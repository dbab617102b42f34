"""graftlint configuration: the port's posture file and the
``plan.analysis`` campaign child (the port of
``shrewd_tpu/analysis/config.py``).

Two consumers, one source of truth each:

- ``python -m shrewd_tpu_torch.tools.graftlint`` reads rule scoping —
  which modules each AST pass covers, per-rule severity, the device→host
  transfer budget — from ``graftlint.toml`` beside this module, a
  ``[tool.graftlint]`` block over ``shrewd_tpu_torch/`` (the repo's
  ``pyproject.toml`` block is the JAX package's posture), so the lint
  posture is versioned with the code it certifies;
- the orchestrator reads the ``plan.analysis`` child to decide whether
  campaign steps are certified on their first dispatch
  (``parallel/exec_cache.py`` auditor hook, ``analysis/step_audit.py``),
  so a campaign's verification posture is reproducible from its config
  dump like every other posture.

Python 3.11+ reads the posture with ``tomllib``.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field

from shrewd_tpu_torch.utils.config import ConfigObject, Param

#: rule ids → human names (the waiver comment uses the name:
#: ``# graftlint: allow-<name> -- <reason>``)
RULES = {
    "GL101": "jit",
    "GL102": "wall-clock",
    "GL103": "raw-write",
    "GL104": "key-reuse",
    "GL105": "key-genesis",
    "GL106": "clock",
    # --- the GL2xx replay-safety family (analysis/replay_lint.py) ---
    "GL201": "journal-before-mutate",
    "GL202": "journal-exhaustive",
    "GL203": "fsync-rename",
    "GL204": "best-effort-guard",
    # GL205 is computed, never matched by a waiver: a waiver whose rule
    # no longer fires at its site IS the finding
    "GL205": "stale-waiver",
}

SEVERITIES = ("error", "warn", "off")

#: the port's posture, relative to the repo root
CONFIG_PATH = os.path.join("shrewd_tpu_torch", "analysis", "graftlint.toml")


class AnalysisConfig(ConfigObject):
    """The ``plan.analysis`` child: whether campaign steps are certified
    (the replay-safety audit of ``analysis/step_audit.py``) on their
    first dispatch."""

    certify = Param(str, "off",
                    "certify campaign steps on their first dispatch: "
                    "'off' (no auditor), 'warn' (audit + report, never "
                    "refuse), 'strict' (a violating step is refused — "
                    "exec_cache.AdmissionError)",
                    check=lambda v: v in ("off", "warn", "strict"))
    transfer_budget = Param(int, 1,
                            "max device→host transfers per campaign step "
                            "invocation (1 = the ONE-result-copy-per-sync-"
                            "interval contract of parallel/pipeline.py)",
                            check=lambda v: v >= 1)


@dataclass
class GraftlintConfig:
    """Resolved lint configuration (``graftlint.toml`` + defaults)."""

    # GL101: modules where every TrialKernel must be built through the
    # kernel registry (and no torch.compile / torch.jit) or carry an
    # allow-jit waiver
    jit_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/parallel/campaign.py",
        "shrewd_tpu_torch/parallel/pipeline.py",
        "shrewd_tpu_torch/parallel/elastic.py",
        "shrewd_tpu_torch/parallel/exec_cache.py",
        "shrewd_tpu_torch/ops/trial.py",
        "shrewd_tpu_torch/ops/chunked.py",
        "shrewd_tpu_torch/ops/taint_cuda.py",
        "shrewd_tpu_torch/integrity.py",
        "shrewd_tpu_torch/resilience.py",
        "shrewd_tpu_torch/chaos.py",
        "shrewd_tpu_torch/campaign/orchestrator.py",
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
    ])
    # GL102: modules whose trigger/replay logic must be wall-clock-free
    # (the fleet scheduler qualifies by design: scheduling reads only
    # admission order, trial counts and weights)
    deterministic_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/chaos.py",
        "shrewd_tpu_torch/parallel/elastic.py",
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
    ])
    # GL103: modules whose persisted JSON documents must go through
    # resilience.write_json_atomic (+ dir fsync)
    checkpoint_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/campaign/orchestrator.py",
        "shrewd_tpu_torch/resilience.py",
        "shrewd_tpu_torch/parallel/elastic.py",
        "shrewd_tpu_torch/integrity.py",
        "shrewd_tpu_torch/chaos.py",
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
    ])
    # GL104 applies package-wide; GL105 everywhere except these files
    # (the one place key genesis is allowed — everything else derives
    # from the plan seed through utils/prng.py)
    key_genesis_allow: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/utils/prng.py",
    ])
    # GL106: obs-instrumented modules where every clock read
    # (time.time/monotonic/perf_counter and the _ns variants) must route
    # through the sanctioned obs.clock seam — one audited import site
    # instead of scattered reads.  obs/clock.py itself is deliberately
    # NOT listed: it IS the seam (and carries the GL102 waiver for its
    # one wall-clock read).
    clock_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/campaign/orchestrator.py",
        "shrewd_tpu_torch/parallel/pipeline.py",
        "shrewd_tpu_torch/parallel/elastic.py",
        "shrewd_tpu_torch/resilience.py",
        "shrewd_tpu_torch/chaos.py",
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
        "shrewd_tpu_torch/service/journal.py",
        "shrewd_tpu_torch/obs/trace.py",
        "shrewd_tpu_torch/obs/export.py",
        "shrewd_tpu_torch/obs/metrics.py",
    ])
    # ------------------------------------------------------------------
    # GL2xx: crash/replay-safety certification of the fleet layer
    # (analysis/replay_lint.py)
    # ------------------------------------------------------------------
    # GL201: modules whose journaled scheduler state must only mutate
    # UNDER a dominating journal call (the WAL contract made static)
    journaled_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/scenario/runner.py",
    ])
    # the attributes GL201 tracks as journaled scheduler state (tenant
    # status, fair-share/vtime inputs, quota-revocation and the failure
    # ledger — the fields recover() replays)
    journaled_attrs: list = field(default_factory=lambda: [
        "status", "revoked", "trials", "batches", "failures",
        "retry_at", "errors", "kills",
    ])
    # call names that COUNT as journaling (the WAL append surfaces)
    journal_call_names: list = field(default_factory=lambda: [
        "_jlog",
    ])
    # functions exempt from GL201: constructors build fresh objects and
    # the replay path must NOT re-journal what it replays
    replay_functions: list = field(default_factory=lambda: [
        "__init__", "_apply_record", "_admit_from_dict", "recover",
        "resume", "replay_path", "from_dict",
    ])
    # GL202: the journal-record dispatch function — every kind appended
    # anywhere in the journaled/durability modules must be handled here
    replay_dispatch: str = "_apply_record"
    # GL203: modules whose renames must be fsync-dominated and whose
    # recovery-read artifacts must never be written raw
    durability_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/service/journal.py",
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
        "shrewd_tpu_torch/scenario/runner.py",
        "shrewd_tpu_torch/resilience.py",
        "shrewd_tpu_torch/campaign/orchestrator.py",
    ])
    # functions whose reads define the recovery-read artifact set (any
    # basename they open/load is crash-surface state)
    recovery_functions: list = field(default_factory=lambda: [
        "recover", "resume", "replay_path", "is_dirty",
        "load_checkpoint_doc", "status", "journal_path",
    ])
    # GL204: modules whose best-effort observability calls must be
    # exception-guarded (one failure must never become two)
    best_effort_modules: list = field(default_factory=lambda: [
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/service/queue.py",
        "shrewd_tpu_torch/scenario/runner.py",
    ])
    # trailing attribute names of the best-effort seams
    best_effort_calls: list = field(default_factory=lambda: [
        "publish", "flight_dump", "maybe_flight_dump",
    ])
    severity: dict = field(default_factory=lambda: {
        rid: "error" for rid in RULES})
    transfer_budget: int = 1

    def rule_severity(self, rule_id: str) -> str:
        return self.severity.get(rule_id, "error")


def load_config(root: str) -> GraftlintConfig:
    """GraftlintConfig from ``<root>/shrewd_tpu_torch/analysis/
    graftlint.toml`` (defaults when the file or its ``[tool.graftlint]``
    block is absent)."""
    cfg = GraftlintConfig()
    path = os.path.join(root, CONFIG_PATH)
    if not os.path.exists(path):
        return cfg
    with open(path, "rb") as f:
        try:
            doc = tomllib.load(f).get("tool", {}).get("graftlint", {})
        except tomllib.TOMLDecodeError as e:
            raise ValueError(f"graftlint config {path}: {e}") from e
    for key in ("jit_modules", "deterministic_modules",
                "checkpoint_modules", "key_genesis_allow",
                "clock_modules", "journaled_modules", "journaled_attrs",
                "journal_call_names", "replay_functions",
                "durability_modules", "recovery_functions",
                "best_effort_modules", "best_effort_calls"):
        if key in doc:
            setattr(cfg, key, list(doc[key]))
    if "replay_dispatch" in doc:
        cfg.replay_dispatch = str(doc["replay_dispatch"])
    if "transfer_budget" in doc:
        cfg.transfer_budget = int(doc["transfer_budget"])
    sev = doc.get("severity", {})
    name_to_id = {name: rid for rid, name in RULES.items()}
    for name, level in sev.items():
        rid = name_to_id.get(name, name)
        if level not in SEVERITIES:
            raise ValueError(
                f"graftlint config: severity for {name!r} must be one of "
                f"{SEVERITIES}, got {level!r}")
        cfg.severity[rid] = level
    return cfg
