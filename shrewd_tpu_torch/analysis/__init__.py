"""graftlint: determinism & replay-safety certification of the port.

Three layers over the campaign stack (CLI: ``python -m
shrewd_tpu_torch.tools.graftlint``):

- **Layer 1** (``step_audit`` / ``certify``) — run every campaign step
  kind once under torch's function and dispatch modes and certify the
  replay-safety rules (frozen-key RNG lineage, no hidden host reads, the
  ONE-result-copy-per-sync-interval transfer budget, no undeclared
  in-place writes to the step's inputs).  Installed through
  ``parallel/exec_cache.py``, it audits each step kind on its first
  dispatch; strict mode refuses a violating step.
- **Layer 2** (``ast_lint``) — repo-specific AST passes over
  ``shrewd_tpu_torch/``: kernel-registry routing (GL101), no wall clock in
  deterministic regions, atomic checkpoint writes, PRNG key hygiene
  (GL104/GL105 over ``utils/prng.py``), the clock seam — plus the GL2xx
  crash/replay-safety family (``replay_lint``): journal-before-mutate
  CFG dominance, journal-record-kind exhaustiveness, fsync-before-rename
  ordering, best-effort-seam guards, and the GL205 stale-waiver audit.
  The posture lives in ``graftlint.toml`` beside this module.
- **Layer 3** (``crashcheck``) — dynamic, exhaustive crash-point model
  checking of the fleet WAL (``run_crashcheck``) and of the federation
  gateway's WAL (``run_gateway_crashcheck``): recovery re-executed from
  every recorded durability boundary, with bit-identical final tallies
  required at each.

``crashcheck`` loads on first use (``analysis.crashcheck``): it reaches
the service layer, which itself imports the plan and so this package.
"""

from shrewd_tpu_torch.analysis.ast_lint import (Finding, LintReport,
                                                lint_file, lint_tree)
from shrewd_tpu_torch.analysis.config import (RULES, AnalysisConfig,
                                              GraftlintConfig, load_config)
from shrewd_tpu_torch.analysis.step_audit import (ALLOWED_RNG,
                                                  CALLBACK_PRIMS,
                                                  FORBIDDEN_RNG,
                                                  CertificationError,
                                                  StepAuditor,
                                                  audit_callable,
                                                  primitive_census)

__all__ = [
    "ALLOWED_RNG", "CALLBACK_PRIMS", "FORBIDDEN_RNG", "RULES",
    "AnalysisConfig", "CertificationError", "Finding", "GraftlintConfig",
    "LintReport", "StepAuditor", "audit_callable", "crashcheck",
    "install_step_auditor", "lint_file", "lint_tree", "load_config",
    "primitive_census",
]


def __getattr__(name):
    if name == "crashcheck":
        import importlib

        return importlib.import_module(f"{__name__}.crashcheck")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def install_step_auditor(mode: str, transfer_budget: int = 1):
    """Orchestrator/CLI wiring: install the ledger's step auditor per the
    ``plan.analysis.certify`` posture.  Certification is a process-wide
    opt-in and one campaign must not silently DISARM or DOWNGRADE
    another's: 'off' leaves any existing auditor in place, and 'warn'
    keeps an already-installed strict auditor (the stricter posture
    wins; an explicit disarm is the CLI's ``--certify off``).  Returns
    the effective auditor or None."""
    if mode == "off":
        return None
    from shrewd_tpu_torch.parallel import exec_cache

    existing = exec_cache.current_auditor()
    if mode == "warn" and getattr(existing, "strict", False):
        return existing
    auditor = StepAuditor(transfer_budget=transfer_budget,
                          strict=mode == "strict")
    exec_cache.install_auditor(auditor)
    return auditor
