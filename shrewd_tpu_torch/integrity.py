"""Result-integrity layer: canary trials, tally invariants, differential audit
(the port of ``shrewd_tpu/integrity.py``).

The resilience layer makes campaigns survive backend failures; this
module defends the *results*: a corrupted batch (a bad build, a stale
buffer, a bit-flipped tally on a degraded tier) would otherwise flow
straight into the AVF estimate and its Wilson/stratified stopping
decision.  The reference keeps a golden-reference discipline *inside* the
run via its CheckerCPU oracles (``src/cpu/checker/cpu.hh``; PAPER §2.4);
this module is the campaign-embedded analog, three defenses deep:

1. **Canary trials** — every dispatched batch is salted with trials whose
   outcomes are known by construction: an out-of-window cycle flip and a
   zero-mask (kind-NONE) flip are MASKED on every kernel, and a cached
   host-oracle-verified *seed canary* per (simpoint, structure) re-runs the
   same frozen keys through the batch's own dispatch tier.  Any canary miss
   marks the whole batch corrupt: it is quarantined and re-dispatched down
   the resilience ladder on its frozen PRNG keys (bit-identical recovery).
2. **Tally invariant enforcement** — per-batch checks that outcome classes
   sum to the trial count, tallies are non-negative/finite/integral,
   cumulative counters are monotone across batches, and each shard's local
   tally is consistent with the summed one (``shard_sum_violations``,
   over the mesh's real shards, ``parallel/campaign.py``).
   Violations raise ``ExitEvent.INTEGRITY_VIOLATION`` with a
   persisted evidence record.
3. **Continuous differential audit** — a sampled fraction of each batch
   re-runs on an alternate kernel (host oracle / dense / chunked) and
   feeds a mismatch ledger with per-reason codes and a mismatch budget
   mirroring the escalation gate (abort rc 3, resumable).

On the card every canary and audit run is a K1 launch of its own: the
constructed canaries and the audit sample go through
``TrialKernel.run_batch_hybrid``, the seed canary through the batch's own
dispatch tier.  The kernel modules are imported lazily inside the
canary/audit builders.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.resilience import (DispatchResult, ResilientDispatcher,
                                   TIERS)
from shrewd_tpu_torch.utils import debug
from shrewd_tpu_torch.utils.config import ConfigObject, Param

debug.register_flag("Integrity", "canaries / invariants / audit")

# Reserved batch id for canary key derivation (prng.batch_key(sk, THIS)):
# real batch ids count up from 0 and can never reach 2^31-1, so canary
# faults are drawn from a stream no real trial will ever consume — salting
# batches with canaries cannot perturb the campaign's sampled faults.
CANARY_BATCH_ID = 0x7FFFFFFF

# Evidence entries kept in memory / checkpoints (counters stay exact; only
# the per-event detail ring is bounded, so a pathological run cannot grow
# the checkpoint without bound).
MAX_EVIDENCE = 200


class IntegrityError(RuntimeError):
    """A batch failed integrity checks beyond recovery (all re-dispatches
    exhausted, or an invariant that cannot be requeued away)."""


class IntegrityConfig(ConfigObject):
    """Knobs for the result-integrity layer (a ``CampaignPlan`` child, so a
    campaign's self-validation posture is reproducible from its config
    dump)."""

    canary_trials = Param(int, 2,
                          "seed-canary trials salted per dispatched batch "
                          "(rounded up to the mesh size; 0 disables "
                          "canaries, constructed ones included)",
                          check=lambda v: v >= 0)
    invariants = Param(bool, True,
                       "enforce per-batch tally invariants (sum==trials, "
                       "non-negative/finite, monotone cumulative, "
                       "shard-vs-psum consistency)")
    audit_rate = Param(float, 0.01,
                       "fraction of each batch re-run on the alternate "
                       "kernel (0 disables the differential audit; at "
                       "least one trial per batch when enabled)",
                       check=lambda v: 0 <= v <= 1)
    audit_threshold = Param(float, 0.01,
                            "max audited-trial mismatch rate before the "
                            "run is flagged",
                            check=lambda v: 0 <= v <= 1)
    audit_action = Param(str, "warn",
                         "off | warn | abort when the audit mismatch rate "
                         "exceeds the threshold (abort exits rc 3, "
                         "resumable)",
                         check=lambda v: v in ("off", "warn", "abort"))
    audit_alternate = Param(str, "oracle",
                            "alternate kernel for the differential audit: "
                            "oracle (host golden kernel, dense fallback) | "
                            "dense | chunked",
                            check=lambda v: v in ("oracle", "dense",
                                                  "chunked"))
    max_requeue = Param(int, 2,
                        "re-dispatches of a quarantined batch before the "
                        "violation is fatal", check=lambda v: v >= 0)


# --------------------------------------------------------------------------
# tally invariants (host-pure)
# --------------------------------------------------------------------------

def tally_violations(tally, batch_size: int, strata=None,
                     n_outcomes: int | None = None) -> list[str]:
    """Invariant violations of one batch tally (empty list = clean).

    The checks are exactly the properties every execution tier promises:
    one outcome class per trial (sum == batch), counts are non-negative
    finite integers, and a stratified tally refines — never disagrees
    with — the pooled one."""
    viol: list[str] = []
    t = np.asarray(tally, dtype=np.float64)
    if n_outcomes is not None and t.shape != (n_outcomes,):
        return [f"tally shape {t.shape} != ({n_outcomes},)"]
    if not np.all(np.isfinite(t)):
        viol.append(f"non-finite tally {t.tolist()}")
        return viol                      # downstream checks are meaningless
    if np.any(t < 0):
        viol.append(f"negative tally {t.astype(np.int64).tolist()}")
    if np.any(t != np.rint(t)):
        viol.append(f"non-integral tally {t.tolist()}")
    if int(t.sum()) != int(batch_size):
        viol.append(f"tally sum {int(t.sum())} != batch size "
                    f"{int(batch_size)}")
    if strata is not None:
        s = np.asarray(strata, dtype=np.float64)
        if not np.all(np.isfinite(s)):
            viol.append("non-finite strata tally")
        elif np.any(s < 0):
            viol.append("negative strata tally")
        elif not np.array_equal(s.sum(axis=0), t):
            viol.append(
                f"strata sum {s.sum(axis=0).astype(np.int64).tolist()} "
                f"!= tally {t.astype(np.int64).tolist()}")
    return viol


def monotone_violations(prev_cum, new_cum) -> list[str]:
    """Cumulative outcome counters may only grow across batches."""
    p = np.asarray(prev_cum, dtype=np.int64)
    n = np.asarray(new_cum, dtype=np.int64)
    if np.any(n < p):
        return [f"cumulative tally regressed: {p.tolist()} -> {n.tolist()}"]
    return []


def shard_sum_violations(shard_tallies, psum_tally) -> list[str]:
    """Each shard's local tally must be consistent with the replicated
    psum (the in-graph reduction the whole campaign trusts)."""
    local = np.asarray(shard_tallies, dtype=np.int64)
    total = np.asarray(psum_tally, dtype=np.int64)
    if not np.array_equal(local.sum(axis=0), total):
        return [f"shard tallies sum {local.sum(axis=0).tolist()} != "
                f"replicated psum {total.tolist()}"]
    return []


# --------------------------------------------------------------------------
# canary trials
# --------------------------------------------------------------------------

def canary_supported(kernel) -> bool:
    """Constructed (fault-level) canaries need a fault-level exact API —
    the TrialKernel family; tier kernels (cache/MESI/NoC) get the
    key-level seed canary only."""
    return hasattr(kernel, "run_batch_hybrid") and hasattr(kernel, "trace")


def constructed_canaries(kernel):
    """(Fault batch, note list) whose outcomes are MASKED by construction:

    - ``oow_cycle_pos`` / ``oow_cycle_neg``: a REGFILE flip at a cycle
      outside [0, n) never matches any step index, so no bit ever flips
      (the chunked kernel resolves the same coordinates through its
      out-of-window landing shortcut, including negative landings);
    - ``zero_mask``: a KIND_NONE fault with in-window coordinates — its
      flip mask applies to no structure, so the replay IS the golden
      replay (on the chunked kernel this one exercises the landing-chunk
      replay and must converge state-equal at the boundary)."""
    from shrewd_tpu_torch.compat import fault_from_arrays
    from shrewd_tpu_torch.models.o3 import KIND_NONE, KIND_REGFILE

    n = int(kernel.trace.n)
    fault = fault_from_arrays(
        kind=[KIND_REGFILE, KIND_REGFILE, KIND_NONE],
        cycle=[n + 7, -3, n // 2], entry=[0, 1, max(n // 2, 0)],
        bit=[0, 3, 5], shadow_u=np.ones(3, np.float32),
        device=kernel.device)
    return fault, ["oow_cycle_pos", "oow_cycle_neg", "zero_mask"]


class CanaryResult(NamedTuple):
    ok: bool
    trials: int
    failures: list[dict]      # [{"canary": ..., "want": ..., "got": ...}]


class _CounterGuard:
    """Snapshot/restore a kernel's host-side escape counters so canary and
    audit re-runs never pollute the campaign's escape-rate stats."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __enter__(self):
        self._esc = getattr(self.kernel, "escapes", None)
        self._tt = getattr(self.kernel, "taint_trials", None)
        return self

    def __exit__(self, *exc):
        if self._esc is not None:
            self.kernel.escapes = self._esc
        if self._tt is not None:
            self.kernel.taint_trials = self._tt
        return False


class CanaryBattery:
    """Per-campaign canary set: constructed MASKED faults plus the cached
    oracle-verified seed canary.

    ``seed_keys`` are derived from the campaign's frozen PRNG coordinates
    under the reserved ``CANARY_BATCH_ID``, so the canary stream is
    disjoint from every real trial's.  The expected seed tally is computed
    ONCE per battery from the host oracle (dense in-framework oracle when
    the native kernel is unavailable; the unsharded dense protocol for
    tier kernels) and every batch's dispatch tier must reproduce it."""

    def __init__(self, campaign, structure: str, seed_keys=None):
        self.campaign = campaign
        self.kernel = campaign.kernel
        self.structure = structure
        self.seed_keys = seed_keys
        self._constructed = None          # lazy: (Fault, notes)
        self._seed_expected = None        # lazy: np tally
        self._seed_usable = None

    # --- expected outcomes (trusted references, computed once) ---------

    def _ensure_constructed(self):
        if self._constructed is None and canary_supported(self.kernel):
            self._constructed = constructed_canaries(self.kernel)
        return self._constructed

    def _seed_reference(self) -> np.ndarray | None:
        """Oracle-verified per-trial outcomes for the seed keys, or None
        when no trusted reference covers this campaign's semantics (the
        pure-taint mode intentionally over-approximates SDC, so an exact
        oracle would false-positive)."""
        kernel, camp = self.kernel, self.campaign
        if canary_supported(kernel):
            if getattr(camp, "mode", "dense") == "taint":
                return None
            budget = getattr(getattr(kernel, "cfg", None),
                             "escape_budget", 1 << 30)
            if budget < int(self.seed_keys.shape[0]):
                return None          # device path may legally SDC-clip
            faults = kernel.sample_batch(self.seed_keys, self.structure)
            return np.asarray(kernel.oracle_outcomes(faults))
        # tier kernels (cache/MESI/NoC): the kernel's own per-trial
        # outcomes on the campaign's device are the reference (the canary
        # then proves the campaign's tally path reproduces them)
        return kernel.outcomes_from_keys(self.seed_keys,
                                         self.structure).cpu().numpy()

    def seed_expected(self) -> np.ndarray | None:
        if self._seed_usable is None:
            if self.seed_keys is None:
                self._seed_usable = False
            else:
                from shrewd_tpu_torch.ops import classify as C

                ref = self._seed_reference()
                if ref is None:
                    self._seed_usable = False
                else:
                    self._seed_expected = np.bincount(
                        ref, minlength=C.N_OUTCOMES).astype(np.int64)
                    self._seed_usable = True
        return self._seed_expected if self._seed_usable else None

    # --- the per-batch check -------------------------------------------

    def check(self, tier: int, tier_fn) -> CanaryResult:
        """Run every canary; ``tier_fn(keys, stratified)`` is the dispatch
        function of the tier that produced the batch under test, so the
        seed canary exercises the exact same execution path."""
        from shrewd_tpu_torch.ops import classify as C

        failures: list[dict] = []
        trials = 0
        with _CounterGuard(self.kernel):
            built = self._ensure_constructed()
            if built is not None:
                fault, notes = built
                out = np.asarray(self.kernel.run_batch_hybrid(fault))
                trials += len(notes)
                for i, note in enumerate(notes):
                    if int(out[i]) != C.OUTCOME_MASKED:
                        failures.append({
                            "canary": note,
                            "want": C.OUTCOME_NAMES[C.OUTCOME_MASKED],
                            "got": C.OUTCOME_NAMES[int(out[i])]})
            want = self.seed_expected()
            if want is not None:
                tally, _strata = tier_fn(self.seed_keys, False)
                tally = np.asarray(tally, dtype=np.int64)
                trials += int(self.seed_keys.shape[0])
                if not np.array_equal(tally, want):
                    failures.append({
                        "canary": f"seed@{TIERS[tier]}",
                        "want": want.tolist(),
                        "got": tally.tolist()})
        return CanaryResult(not failures, trials, failures)


# --------------------------------------------------------------------------
# differential audit
# --------------------------------------------------------------------------

def audit_supported(kernel) -> bool:
    return canary_supported(kernel)


class AuditOracle:
    """Re-run sampled trials on an alternate kernel and compare outcomes
    per-trial — the in-campaign slice of the offline DIFF_AVF artifacts.

    The primary side is the exact hybrid driver (bit-identical to the
    dense kernel by the taint-parity contract); the alternate is the host
    oracle (native golden kernel — the CheckerCPU analog), the dense
    kernel, or the chunked kernel per config.  A mismatch therefore means
    kernel/classify corruption, never a legitimate strategy difference."""

    def __init__(self, kernel, structure: str, alternate: str = "oracle"):
        self.kernel = kernel
        self.structure = structure
        self.alternate = alternate
        self._chunked = None

    def _alternate_outcomes(self, faults) -> np.ndarray:
        if self.alternate == "chunked":
            if self._chunked is None:
                from shrewd_tpu_torch.ops.chunked import ChunkedCampaign

                # a chunk length that never divides the window exercises
                # the ragged-tail path (n % chunk != 0) for free; pin the
                # EXACT engine — the primary is the taint-family hybrid
                # driver, so a deviation-set chunk engine would share its
                # kernel with the side under audit
                n = int(self.kernel.trace.n)
                chunk = max(n // 2 - 1, 1)
                self._chunked = ChunkedCampaign(self.kernel, chunk=chunk,
                                                engine="exact")
            return self._chunked.outcomes_of_faults(faults)
        if self.alternate == "dense":
            return self.kernel.run_batch(faults).cpu().numpy()
        return np.asarray(self.kernel.oracle_outcomes(faults))

    def audit(self, keys, idx: np.ndarray) -> list[dict]:
        """Mismatch records for the sampled trial indices ``idx`` of a
        batch's key array (empty list = full agreement)."""
        import torch

        from shrewd_tpu_torch.ops import classify as C

        n = int(idx.size)
        if n == 0:
            return []
        # the kernel's own pow2-bucket padding keeps the shapes few
        # across varying audit-sample sizes (as in resolve_escapes)
        pad = self.kernel._bucket(np.asarray(idx, np.int64))
        sub_keys = keys[torch.as_tensor(pad, device=keys.device)]
        with _CounterGuard(self.kernel):
            faults = self.kernel.sample_batch(sub_keys, self.structure)
            primary = np.asarray(
                self.kernel.run_batch_hybrid(faults))[:n]
            alt = np.asarray(self._alternate_outcomes(faults))[:n]
        out: list[dict] = []
        for i in np.nonzero(primary != alt)[0]:
            out.append({
                "trial_index": int(idx[i]),
                "primary": C.OUTCOME_NAMES[int(primary[i])],
                "alternate": C.OUTCOME_NAMES[int(alt[i])],
                "reason": f"{C.OUTCOME_NAMES[int(primary[i])]}->"
                          f"{C.OUTCOME_NAMES[int(alt[i])]}"
                          f"@{self.alternate}"})
        return out


class MismatchLedger:
    """Audit accounting: audited trials, mismatches, per-reason counts and
    a bounded evidence ring.  Checkpointed (v5) so the mismatch budget
    survives resume."""

    def __init__(self):
        self.audited = 0
        self.mismatched = 0
        self.reasons: dict[str, int] = {}
        self.entries: list[dict] = []

    def record(self, n_audited: int, mismatches: list[dict],
               context: dict | None = None) -> None:
        self.audited += int(n_audited)
        self.mismatched += len(mismatches)
        for m in mismatches:
            self.reasons[m["reason"]] = self.reasons.get(m["reason"], 0) + 1
            entry = dict(m)
            if context:
                entry.update(context)
            self.entries.append(entry)
        del self.entries[:-MAX_EVIDENCE]

    def rate(self) -> float:
        return self.mismatched / max(self.audited, 1)

    def over(self, threshold: float) -> bool:
        return self.audited > 0 and self.rate() > threshold

    def to_dict(self) -> dict:
        return {"audited": self.audited, "mismatched": self.mismatched,
                "reasons": dict(self.reasons),
                "entries": list(self.entries)}

    @classmethod
    def from_dict(cls, d: dict) -> "MismatchLedger":
        led = cls()
        led.audited = int(d.get("audited", 0))
        led.mismatched = int(d.get("mismatched", 0))
        led.reasons = {str(k): int(v)
                       for k, v in d.get("reasons", {}).items()}
        led.entries = list(d.get("entries", []))
        return led


class AuditBudgetInfo(NamedTuple):
    """Payload of ``ExitEvent.INTEGRITY_VIOLATION`` when the mismatch
    budget is exceeded (the audit mirror of ``EscalationInfo``)."""
    rate: float
    threshold: float
    action: str              # "warn" | "abort"
    reasons: dict            # {reason code: count}


class IntegrityMonitor:
    """Campaign-wide integrity accounting: counters, the mismatch ledger,
    the quarantine record, pending evidence events, and the test hook
    that injects tally corruption.

    One monitor per orchestrator (result trust is a campaign property,
    like backend health); ``CheckedDispatcher`` instances share it."""

    def __init__(self, cfg: IntegrityConfig | None = None):
        self.cfg = cfg if cfg is not None else IntegrityConfig()
        self.ledger = MismatchLedger()
        self.canary_runs = 0
        self.canary_trials = 0
        self.canary_failures = 0
        self.invariant_checks = 0
        self.invariant_violations = 0
        self.audit_batches = 0
        self.quarantined = 0
        self.requeues = 0
        self.recovered = 0
        self.quarantine_log: list[dict] = []
        self._pending_events: list[dict] = []
        self._corruptions: list = []      # armed test-hook callables

    # --- test hook ------------------------------------------------------

    def arm_corruption(self, fn, times: int = 1, note=None) -> None:
        """INJECTION HOOK: apply ``fn(tally) -> tally`` to the next
        ``times`` dispatched batch tallies — the injected-corruption
        harness the acceptance criterion requires (a bit-flipped tally on
        a degraded tier is otherwise unobtainable on a healthy backend).
        Used by tests directly and by the chaos harness
        (``chaos.ChaosEngine``), whose ``note`` callback is invoked at
        apply time so the chaos ledger counts the fault when it actually
        lands, not when it is scheduled."""
        self._corruptions.extend([(fn, note)] * times)

    def apply_corruption(self, res: DispatchResult) -> DispatchResult:
        if not self._corruptions:
            return res
        fn, note = self._corruptions.pop(0)
        if note is not None:
            note()
        return res._replace(tally=np.asarray(fn(np.asarray(res.tally))))

    # --- evidence -------------------------------------------------------

    def record_quarantine(self, evidence: dict) -> None:
        self.quarantined += 1
        self.quarantine_log.append(evidence)
        del self.quarantine_log[:-MAX_EVIDENCE]
        self._pending_events.append(evidence)
        obs_trace.tracer().emit(
            "quarantine", cat="integrity",
            kind=str(evidence.get("kind", "")),
            sp=evidence.get("simpoint", ""),
            structure=evidence.get("structure", ""),
            batch_id=int(evidence.get("batch_id", -1)),
            fatal=bool(evidence.get("fatal", False)))
        debug.dprintf("Integrity", "quarantine: %s", evidence)

    def take_events(self) -> list[dict]:
        ev, self._pending_events = self._pending_events, []
        return ev

    # --- checkpoint (v5) ------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "ledger": self.ledger.to_dict(),
            "canary_runs": self.canary_runs,
            "canary_trials": self.canary_trials,
            "canary_failures": self.canary_failures,
            "invariant_checks": self.invariant_checks,
            "invariant_violations": self.invariant_violations,
            "audit_batches": self.audit_batches,
            "quarantined": self.quarantined,
            "requeues": self.requeues,
            "recovered": self.recovered,
            "quarantine_log": list(self.quarantine_log),
        }

    @classmethod
    def from_dict(cls, d: dict | None,
                  cfg: IntegrityConfig | None = None) -> "IntegrityMonitor":
        mon = cls(cfg)
        if not d:
            return mon     # pre-v5 checkpoint: the faithful unknown
        mon.ledger = MismatchLedger.from_dict(d.get("ledger", {}))
        for k in ("canary_runs", "canary_trials", "canary_failures",
                  "invariant_checks", "invariant_violations",
                  "audit_batches", "quarantined", "requeues", "recovered"):
            setattr(mon, k, int(d.get(k, 0)))
        mon.quarantine_log = list(d.get("quarantine_log", []))
        return mon


class CheckedDispatcher:
    """Integrity enforcement around one campaign's resilient dispatch.

    Wraps a ``ResilientDispatcher``: every batch passes the tally
    invariants and the canary battery before its tally is believed; a
    failing batch is quarantined and re-dispatched on its frozen keys down
    the resilience ladder (below the tier that produced the corrupt
    result, when one exists), and a sampled fraction feeds the
    differential-audit ledger."""

    def __init__(self, dispatcher: ResilientDispatcher, campaign,
                 monitor: IntegrityMonitor, sp_name: str, structure: str,
                 seed_keys=None):
        self.dispatcher = dispatcher
        self.campaign = campaign
        self.monitor = monitor
        self.cfg = monitor.cfg
        self.sp_name = sp_name
        self.structure = structure       # display name (may be tier-
        # qualified, e.g. "cache:data"); kernel-facing calls use the
        # campaign's substructure name (ShardedCampaign.structure)
        self._kernel_structure = getattr(campaign, "structure", structure)
        self._battery = (CanaryBattery(campaign, self._kernel_structure,
                                       seed_keys)
                         if self.cfg.canary_trials > 0 else None)
        self._auditor = None
        # shard-vs-sum accounting lives on the campaign (the check runs
        # inside tally_batch); deltas sync into the shared monitor here
        self._shard_seen = (getattr(campaign, "shard_checks", 0),
                            getattr(campaign, "shard_mismatches", 0))

    def _sync_shard_counters(self, batch_id: int) -> None:
        camp, mon = self.campaign, self.monitor
        sc = getattr(camp, "shard_checks", 0)
        sm = getattr(camp, "shard_mismatches", 0)
        dm = sm - self._shard_seen[1]
        if dm:
            # a shard-sum mismatch raises inside the device tier, so the
            # resilience ladder already re-ran the batch elsewhere — count
            # it and surface the evidence, no extra requeue needed
            mon.invariant_violations += dm
            mon._pending_events.append({
                "kind": "shard", "simpoint": self.sp_name,
                "structure": self.structure, "batch_id": int(batch_id),
                "mismatches": int(dm), "recovered_by_ladder": True})
        self._shard_seen = (sc, sm)

    # --- internals ------------------------------------------------------

    def _tier_fn(self, tier: int):
        for t, fn in self.dispatcher.tiers:
            if t == tier:
                return fn
        return self.dispatcher.tiers[0][1]

    def _check(self, res: DispatchResult, batch_size: int,
               batch_id: int = -1) -> list[dict]:
        """Invariants + canaries for one dispatch result; returns the
        failure evidence (empty = batch believed)."""
        mon = self.monitor
        problems: list[dict] = []
        if self.cfg.invariants:
            mon.invariant_checks += 1
            viol = tally_violations(res.tally, batch_size, res.strata)
            if viol:
                mon.invariant_violations += 1
                problems.append({"kind": "invariant", "violations": viol})
            obs_trace.tracer().emit(
                "invariant_verdict", cat="integrity", ok=not viol,
                sp=self.sp_name, structure=self.structure,
                batch_id=int(batch_id))
        if self._battery is not None:
            mon.canary_runs += 1
            try:
                cres = self._battery.check(res.tier,
                                           self._tier_fn(res.tier))
            except Exception as e:  # noqa: BLE001 — a backend failure
                # DURING the canary run (wedge, transient launch error) must
                # degrade like any other dispatch failure, not crash the
                # campaign: quarantining the batch sends it down the
                # ladder, where the canary re-runs on the next tier
                problems.append({"kind": "canary_dispatch",
                                 "error": f"{type(e).__name__}: "
                                          f"{str(e)[:300]}"})
                obs_trace.tracer().emit(
                    "canary_verdict", cat="integrity", ok=False,
                    dispatch_error=True, sp=self.sp_name,
                    structure=self.structure, batch_id=int(batch_id))
                return problems
            mon.canary_trials += cres.trials
            if not cres.ok:
                mon.canary_failures += len(cres.failures)
                problems.append({"kind": "canary",
                                 "failures": cres.failures})
            obs_trace.tracer().emit(
                "canary_verdict", cat="integrity", ok=cres.ok,
                trials=int(cres.trials), sp=self.sp_name,
                structure=self.structure, batch_id=int(batch_id))
        return problems

    def _audit(self, keys, batch_id: int) -> None:
        cfg, mon = self.cfg, self.monitor
        if cfg.audit_rate <= 0 or not audit_supported(self.campaign.kernel):
            return
        if self._auditor is None:
            self._auditor = AuditOracle(self.campaign.kernel,
                                        self._kernel_structure,
                                        cfg.audit_alternate)
        B = int(keys.shape[0])
        n = max(1, int(round(cfg.audit_rate * B)))
        # deterministic per-batch sample: resume re-audits the same trials
        rng = np.random.default_rng((batch_id + 1) * 0x9E3779B1 & 0xFFFFFFFF)
        idx = np.sort(rng.choice(B, size=min(n, B), replace=False))
        try:
            mismatches = self._auditor.audit(keys, idx)
        except Exception as e:  # noqa: BLE001 — the audit is sampled
            # best-effort device work with no watchdog: a transient
            # backend failure here must cost one batch's audit, never the
            # campaign (the batch's tally already passed its checks)
            debug.dprintf("Integrity", "audit dispatch failed for %s/%s "
                          "batch %d (skipped): %s", self.sp_name,
                          self.structure, batch_id, e)
            return
        mon.audit_batches += 1
        mon.ledger.record(idx.size, mismatches,
                          context={"simpoint": self.sp_name,
                                   "structure": self.structure,
                                   "batch_id": int(batch_id)})
        obs_trace.tracer().emit(
            "audit_verdict", cat="integrity", ok=not mismatches,
            audited=int(idx.size), mismatches=len(mismatches),
            sp=self.sp_name, structure=self.structure,
            batch_id=int(batch_id))
        if mismatches:
            debug.dprintf("Integrity", "audit: %d/%d mismatches in %s/%s "
                          "batch %d", len(mismatches), idx.size,
                          self.sp_name, self.structure, batch_id)

    # --- interval-granular surface (the pipelined engine) ---------------
    #
    # The pipelined engine (parallel/pipeline.py) materializes one sync
    # interval at a time and runs the SAME defenses at interval
    # boundaries on the cumulative deltas: the canary battery still runs
    # on the batch's dispatch tier, the invariants still require
    # sum == trials (now the interval's trial count), and the audit still
    # samples each batch with its own deterministic per-batch draw — so
    # the mismatch ledger is identical whichever loop ran.

    def check_result(self, res: DispatchResult, n_trials: int,
                     batch_id: int = -1) -> list[dict]:
        """Invariants + canaries for a believed-result candidate covering
        ``n_trials`` trials (a batch or a whole sync interval); returns
        failure evidence (empty = believed)."""
        return self._check(res, n_trials, batch_id=batch_id)

    def sync_shard_counters(self, batch_id: int) -> None:
        """Fold the campaign's shard-vs-sum counters into the shared
        monitor (evidence attributed to ``batch_id``)."""
        self._sync_shard_counters(batch_id)

    def audit_batch(self, keys, batch_id: int) -> None:
        """Differential-audit one batch's keys under its own
        deterministic sample (resume and pipelined runs re-audit the
        same trials)."""
        self._audit(keys, batch_id)

    # --- the checked dispatch ------------------------------------------

    def tally_batch(self, keys, stratified: bool = False,
                    batch_id: int = -1) -> DispatchResult:
        mon = self.monitor
        dispatcher = self.dispatcher
        requeued = False
        for attempt in range(self.cfg.max_requeue + 1):
            with _CounterGuard(self.campaign.kernel) as guard:
                res = dispatcher.tally_batch(keys, stratified=stratified)
                res = mon.apply_corruption(res)
                problems = self._check(res, int(keys.shape[0]),
                                       batch_id=batch_id)
                if not problems:
                    guard._esc = getattr(self.campaign.kernel,
                                         "escapes", None)
                    guard._tt = getattr(self.campaign.kernel,
                                        "taint_trials", None)
            if not problems:
                self._sync_shard_counters(batch_id)
                if requeued:
                    mon.recovered += 1
                    mon._pending_events.append({
                        "kind": "recovered", "simpoint": self.sp_name,
                        "structure": self.structure,
                        "batch_id": int(batch_id), "tier": TIERS[res.tier],
                        "attempts": attempt + 1})
                    obs_trace.tracer().emit(
                        "quarantine_recovered", cat="integrity",
                        sp=self.sp_name, structure=self.structure,
                        batch_id=int(batch_id), tier=TIERS[res.tier],
                        attempts=attempt + 1)
                self._audit(keys, batch_id)
                return res
            evidence = {
                "kind": problems[0]["kind"], "simpoint": self.sp_name,
                "structure": self.structure, "batch_id": int(batch_id),
                "tier": TIERS[res.tier], "attempt": attempt,
                "problems": problems,
                "fatal": attempt >= self.cfg.max_requeue,
            }
            mon.record_quarantine(evidence)
            if attempt >= self.cfg.max_requeue:
                raise IntegrityError(
                    f"{self.sp_name}/{self.structure} batch {batch_id}: "
                    f"integrity checks failed on every re-dispatch "
                    f"({evidence['problems']})")
            # re-dispatch the frozen keys down the ladder: below the tier
            # that produced the corrupt result when a lower tier exists,
            # else the full ladder again (transient corruption)
            sub = self.dispatcher.sub_ladder(below=res.tier)
            dispatcher = sub if sub is not None else self.dispatcher
            mon.requeues += 1
            requeued = True
            debug.dprintf("Integrity",
                          "%s/%s batch %d quarantined on %s (attempt %d) "
                          "— re-dispatching", self.sp_name, self.structure,
                          batch_id, TIERS[res.tier], attempt)
        raise AssertionError("unreachable")


def checked_dispatcher_for(dispatcher, campaign, monitor, sp_name: str,
                           structure: str, structure_key=None
                           ) -> CheckedDispatcher:
    """Build the checked wrapper for one campaign.  ``structure_key`` is
    the campaign's frozen PRNG structure key; seed-canary keys derive from
    it under the reserved CANARY_BATCH_ID (disjoint from all real
    batches), rounded up to the mesh size so every tier can shard them."""
    seed_keys = None
    if monitor.cfg.canary_trials > 0 and structure_key is not None:
        from shrewd_tpu_torch.parallel.mesh import round_up_to_mesh
        from shrewd_tpu_torch.utils import prng

        mesh = getattr(campaign, "mesh", None)
        n = round_up_to_mesh(monitor.cfg.canary_trials,
                             mesh.size if mesh is not None else 1)
        seed_keys = prng.trial_keys(
            prng.batch_key(structure_key, CANARY_BATCH_ID), n)
    return CheckedDispatcher(dispatcher, campaign, monitor, sp_name,
                             structure, seed_keys)
