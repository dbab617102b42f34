"""Campaign orchestrator: advance, observe, checkpoint, resume (the port of
``shrewd_tpu/campaign/orchestrator.py`` on one card).

Drives a ``CampaignPlan`` batch-by-batch on the CUDA card (or the CPU, when
the caller asks). Control shape follows the reference's Simulator/exit-event
inversion (SURVEY §3.1: C++ simulates, Python orchestrates): the batch step
on the card (``TrialKernel.tally_on_device``, a K1 launch) is the hot path,
and this host loop only consumes tallies, updates stats, applies the
stopping rule, and emits typed events.

Campaign checkpoint/resume replaces the reference's ``m5.cpt`` machinery
(``sim/serialize.hh:169``) for *campaign* state: progress is a JSON document
plus tally arrays; per-trial state never needs saving because the PRNG
discipline (utils/prng.py) makes any batch re-derivable from its coordinates.
Batch boundaries are the natural drain points (the Drainable analog,
``sim/drain.hh:234``: the orchestrator only checkpoints between batches, when
no device computation is in flight).  The checkpoint holds no device state,
so a checkpoint written by either package resumes in the other.

Not in this slice, each raising ``NotImplementedError`` before any trial
runs: a device mesh (multi-GPU), a chaos plan, an elastic context, the
static certification (``analysis.certify``), a persistent compilation
cache, the tier structures (``cache:*``, ``mesi:*``, ``noc:*``) and
``CheckpointSpec`` simpoints.  None is reachable from a default plan.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from shrewd_tpu_torch import integrity as integ
from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch import stats as statsmod
from shrewd_tpu_torch.chaos import LATER
from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.obs import export as obs_export
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.campaign.plan import (TIER_STRUCTURES, CampaignPlan,
                                            CheckpointSpec)
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.parallel import exec_cache
from shrewd_tpu_torch.parallel import pipeline as pipeline_mod
from shrewd_tpu_torch.parallel import stopping
from shrewd_tpu_torch.parallel.campaign import ShardedCampaign
from shrewd_tpu_torch.resilience import TIERS
from shrewd_tpu_torch.sim.exit_event import ExitEvent
from shrewd_tpu_torch.utils import probes
from shrewd_tpu_torch.utils import debug, prng
from shrewd_tpu_torch.utils.device import resolve as resolve_device

debug.register_flag("Campaign", "orchestrator progress")

CKPT_VERSION = 5

# Campaign-checkpoint upgraders — the ``util/cpt_upgraders/`` analog
# (reference keeps one script per version tag and applies them in sequence
# until the checkpoint reaches the current version).  Each entry maps
# version N → a function upgrading a version-N document IN PLACE to N+1.
#
# v1 → v2: v2 adds the per-structure escape-rate observability counters
# ("escapes"/"taint_trials" — previously lost across resume); v1 documents
# upgrade by defaulting them to zero (the counters are diagnostics, not
# inputs to the stopping rule, so zero is the faithful unknown).


def _upgrade_v1(doc: dict) -> None:
    for per_structure in doc.get("state", {}).values():
        for st_doc in per_structure.values():
            st_doc.setdefault("escapes", 0)
            st_doc.setdefault("taint_trials", 0)
    doc["version"] = 2


def _upgrade_v2(doc: dict) -> None:
    """v2 → v3: per-(simpoint, structure) strata tallies for the
    post-stratified estimator (parallel/stopping.post_stratified).  Old
    checkpoints carry none — a campaign resumed from one stays on the
    pooled Wilson rule for good (its strata can never cover the
    pre-upgrade trials), which is the conservative correct reading."""
    for per_structure in doc.get("state", {}).values():
        for st_doc in per_structure.values():
            st_doc.setdefault("strata", None)
    doc["version"] = 3


def _upgrade_v3(doc: dict) -> None:
    """v3 → v4: per-tier trial accounting (the escalation budget) plus a
    content checksum on every new write.  Pre-v4 trials carry no tier
    provenance — they default to zeros (not attributed to 'device': that
    would fabricate exactly the hybrid-throughput claim the budget exists
    to police), so a resumed old campaign's escalation rate covers only
    post-upgrade batches."""
    for per_structure in doc.get("state", {}).values():
        for st_doc in per_structure.values():
            st_doc.setdefault("tier_trials", [0] * len(TIERS))
    doc["version"] = 4


def _upgrade_v4(doc: dict) -> None:
    """v4 → v5: campaign-level integrity state (mismatch ledger, canary/
    invariant counters, quarantine log).  Pre-v5 campaigns ran with no
    in-loop auditing, so the upgrade records exactly that — an empty
    monitor (the faithful unknown): a resumed old campaign's audit rate
    covers only post-upgrade batches, like the v4 tier ledger."""
    doc.setdefault("integrity", None)
    doc["version"] = 5


CKPT_UPGRADERS = {1: _upgrade_v1, 2: _upgrade_v2, 3: _upgrade_v3,
                  4: _upgrade_v4}


def upgrade_checkpoint(doc: dict) -> dict:
    """Apply upgraders in sequence until ``doc`` reaches CKPT_VERSION."""
    v = doc.get("version")
    while v != CKPT_VERSION:
        up = CKPT_UPGRADERS.get(v)
        if up is None:
            raise ValueError(
                f"campaign checkpoint version {v} has no upgrade path to "
                f"{CKPT_VERSION} (register one in CKPT_UPGRADERS)")
        debug.dprintf("Campaign", "upgrading checkpoint v%s -> v%s",
                      v, v + 1 if isinstance(v, int) else "?")
        up(doc)
        v = doc.get("version")
    return doc


class BatchInfo(NamedTuple):
    simpoint: str
    structure: str
    batch_id: int           # id of the batch just completed
    trials: int             # cumulative trials for this (simpoint, structure)
    tallies: np.ndarray     # cumulative outcome tallies
    avf: float
    tier: int = resil.TIER_DEVICE   # resilience tier that ran this batch


class DegradeInfo(NamedTuple):
    """Payload of ``ExitEvent.BACKEND_DEGRADED``."""
    simpoint: str
    structure: str
    batch_id: int
    tier: int               # TIERS index the batch actually ran on
    attempts: int           # dispatch attempts consumed (retries included)


class EscalationInfo(NamedTuple):
    """Payload of ``ExitEvent.ESCALATION_EXCEEDED``."""
    rate: float
    threshold: float
    action: str             # "warn" | "abort"
    tier_trials: dict       # {tier name: trials}


class StructureResult(NamedTuple):
    simpoint: str
    structure: str
    tallies: np.ndarray
    trials: int
    avf: float
    avf_interval: stopping.Interval
    sdc_interval: stopping.Interval
    converged: bool
    wall_seconds: float


class _State:
    """Mutable per-(simpoint, structure) progress."""

    def __init__(self):
        self.tallies = np.zeros(C.N_OUTCOMES, dtype=np.int64)
        self.next_batch = 0
        self.converged = False
        self.done = False
        # v2: taint-path observability survives resume (escape-rate stats
        # were silently zeroed across checkpoints before)
        self.escapes = 0
        self.taint_trials = 0
        # v3: strata history for the post-stratified estimator (None when
        # the campaign runs unstratified or predates v3)
        self.strata: np.ndarray | None = None
        # v4: which resilience tier ran each trial (device/cpu/oracle) —
        # the per-structure half of the escalation budget
        self.tier_trials = np.zeros(len(TIERS), dtype=np.int64)

    @property
    def trials(self) -> int:
        return int(self.tallies.sum())

    def to_dict(self) -> dict:
        return {"tallies": self.tallies.tolist(),
                "next_batch": self.next_batch,
                "converged": self.converged, "done": self.done,
                "escapes": self.escapes, "taint_trials": self.taint_trials,
                "strata": (None if self.strata is None
                           else self.strata.tolist()),
                "tier_trials": self.tier_trials.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "_State":
        st = cls()
        st.tallies = np.asarray(d["tallies"], dtype=np.int64)
        st.next_batch = int(d["next_batch"])
        st.converged = bool(d["converged"])
        st.done = bool(d["done"])
        st.escapes = int(d["escapes"])
        st.taint_trials = int(d["taint_trials"])
        if d.get("strata") is not None:
            st.strata = np.asarray(d["strata"], dtype=np.int64)
        st.tier_trials = np.asarray(d["tier_trials"], dtype=np.int64)
        return st


# Frozen PRNG ids: NEVER renumber — checkpoints derive batch keys from
# these, so an edit here silently changes the sampled faults of resumed
# campaigns.  New structures append with fresh ids.
_STRUCTURE_IDS = {
    "regfile": 0, "fu": 1, "rob": 2, "iq": 3, "lsq": 4, "latch": 5,
    "cache:data": 6, "cache:tag": 7, "cache:state": 8,
    "mesi:state": 9, "mesi:tag": 10, "noc:router": 11,
}


def _avf32(tallies) -> float:
    """(SDC+DUE)/trials of a host tally in float32, as the reference's
    ``classify.avf`` computes it (its ``BatchInfo.avf`` and the ``avf``
    stat are float32 values)."""
    t = np.asarray(tallies, dtype=np.int64)
    return float(np.float32(t[C.OUTCOME_SDC] + t[C.OUTCOME_DUE])
                 / np.float32(max(int(t.sum()), 1)))


def _structure_id(structure: str) -> int:
    """Canonical frozen id (PRNG stability across resumes / plan edits /
    structure additions)."""
    return _STRUCTURE_IDS[structure]


class Orchestrator:
    def __init__(self, plan: CampaignPlan, mesh=None,
                 outdir: str | None = None, device=None):
        """``device=None`` runs on the CUDA card and raises without one;
        ``device="cpu"`` runs on the CPU.  ``mesh`` must be None: the
        campaign runs on one device."""
        if mesh is not None:
            raise NotImplementedError(
                f"a device mesh {LATER} (multi-GPU); pass mesh=None")
        # every option this slice does not run is refused here, before the
        # first trial (none of them is reachable from a default plan)
        tiers = [s for s in plan.structures if s in TIER_STRUCTURES]
        if tiers:
            raise NotImplementedError(
                f"the tier structures {tiers} (cache/MESI/NoC kernels) "
                f"{LATER}")
        if any(isinstance(sp, CheckpointSpec) for sp in plan.simpoints):
            raise NotImplementedError(
                f"CheckpointSpec simpoints (checkpoint ingest) {LATER}")
        if plan.analysis.certify != "off":
            raise NotImplementedError(
                f"static certification (analysis.certify="
                f"{plan.analysis.certify!r}) {LATER}")
        if plan.pipeline.compilation_cache_dir:
            raise NotImplementedError(
                "pipeline.compilation_cache_dir configures jax's persistent "
                "compilation cache, which the port has no counterpart of")
        plan.chaos.build()           # raises for a non-empty chaos plan
        self.plan = plan
        self.device = resolve_device(device)
        self.outdir = outdir
        # one device divides every batch size: the effective batch size is
        # the plan's (the reference rounds it up to its mesh size)
        self.batch_size = int(plan.batch_size)
        # federated single-campaign sharding (plan.shard_index/shard_count):
        # shard i of N serves the round-robin stripe {i, i+N, ...} of the
        # PARENT campaign's batch-id space; this orchestrator's local
        # batch ordinals map to global ids at the ONE key-derivation site
        # (_compute_batch via _global_batch_id).
        self.shard_index = int(plan.shard_index)
        self.shard_count = int(plan.shard_count)
        self._per_sp = list(plan.structures)
        self.state: dict[tuple[str, str], _State] = {
            (sp.name, s): _State()
            for sp in plan.simpoints for s in self._per_sp}
        self.results: dict[tuple[str, str], StructureResult] = {}
        self._kernels: dict[int, TrialKernel] = {}
        self._traces: dict[int, object] = {}
        self._campaigns: dict[tuple[int, str], ShardedCampaign] = {}
        # backend resilience: one watchdog + escalation budget per
        # orchestrator (backend health is a process property, not a
        # per-structure one); dispatchers are per-campaign ladders
        self.rcfg = plan.resilience
        self.watchdog = resil.DeviceWatchdog(self.rcfg.dispatch_timeout)
        self.budget = resil.EscalationBudget()
        # resume re-arm: the gate below fires only at/above this rate, so
        # a run aborted by the budget can be resumed against a healed
        # backend (rate falls → completes) yet still re-aborts while the
        # escalation is not improving (rate holds or grows)
        self._esc_baseline = 0.0
        self._dispatchers: dict[tuple[int, str],
                                resil.ResilientDispatcher] = {}
        self._esc_flagged = False
        self.aborted = False
        self.abort_reason = ""
        # result-integrity layer (integrity.py): one monitor per
        # orchestrator (result trust is a campaign property, like backend
        # health); dispatch goes through per-campaign checked wrappers
        self.icfg = plan.integrity
        self.monitor = integ.IntegrityMonitor(self.icfg)
        self._checked: dict[tuple[int, str], integ.CheckedDispatcher] = {}
        # resume re-arm, mirroring the escalation gate: an audit-aborted
        # run resumed against healthy kernels completes once the mismatch
        # rate falls below its restored baseline
        self._audit_flagged = False
        self._audit_baseline = 0.0
        # graceful preemption (SIGTERM/SIGINT drain): the handler only
        # sets a flag, the loop finishes its in-flight batch, checkpoints
        # and ends the stream with ExitEvent.PREEMPTED (CLI rc 4)
        self._drain = False
        self.preempted = False
        # pipelined engine (parallel/pipeline.py): sync_every > 1
        # accumulates intervals on the device; sync_every = 1 (the
        # default) is exactly the serial loop
        self.pcfg = plan.pipeline
        self._perf = pipeline_mod.PerfStats()
        self._engines: dict[tuple[int, str],
                            pipeline_mod.PipelinedEngine] = {}
        # run-until-CI with the stopping rule on the device
        # (pcfg.until_ci): one transfer per super-interval instead of
        # one per sync interval
        self._ci_engines: dict[tuple[int, str],
                               pipeline_mod.UntilCIEngine] = {}
        # probe points (utils/probes; gem5 ProbePoint pattern): listeners
        # attach without the orchestrator knowing who observes.  Payloads
        # are batch-granular — BatchInfo / StructureResult / ckpt path.
        self.probes = probes.ProbeManager("campaign")
        self.pp_batch = self.probes.add_point("BatchComplete")
        self.pp_structure = self.probes.add_point("StructureComplete")
        self.pp_checkpoint = self.probes.add_point("Checkpoint")
        self.pp_degraded = self.probes.add_point("BackendDegraded")
        # abnormal exits (integrity abort) dump the flight recorder here;
        # first registration wins
        if outdir and obs_trace.tracer().flight_path is None:
            obs_trace.tracer().set_flight_path(
                os.path.join(outdir, obs_trace.FLIGHT_NAME))
        self._build_stats()

    # --- chaos / elastic / preemption attachment ---

    def attach_chaos(self, engine) -> None:
        raise NotImplementedError(f"the chaos engine {LATER}")

    def attach_elastic(self, ctx) -> None:
        raise NotImplementedError(f"elastic multi-host campaigns {LATER}")

    def request_drain(self) -> None:
        """Ask the drive loop to stop at the next batch boundary, write a
        resumable checkpoint and end the stream (the graceful-preemption
        path; idempotent)."""
        self._drain = True

    def install_signal_handlers(self):
        """SIGTERM/SIGINT → graceful drain (finish the in-flight batch,
        checkpoint, exit resumable).  A second signal raises
        KeyboardInterrupt — the operator's escape hatch.  Returns a
        restore callable; no-op outside the main thread (signals cannot
        be installed there)."""
        import signal

        def _handler(signum, frame):
            if self._drain:
                raise KeyboardInterrupt
            self._drain = True
            debug.dprintf("Campaign", "signal %s: draining to checkpoint",
                          signum)

        try:
            prev = {s: signal.signal(s, _handler)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:        # not the main thread
            return lambda: None
        return lambda: [signal.signal(s, h) for s, h in prev.items()]

    # --- stats tree (statistics::Group bound to the object tree) ---

    def _build_stats(self) -> None:
        self.stats = statsmod.Group("campaign")
        sweep = [(sp.name, self._per_sp) for sp in self.plan.simpoints]
        for sp_name, structures in sweep:
            g = statsmod.Group(sp_name)
            setattr(self.stats, f"sp_{sp_name}", g)
            for s in structures:
                sg = statsmod.Group(s)
                setattr(g, f"st_{s}", sg)
                sg.trials = statsmod.Scalar("trials", "trials run")
                sg.outcomes = statsmod.Vector(
                    "outcomes", C.N_OUTCOMES, "outcome tally",
                    subnames=list(C.OUTCOME_NAMES))
                st = self.state[(sp_name, s)]
                sg.avf = statsmod.Formula(
                    "avf", lambda st=st: _avf32(st.tallies),
                    "(SDC+DUE)/trials")
                sg.tiers = statsmod.Vector(
                    "tier_trials", len(TIERS),
                    "trials per resilience tier", subnames=list(TIERS))
        # campaign-level escalation accounting: the 'is the device number
        # really a device number' ledger (resilience.EscalationBudget)
        rg = statsmod.Group("resilience")
        self.stats.resilience = rg
        rg.tier_trials = statsmod.Formula(
            "tier_trials",
            lambda: {t: int(c) for t, c in zip(TIERS, self.budget.counts)},
            "trials per execution tier, campaign-wide")
        rg.escalation_rate = statsmod.Formula(
            "escalation_rate", lambda: self.budget.rate(),
            "fraction of trials that ran below the device tier")
        rg.dispatch_timeouts = statsmod.Formula(
            "dispatch_timeouts", lambda: self.watchdog.timeouts,
            "dispatches the watchdog declared wedged")
        rg.retries = statsmod.Formula(
            "retries",
            lambda: sum(d.retries for d in self._dispatchers.values()),
            "re-dispatch attempts beyond each first try")
        rg.leaked_threads = statsmod.Formula(
            "leaked_threads", lambda: self.watchdog.leaked_threads,
            "abandoned watchdog dispatch threads still alive")
        # chaos and elastic accounting: the engines come with later
        # slices, so the groups hold the reference's zeros (the stats
        # layout stays the reference's)
        cg = statsmod.Group("chaos")
        self.stats.chaos = cg
        cg.injected = statsmod.Formula(
            "injected", lambda: {}, "faults injected per kind (chaos plan)")
        cg.survived = statsmod.Formula(
            "survived", lambda: {},
            "injected faults the stack recovered from, per kind")
        cg.dispatches = statsmod.Formula(
            "dispatches", lambda: 0,
            "batches this process computed under the chaos schedule")
        eg = statsmod.Group("elastic")
        self.stats.elastic = eg
        for name, desc in (
                ("workers_lost", "peers declared lost (heartbeat stale)"),
                ("leases_claimed", "batch leases this worker won"),
                ("leases_adopted", "peer-computed batches adopted"),
                ("leases_revoked", "lost workers' leases revoked"),
                ("batches_reclaimed",
                 "revoked batches this worker re-dispatched")):
            setattr(eg, name, statsmod.Formula(name, lambda: 0, desc))
        eg.collective_timeouts = statsmod.Formula(
            "collective_timeouts",
            lambda: sum(c.collective_timeouts
                        for c in self._campaigns.values()),
            "device-step deadlines (possible lost-peer symptom)")
        # result-integrity accounting: the 'and the tallies were audited'
        # ledger (integrity.IntegrityMonitor) — canary outcomes, invariant
        # checks, differential-audit mismatches, quarantine/recovery
        mon = self.monitor
        ig = statsmod.Group("integrity")
        self.stats.integrity = ig
        ig.canary_trials = statsmod.Formula(
            "canary_trials", lambda: mon.canary_trials,
            "canary trials run (known-outcome salting)")
        ig.canary_failures = statsmod.Formula(
            "canary_failures", lambda: mon.canary_failures,
            "canary trials that missed their constructed outcome")
        ig.invariant_checks = statsmod.Formula(
            "invariant_checks", lambda: mon.invariant_checks +
            sum(c.shard_checks for c in self._campaigns.values()),
            "tally/monotone/shard invariant evaluations")
        ig.invariant_violations = statsmod.Formula(
            "invariant_violations", lambda: mon.invariant_violations,
            "invariant evaluations that failed")
        ig.audited_trials = statsmod.Formula(
            "audited_trials", lambda: mon.ledger.audited,
            "trials re-run on the alternate kernel")
        ig.audit_mismatches = statsmod.Formula(
            "audit_mismatches", lambda: mon.ledger.mismatched,
            "audited trials whose outcomes disagreed")
        ig.audit_mismatch_rate = statsmod.Formula(
            "audit_mismatch_rate", lambda: mon.ledger.rate(),
            "mismatched / audited")
        ig.quarantined_batches = statsmod.Formula(
            "quarantined_batches", lambda: mon.quarantined,
            "batches whose tally failed canary/invariant checks")
        ig.requeues = statsmod.Formula(
            "requeues", lambda: mon.requeues,
            "quarantined-batch re-dispatches down the ladder")
        ig.recovered_batches = statsmod.Formula(
            "recovered_batches", lambda: mon.recovered,
            "quarantined batches recovered with a clean tally")
        # pipeline performance accounting: device/host seconds, the
        # overlap fraction, the until-CI ledger and the shared-kernel
        # registry are first-class stats.  The names are the reference's;
        # the port's executables_* count TrialKernels built and reused
        # (parallel/exec_cache.py), and its round trips are its own
        # device→host copies
        perf = self._perf
        pg = statsmod.Group("perf")
        self.stats.perf = pg
        pg.device_step_seconds = statsmod.Formula(
            "device_step_seconds", lambda: perf.device_step_seconds,
            "dispatch-to-materialization latency summed over intervals")
        pg.device_wait_seconds = statsmod.Formula(
            "device_wait_seconds", lambda: perf.device_wait_seconds,
            "host time BLOCKED waiting on device results")
        pg.host_seconds = statsmod.Formula(
            "host_seconds", lambda: perf.host_seconds,
            "host-side work time while intervals were in flight")
        pg.overlap_fraction = statsmod.Formula(
            "overlap_fraction", lambda: perf.overlap_fraction(),
            "fraction of device latency hidden behind host work")
        pg.dispatch_depth = statsmod.Formula(
            "dispatch_depth", lambda: perf.depth_hwm,
            "in-flight interval high-water mark")
        pg.intervals = statsmod.Formula(
            "intervals", lambda: perf.intervals,
            "sync intervals believed through the pipelined path")
        pg.serial_fallbacks = statsmod.Formula(
            "serial_fallbacks", lambda: perf.serial_fallbacks,
            "intervals recovered through the serial per-batch ladder")
        pg.super_intervals = statsmod.Formula(
            "super_intervals", lambda: perf.super_intervals,
            "until-CI super-intervals believed through the device-resident "
            "stopping loop")
        pg.host_roundtrips_saved = statsmod.Formula(
            "host_roundtrips_saved", lambda: perf.host_roundtrips_saved,
            "device->host copies avoided vs the per-batch host loop "
            "(batches consumed minus the copies and stop-flag reads the "
            "device loop made; may be negative)")
        pg.hw_trajectory_final = statsmod.Formula(
            "hw_trajectory_final", lambda: perf.hw_trajectory_final,
            "last half-width the device-resident stopping rule observed "
            "(NaN until a super-interval has run; stats.json nulls it)")
        pg.auto_sync_every = statsmod.Formula(
            "auto_sync_every", lambda: perf.auto_sync_every,
            "last super-interval budget the half-width-trajectory "
            "planner chose (the auto-tuned effective sync_every)")
        pg.executables_compiled = statsmod.Formula(
            "executables_compiled", lambda: exec_cache.cache().compiled,
            "TrialKernels built (process-wide shared-kernel registry)")
        pg.executables_reused = statsmod.Formula(
            "executables_reused", lambda: exec_cache.cache().reused,
            "TrialKernels reused from the shared-kernel registry")
        pg.executables_certified = statsmod.Formula(
            "executables_certified",
            lambda: sum(1 for c in exec_cache.cache().certificates.values()
                        if c.get("ok")),
            "certified executables (the port certifies none)")
        pg.executables_refused = statsmod.Formula(
            "executables_refused", lambda: exec_cache.cache().refused,
            "executables refused admission (the port refuses none)")
        pg.exec_cache_keys = statsmod.Formula(
            "exec_cache_keys",
            lambda: exec_cache.cache().per_key_stats(),
            "per-kernel-key hit/miss/evict counters of the shared-kernel "
            "registry")
        # observability accounting (obs/): the tracer's own
        # ledger — zeros while tracing is disabled (the no-op constant)
        og = statsmod.Group("obs")
        self.stats.obs = og
        og.tracing = statsmod.Formula(
            "tracing", lambda: 1 if obs_trace.tracer().enabled else 0,
            "1 while a live tracer is installed (0 = no-op constant)")
        og.events_emitted = statsmod.Formula(
            "events_emitted", lambda: obs_trace.tracer().emitted,
            "structured events emitted process-wide")
        og.events_dropped = statsmod.Formula(
            "events_dropped", lambda: obs_trace.tracer().dropped,
            "ring overwrites (events no longer in the flight window)")
        og.flight_dumps = statsmod.Formula(
            "flight_dumps", lambda: obs_trace.tracer().flight_dumps,
            "flight-recorder dumps written (abnormal-exit artifacts)")
        og.events_by_name = statsmod.Formula(
            "events_by_name",
            lambda: dict(sorted(obs_trace.tracer().by_name.items())),
            "event count per name (the trace's table of contents)")
        # refresh from restored state (resume path)
        for (spn, s), st in self.state.items():
            sg = getattr(getattr(self.stats, f"sp_{spn}"), f"st_{s}")
            sg.trials.set(st.trials)
            sg.outcomes.reset()
            sg.outcomes += st.tallies
            sg.tiers.reset()
            sg.tiers += st.tier_trials

    # --- lazy elaboration ---

    def trace(self, sp_idx: int):
        if sp_idx not in self._traces:
            self._traces[sp_idx] = self.plan.simpoints[sp_idx].build_trace()
        return self._traces[sp_idx]

    def kernel(self, sp_idx: int) -> TrialKernel:
        if sp_idx not in self._kernels:
            # content-keyed kernel sharing (exec_cache.shared_kernel):
            # orchestrators over the same window, machine config and
            # device reuse one TrialKernel (one scoreboard, FU-pool
            # schedule and golden record per process).  Escape counters
            # are consumed as deltas, so sharing cannot leak state across
            # campaigns.
            import json as _json

            trace = self.trace(sp_idx)
            cfg_fp = _json.dumps(self.plan.machine.to_dict(),
                                 sort_keys=True, default=str)
            self._kernels[sp_idx] = exec_cache.shared_kernel(
                trace, cfg_fp,
                lambda: TrialKernel(trace, self.plan.machine,
                                    device=self.device),
                device=self.device)
        return self._kernels[sp_idx]

    def campaign(self, sp_idx: int, structure: str) -> ShardedCampaign:
        key = (sp_idx, structure)
        if key not in self._campaigns:
            kernel = self.kernel(sp_idx)
            # the shared watchdog guards only the device step inside the
            # campaign (ShardedCampaign._dispatch): a timed-out step raises
            # BEFORE any host-side counter mutation, so an orphaned
            # dispatch thread that completes late ran only pure device
            # work and cannot corrupt kernel.escapes/taint_trials
            self._campaigns[key] = ShardedCampaign(
                kernel, None, structure, stratify=self.plan.stratify,
                watchdog=self.watchdog,
                integrity_check=self.icfg.invariants)
        return self._campaigns[key]

    def dispatcher(self, sp_idx: int, structure: str
                   ) -> resil.ResilientDispatcher:
        """The retry/degradation ladder for one campaign (resilience.py):
        shares the orchestrator's watchdog so backend health is judged
        across structures, not per-structure."""
        key = (sp_idx, structure)
        if key not in self._dispatchers:
            self._dispatchers[key] = resil.dispatcher_for_campaign(
                self.campaign(sp_idx, structure), self.rcfg,
                watchdog=self.watchdog)
        return self._dispatchers[key]

    def checked_dispatcher(self, sp_idx: int, sp_name: str, structure: str
                           ) -> integ.CheckedDispatcher:
        """The integrity-enforcing wrapper around one campaign's resilient
        dispatch (canaries + tally invariants + differential audit);
        shares the orchestrator-wide monitor."""
        key = (sp_idx, structure)
        if key not in self._checked:
            sk = self._structure_prng_key(sp_idx, structure)
            self._checked[key] = integ.checked_dispatcher_for(
                self.dispatcher(sp_idx, structure),
                self.campaign(sp_idx, structure), self.monitor,
                sp_name, structure, structure_key=sk)
        return self._checked[key]

    def engine(self, sp_idx: int, sp_name: str, structure: str
               ) -> pipeline_mod.PipelinedEngine:
        """The pipelined engine for one campaign (parallel/pipeline.py):
        shares the orchestrator's integrity monitor and perf
        ledger; recovery routes through the same checked dispatcher the
        serial loop uses, so failure semantics are identical."""
        key = (sp_idx, structure)
        if key not in self._engines:
            self._engines[key] = pipeline_mod.PipelinedEngine(
                self.campaign(sp_idx, structure),
                self.checked_dispatcher(sp_idx, sp_name, structure),
                self._structure_prng_key(sp_idx, structure),
                self.batch_size, self._ceiling_batches,
                sync_every=self.pcfg.sync_every, depth=self.pcfg.depth,
                monitor=self.monitor, perf=self._perf,
                sp_name=sp_name, structure=structure)
        return self._engines[key]

    def until_ci_engine(self, sp_idx: int, sp_name: str, structure: str
                        ) -> pipeline_mod.UntilCIEngine:
        """The device-resident until-CI engine for one campaign: shares
        the orchestrator's integrity monitor and perf
        ledger; its recovery path routes through the same checked
        dispatcher the serial loop uses, re-deriving the stopping
        decision with the HOST rule."""
        key = (sp_idx, structure)
        if key not in self._ci_engines:
            self._ci_engines[key] = pipeline_mod.UntilCIEngine(
                self.campaign(sp_idx, structure),
                self.checked_dispatcher(sp_idx, sp_name, structure),
                self._structure_prng_key(sp_idx, structure),
                self.batch_size, self.monitor,
                min_trials=int(self.plan.min_trials),
                target_halfwidth=float(self.plan.target_halfwidth),
                confidence=float(self.plan.confidence),
                perf=self._perf,
                sp_name=sp_name, structure=structure)
        return self._ci_engines[key]

    @property
    def _ceiling_batches(self) -> int:
        """Batches the stopping rule could possibly consume (the
        ``max_trials`` ceiling) — the ONE definition the pipelined
        engine's dispatch-ahead bound and ``_interval_len``'s ragged
        final interval must share (a divergence would make ``_fill``
        raise its past-the-ceiling error)."""
        return -(-int(self.plan.max_trials) // self.batch_size)

    def _interval_len(self, st: _State, camp: ShardedCampaign,
                      key: tuple | None = None) -> int:
        """Effective sync-interval length for one campaign's next
        dispatch: the plan's ``sync_every`` bounded by the remaining
        batch budget (the ragged final interval before ``max_trials``)
        AND by the half-width trajectory (below), or 0 — the serial
        per-batch loop — where pipelining cannot apply: sharded
        campaigns stripe individual batches, and host-resolution /
        chunked campaigns have no device-accumulable step.  A
        1-batch ragged TAIL of a pipelined campaign still returns 1
        (not 0): the engine may already hold that batch in flight from
        dispatch-ahead, and consuming it there avoids recomputing it
        serially.

        **Adaptive shrink**: a fixed interval checks the stopping rule
        every ``sync_every`` batches, so a campaign that would converge
        mid-interval overruns by up to ``sync_every - 1`` batches — on
        small/fast campaigns (the NORTHSTAR regime: ~2-3 batches each)
        that overshoot eats the whole pipelining win.  The Wilson
        half-width is ~∝ 1/√n at a stable p̂, so the trials still
        needed are ~ n·((hw/target)² − 1); the interval is clamped to
        that distance.  Far from convergence the full ``sync_every``
        throughput applies; near it the check cadence degenerates to
        the serial per-batch loop exactly — overshoot goes to ~zero
        while tallies stay bit-identical (grouping never changes the
        frozen keys).  Two shape rules keep the adaptivity from eating
        its own win: interval lengths are quantized DOWN to powers of
        two (the AOT interval step is shape-specialized per S, so a
        free-running S ∈ {1..sync_every} would compile log-many more
        executables than it amortizes; rounding down only adds checks,
        never overshoot), and a 1-batch ask routes through the plain
        serial batch step (shared with the canary/recovery paths)
        unless the engine already holds that batch in flight from
        dispatch-ahead."""
        k = int(self.pcfg.sync_every)
        if k <= 1 or self.shard_count > 1 or not camp.supports_intervals:
            return 0
        k = max(1, min(k, self._ceiling_batches - st.next_batch))
        need = self._trials_needed(st, camp)
        k = max(1, min(k, -(-int(max(need, 1)) // self.batch_size)))
        k = 1 << (k.bit_length() - 1)          # power-of-two quantization
        if k == 1 and not self._engine_holds(key, st):
            return 0
        return k

    def _trials_needed(self, st: _State, camp: ShardedCampaign) -> float:
        """Trials the stopping rule still plausibly needs — delegated to
        ``stopping.eta_trials``, the ONE convergence-distance estimator
        shared by the adaptive sync interval, the until-CI super-interval
        planner, and the published per-tenant ETA the federation gateway
        routes on (``obs/metrics``): the planners and the service tier
        must never disagree about how far a campaign is from stopping."""
        vulnerable = int(st.tallies[C.OUTCOME_SDC] +
                         st.tallies[C.OUTCOME_DUE])
        return stopping.eta_trials(
            vulnerable, st.trials, st.strata, camp.stratify,
            self.plan.confidence, self.plan.target_halfwidth,
            self.plan.min_trials)

    def _until_ci_len(self, st: _State, camp: ShardedCampaign) -> int:
        """Super-interval budget for the device-resident until-CI step
        (``pcfg.until_ci``), or 0 where the stopping rule cannot run on
        the device (sharded, host-resolution or chunked campaigns, or
        cumulative counts past the device loop's int32 accumulators).

        The planner auto-tunes the effective sync interval from the
        observed half-width trajectory: plan 2× the trials-needed
        estimate (the estimate assumes a stable p̂, and planned-but-
        unconsumed batches cost only key staging — the device loop exits
        at the exact stopping boundary, so overshooting the PLAN never
        overshoots the TRIALS), rounded UP to a power of two (the
        reference's bound on its shape-specialized executables, kept so
        the budgets are the reference's), clamped by the remaining
        max_trials ceiling and the bounded super-interval budget
        (``pcfg.max_super_interval`` — integrity checks must keep gating
        cumulative deltas at a bounded cadence)."""
        if (not self.pcfg.until_ci or self.shard_count > 1
                or not camp.supports_intervals):
            return 0
        # the device loop counts trials and tallies in int32: every count
        # it can reach is bounded by ceiling_batches*batch_size, so gate
        # on that product (max_trials alone is off by up to one batch)
        if self._ceiling_batches * self.batch_size >= 2 ** 31:
            return 0
        remaining = self._ceiling_batches - st.next_batch
        if remaining < 1:
            return 0
        need = max(self._trials_needed(st, camp), float(self.batch_size))
        k = -(-int(need) // self.batch_size) * 2
        k = 1 << (k - 1).bit_length()              # next power of two, up
        k = max(1, min(k, remaining, int(self.pcfg.max_super_interval)))
        return k

    def _engine_holds(self, key: tuple | None, st: _State) -> bool:
        """Whether THIS campaign's engine dispatch-ahead queue already
        holds ``st.next_batch`` as a 1-BATCH in-flight interval (the
        ragged-tail case: consuming it from the queue beats recomputing
        it through the serial step).  The length must match too — a
        1-batch ask against a held LONGER interval would make ``_fill``
        drop the whole in-flight window and re-dispatch, which is
        strictly worse than the serial route."""
        eng = self._engines.get(key) if key is not None else None
        return bool(eng is not None and eng._q
                    and eng._q[0].b0 == st.next_batch
                    and eng._q[0].k == 1)

    def _structure_prng_key(self, sp_idx: int, structure: str):
        """The frozen PRNG key every batch of one (simpoint, structure)
        campaign derives from — the single source both the drive loop and
        the seed-canary stream must share (a divergence here would verify
        canaries against the wrong fault stream)."""
        return prng.structure_key(
            prng.simpoint_key(prng.campaign_key(self.plan.seed, self.device),
                              sp_idx),
            _structure_id(structure))

    # --- the drive loop ---

    def stepper(self) -> "StepDriver":
        """The step-wise view of this campaign (service/scheduler.py): a
        ``StepDriver`` whose ``tick()`` advances exactly one scheduling
        quantum — one obtained batch (serial) or one sync interval
        (pipelined) — and hands control back.  The run-to-completion
        loop is ``for ev in orch.events()``; a multi-tenant scheduler
        instead interleaves many campaigns' ticks over one mesh."""
        return StepDriver(self)

    def events(self) -> Iterator[tuple[ExitEvent, object]]:
        """Advance the whole plan, yielding control at every typed event."""
        plan = self.plan
        for sp_idx, sp in enumerate(plan.simpoints):
            for structure in self._per_sp:
                st = self.state[(sp.name, structure)]
                if st.done:
                    continue
                yield from self._run_structure(sp_idx, sp.name, structure, st)
                if self.aborted or self.preempted:
                    return    # budget abort / drain: no CAMPAIGN_COMPLETE
            yield ExitEvent.SIMPOINT_COMPLETE, sp.name
        yield ExitEvent.CAMPAIGN_COMPLETE, dict(self.results)

    def _run_structure(self, sp_idx: int, sp_name: str, structure: str,
                       st: _State) -> Iterator[tuple[ExitEvent, object]]:
        plan = self.plan
        camp = self.campaign(sp_idx, structure)
        sk = self._structure_prng_key(sp_idx, structure)
        sg = getattr(getattr(self.stats, f"sp_{sp_name}"), f"st_{structure}")
        t0 = obs_clock.monotonic()
        while True:
            # stopping rule first, so a resumed campaign re-evaluates the
            # restored tallies instead of running one extra batch (the
            # checkpoint may have been cut between a batch and its check)
            vulnerable = int(st.tallies[C.OUTCOME_SDC] +
                             st.tallies[C.OUTCOME_DUE])
            avf_now = vulnerable / max(st.trials, 1)
            # strata cover every counted trial only when the whole history
            # ran stratified (v3 fresh run or faithful resume)
            strata_ok = camp.stratify and stopping.strata_cover_trials(
                st.strata, st.trials)
            if strata_ok:
                pairs = stopping.pairs_from_strata(st.strata)
                converged = st.trials > 0 and stopping.should_stop_stratified(
                    pairs, plan.target_halfwidth, plan.confidence,
                    plan.min_trials)
            else:
                converged = st.trials > 0 and stopping.should_stop(
                    vulnerable, st.trials, plan.target_halfwidth,
                    plan.confidence, plan.min_trials)
            capped = st.trials >= plan.max_trials
            if converged or capped:
                st.converged = converged
                st.done = True
                result = StructureResult(
                    simpoint=sp_name, structure=structure,
                    tallies=st.tallies.copy(), trials=st.trials,
                    avf=avf_now,
                    avf_interval=(stopping.post_stratified(
                        pairs, plan.confidence) if strata_ok
                        else stopping.wilson(vulnerable, st.trials,
                                             plan.confidence)),
                    sdc_interval=stopping.wilson(
                        int(st.tallies[C.OUTCOME_SDC]), st.trials,
                        plan.confidence),
                    converged=converged,
                    wall_seconds=obs_clock.monotonic() - t0)
                self.results[(sp_name, structure)] = result
                self.pp_structure.notify(result)
                obs_trace.tracer().emit(
                    "structure_complete", cat="campaign", sp=sp_name,
                    structure=structure, trials=int(st.trials),
                    converged=bool(converged))
                yield (ExitEvent.CI_CONVERGED if converged
                       else ExitEvent.MAX_TRIALS), result
                return

            # graceful preemption: the drain flag is only ever honored at
            # a batch boundary (the Drainable posture — no device work in
            # flight), so the in-flight batch always completes first
            if self._drain:
                self.preempted = True
                ckpt = self.checkpoint() if self.outdir else None
                yield ExitEvent.PREEMPTED, ckpt
                return
            # obtain this batch's believed tally through the
            # integrity-checked resilience ladder (a batch, a sync interval
            # or an until-CI super-interval)
            try:
                if (s_ci := self._until_ci_len(st, camp)) >= 1:
                    doc = self._compute_until_ci(
                        sp_idx, sp_name, structure, camp, st, s_ci)
                elif (k_int := self._interval_len(
                        st, camp, (sp_idx, structure))) >= 1:
                    doc = self._compute_interval(
                        sp_idx, sp_name, structure, camp,
                        st.next_batch, k_int)
                else:
                    doc = self._compute_batch(sp_idx, sp_name, structure,
                                              camp, sk, st.next_batch)
            except integ.IntegrityError:
                # unrecoverable corruption: every re-dispatch failed the
                # checks.  The corrupt batch is NOT counted; leave the
                # evidence + a resumable checkpoint and end the stream
                # (events() sees .aborted; the CLI exits rc 3)
                self.aborted = True
                self.abort_reason = "integrity violation"
                self._persist_evidence(flight=False)
                for ev in self.monitor.take_events():
                    yield ExitEvent.INTEGRITY_VIOLATION, ev
                if self.outdir:
                    self.checkpoint()
                obs_trace.flight_dump(
                    self.outdir, "integrity_violation", sp=sp_name,
                    structure=structure, batch_id=int(st.next_batch))
                return
            if camp.stratify and doc.get("strata") is not None:
                sarr = np.asarray(doc["strata"], dtype=np.int64)
                if st.strata is None:
                    st.strata = np.zeros_like(sarr)
                st.strata += sarr
            tally = np.asarray(doc["tally"], dtype=np.int64)
            tier = int(doc.get("tier", resil.TIER_DEVICE))
            # a pipelined doc covers a whole sync interval: n_batches > 1,
            # optionally with per-batch tier provenance from a recovery
            n_batches = int(doc.get("n_batches", 1))
            n_new = self.batch_size * n_batches
            tiers_list = [int(t) for t in
                          (doc.get("tiers") or [tier] * n_batches)]
            # cumulative-monotonicity invariant: belt-and-braces over the
            # per-batch checks (a non-negative tally cannot regress the
            # cumulative counters, so a trip here means host-side state
            # corruption — not requeueable, abort resumable)
            if self.icfg.invariants:
                self.monitor.invariant_checks += 1
                mviol = integ.monotone_violations(st.tallies,
                                                  st.tallies + tally)
                if mviol:
                    self.monitor.invariant_violations += 1
                    self.monitor.record_quarantine({
                        "kind": "invariant", "simpoint": sp_name,
                        "structure": structure,
                        "batch_id": st.next_batch,
                        "problems": [{"kind": "invariant",
                                      "violations": mviol}],
                        "fatal": True})
                    self.aborted = True
                    self.abort_reason = "integrity violation"
                    self._persist_evidence(flight=False)
                    for ev in self.monitor.take_events():
                        yield ExitEvent.INTEGRITY_VIOLATION, ev
                    if self.outdir:
                        self.checkpoint()
                    obs_trace.flight_dump(
                        self.outdir, "integrity_violation", sp=sp_name,
                        structure=structure,
                        batch_id=int(st.next_batch))
                    return
            st.tallies += tally
            prev_nb = st.next_batch
            st.next_batch += n_batches
            st.escapes += int(doc.get("escapes", 0))
            st.taint_trials += int(doc.get("taint_trials", 0))
            for t in tiers_list:
                st.tier_trials[t] += self.batch_size
                self.budget.record(t, self.batch_size)
                sg.tiers.add(t, self.batch_size)
            sg.trials += n_new
            sg.outcomes += tally
            avf_live = _avf32(st.tallies)
            obs_trace.tracer().emit(
                "batch_believed", cat="campaign", sp=sp_name,
                structure=structure, b0=int(prev_nb),
                n_batches=int(n_batches), trials=int(st.trials),
                tier=TIERS[tier], adopted=False)
            debug.dprintf("Campaign", "%s/%s batch %d: trials=%d avf=%.4f"
                          " tier=%s", sp_name, structure, st.next_batch,
                          st.trials, avf_live, TIERS[tier])
            info = BatchInfo(
                sp_name, structure, st.next_batch - 1, st.trials,
                st.tallies.copy(), avf_live, tier)
            if tier != resil.TIER_DEVICE:
                dinfo = DegradeInfo(sp_name, structure, st.next_batch - 1,
                                    tier, int(doc.get("attempts", 1)))
                self.pp_degraded.notify(dinfo)
                yield ExitEvent.BACKEND_DEGRADED, dinfo
            self.pp_batch.notify(info)
            yield ExitEvent.BATCH_COMPLETE, info

            # integrity evidence (quarantine/recovery/shard events) from
            # the checked dispatch surfaces as typed events after the
            # batch that produced it, with the record already on disk
            events = self.monitor.take_events()
            if events:
                self._persist_evidence()
                for ev in events:
                    yield ExitEvent.INTEGRITY_VIOLATION, ev

            # audit mismatch budget — the differential-audit mirror of
            # the escalation gate below (same re-arm-on-resume shape)
            if (self.icfg.audit_action != "off"
                    and not self._audit_flagged
                    and self.monitor.ledger.over(self.icfg.audit_threshold)
                    and self.monitor.ledger.rate() >= self._audit_baseline):
                self._audit_flagged = True
                ainfo = integ.AuditBudgetInfo(
                    self.monitor.ledger.rate(), self.icfg.audit_threshold,
                    self.icfg.audit_action,
                    dict(self.monitor.ledger.reasons))
                self._persist_evidence(flight=False)
                # one dump with the SPECIFIC reason on warn and abort
                # alike — the generic quarantine_evidence label would
                # misattribute an audit-budget breach (possibly with
                # zero quarantines) to a quarantine that never happened
                obs_trace.flight_dump(
                    self.outdir, "audit_budget", sp=sp_name,
                    structure=structure,
                    rate=self.monitor.ledger.rate(),
                    action=self.icfg.audit_action)
                yield ExitEvent.INTEGRITY_VIOLATION, ainfo
                if self.icfg.audit_action == "abort":
                    self.aborted = True
                    self.abort_reason = "audit mismatch budget"
                    if self.outdir:
                        self.checkpoint()
                    return

            if (self.rcfg.escalation_action != "off"
                    and not self._esc_flagged
                    and self.budget.over(self.rcfg.escalation_threshold)
                    and self.budget.rate() >= self._esc_baseline):
                self._esc_flagged = True
                einfo = EscalationInfo(
                    self.budget.rate(), self.rcfg.escalation_threshold,
                    self.rcfg.escalation_action,
                    {t: int(c) for t, c in zip(TIERS, self.budget.counts)})
                yield ExitEvent.ESCALATION_EXCEEDED, einfo
                if self.rcfg.escalation_action == "abort":
                    # leave a resumable checkpoint, then end the stream
                    # (events() sees .aborted and never claims completion)
                    self.aborted = True
                    self.abort_reason = "escalation budget"
                    if self.outdir:
                        self.checkpoint()
                    obs_trace.flight_dump(
                        self.outdir, "escalation_budget", sp=sp_name,
                        structure=structure, rate=self.budget.rate())
                    return

            # interval-aware cadence: a sync interval may jump next_batch
            # past the exact multiple, so checkpoint on every CROSSING of
            # a checkpoint_every boundary (identical to % == 0 when
            # n_batches == 1)
            if (plan.checkpoint_every and self.outdir and
                    st.next_batch // plan.checkpoint_every
                    > prev_nb // plan.checkpoint_every):
                ckpt = self.checkpoint()
                self.pp_checkpoint.notify(ckpt)
                obs_trace.tracer().emit(
                    "checkpoint", cat="campaign", sp=sp_name,
                    structure=structure, next_batch=int(st.next_batch))
                yield ExitEvent.CHECKPOINT, ckpt

    def _global_batch_id(self, batch_id: int) -> int:
        """Map this shard's local batch ordinal to its global id in the
        parent campaign's batch-id space (round-robin stripe: shard i of
        N serves {i, i+N, i+2N, ...}); the identity when unsharded.
        Per-batch tallies are pure functions of their frozen per-batch
        PRNG keys, so a shard re-dispatches exactly the batches the solo
        run would have — the gateway's order-fixed fold of shard tallies
        is bit-identical to the solo accumulation."""
        if self.shard_count <= 1:
            return batch_id
        return self.shard_index + batch_id * self.shard_count

    def _compute_batch(self, sp_idx: int, sp_name: str, structure: str,
                       camp, sk, batch_id: int) -> dict:
        """Dispatch ONE batch through the integrity-checked resilience
        ladder and return its believed result as a JSON-serializable
        document (the lease board's publish format; the local path uses
        the same shape so accumulation is one code path).

        Sharded campaigns map the local ordinal to its GLOBAL batch id
        up front: key derivation, integrity evidence, and the published
        document all speak global coordinates, exactly as the solo run
        would."""
        batch_id = self._global_batch_id(batch_id)
        keys = prng.trial_keys(prng.batch_key(sk, batch_id),
                               self.batch_size)
        # per-structure DELTAS of the kernel's shared running escape
        # counters (one kernel serves every structure of a simpoint, and
        # resume restores prior counts — assignment would clobber)
        esc0 = int(getattr(camp.kernel, "escapes", 0))
        tt0 = int(getattr(camp.kernel, "taint_trials", 0))
        res = self.checked_dispatcher(sp_idx, sp_name, structure
                                      ).tally_batch(
            keys, stratified=camp.stratify, batch_id=batch_id)
        return {
            "batch_id": int(batch_id),
            "batch_size": int(self.batch_size),
            "tally": np.asarray(res.tally, dtype=np.int64).tolist(),
            "strata": (None if res.strata is None
                       else np.asarray(res.strata, np.int64).tolist()),
            "tier": int(res.tier),
            "attempts": int(res.attempts),
            "escapes": int(getattr(camp.kernel, "escapes", 0)) - esc0,
            "taint_trials": (int(getattr(camp.kernel, "taint_trials", 0))
                             - tt0),
        }

    def _compute_interval(self, sp_idx: int, sp_name: str, structure: str,
                          camp, b0: int, k: int) -> dict:
        """Obtain ONE sync interval (k batches) through the pipelined
        engine.  Same believed-result document shape as ``_compute_batch``
        plus ``n_batches``/``tiers``; integrity checks run on the interval
        deltas, and any failure recovers through the serial per-batch
        ladder on frozen keys (parallel/pipeline.py)."""
        esc0 = int(getattr(camp.kernel, "escapes", 0))
        tt0 = int(getattr(camp.kernel, "taint_trials", 0))
        doc = self.engine(sp_idx, sp_name, structure).obtain(
            b0, k, stratified=camp.stratify)
        doc["escapes"] = int(getattr(camp.kernel, "escapes", 0)) - esc0
        doc["taint_trials"] = (int(getattr(camp.kernel, "taint_trials", 0))
                               - tt0)
        return doc

    def _compute_until_ci(self, sp_idx: int, sp_name: str, structure: str,
                          camp, st: _State, S: int) -> dict:
        """Obtain ONE device-resident until-CI super-interval (budget S
        batches; the device decides how many it consumes).  Same believed-
        result document shape as ``_compute_interval`` — ``n_batches`` is
        the device-decided consumed count, recorded into the checkpoint
        through the ordinary accumulation path."""
        b0 = st.next_batch
        esc0 = int(getattr(camp.kernel, "escapes", 0))
        tt0 = int(getattr(camp.kernel, "taint_trials", 0))
        # the stratified rule applies iff the strata history covers every
        # counted trial — for a FRESH stratified campaign (no batches
        # yet, strata still None) it covers vacuously, exactly as the
        # serial loop's check does from its first accumulated batch on
        strat_rule = camp.stratify and (
            st.trials == 0 or stopping.strata_cover_trials(
                st.strata, st.trials))
        doc = self.until_ci_engine(sp_idx, sp_name, structure).obtain(
            b0, S, st.tallies, st.strata if camp.stratify else None,
            strat_rule)
        doc["escapes"] = int(getattr(camp.kernel, "escapes", 0)) - esc0
        doc["taint_trials"] = (int(getattr(camp.kernel, "taint_trials", 0))
                               - tt0)
        return doc

    # --- outputs (the m5out contract) ---

    def write_outputs(self) -> None:
        """outdir/{config.json, stats.txt, stats.json} — the reference's run
        artifacts (``python/m5/main.py:227-248``, ``base/stats/text.cc``)."""
        if not self.outdir:
            return
        os.makedirs(self.outdir, exist_ok=True)
        self.plan.dump_json(os.path.join(self.outdir, "config.json"))
        with open(os.path.join(self.outdir, "stats.txt"), "w") as f:
            statsmod.dump_text(self.stats, f)
        with open(os.path.join(self.outdir, "stats.json"), "w") as f:
            statsmod.dump_json(self.stats, f)
        try:
            statsmod.dump_hdf5(self.stats,
                               os.path.join(self.outdir, "stats.h5"))
        except ImportError:        # h5py is optional (env without HDF5)
            pass
        tracer = obs_trace.tracer()
        if tracer.enabled:
            # Chrome/Perfetto trace_event export of the retained event
            # window (process-wide: in fleet mode per-tenant lanes ride
            # the pid axis).  Atomic like every persisted artifact.
            resil.write_json_atomic(
                os.path.join(self.outdir, "trace.json"),
                obs_export.to_trace_event(tracer.snapshot()))

    # --- campaign checkpoint/resume ---

    def checkpoint(self, ckpt_dir: str | None = None) -> str:
        """Write campaign progress; any batch is re-derivable from its
        coordinates, so this plus the plan is the whole campaign state.

        Crash-safety (v4): tmp + fsync + rename (a kill mid-write can only
        truncate the tmp file), a content checksum in the document (a
        torn/corrupted file is *detected*, not trusted), and one-deep
        rotation — the previous checkpoint survives as campaign.prev.json
        so resume always has a valid fallback."""
        if ckpt_dir is None:
            if not self.outdir:
                raise ValueError("no outdir and no explicit ckpt_dir")
            ckpt_dir = os.path.join(self.outdir, "campaign_ckpt")
        os.makedirs(ckpt_dir, exist_ok=True)
        state_doc: dict[str, dict] = {}
        for (spn, s), st in self.state.items():
            state_doc.setdefault(spn, {})[s] = st.to_dict()
        doc = {
            "version": CKPT_VERSION,
            "plan": self.plan.to_dict(),
            # the EFFECTIVE batch size (the reference rounds the plan's up
            # to its mesh): batch PRNG keys derive from it, so a resume
            # that rounds differently would silently mix two incompatible
            # key streams — resume() validates this instead
            "batch_size": int(self.batch_size),
            "state": state_doc,
            # v5: the integrity monitor (mismatch ledger, canary/invariant
            # counters, quarantine log) rides the checkpoint so the audit
            # budget and evidence survive resume
            "integrity": self.monitor.to_dict(),
        }
        doc["checksum"] = resil.doc_checksum(doc)
        path = os.path.join(ckpt_dir, "campaign.json")
        if os.path.exists(path):
            # rotate only a VALID latest: rotating a torn campaign.json
            # (crash or injected tear since the last write) over
            # campaign.prev.json would destroy the one valid fallback and
            # open a no-valid-checkpoint window until the write below
            # lands — exactly the double-fault a chaos plan composes
            try:
                resil.load_json_verified(path)
            except ValueError:
                debug.dprintf("Campaign", "latest checkpoint is torn — "
                              "overwriting in place, keeping prev")
            else:
                # graftlint: allow-fsync-rename -- rotation of an
                # ALREADY-durable checkpoint: its bytes were fsync'd by
                # write_json_atomic when it was written, and the
                # dir-fsync just below is what makes the rotation
                # itself durable (fsync-after is the correct order for
                # renaming a durable file)
                os.replace(path,
                           os.path.join(ckpt_dir, "campaign.prev.json"))
                # durability: the rotation rename is only crash-safe once
                # the directory entry itself is on disk — without this a
                # power loss could drop BOTH names (the new
                # campaign.json's own write_json_atomic fsyncs the dir
                # again after its rename)
                resil.fsync_dir(ckpt_dir)
        resil.write_json_atomic(path, doc)
        return ckpt_dir

    @staticmethod
    def load_checkpoint_doc(ckpt_dir: str) -> dict:
        """Newest *valid* checkpoint document: a truncated or
        checksum-failing campaign.json falls back to campaign.prev.json
        (auto-resume must survive a kill mid-checkpoint; skipped batches
        re-run from their PRNG coordinates, so falling back one
        checkpoint costs work, never correctness)."""
        errors = []
        for name in ("campaign.json", "campaign.prev.json"):
            path = os.path.join(ckpt_dir, name)
            try:
                doc = resil.load_json_verified(path)
            except (OSError, ValueError) as e:
                errors.append(f"{name}: {e}")
                debug.dprintf("Campaign", "checkpoint %s unusable: %s",
                              name, e)
                continue
            if name != "campaign.json":
                debug.dprintf("Campaign",
                              "latest checkpoint invalid — resuming from "
                              "previous valid checkpoint %s", name)
            return doc
        raise ValueError(
            f"no valid campaign checkpoint in {ckpt_dir}: "
            + "; ".join(errors))

    @classmethod
    def resume(cls, ckpt_dir: str, mesh=None, outdir: str | None = None,
               device=None) -> "Orchestrator":
        """Rebuild an orchestrator from the newest valid checkpoint in
        ``ckpt_dir`` (either package's), on ``device`` (None: the card)."""
        doc = cls.load_checkpoint_doc(ckpt_dir)
        upgrade_checkpoint(doc)
        plan = CampaignPlan.from_dict(doc["plan"])
        orch = cls(plan, mesh=mesh, outdir=outdir, device=device)
        want = doc.get("batch_size")
        if want is not None and int(want) != orch.batch_size:
            raise ValueError(
                f"checkpoint ran with effective batch_size {want} but the "
                f"plan's is {plan.batch_size} on one device — batch PRNG "
                "keys would diverge from the checkpointed history (a "
                "checkpoint of the reference on a mesh whose size does not "
                "divide the plan's batch size cannot resume here)")
        for spn, per_structure in doc["state"].items():
            for s, st_doc in per_structure.items():
                orch.state[(spn, s)] = _State.from_dict(st_doc)
        orch.budget = resil.EscalationBudget.from_states(
            st.tier_trials for st in orch.state.values())
        orch._esc_baseline = orch.budget.rate()
        orch.monitor = integ.IntegrityMonitor.from_dict(
            doc.get("integrity"), orch.icfg)
        orch._audit_baseline = orch.monitor.ledger.rate()
        orch._build_stats()   # rebind formulas/counters to restored state
        return orch

    # step-wise terminal codes (StepDriver.rc / the fleet CLI contract):
    # mirror the run-to-completion CLI — 0 complete, 3 budget/integrity
    # abort (resumable), 4 graceful preemption (resumable)
    RC_COMPLETE = 0
    RC_ABORTED = 3
    RC_PREEMPTED = 4

    def _persist_evidence(self, flight: bool = True) -> None:
        """Persist the integrity evidence record
        (``outdir/integrity_evidence.json``, atomic): quarantine log +
        mismatch ledger, so a violated run is inspectable without parsing
        checkpoints.  ``flight=False`` on paths that immediately follow
        with their own specific-reason flight dump (one dump per
        trigger, with the most specific reason winning by
        construction)."""
        if not self.outdir:
            return
        os.makedirs(self.outdir, exist_ok=True)
        resil.write_json_atomic(
            os.path.join(self.outdir, "integrity_evidence.json"),
            {"quarantine": list(self.monitor.quarantine_log),
             "ledger": self.monitor.ledger.to_dict()})
        # quarantine is one of the flight recorder's abnormal-exit
        # triggers: dump the recent-event window NOW, while the failing
        # batch's dispatch → verdict → quarantine → recovery events are
        # still in the ring ("why did this batch quarantine" must be
        # answerable from one artifact even when the run then completes)
        if flight:
            obs_trace.flight_dump(self.outdir, "quarantine_evidence",
                                  quarantined=self.monitor.quarantined)


class StepDriver:
    """Step-wise, resumable driver over one campaign's event stream — the
    per-tenant surface the multi-tenant scheduler ticks
    (``shrewd_tpu/service/scheduler.py``).

    ``events()`` is already batch-granular (it yields at every typed
    event), so the step-wise refactor is a protocol, not a rewrite: each
    ``tick()`` advances the underlying generator until ONE batch or sync
    interval has been obtained and believed (``BATCH_COMPLETE``) or the
    campaign reaches a terminal state, then returns the events produced
    en route.  All host-side follow-up work of a batch (budget gates,
    checkpoint-crossing, integrity evidence) that the generator performs
    lazily after its yield lands at the START of the next tick — which
    may be scheduled arbitrarily later, interleaved with other tenants'
    ticks.  That is safe by construction: every orchestrator's state is
    self-contained, and per-batch tallies are pure functions of their
    frozen PRNG keys, so tick interleaving cannot perturb any tenant's
    cumulative state (the fleet bit-identity invariant).
    """

    def __init__(self, orch: Orchestrator):
        self.orch = orch
        self._gen = orch.events()
        self.done = False
        self.rc = Orchestrator.RC_COMPLETE
        self.results: dict | None = None    # CAMPAIGN_COMPLETE payload

    def request_drain(self) -> None:
        """Graceful per-tenant preemption: the next tick finishes its
        in-flight batch, checkpoints (when the orchestrator has an
        outdir) and terminates with rc 4 (resumable)."""
        self.orch.request_drain()

    def tick(self) -> list[tuple[ExitEvent, object]]:
        """Advance one scheduling quantum.  Returns the typed events
        produced (possibly several: a batch may be followed by
        checkpoint/degradation/integrity events, and structure/simpoint
        completions ride between batches).  After a terminal event the
        driver is ``done`` with the campaign's CLI return code in
        ``rc``; further ticks return []."""
        if self.done:
            return []
        out: list[tuple[ExitEvent, object]] = []
        while True:
            try:
                event, payload = next(self._gen)
            except StopIteration:
                # the stream ended without CAMPAIGN_COMPLETE: an abort
                # path (escalation/audit budget, integrity violation)
                # or a preemption whose terminal event we consumed on a
                # previous iteration of this very tick
                self.done = True
                if self.orch.preempted:
                    self.rc = Orchestrator.RC_PREEMPTED
                elif self.orch.aborted:
                    self.rc = Orchestrator.RC_ABORTED
                return out
            out.append((event, payload))
            if event is ExitEvent.CAMPAIGN_COMPLETE:
                self.done = True
                self.results = dict(payload)
                return out
            if event is ExitEvent.PREEMPTED:
                self.done = True
                self.rc = Orchestrator.RC_PREEMPTED
                return out
            if event is ExitEvent.BATCH_COMPLETE:
                return out
