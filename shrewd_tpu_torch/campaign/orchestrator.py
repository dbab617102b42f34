"""Campaign orchestrator: advance, observe, checkpoint, resume (the port of
``shrewd_tpu/campaign/orchestrator.py``).

Drives a ``CampaignPlan`` batch-by-batch over a device mesh: every visible
CUDA card by default, the CPU when the caller asks, or the mesh it is
given (``parallel/mesh.py``; several processes over ``torch.distributed``).
Control shape follows the reference's Simulator/exit-event
inversion (SURVEY §3.1: C++ simulates, Python orchestrates): the batch step
on the card (the structure kernel's ``tally_on_device``: a K1 launch for the
O3 structures, a step loop for MESI and NoC) is the hot path, and this host
loop only consumes tallies, updates stats, applies the
stopping rule, and emits typed events.

Campaign checkpoint/resume replaces the reference's ``m5.cpt`` machinery
(``sim/serialize.hh:169``) for *campaign* state: progress is a JSON document
plus tally arrays; per-trial state never needs saving because the PRNG
discipline (utils/prng.py) makes any batch re-derivable from its coordinates.
Batch boundaries are the natural drain points (the Drainable analog,
``sim/drain.hh:234``: the orchestrator only checkpoints between batches, when
no device computation is in flight).  The checkpoint holds no device state,
so a checkpoint written by either package resumes in the other.

The tier structures route to their own fault kernels (``kernel_for``):
``cache:*`` per simpoint, from the simpoint's golden access stream alone;
``mesi:*`` and ``noc:*`` once per plan, on a seeded coherence torture
stream, reported under the ``coherence`` pseudo-simpoint.

A chaos plan (``chaos.py``) injects faults at the hook points the
orchestrator owns; an elastic context (``parallel/elastic.py``) shares the
campaign with other worker processes through a lease board.

A plan's ``analysis.certify`` ("warn" or "strict") installs the step
auditor (``analysis.install_step_auditor``): each campaign step kind is
certified on its first dispatch, and "strict" refuses a violating step
before its result is counted.  Not in the port, raising
``NotImplementedError`` before any trial runs: a persistent compilation
cache (``pipeline.compilation_cache_dir``; the port compiles nothing per
step).
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, NamedTuple

import numpy as np

from shrewd_tpu_torch import chaos as chaosmod
from shrewd_tpu_torch import integrity as integ
from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch import stats as statsmod
from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.obs import export as obs_export
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.campaign.plan import COHERENCE_SP_NAME, CampaignPlan
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.parallel import elastic as elastic_mod
from shrewd_tpu_torch.parallel import exec_cache
from shrewd_tpu_torch.parallel import pipeline as pipeline_mod
from shrewd_tpu_torch.parallel import stopping
from shrewd_tpu_torch.parallel.campaign import ShardedCampaign
from shrewd_tpu_torch.parallel.mesh import (make_mesh, round_up_to_mesh,
                                            same_device)
from shrewd_tpu_torch.resilience import TIERS
from shrewd_tpu_torch.sim.exit_event import ExitEvent
from shrewd_tpu_torch.utils import probes
from shrewd_tpu_torch.utils import debug, prng

LATER = "comes with a later slice of the PyTorch port"

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


# pseudo-simpoint id for the plan-level coherence tiers (mesi:/noc: do not
# depend on any simpoint's trace, so they run once per plan); the reserved
# NAME lives in plan.py, where construction rejects real simpoints using it
_COHERENCE_SP_ID = 1_000_000


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


def _is_plan_level(structure: str) -> bool:
    return structure.split(":", 1)[0] in ("mesi", "noc")


class Orchestrator:
    def __init__(self, plan: CampaignPlan, mesh=None,
                 outdir: str | None = None, device=None):
        """``mesh`` (``parallel/mesh.py Mesh``): the devices the batches
        are sharded over.  ``mesh=None`` builds ``make_mesh()`` over every
        visible CUDA card (it raises without one), or, with
        ``device="cpu"``, a one-CPU mesh; ``device`` names the one device
        of such a mesh.  Kernels live on the mesh's first device."""
        if mesh is not None and device is not None and not any(
                same_device(d, device) for d in mesh.devices):
            raise ValueError(f"device {device!r} is not on the mesh {mesh}")
        # the one option the port has no counterpart of is refused here,
        # before the first trial (it is not reachable from a default plan)
        if plan.pipeline.compilation_cache_dir:
            raise NotImplementedError(
                "pipeline.compilation_cache_dir configures jax's persistent "
                "compilation cache, which the port has no counterpart of")
        self.plan = plan
        if mesh is None:
            mesh = make_mesh(None if device is None else [device])
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.outdir = outdir
        # the plan's batch_size need not divide the mesh (and cannot be
        # expected to once elastic re-meshing shrinks the device count):
        # round up to the next mesh multiple instead of failing at the
        # first shard_keys call.  PRNG note: the effective batch size is a
        # pure function of (plan, mesh size), so reproducibility holds —
        # re-run on the same mesh, or checkpoint/resume, sees the same keys
        self.batch_size = round_up_to_mesh(plan.batch_size, self.mesh.size)
        if self.batch_size != plan.batch_size:
            warnings.warn(
                f"plan batch_size {plan.batch_size} is not divisible by "
                f"the {self.mesh.size}-device mesh — rounded up to "
                f"{self.batch_size}", RuntimeWarning, stacklevel=2)
        # federated single-campaign sharding (plan.shard_index/shard_count):
        # shard i of N serves the round-robin stripe {i, i+N, ...} of the
        # PARENT campaign's batch-id space; this orchestrator's local
        # batch ordinals map to global ids at the ONE key-derivation site
        # (_compute_batch via _global_batch_id).
        self.shard_index = int(plan.shard_index)
        self.shard_count = int(plan.shard_count)
        self._per_sp = [s for s in plan.structures if not _is_plan_level(s)]
        self._plan_level = [s for s in plan.structures if _is_plan_level(s)]
        self.state: dict[tuple[str, str], _State] = {
            (sp.name, s): _State()
            for sp in plan.simpoints for s in self._per_sp}
        for s in self._plan_level:
            self.state[(COHERENCE_SP_NAME, s)] = _State()
        self.results: dict[tuple[str, str], StructureResult] = {}
        self._kernels: dict[int, TrialKernel] = {}
        self._traces: dict[int, object] = {}
        self._tier_kernels: dict = {}
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
        # replay-safety certification (shrewd_tpu_torch/analysis/):
        # audit every campaign step kind on its first dispatch; 'strict'
        # refuses a violating step (exec_cache.AdmissionError) before its
        # result is counted.  Installed process-wide — certification is a
        # posture of the process's shared ledger
        self.auditor = None
        if plan.analysis.certify != "off":
            from shrewd_tpu_torch import analysis as analysis_mod

            self.auditor = analysis_mod.install_step_auditor(
                plan.analysis.certify, plan.analysis.transfer_budget)
        # deterministic chaos harness (chaos.py): injected faults fire at
        # hook points in the watchdog/ladder/integrity/checkpoint paths
        self.chaos: chaosmod.ChaosEngine | None = None
        eng = plan.chaos.build()
        if eng is not None:
            self.attach_chaos(eng)
        # elastic multi-process context (parallel/elastic.py): when
        # attached, batches are leased from the shared board instead of
        # computed unconditionally, and peer results are adopted
        # bit-identically
        self._elastic = None
        # probe points (utils/probes; gem5 ProbePoint pattern): listeners
        # attach without the orchestrator knowing who observes.  Payloads
        # are batch-granular — BatchInfo / StructureResult / ckpt path.
        self.probes = probes.ProbeManager("campaign")
        self.pp_batch = self.probes.add_point("BatchComplete")
        self.pp_structure = self.probes.add_point("StructureComplete")
        self.pp_checkpoint = self.probes.add_point("Checkpoint")
        self.pp_degraded = self.probes.add_point("BackendDegraded")
        # abnormal exits (integrity abort, chaos hard kill) dump the flight
        # recorder here — pre-registered because the kill seam fires with
        # no outdir in hand; first registration wins
        if outdir and obs_trace.tracer().flight_path is None:
            obs_trace.tracer().set_flight_path(
                os.path.join(outdir, obs_trace.FLIGHT_NAME))
        self._build_stats()

    # --- chaos / elastic / preemption attachment ---

    def attach_chaos(self, engine: chaosmod.ChaosEngine) -> None:
        """Wire the deterministic fault-injection engine into every hook
        point this orchestrator owns (watchdog wedges; the per-campaign
        ladders and engines pick the engine up lazily at construction)."""
        self.chaos = engine
        self.watchdog.chaos = engine

    def attach_elastic(self, ctx: elastic_mod.ElasticContext) -> None:
        """Join an elastic campaign: heartbeats start now (liveness must
        be visible before the first lease claim)."""
        self._elastic = ctx
        # a chaos engine built from plan config predates the worker name;
        # adopt it so worker-targeted faults (kill_worker) aim correctly
        if self.chaos is not None and not self.chaos.worker:
            self.chaos.worker = ctx.worker
        ctx.start()

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
        if self._plan_level:
            sweep.append((COHERENCE_SP_NAME, self._plan_level))
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
        # chaos accounting: what the deterministic failure plan injected
        # and what the stack survived — a chaos run is self-describing
        # from this group alone (empty dicts when no plan is attached)
        cg = statsmod.Group("chaos")
        self.stats.chaos = cg
        cg.injected = statsmod.Formula(
            "injected",
            lambda: dict(self.chaos.injected) if self.chaos else {},
            "faults injected per kind (chaos plan)")
        cg.survived = statsmod.Formula(
            "survived",
            lambda: dict(self.chaos.survived) if self.chaos else {},
            "injected faults the stack recovered from, per kind")
        cg.dispatches = statsmod.Formula(
            "dispatches",
            lambda: self.chaos.dispatches if self.chaos else 0,
            "batches this process computed under the chaos schedule")
        # elastic accounting: membership/lease ledgers (zeros when the
        # campaign is not elastic)
        eg = statsmod.Group("elastic")
        self.stats.elastic = eg
        for name, desc in (
                ("workers_lost", "peers declared lost (heartbeat stale)"),
                ("leases_claimed", "batch leases this worker won"),
                ("leases_adopted", "peer-computed batches adopted"),
                ("leases_revoked", "lost workers' leases revoked"),
                ("batches_reclaimed",
                 "revoked batches this worker re-dispatched")):
            setattr(eg, name, statsmod.Formula(
                name,
                lambda n=name: (self._elastic.counters()[n]
                                if self._elastic else 0), desc))
        eg.collective_timeouts = statsmod.Formula(
            "collective_timeouts",
            lambda: sum(c.collective_timeouts
                        for c in self._campaigns.values()),
            "sharded-step deadlines (possible lost-peer symptom)")
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
            "campaign steps whose replay-safety certificate passed")
        pg.executables_refused = statsmod.Formula(
            "executables_refused", lambda: exec_cache.cache().refused,
            "campaign steps refused by a strict certification")
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

    def kernel_for(self, sp_idx: int, structure: str):
        """→ (kernel, substructure): O3/Minor structures go to the trial
        kernel; tier-qualified names route to the cache / MESI / NoC fault
        kernels (plan.TIER_STRUCTURES), each on the orchestrator's
        device."""
        tier, _, sub = structure.partition(":")
        if not sub:
            return self.kernel(sp_idx), structure
        if tier == "cache":
            key = ("cache", sp_idx)
            if key not in self._tier_kernels:
                from shrewd_tpu_torch.models.ruby import (
                    CacheKernel, golden_access_stream, simulate_cache)
                # the cache tier needs only the simpoint's access stream,
                # not the O3 trial kernel
                trace = self.trace(sp_idx)
                tl, _miss = simulate_cache(golden_access_stream(trace),
                                           self.plan.cache,
                                           n_cycles=trace.n)
                self._tier_kernels[key] = CacheKernel(
                    tl, self.plan.cache, device=self.device)
            return self._tier_kernels[key], sub
        if tier in ("mesi", "noc"):
            if "mesi_trace" not in self._tier_kernels:
                from shrewd_tpu_torch.models.mesi import torture_stream
                self._tier_kernels["mesi_trace"] = torture_stream(
                    self.plan.mesi, self.plan.coherence_accesses,
                    self.plan.coherence_mem_words, seed=self.plan.seed)
            stream = self._tier_kernels["mesi_trace"]
            if tier == "mesi":
                if "mesi" not in self._tier_kernels:
                    from shrewd_tpu_torch.models.mesi import MesiKernel
                    rng = np.random.default_rng(self.plan.seed)
                    init = rng.integers(
                        0, 1 << 32, self.plan.coherence_mem_words,
                        dtype=np.uint64).astype(np.uint32)
                    self._tier_kernels["mesi"] = MesiKernel(
                        stream, self.plan.mesi, init, device=self.device)
                return self._tier_kernels["mesi"], sub
            if "noc" not in self._tier_kernels:
                from shrewd_tpu_torch.models.noc import (NocKernel,
                                                         build_message_trace)
                msgs = build_message_trace(stream, self.plan.mesi,
                                           self.plan.noc)
                self._tier_kernels["noc"] = NocKernel(
                    msgs, self.plan.noc, device=self.device)
            return self._tier_kernels["noc"], sub
        raise KeyError(f"unknown structure tier {tier!r}")

    def campaign(self, sp_idx: int, structure: str) -> ShardedCampaign:
        key = (sp_idx, structure)
        if key not in self._campaigns:
            kernel, sub = self.kernel_for(sp_idx, structure)
            stratify = (self.plan.stratify
                        and hasattr(kernel, "run_keys_stratified"))
            # the shared watchdog guards only the device step inside the
            # campaign (ShardedCampaign._dispatch): a timed-out step raises
            # BEFORE any host-side counter mutation, so an orphaned
            # dispatch thread that completes late ran only pure device
            # work and cannot corrupt kernel.escapes/taint_trials
            self._campaigns[key] = ShardedCampaign(
                kernel, self.mesh, sub, stratify=stratify,
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
                watchdog=self.watchdog, chaos=self.chaos)
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
        shares the orchestrator's integrity monitor, chaos engine and perf
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
                monitor=self.monitor, chaos=self.chaos, perf=self._perf,
                sp_name=sp_name, structure=structure)
        return self._engines[key]

    def until_ci_engine(self, sp_idx: int, sp_name: str, structure: str
                        ) -> pipeline_mod.UntilCIEngine:
        """The device-resident until-CI engine for one campaign: shares
        the orchestrator's integrity monitor, chaos engine and perf
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
                chaos=self.chaos, perf=self._perf,
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
        per-batch loop — where pipelining cannot apply: elastic
        campaigns lease individual batches, sharded campaigns stripe
        them, and host-resolution, chunked and multi-process campaigns
        have no device-accumulable step.  A
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
        if (k <= 1 or self._elastic is not None or self.shard_count > 1
                or not camp.supports_intervals):
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

    def _until_ci_len(self, st: _State, camp: ShardedCampaign,
                      sp_name: str = "", structure: str = "") -> int:
        """Super-interval budget for the device-resident until-CI step
        (``pcfg.until_ci``), or 0 where the stopping rule cannot run on
        the device (elastic leasing; sharded, host-resolution, chunked or
        multi-process campaigns; or cumulative counts past the device
        loop's int32 accumulators).

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
        if (not self.pcfg.until_ci or self._elastic is not None
                or self.shard_count > 1 or not camp.supports_intervals):
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
        if self.chaos is not None:
            # serial parity of the chaos ledgers: a budget that extends
            # past a scheduled batch-granular fault would arm it even
            # when convergence lands first — a batch the serial loop
            # never reaches.  Stop the super-interval just BEFORE the
            # next fault strictly after the head batch (a head-batch
            # fault is always consumed); if the campaign is still
            # running, the next super-interval starts AT the fault's
            # batch and arms it exactly when the serial loop would
            nxt = self.chaos.next_batch_fault(
                st.next_batch, sp_name, structure,
                min_id=st.next_batch + 1)
            if nxt is not None:
                k = min(k, nxt - st.next_batch)
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
        if self._plan_level:
            # coherence tiers (mesi:/noc:) measure plan-level synthetic
            # traffic, independent of every simpoint's trace — run ONCE
            for structure in self._plan_level:
                st = self.state[(COHERENCE_SP_NAME, structure)]
                if st.done:
                    continue
                yield from self._run_structure(
                    _COHERENCE_SP_ID, COHERENCE_SP_NAME, structure, st)
                if self.aborted or self.preempted:
                    return
            yield ExitEvent.SIMPOINT_COMPLETE, COHERENCE_SP_NAME
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
            # obtain this batch's believed tally: locally through the
            # integrity-checked resilience ladder (a batch, a sync
            # interval or an until-CI super-interval), or — in an elastic
            # campaign — through the lease board (compute it under a
            # lease, or adopt a peer's published result; either way the
            # tally is a pure function of the frozen keys, so the
            # cumulative state is bit-identical to a single-worker run)
            try:
                if self._elastic is not None:
                    doc, adopted = self._elastic_obtain(
                        sp_idx, sp_name, structure, st, camp)
                elif (s_ci := self._until_ci_len(st, camp, sp_name,
                                                 structure)) >= 1:
                    doc = self._compute_until_ci(
                        sp_idx, sp_name, structure, camp, st, s_ci)
                    adopted = False
                elif (k_int := self._interval_len(
                        st, camp, (sp_idx, structure))) >= 1:
                    doc = self._compute_interval(
                        sp_idx, sp_name, structure, camp,
                        st.next_batch, k_int)
                    adopted = False
                else:
                    doc = self._compute_batch(sp_idx, sp_name, structure,
                                              camp, sk, st.next_batch)
                    adopted = False
            except elastic_mod.DrainRequested:
                # SIGTERM while blocked on a peer's lease: drain NOW (the
                # scheduler's kill grace is shorter than any claim wait)
                self.preempted = True
                ckpt = self.checkpoint() if self.outdir else None
                yield ExitEvent.PREEMPTED, ckpt
                return
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
            # elastic bit-identity guard: the effective batch size is
            # rounded to the LOCAL mesh, so workers with different device
            # counts would lease differently-sized (differently-KEYED)
            # batches under the same batch_id — silently corrupting the
            # trials accounting and the pure-function-of-coordinates
            # contract.  Refuse loudly; the fix is a plan batch_size
            # divisible by every worker's mesh.
            if adopted and int(doc.get("batch_size",
                                       self.batch_size)) != self.batch_size:
                raise elastic_mod.ElasticError(
                    f"adopted batch {doc.get('batch_id')} of "
                    f"{sp_name}/{structure} was computed with "
                    f"batch_size={doc.get('batch_size')} by "
                    f"{doc.get('worker')!r}, but this worker's effective "
                    f"batch_size is {self.batch_size} (mesh size "
                    f"{self.mesh.size}) — elastic workers must agree on "
                    "the effective batch size; pick a plan batch_size "
                    "divisible by every worker's mesh")
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
                tier=TIERS[tier], adopted=bool(adopted))
            debug.dprintf("Campaign", "%s/%s batch %d: trials=%d avf=%.4f"
                          " tier=%s%s", sp_name, structure, st.next_batch,
                          st.trials, avf_live, TIERS[tier],
                          " (adopted)" if adopted else "")
            # elastic membership changes observed while obtaining this
            # batch surface as typed events (the re-mesh announcement)
            if self._elastic is not None:
                for lost in self._elastic.take_lost():
                    yield ExitEvent.WORKER_LOST, lost
            info = BatchInfo(
                sp_name, structure, st.next_batch - 1, st.trials,
                st.tallies.copy(), avf_live, tier)
            if tier != resil.TIER_DEVICE and not adopted:
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

    def _arm_chaos(self, batch_ids, sp_name: str, structure: str) -> None:
        """Arm the deterministic chaos schedule for the batches about to
        be obtained (one id = the serial loop, several = one sync
        interval — the armed set is the union either way): worker kills
        fire here at the boundary before any work, and an armed tally
        corruption lands on the result's believed tally."""
        if self.chaos is None:
            return
        self.chaos.begin_batches(batch_ids, sp_name, structure)
        self.chaos.maybe_kill()
        cspec = self.chaos.take_corrupt_tally()
        if cspec is not None:
            delta = int(cspec.get("delta", 1))
            self.monitor.arm_corruption(
                lambda t, d=delta: t + d, times=1,
                note=lambda: self.chaos.note_fired("corrupt_tally"))

    def _compute_batch(self, sp_idx: int, sp_name: str, structure: str,
                       camp, sk, batch_id: int) -> dict:
        """Dispatch ONE batch through the integrity-checked resilience
        ladder and return its believed result as a JSON-serializable
        document (the lease board's publish format; the local path uses
        the same shape so accumulation is one code path).

        Chaos hook point: faults armed for this batch fire here — the
        wedge inside the watchdog, per-tier BackendErrors inside the
        ladder, tally corruption inside the checked dispatcher, and the
        worker kill at the boundary before any work.

        Sharded campaigns map the local ordinal to its GLOBAL batch id
        up front: key derivation, chaos arming, integrity evidence, and
        the published document all speak global coordinates, exactly as
        the solo run would."""
        batch_id = self._global_batch_id(batch_id)
        self._arm_chaos([batch_id], sp_name, structure)
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
        if self.chaos is not None:
            # the tally was believed (checks passed, quarantine
            # recovered): every fault that fired this batch was survived
            self.chaos.end_batch()
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
        ladder on frozen keys (parallel/pipeline.py).

        Chaos hook point: batch-granular faults scheduled on ANY of the
        interval's batch ids arm here and fire at the pipelined
        equivalents of their serial hook points (the wedge at
        materialization under the armed deadline, tier errors at consume
        time, tally corruption on the interval result, the worker kill at
        the interval boundary before any work)."""
        self._arm_chaos(range(b0, b0 + k), sp_name, structure)
        esc0 = int(getattr(camp.kernel, "escapes", 0))
        tt0 = int(getattr(camp.kernel, "taint_trials", 0))
        doc = self.engine(sp_idx, sp_name, structure).obtain(
            b0, k, stratified=camp.stratify)
        if self.chaos is not None:
            self.chaos.end_batch()
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
        through the ordinary accumulation path.

        Chaos hook point: batch-granular faults scheduled on ANY of the
        budgeted batch ids arm here (the union, like the interval path) —
        the wedge fires under the armed deadline at materialization, tier
        errors at consume time, tally corruption on the super-interval
        result, the worker kill at the boundary before any work."""
        b0 = st.next_batch
        self._arm_chaos(range(b0, b0 + S), sp_name, structure)
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
        if self.chaos is not None:
            # arming advanced the per-process dispatch counter by the
            # BUDGET S, but the device consumed possibly fewer batches —
            # the serial loop advances it only per batch computed, so
            # rewind the difference or later ``after_dispatches``
            # triggers fire at shifted campaign coordinates (the
            # fused-vs-serial chaos-ledger parity contract; the planner
            # clamp already keeps un-consumed triggers from ARMING)
            self.chaos.dispatches -= S - int(doc.get("n_batches", S))
            self.chaos.end_batch()
        doc["escapes"] = int(getattr(camp.kernel, "escapes", 0)) - esc0
        doc["taint_trials"] = (int(getattr(camp.kernel, "taint_trials", 0))
                               - tt0)
        return doc

    def _elastic_obtain(self, sp_idx: int, sp_name: str, structure: str,
                        st: _State, camp) -> tuple[dict, bool]:
        """One batch through the lease board: adopt the published result
        for ``st.next_batch`` or claim and compute it; while blocked on a
        live peer, speculate up to ``lookahead`` batches ahead (their
        published results are adopted when accumulation reaches them).
        Lost peers' leases are revoked en route (ElasticContext.obtain)."""
        ctx = self._elastic
        sk = self._structure_prng_key(sp_idx, structure)
        target = st.next_batch
        spec_state = {"next": target + 1}

        def compute_for(batch_id):
            return self._compute_batch(sp_idx, sp_name, structure, camp,
                                       sk, batch_id)

        # speculation never runs past the last batch the stopping rule
        # could possibly consume (the max_trials ceiling) — batches past
        # it would be fully computed and never accumulated by anyone
        ceiling = -(-int(self.plan.max_trials) // self.batch_size)

        def speculate() -> bool:
            while spec_state["next"] < min(target + 1 + ctx.cfg.lookahead,
                                           ceiling):
                b = spec_state["next"]
                spec_state["next"] += 1
                k = ctx.key(sp_name, structure, b)
                if ctx.board.done(k) is None and ctx.board.claim(k):
                    ctx.claimed += 1
                    d = compute_for(b)
                    d["worker"] = ctx.worker
                    ctx.board.publish(k, d)
                    return True
            return False

        key = ctx.key(sp_name, structure, target)
        for attempt in range(3):
            doc, adopted = ctx.obtain(key, lambda: compute_for(target),
                                      speculate,
                                      should_abort=lambda: self._drain)
            if not (adopted and self.icfg.invariants):
                return doc, adopted
            # an adopted result passes the same cheap host-side tally
            # invariants every locally-computed batch passed before being
            # believed (the computing peer checked them, but a stale or
            # buggy peer build publishes with a valid checksum — validate
            # at the trust boundary, not just at the producer)
            viol = integ.tally_violations(
                doc.get("tally"), int(doc.get("batch_size",
                                              self.batch_size)),
                doc.get("strata"))
            if not viol:
                return doc, adopted
            self.monitor.invariant_violations += 1
            self.monitor.record_quarantine({
                "kind": "adopted", "simpoint": sp_name,
                "structure": structure, "batch_id": int(target),
                "worker": doc.get("worker"), "problems": [
                    {"kind": "invariant", "violations": viol}],
                "fatal": attempt >= 2})
            debug.dprintf(
                "Elastic", "adopted %s from %s failed invariants (%s) — "
                "retracting and recomputing", key, doc.get("worker"), viol)
            ctx.board.retract(key)
        raise integ.IntegrityError(
            f"{sp_name}/{structure} batch {target}: adopted result failed "
            "invariants on every retract/recompute attempt")

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
            # the EFFECTIVE batch size (plan batch_size rounded up to the
            # mesh): batch PRNG keys derive from it, so a resume on a
            # mesh that rounds differently would silently mix two
            # incompatible key streams — resume() validates this instead
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
        if self.chaos is not None:
            spec = self.chaos.take_torn_checkpoint()
            if spec is not None:
                # chaos checkpoint hook: corrupt the freshly-written bytes
                # the way a power loss would, then prove on the spot that
                # the v5 fallback chain still yields a valid document
                chaosmod.tear_file(path,
                                   float(spec.get("keep_fraction", 0.5)))
                try:
                    self.load_checkpoint_doc(ckpt_dir)
                    self.chaos.note_survived("torn_checkpoint")
                except ValueError:
                    debug.dprintf(
                        "Chaos", "torn checkpoint NOT recoverable (no "
                        "valid fallback in %s)", ckpt_dir)
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
        ``ckpt_dir`` (either package's), on ``mesh`` or ``device`` (as
        the constructor takes them).  A mesh that rounds the plan's batch
        size differently from the checkpointed run is refused."""
        doc = cls.load_checkpoint_doc(ckpt_dir)
        upgrade_checkpoint(doc)
        plan = CampaignPlan.from_dict(doc["plan"])
        orch = cls(plan, mesh=mesh, outdir=outdir, device=device)
        want = doc.get("batch_size")
        if want is not None and int(want) != orch.batch_size:
            raise ValueError(
                f"checkpoint ran with effective batch_size {want} but "
                f"this {orch.mesh.size}-device mesh rounds the plan's "
                f"{plan.batch_size} to {orch.batch_size} — batch PRNG "
                "keys would diverge from the checkpointed history; "
                "resume on a mesh size that divides the original batch "
                "size (or keep plan batch_size a multiple of both)")
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
