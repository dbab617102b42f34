"""The resident multi-tenant campaign scheduler (see package docstring).

Port of ``shrewd_tpu/service/scheduler.py``.  One ``CampaignScheduler``
owns one mesh for its whole life and ticks many campaigns through it:
each admitted ``TenantSpec`` becomes an ``Orchestrator`` + ``StepDriver``
pair, and every scheduler tick advances exactly one tenant by one batch
(serial) or one sync interval (pipelined).  Interleaving is where the
throughput comes from: while tenant A's tick runs host-side work
(stopping rule, invariants, stats, checkpoints), tenant B's in-flight
intervals keep computing on the device, and the content-keyed kernel
registry (``parallel/exec_cache``) shares one ``TrialKernel`` between
tenants on one window — the second tenant on a shared window builds no
new kernel (its ledger's ``compiled`` stays put).

Two departures from the reference, each refused or dropped here:

- a non-empty ``certify=`` raises ``NotImplementedError``: the port has
  no static certification yet (the analysis re-scope), exactly as its
  ``Orchestrator`` refuses ``analysis.certify`` other than ``"off"``;
- the reference's fleet points jax's persistent compilation cache at a
  shared artifact store (``exec_cache.enable_persistent_cache``); the
  port compiles nothing per step, so there is nothing to persist and
  the call is dropped.

Scheduling is deterministic by construction: policies consume only
admission order, per-tenant trial counts and weights — never wall clock
— so a fleet's schedule log is reproducible, and each tenant's tallies
are bit-identical to its solo serial run regardless of interleaving
(frozen per-batch PRNG keys; the invariant every layer of this codebase
preserves).

Policies (``policy=``):

- ``"fair"`` (default) — strict priority classes; within the runnable
  class with the highest priority, weighted fair-share stride
  scheduling: pick the tenant with the smallest virtual time
  ``trials / weight`` (ties break on admission order).
- ``"priority"`` — strict priority, FIFO within a class (admission
  order), for drain-one-tenant-first operation.

The **global dispatch-depth budget** bounds how much device work the
whole fleet keeps in flight: each running tenant's pipelined engine
depth is clamped to ``max(1, depth_budget // n_running)`` (re-balanced
as tenants come and go), with the per-tenant plan depth as ceiling and a
floor of 1 — the fleet cannot over-subscribe the mesh the way N
independent processes would.

**Quota revocation** (the sanctioned early-stop seam): a supervising
controller — the scenario-matrix Pareto loop (``shrewd_tpu_torch/scenario/``)
is the canonical caller — may call ``revoke_quota(tenant, reason)`` to
withdraw a tenant's remaining service.  The decision is journaled as a
``revoke`` record BEFORE any state changes (so replay after a hard kill
re-applies it exactly), a running tenant drains its in-flight batch to
a resumable checkpoint, and the tenant lands in the terminal status
``pruned`` — excluded from fair share like quarantine, but *not* a
failure: its partial tallies/results stay first-class (they are the
provenance a Pareto artifact cites).

Failure isolation: every tenant owns its watchdog, ladder, integrity
monitor and chaos engine, so a wedge or corrupt tally quarantines and
recovers INSIDE the afflicted tenant.  A chaos ``kill_worker`` is
rescoped at admission (``ChaosEngine.kill_action``): in a fleet the
"worker" is the tenant's step driver, so the kill tears down only that
tenant's orchestrator — the scheduler rebuilds it from its last
per-tenant checkpoint (or from scratch; frozen keys make both
bit-identical) while every other tenant keeps running.

**Survivability** (the write-ahead layer): ``fleet.json`` alone is only
written at checkpoints, so every state transition — admit, tick-complete
with its vtime/quota deltas, failure, quarantine, status change — is
ALSO appended to a crash-safe journal (``service/journal.py``: fsync'd,
checksummed, compacted into the snapshot) before the in-memory ledgers
are trusted.  ``recover()`` replays snapshot+journal after a hard kill
(SIGKILL/OOM) at any instruction boundary and resumes every tenant from
its namespaced checkpoint bit-identically.  A **poison tenant** whose
tick raises repeatedly gets a deterministic retry budget (tick-counted
exponential backoff — no wall clock) and then a durable ``quarantined``
status with its exception ledger persisted, never stalling the fleet or
burning its fair share; a **livelocked** tenant is preempted by the
per-tenant tick watchdog (``resilience.DeviceWatchdog`` deadlines) and
routed down the same quarantine path.  All of it is provable on a
reproducible schedule through the service-level chaos kinds
(``kill_fleet`` / ``torn_journal`` / ``corrupt_submission``).

The scheduler is pure host-side control: device work starts when a
tenant's orchestrator is built on the fleet's mesh.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from shrewd_tpu_torch import chaos as chaos_mod
from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch import stats as statsmod
from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.obs import metrics as obs_metrics
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.service.journal import (FleetJournal, is_dirty,
                                              journal_path)
from shrewd_tpu_torch.service.queue import (SubmissionQueue, TenantSpec,
                                            sanitize)
from shrewd_tpu_torch.utils import debug

FLEET_CKPT_VERSION = 2

#: snapshot versions ``recover``/``resume`` accept (v1 = pre-journal;
#: its documents simply lack the survivability fields)
_CKPT_VERSIONS = (1, FLEET_CKPT_VERSION)

#: exception-ledger cap per tenant (the snapshot/journal carry it)
_MAX_ERRORS = 32

POLICIES = ("fair", "priority")

#: ``step()`` sentinel: nothing runnable but the fleet is resident
#: (spool attached, ``idle_exit`` off) — the caller chooses whether to
#: sleep (``run()``) or go serve another pod (the federation driver)
IDLE = object()

#: certify escalation order (the fleet's admission-time certification
#: posture can tighten a tenant's plan, never loosen it)
_CERTIFY_ORDER = {"off": 0, "warn": 1, "strict": 2}

#: tenant terminal statuses a fleet resume re-admits (a resumable tenant
#: continues from its namespaced checkpoint; ``quota`` stays parked until
#: the operator resubmits with a bigger quota)
_RESUMABLE = ("queued", "running", "preempted")


class TenantKilled(RuntimeError):
    """A chaos ``kill_worker`` fired inside a tenant's tick (the
    fleet-scoped analog of ``os._exit``): the tenant's orchestrator is
    dead; the scheduler rebuilds and resumes it."""

    def __init__(self, tenant: str, rc: int):
        super().__init__(f"tenant {tenant!r} killed by chaos (rc {rc})")
        self.tenant = tenant
        self.rc = rc


class FleetKilled(RuntimeError):
    """The in-process stand-in for a fleet hard kill.

    The DEFAULT action of the ``kill_fleet``/``torn_journal`` chaos
    kinds is a true hard death (``os._exit`` — no drain, no checkpoint,
    no atexit), which is what the CI round-trip exercises in a
    subprocess.  Tests install ``engine.kill_action = raise FleetKilled``
    instead, so the "dead" fleet's process survives to run
    ``CampaignScheduler.recover()`` and assert bit-identity."""

    def __init__(self, rc: int = 137):
        super().__init__(f"fleet killed by chaos (rc {rc})")
        self.rc = rc


class TenantState:
    """One tenant's life in the fleet: spec + driver + ledgers."""

    def __init__(self, spec: TenantSpec, order: int, ticket: str = ""):
        self.spec = spec
        self.order = order           # admission order (the FIFO tiebreak)
        self.ticket = ticket         # spool ticket ("" = direct admit)
        self.status = "queued"
        self.orch = None
        self.driver = None
        self.trials = 0              # trials served (the fair-share unit)
        self.batches = 0             # trials // effective batch size
        self.ticks = 0               # scheduling quanta consumed
        self.kills = 0               # chaos kill_worker fires survived
        self.failures = 0            # tick/elaboration exceptions (lifetime)
        self.retry_at = 0            # fleet tick gating the next retry
        self.errors: list[dict] = []  # exception ledger {tick, error}
        self.revoked = ""            # quota-revocation reason ("" = none)
        self.evicted = ""            # migration-eviction reason ("" = none)
        self.rc: int | None = None
        self.queue_latency_s = 0.0   # submit → admission
        self.wall_s = 0.0            # admission → terminal
        self._t_admit: float | None = None
        self._plan_depth = 1         # the plan's own depth (budget ceiling)
        self.results: dict | None = None   # JSON-able per-structure summary

    @property
    def vtime(self) -> float:
        return self.trials / self.spec.weight

    def to_dict(self) -> dict:
        return {"spec": self.spec.to_dict(), "order": self.order,
                "ticket": self.ticket, "status": self.status,
                "trials": self.trials, "batches": self.batches,
                "ticks": self.ticks, "kills": self.kills,
                "failures": self.failures, "errors": list(self.errors),
                "revoked": self.revoked, "evicted": self.evicted,
                "rc": self.rc,
                "queue_latency_s": round(self.queue_latency_s, 3),
                "wall_s": round(self.wall_s, 3), "results": self.results}


class CampaignScheduler:
    """The resident scheduler (see module docstring).

    ``outdir`` namespaces everything per tenant:
    ``outdir/tenants/<name>/`` holds each tenant's m5out artifacts and
    its ``campaign_ckpt`` (the per-tenant checkpoint namespace), and
    ``outdir/fleet_ckpt/fleet.json`` + ``outdir/fleet_stats.json`` hold
    the fleet's own resumable state and stats dump."""

    def __init__(self, outdir: str | None = None, mesh=None,
                 depth_budget: int = 4, policy: str = "fair",
                 queue: SubmissionQueue | None = None, certify: str = "",
                 idle_exit: bool = True, poll_interval: float = 0.2,
                 on_tick=None, chaos=None, retry_budget: int = 3,
                 backoff_ticks: int = 2, tick_timeout: float = 0.0,
                 compact_every: int = 64, store_dir: str | None = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r} (one of {POLICIES})")
        if certify and certify not in _CERTIFY_ORDER:
            raise ValueError(f"unknown certify mode {certify!r}")
        if certify:
            # departure: admission-time certification needs the static
            # analysis layer, which the port does not have yet
            raise NotImplementedError(
                f"fleet certification (certify={certify!r}) comes with "
                "the port's analysis layer")
        self.outdir = outdir
        self._mesh = mesh
        self.depth_budget = max(1, int(depth_budget))
        self.policy = policy
        self.queue = queue
        self.certify = certify
        self.idle_exit = idle_exit
        self.poll_interval = float(poll_interval)
        self.on_tick = on_tick
        #: the FLEET-level chaos engine (kill_fleet / torn_journal /
        #: corrupt_submission) — distinct from each tenant's own engine,
        #: whose kills are rescoped to that tenant
        self.chaos = chaos
        #: tick-exception retries before durable quarantine; the i-th
        #: retry waits ``backoff_ticks * 2**(i-1)`` FLEET TICKS —
        #: deterministic, tick-counted, no wall clock in any decision
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_ticks = max(1, int(backoff_ticks))
        #: per-tenant tick deadline (seconds; 0 = no watchdog): a
        #: livelocked tick is abandoned (DeviceWatchdog posture) and the
        #: tenant takes the failure/quarantine path instead of wedging
        #: the whole scheduler loop
        self.tick_timeout = float(tick_timeout)
        self.compact_every = max(1, int(compact_every))
        #: digest-keyed artifact-store root for binary-in submissions
        #: (ingest/store.py); None = ``<outdir>/store``.  The federation
        #: threads ONE root through every pod so a binary ingested on
        #: pod0 warm-starts in O(1) on pod1 after a migration/failover.
        self.store_dir = store_dir
        self._store = None
        self.recoveries = 0           # hard-kill recoveries survived
        self.journal_torn = 0         # torn journal records dropped
        self.ingest_lifts = 0         # windows lifted for binary tenants
        self.ingest_captures = 0      # host captures run for binary tenants
        self.tenants: dict[str, TenantState] = {}
        self.schedule_log: list[str] = []    # tenant name per tick
        self.ticks = 0
        self._drain = False
        self.preempted = False
        self._journal: FleetJournal | None = None
        self._journal_floor = 0       # next_seq floor (snapshot journal_seq+1)
        self._explicit_params: frozenset = frozenset()  # caller-pinned knobs
        self._watchdog = (resil.DeviceWatchdog(timeout=self.tick_timeout,
                                               name="fleet-tick")
                          if self.tick_timeout > 0 else None)
        self._t0 = obs_clock.monotonic()
        # abnormal exits (chaos hard kill, quarantine) dump the flight
        # recorder here — pre-registered because the kill seam fires
        # with no outdir in hand (obs/trace.py maybe_flight_dump)
        if outdir:
            obs_trace.tracer().set_flight_path(
                os.path.join(outdir, obs_trace.FLIGHT_NAME))
        self._build_stats()

    # --- mesh / stats -----------------------------------------------------

    @property
    def mesh(self):
        """The fleet's ONE mesh, built lazily: every tenant's campaigns
        shard over the same devices, which is what lets tenants on one
        window share a kernel.  The default is ``make_mesh()`` — every
        visible card (it raises without one); CPU callers pass
        ``mesh=make_mesh(["cpu"])``.  (The reference also points jax's
        persistent compilation cache at a shared store here; the port
        compiles nothing per step, so that call has no counterpart.)"""
        if self._mesh is None:
            from shrewd_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh()
        return self._mesh

    @property
    def store(self):
        """The artifact store for binary-in submissions, built lazily
        (plan-only fleets never touch it)."""
        if self._store is None:
            from shrewd_tpu_torch.ingest.store import ArtifactStore

            root = self.store_dir or (os.path.join(self.outdir, "store")
                                      if self.outdir else None)
            if root is None:
                raise RuntimeError("binary-in submission needs a "
                                   "store_dir (or an outdir)")
            self._store = ArtifactStore(root)
        return self._store

    def _build_stats(self) -> None:
        """``campaign.fleet.*`` — the multi-tenant ledger: who ran, how
        fairly, how fast, and how much compile work co-scheduling
        deduped.  Formulas read live scheduler state, like every other
        stats group in the tree."""
        from shrewd_tpu_torch.parallel import exec_cache

        self.stats = statsmod.Group("campaign")
        fg = statsmod.Group("fleet")
        self.stats.fleet = fg
        fg.tenants_admitted = statsmod.Formula(
            "tenants_admitted", lambda: len(self.tenants),
            "tenants admitted to the fleet")
        fg.tenants_by_status = statsmod.Formula(
            "tenants_by_status", lambda: self._by_status(),
            "tenant count per terminal/live status")
        fg.ticks = statsmod.Formula(
            "ticks", lambda: self.ticks,
            "scheduling quanta dispatched fleet-wide")
        fg.depth_budget = statsmod.Formula(
            "depth_budget", lambda: self.depth_budget,
            "global dispatch-depth budget shared by running tenants")
        fg.tenant_trials = statsmod.Formula(
            "tenant_trials",
            lambda: {n: t.trials for n, t in self.tenants.items()},
            "trials served per tenant")
        fg.tenant_throughput = statsmod.Formula(
            "tenant_throughput",
            lambda: {n: round(t.trials / t.wall_s, 1)
                     for n, t in self.tenants.items() if t.wall_s > 0},
            "per-tenant trials/second (admission to terminal)")
        fg.queue_latency_s = statsmod.Formula(
            "queue_latency_s",
            lambda: {n: round(t.queue_latency_s, 3)
                     for n, t in self.tenants.items() if t.ticket},
            "spool-submit to admission latency per queued tenant")
        fg.fairness_index = statsmod.Formula(
            "fairness_index", lambda: self.fairness_index(),
            "Jain index over weight-normalized trials served "
            "(1.0 = perfectly weighted-fair)")
        fg.cache_hit_rate = statsmod.Formula(
            "cache_hit_rate",
            lambda: (lambda s: round(s["reused"]
                                     / max(s["reused"] + s["compiled"], 1),
                                     4))(exec_cache.cache().stats()),
            "process-wide kernel-registry hit rate (cross-tenant "
            "kernel sharing)")
        fg.schedule_ticks = statsmod.Formula(
            "schedule_ticks",
            lambda: {n: t.ticks for n, t in self.tenants.items()},
            "scheduling quanta per tenant")
        fg.recoveries = statsmod.Formula(
            "recoveries", lambda: self.recoveries,
            "hard-kill recoveries this fleet has survived "
            "(snapshot + write-ahead-journal replay)")
        fg.quarantined = statsmod.Formula(
            "quarantined",
            lambda: sum(1 for t in self.tenants.values()
                        if t.status == "quarantined"),
            "poison tenants parked in durable quarantine")
        fg.ingest_lifts = statsmod.Formula(
            "ingest_lifts", lambda: self.ingest_lifts,
            "windows lifted for binary-in submissions (0 on a "
            "digest-store warm start)")
        fg.ingest_captures = statsmod.Formula(
            "ingest_captures", lambda: self.ingest_captures,
            "host captures run for binary-in submissions")
        fg.pruned = statsmod.Formula(
            "pruned",
            lambda: sum(1 for t in self.tenants.values()
                        if t.status == "pruned"),
            "tenants whose remaining quota was revoked (Pareto-"
            "dominated scenario cells; partial results stay first-class)")
        fg.evicted = statsmod.Formula(
            "evicted",
            lambda: sum(1 for t in self.tenants.values()
                        if t.status == "evicted"),
            "tenants released for migration (drained to their "
            "namespaced checkpoints; a federation gateway recovers "
            "them on another pod, bit-identically)")
        fg.tenant_failures = statsmod.Formula(
            "tenant_failures",
            lambda: {n: t.failures for n, t in self.tenants.items()
                     if t.failures},
            "tick/elaboration exceptions per tenant (the retry-budget "
            "ledger)")
        fg.journal_records = statsmod.Formula(
            "journal_records",
            lambda: self._journal.appended if self._journal else 0,
            "write-ahead journal records fsync'd this process")
        fg.journal_compactions = statsmod.Formula(
            "journal_compactions",
            lambda: self._journal.compactions if self._journal else 0,
            "journal compactions into the fleet snapshot this process")
        fg.journal_torn_dropped = statsmod.Formula(
            "journal_torn_dropped", lambda: self.journal_torn,
            "torn journal tail records dropped at the last recovery")
        fg.submissions_bad = statsmod.Formula(
            "submissions_bad",
            lambda: self.queue.bad_count() if self.queue else 0,
            "poisoned spool submissions quarantined to bad/")

    def _by_status(self) -> dict:
        out: dict[str, int] = {}
        for t in self.tenants.values():
            out[t.status] = out.get(t.status, 0) + 1
        return out

    def fairness_index(self) -> float:
        """Jain's fairness index over ``trials / weight`` of every tenant
        that ran: (Σx)² / (n·Σx²) ∈ (0, 1], 1.0 = perfectly weighted-fair
        allocation."""
        x = [t.trials / t.spec.weight for t in self.tenants.values()
             if t.trials > 0]
        if not x:
            return 1.0
        return float(sum(x) ** 2 / (len(x) * sum(v * v for v in x)))

    # --- the write-ahead journal ------------------------------------------

    def _open_journal(self) -> FleetJournal | None:
        """The fleet's WAL, opened lazily (no outdir → no journal, zero
        overhead).  The seq floor comes from the snapshot so sequence
        numbers stay monotonic across compactions and restarts."""
        if self._journal is None and self.outdir:
            floor = self._journal_floor
            if floor == 0:
                try:
                    snap = resil.load_json_verified(os.path.join(
                        self.outdir, "fleet_ckpt", "fleet.json"))
                    floor = int(snap.get("journal_seq", -1)) + 1
                except (OSError, ValueError):
                    pass
            self._journal = FleetJournal(journal_path(self.outdir),
                                         next_seq=floor, chaos=self.chaos)
            # the scheduler's own knobs must survive a kill BEFORE the
            # first snapshot exists, so each process journals its config
            # once at open (replay restores it; later records win)
            self._journal.append("config", {
                "policy": self.policy,
                "depth_budget": self.depth_budget,
                "retry_budget": self.retry_budget,
                "backoff_ticks": self.backoff_ticks,
                "tick_timeout": self.tick_timeout,
                "compact_every": self.compact_every})
        return self._journal

    def _jlog(self, kind: str, data: dict | None = None) -> None:
        """Durably journal one state transition BEFORE the in-memory
        ledgers are trusted (the WAL contract, statically certified as
        GL201: every mutation of journaled state is dominated by its
        _jlog).  Deliberately does NOT compact: a compaction riding the
        append would snapshot the PRE-mutation ledgers while truncating
        the very record that carries the transition — compaction runs
        only at loop-safe points (``_maybe_compact``), after the tick's
        mutations are applied."""
        j = self._open_journal()
        if j is None:
            return
        j.append(kind, data)

    def _maybe_compact(self) -> None:
        """Fold the WAL into a fresh snapshot once ``compact_every``
        records accumulate — called between ticks, never from inside
        ``_jlog`` (see there)."""
        j = self._journal
        if j is not None and j.since_compact >= self.compact_every:
            self.checkpoint()

    # --- admission --------------------------------------------------------

    def admit(self, spec: TenantSpec, ticket: str = "") -> TenantState:
        """Admit one tenant (direct or from the spool).  Names are the
        tenant identity — checkpoint namespace, stats key, chaos worker —
        so a duplicate is refused loudly rather than silently merging
        two tenants' state.  The ONE exception: a terminal ``evicted``
        tenant RELEASED its name — re-admission replaces the released
        roster entry (the returning-migration case: a federation
        gateway may place a tenant back on a pod it drained off
        earlier; the fresh admission resumes from whatever namespaced
        checkpoint the migration left)."""
        existing = self.tenants.get(spec.name)
        if existing is not None and existing.status != "evicted":
            raise ValueError(f"tenant {spec.name!r} already admitted")
        t = TenantState(spec, order=len(self.tenants), ticket=ticket)
        if spec.submitted_at:
            # queue latency is observability (submit → admission seconds
            # across processes); every scheduling decision reads only
            # admission order, trial counts and weights.  Routed through
            # the sanctioned obs.clock seam (GL106).
            t.queue_latency_s = max(0.0, obs_clock.now()
                                    - spec.submitted_at)
        self._jlog("admit", {"tenant": spec.name, "spec": spec.to_dict(),
                             "ticket": ticket, "order": t.order})
        self.tenants[spec.name] = t
        obs_trace.tracer().emit(
            "tenant_admit", cat="fleet", tenant=spec.name,
            order=t.order, priority=spec.priority, weight=spec.weight)
        debug.dprintf("Fleet", "admitted %s (priority=%d weight=%g%s)",
                      spec.name, spec.priority, spec.weight,
                      f" ticket={ticket}" if ticket else "")
        return t

    def tenant_outdir(self, name: str) -> str | None:
        if not self.outdir:
            return None
        return os.path.join(self.outdir, "tenants", sanitize(name))

    def _start(self, t: TenantState) -> None:
        """Elaborate one queued tenant: plan → orchestrator (resuming
        from its namespaced checkpoint when one exists) → step driver,
        with chaos kills rescoped to the tenant."""
        from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

        if t.spec.binary_digest:
            # binary-in submission: run (or resume, or warm-start) the
            # journaled ingest pipeline first; the resolved plan is an
            # ordinary pre-lifted plan pointing at store-resident
            # windows.  IngestQuarantine propagates to _note_failure,
            # which quarantines immediately (deterministic poison).
            from shrewd_tpu_torch.campaign.plan import CampaignPlan

            plan = CampaignPlan.from_dict(self._ingest_plan(t))
        else:
            plan = t.spec.build_plan()
        outdir = self.tenant_outdir(t.spec.name)
        ckpt_dir = (os.path.join(outdir, "campaign_ckpt") if outdir
                    else None)
        resumable = False
        if ckpt_dir is not None:
            try:
                Orchestrator.load_checkpoint_doc(ckpt_dir)
                resumable = True
            except ValueError:
                resumable = False
        if resumable:
            t.orch = Orchestrator.resume(ckpt_dir, mesh=self.mesh,
                                         outdir=outdir)
        else:
            t.orch = Orchestrator(plan, mesh=self.mesh, outdir=outdir)
        self._scope_chaos(t)
        # the depth-budget ceiling is the SUBMITTED plan's depth, read
        # from the spec document: _rebalance mutates pcfg.depth in
        # place and the clamped value rides the tenant checkpoint, so
        # reading it back from a resumed/rebuilt orchestrator would
        # ratchet the tenant's depth down monotonically across resumes
        spec_depth = (t.spec.plan.get("pipeline") or {}).get(
            "depth", t.orch.pcfg.depth)
        t._plan_depth = max(1, int(spec_depth))
        t.driver = t.orch.stepper()
        self._jlog("status", {"tenant": t.spec.name, "status": "running"})
        t.status = "running"
        obs_trace.tracer().emit(
            "tenant_start", cat="fleet", tenant=t.spec.name,
            resumed=bool(resumable))
        if t._t_admit is None:
            t._t_admit = obs_clock.monotonic()
        self._rebalance()

    def _ingest_plan(self, t: TenantState) -> dict:
        """Binary → plan via the journaled streaming pipeline
        (ingest/pipeline.py).  The pipeline's WAL lives in the tenant's
        namespace (``tenants/<name>/ingest/``) so it rides checkpoint
        copies across migration/failover; artifacts land in the SHARED
        digest-keyed store, so a re-submission of the same binary —
        here or on any pod over the same store — warm-starts in O(1)
        with zero lifts."""
        from shrewd_tpu_torch.ingest.pipeline import IngestPipeline

        data = t.spec.verify_binary()    # ValueError on poisoned spec
        digest = self.store.put_binary(data)
        outdir = self.tenant_outdir(t.spec.name)
        if outdir is None:
            raise RuntimeError("binary-in submission needs an outdir "
                               "(the ingest WAL is per-tenant state)")
        pipe = IngestPipeline(os.path.join(outdir, "ingest"),
                              self.store, digest, axes=t.spec.ingest,
                              chaos=self.chaos)
        pipe.run()
        self.ingest_lifts += pipe.lifts
        self.ingest_captures += pipe.captures
        return pipe.resolved_plan(t.spec.plan)

    def _scope_chaos(self, t: TenantState, engine=None) -> None:
        """Rescope a tenant's chaos engine to the fleet: the engine's
        "worker" is the tenant, and a kill_worker tears down the tenant's
        driver (``TenantKilled``), not the host process."""
        if engine is not None:
            t.orch.attach_chaos(engine)
        eng = t.orch.chaos
        if eng is None:
            return
        if not eng.worker:
            eng.worker = t.spec.name
        name = t.spec.name

        def _kill(rc: int):
            raise TenantKilled(name, rc)

        eng.kill_action = _kill

    def _rebalance(self) -> None:
        """Re-divide the global dispatch-depth budget over running
        tenants (floor 1, ceiling = each tenant's own plan depth) —
        engines read their depth live, so in-flight windows shrink/grow
        at the next fill."""
        running = [t for t in self.tenants.values()
                   if t.status == "running"]
        if not running:
            return
        share = max(1, self.depth_budget // len(running))
        for t in running:
            depth = max(1, min(t._plan_depth, share))
            t.orch.pcfg.depth = depth
            for eng in t.orch._engines.values():
                eng.depth = depth

    # --- the scheduling loop ---------------------------------------------

    def request_drain(self) -> None:
        """Graceful fleet preemption (idempotent): every running tenant
        finishes its in-flight batch, checkpoints into its namespace,
        and the fleet state is persisted resumable (rc 4)."""
        self._drain = True

    def install_signal_handlers(self):
        """SIGTERM/SIGINT → graceful fleet drain; a second signal raises
        KeyboardInterrupt (the operator escape hatch) — the
        ``Orchestrator.install_signal_handlers`` discipline extended to
        the whole fleet.  Returns a restore callable; no-op off the main
        thread."""
        import signal

        def _handler(signum, frame):
            if self._drain:
                raise KeyboardInterrupt
            self._drain = True
            debug.dprintf("Fleet", "signal %s: draining fleet to "
                          "checkpoints", signum)

        try:
            prev = {s: signal.signal(s, _handler)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:            # not the main thread
            return lambda: None
        return lambda: [signal.signal(s, h) for s, h in prev.items()]

    def _poll_queue(self) -> None:
        if self.queue is None:
            return
        if self.chaos is not None:
            # corrupt_submission chaos: poison the scheduled pending doc
            # in place (parses, checksum fails) so the claim path's
            # bad-spool quarantine is provable on a schedule.  Documents
            # that do not parse yet (in-flight submit placeholders) are
            # not submissions: they neither consume the chaos ordinal
            # nor crash the loop the harness exists to protect.
            for ticket in self.queue.pending():
                path = os.path.join(self.queue.pending_dir, ticket)
                try:
                    with open(path) as f:
                        json.load(f)
                except (OSError, ValueError):
                    continue
                spec = self.chaos.take_corrupt_submission()
                if spec is not None:
                    chaos_mod.corrupt_json_checksum(path)
        for ticket, spec in self.queue.claim():
            try:
                self.admit(spec, ticket=ticket)
            except ValueError as e:
                # duplicate name etc: publish the refusal as the ticket's
                # result instead of wedging the spool
                debug.dprintf("Fleet", "refused %s: %s", ticket, e)
                self.queue.mark_done(ticket, {"tenant": spec.name,
                                              "status": "refused",
                                              "error": str(e)})

    def _candidates(self) -> list[TenantState]:
        out = []
        for t in self.tenants.values():
            if t.status == "queued" and t.revoked:
                # a revocation that outlived its tenant's start (journal
                # replay re-queued it, or the revoke landed while it sat
                # in backoff): prune WITHOUT elaborating — revocation
                # must never cost a plan build
                self._prune_queued(t)
                continue
            if t.status == "queued" and t.evicted:
                # an eviction that outlived its tenant's start (journal
                # replay re-queued it): release WITHOUT elaborating —
                # the new placement owns it now
                self._evict_queued(t)
                continue
            if t.status == "queued" and t.retry_at <= self.ticks:
                try:
                    self._start(t)
                except FleetKilled:
                    # a fleet-scoped chaos kill (kill_during_lift fires
                    # inside the ingest pipeline) is the whole process
                    # dying, not one tenant failing — it must NOT be
                    # swallowed into the retry/quarantine ledger
                    raise
                except Exception as e:  # noqa: BLE001 — tenant isolation:
                    # a plan that fails to elaborate (malformed dict,
                    # missing trace file, bad config) is THAT tenant's
                    # failure — it burns its retry budget and lands in
                    # quarantine with the evidence while everyone else
                    # keeps being served; a resident scheduler must
                    # never die on one bad submission
                    self._note_failure(t, e)
            if t.status == "running":
                out.append(t)
        return out

    def _in_backoff(self) -> bool:
        return any(t.status == "queued" and t.retry_at > self.ticks
                   for t in self.tenants.values())

    def _note_failure(self, t: TenantState, err: Exception) -> None:
        """One tick/elaboration exception: ledger it, tear down the dead
        driver, and either schedule a deterministic retry (exponential
        backoff counted in FLEET TICKS — no wall clock enters any
        decision) or quarantine the tenant for good.  The transition is
        journaled BEFORE any ledger mutates (GL201): a kill inside the
        append leaves the in-memory state untouched and the record
        absent — never a half-applied failure."""
        from shrewd_tpu_torch.ingest.pipeline import IngestQuarantine

        entry = {"tick": self.ticks,
                 "error": f"{type(err).__name__}: {err}"}
        failures = t.failures + 1
        errors = (t.errors + [entry])[-_MAX_ERRORS:]
        if isinstance(err, IngestQuarantine):
            # an ingest poison verdict is deterministic — the binary
            # cannot heal, so retrying would re-run the whole capture
            # just to fail identically; quarantine NOW with the stage
            # evidence (the pipeline journaled its own verdict first)
            self._quarantine(t, failures, errors)
            return
        if failures > self.retry_budget:
            self._quarantine(t, failures, errors)
            return
        delay = self.backoff_ticks * (2 ** (failures - 1))
        retry_at = self.ticks + delay
        self._jlog("failure", {"tenant": t.spec.name,
                               "failures": failures,
                               "fleet_tick": self.ticks,
                               "retry_at": retry_at,
                               "error": entry["error"]})
        t.failures = failures
        t.errors = errors
        t.retry_at = retry_at
        t.orch = t.driver = None
        t.status = "queued"
        obs_trace.tracer().emit(
            "tenant_failure", cat="fleet", tenant=t.spec.name,
            failures=t.failures, fleet_tick=self.ticks,
            retry_at=t.retry_at)
        debug.dprintf("Fleet", "%s: failure %d/%d (%s) — retry at tick "
                      "%d", t.spec.name, t.failures, self.retry_budget,
                      err, t.retry_at)
        self._rebalance()

    def _quarantine(self, t: TenantState, failures: int | None = None,
                    errors: list | None = None) -> None:
        """Retry budget exhausted: the tenant is poison.  Park it in a
        DURABLE ``quarantined`` status — journal record (FIRST, before
        any ledger mutates), persisted exception ledger in its
        namespace, done-doc for its ticket — so it never stalls the
        fleet, never burns fair share, and never silently retries
        across a resume/recover."""
        failures = t.failures if failures is None else failures
        errors = list(t.errors) if errors is None else errors
        last = errors[-1]["error"] if errors else ""
        self._jlog("quarantine", {"tenant": t.spec.name,
                                  "failures": failures,
                                  "errors": list(errors)})
        t.status = "quarantined"
        t.failures = failures
        t.errors = errors
        t.orch = t.driver = None
        t.results = {"error": last, "failures": failures}
        t.wall_s = (obs_clock.monotonic() - t._t_admit) if t._t_admit \
            else 0.0
        obs_trace.tracer().emit(
            "tenant_quarantine", cat="fleet", tenant=t.spec.name,
            failures=t.failures, fleet_tick=self.ticks)
        outdir = self.tenant_outdir(t.spec.name)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            resil.write_json_atomic(
                os.path.join(outdir, "quarantine.json"),
                {"tenant": t.spec.name, "failures": t.failures,
                 "errors": list(t.errors)})
        if self.queue is not None and t.ticket:
            self.queue.mark_done(t.ticket, {
                "tenant": t.spec.name, "status": "quarantined",
                "failures": t.failures, "error": last})
        debug.dprintf("Fleet", "%s: QUARANTINED after %d failures (%s)",
                      t.spec.name, t.failures, last)
        self._rebalance()
        if self.outdir:
            self.checkpoint()
        # "why did this tenant quarantine" must be answerable from one
        # artifact: dump the recent-event window now, while the failing
        # tenant's dispatch/verdict/failure events are still in the
        # ring.  Guarded (GL204): the recorder is evidence, and an
        # exporter crash must never turn one failure into two.
        try:
            obs_trace.flight_dump(self.outdir, "tenant_quarantine",
                                  tenant=t.spec.name,
                                  failures=t.failures)
        except Exception as e:  # noqa: BLE001 — best-effort seam
            debug.dprintf("Fleet", "flight dump failed: %s", e)

    # --- quota revocation (the sanctioned early-stop seam) ----------------

    def revoke_quota(self, tenant: str, reason: str = "") -> bool:
        """Withdraw a tenant's remaining service (the scenario-matrix
        Pareto loop's prune seam).  Journaled BEFORE any state changes so
        a hard kill between the decision and the drain replays it
        exactly; a running tenant drains its in-flight batch to a
        resumable checkpoint and finalizes as ``pruned`` (terminal,
        excluded from fair share like quarantine — but its partial
        results stay first-class provenance, never an error).  Returns
        False when the tenant is already terminal or already revoked
        (idempotent: callers may re-decide every tick)."""
        t = self.tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        if t.revoked or t.status not in ("queued", "running"):
            return False
        # the DECISION is journaled before the ledger mutates (GL201):
        # a kill inside the append either replays the revocation or
        # leaves the tenant untouched — never a revoked-in-memory
        # tenant whose journal never heard about it
        reason = reason or "revoked"
        self._jlog("revoke", {"tenant": t.spec.name, "reason": reason,
                              "fleet_tick": self.ticks})
        t.revoked = reason
        obs_trace.tracer().emit(
            "tenant_revoke", cat="fleet", tenant=t.spec.name,
            reason=t.revoked, fleet_tick=self.ticks)
        debug.dprintf("Fleet", "%s: quota revoked (%s)", t.spec.name,
                      t.revoked)
        if t.status == "queued":
            self._prune_queued(t)
        else:
            t.driver.request_drain()
        return True

    # --- eviction (the migrate-out seam) ----------------------------------

    def evict(self, tenant: str, reason: str = "") -> bool:
        """Release a tenant for migration — the federation gateway's
        drain-HERE half of drain-here/recover-there: the tenant drains
        its in-flight batch to its namespaced resumable checkpoint and
        goes terminal ``evicted`` ON THIS POD (excluded from fair share,
        never re-run by this scheduler's resume/recover), while the
        checkpoint stays behind for whoever recovers it elsewhere —
        bit-identity makes the hand-off free.  The decision is journaled
        BEFORE any state changes (GL201): a hard kill between the
        decision and the drain replays the eviction exactly, so the
        gateway can never find a tenant it released still being served.
        Returns False when the tenant is already terminal, revoked or
        evicted (idempotent)."""
        t = self.tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        if t.evicted or t.revoked or t.status not in ("queued", "running"):
            return False
        reason = reason or "evicted"
        self._jlog("evict", {"tenant": t.spec.name, "reason": reason,
                             "fleet_tick": self.ticks})
        t.evicted = reason
        obs_trace.tracer().emit(
            "tenant_evict", cat="fleet", tenant=t.spec.name,
            reason=t.evicted, fleet_tick=self.ticks)
        debug.dprintf("Fleet", "%s: evicted for migration (%s)",
                      t.spec.name, t.evicted)
        if t.status == "queued":
            self._evict_queued(t)
        else:
            t.driver.request_drain()
        return True

    def _release_queued(self, t: TenantState, status: str,
                        reason: str) -> None:
        """A queued tenant goes terminal WITHOUT elaboration — the
        shared tail of revocation (``pruned``) and eviction
        (``evicted``): journal-first status record, done-doc with the
        reason, durable snapshot.  Releasing must never cost a plan
        build (a plan that cannot elaborate must still be releasable),
        and an evicted tenant's (possibly absent) checkpoint is already
        whatever the new placement will resume from."""
        wall_s = (obs_clock.monotonic() - t._t_admit) if t._t_admit \
            else 0.0
        self._jlog("status", {"tenant": t.spec.name, "status": status,
                              "trials": t.trials, "batches": t.batches,
                              "wall_s": round(wall_s, 3),
                              "results": t.results})
        t.status = status
        t.wall_s = wall_s
        obs_trace.tracer().emit(
            f"tenant_{status}", cat="fleet", tenant=t.spec.name,
            trials=t.trials, reason=reason)
        if self.queue is not None and t.ticket:
            self.queue.mark_done(t.ticket, {
                "tenant": t.spec.name, "status": status,
                "reason": reason, "trials": t.trials,
                "results": t.results})
        if self.outdir:
            self.checkpoint()

    def _evict_queued(self, t: TenantState) -> None:
        self._release_queued(t, "evicted", t.evicted)

    def _prune_queued(self, t: TenantState) -> None:
        self._release_queued(t, "pruned", t.revoked)

    def _pick(self, cands: list[TenantState]) -> TenantState:
        top = max(t.spec.priority for t in cands)
        cls = [t for t in cands if t.spec.priority == top]
        if self.policy == "priority":
            return min(cls, key=lambda t: t.order)
        return min(cls, key=lambda t: (t.vtime, t.order))

    def _handle_kill(self, t: TenantState, e: TenantKilled) -> None:
        """The fleet-scoped worker death: only THIS tenant's
        orchestrator died.  Rebuild it — from its namespaced checkpoint
        when one exists, else from scratch — carrying the SAME chaos
        engine (its schedule state, including the consumed kill, must
        survive the rebuild or the kill would re-fire forever), and
        keep running.  Frozen keys make the recovered tallies
        bit-identical either way."""
        kills = t.kills + 1
        debug.dprintf("Fleet", "%s: %s — rebuilding tenant", t.spec.name, e)
        self._jlog("tenant_kill", {"tenant": t.spec.name,
                                   "kills": kills})
        t.kills = kills
        obs_trace.tracer().emit("tenant_kill", cat="fleet",
                                tenant=t.spec.name, kills=t.kills)
        engine = t.orch.chaos
        t.status = "queued"
        t.orch = t.driver = None
        self._start(t)
        self._scope_chaos(t, engine=engine)

    def _tick_tenant(self, t: TenantState) -> None:
        # ambient tenant scope: every event the tick emits from nested
        # seams (exec cache, watchdog, integrity, chaos) lands in this
        # tenant's lane without threading identity through every call
        with obs_trace.tracer().scope(tenant=t.spec.name):
            self._tick_tenant_scoped(t)

    def _tick_tenant_scoped(self, t: TenantState) -> None:
        obs_trace.tracer().emit(
            "tenant_tick", cat="fleet", tenant=t.spec.name,
            fleet_tick=self.ticks, tick=t.ticks)
        try:
            if self._watchdog is not None:
                # per-tenant tick watchdog: a livelocked tick (wedged
                # host loop, runaway elaboration) is abandoned at the
                # deadline (DispatchTimeout) instead of wedging the
                # whole scheduler; the failure path below quarantines
                # repeat offenders
                self._watchdog.call(t.driver.tick)
            else:
                t.driver.tick()
        except TenantKilled as e:
            self._handle_kill(t, e)
            return
        except Exception as e:  # noqa: BLE001 — tenant isolation: an
            # exception escaping the event stream is unrecoverable FOR
            # THIS TENANT'S DRIVER (lazy elaboration of a bad plan at
            # first tick, a missing trace file, a config the models
            # reject, a livelock deadline — the ladder/integrity layers
            # already absorbed everything transient inside the
            # generator).  Ledger it; retry on a tick-counted backoff;
            # quarantine when the budget is gone.  The fleet keeps
            # serving either way.
            self._note_failure(t, e)
            return
        trials = sum(st.trials for st in t.orch.state.values())
        batches = trials // max(t.orch.batch_size, 1)
        self._jlog("tick", {"tenant": t.spec.name,
                            "fleet_tick": self.ticks,
                            "trials": trials, "batches": batches,
                            "ticks": t.ticks + 1, "kills": t.kills})
        t.ticks += 1
        t.trials = trials
        t.batches = batches
        if t.driver.done:
            self._finalize(t)
            return
        if (t.spec.quota_batches
                and t.batches >= t.spec.quota_batches):
            # quota exhausted: drain THIS tenant to a resumable
            # checkpoint (status "quota") — the next tick finishes its
            # in-flight batch and preempts it
            debug.dprintf("Fleet", "%s: quota %d batches reached — "
                          "draining", t.spec.name, t.spec.quota_batches)
            t.driver.request_drain()

    def _finalize(self, t: TenantState) -> None:
        rc = t.driver.rc
        from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

        if rc == Orchestrator.RC_ABORTED:
            # honesty outranks the revocation: an abort (integrity/
            # budget) during the drain is still an abort
            status = "aborted"
        elif t.revoked:
            # the journaled revocation decision is authoritative over
            # every cooperative ending — including a campaign whose
            # final in-flight batch happened to complete it during the
            # drain (rc 0): the quota WAS withdrawn first, and the
            # Pareto artifact's decision list must match the statuses
            status = "pruned"
        elif t.evicted and rc == Orchestrator.RC_PREEMPTED:
            # the drain the eviction requested completed: released for
            # migration, checkpoint left behind.  A campaign whose final
            # in-flight batch happened to COMPLETE it during the drain
            # (rc 0) stays "complete" — there is nothing left to
            # migrate, and the gateway reads the status to decide
            status = "evicted"
        elif rc == Orchestrator.RC_PREEMPTED:
            status = ("quota" if t.spec.quota_batches
                      and t.batches >= t.spec.quota_batches
                      else "preempted")
        else:
            status = "complete"
            if t.kills and t.orch.chaos is not None:
                # the killed tenant finished with believed tallies: the
                # injected kill was survived (the ledger the chaos stats
                # group reports)
                for _ in range(t.kills):
                    t.orch.chaos.note_survived("kill_worker")
        wall_s = (obs_clock.monotonic() - t._t_admit) if t._t_admit \
            else 0.0
        results = self._summarize(t)
        self._jlog("status", {"tenant": t.spec.name, "status": status,
                              "rc": rc, "trials": t.trials,
                              "batches": t.batches,
                              "wall_s": round(wall_s, 3),
                              "results": results})
        t.status = status
        t.rc = rc
        t.wall_s = wall_s
        t.results = results
        obs_trace.tracer().emit(
            "tenant_done", cat="fleet", tenant=t.spec.name,
            status=t.status, rc=t.rc, trials=t.trials)
        t.orch.write_outputs()
        if t.orch.outdir and t.status == "complete":
            t.orch.checkpoint()          # the final-state dump _drive writes
        if self.queue is not None and t.ticket:
            done = {
                "tenant": t.spec.name, "status": t.status, "rc": t.rc,
                "trials": t.trials, "batches": t.batches,
                "wall_s": round(t.wall_s, 3), "results": t.results}
            if t.revoked:
                # same done-doc shape as the queued-prune path: a
                # submitter whose cell was pruned mid-run learns the
                # dominator from its ticket too
                done["reason"] = t.revoked
            elif t.evicted:
                done["reason"] = t.evicted
            self.queue.mark_done(t.ticket, done)
        debug.dprintf("Fleet", "%s: %s (rc=%s, %d trials, %d ticks)",
                      t.spec.name, t.status, t.rc, t.trials, t.ticks)
        self._rebalance()
        if self.outdir:
            self.checkpoint()

    def _summarize(self, t: TenantState) -> dict:
        """JSON-able per-(simpoint, structure) final state: completed
        tenants summarize their StructureResults; preempted/aborted ones
        summarize their partial cumulative state (what the checkpoint
        holds).  The per-stratum tally history rides along (from the
        orchestrator's cumulative state, the one place it lives) so a
        stratified campaign's half-width can be recomputed from the
        summary with the SAME estimator the stopping rule used —
        downstream folds (the scenario Pareto loop) must not silently
        degrade to pooled Wilson on terminal tenants."""
        def strata_of(sp, st):
            s = t.orch.state.get((sp, st)) if t.orch is not None else None
            return (s.strata.tolist()
                    if s is not None and s.strata is not None else None)

        out = {}
        if t.driver.results is not None:
            for (sp, st), r in t.driver.results.items():
                out[f"{sp}/{st}"] = {
                    "tallies": np.asarray(r.tallies).tolist(),
                    "trials": int(r.trials), "avf": float(r.avf),
                    "converged": bool(r.converged),
                    "strata": strata_of(sp, st)}
        else:
            # partial cumulative state (preempted / pruned mid-run):
            # the tallies are exact counts over the consumed batch
            # prefix, so the AVF is exact too — a revocation-pruned
            # shard's done-doc is first-class provenance in the
            # gateway's sharded merge, never a null to be re-derived
            from shrewd_tpu_torch.ops import classify as C

            for (sp, st), s in t.orch.state.items():
                vul = int(s.tallies[C.OUTCOME_SDC]
                          + s.tallies[C.OUTCOME_DUE])
                out[f"{sp}/{st}"] = {
                    "tallies": s.tallies.tolist(),
                    "trials": int(s.trials),
                    "avf": (vul / int(s.trials) if s.trials > 0
                            else None),
                    "converged": bool(s.converged),
                    "strata": (s.strata.tolist()
                               if s.strata is not None else None)}
        return out

    def step(self) -> object:
        """ONE scheduling quantum — the cooperative surface a federation
        driver round-robins N pod schedulers through in a single
        process (``shrewd_tpu_torch/federation/``): every quantum runs to an
        instruction boundary and hands control back, so pods interleave
        deterministically without threads (bit-identity never depended
        on scheduling anyway — frozen per-batch keys — but a
        single-threaded round-robin makes the *schedule logs*
        reproducible too).  Returns ``None`` after a quantum of
        progress, ``IDLE`` when the fleet is resident-idle (spool
        attached, ``idle_exit`` off, nothing runnable — the caller
        decides whether to sleep or serve another pod), or the terminal
        fleet rc (int)."""
        if self._drain:
            return self._drain_all()
        if self.chaos is not None:
            # kill_fleet at a tick ordinal: the hard kill lands at
            # the instruction boundary between ticks — nothing
            # drains, nothing checkpoints; the journal is the only
            # survivor (which is the point)
            self.chaos.maybe_kill_fleet(tick=self.ticks)
        self._poll_queue()
        cands = self._candidates()
        if not cands:
            if self._in_backoff():
                # a tenant waits out its retry backoff and nothing
                # else is runnable: consume an idle quantum — the
                # backoff is counted in fleet ticks, so idling must
                # advance them (deterministic, clock-free)
                self.ticks += 1
                return None
            if self.queue is not None and not self.idle_exit:
                return IDLE
            return self._shutdown()
        t = self._pick(cands)
        self.schedule_log.append(t.spec.name)
        self.ticks += 1
        self._tick_tenant(t)
        self._maybe_compact()
        self._publish_metrics()
        if self.on_tick is not None:
            self.on_tick(self)
        return None

    def _shutdown(self) -> int:
        """Every tenant terminal and the spool (if any) drained: persist
        outputs + the shutdown journal record, report the fleet rc."""
        self.write_outputs()
        if self.outdir:
            self._jlog("shutdown", {"statuses": self._by_status()})
            self.checkpoint()
        if any(t.status == "aborted" for t in self.tenants.values()):
            return 3
        return 0

    def run(self) -> int:
        """Drive the fleet: poll the spool, pick, tick, finalize — until
        every tenant is terminal and (with ``idle_exit``) the spool is
        empty, or a drain is requested.  Exactly ``step()`` in a loop
        (one code path — the federation's cooperative stepping cannot
        drift from the resident loop).  Returns the fleet rc: 0 all
        served, 3 when any tenant aborted (budget/integrity), 4 when the
        fleet was drained (resumable)."""
        while True:
            rc = self.step()
            if rc is IDLE:
                time.sleep(self.poll_interval)
            elif rc is not None:
                return rc

    def _drain_all(self) -> int:
        """Graceful fleet preemption: every running tenant drains to a
        namespaced resumable checkpoint; queued tenants stay queued in
        the fleet checkpoint.  rc 4, resumable via ``resume()``."""
        self.preempted = True
        for t in self.tenants.values():
            if t.status == "running":
                t.driver.request_drain()
                while t.driver is not None and not t.driver.done:
                    self.ticks += 1
                    t.ticks += 1
                    try:
                        t.driver.tick()
                    except TenantKilled as e:
                        # belt-and-braces: the drain flag preempts at
                        # the next batch boundary before any compute,
                        # so a kill should not be reachable here — but
                        # if one ever is, it must not break the drain
                        # contract (every tenant checkpoints, fleet
                        # exits resumable): rebuild and re-drain
                        self._handle_kill(t, e)
                        t.driver.request_drain()
                    except Exception as e:  # noqa: BLE001 — isolation,
                        # as in _tick_tenant: a dead tenant must not
                        # stop the rest of the fleet from draining (it
                        # keeps its retry budget for the resumed fleet)
                        self._note_failure(t, e)
                        break
                if t.status == "running":
                    self._finalize(t)
        self.write_outputs()
        if self.outdir:
            self._jlog("shutdown", {"drained": True,
                                    "statuses": self._by_status()})
            self.checkpoint()
        debug.dprintf("Fleet", "fleet drained: %s", self._by_status())
        return 4

    def _publish_metrics(self) -> None:
        """Atomic per-tick metrics snapshot (``metrics.json`` +
        Prometheus text) — the live pull surface ``tools/obs.py --tail``
        and scrapers consume.  Best-effort: an observability write must
        never take the fleet down."""
        if not self.outdir:
            return
        try:
            obs_metrics.publish(self.outdir, self)
        except Exception as e:  # noqa: BLE001 — the publish path runs
            # real computation (half-widths, serialization) per tick; NO
            # exception from it may take the resident fleet down
            debug.dprintf("Fleet", "metrics publish failed: %s", e)

    # --- fleet state persistence / outputs --------------------------------

    def results(self) -> dict:
        return {n: t.results for n, t in self.tenants.items()}

    def tenant_tallies(self, name: str) -> dict:
        """{(simpoint, structure): int64 tallies} for one tenant — the
        bit-identity comparison surface the fleet tests pin against each
        tenant's solo serial run."""
        t = self.tenants[name]
        out = {}
        for key, row in (t.results or {}).items():
            sp, st = key.split("/", 1)
            out[(sp, st)] = np.asarray(row["tallies"], dtype=np.int64)
        return out

    def write_outputs(self) -> None:
        if not self.outdir:
            return
        os.makedirs(self.outdir, exist_ok=True)
        self._publish_metrics()     # terminal statuses visible to tailers
        with open(os.path.join(self.outdir, "fleet_stats.txt"), "w") as f:
            statsmod.dump_text(self.stats, f)
        with open(os.path.join(self.outdir, "fleet_stats.json"), "w") as f:
            statsmod.dump_json(self.stats, f)
        tracer = obs_trace.tracer()
        if tracer.enabled:
            from shrewd_tpu_torch.obs import export as obs_export

            # fleet-level Perfetto export: per-tenant lanes on the pid
            # axis (the tenant scope every tick wraps its events in)
            resil.write_json_atomic(
                os.path.join(self.outdir, "trace.json"),
                obs_export.to_trace_event(tracer.snapshot()))

    def checkpoint(self) -> str:
        """Persist the fleet's own resumable state (atomic, checksummed —
        the campaign-checkpoint discipline): tenant specs, statuses,
        fair-share ledgers and result summaries.  Per-tenant campaign
        state lives in each tenant's namespaced checkpoint; this document
        only has to say who exists and where they stand.  A durable
        snapshot compacts the write-ahead journal behind it (the
        snapshot-first ordering makes a crash between the two leave
        duplicates — skipped by seq at replay — never a gap)."""
        ckpt_dir = os.path.join(self.outdir, "fleet_ckpt")
        os.makedirs(ckpt_dir, exist_ok=True)
        doc = {"version": FLEET_CKPT_VERSION, "policy": self.policy,
               "depth_budget": self.depth_budget, "ticks": self.ticks,
               "retry_budget": self.retry_budget,
               "backoff_ticks": self.backoff_ticks,
               "tick_timeout": self.tick_timeout,
               "compact_every": self.compact_every,
               "recoveries": self.recoveries,
               "journal_seq": (self._journal.next_seq - 1
                               if self._journal is not None else
                               self._journal_floor - 1),
               "tenants": [t.to_dict() for t in self.tenants.values()]}
        doc["checksum"] = resil.doc_checksum(doc)
        resil.write_json_atomic(os.path.join(ckpt_dir, "fleet.json"), doc)
        if self._journal is not None:
            self._journal.compact()
        return ckpt_dir

    def _admit_from_dict(self, td: dict) -> TenantState:
        """Rebuild one TenantState from a snapshot/journal document —
        the replay path, which must NOT re-journal the admission."""
        spec = TenantSpec.from_dict(td["spec"])
        t = TenantState(spec, order=int(td.get("order", len(self.tenants))),
                        ticket=td.get("ticket", ""))
        t.status = td.get("status", "queued")
        t.trials = int(td.get("trials", 0))
        t.batches = int(td.get("batches", 0))
        t.ticks = int(td.get("ticks", 0))
        t.kills = int(td.get("kills", 0))
        t.failures = int(td.get("failures", 0))
        t.errors = list(td.get("errors") or [])
        t.revoked = str(td.get("revoked") or "")
        t.evicted = str(td.get("evicted") or "")
        t.rc = td.get("rc")
        t.results = td.get("results")
        t.queue_latency_s = float(td.get("queue_latency_s", 0.0))
        t.wall_s = float(td.get("wall_s", 0.0))
        self.tenants[spec.name] = t
        return t

    def _apply_record(self, r: dict) -> None:
        """Replay one journal record onto the tenant table (idempotent:
        records carry absolute values, not deltas)."""
        kind = r.get("kind")
        if kind == "config":
            if "policy" in r and "policy" not in self._explicit_params:
                self.policy = str(r["policy"])
            for k, cast in (("depth_budget", int), ("retry_budget", int),
                            ("backoff_ticks", int), ("compact_every", int),
                            ("tick_timeout", float)):
                if k in r and k not in self._explicit_params:
                    setattr(self, k, cast(r[k]))
            self._watchdog = (resil.DeviceWatchdog(
                timeout=self.tick_timeout, name="fleet-tick")
                if self.tick_timeout > 0 else None)
            return
        if kind in ("shutdown", "recover"):
            # lifecycle markers: nothing to restore, but the dispatch
            # handles them EXPLICITLY so the GL202 exhaustiveness check
            # can prove every appended kind has a considered replay
            # story (an unlisted kind is a recovery gap, not noise)
            return
        if kind == "admit":
            existing = self.tenants.get(r.get("tenant", ""))
            if existing is None or existing.status == "evicted":
                # a re-admission over a RELEASED (evicted) name replays
                # as a replacement, mirroring admit()'s one exception
                self._admit_from_dict({"spec": r["spec"],
                                       "order": r.get("order", 0),
                                       "ticket": r.get("ticket", ""),
                                       "status": "queued"})
            return
        t = self.tenants.get(r.get("tenant", ""))
        if t is None:
            return
        if kind == "tick":
            t.trials = int(r.get("trials", t.trials))
            t.batches = int(r.get("batches", t.batches))
            t.ticks = int(r.get("ticks", t.ticks))
            t.kills = int(r.get("kills", t.kills))
            self.ticks = max(self.ticks, int(r.get("fleet_tick", 0)))
        elif kind == "failure":
            t.failures = int(r.get("failures", t.failures))
            t.errors.append({"tick": r.get("fleet_tick", 0),
                             "error": r.get("error", "")})
            del t.errors[:-_MAX_ERRORS]
            t.status = "queued"
            self.ticks = max(self.ticks, int(r.get("fleet_tick", 0)))
        elif kind == "quarantine":
            t.status = "quarantined"
            t.failures = int(r.get("failures", t.failures))
            t.errors = list(r.get("errors") or t.errors)
            last = t.errors[-1]["error"] if t.errors else ""
            t.results = {"error": last, "failures": t.failures}
        elif kind == "tenant_kill":
            t.kills = int(r.get("kills", t.kills))
        elif kind == "revoke":
            # the revocation DECISION is durable the instant it is made:
            # a kill between the decision and the drain replays it here,
            # and _candidates prunes the re-queued tenant without ever
            # elaborating it — the journaled decision, not the drain,
            # is what makes prune-replay exact
            t.revoked = str(r.get("reason") or "revoked")
            self.ticks = max(self.ticks, int(r.get("fleet_tick", 0)))
        elif kind == "evict":
            # like revoke: the DECISION is durable the instant it is
            # made — a kill between the decision and the drain replays
            # it here, and _candidates releases the re-queued tenant
            # without elaboration (the new placement owns it)
            t.evicted = str(r.get("reason") or "evicted")
            self.ticks = max(self.ticks, int(r.get("fleet_tick", 0)))
        elif kind == "status":
            t.status = r.get("status", t.status)
            if "rc" in r:
                t.rc = r["rc"]
            if "trials" in r:
                t.trials = int(r["trials"])
            if "batches" in r:
                t.batches = int(r["batches"])
            if "results" in r:
                t.results = r["results"]
            if "wall_s" in r:
                t.wall_s = float(r["wall_s"])

    @classmethod
    def recover(cls, outdir: str, mesh=None,
                queue: SubmissionQueue | None = None,
                **kw) -> "CampaignScheduler":
        """Rebuild a fleet after ANY shutdown — graceful drain or hard
        kill — by replaying ``fleet_ckpt/fleet.json`` plus every journal
        record beyond it.  Terminal tenants (complete/aborted/quota/
        quarantined) keep their recorded state; resumable ones are
        re-queued and continue from their namespaced campaign
        checkpoints on the next ``run()`` — bit-identical to an
        undisturbed fleet, because per-batch tallies are pure functions
        of their frozen PRNG keys no matter where the kill landed.  The
        (possibly torn) journal is immediately folded into a fresh
        snapshot, so recovery is itself crash-safe."""
        ckpt_dir = os.path.join(outdir, "fleet_ckpt")
        snap_path = os.path.join(ckpt_dir, "fleet.json")
        snap = None
        if os.path.exists(snap_path):
            snap = resil.load_json_verified(snap_path)
            if snap.get("version") not in _CKPT_VERSIONS:
                raise ValueError(
                    f"fleet checkpoint version {snap.get('version')} "
                    f"not in {_CKPT_VERSIONS}")
        jpath = journal_path(outdir)
        records, torn, _valid = (FleetJournal.replay_path(jpath)
                                 if os.path.exists(jpath) else ([], 0, 0))
        snap_seq = int(snap.get("journal_seq", -1)) if snap else -1
        fresh = [r for r in records if int(r["seq"]) > snap_seq]
        # a lone config record is just this-or-a-prior open's preamble,
        # not un-replayed fleet state
        dirty = any(r["kind"] != "config" for r in fresh) or torn > 0
        explicit = frozenset(
            k for k in ("depth_budget", "policy", "retry_budget",
                        "backoff_ticks", "tick_timeout", "compact_every")
            if k in kw)

        def _p(name, default):
            return kw.pop(name, snap.get(name, default) if snap
                          else default)

        sched = cls(outdir=outdir, mesh=mesh, queue=queue,
                    depth_budget=_p("depth_budget", 4),
                    policy=_p("policy", "fair"),
                    retry_budget=_p("retry_budget", 3),
                    backoff_ticks=_p("backoff_ticks", 2),
                    tick_timeout=_p("tick_timeout", 0.0),
                    compact_every=_p("compact_every", 64), **kw)
        sched._explicit_params = explicit
        sched.journal_torn = torn
        if snap:
            sched.recoveries = int(snap.get("recoveries", 0))
            sched.ticks = int(snap.get("ticks", 0))
            for td in sorted(snap["tenants"], key=lambda d: d["order"]):
                sched._admit_from_dict(td)
        for r in fresh:
            sched._apply_record(r)
        for t in sched.tenants.values():
            if t.status in _RESUMABLE:
                t.status = "queued"    # _start resumes from its ckpt
                t.retry_at = 0         # a recovery re-arms retries NOW;
                #                        the failure count survives, so a
                #                        poison tenant cannot mine a fresh
                #                        budget out of every crash
            elif (queue is not None and t.ticket
                    and t.status in ("complete", "aborted", "quota",
                                     "quarantined", "pruned", "evicted")
                    and queue.done(t.ticket) is None):
                # the kill landed between the terminal journal record
                # and mark_done: the replayed state is authoritative, so
                # publish the done-doc now or the submitter's ticket
                # would stay claimed (and unanswered) forever
                done = {
                    "tenant": t.spec.name, "status": t.status,
                    "rc": t.rc, "trials": t.trials,
                    "batches": t.batches, "failures": t.failures,
                    "wall_s": round(t.wall_s, 3), "results": t.results}
                if t.revoked:
                    done["reason"] = t.revoked
                elif t.evicted:
                    done["reason"] = t.evicted
                queue.mark_done(t.ticket, done)
        sched._journal_floor = max(
            snap_seq + 1, (records[-1]["seq"] + 1) if records else 0)
        sched._open_journal()
        if dirty:
            sched.recoveries += 1
            sched._jlog("recover", {"recoveries": sched.recoveries,
                                    "replayed": len(fresh),
                                    "torn_dropped": torn})
            obs_trace.tracer().emit(
                "fleet_recover", cat="fleet",
                recoveries=sched.recoveries, replayed=len(fresh),
                torn_dropped=torn)
            debug.dprintf("Fleet", "recovered dirty fleet: %d journal "
                          "records replayed, %d torn dropped",
                          len(fresh), torn)
        # fold the replayed state (and the recover record) into a fresh
        # snapshot and truncate the (possibly torn) journal before any
        # new work appends to it — recovery is itself crash-safe, and a
        # recovered-then-idle fleet reads as clean
        sched.checkpoint()
        return sched

    @classmethod
    def resume(cls, outdir: str, mesh=None,
               queue: SubmissionQueue | None = None,
               **kw) -> "CampaignScheduler":
        """Rebuild a CLEANLY drained fleet from its snapshot.  Refuses a
        dirty shutdown (journal records beyond the snapshot — the
        hard-kill signature) so un-replayed state is never silently
        discarded; ``recover()`` is the superset that handles both."""
        snap_path = os.path.join(outdir, "fleet_ckpt", "fleet.json")
        if is_dirty(outdir):
            raise ValueError(
                f"{outdir}: dirty shutdown detected (journal holds "
                "records beyond the snapshot) — resume would lose "
                "state; use CampaignScheduler.recover() / "
                "fleet.py --recover")
        if not os.path.exists(snap_path):
            raise FileNotFoundError(f"{snap_path}: no fleet checkpoint")
        return cls.recover(outdir, mesh=mesh, queue=queue, **kw)
