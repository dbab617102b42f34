"""Deterministic chaos harness: a failure-plan DSL over the resilience stack
(the port of ``shrewd_tpu/chaos.py``; host bookkeeping only, the same plans
and the same ledgers).

The campaign stack has a watchdog, a degradation ladder, an integrity
quarantine and a crash-safe checkpoint chain.  A fault-injection framework
should be able to inject faults into *itself* on a reproducible schedule
and prove the whole stack end to end; this module is that schedule.

A **chaos plan** is a JSON document::

    {"seed": 0, "faults": [
      {"kind": "wedge",           "at_batch": 0, "times": 1},
      {"kind": "backend_error",   "at_batch": 1, "tier": "device",
       "permanent": true},
      {"kind": "corrupt_tally",   "at_batch": 2, "delta": 1},
      {"kind": "torn_checkpoint", "at_ckpt": 1},
      {"kind": "kill_worker",     "after_dispatches": 3, "rc": 137}
    ]}

Triggers are pure functions of campaign coordinates — batch ids, checkpoint
ordinals, per-process dispatch counts — never wall-clock randomness.  The
seeded form ``{"sample": {"k": 2, "of": 20}}`` draws ``k`` batch ids from
``range(of)`` with a PRNG derived from the plan seed and the fault's index,
so the schedule is reproducible bit-for-bit across runs.

Each fault kind lands on a hook point that already exists in the code:

======================  ====================================================
``wedge``               ``DeviceWatchdog.call`` (the dispatch sleeps past
                        the deadline → ``DispatchTimeout`` → retry/ladder);
                        requires ``resilience.dispatch_timeout > 0``
``backend_error``       ``ResilientDispatcher.tally_batch`` (raises
                        ``BackendError`` on the named tier; ``times`` bounds
                        failed attempts, ``permanent`` fails the whole tier
                        for that batch → ladder descends)
``corrupt_tally``       ``IntegrityMonitor.arm_corruption`` (the integrity
                        layer quarantines and re-dispatches on frozen keys)
``torn_checkpoint``     checkpoint bytes truncated after the atomic write
                        (the v5 ``campaign.prev.json`` fallback recovers)
``kill_worker``         ``os._exit`` at a batch boundary (the elastic lease
                        board revokes the dead worker's leases and
                        survivors re-dispatch them on frozen keys)
======================  ====================================================

**Service-level kinds** target the multi-tenant fleet itself (the
reference's ``service/`` layer) rather than one campaign — the checker must
survive the faults it studies, and the resident scheduler is its weakest
link:

======================  ====================================================
``kill_fleet``          hard process death (``kill_action`` seam, default
                        ``os._exit``) at a fleet tick (``at_tick``) or right
                        after a write-ahead-journal record lands
                        (``at_journal``) — ``CampaignScheduler.recover()``
                        must replay snapshot+journal bit-identically
``torn_journal``        the journal append at ``at_journal`` persists only a
                        prefix (fsync'd) and the process dies — exactly a
                        power loss mid-append; replay must drop the torn
                        tail and lose nothing acknowledged before it
``corrupt_submission``  the ``at_submission``-th pending spool document the
                        scheduler inspects is corrupted in place (parses,
                        checksum fails) — the claim path must quarantine it
                        to ``spool/bad/`` instead of raising out of the loop
======================  ====================================================

**Federation-level kinds** target whole pods of the fleet-of-fleets
(the reference's ``federation/`` layer) — one gateway over N scheduler pods must
survive any single pod's death, and the chaos DSL is how that claim is
proven on a schedule:

======================  ====================================================
``kill_pod``            hard pod death at a pod fleet tick (``at_tick``) or
                        a federation round ordinal (``at_round``); fires
                        through the ``kill_action`` seam (the pod loop
                        rescopes it to ``PodKilled`` so only the named pod
                        dies) — the supervisor must declare the pod lost and
                        the gateway must fail its tenants over from their
                        namespaced checkpoints, bit-identically
``partition_pod``       heartbeat suppression WITHOUT death for ``rounds``
                        federation rounds starting at each ``at_round``:
                        the pod keeps computing but stops beating, the
                        supervisor declares it lost and fails over — when
                        the partition heals, the gateway must reconcile the
                        stale placement without double-counting the tenant
``kill_shard``          ``kill_pod`` addressed by SUB-TENANT: the fault
                        names one shard of a sharded campaign
                        (``<parent>+shardN``) and kills whatever pod hosts
                        it when that pod reaches ``at_tick`` / the
                        federation reaches ``at_round`` — the fault follows
                        the shard through failover instead of naming a pod
                        that may no longer serve it
``partition_during_merge``  heartbeat suppression addressed by MERGE
                        PROGRESS: the window opens at the first round where
                        the gateway's cumulative ``shard_fold`` ordinal
                        reaches ``at_fold`` and holds for ``rounds`` rounds
                        — the partition lands mid-merge no matter how many
                        rounds the shards needed to produce that fold
``kill_during_retire``  hard pod death addressed by the gateway's journaled
                        SCALE ORDINAL (``at_scale``): fires while the pod loop
                        is draining a retiring pod whose
                        ``pool_retire_begin`` record carries that ordinal —
                        the retire window is deterministically targetable no
                        matter which round the autoscaler decided in; lease
                        expiry + the journaled retire must finish the job
``kill_new_pod``        hard pod death addressed by the scale ordinal of a
                        ``pool_scale_up`` record (``at_scale``): the freshly
                        spawned pod dies on its first service step — the
                        gateway must fail its tenants over exactly as for
                        any dead pod, and recovery must not resurrect the
                        pod into a double placement
======================  ====================================================

Each kind's trigger vocabulary is validated per kind: a ``kill_pod``
with ``at_batch`` (or any trigger key outside its vocabulary) is a plan
error, not a silently-ignored fault.

Every injected and survived fault is counted per kind; the orchestrator
exposes the ledgers as the ``campaign.chaos.*`` stats group, so a chaos run
is self-describing from its stats dump alone.

The campaign-level kinds' hook points are in this package (the watchdog
and ladder of ``resilience.py``, the engines of ``parallel/pipeline.py``,
``IntegrityMonitor.arm_corruption``, the orchestrator's checkpoint writer
and batch boundary).  The service- and federation-level kinds are parsed
and their ``maybe_*`` / ``take_*`` methods are here; their call sites come
with those layers.  The engine is pure host-side bookkeeping: injections
ride hooks in modules that already own the device work.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.resilience import TIERS, BackendError
from shrewd_tpu_torch.utils import debug
from shrewd_tpu_torch.utils.config import ConfigObject, Param

debug.register_flag("Chaos", "deterministic fault-injection harness")

KINDS = ("wedge", "backend_error", "corrupt_tally", "torn_checkpoint",
         "kill_worker", "kill_fleet", "torn_journal", "corrupt_submission",
         "kill_pod", "partition_pod", "kill_shard",
         "partition_during_merge", "corrupt_binary", "kill_during_lift",
         "kill_during_retire", "kill_new_pod")

#: kinds whose triggers are NOT batch coordinates (never armed by
#: ``begin_batch``): checkpoint ordinals and the fleet/federation seams
_NON_BATCH_KINDS = ("torn_checkpoint", "kill_fleet", "torn_journal",
                    "corrupt_submission", "kill_pod", "partition_pod",
                    "kill_shard", "partition_during_merge",
                    "corrupt_binary", "kill_during_lift",
                    "kill_during_retire", "kill_new_pod")

#: trigger keys carrying id lists, by kind (fleet/federation kinds +
#: checkpoint); batch kinds use at_batch / sample / after_dispatches.
#: These tuples are also each kind's FULL trigger vocabulary — any other
#: ``_ID_KEYS`` key on a fault of that kind is a plan error (a
#: ``kill_pod`` with ``at_batch`` would otherwise arm nothing, silently)
_KIND_TRIGGERS = {
    "torn_checkpoint": ("at_ckpt",),
    "kill_fleet": ("at_tick", "at_journal"),
    "torn_journal": ("at_journal",),
    "corrupt_submission": ("at_submission",),
    "kill_pod": ("at_tick", "at_round"),
    "partition_pod": ("at_round",),
    "kill_shard": ("at_tick", "at_round"),
    "partition_during_merge": ("at_fold",),
    "corrupt_binary": ("at_stage",),
    "kill_during_lift": ("at_stage",),
    "kill_during_retire": ("at_scale",),
    "kill_new_pod": ("at_scale",),
}

_ID_KEYS = ("at_batch", "at_ckpt", "at_tick", "at_journal",
            "at_submission", "at_round", "at_fold", "at_stage",
            "at_scale")

KILL_DEFAULT_RC = 137


class ChaosPlanError(ValueError):
    """A chaos plan failed validation."""


class ChaosConfig(ConfigObject):
    """The ``plan.chaos`` config child: where this campaign's failure
    schedule comes from, so a chaos run is reproducible from its config
    dump like every other campaign posture."""

    plan_path = Param(str, "", "path to a chaos-plan JSON file "
                               "(empty = no chaos)")
    spec = Param(str, "", "inline chaos-plan JSON (overrides plan_path)")

    def build(self, worker: str = "") -> "ChaosEngine | None":
        if self.spec:
            return ChaosEngine(json.loads(self.spec), worker=worker)
        if self.plan_path:
            return ChaosEngine.from_path(self.plan_path, worker=worker)
        return None


def _as_id_list(v) -> list[int]:
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(x) for x in v]


def _normalize(plan: dict) -> list[dict]:
    """Validate + expand the fault list (seeded samples → explicit ids)."""
    seed = int(plan.get("seed", 0))
    faults = plan.get("faults")
    if not isinstance(faults, list):
        raise ChaosPlanError("chaos plan needs a 'faults' list")
    out: list[dict] = []
    for i, spec in enumerate(faults):
        kind = spec.get("kind")
        if kind not in KINDS:
            raise ChaosPlanError(
                f"fault {i}: unknown kind {kind!r} (one of {KINDS})")
        s = dict(spec)
        if "sample" in s:
            # the seeded schedule: k batch ids drawn from range(of) with
            # a PRNG that is a pure function of (plan seed, fault index)
            samp = s.pop("sample")
            rng = np.random.default_rng((seed, i))
            ids = rng.choice(int(samp["of"]), size=int(samp["k"]),
                             replace=False)
            s["at_batch"] = sorted(int(x) for x in ids)
        for key in _ID_KEYS:
            if key in s:
                s[key] = _as_id_list(s[key])
        if kind in _KIND_TRIGGERS:
            keys = _KIND_TRIGGERS[kind]
            if not any(k in s for k in keys):
                raise ChaosPlanError(
                    f"fault {i}: {kind} needs " + " / ".join(keys))
            # per-kind trigger vocab: an id key outside this kind's
            # vocabulary would silently never fire — reject it loudly
            stray = [k for k in _ID_KEYS if k in s and k not in keys]
            if stray:
                raise ChaosPlanError(
                    f"fault {i}: {kind} does not take {stray[0]!r} "
                    f"(its trigger vocabulary is {'/'.join(keys)})")
            if kind in ("partition_pod", "partition_during_merge") \
                    and int(s.get("rounds", 2)) < 1:
                raise ChaosPlanError(
                    f"fault {i}: {kind} 'rounds' must be >= 1")
        elif "at_batch" not in s and "after_dispatches" not in s:
            raise ChaosPlanError(
                f"fault {i}: {kind} needs at_batch / sample / "
                "after_dispatches")
        if "tier" in s and s["tier"] not in TIERS:
            raise ChaosPlanError(
                f"fault {i}: unknown tier {s['tier']!r} (one of {TIERS})")
        if "after_dispatches" in s:
            s["_fires_left"] = 1
        else:
            s["_fires_left"] = sum(len(s[k]) for k in _ID_KEYS
                                   if k in s) or 1
        out.append(s)
    return out


class ChaosEngine:
    """Armed per-batch injection state + the injected/survived ledgers.

    The orchestrator calls ``begin_batch`` before each dispatch it computes
    (elastic workers: each batch they *compute*, not adopt) and
    ``end_batch`` after the batch's tally is believed; hook owners
    (watchdog, ladder, monitor, checkpoint writer) consume armed faults via
    the ``take_* / maybe_*`` methods.  Everything is deterministic given
    the plan: no wall clock enters any trigger decision.
    """

    def __init__(self, plan: dict, worker: str = ""):
        self.worker = worker
        self.faults = _normalize(plan)
        self.injected: dict[str, int] = {}
        self.survived: dict[str, int] = {}
        self.fires: list[dict] = []          # evidence: what fired where
        self.dispatches = 0                  # batches this process computed
        self.ckpts = 0                       # checkpoints this process wrote
        self.submissions = 0                 # spool docs inspected (fleet)
        # kind -> LIST of armed states (a plan may schedule several
        # faults of the same kind onto one batch, e.g. backend_error on
        # two tiers to force a double descent — none may be dropped)
        self._armed: dict[str, list[dict]] = {}
        self._batch: tuple = ()              # (batch_id, simpoint, structure)
        self._wedge_warned = False
        # what a fired kill_worker actually DOES.  None = hard process
        # death via os._exit, resolved LATE at fire time (the elastic/
        # multi-host posture — the lease board must survive a worker that
        # vanishes without warning; late binding keeps monkeypatched
        # os._exit test harnesses working).  A multi-tenant fleet
        # rescopes it (service/scheduler.py): there the "worker" is one
        # tenant's step loop, not the host process, so the scheduler
        # installs an action that kills only the afflicted tenant — the
        # others must keep running, which is exactly the isolation the
        # fleet chaos test pins.
        self.kill_action = None

    @classmethod
    def from_path(cls, path: str, worker: str = "") -> "ChaosEngine":
        with open(path) as f:
            return cls(json.load(f), worker=worker)

    # --- ledger helpers -------------------------------------------------

    def _fire(self, kind: str, detail: dict | None = None) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        ev = {"kind": kind, "batch": self._batch}
        if detail:
            ev.update(detail)
        self.fires.append(ev)
        obs_trace.tracer().emit(
            "chaos_inject", cat="chaos", kind=kind,
            at=list(self._batch), **(detail or {}))
        debug.dprintf("Chaos", "injected %s at %s", kind, self._batch)

    def note_fired(self, kind: str) -> None:
        """External hooks (monitor corruption note) report a fire."""
        for st in self._armed.get(kind, ()):
            if not st["fired"]:
                st["fired"] = True
                self._fire(kind)
                return

    def note_survived(self, kind: str) -> None:
        self.survived[kind] = self.survived.get(kind, 0) + 1
        obs_trace.tracer().emit("chaos_survived", cat="chaos", kind=kind)
        debug.dprintf("Chaos", "survived %s", kind)

    # --- batch lifecycle ------------------------------------------------

    def begin_batch(self, batch_id: int, simpoint: str = "",
                    structure: str = "") -> None:
        """Arm the faults matching this batch.  Called once per batch this
        process computes (the per-process ``after_dispatches`` counter and
        the campaign-coordinate ``at_batch`` trigger both advance here)."""
        self.dispatches += 1
        self._armed = {}
        self._batch = (int(batch_id), simpoint, structure)
        for s in self.faults:
            if s["kind"] in _NON_BATCH_KINDS or s["_fires_left"] <= 0:
                continue
            if s.get("simpoint") and simpoint and s["simpoint"] != simpoint:
                continue
            if s.get("structure") and structure \
                    and s["structure"] != structure:
                continue
            hit = (batch_id in s.get("at_batch", ())
                   or s.get("after_dispatches") == self.dispatches)
            if not hit:
                continue
            s["_fires_left"] -= 1
            times = int(s.get("times", 1))
            if s.get("permanent"):
                times = 1 << 30      # within-batch permanent: tier descends
            self._armed.setdefault(s["kind"], []).append(
                {"spec": s, "left": times, "fired": False})

    def next_batch_fault(self, b0: int, simpoint: str = "",
                         structure: str = "",
                         min_id: int | None = None) -> int | None:
        """Smallest batch id >= ``min_id`` (default ``b0``) at which a
        batch-granular fault can still fire for this (simpoint,
        structure), or None.  The until-CI super-interval planner bounds
        its budget here: a fused campaign that converges before a
        scheduled fault's batch must never spuriously arm it (the serial
        loop would not have reached that batch, and the injected/survived
        ledgers must agree between the serial and fused loops under the
        same deterministic plan).  ``b0`` is the NEXT batch this process
        will arm: ``after_dispatches`` triggers count armed batches, so
        trigger d maps to batch ``b0 + (d - dispatches) - 1`` while this
        structure's run is what advances the counter."""
        lo = int(b0) if min_id is None else int(min_id)
        best = None
        for s in self.faults:
            if s["kind"] in _NON_BATCH_KINDS or s["_fires_left"] <= 0:
                continue
            if s.get("simpoint") and simpoint \
                    and s["simpoint"] != simpoint:
                continue
            if s.get("structure") and structure \
                    and s["structure"] != structure:
                continue
            for b in s.get("at_batch", ()):
                if b >= lo and (best is None or b < best):
                    best = b
            d = s.get("after_dispatches")
            if d is not None and d - self.dispatches >= 1:
                b = b0 + (d - self.dispatches) - 1
                if b >= lo and (best is None or b < best):
                    best = b
        return best

    def begin_batches(self, batch_ids, simpoint: str = "",
                      structure: str = "") -> None:
        """Interval-scoped arming (the pipelined engine consumes one sync
        interval at a time): arm the UNION of faults triggered by any id
        in ``batch_ids``, advancing the per-process dispatch counter once
        per batch — a batch-granular plan keeps firing at the same
        campaign coordinates whether the loop is serial or pipelined."""
        ids = [int(b) for b in batch_ids]
        armed: dict[str, list[dict]] = {}
        for b in ids:
            self.begin_batch(b, simpoint, structure)
            for kind, states in self._armed.items():
                armed.setdefault(kind, []).extend(states)
        self._armed = armed
        self._batch = (ids[0] if ids else -1, simpoint, structure)

    def end_batch(self) -> None:
        """The batch's tally was believed (invariants/canaries passed,
        quarantine recovered): every fault that fired during it was
        survived."""
        for kind, states in self._armed.items():
            for st in states:
                if st["fired"]:
                    self.note_survived(kind)
            if any(st["fired"] for st in states):
                continue
            if kind == "wedge" and not self._wedge_warned:
                # armed but no deadline-bearing dispatch ever consumed it
                # — the watchdog path was NOT proven; say so rather than
                # letting the operator read silence as success
                self._wedge_warned = True
                import warnings

                warnings.warn(
                    "chaos plan armed a 'wedge' fault but no dispatch "
                    "ran under a positive watchdog deadline "
                    "(resilience.dispatch_timeout) — the wedge never "
                    "fired and the watchdog path is NOT being proven",
                    RuntimeWarning, stacklevel=2)
        self._armed = {}

    # --- hook points ----------------------------------------------------

    def maybe_kill(self) -> None:
        """The elastic hook: hard process death at a batch boundary (the
        preempted-without-warning case the lease board must survive)."""
        for st in self._armed.get("kill_worker", ()):
            spec = st["spec"]
            # a worker-TARGETED kill fires only on the named worker — an
            # engine with no worker identity (e.g. built from plan config
            # before attach_elastic names it) must NOT match a filter
            # meant for someone else, or every process dies instead of one
            if spec.get("worker") and spec["worker"] != self.worker:
                continue
            st["fired"] = True
            self._fire("kill_worker", {"worker": self.worker})
            debug.dprintf("Chaos", "kill_worker %s: kill_action(%s)",
                          self.worker, spec.get("rc", KILL_DEFAULT_RC))
            self.kill_now(spec.get("rc"))

    def kill_now(self, rc=None) -> None:
        """Fire the kill seam: the configured ``kill_action`` (a fleet
        rescopes it; tests install a raising action) or a true hard
        ``os._exit`` — no atexit, no flush, no drain.  The flight
        recorder dumps FIRST (to its pre-registered path): a hard death
        is exactly the exit whose last events are otherwise lost."""
        rc = int(KILL_DEFAULT_RC if rc is None else rc)
        obs_trace.tracer().maybe_flight_dump("hard_kill", rc=rc,
                                             worker=self.worker)
        kill = self.kill_action if self.kill_action is not None \
            else os._exit
        kill(rc)

    # --- service-level hook points (the fleet scheduler/journal/spool) --

    def maybe_kill_fleet(self, tick: int | None = None,
                         journal_seq: int | None = None) -> None:
        """The fleet's hard-kill seam: ``kill_fleet`` fires at a fleet
        tick boundary (``at_tick``, consulted by the scheduler loop) or
        right after a journal record lands (``at_journal``, consulted by
        ``FleetJournal.append``) — both deterministic fleet coordinates,
        never a clock."""
        for s in self.faults:
            if s["kind"] != "kill_fleet" or s["_fires_left"] <= 0:
                continue
            hit = (tick is not None and tick in s.get("at_tick", ())) \
                or (journal_seq is not None
                    and journal_seq in s.get("at_journal", ()))
            if not hit:
                continue
            s["_fires_left"] -= 1
            self._batch = (tick if tick is not None else journal_seq,
                           "fleet", "")
            self._fire("kill_fleet",
                       {"tick": tick, "journal_seq": journal_seq})
            debug.dprintf("Chaos", "kill_fleet (tick=%s journal=%s)",
                          tick, journal_seq)
            self.kill_now(s.get("rc"))

    # --- federation-level hook points (the fleet-of-fleets gateway) -----

    def maybe_kill_pod(self, pod: str, tick: int | None = None,
                       round: int | None = None) -> None:
        """The federation's hard-kill seam: ``kill_pod`` fires when the
        named pod reaches fleet tick ``at_tick`` or the federation
        reaches round ``at_round`` — both deterministic federation
        coordinates.  The pod loop installs a ``kill_action`` that raises
        ``PodKilled`` so exactly one pod dies (the in-process analog of
        SIGKILLing one pod's server; the pod's outdir is left dirty,
        undrained — precisely what ``os._exit`` would leave)."""
        for s in self.faults:
            if s["kind"] != "kill_pod" or s["_fires_left"] <= 0:
                continue
            if s.get("pod") and s["pod"] != pod:
                continue
            hit = (tick is not None and tick in s.get("at_tick", ())) \
                or (round is not None and round in s.get("at_round", ()))
            if not hit:
                continue
            s["_fires_left"] -= 1
            self._batch = (tick if tick is not None else round,
                           "pod", pod)
            self._fire("kill_pod", {"pod": pod, "tick": tick,
                                    "round": round})
            debug.dprintf("Chaos", "kill_pod %s (tick=%s round=%s)",
                          pod, tick, round)
            self.kill_now(s.get("rc"))

    def partition_active(self, pod: str, round: int) -> bool:
        """Federation hook: True while the named pod is scheduled to be
        partitioned at this round (heartbeat suppression without death —
        the pod keeps computing; the pod loop simply withholds its beats).
        Each ``at_round`` window ``[r0, r0 + rounds)`` fires the ledger
        once at activation; the heal is implicit when the window ends
        and the pod loop reports ``note_survived`` once the federation
        converges through it."""
        active = False
        for s in self.faults:
            if s["kind"] != "partition_pod":
                continue
            if s.get("pod") and s["pod"] != pod:
                continue
            rounds = int(s.get("rounds", 2))
            for r0 in s.get("at_round", ()):
                if not (r0 <= round < r0 + rounds):
                    continue
                fired = s.setdefault("_partition_fired", [])
                if r0 not in fired:
                    if s["_fires_left"] <= 0:
                        continue
                    s["_fires_left"] -= 1
                    fired.append(r0)
                    self._batch = (round, "partition", pod)
                    self._fire("partition_pod",
                               {"pod": pod, "round": round,
                                "rounds": rounds})
                active = True
        return active

    def maybe_kill_shard(self, shard: str, tick: int | None = None,
                         round: int | None = None) -> None:
        """Sharded-campaign kill seam: ``kill_shard`` names one
        SUB-TENANT of a sharded campaign (``<parent>+shardN``) and
        fires when the pod hosting it reaches fleet tick ``at_tick``
        or the federation reaches round ``at_round``.  The pod loop
        consults this per shard child placed on the pod it is about to
        step and kills THAT pod — addressing the fault by shard means
        it follows the sub-tenant through failover instead of naming a
        pod that may no longer host it."""
        for s in self.faults:
            if s["kind"] != "kill_shard" or s["_fires_left"] <= 0:
                continue
            if s.get("shard") and s["shard"] != shard:
                continue
            hit = (tick is not None and tick in s.get("at_tick", ())) \
                or (round is not None and round in s.get("at_round", ()))
            if not hit:
                continue
            s["_fires_left"] -= 1
            self._batch = (tick if tick is not None else round,
                           "shard", shard)
            self._fire("kill_shard", {"shard": shard, "tick": tick,
                                      "round": round})
            debug.dprintf("Chaos", "kill_shard %s (tick=%s round=%s)",
                          shard, tick, round)
            self.kill_now(s.get("rc"))

    def partition_merge_active(self, pod: str, folds: int,
                               round: int) -> bool:
        """Merge-progress partition hook: True while the named pod is
        inside a ``partition_during_merge`` window.  The trigger
        coordinate is the gateway's cumulative merge-fold ordinal
        (``at_fold``: the count of journaled ``shard_fold`` records) —
        the window OPENS at the first federation round where ``folds``
        reaches ``at_fold`` and stays active for ``rounds`` rounds, so
        the partition lands exactly while a sharded campaign's merge
        is in flight no matter how many rounds the shards needed to
        produce that fold.  Deterministic like every other trigger:
        fold ordinals are journaled WAL appends, never a clock."""
        active = False
        for s in self.faults:
            if s["kind"] != "partition_during_merge":
                continue
            if s.get("pod") and s["pod"] != pod:
                continue
            rounds = int(s.get("rounds", 2))
            for f0 in s.get("at_fold", ()):
                started = s.setdefault("_merge_started", {})
                r0 = started.get(f0)
                if r0 is None:
                    if folds < f0 or s["_fires_left"] <= 0:
                        continue
                    s["_fires_left"] -= 1
                    started[f0] = r0 = round
                    self._batch = (round, "partition_merge", pod)
                    self._fire("partition_during_merge",
                               {"pod": pod, "fold": folds,
                                "round": round, "rounds": rounds})
                if r0 <= round < r0 + rounds:
                    active = True
        return active

    def maybe_kill_during_retire(self, pod: str, scale: int) -> None:
        """Pool-retirement kill seam: ``kill_during_retire`` is addressed
        by the gateway's journaled scale ordinal (``at_scale``: the
        ``scale`` field of the ``pool_retire_begin`` record) and fires
        while the pod loop is draining the retiring pod — after the retire
        is journaled, before ``pool_retire_done`` lands.  An optional
        ``pod`` filter narrows it further.  The window is deterministic
        no matter which round the autoscaler decided in: the ordinal is
        a WAL append, never a clock."""
        for s in self.faults:
            if s["kind"] != "kill_during_retire" or s["_fires_left"] <= 0:
                continue
            if s.get("pod") and s["pod"] != pod:
                continue
            if scale not in s.get("at_scale", ()):
                continue
            s["_fires_left"] -= 1
            self._batch = (scale, "retire", pod)
            self._fire("kill_during_retire", {"pod": pod, "scale": scale})
            debug.dprintf("Chaos", "kill_during_retire %s (scale=%d)",
                          pod, scale)
            self.kill_now(s.get("rc"))

    def maybe_kill_new_pod(self, pod: str, scale: int) -> None:
        """Scale-up kill seam: ``kill_new_pod`` is addressed by the scale
        ordinal of a ``pool_scale_up`` record (``at_scale``) and fires
        when the pod loop first steps the freshly spawned pod — the
        narrowest window where a new pod can die with placements already
        journaled onto it.  Optional ``pod`` filter as elsewhere."""
        for s in self.faults:
            if s["kind"] != "kill_new_pod" or s["_fires_left"] <= 0:
                continue
            if s.get("pod") and s["pod"] != pod:
                continue
            if scale not in s.get("at_scale", ()):
                continue
            s["_fires_left"] -= 1
            self._batch = (scale, "scale", pod)
            self._fire("kill_new_pod", {"pod": pod, "scale": scale})
            debug.dprintf("Chaos", "kill_new_pod %s (scale=%d)",
                          pod, scale)
            self.kill_now(s.get("rc"))

    def take_torn_journal(self, seq: int) -> dict | None:
        """Journal hook: the spec when journal record ``seq`` is
        scheduled to tear (the append persists a prefix and the process
        dies — see ``FleetJournal.append``), or None."""
        for s in self.faults:
            if s["kind"] != "torn_journal" or s["_fires_left"] <= 0:
                continue
            if seq in s.get("at_journal", ()):
                s["_fires_left"] -= 1
                self._batch = (seq, "journal", "")
                self._fire("torn_journal", {"journal_seq": seq})
                return s
        return None

    def take_corrupt_submission(self) -> dict | None:
        """Spool hook: called once per pending submission document the
        scheduler inspects; returns the spec when this inspection
        ordinal is scheduled to corrupt the document in place."""
        ordinal = self.submissions
        self.submissions += 1
        for s in self.faults:
            if s["kind"] != "corrupt_submission" or s["_fires_left"] <= 0:
                continue
            if ordinal in s.get("at_submission", ()):
                s["_fires_left"] -= 1
                self._batch = (ordinal, "submission", "")
                self._fire("corrupt_submission", {"submission": ordinal})
                return s
        return None

    # --- ingest-pipeline hook points (the journaled streaming ingest) ---

    def take_corrupt_binary(self, stage: int) -> dict | None:
        """Ingest hook: called at each journaled stage ordinal the
        pipeline is about to COMPUTE (cached stages never consult it —
        a warm start has no bytes in flight to rot); returns the spec
        when this ordinal is scheduled to checksum-rot the submitted
        binary in the artifact store.  The pipeline then rots the
        stored ELF itself (``rot_file``) so its per-stage digest
        re-verification deterministically lands the submission in
        quarantine at exactly this stage."""
        for s in self.faults:
            if s["kind"] != "corrupt_binary" or s["_fires_left"] <= 0:
                continue
            if stage in s.get("at_stage", ()):
                s["_fires_left"] -= 1
                self._batch = (stage, "ingest", "")
                self._fire("corrupt_binary", {"stage": stage})
                debug.dprintf("Chaos", "corrupt_binary (stage=%d)", stage)
                return s
        return None

    def maybe_kill_during_lift(self, stage: int) -> None:
        """Ingest hard-kill seam: ``kill_during_lift`` fires when the
        pipeline reaches stage ordinal ``at_stage`` with real work to do
        (the same compute-only consultation as ``take_corrupt_binary``)
        — the stage's WAL record has NOT landed yet, so recovery must
        resume from the previous durable stage and re-lift to
        bit-identical windows."""
        for s in self.faults:
            if s["kind"] != "kill_during_lift" or s["_fires_left"] <= 0:
                continue
            if stage not in s.get("at_stage", ()):
                continue
            s["_fires_left"] -= 1
            self._batch = (stage, "ingest", "")
            self._fire("kill_during_lift", {"stage": stage})
            debug.dprintf("Chaos", "kill_during_lift (stage=%d)", stage)
            self.kill_now(s.get("rc"))

    def take_wedge(self, timeout: float) -> dict | None:
        """Watchdog hook: ``{"fn": wedged, "deadline": s}`` (consumed once
        per armed count), or None.  Only meaningful under a positive
        watchdog deadline — with no deadline a wedge would hang the run,
        which is the disease, not the test.

        The injected dispatch carries its own (short) deadline, bounded by
        the real one: the campaign's deadline must stay generous enough
        for first-compile dispatches, but the injected wedge should prove
        the timeout machinery in test-scale time.  The wedged fn never
        touches the backend and exits shortly after abandonment, so the
        orphaned thread cannot poison in-flight collectives the way an
        abandoned *real* dispatch would."""
        if timeout <= 0:
            return None
        for st in self._armed.get("wedge", ()):
            if st["left"] <= 0:
                continue
            st["left"] -= 1
            if not st["fired"]:
                st["fired"] = True
                self._fire("wedge")
            deadline = min(timeout,
                           float(st["spec"].get("deadline", 0.25)))

            def wedged():
                time.sleep(deadline * 3)
                raise BackendError("chaos wedge released after deadline")
            return {"fn": wedged, "deadline": deadline}
        return None

    def maybe_backend_error(self, tier: int) -> None:
        """Ladder hook: raise ``BackendError`` on the named tier while the
        armed attempt budget lasts."""
        for st in self._armed.get("backend_error", ()):
            if st["left"] <= 0:
                continue
            want = st["spec"].get("tier", TIERS[0])
            if TIERS[tier] != want:
                continue
            st["left"] -= 1
            if not st["fired"]:
                st["fired"] = True
                self._fire("backend_error", {"tier": want})
            raise BackendError(
                f"chaos: injected {want}-tier failure "
                f"(batch {self._batch[0]})")

    def take_corrupt_tally(self) -> dict | None:
        """Integrity hook: the armed corruption spec (the orchestrator arms
        ``IntegrityMonitor.arm_corruption`` with it), or None.  The fire is
        reported back via ``note_fired`` when the corruption is actually
        applied to a dispatched tally."""
        for st in self._armed.get("corrupt_tally", ()):
            if st["left"] > 0:
                st["left"] -= 1
                return st["spec"]
        return None

    def take_torn_checkpoint(self) -> dict | None:
        """Checkpoint hook: called once per checkpoint written; returns the
        spec when this checkpoint ordinal is scheduled to tear."""
        ordinal = self.ckpts
        self.ckpts += 1
        for s in self.faults:
            if s["kind"] != "torn_checkpoint" or s["_fires_left"] <= 0:
                continue
            if ordinal in s.get("at_ckpt", ()):
                s["_fires_left"] -= 1
                self._batch = (ordinal, "ckpt", "")
                self._fire("torn_checkpoint", {"ckpt": ordinal})
                return s
        return None

    # --- reporting ------------------------------------------------------

    def to_dict(self) -> dict:
        return {"injected": dict(self.injected),
                "survived": dict(self.survived),
                "fires": list(self.fires)}


def tear_file(path: str, keep_fraction: float = 0.5) -> None:
    """Corrupt a file the way a power loss mid-write would: keep a prefix,
    drop the tail (the checksum/JSON-truncation detectors must catch it)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * keep_fraction), 1))


def rot_file(path: str) -> None:
    """Corrupt a file the way silent bit-rot would: same length, one
    byte flipped — content-digest verification (not truncation checks)
    must catch it.  This is the ``corrupt_binary`` injection: the rotted
    ELF no longer hashes to its store address, which is poison, not a
    cache miss."""
    with open(path, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def corrupt_json_checksum(path: str) -> None:
    """Corrupt a COMPLETE checksummed document the way bit-rot (not a
    torn write) would: the JSON still parses, the checksum no longer
    verifies — the reader's quarantine path, not its in-flight-skip
    path, must catch it."""
    with open(path) as f:
        doc = json.load(f)
    doc["checksum"] = "0" * 64
    with open(path, "w") as f:
        # graftlint: allow-raw-write -- chaos corruption: producing a
        # definitively-bad persisted document IS the injected fault
        json.dump(doc, f)
