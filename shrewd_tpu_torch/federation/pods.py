"""Pods and the pod supervisor: liveness for the fleet-of-fleets.

A **pod** is one complete `CampaignScheduler` deployment — its own
submission spool, its own outdir (namespaced tenant checkpoints, WAL,
``metrics.json``), its own mesh — exactly what one ``fleet.py --serve``
process owns.  ``PodHandle`` wraps that deployment for the in-process
federation driver: it builds (or hard-kill-recovers) the scheduler
lazily, steps it one cooperative quantum at a time
(``CampaignScheduler.step``), and announces liveness through the
coord-dir heartbeat machinery (``parallel/elastic.py``) — one atomic
``hb_<pod>.json`` lease renewal per federation round.

The **supervisor** is the other side of that lease: it reads each pod's
heartbeat and declares the pod dead when the lease expires.  Expiry is
counted in SUPERVISOR POLLS (federation rounds), never wall-clock
seconds, so a chaos schedule that suppresses a pod's beats
(``partition_pod``) produces the same death verdict at the same round
on every run — the federation's failure detector is as deterministic
as the chaos DSL that tests it.  (For a multi-process deployment the
same heartbeat files work with ``elastic.Membership``'s wall-clock
staleness; the supervisor's poll-counted view is the harness-grade
mode, and the one the chaos proofs pin.)

A pod killed by ``kill_pod`` chaos leaves EXACTLY what a SIGKILLed
server process leaves: a stale heartbeat, an undrained outdir, a dirty
WAL, namespaced tenant checkpoints — no drain, no snapshot.  That
equivalence is what lets the in-process federation prove the same
failover story a real multi-process deployment needs.

Device work starts when a pod's scheduler elaborates its first tenant;
on one card every pod's mesh is that card.  Port of
``shrewd_tpu/federation/pods.py``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

from shrewd_tpu_torch.parallel import elastic
from shrewd_tpu_torch.resilience import load_json_verified
from shrewd_tpu_torch.service.queue import SubmissionQueue
from shrewd_tpu_torch.utils import debug

debug.register_flag("Federation", "gateway / pods / failover")


class PodKilled(RuntimeError):
    """A chaos ``kill_pod`` fired: this pod's scheduler is dead (the
    in-process analog of SIGKILLing one pod's server process — the
    driver stops stepping it and its heartbeat goes stale)."""

    def __init__(self, pod: str, rc: int):
        super().__init__(f"pod {pod!r} killed by chaos (rc {rc})")
        self.pod = pod
        self.rc = rc


class PodPort(NamedTuple):
    """A pod's service surface as the gateway sees it: where to hand
    off submissions (spool), and where its durable state lives
    (outdir: ``metrics.json`` for load, ``tenants/<name>/`` for the
    checkpoints migration copies)."""

    name: str
    spool: str
    outdir: str


class PodHandle:
    """One pod of the federation (see module doc)."""

    def __init__(self, name: str, root: str, coord_dir: str, mesh=None,
                 **sched_kw):
        self.name = name
        self.root = root
        self.spool_dir = os.path.join(root, "spool")
        self.outdir = os.path.join(root, "out")
        self.queue = SubmissionQueue(self.spool_dir)
        self.heartbeat = elastic.HeartbeatWriter(coord_dir, name)
        self.mesh = mesh
        self.sched_kw = dict(sched_kw)
        self.sched = None
        self.dead = False            # kill_pod fired (stepping stops)
        self.partitioned = False     # beats suppressed, still computing
        self.steps = 0
        # cumulative seconds inside step() (obs.clock — observability
        # only, GL106: the sharded-speedup evidence compares the solo
        # run's busy time against the hottest shard pod's; it never
        # feeds a scheduling decision)
        self.busy_s = 0.0

    @property
    def port(self) -> PodPort:
        return PodPort(self.name, self.spool_dir, self.outdir)

    def build(self):
        """Build the pod's resident scheduler — via ``recover()``, which
        is a fresh build when no durable state exists and a
        snapshot+WAL replay when a previous incarnation died hard (the
        pod restart path is the recovery path; there is no separate
        cold-start code to drift)."""
        from shrewd_tpu_torch.service.scheduler import CampaignScheduler

        if self.sched is None:
            self.sched = CampaignScheduler.recover(
                self.outdir, mesh=self.mesh, queue=self.queue,
                idle_exit=False, **self.sched_kw)
        return self.sched

    def step(self):
        """One cooperative scheduler quantum (``None`` / ``IDLE`` / rc)."""
        from shrewd_tpu_torch.obs import clock as obs_clock

        self.steps += 1
        t0 = obs_clock.monotonic()
        try:
            return self.build().step()
        finally:
            self._sync()
            self.busy_s += obs_clock.monotonic() - t0

    def _sync(self) -> None:
        """End a timed step on a device sync: kernels launch
        asynchronously, and pods that share one card would otherwise
        charge each other's queued work to whichever pod syncs next."""
        mesh = getattr(self.sched, "_mesh", None)
        if mesh is None:
            return
        import torch

        for dev in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def beat(self) -> None:
        """Renew this pod's liveness lease (atomic heartbeat write).
        The driver withholds the call while a ``partition_pod`` window
        is active — suppression IS the partition."""
        self.heartbeat.beat()

    def kill(self) -> None:
        """Mark the pod hard-dead (chaos): stepping stops, beats stop,
        and everything durable stays exactly as the kill left it."""
        self.dead = True
        self.sched = None

    def drain(self) -> int | None:
        """Gracefully drain a live pod to resumable checkpoints
        (federation shutdown); returns the pod's fleet rc."""
        if self.dead or self.sched is None:
            return None
        from shrewd_tpu_torch.service.scheduler import IDLE

        self.sched.request_drain()
        while True:
            rc = self.sched.step()
            if rc is not IDLE and rc is not None:
                return rc


class PodSupervisor:
    """Lease-expiry liveness over the coord-dir heartbeats.

    ``observe()`` is called once per federation round: a pod whose
    heartbeat content has not advanced for ``expiry_rounds``
    consecutive polls (or that never beat at all) has let its lease
    expire and is reported dead.  The verdict is a pure function of
    the observed beat sequence — deterministic under the chaos
    schedule that drives suppression."""

    def __init__(self, coord_dir: str, expiry_rounds: int = 3):
        self.coord_dir = coord_dir
        os.makedirs(coord_dir, exist_ok=True)
        self.expiry_rounds = max(1, int(expiry_rounds))
        self.membership = elastic.Membership(coord_dir)
        self._seen: dict[str, tuple[int | None, int]] = {}

    def _beats(self, pod: str) -> int | None:
        try:
            return int(load_json_verified(
                self.membership._hb_path(pod))["beats"])
        except (OSError, ValueError, KeyError, TypeError):
            return None              # never beat / torn mid-read

    def observe(self, pods) -> dict[str, bool]:
        """One supervisor poll: ``{pod: alive}`` for every named pod."""
        out = {}
        for name in pods:
            beats = self._beats(name)
            prev, stale = self._seen.get(name, (None, 0))
            stale = 0 if (beats is not None and beats != prev) \
                else stale + 1
            self._seen[name] = (beats if beats is not None else prev,
                                stale)
            out[name] = stale < self.expiry_rounds
            if not out[name]:
                debug.dprintf("Federation",
                              "pod %s lease expired (%d stale polls)",
                              name, stale)
        return out

    def alive(self, pod: str) -> bool:
        _beats, stale = self._seen.get(pod, (None, 0))
        return stale < self.expiry_rounds
