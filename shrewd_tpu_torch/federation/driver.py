"""The federation driver: gateway + N pods + supervisor in one loop.

``Federation`` composes the tier: it builds N pods (each a complete
``CampaignScheduler`` deployment — own spool, own outdir, own WAL), a
``Gateway`` routing over their published surfaces, and a
``PodSupervisor`` watching their heartbeat leases; then ``serve()``
round-robins every live pod through the scheduler's cooperative
``step()`` seam, one quantum per federation round, single-threaded and
deterministic.  Between rounds the driver runs the control plane:
claim gateway submissions, renew pod leases (withheld while a
``partition_pod`` chaos window is active), take supervisor verdicts
(death → ``Gateway.pod_dead`` failover; resurrection →
``Gateway.pod_heal`` + fencing evictions on the healed pod), advance
migrations, execute the quota revocations the gateway's sharded-merge
fold decides (``Gateway.shard_revocations`` →
``CampaignScheduler.revoke_quota``, idempotent and re-derived from the
ledger every round), and rebalance when one pod's ETA runs away.

In-process pods are the harness posture, not a toy: a pod "hard
killed" by ``kill_pod`` chaos simply stops being stepped and stops
beating — its durable outdir (dirty WAL, namespaced checkpoints, stale
heartbeat) is byte-for-byte what a SIGKILLed ``fleet.py --serve``
process leaves, so the failover the driver proves is the one a
multi-process deployment needs.  Bit-identity does the rest: every
placement resumes from frozen-key checkpoints, so the federation's
final tallies equal solo runs no matter which pods died, partitioned,
or traded tenants mid-campaign (the ``tests/test_federation.py``
pins).

Rebalancing policy (deliberately simple, journaled like everything
else): every ``rebalance_every`` rounds, if the hottest live pod's ETA
mass exceeds ``rebalance_factor ×`` the coldest's and the hot pod
serves more than one active tenant, the tenant with the largest
remaining ETA migrates to the coldest pod — drain-here/recover-there,
the same path failover uses.  A tenant is never migrated more than
``max_epochs`` times (placement flapping caps itself).

Port of ``shrewd_tpu/federation/driver.py``.  The reference also
points every pod at jax's persistent compilation cache in the shared
store; the port compiles nothing per step, so pods in one process share
``TrialKernel``s through the kernel registry (``parallel/exec_cache``)
instead, and the store keeps its directory layout.
"""

from __future__ import annotations

from shrewd_tpu_torch.federation.gateway import Gateway, TERMINAL
from shrewd_tpu_torch.federation.pods import PodHandle, PodKilled, PodSupervisor
from shrewd_tpu_torch.service.queue import TenantSpec
from shrewd_tpu_torch.service.scheduler import IDLE
from shrewd_tpu_torch.utils import debug

import os
import time


class Federation:
    """One fleet-of-fleets (see module doc)."""

    def __init__(self, root: str, pod_names=("pod0", "pod1", "pod2"),
                 mesh=None, chaos=None, autoscale=None, on_round=None,
                 quantum: int = 1,
                 expiry_rounds: int = 3, rebalance_every: int = 0,
                 rebalance_factor: float = 4.0, max_epochs: int = 3,
                 idle_exit: bool = True, poll_interval: float = 0.2,
                 **sched_kw):
        self.root = root
        self.coord_dir = os.path.join(root, "coord")
        # ONE digest-keyed artifact store for the whole federation: a
        # binary ingested on any pod warm-starts in O(1) on every other
        # (failover/migration re-runs the tenant's ingest pipeline
        # against the same store, so re-placement costs zero lifts)
        sched_kw.setdefault("store_dir", os.path.join(root, "store"))
        # kept for pool reconciliation: journaled scale-ups spawn their
        # PodHandles with the same posture as the static pods
        self.mesh = mesh
        self.sched_kw = dict(sched_kw)
        self.pods = {
            name: PodHandle(name, os.path.join(root, "pods", name),
                            self.coord_dir, mesh=mesh, **sched_kw)
            for name in pod_names}
        self.gateway = Gateway(
            os.path.join(root, "gateway"),
            pods={n: p.port for n, p in self.pods.items()})
        self.supervisor = PodSupervisor(self.coord_dir,
                                        expiry_rounds=expiry_rounds)
        self.chaos = chaos
        self.autoscale = autoscale   # federation/autoscale.Autoscaler
        #: supervisor hook called once per round with the federation
        #: (the scenario runner's Pareto fold rides here) — callers own
        #: their own exception posture, same as the scheduler's on_tick
        self.on_round = on_round
        self.quantum = max(1, int(quantum))
        self.rebalance_every = int(rebalance_every)
        self.rebalance_factor = float(rebalance_factor)
        self.max_epochs = max(1, int(max_epochs))
        self.idle_exit = idle_exit
        self.poll_interval = float(poll_interval)
        self.round = 0
        self.idle_rounds = 0
        self.migrations = 0
        self.failovers = 0
        self.fenced = 0
        self.revoked = 0             # shard-convergence quota revocations
        self.scale_ups = 0           # pods added by pool autoscaling
        self.retired = 0             # pool retires completed

    @classmethod
    def recover(cls, root: str, pod_names=("pod0", "pod1", "pod2"),
                **kw) -> "Federation":
        """Rebuild a federation after ANY shutdown of the driver
        process — the gateway replays its WAL (``Gateway.recover``,
        repairing interrupted placements), and each pod's scheduler
        replays its own WAL lazily the first time the serve loop builds
        it (``PodHandle.build`` routes through
        ``CampaignScheduler.recover``).  The whole tier restarts the
        way it cold-starts: recovery IS the boot path."""
        fed = cls(root, pod_names=pod_names, **kw)
        # the freshly-built gateway is replaced by the recovered one
        # (same outdir, same spool object — Gateway.__init__ is
        # deliberately side-effect-free beyond mkdir, so the swap is
        # cheap; the WAL opens lazily on first append)
        fed.gateway = Gateway.recover(
            os.path.join(root, "gateway"),
            pods={n: p.port for n, p in fed.pods.items()},
            spool=fed.gateway.spool)
        return fed

    # --- submissions -------------------------------------------------------

    def submit(self, spec: TenantSpec) -> dict:
        """Direct admission through the gateway (tests, the CLI's
        --plans mode).  Spool/HTTP submissions go through
        ``gateway.poll_spool`` inside the serve loop instead."""
        return self.gateway.admit(spec)

    # --- chaos seams -------------------------------------------------------

    def _maybe_kill(self, pod: PodHandle) -> bool:
        """Consult the kill_pod schedule for this pod at the current
        (tick, round) coordinates; True when the pod just died.  The
        kill_action raises ``PodKilled`` so exactly one pod dies — the
        driver survives to supervise the failover, which is the point."""
        if self.chaos is None or pod.dead:
            return False
        name = pod.name

        def _kill(rc):
            raise PodKilled(name, rc)

        prev = self.chaos.kill_action
        self.chaos.kill_action = _kill
        try:
            tick = pod.sched.ticks if pod.sched is not None else 0
            self.chaos.maybe_kill_pod(name, tick=tick, round=self.round)
            # kill_new_pod: addressed by the journaled scale ordinal of
            # this pod's pool_scale_up record — consulted every step but
            # single-fire, so it lands on the fresh pod's FIRST quantum
            # no matter which round the autoscaler decided in
            scale = self.gateway.scaled_pods.get(name)
            if scale is not None:
                self.chaos.maybe_kill_new_pod(name, scale)
            # kill_shard: the schedule names a SUB-TENANT of a sharded
            # campaign; the fault kills whatever pod currently hosts it
            # — consult it for every shard child placed here so the
            # fault follows the shard through failover
            for e in self.gateway.entries.values():
                if e.shard_of and e.pod == name \
                        and e.status in ("routed", "placed"):
                    self.chaos.maybe_kill_shard(
                        e.spec.name, tick=tick, round=self.round)
        except PodKilled as e:
            debug.dprintf("Federation", "%s", e)
            pod.kill()
            return True
        finally:
            self.chaos.kill_action = prev
        return False

    # --- the elastic pool --------------------------------------------------

    def _drive_pool(self) -> None:
        """Reconcile pod processes to the gateway's journaled pool
        ledger — the WAL decides, this loop obeys.  Four passes, all
        idempotent per round:

        - let the autoscaler (when attached) journal at most one new
          decision;
        - spawn a ``PodHandle`` for every journaled scaled-up pod that
          has none yet (recovery lands here too: a ``pool_scale_up``
          replayed from the WAL gets its pod process back);
        - drive every pending retire: migrate non-terminal tenants off
          the fenced pod through the ordinary drain-here/recover-there
          path, and journal ``pool_retire_done`` once nothing
          non-terminal remains (a DEAD retiring pod needs no drain —
          lease expiry already failed its tenants over, which is what
          makes a hung retire safe);
        - drop handles for pods the ledger no longer owns.

        On convergence the elastic headroom is drained back to the
        static floor: every remaining autoscaled pod is retired, so a
        3→N federation always finishes at 3 — the pool's steady state
        is the hand-built one, and the WAL shows the full round trip."""
        gw = self.gateway
        if self.autoscale is not None:
            d = self.autoscale.tick(gw, self.round)
            if d is not None and d["action"] == "scale_up":
                self.scale_ups += 1
        if not gw.spool.pending() and gw.entries and gw.all_done():
            for name in sorted(gw.scaled_pods):
                if name in gw.retiring:
                    continue
                try:
                    gw.pool_retire_begin(name, reason="converged",
                                         round=self.round)
                except (ValueError, RuntimeError):
                    break
        for name in sorted(gw.pods):
            if name not in self.pods:
                self.pods[name] = PodHandle(
                    name, os.path.join(self.root, "pods", name),
                    self.coord_dir, mesh=self.mesh, **self.sched_kw)
        for name in sorted(gw.retiring):
            pod = self.pods.get(name)
            rec = gw.retires.get(name) or {}
            scale = int(rec.get("scale") or 0)
            if self.chaos is not None and pod is not None \
                    and not pod.dead:
                # the retire window is deterministically targetable:
                # kill_during_retire addresses this retire's journaled
                # scale ordinal, scoped to kill exactly this pod
                def _kill(rc, _n=name):
                    raise PodKilled(_n, rc)

                prev = self.chaos.kill_action
                self.chaos.kill_action = _kill
                try:
                    self.chaos.maybe_kill_during_retire(name, scale)
                except PodKilled as e:
                    debug.dprintf("Federation", "%s", e)
                    pod.kill()
                finally:
                    self.chaos.kill_action = prev
            live_here = [e for e in gw.entries.values()
                         if e.pod == name and e.status not in TERMINAL]
            if not live_here:
                if pod is not None and name not in gw.dead_pods:
                    pod.drain()
                gw.pool_retire_done(name, round=self.round)
                self.retired += 1
                continue
            if pod is None or pod.dead or name in gw.dead_pods:
                continue             # lease expiry moves the tenants
            for e in live_here:
                if e.status == "placed":
                    try:
                        target = gw._pick_pod(
                            exclude=(name,), avoid=gw._sibling_pods(e))
                    except RuntimeError:
                        break        # no live target: wait for one
                    gw.migrate(e.spec.name, target, "retire")
                if e.status == "draining" and pod.sched is not None \
                        and e.spec.name in pod.sched.tenants:
                    pod.sched.evict(e.spec.name, "retire")
        for name in list(self.pods):
            if name not in gw.pods:
                self.pods.pop(name)
        try:
            from shrewd_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.publish_pool(gw.outdir, gw.pool_status())
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    # --- the serve loop ----------------------------------------------------

    def _step_pod(self, pod: PodHandle) -> None:
        """One quantum of one pod: chaos-check at every scheduler tick
        boundary (kill_pod at_tick must land between ticks, exactly
        where a SIGKILL between run-loop iterations would), then step."""
        for _ in range(self.quantum):
            if self._maybe_kill(pod):
                return
            try:
                rc = pod.step()
            except PodKilled as e:
                debug.dprintf("Federation", "%s", e)
                pod.kill()
                return
            if rc is not None and rc is not IDLE:
                return                   # pod's scheduler went terminal

    def _supervise(self) -> None:
        """Take the supervisor's lease verdicts: deaths fail over,
        resurrections heal + fence."""
        alive = self.supervisor.observe(sorted(self.pods))
        for name, ok in alive.items():
            if not ok and name not in self.gateway.dead_pods:
                moved = self.gateway.pod_dead(name)
                self.failovers += len(moved)
            elif ok and name in self.gateway.dead_pods:
                pod = self.pods[name]
                stale = self.gateway.pod_heal(name)
                # fence the healed pod: any tenant the ledger moved
                # elsewhere while it was partitioned must stop being
                # served here — its copy's tallies are bit-identical,
                # but only the authoritative placement reports
                if pod.sched is not None and not pod.dead:
                    for tenant in stale:
                        t = pod.sched.tenants.get(tenant)
                        if t is not None and t.status in ("queued",
                                                          "running"):
                            pod.sched.evict(tenant, "fenced")
                            self.fenced += 1

    def _maybe_rebalance(self) -> None:
        if not self.rebalance_every \
                or self.round % self.rebalance_every:
            return
        live = self.gateway.live_pods()
        if len(live) < 2:
            return
        loads = {n: self.gateway.pod_load(n) for n in live}
        hot = max(live, key=lambda n: (loads[n]["score"], n))
        cold = min(live, key=lambda n: (loads[n]["score"], n))
        if hot == cold or loads[hot]["tenants"] < 2:
            return
        if loads[hot]["score"] < self.rebalance_factor \
                * max(loads[cold]["score"], 1.0):
            return
        # the hot pod's ETA ran away: move its largest-REMAINING-ETA
        # migratable tenant to the coldest pod (SLO-tightest first on
        # ties — the tenant with the least slack gets the fresh pod).
        # Remaining ETA is the LIVE per-tenant number the hot pod
        # publishes — the admission-time estimate on the entry is a
        # whole-plan + queue snapshot that never updates, and picking
        # by it would migrate nearly-finished tenants
        cands = [e for e in self.gateway.entries.values()
                 if e.pod == hot and e.status == "placed"
                 and e.epoch < self.max_epochs]
        if not cands:
            return
        try:
            from shrewd_tpu_torch.obs import metrics as obs_metrics

            rows = obs_metrics.read(self.pods[hot].outdir).get(
                "tenants", {})
        except (OSError, ValueError):
            rows = {}

        def remaining(e):
            row = rows.get(e.spec.name) or {}
            eta = row.get("eta_trials")
            return float(eta) if eta is not None \
                else float(e.eta_trials or 0.0)

        pick = max(cands, key=lambda e: (
            remaining(e), -(e.spec.slo_s or float("inf")),
            e.spec.name))
        if remaining(pick) <= 0:
            return                       # nothing migratable is owed work
        if self.gateway.migrate(pick.spec.name, cold, "eta-runaway"):
            self.migrations += 1
            pod = self.pods[hot]
            if pod.sched is not None and not pod.dead:
                pod.sched.evict(pick.spec.name, "migrate")

    def serve(self, max_rounds: int = 100000) -> int:
        """Drive the federation until every admitted tenant is done,
        then drain the surviving pods to resumable checkpoints and
        snapshot the gateway.  Returns 0 on convergence."""
        while True:
            self.round += 1
            if self.round - self.idle_rounds > max_rounds:
                # only WORKING rounds count against the runaway guard:
                # a resident federation (idle_exit=False) polls an
                # empty spool indefinitely, and idling is not failing
                # to converge
                raise RuntimeError(
                    f"federation did not converge in {max_rounds} "
                    f"working rounds: {self.gateway._by_status()}")
            self.gateway.poll_spool()
            self._drive_pool()
            for name in sorted(self.pods):
                pod = self.pods[name]
                if pod.dead:
                    continue
                if pod.sched is None:
                    pod.build()
                self._step_pod(pod)
                pod.partitioned = self.chaos is not None and (
                    self.chaos.partition_active(name, self.round)
                    or self.chaos.partition_merge_active(
                        name, self.gateway.folds, self.round))
                if not pod.dead and not pod.partitioned:
                    pod.beat()
            self._supervise()
            self.gateway.poll()
            # shard convergence revocation: the gateway only decides
            # (journaled shard_converged + the stateless revocation
            # list); executing the revoke on each pod's scheduler is
            # the driver's job — same division of authority as
            # migration evictions.  revoke_quota is idempotent and the
            # list is re-derived from the ledger every poll, so a
            # revocation missed while a pod was dead or partitioned is
            # simply retried next round.
            for child, pod_name in self.gateway.shard_revocations():
                pod = self.pods.get(pod_name)
                # a stripe failed over this round sits in its new pod's
                # spool until that pod's next step claims it: its
                # revocation waits a round, like a dead pod's (the
                # reference revokes it at once and raises KeyError,
                # ROADMAP Queue 3 R9)
                if pod is None or pod.dead or pod.partitioned \
                        or pod.sched is None \
                        or child not in pod.sched.tenants:
                    continue
                if pod.sched.revoke_quota(child, "shard-converged"):
                    self.revoked += 1
            self._maybe_rebalance()
            if self.on_round is not None:
                self.on_round(self)
            if not self.gateway.spool.pending() and (
                    self.gateway.all_done()
                    or not self.gateway.entries):
                if self.gateway.retiring or (self.gateway.entries
                                             and self.gateway.scaled_pods):
                    continue         # pool transitions still settling
                if self.idle_exit:
                    break
                self.idle_rounds += 1
                time.sleep(self.poll_interval)
        # converged: note chaos survivals (every injected pod fault the
        # federation finished through), drain survivors, snapshot
        if self.chaos is not None:
            for kind in ("kill_pod", "partition_pod", "kill_shard",
                         "partition_during_merge", "kill_during_retire",
                         "kill_new_pod"):
                done = self.chaos.injected.get(kind, 0) \
                    - self.chaos.survived.get(kind, 0)
                for _ in range(done):
                    self.chaos.note_survived(kind)
        for name in sorted(self.pods):
            self.pods[name].drain()
        self.gateway.shutdown()
        debug.dprintf("Federation", "converged in %d rounds "
                      "(%d failovers, %d migrations, %d fenced)",
                      self.round, self.failovers, self.migrations,
                      self.fenced)
        return 0

    # --- aggregate views ---------------------------------------------------

    def results(self) -> dict:
        return self.gateway.results()

    def tenant_tallies(self, name: str) -> dict:
        return self.gateway.tenant_tallies(name)

    def counters(self) -> dict:
        return {"rounds": self.round, "failovers": self.failovers,
                "migrations": self.migrations, "fenced": self.fenced,
                "revoked": self.revoked,
                "scale_ups": self.scale_ups, "retired": self.retired,
                "busy_s": {n: round(self.pods[n].busy_s, 4)
                           for n in sorted(self.pods)},
                "dead_pods": sorted(self.gateway.dead_pods)}
