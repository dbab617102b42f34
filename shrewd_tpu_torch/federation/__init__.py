"""Federated fleet-of-fleets: one service surface over many meshes.

The service layer made ONE resident scheduler a certifiable,
crash-safe campaign service — but still one process, one mesh.  This
package is the tier above it: a **gateway** routes tenants across N
independent ``CampaignScheduler`` pods by live convergence distance
(the half-width-trajectory ETA each pod publishes in its
``metrics.json``), journals every routing decision to its own
write-ahead ledger BEFORE acting on it, and survives any single pod's
hard death by recovering that pod's tenants on survivors from their
namespaced checkpoints — **migration by bit-identity**: every pod
resumes on frozen per-batch PRNG keys, so a tenant drained on pod A
and recovered on pod B finishes bit-identical to a solo run, which
makes failover, live rebalancing and partition fencing all the same
free operation.

- ``gateway.py``    — ``Gateway``: the crash-safe routing ledger
  (``FleetJournal`` reused as the gateway WAL), ETA/SLO admission with
  deadline estimates, the two-phase route→handoff→place placement that
  ``recover()`` replays without ever double-placing a tenant;
- ``pods.py``       — ``PodHandle`` (one scheduler deployment: spool +
  outdir + coord-dir heartbeat lease) and ``PodSupervisor``
  (round-counted lease expiry over ``parallel/elastic.py`` heartbeats
  — a deterministic failure detector);
- ``autoscale.py``  — ``Autoscaler``: the journaled pool control loop
  (ETA mass + unplaced backlog + SLO-miss pressure in, GL201-certified
  ``pool_scale_up`` / ``pool_retire_begin`` / ``pool_retire_done`` WAL
  records out; retirement rides the ordinary drain-here/recover-there
  migration path, so every pool decision replays from the WAL alone);
- ``driver.py``     — ``Federation``: the single-threaded round-robin
  over the pods' cooperative ``CampaignScheduler.step()`` seam, chaos
  integration (``kill_pod`` / ``partition_pod``), failover, healing
  + fencing, ETA-runaway rebalancing;
- ``http_front.py`` — the thin network adapter: POST /submit into the
  gateway spool, GET /status off the published snapshot.

The invariant, pinned in ``tests/test_federation.py``: the
federation's aggregate tallies are bit-identical to solo serial runs
under any schedule of pod deaths, partitions and migrations, and each
tenant is counted exactly once — the routing ledger, not whoever
happened to compute, decides who reports.

Port of ``shrewd_tpu/federation/``: copies of the reference's modules
with their imports pointed at the port.  Device work starts inside the
pods' schedulers; on one card every pod's mesh is that card.
"""

from shrewd_tpu_torch.federation.autoscale import Autoscaler
from shrewd_tpu_torch.federation.driver import Federation
from shrewd_tpu_torch.federation.gateway import (Gateway, RouteEntry,
                                           copy_tenant_checkpoint,
                                           find_spool_ticket,
                                           gateway_journal_path,
                                           gateway_snap_path)
from shrewd_tpu_torch.federation.http_front import GatewayHTTPFront
from shrewd_tpu_torch.federation.pods import (PodHandle, PodKilled, PodPort,
                                        PodSupervisor)

__all__ = ["Autoscaler", "Federation", "Gateway", "GatewayHTTPFront",
           "PodHandle",
           "PodKilled", "PodPort", "PodSupervisor", "RouteEntry",
           "copy_tenant_checkpoint", "find_spool_ticket",
           "gateway_journal_path", "gateway_snap_path"]
