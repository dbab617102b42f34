"""Live fleet metrics: atomic per-tick snapshots + Prometheus exposition.

The resident scheduler (``service/scheduler.py``) calls ``publish`` each
tick: a JSON snapshot lands atomically at ``<outdir>/metrics.json``
(readers never observe a torn document) and the same numbers render as
Prometheus text exposition at ``<outdir>/metrics.prom`` — the pull
surface a scraper or ``tools/obs.py --tail`` consumes without touching
scheduler internals.

Per tenant: status, trials served, trials/s, scheduling quanta, virtual
time (the fair-share position), queue latency, failures/kills, and the
live Wilson half-width per (simpoint, structure) — the half-width
trajectory that says how far each tenant is from convergence.  Fleet-
wide: tick count, fairness index, executable-cache hit rate (the
cross-tenant compile-dedupe observable), write-ahead-journal depth, and
recovery/quarantine counts.

Wall-clock reads route through ``obs.clock`` (GL106): rates are
*observability*, never scheduling inputs — every scheduling decision
still consumes only admission order, trial counts and weights.

Port of ``shrewd_tpu/obs/metrics.py``.  ``cache_compiled`` and
``cache_reused`` read the port's kernel registry
(``parallel/exec_cache.cache()``): kernels built and shared, where the
reference counts compiled executables.  Host only.
"""

from __future__ import annotations

import os

from shrewd_tpu_torch.obs import clock

METRICS_JSON = "metrics.json"
METRICS_PROM = "metrics.prom"

#: the federation gateway's pool-ledger surfaces (published under the
#: GATEWAY outdir, not a pod's — pool membership is gateway state)
POOL_JSON = "pool.json"
POOL_PROM = "pool.prom"

#: exposition prefix — one namespace for every gauge this module emits
_PROM_NS = "shrewd_fleet"


def _convergence(orch) -> tuple[dict, float, dict]:
    """``({lane: halfwidth}, eta_trials, {lane: cumulative counts})`` of
    one tenant's orchestrator — the convergence-distance trajectory,
    computed by the SAME estimator selection the stopping rule applies
    (post-stratified when the strata history covers the trials, pooled
    Wilson otherwise) so the published distance never disagrees with the
    rule that decides stopping.  ``eta_trials`` sums
    ``stopping.eta_trials`` (the planner's own trials-needed trajectory)
    over the tenant's lanes — the number the federation gateway routes
    on: convergence distance, not instantaneous throughput.  The third
    element is the per-lane cumulative {tallies, trials, strata} counts
    — the live numbers the gateway's sharded-merge fold sums across
    sub-tenants (``stopping.merged_fold``)."""
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.parallel import stopping

    hws = {}
    eta = 0.0
    lanes = {}
    for (sp, st), s in orch.state.items():
        lane = f"{sp}/{st}"
        lanes[lane] = {
            "tallies": [int(x) for x in s.tallies],
            "trials": int(s.trials),
            "strata": (None if s.strata is None else
                       [[int(x) for x in row] for row in s.strata]),
        }
        if s.trials <= 0:
            # an unstarted lane still owes its whole min_trials floor
            # (bounded by the cap — a sharded sub-tenant's slice may be
            # smaller than the parent's min_trials floor)
            eta += float(min(orch.plan.min_trials, orch.plan.max_trials))
            continue
        vul = int(s.tallies[C.OUTCOME_SDC] + s.tallies[C.OUTCOME_DUE])
        hws[lane] = round(float(stopping.live_halfwidth(
            vul, s.trials, s.strata, orch.plan.stratify,
            orch.plan.confidence)), 6)
        if not s.done and not s.converged:
            # `done` and not `converged` = the lane hit its max_trials
            # cap with the CI still wide: it will never run again, so
            # it owes NO further trials — counting its (permanently
            # positive) trajectory distance would leave phantom ETA
            # mass on the pod and misroute the federation gateway.
            # The live trajectory distance is clamped at the remaining
            # max_trials budget for the same reason: trials past the
            # cap will never be served, and for a sharded sub-tenant
            # the remaining budget IS its share of the remaining batch
            # space — an unclamped trajectory would overstate a sharded
            # campaign's finish time by the shard count.
            eta += min(
                stopping.eta_trials(
                    vul, s.trials, s.strata, orch.plan.stratify,
                    orch.plan.confidence, orch.plan.target_halfwidth,
                    orch.plan.min_trials),
                max(0.0, float(orch.plan.max_trials) - s.trials))
    return hws, eta, lanes


def snapshot(sched) -> dict:
    """One JSON-able metrics snapshot of a ``CampaignScheduler``."""
    from shrewd_tpu_torch.parallel import exec_cache

    now_mono = clock.monotonic()
    tenants = {}
    for name, t in sched.tenants.items():
        wall = t.wall_s
        if not wall and t._t_admit is not None:
            wall = now_mono - t._t_admit
        row = {
            "status": t.status,
            "priority": t.spec.priority,
            "weight": t.spec.weight,
            "trials": t.trials,
            "batches": t.batches,
            "ticks": t.ticks,
            "vtime": round(t.vtime, 3),
            "trials_per_s": (round(t.trials / wall, 2) if wall > 0
                             else 0.0),
            "queue_latency_s": round(t.queue_latency_s, 3),
            "failures": t.failures,
            "kills": t.kills,
            "rc": t.rc,
        }
        if t.orch is not None:
            hws, eta, lanes = _convergence(t.orch)
            row["halfwidth"] = hws
            # per-lane cumulative counts: the gateway's sharded-merge
            # fold consumes these live (stopping.merged_fold) — tallies
            # are a few ints per lane, so the snapshot stays small
            row["lanes"] = lanes
            # the half-width-trajectory ETA: trials still needed to
            # reach the stopping rule's target, plus its projections
            # onto scheduling quanta and wall seconds (the deadline-
            # estimate inputs of the federation gateway)
            row["eta_trials"] = round(eta, 1)
            per_tick = t.trials / t.ticks if t.ticks > 0 else 0.0
            row["eta_ticks"] = (round(eta / per_tick, 1)
                                if per_tick > 0 else None)
            row["eta_s"] = (round(eta / row["trials_per_s"], 2)
                            if row["trials_per_s"] > 0 else None)
        tenants[name] = row
    cs = exec_cache.cache().stats()
    fleet = {
        "ticks": sched.ticks,
        "tenants": len(sched.tenants),
        "by_status": sched._by_status(),
        "fairness_index": round(sched.fairness_index(), 4),
        "depth_budget": sched.depth_budget,
        "cache_compiled": cs["compiled"],
        "cache_reused": cs["reused"],
        "cache_hit_rate": round(
            cs["reused"] / max(cs["reused"] + cs["compiled"], 1), 4),
        "journal_depth": (sched._journal.since_compact
                          if sched._journal is not None else 0),
        "recoveries": sched.recoveries,
        "quarantined": sum(1 for t in sched.tenants.values()
                           if t.status == "quarantined"),
        "pruned": sum(1 for t in sched.tenants.values()
                      if t.status == "pruned"),
        "evicted": sum(1 for t in sched.tenants.values()
                       if t.status == "evicted"),
    }
    return {"schema": 1, "tick": sched.ticks, "wall_time": clock.now(),
            "tenants": tenants, "fleet": fleet}


def _label_escape(v) -> str:
    """Prometheus label-value escaping (exposition format: backslash,
    double quote and newline must be escaped — an unescaped tenant name
    would make the scraper reject the whole exposition)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(snap: dict) -> str:
    """Prometheus text exposition (gauge-only) of one snapshot."""
    lines = []

    def gauge(name: str, value, labels: dict | None = None,
              help_: str = ""):
        full = f"{_PROM_NS}_{name}"
        if help_:
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} gauge")
        lab = ""
        if labels:
            body = ",".join(f'{k}="{_label_escape(v)}"'
                            for k, v in sorted(labels.items()))
            lab = "{" + body + "}"
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        lines.append(f"{full}{lab} {v:g}")

    fleet = snap.get("fleet", {})
    gauge("ticks", fleet.get("ticks", 0),
          help_="scheduling quanta dispatched fleet-wide")
    gauge("fairness_index", fleet.get("fairness_index", 1.0),
          help_="Jain index over weight-normalized trials served")
    gauge("cache_hit_rate", fleet.get("cache_hit_rate", 0.0),
          help_="process-wide executable-cache hit rate")
    gauge("journal_depth", fleet.get("journal_depth", 0),
          help_="write-ahead journal records since last compaction")
    gauge("recoveries", fleet.get("recoveries", 0),
          help_="hard-kill recoveries survived")
    gauge("tenants_quarantined", fleet.get("quarantined", 0),
          help_="poison tenants parked in durable quarantine")
    # metric-family-OUTER, tenant-inner: the exposition format requires
    # every sample of one family contiguous under a single HELP/TYPE —
    # interleaving per tenant makes promtool reject the whole document
    tenants = sorted(snap.get("tenants", {}).items())
    families = dict(
        trials="trials served", trials_per_s="serving rate",
        ticks="scheduling quanta", vtime="fair-share virtual time",
        queue_latency_s="submit-to-admission seconds",
        failures="tick/elaboration exceptions",
        eta_trials="half-width-trajectory trials still needed",
        eta_ticks="scheduling quanta to projected convergence",
        eta_s="seconds to projected convergence")
    for key, hp in families.items():
        first = True
        for name, row in tenants:
            gauge(f"tenant_{key}", row.get(key, 0), {"tenant": name},
                  help_=hp if first else "")
            first = False
    first = True
    for name, row in tenants:
        for lane, hw in sorted((row.get("halfwidth") or {}).items()):
            gauge("tenant_halfwidth", hw, {"tenant": name, "lane": lane},
                  help_="live Wilson half-width" if first else "")
            first = False
    return "\n".join(lines) + "\n"


def publish(outdir: str, sched) -> dict:
    """Snapshot + write both surfaces atomically; returns the snapshot.

    Atomic means RENAME-atomic only — readers racing the scheduler never
    see a torn document — but deliberately UNSYNCED: publish runs on
    every scheduler tick, the snapshot is overwritten by the next tick,
    and an fsync per tick would serialize disk latency into the dispatch
    hot loop for durability nobody needs (crash recovery reads the WAL,
    never metrics)."""
    import json

    snap = snapshot(sched)
    os.makedirs(outdir, exist_ok=True)
    tmp = os.path.join(outdir, METRICS_JSON + ".tmp")
    with open(tmp, "w") as f:
        # graftlint: allow-raw-write -- per-tick metrics snapshot:
        # atomic rename, deliberately unsynced (overwritten next tick;
        # a per-tick fsync would stall the scheduling loop, and crash
        # recovery reads the journal, never this file)
        json.dump(snap, f, default=str)
    os.replace(tmp, os.path.join(outdir, METRICS_JSON))
    prom = prometheus_text(snap)
    tmp = os.path.join(outdir, METRICS_PROM + ".tmp")
    with open(tmp, "w") as f:
        f.write(prom)
    os.replace(tmp, os.path.join(outdir, METRICS_PROM))
    return snap


def pool_prometheus_text(pool: dict) -> str:
    """Prometheus exposition of the gateway's pool ledger
    (``Gateway.pool_status()`` — pure WAL-derived state: the gauges
    below are a rendering of the journaled ``pool_scale_up`` /
    ``pool_retire_begin`` / ``pool_retire_done`` records, never a
    second count of pod processes)."""
    lines = []

    def gauge(name: str, value, labels: dict | None = None,
              help_: str = ""):
        full = f"{_PROM_NS}_{name}"
        if help_:
            lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} gauge")
        lab = ""
        if labels:
            body = ",".join(f'{k}="{_label_escape(v)}"'
                            for k, v in sorted(labels.items()))
            lab = "{" + body + "}"
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        lines.append(f"{full}{lab} {v:g}")

    gauge("pool_size", pool.get("size", 0),
          help_="pods in the gateway's journaled pool ledger")
    gauge("pool_live", pool.get("live", 0),
          help_="pods eligible for placement (not dead, not retiring)")
    gauge("pool_pending_scale_decisions",
          pool.get("pending_scale_decisions", 0),
          help_="journaled pool transitions not yet completed "
                "(retires begun without a pool_retire_done)")
    gauge("pool_scale_seq", pool.get("scale_seq", 0),
          help_="journaled scale ordinal (pool WAL records so far)")
    first = True
    for pod, rounds in sorted(
            (pool.get("retire_drain_rounds") or {}).items()):
        gauge("pool_retire_drain_rounds", rounds, {"pod": pod},
              help_="federation rounds from pool_retire_begin to "
                    "pool_retire_done" if first else "")
        first = False
    return "\n".join(lines) + "\n"


def publish_pool(outdir: str, pool: dict) -> None:
    """Write the pool ledger's observability surfaces (rename-atomic,
    deliberately unsynced like ``publish`` — recovery replays the
    gateway WAL, never these files)."""
    import json

    os.makedirs(outdir, exist_ok=True)
    tmp = os.path.join(outdir, POOL_JSON + ".tmp")
    with open(tmp, "w") as f:
        # graftlint: allow-raw-write -- per-round pool snapshot: atomic
        # rename, deliberately unsynced (overwritten next round; crash
        # recovery replays the gateway WAL, never this file)
        json.dump(pool, f, default=str)
    os.replace(tmp, os.path.join(outdir, POOL_JSON))
    tmp = os.path.join(outdir, POOL_PROM + ".tmp")
    with open(tmp, "w") as f:
        f.write(pool_prometheus_text(pool))
    os.replace(tmp, os.path.join(outdir, POOL_PROM))


def read(outdir: str) -> dict:
    """Load the latest snapshot (``tools/obs.py --tail``)."""
    import json

    with open(os.path.join(outdir, METRICS_JSON)) as f:
        return json.load(f)


def read_pool(outdir: str) -> dict:
    """Load the latest pool-ledger surface (``GET /pool``)."""
    import json

    with open(os.path.join(outdir, POOL_JSON)) as f:
        return json.load(f)
