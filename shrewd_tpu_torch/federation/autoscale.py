"""Journaled pool autoscaling: pressure signals in, WAL records out.

The gateway already publishes everything a pool controller needs — each
pod's ETA mass (``pod_load``: convergence distance, not instantaneous
throughput), the backlog it has accepted but not yet placed, and every
tenant's admission deadline against its SLO.  The ``Autoscaler`` folds
those three signals into one pressure score and, when the score crosses
its thresholds, asks the gateway to change the pool — and that is ALL
it does.  The decision only exists once the gateway journals it
(``pool_scale_up`` / ``pool_retire_begin`` land in the gateway WAL
before any pod is touched); the federation driver then reconciles pod
processes to the journaled ledger (spawning handles, draining retiring
pods through the ordinary migration path, completing retires with
``pool_retire_done``).  The split is deliberate: recovery without an
autoscaler attached (``Federation.recover``, the crashcheck sweep)
still completes every pending pool transition, because completing is
the driver's job and deciding was already durable.

Determinism: thresholds and cooldowns are counted in federation rounds
and trials — never wall-clock seconds — so the same submissions against
the same chaos schedule scale the pool at the same rounds on every run.

Pure host-side control arithmetic.  Port of
``shrewd_tpu/federation/autoscale.py``.
"""

from __future__ import annotations

from shrewd_tpu_torch.federation.gateway import TERMINAL, est_trials
from shrewd_tpu_torch.utils import debug


class Autoscaler:
    """The pool control loop (see module doc).

    ``min_pods``/``max_pods`` bound the LIVE pool; ``up_trials`` /
    ``down_trials`` are per-pod pressure thresholds in trials (the unit
    every signal already carries); ``cooldown_rounds`` spaces decisions
    so one burst of submissions cannot fork the pool faster than the
    drains it causes can settle; ``slo_weight`` scales how much each
    projected SLO miss inflates the pressure score."""

    def __init__(self, min_pods: int = 1, max_pods: int = 8,
                 up_trials: float = 8192.0, down_trials: float = 512.0,
                 cooldown_rounds: int = 2, slo_weight: float = 0.5):
        self.min_pods = max(1, int(min_pods))
        self.max_pods = max(self.min_pods, int(max_pods))
        self.up_trials = float(up_trials)
        self.down_trials = float(down_trials)
        self.cooldown_rounds = max(0, int(cooldown_rounds))
        self.slo_weight = float(slo_weight)
        self.last_round: int | None = None   # round of the last decision
        self.decisions: list[dict] = []      # local audit (the WAL is truth)

    def pressure(self, gw) -> dict:
        """The pool pressure evidence: ETA mass across live pods,
        unplaced backlog (accepted entries with no pod yet — queued
        surplus shards included), and projected SLO-deadline misses.
        The combined ``score`` is per-pod trials inflated by misses; the
        whole dict rides into the ``pool_scale_up`` record so every
        decision is auditable from the WAL alone."""
        live = gw.live_pods()
        loads = {n: gw.pod_load(n) for n in live}
        eta_mass = sum(ld["score"] for ld in loads.values())
        backlog = 0.0
        unplaced = 0
        slo_misses = 0
        for e in gw.entries.values():
            if e.status in TERMINAL or e.status == "sharded":
                continue
            if e.status == "accepted":
                unplaced += 1
                backlog += est_trials(e.spec)
            if e.spec.slo_s and e.deadline_s is not None \
                    and e.deadline_s > e.spec.slo_s:
                slo_misses += 1
        per_pod = (eta_mass + backlog) / max(len(live), 1)
        score = per_pod * (1.0 + self.slo_weight * slo_misses)
        return {"live": len(live), "eta_mass": round(eta_mass, 1),
                "backlog_trials": round(backlog, 1),
                "unplaced": unplaced, "slo_misses": slo_misses,
                "per_pod_trials": round(per_pod, 1),
                "score": round(score, 1)}

    def tick(self, gw, rnd: int) -> dict | None:
        """One control decision for federation round ``rnd``: scale up,
        begin one retire, or do nothing.  At most one decision per
        cooldown window, never more than one pending retire at a time
        (a second retire before the first drain settles would read the
        drain's transient as idleness), and the returned decision is
        only ever a REPORT — the gateway journaled it already."""
        if self.last_round is not None \
                and rnd - self.last_round < self.cooldown_rounds:
            return None
        p = self.pressure(gw)
        if p["score"] > self.up_trials and p["live"] < self.max_pods:
            pod = gw.pool_scale_up(reason="pressure", pressure=p,
                                   round=rnd)
            self.last_round = rnd
            d = {"action": "scale_up", "pod": pod, "round": rnd,
                 "pressure": p}
            self.decisions.append(d)
            debug.dprintf("Federation", "autoscale up -> %s (score %.0f)",
                          pod, p["score"])
            return d
        if p["score"] < self.down_trials and p["live"] > self.min_pods \
                and not gw.retiring:
            victim = self._victim(gw)
            if victim is None:
                return None
            scale = gw.pool_retire_begin(victim, reason="idle", round=rnd)
            self.last_round = rnd
            d = {"action": "retire", "pod": victim, "scale": scale,
                 "round": rnd, "pressure": p}
            self.decisions.append(d)
            debug.dprintf("Federation",
                          "autoscale retire %s (score %.0f)",
                          victim, p["score"])
            return d
        return None

    def _victim(self, gw) -> str | None:
        """Which pod retires: the coldest live pod, autoscaled pods
        strictly first — the pool contracts back to its static floor
        before any hand-built pod is ever considered."""
        live = gw.live_pods()
        if len(live) <= self.min_pods:
            return None
        loads = {n: gw.pod_load(n) for n in live}
        scaled = [n for n in live if n in gw.scaled_pods]
        pool = scaled or live
        return min(pool, key=lambda n: (loads[n]["score"], n))
