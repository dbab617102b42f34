"""Confidence-interval estimation and early stopping (the port's copy of
``shrewd_tpu/parallel/stopping.py``: the host rules in float64, the
``*_device`` mirrors in float32 torch).

The statistical machinery of the north star ("wall-clock to AVF ±1% CI"):
AVF is a binomial proportion over trials; the campaign stops when the
interval half-width reaches the target.  Wilson intervals avoid the Wald
interval's collapse at p→0/1 (SDC rates near 1e-5 in the replication DSE),
and stopping on a *fixed precision* rather than sequential significance keeps
the early-stop bias negligible (SURVEY §7 hard part #5).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.ops import classify as C

# two-sided z for common confidence levels; non-tabulated confidences are
# bisected once and memoized here — the 80-iteration erf bisection used to
# rerun on EVERY should_stop call (once per batch per campaign for e.g.
# confidence=0.975)
_Z = {0.90: 1.6448536269514722, 0.95: 1.959963984540054,
      0.99: 2.5758293035489004}


def z_value(confidence: float) -> float:
    z = _Z.get(confidence)
    if z is not None:
        return z
    # Acklam-style rational approximation is overkill here; bisect the
    # complementary error function instead (exact enough for stopping).
    lo, hi = 0.0, 10.0
    target = (1.0 + confidence) / 2.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < target:
            lo = mid
        else:
            hi = mid
    z = (lo + hi) / 2
    _Z[confidence] = z
    return z


class Interval(NamedTuple):
    estimate: float    # point estimate (Wilson center is used for bounds)
    lo: float
    hi: float

    @property
    def halfwidth(self) -> float:
        return (self.hi - self.lo) / 2.0


def wilson(successes: float, trials: float, confidence: float = 0.95) -> Interval:
    """Wilson score interval for a binomial proportion."""
    if trials <= 0:
        return Interval(float("nan"), 0.0, 1.0)
    z = z_value(confidence)
    p = successes / trials
    denom = 1.0 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    margin = (z / denom) * math.sqrt(
        p * (1 - p) / trials + z * z / (4 * trials * trials))
    return Interval(p, max(0.0, center - margin), min(1.0, center + margin))


def should_stop(successes: float, trials: float, target_halfwidth: float,
                confidence: float = 0.95, min_trials: int = 1000) -> bool:
    """The campaign stopping rule: enough trials AND CI tight enough."""
    if trials < min_trials:
        return False
    return wilson(successes, trials, confidence).halfwidth <= target_halfwidth


def trials_needed(p_guess: float, target_halfwidth: float,
                  confidence: float = 0.95) -> int:
    """Planning estimate: trials for a Wald-width target at proportion p."""
    z = z_value(confidence)
    p = min(max(p_guess, 1e-12), 1 - 1e-12)
    return int(math.ceil(z * z * p * (1 - p) / (target_halfwidth ** 2)))


def post_stratified(tallies_h, confidence: float = 0.95) -> Interval:
    """Post-stratified proportion estimate from per-stratum (vulnerable,
    trials) counts: ``tallies_h`` is a sequence of (successes_h, n_h).

    Stratum weights are the OBSERVED allocation shares W_h = n_h / n (the
    sampler draws strata at their natural rates, so the observed shares are
    unbiased weights); the estimator is p̂ = Σ W_h p̂_h with variance
    Σ W_h² p̃_h(1-p̃_h)/n_h — ≤ the pooled binomial variance when
    per-stratum rates differ (classic post-stratification; normal-approx
    interval, adequate at campaign trial counts).  The variance uses the
    Agresti-Coull-adjusted p̃_h = (s_h+2)/(n_h+4), never the raw p̂_h: a
    tiny stratum with all-vulnerable or all-masked trials would otherwise
    contribute ZERO variance and stop the campaign before the claimed
    coverage holds.  Empty strata contribute nothing."""
    n = sum(nh for _s, nh in tallies_h)
    if n <= 0:
        return Interval(float("nan"), 0.0, 1.0)
    z = z_value(confidence)
    p = 0.0
    var = 0.0
    for s_h, n_h in tallies_h:
        if n_h <= 0:
            continue
        w = n_h / n
        p += w * (s_h / n_h)
        pt = (s_h + 2.0) / (n_h + 4.0)
        var += w * w * pt * (1.0 - pt) / n_h
    margin = z * math.sqrt(var)
    return Interval(p, max(0.0, p - margin), min(1.0, p + margin))


def should_stop_stratified(tallies_h, target_halfwidth: float,
                           confidence: float = 0.95,
                           min_trials: int = 1000) -> bool:
    """Stratified stopping rule (post_stratified interval vs target)."""
    n = sum(nh for _s, nh in tallies_h)
    if n < min_trials:
        return False
    return post_stratified(tallies_h,
                           confidence).halfwidth <= target_halfwidth


def pairs_from_strata(strata) -> list:
    """(N_STRATA, N_OUTCOMES) tally → [(vulnerable_h, n_h), ...] for
    post_stratified/should_stop_stratified.  The single definition of
    "vulnerable" for stratified stopping — the orchestrator and
    run_until_ci must not diverge on it."""
    s = np.asarray(strata)
    vul_h = s[:, C.OUTCOME_SDC] + s[:, C.OUTCOME_DUE]
    return list(zip(vul_h.tolist(), s.sum(axis=1).tolist()))


def strata_cover_trials(strata, trials: int) -> bool:
    """True iff the strata history accounts for every counted trial (the
    gate for using the stratified rule over pooled Wilson)."""
    return strata is not None and int(np.asarray(strata).sum()) == trials


def eta_trials(vulnerable: int, trials: int, strata, stratify: bool,
               confidence: float, target_halfwidth: float,
               min_trials: int) -> float:
    """Trials the stopping rule still plausibly needs — the half-width-
    trajectory estimate (Wilson hw ~∝ 1/√n at a stable p̂, so distance-
    to-target is ~ n·((hw/target)² − 1)), floored by ``min_trials``.
    THE single convergence-distance estimator: the orchestrator's
    adaptive sync interval and until-CI planner consume it, and
    ``obs/metrics`` publishes it per tenant so the federation gateway
    routes and estimates deadlines on the same number the stopping rule
    would act on.  0.0 means the rule could stop now."""
    need = float(min_trials - trials)
    if trials > 0:
        hw = live_halfwidth(vulnerable, trials, strata, stratify,
                            confidence)
        target = float(target_halfwidth)
        if hw > target > 0:
            need = max(need, trials * ((hw / target) ** 2 - 1.0))
    return max(0.0, need)


def live_halfwidth(vulnerable: int, trials: int, strata,
                   stratify: bool, confidence: float) -> float:
    """The half-width the live stopping rule actually tracks: the
    post-stratified (Agresti-Coull) estimator when the campaign
    stratifies and the strata history covers every counted trial, pooled
    Wilson otherwise — the same selection the orchestrator's convergence
    check applies, so any published convergence distance (metrics
    snapshots, the trials-needed planner) agrees with the rule that
    decides stopping."""
    if stratify and strata_cover_trials(strata, trials):
        return post_stratified(pairs_from_strata(strata),
                               confidence).halfwidth
    return wilson(vulnerable, trials, confidence).halfwidth


def merged_fold(lanes_by_shard, stratify: bool, confidence: float,
                target_halfwidth: float, min_trials: int) -> dict:
    """Order-fixed fold of per-shard cumulative lane reports into the
    merged campaign trajectory (the federation gateway's single-campaign
    sharding merge, ``federation/gateway.py``).

    ``lanes_by_shard`` maps shard index → {lane: {"tallies", "trials",
    "strata"}} where each report is that shard's CUMULATIVE count over
    its round-robin stripe of the parent's frozen batch-id space.  The
    fold sums in ascending shard index — int64 tally addition is exact,
    so the fixed order is what makes the recorded merge trajectory
    deterministic under WAL replay (the psum-vs-shard invariant
    ``integrity.py`` checks per batch, lifted to the fleet level).
    Because shard i of N serves global ids {i, i+N, ...}, a balanced
    fold (every shard r batches deep) covers exactly the solo prefix
    {0..rN−1}: the merged tallies are bit-identical to the solo
    accumulation at the same trial count.

    Returns {lane: {"tallies": [...], "trials", "strata", "halfwidth",
    "converged"}} — JSON-ready, evaluated with the SAME rule selection
    as ``live_halfwidth`` so the merged stopping decision is the one the
    solo campaign's convergence check would have made."""
    merged: dict = {}
    has_strata: dict = {}
    for idx in sorted(lanes_by_shard):
        for lane, rep in lanes_by_shard[idx].items():
            m = merged.setdefault(lane, {"tallies": None, "trials": 0,
                                         "strata": None})
            t = np.asarray(rep["tallies"], dtype=np.int64)
            m["tallies"] = t if m["tallies"] is None else m["tallies"] + t
            m["trials"] += int(rep["trials"])
            s = rep.get("strata")
            if s is None:
                has_strata[lane] = False
            elif has_strata.setdefault(lane, True):
                sa = np.asarray(s, dtype=np.int64)
                m["strata"] = (sa if m["strata"] is None
                               else m["strata"] + sa)
    for lane, m in merged.items():
        strata = (m["strata"].tolist()
                  if has_strata.get(lane) and m["strata"] is not None
                  else None)
        vul = int(m["tallies"][C.OUTCOME_SDC]
                  + m["tallies"][C.OUTCOME_DUE])
        hw = live_halfwidth(vul, m["trials"], strata, stratify, confidence)
        m["tallies"] = m["tallies"].tolist()
        m["strata"] = strata
        m["avf"] = vul / max(m["trials"], 1)
        m["halfwidth"] = hw
        m["converged"] = bool(m["trials"] > 0
                              and m["trials"] >= min_trials
                              and hw <= float(target_halfwidth))
    return merged


# --------------------------------------------------------------------------
# device mirrors
# --------------------------------------------------------------------------
#
# float32 torch mirrors of the two stopping half-widths, for a run-until-CI
# step that keeps its cumulative tallies on the device.  Each follows the
# HOST formula's operation order, so the only divergence is float32-vs-
# float64 rounding; a tally within float32 epsilon of the target could flip
# the decision either way, which the host rule's re-evaluation of the
# counted tallies catches.


def wilson_halfwidth_device(successes, trials, z):
    """``wilson(successes, trials).halfwidth`` as float32 tensor math
    (``successes``/``trials`` integer tensors, ``z`` a float32 tensor)."""
    n = torch.clamp(trials, min=1).to(torch.float32)
    s = successes.to(torch.float32)
    p = s / n
    zz = z * z
    denom = 1.0 + zz / n
    center = (p + zz / (2.0 * n)) / denom
    margin = (z / denom) * torch.sqrt(
        p * (1.0 - p) / n + zz / (4.0 * n * n))
    lo = torch.clamp(center - margin, min=0.0)
    hi = torch.clamp(center + margin, max=1.0)
    return (hi - lo) / 2.0


def post_stratified_halfwidth_device(strata, z):
    """``post_stratified(pairs_from_strata(strata)).halfwidth`` as float32
    tensor math over the (N_STRATA, N_OUTCOMES) cumulative tally:
    observed-share weights, Agresti-Coull-adjusted per-stratum variance,
    empty strata contributing nothing (the host's zero-variance guard,
    mirrored with a where-mask instead of a continue)."""
    n_h = strata.sum(dim=1).to(torch.float32)
    s_h = (strata[:, C.OUTCOME_SDC]
           + strata[:, C.OUTCOME_DUE]).to(torch.float32)
    n = torch.clamp(n_h.sum(), min=1.0)
    nz = n_h > 0
    safe_n_h = torch.clamp(n_h, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=strata.device)
    w = torch.where(nz, n_h / n, zero)
    p = torch.sum(torch.where(nz, w * (s_h / safe_n_h), zero))
    pt = (s_h + 2.0) / (n_h + 4.0)
    var = torch.sum(torch.where(nz, w * w * pt * (1.0 - pt) / safe_n_h,
                                zero))
    margin = z * torch.sqrt(var)
    lo = torch.clamp(p - margin, min=0.0)
    hi = torch.clamp(p + margin, max=1.0)
    return (hi - lo) / 2.0


def should_stop_device(halfwidth, trials, target_halfwidth, min_trials):
    """The stopping decision on the device: enough trials AND CI tight
    enough — the integer gates are exact mirrors of ``should_stop``; only
    the half-width comparison carries float32 rounding."""
    return (trials >= min_trials) & (halfwidth <= target_halfwidth)
