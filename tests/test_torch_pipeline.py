"""The port's interval and until-CI steps and pipelined engines against
the serial loop and the JAX package's, on the CPU.

``dispatch_interval`` / ``materialize_interval`` must equal the summed
``tally_batch`` tallies (and strata) and the reference's interval step,
with the escape counters moved exactly as the serial loop moves them;
the until-CI step must consume the serial loop's batch count and give its
tallies and strata on the dense, hybrid and stratified paths, with the
reference's half-width trajectory; and ``PerfStats`` must carry the
reference's fields.  The module fixture of ``test_torch_orchestrator.py``
provides the reference's jax 0.9 aliases (R1, R4)."""

import numpy as np
import pytest

from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import pipeline as RPL
from shrewd_tpu.parallel import stopping as RS
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.parallel import ShardedCampaign
from shrewd_tpu_torch.parallel import pipeline as PL
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# the module's R1/R4 fixture (autouse) and the one-device mesh
from test_torch_orchestrator import _reference_on_jax_09, mesh  # noqa: F401

_PATHS = [({}, False), ({"escape_budget": 4}, True),
          ({"replay_kernel": "dense"}, False),
          ({"replay_kernel": "dense"}, True)]
_IDS = ["hybrid", "hybrid-over-budget-stratified", "dense",
        "dense-stratified"]


def _batches(seed, n_batches, B):
    ks = [_keys(seed + i, B) for i in range(n_batches)]
    return [r for r, _ in ks], [m for _, m in ks]


@pytest.mark.parametrize("cfg,stratify", _PATHS, ids=_IDS)
def test_interval_equals_summed_batches(window, mesh, cfg, stratify):
    rk, mk = _kernels(window, **cfg)
    rkeys, keys = _batches(90, 3, 64)
    camp = ShardedCampaign(mk, None, "fu", stratify=stratify,
                           integrity_check=True)
    assert camp.supports_intervals
    tally, strata = camp.tally_interval(keys)
    esc, tt = mk.escapes, mk.taint_trials
    # the serial loop on a fresh kernel
    _, mk2 = _kernels(window, **cfg)
    serial = ShardedCampaign(mk2, None, "fu", stratify=stratify)
    per = [serial.tally_batch_stratified(k).numpy() if stratify
           else serial.tally_batch(k).numpy() for k in keys]
    if stratify:
        np.testing.assert_array_equal(strata, np.sum(per, axis=0))
        np.testing.assert_array_equal(tally, np.sum(per, axis=0).sum(0))
    else:
        assert strata is None
        np.testing.assert_array_equal(tally, np.sum(per, axis=0))
    assert tally.dtype == np.int64
    assert (esc, tt) == (mk2.escapes, mk2.taint_trials)
    assert camp.shard_checks == 1 and camp.transfers == 1
    # the reference's interval step on the same keys
    rcamp = RefCampaign(rk, mesh, "fu", stratify=stratify,
                        integrity_check=True)
    rt, rs = rcamp.tally_interval(rkeys)
    np.testing.assert_array_equal(tally, rt)
    if stratify:
        np.testing.assert_array_equal(strata, rs)
    assert (esc, tt) == (rk.escapes, rk.taint_trials)


def test_interval_refused_where_it_cannot_apply(window):
    _, mk = _kernels(window)
    camp = ShardedCampaign(mk, None, "fu", resolution="host")
    assert not camp.supports_intervals
    with pytest.raises(ValueError, match="sync-interval"):
        camp.dispatch_interval([_keys(1, 32)[1]])
    with pytest.raises(ValueError, match="until-CI"):
        camp.dispatch_until_ci([_keys(1, 32)[1]], np.zeros(4), None, 0,
                               0, 0.1, 0.95, False)


def _serial_stop(camp, keys, tallies0, strata0, target, min_trials,
                 strat_rule):
    """The serial loop's consumed count and final cumulative state."""
    cum = np.asarray(tallies0, np.int64).copy()
    cs = None if strata0 is None else np.asarray(strata0, np.int64).copy()
    for i, k in enumerate(keys):
        if camp.stratify:
            th = camp.tally_batch_stratified(k).numpy().astype(np.int64)
            cs = th if cs is None else cs + th
            cum += th.sum(0)
        else:
            cum += camp.tally_batch(k).numpy()
        trials = int(cum.sum())
        if strat_rule:
            stop = RS.should_stop_stratified(RS.pairs_from_strata(cs),
                                             target, 0.95, min_trials)
        else:
            stop = RS.should_stop(int(cum[C.OUTCOME_SDC]
                                      + cum[C.OUTCOME_DUE]), trials,
                                  target, 0.95, min_trials)
        if stop:
            return i + 1, cum, cs
    return len(keys), cum, cs


@pytest.mark.parametrize("cfg,stratify", _PATHS, ids=_IDS)
@pytest.mark.parametrize("target", [0.12, 0.06, 0.001])
def test_until_ci_consumes_the_serial_count(window, mesh, cfg, stratify,
                                            target):
    """A resumed start (one batch already counted), the device-side rule
    at per-batch cadence: the consumed count, the tallies and the strata
    are the serial loop's; the half-width trajectory is the reference's
    float32 one; the budget runs out at target 0.001."""
    rk, mk = _kernels(window, **cfg)
    rkeys, keys = _batches(100, 6, 64)
    _, mk0 = _kernels(window, **cfg)
    first = ShardedCampaign(mk0, None, "fu", stratify=stratify)
    if stratify:
        s0 = first.tally_batch_stratified(keys[0]).numpy().astype(np.int64)
        t0 = s0.sum(0)
    else:
        s0, t0 = None, first.tally_batch(keys[0]).numpy().astype(np.int64)
    strat_rule = stratify
    camp = ShardedCampaign(mk, None, "fu", stratify=stratify)
    h = camp.dispatch_until_ci(keys[1:], t0, s0, 64, 128, target, 0.95,
                               strat_rule)
    tally, strata, consumed, hw = camp.materialize_until_ci(h)
    _, mk2 = _kernels(window, **cfg)
    n, cum, cs = _serial_stop(
        ShardedCampaign(mk2, None, "fu", stratify=stratify), keys[1:], t0,
        s0, target, 128, strat_rule)
    assert consumed == n == len(hw)
    np.testing.assert_array_equal(t0 + tally, cum)
    if stratify:
        np.testing.assert_array_equal(s0 + strata, cs)
    assert (mk.escapes, mk.taint_trials) == (mk2.escapes, mk2.taint_trials)
    if target == 0.001:
        assert consumed == 5
    rcamp = RefCampaign(rk, mesh, "fu", stratify=stratify)
    rh = rcamp.dispatch_until_ci(rkeys[1:], t0, s0, 64, 128, target, 0.95,
                                 strat_rule)
    rt, rs, rc, rhw = rcamp.materialize_until_ci(rh)
    assert rc == consumed
    np.testing.assert_array_equal(rt, tally)
    assert hw.dtype == np.float32
    np.testing.assert_array_equal(hw, rhw)


def test_perf_stats_fields_match_reference():
    p, r = PL.PerfStats(), RPL.PerfStats()
    assert p.to_dict() == r.to_dict()
    for s in (p, r):
        s.device_step_seconds, s.device_wait_seconds = 2.0, 0.5
        s.super_intervals, s.hw_trajectory_final = 3, 0.0123456789
    assert p.to_dict() == r.to_dict()
    assert p.overlap_fraction() == 0.75
    assert PL.PipelineConfig().to_dict() == RPL.PipelineConfig().to_dict()


def test_engines_count_intervals_and_round_trips(window):
    """The pipelined engine believes whole intervals; the until-CI engine
    counts one super-interval and the port's own copies (here: six
    consumed batches against two copies and the stop flags read from the
    min_trials gate on)."""
    from shrewd_tpu_torch import integrity as I
    from shrewd_tpu_torch import resilience as R
    from shrewd_tpu_torch.utils import prng

    _, mk = _kernels(window)
    camp = ShardedCampaign(mk, None, "fu", integrity_check=True)
    mon = I.IntegrityMonitor(I.IntegrityConfig(audit_rate=0.0))
    sk = prng.structure_key(prng.simpoint_key(prng.campaign_key(0, "cpu"),
                                              0), 1)
    checked = I.checked_dispatcher_for(
        R.dispatcher_for_campaign(camp), camp, mon, "w0", "fu",
        structure_key=sk)
    perf = PL.PerfStats()
    eng = PL.PipelinedEngine(camp, checked, sk, 32, 8, sync_every=2,
                             depth=2, monitor=mon, perf=perf)
    doc = eng.obtain(0, 2)
    assert (doc["n_batches"], doc["tiers"], sum(doc["tally"])) == \
        (2, [0, 0], 64)
    assert (perf.intervals, perf.dispatches, perf.depth_hwm) == (1, 2, 2)
    ci = PL.UntilCIEngine(camp, checked, sk, 32, mon, min_trials=64,
                          target_halfwidth=1e-6, confidence=0.95,
                          perf=perf)
    doc = ci.obtain(2, 6, np.asarray(doc["tally"]), None, False)
    assert doc["n_batches"] == 6 and len(doc["hw_tail"]) == 6
    assert perf.super_intervals == 1 and perf.auto_sync_every == 6
    # six batches, each with its stop flag read, and ONE final copy (the
    # accumulators with the half-width trace)
    assert perf.host_roundtrips_saved == 6 - (6 + 1)
