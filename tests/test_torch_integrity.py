"""The port's result-integrity layer against the JAX package's, on the CPU.

The tally invariants must report the reference's messages on crafted
tallies; the canary battery and the differential audit must give the
reference's verdicts, trial counts and mismatch ledger on a small window;
and a tally corrupted inside the checked dispatcher must be quarantined
and recovered to the reference's tally with the reference's monitor
document.  The module fixture of ``test_torch_orchestrator.py`` provides
the reference's jax 0.9 aliases (R1, R4)."""

import numpy as np
import pytest

from shrewd_tpu import integrity as RI
from shrewd_tpu import resilience as RR
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import integrity as I
from shrewd_tpu_torch import resilience as R
from shrewd_tpu_torch.parallel import ShardedCampaign
from shrewd_tpu_torch.utils import prng
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# the module's R1/R4 fixture (autouse) and the one-device mesh
from test_torch_orchestrator import _reference_on_jax_09, mesh  # noqa: F401

_CRAFTED = [
    ([10, 2, 3, 1], 16, None),
    ([10, 2, 3, 1], 17, None),
    ([10, -2, 3, 1], 12, None),
    ([10.5, 2, 3, 0.5], 16, None),
    ([np.nan, 2, 3, 1], 6, None),
    ([4, 0, 0, 0], 4, [[1, 0, 0, 0], [3, 0, 0, 0]]),
    ([4, 0, 0, 0], 4, [[1, 0, 0, 0], [2, 0, 0, 0]]),
    ([4, 0, 0, 0], 4, [[-1, 0, 0, 0], [5, 0, 0, 0]]),
    ([4, 0, 0, 0], 4, [[np.inf, 0, 0, 0], [3, 0, 0, 0]]),
]


@pytest.mark.parametrize("tally,batch,strata", _CRAFTED)
def test_invariant_messages_match_reference(tally, batch, strata):
    assert I.tally_violations(tally, batch, strata) == \
        RI.tally_violations(tally, batch, strata)
    assert I.tally_violations(tally, batch, n_outcomes=3) == \
        RI.tally_violations(tally, batch, n_outcomes=3)


def test_monotone_and_shard_messages_match_reference():
    for prev, new in (([1, 2, 3, 4], [1, 2, 3, 5]), ([5, 2, 3, 4],
                                                     [4, 2, 3, 4])):
        assert I.monotone_violations(prev, new) == \
            RI.monotone_violations(prev, new)
    for local, total in (([[1, 2, 0, 0]], [1, 2, 0, 0]),
                         ([[1, 2, 0, 0]], [1, 3, 0, 0])):
        assert I.shard_sum_violations(local, total) == \
            RI.shard_sum_violations(local, total)


def _seed_keys(seed, n):
    rk = ref_prng.trial_keys(ref_prng.batch_key(ref_prng.structure_key(
        ref_prng.simpoint_key(ref_prng.campaign_key(seed), 0), 1),
        I.CANARY_BATCH_ID), n)
    mk = prng.trial_keys(prng.batch_key(prng.structure_key(
        prng.simpoint_key(prng.campaign_key(seed, "cpu"), 0), 1),
        I.CANARY_BATCH_ID), n)
    return rk, mk


@pytest.mark.parametrize("structure", ["regfile", "fu", "latch"])
def test_canary_battery_matches_reference(window, mesh, structure):
    rk, mk = _kernels(window)
    rseed, mseed = _seed_keys(3, 2)
    rcamp = RefCampaign(rk, mesh, structure)
    mcamp = ShardedCampaign(mk, None, structure)
    rb = RI.CanaryBattery(rcamp, structure, rseed)
    mb = I.CanaryBattery(mcamp, structure, mseed)
    np.testing.assert_array_equal(mb.seed_expected(), rb.seed_expected())
    want = rb.check(RR.TIER_DEVICE, RR._device_tier(rcamp))
    got = mb.check(R.TIER_DEVICE, R._device_tier(mcamp))
    assert got == want and got.ok and got.trials == 5
    # a tier that returns a wrong tally fails the seed canary alike
    def bad_tier(keys, stratified):
        return np.asarray([0, 0, 0, int(keys.shape[0])]), None
    assert mb.check(R.TIER_ORACLE, bad_tier) == \
        rb.check(RR.TIER_ORACLE, bad_tier)
    assert not mb.check(R.TIER_ORACLE, bad_tier).ok
    # the canaries leave the campaign's escape counters untouched
    assert (mk.escapes, mk.taint_trials) == (0, 0)


@pytest.mark.parametrize("alternate", ["oracle", "dense", "chunked"])
def test_audit_matches_reference(window, alternate):
    rk, mk = _kernels(window)
    rkeys, keys = _keys(61, 256)
    idx = np.sort(np.random.default_rng(4).choice(256, 40, replace=False))
    ra = RI.AuditOracle(rk, "fu", alternate)
    ma = I.AuditOracle(mk, "fu", alternate)
    assert ma.audit(keys, idx) == ra.audit(rkeys, idx) == []
    assert ma.audit(keys, idx[:0]) == []
    # a primary that disagrees: the same mismatch records and reasons
    for a, k in ((ra, rkeys), (ma, keys)):
        orig = a.kernel.run_batch_hybrid
        a.kernel.run_batch_hybrid = lambda f, o=orig: np.where(
            np.arange(len(o(f))) % 7 == 0, 3, o(f))
    assert ma.audit(keys, idx) == ra.audit(rkeys, idx)
    led, rled = I.MismatchLedger(), RI.MismatchLedger()
    led.record(40, ma.audit(keys, idx), {"batch_id": 0})
    rled.record(40, ra.audit(rkeys, idx), {"batch_id": 0})
    assert led.to_dict() == rled.to_dict() and led.mismatched > 0
    assert I.MismatchLedger.from_dict(led.to_dict()).to_dict() == \
        led.to_dict()


def _checked_pair(window, mesh, structure="fu", **icfg):
    rk, mk = _kernels(window)
    rcamp = RefCampaign(rk, mesh, structure, stratify=True,
                        integrity_check=True)
    mcamp = ShardedCampaign(mk, None, structure, stratify=True,
                            integrity_check=True)
    rmon = RI.IntegrityMonitor(RI.IntegrityConfig(**icfg))
    mmon = I.IntegrityMonitor(I.IntegrityConfig(**icfg))
    rsk = ref_prng.structure_key(ref_prng.simpoint_key(
        ref_prng.campaign_key(0), 0), 1)
    msk = prng.structure_key(prng.simpoint_key(
        prng.campaign_key(0, "cpu"), 0), 1)
    rcd = RI.checked_dispatcher_for(
        RR.dispatcher_for_campaign(rcamp, RR.ResilienceConfig(
            backoff_base=0.0)), rcamp, rmon, "w0", structure,
        structure_key=rsk)
    mcd = I.checked_dispatcher_for(
        R.dispatcher_for_campaign(mcamp, R.ResilienceConfig(
            backoff_base=0.0)), mcamp, mmon, "w0", structure,
        structure_key=msk)
    return rcd, mcd, rmon, mmon


@pytest.mark.parametrize("times", [0, 1, 2])
def test_corrupted_tally_is_quarantined_and_recovered(window, mesh, times):
    """``times`` corrupted dispatches: each quarantines the batch and
    re-dispatches it down the ladder (device → oracle here); the believed
    tally, tier and the monitor's document are the reference's."""
    rcd, mcd, rmon, mmon = _checked_pair(window, mesh)
    for mon in (rmon, mmon):
        mon.arm_corruption(lambda t: t + np.asarray([1, 0, 0, 0]),
                           times=times)
    for b in range(2):
        rkeys, keys = _keys(70 + b, 96)
        want = rcd.tally_batch(rkeys, stratified=True, batch_id=b)
        got = mcd.tally_batch(keys, stratified=True, batch_id=b)
        np.testing.assert_array_equal(got.tally, want.tally)
        np.testing.assert_array_equal(got.strata, want.strata)
        assert (got.tier, got.attempts) == (want.tier, want.attempts)
    assert mmon.to_dict() == rmon.to_dict()
    assert mmon.take_events() == rmon.take_events()
    assert (mmon.quarantined, mmon.recovered) == (times, min(times, 1))
    assert mcd.campaign.shard_checks == rcd.campaign.shard_checks > 0
    assert I.IntegrityMonitor.from_dict(mmon.to_dict()).to_dict() == \
        mmon.to_dict()


def test_unrecoverable_corruption_raises(window, mesh):
    rcd, mcd, rmon, mmon = _checked_pair(window, mesh, max_requeue=1)
    for mon in (rmon, mmon):
        mon.arm_corruption(lambda t: t * 2, times=5)
    rkeys, keys = _keys(80, 64)
    with pytest.raises(RI.IntegrityError):
        rcd.tally_batch(rkeys, batch_id=3)
    with pytest.raises(I.IntegrityError, match="every re-dispatch"):
        mcd.tally_batch(keys, batch_id=3)
    assert mmon.to_dict() == rmon.to_dict()
