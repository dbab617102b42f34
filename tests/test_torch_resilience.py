"""The port's resilience layer against the JAX package's, on the CPU.

The degradation ladder over a campaign whose device tier fails k times
must give the reference's ``DispatchResult`` (tally, strata, tier,
attempts), retry and descent counts and ``EscalationBudget`` document;
the watchdog must time out a wedged call in bounded time, in both its
modes; the crash-safe document helpers must write the reference's bytes;
the oracle tier must give the device tier's tallies on the same keys;
and a campaign on the card must get the device tier alone.  The module fixture of ``test_torch_orchestrator.py`` provides
the reference's jax 0.9 aliases (R1, R4)."""

import json
import time

import numpy as np
import pytest
import torch

from shrewd_tpu import resilience as RR
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu_torch import resilience as R
from shrewd_tpu_torch.parallel import ShardedCampaign
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# the module's R1/R4 fixture (autouse) and the one-device mesh
from test_torch_orchestrator import _reference_on_jax_09, mesh  # noqa: F401


def _failing(camp, k, exc):
    """Make ``camp``'s batch step raise ``exc`` on its first ``k`` calls."""
    calls = [0]
    orig, orig_s = camp.tally_batch, camp.tally_batch_stratified

    def wrap(f):
        def g(keys):
            calls[0] += 1
            if calls[0] <= k:
                raise exc("device lost")
            return f(keys)
        return g
    camp.tally_batch = wrap(orig)
    camp.tally_batch_stratified = wrap(orig_s)
    return camp


@pytest.mark.parametrize("k", [0, 1, 3, 5])
@pytest.mark.parametrize("stratified", [False, True])
def test_ladder_matches_reference(window, mesh, k, stratified):
    """max_retries=2: k < 3 failures are retried on the device tier,
    k ≥ 3 descend (the CPU tier is skipped on a CPU campaign in both
    packages) to the oracle tier."""
    rk, mk = _kernels(window)
    cfg = dict(max_retries=2, backoff_base=0.0, backoff_jitter=0.0)
    rd = RR.dispatcher_for_campaign(
        _failing(RefCampaign(rk, mesh, "fu", stratify=True), k,
                 RuntimeError), RR.ResilienceConfig(**cfg))
    md = R.dispatcher_for_campaign(
        _failing(ShardedCampaign(mk, None, "fu", stratify=True), k,
                 RuntimeError), R.ResilienceConfig(**cfg))
    assert [t for t, _ in md.tiers] == [t for t, _ in rd.tiers] == \
        [R.TIER_DEVICE, R.TIER_ORACLE]
    rb, mb = RR.EscalationBudget(), R.EscalationBudget()
    for seed in (51, 52):
        rkeys, keys = _keys(seed, 96)
        want = rd.tally_batch(rkeys, stratified=stratified)
        got = md.tally_batch(keys, stratified=stratified)
        np.testing.assert_array_equal(got.tally, want.tally)
        assert got.tally.dtype == np.int64
        if stratified:
            np.testing.assert_array_equal(got.strata, want.strata)
        else:
            assert got.strata is None and want.strata is None
        assert (got.tier, got.attempts) == (want.tier, want.attempts)
        rb.record(want.tier, 96)
        mb.record(got.tier, 96)
    assert (md.retries, md.degradations) == (rd.retries, rd.degradations)
    assert mb.to_dict() == rb.to_dict()
    assert mb.over(0.05) == rb.over(0.05)


def test_ladder_exhausted_and_sub_ladder(window):
    _, mk = _kernels(window)
    cfg = R.ResilienceConfig(max_retries=0, backoff_base=0.0,
                             allow_oracle=False)
    camp = _failing(ShardedCampaign(mk, None, "fu"), 10, RuntimeError)
    d = R.dispatcher_for_campaign(camp, cfg)
    assert d.sub_ladder(below=R.TIER_DEVICE) is None
    _, keys = _keys(53, 32)
    with pytest.raises(R.LadderExhausted, match="device tier failed"):
        d.tally_batch(keys)


@pytest.mark.parametrize("mode", ["call", "call_armed"])
def test_watchdog_times_out(mode):
    wd = R.DeviceWatchdog(timeout=0.05, name="t")
    t0 = time.monotonic()
    with pytest.raises(R.DispatchTimeout, match="exceeded"):
        if mode == "call":
            wd.call(time.sleep, 2.0)
        else:
            wd.call_armed(lambda: time.sleep(2.0), wd.arm())
    assert time.monotonic() - t0 < 1.5
    assert (wd.timeouts, wd.healthy) == (1, False)
    assert wd.call(lambda: 7) == 7 and wd.healthy
    assert wd.leaked_threads <= 1
    # timeout 0 is a direct call
    assert R.DeviceWatchdog(0.0).call(lambda x: x + 1, 1) == 2


def test_watchdog_matches_reference_accounting():
    for mod in (R, RR):
        wd = mod.DeviceWatchdog(timeout=0.0)
        wd.call(lambda: None)
        assert wd.dispatches == 1 and wd.timeouts == 0
    pol, rpol = (R.BackoffPolicy(0.05, 5.0, 0.25, seed=3),
                 RR.BackoffPolicy(0.05, 5.0, 0.25, seed=3))
    assert [pol.delay(a) for a in range(6)] == \
        [rpol.delay(a) for a in range(6)]


def test_campaign_watchdog_counts_collective_timeouts(window):
    _, mk = _kernels(window)
    wd = R.DeviceWatchdog(timeout=0.01)
    camp = ShardedCampaign(mk, None, "fu", watchdog=wd)
    slow = mk.tally_on_device

    def wedged(*a, **k):
        time.sleep(0.5)
        return slow(*a, **k)
    mk.tally_on_device = wedged
    esc0 = mk.escapes
    _, keys = _keys(54, 32)
    with pytest.raises(R.DispatchTimeout):
        camp.tally_batch(keys)
    # the step raised before any host counter moved
    assert camp.collective_timeouts == 1 and mk.escapes == esc0


def test_document_helpers_write_the_reference_bytes(tmp_path):
    doc = {"version": 5, "plan": {"b": [1, 2], "a": None},
           "state": {"w0": {"regfile": {"tallies": [1, 2, 3, 0]}}},
           "x": 0.25}
    doc["checksum"] = RR.doc_checksum(doc)
    assert R.doc_checksum(doc) == doc["checksum"]
    R.write_json_atomic(str(tmp_path / "mine.json"), doc)
    RR.write_json_atomic(str(tmp_path / "ref.json"), doc)
    assert (tmp_path / "mine.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert R.load_json_verified(str(tmp_path / "ref.json")) == doc
    bad = dict(doc, x=0.5)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="checksum mismatch"):
        R.load_json_verified(str(tmp_path / "bad.json"))
    (tmp_path / "torn.json").write_text('{"version": 5, "pl')
    with pytest.raises(ValueError, match="truncated"):
        R.load_json_verified(str(tmp_path / "torn.json"))


@pytest.mark.parametrize("structure", ["regfile", "fu", "latch"])
def test_cpu_and_oracle_tiers_equal_the_device_tier(window, mesh,
                                                    structure):
    """Each tier on its own: the reference's CPU tier (its campaign on a
    CPU mesh), the port's device tier on a CPU campaign and the port's
    oracle tier (the C++ golden kernel) give the same tally and strata
    as the reference's device tier.  The port has no CPU tier of its own
    (module docstring of ``resilience``)."""
    rk, mk = _kernels(window)
    camp = ShardedCampaign(mk, None, structure, stratify=True)
    rcamp = RefCampaign(rk, mesh, structure, stratify=True)
    rkeys, keys = _keys(55, 128)
    want = RR._device_tier(rcamp)(rkeys, True)
    ref_cpu = RR._cpu_tier(rcamp)(rkeys, True)
    dev = R._device_tier(camp)(keys, True)
    oracle = R._oracle_tier(camp)(keys, True)
    for got in (ref_cpu, dev, oracle):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert R.oracle_available(camp)
    assert not hasattr(R, "_cpu_tier")


class _CardCampaign:
    """A campaign whose kernel claims the card and whose step fails as a
    kernel that does not launch would: the ladder's construction and
    failure path without a card."""

    class kernel:
        device = torch.device("cuda")
        trace = shadow_cov = sampler = object()
        memmap = None

    watchdog = None
    calls = 0

    def tally_batch(self, keys):
        self.calls += 1
        raise RuntimeError("CUDA error: the launch failed")

    tally_batch_stratified = tally_batch


@pytest.mark.parametrize("stratified", [False, True])
def test_card_ladder_has_the_device_tier_alone(stratified):
    """A campaign on the card gets no fallback tier, whatever the config
    allows, and a failing launch raises out of the dispatch as it is,
    once, with no retry and no descent."""
    camp = _CardCampaign()
    d = R.dispatcher_for_campaign(camp, R.ResilienceConfig(
        max_retries=3, backoff_base=0.0, allow_cpu=True, allow_oracle=True))
    assert [t for t, _ in d.tiers] == [R.TIER_DEVICE]
    assert d.sub_ladder(below=R.TIER_DEVICE) is None
    with pytest.raises(RuntimeError, match="launch failed"):
        d.tally_batch(np.zeros((4, 2), np.uint32), stratified=stratified)
    assert (camp.calls, d.retries, d.degradations) == (1, 0, 0)


def test_card_ladder_retries_a_timeout_on_the_card_only():
    """A deadline on the card (a ``BackendError``) is retried on the
    device tier and then exhausts the ladder: it never descends."""
    camp = _CardCampaign()

    def wedged(keys):
        camp.calls += 1
        raise R.DispatchTimeout("device dispatch exceeded 1.0s")
    camp.tally_batch = wedged
    d = R.dispatcher_for_campaign(camp, R.ResilienceConfig(
        max_retries=2, backoff_base=0.0))
    with pytest.raises(R.LadderExhausted, match="exceeded"):
        d.tally_batch(np.zeros((4, 2), np.uint32))
    assert (camp.calls, d.retries, d.degradations) == (3, 2, 0)
