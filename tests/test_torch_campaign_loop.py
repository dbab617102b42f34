"""The port's one-device campaign step and run-until-CI loop against the
JAX package's, on the CPU.

Every ``tally_batch`` route of ``ShardedCampaign`` (the budgeted device
resolution, the host resolution, dense, taint, stratified and the chunked
route) against the reference's on a one-device mesh, and ``run_until_ci``
fresh and resumed, must give the reference's integers bit for bit and its
host-computed float64 intervals exactly.  The reference's ``TrialKernel``
calls ``jax.core.trace_state_clean``, which jax 0.9 moved to
``jax._src.core``; the fixture of ``test_torch_campaign.py`` provides the
alias for this file's tests only.
"""

import numpy as np
import pytest
import torch

from shrewd_tpu.ops import chunked as RC
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import run_until_ci as ref_run_until_ci
from shrewd_tpu_torch.ops import chunked as PC
from shrewd_tpu_torch.parallel import ShardedCampaign, run_until_ci
# the module's R1 alias fixture (autouse) and the two-package helpers
from test_torch_campaign import (_kernels, _keys,  # noqa: F401
                                 _trace_state_alias, mesh, window)


# --- the campaign step -----------------------------------------------------

def _pair(window, mesh, structure, ref_kw=None, **kw):
    rk, mk = _kernels(window, **(ref_kw or {}))
    return (rk, mk, RefCampaign(rk, mesh, structure, **kw),
            ShardedCampaign(mk, None, structure, **kw))


@pytest.mark.parametrize("cfg,structure,kw", [
    ({}, "fu", {}),
    ({"escape_budget": 8}, "lsq", {"stratify": True}),
    ({}, "iq", {"resolution": "host"}),
    ({"replay_kernel": "taint"}, "fu", {"resolution": "host"}),
    ({"replay_kernel": "taint"}, "rob", {}),
    ({"replay_kernel": "dense"}, "latch", {"stratify": True}),
], ids=["device", "device-over-budget-stratified", "host-hybrid",
        "host-taint", "device-taint", "dense-stratified"])
def test_tally_batch_routes_match_reference(window, mesh, cfg, structure,
                                            kw):
    rk, mk, rc, pc = _pair(window, mesh, structure, cfg, **kw)
    for seed in (41, 42):
        rkeys, keys = _keys(seed, 192)
        got = pc.tally_batch(keys)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(rc.tally_batch(rkeys)))
        if kw.get("stratify"):
            got_h = pc.tally_batch_stratified(keys)
            np.testing.assert_array_equal(
                got_h.numpy(), np.asarray(rc.tally_batch_stratified(rkeys)))
            np.testing.assert_array_equal(got_h.numpy().sum(0), got.numpy())
        assert (mk.escapes, mk.taint_trials) == (rk.escapes,
                                                 rk.taint_trials)


@pytest.mark.parametrize("structure", ["fu"])
def test_chunked_route_matches_reference(window, mesh, structure):
    rk, mk = _kernels(window)
    rch = RC.ChunkedCampaign(rk, chunk=160)
    pch = PC.ChunkedCampaign(mk, chunk=160)
    rc = RefCampaign(rk, mesh, structure, stratify=True, chunked=rch)
    pc = ShardedCampaign(mk, None, structure, stratify=True, chunked=pch)
    rkeys, keys = _keys(43, 64)
    np.testing.assert_array_equal(pc.tally_batch(keys).numpy(),
                                  np.asarray(rc.tally_batch(rkeys)))
    np.testing.assert_array_equal(
        pc.tally_batch_stratified(keys).numpy(),
        np.asarray(rc.tally_batch_stratified(rkeys)))
    assert pch.last_stats == rch.last_stats
    # the chunked route's outcomes are the dense protocol's
    np.testing.assert_array_equal(
        pc.tally_batch(keys).numpy(),
        np.bincount(mk.outcomes_from_keys(keys, structure).numpy(),
                    minlength=4))


def test_campaign_refuses_what_a_later_slice_brings(window):
    """A mesh still waits for the multi-GPU slice; the watchdog, the
    integrity check and the dispatcher came with the orchestrator's
    slice and are held here as working."""
    from shrewd_tpu_torch import resilience as R

    _, mk = _kernels(window)
    with pytest.raises(NotImplementedError, match="mesh"):
        ShardedCampaign(mk, object(), "fu")
    with pytest.raises(ValueError, match="resolution='device'"):
        ShardedCampaign(mk, None, "fu", resolution="host", stratify=True)
    with pytest.raises(ValueError, match="stratify=True"):
        ShardedCampaign(mk, None, "fu").tally_batch_stratified(
            _keys(1, 8)[1])
    keys = _keys(1, 64)[1]
    plain = ShardedCampaign(mk, None, "fu").tally_batch(keys)
    checked = ShardedCampaign(mk, None, "fu", integrity_check=True,
                              watchdog=R.DeviceWatchdog(timeout=60.0))
    assert torch.equal(checked.tally_batch(keys), plain)
    assert checked.shard_checks == 1 and checked.watchdog.dispatches == 1
    camp = ShardedCampaign(mk, None, "fu")
    kw = dict(seed=0, simpoint_id=0, structure_id=1, batch_size=64,
              max_trials=128)
    got = run_until_ci(camp, dispatcher=R.dispatcher_for_campaign(camp),
                       **kw)
    want = run_until_ci(camp, **kw)
    np.testing.assert_array_equal(got.tallies, want.tallies)
    assert got.tier_trials.tolist() == [128, 0, 0]
    assert got.escalation_rate == 0.0


# --- run_until_ci ----------------------------------------------------------

_CI = dict(seed=3, simpoint_id=2, batch_size=128, min_trials=256)


def _same_result(got, want):
    assert got.structure == want.structure
    np.testing.assert_array_equal(got.tallies, want.tallies)
    assert got.tallies.dtype == np.int64
    assert (got.trials, got.batches, got.converged) == (
        want.trials, want.batches, want.converged)
    assert got.avf == want.avf
    assert tuple(got.avf_interval) == tuple(want.avf_interval)
    assert tuple(got.sdc_interval) == tuple(want.sdc_interval)
    if want.strata_tallies is None:
        assert got.strata_tallies is None
    else:
        np.testing.assert_array_equal(got.strata_tallies,
                                      want.strata_tallies)
    assert (got.tier_trials, got.escalation_rate) == (
        want.tier_trials, want.escalation_rate)


@pytest.mark.parametrize("structure,sid,stratify,target", [
    ("rob", 2, True, 0.018), ("fu", 1, False, 0.03)])
def test_run_until_ci_fresh_and_resumed_match_reference(
        window, mesh, structure, sid, stratify, target):
    rk, mk, rc, pc = _pair(window, mesh, structure, stratify=stratify)
    ci = dict(_CI, target_halfwidth=target)
    want = ref_run_until_ci(rc, structure_id=sid, **ci)
    got = run_until_ci(pc, structure_id=sid, **ci)
    _same_result(got, want)
    assert got.converged and got.batches >= 3
    # resume after two batches, with the strata (a stratified campaign)
    part = run_until_ci(pc, structure_id=sid, max_trials=256, **ci)
    assert part.batches == 2 and not part.converged
    resumed = run_until_ci(
        pc, structure_id=sid, start_batch=2, initial_tallies=part.tallies,
        initial_strata=part.strata_tallies, **ci)
    want_r = ref_run_until_ci(
        rc, structure_id=sid, start_batch=2, initial_tallies=part.tallies,
        initial_strata=part.strata_tallies, **ci)
    _same_result(resumed, want_r)
    np.testing.assert_array_equal(resumed.tallies, got.tallies)
    assert resumed.batches == got.batches - 2
    if stratify:
        # resumed without its strata: the pooled interval over everything
        pooled = run_until_ci(pc, structure_id=sid, start_batch=2,
                              initial_tallies=part.tallies, **ci)
        _same_result(pooled, ref_run_until_ci(
            rc, structure_id=sid, start_batch=2,
            initial_tallies=part.tallies, **ci))


