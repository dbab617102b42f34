"""The port's sharded interval and until-CI steps, ``run_until_ci`` and the
shard-vs-sum check on 2- and 4-shard meshes, against the JAX package's on
the CPU (the per-batch routes are in ``test_torch_mesh.py``).

The reference runs on ``make_mesh(jax.devices()[:n])``, the port on
``make_mesh(["cpu"] * n)``; the escape budget of 1 is exceeded in every
shard, so the per-shard budget shows in the tallies.  The module fixture of
``test_torch_orchestrator.py`` works around the reference's faults R1 and
R4 under jax 0.9.
"""

import numpy as np
import pytest
import torch

from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import run_until_ci as ref_run_until_ci
from shrewd_tpu_torch import integrity as integ
from shrewd_tpu_torch.parallel import ShardedCampaign, run_until_ci
from shrewd_tpu_torch.parallel import mesh as M
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
from test_torch_mesh import _meshes
# R1 and R4 for the reference (autouse, module scope)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401


@pytest.mark.parametrize("n,stratify", [(2, False), (4, True)],
                         ids=["pooled-2", "stratified-4"])
def test_interval_and_until_ci_match_reference(window, n, stratify):
    rmesh, pmesh = _meshes(n)
    rk, mk = _kernels(window, escape_budget=1)
    rc = RefCampaign(rk, rmesh, "fu", stratify=stratify,
                     integrity_check=True)
    pc = ShardedCampaign(mk, pmesh, "fu", stratify=stratify,
                         integrity_check=True)
    assert pc.supports_intervals
    pairs = [_keys(60 + i, 64) for i in range(3)]
    rkeys, keys = [p[0] for p in pairs], [p[1] for p in pairs]
    t, s = pc.tally_interval(keys)
    rt, rs = rc.tally_interval(rkeys)
    np.testing.assert_array_equal(t, rt)
    if stratify:
        np.testing.assert_array_equal(s, rs)
    args = (np.zeros(4, np.int64), None, 0, 64, 0.2, 0.95, stratify)
    got = pc.materialize_until_ci(pc.dispatch_until_ci(keys, *args))
    want = rc.materialize_until_ci(rc.dispatch_until_ci(rkeys, *args))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[3], want[3], rtol=2 ** -22)
    assert (mk.escapes, mk.taint_trials) == (rk.escapes, rk.taint_trials)
    assert pc.shard_checks == rc.shard_checks == 2


@pytest.mark.parametrize("n", [2, 4])
def test_run_until_ci_matches_reference(window, n):
    rmesh, pmesh = _meshes(n)
    rk, mk = _kernels(window, escape_budget=4)
    kw = dict(seed=3, simpoint_id=1, structure_id=2, batch_size=64,
              target_halfwidth=0.05, min_trials=128, max_trials=640)
    got = run_until_ci(ShardedCampaign(mk, pmesh, "fu", stratify=True),
                       **kw)
    want = ref_run_until_ci(RefCampaign(rk, rmesh, "fu", stratify=True),
                            **kw)
    np.testing.assert_array_equal(got.tallies, want.tallies)
    np.testing.assert_array_equal(got.strata_tallies, want.strata_tallies)
    assert (got.trials, got.batches, got.converged) == (
        want.trials, want.batches, want.converged)
    assert tuple(got.avf_interval) == tuple(want.avf_interval)


def test_corrupted_local_is_caught_by_the_shard_check(window):
    """A shard's local tally that no longer sums to the reduced tally (a
    corrupted collective) raises ``IntegrityError`` and counts a
    mismatch, on the batch step and on the interval step."""
    _, mk = _kernels(window)
    camp = ShardedCampaign(mk, M.make_mesh(["cpu"] * 4), "fu",
                           integrity_check=True)
    _, keys = _keys(70, 64)
    clean = camp.tally_batch(keys)
    real = camp._gather_locals

    def corrupt(local):
        out = real(local).copy()
        out[2, 0] += 1
        return out

    camp._gather_locals = corrupt
    with pytest.raises(integ.IntegrityError, match="shard tallies sum"):
        camp.tally_batch(keys)
    assert (camp.shard_checks, camp.shard_mismatches) == (2, 1)
    # the interval step checks each shard's own accumulator
    h = camp.dispatch_interval([keys, keys])
    h.locals[1][0] += 1
    with pytest.raises(integ.IntegrityError, match="shard tallies sum"):
        camp.materialize_interval(h)
    assert camp.shard_mismatches == 2
    camp._gather_locals = real
    assert torch.equal(camp.tally_batch(keys), clean)
