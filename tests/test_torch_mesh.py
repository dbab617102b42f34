"""The port's device mesh and sharded campaign step against the JAX
package's, on the CPU.

``make_mesh(["cpu"] * n)`` lists the CPU n times (n shards on one device),
the counterpart of the reference's forced host-platform device count; the
reference runs on ``make_mesh(jax.devices()[:n])`` for n = 1, 2 and 4.
Every per-batch route of ``ShardedCampaign`` (dense, stratified, the
budgeted device route with an escape budget that each shard's escapes
exceed, the host route) must give the reference's integers and counters
bit for bit on the same mesh size (the interval and until-CI steps,
``run_until_ci`` and a corrupted local are in ``test_torch_mesh_steps.py``).  The module fixture of ``test_torch_orchestrator.py`` works
around the reference's faults R1 and R4 under jax 0.9.
"""

import jax
import numpy as np
import pytest
import torch

from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu.parallel.mesh import round_up_to_mesh as ref_round_up
from shrewd_tpu_torch.parallel import ShardedCampaign
from shrewd_tpu_torch.parallel import mesh as M
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# R1 and R4 for the reference (autouse, module scope)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401

SIZES = [1, 2, 4]


def _meshes(n):
    return ref_make_mesh(jax.devices()[:n]), M.make_mesh(["cpu"] * n)


# --- the mesh helpers -------------------------------------------------------

@pytest.mark.parametrize("n,size", [(30, 4), (32, 4), (1, 8), (4096, 1),
                                    (100, 3)])
def test_round_up_to_mesh_matches_reference(n, size):
    assert M.round_up_to_mesh(n, size) == ref_round_up(n, size)
    with pytest.raises(ValueError, match="positive"):
        M.round_up_to_mesh(n, 0)


def test_shard_keys_rows_and_refusals():
    mesh = M.make_mesh(["cpu"] * 4)
    assert (mesh.size, mesh.local_size, mesh.world_size, mesh.offset,
            mesh.backend) == (4, 4, 1, 0, None)
    _, keys = _keys(3, 32)
    shards = M.shard_keys(mesh, keys)
    assert [s.shape[0] for s in shards] == [8] * 4
    assert torch.equal(torch.cat(shards), keys)
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        M.shard_keys(mesh, keys[:30])
    stack = M.shard_batch_stack(mesh, [keys, keys.flip(0)])
    assert len(stack) == 4 and torch.equal(stack[1][1], keys.flip(0)[8:16])
    assert [r.device.type for r in M.replicated(mesh, [1, 2])] == ["cpu"] * 4
    # the CPU may repeat; a CUDA mesh lists distinct cards
    with pytest.raises(ValueError, match="distinct cards"):
        M.make_mesh(["cuda:0", "cuda:0"])
    # a multi-process world is refused by the single-process helpers
    with pytest.raises(ValueError, match="single-process"):
        M.shard_batch_stack(M.Mesh(["cpu"], world_size=2), [keys])
    # its rows are rank-major: process 1 of 2 takes the second half
    far = M.Mesh(["cpu"] * 2, backend="gloo", world_size=2, rank=1)
    assert torch.equal(torch.cat(M.shard_keys(far, keys)), keys[16:])


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        assert M.make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.make_mesh()
    M.init_distributed("localhost:1", 1, 0)     # one process: a no-op
    assert M.make_mesh(["cpu"]).backend is None


# --- the campaign step, per route, at 1, 2 and 4 shards ---------------------

_ROUTES = {
    # (config, structure, campaign kw)
    "dense": ({"replay_kernel": "dense"}, "rob", {}),
    "stratified": ({}, "lsq", {"stratify": True}),
    "budgeted": ({"escape_budget": 1}, "fu", {}),
    "host": ({}, "iq", {"resolution": "host"}),
}


@pytest.mark.parametrize("route,n", [
    (r, n) for r in sorted(_ROUTES) for n in SIZES
    # the budgeted route at 1 and 4 shards is in the per-shard budget test
    if r == "stratified" or n == 2 or (n == 4 and r != "budgeted")])
def test_tally_batch_matches_reference_per_mesh_size(window, route, n):
    cfg, structure, kw = _ROUTES[route]
    rmesh, pmesh = _meshes(n)
    rk, mk = _kernels(window, **cfg)
    rc = RefCampaign(rk, rmesh, structure, integrity_check=True, **kw)
    pc = ShardedCampaign(mk, pmesh, structure, integrity_check=True, **kw)
    assert len(pc.kernels) == n and all(k is mk for k in pc.kernels)
    rkeys, keys = _keys(51, 128)
    got = pc.tally_batch(keys)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rc.tally_batch(rkeys)))
    if kw.get("stratify"):
        np.testing.assert_array_equal(
            pc.tally_batch_stratified(keys).numpy(),
            np.asarray(rc.tally_batch_stratified(rkeys)))
    assert (mk.escapes, mk.taint_trials) == (rk.escapes, rk.taint_trials)
    # one check per device step; the host route has none, in either
    # package
    steps = 0 if route == "host" else 1 + bool(kw.get("stratify"))
    assert pc.shard_checks == rc.shard_checks == steps
    assert pc.shard_mismatches == rc.shard_mismatches == 0


def test_escape_budget_applies_per_shard(window):
    """A budget the escapes of every shard exceed: each shard resolves its
    own ``escape_budget`` lanes, so 4 shards resolve 4x the lanes of one
    and the tallies differ — in both packages alike."""
    _, mk0 = _kernels(window, escape_budget=1)
    _, keys = _keys(51, 128)
    for s in M.shard_keys(M.make_mesh(["cpu"] * 4), keys):
        res = mk0.taint_fast(mk0.sample_batch(s, "fu"), may_latch=False)
        assert int((res.escaped | res.overflow).sum()) > 1
    got = {}
    for n in (1, 4):
        rmesh, pmesh = _meshes(n)
        rk, mk = _kernels(window, escape_budget=1)
        rkeys, keys = _keys(51, 128)
        got[n] = ShardedCampaign(mk, pmesh, "fu").tally_batch(keys).numpy()
        np.testing.assert_array_equal(
            got[n], np.asarray(RefCampaign(rk, rmesh, "fu")
                               .tally_batch(rkeys)))
    assert not np.array_equal(got[1], got[4])
    assert got[4][1] < got[1][1]       # fewer lanes left as SDC
