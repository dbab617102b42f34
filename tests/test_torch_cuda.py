"""Card tests of the port's Hopper kernels (``ops/taint_cuda.py``): the
fast pass (K1) and the chunk kernel (K2) with the chunked path around it.

Each test needs a CUDA card and skips without one.  They import torch and
the port only (no JAX), so on a machine with the card run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax).  Each kernel is held
bitwise against its plain PyTorch version on the same device tensors.
"""

import numpy as np
import pytest
import torch

from shrewd_tpu_torch import compat, native
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops import taint_cuda
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
from shrewd_tpu_torch.ops.taint import (setup_gather, taint_chunk,
                                        taint_fast_plain)
from shrewd_tpu_torch.ops.taint_cuda import taint_chunk_cuda, taint_fast_cuda
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def kernel(cuda):
    t = native.generate_trace(seed=5, n=512, nphys=64, mem_words=1024,
                              working_set_words=256)
    return TrialKernel(t, O3Config(shadow_coverage=[0.5] * 7), device=cuda)


def _mixed(kernel, n_lanes, seed):
    t = kernel.trace
    rng = np.random.default_rng(seed)
    kind = rng.integers(1, 10, n_lanes)
    return compat.fault_from_arrays(
        kind, rng.integers(0, t.n, n_lanes),
        np.where(kind == 1, rng.integers(0, t.nphys, n_lanes),
                 rng.integers(0, t.n, n_lanes)),
        rng.integers(0, 32, n_lanes), rng.random(n_lanes, dtype=np.float32),
        kernel.device)


def _both(kernel, faults, k, may_latch):
    setup = kernel._setup_batch(faults)
    args = (kernel.golden_rec, kernel.tr, kernel.shadow_cov, faults, *setup)
    kw = dict(k=k, compare_regs=kernel.cfg.compare_regs, may_latch=may_latch)
    got = taint_fast_cuda(*args, **kw)
    torch.cuda.synchronize()
    return got, taint_fast_plain(*args, **kw)


def _assert_equal(got, ref):
    for field in ("outcome", "escaped", "overflow", "tags", "vals", "steps"):
        a, b = getattr(got, field), getattr(ref, field)
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), field


def test_kernel_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert taint_cuda.build(verbose=True).exists()


def test_kernel_matches_plain_on_regfile(kernel):
    keys = prng.trial_keys(prng.campaign_key(0), 4096)
    got, ref = _both(kernel, kernel.sample_batch(keys, "regfile"), 16, False)
    _assert_equal(got, ref)


@pytest.mark.parametrize("k,may_latch", [(16, True), (16, False),
                                         (4, True), (4, False)])
def test_kernel_matches_plain_on_every_kind(kernel, k, may_latch):
    got, ref = _both(kernel, _mixed(kernel, 2048, 11), k, may_latch)
    _assert_equal(got, ref)
    if k == 4:
        assert bool(got.overflow.any())


def test_kernel_matches_plain_on_ragged_shapes(cuda):
    """A window that is no multiple of the kernel's column tile and a batch
    that is no multiple of its block, memory-only classification."""
    t = native.generate_trace(seed=9, n=300, nphys=256, mem_words=512,
                              working_set_words=128)
    kernel = TrialKernel(t, O3Config(compare_regs=False), device=cuda)
    got, ref = _both(kernel, _mixed(kernel, 1000, 12), 16, True)
    _assert_equal(got, ref)


def test_hybrid_on_card_equals_dense_and_counts_launches(kernel):
    keys = prng.trial_keys(prng.campaign_key(3), 1024)
    faults = kernel.sample_batch(keys, "regfile")
    before = taint_fast_cuda.launches
    hybrid = kernel.run_batch_hybrid(faults, may_latch=False)
    assert taint_fast_cuda.launches == before + 1
    np.testing.assert_array_equal(hybrid,
                                  kernel.run_batch(faults).cpu().numpy())
    np.testing.assert_array_equal(hybrid, kernel.oracle_outcomes(faults))


def test_cuda_tensors_never_reach_the_plain_version(kernel, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(taint_cuda, "taint_fast_plain", refuse)
    keys = prng.trial_keys(prng.campaign_key(4), 256)
    assert keys.device.type == "cuda"
    faults = kernel.sample_batch(keys, "regfile")
    kernel.taint_fast(faults, may_latch=False)
    kernel.taint_batch(faults, False)
    kernel.run_keys(keys, "regfile")


# --- K2: the chunk kernel ------------------------------------------------------

def _chunk_args(kernel, chunk, c, n_lanes, k, seed):
    """Chunk ``c``'s record and a batch of localized mixed-kind lanes, a
    third carried in with seeded sets (holes included) and negative
    coordinates."""
    camp = ChunkedCampaign(kernel, chunk=chunk)
    tr, _, gold = camp.chunk_record(c)
    rng = np.random.default_rng(seed)
    t = kernel.trace
    S = camp.S
    kind = rng.integers(1, 10, n_lanes)
    carried = rng.random(n_lanes) < 1 / 3
    at = np.where(carried, rng.integers(-S, 0, n_lanes),
                  rng.integers(0, S, n_lanes))
    faults = compat.fault_from_arrays(
        kind, np.where(kind == 1, at, rng.integers(-S, S, n_lanes)),
        np.where(kind == 1, rng.integers(0, t.nphys, n_lanes), at),
        rng.integers(0, 32, n_lanes), rng.random(n_lanes, dtype=np.float32),
        kernel.device)
    tags = np.full((n_lanes, k), -1, np.int64)
    vals = np.zeros((n_lanes, k), np.int64)
    for lane in np.nonzero(carried)[0]:
        m = int(rng.integers(1, k + 1))
        slots = rng.choice(k, m, replace=False)
        tags[lane, slots] = rng.choice(t.nphys + t.mem_words, m,
                                       replace=False)
        vals[lane, slots] = rng.integers(0, 1 << 32, m)
    reg0 = torch.as_tensor(camp.gb_reg[c].astype(np.int64),
                           device=kernel.device)
    cov = torch.full((S,), 0.5, device=kernel.device)
    return (gold, tr, cov, faults, *setup_gather(gold, tr, reg0, faults),
            torch.as_tensor(tags, device=kernel.device),
            torch.as_tensor(vals, device=kernel.device))


@pytest.mark.parametrize("k,may_latch", [(16, True), (16, False),
                                         (4, True), (4, False)])
def test_chunk_kernel_matches_plain(kernel, k, may_latch):
    # 512 = 2 * 200 + 112: chunk 2 is NOP-padded
    for c in (0, 2):
        args = _chunk_args(kernel, 200, c, 1000, k, 21 + c)
        before = taint_chunk_cuda.launches
        got = taint_chunk_cuda(*args, k=k, may_latch=may_latch)
        torch.cuda.synchronize()
        assert taint_chunk_cuda.launches == before + 1
        ref = taint_chunk(*args, k=k, may_latch=may_latch)
        for a, b in zip(got, ref):
            assert torch.equal(a.to(torch.int64), b.to(torch.int64))
        if k == 4:
            assert bool(got[7].any())


def test_chunked_path_on_card_launches_k2_and_equals_exact(kernel,
                                                            monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain chunk scan called on CUDA tensors")
    monkeypatch.setattr(taint_cuda, "taint_chunk", refuse)
    keys = prng.trial_keys(prng.campaign_key(6), 256)
    fast = ChunkedCampaign(kernel, chunk=200, engine="taint")
    before = taint_chunk_cuda.launches
    out = fast.outcomes_from_keys(keys, "regfile")
    assert taint_chunk_cuda.launches > before
    exact = ChunkedCampaign(kernel, chunk=200, engine="exact")
    np.testing.assert_array_equal(out, exact.outcomes_from_keys(keys,
                                                                "regfile"))
    np.testing.assert_array_equal(
        out, kernel.oracle_outcomes(kernel.sample_batch(keys, "regfile")))
