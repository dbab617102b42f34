"""The port's deviation-set scans against the JAX package.

The plain fast pass (the CPU side of the Hopper kernel) is held against
both ``taint_fast_pallas`` in interpret mode and the XLA ``taint_replay``;
the row pass against ``taint_replay`` with the memory timeline; the golden
record and the setup gathers field by field.  Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models.o3 import KIND_LATCH_OP
from shrewd_tpu.models.o3 import Fault as RefFault
from shrewd_tpu.ops import replay as RR
from shrewd_tpu.ops import taint as RT
from shrewd_tpu.ops.pallas_taint import taint_fast_pallas
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.ops import replay as R
from shrewd_tpu_torch.ops import taint as T
from shrewd_tpu_torch.ops import taint_cuda


class Pair:
    """One window, fault batch and coverage, in both packages."""

    def __init__(self, seed=3, n=256, nphys=64, mem_words=256, lanes=256):
        t = ref_native.generate_trace(seed=seed, n=n, nphys=nphys,
                                      mem_words=mem_words,
                                      working_set_words=mem_words // 4)
        rng = np.random.default_rng(seed)
        kind = rng.integers(1, 10, lanes).astype(np.int32)
        self.f = (kind, rng.integers(0, n, lanes).astype(np.int32),
                  np.where(kind == 1, rng.integers(0, nphys, lanes),
                           rng.integers(0, n, lanes)).astype(np.int32),
                  rng.integers(0, 32, lanes).astype(np.int32),
                  rng.random(lanes).astype(np.float32))
        self.sc = rng.random(n).astype(np.float32) * 0.5
        self.t = t
        self.trR = RR.TraceArrays.from_trace(t)
        self.faultR = RefFault(*(jnp.asarray(x) for x in self.f))
        self.goldR = RT.record_golden(self.trR, jnp.asarray(t.init_reg),
                                      jnp.asarray(t.init_mem), True)
        pt = compat.trace_from_arrays(*t)
        self.pt = pt
        self.tr = R.TraceArrays.from_trace(pt, "cpu")
        self.init_reg = torch.as_tensor(pt.init_reg.astype(np.int64))
        self.init_mem = torch.as_tensor(pt.init_mem.astype(np.int64))
        self.fault = compat.fault_from_arrays(*self.f, "cpu")
        self.gold = T.record_golden(self.tr, self.init_reg, self.init_mem,
                                    True)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _eq(got, want, mask=None):
    got = got.numpy().astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_array_equal(got, want)


def test_record_golden_matches_reference(pair):
    for name in T.GoldenRecord._fields:
        _eq(getattr(pair.gold, name), getattr(pair.goldR, name))


def test_record_golden_without_timelines():
    p = Pair(seed=4, n=128, lanes=8)
    g = T.record_golden(p.tr, p.init_reg, p.init_mem, False,
                        reg_timeline=False)
    assert g.reg_t is None and g.mem_t is None
    _eq(g.final_mem, p.goldR.final_mem)
    _eq(g.res, p.goldR.res)


def test_setup_scan_equals_fault_setup(pair):
    want = RT.fault_setup(pair.goldR, pair.trR, pair.faultR)
    timeline = T.fault_setup(pair.gold, pair.tr, pair.fault)
    scan = T.setup_scan(pair.tr, pair.init_reg, pair.init_mem, pair.fault)
    for w, a, b in zip(want, timeline, scan):
        _eq(a, w)
        _eq(b, w)


@pytest.mark.parametrize("k", [16, 4])
@pytest.mark.parametrize("may_latch", [True, False])
def test_fast_pass_matches_pallas_and_xla(pair, k, may_latch):
    setupR = RT.fault_setup(pair.goldR, pair.trR, pair.faultR)
    trR = pair.trR
    pal = taint_fast_pallas(
        pair.goldR, trR.opcode, trR.dst, trR.src1, trR.src2, trR.imm,
        trR.taken, jnp.asarray(pair.sc), pair.faultR, *setupR, k=k,
        may_latch=may_latch, b_tile=128, interpret=True)
    xla = jax.vmap(lambda f: RT.taint_replay(
        pair.goldR._replace(mem_t=None), trR, f, jnp.asarray(pair.sc),
        k=k))(pair.faultR)
    got = T.taint_fast_plain(pair.gold, pair.tr, torch.as_tensor(pair.sc),
                             pair.fault,
                             *T.fault_setup(pair.gold, pair.tr, pair.fault),
                             k=k, may_latch=may_latch)
    # without may_latch a LATCH_OP fault is ignored, as in the Pallas
    # kernel; the XLA scan always applies it
    xla_lanes = None if may_latch else pair.f[0] != KIND_LATCH_OP
    for name in ("outcome", "escaped", "overflow"):
        _eq(getattr(got, name), getattr(pal, name))
        _eq(getattr(got, name), getattr(xla, name), xla_lanes)
    assert bool(got.escaped.any())
    if k == 4:
        assert bool(got.overflow.any())


def test_row_pass_matches_taint_replay_with_the_memory_timeline(pair):
    want = jax.vmap(lambda f: RT.taint_replay(
        pair.goldR, pair.trR, f, jnp.asarray(pair.sc), k=16))(pair.faultR)
    got = T.taint_replay(pair.gold, pair.tr, pair.fault,
                         torch.as_tensor(pair.sc), k=16)
    for name in ("outcome", "escaped", "overflow"):
        _eq(getattr(got, name), getattr(want, name))
    assert not bool(got.escaped.any())


def test_compare_regs_false_matches_reference(pair):
    want = jax.vmap(lambda f: RT.taint_replay(
        pair.goldR, pair.trR, f, jnp.asarray(pair.sc), k=16,
        compare_regs=False))(pair.faultR)
    got = T.taint_replay(pair.gold, pair.tr, pair.fault,
                         torch.as_tensor(pair.sc), k=16, compare_regs=False)
    _eq(got.outcome, want.outcome)


def test_wrapper_runs_the_plain_version_for_cpu_tensors(pair):
    setup = T.fault_setup(pair.gold, pair.tr, pair.fault)
    args = (pair.gold, pair.tr, torch.as_tensor(pair.sc), pair.fault,
            *setup)
    before = taint_cuda.taint_fast_cuda.launches
    got = taint_cuda.taint_fast_cuda(*args, k=16, may_latch=True)
    want = T.taint_fast_plain(*args, k=16, may_latch=True)
    assert taint_cuda.taint_fast_cuda.launches == before
    for name in T.TaintResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_kernel_stream_layout(pair):
    s = taint_cuda.pack_stream(pair.gold, pair.tr, torch.as_tensor(pair.sc))
    n, nphys = pair.t.n, pair.t.nphys
    assert s.dtype == torch.int32 and s.shape == (n, 16)
    assert s.is_contiguous()                  # 64 B per step, step-major
    g = pair.goldR
    ld, st = np.asarray(g.is_ld), np.asarray(g.is_st)
    # op | flags << 8; a generated window is quiet everywhere: no LOUD bit
    flags = (np.asarray(g.wr).astype(int) | ld << 1 | st << 2
             | (pair.t.taken != 0) << 4)
    np.testing.assert_array_equal(s[:, 0].numpy(),
                                  pair.t.opcode | flags << 8)
    np.testing.assert_array_equal(s[:, 4].numpy().view(np.uint32),
                                  pair.t.imm)
    np.testing.assert_array_equal(
        s[:, 8].numpy().view(np.uint32), np.asarray(g.res))
    mslot = (np.asarray(g.ea).astype(np.int64) >> 2) & (pair.t.mem_words - 1)
    mtag = np.where(ld | st, nphys + mslot, -1)
    np.testing.assert_array_equal(s[:, 11].numpy(), mtag)
    assert (s[:, 12].numpy() == n).all()      # no loud step after any
    # the filter probe: bit (tag * 0x9E3779B1 mod 2**32) >> 26 of each tag
    probe = s[:, 13].numpy().view(np.uint32).astype(np.uint64) | \
        s[:, 14].numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)

    def bit(tag):
        h = (tag.astype(np.uint64) * np.uint64(0x9E3779B1)) & \
            np.uint64(0xFFFFFFFF)
        return np.uint64(1) << (h >> np.uint64(26))
    want = (bit(pair.t.src1) | bit(pair.t.src2) | bit(pair.t.dst)
            | np.where(ld | st, bit(np.maximum(mtag, 0)), np.uint64(0)))
    np.testing.assert_array_equal(probe, want)
    np.testing.assert_array_equal(s[:, 15].numpy().view(np.float32), pair.sc)
