"""The port's dense scan, ALU and classification against the JAX package.

Same inputs, made with numpy from a seed, go through
``shrewd_tpu.ops.replay`` / ``classify`` and their port.  Tolerance: exact
(integer and float bit patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.isa import uops as RU
from shrewd_tpu.models.o3 import Fault as RefFault
from shrewd_tpu.ops import classify as RC
from shrewd_tpu.ops import replay as RR
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops import replay as R

# edge operands: 0, 1, -1, INT_MIN, INT_MAX, shift counts around 32,
# f32 subnormals, min normal, 1.0, max float, ±inf and NaNs
EDGES = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 31, 32, 33,
                  0xFFFFFFE0, 0x00000001, 0x807FFFFF, 0x00800000,
                  0x3F800000, 0xBF800000, 0x7F7FFFFF, 0x7F800000,
                  0xFF800000, 0x7FC00001, 0xFFC00000, 0x00000003],
                 dtype=np.uint32)


def test_uop_tables_are_the_reference_tables():
    assert U.OPCODE_NAMES == RU.OPCODE_NAMES
    assert U.N_OPCODES == RU.N_OPCODES
    np.testing.assert_array_equal(U._OPCLASS_TABLE, RU._OPCLASS_TABLE)
    ops = np.arange(RU.N_OPCODES)
    for pred in ("writes_dest", "is_div", "is_fp", "is_load", "is_store",
                 "is_branch", "is_mem", "uses_src1", "uses_src2"):
        np.testing.assert_array_equal(getattr(U, pred)(ops),
                                      getattr(RU, pred)(ops))


def _operands():
    rng = np.random.default_rng(0)
    a, b = (x.ravel() for x in np.meshgrid(EDGES, EDGES))
    rand = rng.integers(0, 2**32, (2, 600), dtype=np.uint64).astype(
        np.uint32)
    a = np.concatenate([a, rand[0]])
    b = np.concatenate([b, rand[1]])
    imm = rng.choice(np.concatenate([EDGES, rand[0][:50]]), a.shape[0])
    return a, b, imm


@pytest.mark.parametrize("op", range(32))
def test_alu_matches_reference(op):
    a, b, imm = _operands()
    want = np.asarray(jax.vmap(lambda x, y, z: RR._alu(
        jnp.int32(op), x, y, z))(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(imm)))

    def t(x):
        return torch.as_tensor(x.astype(np.int64))
    per_lane = R._alu(torch.full((a.shape[0],), op), t(a), t(b), t(imm))
    scalar = R._alu_op(op, t(a), t(b), t(imm))
    np.testing.assert_array_equal(per_lane.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(scalar.numpy(), want.astype(np.int64))


def test_fp4_and_div4_match_reference():
    a, b, _ = _operands()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta = torch.as_tensor(a.astype(np.int64))
    tb = torch.as_tensor(b.astype(np.int64))
    for got, want in zip(R._fp4(ta, tb), RR._fp4(ja, jb)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    for got, want in zip(R._div4(ta, tb), RR._div4(ja, jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
            bool if want.dtype == jnp.bool_ else np.int64))
    np.testing.assert_array_equal(R._mulhi(ta, tb).numpy(),
                                  np.asarray(RR._mulhi(ja, jb)).astype(
                                      np.int64))


def _window(seed=3, n=256, nphys=64, mem_words=256):
    return ref_native.generate_trace(seed=seed, n=n, nphys=nphys,
                                     mem_words=mem_words,
                                     working_set_words=mem_words // 4)


def _faults(t, kinds, n_lanes, seed):
    rng = np.random.default_rng(seed)
    kind = rng.choice(np.asarray(kinds), n_lanes).astype(np.int32)
    cycle = rng.integers(0, t.n, n_lanes).astype(np.int32)
    entry = np.where(kind == 1, rng.integers(0, t.nphys, n_lanes),
                     rng.integers(0, t.n, n_lanes)).astype(np.int32)
    bit = rng.integers(0, 32, n_lanes).astype(np.int32)
    shadow_u = rng.random(n_lanes).astype(np.float32)
    return kind, cycle, entry, bit, shadow_u


@pytest.mark.parametrize("kind", range(10))
def test_dense_replay_matches_vmapped_reference(kind):
    t = _window()
    sc = np.random.default_rng(1).random(t.n).astype(np.float32) * 0.6
    f = _faults(t, [kind], 48, seed=100 + kind)
    trR = RR.TraceArrays.from_trace(t)
    want = jax.vmap(lambda x: RR.replay(
        trR, jnp.asarray(t.init_reg), jnp.asarray(t.init_mem), x,
        jnp.asarray(sc)))(RefFault(*(jnp.asarray(x) for x in f)))
    pt = compat.trace_from_arrays(*t)
    got = R.replay(R.TraceArrays.from_trace(pt, "cpu"),
                   torch.as_tensor(pt.init_reg.astype(np.int64)),
                   torch.as_tensor(pt.init_mem.astype(np.int64)),
                   compat.fault_from_arrays(*f, "cpu"), torch.as_tensor(sc))
    for name in ("reg", "mem", "detected", "trapped", "diverged"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(
                np.int64 if name in ("reg", "mem") else bool))


def test_dense_replay_memmap_waits_for_a_later_slice():
    """The memmap came with the ingest slice: a MemMap whose µops all
    carry cluster -1 keeps the dense range test, so on every fault kind
    (LSQ-address flips included) the replay equals the one without a
    memmap and the reference's with the same map.  (The trap model's
    branches: tests/test_torch_memmap.py.)"""
    t = _window(n=128)
    pt = compat.trace_from_arrays(*t)
    f = _faults(t, list(range(10)), 96, seed=5)
    fields = dict(uop_cluster=np.full(t.n, -1), cl_lo=[0x1000, 0x9000],
                  cl_span=[0x100, 0x100], cl_word_off=[0, 64],
                  ld_lo=[0x1000], ld_span=[0x10000], st_lo=[0x1000],
                  st_span=[0x8000])
    mm = R.MemMap(**{n: torch.as_tensor(np.asarray(v, np.int64))
                     for n, v in fields.items()})
    rmm = RR.MemMap(**{n: jnp.asarray(np.asarray(
        v, np.int32 if n in ("uop_cluster", "cl_word_off") else np.uint32))
        for n, v in fields.items()})
    args = (R.TraceArrays.from_trace(pt, "cpu"),
            torch.as_tensor(pt.init_reg.astype(np.int64)),
            torch.as_tensor(pt.init_mem.astype(np.int64)),
            compat.fault_from_arrays(*f, "cpu"), torch.zeros(t.n))
    got, plain = R.replay(*args, memmap=mm), R.replay(*args)
    trR = RR.TraceArrays.from_trace(t)
    want = jax.vmap(lambda x: RR.replay(
        trR, jnp.asarray(t.init_reg), jnp.asarray(t.init_mem), x,
        jnp.zeros(t.n, jnp.float32), memmap=rmm))(
            RefFault(*(jnp.asarray(x) for x in f)))
    for name in ("reg", "mem", "detected", "trapped", "diverged"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name)).astype(
                np.int64 if name in ("reg", "mem") else bool))


@pytest.mark.parametrize("compare_regs", [True, False])
def test_classify_and_tallies_match_reference(compare_regs):
    rng = np.random.default_rng(7)
    B, nphys, mw = 512, 16, 32
    gold_reg = rng.integers(0, 4, nphys)
    gold_mem = rng.integers(0, 4, mw)
    reg = np.where(rng.random((B, nphys)) < 0.02,
                   rng.integers(0, 4, (B, nphys)), gold_reg)
    mem = np.where(rng.random((B, mw)) < 0.01,
                   rng.integers(0, 4, (B, mw)), gold_mem)
    det, trap, div = (rng.random((3, B)) < [[0.1], [0.1], [0.1]])
    ref_res = RR.ReplayResult(jnp.asarray(reg, jnp.uint32),
                              jnp.asarray(mem, jnp.uint32),
                              jnp.asarray(det), jnp.asarray(trap),
                              jnp.asarray(div))
    ref_gold = RR.ReplayResult(jnp.asarray(gold_reg, jnp.uint32),
                               jnp.asarray(gold_mem, jnp.uint32),
                               jnp.bool_(False), jnp.bool_(False),
                               jnp.bool_(False))
    want = np.asarray(jax.vmap(lambda r: RC.classify(
        r, ref_gold, compare_regs))(ref_res))

    def t(x):
        return torch.as_tensor(x)
    res = R.ReplayResult(t(reg), t(mem), t(det), t(trap), t(div))
    gold = R.ReplayResult(t(gold_reg)[None], t(gold_mem)[None],
                          *(torch.zeros(1, dtype=torch.bool),) * 3)
    got = C.classify(res, gold, compare_regs)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(C.tally(got).numpy(),
                                  np.asarray(RC.tally(jnp.asarray(want))))
    strata = rng.integers(0, 8, B)
    np.testing.assert_array_equal(
        C.tally_stratified(got, t(strata), 8).numpy(),
        np.asarray(RC.tally_stratified(jnp.asarray(want),
                                       jnp.asarray(strata), 8)))
    tal = C.tally(got)
    assert float(C.avf(tal)) == float(RC.avf(jnp.asarray(tal.numpy())))
    assert float(C.sdc_rate(tal)) == float(
        RC.sdc_rate(jnp.asarray(tal.numpy())))
