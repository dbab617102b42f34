"""The quiet-step rule and the lane order behind the Hopper kernels' step
skipping (``ops/taint_cuda.py``), on the CPU.

A step is quiet when a lane with an empty deviation set and no fault phase
there stays live with its set empty; the kernels jump an empty-set lane to
its landing or the next loud step, and take a quiet untouched step as a
no-op.  Here: generated windows are quiet everywhere and null lanes of
the plain chunk scan run live to the end; a window with one branch's
``taken`` inverted before recording is loud at that step alone, and the
plain scan — and the JAX reference's ``taint_chunk`` — stop every null
lane there; so do windows made loud by a misaligned load, a DIVU by zero
and ``taken`` on a non-branch, and records that get one step's values
wrong (a write, a load's or a store's word) are loud there; the scan taken
one step at a time (the card tests' independent count of the kernels' hit
counters) equals the scan; the lane order's start rules; the bound count
of ``chip_smoke.py``.  Tolerance everywhere: exact.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models.o3 import Fault as RefFault
from shrewd_tpu.ops import replay as RR
from shrewd_tpu.ops import taint as RT
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops import replay as R
from shrewd_tpu_torch.ops import taint as T
from shrewd_tpu_torch.ops import taint_cuda as TC
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
from shrewd_tpu_torch.ops.trial import TrialKernel
from test_torch_cuda import hit_counts, loud_trace, step_by_step, wrong_record

ROOT = Path(__file__).resolve().parents[1]
N, NPHYS, MEM_WORDS = 384, 64, 256


def window(seed: int, flip_branch: bool = False):
    """A generated window; with ``flip_branch`` the ``taken`` of its middle
    branch is inverted before recording → (trace, that branch's step)."""
    t = ref_native.generate_trace(seed=seed, n=N, nphys=NPHYS,
                                  mem_words=MEM_WORDS,
                                  working_set_words=MEM_WORDS // 4)
    br = np.nonzero(U.is_branch(t.opcode))[0]
    j = int(br[len(br) // 2])
    if flip_branch:
        taken = t.taken.copy()
        taken[j] ^= 1
        t = t._replace(taken=taken)
    return t, j


def record(t):
    """The port's trace arrays and golden record of a window, on the
    CPU."""
    return record_port(compat.trace_from_arrays(*t))


def record_port(pt):
    """``record`` of the port's ``Trace`` as it is (not validated: a
    constructed window may set ``taken`` on a non-branch)."""
    tr = R.TraceArrays.from_trace(pt, "cpu")
    gold = T.record_golden(tr, torch.as_tensor(pt.init_reg.astype(np.int64)),
                           torch.as_tensor(pt.init_mem.astype(np.int64)),
                           False)
    return tr, gold


def null_lanes(lanes: int):
    """Null padding lanes as the chunked driver builds them."""
    f = (np.zeros(lanes, np.int32), np.full(lanes, -1, np.int32),
         np.full(lanes, -1, np.int32), np.zeros(lanes, np.int32),
         np.ones(lanes, np.float32))
    return f


def mixed_lanes(lanes: int, seed: int):
    """Lanes of every kind landing anywhere in the window or before it
    (negative coordinates, as a carried lane's), with null lanes."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 10, lanes).astype(np.int32)
    at = rng.integers(-N // 2, N, lanes)
    cycle = np.where(kind == 1, at, rng.integers(-N, N, lanes))
    entry = np.where(kind == 1, rng.integers(0, NPHYS, lanes), at)
    return (kind, cycle.astype(np.int32), entry.astype(np.int32),
            rng.integers(0, 32, lanes).astype(np.int32),
            rng.random(lanes).astype(np.float32))


def empty_sets(lanes: int, k: int):
    return (torch.full((lanes, k), T.EMPTY, dtype=torch.int64),
            torch.zeros((lanes, k), dtype=torch.int64))


@pytest.mark.parametrize("seed", [3, 8])
def test_generated_window_is_quiet_and_null_lanes_run_to_the_end(seed):
    t, _ = window(seed)
    tr, gold = record(t)
    quiet = TC.quiet_steps(gold, tr)
    assert quiet.shape == (N,) and bool(quiet.all())
    assert (TC.next_loud(quiet) == N).all()
    f = compat.fault_from_arrays(*null_lanes(16), "cpu")
    got = T.taint_chunk(gold, tr, torch.zeros(N), f,
                        *T.fault_setup(gold, tr, f), *empty_sets(16, 16))
    tags, _, steps, det, trap, div, esc, ovf = got
    assert (steps == N).all() and (tags == T.EMPTY).all()
    for flag in (det, trap, div, esc, ovf):
        assert not bool(flag.any())


def test_chunk_records_are_quiet():
    """The C++ chunk recorder's streams (the K2 path's records, NOP
    padding included) are quiet at every step of a generated window."""
    t, _ = window(5)
    kernel = TrialKernel(compat.trace_from_arrays(*t), O3Config(),
                         device="cpu")
    camp = ChunkedCampaign(kernel, chunk=150)
    assert camp.C * camp.S > N              # the last chunk is padded
    for c in range(camp.C):
        tr, _, gold = camp.chunk_record(c)
        assert bool(TC.quiet_steps(gold, tr).all())


def test_loud_step_stops_null_lanes_as_the_reference():
    t, j = window(3, flip_branch=True)
    _check_loud_window(t, record(t), j, "diverged")


@pytest.mark.parametrize("how,flag", [("misaligned_load", "trapped"),
                                      ("divu_by_zero", "trapped"),
                                      ("taken_off_branch", "diverged")])
def test_other_loud_steps_stop_null_lanes_as_the_reference(how, flag):
    t, _ = window(3)
    pt, j = loud_trace(compat.trace_from_arrays(*t), how)
    t = t._replace(**{f: getattr(pt, f).astype(getattr(t, f).dtype)
                      for f in pt._fields})
    _check_loud_window(t, record_port(pt), j, flag)


def _check_loud_window(t, record_, j: int, flag: str):
    """Window ``t`` (the reference's ``Trace``) with its port record is
    loud at step ``j`` alone; the plain chunk scan stops every null lane
    there with ``flag`` and an empty set, and equals the JAX reference's
    ``taint_chunk`` on every lane."""
    tr, gold = record_
    quiet = TC.quiet_steps(gold, tr)
    assert torch.nonzero(~quiet).flatten().tolist() == [j]
    want = np.where(np.arange(N) <= j, j, N)
    np.testing.assert_array_equal(TC.next_loud(quiet).numpy(), want)
    stream = TC.pack_stream(gold, tr, torch.zeros(N))
    loud_bit = (stream[:, 0] >> 8) & 8
    assert torch.nonzero(loud_bit).flatten().tolist() == [j]
    np.testing.assert_array_equal(stream[:, 12].numpy(),
                                  np.where(np.arange(N) < j, j, N))

    nulls = null_lanes(24)
    f_np = tuple(np.concatenate([a, b]) for a, b in
                 zip(nulls, mixed_lanes(104, 1)))
    B, k = f_np[0].shape[0], 16
    f = compat.fault_from_arrays(*f_np, "cpu")
    setup = T.fault_setup(gold, tr, f)
    sc = np.random.default_rng(2).random(N).astype(np.float32) * 0.5
    got = T.taint_chunk(gold, tr, torch.as_tensor(sc), f, *setup,
                        *empty_sets(B, k), k=k)
    tags, vals, steps, det, trap, div, esc, ovf = got
    # every null lane stops at the loud step with its flag, set empty
    flags = dict(detected=det, trapped=trap, diverged=div, escaped=esc,
                 overflowed=ovf)
    assert (steps[:24] == j + 1).all() and bool(flags.pop(flag)[:24].all())
    assert (tags[:24] == T.EMPTY).all()
    for other in flags.values():
        assert not bool(other[:24].any())

    # the JAX reference's taint_chunk on the same window and lanes
    trR = RR.TraceArrays.from_trace(t)
    goldR = RT.record_golden(trR, jnp.asarray(t.init_reg),
                             jnp.asarray(t.init_mem), True)
    fR = RefFault(*(jnp.asarray(x) for x in f_np))
    setupR = RT.fault_setup(goldR, trR, fR)
    ref = jax.vmap(lambda f_, s: RT.taint_chunk(
        goldR._replace(mem_t=None), trR, f_, jnp.asarray(sc),
        jnp.full((k,), -1, jnp.int32), jnp.zeros((k,), jnp.uint32), k=k,
        setup=s))(fR, setupR)
    r_tags, r_vals, r_live, *r_flags = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(tags.numpy(), r_tags.astype(np.int64))
    np.testing.assert_array_equal(vals.numpy(), r_vals.astype(np.int64))
    for a, w in zip((det, trap, div, esc, ovf), r_flags):
        np.testing.assert_array_equal(a.numpy(), w)
    # a lane live at the end ran every step; one stopped, at most j + 1
    np.testing.assert_array_equal((steps == N).numpy(), r_live)
    assert not r_live[:24].any() and (steps <= j + 1).any()


def _prefix(gold, tr, m: int):
    """The record and trace of a window's first ``m`` steps."""
    return (gold._replace(**{x: getattr(gold, x)[:m]
                             for x in ("a", "b", "ea", "res", "st_old",
                                       "dst_old", "wr", "is_ld", "is_st")}),
            type(tr)(*(x[:m] for x in tr)))


@pytest.mark.parametrize("how", ["write", "escape", "store"])
def test_wrong_record_is_loud_at_that_step(how):
    """A record that gets one step's values wrong (not one a recorder
    makes) fires the clauses a consistent record never does: the
    writeback's or the store's upsert, or the load's escape.  The step is
    loud, alone, and the plain scan's null lanes stop there (an escape) or
    leave it with a non-empty set (an upsert)."""
    t, _ = window(8)
    tr, gold = record(t)
    gold, j = wrong_record(gold, how)
    assert torch.nonzero(~TC.quiet_steps(gold, tr)).flatten().tolist() == [j]
    g_j, tr_j = _prefix(gold, tr, j + 1)
    f = compat.fault_from_arrays(*null_lanes(8), "cpu")
    tags, _, steps, det, trap, div, esc, ovf = T.taint_chunk(
        g_j, tr_j, torch.zeros(j + 1), f, *T.fault_setup(gold, tr, f),
        *empty_sets(8, 16))
    for other in (det, trap, div, ovf):
        assert not bool(other.any())
    assert (steps == j + 1).all()
    if how == "escape":
        assert bool(esc.all()) and (tags == T.EMPTY).all()
    else:
        assert not bool(esc.any()) and bool((tags != T.EMPTY).any(1).all())
    # the steps before it leave the null lanes as they were
    g_0, tr_0 = _prefix(gold, tr, j)
    tags, *_ = T.taint_chunk(g_0, tr_0, torch.zeros(j), f,
                             *T.fault_setup(gold, tr, f), *empty_sets(8, 16))
    assert (tags == T.EMPTY).all()


def test_step_by_step_scan_equals_the_plain_scan():
    """The card tests hold the kernels' hit counters against
    ``hit_counts`` of the scan taken one step at a time; here that scan
    equals the plain chunk scan on lanes of every kind, carried sets,
    null lanes and a loud step, K = 4 so that some sets overflow."""
    t, j = window(5, flip_branch=True)
    tr, gold = record(t)
    k, B = 4, 96
    f_np = tuple(np.concatenate([a, b]) for a, b in
                 zip(null_lanes(8), mixed_lanes(B - 8, 6)))
    f = compat.fault_from_arrays(*f_np, "cpu")
    rng = np.random.default_rng(7)
    tags0, vals0 = empty_sets(B, k)
    carried = 8 + np.nonzero(rng.random(B - 8) < 0.3)[0]   # not null
    tags0[carried, 0] = torch.as_tensor(rng.integers(0, NPHYS, carried.size))
    vals0[carried, 0] = torch.as_tensor(rng.integers(0, 1 << 32,
                                                     carried.size))
    sc = torch.as_tensor(np.random.default_rng(2).random(N)
                         .astype(np.float32) * 0.5)
    args = (gold, tr, sc, f, *T.fault_setup(gold, tr, f), tags0, vals0)
    got, before, alive = step_by_step(*args, k=k)
    ref = T.taint_chunk(*args, k=k)
    for a, b in zip(got, ref):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    assert bool(ref[7].any()) and bool(ref[5].any())
    assert before.shape == (N, B, k) and alive.shape == (N, B)
    counts = hit_counts(gold, tr, f, before, alive)
    # a lane takes each step at most once, and only while live
    assert bool((counts.sum(0) <= ref[2]).all())
    assert bool((counts[:, :8] == 0).all()) and bool((counts > 0).any(1).all())


def test_lane_starts_and_order():
    rng = np.random.default_rng(4)
    n, B, k = 50, 400, 4
    kind = rng.integers(0, 10, B)
    cycle = rng.integers(-2 * n, 2 * n, B)
    entry = rng.integers(-2 * n, 2 * n, B)
    tags0 = np.full((B, k), -1, np.int64)
    carries = rng.random(B) < 0.3
    tags0[carries, rng.integers(0, k, B)[carries]] = 7
    f = compat.fault_from_arrays(kind, cycle, entry, np.zeros(B, np.int64),
                                 np.ones(B, np.float32), "cpu")
    land = np.where(kind == 1, cycle, entry)
    lands = (kind >= 1) & (0 <= land) & (land < n)
    want_k1 = np.where(lands, land, n)
    want_k2 = np.where(carries, 0, want_k1)
    # every rule is exercised, for every kind
    for kd in range(1, 10):
        lanes = kind == kd
        assert (lanes & lands).any() and (lanes & ~lands).any()
        assert (lanes & carries & lands).any()
    assert ((kind == 0) & ~carries).any() and ((kind == 0) & carries).any()
    np.testing.assert_array_equal(TC.lane_starts(f, n).numpy(), want_k1)
    start = TC.lane_starts(f, n, torch.as_tensor(tags0))
    np.testing.assert_array_equal(start.numpy(), want_k2)
    order = TC.lane_order(start)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(B))
    # sorted by start; ties keep the lanes' order
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want_k2, kind="stable"))


def test_counts_come_from_the_kernel_only():
    t, _ = window(3)
    tr, gold = record(t)
    f = compat.fault_from_arrays(*null_lanes(4), "cpu")
    args = (gold, tr, torch.zeros(N), f, *T.fault_setup(gold, tr, f))
    counts = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="counts"):
        TC.taint_fast_cuda(*args, counts=counts)
    with pytest.raises(ValueError, match="counts"):
        TC.taint_chunk_cuda(*args, *empty_sets(4, 16), counts=counts)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("k", [4, 16])
def test_chip_smoke_need_operation_count(k):
    """The function's own-need count behind chip_smoke.py's bounds
    equals a lane by lane sum: the full body on the landing step (with the
    flip) and on each loud step a lane reaches, the cheapest full body on
    each counted hit; a counted miss changes nothing and needs nothing."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(200 + k)
    n, lanes = 40, 64
    opcode = rng.integers(0, 32, n).astype(np.int32)
    loud = np.isin(np.arange(n), (5, 17, 30))
    land = np.where(rng.random(lanes) < 0.8, rng.integers(-n, n, lanes), -1)
    steps = rng.integers(1, n + 1, lanes)
    land[0], steps[0] = 17, n         # a landing on a loud step
    counts = rng.integers(0, n, (2, lanes))
    lookup, upsert = 4 * k, 7 * k + 3
    full_body = smoke.OPS_STEP + 2 * lookup + smoke.OPS_FILTER * k
    want = want_full = 0
    for lane in range(lanes):
        last = steps[lane] - 1
        for i in range(last + 1):
            is_land = i == land[lane]
            if loud[i] or is_land:
                want += full_body + (opcode[i] == U.LOAD) * (smoke.OPS_LOAD
                                                             + lookup)
                want_full += 1
            if is_land:
                want += smoke.OPS_LANDING + lookup + upsert
        want += counts[0, lane] * full_body
        want_full += counts[0, lane]
    assert ((land >= 0) & (land < steps)).any()
    got = smoke.need_operations(opcode, loud, land, steps, counts, k)
    assert got == (want, want_full, int(counts[1].sum()))
