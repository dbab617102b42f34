"""The VA-space memmap trap model of the dense replay, against the JAX
package's ``replay(memmap=…)``.

Three levels, each compared exactly (final registers, memory and the three
flags of every lane):

- the reference's own directed cases (``tests/test_replay.py``'s two
  clusters in a writable and a read-only region), one per branch of the
  model: a load outside every mapped region traps, a store in a read-only
  region traps, a valid hit in another cluster is routed to that cluster's
  words, a mapped VA no cluster tracks goes to the scratch word, and a µop
  of cluster -1 keeps the dense range test;
- ``sort.c``'s output-mode lift (``capture_and_lift_to_output``, 4
  clusters, 32768 words) with its ``memmap_from_meta``: 64 coordinates,
  32 register flips and 32 LSQ-address flips picked so that every branch
  above that a one-bit flip can reach there is reached (the branch of each
  is computed on the host; the clusters lie too far apart for one bit to
  move an access into another, so the cross-cluster route is the directed
  case's alone);
- the exact chunked engine on that window in 2 chunks, with the boundary
  pass through the memmap scan, against the dense outcomes;
- ``hostdiff.run_device`` on the pair-lane 64-bit lift (``device64``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu.ingest import hostdiff as ref_hd
from shrewd_tpu.models.o3 import Fault as RefFault, O3Config as RefConfig
from shrewd_tpu.ops import chunked as ref_chunked
from shrewd_tpu.ops.replay import (MemMap as RefMemMap,
                                   TraceArrays as RefArrays,
                                   replay as ref_replay)
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.trace.format import Trace as RefTrace
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import (KIND_LSQ_ADDR, KIND_REGFILE,
                                        O3Config, null_fault)
from shrewd_tpu_torch.ops import classify as C, window as W
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
from shrewd_tpu_torch.ops.replay import MemMap, TraceArrays, replay
from shrewd_tpu_torch.ops.taint import record_golden
from shrewd_tpu_torch.ops.trial import TrialKernel

from test_torch_lift import needs_toolchain, shared_captures

M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    """R1: the reference's ``TrialKernel.golden`` calls
    ``jax.core.trace_state_clean``, which jax 0.9 moved."""
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


def _ref_faults(kind, cycle, entry, bit):
    i32 = lambda x: jnp.asarray(np.asarray(x, np.int32))  # noqa: E731
    return RefFault(kind=i32(kind), cycle=i32(cycle), entry=i32(entry),
                    bit=i32(bit),
                    shadow_u=jnp.ones(len(kind), jnp.float32))


def _assert_same(got, ref):
    for f in ("reg", "mem", "detected", "trapped", "diverged"):
        np.testing.assert_array_equal(
            getattr(got, f).cpu().numpy().astype(np.int64),
            np.asarray(getattr(ref, f)).astype(np.int64), err_msg=f)


# --- the directed cases ------------------------------------------------------

LO0, LO1 = 0x10000, 0x50000


def _mini(store: bool, clusters):
    """Two clusters: cluster 0 = VA [0x10000, 0x10100) → words 0..63, in
    writable region [0x10000, 0x10200); cluster 1 = VA [0x50000, 0x50100)
    → words 64..127, in read-only region [0x50000, 0x50200)."""
    delta0 = (0 * 4 - LO0) & M32
    rows = [(U.LUI, 2, 0, 0, (LO0 + 0x10 + delta0) & M32, 0),
            (U.LOAD, 3, 2, 0, 0, 0)]
    if store:
        rows.append((U.STORE, 0, 2, 3, 0, 0))
    arr = np.array(rows, np.int64)
    t = compat.trace_from_arrays(
        arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4], arr[:, 5],
        np.arange(16, dtype=np.uint32) * 3 + 1,
        np.arange(128, dtype=np.uint32) * 7 + 5)
    fields = dict(uop_cluster=clusters[:len(rows)], cl_lo=[LO0, LO1],
                  cl_span=[0x100, 0x100], cl_word_off=[0, 64],
                  ld_lo=[LO0, LO1], ld_span=[0x200, 0x200], st_lo=[LO0],
                  st_span=[0x200])
    mm = MemMap(**{k: torch.as_tensor(np.asarray(v, np.int64))
                   for k, v in fields.items()})
    rmm = RefMemMap(**{k: jnp.asarray(np.asarray(
        v, np.int32 if k in ("uop_cluster", "cl_word_off") else np.uint32))
        for k, v in fields.items()})
    return t, mm, rmm


CASES = {
    # (store?, cluster per µop, faulted µop, bit, what the reference says)
    "golden": (False, [-1, 0, 0], None, 0, "no trap"),
    "unmapped load traps": (False, [-1, 0, 0], 1, 23, "trap"),
    "cross-cluster load routes": (False, [-1, 0, 0], 1, 18, "no trap"),
    "store to read-only traps": (True, [-1, 0, 0], 2, 18, "trap"),
    "store in cluster": (True, [-1, 0, 0], 2, 2, "no trap"),
    "untracked VA to scratch": (True, [-1, 0, 0], 2, 8, "no trap"),
    "legacy µop": (False, [-1, -1, -1], None, 0, "no trap"),
    "legacy µop out of range": (False, [-1, -1, -1], 1, 23, "trap"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_directed_branches_equal_reference(case):
    store, clusters, at, bit, want = CASES[case]
    t, mm, rmm = _mini(store, clusters)
    kind = [0] if at is None else [KIND_LSQ_ADDR]
    entry = [0] if at is None else [at]
    got = replay(TraceArrays.from_trace(t, "cpu"),
                 torch.as_tensor(t.init_reg.astype(np.int64)),
                 torch.as_tensor(t.init_mem.astype(np.int64)),
                 compat.fault_from_arrays(kind, [0], entry, [bit], [1.0],
                                          device="cpu"),
                 torch.zeros(t.n), memmap=mm)
    ref = jax.vmap(lambda f: ref_replay(
        RefArrays.from_trace(t), jnp.asarray(t.init_reg),
        jnp.asarray(t.init_mem), f, jnp.zeros(t.n, jnp.float32),
        memmap=rmm))(_ref_faults(kind, [0], entry, [bit]))
    _assert_same(got, ref)
    assert bool(got.trapped[0]) == (want == "trap")
    if case == "cross-cluster load routes":
        assert int(got.reg[0, 3]) == int(t.init_mem[64 + 4])
    if case == "untracked VA to scratch":
        assert int(got.mem[0, 127]) == int(t.init_mem[4])


# --- the lifted window -------------------------------------------------------

def _branch(mm: dict, clu: int, addr: int, is_store: bool) -> str:
    """Host model of the trap model's branch for one access."""
    if clu < 0:
        ok = addr % 4 == 0 and (addr >> 2) < mm["mem_words"]
        return "legacy valid" if ok else "legacy trap"
    delta = (4 * mm["cl_word_off"][clu] - mm["cl_lo"][clu]) & M32
    va = (addr - delta) & M32
    in_cl = [((va - lo) & M32) < span for lo, span in
             zip(mm["cl_lo"], mm["cl_span"])]
    if is_store:
        ok = any(((va - lo) & M32) < sp for lo, sp in zip(mm["st_lo"],
                                                          mm["st_span"]))
        if not ok:
            return "store outside writable" if any(
                ((va - lo) & M32) < sp for lo, sp in
                zip(mm["ld_lo"], mm["ld_span"])) else "unmapped"
    elif not (any(in_cl) or any(((va - lo) & M32) < sp for lo, sp in
                                zip(mm["ld_lo"], mm["ld_span"]))):
        return "unmapped"
    if not any(in_cl):
        return "untracked"
    return "own cluster" if in_cl[clu] else "cross cluster"


@pytest.fixture(scope="module")
def lifted():
    paths = hd.build_tools("workloads/sort.c")
    with shared_captures(hd, cache={}):
        return hd.capture_and_lift_to_output(paths)


@pytest.fixture(scope="module")
def coords(lifted):
    """32 register flips from ``sample_coords`` and 32 LSQ-address flips
    covering every branch the window's accesses can reach."""
    trace, meta = lifted
    uop_start = np.asarray(meta["uop_start"])
    c = hd.sample_coords(32, meta["window_macro_ops"], seed=3)
    reg_f = (np.full(32, KIND_REGFILE), uop_start[c[:, 0]], c[:, 1],
             c[:, 2])
    kernel = TrialKernel(trace, device="cpu")
    gold = record_golden(kernel.tr, kernel.init_reg, kernel.init_mem,
                         False, reg_timeline=False)
    ea = gold.ea.tolist()
    mm = {k: v.tolist() for k, v in hd.memmap_from_meta(
        meta, device="cpu")._asdict().items()}
    mm["mem_words"] = trace.mem_words
    rng = np.random.default_rng(11)
    mem_uops = np.nonzero(np.isin(trace.opcode, (U.LOAD, U.STORE)))[0]
    by_branch: dict = {}
    for i in rng.permutation(mem_uops)[:400].tolist():
        for b in range(32):
            key = _branch(mm, mm["uop_cluster"][i], ea[i] ^ (1 << b),
                          trace.opcode[i] == U.STORE)
            by_branch.setdefault(key, []).append((i, b))
    picks = []
    for key in sorted(by_branch):
        picks += by_branch[key][:3]
    rest = [p for key in sorted(by_branch) for p in by_branch[key][3:]]
    picks += [rest[j] for j in rng.choice(len(rest), 32 - len(picks),
                                          replace=False)]
    lsq = np.asarray(picks[:32])
    lsq_f = (np.full(32, KIND_LSQ_ADDR), np.zeros(32), lsq[:, 0], lsq[:, 1])
    faults = tuple(np.concatenate([a, b]).astype(np.int32)
                   for a, b in zip(reg_f, lsq_f))
    return faults, sorted(by_branch)


@needs_toolchain
def test_lsq_coordinates_reach_every_branch(coords):
    _faults, branches = coords
    for need in ("own cluster", "untracked", "unmapped",
                 "store outside writable"):
        assert need in branches, branches


@needs_toolchain
def test_lifted_window_memmap_replay_equals_reference(lifted, coords):
    trace, meta = lifted
    faults, _ = coords
    k = TrialKernel(trace, O3Config(enable_shrewd=False), device="cpu",
                    memmap=hd.memmap_from_meta(meta, device="cpu"))
    got = k._replay(compat.fault_from_arrays(*faults, np.ones(64),
                                             device="cpu"))
    rk = RefKernel(RefTrace(*trace), RefConfig(enable_shrewd=False),
                   memmap=ref_hd.memmap_from_meta(meta))
    ref = jax.jit(jax.vmap(rk._replay_one))(_ref_faults(*faults))
    _assert_same(got, ref)
    trapped = got.trapped.numpy()
    assert trapped[32:].sum() >= 3 and (~trapped[32:]).sum() >= 3
    # the golden replay under the memmap is the plain one
    plain = TrialKernel(trace, O3Config(enable_shrewd=False), device="cpu")
    np.testing.assert_array_equal(k.golden.mem.numpy(),
                                  plain.golden.mem.numpy())
    # with a memmap every path of the kernel is the dense scan
    out = k.run_batch(compat.fault_from_arrays(*faults, np.ones(64),
                                               device="cpu")).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(rk.run_batch(_ref_faults(*faults))))
    np.testing.assert_array_equal(
        k.run_batch_hybrid(compat.fault_from_arrays(
            *faults, np.ones(64), device="cpu")), out)


@needs_toolchain
def test_chunked_exact_with_memmap_equals_dense(lifted, coords):
    """Two chunks on the exact engine: boundary goldens from the memmap
    scan equal the reference's, and the outcomes equal the dense ones."""
    trace, meta = lifted
    faults, _ = coords
    S = (trace.n + 1) // 2
    W.clear_registry()
    k = TrialKernel(trace, O3Config(), device="cpu",
                    memmap=hd.memmap_from_meta(meta, device="cpu"))
    with pytest.raises(ValueError, match="memmap"):
        ChunkedCampaign(k, chunk=S, engine="taint")
    ch = ChunkedCampaign(k, chunk=S)
    assert ch.engine == "exact" and ch.C == 2
    rk = RefKernel(RefTrace(*trace), RefConfig(),
                   memmap=ref_hd.memmap_from_meta(meta))
    rwin = ref_chunked.preprocess_window(rk, S)
    np.testing.assert_array_equal(ch.window.gb_reg, rwin.gb_reg)
    np.testing.assert_array_equal(ch.window.gb_mem, rwin.gb_mem)
    f = compat.fault_from_arrays(*faults, np.ones(64), device="cpu")
    got = ch.outcomes_of_faults(f)
    np.testing.assert_array_equal(got, k.run_batch(f).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(rk.run_batch(_ref_faults(*faults))))
    assert ch.last_stats["carried"] > 0
    assert (got == C.OUTCOME_DUE).sum() >= 3
    # a second campaign over the same kernel is a registry hit
    hits = W.STATS["registry_hits"]
    ChunkedCampaign(k, chunk=S)
    assert W.STATS["registry_hits"] == hits + 1
    W.clear_registry()


@needs_toolchain
def test_null_fault_is_inert_under_the_memmap(lifted):
    trace, meta = lifted
    k = TrialKernel(trace, device="cpu",
                    memmap=hd.memmap_from_meta(meta, device="cpu"))
    r = k._replay(null_fault("cpu"))
    assert not bool(r.trapped[0] | r.diverged[0] | r.detected[0])


@needs_toolchain
def test_device64_run_device_equals_reference():
    """``hostdiff``'s device64 mode: the pair-lane 64-bit lift (hi lanes
    at phys + 32) under its memmap, bits [0, 64), without escalation."""
    from shrewd_tpu_torch.ingest.lift64 import lift64

    captures = {}
    with shared_captures(hd, cache=captures):
        trace, meta = hd.capture_and_lift_to_output(
            hd.build_tools("workloads/sort.c"), lifter=lift64)
    assert int(meta["width"]) == 64 and trace.nphys == 64
    coords = hd.sample_coords(16, meta["window_macro_ops"], seed=2,
                              bit_range=64)
    assert (coords[:, 2] >= 32).any()
    rep, rrep = {}, {}
    got = hd.run_device(trace, meta, coords, resolve_diverged=False,
                        report=rep, device="cpu")
    ref = ref_hd.run_device(RefTrace(*trace), meta, coords,
                            resolve_diverged=False, report=rrep)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert rep == rrep and rep["device_memmap"] is True
