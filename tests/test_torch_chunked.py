"""The pieces of the port's chunked replay against the JAX package's, on
the CPU.

Each piece of the slice is held against its reference on the same inputs
(carried across through ``shrewd_tpu_torch/compat.py``): the chunk record,
the setup gathers, the plain chunk scan (against the XLA ``taint_chunk``
and ``taint_chunk_pallas`` in interpret mode), the boundary states, the
dense scan chunk by chunk, and the pin of ``chip_smoke.py``'s chunked
gate.  ``tests/test_torch_chunked_campaign.py`` holds ``ChunkedCampaign``
itself.  Tolerance everywhere: exact.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models.o3 import KIND_LATCH_OP
from shrewd_tpu.models.o3 import Fault as RefFault
from shrewd_tpu.models.o3 import O3Config as RefConfig
from shrewd_tpu.ops import chunked as RC
from shrewd_tpu.ops import taint as RT
from shrewd_tpu.ops import window as RW
from shrewd_tpu.ops.pallas_taint import taint_chunk_pallas
from shrewd_tpu.ops.replay import TraceArrays as RefTraceArrays
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.trace.synth import WorkloadConfig, generate
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.ops import chunked as PC
from shrewd_tpu_torch.ops import replay as R
from shrewd_tpu_torch.ops import taint as T
from shrewd_tpu_torch.ops import taint_cuda
from shrewd_tpu_torch.ops import window as W
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.parallel.exec_cache import trace_digest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    assert jax.config.jax_threefry_partitionable
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


def mk_pair(n=384, seed=11, **cfg):
    """The same window and config in both packages (the reference's
    ``tests/test_chunked.py mk_kernel``)."""
    t = generate(WorkloadConfig(n=n, nphys=32, mem_words=64,
                                working_set_words=32, seed=seed))
    rcfg = RefConfig(**cfg)
    ref = RefKernel(t, rcfg)
    mine = TrialKernel(compat.trace_from_arrays(*t),
                       compat.config_from_dict(rcfg.to_dict()),
                       device="cpu")
    return ref, mine


def keys(seed, n):
    rk = ref_prng.trial_keys(ref_prng.campaign_key(seed), n)
    return rk, compat.keys_from_key_data(jax.random.key_data(rk), "cpu")


# --- pieces ------------------------------------------------------------------

class Chunk:
    """Chunk ``c`` of a preprocessed window, in both packages."""

    def __init__(self, n=300, S=100, c=1, seed=5):
        self.ref, self.mine = mk_pair(n=n, seed=seed)
        RW.clear_registry()
        self.rwin = RC.preprocess_window(self.ref, S)
        self.S, self.c = S, c
        lo, hi = c * S, (c + 1) * S
        trc = self.rwin.chunk_trace(c)
        self.trR = RefTraceArrays(**{f: jnp.asarray(trc[f])
                                     for f in RW.TRACE_FIELDS})
        self.goldR = RC._record_chunk(
            self.trR, jnp.asarray(self.rwin.gb_reg[c]),
            jnp.asarray(self.rwin.gb_mem[c]),
            jnp.asarray(self.rwin.gb_reg[c + 1]),
            jnp.asarray(self.rwin.gb_mem[c + 1]))
        self.tr = R.TraceArrays(**{
            f: torch.as_tensor(self.rwin.tr[f][lo:hi].astype(np.int64))
            for f in W.TRACE_FIELDS})

        def t(x):
            return torch.as_tensor(np.asarray(x).astype(np.int64))
        self.reg0, self.mem0 = t(self.rwin.gb_reg[c]), t(self.rwin.gb_mem[c])
        self.gold = T.record_chunk(self.tr, self.reg0, self.mem0,
                                   t(self.rwin.gb_reg[c + 1]),
                                   t(self.rwin.gb_mem[c + 1]))

    def faults(self, lanes, seed):
        """Chunk-local coordinates of every kind: a third of the lanes
        carried in (negative coordinates), some struck in other chunks
        (coordinates past the chunk), null padding lanes."""
        rng = np.random.default_rng(seed)
        S = self.S
        kind = rng.integers(1, 10, lanes).astype(np.int32)
        cycle = rng.integers(-S, 2 * S, lanes)
        entry = np.where(kind == 1, rng.integers(0, 32, lanes),
                         rng.integers(-S, 2 * S, lanes))
        null = rng.random(lanes) < 0.1
        kind[null] = 0
        cycle[null] = entry[null] = -1
        f = (kind, cycle.astype(np.int32), entry.astype(np.int32),
             rng.integers(0, 32, lanes).astype(np.int32),
             np.where(null, 1.0, rng.random(lanes)).astype(np.float32))
        return RefFault(*(jnp.asarray(x) for x in f)), \
            compat.fault_from_arrays(*f, "cpu")


@pytest.fixture(scope="module")
def chunk():
    return Chunk()


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_record_chunk_matches_reference(chunk):
    for name in ("a", "b", "ea", "res", "st_old", "dst_old", "wr", "is_ld",
                 "is_st", "final_reg", "final_mem"):
        _eq(getattr(chunk.gold, name), getattr(chunk.goldR, name))
    assert chunk.gold.reg_t is None and chunk.gold.mem_t is None


def test_record_chunk_pads_with_inert_nops():
    """The last chunk of a padded window records NOP columns that write
    nothing, as the reference's."""
    ch = Chunk(n=300, S=77, c=3)
    assert (np.asarray(ch.trR.opcode)[300 - 3 * 77:] == 0).all()
    for name in ("a", "ea", "res", "st_old", "dst_old", "wr"):
        _eq(getattr(ch.gold, name), getattr(ch.goldR, name))


@pytest.mark.parametrize("seed", [0, 1])
def test_setup_gather_matches_setup_scan(chunk, seed):
    fR, f = chunk.faults(256, seed)
    want = RT.setup_scan(chunk.trR, jnp.asarray(chunk.rwin.gb_reg[1]),
                         jnp.asarray(chunk.rwin.gb_mem[1]), fR)
    got = T.setup_gather(chunk.gold, chunk.tr, chunk.reg0, f)
    scan = T.setup_scan(chunk.tr, chunk.reg0, chunk.mem0, f)
    for w, a, b in zip(want, got, scan):
        _eq(a, w)
        _eq(b, w)
    # lanes whose flip is not in this chunk gather 0, as the scan leaves
    out = (f.cycle < 0) | (f.cycle >= chunk.S)
    assert bool(out.any()) and not got[0][out].any()


def seeded_sets(chunk, fR, k, seed):
    """Carried sets as the chunked driver hands them on: the sets chunk 0
    leaves (run by the reference from EMPTY), with holes punched in."""
    rng = np.random.default_rng(seed)
    B = fR.kind.shape[0]
    prev = Chunk(n=300, S=100, c=0)
    f0 = RefFault(kind=fR.kind, cycle=fR.cycle + chunk.S,
                  entry=jnp.where(fR.kind == 1, fR.entry,
                                  fR.entry + chunk.S),
                  bit=fR.bit, shadow_u=fR.shadow_u)
    setup0 = RT.setup_scan(prev.trR, jnp.asarray(prev.rwin.gb_reg[0]),
                           jnp.asarray(prev.rwin.gb_mem[0]), f0)
    cov = jnp.zeros(chunk.S, jnp.float32)
    tags, vals = jax.vmap(lambda f, s: RT.taint_chunk(
        prev.goldR, prev.trR, f, cov, jnp.full((k,), -1, jnp.int32),
        jnp.zeros((k,), jnp.uint32), k=k, setup=s)[:2])(f0, setup0)
    tags, vals = np.array(tags), np.array(vals)
    tags[rng.random(tags.shape) < 0.3] = -1
    # a quarter of the lanes arrive with a full set of register and memory
    # tags, so that the small sets overflow
    full = rng.random(B) < 0.25
    for lane in np.nonzero(full)[0]:
        tags[lane] = rng.choice(32 + 64, k, replace=False)
        vals[lane] = rng.integers(0, 1 << 32, k, dtype=np.uint32)
    assert (tags[:, 0] == -1).any() and (tags >= 32).any()
    return tags, vals


@pytest.mark.parametrize("k", [16, 4])
@pytest.mark.parametrize("may_latch", [True, False])
def test_taint_chunk_matches_xla_and_pallas(chunk, k, may_latch):
    fR, f = chunk.faults(128, 3)
    tags0, vals0 = seeded_sets(chunk, fR, k, 4)
    sc = np.random.default_rng(5).random(chunk.S).astype(np.float32) * 0.5
    setupR = RT.setup_scan(chunk.trR, jnp.asarray(chunk.rwin.gb_reg[1]),
                           jnp.asarray(chunk.rwin.gb_mem[1]), fR)
    xla = jax.vmap(lambda f_, t0, v0, s: RT.taint_chunk(
        chunk.goldR, chunk.trR, f_, jnp.asarray(sc), t0, v0, k=k,
        setup=s))(fR, jnp.asarray(tags0), jnp.asarray(vals0), setupR)
    trR = chunk.trR
    pal = taint_chunk_pallas(
        chunk.goldR, trR.opcode, trR.dst, trR.src1, trR.src2, trR.imm,
        trR.taken, jnp.asarray(sc), fR, *setupR, jnp.asarray(tags0).T,
        jnp.asarray(vals0).T, k=k, may_latch=may_latch, b_tile=128,
        interpret=True)
    t0, v0 = compat.sets_from_arrays(tags0, vals0, "cpu")
    setup = T.setup_gather(chunk.gold, chunk.tr, chunk.reg0, f)
    got = T.taint_chunk(chunk.gold, chunk.tr, torch.as_tensor(sc), f,
                        *setup, t0, v0, k=k, may_latch=may_latch)
    tags, vals, steps, det, trap, div, esc, ovf = got
    # the Pallas kernel: every field, every lane
    p_det, p_trap, p_div, p_esc, p_ovf, p_tags, p_vals = pal
    for a, w in ((det, p_det), (trap, p_trap), (div, p_div), (esc, p_esc),
                 (ovf, p_ovf), (tags, np.asarray(p_tags).T),
                 (vals, np.asarray(p_vals).T)):
        _eq(a, w)
    # the XLA scan always applies a LATCH_OP fault
    lanes = slice(None) if may_latch else \
        np.asarray(fR.kind) != KIND_LATCH_OP
    x = [np.asarray(v)[lanes] for v in xla]
    x_live = x.pop(2)
    for a, w in zip((tags, vals, det, trap, div, esc, ovf), x):
        np.testing.assert_array_equal(a.numpy()[lanes].astype(np.int64),
                                      w.astype(np.int64))
    # a lane live at the end ran every step
    assert (steps.numpy()[lanes][x_live] == chunk.S).all()
    assert bool((det | trap | div).any()) and bool(esc.any())
    if k == 4:
        assert bool(ovf.any())
    rt, rv = compat.sets_to_arrays(tags, vals)
    np.testing.assert_array_equal(rt, np.asarray(p_tags).T)
    np.testing.assert_array_equal(rv, np.asarray(p_vals).T)


def test_chunk_wrapper_runs_the_plain_version_for_cpu_tensors(chunk):
    fR, f = chunk.faults(64, 6)
    tags0, vals0 = seeded_sets(chunk, fR, 16, 7)
    t0, v0 = compat.sets_from_arrays(tags0, vals0, "cpu")
    args = (chunk.gold, chunk.tr, torch.zeros(chunk.S), f,
            *T.setup_gather(chunk.gold, chunk.tr, chunk.reg0, f), t0, v0)
    before = taint_cuda.taint_chunk_cuda.launches
    got = taint_cuda.taint_chunk_cuda(*args, k=16, may_latch=True)
    want = T.taint_chunk(*args, k=16, may_latch=True)
    assert taint_cuda.taint_chunk_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_boundary_states_match_reference():
    ref, mine = mk_pair(n=300, seed=5)
    RW.clear_registry()
    W.clear_registry()
    rwin = RC.preprocess_window(ref, 77)
    win = PC.preprocess_window(mine, 77)
    assert (win.n, win.S, win.C) == (rwin.n, rwin.S, rwin.C) == (300, 77, 4)
    assert win.trace_digest == rwin.trace_digest
    assert trace_digest(mine.trace) == rwin.trace_digest
    tr, gb_reg, gb_mem = compat.window_to_arrays(win)
    for f in W.TRACE_FIELDS:
        np.testing.assert_array_equal(tr[f], rwin.tr[f], err_msg=f)
        assert tr[f].dtype == rwin.tr[f].dtype
    np.testing.assert_array_equal(gb_reg, rwin.gb_reg)
    np.testing.assert_array_equal(gb_mem, rwin.gb_mem)
    back = compat.window_from_arrays(rwin.n, rwin.S, rwin.tr, rwin.gb_reg,
                                     rwin.gb_mem, rwin.trace_digest)
    np.testing.assert_array_equal(back.gb_mem, win.gb_mem)
    # the last boundary is the golden final state
    np.testing.assert_array_equal(gb_reg[-1], np.asarray(ref.golden.reg))
    np.testing.assert_array_equal(gb_mem[-1], np.asarray(ref.golden.mem))


def test_exact_chunks_equal_one_dense_pass():
    """The dense scan over a whole window equals the same scan chunk by
    chunk, each chunk starting from the lanes' carried state with the
    global µop index (``index_offset``), on every lane that does not
    freeze; a lane that does raises its flag in the chunked run too."""
    _, mine = mk_pair(n=300, seed=7)
    _, k = keys(3, 48)
    f = mine.sample_batch(k, "regfile")
    whole = R.replay(mine.tr, mine.init_reg, mine.init_mem, f,
                     mine.shadow_cov)
    reg, mem = mine.init_reg, mine.init_mem
    flags = [torch.zeros(48, dtype=torch.bool)] * 3
    for lo in range(0, 300, 77):
        hi = min(lo + 77, 300)
        tr = R.TraceArrays(*(x[lo:hi] for x in mine.tr))
        r = R.replay(tr, reg, mem, f, mine.shadow_cov[lo:hi],
                     index_offset=lo)
        assert r.reg.shape == (48, 32)
        reg, mem = r.reg, r.mem
        flags = [a | b for a, b in zip(flags, (r.detected, r.trapped,
                                              r.diverged))]
    want = (whole.detected, whole.trapped, whole.diverged)
    ok = ~(want[0] | want[1] | want[2])
    assert bool(ok.any()) and not bool(ok.all())
    assert torch.equal(reg[ok], whole.reg[ok])
    assert torch.equal(mem[ok], whole.mem[ok])
    for a, w in zip(flags, want):
        assert not bool(a[ok].any())
        assert bool(a[w].all())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chunked_pin_for_chip_smoke():
    """chip_smoke.py holds the taint engine's outcomes of 64 keys on its
    chunked window (``CHUNK_WINDOW``) against a constant: they must be
    the reference's."""
    smoke = _chip_smoke()
    t = ref_native.generate_trace(**smoke.CHUNK_WINDOW)
    rk = ref_prng.trial_keys(ref_prng.campaign_key(smoke.GATE_SEED),
                             smoke.N_GATE)
    ch = RC.ChunkedCampaign(RefKernel(t, RefConfig()), chunk=smoke.CHUNK,
                            engine="taint")
    out = ch.outcomes_from_keys(rk, "regfile")
    assert "".join(map(str, out.tolist())) == smoke.PIN_CHUNKED
