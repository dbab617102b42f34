"""Card tests of the port's Hopper kernels (``ops/taint_cuda.py``): the
fast pass (K1) and the chunk kernel (K2) with the chunked path around it;
and of the tier kernels (cache, MESI, NoC), whose step loops and scatters
on the card must give their CPU outcomes.

Each test needs a CUDA card and skips without one.  They import torch and
the port only (no JAX), so on a machine with the card run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax).  Each kernel is held
bitwise against its plain PyTorch version on the same device tensors.
"""

import shutil

import numpy as np
import pytest
import torch

from shrewd_tpu_torch import compat, native
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops import taint_cuda
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
from shrewd_tpu_torch.ops.replay import TraceArrays
from shrewd_tpu_torch.ops.taint import (record_golden, setup_gather,
                                        taint_chunk, taint_fast_plain)
from shrewd_tpu_torch.ops.taint_cuda import taint_chunk_cuda, taint_fast_cuda
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda

# --- constructions shared with tests/test_torch_quiet.py (no card needed) ---

STEP_FIELDS = ("a", "b", "ea", "res", "st_old", "dst_old", "wr", "is_ld",
               "is_st")


def _middle(mask: np.ndarray) -> int:
    at = np.nonzero(mask)[0]
    return int(at[len(at) // 2])


def loud_trace(trace, how: str):
    """``trace`` (the port's ``Trace``) with one step made loud before
    recording → (trace, that step).  ``misaligned_load``: the middle
    load's ``imm`` plus one, so its address traps (it still reads the same
    word, so no later value changes); ``divu_by_zero``: the middle µop
    that writes 0 becomes a DIVU by a register that holds 0 there (#DE; it
    still writes 0); ``taken_off_branch``: ``taken`` set on the middle
    non-branch µop, which then diverges."""
    if how == "misaligned_load":
        j = _middle(U.is_load(trace.opcode))
        imm = trace.imm.copy()
        imm[j] += np.uint32(1)
        return trace._replace(imm=imm), j
    if how == "taken_off_branch":
        j = _middle(~U.is_branch(trace.opcode))
        taken = trace.taken.copy()
        taken[j] = 1
        return trace._replace(taken=taken), j
    assert how == "divu_by_zero", how
    tr = TraceArrays.from_trace(trace, "cpu")
    gold = record_golden(tr, torch.as_tensor(trace.init_reg.astype(np.int64)),
                         torch.as_tensor(trace.init_mem.astype(np.int64)),
                         False, reg_timeline=True)
    zero_reg = (gold.reg_t == 0).numpy()
    j = _middle(gold.wr.numpy() & ~gold.is_ld.numpy()
                & (gold.res == 0).numpy() & zero_reg.any(1))
    opcode, src2 = trace.opcode.copy(), trace.src2.copy()
    opcode[j] = U.DIVU
    src2[j] = int(np.argmax(zero_reg[j]))
    return trace._replace(opcode=opcode, src2=src2), j


def wrong_record(gold, how: str):
    """``gold`` with one step's values changed, so that the step is loud
    by a clause no consistent record fires → (record, that step).
    ``write``: the middle register write records another result (the
    writeback upserts); ``escape``: the middle load records another word
    (the load escapes); ``store``: the middle store records another word
    (the store upserts)."""
    if how == "write":
        j = _middle((gold.wr & ~gold.is_ld).cpu().numpy())
        res = gold.res.clone()
        res[j] ^= 1
        return gold._replace(res=res), j
    assert how in ("escape", "store"), how
    j = _middle((gold.is_ld if how == "escape" else gold.is_st).cpu().numpy())
    ea = gold.ea.clone()
    ea[j] ^= 4
    return gold._replace(ea=ea), j


def step_by_step(gold, tr, shadow_cov, faults, gold_at_fault, alt1, alt2,
                 tags0, vals0, k: int = 16, may_latch: bool = True):
    """The plain chunk scan taken one µop at a time: each step is a
    ``taint_chunk`` over that µop alone, from the sets the step before
    left and with the fault coordinates shifted to it → (the result as
    ``taint_chunk`` gives it for the whole chunk, the sets before each
    step ``[n, B, k]``, each lane's liveness before each step ``[n,
    B]``)."""
    B = faults.kind.shape[0]
    regfile = faults.kind == 1
    tags, vals = tags0.clone(), vals0.clone()
    live = torch.ones(B, dtype=torch.bool, device=tags.device)
    steps = torch.full((B,), tr.n, dtype=torch.int32, device=tags.device)
    flags = [torch.zeros_like(live) for _ in range(5)]
    before, alive = [], []
    for i in range(tr.n):
        before.append(tags)
        alive.append(live)
        one = slice(i, i + 1)
        f_i = faults._replace(
            cycle=torch.where(regfile, faults.cycle - i, faults.cycle),
            entry=torch.where(regfile, faults.entry, faults.entry - i))
        g_i = gold._replace(reg_t=None, mem_t=None, **{
            x: getattr(gold, x)[one] for x in STEP_FIELDS})
        t_i, v_i, _, *fl = taint_chunk(
            g_i, type(tr)(*(x[one] for x in tr)), shadow_cov[one], f_i,
            gold_at_fault, alt1, alt2, tags, vals, k=k, may_latch=may_latch)
        stop = live & (fl[0] | fl[1] | fl[2] | fl[3] | fl[4])
        tags = torch.where(live[:, None], t_i, tags)
        vals = torch.where(live[:, None], v_i, vals)
        flags = [a | (live & b) for a, b in zip(flags, fl)]
        steps = torch.where(stop, i + 1, steps)
        live = live & ~stop
    return ((tags, vals, steps, *flags), torch.stack(before),
            torch.stack(alive))


def hit_counts(gold, tr, faults, before, alive) -> torch.Tensor:
    """``(2, B)``: per lane, the quiet steps other than its landing that
    it takes live with a non-empty set whose tags (src1, src2, dst, the
    memory word of a golden load or store) hit the set (row 0) or miss it
    (row 1) — what the kernels' ``counts`` output counts, from the sets
    of ``step_by_step``."""
    n = tr.n
    kind = faults.kind.to(torch.int64)
    land = torch.where(kind == 1, faults.cycle.to(torch.int64),
                       torch.where((kind >= 2) & (kind <= 9),
                                   faults.entry.to(torch.int64), -1))
    nphys, mem_words = gold.final_reg.shape[0], gold.final_mem.shape[0]
    mem = gold.is_ld | gold.is_st
    mtag = torch.where(mem, nphys + ((gold.ea >> 2) & (mem_words - 1)), -2)
    present = before != -1
    touch = torch.zeros_like(alive)
    for t in (tr.src1, tr.src2, tr.dst, mtag):
        touch |= (present & (before == t[:, None, None])).any(2)
    steps_i = torch.arange(n, device=land.device)[:, None]
    taken = (alive & present.any(2) & (land[None, :] != steps_i)
             & taint_cuda.quiet_steps(gold, tr)[:, None])
    return torch.stack([(taken & touch).sum(0), (taken & ~touch).sum(0)])


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


# --- step skipping: loud steps, null and converging lanes ---------------

@pytest.fixture
def loud_kernel(cuda):
    """A window with one loud step: the middle branch's ``taken`` inverted
    before recording, so every lane live there with an empty set
    diverges at it."""
    t = native.generate_trace(seed=5, n=512, nphys=64, mem_words=1024,
                              working_set_words=256)
    br = np.nonzero(U.is_branch(t.opcode))[0]
    j = int(br[len(br) // 2])
    taken = t.taken.copy()
    taken[j] ^= 1
    kernel = TrialKernel(t._replace(taken=taken),
                         O3Config(shadow_coverage=[0.5] * 7), device=cuda)
    quiet = taint_cuda.quiet_steps(kernel.golden_rec, kernel.tr)
    assert torch.nonzero(~quiet).flatten().tolist() == [j]
    return kernel, j


@pytest.mark.parametrize("k", [16, 4])
def test_kernels_match_plain_on_a_loud_window(loud_kernel, k):
    kernel, j = loud_kernel
    got, ref = _both(kernel, _mixed(kernel, 2048, 13), k, True)
    _assert_equal(got, ref)
    assert bool((got.steps == j + 1).any())
    # K2 on the chunk holding the loud step, a third of the lanes carried
    c = j // 200
    args = _chunk_args(kernel, 200, c, 1000, k, 31)
    got = taint_chunk_cuda(*args, k=k, may_latch=True)
    torch.cuda.synchronize()
    ref = taint_chunk(*args, k=k, may_latch=True)
    for a, b in zip(got, ref):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    assert bool((got[2] == j - c * 200 + 1).any())


def test_chunk_kernel_on_null_and_converging_lanes(kernel):
    """A wave as the chunked driver builds it: regfile lanes landing in
    the chunk (most of them converge: their set empties and they jump to
    the end) and null padding."""
    camp = ChunkedCampaign(kernel, chunk=256)
    tr, cov, gold = camp.chunk_record(0)
    keys = prng.trial_keys(prng.campaign_key(8), 384)
    f = kernel.sample_batch(keys, "regfile")
    f = f._replace(cycle=torch.where(f.cycle < 256, f.cycle, -1))
    null = compat.fault_from_arrays(
        np.zeros(128, np.int64), np.full(128, -1), np.full(128, -1),
        np.zeros(128, np.int64), np.ones(128, np.float32), kernel.device)
    faults = type(f)(*(torch.cat([a, b]) for a, b in zip(f, null)))
    B, k = 512, kernel.cfg.taint_k
    reg0 = torch.as_tensor(camp.gb_reg[0].astype(np.int64),
                           device=kernel.device)
    tags0 = torch.full((B, k), -1, dtype=torch.int64, device=kernel.device)
    args = (gold, tr, cov, faults, *setup_gather(gold, tr, reg0, faults),
            tags0, torch.zeros_like(tags0))
    counts = torch.zeros((2, B), dtype=torch.int32, device=kernel.device)
    got = taint_chunk_cuda(*args, k=k, may_latch=False, counts=counts)
    torch.cuda.synchronize()
    ref = taint_chunk(*args, k=k, may_latch=False)
    for a, b in zip(got, ref):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    tags, steps = got[0], got[2]
    landed = (faults.cycle >= 0) & (faults.kind == 1)
    converged = landed & (tags == -1).all(1) & (steps == 256)
    assert bool(converged.any())
    assert bool((steps[384:] == 256).all()) and not bool(counts[:, 384:].any())
    # a lane takes each step at most once
    assert bool((counts.sum(0) <= steps).all())


@pytest.mark.parametrize("how", ["misaligned_load", "divu_by_zero",
                                 "taken_off_branch"])
def test_kernels_match_plain_on_other_loud_windows(cuda, how):
    """Windows made loud at one step by another clause than a branch
    (``loud_trace``): K1 over the window and K2 on the chunk that holds
    the step, bitwise against their plain versions."""
    t, j = loud_trace(native.generate_trace(
        seed=5, n=512, nphys=64, mem_words=1024, working_set_words=256), how)
    kernel = TrialKernel(t, O3Config(shadow_coverage=[0.5] * 7),
                         device=cuda)
    quiet = taint_cuda.quiet_steps(kernel.golden_rec, kernel.tr)
    assert torch.nonzero(~quiet).flatten().tolist() == [j]
    got, ref = _both(kernel, _mixed(kernel, 2048, 14), 16, True)
    _assert_equal(got, ref)
    assert bool((got.steps == j + 1).any())
    c = j // 200
    args = _chunk_args(kernel, 200, c, 1000, 16, 32)
    got = taint_chunk_cuda(*args, k=16, may_latch=True)
    torch.cuda.synchronize()
    ref = taint_chunk(*args, k=16, may_latch=True)
    for a, b in zip(got, ref):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    assert bool((got[2] == j - c * 200 + 1).any())


@pytest.mark.parametrize("how", ["write", "escape", "store"])
def test_kernels_match_plain_on_a_wrong_record(kernel, how):
    """A record loud at one step by a clause no consistent record fires
    (``wrong_record``): both kernels read it as their plain versions do."""
    gold, j = wrong_record(kernel.golden_rec, how)
    quiet = taint_cuda.quiet_steps(gold, kernel.tr)
    assert torch.nonzero(~quiet).flatten().tolist() == [j]
    faults = _mixed(kernel, 2048, 15)
    args = (gold, kernel.tr, kernel.shadow_cov, faults,
            *kernel._setup_batch(faults))
    kw = dict(k=16, compare_regs=kernel.cfg.compare_regs, may_latch=True)
    got = taint_fast_cuda(*args, **kw)
    torch.cuda.synchronize()
    _assert_equal(got, taint_fast_plain(*args, **kw))
    B = faults.kind.shape[0]
    sets = (torch.full((B, 16), -1, dtype=torch.int64, device=kernel.device),
            torch.zeros((B, 16), dtype=torch.int64, device=kernel.device))
    got = taint_chunk_cuda(*args, *sets, k=16, may_latch=True)
    torch.cuda.synchronize()
    for a, b in zip(got, taint_chunk(*args, *sets, k=16, may_latch=True)):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))


@pytest.mark.parametrize("k", [16, 4])
def test_hit_counts_equal_an_independent_count(kernel, k):
    """The kernels' ``counts`` output, which sets the bound in
    ``chip_smoke.py``, equals ``hit_counts`` of the plain scan taken one
    step at a time: K2 on a chunk with carried sets, K1 over the
    window."""
    args = _chunk_args(kernel, 200, 0, 256, k, 41)
    B = args[3].kind.shape[0]
    counts = torch.zeros((2, B), dtype=torch.int32, device=kernel.device)
    got = taint_chunk_cuda(*args, k=k, may_latch=True, counts=counts)
    torch.cuda.synchronize()
    chained, before, alive = step_by_step(*args, k=k, may_latch=True)
    for a, b in zip(got, chained):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    want = hit_counts(args[0], args[1], args[3], before, alive)
    assert torch.equal(counts.to(torch.int64), want)
    assert bool((want > 0).any(1).all())

    faults = _mixed(kernel, 256, 42)
    setup = kernel._setup_batch(faults)
    args = (kernel.golden_rec, kernel.tr, kernel.shadow_cov, faults, *setup)
    counts.zero_()
    got = taint_fast_cuda(*args, k=k, may_latch=True, counts=counts)
    torch.cuda.synchronize()
    sets = (torch.full((B, k), -1, dtype=torch.int64, device=kernel.device),
            torch.zeros((B, k), dtype=torch.int64, device=kernel.device))
    chained, before, alive = step_by_step(*args, *sets, k=k, may_latch=True)
    for field, b in zip(("tags", "vals", "steps"), chained):
        assert torch.equal(getattr(got, field).to(torch.int64),
                           b.to(torch.int64)), field
    want = hit_counts(args[0], args[1], faults, before, alive)
    assert torch.equal(counts.to(torch.int64), want)
    assert bool((want > 0).any(1).all())


# --- the O3 structures and the campaign loop ---------------------------------

STRUCTS = ("regfile", "fu", "rob", "iq", "lsq", "latch")


def _fupool_pair(cuda, **kw):
    """The same window and fupool config as a kernel on the card and one on
    the CPU."""
    t = native.generate_trace(seed=6, n=448, nphys=64, mem_words=1024,
                              working_set_words=256)
    cfg = O3Config(shadow_model="fupool", **kw)
    return (TrialKernel(t, cfg, device=cuda),
            TrialKernel(t, O3Config.from_dict(cfg.to_dict()), device="cpu"))


def test_residency_sampler_on_card_equals_cpu(cuda):
    from shrewd_tpu_torch.models.timing import ResidencySampler
    rng = np.random.default_rng(3)
    start = rng.integers(0, 1000, 500)
    sampler = ResidencySampler(start, start + rng.integers(0, 1 << 16, 500),
                               squashed_mass=1 << 20)
    keys = prng.trial_keys(prng.campaign_key(5, "cpu"), 8192)
    got = sampler.sample(keys.to(cuda))
    want = sampler.sample(keys)
    assert got[0].device.type == "cuda"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[0] == 500).any())


@pytest.mark.parametrize("structure", STRUCTS)
def test_structure_run_keys_on_card_equals_cpu(cuda, structure):
    """Faults drawn on the card equal the CPU's; K1 holds against its plain
    version on them (sentinel and bubble lanes included) and runs once per
    ``run_keys``, whose tally equals the CPU's."""
    card, cpu = _fupool_pair(cuda)
    keys = prng.trial_keys(prng.campaign_key(7, "cpu"), 1024)
    faults = card.sample_batch(keys.to(cuda), structure)
    for g, w in zip(faults, cpu.sample_batch(keys, structure)):
        assert torch.equal(g.cpu(), w)
    got, ref = _both(card, faults, 16, structure == "latch")
    _assert_equal(got, ref)
    before = taint_fast_cuda.launches
    tally = card.run_keys(keys.to(cuda), structure)
    assert taint_fast_cuda.launches == before + 1
    assert torch.equal(tally, cpu.run_keys(keys, structure))
    assert card.escapes == cpu.escapes


def test_budgeted_path_on_card_equals_cpu(cuda):
    card, cpu = _fupool_pair(cuda, escape_budget=8)
    keys = prng.trial_keys(prng.campaign_key(8, "cpu"), 1024)
    for s in ("fu", "lsq"):
        got, n = card.run_keys_stratified(keys.to(cuda), s)
        want, n_cpu = cpu.run_keys_stratified(keys, s)
        assert torch.equal(got, want) and int(n) == int(n_cpu) > 8


def test_run_until_ci_on_card_equals_cpu(cuda):
    from shrewd_tpu_torch.parallel import ShardedCampaign, run_until_ci
    card, cpu = _fupool_pair(cuda)
    kw = dict(seed=0, simpoint_id=0, structure_id=1, batch_size=256,
              target_halfwidth=0.03, min_trials=512)
    got = run_until_ci(ShardedCampaign(card, None, "fu", stratify=True),
                       **kw)
    want = run_until_ci(ShardedCampaign(cpu, None, "fu", stratify=True),
                        **kw)
    assert got.converged and got.batches >= 2
    np.testing.assert_array_equal(got.tallies, want.tallies)
    np.testing.assert_array_equal(got.strata_tallies, want.strata_tallies)
    assert (got.trials, got.batches) == (want.trials, want.batches)
    assert tuple(got.avf_interval) == tuple(want.avf_interval)


# --- the campaign orchestrator ----------------------------------------------

def _tiny_plan(mode: str, stratify: bool):
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, WorkloadSpec
    from shrewd_tpu_torch.trace.synth import WorkloadConfig
    plan = CampaignPlan(
        simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
            n=96, nphys=32, mem_words=64, working_set_words=32, seed=7))],
        structures=["regfile", "fu"], batch_size=32, target_halfwidth=0.08,
        max_trials=2048, min_trials=64, stratify=stratify,
        checkpoint_every=2)
    plan.machine.shadow_model = "fupool"
    plan.resilience.backoff_base = 0.0
    plan.pipeline.sync_every = 4 if mode == "sync" else 1
    plan.pipeline.until_ci = mode == "until"
    return plan


@pytest.mark.parametrize("mode", ["serial", "sync", "until"])
@pytest.mark.parametrize("stratify", [False, True])
def test_orchestrator_on_card_equals_cpu(cuda, tmp_path, mode, stratify):
    """The same plan on the card and on the CPU: the same results,
    checkpoint state and integrity document; every batch on the device
    tier, K1 launched, its plain version never called on the card."""
    import json
    import os

    from shrewd_tpu_torch import stats
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

    docs = []
    plain_calls = []
    orig = taint_cuda.taint_fast_plain

    def counted(*a, **kw):
        plain_calls.append(a[3].kind.device.type)
        return orig(*a, **kw)

    taint_cuda.taint_fast_plain = counted
    try:
        for dev in (cuda, "cpu"):
            before = taint_fast_cuda.launches
            orch = Orchestrator(_tiny_plan(mode, stratify),
                                outdir=str(tmp_path / str(dev)), device=dev)
            list(orch.events())
            orch.checkpoint()
            with open(os.path.join(orch.outdir, "campaign_ckpt",
                                   "campaign.json")) as f:
                doc = json.load(f)
            docs.append((doc["state"], doc["integrity"],
                         sorted((k, r.tallies.tolist(), r.trials,
                                 tuple(r.avf_interval))
                                for k, r in orch.results.items())))
            if dev is cuda:
                assert taint_fast_cuda.launches > before
                res = stats.to_dict(orch.stats)["resilience"]
                assert res["tier_trials"]["cpu"] == 0
                assert res["tier_trials"]["oracle"] == 0
                assert res["tier_trials"]["device"] > 0
    finally:
        taint_cuda.taint_fast_plain = orig
    assert "cuda" not in plain_calls
    assert docs[0] == docs[1]


def test_interval_stays_on_the_card_until_materialized(cuda):
    from shrewd_tpu_torch.parallel import ShardedCampaign
    card, cpu = _fupool_pair(cuda)
    keys = [prng.trial_keys(prng.campaign_key(20 + i, "cpu"), 512)
            for i in range(3)]
    camp = ShardedCampaign(card, None, "fu", stratify=True,
                           integrity_check=True)
    h = camp.dispatch_interval([k.to(cuda) for k in keys])
    acc, n_unres = h.out
    assert acc.device.type == "cuda" and n_unres.device.type == "cuda"
    assert isinstance(h.event, torch.cuda.Event)
    assert camp.transfers == 0
    tally, strata = camp.materialize_interval(h)
    assert camp.transfers == 1
    serial = ShardedCampaign(cpu, None, "fu", stratify=True)
    want = sum(serial.tally_batch_stratified(k).numpy().astype(np.int64)
               for k in keys)
    np.testing.assert_array_equal(strata, want)
    np.testing.assert_array_equal(tally, want.sum(0))
    h = camp.dispatch_until_ci([k.to(cuda) for k in keys], np.zeros(4), None,
                               0, 0, 1.0, 0.95, True)
    assert h.out[0].device.type == "cuda" and h.out[3].device.type == "cuda"
    _, _, consumed, hw = camp.materialize_until_ci(h)
    assert consumed == 1 and hw.shape == (1,)


@pytest.mark.parametrize("mode", ["serial", "sync", "until"])
def test_k1_launch_failure_raises_out_of_the_orchestrator(cuda, tmp_path,
                                                          monkeypatch, mode):
    """A K1 that fails to launch ends a campaign on the card with its own
    error: the ladder has the device tier alone, so no batch moves to the
    CPU or the host oracle, and no batch is believed."""
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.ops import trial

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: the launch failed")

    monkeypatch.setattr(trial, "taint_fast_cuda", broken)
    orch = Orchestrator(_tiny_plan(mode, True), outdir=str(tmp_path),
                        device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        list(orch.events())
    for st in orch.state.values():
        assert st.tier_trials.tolist() == [0, 0, 0] and st.next_batch == 0


# --- the device mesh and the chaos engine on the card ----------------------

def test_sharded_campaign_on_the_card_mesh_equals_a_cpu_mesh(cuda):
    """``make_mesh()`` spans every visible card; a CPU mesh of the same
    size gives the same tallies on the budgeted, stratified, interval and
    until-CI steps, with the shard-vs-sum check on."""
    from shrewd_tpu_torch.parallel import ShardedCampaign
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    card, cpu = _fupool_pair(cuda, escape_budget=4)
    mesh = make_mesh()
    assert [d.type for d in mesh.devices] == ["cuda"] * mesh.size
    cpu_mesh = make_mesh(["cpu"] * mesh.size)
    n = 512 * mesh.size
    keys = [prng.trial_keys(prng.campaign_key(30 + i, "cpu"), n)
            for i in range(3)]
    got = ShardedCampaign(card, mesh, "fu", stratify=True,
                          integrity_check=True)
    want = ShardedCampaign(cpu, cpu_mesh, "fu", stratify=True,
                           integrity_check=True)
    assert torch.equal(got.tally_batch(keys[0].to(cuda)),
                       want.tally_batch(keys[0]))
    assert torch.equal(got.tally_batch_stratified(keys[1].to(cuda)),
                       want.tally_batch_stratified(keys[1]))
    for a, b in zip(got.tally_interval([k.to(cuda) for k in keys]),
                    want.tally_interval(keys)):
        np.testing.assert_array_equal(a, b)
    args = (np.zeros(4), None, 0, 0, 0.05, 0.95, True)
    a = got.materialize_until_ci(got.dispatch_until_ci(
        [k.to(cuda) for k in keys], *args))
    b = want.materialize_until_ci(want.dispatch_until_ci(keys, *args))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert (card.escapes, card.taint_trials) == (cpu.escapes,
                                                 cpu.taint_trials)
    assert got.shard_checks == want.shard_checks == 4


def _mixed_mesh_steps(got, want, keys, cuda, stratify: bool):
    """The budgeted (and stratified), interval and until-CI steps of a
    card+CPU mesh campaign against a 2-shard CPU mesh campaign; → the
    card+CPU interval's handle."""
    assert torch.equal(got.tally_batch(keys[0].to(cuda)),
                       want.tally_batch(keys[0]))
    if stratify:
        assert torch.equal(got.tally_batch_stratified(keys[1].to(cuda)),
                           want.tally_batch_stratified(keys[1]))
    handle = got.dispatch_interval([k.to(cuda) for k in keys])
    for a, b in zip(got.materialize_interval(handle),
                    want.tally_interval(keys)):
        np.testing.assert_array_equal(a, b)
    args = (np.zeros(4), None, 0, 0, 0.05, 0.95, stratify)
    a = got.materialize_until_ci(got.dispatch_until_ci(
        [k.to(cuda) for k in keys], *args))
    b = want.materialize_until_ci(want.dispatch_until_ci(keys, *args))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    return handle


def test_card_and_cpu_mesh_builds_replicas_and_equals_a_cpu_mesh(
        cuda, monkeypatch):
    """A mesh of the card and the CPU is a mesh of two distinct devices:
    the card kernel's replica takes the CPU shard (built once and cached),
    the two shards run on threads of their own, the interval records the
    card's event, and the budgeted (escape budget 1, exceeded in each
    shard), stratified, host-resolution, interval and until-CI steps give
    a 2-shard CPU mesh's tallies and escape counts, with the shard-vs-sum
    check on."""
    import threading

    from shrewd_tpu_torch.parallel import ShardedCampaign
    from shrewd_tpu_torch.parallel.mesh import make_mesh, shard_keys
    card, cpu = _fupool_pair(cuda, escape_budget=1)
    mesh = make_mesh([cuda, "cpu"])
    got = ShardedCampaign(card, mesh, "fu", stratify=True,
                          integrity_check=True)
    want = ShardedCampaign(cpu, make_mesh(["cpu", "cpu"]), "fu",
                           stratify=True, integrity_check=True)
    rep = got.kernels[1]
    assert got.kernels[0] is card and rep is not card
    assert rep.device.type == "cpu" and card.on_device("cpu") is rep
    assert ShardedCampaign(card, mesh, "fu").kernels[1] is rep
    threads = {}
    for k in got.kernels:
        def spy(*a, _f=k.tally_on_device, _d=k.device.type, **kw):
            threads.setdefault(_d, set()).add(threading.get_ident())
            return _f(*a, **kw)
        monkeypatch.setattr(k, "tally_on_device", spy)
    keys = [prng.trial_keys(prng.campaign_key(40 + i, "cpu"), 1024)
            for i in range(3)]
    handle = _mixed_mesh_steps(got, want, keys, cuda, stratify=True)
    assert isinstance(handle.event, torch.cuda.Event)
    assert [t.device.type for t in handle.locals] == ["cuda", "cpu"]
    assert threading.get_ident() not in threads["cuda"] | threads["cpu"]
    for k, s in zip(got.kernels, shard_keys(mesh, keys[0])):
        assert int(k.tally_on_device(s, "fu")[1]) > 1     # over budget
    assert card.escapes == cpu.escapes
    assert card.taint_trials == cpu.taint_trials
    assert got.shard_checks == want.shard_checks == 4
    host = ShardedCampaign(card, mesh, "fu", resolution="host")
    assert torch.equal(
        host.tally_batch(keys[0].to(cuda)),
        ShardedCampaign(cpu, make_mesh(["cpu", "cpu"]), "fu",
                        resolution="host").tally_batch(keys[0]))
    assert (card.escapes, card.taint_trials) == (cpu.escapes,
                                                 cpu.taint_trials)


def test_tier_kernel_on_a_card_and_cpu_mesh_equals_a_cpu_mesh(cuda):
    """A tier kernel (the cache's data array) on a card+CPU mesh: its CPU
    replica takes the second shard, and every step gives a 2-shard CPU
    mesh's tallies."""
    from shrewd_tpu_torch.parallel import ShardedCampaign
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    card, cpu = _tier_pair(cuda, "cache")
    got = ShardedCampaign(card, make_mesh([cuda, "cpu"]), "data",
                          stratify=True, integrity_check=True)
    want = ShardedCampaign(cpu, make_mesh(["cpu", "cpu"]), "data",
                           stratify=True, integrity_check=True)
    assert got.kernels[1] is not card and got.kernels[1].device.type == "cpu"
    keys = [prng.trial_keys(prng.campaign_key(50 + i, "cpu"), 1024)
            for i in range(3)]
    _mixed_mesh_steps(got, want, keys, cuda, stratify=True)
    assert got.shard_checks == want.shard_checks == 4


def _chaos_plan(faults):
    import json
    plan = _tiny_plan("serial", True)
    plan.chaos.spec = json.dumps({"faults": faults})
    plan.resilience.dispatch_timeout = 60.0
    return plan


def test_chaos_run_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    """A wedge, a transient device-tier error, a corrupted tally and a torn
    checkpoint, all survived: the card's results, chaos ledgers and
    integrity counters are the CPU run's.  The card survives all four on
    the device tier; the CPU re-dispatches the quarantined batch below the
    tier that produced it, on the host oracle (D1)."""
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    faults = [{"kind": "wedge", "at_batch": 0},
              {"kind": "backend_error", "at_batch": 1, "tier": "device"},
              {"kind": "corrupt_tally", "at_batch": 2},
              {"kind": "torn_checkpoint", "at_ckpt": 1}]
    got = []
    for dev in (cuda, "cpu"):
        orch = Orchestrator(_chaos_plan(faults),
                            outdir=str(tmp_path / str(dev)), device=dev)
        events = list(orch.events())
        assert events[-1][0].name == "CAMPAIGN_COMPLETE"
        mon = orch.monitor
        got.append((sorted((k, r.tallies.tolist(), r.trials)
                           for k, r in orch.results.items()),
                    orch.chaos.injected, orch.chaos.survived,
                    (mon.quarantined, mon.recovered, mon.requeues),
                    [int(st.tier_trials.sum())
                     for st in orch.state.values()]))
        tiers = [st.tier_trials.tolist() for st in orch.state.values()]
        below = sum(t[1] + t[2] for t in tiers)
        assert below == (0 if dev is cuda else 32), tiers
    assert got[0] == got[1]
    assert got[0][1] == got[0][2] == {"wedge": 1, "backend_error": 1,
                                      "corrupt_tally": 1,
                                      "torn_checkpoint": 1}


def test_permanent_device_fault_raises_out_of_the_orchestrator(cuda,
                                                               tmp_path):
    """On the card the ladder is the device tier alone (ROADMAP Queue 3
    D1): a permanent device-tier fault exhausts its retries and raises
    out of ``events()``, where a CPU campaign descends to the oracle."""
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.resilience import LadderExhausted
    plan = _chaos_plan([{"kind": "backend_error", "at_batch": 1,
                         "tier": "device", "permanent": True}])
    orch = Orchestrator(plan, outdir=str(tmp_path / "card"), device=cuda)
    with pytest.raises(LadderExhausted, match="chaos: injected device"):
        list(orch.events())
    assert orch.chaos.injected == {"backend_error": 1}
    assert not orch.chaos.survived
    cpu = Orchestrator(_chaos_plan([{"kind": "backend_error",
                                     "at_batch": 1, "tier": "device",
                                     "permanent": True}]), device="cpu")
    assert list(cpu.events())[-1][0].name == "CAMPAIGN_COMPLETE"
    assert cpu.chaos.survived == {"backend_error": 1}


# --- the tier structures (cache, MESI, NoC) -------------------------------

def _tier_pair(cuda, tier: str):
    """(card kernel, CPU kernel) of one tier at a small size."""
    from shrewd_tpu_torch.models import mesi as M
    from shrewd_tpu_torch.models import noc as N
    from shrewd_tpu_torch.models import ruby as R
    if tier == "cache":
        t = native.generate_trace(seed=5, n=512, nphys=64, mem_words=1024,
                                  working_set_words=256)
        tl, _ = R.simulate_cache(R.golden_access_stream(t), R.CacheConfig(),
                                 t.n)
        return (R.CacheKernel(tl, R.CacheConfig(), device=cuda),
                R.CacheKernel(tl, R.CacheConfig(), device="cpu"))
    cfg = M.MesiConfig(n_cores=4)
    tr = M.torture_stream(cfg, 96, 64, seed=3, sharing=0.6)
    mem = np.random.default_rng(9).integers(0, 1 << 32, 64,
                                            dtype=np.uint64).astype(np.uint32)
    if tier == "mesi":
        return (M.MesiKernel(tr, cfg, mem, device=cuda),
                M.MesiKernel(tr, cfg, mem, device="cpu"))
    ncfg = N.NocConfig(vcs_per_vnet=1, buffers_per_data_vc=1,
                       buffers_per_ctrl_vc=1)
    msgs = N.build_message_trace(tr, cfg, ncfg)
    return (N.NocKernel(msgs, ncfg, device=cuda),
            N.NocKernel(msgs, ncfg, device="cpu"))


@pytest.mark.parametrize("structure", [
    "cache:data", "cache:tag", "cache:state", "mesi:state", "mesi:tag",
    "mesi:dir", "mesi:tbe", "noc:router"])
def test_tier_kernel_on_card_equals_cpu(cuda, structure):
    """Per-key outcomes and the stratified tally of each tier kernel on the
    card equal its CPU outcomes for the same keys (scatters, first-index
    choices and searchsorted alike on both devices)."""
    tier, sub = structure.split(":")
    card, cpu = _tier_pair(cuda, tier)
    keys = prng.trial_keys(prng.campaign_key(11, "cpu"), 2048)
    got = card.outcomes_from_keys(keys.to(cuda), sub)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  cpu.outcomes_from_keys(keys, sub).numpy())
    tally, n_unres = card.tally_on_device(keys.to(cuda), sub,
                                          stratified=True)
    assert tally.device.type == "cuda" and int(n_unres) == 0
    np.testing.assert_array_equal(
        tally.cpu().numpy(), cpu.run_keys_stratified(keys, sub)[0].numpy())


def test_noc_pipeline_on_card_equals_cpu(cuda):
    """The flit pipeline on lanes of every pipeline type, some starved by
    a lost credit."""
    from shrewd_tpu_torch.models import noc as N
    card, cpu = _tier_pair(cuda, "noc")
    rng = np.random.default_rng(4)
    n = 256
    co = [rng.integers(0, 4, n), rng.integers(0, card.n_cycles, n),
          np.repeat(N.PIPELINE_TYPES, n // 4), rng.integers(0, 2, n)]
    d, c = N.flit_sim(card.msgs, card.cfg, N.NocFault(
        *(torch.as_tensor(x, device=cuda) for x in co)), card._horizon)
    dc, cc = N.flit_sim(cpu.msgs, cpu.cfg, N.NocFault(
        *(torch.as_tensor(x) for x in co)), cpu._horizon)
    np.testing.assert_array_equal(d.cpu().numpy(), dc.numpy())
    np.testing.assert_array_equal(c.cpu().numpy(), cc.numpy())
    assert (dc < 0).any()


@pytest.mark.parametrize("mode", ["serial", "until"])
def test_tier_plan_on_card_equals_cpu(cuda, tmp_path, mode):
    """A plan naming all six tier structures through the Orchestrator on
    the card and on the CPU: the same results and checkpoint state, every
    batch on the device tier, the seed canaries passed."""
    import json
    import os

    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

    docs = []
    for dev in (cuda, "cpu"):
        plan = _tiny_plan(mode, True)
        plan.structures = ["cache:data", "cache:tag", "cache:state",
                           "mesi:state", "mesi:tag", "noc:router"]
        plan.coherence_accesses = 48
        orch = Orchestrator(plan, outdir=str(tmp_path / str(dev)),
                            device=dev)
        evs = list(orch.events())
        assert evs[-1][0].name == "CAMPAIGN_COMPLETE"
        orch.checkpoint()
        with open(os.path.join(orch.outdir, "campaign_ckpt",
                               "campaign.json")) as f:
            doc = json.load(f)
        assert doc["integrity"]["canary_failures"] == 0
        assert doc["integrity"]["canary_runs"] > 0
        for per in doc["state"].values():
            for st in per.values():
                assert st["tier_trials"][1:] == [0, 0]
        docs.append((doc["state"], doc["integrity"],
                     sorted((k, r.tallies.tolist(), r.trials)
                            for k, r in orch.results.items())))
    assert docs[0] == docs[1]


# --- real workload binaries: memmap replay, lifted windows, hostdiff ---------

needs_toolchain = pytest.mark.skipif(
    any(shutil.which(x) is None for x in ("gcc", "g++", "objdump", "nm")),
    reason="host toolchain required")


@pytest.fixture(scope="module")
def sort_ingest(tmp_path_factory):
    """``workloads/sort.c`` ingested at the reference test's axes with the
    preprocess stage (chunk 512) → (store, the window traces)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.pipeline import IngestPipeline
    from shrewd_tpu_torch.ingest.store import ArtifactStore
    from shrewd_tpu_torch.trace import format as tf

    root = tmp_path_factory.mktemp("sort_ingest")
    store = ArtifactStore(str(root / "store"))
    digest = store.put_binary(open(hd.build_tools(
        "workloads/sort.c").workload, "rb").read())
    pipe = IngestPipeline(str(root / "t"), store, digest, axes={
        "interval": 1500, "k": 2, "max_steps": 20000, "preprocess": True,
        "chunk": 512})
    plan = pipe.run()
    return store, [tf.load(store.payload_path(digest, pipe.key,
                                              e["file"]))[0]
                   for e in plan["simpoints"]]


@pytest.fixture(scope="module")
def sort_output_lift():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shrewd_tpu_torch.ingest import hostdiff as hd
    return hd.capture_and_lift_to_output(hd.build_tools("workloads/sort.c"))


@needs_toolchain
def test_memmap_replay_on_card_equals_cpu(cuda, sort_output_lift):
    """The VA-space trap model's (B, k) compares on the card: register
    and LSQ-address flips, every final state and flag equal to the CPU's;
    and ``hostdiff.run_device`` on the card equals it on the CPU."""
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.models.o3 import KIND_LSQ_ADDR

    trace, meta = sort_output_lift
    rng = np.random.default_rng(8)
    mem = np.nonzero(np.isin(trace.opcode, (U.LOAD, U.STORE)))[0]
    n = 512
    lsq = rng.random(n) < 0.5
    kind = np.where(lsq, KIND_LSQ_ADDR, 1)
    cycle = rng.integers(0, trace.n, n)
    entry = np.where(lsq, rng.choice(mem, n), rng.integers(0, 16, n))
    args = (kind, cycle, entry, rng.integers(0, 32, n), np.ones(n))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        k = TrialKernel(trace, O3Config(enable_shrewd=False), device=dev,
                        memmap=hd.memmap_from_meta(meta, device=dev))
        res[dev.type] = k._replay(compat.fault_from_arrays(*args,
                                                           device=dev))
    for f in ("reg", "mem", "detected", "trapped", "diverged"):
        assert torch.equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f
    assert bool(res["cpu"].trapped.any())
    coords = hd.sample_coords(256, meta["window_macro_ops"], seed=1)
    np.testing.assert_array_equal(
        hd.run_device(trace, meta, coords, resolve_diverged=False,
                      device=cuda),
        hd.run_device(trace, meta, coords, resolve_diverged=False,
                      device="cpu"))


@needs_toolchain
def test_k1_matches_plain_on_lifted_windows(cuda, sort_ingest):
    """K1 at the lifted windows' shapes (nphys 64, a lifted opcode mix):
    regfile lanes and lanes of every kind, bitwise its plain version; the
    hybrid campaign unit equals the dense scan and the C++ oracle."""
    _store, traces = sort_ingest
    for t in traces:
        kernel = TrialKernel(t, O3Config(), device=cuda)
        keys = prng.trial_keys(prng.campaign_key(0), 4096)
        got, ref = _both(kernel, kernel.sample_batch(keys, "regfile"), 16,
                         False)
        _assert_equal(got, ref)
        got, ref = _both(kernel, _mixed(kernel, 2048, 13), 16, True)
        _assert_equal(got, ref)
        faults = kernel.sample_batch(keys[:512], "regfile")
        hybrid = kernel.run_batch_hybrid(faults, may_latch=False)
        np.testing.assert_array_equal(
            hybrid, kernel.run_batch(faults).cpu().numpy())
        np.testing.assert_array_equal(hybrid,
                                      kernel.oracle_outcomes(faults))


@needs_toolchain
def test_store_opened_chunked_k2_matches_plain(cuda, sort_ingest,
                                               monkeypatch):
    """``ChunkedCampaign(kernel, chunk=512, store=…)`` opens the window
    the preprocess stage stored (no rebuild), launches K2 on every fast
    wave, each launch bitwise its plain version, and gives the exact
    engine's outcomes."""
    from shrewd_tpu_torch.ops import chunked as chunked_mod, window as W

    store, traces = sort_ingest
    launches = []
    real = chunked_mod.taint_chunk_cuda

    def held(*a, **kw):
        got = real(*a, **kw)
        ref = taint_chunk(*a, **{x: v for x, v in kw.items()
                                 if x != "stream"})
        for x, y in zip(got, ref):
            assert torch.equal(x.to(torch.int64), y.to(torch.int64))
        launches.append(1)
        return got

    monkeypatch.setattr(chunked_mod, "taint_chunk_cuda", held)
    for t in traces:
        W.clear_registry()
        builds, hits = W.STATS["builds"], W.STATS["store_hits"]
        kernel = TrialKernel(t, O3Config(), device=cuda)
        camp = ChunkedCampaign(kernel, chunk=512, store=store)
        assert camp.engine == "taint" and camp.C >= 2
        assert (W.STATS["builds"], W.STATS["store_hits"]) == (builds,
                                                               hits + 1)
        keys = prng.trial_keys(prng.campaign_key(5), 512)
        exact_waves = []
        trial_chunk = camp._trial_chunk
        camp._trial_chunk = lambda *a: exact_waves.append(1) or \
            trial_chunk(*a)
        launches.clear()
        out = camp.outcomes_from_keys(keys, "regfile")
        # one K2 launch per fast wave; the fallback lanes' waves are the
        # exact engine's, counted in the same total
        assert launches and len(launches) == \
            camp.last_stats["waves"] - len(exact_waves)
        exact = ChunkedCampaign(TrialKernel(t, O3Config(), device="cpu"),
                                chunk=512, engine="exact")
        np.testing.assert_array_equal(out, exact.outcomes_from_keys(
            keys.cpu(), "regfile"))
    W.clear_registry()


@needs_toolchain
def test_hostdiff_cli_on_the_card(cuda, tmp_path):
    import contextlib
    import io
    import json

    from shrewd_tpu_torch.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["hostdiff", "--trials", "8", "--out",
                     str(tmp_path / "d.json")]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["trials", "host_avf", "device_avf", "avf_abs_err",
                          "agreement_exact", "agreement_vulnerable",
                          "cis_overlap"]
    rep = json.loads((tmp_path / "d.json").read_text())
    assert rep["device_memmap"] is True
    assert "diverged_resolution_failed" not in rep
    assert sum(rep.get("diverged_resolved", {}).values()) == \
        rep["escalated_total"]


@pytest.fixture(scope="module")
def sort_checkpoint(tmp_path_factory):
    """One capture of ``workloads/sort.c``'s marker window written as an
    ``m5.cpt`` with its sidecar → (checkpoint dir, binary, capture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.cpt import (snapshot_from_capture,
                                             write_arch_snapshot)
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    paths = hd.build_tools("workloads/sort.c")
    root = tmp_path_factory.mktemp("sort_cpt")
    cap = root / "win.bin"
    subprocess.run([str(paths.tracer), str(cap), f"{paths.begin:x}",
                    f"{paths.end:x}", "2000000", str(paths.workload)],
                   check=True, capture_output=True, text=True)
    nt = read_nativetrace(str(cap))
    cpt_dir = str(root / "cpt")
    write_arch_snapshot(cpt_dir, snapshot_from_capture(nt))
    return cpt_dir, str(paths.workload), nt


@needs_toolchain
def test_checkpoint_spec_campaign_on_card_equals_cpu(cuda, sort_checkpoint,
                                                     tmp_path):
    """A ``CheckpointSpec`` plan (the restored window, regfile and fu,
    stratified) gives the CPU's results and checkpoint state on the card,
    every batch on the device tier."""
    import json
    import os

    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, CheckpointSpec

    cpt_dir, binary, _ = sort_checkpoint
    plan = CampaignPlan(
        simpoints=[CheckpointSpec(name="cpt", cpt_dir=cpt_dir,
                                  binary=binary, max_steps=2000)],
        structures=["regfile", "fu"], batch_size=512, max_trials=1024,
        min_trials=1024, stratify=True, checkpoint_every=1)
    docs = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        o = Orchestrator(CampaignPlan.from_dict(plan.to_dict()),
                         device=dev, outdir=out)
        list(o.events())
        with open(os.path.join(out, "campaign_ckpt", "campaign.json")) as f:
            docs[dev] = json.load(f)["state"]
    assert docs["cuda"] == docs["cpu"]
    for st in docs["cuda"]["cpt"].values():
        assert st["tier_trials"][1:] == [0, 0] and sum(st["tallies"]) == 1024


def test_trace_cli_on_card_equals_cpu(cuda):
    """``trace`` records its golden record on the card by default: the
    same lines as ``--platform cpu``, value for value."""
    import contextlib
    import io

    from shrewd_tpu_torch.main import main

    outs = []
    for extra in ([], ["--platform", "cpu"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["trace", "-n", "64", "--all", *extra]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 64


@needs_toolchain
def test_check_trace_clean_on_the_cards_golden_record(cuda,
                                                      sort_checkpoint):
    """The card's golden record of the restored window: no divergence or
    trap, the capture's 16 GPRs after the same steps (masked to 32 bits),
    and every load clean against the independent store history."""
    from shrewd_tpu_torch.ingest.cpt import load_arch_snapshot
    from shrewd_tpu_torch.ingest.warm import window_from_snapshot_lifted
    from shrewd_tpu_torch.utils.memchecker import check_trace

    cpt_dir, binary, nt = sort_checkpoint
    n = len(nt.steps) - 1
    trace, meta = window_from_snapshot_lifted(load_arch_snapshot(cpt_dir),
                                              binary, max_steps=n)
    assert meta["emu_steps"] == n and meta["stats"]["lift_rate"] >= 0.95
    kernel = TrialKernel(trace, O3Config(enable_shrewd=False), device=cuda)
    g = kernel.golden
    assert not bool(g.diverged.any()) and not bool(g.trapped.any())
    want = nt.steps[n][:16].astype(np.uint64) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(g.reg[0, :16].cpu().numpy(),
                                  want.astype(np.int64))
    r = check_trace(trace, golden_record=kernel.golden_rec)
    assert r.n_violations == 0 and r.n_loads > 0, r.detail


# --- the protection search, the thermal network and the fleet --------------

def test_design_space_on_card_equals_cpu(cuda):
    """Seeded profiles, 6 structures × 4 schemes: the card's rates equal
    the CPU's (the same float32 products and left-to-right sums), and
    ``search`` gives the same assignment and front."""
    from shrewd_tpu_torch.search import protect as PS

    rng = np.random.default_rng(0)
    profiles = [PS.StructureProfile.from_tally(
        f"s{i}", int(rng.integers(64, 20000)), rng.integers(1, 400, 4),
        fit_per_bit=float(rng.uniform(1e-4, 1e-2))) for i in range(6)]
    schemes = [PS.NONE, PS.PARITY, PS.SECDED,
               PS.Scheme("shadow", 0.6, 0.0, 1.5, detect_sdc=0.45)]
    card = PS.DesignSpace(profiles, schemes=schemes, device=cuda)
    cpu = PS.DesignSpace(profiles, schemes=schemes, device="cpu")
    cfgs = cpu.enumerate()
    for a, b in zip(card.evaluate(cfgs), cpu.evaluate(cfgs)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-6)
    for target in (0.0, 1e-3):
        x, y = card.search(target), cpu.search(target)
        assert (x.feasible, x.assignment) == (y.feasible, y.assignment)
        assert [p[2] for p in x.pareto] == [p[2] for p in y.pareto]


def test_thermal_trajectory_on_card_equals_cpu(cuda):
    """A 4-node network over 2000 steps: the card's trajectory equals
    the CPU's within float32 LU (rtol 1e-5)."""
    from shrewd_tpu_torch.utils.thermal import ThermalNetwork

    def net():
        n = ThermalNetwork(n_nodes=4, ambient_c=45.0, step_s=0.005)
        for i in range(4):
            n.resistor(i, (i + 1) % 4, 0.8 + 0.1 * i)
            n.resistor(i, -1, 2.0 + 0.5 * i)
            n.capacitor(i, -1, 0.3 + 0.05 * i)
        return n

    power = np.random.default_rng(0).uniform(0.0, 6.0, (2000, 4))
    card = net().build(device=cuda).trajectory(power)
    cpu = net().build(device="cpu").trajectory(power)
    assert card.device.type == "cuda"
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-5)


def test_two_tenant_fleet_on_card_equals_solo_runs(cuda, tmp_path):
    """Two tenants on the card's mesh under ``fair``: each tenant's
    tallies equal its solo serial run on the card and the same fleet on
    the CPU; K1 launched, its plain version never called on the card."""
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    from shrewd_tpu_torch.service import CampaignScheduler, TenantSpec

    plans = {"a": _tiny_plan("serial", False),
             "b": _tiny_plan("sync", True)}
    plans["b"].seed = 5
    plain_calls = []
    orig = taint_cuda.taint_fast_plain

    def counted(*a, **kw):
        plain_calls.append(a[3].kind.device.type)
        return orig(*a, **kw)

    taint_cuda.taint_fast_plain = counted
    try:
        out = {}
        for dev in (cuda, "cpu"):
            before = taint_fast_cuda.launches
            sched = CampaignScheduler(outdir=str(tmp_path / str(dev)),
                                      mesh=make_mesh([dev]))
            for n, p in plans.items():
                sched.admit(TenantSpec(name=n, plan=p.to_dict()))
            assert sched.run() == 0
            out[str(dev)] = {n: {k: v.tolist() for k, v in
                                 sched.tenant_tallies(n).items()}
                             for n in plans}
            if dev is cuda:
                assert taint_fast_cuda.launches > before
        for n, p in plans.items():
            orch = Orchestrator(p, device=cuda)
            list(orch.events())
            assert out["cuda"][n] == {k: r.tallies.tolist()
                                      for k, r in orch.results.items()}
    finally:
        taint_cuda.taint_fast_plain = orig
    assert "cuda" not in plain_calls
    assert out["cuda"] == out["cpu"]
