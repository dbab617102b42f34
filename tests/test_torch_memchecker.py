"""The port's memory-ordering checker against the JAX package's, on the
CPU (``utils/memchecker.py``; the reference's ``MemChecker`` readable-set
semantics, ``src/mem/mem_checker.hh``).

``expected_load_values`` and ``check_trace`` give the same loads, counts
and violation detail on synthetic windows, on a window restored from the
reference's literal checkpoint, on each package's own golden record, and
on an observed-load array with one word corrupted.  ``MemChecker``'s
overlapping-window cases record the same violations, and
``check_mesi_trace`` counts the same on each package's MESI stream and
golden loads.
"""

import gzip

import numpy as np
import pytest

from shrewd_tpu.ingest import cpt as RC
from shrewd_tpu.ingest import warm as RW
from shrewd_tpu.models import mesi as RM
from shrewd_tpu.models.o3 import O3Config as RefO3Config
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu.utils import memchecker as RMC
from shrewd_tpu_torch.ingest import cpt as PC
from shrewd_tpu_torch.ingest import warm as PW
from shrewd_tpu_torch.models import mesi as PM
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.trace import synth as psynth
from shrewd_tpu_torch.utils import memchecker as PMC
from test_ingest import _CPT_TEXT
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401


def _synth(n, seed):
    kw = dict(n=n, nphys=64, mem_words=256, working_set_words=64, seed=seed)
    return (psynth.generate(psynth.WorkloadConfig(**kw)),
            rsynth.generate(rsynth.WorkloadConfig(**kw)))


@pytest.fixture
def restored(tmp_path):
    """A synthetic window warmed over the literal checkpoint's state."""
    d = tmp_path / "cpt"
    d.mkdir()
    (d / "m5.cpt").write_text(_CPT_TEXT)
    with gzip.open(d / "system.physmem.store0.pmem", "wb") as f:
        f.write(bytes(range(32)))
    kw = dict(n=160, nphys=32, mem_words=64, working_set_words=32, seed=9)
    return (PW.window_from_snapshot(PC.load_arch_snapshot(str(d)),
                                    psynth.WorkloadConfig(**kw), 48),
            RW.window_from_snapshot(RC.load_arch_snapshot(str(d)),
                                    rsynth.WorkloadConfig(**kw), 48))


def _windows(restored):
    return [_synth(256, 4), _synth(128, 6), _synth(512, 11), restored]


def test_expected_load_values_equal_reference(restored):
    for mine, ref in _windows(restored):
        pi, pv = PMC.expected_load_values(mine)
        ri, rv = RMC.expected_load_values(ref)
        assert (pi.dtype, pv.dtype) == (ri.dtype, rv.dtype)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)
        assert pi.size > 0


def test_check_trace_on_each_golden_record(restored):
    """Each package's own golden record (the port's on the CPU here; the
    card's in tests/test_torch_cuda.py) checks clean, with the same
    counts."""
    for mine, ref in _windows(restored):
        got = PMC.check_trace(mine, golden_record=TrialKernel(
            mine, O3Config(), device="cpu").golden_rec)
        want = RMC.check_trace(ref, golden_record=RefKernel(
            ref, RefO3Config()).golden_rec)
        assert tuple(got) == tuple(want)
        assert got.n_violations == 0 and got.n_loads > 0


@pytest.mark.parametrize("which", [0, 1, -1])
def test_corrupted_word_gives_the_same_violation(restored, which):
    for mine, ref in _windows(restored):
        _, expected = RMC.expected_load_values(ref)
        observed = np.zeros(int((np.asarray(ref.opcode) ==
                                 RMC.U.LOAD).sum()), np.uint32)
        idx, _ = RMC.expected_load_values(ref)
        pos = np.searchsorted(np.nonzero(np.asarray(ref.opcode) ==
                                         RMC.U.LOAD)[0], idx)
        observed[pos] = expected
        observed[pos[which]] ^= np.uint32(0x40)
        got = PMC.check_trace(mine, observed_loads=observed)
        want = RMC.check_trace(ref, observed_loads=observed)
        assert tuple(got) == tuple(want)
        assert got.n_violations == 1
        assert got.first_violation == int(idx[which])
        assert "expected" in got.detail
    with pytest.raises(ValueError):
        PMC.check_trace(mine)


def _transactions(mod):
    """The reference tests' overlapping-window cases, on one checker."""
    mc = mod.MemChecker(np.array([7, 8, 9, 0], np.uint32))
    ok = []
    s = mc.start_write(0, 1, 0xAB)
    mc.complete_write(s, 1, 1)
    r = mc.start_read(2, 1)
    ok.append(mc.complete_read(r, 3, 1, 0xAB))
    r = mc.start_read(5, 1)
    ok.append(mc.complete_read(r, 6, 1, 0x8))           # stale initial
    s1 = mc.start_write(7, 2, 0x11)
    mc.complete_write(s1, 8, 2)
    s2 = mc.start_write(9, 2, 0x22)                      # overlaps r
    r = mc.start_read(10, 2)
    ok.append(mc.complete_read(r, 11, 2, 0x22))
    r_old = mc.start_read(10, 2)
    ok.append(mc.complete_read(r_old, 11, 2, 0x11))      # still legal
    mc.complete_write(s2, 20, 2)
    r = mc.start_read(21, 2)
    ok.append(mc.complete_read(r, 22, 2, 0x11))          # now stale
    r = mc.start_read(0, 3)
    ok.append(mc.complete_read(r, 1, 3, 0))
    r = mc.start_read(23, 0)
    ok.append(mc.complete_read(r, 24, 0, 7))
    w = mc.start_write(25, 3, -1)                        # masked to 32 bits
    r = mc.start_read(26, 3)
    ok.append(mc.complete_read(r, 27, 3, 0xFFFFFFFF))
    mc.complete_write(w, 28, 3)
    return ok, list(mc.violations)


def test_transaction_windows_equal_reference():
    mine, ref = _transactions(PMC), _transactions(RMC)
    assert mine == ref
    assert mine[0] == [True, False, True, True, False, True, True, True]
    for mod in (PMC, RMC):
        mc = mod.MemChecker()
        with pytest.raises(KeyError):
            mc.complete_write(99, 1, 0)
        with pytest.raises(KeyError):
            mc.complete_read(99, 1, 0, 0)
        r = mc.start_read(0, 1)
        mc.complete_read(r, 1, 1, 5)
        with pytest.raises(mod.MemoryViolation):
            mc.assert_clean()


@pytest.mark.parametrize("seed,n", [(2, 128), (5, 300)])
def test_check_mesi_trace_equals_reference(seed, n):
    init = np.arange(64, dtype=np.uint32)
    pcfg, rcfg = PM.MesiConfig(), RM.MesiConfig()
    mine = PM.torture_stream(pcfg, n, mem_words=64, seed=seed)
    ref = RM.torture_stream(rcfg, n, mem_words=64, seed=seed)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(mine, f)),
                                      np.asarray(getattr(ref, f)))
    ploads, _ = PM.scalar_mesi(mine, pcfg, init)
    rloads, _ = RM.scalar_mesi(ref, rcfg, init)
    assert PMC.check_mesi_trace(mine, pcfg, init, ploads) == \
        RMC.check_mesi_trace(ref, rcfg, init, rloads) == 0
    bad = np.asarray(ploads, np.uint32).copy()
    bad[::7] ^= np.uint32(0x100)
    got = PMC.check_mesi_trace(mine, pcfg, init, bad)
    assert got == RMC.check_mesi_trace(ref, rcfg, init, bad) >= 1
