"""The port's ``TrialKernel`` against the JAX package's, on the CPU.

Both packages get the same window (the native engine's), the same config
(through ``to_dict``) and the same keys (through ``key_data``); the regfile
tallies of ``run_keys`` must be equal for the dense, taint and hybrid
kernels.  The reference's ``TrialKernel`` calls
``jax.core.trace_state_clean``, which jax 0.9 moved to ``jax._src.core``;
a module-scoped fixture provides the alias for this file's tests only.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models.o3 import O3Config as RefConfig
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat, native
from shrewd_tpu_torch.isa import uops
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops.trial import TrialKernel

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module")
def window():
    return ref_native.generate_trace(seed=1, n=256, nphys=256,
                                     mem_words=1024, working_set_words=256)


def _keys(seed, n):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(seed), n)
    return rkeys, compat.keys_from_key_data(jax.random.key_data(rkeys),
                                            "cpu")


def test_config_dict_matches_reference():
    ref = RefConfig().to_dict()
    assert O3Config().to_dict() == ref
    assert compat.config_from_dict(ref).to_dict() == ref
    tuned = RefConfig(replay_kernel="dense", taint_k=4,
                      shadow_coverage=[0.25] * 7).to_dict()
    assert compat.config_from_dict(tuned).to_dict() == tuned


@pytest.mark.parametrize("mode", ["hybrid", "dense", "taint"])
def test_run_keys_matches_reference(window, mode):
    assert jax.config.jax_threefry_partitionable
    rkeys, keys = _keys(0, 512)
    cfg = RefConfig(replay_kernel=mode)
    want = np.asarray(RefKernel(window, cfg).run_keys(rkeys, "regfile"))
    kernel = TrialKernel(compat.trace_from_arrays(*window),
                         compat.config_from_dict(cfg.to_dict()),
                         device="cpu")
    got = kernel.run_keys(keys, "regfile")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if mode != "taint":
        assert got.tolist() == [126, 358, 28, 0]


@pytest.mark.parametrize("coverage,compare_regs", [(0.5, True),
                                                   (0.3, False)])
def test_hybrid_matches_reference_with_detection(coverage, compare_regs):
    assert jax.config.jax_threefry_partitionable
    t = ref_native.generate_trace(seed=8, n=200, nphys=64, mem_words=512,
                                  working_set_words=128)
    rkeys, keys = _keys(2, 384)
    cfg = RefConfig(shadow_coverage=[coverage] * 7, taint_k=4,
                    compare_regs=compare_regs)
    ref = RefKernel(t, cfg)
    want = np.asarray(ref.run_keys(rkeys, "regfile"))
    kernel = TrialKernel(compat.trace_from_arrays(*t),
                         compat.config_from_dict(cfg.to_dict()),
                         device="cpu")
    np.testing.assert_array_equal(kernel.run_keys(keys, "regfile").numpy(),
                                  want)
    assert kernel.escapes == ref.escapes


@pytest.mark.parametrize("use_row", [False, True])
def test_taint_batch_matches_reference(window, use_row):
    """``use_row=False`` goes through ``taint_fast`` (the kernel's wrapper),
    ``use_row=True`` is the row pass; both equal the reference's."""
    rkeys, keys = _keys(5, 512)
    ref = RefKernel(window, RefConfig())
    want = ref.taint_batch(ref.sample_batch(rkeys, "regfile"), use_row)
    kernel = TrialKernel(compat.trace_from_arrays(*window), device="cpu")
    got = kernel.taint_batch(kernel.sample_batch(keys, "regfile"), use_row)
    for name in ("outcome", "escaped", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if not use_row:
        assert bool(got.escaped.any())


def test_row_pass_refuses_without_the_memory_timeline(window):
    kernel = TrialKernel(compat.trace_from_arrays(*window),
                         O3Config(taint_mem_timeline_mb=0), device="cpu")
    _, keys = _keys(5, 64)
    with pytest.raises(RuntimeError, match="memory timeline"):
        kernel.taint_batch(kernel.sample_batch(keys, "regfile"), True)


def test_oracle_outcomes_match_native_golden_trials(window):
    _, keys = _keys(3, 512)
    kernel = TrialKernel(compat.trace_from_arrays(*window), device="cpu")
    faults = kernel.sample_batch(keys, "regfile")
    got = kernel.oracle_outcomes(faults)
    want = ref_native.golden_trials(
        window, *(f.numpy() for f in faults),
        kernel.shadow_cov.numpy(), compare_regs=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kernel.run_batch(faults).numpy(), want)


def test_native_engine_matches_reference():
    mine = native.generate_trace(seed=6, n=300, nphys=64, mem_words=512,
                                 working_set_words=128)
    ref = ref_native.generate_trace(seed=6, n=300, nphys=64,
                                    mem_words=512, working_set_words=128)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native.golden_replay(mine),
                    ref_native.golden_replay(ref)):
        np.testing.assert_array_equal(a, b)


def test_strata_match_reference(window):
    rkeys, keys = _keys(4, 256)
    ref = RefKernel(window, RefConfig())
    want = np.asarray(ref.strata_of(ref.sample_batch(rkeys, "regfile"),
                                    "regfile"))
    kernel = TrialKernel(compat.trace_from_arrays(*window), device="cpu")
    got = kernel.strata_of(kernel.sample_batch(keys, "regfile"), "regfile")
    np.testing.assert_array_equal(got.numpy(), want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("k", [4, 16])
def test_chip_smoke_operation_count(k):
    """The K1 operation count behind chip_smoke.py's bound equals a lane by
    lane, step by step sum of the same per-step counts."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(k)
    n, lanes = 40, 64
    opcode = rng.integers(0, 32, n).astype(np.int32)
    steps = rng.integers(1, n + 1, lanes)
    cycle = rng.integers(0, n, lanes)
    lookup, remove, upsert = 4 * k, 2 * k, 7 * k + 3
    want = 0
    for s, c in zip(steps, cycle):
        for i in range(s):
            op = opcode[i]
            want += smoke.OPS_STEP + 2 * lookup
            if op == uops.LOAD:
                want += smoke.OPS_LOAD + lookup
            if i < s - 1 and op == uops.STORE:
                want += smoke.OPS_STORE + remove
            if i < s - 1 and uops.writes_dest(op):
                want += smoke.OPS_WRITE + remove
        if c < s:
            want += smoke.OPS_LANDING + lookup + upsert
    assert smoke.k1_operations(opcode, cycle, steps, k) == want


@pytest.mark.parametrize("k", [4, 16])
def test_chip_smoke_k2_operation_count(k):
    """K2's operation count behind chip_smoke.py's bound covers only the
    steps a chunk wave needs: a landing lane from its landing step, a lane
    carrying a set from step 0, a null lane or an unseeded lane that does
    not land in the chunk not at all."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(100 + k)
    n, lanes = 40, 96
    opcode = rng.integers(0, 32, n).astype(np.int32)
    kind = rng.integers(0, 2, lanes)
    cycle = np.where(kind == 1, rng.integers(-n, 2 * n, lanes), -1)
    tags0 = np.full((lanes, k), -1, np.int64)
    seeded = (kind == 1) & (cycle < 0) & (rng.random(lanes) < 0.5)
    tags0[seeded, rng.integers(0, k, lanes)[seeded]] = 3
    landing = (kind == 1) & (cycle >= 0) & (cycle < n)
    first = np.where(landing, cycle, np.where(seeded, 0, n))
    steps = np.where(landing, rng.integers(np.clip(cycle + 1, 1, n), n + 1),
                     n)
    faults = compat.fault_from_arrays(
        kind, cycle, np.zeros(lanes, np.int64), np.zeros(lanes, np.int64),
        np.ones(lanes, np.float32), "cpu")
    lookup, remove, upsert = 4 * k, 2 * k, 7 * k + 3
    want = want_steps = 0
    for s, c, f, lands in zip(steps, cycle, first, landing):
        for i in range(f, s):
            op = opcode[i]
            want += smoke.OPS_STEP + 2 * lookup
            if op == uops.LOAD:
                want += smoke.OPS_LOAD + lookup
            if i < s - 1 and op == uops.STORE:
                want += smoke.OPS_STORE + remove
            if i < s - 1 and uops.writes_dest(op):
                want += smoke.OPS_WRITE + remove
        want_steps += max(s - f, 0)
        if lands:
            want += smoke.OPS_LANDING + lookup + upsert
    assert landing.any() and seeded.any() and (kind == 0).any()
    assert smoke.k2_operations(opcode, faults, torch.as_tensor(tags0), steps,
                               k) == (want, want_steps)


def test_pin_for_chip_smoke():
    """chip_smoke.py holds the port's tally of the first 4096 flagship keys
    against a constant: it must be the reference's tally."""
    assert jax.config.jax_threefry_partitionable
    smoke = _chip_smoke()
    t = ref_native.generate_trace(seed=1, n=4096, nphys=256, mem_words=4096,
                                  working_set_words=1024)
    keys = ref_prng.trial_keys(ref_prng.campaign_key(0), smoke.N_PIN)
    tally = np.asarray(RefKernel(t, RefConfig()).run_keys(keys, "regfile"))
    assert tally.tolist() == smoke.PIN_TALLY
