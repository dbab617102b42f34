"""The port's O3 structure faults against the JAX package's, on the CPU.

Every ``Fault`` field of every structure, under both timing models, and
the latch faults of ``MinorFaultSampler``, must be the reference's bit for
bit on the same keys; so must ``run_keys``' tallies with SHREWD's
structural shadow-FU model, and the FU pool's counters the kernel keeps.
The reference's ``TrialKernel`` calls ``jax.core.trace_state_clean``, which
jax 0.9 moved to ``jax._src.core``; a module-scoped fixture provides the
alias for this file's tests only.
"""

import jax
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import minor as RM
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import minor as M
from shrewd_tpu_torch.models import o3 as O
from shrewd_tpu_torch.ops.trial import TrialKernel

OTHERS = ("fu", "rob", "iq", "lsq", "latch")


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
    ref = ref_native.generate_trace(seed=4, n=448, nphys=64, mem_words=512,
                                    working_set_words=128)
    return ref, compat.trace_from_arrays(*ref)


def _keys(seed, n):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(seed), n)
    return rkeys, compat.keys_from_key_data(jax.random.key_data(rkeys),
                                            "cpu")


def _same_faults(got, want):
    for name, g, w in zip(O.Fault._fields, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert g.numpy().dtype == w.dtype, name


@pytest.mark.parametrize("timing", ["proxy", "scoreboard"])
@pytest.mark.parametrize("structure", ["regfile", "fu", "rob", "iq", "lsq"])
def test_fault_sampler_matches_reference(window, structure, timing):
    ref, mine = window
    rcfg = RO.O3Config(timing=timing)
    rkeys, keys = _keys(11, 1024)
    want = jax.vmap(RO.FaultSampler(ref, structure, rcfg).sample)(rkeys)
    got = O.FaultSampler(mine, structure,
                         compat.config_from_dict(rcfg.to_dict())
                         ).sample_batch(keys)
    _same_faults(got, want)
    entry = got.entry.numpy()
    if timing == "scoreboard" and structure != "regfile":
        # the default tournament predictor's wrong-path mass: sentinels
        assert (entry == mine.n).any() and (entry < mine.n).any()
    if structure == "lsq" and timing == "proxy":
        assert set(np.unique(got.kind.numpy())) == {O.KIND_LSQ_ADDR,
                                                   O.KIND_LSQ_DATA}


def test_fault_sampler_with_a_shared_scoreboard(window):
    """A scoreboard handed in (as TrialKernel shares one) draws as one the
    sampler computes itself; the reference's scoreboard converts."""
    ref, mine = window
    rcfg = RO.O3Config(timing_cfg=RO.TimingConfig(bpred="bimodal",
                                                  rob_size=48))
    mcfg = compat.config_from_dict(rcfg.to_dict())
    sb = RO.compute_scoreboard(ref, rcfg.timing_cfg)
    rkeys, keys = _keys(12, 512)
    for s in ("fu", "iq"):
        want = jax.vmap(RO.FaultSampler(ref, s, rcfg, scoreboard=sb)
                        .sample)(rkeys)
        got = O.FaultSampler(mine, s, mcfg,
                             scoreboard=compat.scoreboard_from_arrays(*sb)
                             ).sample_batch(keys)
        _same_faults(got, want)


def test_fault_sampler_refuses_latch_and_unknown(window):
    _, mine = window
    with pytest.raises(ValueError, match="MinorFaultSampler"):
        O.FaultSampler(mine, "latch", O.O3Config())
    with pytest.raises(KeyError):
        O.FaultSampler(mine, "btb", O.O3Config())


def test_lsq_sampler_on_a_window_without_stores():
    ref = ref_native.generate_trace(seed=2, n=96, nphys=64, mem_words=256,
                                    working_set_words=64, frac_store=0.0)
    mine = compat.trace_from_arrays(*ref)
    rkeys, keys = _keys(13, 256)
    for timing in ("proxy", "scoreboard"):
        rcfg = RO.O3Config(timing=timing)
        want = jax.vmap(RO.FaultSampler(ref, "lsq", rcfg).sample)(rkeys)
        got = O.FaultSampler(mine, "lsq", compat.config_from_dict(
            rcfg.to_dict())).sample_batch(keys)
        _same_faults(got, want)


@pytest.mark.parametrize("depth", [4, 6])
def test_minor_sampler_matches_reference(window, depth):
    ref, mine = window
    rcfg = RM.MinorConfig(depth=depth)
    rkeys, keys = _keys(14, 2048)
    want = jax.vmap(RM.MinorFaultSampler(ref, rcfg).sample)(rkeys)
    mcfg = compat.minor_config_from_dict(rcfg.to_dict())
    got = M.MinorFaultSampler(mine, mcfg).sample_batch(keys)
    _same_faults(got, want)
    entry = got.entry.numpy()
    # bubbles on both sides of the window
    assert (entry < 0).any() and (entry >= mine.n).any()
    assert set(np.unique(got.kind.numpy())) == set(O.STRUCTURES["latch"])


def _kernels(trace_pair, rcfg, minor=None):
    ref, mine = trace_pair
    rk = RefKernel(ref, rcfg, minor)
    mk = TrialKernel(mine, compat.config_from_dict(rcfg.to_dict()),
                     None if minor is None
                     else compat.minor_config_from_dict(minor.to_dict()),
                     device="cpu")
    return rk, mk


@pytest.mark.parametrize("structure", OTHERS)
def test_run_keys_matches_reference_with_fupool(window, structure):
    rk, mk = _kernels(window, RO.O3Config(shadow_model="fupool"))
    rkeys, keys = _keys(15, 384)
    want = np.asarray(rk.run_keys(rkeys, structure))
    got = mk.run_keys(keys, structure)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert mk.escapes == rk.escapes
    np.testing.assert_array_equal(mk.shadow_cov.numpy(),
                                  np.asarray(rk.shadow_cov))
    assert mk.fu_model.availability(True) == rk.fu_model.availability(True)
    if structure == "fu":
        assert want[3] > 0          # the DETECTED branch is reached


@pytest.mark.parametrize("mode,structure", [
    ("dense", "iq"), ("taint", "lsq"), ("dense", "latch"), ("taint", "fu")])
def test_run_keys_other_kernels_match_reference(window, mode, structure):
    rcfg = RO.O3Config(shadow_model="fupool", replay_kernel=mode,
                       timing="proxy", priority_to_shadow=True)
    rk, mk = _kernels(window, rcfg, RM.MinorConfig(depth=5))
    rkeys, keys = _keys(16, 256)
    np.testing.assert_array_equal(
        mk.run_keys(keys, structure).numpy(),
        np.asarray(rk.run_keys(rkeys, structure)))
    assert mk.escapes == rk.escapes


def test_with_shrewd_rebuilds_the_kernel(window):
    rk, mk = _kernels(window, RO.O3Config(shadow_model="fupool"))
    for kw in (dict(enable=False), dict(priority_to_shadow=True)):
        r2, m2 = rk.with_shrewd(**kw), mk.with_shrewd(**kw)
        assert m2.cfg.to_dict() == r2.cfg.to_dict()
        assert m2.device == mk.device and m2 is not mk
        np.testing.assert_array_equal(m2.shadow_cov.numpy(),
                                      np.asarray(r2.shadow_cov))
    assert mk.cfg.enable_shrewd and not mk.cfg.priority_to_shadow
    assert mk.with_shrewd(enable=False).fu_model is None


def test_outcomes_from_keys_and_strata_match_reference(window):
    rk, mk = _kernels(window, RO.O3Config(shadow_model="fupool"))
    rkeys, keys = _keys(17, 128)
    np.testing.assert_array_equal(
        mk.outcomes_from_keys(keys, "rob").numpy(),
        np.asarray(rk.outcomes_from_keys(rkeys, "rob")))
    for s in ("rob", "latch"):
        np.testing.assert_array_equal(
            mk.strata_of(mk.sample_batch(keys, s), s).numpy(),
            np.asarray(rk.strata_of(rk.sample_batch(rkeys, s), s)))


@pytest.mark.parametrize("structure", ("regfile",) + OTHERS)
def test_hybrid_and_dense_equal_the_oracle_on_every_structure(window,
                                                               structure):
    """The serial C++ oracle under the kernel's fupool coverage, the
    check chip_smoke.py phase 11 makes on the card."""
    _, mine = window
    mk = TrialKernel(mine, O.O3Config(shadow_model="fupool"), device="cpu")
    _, keys = _keys(18, 256)
    faults = mk.sample_batch(keys, structure)
    oracle = mk.oracle_outcomes(faults)
    np.testing.assert_array_equal(
        mk.run_batch_hybrid(faults, may_latch=structure == "latch"), oracle)
    np.testing.assert_array_equal(mk.run_batch(faults).numpy(), oracle)
