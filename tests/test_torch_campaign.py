"""The port's budgeted tallies and stopping rule against the JAX
package's, on the CPU.

``run_keys_device`` / ``run_keys_stratified`` (batches over
``escape_budget`` included) must give the reference's integers bit for bit;
the host stopping rules must give its float64 values exactly, and the
float32 ``*_device`` mirrors must match to one float32 ulp with the same
stop decisions.  The reference's ``TrialKernel`` calls
``jax.core.trace_state_clean``, which jax 0.9 moved to ``jax._src.core``; a
module-scoped fixture provides the alias for this file's tests only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.parallel import make_mesh
from shrewd_tpu.parallel import stopping as RS
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.parallel import stopping

@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def window():
    ref = ref_native.generate_trace(seed=5, n=384, nphys=64, mem_words=512,
                                    working_set_words=128)
    return ref, compat.trace_from_arrays(*ref)


def _kernels(window, **kw):
    ref, mine = window
    rcfg = RO.O3Config(shadow_model="fupool", **kw)
    return (RefKernel(ref, rcfg),
            TrialKernel(mine, compat.config_from_dict(rcfg.to_dict()),
                        device="cpu"))


def _keys(seed, n):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(seed), n)
    return rkeys, compat.keys_from_key_data(jax.random.key_data(rkeys),
                                            "cpu")


# --- the budgeted tallies -------------------------------------------------

@pytest.mark.parametrize("structure,budget", [
    ("regfile", 256), ("fu", 8), ("latch", 0)])
def test_run_keys_device_matches_reference(window, structure, budget):
    rk, mk = _kernels(window, escape_budget=budget)
    rkeys, keys = _keys(31, 256)
    want, want_n = (np.asarray(x) for x in rk.run_keys_device(rkeys,
                                                               structure))
    got, got_n = mk.run_keys_device(keys, structure)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got_n) == int(want_n)
    want_h, _ = rk.run_keys_stratified(rkeys, structure)
    got_h, got_n2 = mk.run_keys_stratified(keys, structure)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert int(got_n2) == int(got_n)
    np.testing.assert_array_equal(got_h.numpy().sum(0), got.numpy())
    np.testing.assert_array_equal(
        mk.run_keys_traceable(keys, structure).numpy(), want)
    if budget == 8:
        # over the budget: the device tally differs from the exact one
        assert int(got_n) > budget
        exact = mk.run_keys(keys, structure).numpy()
        assert not np.array_equal(exact, got.numpy())
        assert got.numpy()[1] > exact[1]


def test_budgeted_path_resolves_the_first_lanes_in_index_order(window):
    """Only the first ``escape_budget`` unresolved lanes are re-run: with
    a budget of 1 only the lowest-index one (lane 0 included) is."""
    _, mk = _kernels(window, escape_budget=1)
    _, keys = _keys(32, 256)
    faults = mk.sample_batch(keys, "fu")
    res = mk.taint_fast(faults, may_latch=False)
    unres = np.nonzero((res.escaped | res.overflow).numpy())[0]
    exact = mk.run_batch(faults).numpy()
    out, _, n_unres = mk._outcomes_device(keys, "fu")
    want = np.where((res.escaped | res.overflow).numpy(), 1,
                    res.outcome.numpy())
    want[unres[0]] = exact[unres[0]]
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(n_unres) == unres.size > 1
    # lane 0 itself unresolved: a pick that pads with lane 0 would write
    # a filler's result over it
    lane0 = torch.cat([keys[unres[0]:unres[0] + 1], keys])
    out0, _, _ = mk._outcomes_device(lane0, "fu")
    assert out0[0] == exact[unres[0]]


def test_dense_kernel_has_no_escapes(window):
    rk, mk = _kernels(window, replay_kernel="dense")
    rkeys, keys = _keys(33, 128)
    got, n = mk.run_keys_device(keys, "rob")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rk.run_keys_device(rkeys,
                                                                "rob")[0]))
    assert int(n) == 0


# --- stopping --------------------------------------------------------------

def test_host_stopping_rules_match_reference():
    rng = np.random.default_rng(1)
    for conf in (0.9, 0.95, 0.99, 0.975, 0.8):
        assert stopping.z_value(conf) == RS.z_value(conf)
    for _ in range(200):
        n = int(rng.integers(0, 50000))
        s = int(rng.integers(0, n + 1))
        assert stopping.wilson(s, n) == RS.wilson(s, n)
        assert stopping.should_stop(s, n, 0.01) == RS.should_stop(s, n,
                                                                  0.01)
        strata = rng.integers(0, 500, (8, 4))
        strata[rng.integers(0, 8)] = 0
        pairs = stopping.pairs_from_strata(strata)
        assert pairs == RS.pairs_from_strata(strata)
        assert stopping.post_stratified(pairs) == RS.post_stratified(pairs)
        assert (stopping.should_stop_stratified(pairs, 0.02)
                == RS.should_stop_stratified(pairs, 0.02))
        total = int(strata.sum())
        for strat in (True, False):
            args = (s % (total + 1), total, strata, strat, 0.95)
            assert stopping.live_halfwidth(*args) == RS.live_halfwidth(*args)
            assert (stopping.eta_trials(s % (total + 1), total, strata,
                                        strat, 0.95, 0.01, 1000)
                    == RS.eta_trials(s % (total + 1), total, strata, strat,
                                     0.95, 0.01, 1000))
        assert (stopping.trials_needed(s / max(n, 1), 0.01)
                == RS.trials_needed(s / max(n, 1), 0.01))
    lanes = {0: {"a": {"tallies": [5, 3, 2, 0], "trials": 10,
                       "strata": [[5, 3, 2, 0]] + [[0] * 4] * 7}},
             1: {"a": {"tallies": [1, 1, 0, 0], "trials": 2,
                       "strata": None}}}
    assert (stopping.merged_fold(lanes, True, 0.95, 0.3, 4)
            == RS.merged_fold(lanes, True, 0.95, 0.3, 4))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_device_stopping_mirrors_match_reference_to_one_ulp():
    rng = np.random.default_rng(2)
    z = np.float32(RS.z_value(0.95))
    hw_mine, hw_ref, trials_all = [], [], []
    for _ in range(300):
        n = np.int32(rng.integers(0, 200000))
        s = np.int32(rng.integers(0, n + 1))
        hw_ref.append(np.asarray(RS.wilson_halfwidth_device(
            jnp.int32(s), jnp.int32(n), jnp.float32(z))))
        hw_mine.append(stopping.wilson_halfwidth_device(
            torch.tensor(s), torch.tensor(n), torch.tensor(z)).numpy())
        trials_all.append(n)
        strata = rng.integers(0, 3000, (8, 4)).astype(np.int32)
        strata[rng.integers(0, 8, 2)] = 0
        hw_ref.append(np.asarray(RS.post_stratified_halfwidth_device(
            jnp.asarray(strata), jnp.float32(z))))
        hw_mine.append(stopping.post_stratified_halfwidth_device(
            torch.as_tensor(strata), torch.tensor(z)).numpy())
        trials_all.append(np.int32(strata.sum()))
    hw_mine, hw_ref = np.array(hw_mine), np.array(hw_ref)
    assert hw_mine.dtype == np.float32
    assert _ulps(hw_mine, hw_ref).max() <= 1
    # the stop decisions at targets on and around each half-width
    trials = np.array(trials_all)
    for target in (np.float32(0.01), np.float32(0.003)):
        for tgt in (target, hw_ref, np.nextafter(hw_ref, np.float32(1))):
            want = np.asarray(RS.should_stop_device(
                jnp.asarray(hw_ref), jnp.asarray(trials), jnp.asarray(tgt),
                jnp.int32(1000)))
            got = stopping.should_stop_device(
                torch.as_tensor(hw_mine), torch.as_tensor(trials),
                torch.as_tensor(tgt), 1000).numpy()
            np.testing.assert_array_equal(got, want)


