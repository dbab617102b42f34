"""The port's protection search (``shrewd_tpu_torch/search/protect.py``)
against the JAX package's, on the CPU.

Seeded random profiles (numpy) go through both packages'
``DesignSpace``: ``evaluate`` gives the same sdc, due and area rates, and
``search`` the same ``feasible`` flag, assignment and Pareto front (the
same assignments in the same order).  Tolerance: the rates agree within
``rtol=1e-6`` — both packages compute in float32 with the same order of
products, and only the order of the sum over structures may differ
(XLA's reduction against the port's left-to-right sum).  One space
crosses ``EVAL_CHUNK`` with the chunk set small in both packages.
``shadow_scheme`` on the reference tests' tiny window, with and without
keys, equals the reference's exactly (its floats are means of the same
float32 coverage values).  The reference's own ``tests/test_search.py``
cases hold here too.
"""

import jax
import numpy as np
import pytest

from shrewd_tpu.models.o3 import O3Config as RefConfig
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.search import protect as RS
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.search import protect as PS

from test_torch_ruby import one_torch_thread  # noqa: F401

# float32 sums over structures in a different order (module docstring)
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    """R1: the reference's kernel reaches ``jax.core.trace_state_clean``
    (moved in jax 0.9); aliased for the module and undone after."""
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


def random_profiles(seed, n, halfwidth=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tally = rng.integers(1, 400, 4)
        out.append(RS.StructureProfile.from_tally(
            f"s{i}", int(rng.integers(64, 20000)), tally,
            fit_per_bit=float(rng.uniform(1e-4, 1e-2)),
            halfwidth=float(rng.uniform(0, 0.05)) if halfwidth else 0.0,
            conservative=halfwidth))
    return out


SCHEMES4 = [RS.NONE, RS.PARITY, RS.SECDED,
            RS.Scheme("shadow", 0.6, 0.0, 1.5, detect_sdc=0.45,
                      detect_due=0.7)]


def port_space(ref_profiles, schemes, **kw):
    return PS.DesignSpace(
        [compat.profile_from_fields(*p) for p in ref_profiles],
        schemes=[compat.scheme_from_fields(*s) for s in schemes],
        device="cpu", **kw)


def assert_results_equal(got, want):
    assert got.feasible == want.feasible
    assert got.assignment == want.assignment
    assert got.n_configs == want.n_configs
    np.testing.assert_allclose(
        [got.area, got.sdc_rate, got.due_rate, got.baseline_area,
         got.baseline_sdc],
        [want.area, want.sdc_rate, want.due_rate, want.baseline_area,
         want.baseline_sdc], rtol=RTOL)
    assert [a for _, _, a in got.pareto] == [a for _, _, a in want.pareto]
    np.testing.assert_allclose([(a, s) for a, s, _ in got.pareto],
                               [(a, s) for a, s, _ in want.pareto],
                               rtol=RTOL)


@pytest.mark.parametrize("seed,n,allowed,live", [
    (0, 5, None, False),
    (1, 6, {"s0": [0, 3], "s2": [1, 2, 3], "s5": [0, 2]}, False),
    (2, 7, {"s1": [0, 1]}, True),
], ids=["5x4", "6x4_allowed", "7x4_live"])
def test_design_space_matches_reference(seed, n, allowed, live):
    """Rates of every config, and the search at three targets (none
    feasible, some feasible, all feasible)."""
    ref_p = random_profiles(seed, n, halfwidth=live)
    rds = RS.DesignSpace(ref_p, schemes=SCHEMES4, allowed=allowed)
    pds = port_space(ref_p, SCHEMES4, allowed=allowed)
    cfgs = rds.enumerate()
    np.testing.assert_array_equal(pds.enumerate(), cfgs)
    for got, want in zip(pds.evaluate(cfgs), rds.evaluate(cfgs)):
        assert got.dtype.is_floating_point and got.dtype.itemsize == 4
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL)
    base = rds.search(0.0).baseline_sdc
    for target in (-1.0, base * 0.05, base * 10):
        assert_results_equal(pds.search(target), rds.search(target))


def test_evaluate_crosses_eval_chunk(monkeypatch):
    """A 4^6 space evaluated in chunks of 1000 configs (a partial last
    chunk) equals the reference's chunked pass and the port's unchunked
    one."""
    ref_p = random_profiles(5, 6)
    rds = RS.DesignSpace(ref_p, schemes=SCHEMES4)
    pds = port_space(ref_p, SCHEMES4)
    cfgs = rds.enumerate()
    whole = [x.numpy() for x in pds.evaluate(cfgs)]
    monkeypatch.setattr(RS.DesignSpace, "EVAL_CHUNK", 1000)
    monkeypatch.setattr(PS.DesignSpace, "EVAL_CHUNK", 1000)
    assert len(cfgs) % 1000
    chunked = [x.numpy() for x in pds.evaluate(cfgs)]
    for got, full, want in zip(chunked, whole, rds.evaluate(cfgs)):
        np.testing.assert_array_equal(got, full)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    assert_results_equal(pds.search(1e-3), rds.search(1e-3))


def test_reference_search_cases_hold_in_the_port():
    """``tests/test_search.py``'s algebra: the unprotected baseline,
    correction vs detection, min-area feasibility, an infeasible target,
    a monotone front and the ``allowed`` restriction."""
    def profile(name, bits, masked, sdc, due, det=0.0):
        return PS.StructureProfile.from_tally(
            name, bits, np.array([masked, sdc, due, det]))

    ds = PS.DesignSpace([profile("a", 100, 50, 30, 20),
                         profile("b", 300, 80, 10, 10)], device="cpu")
    base = ds.search(1.0)
    assert base.baseline_area == pytest.approx(400.0)
    assert base.baseline_sdc == pytest.approx(1e-3 * (100 * .3 + 300 * .1),
                                              rel=1e-6)
    res = ds.search(0.0)
    # parity (detect 1) zeroes SDC at the least area of any scheme
    assert res.feasible and res.sdc_rate == 0.0
    assert res.assignment == {"a": "parity", "b": "parity"}
    assert res.area == pytest.approx(400.0 * (1 + 1 / 32))
    assert ds.search(-1.0).feasible is False
    front = ds.search(0.0).pareto
    assert all(a1 < a2 and s1 > s2 for (a1, s1, _), (a2, s2, _)
               in zip(front, front[1:]))
    small = PS.DesignSpace([profile("fu", 10, 1, 1, 0),
                            profile("rf", 10, 1, 1, 0)],
                           allowed={"fu": [0, 1], "rf": [0, 2]},
                           device="cpu")
    assert set(map(tuple, small.enumerate())) == {(0, 0), (0, 2), (1, 0),
                                                  (1, 2)}
    with pytest.raises(KeyError):
        PS.DesignSpace([profile("fu", 1, 1, 0, 0)], allowed={"nope": [0]},
                       device="cpu")
    with pytest.raises(ValueError):
        PS.Scheme("bad", 0.8, 0.5, 1.0).validate()


def test_from_tally_live_profiles_match_reference():
    """The conservative live-profile fit (upper vulnerable bounds, the
    rest rescaled) and its bounds are the reference's, float64 exact."""
    for tally, hw in (([90, 5, 3, 2], 0.02), ([10, 45, 40, 5], 0.2),
                      ([0, 1, 0, 0], 0.5)):
        for cons in (False, True):
            r = RS.StructureProfile.from_tally("s", 64, tally,
                                               halfwidth=hw,
                                               conservative=cons)
            p = PS.StructureProfile.from_tally("s", 64, tally,
                                               halfwidth=hw,
                                               conservative=cons)
            np.testing.assert_array_equal(p.probs, r.probs)
            assert [p.p_lo(i) for i in range(4)] == \
                [r.p_lo(i) for i in range(4)]
            assert [p.p_hi(i) for i in range(4)] == \
                [r.p_hi(i) for i in range(4)]
            assert p.fit == r.fit
    with pytest.raises(ValueError):
        PS.StructureProfile.from_tally("s", 64, [0, 0, 0, 0])


def test_design_space_defaults_to_the_card():
    import torch

    p = [PS.StructureProfile.from_tally("a", 8, [1, 1, 0, 0])]
    if torch.cuda.is_available():
        assert PS.DesignSpace(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PS.DesignSpace(p)


@pytest.fixture(scope="module")
def kernels():
    ref_t = rsynth.generate(rsynth.WorkloadConfig(
        n=96, nphys=32, mem_words=64, working_set_words=32, seed=11))
    cfg = dict(shadow_model="fupool")
    return (RefKernel(ref_t, RefConfig(**cfg)),
            TrialKernel(compat.trace_from_arrays(*ref_t), O3Config(**cfg),
                        device="cpu"))


@pytest.mark.parametrize("with_keys", [False, True],
                         ids=["uniform", "conditioned"])
def test_shadow_scheme_matches_reference(kernels, with_keys):
    rk, pk = kernels
    keys = pkeys = None
    if with_keys:
        keys = ref_prng.trial_keys(ref_prng.campaign_key(0), 512)
        pkeys = compat.keys_from_key_data(jax.random.key_data(keys), "cpu")
    want = RS.shadow_scheme(rk, area=1.4, keys=keys)
    got = PS.shadow_scheme(pk, area=1.4, keys=pkeys)
    assert tuple(got) == tuple(want)
    assert 0.0 < got.detect <= 1.0
    assert PS.shadow_scheme(pk.with_shrewd(enable=False)).detect == 0.0
    if with_keys:
        assert got.detect_sdc is not None or got.detect_due is not None
        with pytest.raises(ValueError, match="FU fault sites"):
            PS.shadow_scheme(pk, keys=pkeys, structure="regfile")
