"""The port's cache tier (``models/ruby.py``) against the JAX package's, on
the CPU.

On the flagship window the golden access stream (the port reads it from
the C++ golden pass, the reference from its Python replay), the cache
timelines and miss streams of the L1 and of the chained L2 are equal, and
so are the per-key outcomes and the stratified tallies of the data, tag
and state structures under every protection; a misaligned golden access
raises, and a window whose keys overflow int32 is refused."""

import jax
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import ruby as RR
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat, native
from shrewd_tpu_torch.models import ruby as R

FLAGSHIP = dict(seed=1, n=4096, nphys=256, mem_words=4096,
                working_set_words=1024)
N_KEYS = 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (restored after): the tier step
    loops run many tiny ops, and with the suite's parallel workers each
    holding a full pool the spinning threads slow them tenfold and more.
    The tier test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def windows():
    ref = ref_native.generate_trace(**FLAGSHIP)
    return ref, native.generate_trace(**FLAGSHIP)


@pytest.fixture(scope="module")
def keys():
    rk = ref_prng.trial_keys(ref_prng.campaign_key(0), N_KEYS)
    return rk, compat.keys_from_key_data(jax.random.key_data(rk), "cpu")


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_access_stream_matches_reference(windows):
    ref, mine = windows
    rs, ps = RR.golden_access_stream(ref), R.golden_access_stream(mine)
    assert len(ps.cycle) > 1000 and ps.is_store.any()
    for f in rs._fields:
        np.testing.assert_array_equal(getattr(ps, f), np.asarray(
            getattr(rs, f)))
        assert getattr(ps, f).dtype == np.asarray(getattr(rs, f)).dtype


@pytest.mark.parametrize("level", ["l1", "l2"])
def test_simulate_cache_matches_reference(windows, level):
    """The timeline and miss stream of ``CacheConfig()`` on the window's
    stream, and of the L2 geometry on the L1's miss stream."""
    ref, mine = windows
    rs, ps = RR.golden_access_stream(ref), R.golden_access_stream(mine)
    rtl, rmiss = RR.simulate_cache(rs, RR.CacheConfig(), ref.n)
    ptl, pmiss = R.simulate_cache(ps, R.CacheConfig(), mine.n)
    if level == "l2":
        cfg = dict(n_sets=256, n_ways=8)
        rtl, rmiss = RR.simulate_cache(rmiss, RR.CacheConfig(**cfg), ref.n)
        ptl, pmiss = R.simulate_cache(pmiss, R.CacheConfig(**cfg), mine.n)
    _same(rtl, ptl)
    _same(rmiss, pmiss)
    assert len(ptl.wkey) > 0 and len(pmiss.cycle) > 0


@pytest.mark.parametrize("prot", ["none", "parity", "ecc"])
@pytest.mark.parametrize("level", ["l1", "l2"])
def test_outcomes_and_strata_match_reference(windows, keys, prot, level):
    ref, mine = windows
    rkeys, pkeys = keys
    cfg = dict(data_protection=prot, tag_protection=prot)
    l2 = dict(n_sets=256, n_ways=8, **cfg)
    rh = RR.CacheHierarchy.build(ref, RR.CacheConfig(**cfg),
                                 RR.CacheConfig(**l2))
    ph = R.CacheHierarchy.build(mine, R.CacheConfig(**cfg),
                                R.CacheConfig(**l2), device="cpu")
    rk, pk = getattr(rh, level), getattr(ph, level)
    for s in R.CACHE_STRUCTURES:
        want = np.asarray(rk.outcomes_from_keys(rkeys, s))
        got = pk.outcomes_from_keys(pkeys, s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        rt, rn = rk.run_keys_stratified(rkeys, s)
        pt, pn = pk.run_keys_stratified(pkeys, s)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        assert int(pn) == int(rn) == 0
        np.testing.assert_array_equal(pk.run_keys(pkeys, s).numpy(),
                                      np.asarray(rk.run_keys(rkeys, s)))
    # the L1 sees consumed corruption on every structure
    if level == "l1" and prot == "none":
        assert (got == 1).any()


def test_sampler_matches_reference(windows, keys):
    ref, mine = windows
    rkeys, pkeys = keys
    rs, ps = RR.golden_access_stream(ref), R.golden_access_stream(mine)
    rk = RR.CacheKernel(RR.simulate_cache(rs, RR.CacheConfig(), ref.n)[0],
                        RR.CacheConfig())
    pk = R.CacheKernel(R.simulate_cache(ps, R.CacheConfig(), mine.n)[0],
                       R.CacheConfig(), device="cpu")
    for s in R.CACHE_STRUCTURES:
        _same(rk.sampler(s).sample_batch(rkeys),
              pk.sampler(s).sample_batch(pkeys))


def test_misaligned_golden_access_raises(windows, monkeypatch):
    """The reference's golden replay asserts on a misaligned access; the
    port raises too, and never returns a stream."""
    _, mine = windows
    real = native.record_chunk

    def skewed(view, wr):
        streams = real(view, wr).copy()
        at = np.nonzero(np.isin(np.asarray(view.opcode),
                                _mem_opcodes()))[0][0]
        streams[2, at] += 2
        return streams

    monkeypatch.setattr(native, "record_chunk", skewed)
    with pytest.raises(ValueError, match="in-range"):
        R.golden_access_stream(mine)


def _mem_opcodes():
    from shrewd_tpu_torch.isa import uops as U
    return [op for op in range(256) if U.is_mem(np.int64(op))]


def test_key_space_beyond_int32_is_refused():
    tl = R.CacheTimeline(*(np.zeros(0, np.int64),) * 5,
                         end_valid=np.zeros(256, np.int32),
                         end_dirty=np.zeros(256, np.int32),
                         span=2**22, n_cycles=2**22 - 1)
    with pytest.raises(ValueError, match="overflows int32"):
        R.CacheKernel(tl, R.CacheConfig(), device="cpu")
