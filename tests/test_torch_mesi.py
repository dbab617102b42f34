"""The port's MESI tier (``models/mesi.py``) against the JAX package's, on
the CPU, on 96-access torture streams over 64 memory words on 2 and 4
cores.

The stream, the golden walk and every faulted walk (loads, final memory
and the final protocol arrays) of the port's step loop equal the
reference's ``lax.scan``; the walks also equal the scalar oracle, except
where the reference's own walk and oracle disagree (reference fault R6:
a TBE fault that flips a set-index bit of a load miss's line, where the
walk writes the victim back from the requested set and the oracle from
the fill's set); per-key outcomes and stratified tallies of the state,
tag, dir and tbe structures are equal under none, parity and ECC."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu.models import mesi as RM
from shrewd_tpu.ops import classify as RC
from shrewd_tpu.ops.trial import N_STRATA
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import mesi as M
from shrewd_tpu_torch.ops import classify as C
from test_torch_ruby import one_torch_thread  # noqa: F401

N_ACCESSES, MEM_WORDS, N_FAULTS = 96, 64, 48
STRUCTURES = ("state", "tag", "dir", "tbe")


class Setup:
    def __init__(self, n_cores):
        self.rcfg = RM.MesiConfig(n_cores=n_cores)
        self.cfg = M.MesiConfig.from_dict(self.rcfg.to_dict())
        self.rtr = RM.torture_stream(self.rcfg, N_ACCESSES, MEM_WORDS,
                                     seed=13, sharing=0.6)
        self.tr = M.torture_stream(self.cfg, N_ACCESSES, MEM_WORDS,
                                   seed=13, sharing=0.6)
        self.mem = np.random.default_rng(9).integers(
            0, 1 << 32, MEM_WORDS, dtype=np.uint64).astype(np.uint32)
        rk = ref_prng.trial_keys(ref_prng.campaign_key(n_cores), N_FAULTS)
        self.rkeys = rk
        self.keys = compat.keys_from_key_data(jax.random.key_data(rk),
                                              "cpu")
        self.kernel = M.MesiKernel(self.tr, self.cfg, self.mem,
                                   device="cpu")
        rtr, rcfg, mem = self.rtr, self.rcfg, jnp.asarray(self.mem)
        self.ref_walk = jax.jit(jax.vmap(
            lambda f: RM.mesi_replay(rtr, rcfg, mem, f, return_state=True)))
        self._ref_kernel = None

    @property
    def ref_kernel(self):
        if self._ref_kernel is None:
            self._ref_kernel = RM.MesiKernel(self.rtr, self.rcfg, self.mem)
        return self._ref_kernel

    def faults(self, structure):
        """The port's draws for ``structure`` and the reference's fault of
        the same coordinates."""
        f = self.kernel.sample_batch(self.keys, structure)
        return f, RM.MesiFault(*(jnp.asarray(x.numpy()) for x in f))


@functools.lru_cache(maxsize=None)
def _setup(n_cores):
    return Setup(n_cores)


@pytest.fixture(scope="module", params=[2, 4], ids=["2cores", "4cores"])
def setup(request):
    return _setup(request.param)


def _loads(loads, tr):
    """A walk's load values at the stream's loads (a store's slot is 0)."""
    return np.asarray(loads)[..., ~np.asarray(tr.is_store)]


def test_torture_stream_matches_reference(setup):
    for f in RM.AccessTrace._fields:
        want = np.asarray(getattr(setup.rtr, f))
        got = getattr(setup.tr, f)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert setup.tr.is_store.any() and not setup.tr.is_store.all()


def test_golden_walk_matches_reference_and_oracle(setup):
    rl, rm = RM.mesi_replay(setup.rtr, setup.rcfg, jnp.asarray(setup.mem),
                            RM.MesiFault(*(jnp.int32(0),) * 5,
                                         jnp.int32(-1)))
    gl, gm = setup.kernel.golden_loads, setup.kernel.golden_mem
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    for oracle in (M.scalar_mesi, RM.scalar_mesi):
        sl, sm = oracle(setup.tr, setup.cfg, setup.mem)
        np.testing.assert_array_equal(_loads(gl, setup.tr), sl)
        np.testing.assert_array_equal(gm.numpy(), sm)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_sampler_matches_reference(setup, structure):
    want = setup.ref_kernel.sample_batch(setup.rkeys, structure)
    got = setup.kernel.sample_batch(setup.keys, structure)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert x.dtype == torch.int32


@pytest.mark.parametrize("structure", STRUCTURES)
def test_faulted_walks_match_reference(setup, structure):
    """Loads, memory and the final state, tag and directory arrays."""
    f, rf = setup.faults(structure)
    loads, mem, state = M.mesi_replay(setup.tr, setup.cfg, setup.mem, f,
                                      return_state=True)
    rl, rm, rstate = setup.ref_walk(rf)
    np.testing.assert_array_equal(loads.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(mem.numpy(), np.asarray(rm))
    for got, want in zip(state, rstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # state and tag faults change some walks
    changed = ((loads != setup.kernel.golden_loads).any(dim=1)
               | (mem != setup.kernel.golden_mem).any(dim=1))
    assert changed.any() or structure in ("dir", "tbe")


def _r6(setup, f, b):
    """Lane b is in the class of reference fault R6: a TBE flip of a
    set-index bit landing on a load."""
    set_bits = int(np.log2(setup.cfg.n_sets))
    cyc = int(f.cycle[b])
    return (int(f.target[b]) == M.TGT_TBE and int(f.bit[b]) < set_bits
            and not setup.tr.is_store[cyc])


@pytest.mark.parametrize("structure", STRUCTURES)
def test_faulted_walks_match_scalar_oracle(setup, structure):
    f, rf = setup.faults(structure)
    loads, mem = M.mesi_replay(setup.tr, setup.cfg, setup.mem, f)
    rl, rm, _ = setup.ref_walk(rf)
    apart = []
    for b in range(N_FAULTS):
        co = tuple(int(x[b]) for x in f)
        sl, sm = M.scalar_mesi(setup.tr, setup.cfg, setup.mem, fault=co)
        if not (np.array_equal(_loads(loads[b], setup.tr), sl)
                and np.array_equal(mem[b].numpy(), sm)):
            apart.append(b)
            # the reference's own walk and oracle disagree there too
            rsl, rsm = RM.scalar_mesi(setup.rtr, setup.rcfg, setup.mem,
                                      fault=co)
            assert not (np.array_equal(_loads(rl[b], setup.tr), rsl)
                        and np.array_equal(np.asarray(rm[b]), rsm))
    assert all(_r6(setup, f, b) for b in apart), apart


@pytest.mark.parametrize("prot", ["none", "parity", "ecc"])
def test_outcomes_and_strata_match_reference(prot):
    """Per-key outcomes of every structure on 4 cores, and the stratified
    tally (the reference's run_keys_stratified for state when unprotected;
    its outcomes binned by its landing octiles otherwise)."""
    setup = _setup(4)
    rcfg = RM.MesiConfig.from_dict({**setup.rcfg.to_dict(),
                                    "state_protection": prot})
    cfg = M.MesiConfig.from_dict(rcfg.to_dict())
    rk = RM.MesiKernel(setup.rtr, rcfg, setup.mem)
    pk = M.MesiKernel(setup.tr, cfg, setup.mem, device="cpu")
    classify = jax.jit(jax.vmap(rk._classify))
    for s in STRUCTURES:
        rf = rk.sample_batch(setup.rkeys, s)
        want = np.asarray(classify(rf))
        got = pk.outcomes_from_keys(setup.keys, s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        strata = np.clip(np.asarray(rf.cycle) * N_STRATA // N_ACCESSES, 0,
                         N_STRATA - 1)
        pt, pn = pk.run_keys_stratified(setup.keys, s)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(
            RC.tally_stratified(jnp.asarray(want), jnp.asarray(strata),
                                N_STRATA)))
        assert int(pn) == 0
        np.testing.assert_array_equal(
            pk.run_keys(setup.keys, s).numpy(),
            np.bincount(want, minlength=C.N_OUTCOMES))
    if prot == "none":
        rt, _ = rk.run_keys_stratified(setup.rkeys, "state")
        np.testing.assert_array_equal(
            pk.run_keys_stratified(setup.keys, "state")[0].numpy(),
            np.asarray(rt))
    if prot == "ecc":
        assert (got == C.OUTCOME_MASKED).all()
