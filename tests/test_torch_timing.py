"""The port's scoreboard timing model against the JAX package's, on the CPU.

The scoreboard, the branch predictors, the L1D walk, the busy arrays and
the wrong-path phantoms are host numpy in both packages and must agree
exactly; ``ResidencySampler`` draws on torch (``searchsorted``) where the
reference counts compares under vmap, and must give the same entries for
the same keys, the wrong-path sentinel ``n`` included, over spans above
2**16 and masses that need the halving loop.
"""

import jax
import numpy as np
import pytest

from shrewd_tpu.isa import semantics as ref_sem
from shrewd_tpu.isa import uops as ref_uops
from shrewd_tpu.models import timing as RT
from shrewd_tpu.trace import synth
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import timing as T


def _window(seed, divides=False):
    """A generated window with branches and FP µops (FDIV among them);
    ``divides`` plants the integer divide family at every 13th µop."""
    t = synth.generate(synth.WorkloadConfig(
        n=512, nphys=64, mem_words=512, working_set_words=128,
        frac_alu=0.3, frac_branch=0.14, frac_fp=0.12, seed=seed))
    if divides:
        op = np.asarray(t.opcode).copy()
        fam = [ref_uops.DIV, ref_uops.DIVU, ref_uops.REM, ref_uops.REMU]
        at = [i for i in range(5, t.n, 13) if not ref_uops.is_branch(op[i])]
        for j, i in enumerate(at):
            op[i] = fam[j % 4]
        t = t._replace(opcode=op)
    return t


@pytest.fixture(scope="module", params=[(3, False), (4, True)],
                ids=["fp", "fp+div"])
def windows(request):
    ref = _window(*request.param)
    mine = compat.trace_from_arrays(*ref)
    op = np.asarray(ref.opcode)
    assert ref_uops.is_branch(op).any() and (op == ref_uops.FDIV).any()
    assert ref_uops.is_div(op).any() == request.param[1]
    return ref, mine


def _cfgs(**kw):
    d = RT.TimingConfig(**kw).to_dict()
    return RT.TimingConfig.from_dict(d), T.TimingConfig.from_dict(d)


def _same_scoreboard(a, b):
    for name in ("dispatch", "issue", "writeback", "commit"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if a.mispredict is None:
        assert b.mispredict is None
    else:
        np.testing.assert_array_equal(a.mispredict, b.mispredict)
    for name in ("wp_mass_rob", "wp_mass_iq", "wp_mass_fu", "wp_mass_lsq"):
        assert getattr(a, name) == getattr(b, name), name


def test_timing_config_dict_matches_reference():
    ref = RT.TimingConfig().to_dict()
    assert T.TimingConfig().to_dict() == ref
    assert T.TimingConfig.from_dict(ref).to_dict() == ref


def _reference_stream(t):
    """The reference's scalar replay's access stream, or None where it
    asserts on a golden access."""
    rec: list = []
    try:
        ref_sem.scalar_replay(t, t.init_reg.copy(), t.init_mem.copy(),
                              record_mem=rec)
    except AssertionError:
        return None
    return rec


def test_scalar_replay_records_the_same_access_stream(windows):
    """The port's access stream (from the C++ golden pass's effective
    addresses) is the reference's scalar replay's record_mem stream; the
    divides planted in the fp+div window send a golden access out of
    range, where both have none."""
    ref, mine = windows
    want = _reference_stream(ref)
    got = T.access_stream(mine)
    if want is None:
        assert got is None
        return
    at, word, is_store = got
    assert len(want) > 0
    assert list(zip(at.tolist(), word.tolist(), is_store.tolist())) == want


@pytest.mark.parametrize("bad", ["misaligned", "out_of_range"])
def test_dcache_falls_back_on_a_bad_golden_access(windows, bad):
    """A golden load at a misaligned or out-of-range address leaves no
    access stream in either package: both keep the flat latencies."""
    ref, _ = windows
    op = np.asarray(ref.opcode)
    imm = np.asarray(ref.imm).copy()
    j = int(np.nonzero(op == ref_uops.LOAD)[0][0])
    imm[j] = (imm[j] + (1 if bad == "misaligned"
                        else 4 * ref.mem_words)) & 0xFFFFFFFF
    ref = ref._replace(imm=imm.astype(np.asarray(ref.imm).dtype))
    mine = compat.trace_from_arrays(*ref)
    assert _reference_stream(ref) is None and T.access_stream(mine) is None
    rc, mc = _cfgs(dcache="classic")
    want = RT.dcache_latencies(ref, rc)
    np.testing.assert_array_equal(want, RT._latencies(ref.opcode, rc))
    np.testing.assert_array_equal(T.dcache_latencies(mine, mc), want)


@pytest.mark.parametrize("bpred", ["none", "bimodal", "tournament"])
@pytest.mark.parametrize("dcache", ["none", "classic"])
def test_scoreboard_matches_reference(windows, bpred, dcache):
    ref, mine = windows
    rc, mc = _cfgs(bpred=bpred, dcache=dcache)
    a = RT.compute_scoreboard(ref, rc)
    b = T.compute_scoreboard(mine, mc)
    _same_scoreboard(a, b)
    if bpred != "none":
        assert b.mispredict.any() and b.wp_mass_rob > 0
    for s in ("rob", "iq", "fu"):
        for x, y in zip(a.occupancy(s), b.occupancy(s)):
            np.testing.assert_array_equal(x, y)
    mem = np.asarray(ref_uops.is_mem(ref.opcode))
    for x, y in zip(a.occupancy("lsq", mem), b.occupancy("lsq", mem)):
        np.testing.assert_array_equal(x, y)
    assert a.n_cycles == b.n_cycles and a.ipc == b.ipc


def test_scoreboard_under_tight_queues_and_small_tables(windows):
    """Small ROB/IQ/LSQ, narrow widths and tiny predictor tables make the
    dispatch stalls and the table aliasing bite."""
    ref, mine = windows
    rc, mc = _cfgs(rob_size=16, iq_size=8, lsq_size=4, dispatch_width=2,
                   issue_width=3, commit_width=2, local_bits=3,
                   global_bits=4, bpred_bits=3, redirect_penalty=9,
                   taken_fetch_break=False, dcache_sets=4, dcache_ways=2,
                   dcache_line_words=4)
    _same_scoreboard(RT.compute_scoreboard(ref, rc),
                     T.compute_scoreboard(mine, mc))
    rc.bpred = mc.bpred = "bimodal"
    _same_scoreboard(RT.compute_scoreboard(ref, rc),
                     T.compute_scoreboard(mine, mc))


def test_busy_arrays_and_phantoms_match_reference(windows):
    ref, mine = windows
    rc, mc = _cfgs()
    op = np.asarray(ref.opcode)
    np.testing.assert_array_equal(RT.nonpipelined_busy(op, rc),
                                  T.nonpipelined_busy(op, mc))
    np.testing.assert_array_equal(RT.approx_shadow_busy(op, rc),
                                  T.approx_shadow_busy(op, mc))
    np.testing.assert_array_equal(RT._latencies(op, rc),
                                  T._latencies(op, mc))
    np.testing.assert_array_equal(RT.dcache_latencies(ref, rc),
                                  T.dcache_latencies(mine, mc))
    np.testing.assert_array_equal(RT.predict_mispredicts(ref, rc),
                                  T.predict_mispredicts(mine, mc))
    a = RT.wrongpath_phantoms(ref, RT.compute_scoreboard(ref, rc), rc)
    b = T.wrongpath_phantoms(mine, T.compute_scoreboard(mine, mc), mc)
    assert a[0].size > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    rc.bpred = mc.bpred = "none"
    sb = T.compute_scoreboard(mine, mc)
    assert all(x.size == 0 for x in T.wrongpath_phantoms(mine, sb, mc))


def _keys(seed, n):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(seed), n)
    return rkeys, compat.keys_from_key_data(jax.random.key_data(rkeys),
                                            "cpu")


def _draws(start, end, squashed, seed, n_keys=2048):
    ref = RT.ResidencySampler(start, end, squashed_mass=squashed)
    mine = T.ResidencySampler(start, end, squashed_mass=squashed)
    assert (mine.total, mine.n) == (ref.total, ref.n)
    np.testing.assert_array_equal(mine.cum, np.asarray(ref.cum))
    rkeys, keys = _keys(seed, n_keys)
    want = [np.asarray(x) for x in jax.vmap(ref.sample)(rkeys)]
    got = [x.numpy() for x in mine.sample(keys)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int32
    return mine, got[0]


def test_residency_draws_match_reference_on_the_scoreboard(windows):
    """Every structure's residency table, with wrong-path mass: some draws
    are the sentinel entry n."""
    ref, mine = windows
    _, mc = _cfgs()
    sb = T.compute_scoreboard(mine, mc)
    mem = np.asarray(ref_uops.is_mem(ref.opcode))
    for i, s in enumerate(("rob", "iq", "fu", "lsq")):
        start, end = sb.occupancy(s, mem if s == "lsq" else None)
        _, entry = _draws(start, end, sb.wrongpath_mass(s), 10 + i)
        assert (entry == mine.n).any(), s
        assert (entry < mine.n).any(), s


def test_residency_draws_over_a_wide_span_and_the_halving_loop():
    rng = np.random.default_rng(5)
    n = 300
    start = rng.integers(0, 1000, n)
    # a span far above 2**16, with empty entries among the occupied
    length = rng.integers(0, 1 << 14, n) * (rng.random(n) < 0.8)
    sampler, entry = _draws(start, start + length, 12345, 21)
    assert sampler.total > 1 << 16 and (entry == n).any()
    assert not np.isin(entry, np.nonzero(length == 0)[0]).any()
    # a mass of at least 2**31: the table halves until it fits
    length = rng.integers(1 << 22, 1 << 24, n)
    assert int(length.sum()) >= 1 << 31
    sampler, entry = _draws(start, start + length, 1 << 30, 22)
    assert sampler.total < 1 << 31 and sampler.total > 1 << 29
    assert (entry == n).any() and (entry < n).any()
    # a degenerate table: uniform over the entries
    _draws(start, start, 0, 23, 256)
