"""The port's ``ChunkedCampaign`` against the JAX package's, on the CPU.

Outcomes, tallies and ``last_stats`` on both engines, mirroring
``tests/test_chunked.py`` and ``tests/test_chunked_fast.py``: three chunks,
a NOP-padded tail, small-batch waves, one chunk, latch faults landing out
of the window, shadow detection, carry horizons 0 and 1, and K = 4
overflows falling back to the exact engine.  Structures other than regfile
are drawn by the reference's sampler and run in both packages as
constructed faults (``outcomes_of_faults``).  Tolerance: exact.
"""

import numpy as np
import pytest

from shrewd_tpu.ops import chunked as RC
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.ops import chunked as PC
from shrewd_tpu_torch.ops import window as W
from shrewd_tpu_torch.ops.trial import TrialKernel
# the module's R1 alias fixture (autouse) and the two-package helpers
from test_torch_chunked import _trace_state_alias, keys, mk_pair  # noqa: F401


def drawn(ref, seed, n, structure):
    """A fault batch drawn by the reference's sampler, in both packages."""
    rk, _ = keys(seed, n)
    f = ref.sampler(structure).sample_batch(rk)
    return f, compat.fault_from_arrays(*(np.asarray(x) for x in f), "cpu")


def both_campaigns(ref, mine, **kw):
    return RC.ChunkedCampaign(ref, **kw), PC.ChunkedCampaign(mine, **kw)


def assert_same(rc, pc, got, want):
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32
    assert pc.last_stats == rc.last_stats


ENGINES = ["exact", "taint"]


@pytest.mark.parametrize("engine", ENGINES)
def test_three_chunks_match_reference(engine):
    ref, mine = mk_pair()
    rk, k = keys(21, 96)
    rc, pc = both_campaigns(ref, mine, chunk=128, engine=engine)
    assert pc.C == 3
    assert_same(rc, pc, pc.outcomes_from_keys(k, "regfile"),
                rc.outcomes_from_keys(rk, "regfile"))
    np.testing.assert_array_equal(
        pc.outcomes_from_keys(k, "regfile"),
        mine.run_batch(mine.sample_batch(k, "regfile")).numpy())


@pytest.mark.parametrize("structure", ["fu", "rob", "iq", "lsq"])
def test_constructed_faults_of_every_structure_match_reference(structure):
    ref, mine = mk_pair()
    fR, f = drawn(ref, 21, 96, structure)
    for engine in ENGINES:
        rc, pc = both_campaigns(ref, mine, chunk=128, engine=engine)
        assert_same(rc, pc, pc.outcomes_of_faults(f),
                    rc.outcomes_of_faults(fR))


@pytest.mark.parametrize("engine", ENGINES)
def test_padding_matches_reference(engine):
    ref, mine = mk_pair(n=300)
    rk, k = keys(5, 64)
    rc, pc = both_campaigns(ref, mine, chunk=77, engine=engine)
    assert pc.C * pc.S > pc.n
    assert_same(rc, pc, pc.outcomes_from_keys(k, "regfile"),
                rc.outcomes_from_keys(rk, "regfile"))


@pytest.mark.parametrize("engine", ENGINES)
def test_small_batch_waves_match_reference(engine):
    ref, mine = mk_pair()
    rk, k = keys(9, 96)
    rc, pc = both_campaigns(ref, mine, chunk=192, max_batch=8,
                            engine=engine)
    assert_same(rc, pc, pc.outcomes_from_keys(k, "regfile"),
                rc.outcomes_from_keys(rk, "regfile"))
    assert pc.last_stats["waves"] > 2 * pc.C


@pytest.mark.parametrize("engine", ENGINES)
def test_single_chunk_matches_reference(engine):
    ref, mine = mk_pair(n=128)
    fR, f = drawn(ref, 3, 48, "fu")
    rc, pc = both_campaigns(ref, mine, chunk=4096, engine=engine)
    assert pc.C == 1
    assert_same(rc, pc, pc.outcomes_of_faults(f), rc.outcomes_of_faults(fR))


@pytest.mark.parametrize("engine", ENGINES)
def test_latch_faults_out_of_window_match_reference(engine):
    ref, mine = mk_pair(n=300)
    fR, f = drawn(ref, 21, 96, "latch")
    rc, pc = both_campaigns(ref, mine, chunk=77, engine=engine)
    assert_same(rc, pc, pc.outcomes_of_faults(f), rc.outcomes_of_faults(fR))
    assert pc.last_stats["oow_masked"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_shadow_detection_matches_reference(engine):
    ref, mine = mk_pair(shadow_coverage=[1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0])
    fR, f = drawn(ref, 13, 96, "fu")
    rc, pc = both_campaigns(ref, mine, chunk=96, engine=engine)
    got = pc.outcomes_of_faults(f)
    assert_same(rc, pc, got, rc.outcomes_of_faults(fR))
    assert (got == 3).any()


@pytest.mark.parametrize("horizon", [0, 1])
@pytest.mark.parametrize("engine", ENGINES)
def test_carry_horizon_matches_reference(engine, horizon):
    ref, mine = mk_pair(n=512, seed=17)
    rk, k = keys(23, 96)
    rc, pc = both_campaigns(ref, mine, chunk=64, carry_horizon=horizon,
                            engine=engine)
    assert_same(rc, pc, pc.outcomes_from_keys(k, "regfile"),
                rc.outcomes_from_keys(rk, "regfile"))
    assert pc.last_stats["horizon_sdc"] > 0


def test_small_sets_fall_back_to_exact_like_the_reference():
    ref, mine = mk_pair(n=300, seed=3, taint_k=4)
    rk, k = keys(9, 64)
    rc, pc = both_campaigns(ref, mine, chunk=77, engine="taint")
    got = pc.outcomes_from_keys(k, "regfile")
    assert_same(rc, pc, got, rc.outcomes_from_keys(rk, "regfile"))
    assert pc.last_stats["fallback_lanes"] > 0
    exact = PC.ChunkedCampaign(mine, chunk=77, engine="exact")
    np.testing.assert_array_equal(got, exact.outcomes_from_keys(k,
                                                                "regfile"))


def test_campaign_over_the_reference_window():
    """A campaign over the reference's preprocessed window, handed across
    by ``compat``, equals one over the port's own."""
    ref, mine = mk_pair(n=300)
    rwin = RC.preprocess_window(ref, 77)
    win = compat.window_from_arrays(rwin.n, rwin.S, rwin.tr, rwin.gb_reg,
                                    rwin.gb_mem, rwin.trace_digest)
    _, k = keys(5, 48)
    np.testing.assert_array_equal(
        PC.ChunkedCampaign(mine, chunk=77, window=win)
        .outcomes_from_keys(k, "regfile"),
        PC.ChunkedCampaign(mine, chunk=77).outcomes_from_keys(k, "regfile"))


def test_tally_matches_outcomes():
    ref, mine = mk_pair()
    rk, k = keys(7, 64)
    rc, pc = both_campaigns(ref, mine, chunk=128)
    tally = pc.run_keys(k, "regfile")
    np.testing.assert_array_equal(tally, rc.run_keys(rk, "regfile"))
    assert tally.dtype == np.int64 and tally.sum() == 64


def test_engines_and_window_options():
    _, mine = mk_pair()
    with pytest.raises(ValueError, match="follows the device"):
        PC.ChunkedCampaign(mine, chunk=128, engine="pallas")
    with pytest.raises(ValueError, match="unknown chunk engine"):
        PC.ChunkedCampaign(mine, chunk=128, engine="nope")
    with pytest.raises(NotImplementedError, match="ArtifactStore"):
        PC.preprocess_window(mine, 128, store=object())
    assert PC.ChunkedCampaign(mine, chunk=128).engine == "taint"
    dense = TrialKernel(mine.trace, O3Config(replay_kernel="dense"),
                        device="cpu")
    assert PC.ChunkedCampaign(dense, chunk=128).engine == "exact"


def test_registry_warm_start_skips_boundary_pass():
    _, mine = mk_pair()
    W.clear_registry()
    builds0 = W.STATS["builds"]
    w1 = PC.preprocess_window(mine, 128)
    assert W.STATS["builds"] == builds0 + 1
    hits0 = W.STATS["registry_hits"]
    assert PC.preprocess_window(mine, 128) is w1
    assert W.STATS["registry_hits"] == hits0 + 1
    PC.ChunkedCampaign(mine, chunk=128)
    assert W.STATS["builds"] == builds0 + 1
    PC.preprocess_window(mine, 96)
    assert W.STATS["builds"] == builds0 + 2
