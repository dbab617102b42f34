"""The port's stats package against the JAX package's, on the CPU.

The same Group tree — Scalars, Vectors with subnames, Formulas (numbers,
dicts, NaN), Distributions and Histograms with under- and overflow, Text,
nested Groups — is built in both packages from the same seeded data, and
``dump_text``, ``dump_json`` and ``to_dict`` must be equal character for
character.  ``dump_hdf5`` keeps its lazy ``h5py`` import in both."""

import io
import math

import numpy as np
import pytest

from shrewd_tpu import stats as ref_stats
from shrewd_tpu_torch import stats


def _tree(S, seed: int):
    rng = np.random.default_rng(seed)
    root = S.Group("campaign")
    sp = S.Group("w0")
    root.sp_w0 = sp
    for name in ("regfile", "fu"):
        g = S.Group(name)
        setattr(sp, f"st_{name}", g)
        g.trials = S.Scalar("trials", "trials run")
        g.trials += int(rng.integers(1, 10_000))
        g.outcomes = S.Vector("outcomes", 4, "outcome tally",
                              subnames=["masked", "sdc", "due", "detected"])
        g.outcomes += rng.integers(0, 500, 4)
        g.outcomes.add(1, 3)
        t = g.outcomes
        g.avf = S.Formula("avf", lambda t=t: float(
            np.float32(t[1] + t[2]) / np.float32(max(t.total(), 1))),
            "(SDC+DUE)/trials")
        g.lat = S.Distribution("lat", 0.0, 64.0, 8, "latency")
        g.lat.sample(rng.uniform(-8, 80, 200))
        g.lat.sample([3.0, 5.0], weights=[2.0, 0.5])
        g.hist = S.Histogram("hist", 6, "auto-ranged")
        g.hist.sample(rng.integers(0, 300, 50))
    res = S.Group("resilience")
    root.resilience = res
    res.tier_trials = S.Formula(
        "tier_trials", lambda: {"device": 4096, "cpu": 0, "oracle": 0},
        "trials per tier")
    res.nan = S.Formula("hw", lambda: math.nan, "NaN until known")
    res.note = S.Text("note", "one card", "free text")
    res.empty = S.Vector("empty", 3, "never touched")
    return root


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_group_tree_dumps_match_reference(seed):
    ref, mine = _tree(ref_stats, seed), _tree(stats, seed)
    rt, mt = io.StringIO(), io.StringIO()
    assert stats.dump_text(mine, mt) == ref_stats.dump_text(ref, rt)
    assert mt.getvalue() == rt.getvalue()
    assert (stats.dump_text(mine, desc=False)
            == ref_stats.dump_text(ref, desc=False))
    rj, mj = io.StringIO(), io.StringIO()
    assert stats.dump_json(mine, mj) == ref_stats.dump_json(ref, rj)
    assert mj.getvalue() == rj.getvalue()
    assert '"hw": null' in mj.getvalue()      # NaN dumps as null
    assert repr(stats.to_dict(mine)) == repr(ref_stats.to_dict(ref))


def test_reset_and_rebind_match_reference():
    ref, mine = _tree(ref_stats, 3), _tree(stats, 3)
    ref.sp_w0.st_fu.reset()
    mine.sp_w0.st_fu.reset()
    ref.sp_w0.st_regfile.outcomes.reset()
    mine.sp_w0.st_regfile.outcomes.reset()
    assert stats.dump_json(mine) == ref_stats.dump_json(ref)
    assert stats.dump_text(mine) == ref_stats.dump_text(ref)


def test_hdf5_dump_matches_reference_or_skips_alike(tmp_path):
    """``stats.h5`` is optional: with h5py both packages write the same
    datasets; without it both raise ImportError, which ``write_outputs``
    swallows."""
    ref, mine = _tree(ref_stats, 5), _tree(stats, 5)
    try:
        import h5py
    except ImportError:
        for mod, g in ((ref_stats, ref), (stats, mine)):
            with pytest.raises(ImportError):
                mod.dump_hdf5(g, str(tmp_path / "x.h5"))
        return
    ref_stats.dump_hdf5(ref, str(tmp_path / "ref.h5"))
    stats.dump_hdf5(mine, str(tmp_path / "mine.h5"))

    def walk(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda k, v: out.__setitem__(
                k, (np.asarray(v[()]).tolist(), dict(v.attrs))
                if isinstance(v, h5py.Dataset) else None))
        return out
    assert repr(walk(tmp_path / "mine.h5")) == repr(walk(tmp_path / "ref.h5"))
