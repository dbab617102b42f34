"""The port's gem5 run-artifact readers and writers against the JAX
package's: ``utils/units.py``, the unit param types and ``dump_ini`` of
``utils/config.py``, ``ingest/configfile.py`` (``config.ini`` /
``config.json``) and ``ingest/statsfile.py`` (``stats.txt``).

Each is held exactly, on the same inputs: the same table of unit strings
parses to the same values (and the same bad ones are refused); the same
``ConfigObject`` tree dumps byte-equal ``config.ini`` files that both
readers re-nest alike; and the ``stats.txt`` the port's ``stats``
writes (several dump blocks, a markerless file, NaN values) reads to the
same blocks in both, with ``diff_stats`` flagging the same names.
"""

import io
import json

import pytest

from shrewd_tpu import stats as rstats
from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.ingest import configfile as RCF
from shrewd_tpu.ingest import statsfile as RSF
from shrewd_tpu.utils import config as RCFG
from shrewd_tpu.utils import units as RU
from shrewd_tpu_torch import stats as pstats
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.ingest import configfile as PCF
from shrewd_tpu_torch.ingest import statsfile as PSF
from shrewd_tpu_torch.utils import config as PCFG
from shrewd_tpu_torch.utils import units as PU

BYTES = ["2GiB", "64kB", "64KiB", "1MB", "3.5KiB", " 8 ", "0", "1e3",
         "4096B", "1Ti", "2p", 4096, 7.0, "1.5", "1.5B", "x", "12ZB",
         "0.1KiB", True, None, 2.5]
FREQS = ["3GHz", "200MHz", "1.5khz", "7Hz", "2THz", 1e9, 3, "3G", "fast",
         "1e3GHz"]
TIMES = ["10ns", "1.5us", "2s", "3ms", "4ps", "5fs", 2e-9, 1, "10", "1h",
         "1e-3s"]


def _outcome(fn, x):
    """(value, type) or the exception type a converter gives."""
    try:
        v = fn(x)
    except Exception as e:       # noqa: BLE001 — the type is compared
        return ("raises", type(e).__name__)
    return (repr(v), type(v).__name__)


@pytest.mark.parametrize("fn,table", [
    ("to_bytes", BYTES), ("to_frequency", FREQS), ("to_seconds", TIMES)])
def test_units_parse_the_same_table(fn, table):
    for x in table:
        assert _outcome(getattr(PU, fn), x) == _outcome(getattr(RU, fn), x), x
    assert any(_outcome(getattr(PU, fn), x)[0] == "raises" for x in table)


def test_units_format_the_same():
    for n in (0, 1, 1023, 1024, 1536, 1 << 20, 3 << 30, (3 << 30) + 1):
        assert PU.format_bytes(n) == RU.format_bytes(n)
    for n in (0, 7, 999, 999.6, 999999, 12_500_000, -4321, 3.2e9, 7e12,
              999_999_999_999_999, 2.5e16, 0.0042):
        assert PU.format_count(n) == RU.format_count(n), n
    assert issubclass(PU.UnitError, ValueError)


@pytest.mark.parametrize("kind,value", [
    ("MemorySize", "64KiB"), ("MemorySize", 4096), ("Frequency", "3GHz"),
    ("Time", "10ns"), ("Time", 1.5)])
def test_unit_param_types_convert_the_same(kind, value):
    mine, ref = getattr(PCFG, kind)(value), getattr(RCFG, kind)(value)
    assert (type(mine).__mro__[1], mine) == (type(ref).__mro__[1], ref)


def _trees(pkg):
    """One config tree per package, built from the same declarations:
    unit params, a vector param, nested children."""
    cfg = pkg

    class Cache(cfg.ConfigObject):
        size = cfg.Param(cfg.MemorySize, "32KiB", "capacity")
        assoc = cfg.Param(int, 8, "associativity")
        latency = cfg.Param(cfg.Time, "1ns", "hit latency")

    class Core(cfg.ConfigObject):
        clock = cfg.Param(cfg.Frequency, "1GHz", "core clock")
        widths = cfg.VectorParam(int, [4, 8], "fetch / issue")
        name = cfg.Param(str, "o3", "label")
        fast = cfg.Param(bool, True, "")
        l1 = cfg.Child(Cache)

    class System(cfg.ConfigObject):
        seed = cfg.Param(int, 7, "")
        core = cfg.Child(Core)
        l2 = cfg.Child(Cache)

    return System(seed=3, core=Core(clock="2.5GHz", l1=Cache(size="64KiB")),
                  l2=Cache(size="1MiB", assoc=16, latency="10ns"))


@pytest.mark.parametrize("tree", ["units", "campaign_plan"])
def test_dump_ini_is_byte_equal_and_reads_alike(tmp_path, tree):
    if tree == "units":
        mine, ref = _trees(PCFG), _trees(RCFG)
    else:
        ref = RP.CampaignPlan(simpoints=[RP.CheckpointSpec(
            name="c", cpt_dir="cpt", binary="sort")],
            structures=["regfile", "fu"], batch_size=128)
        mine = PP.CampaignPlan.from_dict(ref.to_dict())
    mine.dump_ini(tmp_path / "p.ini")
    ref.dump_ini(tmp_path / "r.ini")
    text = (tmp_path / "p.ini").read_bytes()
    assert text == (tmp_path / "r.ini").read_bytes()
    flat = PCF.load_config_ini(str(tmp_path / "p.ini"))
    assert flat == RCF.load_config_ini(str(tmp_path / "r.ini"))
    nested = PCF.tree_from_ini(flat)
    assert nested == RCF.tree_from_ini(flat)
    names = {k for sec in flat.values() for k in sec}
    for name in sorted(names):
        assert PCF.find_params(nested, name) == \
            RCF.find_params(nested, name), name
    with open(tmp_path / "p.ini") as f:
        assert PCF.parse_ini(f) == flat


def test_config_json_reads_alike(tmp_path):
    ref = RP.CampaignPlan(structures=["regfile", "fu", "cache:data"])
    mine = PP.CampaignPlan.from_dict(ref.to_dict())
    mine.dump_json(tmp_path / "p.json")
    ref.dump_json(tmp_path / "r.json")
    got = PCF.load_config_json(str(tmp_path / "p.json"))
    assert got == RCF.load_config_json(str(tmp_path / "r.json"))
    for name in ("structures", "batch_size", "audit_rate", "seed"):
        assert PCF.find_params(got, name) == RCF.find_params(got, name)
    assert PCF.find_params(got, "structures") == [
        ("structures", ["regfile", "fu", "cache:data"])]


@pytest.mark.parametrize("text", [
    "[a]\nx=1\nno equals\n", "x=1\n[a]\n"])
def test_malformed_ini_raises_alike(text):
    with pytest.raises(ValueError) as mine:
        PCF.parse_ini(io.StringIO(text), "config.ini")
    with pytest.raises(ValueError) as ref:
        RCF.parse_ini(io.StringIO(text), "config.ini")
    assert str(mine.value) == str(ref.value)


def _group(mod, scale: float):
    """A stats tree in ``mod`` (either package's ``stats``): scalars, a
    vector, a distribution, a NaN formula, a text stat and a subgroup."""
    g = mod.Group("sim")
    g.trials = mod.Scalar("trials", "trials run")
    g.trials += 12345 * scale
    g.outcomes = mod.Vector("outcomes", 4, "outcome tally",
                            subnames=["masked", "sdc", "due", "detected"])
    g.outcomes += [10 * scale, 2, 0.5, 0]
    g.lat = mod.Distribution("lat", 0, 10, 5, "latency")
    g.avf = mod.Formula("avf", lambda: float("nan") if scale == 1 else 0.25,
                        "AVF")
    g.label = mod.Text("label", "campaign-α", "run label")
    sub = mod.Group("o3")
    sub.rob = mod.Scalar("rob", "ROB entries")
    sub.rob += 192
    g.o3 = sub
    return g


def _comparable(blocks):
    """Blocks with NaN as a string (NaN != NaN)."""
    return [{k: repr(v) for k, v in b.items()} for b in blocks]


def test_stats_txt_of_the_port_reads_alike():
    g1, g2 = _group(pstats, 1), _group(pstats, 3)
    text = pstats.dump_text(g1) + "prose between blocks\n" + \
        pstats.dump_text(g2)
    assert text == rstats.dump_text(_group(rstats, 1)) + \
        "prose between blocks\n" + rstats.dump_text(_group(rstats, 3))
    mine = PSF.load_stats_txt(io.StringIO(text))
    ref = RSF.load_stats_txt(io.StringIO(text))
    assert len(mine) == 2
    assert _comparable(mine) == _comparable(ref)
    assert mine[0]["sim.o3.rob"] == 192
    assert mine[0]["sim.label"] == "campaign-α"
    for a, b in ((0, 1), (1, 0), (0, 0), (1, 1)):
        assert PSF.diff_stats(mine[a], mine[b]) == \
            RSF.diff_stats(ref[a], ref[b])
    assert "sim.avf" in PSF.diff_stats(mine[0], mine[1])
    assert PSF.diff_stats(mine[0], mine[0]) == []
    for ignore, tol in ((("sim.trials", "sim.outcomes"), 0.0), ((), 0.9)):
        assert PSF.diff_stats(mine[0], mine[1], rel_tol=tol,
                              ignore=ignore) == \
            RSF.diff_stats(ref[0], ref[1], rel_tol=tol, ignore=ignore)


@pytest.mark.parametrize("text", [
    "a 1\nb 2.5\nc nan\nd word  # desc\nbanner\n",
    "",
    "---------- Begin Simulation Statistics ----------\n"
    "---------- End Simulation Statistics   ----------\n"])
def test_markerless_and_empty_stats_read_alike(text):
    assert _comparable(PSF.load_stats_txt(io.StringIO(text))) == \
        _comparable(RSF.load_stats_txt(io.StringIO(text)))


def test_stats_txt_from_a_path_and_nan_transitions(tmp_path):
    path = tmp_path / "stats.txt"
    path.write_text(pstats.dump_text(_group(pstats, 1)))
    assert _comparable(PSF.load_stats_txt(str(path))) == \
        _comparable(RSF.load_stats_txt(str(path)))
    nan = float("nan")
    for a, b in (({"x": nan}, {"x": 1.0}), ({"x": 1.0}, {"x": nan}),
                 ({"x": nan}, {"x": nan}), ({"x": "a"}, {"x": 1}),
                 ({"x": 1}, {}), ({"x": 0.0}, {"x": 0})):
        assert PSF.diff_stats(a, b) == RSF.diff_stats(a, b)
    assert PSF.diff_stats({"x": nan}, {"x": 1.0}) == ["x"]
    assert json.dumps(PSF.diff_stats({"x": nan}, {"x": nan})) == "[]"
