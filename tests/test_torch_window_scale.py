"""The port's ``tools.window_scale`` against the JAX package's
``tools/window_scale_r05.py``, on a fixed input.

The reference collates hand-written CPU and TPU numbers and projects TPU
rates; the port collates only the ``bigwindow`` documents it reads (ROADMAP
Queue 3 D9).  On the same horizon-rate document the two agree on the rows
they carry over and on ``per_trial_lane_steps_real`` (lanes run × chunk
length / batch), and the port's document holds no TPU key.
"""

import json
import sys

import pytest

from shrewd_tpu_torch.tools import window_scale

from test_torch_northstar import load_reference

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def bigwindow_doc(mode="chunked", platform="cpu", card=None, horizon=2,
                  chunk=65536, build=False):
    """A ``tools.bigwindow`` document of the port, fixed numbers."""
    row = {"lift_rate": 0.9998, "setup_seconds": 1.5,
           "compile_seconds": 40.2, "trials_per_sec": 3.31,
           "batch": 2048, "chunks": 81, "lanes_per_call": 2048,
           "tally": [388, 1520, 140, 0],
           "resolution": {"waves": 162, "lanes_run": 5843,
                          "resolved_frozen": 120, "resolved_eq": 388,
                          "carried": 3655, "resolved_at_end": 12,
                          "chunk_replays": 331776, "horizon_sdc": 1508,
                          "oow_masked": 0, "engine": "taint",
                          "fallback_lanes": 7}}
    if mode == "dense":
        row = {"lift_rate": 1.0, "compile_seconds": 3.0,
               "trials_per_sec": 297.09, "batch": 8192,
               "tally": [10, 8100, 82, 0]}
    elif horizon:
        row["carry_horizon"] = horizon
    rate = {"platform": platform, "mode": mode, "rates": {"5338673": row}}
    if mode == "chunked":
        rate["chunk"] = chunk
    doc = {"rate": rate, "workload": "workloads/lzss.c",
           "platform": platform, "card": card, "setup": {}}
    if build:
        doc["build"] = {"capture_steps": 2124394, "capture_seconds": 205.0,
                        "capture_truncated": False,
                        "lift_4096": {"uops": 4096, "lift_rate": 1.0,
                                      "seconds": 0.3},
                        "lift_65536": {"uops": 65546, "lift_rate": 0.9999,
                                       "seconds": 1.8}}
    return doc


def keys_of(doc) -> set:
    if isinstance(doc, dict):
        return set(doc) | set().union(*map(keys_of, doc.values()))
    if isinstance(doc, list):
        return set().union(*map(keys_of, doc))
    return set()


def test_collation_agrees_with_the_reference(tmp_path, monkeypatch):
    big = tmp_path / "big.json"
    big.write_text(json.dumps(bigwindow_doc()))
    ref_out = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["window_scale_r05.py", "--big-rate",
                                      str(big), "--out", str(ref_out)])
    assert load_reference("window_scale_r05").main() == 0
    ref = json.loads(ref_out.read_text())
    out = tmp_path / "port.json"
    assert window_scale.main(["--big-rate", str(big), "--out", str(out),
                              "--platform", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert got["chunked_horizon"] == ref["chunked_cpu_horizon2"]
    res = got["resolution"]["big_rate"]["5338673"]
    assert res["per_trial_lane_steps_real"] == \
        ref["tpu_projection"]["per_trial_lane_steps_real"] == \
        int(5843 * 65536 / 2048)
    assert (res["lanes_run"], res["chunk_replays"], res["batch"],
            res["chunk"]) == (5843, 331776, 2048, 65536)
    assert got["notes"][0].startswith(ref["notes"][0][:24])
    assert (got["platform"], got["card"]) == ("cpu", None)


def test_collation_keeps_the_reference_structure_without_tpu_keys(tmp_path):
    docs = {"dense": bigwindow_doc("dense", build=True),
            "chunked": bigwindow_doc(horizon=0, chunk=16384),
            "big_rate": bigwindow_doc()}
    paths = []
    for name, doc in docs.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(doc))
        paths += [f"--{name.replace('_', '-')}", str(p)]
    out = tmp_path / "ws.json"
    assert window_scale.main([*paths, "--out", str(out), "--platform",
                              "cpu"]) == 0
    got = json.loads(out.read_text())
    assert list(got) == ["platform", "card", "build", "dense",
                         "chunked_exact", "chunked_horizon", "resolution",
                         "notes"]
    assert got["build"] == {"lzss": {
        "capture_steps": 2124394, "capture_seconds": 205.0,
        "lifts": {"4096": 1.0, "65546": 0.9999}}}
    assert got["dense"] == {"5338673": 297.09}
    assert got["chunked_exact"] == {"5338673": 3.31}
    # each chunked document's own chunk
    assert got["resolution"]["chunked"]["5338673"][
        "per_trial_lane_steps_real"] == int(5843 * 16384 / 2048)
    assert not {k for k in keys_of(got)
                if "tpu" in k.lower() or k.endswith("_r4")}
    assert "tpu" not in json.dumps(got).lower()


def test_resolution_takes_the_windows_own_chunk_length():
    """A window shorter than the chunk asked for is one chunk of its own
    length."""
    doc = bigwindow_doc(horizon=0)
    doc["rate"]["rates"] = {"4096": doc["rate"]["rates"]["5338673"]}
    got = window_scale.collate({"chunked": doc}, "cpu")
    res = got["resolution"]["chunked"]["4096"]
    assert res["chunk"] == 4096
    assert res["per_trial_lane_steps_real"] == int(5843 * 4096 / 2048)


@pytest.mark.parametrize("docs, what", [
    ({"dense": bigwindow_doc("dense", platform="gpu", card=CARD)},
     "a gpu document, not cpu"),
    ({"dense": bigwindow_doc("chunked")}, "a chunked rate document"),
], ids=["platform", "mode"])
def test_collation_refuses_a_mixed_input(tmp_path, capsys, docs, what):
    argv = []
    for name, doc in docs.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(doc))
        argv += [f"--{name}", str(p)]
    out = tmp_path / "ws.json"
    assert window_scale.main([*argv, "--out", str(out), "--platform",
                              "cpu"]) == 2
    assert what in capsys.readouterr().err
    assert not out.exists()


def test_collation_refuses_two_cards():
    with pytest.raises(ValueError, match="more than one card"):
        window_scale.collate({
            "dense": bigwindow_doc("dense", platform="gpu", card=CARD),
            "chunked": bigwindow_doc(platform="gpu", card="another")},
            "gpu")
