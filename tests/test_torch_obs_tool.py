"""``python -m shrewd_tpu_torch.tools.obs`` against the reference's
``tools/obs.py``, on the CPU: over the same flight-recorder dump, Perfetto
trace and ``metrics.json`` (written by a small traced fleet of the port),
both tools print the same output and return the same exit code in every
mode."""

import contextlib
import importlib.util
import io
import json
import os

import pytest

from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.tools import fleet as fleet_cli
from shrewd_tpu_torch.tools import obs as port_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_obs():
    spec = importlib.util.spec_from_file_location(
        "ref_tools_obs", os.path.join(ROOT, "tools", "obs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A traced two-tenant fleet's trace.json and metrics.json, and a
    flight-recorder dump of a tracer's ring."""
    d = tmp_path_factory.mktemp("obs")
    plan = {"structures": ["regfile"], "batch_size": 32, "max_trials": 64,
            "min_trials": 64, "target_halfwidth": 0.2,
            "integrity": {"canary_trials": 0, "audit_rate": 0.0},
            "simpoints": [{"type": "WorkloadSpec", "name": "w0",
                           "workload": {"n": 96, "nphys": 32,
                                        "mem_words": 64,
                                        "working_set_words": 32,
                                        "seed": 7}}]}
    path = str(d / "p.json")
    json.dump(plan, open(path, "w"))
    outdir = str(d / "fleet")
    try:
        rc, _, err = _run(fleet_cli.main, ["--plans", path, path,
                                           "--outdir", outdir, "--trace",
                                           "--platform", "cpu"])
    finally:
        obs_trace.disable()
    assert rc == 0, err
    t = obs_trace.Tracer(ring=64)
    for i in range(5):
        t.emit("batch_done", cat="campaign", tenant=f"t{i % 2}",
               batch_id=i)
    t.emit("tenant_quarantine", cat="fleet", tenant="t1")
    flight = str(d / "flightrec.json")
    t.flight_dump(flight, "quarantine", tenant="t1")
    return {"trace": os.path.join(outdir, "trace.json"),
            "flight": flight, "outdir": outdir, "empty": str(d)}


@pytest.mark.parametrize("mode", [
    ("--summarize", "trace"), ("--summarize", "flight"),
    ("--timeline", "flight"), ("--timeline", "trace"),
    ("--tail", "outdir"), ("--tail", "empty")],
    ids=["summarize-trace", "summarize-flightrec", "timeline-flightrec",
         "timeline-trace", "tail", "tail-missing"])
def test_obs_tool_matches_reference(artifacts, mode):
    flag, what = mode
    argv = [flag, artifacts[what]]
    if flag == "--timeline":
        argv += ["--width", "80"]
    got = _run(port_obs.main, argv)
    want = _run(_ref_obs().main, argv)
    assert got == want
    assert got[0] == (1 if what == "empty" else 0)
    if flag == "--summarize":
        assert json.loads(got[1])


def test_obs_tool_without_a_mode_exits_2():
    assert _run(port_obs.main, [])[0] == _run(_ref_obs().main, [])[0] == 2
