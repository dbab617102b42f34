"""The port's SimPoint-weighted AVF tool against the JAX package's, on the
CPU.

``shrewd_tpu_torch/tools/simpoint_avf.py`` is held against the repo's
``tools/simpoint_avf.py`` (imported by path) on ``workloads/rotmix.c`` at
interval 4000, k=1, both from ONE ptrace capture
(``test_torch_northstar.one_capture``): the per-window tallies, AVFs and
the weighted AVF must be equal, and with ``--whole-window`` at a small
``--max-steps`` the whole window's too.  The port's documents also record
``platform`` and ``card``, which the reference's do not have.  Every
``--out`` points into ``tmp_path``: the reference's default would
overwrite the repository's committed document.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json
import sys

import pytest

from shrewd_tpu_torch.tools import simpoint_avf

from test_torch_lift import needs_toolchain
from test_torch_northstar import (PORT_OWN, WORKLOAD, load_reference,
                                  one_capture, scrub)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

# the port's own fields of this document
OWN = PORT_OWN + ("platform",)


@pytest.fixture(scope="module")
def captures():
    return {}


def run_both(monkeypatch, tmp_path, captures, argv):
    """``main`` of both packages with ``argv`` (each its own ``--out``
    under ``tmp_path``; the port with ``--platform cpu``) → (port
    document, reference document)."""
    ref = load_reference("simpoint_avf")
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    with one_capture(captures):
        assert simpoint_avf.main([*argv, "--out", str(port_out),
                                  "--platform", "cpu"]) == 0
        monkeypatch.setattr(sys, "argv", ["simpoint_avf.py", *argv,
                                          "--out", str(ref_out)])
        assert ref.main() == 0
    return json.loads(port_out.read_text()), json.loads(ref_out.read_text())


def test_simpoint_avf_equals_the_reference(monkeypatch, tmp_path, captures,
                                           capsys):
    got, ref = run_both(monkeypatch, tmp_path, captures, [
        "--workload", WORKLOAD, "--k", "1", "--trials", "256"])
    assert got["platform"] == "cpu" and got["card"] is None
    assert scrub(got, OWN) == scrub(ref)
    assert [w["tally"] for w in got["windows"]] == [
        w["tally"] for w in ref["windows"]]
    assert sum(got["windows"][0]["tally"]) == 256
    assert got["windows"][0]["uops"] == 2466
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1]) == {
        "weighted_avf": ref["weighted_avf"], "k": 1}


def test_simpoint_avf_whole_window_equals_the_reference(
        monkeypatch, tmp_path, captures):
    """``--whole-window`` at a small ``--max-steps``: the capture stops
    there, and both the SimPoint window and the whole window are lifted
    from that prefix."""
    got, ref = run_both(monkeypatch, tmp_path, captures, [
        "--workload", WORKLOAD, "--k", "1", "--trials", "128",
        "--max-steps", "1500", "--whole-window"])
    assert scrub(got, OWN) == scrub(ref)
    assert got["whole_window"]["tally"] == ref["whole_window"]["tally"]
    assert sum(got["whole_window"]["tally"]) == 128
    assert got["whole_window"]["uops"] > 0
