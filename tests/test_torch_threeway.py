"""The port's ``tools.threeway_diff`` against the JAX package's, on the
CPU.

``shrewd_tpu_torch/tools/threeway_diff.py`` is held against the repo's
``tools/threeway_diff.py`` (imported by path) on ``GEM5_GOLDEN_ROTMIX_
r04.json`` trimmed to its first 16 trials (written into ``tmp_path``):
``workloads/rotmix.c`` built with the host's gcc is gem5's binary (the
sha256 check passes), both sides take ONE ptrace capture and ONE host SFI
run (``one_capture``, ``one_host``), and the documents — the three
tallies, AVFs and agreements, the host re-run's stability, the device
report and the disagreements — must be equal once the port's ``card`` is
dropped.  A golden whose ``binary_sha`` is not the built binary's is
refused by both tools, with the same message, before any host SFI run and
before any device replay.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json
import sys

import pytest

from shrewd_tpu.ingest import hostdiff as ref_hd
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.tools import threeway_diff

from test_torch_diff_artifacts import one_host
from test_torch_lift import needs_toolchain
from test_torch_northstar import ROOT, load_reference, one_capture, scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

GOLDEN = ROOT / "GEM5_GOLDEN_ROTMIX_r04.json"


def golden(tmp_path, n: int, **kw):
    """The rotmix golden trimmed to its first ``n`` trials, with ``kw``
    set, written into ``tmp_path`` → its path."""
    doc = json.loads(GOLDEN.read_text())
    doc["trials"] = doc["trials"][:n]
    doc.update(kw)
    path = tmp_path / f"golden_{n}.json"
    path.write_text(json.dumps(doc))
    return path


def test_threeway_equals_the_reference(monkeypatch, tmp_path, capsys):
    argv = ["--golden", str(golden(tmp_path, 16))]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    with one_host({}), one_capture({}):
        assert threeway_diff.main([*argv, "--out", str(port_out),
                                   "--platform", "cpu"]) == 0
        monkeypatch.setattr(sys, "argv", ["threeway_diff.py", *argv,
                                          "--out", str(ref_out)])
        assert load_reference("threeway_diff").main() == 0
    got = json.loads(port_out.read_text())
    ref = json.loads(ref_out.read_text())
    assert got["card"] is None
    assert scrub(got) == ref
    assert got["coords"] == 16
    assert sum(got["tallies"]["device"].values()) == 16
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1])


def test_both_tools_refuse_another_binary_before_any_trial(monkeypatch,
                                                            tmp_path):
    argv = ["--golden", str(golden(tmp_path, 4, binary_sha="0" * 64))]
    calls = []

    def counted(name, real):
        def run(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return run

    for mod in (hd, ref_hd):
        for name in ("run_host", "run_device",
                     "capture_and_lift_to_output"):
            monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    seen = []
    with one_host({}, seen):
        with pytest.raises(threeway_diff.BinaryMismatch) as port:
            threeway_diff.main([*argv, "--out", str(tmp_path / "p.json"),
                                "--platform", "cpu"])
        monkeypatch.setattr(sys, "argv", ["threeway_diff.py", *argv,
                                          "--out", str(tmp_path / "r.json")])
        with pytest.raises(AssertionError) as ref:
            load_reference("threeway_diff").main()
    assert str(port.value) == str(ref.value)
    assert str(port.value).startswith("built workloads/rotmix.c sha "
                                      "67da870c378b != golden artifact's "
                                      "000000000000")
    assert calls == [] and seen == []
    assert not (tmp_path / "p.json").exists()
