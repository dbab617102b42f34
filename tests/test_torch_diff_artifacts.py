"""The port's ``tools.diff_artifacts`` against the JAX package's, on the
CPU.

``shrewd_tpu_torch/tools/diff_artifacts.py`` is held against the repo's
``tools/diff_artifacts.py`` (imported by path) in ``output`` mode at 4
trials over ``workloads/rotmix.c`` and a workload path that does not
exist.  Both sides take ONE ptrace capture (``test_torch_northstar.
one_capture``) and ONE run of the host's ptrace SFI per coordinate list
(``one_host``: two runs of a binary under ptrace may differ): rotmix's
row — host and device AVF, agreement, escalations, lift rate, µops — and
the missing workload's ``error`` row must be equal once the port's
``card`` and the seconds are dropped.  ``test_torch_threeway.py`` imports
``one_host``.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import contextlib
import hashlib
import json
import subprocess
import sys

from shrewd_tpu_torch.tools import diff_artifacts

from test_torch_lift import needs_toolchain
from test_torch_northstar import load_reference, one_capture, scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

MISSING = "workloads/no_such_workload.c"


@contextlib.contextmanager
def one_host(cache: dict, seen: list | None = None):
    """Within the block, every run of the host's ptrace SFI tool
    (``hostsfi COORDS RESULTS BEGIN END BINARY``, by either package) on
    the same coordinates, markers and binary (by content) writes the first
    run's results; ``seen`` takes each run's command."""
    inner = subprocess.run

    def run(cmd, *a, **kw):
        if not str(cmd[0]).endswith("hostsfi"):
            return inner(cmd, *a, **kw)
        if seen is not None:
            seen.append(cmd)
        with open(cmd[1], "rb") as f:
            coords = f.read()
        with open(cmd[-1], "rb") as f:
            binary = hashlib.sha256(f.read()).hexdigest()
        key = (coords, *map(str, cmd[3:-1]), binary)
        if key not in cache:
            proc = inner(cmd, *a, **kw)
            with open(cmd[2], "rb") as f:
                cache[key] = (f.read(), proc)
        data, proc = cache[key]
        with open(cmd[2], "wb") as f:
            f.write(data)
        return proc

    subprocess.run = run
    try:
        yield
    finally:
        subprocess.run = inner


def test_diff_artifacts_equals_the_reference(monkeypatch, tmp_path, capsys):
    argv = ["--mode", "output", "--trials", "4", "--workloads",
            "workloads/rotmix.c", MISSING]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    with one_host({}), one_capture({}):
        assert diff_artifacts.main([*argv, "--out", str(port_out),
                                    "--platform", "cpu"]) == 0
        monkeypatch.setattr(sys, "argv", ["diff_artifacts.py", *argv,
                                          "--out", str(ref_out)])
        assert load_reference("diff_artifacts").main() == 0
    got = json.loads(port_out.read_text())
    ref = json.loads(ref_out.read_text())
    assert got["card"] is None
    assert scrub(got) == scrub(ref)
    row = got["workloads"]["workloads/rotmix.c"]
    assert "error" not in row and row["trials"] == 4
    assert sum(row["diverged_resolved"].values()) == row["escalated_total"]
    assert set(got["workloads"][MISSING]) == {"error", "seconds"}
    assert got["workloads"][MISSING]["error"] == \
        ref["workloads"][MISSING]["error"]
    assert got["summary"]["workloads_ok"] == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1]) == got["summary"]
