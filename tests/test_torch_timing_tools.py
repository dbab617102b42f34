"""The port's ``tools.timing_validate`` against the JAX package's, on the
CPU.

``shrewd_tpu_torch/tools/timing_validate.py`` is held against the repo's
``tools/timing_validate.py`` (imported by path) on ``workloads/sort.c``,
both from ONE ptrace capture (``test_torch_northstar.one_capture``) and one
run of the rdtsc harness (``one_harness``: the cycle count changes from run
to run, so every later run of a harness binary of the same name prints the
first run's output).  The documents must be equal once the port's ``card``
is dropped.  ``tools.timing_effect`` is held in
``test_torch_timing_effect.py``, which imports this module's helpers.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.tools import timing_validate

from test_torch_lift import needs_toolchain
from test_torch_northstar import load_reference, one_capture, scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain


@contextlib.contextmanager
def one_harness(cache: dict):
    """Within the block, every run of an rdtsc harness (``rdtsc_<stem>``,
    built by either package) returns the first run's result."""
    inner = subprocess.run

    def run(cmd, *a, **kw):
        name = Path(str(cmd[0])).name
        if not name.startswith("rdtsc_"):
            return inner(cmd, *a, **kw)
        if name not in cache:
            cache[name] = inner(cmd, *a, **kw)
        return cache[name]

    subprocess.run = run
    try:
        yield
    finally:
        subprocess.run = inner


def run_both(monkeypatch, tmp_path, name, port_main, argv, captures):
    """``main`` of the port's tool and of the reference's ``tools/<name>.py``
    with ``argv`` (each its own ``--out`` under ``tmp_path``; the port
    with ``--platform cpu``), inside one capture → (port document,
    reference document, port rc, reference rc)."""
    ref = load_reference(name)
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    with one_capture(captures):
        rc = port_main([*argv, "--out", str(port_out), "--platform", "cpu"])
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv,
                                          "--out", str(ref_out)])
        ref_rc = ref.main()
    return (json.loads(port_out.read_text()),
            json.loads(ref_out.read_text()), rc, ref_rc)


@pytest.fixture(scope="module")
def captures():
    return {}


def test_timing_validate_equals_the_reference(monkeypatch, tmp_path,
                                              captures):
    with one_harness({}):
        got, ref, rc, ref_rc = run_both(monkeypatch, tmp_path,
                                        "timing_validate",
                                        timing_validate.main, [], captures)
    assert rc == ref_rc == 0
    assert got["card"] is None
    assert scrub(got) == ref
    assert got["uops"] == got["proxy_cycles"] > 0
    assert got["host_cycles_median"] > 0
    assert got["scoreboard_cycles"] < got["scoreboard_squash_cycles"]


def test_timing_validate_builds_into_the_ports_build_directory():
    """D8: the harness is the port's own binary, not the reference's
    ``tests/_build`` one (``sort.c`` is the workload with the harness's
    ``workload_init`` and ``kernel_payload``)."""
    harness = timing_validate.build_harness("workloads/sort.c")
    assert harness == hd.BUILD_DIR / "rdtsc_sort"
    cycles = int(subprocess.run([str(harness)], check=True,
                                capture_output=True, text=True).stdout)
    assert cycles > 0
