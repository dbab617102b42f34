"""``hostdiff`` in the port: the device column against the JAX package's,
and the CLI on the CPU.

Both packages' ``run_device`` take one lift of one capture of
``workloads/sort.c`` (``shared_captures``, see ``test_torch_lift.py``) and
the same coordinates, and give the same outcome classes and the same
escalation report:

- output mode (the extended window with the VA-space memmap, one truncated
  replay per output event), 64 coordinates, no escalation;
- output mode with escalation to the whole-program 64-bit emulator, on 4
  coordinates of which some escalate;
- the window modes: the static ABI live-out set, and measured liveness.

The pair-lane 64-bit lift (``device64``) is held in ``test_torch_memmap.py``.

``python -m shrewd_tpu_torch hostdiff --trials 8 --platform cpu`` exits
rc 0 and prints the reference's one-line JSON keys.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

from shrewd_tpu.ingest import hostdiff as ref_hd
from shrewd_tpu.trace.format import Trace as RefTrace
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.main import main

from test_torch_lift import needs_toolchain, shared_captures

pytestmark = needs_toolchain

#: the keys of the reference CLI's one-line JSON (shrewd_tpu/main.py)
LINE_KEYS = ["trials", "host_avf", "device_avf", "avf_abs_err",
             "agreement_exact", "agreement_vulnerable", "cis_overlap"]


@pytest.fixture(autouse=True, scope="module")
def _trace_state_alias():
    """R1: ``jax.core.trace_state_clean`` moved in jax 0.9."""
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if missing:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module")
def paths():
    return hd.build_tools("workloads/sort.c")


@pytest.fixture(scope="module")
def captures():
    return {}


@pytest.fixture(scope="module")
def output_lift(paths, captures):
    with shared_captures(hd, cache=captures):
        return hd.capture_and_lift_to_output(paths)


def _both(trace, meta, coords, captures, **kw):
    """(port outcomes, port report, reference outcomes, reference
    report) of ``run_device`` on the same inputs."""
    rep, rrep = {}, {}
    with shared_captures(hd, ref_hd, cache=captures):
        got = hd.run_device(trace, meta, coords, report=rep, device="cpu",
                            **kw)
        if "paths" in kw:
            kw["paths"] = ref_hd.BuildPaths(*kw["paths"])
        ref = ref_hd.run_device(RefTrace(*trace), meta, coords, report=rrep,
                                **kw)
    return got, rep, np.asarray(ref), rrep


def test_output_mode_without_escalation_equals_reference(output_lift,
                                                         captures):
    trace, meta = output_lift
    coords = hd.sample_coords(64, meta["window_macro_ops"], seed=0)
    got, rep, ref, rrep = _both(trace, meta, coords, captures,
                                resolve_diverged=False)
    np.testing.assert_array_equal(got, ref)
    assert rep == rrep and rep["device_memmap"] is True
    assert rep["escalated_total"] > 0
    assert len(np.unique(got)) >= 2


def test_output_mode_with_escalation_equals_reference(paths, output_lift,
                                                      captures):
    trace, meta = output_lift
    coords = hd.sample_coords(4, meta["window_macro_ops"], seed=0)
    got, rep, ref, rrep = _both(trace, meta, coords, captures,
                                paths=paths)
    np.testing.assert_array_equal(got, ref)
    assert rep == rrep
    assert sum(rep.get("diverged_resolved", {}).values()) == \
        rep["escalated_total"] >= 1


@pytest.fixture(scope="module")
def window_lift(paths, captures):
    with shared_captures(hd, cache=captures):
        return hd.capture_and_lift(paths)


@pytest.mark.parametrize("mode", ["abi", "liveness"])
def test_window_modes_equal_reference(paths, captures, window_lift, mode):
    trace, meta = window_lift
    lv = None
    if mode == "liveness":
        from shrewd_tpu_torch.ingest.liveness import post_window_liveness
        lv = post_window_liveness(paths, meta["clusters"])
    coords = hd.sample_coords(64, meta["macro_ops"], seed=1)
    got, _, ref, _ = _both(trace, meta, coords, captures, liveness=lv)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) >= 2


def test_compare_equals_reference():
    rng = np.random.default_rng(4)
    host = rng.integers(0, 3, 200).astype(np.int32)
    dev = np.where(rng.random(200) < 0.9, host,
                   rng.integers(0, 4, 200)).astype(np.int32)
    assert hd.compare(host, dev) == ref_hd.compare(host, dev)


def test_cli_hostdiff_on_the_cpu(tmp_path):
    out = tmp_path / "diff.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["hostdiff", "--trials", "8", "--seed", "0",
                   "--platform", "cpu", "--out", str(out)])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == LINE_KEYS and line["trials"] == 8
    rep = json.loads(out.read_text())
    assert set(ref_hd.compare(np.zeros(1, np.int32),
                              np.zeros(1, np.int32))) <= set(rep)
    assert {"device_diverged", "resync_severed", "escalated_total",
            "device_memmap", "lift_stats", "window_macro_ops",
            "output_words", "output_syscalls"} <= set(rep)
    assert rep["mode"] == "output" and rep["device_memmap"] is True
    assert "diverged_resolution_failed" not in rep
    assert sum(rep.get("diverged_resolved", {}).values()) == \
        rep["escalated_total"]
