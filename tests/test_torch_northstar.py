"""The port's north-star sweep against the JAX package's, on the CPU.

``shrewd_tpu_torch/tools/northstar.py`` is held against the repo's
``tools/northstar.py`` (imported by path) on ``workloads/rotmix.c``: one
SimPoint window of 2466 µops at interval 4000, k=1. The SimPoint windows of
both packages come from ONE ptrace capture (two captures of one binary
differ): every tracer run in the block replays the first run's bytes
(``one_capture``, built on ``test_torch_lift.shared_captures``). The
documents must be equal once the wall-clock fields and the port's own
fields (``card``, the card's identity, and ``setup``, the set-up seconds)
are dropped. The fleet arm and ``main`` are held in
``test_torch_northstar_fleet.py``, ``tools/simpoint_avf.py`` in
``test_torch_simpoint_avf.py``; both import this module's helpers.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import argparse
import contextlib
import importlib.util
import json
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest

from shrewd_tpu_torch import compat
from shrewd_tpu_torch.tools import northstar

from test_torch_lift import needs_toolchain, shared_captures
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "workloads/rotmix.c"
# wall-clock fields, and the port's own (the card's identity, the set-up
# seconds and window lengths)
WALL = ("wall_clock_s", "trials_per_sec", "total_wall_clock_s",
        "select_seconds", "seconds")
PORT_OWN = ("card", "setup")


def load_reference(name: str):
    """The repo's ``tools/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def one_capture(cache: dict):
    """Within the block, every run of the ptrace tracer, by any module,
    writes the bytes of the first run with the same arguments and binary
    (``simpoint_windows`` imports ``subprocess`` in its body, so the
    shim goes on the module itself)."""
    holder = types.SimpleNamespace(subprocess=subprocess)
    with shared_captures(holder, cache=cache):
        real = subprocess.run
        subprocess.run = holder.subprocess.run
        try:
            yield
        finally:
            subprocess.run = real


def scrub(doc, own=PORT_OWN):
    """A document without its wall-clock fields and the port's own."""
    if isinstance(doc, dict):
        return {k: scrub(v, own) for k, v in doc.items()
                if k not in WALL + own}
    if isinstance(doc, list):
        return [scrub(v, own) for v in doc]
    return doc


def sweep_args(**kw) -> argparse.Namespace:
    """The tools' arguments at the rotmix scale."""
    base = dict(workloads=[WORKLOAD], structures=["regfile", "latch"], k=1,
                interval=4000, halfwidth=0.05, batch=256, max_trials=1024,
                seed=0, fleet_batch=128, sync_every=2, depth_budget=2,
                platform="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def captures():
    return {}


@pytest.fixture(scope="module")
def ref_ns():
    return load_reference("northstar")


@pytest.fixture(scope="module")
def windows(ref_ns, captures):
    """(port, reference) ``_build_windows`` on rotmix from one capture."""
    a = sweep_args()
    with one_capture(captures):
        got = northstar._build_windows(a)
        ref = ref_ns._build_windows(a)
    return got, ref


def test_windows_equal_the_reference(windows):
    got, ref = windows
    assert list(got) == list(ref) == [WORKLOAD]
    assert len(got[WORKLOAD]) == len(ref[WORKLOAD]) == 1
    for (gt, gm), (rt, rm) in zip(got[WORKLOAD], ref[WORKLOAD]):
        conv = compat.trace_from_arrays(
            *(np.asarray(getattr(rt, f)) for f in rt._fields))
        for f in conv._fields:
            np.testing.assert_array_equal(getattr(gt, f), getattr(conv, f),
                                          err_msg=f)
        assert gt.n == 2466
        assert json.dumps(gm, sort_keys=True, default=lambda x: np.asarray(
            x).tolist()) == json.dumps(rm, sort_keys=True,
                                       default=lambda x: np.asarray(
                                           x).tolist())


@pytest.fixture(scope="module")
def serial_docs(windows, ref_ns):
    got, ref = windows
    a = sweep_args()
    return northstar._run_serial(a, got), ref_ns._run_serial(a, ref)


def test_serial_arm_equals_the_reference(serial_docs):
    got, ref = serial_docs
    assert got["platform"] == ref["platform"] == "cpu"
    assert got["card"] is None
    assert scrub(got) == scrub(ref)
    assert got["campaigns"] == 2


@pytest.mark.parametrize("structure", ["regfile", "latch"])
def test_serial_rows_are_whole_batches_and_weighted(serial_docs, structure):
    """Each campaign ran whole batches, stopped converged or at its cap,
    and its weighted AVF is the weights' sum over its SimPoint rows."""
    row = serial_docs[0]["workloads"][WORKLOAD]["structures"][structure]
    assert row["trials"] % 256 == 0 and row["trials"] <= 1024
    assert row["converged"] or row["trials"] == 1024
    assert row["weighted_avf"] == round(sum(
        sp["weight"] * sp["avf"] for sp in row["simpoints"]), 4)
