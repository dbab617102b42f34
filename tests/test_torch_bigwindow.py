"""The port's ``tools.bigwindow`` against the JAX package's, on the CPU.

``shrewd_tpu_torch/tools/bigwindow.py`` builds ``workloads/lzss.c``'s
windows at 512 and 2048 µops from one ptrace capture cut at a small
``--max-steps``.  The reference's build raises on a cut capture (its
tracer call checks rc 0), so each window is held against the reference's
``lift`` of the same capture bytes (``shared_captures`` keeps them), as
``test_torch_lift.py`` holds the lifter.  ``rate`` is held against the
reference tool's ``rate`` on the same cached windows (its cache pointed
at the port's), dense and chunked, at a small batch: the tallies bit for
bit, and every field of the rows but the wall-clock ones.  The windows go
to a directory of the module's own (``bigwindow.CACHE``).

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json

import numpy as np
import pytest
import torch

from shrewd_tpu.ingest.lift import lift as ref_lift
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.tools import bigwindow
from shrewd_tpu_torch.trace import format as tfmt

from test_torch_lift import assert_trace_equal, needs_toolchain, \
    shared_captures
from test_torch_northstar import load_reference
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

pytestmark = needs_toolchain

LENGTHS = (512, 2048)
MAX_STEPS = 3000                # ~2040 macro-steps lift to 2048 µops
WORKLOAD = "workloads/lzss.c"
CHUNK = 512                     # 4 chunks of the 2048-µop window
BATCH = 64
WALL = ("compile_seconds", "setup_seconds", "trials_per_sec")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's ``build`` into a directory of the module's own, from one
    capture → (its info, the capture's bytes, the cache directory)."""
    d = tmp_path_factory.mktemp("bigwindow")
    saved, bigwindow.CACHE = bigwindow.CACHE, d
    cache: dict = {}
    setup: dict = {}
    try:
        with shared_captures(bigwindow, cache=cache):
            info = bigwindow.build(LENGTHS, WORKLOAD, MAX_STEPS, setup)
        yield info, next(iter(cache.values()))[0], d, setup
    finally:
        bigwindow.CACHE = saved


@pytest.fixture
def in_cache(built):
    saved, bigwindow.CACHE = bigwindow.CACHE, built[2]
    yield built[2]
    bigwindow.CACHE = saved


def test_build_lifts_the_reference_windows(built, tmp_path):
    info, data, d, setup = built
    assert info["capture_truncated"] is True
    # the last record of a cut capture is read as the state at its end
    assert info["capture_steps"] == MAX_STEPS - 1
    assert "tools_seconds" in setup
    capture = tmp_path / "capture.bin"
    capture.write_bytes(data)
    binary = str(hd.build_tools(WORKLOAD).workload)
    for n in LENGTHS:
        got, meta = tfmt.load(d / f"lzss_w{n}.npz")
        ref, ref_meta = ref_lift(str(capture), binary, max_uops=n)
        assert got.n == ref.n == info[f"lift_{n}"]["uops"] >= n
        assert_trace_equal(got, ref)
        assert info[f"lift_{n}"]["lift_rate"] == round(
            ref_meta["stats"]["lift_rate"], 4)
        assert meta["stats"] == json.loads(json.dumps(ref_meta["stats"]))


def test_build_refuses_a_length_past_the_capture(built, in_cache):
    with pytest.raises(RuntimeError, match="raise --max-steps"):
        with shared_captures(bigwindow, cache={}):
            bigwindow.build((1 << 16,), WORKLOAD, 500)


def _scrub(rate: dict) -> dict:
    return {n: {k: v for k, v in row.items() if k not in WALL}
            for n, row in rate["rates"].items()}


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_rate_equals_the_reference(built, in_cache, monkeypatch, chunked):
    """Both tools on the same windows and keys: dense, the reference's row
    with the port's ``tally`` beside it (held against the reference's
    ``TrialKernel.run_keys``); chunked, every field of the row."""
    ref = load_reference("bigwindow")
    monkeypatch.setattr(ref, "CACHE", in_cache)
    kw = dict(batch=BATCH, reps=1, workload=WORKLOAD, chunked=chunked,
              chunk=CHUNK, trials=BATCH)
    got = bigwindow.rate(LENGTHS, device=torch.device("cpu"), **kw)
    want = ref.rate(LENGTHS, **kw)
    assert got["platform"] == want["platform"] == "cpu"
    assert got["mode"] == want["mode"]
    rows = _scrub(got)
    if chunked:
        assert rows == _scrub(want)
        assert [r["chunks"] for r in rows.values()] == [1, 4]
        return
    from shrewd_tpu.models.o3 import O3Config
    from shrewd_tpu.ops.trial import TrialKernel
    from shrewd_tpu.utils import prng

    keys = prng.trial_keys(prng.campaign_key(0), BATCH)
    for n, row in rows.items():
        tally = row.pop("tally")
        assert sum(tally) == BATCH
        tr, _ = tfmt.load(in_cache / f"lzss_w{n}.npz")
        assert tally == np.asarray(TrialKernel(tr, O3Config()).run_keys(
            keys, "regfile")).tolist()
    assert rows == _scrub(want)


def test_chunked_equals_dense_on_the_same_keys(built, in_cache):
    cpu = torch.device("cpu")
    kw = dict(reps=1, workload=WORKLOAD, chunk=CHUNK, device=cpu)
    dense = bigwindow.rate(LENGTHS, batch=BATCH, **kw)
    chunked = bigwindow.rate(LENGTHS, trials=BATCH, chunked=True, **kw)
    assert {n: r["tally"] for n, r in dense["rates"].items()} == \
        {n: r["tally"] for n, r in chunked["rates"].items()}


def test_main_writes_the_ports_document(built, in_cache, tmp_path):
    """``main`` with ``--platform cpu``: the rate document beside the
    workload, platform, card (null on the CPU) and set-up seconds."""
    out = tmp_path / "bw.json"
    assert bigwindow.main(["--rate", "--lengths", "512", "--batch", "32",
                           "--reps", "1", "--out", str(out),
                           "--platform", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert (doc["workload"], doc["platform"], doc["card"]) == \
        (WORKLOAD, "cpu", None)
    assert list(doc["setup"]["kernel_seconds"]) == ["512"]
    row = doc["rate"]["rates"]["512"]
    assert row["batch"] == 32 and sum(row["tally"]) == 32


def test_default_batches_take_the_accelerator_branch_on_the_card():
    assert bigwindow.default_batch(4096, True, False) == 131072
    assert bigwindow.default_batch(65546, True, False) == 8190
    assert bigwindow.default_batch(524288, True, False) == 1024
    assert bigwindow.default_batch(4096, False, False) == 8192
    assert bigwindow.default_batch(4096, True, True) == 16384
    assert bigwindow.default_batch(65546, True, True) == 16384
    assert bigwindow.default_batch(524288, True, True) == 8192
    assert bigwindow.default_batch(4096, False, True) == 2048
    assert bigwindow.default_batch(1 << 22, True, True) == 1024


@pytest.mark.parametrize("fails, complete", [(1, True), (3, False)],
                         ids=["retaken", "given_up"])
def test_run_tracer_takes_a_short_capture_again(capsys, fails, complete):
    """``hostdiff.run_tracer`` re-runs a capture that missed its end, up to
    ``CAPTURE_ATTEMPTS`` times, and reports each short attempt."""
    import subprocess

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if len(calls) <= fails:
            return subprocess.CompletedProcess(
                cmd, 1, "", "nativetrace: 2000000 steps, 4 regions, "
                "TRUNCATED")
        return subprocess.CompletedProcess(
            cmd, 1, "", "child exited mid-window after 4171 steps")

    proc = hd.run_tracer(run, ["nativetrace", "out.bin", "0", "lzss"],
                         hd.exit_complete)
    assert hd.exit_complete(proc) is complete
    assert len(calls) == min(fails + 1, hd.CAPTURE_ATTEMPTS)
    err = capsys.readouterr().err
    assert err.count("capture of lzss, attempt") == min(
        fails, hd.CAPTURE_ATTEMPTS)
    assert "TRUNCATED" in err


def test_stuck_and_passes_read_the_capture(built, tmp_path):
    """``hostdiff.stuck`` flags a capture whose last steps repeat one state
    (the cut lzss capture advances); ``passes`` finds a pc in it."""
    import struct

    data = built[1]
    path = tmp_path / "cut.bin"
    path.write_bytes(data)
    assert not hd.stuck(path)
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    nt = read_nativetrace(path)
    assert hd.passes(path, int(nt.steps[5, 16]))
    assert not hd.passes(path, 0)
    # the same header and snapshot, then one step 200 times
    head = len(data) - nt.steps.nbytes
    n = 200
    frozen = data[:head] + nt.steps[:1].tobytes() * n
    frozen = frozen[:24] + struct.pack("<Q", n) + frozen[32:]
    path.write_bytes(frozen)
    assert hd.stuck(path)
