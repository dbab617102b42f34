"""The port's journaled ingest pipeline against the JAX package's.

At the reference test's axes on ``workloads/sort.c`` (plus the terminal
``preprocess`` stage), both packages' ``IngestPipeline`` give the same
stage documents, the same windows (trace arrays and metadata) and the same
preprocessed chunk windows; a warm start of either package on the other's
store does no capture and no lift.  The port's quarantine verdicts (digest
rot under the ``corrupt_binary`` chaos kind, an unparseable ELF, a binary
without markers) are durable, ``kill_during_lift`` resumes from the last
durable stage, and two concurrent submissions share one lift — driven by
events, so the test is deterministic.

The tracer runs once per command line (``shared_captures``, see
``test_torch_lift.py``), so both packages ingest one capture.
"""

import os
import subprocess
import threading

import numpy as np
import pytest

from shrewd_tpu.ingest import pipeline as ref_pipeline
from shrewd_tpu.ingest.pipeline import IngestPipeline as RefPipeline
from shrewd_tpu.ingest.store import ArtifactStore as RefStore
from shrewd_tpu.trace import format as ref_tf
from shrewd_tpu_torch.chaos import ChaosEngine
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.ingest import pipeline as port_pipeline
from shrewd_tpu_torch.ingest.pipeline import (STAGES, IngestPipeline,
                                              IngestQuarantine)
from shrewd_tpu_torch.ingest.store import ArtifactStore
from shrewd_tpu_torch.ops import window as W
from shrewd_tpu_torch.service.journal import FleetJournal
from shrewd_tpu_torch.trace import format as tf

from test_torch_lift import (assert_trace_equal, meta_json,
                             needs_toolchain, shared_captures)

pytestmark = needs_toolchain

AXES = {"interval": 1500, "k": 2, "max_steps": 20000}
PRE_AXES = {**AXES, "preprocess": True, "chunk": 512}


@pytest.fixture(scope="module")
def binary():
    return open(hd.build_tools("workloads/sort.c").workload, "rb").read()


@pytest.fixture(scope="module")
def captures():
    return {}


def _kinds(outdir):
    return [r["kind"] for r in FleetJournal.replay_path(
        os.path.join(outdir, "ingest.jsonl"))[0]]


def _no_payloads(doc):
    return {k: v for k, v in doc.items() if k != "payloads"}


@pytest.fixture(scope="module")
def cold_runs(tmp_path_factory, binary, captures):
    """Both packages' cold runs at PRE_AXES, each in its own store."""
    root = tmp_path_factory.mktemp("ingest")
    out = {}
    with shared_captures(port_pipeline, ref_pipeline, cache=captures):
        for name, S, P in (("port", ArtifactStore, IngestPipeline),
                           ("ref", RefStore, RefPipeline)):
            store = S(str(root / name / "store"))
            digest = store.put_binary(binary)
            pipe = P(str(root / name / "t" / "ingest"), store, digest,
                     axes=PRE_AXES)
            out[name] = (store, digest, pipe, pipe.run())
    return root, out


def test_windows_and_stage_docs_equal_reference(cold_runs):
    _root, runs = cold_runs
    store, digest, pipe, plan = runs["port"]
    rstore, rdigest, rpipe, rplan = runs["ref"]
    assert digest == rdigest and pipe.key == rpipe.key
    assert _no_payloads(plan) == _no_payloads(rplan)
    assert [e["name"] for e in plan["simpoints"]] == ["sp6", "sp3"]
    for stage in STAGES + ("preprocess",):
        assert _no_payloads(store.get_doc(digest, pipe.key, stage)) == \
            _no_payloads(rstore.get_doc(digest, pipe.key, stage)), stage
    for e in plan["simpoints"]:
        trace, meta = tf.load(store.payload_path(digest, pipe.key,
                                                 e["file"]))
        rtrace, rmeta = ref_tf.load(rstore.payload_path(digest, pipe.key,
                                                        e["file"]))
        assert_trace_equal(trace, rtrace)
        assert meta_json(meta) == meta_json(rmeta)
    assert (pipe.captures, pipe.lifts) == (rpipe.captures, rpipe.lifts) \
        == (1, 1 + len(plan["simpoints"]))
    assert _kinds(pipe.outdir) == _kinds(rpipe.outdir)


def test_preprocessed_windows_equal_reference(cold_runs):
    """The ``preprocess`` stage stored each window under its trace digest
    in both stores, with equal arrays."""
    _root, runs = cold_runs
    store, digest, pipe, _ = runs["port"]
    rstore = runs["ref"][0]
    doc = store.get_doc(digest, pipe.key, "preprocess")
    assert doc["chunk"] == 512 and len(doc["windows"]) == 2
    for w in doc["windows"]:
        got = W.load_from_store(store, w["trace_digest"], w["S"])
        ref = W.load_from_store(rstore, w["trace_digest"], w["S"])
        assert got.C == w["C"] == ref.C >= 2
        for f in W.TRACE_FIELDS:
            np.testing.assert_array_equal(got.tr[f], ref.tr[f])
        np.testing.assert_array_equal(got.gb_reg, ref.gb_reg)
        np.testing.assert_array_equal(got.gb_mem, ref.gb_mem)


@pytest.mark.parametrize("pkg,on", [("port", "port"), ("port", "ref"),
                                    ("ref", "port")])
def test_warm_start_does_no_capture_and_no_lift(cold_runs, pkg, on):
    root, runs = cold_runs
    store, digest, pipe, plan = runs[on]
    S, P = {"port": (ArtifactStore, IngestPipeline),
            "ref": (RefStore, RefPipeline)}[pkg]
    outdir = str(root / f"warm_{pkg}_on_{on}" / "ingest")
    warm = P(outdir, S(store.root), digest, axes=PRE_AXES)
    assert warm.run() == plan
    assert (warm.captures, warm.lifts) == (0, 0)
    assert _kinds(outdir) == ["ingest_stage"] * (len(STAGES) + 1) + [
        "ingest_done"]


def test_resolved_plan_points_at_the_stored_windows(cold_runs):
    _root, runs = cold_runs
    store, digest, pipe, plan = runs["port"]
    rpipe = runs["ref"][2]
    base = {"structures": ["regfile"], "batch_size": 16, "simpoints": []}
    got = pipe.resolved_plan(base)
    assert [s["name"] for s in got["simpoints"]] == ["sp6", "sp3"]
    assert all(os.path.exists(s["path"]) for s in got["simpoints"])
    # the same plan as the reference's, up to the store root
    ref = rpipe.resolved_plan(base)
    strip = [os.path.relpath(s["path"], store.root) for s in
             got["simpoints"]]
    assert strip == [os.path.relpath(s["path"], rpipe.store.root)
                     for s in ref["simpoints"]]


def test_unparseable_elf_quarantines_durably(tmp_path):
    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put_binary(b"this is not an ELF")
    outdir = str(tmp_path / "t" / "ingest")
    with pytest.raises(IngestQuarantine) as ei:
        IngestPipeline(outdir, store, digest).run()
    assert ei.value.stage == "capture"
    again = IngestPipeline(outdir, store, digest)
    assert again.quarantine_rec is not None
    with pytest.raises(IngestQuarantine):
        again.run()
    assert (again.captures, again.lifts) == (0, 0)
    assert _kinds(outdir) == ["ingest_quarantine"]


def test_markerless_binary_quarantines_at_capture(tmp_path):
    src = tmp_path / "plain.c"
    src.write_text("int main(void) { return 0; }\n")
    exe = tmp_path / "plain"
    subprocess.run(["gcc", "-O1", "-static", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put_binary(exe.read_bytes())
    pipe = IngestPipeline(str(tmp_path / "t" / "ingest"), store, digest)
    with pytest.raises(IngestQuarantine, match="marker") as ei:
        pipe.run()
    assert ei.value.stage == "capture"
    assert pipe.quarantine_rec["stage"] == "capture"


def test_corrupt_binary_chaos_quarantines_at_stage(tmp_path, binary):
    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put_binary(binary)
    eng = ChaosEngine({"faults": [{"kind": "corrupt_binary",
                                   "at_stage": [1]}]})
    outdir = str(tmp_path / "t" / "ingest")
    pipe = IngestPipeline(outdir, store, digest, axes=AXES, chaos=eng)
    with pytest.raises(IngestQuarantine, match="no longer hashes") as ei:
        pipe.run()
    assert ei.value.stage == "lift"
    assert store.get_doc(digest, pipe.key, "capture") is not None
    assert not store.verify_binary(digest)
    assert _kinds(outdir) == ["ingest_stage", "ingest_quarantine"]
    assert eng.injected == {"corrupt_binary": 1}


def test_kill_during_lift_resumes_from_durable_stage(tmp_path, binary):
    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put_binary(binary)

    class Killed(Exception):
        pass

    eng = ChaosEngine({"faults": [{"kind": "kill_during_lift",
                                   "at_stage": [1]}]})
    eng.kill_action = lambda rc: (_ for _ in ()).throw(Killed())
    outdir = str(tmp_path / "t" / "ingest")
    with pytest.raises(Killed):
        IngestPipeline(outdir, store, digest, axes=AXES, chaos=eng).run()
    recs = FleetJournal.replay_path(os.path.join(outdir, "ingest.jsonl"))[0]
    assert [(r["kind"], r["stage"]) for r in recs] == [
        ("ingest_stage", "capture")]
    redo = IngestPipeline(outdir, store, digest, axes=AXES)
    plan = redo.run()
    assert redo.captures == 0
    assert redo.lifts == 1 + len(plan["simpoints"])
    assert store.get_doc(digest, redo.key, "plan") is not None


def test_concurrent_submissions_share_one_lift(tmp_path, binary):
    """Pipeline A holds the single-flight lock inside its capture stage
    until B has entered ``run``; B then waits on the lock, re-probes and
    warm-starts from A's artifacts.  Events fix the interleaving."""
    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put_binary(binary)
    pipes = [IngestPipeline(str(tmp_path / f"t{i}" / "ingest"), store,
                            digest, axes=AXES) for i in range(2)]
    a_holds, b_probing = threading.Event(), threading.Event()
    capture = pipes[0]._stage_capture

    def held_capture():
        a_holds.set()
        assert b_probing.wait(60)
        capture()

    pipes[0]._stage_capture = held_capture
    probe = pipes[1]._plan_probe

    def b_probe():
        got = probe()
        b_probing.set()
        return got

    pipes[1]._plan_probe = b_probe
    plans, errs = [None, None], []

    def run(i):
        try:
            if i == 1:
                assert a_holds.wait(60)
            plans[i] = pipes[i].run()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs, errs
    assert plans[0] == plans[1] is not None
    assert [(p.captures, p.lifts) for p in pipes] == [
        (1, 1 + len(plans[0]["simpoints"])), (0, 0)]
    recs = FleetJournal.replay_path(os.path.join(pipes[1].outdir,
                                                 "ingest.jsonl"))[0]
    assert [r["cached"] for r in recs if r["kind"] == "ingest_stage"] == \
        [True] * len(STAGES)
