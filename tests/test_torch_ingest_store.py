"""The artifact store, the ingest journal and the window store tier,
across the two packages.

``shrewd_tpu_torch.ingest.store.ArtifactStore`` keeps the JAX package's
on-disk layout, so a store written by either package reads in the other:
binaries, checksummed documents, payloads and array artifacts, with rot
read as a miss (or, for a binary, as poison) by both.  The same holds for
the write-ahead journal (``service/journal.py``) and for the preprocessed
chunk windows that ``ops/window.py`` keeps in the store.

The single-flight lock: the JAX package's ``_SingleFlight`` lets two
threads of one process both take the lock (ROADMAP Queue 3 R7).  The
interleavings are driven here step by step, with no sleeps and no races:
the reference's lock reaps a lock file that a thread has created but not
yet recorded as held, and the port's cannot be taken while another thread
is inside its acquisition.
"""

import os
import threading

import numpy as np
import pytest

from shrewd_tpu.ingest import pipeline as ref_pipeline, store as ref_store
from shrewd_tpu.ops import chunked as ref_chunked, window as ref_window
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.trace.format import Trace as RefTrace
from shrewd_tpu.service.journal import FleetJournal as RefJournal
from shrewd_tpu_torch import native
from shrewd_tpu_torch.chaos import rot_file
from shrewd_tpu_torch.ingest import pipeline, store
from shrewd_tpu_torch.ops import window as W
from shrewd_tpu_torch.ops.chunked import preprocess_window
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.parallel.exec_cache import trace_digest
from shrewd_tpu_torch.service.journal import FleetJournal

PKGS = {"port": store, "ref": ref_store}
DIRECTIONS = [("port", "ref"), ("ref", "port")]


@pytest.mark.parametrize("axes", [None, {}, {"k": 5}, {"interval": 1500,
                                                        "k": 2,
                                                        "max_steps": 20000},
                                  {"preprocess": True, "chunk": 1024}])
def test_axes_and_keys_equal_reference(axes):
    norm = pipeline.normalize_axes(axes)
    assert norm == ref_pipeline.normalize_axes(axes)
    assert store.axes_key(norm) == ref_store.axes_key(norm)
    assert pipeline.STAGES == ref_pipeline.STAGES
    assert pipeline.DEFAULT_AXES == ref_pipeline.DEFAULT_AXES
    assert W.store_axes(512) == ref_window.store_axes(512)
    assert store.axes_key(W.store_axes(512)) == ref_store.axes_key(
        ref_window.store_axes(512))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_binaries_docs_and_payloads_cross_read(tmp_path, writer, reader):
    w = PKGS[writer].ArtifactStore(str(tmp_path / "s"))
    r = PKGS[reader].ArtifactStore(str(tmp_path / "s"))
    data = b"\x7fELF not really an ELF"
    digest = w.put_binary(data)
    assert digest == store.data_digest(data) == ref_store.data_digest(data)
    assert r.put_binary(data) == digest            # a hit, not a rewrite
    assert r.verify_binary(digest)
    key = store.axes_key({"k": 3})
    sha = w.write_payload(digest, key, "blob.bin", b"payload bytes")
    w.put_doc(digest, key, "stage", {"n": 7, "payloads": {"blob.bin": sha}})
    assert r.get_doc(digest, key, "stage") == {
        "n": 7, "payloads": {"blob.bin": sha}}
    arrays = {"a": np.arange(12, dtype=np.uint32).reshape(3, 4),
              "b": np.array([-1, 5], np.int64)}
    w.put_arrays(digest, key, "arr", arrays, meta={"v": 1})
    doc, got = r.get_arrays(digest, key, "arr")
    assert doc["v"] == 1 and doc["fields"] == ["a", "b"]
    for f in arrays:
        np.testing.assert_array_equal(got[f], arrays[f])
    # rot: a payload or an array reads as a miss, the binary as poison
    rot_file(w.payload_path(digest, key, "blob.bin"))
    rot_file(w.payload_path(digest, key, "arr.b.npy"))
    rot_file(w.binary_path(digest))
    for s in (w, r):
        assert s.get_doc(digest, key, "stage") is None
        assert s.get_arrays(digest, key, "arr") is None
        assert not s.verify_binary(digest)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_journal_cross_replay_drops_a_torn_tail(tmp_path, writer, reader):
    J = {"port": FleetJournal, "ref": RefJournal}
    path = str(tmp_path / "ingest.jsonl")
    j = J[writer](path)
    j.append("ingest_stage", {"stage": "capture", "ordinal": 0,
                              "cached": False})
    j.append("ingest_done", {"plan": {"simpoints": []}})
    j.close()
    with open(path, "a") as f:
        f.write('{"kind": "ingest_stage", "seq": 2, "chec')   # torn
    recs, torn, valid = J[reader].replay_path(path)
    assert [r["kind"] for r in recs] == ["ingest_stage", "ingest_done"]
    assert torn == 1
    assert J[writer].replay_path(path) == (recs, torn, valid)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_window_store_cross_read(tmp_path, writer, reader):
    """A preprocessed chunk window stored by either package opens in the
    other: the same arrays, counted as a store hit."""
    t = native.generate_trace(seed=4, n=700, nphys=64, mem_words=256,
                              working_set_words=64)
    S = 256
    s = store.ArtifactStore(str(tmp_path / "s"))
    digest = trace_digest(t)
    W.clear_registry()
    ref_window.clear_registry()
    if writer == "port":
        built = preprocess_window(TrialKernel(t, device="cpu"), S, store=s)
    else:
        built = ref_chunked.preprocess_window(
            RefKernel(RefTrace(*t)), S,
            store=ref_store.ArtifactStore(s.root))
    assert (W.STATS["stored"], ref_window.STATS["stored"]) != (0, 0)
    hits = (W.STATS["store_hits"], ref_window.STATS["store_hits"])
    got = (W.load_from_store(s, digest, S) if reader == "port" else
           ref_window.load_from_store(ref_store.ArtifactStore(s.root),
                                      digest, S))
    assert got is not None and got.source == "store"
    assert (W.STATS["store_hits"], ref_window.STATS["store_hits"]) == (
        hits[0] + (reader == "port"), hits[1] + (reader == "ref"))
    assert (got.n, got.S, got.C) == (t.n, S, 3)
    assert isinstance(got.gb_mem, np.memmap)          # opened, not read
    for f in W.TRACE_FIELDS:
        np.testing.assert_array_equal(got.tr[f], built.tr[f], err_msg=f)
    np.testing.assert_array_equal(got.gb_reg, built.gb_reg)
    np.testing.assert_array_equal(got.gb_mem, built.gb_mem)
    W.clear_registry()
    ref_window.clear_registry()


# --- the single-flight lock (R7) --------------------------------------------

def test_reference_lock_reaps_a_lock_being_taken(tmp_path):
    """R7, the reference's fault, in two interleavings: thread A has
    created the lock file, and either (a) not yet written its pid, or (b)
    written it but not yet added the path to ``_HELD``.  Thread B, run
    here at that point, reaps A's lock as stale and takes it too."""
    path = str(tmp_path / ".lock")
    for content in ("", f"{os.getpid()}\n"):
        with open(path, "w") as f:          # A, mid-acquisition
            f.write(content)
        b = ref_store._SingleFlight(path, timeout_s=5.0)
        with b:                             # B does not wait for A
            assert b._owned
        assert not os.path.exists(path)


def test_port_lock_waits_for_a_thread_mid_acquisition(tmp_path):
    """The port's repair: a thread inside its acquisition holds the
    path's thread lock, so another thread times out instead of reaping;
    once the first releases, the second takes the lock."""
    path = str(tmp_path / ".lock")
    a = store._SingleFlight(path)
    a._tlock.acquire()                      # A, mid-acquisition
    try:
        with pytest.raises(RuntimeError, match="held past"):
            with store._SingleFlight(path, timeout_s=0.2):
                pass
    finally:
        a._tlock.release()
    with store._SingleFlight(path) as b:
        with open(path) as f:               # published with its pid in it
            assert f.read() == f"{os.getpid()}\n"
        assert path in store._HELD and b._owned
    assert not os.path.exists(path) and path not in store._HELD


def test_port_lock_still_reaps_residue_and_dead_owners(tmp_path):
    """What the reference reaps as stale, the port reaps too: a lock
    stamped with our pid that no thread holds (a chaos kill's residue),
    a lock of a dead process, and an unreadable one."""
    path = str(tmp_path / ".lock")
    dead = 2 ** 22 + 12345                  # above any pid_max default
    for content in (f"{os.getpid()}\n", f"{dead}\n", "junk"):
        with open(path, "w") as f:
            f.write(content)
        with store._SingleFlight(path, timeout_s=5.0) as lk:
            assert lk._owned
    assert not os.path.exists(path)


def test_port_lock_serializes_threads(tmp_path):
    """Two threads of one process: the second enters only after the
    first has left, whatever the scheduling (events, not sleeps)."""
    path = str(tmp_path / ".lock")
    inside, release = threading.Event(), threading.Event()
    order = []

    def first():
        with store._SingleFlight(path):
            order.append("a in")
            inside.set()
            release.wait(30)
            order.append("a out")

    def second():
        inside.wait(30)
        with store._SingleFlight(path):
            order.append("b in")

    ta, tb = threading.Thread(target=first), threading.Thread(target=second)
    ta.start()
    tb.start()
    inside.wait(30)
    assert order == ["a in"]
    release.set()
    ta.join(30)
    tb.join(30)
    assert order == ["a in", "a out", "b in"]


def test_port_lock_stress_holds_one_holder_at_a_time(tmp_path):
    """16 threads (more than the cores) take the port's lock 20 times
    each under a shortened switch interval: at no time do two hold it,
    and no entry is lost."""
    import sys

    path = str(tmp_path / ".lock")
    inside, most, entries = [0], [0], [0]
    guard = threading.Lock()

    def worker():
        for _ in range(20):
            with store._SingleFlight(path, timeout_s=60.0):
                with guard:
                    inside[0] += 1
                    most[0] = max(most[0], inside[0])
                    entries[0] += 1
                with guard:
                    inside[0] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (most[0], entries[0]) == (1, 16 * 20)
    assert not os.path.exists(path)
