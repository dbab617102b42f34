"""Content-digest-keyed artifact store for the streaming ingest pipeline.

Every artifact the ingest pipeline produces — the raw capture, the lifted
full-window trace, liveness masks, BBV/SimPoint clusters, per-window
traces and their boundary goldens — is keyed by the CONTENT digest of the
submitted binary plus a canonical hash of the ingest axes (interval, k,
seed, max_steps).  A previously-seen ``(digest, axes)`` pair therefore
starts its campaign in O(1) from the shared store: no capture, no lift,
no emulation — the terminal ``plan`` document points at window traces
that are already durable.

Durability discipline (the same contract the WAL tier certifies):

- JSON documents go through ``resilience.write_json_atomic`` (tmp +
  fsync + rename + dir-fsync) and carry content checksums;
- binary payloads (captures, ``.npz`` windows) are committed via the
  same tmp/fsync/rename/dir-fsync sequence, and each owning document
  records the payload's sha256 — ``get_doc`` re-verifies every byte it
  vouches for, so a torn or rotted payload reads as a MISS (re-lift),
  never as silent corruption;
- a missing/torn/checksum-failed document is also just a miss.  The
  store never quarantines: "this artifact is unusable, recompute it" is
  a cache decision.  "this BINARY is not what its digest claims" is
  poison, and that verdict belongs to the pipeline/queue tier.

Single-flight: two concurrent submissions of the same ``(digest, axes)``
share one lift through an O_EXCL lock file under the object directory
(the ``ServerLock`` discipline: pid-stamped, stale locks reaped).  The
loser waits, then finds the winner's artifacts and warm-starts.

Import discipline: jax-free (pure host-side file work; the pipeline
that fills the store owns the heavy lifter/emulator imports).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.utils import debug

debug.register_flag("Ingest", "streaming ingest pipeline / artifact store")

#: lock files held by THIS process (``_SingleFlight`` bookkeeping): a
#: lock on disk stamped with our pid but absent here is the residue of a
#: chaos kill that unwound without releasing — stale, reap it
_HELD: set = set()

#: per-path locks that order the threads of this process (R7, below)
_THREAD_LOCKS: dict = {}
_THREAD_LOCKS_GUARD = threading.Lock()


def data_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def axes_key(axes: dict | None) -> str:
    """Canonical short key for an ingest-axes dict (sorted-key JSON →
    sha256 prefix): the second half of the store address."""
    blob = json.dumps(dict(axes or {}), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class _SingleFlight:
    """O_EXCL-style pid-stamped lock on one ``(digest, axes)`` object dir.

    Same reaping posture as the JAX package's: a dead-pid or unreadable
    lock is stale and reaped, and a lock stamped with OUR pid that this
    process does not hold in ``_HELD`` is the residue of an in-process
    chaos kill and is reaped the same way.

    Two repairs over the JAX package's copy (ROADMAP Queue 3 R7), where
    two threads of one process could both take the lock:

    - the lock file appears with its pid already in it (written to a
      private file, then ``os.link``-ed into place, which fails if the
      lock exists), so no contender reads it empty and reaps it as
      "pid 0";
    - threads of one process first take a per-path ``threading.Lock``,
      held from before the file is created until after it is removed,
      so a file stamped with our pid and absent from ``_HELD`` is seen
      only when no thread of ours is between creating and recording it.
    """

    def __init__(self, path: str, timeout_s: float = 120.0):
        self.path = path
        self.timeout_s = timeout_s
        self._owned = False
        with _THREAD_LOCKS_GUARD:
            self._tlock = _THREAD_LOCKS.setdefault(path, threading.Lock())

    def _stale(self) -> bool:
        try:
            with open(self.path) as f:
                pid = int(f.read().strip() or "0")
        except (OSError, ValueError):
            return True
        if pid == os.getpid():
            return self.path not in _HELD
        if pid <= 0:
            return True
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except OSError:
            return False
        return False

    def _try_create(self) -> bool:
        """Publish a lock file that already holds our pid; False if one
        exists."""
        tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{os.getpid()}\n")
        try:
            os.link(tmp, self.path)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def __enter__(self) -> "_SingleFlight":
        deadline = time.monotonic() + self.timeout_s
        if not self._tlock.acquire(timeout=self.timeout_s):
            raise RuntimeError(f"{self.path}: single-flight lock held past "
                               f"{self.timeout_s}s")
        try:
            while not self._try_create():
                if self._stale():
                    try:
                        os.unlink(self.path)
                    except OSError:
                        pass
                    continue
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{self.path}: single-flight lock held past "
                        f"{self.timeout_s}s")
                time.sleep(0.02)
        except BaseException:
            self._tlock.release()
            raise
        self._owned = True
        _HELD.add(self.path)
        return self

    def __exit__(self, *exc) -> None:
        if not self._owned:
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass
        _HELD.discard(self.path)
        self._owned = False
        self._tlock.release()


class ArtifactStore:
    """The digest-keyed store (see module doc).

    Layout::

        <root>/bin/<sha256>.elf                  submitted binaries
        <root>/obj/<sha256>/<axes>/<name>.json   checksummed stage docs
        <root>/obj/<sha256>/<axes>/<file>        payloads (sha in doc)
        <root>/obj/<sha256>/<axes>/.lock         single-flight guard

    The same layout as the JAX package's store, so either package reads
    a store the other wrote.  (Its ``exec/`` directory held jax's
    persistent compilation cache, which has no counterpart here.)
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.bin_dir = os.path.join(self.root, "bin")
        self.obj_root = os.path.join(self.root, "obj")
        os.makedirs(self.bin_dir, exist_ok=True)
        os.makedirs(self.obj_root, exist_ok=True)

    # --- submitted binaries ----------------------------------------------

    def binary_path(self, digest: str) -> str:
        return os.path.join(self.bin_dir, f"{digest}.elf")

    def put_binary(self, data: bytes) -> str:
        """Content-address one submitted binary; idempotent (a second
        submission of the same bytes is a no-op hit)."""
        digest = data_digest(data)
        path = self.binary_path(digest)
        if os.path.exists(path):
            return digest
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o755)
        os.replace(tmp, path)
        resil.fsync_dir(self.bin_dir)
        resil.notify_durability("rename", path, kind="store_binary")
        debug.dprintf("Ingest", "stored binary %s (%d bytes)",
                      digest[:12], len(data))
        return digest

    def verify_binary(self, digest: str) -> bool:
        """Does the stored binary still hash to its address?  False is
        POISON (rot/tamper), not a cache miss — the caller quarantines."""
        path = self.binary_path(digest)
        try:
            return file_digest(path) == digest
        except OSError:
            return False

    # --- object directories ----------------------------------------------

    def obj_dir(self, digest: str, key: str) -> str:
        d = os.path.join(self.obj_root, digest, key)
        os.makedirs(d, exist_ok=True)
        return d

    def payload_path(self, digest: str, key: str, filename: str) -> str:
        return os.path.join(self.obj_dir(digest, key), filename)

    def commit_payload(self, tmp_path: str, digest: str, key: str,
                       filename: str) -> str:
        """Durably move a finished scratch file into the store (fsync →
        rename → dir-fsync) and return its sha256 for the owning doc."""
        sha = file_digest(tmp_path)
        final = self.payload_path(digest, key, filename)
        with open(tmp_path, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp_path, final)
        resil.fsync_dir(os.path.dirname(final))
        resil.notify_durability("rename", final, kind="store_payload")
        return sha

    def write_payload(self, digest: str, key: str, filename: str,
                      data: bytes) -> str:
        tmp = self.payload_path(digest, key, filename) \
            + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        return self.commit_payload(tmp, digest, key, filename)

    # --- documents --------------------------------------------------------

    def put_doc(self, digest: str, key: str, name: str,
                doc: dict) -> None:
        """Persist one stage document (checksummed, atomic).  ``doc``
        may carry ``payloads: {filename: sha256}`` — ``get_doc``
        re-verifies each before vouching for the document."""
        resil.write_json_atomic(
            os.path.join(self.obj_dir(digest, key), f"{name}.json"),
            dict(doc))

    def get_doc(self, digest: str, key: str, name: str) -> dict | None:
        """Load + verify one stage document AND every payload it
        records.  ANY failure — missing file, torn JSON, checksum
        mismatch, rotted payload — is a miss (None): the pipeline
        recomputes, it never trusts a damaged artifact."""
        path = os.path.join(self.obj_root, digest, key, f"{name}.json")
        try:
            doc = resil.load_json_verified(path)
        except (OSError, ValueError):
            return None
        for filename, sha in (doc.get("payloads") or {}).items():
            ppath = os.path.join(self.obj_root, digest, key, filename)
            try:
                if file_digest(ppath) != sha:
                    debug.dprintf("Ingest", "payload %s rotted — miss",
                                  filename)
                    return None
            except OSError:
                return None
        return doc

    # --- array artifacts ---------------------------------------------------
    #
    # Generic SoA-array kind (the preprocessed chunk windows, ops/window.py):
    # one checksummed document owning one ``.npy`` payload per named array.
    # numpy is imported inside the methods — the module stays import-light
    # for the jax-free service tier.

    def put_arrays(self, digest: str, key: str, name: str, arrays: dict,
                   meta: dict | None = None) -> dict:
        """Persist ``{field: ndarray}`` as ``<name>.<field>.npy`` payloads
        plus the owning ``<name>.json`` doc (payload shas recorded, so
        ``get_doc``/``get_arrays`` re-verify every byte).  Returns the doc."""
        import numpy as np

        payloads = {}
        for field_name, arr in arrays.items():
            filename = f"{name}.{field_name}.npy"
            tmp = self.payload_path(digest, key, filename) \
                + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.save(f, np.ascontiguousarray(arr))
            payloads[filename] = self.commit_payload(
                tmp, digest, key, filename)
        doc = dict(meta or {})
        doc["fields"] = sorted(arrays)
        doc["payloads"] = payloads
        self.put_doc(digest, key, name, doc)
        debug.dprintf("Ingest", "stored %d arrays under %s/%s/%s",
                      len(arrays), digest[:12], key, name)
        return doc

    def get_arrays(self, digest: str, key: str, name: str,
                   mmap: bool = True):
        """Load one array artifact → ``(doc, {field: ndarray})`` or None
        (miss).  ``mmap=True`` maps payloads read-only — chunk windows
        materialize lazily, so a 26M-µop window opens in O(1)."""
        import numpy as np

        doc = self.get_doc(digest, key, name)
        if doc is None:
            return None
        arrays = {}
        for field_name in doc.get("fields") or []:
            path = self.payload_path(digest, key, f"{name}.{field_name}.npy")
            try:
                arrays[field_name] = np.load(
                    path, mmap_mode="r" if mmap else None)
            except (OSError, ValueError):
                return None
        return doc, arrays

    def lock(self, digest: str, key: str) -> _SingleFlight:
        return _SingleFlight(
            os.path.join(self.obj_dir(digest, key), ".lock"))
