"""Preprocessed chunk-window container and process registry.

Port of ``shrewd_tpu/ops/window.py``.  A ``PreprocessedWindow`` is
everything the chunked engines (``ops/chunked.py``) need that depends only
on the trace and the chunk length S, not on the campaign config: the
NOP-padded SoA trace arrays (C·S µops, so the hot loop slices views instead
of re-padding per chunk) and the golden boundary states at every chunk edge
(the in-window checkpoints).

Three tiers of reuse, cheapest first:

1. **process registry**: an LRU of recent windows keyed by
   ``(trace digest, S, memmap identity)``; a second campaign over the same
   trace and S skips the padding and the boundary pass (``STATS`` counts);
2. **artifact store**: ``ingest/store.py ArtifactStore`` objects under the
   trace's content digest, one ``window_chunks`` document per (digest, S)
   and one ``.npy`` payload per array, loaded ``mmap_mode="r"`` so a
   stored window opens in O(1).  The layout is the JAX package's, so
   either package opens a window the other stored;
3. **build**: ``ops/chunked.py preprocess_window`` pads, runs the boundary
   pass, and back-fills tiers 1-2 (a memmap window only tier 1).

numpy-only at import; ``tr_dev`` uploads the padded trace to a device on
first use, once per (window, device).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

#: SoA trace field order (matches ops.replay.TraceArrays)
TRACE_FIELDS = ("opcode", "dst", "src1", "src2", "imm", "taken")

#: store addressing: one doc + payloads per (trace digest, chunk size)
DOC_NAME = "window_chunks"
STORE_VERSION = 1

#: warm-start observability: builds = golden-boundary passes actually run
#: in this process
STATS = {"builds": 0, "registry_hits": 0, "store_hits": 0, "stored": 0}

_REGISTRY: OrderedDict = OrderedDict()
_REGISTRY_MAX = 4


class PreprocessedWindow:
    """Padded SoA chunk arrays + golden boundary states for one trace.

    ``tr`` maps TRACE_FIELDS to host arrays of length C·S; ``gb_reg`` /
    ``gb_mem`` are ``(C+1, nphys)`` / ``(C+1, mem_words)`` uint32 boundary
    goldens (row 0 = init state, row C = golden final), possibly
    ``np.memmap`` views into the store.  ``memmap`` (the VA-space
    ``MemMap`` of a lifted trace, or None) rides along with its padded
    cluster map ``mm_cluster_pad`` for the exact engine; such windows are
    registry-only, never stored."""

    def __init__(self, *, n: int, S: int, nphys: int, mem_words: int,
                 trace_digest: str, tr: dict, gb_reg: np.ndarray,
                 gb_mem: np.ndarray, memmap=None, mm_cluster_pad=None,
                 source: str = "built"):
        self.n = int(n)
        self.S = int(S)
        self.C = (self.n + self.S - 1) // self.S
        self.nphys = int(nphys)
        self.mem_words = int(mem_words)
        self.trace_digest = trace_digest
        self.tr = tr
        self.gb_reg = gb_reg
        self.gb_mem = gb_mem
        self.memmap = memmap
        self.mm_cluster_pad = mm_cluster_pad   # host int64[C·S] or None
        self.source = source
        self._tr_dev: dict = {}
        self._mm_dev: dict = {}

    def chunk_trace(self, c: int) -> dict:
        """Host views of chunk ``c``'s SoA arrays (slicing only)."""
        lo, hi = c * self.S, (c + 1) * self.S
        return {k: v[lo:hi] for k, v in self.tr.items()}

    def tr_dev(self, device) -> dict:
        """The padded trace as int64 tensors on ``device``, uploaded once
        per device and shared by every campaign over this window."""
        device = torch.device(device)
        got = self._tr_dev.get(device)
        if got is None:
            got = {k: torch.as_tensor(v.astype(np.int64), device=device)
                   for k, v in self.tr.items()}
            self._tr_dev[device] = got
        return got

    def chunk_memmap(self, c: int, device):
        """Chunk ``c``'s view of the memmap on ``device`` (its padded
        cluster map, NOP tail at -1, uploaded once per device), or None
        without a memmap."""
        if self.memmap is None:
            return None
        device = torch.device(device)
        mm = self._mm_dev.get(device)
        if mm is None:
            mm = self.memmap._replace(uop_cluster=torch.as_tensor(
                self.mm_cluster_pad)).to(device)
            self._mm_dev[device] = mm
        lo = c * self.S
        return mm._replace(uop_cluster=mm.uop_cluster[lo:lo + self.S])


def _reg_key(trace_digest: str, S: int, memmap) -> tuple:
    # memmap identity, not content: a lifted window's MemMap is built once
    # per kernel, and kernels sharing the object share the window
    return (trace_digest, int(S), id(memmap) if memmap is not None else None)


def lookup(trace_digest: str, S: int, memmap=None):
    key = _reg_key(trace_digest, S, memmap)
    win = _REGISTRY.get(key)
    if win is not None:
        _REGISTRY.move_to_end(key)
        STATS["registry_hits"] += 1
    return win


def register(win: PreprocessedWindow) -> PreprocessedWindow:
    key = _reg_key(win.trace_digest, win.S, win.memmap)
    _REGISTRY[key] = win
    _REGISTRY.move_to_end(key)
    while len(_REGISTRY) > _REGISTRY_MAX:
        _REGISTRY.popitem(last=False)
    return win


def clear_registry() -> None:
    _REGISTRY.clear()


def store_axes(S: int) -> dict:
    return {"kind": DOC_NAME, "S": int(S), "v": STORE_VERSION}


def load_from_store(store, trace_digest: str, S: int):
    """A stored window (arrays mmap'd), or None on any miss or rot:
    ``get_arrays`` re-verifies every payload byte, so a rotted array reads
    as a rebuild, never as corruption."""
    from shrewd_tpu_torch.ingest.store import axes_key

    got = store.get_arrays(trace_digest, axes_key(store_axes(S)), DOC_NAME,
                           mmap=True)
    if got is None:
        return None
    doc, arrays = got
    if doc.get("v") != STORE_VERSION:
        return None
    try:
        tr = {f: arrays[f] for f in TRACE_FIELDS}
        gb_reg, gb_mem = arrays["gb_reg"], arrays["gb_mem"]
    except KeyError:
        return None
    STATS["store_hits"] += 1
    return PreprocessedWindow(
        n=int(doc["n"]), S=int(doc["S"]), nphys=int(doc["nphys"]),
        mem_words=int(doc["mem_words"]), trace_digest=trace_digest,
        tr=tr, gb_reg=gb_reg, gb_mem=gb_mem, source="store")


def save_to_store(store, win: PreprocessedWindow) -> None:
    """Persist one window (memmap-free windows only: a VA-space MemMap is
    kernel state the store cannot rebuild a campaign from)."""
    assert win.memmap is None, "memmap windows are registry-only"
    from shrewd_tpu_torch.ingest.store import axes_key

    arrays = dict(win.tr)
    arrays["gb_reg"] = win.gb_reg
    arrays["gb_mem"] = win.gb_mem
    store.put_arrays(
        win.trace_digest, axes_key(store_axes(win.S)), DOC_NAME, arrays,
        meta={"v": STORE_VERSION, "n": win.n, "S": win.S, "C": win.C,
              "nphys": win.nphys, "mem_words": win.mem_words})
    STATS["stored"] += 1
