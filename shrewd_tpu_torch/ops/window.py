"""Preprocessed chunk-window container and process registry.

Port of ``shrewd_tpu/ops/window.py:38-150``.  A ``PreprocessedWindow`` is
everything the chunked engines (``ops/chunked.py``) need that depends only
on the trace and the chunk length S, not on the campaign config: the
NOP-padded SoA trace arrays (C·S µops, so the hot loop slices views instead
of re-padding per chunk) and the golden boundary states at every chunk edge
(the in-window checkpoints).

Two tiers of reuse, cheapest first:

1. **process registry**: an LRU of recent windows keyed by
   ``(trace digest, S)``; a second campaign over the same trace and S skips
   the padding and the boundary pass (``STATS`` counts);
2. **build**: ``ops/chunked.py preprocess_window`` pads, runs the boundary
   pass and registers the window.

The JAX package's third tier, the content-addressed artifact store
(``load_from_store`` / ``save_to_store``), needs ``ingest/store.py``, and
its memmap windows need the VA-space trap model; a later slice of the
port brings both, and with them the registry's memmap key.

numpy-only at import; ``tr_dev`` uploads the padded trace to a device on
first use, once per (window, device).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

#: SoA trace field order (matches ops.replay.TraceArrays)
TRACE_FIELDS = ("opcode", "dst", "src1", "src2", "imm", "taken")

#: warm-start observability: builds = golden-boundary passes actually run
#: in this process
STATS = {"builds": 0, "registry_hits": 0}

_REGISTRY: OrderedDict = OrderedDict()
_REGISTRY_MAX = 4


class PreprocessedWindow:
    """Padded SoA chunk arrays + golden boundary states for one trace.

    ``tr`` maps TRACE_FIELDS to host arrays of length C·S; ``gb_reg`` /
    ``gb_mem`` are ``(C+1, nphys)`` / ``(C+1, mem_words)`` uint32 boundary
    goldens (row 0 = init state, row C = golden final)."""

    def __init__(self, *, n: int, S: int, nphys: int, mem_words: int,
                 trace_digest: str, tr: dict, gb_reg: np.ndarray,
                 gb_mem: np.ndarray):
        self.n = int(n)
        self.S = int(S)
        self.C = (self.n + self.S - 1) // self.S
        self.nphys = int(nphys)
        self.mem_words = int(mem_words)
        self.trace_digest = trace_digest
        self.tr = tr
        self.gb_reg = gb_reg
        self.gb_mem = gb_mem
        self._tr_dev: dict = {}

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


def lookup(trace_digest: str, S: int):
    key = (trace_digest, int(S))
    win = _REGISTRY.get(key)
    if win is not None:
        _REGISTRY.move_to_end(key)
        STATS["registry_hits"] += 1
    return win


def register(win: PreprocessedWindow) -> PreprocessedWindow:
    key = (win.trace_digest, win.S)
    _REGISTRY[key] = win
    _REGISTRY.move_to_end(key)
    while len(_REGISTRY) > _REGISTRY_MAX:
        _REGISTRY.popitem(last=False)
    return win


def clear_registry() -> None:
    _REGISTRY.clear()
