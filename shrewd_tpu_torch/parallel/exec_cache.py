"""Trace content digests.

Port of ``trace_digest`` from ``shrewd_tpu/parallel/exec_cache.py:385-414``
only.  The JAX package keys its compiled-executable cache by it; the port
compiles nothing per trace, so the cache itself has no counterpart, and the
digest keys the preprocessed-window registry (``ops/window.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np

_TRACE_FIELDS = ("opcode", "dst", "src1", "src2", "imm", "taken",
                 "init_reg", "init_mem")


def trace_digest(trace) -> str:
    """Content digest of a trace's arrays, equal to the JAX package's for
    the same arrays.  The port's ``Trace`` is a NamedTuple, which takes no
    attribute, so the digest is recomputed on each call (a hash of a few
    MB)."""
    h = hashlib.sha1()
    for name in _TRACE_FIELDS:
        arr = getattr(trace, name, None)
        if arr is None:
            continue
        a = np.asarray(arr)
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    for name in ("n", "nphys", "mem_words"):
        h.update(f"{name}={getattr(trace, name, None)}".encode())
    return h.hexdigest()
