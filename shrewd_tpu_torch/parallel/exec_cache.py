"""Trace digests and the shared kernel registry.

Port of ``trace_digest``, ``shared_kernel``, ``clear_kernels``,
``kernel_fingerprint``, ``step_key`` and ``key_digest`` from
``shrewd_tpu/parallel/exec_cache.py``.  The JAX package's
``ExecutableCache`` memoizes compiled jax executables; the port compiles
nothing per trace or per step (its two CUDA kernels are built once per
process from their source, ``ops/taint_cuda.py``), so that cache has no
counterpart.  What the port shares is the heavyweight host object — one
``TrialKernel`` per (window content, machine config): its scoreboard,
FU-pool schedule, golden record and packed stream are built once and
serve every orchestrator of the process.

``cache()`` is the ledger of that registry, under the reference's counter
names so the ``campaign.perf`` stats keep theirs: ``compiled`` counts
kernels built, ``reused`` registry hits, ``per_key_stats()`` both per
kernel key; nothing is certified or refused.  The digest also keys the
preprocessed-window registry (``ops/window.py``).
"""

from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from typing import Callable

import numpy as np

from shrewd_tpu_torch.utils import debug

debug.register_flag("ExecCache", "shared kernel registry hits/misses")

#: kernels kept before LRU eviction — each pins its trace arrays and its
#: golden record on the device, so the bound is deliberately small
KERNEL_CACHE_MAX = 8

_TRACE_FIELDS = ("opcode", "dst", "src1", "src2", "imm", "taken",
                 "init_reg", "init_mem")


class KernelLedger:
    """Counters of the shared kernel registry, named as the reference's
    executable-cache counters (``campaign.perf.executables_*``)."""

    def __init__(self):
        self.compiled = 0        # kernels built (registry misses)
        self.reused = 0          # registry hits
        self.evicted = 0
        self.refused = 0         # the port certifies nothing: always 0
        self.certificates: dict = {}
        self.key_stats: dict[str, dict] = {}

    def _key_stat(self, key) -> dict:
        return self.key_stats.setdefault(
            key_digest(key), {"hits": 0, "misses": 0, "evictions": 0})

    def per_key_stats(self) -> dict:
        """Per-kernel-key hit/miss/evict counters keyed by the short key
        digest (``campaign.perf.exec_cache_keys``)."""
        return {d: dict(s) for d, s in self.key_stats.items()}

    def clear(self) -> None:
        self.key_stats.clear()


_LEDGER = KernelLedger()
_KERNELS: OrderedDict = OrderedDict()


def cache() -> KernelLedger:
    """The per-process ledger of the shared kernel registry."""
    return _LEDGER


def shared_kernel(trace, cfg_fp: str, build: Callable[[], object],
                  device=None):
    """Content-keyed registry of kernel objects: two campaigns over the
    same window content, machine config and device share ONE kernel
    instance, so its construction is paid once.  Safe because a kernel's
    mutable state is only the running escape counters, which every
    consumer reads as per-dispatch deltas, and dispatch is single-threaded
    per process."""
    key = (trace_digest(trace), cfg_fp, str(device))
    kern = _KERNELS.get(key)
    if kern is not None:
        _KERNELS.move_to_end(key)
        _LEDGER.reused += 1
        _LEDGER._key_stat(key)["hits"] += 1
        debug.dprintf("ExecCache", "shared kernel reuse %s", key[0][:12])
        return kern
    kern = build()
    _LEDGER.compiled += 1
    _LEDGER._key_stat(key)["misses"] += 1
    _KERNELS[key] = kern
    while len(_KERNELS) > KERNEL_CACHE_MAX:
        old, _ = _KERNELS.popitem(last=False)
        _LEDGER.evicted += 1
        _LEDGER._key_stat(old)["evictions"] += 1
    return kern


def clear_kernels() -> None:
    _KERNELS.clear()


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


def kernel_fingerprint(kernel) -> tuple:
    """Stable identity of the pure computation a kernel performs: trace
    content + full config.  Kernels with equal fingerprints compute
    identical outcome functions."""
    cfgs = []
    for attr in ("cfg", "minor_cfg"):
        c = getattr(kernel, attr, None)
        if c is None:
            cfgs.append(None)
        else:
            try:
                cfgs.append(json.dumps(c.to_dict(), sort_keys=True,
                                       default=str))
            except Exception:  # noqa: BLE001 — config without to_dict:
                cfgs.append(repr(c))
    trace = getattr(kernel, "trace", None)
    tdig = trace_digest(trace) if trace is not None else f"id{id(kernel)}"
    if getattr(kernel, "memmap", None) is not None:
        tdig += f"+memmap{id(kernel.memmap)}"
    return (type(kernel).__name__, tdig, tuple(cfgs))


def step_key(kernel, mesh, structure: str, kind: str, **flags) -> tuple:
    """The full key of one campaign step (the reference keys its
    executables by it; the port has one device and ``mesh`` is None)."""
    return (kind, kernel_fingerprint(kernel), mesh, str(structure),
            tuple(sorted(flags.items())))


def key_digest(key) -> str:
    """Stable short digest of a key (a JSON-able handle)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:16]
