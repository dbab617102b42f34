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
kernel key.  The digest also keys the preprocessed-window registry
(``ops/window.py``).

The ledger is also where campaign steps are certified.  With an auditor
installed (``install_auditor``; ``analysis.install_step_auditor`` under
``plan.analysis.certify``), ``ShardedCampaign`` sends the first dispatch of
each step kind, keyed by ``step_key``, through ``KernelLedger.audit``: the
auditor (``analysis/step_audit.py StepAuditor``) runs the step once and
returns its certificate, which the ledger keeps in ``certificates``; a
strict refusal raises ``AdmissionError``, counts in ``refused`` and stays
refused for its key.
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


class AdmissionError(RuntimeError):
    """A strict-mode replay-safety audit refused this campaign step (see
    ``.certificate`` for the evidence)."""

    def __init__(self, msg: str, certificate: dict | None = None):
        super().__init__(msg)
        self.certificate = certificate or {}


# the installed auditor (analysis/step_audit.StepAuditor or compatible):
# ``auditor(fn, example_args, key) -> certificate dict``, raising to refuse
# the step.  None (the default) audits nothing.
_AUDITOR = None


def install_auditor(auditor) -> None:
    """Certify the first dispatch of every campaign step kind from now on
    (certificates in ``cache().certificates``)."""
    global _AUDITOR
    _AUDITOR = auditor


def clear_auditor() -> None:
    global _AUDITOR
    _AUDITOR = None


def current_auditor():
    return _AUDITOR


class KernelLedger:
    """Counters of the shared kernel registry, named as the reference's
    executable-cache counters (``campaign.perf.executables_*``)."""

    def __init__(self):
        self.compiled = 0        # kernels built (registry misses)
        self.reused = 0          # registry hits
        self.evicted = 0
        self.refused = 0         # strict-mode refusals of campaign steps
        # step key digest -> the step's replay-safety certificate
        self.certificates: dict[str, dict] = {}
        # step key digest -> its refusal: a refused step stays refused
        self._refusals: dict[str, AdmissionError] = {}
        self.key_stats: dict[str, dict] = {}

    def _key_stat(self, key) -> dict:
        return self.key_stats.setdefault(
            key_digest(key), {"hits": 0, "misses": 0, "evictions": 0})

    def audit(self, key, fn, example_args: tuple):
        """Certify the step ``key`` with the installed auditor (once per
        key) → its certificate, or None without an auditor.  Only the
        auditor's own refusal (an error carrying its certificate) becomes
        ``AdmissionError``, and the key stays refused; an auditor that
        crashed proves nothing, so its failure is kept as an ``ok: False``
        certificate with ``audit_error`` and the step runs."""
        auditor = _AUDITOR
        if auditor is None:
            return None
        d = key_digest(key)
        if d in self._refusals:
            raise self._refusals[d]
        if d in self.certificates:
            return self.certificates[d]
        kind = str(key[0]) if key else "step"
        try:
            cert = auditor(fn, example_args, key)
        except AdmissionError as e:
            self.refused += 1
            self._refusals[d] = e
            raise
        except Exception as e:  # noqa: BLE001
            if hasattr(e, "certificate"):
                # the auditor's own refusal type (CertificationError):
                # normalize so callers see one refusal type
                self.refused += 1
                err = AdmissionError(
                    f"campaign step refused by replay-safety audit: {e}",
                    e.certificate)
                self._refusals[d] = err
                raise err from e
            debug.dprintf("ExecCache", "audit of %s errored (%s) — "
                          "running it unaudited", kind, e)
            cert = {"kind": kind, "ok": False, "audit_error": str(e),
                    "violations": []}
        self.certificates[d] = cert
        return cert

    def stats(self) -> dict:
        """The counters as the reference's ``ExecutableCache.stats()``
        names them (the fleet metrics and stats read this)."""
        return {"compiled": self.compiled, "reused": self.reused,
                "evicted": self.evicted, "refused": self.refused}

    def per_key_stats(self) -> dict:
        """Per-kernel-key hit/miss/evict counters keyed by the short key
        digest (``campaign.perf.exec_cache_keys``)."""
        return {d: dict(s) for d, s in self.key_stats.items()}

    def clear(self) -> None:
        self.key_stats.clear()
        self.certificates.clear()
        self._refusals.clear()


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
    executables by it): the kernel's content, the mesh's identity (its
    devices and its world; ``parallel/mesh.py Mesh.identity``, None
    without a mesh), the structure and the step's flags."""
    ident = mesh.identity() if mesh is not None else None
    return (kind, kernel_fingerprint(kernel), ident, str(structure),
            tuple(sorted(flags.items())))


def key_digest(key) -> str:
    """Stable short digest of a key (a JSON-able handle)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:16]
