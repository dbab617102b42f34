"""Hopper deviation-set kernels: the wrappers of ``csrc/taint_fast.cu``.

Two kernels share the source (see the note at its top for what bounds them
on an H100 and how the design answers that):

- ``taint_fast_cuda`` (K1), the counterpart of
  ``shrewd_tpu/ops/pallas_taint.py taint_fast_pallas``: a whole window
  from empty sets, classified.  Plain version: ``ops/taint.py
  taint_fast_plain``; result: a ``TaintResult``.
- ``taint_chunk_cuda`` (K2), the counterpart of ``taint_chunk_pallas``:
  one chunk from carried sets, unclassified.  Plain version:
  ``ops/taint.py taint_chunk``; result: its tuple ``(tags, vals, steps,
  detected, trapped, diverged, escaped, overflowed)``.

Each takes its plain version's arguments and returns its result:

- for CPU tensors it calls the plain version;
- for CUDA tensors it launches the kernel or raises — there is no fallback.

The kernels read the golden stream packed step-major with each step's
quiet/loud mark (``quiet_steps``, ``pack_stream``).  The code that builds a
golden record packs it once and passes it in (``TrialKernel.packed_stream``,
the chunked driver once per chunk); a call without it packs it for that
launch.  The wrapper sorts the lanes by the step from which they can differ
from the golden run (``lane_starts``, ``lane_order``): the kernel skips,
exactly, the steps that cannot change a lane.

The kernels are compiled from the repository's source at first use, with
``nvcc`` into ``shrewd_tpu_torch/_build/`` under a name keyed by the
source's content, and bound through ctypes (a plain C interface, so the
build takes seconds).  ``taint_fast_cuda.launches`` and
``taint_chunk_cuda.launches`` count the launches.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from shrewd_tpu_torch.models.o3 import KIND_LATCH_IMM, KIND_REGFILE, Fault
from shrewd_tpu_torch.ops.replay import (M32, TraceArrays, _alu, _div_bad,
                                         _signed, op_flags)
from shrewd_tpu_torch.ops.taint import (EMPTY, GoldenRecord, TaintResult,
                                        taint_chunk, taint_fast_plain)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "taint_fast.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
KS = (4, 16)          # set capacities the source instantiates
_lib = None
_count_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin, or
    PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the fast-pass kernel cannot be built")
    return found


def build(verbose: bool = False) -> Path:
    """Compile the kernel unless this exact source and flag set is built;
    returns the shared library's path.  ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's report (registers, spills)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libtaint_fast_{h.hexdigest()[:16]}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip(), flush=True)
    os.replace(tmp, out)
    return out


def _load() -> ct.CDLL:
    global _lib
    if _lib is None:
        lib = ct.CDLL(str(build()))
        lib.taint_fast_launch.restype = ct.c_int
        lib.taint_fast_launch.argtypes = [ct.c_void_p] * 18 + \
            [ct.c_int] * 7 + [ct.c_void_p]
        lib.taint_chunk_launch.restype = ct.c_int
        lib.taint_chunk_launch.argtypes = [ct.c_void_p] * 19 + \
            [ct.c_int] * 6 + [ct.c_void_p]
        _lib = lib
    return _lib


def quiet_steps(gold: GoldenRecord, tr: TraceArrays) -> torch.Tensor:
    """bool[n]: step i is *quiet* when a lane with an EMPTY deviation set
    and no fault phase at i stays live after it with its set still empty
    — no golden memory trap or #DE, no branch mismatch with ``taken``, no
    escape, no upsert.  It is the scan's step (``ops/taint.py
    _scan_deviation``) with the lane's operands the golden ones, computed
    for every step at once; the kernels run the full step body only on
    the others (the note at the top of ``csrc/taint_fast.cu``)."""
    mem_words = gold.final_mem.shape[0]
    a, b = gold.a, gold.b
    eff = _alu(tr.opcode, a, b, tr.imm)
    is_ld, is_st, is_br, writes_op, div_s, div_u = op_flags(tr.opcode)
    valid = ((eff & 3) == 0) & ((eff >> 2) < mem_words)
    bad_s, bad_u = _div_bad(a, b)
    trap = ((is_ld | is_st) & ~valid) | (div_s & bad_s) | (div_u & bad_u)
    slot_mask = mem_words - 1
    same_slot = ((eff >> 2) & slot_mask) == ((gold.ea >> 2) & slot_mask)
    golden_here = same_slot & (gold.is_ld | gold.is_st)
    esc = is_ld & valid & ~trap & ~golden_here
    div = (is_br & (eff != 0)) != (tr.taken != 0)
    live = ~(trap | esc | div)
    # the trial's store, then a golden store the trial missed
    st_t = is_st & valid & live
    st_up = st_t & ~(gold.is_st & same_slot & (b == gold.b))
    g_st_up = (gold.is_st & live & ~(st_t & same_slot)
               & (gold.st_old != gold.b))
    # the writeback, then a golden register write the trial missed
    ldval = torch.where(golden_here,
                        torch.where(gold.is_ld, gold.res, gold.st_old), 0)
    writes_t = (writes_op | is_ld) & live
    w_up = writes_t & (torch.where(is_ld, ldval, eff)
                       != torch.where(gold.wr, gold.res, gold.dst_old))
    g_w_up = gold.wr & live & ~writes_t & (gold.dst_old != gold.res)
    return live & ~(st_up | g_st_up | w_up | g_w_up)


def next_loud(quiet: torch.Tensor) -> torch.Tensor:
    """int64[n]: the first step >= i that is not quiet, or n if none (a
    reverse cumulative minimum)."""
    n = quiet.shape[0]
    idx = torch.where(quiet, n, torch.arange(n, device=quiet.device))
    return idx.flip(0).cummin(0).values.flip(0)


def _filter_bit(tag: torch.Tensor) -> torch.Tensor:
    """The kernels' membership-filter bit of each tag (``bit_of`` in
    ``csrc/taint_fast.cu``: bit ``(tag * 0x9E3779B1 mod 2**32) >> 26`` of
    64), as int64 bit patterns."""
    return torch.ones_like(tag) << (((tag & M32) * 0x9E3779B1 & M32) >> 26)


def pack_stream(gold: GoldenRecord, tr: TraceArrays,
                shadow_cov: torch.Tensor) -> torch.Tensor:
    """The golden stream as the kernels read it: int32 ``[n, 16]``, one
    64-byte record per step — ``op | flags << 8`` (flags ``wr | ld << 1 |
    st << 2 | loud << 3 | taken << 4``), dst, src1, src2; imm, a, b, ea;
    res, st_old, dst_old (uint32 values as their int32 bits), the memory
    tag ``nphys + slot(ea)`` of a golden load or store (else -1); the
    first loud step after this one (n if none), the membership-filter
    probe of the tags the step touches (src1, src2, dst, the memory tag;
    low and high word), the shadow coverage's float32 bits."""
    n = tr.n
    nphys, mem_words = gold.final_reg.shape[0], gold.final_mem.shape[0]
    quiet = quiet_steps(gold, tr)
    after = torch.cat([next_loud(quiet)[1:],
                       torch.full((1,), n, device=quiet.device)])
    flags = (gold.wr.long() | gold.is_ld.long() << 1
             | gold.is_st.long() << 2 | (~quiet).long() << 3
             | (tr.taken != 0).long() << 4)
    mem = gold.is_ld | gold.is_st
    mtag = torch.where(mem, nphys + ((gold.ea >> 2) & (mem_words - 1)), -1)
    probe = (_filter_bit(tr.src1) | _filter_bit(tr.src2)
             | _filter_bit(tr.dst) | torch.where(mem, _filter_bit(mtag), 0))
    cols = torch.stack([tr.opcode | flags << 8, tr.dst, tr.src1, tr.src2,
                        tr.imm, gold.a, gold.b, gold.ea, gold.res,
                        gold.st_old, gold.dst_old, mtag, after, probe,
                        probe >> 32], 1)
    cov = shadow_cov.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([_signed(cols & M32).to(torch.int32), cov[:, None]],
                     1).contiguous()


def lane_starts(faults: Fault, n: int, tags0=None) -> torch.Tensor:
    """int64[B]: the step from which a lane can differ from the golden
    run — 0 for a lane carrying a non-empty set in (``tags0``, ``(B,
    k)``), else its landing (REGFILE: ``cycle``, every other kind:
    ``entry``) when that lies in ``[0, n)``, else n (a null lane, a
    carried lane with an empty set, a lane of another chunk)."""
    kind = faults.kind.to(torch.int64)
    land = torch.where(kind == KIND_REGFILE, faults.cycle,
                       faults.entry).to(torch.int64)
    lands = ((kind >= KIND_REGFILE) & (kind <= KIND_LATCH_IMM)
             & (land >= 0) & (land < n))
    start = torch.where(lands, land, n)
    if tags0 is not None:
        start = torch.where((tags0 != EMPTY).any(1), 0, start)
    return start


def lane_order(start: torch.Tensor) -> torch.Tensor:
    """int32[B]: the lanes sorted by start step (stable), the kernels'
    thread-to-lane map, so that a warp's lanes start together."""
    return torch.argsort(start, stable=True).to(torch.int32)


def _bits32(x: torch.Tensor) -> torch.Tensor:
    return _signed(x.to(torch.int64)).to(torch.int32).contiguous()


def _check(cond: bool, msg: str, who: str = "taint_fast_cuda") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_lanes(who: str, gold: GoldenRecord, tr: TraceArrays,
                 shadow_cov: torch.Tensor, faults: Fault, setup, k: int,
                 dev: torch.device) -> None:
    """The checks both wrappers make before a launch."""
    _check(dev.type == "cuda", f"tensors on {dev}, expected cuda or cpu",
           who)
    _check(k in KS, f"k={k}; the kernel is instantiated for k in {KS}", who)
    B = faults.kind.shape[0]
    nphys = gold.final_reg.shape[0]
    mem_words = gold.final_mem.shape[0]
    _check(nphys & (nphys - 1) == 0 and mem_words & (mem_words - 1) == 0,
           "nphys and mem_words must be powers of two", who)
    lanes = (*faults, *setup)
    for x in (*lanes, shadow_cov, gold.a, gold.final_reg, gold.final_mem,
              tr.opcode):
        _check(x.device == dev, f"a tensor lies on {x.device}, not {dev}",
               who)
    for x in lanes:
        _check(x.shape == (B,), f"lane tensor of shape {tuple(x.shape)}, "
                                f"expected ({B},)", who)
    for x in faults[:4]:
        _check(x.dtype == torch.int32, f"fault field of {x.dtype}", who)
    _check(faults.shadow_u.dtype == torch.float32, "shadow_u not float32",
           who)
    for x in (*setup, gold.a, gold.final_reg):
        _check(x.dtype == torch.int64, f"value tensor of {x.dtype}", who)
    _check(shadow_cov.shape == (tr.n,), "shadow_cov must be per-µop", who)


def _stream_of(stream, gold: GoldenRecord, tr: TraceArrays,
               shadow_cov: torch.Tensor, dev: torch.device,
               who: str) -> torch.Tensor:
    """The caller's packed stream, checked, or one packed for this
    launch."""
    if stream is None:
        return pack_stream(gold, tr, shadow_cov)
    _check(stream.device == dev and stream.shape == (tr.n, 16)
           and stream.dtype == torch.int32 and stream.is_contiguous(),
           f"stream must be pack_stream's contiguous ({tr.n}, 16) int32 "
           f"tensor on {dev}", who)
    return stream


def _counts_ptr(counts, B: int, dev: torch.device, who: str) -> int:
    """The address of the optional ``(2, B)`` int32 counter output, or 0
    (a null pointer: the main path's launches)."""
    if counts is None:
        return 0
    _check(counts.device == dev and counts.shape == (2, B)
           and counts.dtype == torch.int32 and counts.is_contiguous(),
           f"counts must be a contiguous (2, {B}) int32 tensor on {dev}", who)
    return counts.data_ptr()


def taint_fast_cuda(gold: GoldenRecord, tr: TraceArrays,
                    shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                    alt1, alt2, k: int = 16, compare_regs: bool = True,
                    may_latch: bool = True, counts=None,
                    stream=None) -> TaintResult:
    """Deviation-set fast pass over a lane batch.  ``gold_at_fault``,
    ``alt1`` and ``alt2`` are the lanes' setup gathers (``fault_setup`` or
    ``setup_scan``); ``may_latch=False`` ignores LATCH_OP faults.
    ``counts``, a ``(2, B)`` int32 CUDA tensor, receives per lane the
    quiet non-landing steps it took with a non-empty set whose tags hit
    the set (row 0) and miss it (row 1); measurements pass it, the main
    path does not.  ``stream`` is ``pack_stream(gold, tr, shadow_cov)``
    when the caller keeps it; without it the launch packs its own."""
    dev = faults.kind.device
    who = "taint_fast_cuda"
    if dev.type == "cpu":
        _check(counts is None, "counts come from the kernel only", who)
        return taint_fast_plain(gold, tr, shadow_cov, faults, gold_at_fault,
                                alt1, alt2, k=k, compare_regs=compare_regs,
                                may_latch=may_latch)
    _check_lanes(who, gold, tr, shadow_cov, faults,
                 (gold_at_fault, alt1, alt2), k, dev)
    B = faults.kind.shape[0]
    n = tr.n
    nphys = gold.final_reg.shape[0]
    mem_words = gold.final_mem.shape[0]
    counts_ptr = _counts_ptr(counts, B, dev, who)
    stream = _stream_of(stream, gold, tr, shadow_cov, dev, who)
    order = lane_order(lane_starts(faults, n))
    final_state = _bits32(torch.cat([gold.final_reg, gold.final_mem]))
    ins = [x.contiguous() for x in faults] + [
        _bits32(gold_at_fault), _bits32(alt1), _bits32(alt2)]
    outcome, escaped, overflow, steps = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    tags = torch.empty((k, B), dtype=torch.int32, device=dev)
    vals = torch.empty((k, B), dtype=torch.int32, device=dev)
    rc = _load().taint_fast_launch(
        stream.data_ptr(), order.data_ptr(), *(x.data_ptr() for x in ins),
        final_state.data_ptr(), outcome.data_ptr(), escaped.data_ptr(),
        overflow.data_ptr(), steps.data_ptr(), tags.data_ptr(),
        vals.data_ptr(), counts_ptr, n, B, nphys, mem_words, k,
        int(compare_regs), int(may_latch),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"taint_fast kernel launch failed: cudaError {rc}")
    with _count_lock:                # mesh shards launch from threads
        taint_fast_cuda.launches += 1
    return TaintResult(outcome=outcome, escaped=escaped != 0,
                       overflow=overflow != 0, tags=tags.T.to(torch.int64),
                       vals=vals.T.to(torch.int64) & M32, steps=steps)


taint_fast_cuda.launches = 0


def taint_chunk_cuda(gold: GoldenRecord, tr: TraceArrays,
                     shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                     alt1, alt2, tags0, vals0, k: int = 16,
                     may_latch: bool = True, counts=None, stream=None):
    """One chunk of a lane batch from carried deviation sets (K2).
    ``tags0``/``vals0`` are the ``(B, k)`` int64 sets carried in;
    ``gold``/``tr``/``shadow_cov`` cover the chunk and the fault
    coordinates are localized to it (``ops/chunked.py``).  Returns
    ``taint_chunk``'s ``(tags, vals, steps, detected, trapped, diverged,
    escaped, overflowed)``.  ``counts`` and ``stream`` as in
    ``taint_fast_cuda``."""
    dev = faults.kind.device
    who = "taint_chunk_cuda"
    if dev.type == "cpu":
        _check(counts is None, "counts come from the kernel only", who)
        return taint_chunk(gold, tr, shadow_cov, faults, gold_at_fault,
                           alt1, alt2, tags0, vals0, k=k,
                           may_latch=may_latch)
    _check_lanes(who, gold, tr, shadow_cov, faults,
                 (gold_at_fault, alt1, alt2), k, dev)
    B = faults.kind.shape[0]
    for x in (tags0, vals0):
        _check(x.device == dev and x.shape == (B, k),
               f"carried set of shape {tuple(x.shape)} on {x.device}, "
               f"expected ({B}, {k}) on {dev}", who)
        _check(x.dtype == torch.int64, f"carried set of {x.dtype}", who)
    counts_ptr = _counts_ptr(counts, B, dev, who)
    stream = _stream_of(stream, gold, tr, shadow_cov, dev, who)
    order = lane_order(lane_starts(faults, tr.n, tags0))
    ins = [x.contiguous() for x in faults] + [
        _bits32(gold_at_fault), _bits32(alt1), _bits32(alt2),
        tags0.T.to(torch.int32).contiguous(), _bits32(vals0.T)]
    bits, escaped, overflow, steps = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    tags = torch.empty((k, B), dtype=torch.int32, device=dev)
    vals = torch.empty((k, B), dtype=torch.int32, device=dev)
    rc = _load().taint_chunk_launch(
        stream.data_ptr(), order.data_ptr(), *(x.data_ptr() for x in ins),
        bits.data_ptr(), escaped.data_ptr(), overflow.data_ptr(),
        steps.data_ptr(), tags.data_ptr(), vals.data_ptr(), counts_ptr,
        tr.n, B, gold.final_reg.shape[0], gold.final_mem.shape[0], k,
        int(may_latch), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"taint_chunk kernel launch failed: cudaError {rc}")
    with _count_lock:                # mesh shards launch from threads
        taint_chunk_cuda.launches += 1
    return (tags.T.to(torch.int64), vals.T.to(torch.int64) & M32, steps,
            (bits & 1) != 0, (bits & 2) != 0, (bits & 4) != 0, escaped != 0,
            overflow != 0)


taint_chunk_cuda.launches = 0
