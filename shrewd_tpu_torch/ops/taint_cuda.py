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
from pathlib import Path

import torch

from shrewd_tpu_torch.models.o3 import Fault
from shrewd_tpu_torch.ops.replay import M32, TraceArrays, _signed
from shrewd_tpu_torch.ops.taint import (GoldenRecord, TaintResult,
                                        taint_chunk, taint_fast_plain)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "taint_fast.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
KS = (4, 16)          # set capacities the source instantiates
_lib = None
_packed = None        # (record, coverage, stream): K2's last packed stream


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
        lib.taint_fast_launch.argtypes = [ct.c_void_p] * 16 + \
            [ct.c_int] * 7 + [ct.c_void_p]
        lib.taint_chunk_launch.restype = ct.c_int
        lib.taint_chunk_launch.argtypes = [ct.c_void_p] * 17 + \
            [ct.c_int] * 6 + [ct.c_void_p]
        _lib = lib
    return _lib


def pack_stream(gold: GoldenRecord, tr: TraceArrays,
                shadow_cov: torch.Tensor) -> torch.Tensor:
    """The golden stream as the kernel reads it: int32 ``[16, n]`` rows
    op, dst, src1, src2, imm, taken, a, b, ea, res, st_old, dst_old, wr,
    ld, st (uint32 values as their int32 bits) and the shadow coverage's
    float32 bits."""
    rows = torch.stack([tr.opcode, tr.dst, tr.src1, tr.src2, tr.imm,
                        tr.taken, gold.a, gold.b, gold.ea, gold.res,
                        gold.st_old, gold.dst_old, gold.wr.long(),
                        gold.is_ld.long(), gold.is_st.long()])
    cov = shadow_cov.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([_signed(rows).to(torch.int32), cov[None]]).contiguous()


def _chunk_stream(gold: GoldenRecord, tr: TraceArrays,
                  shadow_cov: torch.Tensor) -> torch.Tensor:
    """K2's packed stream, packed once per chunk record: the chunked
    driver builds a chunk's record once (``ChunkedCampaign.chunk_record``)
    and launches K2 on it once per wave, with the chunk's trace and
    coverage.  Keyed on the identity of the record and the coverage."""
    global _packed
    if _packed is None or _packed[0] is not gold or \
            _packed[1] is not shadow_cov:
        _packed = (gold, shadow_cov, pack_stream(gold, tr, shadow_cov))
    return _packed[2]


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


def taint_fast_cuda(gold: GoldenRecord, tr: TraceArrays,
                    shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                    alt1, alt2, k: int = 16, compare_regs: bool = True,
                    may_latch: bool = True) -> TaintResult:
    """Deviation-set fast pass over a lane batch.  ``gold_at_fault``,
    ``alt1`` and ``alt2`` are the lanes' setup gathers (``fault_setup`` or
    ``setup_scan``); ``may_latch=False`` ignores LATCH_OP faults."""
    dev = faults.kind.device
    if dev.type == "cpu":
        return taint_fast_plain(gold, tr, shadow_cov, faults, gold_at_fault,
                                alt1, alt2, k=k, compare_regs=compare_regs,
                                may_latch=may_latch)
    _check_lanes("taint_fast_cuda", gold, tr, shadow_cov, faults,
                 (gold_at_fault, alt1, alt2), k, dev)
    B = faults.kind.shape[0]
    n = tr.n
    nphys = gold.final_reg.shape[0]
    mem_words = gold.final_mem.shape[0]

    stream = pack_stream(gold, tr, shadow_cov)
    final_state = _bits32(torch.cat([gold.final_reg, gold.final_mem]))
    ins = [x.contiguous() for x in faults] + [
        _bits32(gold_at_fault), _bits32(alt1), _bits32(alt2)]
    outcome, escaped, overflow, steps = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    tags = torch.empty((k, B), dtype=torch.int32, device=dev)
    vals = torch.empty((k, B), dtype=torch.int32, device=dev)
    rc = _load().taint_fast_launch(
        stream.data_ptr(), *(x.data_ptr() for x in ins),
        final_state.data_ptr(), outcome.data_ptr(), escaped.data_ptr(),
        overflow.data_ptr(), steps.data_ptr(), tags.data_ptr(),
        vals.data_ptr(), n, B, nphys, mem_words, k, int(compare_regs),
        int(may_latch), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"taint_fast kernel launch failed: cudaError {rc}")
    taint_fast_cuda.launches += 1
    return TaintResult(outcome=outcome, escaped=escaped != 0,
                       overflow=overflow != 0, tags=tags.T.to(torch.int64),
                       vals=vals.T.to(torch.int64) & M32, steps=steps)


taint_fast_cuda.launches = 0


def taint_chunk_cuda(gold: GoldenRecord, tr: TraceArrays,
                     shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                     alt1, alt2, tags0, vals0, k: int = 16,
                     may_latch: bool = True):
    """One chunk of a lane batch from carried deviation sets (K2).
    ``tags0``/``vals0`` are the ``(B, k)`` int64 sets carried in;
    ``gold``/``tr``/``shadow_cov`` cover the chunk and the fault
    coordinates are localized to it (``ops/chunked.py``).  Returns
    ``taint_chunk``'s ``(tags, vals, steps, detected, trapped, diverged,
    escaped, overflowed)``."""
    dev = faults.kind.device
    if dev.type == "cpu":
        return taint_chunk(gold, tr, shadow_cov, faults, gold_at_fault,
                           alt1, alt2, tags0, vals0, k=k,
                           may_latch=may_latch)
    who = "taint_chunk_cuda"
    _check_lanes(who, gold, tr, shadow_cov, faults,
                 (gold_at_fault, alt1, alt2), k, dev)
    B = faults.kind.shape[0]
    for x in (tags0, vals0):
        _check(x.device == dev and x.shape == (B, k),
               f"carried set of shape {tuple(x.shape)} on {x.device}, "
               f"expected ({B}, {k}) on {dev}", who)
        _check(x.dtype == torch.int64, f"carried set of {x.dtype}", who)
    stream = _chunk_stream(gold, tr, shadow_cov)
    ins = [x.contiguous() for x in faults] + [
        _bits32(gold_at_fault), _bits32(alt1), _bits32(alt2),
        tags0.T.to(torch.int32).contiguous(), _bits32(vals0.T)]
    bits, escaped, overflow, steps = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    tags = torch.empty((k, B), dtype=torch.int32, device=dev)
    vals = torch.empty((k, B), dtype=torch.int32, device=dev)
    rc = _load().taint_chunk_launch(
        stream.data_ptr(), *(x.data_ptr() for x in ins), bits.data_ptr(),
        escaped.data_ptr(), overflow.data_ptr(), steps.data_ptr(),
        tags.data_ptr(), vals.data_ptr(), tr.n, B,
        gold.final_reg.shape[0], gold.final_mem.shape[0], k, int(may_latch),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"taint_chunk kernel launch failed: cudaError {rc}")
    taint_chunk_cuda.launches += 1
    return (tags.T.to(torch.int64), vals.T.to(torch.int64) & M32, steps,
            (bits & 1) != 0, (bits & 2) != 0, (bits & 4) != 0, escaped != 0,
            overflow != 0)


taint_chunk_cuda.launches = 0
