"""ctypes bindings to the serial C++ runtime in ``csrc/``.

The port's own binding, counterpart of ``shrewd_tpu/native/__init__.py``
(same structs, same three entry points), plus two of its own for chunked
replay (``ops/chunked.py``): the golden boundary pass over a chunked
window and the per-chunk golden recorder (``csrc/golden_chunk.cc``, the
port's source; it includes ``csrc/shrewd.h`` for the oracle's ALU).  It
only reads ``csrc/``: the sources are compiled with g++ into
``shrewd_tpu_torch/_build/``, under a name keyed by their content, so an
edit to either rebuilds and parallel test workers never load a
half-written library.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from shrewd_tpu_torch.trace.format import Trace

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG.parent / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("golden.cc", "trace_engine.cc")
_HEADERS = ("shrewd.h",)
_PORT_SOURCES = (_PKG / "csrc" / "golden_chunk.cc",)
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_lib = None


class _TraceView(ct.Structure):
    _fields_ = [
        ("opcode", ct.POINTER(ct.c_int32)),
        ("dst", ct.POINTER(ct.c_int32)),
        ("src1", ct.POINTER(ct.c_int32)),
        ("src2", ct.POINTER(ct.c_int32)),
        ("imm", ct.POINTER(ct.c_uint32)),
        ("taken", ct.POINTER(ct.c_int32)),
        ("n", ct.c_int32),
        ("nphys", ct.c_int32),
        ("mem_words", ct.c_int32),
    ]


class _FaultView(ct.Structure):
    _fields_ = [
        ("kind", ct.POINTER(ct.c_int32)),
        ("cycle", ct.POINTER(ct.c_int32)),
        ("entry", ct.POINTER(ct.c_int32)),
        ("bit", ct.POINTER(ct.c_int32)),
        ("shadow_u", ct.POINTER(ct.c_float)),
        ("n_trials", ct.c_int32),
    ]


class _WorkloadParams(ct.Structure):
    _fields_ = [
        ("seed", ct.c_uint64),
        ("n", ct.c_int32),
        ("nphys", ct.c_int32),
        ("mem_words", ct.c_int32),
        ("working_set_words", ct.c_int32),
        ("frac_alu", ct.c_float),
        ("frac_mul", ct.c_float),
        ("frac_load", ct.c_float),
        ("frac_store", ct.c_float),
        ("frac_branch", ct.c_float),
        ("locality", ct.c_float),
        ("reuse_geo_p", ct.c_float),
    ]


def build() -> Path:
    """Compile ``csrc/`` into ``_build/libshrewd_<digest>.so`` unless that
    exact build exists; returns its path."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for path in [_CSRC / name for name in _SOURCES + _HEADERS] + \
            list(_PORT_SOURCES):
        h.update(path.read_bytes())
    out = _BUILD / f"libshrewd_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_CXXFLAGS, f"-I{_CSRC}", "-o", str(tmp),
           *[str(_CSRC / s) for s in _SOURCES],
           *[str(p) for p in _PORT_SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ct.CDLL:
    global _lib
    if _lib is None:
        so = ct.CDLL(str(build()))
        so.shrewd_golden_replay.restype = None
        so.shrewd_golden_replay.argtypes = [ct.POINTER(_TraceView)] + \
            [ct.POINTER(ct.c_uint32)] * 4
        so.shrewd_golden_trials.restype = ct.c_int32
        so.shrewd_golden_trials.argtypes = [
            ct.POINTER(_TraceView), ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_uint32), ct.POINTER(_FaultView),
            ct.POINTER(ct.c_float), ct.c_int32, ct.POINTER(ct.c_int32)]
        so.shrewd_generate_trace.restype = ct.c_int32
        so.shrewd_generate_trace.argtypes = [
            ct.POINTER(_WorkloadParams)] + [ct.POINTER(ct.c_int32)] * 4 + [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32)]
        so.shrewd_record_chunk.restype = None
        so.shrewd_record_chunk.argtypes = [ct.POINTER(_TraceView)] + \
            [ct.POINTER(ct.c_uint32)] * 2 + [ct.POINTER(ct.c_uint8),
                                             ct.POINTER(ct.c_uint32)]
        _lib = so
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint32))


def _ascontig(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _trace_view(trace: Trace, keepalive: list) -> _TraceView:
    fields = {}
    for name, dt in (("opcode", np.int32), ("dst", np.int32),
                     ("src1", np.int32), ("src2", np.int32),
                     ("imm", np.uint32), ("taken", np.int32)):
        arr = _ascontig(getattr(trace, name), dt)
        keepalive.append(arr)
        fields[name] = arr
    return _TraceView(
        opcode=_i32p(fields["opcode"]), dst=_i32p(fields["dst"]),
        src1=_i32p(fields["src1"]), src2=_i32p(fields["src2"]),
        imm=_u32p(fields["imm"]), taken=_i32p(fields["taken"]),
        n=trace.n, nphys=trace.nphys, mem_words=trace.mem_words)


def golden_replay(trace: Trace) -> tuple[np.ndarray, np.ndarray]:
    """Fault-free native replay → (final_reg, final_mem)."""
    keep: list = []
    tv = _trace_view(trace, keep)
    init_reg = _ascontig(trace.init_reg, np.uint32)
    init_mem = _ascontig(trace.init_mem, np.uint32)
    out_reg = np.empty_like(init_reg)
    out_mem = np.empty_like(init_mem)
    lib().shrewd_golden_replay(ct.byref(tv), _u32p(init_reg), _u32p(init_mem),
                               _u32p(out_reg), _u32p(out_mem))
    return out_reg, out_mem


def chunk_view(tr: dict, lo: int, hi: int, init_reg,
               init_mem) -> SimpleNamespace:
    """A trace-shaped view of µops ``[lo, hi)`` of the host arrays ``tr``
    (``ops/window.py TRACE_FIELDS``) that starts from its own state, for
    ``golden_replay`` and ``record_chunk``."""
    view = SimpleNamespace(**{f: v[lo:hi] for f, v in tr.items()})
    view.init_reg = init_reg
    view.init_mem = init_mem
    view.n = hi - lo
    view.nphys = int(np.shape(init_reg)[0])
    view.mem_words = int(np.shape(init_mem)[0])
    return view


def boundary_pass(tr: dict, S: int, gb_reg: np.ndarray,
                  gb_mem: np.ndarray) -> None:
    """The golden boundary states of a chunked window, in place: row
    ``c + 1`` of ``gb_reg``/``gb_mem`` is the fault-free state after chunk
    ``c``, replayed from row ``c`` (port of the native pass,
    ``shrewd_tpu/ops/chunked.py:140-167``).  Row 0 is the caller's."""
    for c in range(gb_reg.shape[0] - 1):
        view = chunk_view(tr, c * S, (c + 1) * S, gb_reg[c], gb_mem[c])
        gb_reg[c + 1], gb_mem[c + 1] = golden_replay(view)


def record_chunk(view, wr) -> np.ndarray:
    """One serial fault-free pass over a chunk view → its golden streams
    uint32[6, n]: a, b, ea, res, st_old, dst_old.  ``wr`` (bool[n]) marks
    the steps that write their destination register."""
    keep: list = []
    tv = _trace_view(view, keep)
    init_reg = _ascontig(view.init_reg, np.uint32)
    init_mem = _ascontig(view.init_mem, np.uint32)
    wr = _ascontig(wr, np.uint8)
    if wr.shape != (view.n,):
        raise ValueError(f"wr of shape {wr.shape}, expected ({view.n},)")
    streams = np.empty((6, view.n), dtype=np.uint32)
    lib().shrewd_record_chunk(ct.byref(tv), _u32p(init_reg),
                              _u32p(init_mem),
                              wr.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                              _u32p(streams))
    return streams


def golden_trials(trace: Trace, kinds, cycles, entries, bits, shadow_us,
                  coverage, compare_regs: bool = True) -> np.ndarray:
    """Serial C++ trial batch → outcomes int32[n_trials].

    The differential oracle for ``TrialKernel``.  Fault fields are host
    arrays (numpy, or CPU tensors); ``coverage`` is the per-µop shadow
    detection probability, float[trace.n]."""
    keep: list = []
    tv = _trace_view(trace, keep)
    init_reg = _ascontig(trace.init_reg, np.uint32)
    init_mem = _ascontig(trace.init_mem, np.uint32)
    kinds = _ascontig(kinds, np.int32)
    cycles = _ascontig(cycles, np.int32)
    entries = _ascontig(entries, np.int32)
    bits = _ascontig(bits, np.int32)
    shadow_us = _ascontig(shadow_us, np.float32)
    cov = _ascontig(coverage, np.float32)
    if len(cov) != trace.n:
        raise ValueError(f"coverage must be per-µop (len {trace.n}), "
                         f"got {len(cov)}")
    n = len(kinds)
    if not (len(cycles) == len(entries) == len(bits) == len(shadow_us) == n):
        raise ValueError("fault field lengths differ")
    fv = _FaultView(
        kind=_i32p(kinds), cycle=_i32p(cycles), entry=_i32p(entries),
        bit=_i32p(bits),
        shadow_u=shadow_us.ctypes.data_as(ct.POINTER(ct.c_float)),
        n_trials=n)
    out = np.empty(n, dtype=np.int32)
    ran = lib().shrewd_golden_trials(
        ct.byref(tv), _u32p(init_reg), _u32p(init_mem), ct.byref(fv),
        cov.ctypes.data_as(ct.POINTER(ct.c_float)),
        1 if compare_regs else 0, _i32p(out))
    if ran != n:
        raise RuntimeError(f"native oracle ran {ran} of {n} trials")
    return out


def generate_trace(seed: int, n: int, nphys: int, mem_words: int,
                   working_set_words: int, frac_alu=0.50, frac_mul=0.05,
                   frac_load=0.20, frac_store=0.12, frac_branch=0.08,
                   locality=0.8, reuse_geo_p=0.3) -> Trace:
    """Native workload engine → Trace."""
    p = _WorkloadParams(
        seed=seed, n=n, nphys=nphys, mem_words=mem_words,
        working_set_words=working_set_words, frac_alu=frac_alu,
        frac_mul=frac_mul, frac_load=frac_load, frac_store=frac_store,
        frac_branch=frac_branch, locality=locality, reuse_geo_p=reuse_geo_p)
    opcode = np.empty(n, dtype=np.int32)
    dst = np.empty(n, dtype=np.int32)
    src1 = np.empty(n, dtype=np.int32)
    src2 = np.empty(n, dtype=np.int32)
    imm = np.empty(n, dtype=np.uint32)
    taken = np.empty(n, dtype=np.int32)
    init_reg = np.empty(nphys, dtype=np.uint32)
    init_mem = np.empty(mem_words, dtype=np.uint32)
    rc = lib().shrewd_generate_trace(
        ct.byref(p), _i32p(opcode), _i32p(dst), _i32p(src1), _i32p(src2),
        _u32p(imm), _i32p(taken), _u32p(init_reg), _u32p(init_mem))
    if rc != 0:
        raise ValueError(f"shrewd_generate_trace failed with code {rc}")
    t = Trace(opcode=opcode, dst=dst, src1=src1, src2=src2, imm=imm,
              taken=taken, init_reg=init_reg, init_mem=init_mem)
    t.validate()
    return t
