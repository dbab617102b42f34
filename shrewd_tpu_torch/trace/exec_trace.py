"""Exec-style instruction tracer for replay windows (SURVEY §5.1; the
port's copy of ``shrewd_tpu/trace/exec_trace.py``).

Reference role: gem5's exec tracer (``src/cpu/exetrace.cc`` ExecEnable /
ExecAll family) — per-instruction lines with PC, disassembly, op class,
result, and memory address, gated by ``--debug-flags Exec...``.

Here the traced object is a replay *window* (the golden µop stream plus the
GoldenRecord value streams the taint kernel already records), so tracing
costs one copy of four of those streams to the host and one formatting
pass over them — no device-side instrumentation, no re-execution.  A
``Fault`` may be overlaid to annotate the landing step and (for
dense-replay results) per-step value deviations.

Flags (registered on import, gem5 names where the concept matches):
  Exec        one line per µop: step, disasm
  ExecResult  append writeback value / load-store address+data
  ExecOpClass append the OpClass
  ExecAll     compound: all of the above
"""

from __future__ import annotations

import sys
from typing import IO

import numpy as np

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.utils import debug

debug.register_flag("Exec", "per-µop replay trace lines")
debug.register_flag("ExecResult", "append results/memory to Exec lines")
debug.register_flag("ExecOpClass", "append the OpClass to Exec lines")
debug.register_compound("ExecAll", ("Exec", "ExecResult", "ExecOpClass"),
                        "full exec trace")


def disassemble(trace, i: int) -> str:
    """One µop in a readable three-operand form."""
    op = int(trace.opcode[i])
    name = U.OPCODE_NAMES[op].lower()
    dst, s1, s2 = (int(trace.dst[i]), int(trace.src1[i]),
                   int(trace.src2[i]))
    imm = int(np.asarray(trace.imm)[i]) & 0xFFFFFFFF
    if op == U.NOP:
        return "nop"
    if op in (U.ADDI, U.ANDI, U.ORI, U.XORI):
        return f"{name:<6} r{dst}, r{s1}, {imm:#x}"
    if op == U.LUI:
        return f"{name:<6} r{dst}, {imm:#x}"
    if op == U.LOAD:
        return f"{name:<6} r{dst}, [r{s1}{imm:+#x}]"
    if op == U.STORE:
        return f"{name:<6} [r{s1}{imm:+#x}], r{s2}"
    if U.is_branch(np.int64(op)):
        return f"{name:<6} r{s1}, r{s2}"
    return f"{name:<6} r{dst}, r{s1}, r{s2}"


def _host(golden_rec):
    """The golden record with the four streams a line reads (``res``,
    ``ea``, ``b``, ``wr``) as host arrays, whichever device recorded it;
    the timelines are left where they are."""
    if golden_rec is None:
        return None
    return golden_rec._replace(**{
        f: v.cpu().numpy() for f in ("res", "ea", "b", "wr")
        if hasattr(v := getattr(golden_rec, f), "cpu")})


def format_line(trace, golden_rec, i: int, fault=None) -> str:
    """One exec-trace line (the reference's Exec format, window-local)."""
    golden_rec = _host(golden_rec)
    parts = [f"{i:6d}:", disassemble(trace, i)]
    if debug.enabled("ExecOpClass"):
        oc = int(U.opclass_of(np.asarray(trace.opcode[i:i + 1]))[0])
        parts.append(f": {U.OPCLASS_NAMES[oc]}")
    if debug.enabled("ExecResult") and golden_rec is not None:
        op = int(trace.opcode[i])
        res = int(np.asarray(golden_rec.res)[i])
        if op == U.LOAD:
            ea = int(np.asarray(golden_rec.ea)[i])
            parts.append(f": A={ea:#010x} D={res:#010x}")
        elif op == U.STORE:
            ea = int(np.asarray(golden_rec.ea)[i])
            d = int(np.asarray(golden_rec.b)[i])
            parts.append(f": A={ea:#010x} D={d:#010x}")
        elif bool(np.asarray(golden_rec.wr)[i]):
            parts.append(f": D={res:#010x}")
        if U.is_branch(np.int64(op)):
            parts.append(f": taken={int(trace.taken[i])}")
    if fault is not None and int(fault.entry) == i:
        parts.append(f"   <-- fault kind={int(fault.kind)} "
                     f"bit={int(fault.bit)}")
    return " ".join(parts)


def exec_trace(trace, golden_rec=None, fault=None, out: IO = None,
               start: int = 0, count: int | None = None) -> int:
    """Dump the window's exec trace to ``out`` if the Exec flag is enabled
    (the gem5 contract: tracing is flag-gated, not call-gated).  Returns
    the number of lines written."""
    if not debug.enabled("Exec"):
        return 0
    out = out or sys.stderr
    golden_rec = _host(golden_rec)
    start = min(max(start, 0), trace.n)
    end = trace.n if count is None else min(trace.n, start + max(count, 0))
    for i in range(start, end):
        print(format_line(trace, golden_rec, i, fault), file=out)
    return end - start
