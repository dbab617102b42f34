"""Scalar reference semantics for the µop ISA.

The host-side golden interpreter: the analog of the reference's CheckerCPU
(``src/cpu/checker/cpu.hh``) — an independent, simple implementation of the
same ISA semantics that the batched device kernels are differentially tested
against.  Also used by the trace generator to resolve branch outcomes and
golden values while generating.

All values are Python ints masked to 32 bits (uint32 semantics); signed
interpretation is explicit.
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.isa import uops as U

M32 = 0xFFFFFFFF


def _s32(x: int) -> int:
    """Reinterpret uint32 as signed."""
    x &= M32
    return x - (1 << 32) if x & 0x80000000 else x


_QNAN = 0x7FC00000
_FLT_MIN_EXP = 0x00800000       # smallest normal magnitude, as bits


def _fp_flush(bits: int) -> int:
    """Subnormal → signed zero (the FTZ half of the FP µop contract)."""
    if 0 < (bits & 0x7FFFFFFF) < _FLT_MIN_EXP:
        return bits & 0x80000000
    return bits


def _fp_op(op: int, a: int, b: int) -> int:
    """f32 bits × f32 bits → canonical f32 bits (see uops.py FP contract:
    IEEE RN, FTZ on inputs and outputs, canonical quiet NaN)."""
    af = np.uint32(_fp_flush(a)).view(np.float32)
    bf = np.uint32(_fp_flush(b)).view(np.float32)
    with np.errstate(all="ignore"):
        if op == U.FADD:
            r = np.float32(af + bf)
        elif op == U.FSUB:
            r = np.float32(af - bf)
        elif op == U.FMUL:
            r = np.float32(af * bf)
        else:
            r = np.float32(np.divide(af, bf, dtype=np.float32))
    if np.isnan(r):
        return _QNAN
    return _fp_flush(int(np.float32(r).view(np.uint32)))


def alu(op: int, a: int, b: int, imm: int) -> int:
    """Compute the µop's primary result (uint32).

    For memory ops the 'result' is the effective address (address-generation
    output); for branches it is the comparison outcome (0/1).
    """
    a &= M32
    b &= M32
    imm &= M32
    if op == U.NOP:
        return 0
    if op == U.ADD:
        return (a + b) & M32
    if op == U.SUB:
        return (a - b) & M32
    if op == U.AND:
        return a & b
    if op == U.OR:
        return a | b
    if op == U.XOR:
        return a ^ b
    if op == U.SLL:
        return (a << (b & 31)) & M32
    if op == U.SRL:
        return a >> (b & 31)
    if op == U.SRA:
        return (_s32(a) >> (b & 31)) & M32
    if op == U.ADDI:
        return (a + imm) & M32
    if op == U.ANDI:
        return a & imm
    if op == U.ORI:
        return a | imm
    if op == U.XORI:
        return a ^ imm
    if op == U.LUI:
        return imm
    if op == U.MUL:
        return (a * b) & M32
    if op == U.MULHU:
        return ((a * b) >> 32) & M32
    if op == U.SLT:
        return 1 if _s32(a) < _s32(b) else 0
    if op == U.SLTU:
        return 1 if a < b else 0
    if op in (U.DIV, U.REM):
        # x86 #DE cases (b==0, INT_MIN/-1) are TRAPS, resolved by the
        # kernels' trap path; the ALU result for them is defined as 0 so
        # every backend computes identically on the dead lane
        if b == 0 or (a == 0x80000000 and b == M32):
            return 0
        sa, sb = _s32(a), _s32(b)
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        return (q if op == U.DIV else sa - q * sb) & M32
    if op in (U.DIVU, U.REMU):
        if b == 0:
            return 0
        return (a // b if op == U.DIVU else a % b) & M32
    if U.FADD <= op <= U.FDIV:
        return _fp_op(op, a, b)
    if op in (U.LOAD, U.STORE):
        return (a + imm) & M32          # effective address
    if op == U.BEQ:
        return 1 if a == b else 0
    if op == U.BNE:
        return 1 if a != b else 0
    if op == U.BLT:
        return 1 if _s32(a) < _s32(b) else 0
    if op == U.BGE:
        return 1 if _s32(a) >= _s32(b) else 0
    raise ValueError(f"unknown opcode {op}")


def scalar_replay(trace, reg: np.ndarray, mem: np.ndarray,
                  record_mem: list | None = None):
    """Run a whole trace over (regfile, memory) — fault-free golden path.

    ``reg``/``mem`` are uint32 arrays, modified in place.  Returns the list of
    computed branch outcomes (for generator bookkeeping).  Memory addressing:
    word index = addr >> 2, valid iff aligned and within ``len(mem)`` words —
    identical to the device kernel's model.

    ``record_mem``, if given, collects the golden memory-access stream as
    ``(µop_index, word_index, is_store)`` tuples — the input to the cache
    timeline builder (models/ruby.py).
    """
    n_words = len(mem)
    taken = []
    for i in range(trace.n):
        op = int(trace.opcode[i])
        a = int(reg[trace.src1[i]])
        b = int(reg[trace.src2[i]])
        imm = int(trace.imm[i])
        res = alu(op, a, b, imm)
        if op == U.LOAD:
            addr = res
            assert addr % 4 == 0 and addr >> 2 < n_words, "golden trace must be in-range"
            res = int(mem[addr >> 2])
            reg[trace.dst[i]] = res
            if record_mem is not None:
                record_mem.append((i, addr >> 2, False))
        elif op == U.STORE:
            addr = res
            assert addr % 4 == 0 and addr >> 2 < n_words, "golden trace must be in-range"
            mem[addr >> 2] = b
            if record_mem is not None:
                record_mem.append((i, addr >> 2, True))
        elif U.is_branch(np.int64(op)):
            taken.append(res)
        elif U.writes_dest(np.int64(op)):
            reg[trace.dst[i]] = res
    return taken
