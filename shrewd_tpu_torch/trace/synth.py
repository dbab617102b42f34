"""Synthetic workload generator (the port's copy of
``shrewd_tpu/trace/synth.py``, with the scalar ALU of the opcodes it emits
from ``shrewd_tpu/isa/semantics.py alu``).

The framework's traffic-generator tier (SURVEY §4 tier 4): the analog of the
reference's synthetic load generators (``cpu/testers/traffic_gen/base.hh:67``
linear/random/strided generators and ``MemTest``) — drives the SFI kernels
with self-checking workloads of controllable character without needing SPEC
artifacts, which are licensed and external to the reference too (SURVEY §7
"Hard parts" #7).

Generates a µop window with a configurable instruction mix, dependency
locality (geometric reuse distance over recently-written registers), and a
bounded memory working set, executing as it generates (via the scalar golden
semantics) so branch outcomes and the memory image are consistent.
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils.config import ConfigObject, Param

M32 = 0xFFFFFFFF
_QNAN = 0x7FC00000
_FLT_MIN_EXP = 0x00800000       # smallest normal magnitude, as bits


def _s32(x: int) -> int:
    """Reinterpret uint32 as signed."""
    x &= M32
    return x - (1 << 32) if x & 0x80000000 else x


def _fp_flush(bits: int) -> int:
    """Subnormal → signed zero (the FTZ half of the FP µop contract)."""
    if 0 < (bits & 0x7FFFFFFF) < _FLT_MIN_EXP:
        return bits & 0x80000000
    return bits


def _fp_op(op: int, a: int, b: int) -> int:
    """f32 bits × f32 bits → canonical f32 bits (IEEE RN, FTZ on inputs
    and outputs, canonical quiet NaN)."""
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


_ALU = {
    U.NOP: lambda a, b, i: 0,
    U.ADD: lambda a, b, i: (a + b) & M32,
    U.SUB: lambda a, b, i: (a - b) & M32,
    U.AND: lambda a, b, i: a & b,
    U.OR: lambda a, b, i: a | b,
    U.XOR: lambda a, b, i: a ^ b,
    U.SLL: lambda a, b, i: (a << (b & 31)) & M32,
    U.SRL: lambda a, b, i: a >> (b & 31),
    U.SRA: lambda a, b, i: (_s32(a) >> (b & 31)) & M32,
    U.ADDI: lambda a, b, i: (a + i) & M32,
    U.ANDI: lambda a, b, i: a & i,
    U.ORI: lambda a, b, i: a | i,
    U.XORI: lambda a, b, i: a ^ i,
    U.LUI: lambda a, b, i: i,
    U.MUL: lambda a, b, i: (a * b) & M32,
    U.SLT: lambda a, b, i: int(_s32(a) < _s32(b)),
    U.SLTU: lambda a, b, i: int(a < b),
    U.LOAD: lambda a, b, i: (a + i) & M32,      # effective address
    U.STORE: lambda a, b, i: (a + i) & M32,
    U.BEQ: lambda a, b, i: int(a == b),
    U.BNE: lambda a, b, i: int(a != b),
    U.BLT: lambda a, b, i: int(_s32(a) < _s32(b)),
    U.BGE: lambda a, b, i: int(_s32(a) >= _s32(b)),
}


def alu(op: int, a: int, b: int, imm: int) -> int:
    """The primary result (uint32) of the opcodes the generator emits: the
    effective address for memory ops, the comparison outcome for
    branches."""
    a, b, imm = a & M32, b & M32, imm & M32
    if U.FADD <= op <= U.FDIV:
        return _fp_op(op, a, b)
    return _ALU[op](a, b, imm)

_ALU_OPS = np.array([U.ADD, U.SUB, U.AND, U.OR, U.XOR, U.SLL, U.SRL, U.SRA,
                     U.ADDI, U.ANDI, U.ORI, U.XORI, U.LUI, U.SLT, U.SLTU],
                    dtype=np.int32)
_BRANCH_OPS = np.array([U.BEQ, U.BNE, U.BLT, U.BGE], dtype=np.int32)
_FP_OPS = np.array([U.FADD, U.FSUB, U.FMUL, U.FDIV], dtype=np.int32)


class WorkloadConfig(ConfigObject):
    """Mix/shape knobs for a synthetic SimPoint window."""

    n = Param(int, 4096, "µops in the window")
    nphys = Param(int, 256, "register-file entries (power of two)")
    mem_words = Param(int, 4096, "memory words (power of two)")
    working_set_words = Param(int, 1024, "words touched by loads/stores")
    frac_alu = Param(float, 0.50, "ALU fraction")
    frac_mul = Param(float, 0.05, "integer-multiply fraction")
    frac_load = Param(float, 0.20, "load fraction")
    frac_store = Param(float, 0.12, "store fraction")
    frac_branch = Param(float, 0.08, "branch fraction")
    frac_fp = Param(float, 0.0, "FP fraction (FADD/FSUB/FMUL/FDIV on f32 "
                    "bit patterns in the integer register file)")
    # remaining fraction is NOPs
    locality = Param(float, 0.8, "P(src comes from recently-written regs)")
    reuse_geo_p = Param(float, 0.3, "geometric reuse-distance parameter")
    seed = Param(int, 0, "generator seed")


def generate(cfg: WorkloadConfig, init_reg: np.ndarray | None = None,
             init_mem: np.ndarray | None = None,
             capture_at: int | None = None):
    """Generate a window. ``init_reg``/``init_mem`` override the random
    initial machine state — the restore path for ingested checkpoints
    (ingest/warm.py) where the state comes from a golden gem5 run.

    ``capture_at=k`` additionally returns the machine state after the first
    k µops retire (``(trace, reg_k, mem_k)``) — the generator already
    executes every µop, so warmup capture costs nothing extra."""
    rng = np.random.default_rng(cfg.seed)
    nphys, n = cfg.nphys, cfg.n
    ws = min(cfg.working_set_words, cfg.mem_words)

    if init_reg is None:
        reg = rng.integers(0, 1 << 32, size=nphys, dtype=np.uint32)
    else:
        if init_reg.shape != (nphys,):
            raise ValueError(f"init_reg shape {init_reg.shape} != ({nphys},)")
        reg = np.asarray(init_reg, dtype=np.uint32).copy()
    if init_mem is None:
        mem = rng.integers(0, 1 << 32, size=cfg.mem_words, dtype=np.uint32)
    else:
        if init_mem.shape != (cfg.mem_words,):
            raise ValueError(
                f"init_mem shape {init_mem.shape} != ({cfg.mem_words},)")
        mem = np.asarray(init_mem, dtype=np.uint32).copy()
    init_reg, init_mem = reg.copy(), mem.copy()

    opcode = np.zeros(n, dtype=np.int32)
    dst = np.zeros(n, dtype=np.int32)
    src1 = np.zeros(n, dtype=np.int32)
    src2 = np.zeros(n, dtype=np.int32)
    imm = np.zeros(n, dtype=np.uint32)
    taken = np.zeros(n, dtype=np.int32)

    recent: list[int] = []           # recently-written register indices

    def pick_src() -> int:
        if recent and rng.random() < cfg.locality:
            d = min(rng.geometric(cfg.reuse_geo_p), len(recent))
            return recent[-d]
        return int(rng.integers(nphys))

    probs = np.array([cfg.frac_alu, cfg.frac_mul, cfg.frac_load,
                      cfg.frac_store, cfg.frac_branch, cfg.frac_fp])
    if probs.sum() > 1.0 + 1e-9:
        raise ValueError("instruction-mix fractions exceed 1")
    kinds = rng.choice(7, size=n, p=np.append(probs, 1.0 - probs.sum()))

    captured: tuple[np.ndarray, np.ndarray] | None = None
    for i in range(n):
        if capture_at is not None and i == capture_at:
            captured = (reg.copy(), mem.copy())
        kind = kinds[i]
        if kind == 0:                 # ALU
            op = int(_ALU_OPS[rng.integers(len(_ALU_OPS))])
            s1, s2, d = pick_src(), pick_src(), int(rng.integers(nphys))
            im = int(rng.integers(0, 1 << 16))
        elif kind == 1:               # MUL
            op, s1, s2, d = U.MUL, pick_src(), pick_src(), int(rng.integers(nphys))
            im = 0
        elif kind in (2, 3):          # LOAD / STORE
            op = U.LOAD if kind == 2 else U.STORE
            s1 = pick_src()
            s2 = pick_src()           # store data (unused by load)
            d = int(rng.integers(nphys))
            word = int(rng.integers(ws))
            # imm chosen so effective address rs1+imm lands on `word`
            im = (word * 4 - int(reg[s1])) & M32
        elif kind == 4:               # branch
            op = int(_BRANCH_OPS[rng.integers(len(_BRANCH_OPS))])
            s1, s2, d = pick_src(), pick_src(), 0
            im = 0
        elif kind == 5:               # FP (values are f32 bit patterns)
            op = int(_FP_OPS[rng.integers(len(_FP_OPS))])
            s1, s2, d = pick_src(), pick_src(), int(rng.integers(nphys))
            im = 0
        else:                         # NOP
            op, s1, s2, d, im = U.NOP, 0, 0, 0, 0

        opcode[i], dst[i], src1[i], src2[i], imm[i] = op, d, s1, s2, im

        # execute (keeps generator state consistent; records branch outcomes)
        a, b = int(reg[s1]), int(reg[s2])
        res = alu(op, a, b, im)
        if op == U.LOAD:
            reg[d] = mem[res >> 2]
            recent.append(d)
        elif op == U.STORE:
            mem[res >> 2] = b
        elif U.is_branch(np.int64(op)):
            taken[i] = res
        elif U.writes_dest(np.int64(op)):
            reg[d] = res
            recent.append(d)
        if len(recent) > 64:
            del recent[:-64]

    trace = Trace(opcode=opcode, dst=dst, src1=src1, src2=src2, imm=imm,
                  taken=taken, init_reg=init_reg, init_mem=init_mem)
    trace.validate()
    if capture_at is None:
        return trace
    if captured is None:                   # capture_at == n (or beyond)
        captured = (reg.copy(), mem.copy())
    return trace, captured[0], captured[1]
