"""64-bit pair-lane lift: the full-width device datapath (VERDICT r3 #5).

The 32-bit lifter projects x86-64 state onto low-32 lanes, so the replay
kernel could only model fault bits [0,32) — the upper halves of the
reference's 64-bit ``PhysRegFile`` banks
(``gem5 src/cpu/o3/regfile.hh:65-99``) were out of reach of the
*device* and round 3 substituted the host emulator.  This module lifts the
same captures into **register pairs over the unchanged 32-bit µop ISA**:
architectural register ``r`` lives in phys ``r`` (bits 31:0) and phys
``r+32`` (bits 63:32), and 64-bit x86 semantics are expressed as short
carry/borrow µop sequences (the classic RV32-style lowering).  Nothing in
the dense/taint kernels or the C++ golden changes — the device really
executes the 64-bit dataflow, and a REGFILE fault coordinate
``(reg, bit)`` with bit ∈ [0,64) maps to phys ``(reg + 32·(bit≥32),
bit mod 32)``.

Correctness authority: the per-macro-op self-check now compares the FULL
captured 64-bit register file (``_regs_match``), so any hi-lane semantics
this lifter gets wrong demote that macro-op to an opaque resync instead of
silently corrupting the golden — the same fail-closed discipline as the
32-bit lift.

Address faithfulness: replay addresses stay in the folded low-32 cluster
space, so a *hi-lane* deviation of an address register would otherwise be
invisible to the memory system.  Every memory access therefore carries a
hi-guard: the contributing registers' hi lanes are XORed against their
captured golden values and any deviation ORs a 2^30 poison into the
effective address, which throws it outside every mapped-region window of
the VA crash model (ops/replay.MemMap) — exactly the silicon outcome,
where any hi-bit pointer corruption faults.
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.ingest.lift import (M32, N_GPR, T0, T1, T2, T3, T4, T5, T6,
                                    T7, TCMP, ZERO, Inst, Lifter, NativeTrace,
                                    Operand, _JCC_SIGNED, _JCC_UNSIGNED,
                                    read_nativetrace, static_decode)
from shrewd_tpu_torch.isa import uops as U

HI = 32                      # hi-lane offset: phys(hi(r)) = r + HI
G0, G1 = 26, 27              # guard scratch (lo-lane space, never arch)
NPHYS64 = 64
M64 = 0xFFFFFFFFFFFFFFFF


def hi(r: int) -> int:
    return r + HI


def _sx32(v: int) -> int:
    """x86 imm32 → imm64 sign extension (the default for every non-movabs
    64-bit immediate form)."""
    v &= M64
    if v & 0x80000000 and (v >> 32) == 0:
        v |= 0xFFFFFFFF00000000
    return v


class Lifter64(Lifter):
    """Pair-lane lifter: explicit 64-bit handlers first, then delegation
    to the 32-bit handlers with an architectural hi-zero fix for 32-bit
    register writes (x86 zeroes bits 63:32 on every 32-bit write,
    data-independently), all under full-width verification."""

    # phys 32..57 are the GPR/temp hi lanes here, so the base lifter's
    # FP bank (FX0=32..47) cannot coexist — xmm instructions demote in
    # 64-bit mode (use the 32-bit lift for FP campaigns)
    FP_BASE = None

    # mnemonics whose last operand is NOT a written register destination
    _NO_DEST = ("cmp", "test", "push", "bt", "j", "call", "ret", "nop")

    def __init__(self, nt: NativeTrace, insts: dict[int, Inst],
                 max_uops: int | None = None, elf_regs: list | None = None):
        super().__init__(nt, insts, max_uops=max_uops, elf_regs=elf_regs)
        self.reg = np.zeros(NPHYS64, dtype=np.uint64)

    # -- width hooks -------------------------------------------------------

    def _seed_regs(self, step0: np.ndarray) -> None:
        self.reg[:] = 0
        self.reg[:N_GPR] = step0[:N_GPR] & np.uint64(M32)
        self.reg[HI:HI + N_GPR] = step0[:N_GPR] >> np.uint64(32)

    def _full(self, r: int) -> int:
        return int(self.reg[r]) | (int(self.reg[hi(r)]) << 32)

    def _regs_match(self, next_full: np.ndarray) -> bool:
        got = self.reg[:N_GPR] | (self.reg[HI:HI + N_GPR] << np.uint64(32))
        return bool((got == next_full[:N_GPR]).all())

    def _resync_regs(self, next_full: np.ndarray) -> None:
        lo_want = next_full[:N_GPR] & np.uint64(M32)
        hi_want = next_full[:N_GPR] >> np.uint64(32)
        for r in np.nonzero(self.reg[:N_GPR] != lo_want)[0]:
            self._emit_resync(int(r), int(lo_want[r]))
        for r in np.nonzero(self.reg[HI:HI + N_GPR] != hi_want)[0]:
            self._emit_resync(hi(int(r)), int(hi_want[r]))

    def _final_reg_expect(self, vals: np.ndarray) -> list:
        return [int(x) for x in vals[:N_GPR]]

    # -- pair emission helpers --------------------------------------------

    def _const64(self, v: int, treg: int) -> int:
        self._emit(U.LUI, treg, ZERO, ZERO, v & M32)
        self._emit(U.LUI, hi(treg), ZERO, ZERO, (v >> 32) & M32)
        return treg

    def _mov64(self, d: int, s: int) -> None:
        if d == s:
            return
        self._emit(U.ADD, d, s, ZERO)
        self._emit(U.ADD, hi(d), hi(s), ZERO)

    def _add64(self, d: int, a: int, b: int) -> None:
        """d = a + b (64-bit, carry via SLTU; d may alias a or b, but b
        must not be the T7 scratch pair)."""
        assert b != T7, "T7 pair is _add64 scratch"
        self._emit(U.ADD, T7, a, b)             # lo sum
        self._emit(U.SLTU, hi(T7), T7, a)       # carry-out ⟺ sum < a
        self._emit(U.ADD, hi(d), hi(a), hi(b))
        self._emit(U.ADD, hi(d), hi(d), hi(T7))
        self._emit(U.ADD, d, T7, ZERO)

    def _addi64(self, d: int, a: int, imm: int) -> None:
        self._const64(imm & M64, T4)
        self._add64(d, a, T4)

    def _sub64(self, d: int, a: int, b: int) -> None:
        self._emit(U.SLTU, hi(T7), a, b)        # borrow
        self._emit(U.SUB, T7, a, b)
        self._emit(U.SUB, hi(d), hi(a), hi(b))
        self._emit(U.SUB, hi(d), hi(d), hi(T7))
        self._emit(U.ADD, d, T7, ZERO)

    def _logic64(self, op: int, d: int, a: int, b: int) -> None:
        self._emit(op, d, a, b)
        self._emit(op, hi(d), hi(a), hi(b))

    def _shl64_imm(self, d: int, a: int, c: int) -> None:
        c &= 63
        if c == 0:
            self._mov64(d, a)
            return
        self._emit(U.ADDI, T7, ZERO, ZERO, c & 31)
        if c < 32:
            self._emit(U.ADDI, hi(T7), ZERO, ZERO, 32 - c)
            self._emit(U.SLL, T4, hi(a), T7)
            self._emit(U.SRL, hi(T4), a, hi(T7))
            self._emit(U.OR, hi(d), T4, hi(T4))
            self._emit(U.SLL, d, a, T7)
        else:
            self._emit(U.SLL, hi(d), a, T7)     # shift amount (c-32)&31
            self._emit(U.LUI, d, ZERO, ZERO, 0)

    def _shr64_imm(self, d: int, a: int, c: int, arith: bool) -> None:
        c &= 63
        sh = U.SRA if arith else U.SRL
        if c == 0:
            self._mov64(d, a)
            return
        self._emit(U.ADDI, T7, ZERO, ZERO, c & 31)
        if c < 32:
            self._emit(U.ADDI, hi(T7), ZERO, ZERO, 32 - c)
            self._emit(U.SRL, T4, a, T7)
            self._emit(U.SLL, hi(T4), hi(a), hi(T7))
            self._emit(U.OR, d, T4, hi(T4))
            self._emit(sh, hi(d), hi(a), T7)
        else:
            self._emit(sh, d, hi(a), T7)        # amount (c-32)&31
            if arith:
                self._emit(U.ADDI, T7, ZERO, ZERO, 31)
                self._emit(U.SRA, hi(d), hi(a), T7)
            else:
                self._emit(U.LUI, hi(d), ZERO, ZERO, 0)

    def _ltu64(self, dst: int, alo: int, ahi: int, blo: int, bhi: int,
               signed: bool) -> None:
        """dst(lo) = (a < b) over the 64-bit pairs, 0/1."""
        self._emit(U.SLT if signed else U.SLTU, dst, ahi, bhi)
        self._emit(U.XOR, G1, ahi, bhi)
        self._emit(U.SLTU, G1, ZERO, G1)        # hi_neq
        self._emit(U.ADDI, hi(G1), ZERO, ZERO, 1)
        self._emit(U.SUB, G1, hi(G1), G1)       # hi_eq
        self._emit(U.SLTU, hi(G0), alo, blo)    # lo_lt
        self._emit(U.AND, G1, G1, hi(G0))
        self._emit(U.OR, dst, dst, G1)

    # -- address hi-guards -------------------------------------------------

    def _guard_regs(self, op: Operand) -> list[int]:
        return [x for x in (op.base, op.index)
                if isinstance(x, int) and 0 <= x < N_GPR]

    def _emit_guard(self, base_reg: int, regs: list[int]) -> int:
        """Poison the effective address when any contributing register's
        hi lane deviates from its captured golden value → the VA crash
        model traps, matching the silicon segfault for hi-bit pointer
        corruption.  Returns the guarded address register (G0)."""
        first = True
        for r in regs:
            ghi = int(self.reg[hi(r)])
            if first:
                self._emit(U.XORI, G0, hi(r), ZERO, ghi)
                first = False
            else:
                self._emit(U.XORI, G1, hi(r), ZERO, ghi)
                self._emit(U.OR, G0, G0, G1)
        self._emit(U.SLTU, G0, ZERO, G0)        # any deviation → 1
        self._emit(U.ADDI, G1, ZERO, ZERO, 30)
        self._emit(U.SLL, G0, G0, G1)           # 0 or 2^30 poison
        self._emit(U.ADD, G0, base_reg, G0)
        return G0

    def _addr_uops(self, op: Operand, pc: int, treg: int):
        r = super()._addr_uops(op, pc, treg)
        if r is None:
            return None
        base_reg, disp = r
        regs = self._guard_regs(op)
        if op.rip_rel or not regs:
            return r
        return self._emit_guard(base_reg, regs), disp

    def _subword_addr(self, op: Operand, pc: int, regs: np.ndarray,
                      width: int):
        r = super()._subword_addr(op, pc, regs, width)
        if r is None:
            return None
        word_r, sh_r = r
        gregs = self._guard_regs(op)
        if op.rip_rel or not gregs:
            return r
        return self._emit_guard(word_r, gregs), sh_r

    # -- stack helpers (2-word slots, rsp hi-guarded) ----------------------

    def _rsp_addr(self) -> int:
        """Guarded stack address register for the current rsp."""
        return self._emit_guard(4, [4])

    # -- the 64-bit handler layer ------------------------------------------

    # -- EVEX chain: pair-lane kmovq + 64-bit tzcnt ------------------------
    def _lift_vec_chain(self, m, ops, pc, regs):
        if m == "kmovq" and len(ops) == 2 and ops[0].kind == "kreg" \
                and ops[1].kind == "reg" and ops[1].reg >= 0:
            _, kmask = self._vec_state()
            st = kmask.get(ops[0].reg)
            dst = ops[1].reg
            if isinstance(st, self._KConcat):
                if not (self._kmask_live(st.lo, dst, regs)
                        and self._kmask_live(st.hi, dst, regs)):
                    return False
                return (self._materialize_kmask(st.lo, dst, regs)
                        and self._materialize_kmask(st.hi, hi(dst), regs))
            if isinstance(st, self._KMask) and st.width <= 32 \
                    and self._kmask_live(st, dst, regs):
                if not self._materialize_kmask(st, dst, regs):
                    return False
                self._emit(U.LUI, hi(dst), ZERO, ZERO, 0)
                return True
            return False
        if m == "tzcnt" and len(ops) == 2 \
                and all(o.kind == "reg" and o.reg >= 0
                        and abs(o.width) == 64 for o in ops):
            src, dst = ops[0].reg, ops[1].reg
            # ctz64 = ctz32(lo) + (lo==0 ? ctz32(hi) : 0) — ctz32 already
            # returns 32 for a zero input, so the sum is 64 for src==0
            self._emit_ctz32(src, T0)
            self._emit_ctz32(hi(src), T1)
            self._emit(U.ADDI, T2, ZERO, ZERO, 5)
            self._emit(U.SRL, T2, T0, T2)            # 1 iff ctz_lo == 32
            self._emit(U.ANDI, T2, T2, ZERO, 1)
            self._emit(U.SUB, T3, ZERO, T2)          # 0 or all-ones
            self._emit(U.AND, T3, T1, T3)
            self._emit(U.ADD, dst, T0, T3)
            self._emit(U.LUI, hi(dst), ZERO, ZERO, 0)
            self.flags_src = ("res64", dst)
            return True
        return super()._lift_vec_chain(m, ops, pc, regs)

    # -- string-op primitives: pair-lane widening + hi-guards --------------
    def _inc_strreg(self, r: int, v: int) -> None:
        self._addi64(r, r, v)

    def _str_copy_word(self, sdelta: int, ddelta: int, w: int) -> None:
        s = self._emit_guard(self._RSI, [self._RSI])
        self._emit(U.LOAD, T6, s, ZERO, sdelta)
        if w == 8:
            self._emit(U.LOAD, T7, s, ZERO, (sdelta + 4) & M32)
        d = self._emit_guard(self._RDI, [self._RDI])
        self._emit(U.STORE, 0, d, T6, ddelta)
        if w == 8:
            self._emit(U.STORE, 0, d, T7, (ddelta + 4) & M32)

    def _str_store_reg(self, reg: int, ddelta: int, w: int,
                       hi_imm: int = 0) -> None:
        # hi_imm unused: the pair-lane datapath has the live hi lane
        d = self._emit_guard(self._RDI, [self._RDI])
        self._emit(U.STORE, 0, d, reg, ddelta)
        if w == 8:
            self._emit(U.STORE, 0, d, hi(reg), (ddelta + 4) & M32)

    def _lift_one(self, i: int, inst: Inst, regs: np.ndarray,
                  next_regs: np.ndarray, next_pc: int) -> bool:
        if self._lift_one64(i, inst, regs, next_pc):
            return True
        # 64-kind flags must never reach the 32-bit flag consumers — the
        # tuple shapes coincide and they would silently compute on lo
        # lanes; demote instead (fail-closed)
        m0 = inst.mnemonic.split()[0]
        m0 = {"jz": "je", "jnz": "jne"}.get(m0, m0)
        if self.flags_src is not None \
                and self.flags_src[0] in ("cmp64", "res64") \
                and (m0 in _JCC_SIGNED or m0 in _JCC_UNSIGNED
                     or m0.startswith(("set", "cmov"))):
            return False
        # 64-bit-WIDTH flag producers must never delegate either: the base
        # handlers would compare/test lo lanes only, and the golden-
        # consistent result would hide hi-lane fault propagation — the
        # exact coordinates device64 mode exists to cover
        if m0.startswith(("cmp", "test")) \
                and self._w64(m0, inst, inst.operands):
            return False
        if not super()._lift_one(i, inst, regs, next_regs, next_pc):
            return False
        self._fix_hi_lanes(inst, m0)
        return True

    # implicit 32-bit destinations of delegated handlers: one-operand
    # mul/div write edx:eax; cdq/cltd write edx — all with hi-zeroing
    _IMPLICIT_HI_ZERO = {"cdq": (2,), "cltd": (2,)}

    def _fix_hi_lanes(self, inst: Inst, m: str) -> None:
        """Architectural hi-zero for delegated 32-bit handlers: every
        32-bit register write clears bits 63:32 regardless of data."""
        ops = inst.operands
        if m in ("div", "idiv", "mul", "imul") and len(ops) == 1:
            if ops[0].kind == "reg" and abs(ops[0].width) == 32:
                self._emit(U.LUI, hi(0), ZERO, ZERO, 0)   # eax
                self._emit(U.LUI, hi(2), ZERO, ZERO, 0)   # edx
            return
        if m in self._IMPLICIT_HI_ZERO:
            for r in self._IMPLICIT_HI_ZERO[m]:
                self._emit(U.LUI, hi(r), ZERO, ZERO, 0)
            return
        if m.startswith(self._NO_DEST) or not ops:
            return
        dst = ops[-1]
        if dst.kind == "reg" and dst.reg >= 0 and dst.width == 32:
            self._emit(U.LUI, hi(dst.reg), ZERO, ZERO, 0)
        if m.startswith("xchg"):
            o0 = ops[0]
            if o0.kind == "reg" and o0.reg >= 0 and o0.width == 32:
                self._emit(U.LUI, hi(o0.reg), ZERO, ZERO, 0)

    def _is64(self, o: Operand) -> bool:
        return o.kind == "reg" and o.reg >= 0 and abs(o.width) == 64

    def _w64(self, m: str, inst: Inst, ops: list) -> bool:
        """True when the operation's width is 64 bits: q suffix, a 64-bit
        register operand, or an 8-byte memory operand."""
        if m.endswith("q"):
            return True
        if any(self._is64(o) for o in ops):
            return True
        return any(o.kind == "mem" and self._mem_width(inst, o) == 8
                   for o in ops)

    def _lift_one64(self, i: int, inst: Inst, regs: np.ndarray,
                    next_pc: int) -> bool:
        m = inst.mnemonic
        ops = inst.operands
        pc = int(regs[16])
        mark = len(self.opcode)
        try:
            done = self._dispatch64(m, ops, pc, inst, next_pc)
        except Exception:  # noqa: BLE001 — any surprise demotes, fail-closed
            self._rollback(mark)
            return False
        if not done:
            self._rollback(mark)
        return done

    def _dispatch64(self, m: str, ops: list, pc: int, inst: Inst,
                    next_pc: int) -> bool:
        m = {"jz": "je", "jnz": "jne"}.get(m, m)
        # --- moves -------------------------------------------------------
        if m in ("mov", "movq", "movabs", "movabsq") and len(ops) == 2:
            src, dst = ops

            def imm64(v: int) -> int:
                if m in ("movabs", "movabsq"):
                    return v & M64              # full 64-bit immediate
                return _sx32(v)

            if self._is64(dst):
                if src.kind == "imm":
                    self._const64(imm64(src.imm), dst.reg)
                    return True
                if self._is64(src):
                    self._mov64(dst.reg, src.reg)
                    return True
                if src.kind == "mem":
                    a = self._addr_uops(src, pc, T0)
                    if a is None:
                        return False
                    self._emit(U.LOAD, dst.reg, a[0], ZERO, a[1])
                    self._emit(U.LOAD, hi(dst.reg), a[0], ZERO,
                               (a[1] + 4) & M32)
                    return True
                return False
            if dst.kind == "mem" and (self._is64(src)
                                      or (src.kind == "imm"
                                          and m in ("movq",))):
                a = self._addr_uops(dst, pc, T0)
                if a is None:
                    return False
                if src.kind == "imm":
                    self._const64(imm64(src.imm), T1)
                    sreg = T1
                else:
                    sreg = src.reg
                self._emit(U.STORE, 0, a[0], sreg, a[1])
                self._emit(U.STORE, 0, a[0], hi(sreg), (a[1] + 4) & M32)
                return True
            return False
        if m in ("movslq", "movsxd") and len(ops) == 2:
            src, dst = ops
            if not self._is64(dst):
                return False
            if src.kind == "reg" and src.reg >= 0:
                self._emit(U.ADD, dst.reg, src.reg, ZERO)
            elif src.kind == "mem":
                a = self._addr_uops(src, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, dst.reg, a[0], ZERO, a[1])
            else:
                return False
            self._emit(U.ADDI, T7, ZERO, ZERO, 31)
            self._emit(U.SRA, hi(dst.reg), dst.reg, T7)
            return True
        # --- lea (64-bit address arithmetic into a register) -------------
        if m in ("lea", "leaq") and len(ops) == 2:
            src, dst = ops
            if not self._is64(dst) or src.kind != "mem" or src.seg:
                return False
            if src.rip_rel:
                self._const64(src.disp & M64, dst.reg)
                return True
            if src.base < 0 and src.index < 0:
                self._const64(src.disp & M64, dst.reg)
                return True
            parts = []
            if src.index >= 0:
                if src.scale > 1:
                    self._shl64_imm(T2, src.index,
                                    src.scale.bit_length() - 1)
                else:
                    self._mov64(T2, src.index)
                parts.append(T2)
            if src.base >= 0:
                if parts:
                    self._add64(T2, T2, src.base)
                else:
                    self._mov64(T2, src.base)
            self._addi64(dst.reg, T2 if (src.base >= 0 or parts)
                         else ZERO, src.disp)
            return True
        # --- 64-bit ALU ---------------------------------------------------
        alu64 = {"add": "add", "addq": "add", "sub": "sub", "subq": "sub",
                 "and": "and", "andq": "and", "or": "or", "orq": "or",
                 "xor": "xor", "xorq": "xor"}
        if m in alu64 and len(ops) == 2:
            src, dst = ops
            if not self._is64(dst):
                return False
            kind = alu64[m]
            if src.kind == "imm":
                sreg = self._const64(_sx32(src.imm), T1)
            elif self._is64(src):
                sreg = src.reg
            elif src.kind == "mem":
                a = self._addr_uops(src, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T1, a[0], ZERO, a[1])
                self._emit(U.LOAD, hi(T1), a[0], ZERO, (a[1] + 4) & M32)
                sreg = T1
            else:
                return False
            if kind == "add":
                self._add64(dst.reg, dst.reg, sreg)
            elif kind == "sub":
                self._sub64(dst.reg, dst.reg, sreg)
            else:
                opmap = {"and": U.AND, "or": U.OR, "xor": U.XOR}
                self._logic64(opmap[kind], dst.reg, dst.reg, sreg)
            self.flags_src = ("res64", dst.reg)
            return True
        if m in ("inc", "incq", "dec", "decq") and len(ops) == 1 \
                and self._is64(ops[0]):
            d = ops[0].reg
            self._addi64(d, d, 1 if m.startswith("inc") else M64)
            self.flags_src = ("res64", d)       # CF unchanged; ZF/SF ok
            return True
        if m in ("neg", "negq") and len(ops) == 1 and self._is64(ops[0]):
            d = ops[0].reg
            self._emit(U.SLTU, hi(T7), ZERO, d)  # borrow from 0 - lo
            self._emit(U.SUB, d, ZERO, d)
            self._emit(U.SUB, hi(d), ZERO, hi(d))
            self._emit(U.SUB, hi(d), hi(d), hi(T7))
            self.flags_src = ("res64", d)
            return True
        if m in ("not", "notq") and len(ops) == 1 and self._is64(ops[0]):
            d = ops[0].reg
            self._emit(U.XORI, d, d, ZERO, M32)
            self._emit(U.XORI, hi(d), hi(d), ZERO, M32)
            return True
        # --- shifts by immediate -----------------------------------------
        if m in ("shl", "shlq", "sal", "salq", "shr", "shrq",
                 "sar", "sarq") and len(ops) in (1, 2):
            dst = ops[-1]
            if not self._is64(dst):
                return False
            if len(ops) == 2:
                if ops[0].kind != "imm":
                    return False                # variable count: demote
                c = ops[0].imm & 63
            else:
                c = 1
            if m.startswith(("shl", "sal")):
                self._shl64_imm(dst.reg, dst.reg, c)
            else:
                self._shr64_imm(dst.reg, dst.reg, c,
                                arith=m.startswith("sar"))
            self.flags_src = ("res64", dst.reg)
            return True
        # --- compares / tests --------------------------------------------
        if m in ("cmp", "cmpq") and len(ops) == 2 \
                and self._w64(m, inst, ops):
            src, dst = ops
            if src.kind == "imm":
                b = self._const64(_sx32(src.imm), TCMP)
            elif self._is64(src):
                b = src.reg
            else:
                return False
            if self._is64(dst):
                a = dst.reg
            elif dst.kind == "mem":
                aa = self._addr_uops(dst, pc, T0)
                if aa is None:
                    return False
                self._emit(U.LOAD, T2, aa[0], ZERO, aa[1])
                self._emit(U.LOAD, hi(T2), aa[0], ZERO, (aa[1] + 4) & M32)
                a = T2
            else:
                return False
            self.flags_src = ("cmp64", a, b)
            return True
        if m in ("test", "testq") and len(ops) == 2 \
                and self._w64(m, inst, ops):
            if self._is64(ops[0]) and self._is64(ops[1]):
                a, b = ops[0].reg, ops[1].reg
                if a == b:
                    self.flags_src = ("res64", a)
                    return True
            elif ops[0].kind == "imm" and self._is64(ops[1]):
                a = self._const64(_sx32(ops[0].imm), TCMP)
                b = ops[1].reg
            else:
                return False
            self._emit(U.AND, T2, a, b)
            self._emit(U.AND, hi(T2), hi(a), hi(b))
            self.flags_src = ("res64", T2)
            return True
        # --- jcc consuming 64-bit flags ----------------------------------
        if (m in _JCC_SIGNED or m in _JCC_UNSIGNED) \
                and self.flags_src is not None \
                and self.flags_src[0] in ("cmp64", "res64"):
            self.stats.branches += 1
            taken = 1 if next_pc != (pc + inst.length) else 0
            ok = self._jcc64(m, taken)
            if ok:
                self.stats.branches_lifted += 1
            else:
                self.stats.branches_dropped += 1
            return ok
        # --- stack -------------------------------------------------------
        if m in ("push", "pushq") and len(ops) == 1 and self._is64(ops[0]):
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            s = ops[0].reg
            self._emit(U.ADDI, 4, 4, ZERO, (-8) & M32)
            areg = self._rsp_addr()
            self._emit(U.STORE, 0, areg, s, delta)
            self._emit(U.STORE, 0, areg, hi(s), (delta + 4) & M32)
            return True
        if m in ("pop", "popq") and len(ops) == 1 and self._is64(ops[0]):
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            d = ops[0].reg
            areg = self._rsp_addr()
            self._emit(U.LOAD, d, areg, ZERO, delta)
            self._emit(U.LOAD, hi(d), areg, ZERO, (delta + 4) & M32)
            self._emit(U.ADDI, 4, 4, ZERO, 8)
            return True
        if m in ("call", "callq"):
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            ra = (pc + inst.length) & M64
            self._const64(ra, T1)
            self._emit(U.ADDI, 4, 4, ZERO, (-8) & M32)
            areg = self._rsp_addr()
            self._emit(U.STORE, 0, areg, T1, delta)
            self._emit(U.STORE, 0, areg, hi(T1), (delta + 4) & M32)
            return True
        if m in ("ret", "retq"):
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            addr = (int(self.reg[4]) + delta) & M32
            if (addr & 3) or (addr >> 2) >= self.mem_words or \
                    int(self.mem[addr >> 2]) != (next_pc & M32):
                return False
            areg = self._rsp_addr()
            self._emit(U.LOAD, T1, areg, ZERO, delta)
            self._emit(U.LOAD, hi(T1), areg, ZERO, (delta + 4) & M32)
            self._emit(U.ADDI, 4, 4, ZERO, 8)
            # full-width return-address integrity: lo must equal the
            # captured target, hi must be zero (static text < 4 GiB)
            self._emit(U.LUI, T2, ZERO, ZERO, next_pc & M32)
            self._emit(U.XOR, T2, T1, T2)
            self._emit(U.OR, T2, T2, hi(T1))
            self._emit(U.BEQ, 0, T2, ZERO, taken=1)
            return True
        return False

    def _jcc64(self, m: str, taken: int) -> bool:
        kind = self.flags_src[0]
        mark = len(self.opcode)
        if kind == "cmp64":
            _, a, b = self.flags_src
            alo, ahi, blo, bhi = a, hi(a), b, hi(b)
        else:                                   # res64: flags of r vs 0
            r = self.flags_src[1]
            alo, ahi, blo, bhi = r, hi(r), ZERO, ZERO
        sense = None
        if m in ("je", "jz", "jne", "jnz"):
            self._emit(U.XOR, T3, alo, blo)
            self._emit(U.XOR, hi(T3), ahi, bhi)
            self._emit(U.OR, T3, T3, hi(T3))
            sense = m in ("jne", "jnz")         # True: taken ⟺ T3 != 0
        elif m in ("js", "jns"):
            if kind != "res64":
                self._rollback(mark)
                return False
            self._emit(U.ADDI, T3, ZERO, ZERO, 31)
            self._emit(U.SRL, T3, ahi, T3)      # sign bit of the result
            sense = m == "js"
        elif m in _JCC_UNSIGNED:
            mode = _JCC_UNSIGNED[m]
            if mode in (False, True):           # jb/jnae (F) · jae/jnb (T)
                self._ltu64(T3, alo, ahi, blo, bhi, signed=False)
                sense = mode is False           # jb taken ⟺ a < b
            else:                               # ja ("swap_b") · jbe
                self._ltu64(T3, blo, bhi, alo, ahi, signed=False)
                sense = mode == "swap_b"        # ja taken ⟺ b < a
        elif m in _JCC_SIGNED:
            cond = _JCC_SIGNED[m][0]
            if cond in ("lt", "ge"):            # jl · jge: a <s b
                self._ltu64(T3, alo, ahi, blo, bhi, signed=True)
                sense = cond == "lt"
            elif cond in ("swap_lt", "swap_ge"):  # jg · jle: b <s a
                self._ltu64(T3, blo, bhi, alo, ahi, signed=True)
                sense = cond == "swap_lt"
            else:
                self._rollback(mark)
                return False
        else:
            self._rollback(mark)
            return False
        golden = int(self.reg[T3])
        cond_now = (golden != 0) if sense else (golden == 0)
        if int(cond_now) != taken:
            self._rollback(mark)
            return False
        self._emit(U.BNE if sense else U.BEQ, 0, T3, ZERO, taken=taken)
        return True


def lift64(trace_path: str, binary: str, max_uops: int | None = None,
           nt: NativeTrace | None = None,
           insts: "dict[int, Inst] | None" = None):
    """nativetrace capture + binary → (Trace, metadata), 64-bit pair-lane
    datapath (nphys=64; REGFILE coordinate (reg, bit<64) ↦ phys
    (reg + 32·(bit≥32), bit mod 32))."""
    if nt is None:
        nt = read_nativetrace(trace_path)
    if insts is None:
        insts = static_decode(binary)
    try:
        from shrewd_tpu_torch.ingest.emu import elf_regions
        elf_regs = elf_regions(binary)
    except Exception:  # noqa: BLE001
        elf_regs = []
    trace, meta = Lifter64(nt, insts, max_uops=max_uops,
                           elf_regs=elf_regs).run()
    meta["width"] = 64
    return trace, meta
