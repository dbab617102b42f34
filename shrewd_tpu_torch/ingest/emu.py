"""Snapshot-seeded x86-64 subset emulator: checkpoint → synthetic capture.

Checkpoint restore needs an instruction stream to rebuild a replay window
(SURVEY §5.4: checkpoints are architectural-only — the reference restores
arch state and *runs forward*, ``src/cpu/o3/cpu.cc:706-799``).  A live
ptrace capture (tools/nativetrace.cc) needs the program running on this
host at the right marker; a checkpoint mid-run has no such luxury.  This
module plays the host CPU's role instead: a 64-bit x86 subset interpreter
seeded from the ``ArchSnapshot`` (regs + memory image + pc) that emits the
same per-step record stream the ptrace tracer produces, so the *unchanged*
capture-based lifter (ingest/lift.py) consumes it.

The duplication is deliberate and load-bearing: the lifter re-simulates
every macro-op in its own 32-bit µop semantics and demotes on mismatch, so
running it over this emulator's stream is a differential test between two
independent implementations — a bug in either shows up as opaque demotions
(visible in LiftStats), not silent corruption.  On workloads with a live
capture available, ``tests/test_emu.py`` additionally pins this emulator's
step stream bit-for-bit against the real ptrace capture.

Width semantics follow the ISA: 8/16-bit destination writes merge, 32-bit
zero-extend to 64, 64-bit overwrite.  Flags are kept lazily (source op +
operands) and materialized per condition code.  Anything outside the
supported subset (syscalls included) ends the window — the window-boundary
analog of the tracer's end marker.

Reference anchors: restore-then-rewarm (``src/cpu/o3/cpu.cc:706-799``),
the CheckerCPU lockstep-interpreter pattern (``src/cpu/checker/cpu.hh``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.ingest.lift import (Inst, NativeTrace, Operand, _CMOV,
                                    static_decode, stem_of)

M8, M16, M32, M64 = 0xFF, 0xFFFF, 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF
RAX, RCX, RDX, RBX, RSP, RBP, RSI, RDI = range(8)
R11 = 11

_ALU = {"add", "sub", "and", "or", "xor", "imul"}
_SHIFT = {"shl": "shl", "sal": "shl", "shr": "shr", "sar": "sar",
          "rol": "rol", "ror": "ror"}

# one shared suffix-strip rule with the lifter (lift.stem_of): the rstrip
# bug this replaced existed in both files precisely because the logic was
# duplicated
_stem = stem_of

_JCC = {"je": "e", "jz": "e", "jne": "ne", "jnz": "ne",
        "jb": "b", "jnae": "b", "jae": "ae", "jnb": "ae",
        "ja": "a", "jnbe": "a", "jbe": "be", "jna": "be",
        "jl": "l", "jnge": "l", "jge": "ge", "jnl": "ge",
        "jg": "g", "jnle": "g", "jle": "le", "jng": "le",
        "js": "s", "jns": "ns"}

# _CMOV maps cmov* → the lifter's condition vocabulary; translate to ours
_LIFT_COND = {"eq": "e", "ne": "ne", "lt": "l", "ge": "ge",
              "swap_lt": "g", "swap_ge": "le", "sign": "s", "nsign": "ns",
              "ub": "b", "uae": "ae", "ua": "a", "ube": "be"}

# setcc suffix → condition code (sete, setnz, setbe, …)
_JCC_SET = {k[1:]: v for k, v in _JCC.items()}


class StopEmu(Exception):
    """Window boundary: unsupported instruction / memory miss / syscall."""


class Region:
    def __init__(self, vaddr: int, data: bytes, read_only: bool = False):
        self.vaddr = vaddr
        self.buf = bytearray(data)
        self.read_only = read_only

    def contains(self, addr: int, size: int) -> bool:
        return self.vaddr <= addr and addr + size <= self.vaddr + len(self.buf)


def elf_regions(binary: str) -> list:
    """PT_LOAD segments of a static non-PIE ELF as (vaddr, bytes, ro)
    triples — the read-only text/rodata backing a whole-program emulation
    needs beyond the writable-memory snapshot (a store into one is a fault
    on real hardware and classifies DUE here)."""
    import struct as _struct

    with open(binary, "rb") as f:
        blob = f.read()
    if blob[:4] != b"\x7fELF" or blob[4] != 2:
        raise ValueError("need a 64-bit ELF")
    e_phoff, = _struct.unpack_from("<Q", blob, 0x20)
    e_phentsize, = _struct.unpack_from("<H", blob, 0x36)
    e_phnum, = _struct.unpack_from("<H", blob, 0x38)
    loads = []
    relro = []                            # GNU_RELRO: rw in phdrs, ro live
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        p_type, p_flags = _struct.unpack_from("<II", blob, off)
        p_offset, p_vaddr, _p_paddr, p_filesz, p_memsz = \
            _struct.unpack_from("<5Q", blob, off + 8)
        if p_type == 0x6474E552:
            relro.append((p_vaddr, p_vaddr + p_memsz))
        if p_type != 1:                   # PT_LOAD
            continue
        data = blob[p_offset:p_offset + p_filesz]
        if p_memsz > p_filesz:            # bss zero-fill
            data = data + b"\x00" * (p_memsz - p_filesz)
        loads.append((p_vaddr, data, not (p_flags & 0x2)))   # PF_W
    out = []
    for vaddr, data, ro in loads:
        if ro:
            out.append((vaddr, data, True))
            continue
        # split the writable segment at RELRO boundaries (mprotected
        # read-only after startup — a store there is a fault on hardware)
        cut = vaddr
        for lo, hi in relro:
            if lo <= vaddr and cut < hi <= vaddr + len(data):
                out.append((cut, data[cut - vaddr:hi - vaddr], True))
                cut = hi
        if cut < vaddr + len(data):
            out.append((cut, data[cut - vaddr:], False))
    return out


class EmuResult(NamedTuple):
    nt: NativeTrace            # lifter-compatible synthetic capture
    steps: int
    stop_reason: str
    stop_pc: int


class ExitedEmu(Exception):
    """Clean program exit (exit/exit_group syscall) in do_syscalls mode."""

    def __init__(self, code: int):
        super().__init__(f"exit({code})")
        self.code = code


class Emulator:
    def __init__(self, insts: dict[int, Inst], regs: np.ndarray,
                 regions: list[tuple[int, bytes]], pc: int,
                 do_syscalls: bool = False, fs_base: int = 0):
        """``do_syscalls=True`` executes write/exit syscalls instead of
        ending the window: stdout bytes accumulate in ``self.stdout`` and
        exit raises ExitedEmu — the mode used for whole-program perturbed
        re-execution (64-bit fault classification, CheckerCPU role)."""
        self.insts = insts
        self.reg = [int(x) & M64 for x in regs[:16]]
        # snapshot regions first (they win on overlap), then any read-only
        # ELF fallbacks appended by the caller as (vaddr, data, True)
        self.regions = [Region(*r) for r in regions]
        self.pc = int(pc)
        self.flags = ("res", 0, 64, 0)   # kind, operands..., width
        self.stop_reason = "max_steps"
        self.do_syscalls = do_syscalls
        self.stdout = bytearray()
        self.fs_base = fs_base or self.FS_BASE
        self.xmm = [0] * 32          # 512-bit zmm values (EVEX regs 16-31)
        self.kreg = [0] * 8          # AVX-512 mask registers
        if do_syscalls and not fs_base:
            self.regions.append(Region(self.FS_BASE - 0x1000,
                                       bytes(0x2000)))

    # -- memory ------------------------------------------------------------

    def _region(self, addr: int, size: int) -> Region:
        for r in self.regions:
            if r.contains(addr, size):
                return r
        raise StopEmu(f"mem miss {addr:#x}+{size}")

    def load(self, addr: int, size: int) -> int:
        r = self._region(addr, size)
        off = addr - r.vaddr
        return int.from_bytes(r.buf[off:off + size], "little")

    def store(self, addr: int, size: int, value: int) -> None:
        r = self._region(addr, size)
        if r.read_only:
            raise StopEmu(f"store to read-only {addr:#x}")   # host: SIGSEGV
        off = addr - r.vaddr
        r.buf[off:off + size] = (value & ((1 << (8 * size)) - 1)).to_bytes(
            size, "little")

    # -- registers ---------------------------------------------------------

    def rget(self, op: Operand) -> int:
        v = self.reg[op.reg]
        w = op.width
        if w == 64:
            return v
        if w == 32:
            return v & M32
        if w == 16:
            return v & M16
        if w == 8:
            return v & M8
        if w == -8:                       # high byte (%ah family)
            return (v >> 8) & M8
        raise StopEmu(f"reg width {w}")

    def rset(self, op: Operand, value: int) -> None:
        old = self.reg[op.reg]
        w = op.width
        if w == 64:
            nv = value & M64
        elif w == 32:
            nv = value & M32              # zero-extends
        elif w == 16:
            nv = (old & ~M16) | (value & M16)
        elif w == 8:
            nv = (old & ~M8) | (value & M8)
        elif w == -8:
            nv = (old & ~(M8 << 8)) | ((value & M8) << 8)
        else:
            raise StopEmu(f"reg width {w}")
        self.reg[op.reg] = nv

    # -- operands ----------------------------------------------------------

    FS_BASE = 0x7000_0000_0000       # synthetic fallback (no capture)

    def ea(self, op: Operand) -> int:
        if op.base == -3:
            raise StopEmu("unparsed mem operand")
        if op.base == -5:
            # %gs:disp — the capture records fs_base only; resolving gs
            # against fs_base would silently read the wrong TLS block, so
            # stop loudly (the trial classifies DUE, never silent skew)
            raise StopEmu("gs-relative access (no gs_base captured)")
        if op.base == -4:
            # %fs:disp — TLS-relative.  With a captured fs_base the real
            # TLS block is in the writable-memory snapshot (pointer guard
            # included, so glibc's mangled function pointers demangle
            # correctly); without one, a zeroed synthetic block gives
            # single-threaded defaults.
            return (self.fs_base + op.disp) & M64
        # segment overrides FIRST: a segment-prefixed rip-relative form
        # must not slip past via the rip_rel early-return below (fs would
        # silently read non-TLS memory; gs must stop loudly)
        if op.seg == "gs":
            raise StopEmu("gs-relative access (no gs_base captured)")
        seg_base = self.fs_base if op.seg == "fs" else 0
        if op.rip_rel:
            return (seg_base + op.disp) & M64
        a = op.disp + seg_base
        if op.base >= 0:
            a += self.reg[op.base]
        if op.index >= 0:
            a += self.reg[op.index] * op.scale
        return a & M64

    def _op_width(self, inst: Inst, default: int = 64) -> int:
        for o in inst.operands:
            if o.kind == "reg" and o.reg >= 0 and o.width:
                return abs(o.width)
        return {"b": 8, "w": 16, "l": 32, "q": 64}.get(
            inst.mnemonic[-1], default)

    def read(self, inst: Inst, op: Operand, width: int) -> int:
        if op.kind == "imm":
            return op.imm & ((1 << width) - 1)
        if op.kind == "reg":
            if op.reg < 0:
                raise StopEmu("non-GPR operand")
            return self.rget(op)
        if op.kind == "mem":
            return self.load(self.ea(op), width // 8)
        raise StopEmu("operand kind")

    def write(self, inst: Inst, op: Operand, width: int, value: int) -> None:
        if op.kind == "reg":
            if op.reg < 0:
                raise StopEmu("non-GPR operand")
            self.rset(op, value)
        elif op.kind == "mem":
            self.store(self.ea(op), width // 8, value)
        else:
            raise StopEmu("write to imm")

    # -- flags -------------------------------------------------------------

    def set_flags_sub(self, a: int, b: int, width: int) -> None:
        self.flags = ("sub", a, b, width)

    def set_flags_add(self, a: int, b: int, width: int) -> None:
        self.flags = ("add", a, b, width)

    def set_flags_res(self, v: int, width: int) -> None:
        self.flags = ("res", v, width, 0)

    def _fl(self) -> tuple[bool, bool, bool, bool]:
        """(ZF, SF, CF, OF) from the lazy flags record."""
        kind = self.flags[0]
        if kind == "fl":                   # directly materialized flags
            return self.flags[1], self.flags[2], self.flags[3], self.flags[4]
        if kind == "res":
            _, v, w, _ = self.flags
            mask = (1 << w) - 1
            r = v & mask
            return r == 0, bool(r >> (w - 1)), False, False
        _, a, b, w = self.flags
        mask = (1 << w) - 1
        a &= mask
        b &= mask
        if kind == "sub":
            r = (a - b) & mask
            cf = b > a
            of = bool(((a ^ b) & (a ^ r)) >> (w - 1) & 1)
        else:                              # add
            r = (a + b) & mask
            cf = a + b > mask
            of = bool((~(a ^ b) & (a ^ r)) >> (w - 1) & 1)
        return r == 0, bool(r >> (w - 1)), cf, of

    def cond(self, cc: str) -> bool:
        zf, sf, cf, of = self._fl()
        return {
            "e": zf, "ne": not zf,
            "b": cf, "ae": not cf,
            "a": not cf and not zf, "be": cf or zf,
            "l": sf != of, "ge": sf == of,
            "g": not zf and sf == of, "le": zf or sf != of,
            "s": sf, "ns": not sf,
        }[cc]

    # -- one step ----------------------------------------------------------


    # -- SIMD subset (glibc str/mem primitives) ----------------------------

    def _simd_read(self, op: Operand, width_bits: int) -> int:
        if op.kind == "xmm":
            return self.xmm[op.reg] & ((1 << width_bits) - 1)
        if op.kind == "mem":
            return self.load(self.ea(op), width_bits // 8)
        if op.kind == "reg" and op.reg >= 0:
            return self.rget(op) & ((1 << width_bits) - 1)
        raise StopEmu("simd operand")

    def _simd_write(self, op: Operand, width_bits: int, v: int) -> None:
        v &= (1 << width_bits) - 1
        if op.kind == "xmm":
            # SSE forms (128-bit dest) preserve the upper ymm half; VEX
            # forms zero it — width 128 from an SSE mnemonic keeps upper,
            # the VEX dispatch below passes zero_upper=True instead
            self.xmm[op.reg] = v if width_bits >= 512 else \
                ((self.xmm[op.reg] >> width_bits) << width_bits) | v
        elif op.kind == "mem":
            self.store(self.ea(op), width_bits // 8, v)
        elif op.kind == "reg" and op.reg >= 0:
            self.write(None, op, max(abs(op.width), 32), v)
        else:
            raise StopEmu("simd operand")

    @staticmethod
    def _per_byte(a: int, b: int, nbytes: int, fn) -> int:
        out = 0
        for i in range(nbytes):
            out |= (fn((a >> (8 * i)) & 0xFF, (b >> (8 * i)) & 0xFF)
                    & 0xFF) << (8 * i)
        return out

    def _simd(self, m: str, ops: list) -> None:
        """The glibc str/mem SIMD vocabulary: moves, byte compares,
        min-unsigned, logicals, movemask, broadcast.  VEX (v-prefixed)
        forms zero the untouched upper ymm half; SSE forms preserve it
        (the architectural split that makes vzeroupper matter)."""
        vex = m.startswith("v")
        base = m[1:] if vex else m
        # EVEX spells element width into the mnemonic for full-register
        # moves/logicals; semantics are identical at our granularity
        _ALIAS = {"pxord": "pxor", "pxorq": "pxor",
                  "pandd": "pand", "pandq": "pand",
                  "pord": "por", "porq": "por",
                  "movdqu8": "movdqu", "movdqu16": "movdqu",
                  "movdqu32": "movdqu", "movdqu64": "movdqu",
                  "movdqa32": "movdqa", "movdqa64": "movdqa"}
        base = _ALIAS.get(base, base)
        width = max((o.width for o in ops if o.kind == "xmm"), default=128)
        nb = width // 8
        if base == "zeroupper":
            self.xmm = [x & ((1 << 128) - 1) for x in self.xmm]
            return
        if base in ("zeroall",):
            self.xmm = [0] * 32
            return
        if base in ("movdqu", "movdqa", "movaps", "movups", "movapd",
                    "movupd", "lddqu"):
            src, dst = ops
            v = self._simd_read(src, width)
            self._simd_write(dst, width, v)
            if vex and dst.kind == "xmm" and width < 512:
                self.xmm[dst.reg] &= (1 << width) - 1   # VEX zeroes→MAXVL
            return
        if base in ("movd", "movq"):
            w = 32 if base == "movd" else 64
            src, dst = ops
            v = self._simd_read(src, w)
            if dst.kind == "xmm":
                self.xmm[dst.reg] = v                      # zero-extends
            else:
                self._simd_write(dst, w, v)
            return
        if base in ("pbroadcastb", "pbroadcastw", "pbroadcastd",
                    "pbroadcastq", "broadcastss"):
            src, dst = ops
            ew = {"b": 1, "w": 2, "d": 4, "q": 8, "s": 4}[base[-1]
                                                          if base[-1] != "s"
                                                          else "s"]
            e = self._simd_read(src, 8 * ew)
            dw = dst.width or width
            v = 0
            for i in range(dw // (8 * ew)):
                v |= e << (8 * ew * i)
            self._simd_write(dst, dw, v)
            if vex and dst.kind == "xmm" and dw < 512:
                self.xmm[dst.reg] &= (1 << dw) - 1
            return
        if base == "pmovmskb":
            src, dst = ops
            v = self._simd_read(src, src.width or width)
            mask = 0
            for i in range((src.width or width) // 8):
                mask |= (((v >> (8 * i + 7)) & 1) << i)
            self._simd_write(dst, 32, mask)
            self.reg[dst.reg] &= 0xFFFFFFFF                # zext to 64
            return
        if base.startswith("kmov"):
            src_o, dst = ops
            kw = {"b": 8, "w": 16, "d": 32, "q": 64}[base[4]]
            if src_o.kind == "kreg":
                v = self.kreg[src_o.reg] & ((1 << kw) - 1)
                if dst.kind == "kreg":
                    self.kreg[dst.reg] = v
                else:
                    self._simd_write(dst, kw, v)
            else:
                self.kreg[dst.reg] = self._simd_read(src_o, kw)
            return
        if base.startswith("kunpck"):
            # kunpck{bw,wd,dq} %k_lo,%k_hi_src? — AT&T order
            # [src_low, src_high, dst]: dst = (high << w) | low
            kw = {"bw": 8, "wd": 16, "dq": 32}[base[6:]]
            lo, hi, dst = ops
            self.kreg[dst.reg] = (
                ((self.kreg[hi.reg] & ((1 << kw) - 1)) << kw)
                | (self.kreg[lo.reg] & ((1 << kw) - 1)))
            return
        if base.startswith("kortest"):
            a, b2 = ops
            v = self.kreg[a.reg] | self.kreg[b2.reg]
            # ZF = union empty; consumers in glibc branch on e/ne (CF-"all
            # ones" users would need a richer flag model and stop there)
            self.set_flags_res(v & M64, 64)
            return
        if base in ("pcmpeqb", "pcmpb", "pcmpneqb") \
                and ops[-1].kind == "kreg":
            if base == "pcmpb":                 # predicate immediate form
                pred, s2, s1, dst = ops
                if pred.imm not in (0, 4):
                    # 1 LT / 2 LE / 5 NLT / 6 NLE need signed per-byte
                    # compares — stop loudly rather than mis-mask as EQ
                    raise StopEmu(f"vpcmpb predicate imm {pred.imm}")
                neq = pred.imm == 4
            else:
                s2, s1, dst = ops
                neq = base == "pcmpneqb"
            vw = max((o.width for o in (s1, s2) if o.kind == "xmm"),
                     default=width)
            a = self._simd_read(s1, vw)
            b2 = self._simd_read(s2, vw)
            mask = 0
            for i in range(vw // 8):
                eq = ((a >> (8 * i)) & 0xFF) == ((b2 >> (8 * i)) & 0xFF)
                if eq != neq:
                    mask |= 1 << i
            self.kreg[dst.reg] = mask
            return
        if base in ("addss", "subss", "mulss", "divss", "minss",
                    "maxss") and len(ops) == 2:
            src, dst = ops
            if dst.kind != "xmm":
                raise StopEmu(f"{base} dst {dst.kind}")
            a = self._simd_read(src, 32) if src.kind != "mem" else None
            if src.kind == "mem":
                a = self.load(self.ea(src), 4)
            b = self.xmm[dst.reg] & 0xFFFFFFFF
            with np.errstate(all="ignore"):
                fa = np.uint32(a).view(np.float32)
                fb = np.uint32(b).view(np.float32)
                # min/max pick the SOURCE on NaN or tie (Intel MINSS/MAXSS)
                r = {"addss": fb + fa, "subss": fb - fa, "mulss": fb * fa,
                     "divss": fb / fa,
                     "minss": fb if fb < fa else fa,
                     "maxss": fb if fb > fa else fa}[base]
            bits = int(np.float32(r).view(np.uint32))
            self.xmm[dst.reg] = (self.xmm[dst.reg]
                                 & ~0xFFFFFFFF) | bits
            return
        if base in ("comiss", "ucomiss") and len(ops) == 2:
            src, dst = ops
            a = (self.load(self.ea(src), 4) if src.kind == "mem"
                 else self._simd_read(src, 32))
            b = self._simd_read(dst, 32)
            fa = np.uint32(a & 0xFFFFFFFF).view(np.float32)
            fb = np.uint32(b & 0xFFFFFFFF).view(np.float32)
            # hardware semantics exactly: unordered → ZF=CF=1 (PF too,
            # unmodeled); equal (incl. +0/-0) → ZF=1; dst<src → CF=1
            if np.isnan(fa) or np.isnan(fb):
                self.flags = ("fl", True, False, True, False)
            elif fb == fa:
                self.flags = ("fl", True, False, False, False)
            elif fb < fa:
                self.flags = ("fl", False, False, True, False)
            else:
                self.flags = ("fl", False, False, False, False)
            return
        if base == "movss" and len(ops) == 2:
            src, dst = ops
            if dst.kind == "xmm" and src.kind == "mem":
                v = self.load(self.ea(src), 4)
                self.xmm[dst.reg] = v               # load zero-extends
                return
            if dst.kind == "mem" and src.kind == "xmm":
                self.store(self.ea(dst), 4, self.xmm[src.reg] & 0xFFFFFFFF)
                return
            if dst.kind == "xmm" and src.kind == "xmm":
                self.xmm[dst.reg] = ((self.xmm[dst.reg] & ~0xFFFFFFFF)
                                     | (self.xmm[src.reg] & 0xFFFFFFFF))
                return
            raise StopEmu("movss operands")
        if base in ("pxor", "por", "pand", "pandn", "pcmpeqb", "pminub",
                    "psubb", "paddb"):
            if vex and len(ops) == 3:
                s2, s1, dst = ops
            else:
                s2, dst = ops
                s1 = dst
            a = self._simd_read(s1, width)
            b = self._simd_read(s2, width)
            if base == "pxor":
                r = a ^ b
            elif base == "por":
                r = a | b
            elif base == "pand":
                r = a & b
            elif base == "pandn":
                r = (~a) & b & ((1 << width) - 1)
            elif base == "pcmpeqb":
                r = self._per_byte(a, b, nb,
                                   lambda x, y: 0xFF if x == y else 0)
            elif base == "pminub":
                r = self._per_byte(a, b, nb, min)
            elif base == "psubb":
                r = self._per_byte(a, b, nb, lambda x, y: (x - y) & 0xFF)
            else:                                          # paddb
                r = self._per_byte(a, b, nb, lambda x, y: (x + y) & 0xFF)
            # VEX/EVEX destination writes zero through MAXVL (bit 511) —
            # `vpxor %xmm0,%xmm0,%xmm0` clears the whole zmm; SSE forms
            # preserve everything above their width
            self._simd_write(dst, 512 if vex else width,
                             r & ((1 << width) - 1))
            return
        raise StopEmu(f"unsupported simd {m}")

    def step(self, bulk_limit: int = 1) -> int:
        """Execute at most ``bulk_limit`` hardware steps and return the
        count consumed.  Every instruction consumes 1 except rep
        movs/stos, where a hardware step = ONE iteration (a single-step
        trap fires per iteration) — the rep handler may consume up to
        ``bulk_limit`` iterations in one call so whole-program runs don't
        pay a Python call per byte of a big memset, while callers that
        need exact step alignment (fault injection, per-step window
        validation) cap the bulk at their next boundary."""
        self._consumed = 1
        inst = self.insts.get(self.pc)
        if inst is None:
            raise StopEmu("undecoded pc")
        self._bulk_limit = max(1, bulk_limit)
        self._step_body(inst)
        return self._consumed

    def _step_body(self, inst) -> None:
        m = inst.mnemonic
        ops = inst.operands
        next_pc = self.pc + inst.length
        w = self._op_width(inst)
        mask = (1 << w) - 1
        sign = 1 << (w - 1)

        def sx(v: int, from_w: int) -> int:
            v &= (1 << from_w) - 1
            return v - (1 << from_w) if v >> (from_w - 1) else v

        if (any(o.kind in ("xmm", "kreg") for o in ops)
                or m in ("vzeroupper",)):
            self._simd(m, ops)
            self.pc = next_pc & M64
            return
        rep_parts = m.split()
        if (len(rep_parts) == 2
                and rep_parts[0] in ("rep", "repz", "repe")
                and rep_parts[1].rstrip("bwldq") in ("movs", "stos")):
            # the erms memcpy/memset cores: copy/fill rcx elements (DF
            # assumed clear — glibc never runs these with DF set).
            # Element size from the suffix, else from the register operand
            # ("rep stos %al,%es:(%rdi)" prints suffixless)
            kind_s = rep_parts[1].rstrip("bwldq")
            sfx = rep_parts[1][len(kind_s):]
            esz = {"b": 1, "w": 2, "l": 4, "d": 4, "q": 8}.get(sfx, 0)
            if not esz:
                widths = [abs(o.width) // 8 for o in ops
                          if o.kind == "reg" and o.reg >= 0 and o.width]
                esz = widths[0] if widths else 1
            # ONE iteration per step(), pc held until rcx reaches 0 — the
            # hardware model: a single-step trap fires after EVERY rep
            # iteration, so ptrace (tools/hostsfi.cc), the capture
            # (tools/nativetrace.cc), and the lifter all count per
            # iteration.  Executing the whole rep as one step desynced
            # every later fault coordinate by (iterations-1) — the r4
            # strmix due→masked channel.  A corrupted rcx simply walks
            # rdi/rsi out of the image and traps exactly where silicon
            # segfaults (no plausibility guard needed).
            n = self.reg[RCX]
            if n == 0:
                self.pc = next_pc & M64
                return
            k = int(min(n, self._bulk_limit))
            if kind_s == "movs":
                for _ in range(k):
                    self.store(self.reg[RDI], esz,
                               self.load(self.reg[RSI], esz))
                    self.reg[RSI] = (self.reg[RSI] + esz) & M64
                    self.reg[RDI] = (self.reg[RDI] + esz) & M64
            else:
                v = self.reg[RAX] & ((1 << (8 * esz)) - 1)
                for _ in range(k):
                    self.store(self.reg[RDI], esz, v)
                    self.reg[RDI] = (self.reg[RDI] + esz) & M64
            self.reg[RCX] = (n - k) & M64
            self._consumed = k
            if self.reg[RCX] == 0:
                self.pc = next_pc & M64
            return
        if m in ("bsf", "bsr", "tzcnt", "lzcnt"):
            src_o, dst = ops
            v = self.read(inst, src_o, w)
            if v == 0:
                res = w
                if m in ("tzcnt", "lzcnt"):
                    self.write(inst, dst, w, w)
                # bsf/bsr leave dst unchanged on zero
            else:
                if m in ("bsf", "tzcnt"):
                    res = (v & -v).bit_length() - 1
                elif m == "bsr":
                    res = v.bit_length() - 1
                else:                                      # lzcnt
                    res = w - v.bit_length()
                self.write(inst, dst, w, res)
            if m in ("tzcnt", "lzcnt"):
                # TZCNT/LZCNT define ZF from the *result* (BSF semantics
                # — ZF = src==0 — would mis-steer branches after tzcnt)
                self.set_flags_res(res & mask, w)
            else:
                self.set_flags_res(v & mask, w)   # bsf/bsr: ZF = src == 0
            self.pc = next_pc & M64
            return
        if m in ("nop", "nopw", "nopl", "endbr64") or m.startswith("nop"):
            pass
        elif m in ("mov", "movb", "movw", "movl", "movq", "movabs"):
            src, dst = ops
            self.write(inst, dst, w, self.read(inst, src, w))
        elif m in ("movslq", "movsxd"):
            src, dst = ops
            self.write(inst, dst, 64, sx(self.read(inst, src, 32), 32) & M64)
        elif m.startswith(("movz", "movs")) and len(m) >= 6:
            src, dst = ops
            fw = 8 if m[4] == "b" else 16
            v = self.read(inst, src, fw)
            if m.startswith("movs"):
                v = sx(v, fw) & mask
            dw = abs(dst.width) if dst.kind == "reg" and dst.width else w
            self.write(inst, dst, dw, v & ((1 << dw) - 1))
        elif m in ("lea", "leaq", "leal"):
            src, dst = ops
            self.write(inst, dst, w, self.ea(src) & mask)
        elif (stem := _stem(m, _ALU)) is not None:
            if stem == "imul" and len(ops) == 3:
                immv, src, dst = ops
                r = sx(self.read(inst, src, w), w) * immv.imm
                self.write(inst, dst, w, r & mask)
                self.set_flags_res(r & mask, w)
            else:
                src, dst = ops
                a = self.read(inst, dst, w)
                b = self.read(inst, src, w)
                if stem == "add":
                    r = a + b
                    self.set_flags_add(a, b, w)
                elif stem == "sub":
                    r = a - b
                    self.set_flags_sub(a, b, w)
                elif stem == "imul":
                    r = sx(a, w) * sx(b, w)
                    self.set_flags_res(r & mask, w)
                else:
                    r = {"and": a & b, "or": a | b, "xor": a ^ b}[stem]
                    self.set_flags_res(r & mask, w)
                self.write(inst, dst, w, r & mask)
        elif (sh_stem := _stem(m, _SHIFT)) is not None:
            stem = _SHIFT[sh_stem]
            if len(ops) == 1:
                ops = [Operand("imm", imm=1)] + ops
            src, dst = ops
            sh = self.read(inst, src, 8) & (63 if w == 64 else 31)
            a = self.read(inst, dst, w)
            if stem == "shl":
                r = a << sh
            elif stem == "shr":
                r = a >> sh
            elif stem == "sar":
                r = (sx(a, w) >> sh) & mask
            elif stem == "rol":
                sh %= w
                r = (a << sh) | (a >> (w - sh)) if sh else a
            else:                                 # ror
                sh %= w
                r = (a >> sh) | (a << (w - sh)) if sh else a
            self.write(inst, dst, w, r & mask)
            if sh and stem not in ("rol", "ror"):
                self.set_flags_res(r & mask, w)
        elif (stem := _stem(m, ("inc", "dec", "neg", "not"))) is not None:
            d = ops[0]
            a = self.read(inst, d, w)
            if stem == "inc":
                r = a + 1
                self.set_flags_res(r & mask, w)      # CF preserved ≈ res
            elif stem == "dec":
                r = a - 1
                self.set_flags_res(r & mask, w)
            elif stem == "neg":
                r = -a
                self.set_flags_sub(0, a, w)
            else:
                r = ~a
            self.write(inst, d, w, r & mask)
        elif _stem(m, ("cmp",)) is not None:
            src, dst = ops
            self.set_flags_sub(self.read(inst, dst, w),
                               self.read(inst, src, w), w)
        elif _stem(m, ("test",)) is not None:
            a, b = ops
            self.set_flags_res(self.read(inst, a, w)
                               & self.read(inst, b, w), w)
        elif m in ("push", "pushq"):
            v = self.read(inst, ops[0], 64)
            self.reg[RSP] = (self.reg[RSP] - 8) & M64
            self.store(self.reg[RSP], 8, v)
        elif m in ("pop", "popq"):
            v = self.load(self.reg[RSP], 8)
            self.reg[RSP] = (self.reg[RSP] + 8) & M64
            self.write(inst, ops[0], 64, v)
        elif m in ("call", "callq"):
            if ops and ops[0].kind == "imm":
                target = ops[0].imm
            elif ops and ops[0].kind == "reg" and ops[0].reg >= 0:
                target = self.reg[ops[0].reg]
            elif ops and ops[0].kind == "mem" and ops[0].base != -3:
                target = self.load(self.ea(ops[0]), 8)
            else:
                raise StopEmu("call target")
            self.reg[RSP] = (self.reg[RSP] - 8) & M64
            self.store(self.reg[RSP], 8, next_pc)
            next_pc = target & M64
        elif m in ("ret", "retq"):
            next_pc = self.load(self.reg[RSP], 8)
            self.reg[RSP] = (self.reg[RSP] + 8) & M64
        elif m == "leave":
            self.reg[RSP] = self.reg[RBP]
            self.reg[RBP] = self.load(self.reg[RSP], 8)
            self.reg[RSP] = (self.reg[RSP] + 8) & M64
        elif m in ("jmp", "jmpq"):
            if ops and ops[0].kind == "imm":
                next_pc = ops[0].imm & M64
            elif ops and ops[0].kind == "reg" and ops[0].reg >= 0:
                next_pc = self.reg[ops[0].reg]
            elif ops and ops[0].kind == "mem" and ops[0].base != -3:
                # jump tables / resolved-IFUNC GOT slots: same memory-
                # indirect form the call branch already supports
                next_pc = self.load(self.ea(ops[0]), 8)
            else:
                raise StopEmu("indirect jmp form")
        elif m in _JCC:
            if self.cond(_JCC[m]):
                next_pc = ops[0].imm & M64
        elif m.startswith("cmov"):
            base = m if m in _CMOV else m.rstrip("lqw")
            if base not in _CMOV:
                raise StopEmu(f"cmov {m}")
            src, dst = ops
            if self.cond(_LIFT_COND[_CMOV[base]]):
                self.write(inst, dst, w, self.read(inst, src, w))
        elif m in ("cltq", "cdqe"):
            self.reg[RAX] = sx(self.reg[RAX] & M32, 32) & M64
        elif m in ("cwtl", "cwde"):
            self.reg[RAX] = (self.reg[RAX] & ~M32) | (
                sx(self.reg[RAX] & M16, 16) & M32)
        elif m in ("cltd", "cdq"):
            self.reg[RDX] = (self.reg[RDX] & ~M32) | (
                M32 if self.reg[RAX] & 0x80000000 else 0)
        elif m in ("cqto", "cqo"):
            self.reg[RDX] = M64 if self.reg[RAX] >> 63 else 0
        elif m.rstrip("lqwb") in ("div", "idiv"):
            stem = m.rstrip("lqwb")
            b = self.read(inst, ops[0], w)
            if b == 0:
                raise StopEmu("div by zero")
            if w == 32:
                a = ((self.reg[RDX] & M32) << 32) | (self.reg[RAX] & M32)
            else:
                a = ((self.reg[RDX] & M64) << 64) | (self.reg[RAX] & M64)
            if stem == "idiv":
                aa = a - (1 << (2 * w)) if a >> (2 * w - 1) else a
                bb = sx(b, w)
                q = abs(aa) // abs(bb)    # exact trunc-toward-zero
                if (aa < 0) != (bb < 0):
                    q = -q
                r = aa - q * bb
                if not (-(1 << (w - 1)) <= q <= (1 << (w - 1)) - 1):
                    raise StopEmu("div overflow")   # x86 #DE
            else:
                q, r = divmod(a, b)
                if q > (1 << w) - 1:
                    raise StopEmu("div overflow")   # x86 #DE
            if w == 32:
                self.reg[RAX] = q & M32   # 32-bit writes zero-extend
                self.reg[RDX] = r & M32
            else:
                self.reg[RAX] = q & M64
                self.reg[RDX] = r & M64
        elif m.startswith("cmpxchg") and len(ops) == 2:
            # if rax(w) == dst: dst := src, ZF=1  else rax := dst, ZF=0
            # (cmpxchg8b/16b take one operand and fall through to StopEmu)
            src, dst = ops
            cur = self.read(inst, dst, w)
            acc = self.reg[RAX] & mask
            self.set_flags_sub(acc, cur, w)
            if acc == cur:
                self.write(inst, dst, w, self.read(inst, src, w))
            else:
                self.rset(Operand("reg", reg=RAX, width=w), cur)
        elif m.startswith("set") and m[3:] in _JCC_SET:
            v = 1 if self.cond(_JCC_SET[m[3:]]) else 0
            self.write(inst, ops[0], 8, v)
        elif m in ("xchg", "xchgl", "xchgq"):
            a, b = ops
            va = self.read(inst, a, w)
            vb = self.read(inst, b, w)
            self.write(inst, a, w, vb)
            self.write(inst, b, w, va)
        elif m == "syscall" and self.do_syscalls:
            nr = self.reg[RAX]
            if nr == 1 and self.reg[RDI] == 1:            # write(1, buf, n)
                n = self.reg[RDX]
                if n > (1 << 20):
                    raise StopEmu("write size")
                buf = bytes(self.load(self.reg[RSI] + i, 1)
                            for i in range(n))
                self.stdout += buf
                self.reg[RAX] = n
            elif nr in (60, 231):                          # exit/exit_group
                raise ExitedEmu(self.reg[RDI] & 0xFF)
            else:
                raise StopEmu(f"syscall {nr}")
            # kernel return clobbers: rcx = rip after syscall, r11 = rflags
            self.reg[RCX] = next_pc & M64
            self.reg[R11] = 0x202
        else:
            raise StopEmu(f"unsupported {m}")
        self.pc = next_pc & M64

    # -- run ---------------------------------------------------------------

    def canonical(self) -> np.ndarray:
        row = np.zeros(18, dtype=np.uint64)
        for i in range(16):
            row[i] = self.reg[i]
        row[16] = self.pc
        row[17] = 0x202                   # IF set, DF clear
        return row

    def run(self, max_steps: int) -> EmuResult:
        rows = [self.canonical()]
        begin = self.pc
        stop = "max_steps"
        for _ in range(max_steps):
            try:
                self.step()
            except StopEmu as e:
                # rows[-1] is already the clean state AT the boundary (the
                # unsupported instruction never executed) — exactly the
                # NativeTrace contract's "last record = state at end"
                stop = str(e)
                break
            rows.append(self.canonical())
        steps = np.stack(rows)
        regions = [(r.vaddr, bytes(r.buf)) for r in self.regions]
        # NativeTrace contract: steps[n_macro] is the state at the end
        # marker; regions snapshot the *initial* image — rebuild from the
        # originals the caller seeded (they were copied into Region bufs),
        # so hand back the caller's originals via from_snapshot instead.
        nt = NativeTrace(begin=begin, end=int(steps[-1][16]),
                         steps=steps, regions=regions)
        return EmuResult(nt=nt, steps=len(steps) - 1, stop_reason=stop,
                         stop_pc=int(steps[-1][16]))


class ProgramResult(NamedTuple):
    kind: str            # "exit" | "hang" | "stop:<reason>"
    stdout: bytes
    exit_code: int | None
    steps: int


def run_program(insts: dict[int, Inst], regs: np.ndarray,
                regions: list[tuple[int, bytes]], pc: int,
                max_steps: int = 2_000_000,
                fault: "tuple | None" = None,
                fs_base: int = 0) -> ProgramResult:
    """Whole-program (perturbed) re-execution to exit — the 64-bit
    CheckerCPU: classify a fault by the same program-outcome criteria the
    host-silicon oracle uses (stdout + exit status, tools/hostsfi.cc),
    with wrong paths executed for real rather than frozen.

    ``fault`` = (step, reg, bit) flips GPR ``reg`` bit ``bit`` (bit ∈
    [0,64) — the full 64-bit register, including the upper half the
    32-bit replay projection cannot track) after ``step`` dynamic
    instructions, exactly like the ptrace oracle's PTRACE_SETREGS flip."""
    emu = Emulator(insts, regs, regions, pc, do_syscalls=True,
                   fs_base=fs_base)
    steps = 0
    try:
        while steps < max_steps:
            if fault is not None and steps == fault[0]:
                if fault[1] >= 16:
                    # xmm[reg-16] low lane, the FP-bank coordinate space
                    # (hostsfi's PTRACE_SETFPREGS flip)
                    emu.xmm[fault[1] - 16] ^= (1 << fault[2])
                else:
                    emu.reg[fault[1]] ^= (1 << fault[2])
                    emu.reg[fault[1]] &= M64
            # bulk rep execution up to the next boundary we must observe
            # exactly: the fault-injection step, or the hang budget —
            # per-iteration stepping stays the unit of accounting
            limit = max_steps - steps
            if fault is not None and steps < fault[0]:
                limit = min(limit, fault[0] - steps)
            steps += emu.step(limit)
        return ProgramResult("hang", bytes(emu.stdout), None, steps)
    except ExitedEmu as e:
        return ProgramResult("exit", bytes(emu.stdout), e.code, steps)
    except StopEmu as e:
        return ProgramResult(f"stop:{e}", bytes(emu.stdout), None, steps)


def emulate_window(binary: str, regs: np.ndarray,
                   regions: list[tuple[int, bytes]], pc: int,
                   max_steps: int = 200_000,
                   insts: "dict[int, Inst] | None" = None) -> EmuResult:
    """Decode + run; regions are (vaddr, bytes) of the initial image.

    ``insts`` accepts a pre-parsed static decode so callers that also lift
    (warm.window_from_snapshot_lifted) disassemble once.

    NOTE the returned ``nt.regions`` must be the INITIAL image (the lifter
    snapshots memory at window start); Emulator.run hands back post-run
    buffers, so re-seed them here."""
    if insts is None:
        insts = static_decode(binary)
    emu = Emulator(insts, regs, regions, pc)
    res = emu.run(max_steps)
    return res._replace(nt=res.nt._replace(
        regions=[(v, d) for v, d in regions]))
