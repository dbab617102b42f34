"""Macro-op → µop lifter: real x86-64 dynamic streams → replayable Traces.

This replaces synthetic workloads (VERDICT r1 missing #1) with *real* dynamic
instruction streams captured from the host CPU by ``tools/nativetrace.cc``
(the NativeTrace/statetrace pattern, reference ``src/cpu/nativetrace.cc``,
``util/statetrace``).  The lifter plays the role of the reference's
macro→µop expansion (x86 ``Decoder`` + ``MicrocodeRom``,
``src/arch/x86/decoder.hh:57,75``, µop definitions under
``src/arch/x86/isa/microops/``), retargeted at the framework's 23-op
dataflow ISA (``isa/uops.py``) instead of gem5's µop ISA.

Design
------
- **32-bit projection.** The replay datapath is uint32; every x86-64 value
  is tracked as its low 32 bits.  64-bit adds/subs/logic/left-shifts project
  exactly; anything that does not (right shifts, partial-register writes,
  byte memory ops) is demoted per-instance by the self-check below.
- **Self-validating lift.** The lifter *simulates* each candidate µop
  sequence against the µop ISA semantics and compares all 16 GPRs with the
  captured next-step register state.  On mismatch the sequence is rolled
  back and replaced by an *opaque* lift — ``LUI rd, observed`` per changed
  register — which breaks dataflow through that one macro-op but re-syncs
  the register file to ground truth, so error never accumulates.  The
  fraction of opaque lifts is the fidelity metric (``LiftStats``).
- **Folded-affine memory remap.** Touched addresses cluster into a few
  dense regions (data/bss, live stack).  A pre-pass computes every dynamic
  effective address from the captured registers; each *static* instruction
  that always hits one cluster gets that cluster's remap constant folded
  into its displacement (the common case: array bases and rsp-relative
  slots are cluster-stable), so the remap costs zero µops.  A faulted
  address that leaves the cluster maps out of range and traps (DUE) — the
  wild-pointer-segfault reading, the software analog of the reference's
  page-table walk faults (``arch/x86/pagetable_walker.cc``).
- **Branch lifting with self-check.** cmp/test + jcc pairs lift to the µop
  branch set (BEQ/BNE/BLT/BGE, with SLTU for unsigned conditions); the
  lifted condition evaluated under the simulated golden state must equal
  the captured direction, else the branch is dropped (counted).  Return
  addresses are checked with an explicit BEQ against the captured target,
  so stack-slot corruption of a return address becomes a detected
  divergence.

The output ``Trace`` is bit-for-bit replayable by ops/replay.py: the golden
replay reproduces the captured register stream in its low 32 bits at every
non-opaque macro-op boundary (tests/test_lift.py).
"""

from __future__ import annotations

import re
import struct
import subprocess
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.isa import semantics
from shrewd_tpu_torch.trace.format import Trace

# canonical register order (tools/ptrace_common.h): x86-64 encoding order
GPR_NAMES_64 = ["rax", "rcx", "rdx", "rbx", "rsp", "rbp", "rsi", "rdi",
                "r8", "r9", "r10", "r11", "r12", "r13", "r14", "r15"]
GPR_NAMES_32 = ["eax", "ecx", "edx", "ebx", "esp", "ebp", "esi", "edi"] + \
    [f"r{i}d" for i in range(8, 16)]
GPR_NAMES_16 = ["ax", "cx", "dx", "bx", "sp", "bp", "si", "di"] + \
    [f"r{i}w" for i in range(8, 16)]
GPR_NAMES_8 = ["al", "cl", "dl", "bl", "spl", "bpl", "sil", "dil"] + \
    [f"r{i}b" for i in range(8, 16)]

_REGMAP: dict[str, tuple[int, int]] = {}    # name -> (index, width_bits)
for _i, _n in enumerate(GPR_NAMES_64):
    _REGMAP[_n] = (_i, 64)
for _i, _n in enumerate(GPR_NAMES_32):
    _REGMAP[_n] = (_i, 32)
for _i, _n in enumerate(GPR_NAMES_16):
    _REGMAP[_n] = (_i, 16)
for _i, _n in enumerate(GPR_NAMES_8):
    _REGMAP[_n] = (_i, 8)
# high-byte registers: unliftable partial writes; sources demote via self-check
for _i, _n in enumerate(["ah", "ch", "dh", "bh"]):
    _REGMAP[_n] = (_i, -8)

N_GPR = 16
RCX_ARCH = 1       # x86 encoding order: rcx is the shift/rotate count reg
# physical register layout of the lifted trace
ZERO = 16          # always-0 register (never written)
TCMP = 17          # cmp-immediate staging (live cmp → jcc only)
T0, T1, T2, T3 = 18, 19, 20, 21
T4, T5 = 22, 23    # sub-word expansion / cmov scratch
T6, T7 = 24, 25    # flags-preserving-instruction scratch
FX0 = 32           # xmm bank: phys FX0+k holds xmm{k}'s low 32 bits (f32)
FT0, FT1 = 48, 49  # FP-lift scratch (loaded operands, compare keys)
HSH = 50           # hi-half shadow of the last 64-bit imul (peephole)
# Register discipline: flags_src may reference T1/T2/TCMP between the
# flag-setting instruction and its consumer (jcc/cmov), and x86 mov/cmov/
# string/push do NOT write EFLAGS — so every lift of a flags-PRESERVING
# instruction must keep its scratch to T0/T3..T7 and never write T1/T2/TCMP.
NPHYS = 64

M32 = 0xFFFFFFFF


class NativeTrace(NamedTuple):
    """Parsed tools/nativetrace.cc capture."""

    begin: int
    end: int
    steps: np.ndarray           # uint64[n_steps+1, 18] (last = state at end)
    regions: list               # [(vaddr, bytes)] memory snapshot at begin
    fs_base: int = 0            # TLS base (SHTRACE2+); 0 if unrecorded


def read_nativetrace(path) -> NativeTrace:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic not in (b"SHTRACE1", b"SHTRACE2", b"SHTRACE3"):
            raise ValueError(f"bad magic {magic!r}")
        begin, end, n_steps, n_regions = struct.unpack("<4Q", f.read(32))
        fs_base = (struct.unpack("<Q", f.read(8))[0]
                   if magic != b"SHTRACE1" else 0)
        regions = []
        for _ in range(n_regions):
            vaddr, size = struct.unpack("<2Q", f.read(16))
            regions.append((vaddr, f.read(size)))
        data = f.read()
    # SHTRACE3 appends 8 u64 per step: the 16 xmm low lanes (f32 bit
    # patterns) packed two per word — columns 18..25
    cols = 26 if magic == b"SHTRACE3" else 18
    rec = cols * 8
    n_rec = len(data) // rec
    steps = np.frombuffer(data[:n_rec * rec], dtype=np.uint64).reshape(
        n_rec, cols)
    if n_rec not in (n_steps, n_steps + 1):
        raise ValueError(f"step records {n_rec} != n_steps {n_steps}(+1)")
    return NativeTrace(begin, end, steps, regions, fs_base)


# --- static decode via objdump --------------------------------------------

class Inst(NamedTuple):
    pc: int
    length: int
    mnemonic: str
    operands: list              # parsed Operand list (AT&T order)
    comment_addr: int | None    # resolved rip-relative target, if any


@dataclass
class Operand:
    kind: str                   # "reg" | "imm" | "mem"
    reg: int = -1               # arch index (reg kind)
    width: int = 0
    imm: int = 0
    # mem fields
    base: int = -1              # arch index or -1
    index: int = -1
    scale: int = 1
    disp: int = 0
    rip_rel: bool = False
    seg: str = ""               # segment override: "fs"/"gs" ("" = none)


_LINE_RE = re.compile(
    r"^\s*([0-9a-f]+):\s+((?:[0-9a-f]{2}\s)+)\s*(\S+)\s*(.*)$")
_MEM_RE = re.compile(
    r"^(-?0x[0-9a-f]+|-?\d+)?\((%\w+)?(?:,(%\w+),(\d+))?\)$")


def _parse_operand(tok: str, comment_addr: int | None) -> Operand | None:
    tok = tok.strip()
    if not tok:
        return None
    if tok.startswith("$"):
        return Operand("imm", imm=int(tok[1:], 0))
    if tok.startswith("%"):
        name = tok[1:]
        if name in _REGMAP:
            idx, width = _REGMAP[name]
            return Operand("reg", reg=idx, width=width)
        if name == "rip":
            return None
        if name.startswith(("ds:", "es:", "ss:", "cs:")):
            # zero-base segments in 64-bit mode (string-op operands print
            # as "%ds:(%rsi)" / "%es:(%rdi)"): parse the inner form plain
            return _parse_operand(name[3:], comment_addr)
        if name.startswith(("fs:", "gs:")):
            # Segment-relative absolute ("%fs:0x30"): base=-4 marks an
            # fs-relative address — unmappable for the lifter (demote) but
            # emulable against the captured fs_base (ingest/emu.py).
            # %gs: gets its OWN code (-5): no gs_base is captured, and
            # resolving it against fs_base would silently read the wrong
            # TLS block — the emulator stops loudly instead.
            segname = name[:2]
            rest = name[3:]
            try:
                return Operand("mem",
                               base=-4 if segname == "fs" else -5,
                               disp=int(rest, 0))
            except ValueError:
                pass
            # register-indirect segment forms ("%fs:(%rax)",
            # "%fs:0x10(,%rbx,4)"): parse the inner mem operand and mark
            # the override — the emulator adds fs_base to the computed ea
            # (gs still stops loudly); the lifter demotes like the
            # absolute forms
            inner = _parse_operand(rest, comment_addr)
            if inner is not None and inner.kind == "mem" \
                    and inner.base != -3:
                inner.seg = segname
                return inner
            return Operand("mem", base=-3)
        if re.fullmatch(r"k[0-7]", name):
            return Operand("kreg", reg=int(name[1]))
        if re.fullmatch(r"[xyz]mm(\d+)", name):
            idx = int(name[3:])
            if idx < 32:
                return Operand("xmm", reg=idx,
                               width={"x": 128, "y": 256,
                                      "z": 512}[name[0]])
        return Operand("reg", reg=-2)           # non-GPR (seg, x87, ...)
    if tok.startswith("*"):
        # indirect target: "*%rax", "*(%rip)", "*0x0(%rbp,%rbx,8)" — parse
        # the inner operand (the emulator executes these; the lifter's
        # call/jmp handling never needs the target, control follows the
        # captured stream)
        inner = _parse_operand(tok[1:], comment_addr)
        if inner is not None and inner.kind in ("mem", "reg"):
            return inner
        return Operand("mem", base=-3)
    m = _MEM_RE.match(tok)
    if m:
        disp = int(m.group(1), 0) if m.group(1) else 0
        base = -1
        rip_rel = False
        if m.group(2):
            bname = m.group(2)[1:]
            if bname == "rip":
                rip_rel = True
                if comment_addr is not None:
                    disp = comment_addr
            elif bname in _REGMAP:
                base = _REGMAP[bname][0]
            else:
                return Operand("mem", base=-3)
        index = -1
        scale = 1
        if m.group(3):
            iname = m.group(3)[1:]
            if iname not in _REGMAP:
                return Operand("mem", base=-3)
            index = _REGMAP[iname][0]
            scale = int(m.group(4))
        return Operand("mem", base=base, index=index, scale=scale,
                       disp=disp, rip_rel=rip_rel)
    # bare address (jump/call target or absolute mem)
    try:
        return Operand("imm", imm=int(tok, 16))
    except ValueError:
        return None


def _split_operands(s: str) -> list[str]:
    """Split on commas not inside parens."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def static_decode(binary: str) -> dict[int, Inst]:
    """objdump -d → {pc: Inst}.  The static half of the decode; the dynamic
    PC stream selects which of these execute (and in what order)."""
    txt = subprocess.run(["objdump", "-d", binary], capture_output=True,
                         text=True, check=True).stdout
    out: dict[int, Inst] = {}
    last_pc: int | None = None
    hexpair = re.compile(r"^[0-9a-f]{2}$")
    for line in txt.splitlines():
        # objdump wraps long encodings onto bytes-only continuation lines;
        # fold their byte count into the previous instruction's length (a
        # short length corrupts every pc+len computation: fall-through
        # targets, call return addresses).  A continuation line is exactly
        # "pc:" + 2-hex-char byte tokens — a real mnemonic token ("fadd")
        # is longer than a byte pair, so it cannot be mistaken for one.
        toks = line.split()
        if (last_pc is not None and len(toks) >= 2 and toks[0].endswith(":")
                and all(hexpair.match(t) for t in toks[1:])):
            prev = out[last_pc]
            out[last_pc] = prev._replace(length=prev.length + len(toks) - 1)
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        pc = int(m.group(1), 16)
        length = len(m.group(2).split())
        rest = m.group(4)
        comment_addr = None
        if "#" in rest:
            rest, comment = rest.split("#", 1)
            cm = re.match(r"\s*([0-9a-f]+)", comment)
            if cm:
                comment_addr = int(cm.group(1), 16)
        rest = rest.split("<")[0].strip()      # drop symbol annotations
        mnem = m.group(3)
        # objdump tokenizes prefix bytes as the mnemonic ("lock decl …");
        # fold ignorable-here prefixes into the real instruction (lock is
        # meaningless to a single-context interpretation; its atomicity is
        # what the reference's MemChecker polices, not dataflow).  The
        # cs/ds/es/ss segment overrides are ignored in 64-bit mode; gcc
        # pads loop heads with "cs nopw 0x0(%rax,%rax,1)", which code
        # falling into the loop executes
        while mnem in ("lock", "bnd", "notrack", "data16",
                       "cs", "ds", "es", "ss") and rest:
            parts = rest.split(None, 1)
            mnem = parts[0]
            rest = parts[1] if len(parts) > 1 else ""
        if mnem in ("rep", "repz", "repe", "repnz", "repne") and rest:
            parts = rest.split(None, 1)
            mnem = f"{mnem} {parts[0]}"
            rest = parts[1] if len(parts) > 1 else ""
        ops = [o for o in (_parse_operand(t, comment_addr)
                           for t in _split_operands(rest)) if o is not None]
        out[pc] = Inst(pc, length, mnem, ops, comment_addr)
        last_pc = pc
    return out


# --- lift statistics -------------------------------------------------------

@dataclass
class LiftStats:
    macro_ops: int = 0
    lifted: int = 0             # exact dataflow lift, self-check passed
    opaque: int = 0             # demoted to observed-value resync
    branches: int = 0
    branches_lifted: int = 0
    branches_dropped: int = 0
    mem_accesses: int = 0
    mem_dropped: int = 0        # byte/unmappable accesses skipped
    clusters_dropped: int = 0   # low-32-colliding / wrapping clusters
    uops: int = 0
    opaque_mnemonics: dict = field(default_factory=dict)

    @property
    def lift_rate(self) -> float:
        return self.lifted / max(self.macro_ops, 1)

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "macro_ops", "lifted", "opaque", "branches", "branches_lifted",
            "branches_dropped", "mem_accesses", "mem_dropped",
            "clusters_dropped", "uops")}
        d["lift_rate"] = self.lift_rate
        d["opaque_mnemonics"] = dict(sorted(
            self.opaque_mnemonics.items(), key=lambda kv: -kv[1])[:12])
        return d


# --- the lifter ------------------------------------------------------------

_ALU2 = {  # mnemonic stem -> opcode for reg/reg (dst = dst OP src)
    "add": U.ADD, "sub": U.SUB, "and": U.AND, "or": U.OR, "xor": U.XOR,
    "imul": U.MUL,
}


def stem_of(m: str, *tables) -> str | None:
    """objdump size-suffix stripping, shared by the lifter and the
    emulator: strip at most ONE trailing b/w/l/q, and only when the
    remainder is in one of ``tables``.  ``rstrip("bwlq")`` eats stem
    letters — "subl" → "su", "roll" → "ro", "imulq" → "imu" — silently
    demoting suffixed memory-operand forms."""
    for t in tables:
        if m in t:
            return m
    if len(m) > 1 and m[-1] in "bwlq":
        c = m[:-1]
        for t in tables:
            if c in t:
                return c
    return None
_SHIFTS = {"shl": U.SLL, "sal": U.SLL, "shr": U.SRL, "sar": U.SRA}

_JCC_SIGNED = {  # cond after cmp(src=b, dst=a): flags of a-b
    "je": ("eq",), "jne": ("ne",), "jl": ("lt",), "jge": ("ge",),
    "jg": ("swap_lt",), "jle": ("swap_ge",),
    "js": ("sign",), "jns": ("nsign",),
}
_JCC_UNSIGNED = {"jb": False, "jnae": False, "jae": True, "jnb": True,
                 "ja": "swap_b", "jbe": "swap_ae"}

_CMOV = {"cmove": "eq", "cmovz": "eq", "cmovne": "ne", "cmovnz": "ne",
         "cmovl": "lt", "cmovge": "ge", "cmovg": "swap_lt",
         "cmovle": "swap_ge", "cmovs": "sign", "cmovns": "nsign",
         "cmovb": "ub", "cmovnae": "ub", "cmovae": "uae", "cmovnb": "uae",
         "cmova": "ua", "cmovnbe": "ua", "cmovbe": "ube", "cmovna": "ube"}


class Cluster(NamedTuple):
    lo: int                     # low-32 virtual address (inclusive)
    hi: int                     # low-32 virtual address (exclusive)
    word_off: int               # word offset in the flat replay memory


# --- x86 string ops (the erms memcpy/memset loops glibc leans on) ----------
# Single-stepping a rep-prefixed instruction traps once per ITERATION with
# rip unchanged, so each captured step is exactly one element move — the
# lifter emits that one element's dataflow and the register self-check
# validates it (direction-flag-reversed or otherwise odd iterations demote).

_STR_W = {"b": 1, "w": 2, "l": 4, "d": 4, "q": 8}


def _is_movs(inst: Inst) -> bool:
    m = inst.mnemonic.split()[-1]
    return (m[:-1] == "movs" and m[-1] in _STR_W
            and len(inst.operands) == 2
            and all(o.kind == "mem" for o in inst.operands))


def _is_stos(inst: Inst) -> bool:
    m = inst.mnemonic.split()[-1]
    return ((m == "stos" or (m[:-1] == "stos" and m[-1] in _STR_W))
            and len(inst.operands) == 2
            and inst.operands[0].kind == "reg"
            and inst.operands[1].kind == "mem")


def _str_width(inst: Inst) -> int:
    for o in inst.operands:
        if o.kind == "reg" and o.reg >= 0 and o.width:
            return abs(o.width) // 8
    return _STR_W.get(inst.mnemonic.split()[-1][-1], 8)


class Lifter:
    """One nativetrace capture + static decode → Trace + metadata."""

    # phys index of xmm0's low lane; None disables the FP lift (lift64
    # reuses 32..57 as GPR hi lanes)
    FP_BASE: "int | None" = FX0

    def __init__(self, nt: NativeTrace, insts: dict[int, Inst],
                 max_uops: int | None = None, elf_regs: list | None = None):
        self.nt = nt
        self.insts = insts
        self.max_uops = max_uops
        self.elf_regs = elf_regs or []      # (vaddr, bytes, ro) PT_LOADs
        self.stats = LiftStats()
        # emitted µop columns
        self.opcode: list[int] = []
        self.dst: list[int] = []
        self.src1: list[int] = []
        self.src2: list[int] = []
        self.imm: list[int] = []
        self.taken: list[int] = []
        self.mem_cluster: list[int] = []    # per-µop cluster idx (-1: none)
        self.resync_uops: list[int] = []    # LUIs emitted by demotions
        # (macro step, arch regs the demoted inst READS): a fault in one
        # of those registers flows into silicon behavior the replay never
        # models (e.g. a demoted ymm load's address crash channel) — the
        # host-diff harness escalates exactly those coords (hostdiff.py
        # _demoted_exposed)
        self.demoted_reads: list[tuple[int, list[int]]] = []
        self.uop_start: list[int] = []      # macro step -> first µop index
        # golden simulation state (the self-check oracle)
        self.reg = np.zeros(NPHYS, dtype=np.uint64)   # low-32 values (u64 buf)
        self.mem: np.ndarray | None = None  # uint32[mem_words]
        self.clusters: list[Cluster] = []
        self.mem_words = 0
        self.flags_src: tuple | None = None  # ('cmp'|'test'|'res', a, b)
        # (reg, macro_idx) after `imul r64, r64` whose true operands fit
        # u32: HSH holds high32 of the product, consumed by an adjacent
        # `shr $c, reg` with c >= 32 — the unsigned divide-by-constant
        # idiom (magic multiply + wide shift) every compiler emits
        self._hi_shadow: "tuple | None" = None

    # -- memory clustering (pre-pass) --------------------------------------

    def _ea_of(self, op: Operand, regs: np.ndarray) -> int | None:
        """Full-64-bit effective address from captured registers."""
        if op.base in (-3, -4, -5) or op.seg:
            return None
        ea = op.disp
        if op.rip_rel:
            return op.disp          # already resolved absolute
        if op.base >= 0:
            ea += int(regs[op.base])
        if op.index >= 0:
            ea += int(regs[op.index]) * op.scale
        return ea & 0xFFFFFFFFFFFFFFFF

    def _mem_width(self, inst: Inst, op: Operand) -> int:
        """Access width in bytes, from the register operand or suffix."""
        for o in inst.operands:
            if o.kind == "reg" and o.reg >= 0:
                return abs(o.width) // 8
        sfx = inst.mnemonic[-1]
        return {"b": 1, "w": 2, "l": 4, "q": 8}.get(sfx, 8)

    def build_memory_map(self) -> None:
        """Pre-pass: every dynamic EA → clusters → flat word layout, plus a
        per-static-pc cluster assignment (folded-affine remap)."""
        touched: dict[int, set[int]] = {}       # pc -> set of EAs
        steps = self.nt.steps
        n = len(steps) - 1
        for i in range(n):
            pc = int(steps[i][16])
            inst = self.insts.get(pc)
            if inst is None:
                continue
            if inst.mnemonic in ("call", "callq"):
                # implicit push of the return address
                touched.setdefault(pc, set()).add(
                    (int(steps[i][4]) - 8) & 0xFFFFFFFFFFFFFFFF)
            if inst.mnemonic in ("ret", "retq", "push", "pushq"):
                rsp = int(steps[i][4])
                ea = rsp - 8 if inst.mnemonic.startswith("push") else rsp
                touched.setdefault(pc, set()).add(ea & 0xFFFFFFFFFFFFFFFF)
            if inst.mnemonic in ("pop", "popq"):
                touched.setdefault(pc, set()).add(int(steps[i][4]))
            if _is_movs(inst):
                # two independent memory streams at one static pc: keyed
                # (pc, "s")/(pc, "d") so each gets its own cluster binding
                # (the plain pc key would demand a single shared cluster)
                for op, tag in zip(inst.operands, ("s", "d")):
                    ea = self._ea_of(op, steps[i])
                    if ea is not None:
                        touched.setdefault((pc, tag), set()).add(ea)
                continue
            for op in inst.operands:
                if op.kind != "mem" or op.base in (-3, -4, -5) or op.seg:
                    continue
                ea = self._ea_of(op, steps[i])
                if ea is not None:
                    touched.setdefault(pc, set()).add(ea)
        all_eas = sorted({ea for s in touched.values() for ea in s})
        if not all_eas:
            self.clusters = []
            self.mem_words = 64
            self.mem = np.zeros(64, dtype=np.uint32)
            self.pc_cluster = {}
            return
        # cluster EAs with gaps > 64 KiB separating clusters
        clusters_raw: list[list[int]] = [[all_eas[0]]]
        for ea in all_eas[1:]:
            if ea - clusters_raw[-1][-1] > 65536:
                clusters_raw.append([ea])
            else:
                clusters_raw[-1].append(ea)
        # Layout: each cluster padded, word-aligned, 16-word margin.  The
        # replay address space is the low-32 projection, so clusters whose
        # projected ranges collide cannot coexist — keep the heaviest
        # (most-touched) clusters and DROP the rest: a dropped cluster's
        # accesses demote to opaque via pc_cluster=None (stray one-off EAs
        # in the libc exit tail were colliding and failing whole lifts).
        weights = [len(c) for c in clusters_raw]
        order = sorted(range(len(clusters_raw)), key=lambda i: -weights[i])
        kept: list[tuple[int, int]] = []       # (lo32, hi32) accepted
        kept_idx = []
        for ci in order:
            c = clusters_raw[ci]
            lo = (c[0] & ~0x3F)                  # 64-byte align down
            hi = ((c[-1] + 8 + 0x3F) & ~0x3F) + 64
            lo32, hi32 = lo & M32, hi & M32
            if hi32 < lo32:                      # wraps the 32-bit space
                self.stats.clusters_dropped += 1
                continue
            if any(lo32 < h and ll < hi32 for ll, h in kept):
                self.stats.clusters_dropped += 1
                continue
            kept.append((lo32, hi32))
            kept_idx.append(ci)
        word_off = 0
        self.clusters = []
        for ci in sorted(kept_idx):
            c = clusters_raw[ci]
            lo = (c[0] & ~0x3F)
            hi = ((c[-1] + 8 + 0x3F) & ~0x3F) + 64
            self.clusters.append(Cluster(lo & M32, hi & M32, word_off))
            word_off += (hi - lo) // 4
        # +1: the replay kernel's VA crash model absorbs mapped-but-
        # untracked accesses at mem_words-1, which must lie outside every
        # cluster (and so outside every liveness comparison mask)
        self.mem_words = 1 << int(np.ceil(np.log2(max(word_off + 1, 64))))
        self.mem = np.zeros(self.mem_words, dtype=np.uint32)
        # Fill from the snapshot regions.  Reverse order so that on
        # overlap the EARLIEST region wins (its write lands last) — the
        # same first-match precedence the emulator uses, where live
        # snapshot regions precede read-only ELF fallback segments.
        for cl in self.clusters:
            for vaddr, data in reversed(self.nt.regions):
                va32 = vaddr & M32
                end32 = va32 + len(data)
                lo = max(cl.lo, va32)
                hi = min(cl.hi, end32)
                if lo >= hi:
                    continue
                src = data[lo - va32: hi - va32]
                nw = len(src) // 4
                w0 = cl.word_off + (lo - cl.lo) // 4
                self.mem[w0:w0 + nw] = np.frombuffer(
                    src[:nw * 4], dtype="<u4")
        # per-static-pc cluster: must be unique for the folded-affine remap
        self.pc_cluster: dict[int, Cluster | None] = {}
        for pc, eas in touched.items():
            cls = {self._cluster_of(ea & M32) for ea in eas}
            # None (an EA in a DROPPED cluster) must demote the pc, not be
            # discarded: folding a kept cluster's remap into a dropped
            # cluster's EA would store through a wrong replay word
            self.pc_cluster[pc] = (cls.pop() if len(cls) == 1
                                   and None not in cls else None)

    STACK_GROW = 4 << 20

    def map_regions(self) -> list:
        """Silicon-mapped address windows for the replay kernel's VA crash
        model: (lo32, span_bytes, writable).  Snapshot regions are the live
        writable map; ELF PT_LOAD segments add text/rodata (a store into a
        read-only one is a SIGSEGV on silicon).  The region holding the
        initial stack pointer extends downward by STACK_GROW — Linux grows
        the main-thread stack on demand, so an address landing shortly
        below the mapped stack does NOT fault on real hardware."""
        rsp0 = int(self.nt.steps[0][4])
        out = []
        for vaddr, data in self.nt.regions:
            lo, span = int(vaddr), len(data)
            if lo <= rsp0 < lo + span:
                lo -= self.STACK_GROW
                span += self.STACK_GROW
            out.append((lo & M32, int(span), True))
        for vaddr, data, ro in self.elf_regs:
            out.append((int(vaddr) & M32, len(data), not ro))
        return out

    def _cluster_of(self, ea32: int) -> Cluster | None:
        for cl in self.clusters:
            if cl.lo <= ea32 < cl.hi:
                return cl
        return None

    def _remap_const(self, cl: Cluster) -> int:
        """byte-address delta folded into a displacement: replay address =
        real_low32 + delta = 4*(word_off) + (real - lo)."""
        return (4 * cl.word_off - cl.lo) & M32

    # -- µop emission + simulation -----------------------------------------

    def _emit(self, op: int, dst: int, src1: int, src2: int, imm: int = 0,
              taken: int = 0) -> None:
        self.opcode.append(op)
        self.dst.append(dst)
        self.src1.append(src1)
        self.src2.append(src2)
        self.imm.append(imm & M32)
        self.taken.append(taken)
        # per-µop cluster for the replay kernel's VA-space crash model:
        # derived from the *golden* replay address (cluster-stable by the
        # folded-affine invariant), so every emission site gets it free
        if op in (U.LOAD, U.STORE):
            addr = (int(self.reg[src1]) + (imm & M32)) & M32
            self.mem_cluster.append(self._replay_cluster_idx(addr))
        else:
            self.mem_cluster.append(-1)
        self._sim_apply(op, dst, src1, src2, imm & M32)

    def _replay_cluster_idx(self, replay_addr: int) -> int:
        """Cluster index owning a flat replay byte-address, or -1."""
        w = replay_addr >> 2
        for i, cl in enumerate(self.clusters):
            if cl.word_off <= w < cl.word_off + (cl.hi - cl.lo) // 4:
                return i
        return -1

    def _sim_apply(self, op, dst, src1, src2, imm) -> None:
        r = self.reg
        a = int(r[src1]) & M32
        b = int(r[src2]) & M32
        sh = b & 31
        res = None
        if op == U.ADD:
            res = a + b
        elif op == U.SUB:
            res = a - b
        elif op == U.AND:
            res = a & b
        elif op == U.OR:
            res = a | b
        elif op == U.XOR:
            res = a ^ b
        elif op == U.SLL:
            res = a << sh
        elif op == U.SRL:
            res = a >> sh
        elif op == U.SRA:
            res = (a - (1 << 32) if a >= (1 << 31) else a) >> sh
        elif op == U.ADDI:
            res = a + imm
        elif op == U.ANDI:
            res = a & imm
        elif op == U.ORI:
            res = a | imm
        elif op == U.XORI:
            res = a ^ imm
        elif op == U.LUI:
            res = imm
        elif op == U.MUL:
            res = a * b
        elif op == U.SLT:
            res = int(self._s32(a) < self._s32(b))
        elif op == U.SLTU:
            res = int(a < b)
        elif op in (U.DIV, U.REM, U.DIVU, U.REMU, U.MULHU,
                    U.FADD, U.FSUB, U.FMUL, U.FDIV):
            res = semantics.alu(op, a, b, imm)
        elif op == U.LOAD:
            addr = (a + imm) & M32
            res = int(self.mem[(addr >> 2) & (self.mem_words - 1)]) \
                if (addr & 3) == 0 and (addr >> 2) < self.mem_words else 0
        elif op == U.STORE:
            addr = (a + imm) & M32
            if (addr & 3) == 0 and (addr >> 2) < self.mem_words:
                self.mem[addr >> 2] = b
            return
        else:                    # NOP / branches: no register effect
            return
        r[dst] = res & M32

    @staticmethod
    def _s32(v: int) -> int:
        return v - (1 << 32) if v & 0x80000000 else v

    def _const(self, value: int, treg: int) -> int:
        """Materialize a 32-bit constant (one ADDI off ZERO)."""
        self._emit(U.ADDI, treg, ZERO, ZERO, value & M32)
        return treg

    # -- per-macro-op lifting ----------------------------------------------

    def _addr_uops(self, op: Operand, pc: int, treg: int
                   ) -> tuple[int, int] | None:
        """µops computing the access address → (reg, folded_imm), or None
        if unmappable.  The cluster remap constant is folded into the
        displacement (zero-cost translation; see module docstring)."""
        cl = self.pc_cluster.get(pc)
        self.stats.mem_accesses += 1
        if cl is None:
            self.stats.mem_dropped += 1
            return None
        delta = self._remap_const(cl)
        if op.rip_rel or op.base < 0 and op.index < 0:
            base_reg = ZERO
            disp = op.disp
        elif op.index >= 0:
            if op.scale > 1:
                sh = self._const(op.scale.bit_length() - 1, T3)
                self._emit(U.SLL, treg, op.index, sh)
            else:
                self._emit(U.ADD, treg, op.index, ZERO)
            if op.base >= 0:
                self._emit(U.ADD, treg, treg, op.base)
            base_reg = treg
            disp = op.disp
        else:
            base_reg = op.base
            disp = op.disp
        return base_reg, (disp + delta) & M32

    # -- EVEX strlen chain -------------------------------------------------
    # glibc's __strlen_evex head is vpxorq zmmZ (zero) → vpcmpeqb
    # (mem),ymmZ,k → kmovd k,r32 → tzcnt: everything between memory bytes
    # and the GPR mask is vector state the 32-bit datapath cannot hold.
    # Tracked symbolically instead: a known-zero vector register set and a
    # per-k-register "byte==0 mask of W bytes at [base+disp]" record; at
    # kmovd the mask is MATERIALIZED as byte-compare µops against replay
    # memory, restoring fault propagation from string bytes to the length
    # (the r3/r4 strmix disagreement channel).  The register self-check
    # validates every materialized mask against the captured GPR, and any
    # unrecognized vector/k write invalidates the touched state
    # (fail-closed: unknown k at kmovd demotes exactly as before).

    class _VRegion(NamedTuple):
        pc: int            # the referencing instruction (cluster key)
        base: int          # address base register (canonical index)
        base_val: int      # captured base value at reference time (low 32)
        disp: int

    class _KMask(NamedTuple):
        regions: tuple     # _VRegion tuple; mask bit b = OR over regions
        width: int         # compared bytes (ymm: 32)

    class _KConcat(NamedTuple):
        lo: "Lifter._KMask"    # bits [0,32)  (kunpckdq src2)
        hi: "Lifter._KMask"    # bits [32,64) (kunpckdq src1)

    def _vec_state(self):
        if not hasattr(self, "_vzero"):
            self._vzero: set[int] = set()
            self._kmask: dict[int, Lifter._KMask | None] = {}
            # vector regs holding loaded/min-combined byte blocks: reg ->
            # (regions tuple, width); min(a,b)==0 iff a==0 or b==0, so a
            # vpminub chain is exactly a region-set union for the later
            # ==0 compare
            self._vreg: dict[int, tuple] = {}
        return self._vzero, self._kmask

    def _vec_reset(self) -> None:
        if hasattr(self, "_vzero"):
            self._vzero.clear()
            self._kmask.clear()
            self._vreg.clear()

    def _vregion_of(self, mem: "Operand", pc: int, regs: np.ndarray):
        if mem.base < 0 or mem.index >= 0 or mem.rip_rel or mem.seg:
            return None
        # the symbolic region record carries no µops, so a corrupted base
        # register would otherwise never influence the replay even though
        # the HARDWARE load through it is silicon's crash channel (strmix
        # r4: hi-bit rdi flips → silicon segfault, replay masked).  Emit a
        # word-aligned probe LOAD through the live/guarded address path:
        # the golden lane reads a golden word (dead value), a deviated
        # base trap/escapes exactly like any other access.
        r = self._addr_uops(mem, pc, T3)
        if r is None:
            return None                    # dropped cluster → demote
        base_r, disp = r
        self._emit(U.ADDI, T3, base_r, ZERO, disp)
        self._emit(U.ANDI, T3, T3, ZERO, 0xFFFFFFFC)
        self._emit(U.LOAD, T6, T3, ZERO, 0)
        return self._VRegion(pc, mem.base, int(regs[mem.base]) & M32,
                             mem.disp)

    def _lift_vec_chain(self, m: str, ops: list, pc: int,
                        regs: np.ndarray):
        """True/False when this instruction was consumed (lifted/demoted);
        None to fall through to the ordinary handlers."""
        touches_vec = any(o.kind in ("xmm", "kreg") for o in ops)
        if not touches_vec and m not in ("tzcnt",):
            return None
        vzero, kmask = self._vec_state()
        vreg = self._vreg
        # conservative pre-invalidation of the destination (AT&T: last op)
        # — except flags-only instructions (last operand is a source) and
        # kunpck, whose dst may alias a source (its handler re-writes it)
        if touches_vec and ops and not m.startswith(("kortest", "ktest",
                                                     "vptest", "kunpckdq")):
            d = ops[-1]
            if d.kind == "xmm":
                vzero.discard(d.reg)
                vreg.pop(d.reg, None)
            elif d.kind == "kreg":
                kmask[d.reg] = None

        if m in ("vpxor", "vpxord", "vpxorq", "xorps", "xorpd", "pxor") \
                and len(ops) in (2, 3) \
                and all(o.kind == "xmm" and o.reg == ops[0].reg
                        for o in ops):
            vzero.add(ops[0].reg)
            # FP-modeled low xmm regs: the scalar-SSE lift must still zero
            # the modeled lane (consuming here left it stale and demoted
            # every gcc pxor-zeroing idiom) — record and fall through
            if (self.FP_BASE is not None
                    and getattr(self, "_has_xmm", False)
                    and 0 <= ops[0].reg < 16 and abs(ops[0].width) <= 128):
                return None
            return True                      # architecturally GPR-silent

        if m in ("vmovdqa64", "vmovdqu64", "vmovdqa", "vmovdqu") \
                and len(ops) == 2 and ops[0].kind == "mem" \
                and ops[1].kind == "xmm":
            r = self._vregion_of(ops[0], pc, regs)
            if r is not None:
                vreg[ops[1].reg] = ((r,), abs(ops[1].width) // 8)
                return True                  # GPR-silent block load
            return False

        if m in ("vpminub",) and len(ops) == 3 and ops[2].kind == "xmm":
            # unsigned byte min: min(a,b)==0 iff a==0 or b==0 — the ==0
            # compare downstream sees the union of the source regions
            a, b, d = ops
            regions = []
            for o in (a, b):
                if o.kind == "mem":
                    r = self._vregion_of(o, pc, regs)
                    if r is None:
                        return False
                    regions.append(r)
                elif o.kind == "xmm" and o.reg in vreg:
                    regions.extend(vreg[o.reg][0])
                else:
                    return False
            if len(regions) > 4:
                return False
            vreg[d.reg] = (tuple(regions), abs(d.width) // 8)
            return True

        if m in ("vpcmpeqb",) and len(ops) == 3 \
                and ops[1].kind == "xmm" and ops[2].kind == "kreg":
            src, z, k = ops
            if z.reg not in vzero:
                return False
            w = abs(z.width) // 8
            if src.kind == "mem":
                r = self._vregion_of(src, pc, regs)
                if r is not None:
                    kmask[k.reg] = self._KMask((r,), w)
                    return True
                return False
            if src.kind == "xmm" and src.reg in vreg:
                kmask[k.reg] = self._KMask(vreg[src.reg][0], w)
                return True
            return False                     # unknown compare → opaque

        if m in ("kmovd",) and len(ops) == 2 and ops[0].kind == "kreg" \
                and ops[1].kind == "reg" and ops[1].reg >= 0:
            st = kmask.get(ops[0].reg)
            dst = ops[1].reg
            if not isinstance(st, self._KMask) or st.width > 32 \
                    or not self._kmask_live(st, dst, regs):
                return False
            return self._materialize_kmask(st, dst, regs)

        if m in ("kunpckdq",) and len(ops) == 3 \
                and all(o.kind == "kreg" for o in ops):
            # AT&T (src2, src1, dst): dst[31:0]=src2, dst[63:32]=src1
            lo_st, hi_st = kmask.get(ops[0].reg), kmask.get(ops[1].reg)
            if not isinstance(lo_st, self._KMask) \
                    or not isinstance(hi_st, self._KMask):
                kmask[ops[2].reg] = None
                return False
            kmask[ops[2].reg] = self._KConcat(lo_st, hi_st)
            return True                      # GPR-silent

        if m in ("kmovq",) and len(ops) == 2 and ops[0].kind == "kreg" \
                and ops[1].kind == "reg" and ops[1].reg >= 0:
            st = kmask.get(ops[0].reg)
            dst = ops[1].reg
            if isinstance(st, self._KConcat):
                # 32-bit projection: only the low half is tracked (the
                # pair-lane lifter overrides with the hi lane too)
                if not self._kmask_live(st.lo, dst, regs):
                    return False
                return self._materialize_kmask(st.lo, dst, regs)
            if st is not None and st.width <= 32 \
                    and self._kmask_live(st, dst, regs):
                return self._materialize_kmask(st, dst, regs)
            return False

        if m in ("kortestd",) and len(ops) == 2 \
                and all(o.kind == "kreg" for o in ops):
            # flags = (k0 | k1) == 0; OR of masks = union of regions.
            # No GPR is written, so the register self-check cannot vet
            # this — the BRANCH self-check (captured direction vs lifted
            # condition) is the net instead.
            sts = [kmask.get(o.reg) for o in ops]
            if any(not isinstance(s, self._KMask) or s.width > 32
                   or not self._kmask_live(s, TCMP, regs) for s in sts):
                return False
            if sts[0].width != sts[1].width:
                # differing compare widths: the narrower mask's high bits
                # are architecturally zero, but a region-union would
                # materialize phantom byte-compares there — demote
                return False
            merged = self._KMask(sts[0].regions + sts[1].regions,
                                 sts[0].width)
            if len(merged.regions) > 8 \
                    or not self._materialize_kmask(merged, TCMP, regs):
                return False
            self.flags_src = ("res", TCMP)
            return True

        if m == "tzcnt" and len(ops) == 2 \
                and all(o.kind == "reg" and o.reg >= 0
                        and abs(o.width) == 32 for o in ops):
            self._emit_ctz32(ops[0].reg, ops[1].reg)
            self.flags_src = ("res", ops[1].reg)
            return True

        # fall through: the scalar-SSE FP lift (and the generic demotion
        # path) still see the instruction; state was already invalidated
        return None

    def _kmask_live(self, st: "_KMask", dst: int, regs: np.ndarray) -> bool:
        """The materialization addresses through the live base registers,
        so none may be the destination.  A base that moved since the
        compare (the strlen 4× loop bumps rdi before kortest) is fine —
        the golden drift folds into the displacement."""
        return all(r.base != dst for r in st.regions)

    def _materialize_kmask(self, st: "_KMask", dst: int,
                           regs: np.ndarray) -> bool:
        """dst = bitmask over st.width bytes: bit b set iff byte b == 0 in
        ANY region (single region: the vpcmpeqb-vs-zero result; several:
        the vpminub-combined compare) — recomputed from replay memory so
        corrupted string bytes reach the mask."""
        deltas = []
        for r in st.regions:
            cl = self.pc_cluster.get(r.pc)
            self.stats.mem_accesses += 1
            if cl is None:
                self.stats.mem_dropped += 1
                return False
            # golden drift of the base register since the compare: on the
            # golden path base_now + (disp − drift) == base_then + disp;
            # off-path a corrupted base shifts the window, as on hardware
            drift = (int(regs[r.base]) - r.base_val) & M32
            deltas.append((r, (r.disp + self._remap_const(cl) - drift)
                           & M32))
        # cost note: ~11 µops/byte/region (354 per 32-byte single-region
        # kmovd).  Bounded in practice — strmix's materializations total
        # ≈ 25k µops, a few % of the largest lifted windows — and every
        # µop is validated by the register self-check, so the simple
        # per-byte form is kept over a load-each-word-once variant (~22%
        # fewer µops, more edge cases).
        self._emit(U.LUI, dst, ZERO, ZERO, 0)
        self._emit(U.ADDI, T3, ZERO, ZERO, 3)         # byte→bit shift ×8
        for i in range(st.width):
            first = True
            for r, delta in deltas:
                # pointers are NOT word-aligned: per-byte address with an
                # aligned word load + dynamic in-word shift
                self._emit(U.ADDI, T2, r.base, ZERO, (delta + i) & M32)
                self._emit(U.ANDI, T6, T2, ZERO, (~3) & M32)
                self._emit(U.LOAD, T6, T6, ZERO, 0)
                self._emit(U.ANDI, T4, T2, ZERO, 3)
                self._emit(U.SLL, T4, T4, T3)
                self._emit(U.SRL, T5, T6, T4)
                self._emit(U.ANDI, T5, T5, ZERO, 0xFF)
                self._emit(U.SLTU, T5, ZERO, T5)
                self._emit(U.XORI, T5, T5, ZERO, 1)
                if first:
                    self._emit(U.ADD, T7, T5, ZERO)
                    first = False
                else:
                    self._emit(U.OR, T7, T7, T5)
            self._emit(U.ADDI, T4, ZERO, ZERO, i)
            self._emit(U.SLL, T5, T7, T4)
            self._emit(U.OR, dst, dst, T5)
        return True

    def _emit_ctz32(self, src: int, dst: int) -> None:
        """Branchless count-trailing-zeros (tzcnt semantics: 32 for 0)."""
        self._emit(U.ADD, T5, src, ZERO)
        self._emit(U.LUI, T6, ZERO, ZERO, 0)
        for msk, log in ((0xFFFF, 4), (0xFF, 3), (0xF, 2), (0x3, 1),
                         (0x1, 0)):
            self._emit(U.ANDI, T4, T5, ZERO, msk)
            self._emit(U.SLTU, T4, ZERO, T4)
            self._emit(U.XORI, T4, T4, ZERO, 1)       # low part all-zero?
            self._emit(U.ADDI, T3, ZERO, ZERO, log)
            self._emit(U.SLL, T4, T4, T3)             # 0 or 2^log
            self._emit(U.ADD, T6, T6, T4)
            self._emit(U.SRL, T5, T5, T4)
        self._emit(U.ANDI, T4, T5, ZERO, 1)
        self._emit(U.XORI, T4, T4, ZERO, 1)
        self._emit(U.ADD, T6, T6, T4)                 # src==0 → 32
        self._emit(U.ADD, dst, T6, ZERO)

    # -- x86 string ops ----------------------------------------------------
    # Canonical indices of the implicit string registers.
    _RSI, _RDI, _RCX = 6, 7, 1

    def _lift_movs(self, inst: Inst, pc: int, regs: np.ndarray) -> bool:
        """One movs iteration: [rdi] <- [rsi], rsi/rdi advance, rep
        decrements rcx.  DF=1 (backward) iterations fail the register
        self-check and demote — fail-closed."""
        w = _str_width(inst)
        scl = self.pc_cluster.get((pc, "s"))
        dcl = self.pc_cluster.get((pc, "d"))
        self.stats.mem_accesses += 2
        if scl is None or dcl is None or w < 4:
            self.stats.mem_dropped += 2
            return False
        self._str_copy_word(self._remap_const(scl), self._remap_const(dcl),
                            w)
        self._inc_strreg(self._RSI, w)
        self._inc_strreg(self._RDI, w)
        if inst.mnemonic.startswith("rep"):
            self._inc_strreg(self._RCX, -1)
        return True

    def _stos_hi_imm(self, src_reg: int, regs: np.ndarray) -> int:
        """High word a qword stos writes: the 32-bit projection tracks
        only the low lane, so the high half is golden-frozen from the
        captured register (lift64 overrides with the live hi lane)."""
        return (int(regs[src_reg]) >> 32) & M32

    def _lift_stos(self, inst: Inst, pc: int, regs: np.ndarray) -> bool:
        """One stos iteration: [rdi] <- rax/eax/al, rdi advances, rep
        decrements rcx (the erms memset loop)."""
        w = _str_width(inst)
        src, dst = inst.operands
        if w >= 4:
            cl = self.pc_cluster.get(pc)
            self.stats.mem_accesses += 1
            if cl is None:
                self.stats.mem_dropped += 1
                return False
            self._str_store_reg(src.reg, self._remap_const(cl), w,
                                self._stos_hi_imm(src.reg, regs))
        elif not self._subword_store(dst, pc, regs, w, src_reg=src.reg):
            return False
        self._inc_strreg(self._RDI, w)
        if inst.mnemonic.startswith("rep"):
            self._inc_strreg(self._RCX, -1)
        return True

    # overridable string-op primitives (Lifter64 widens them to pair lanes)
    def _str_copy_word(self, sdelta: int, ddelta: int, w: int) -> None:
        self._emit(U.LOAD, T6, self._RSI, ZERO, sdelta)
        self._emit(U.STORE, 0, self._RDI, T6, ddelta)
        if w == 8:
            # both halves move memory→memory: exact even in the 32-bit
            # projection, and replay memory stays byte-faithful for later
            # byte readers (the EVEX mask materialization reads it)
            self._emit(U.LOAD, T7, self._RSI, ZERO, (sdelta + 4) & M32)
            self._emit(U.STORE, 0, self._RDI, T7, (ddelta + 4) & M32)

    def _str_store_reg(self, reg: int, ddelta: int, w: int,
                       hi_imm: int = 0) -> None:
        self._emit(U.STORE, 0, self._RDI, reg, ddelta)
        if w == 8:
            self._emit(U.LUI, T7, ZERO, ZERO, hi_imm)
            self._emit(U.STORE, 0, self._RDI, T7, (ddelta + 4) & M32)

    def _inc_strreg(self, r: int, v: int) -> None:
        self._emit(U.ADDI, r, r, ZERO, v & M32)

    # -- sub-word (byte/halfword) memory access expansion ------------------
    #
    # The replay µop ISA is word-only (LOAD/STORE trap on addr&3 != 0, the
    # reference analog being x86's own alignment machinery); byte accesses
    # are expanded to word load + shift/mask/merge sequences whose shift
    # amount is computed *dynamically* from the effective address, so a
    # fault-corrupted base register still selects the right byte of the
    # right word (mirrors how x86 µcode slices sub-word accesses,
    # gem5 src/arch/x86/isa/microops/ldstop.isa).

    def _subword_addr(self, op: Operand, pc: int, regs: np.ndarray,
                      width: int):
        """µops leaving word address in T0 and bit-shift (=8×byte-offset)
        in T3 → (T0, T3); None demotes (unmappable or straddling word)."""
        ea = self._ea_of(op, regs)
        if ea is None or (ea & 3) + width > 4:
            return None
        a = self._addr_uops(op, pc, T0)
        if a is None:
            return None
        self._emit(U.ADDI, T0, a[0], ZERO, a[1])        # byte EA (remapped)
        c3 = self._const(3, T4)
        self._emit(U.ANDI, T3, T0, ZERO, 3)
        self._emit(U.SLL, T3, T3, c3)                   # (ea & 3) * 8
        self._emit(U.ANDI, T0, T0, ZERO, 0xFFFFFFFC)
        return T0, T3

    def _subword_load_value(self, src: Operand, pc: int, regs: np.ndarray,
                            width: int, signed: bool, out_reg: int) -> bool:
        """Load byte/halfword → zero/sign-extended value in ``out_reg``."""
        wa = self._subword_addr(src, pc, regs, width)
        if wa is None:
            return False
        word_r, sh_r = wa
        self._emit(U.LOAD, T6, word_r, ZERO, 0)
        self._emit(U.SRL, T6, T6, sh_r)
        msk = 0xFF if width == 1 else 0xFFFF
        self._emit(U.ANDI, out_reg, T6, ZERO, msk)
        if signed:
            sbit = msk ^ (msk >> 1)
            self._emit(U.XORI, out_reg, out_reg, ZERO, sbit)
            self._emit(U.ADDI, out_reg, out_reg, ZERO, (-sbit) & M32)
        return True

    def _subword_store(self, dst: Operand, pc: int, regs: np.ndarray,
                       width: int, src_reg: int | None = None,
                       src_imm: int | None = None) -> bool:
        """Store the low byte/halfword of a register (or an immediate)."""
        wa = self._subword_addr(dst, pc, regs, width)
        if wa is None:
            return False
        word_r, sh_r = wa
        msk = 0xFF if width == 1 else 0xFFFF
        self._emit(U.LOAD, T6, word_r, ZERO, 0)
        self._emit(U.LUI, T7, ZERO, ZERO, msk)
        self._emit(U.SLL, T7, T7, sh_r)
        self._emit(U.XORI, T7, T7, ZERO, M32)           # ~(msk << sh)
        self._emit(U.AND, T6, T6, T7)
        if src_imm is not None:
            self._emit(U.LUI, T5, ZERO, ZERO, src_imm & msk)
        else:
            self._emit(U.ANDI, T5, src_reg, ZERO, msk)
        self._emit(U.SLL, T5, T5, sh_r)
        self._emit(U.OR, T6, T6, T5)
        self._emit(U.STORE, 0, word_r, T6, 0)
        return True

    def _extend_reg(self, src_reg: int, width: int, signed: bool,
                    out_reg: int) -> None:
        """out = zero/sign-extended low byte/halfword of src."""
        msk = 0xFF if width == 1 else 0xFFFF
        self._emit(U.ANDI, out_reg, src_reg, ZERO, msk)
        if signed:
            sbit = msk ^ (msk >> 1)
            self._emit(U.XORI, out_reg, out_reg, ZERO, sbit)
            self._emit(U.ADDI, out_reg, out_reg, ZERO, (-sbit) & M32)

    def _cond_bool(self, cond: str, out_reg: int) -> int | None:
        """Materialize a flag condition as 0/1 in ``out_reg`` (for cmov),
        from the recorded flags_src — same condition algebra as _lift_jcc
        but branch-free (the select must stay value-faithful under faults,
        so no control flow)."""
        if self.flags_src is None:
            return None
        k = self.flags_src[0]
        if k == "fcmp":
            # float compare keys: only unordered-style conditions map to
            # SLTU/equality on the keys (as in _lift_jcc); everything
            # else demotes fail-closed
            if cond not in ("eq", "ne", "ub", "uae", "ua", "ube"):
                return None
            k = "cmp"
        if k in ("cmp", "cmpb"):
            a, b = self.flags_src[1], self.flags_src[2]
        else:
            a, b = self.flags_src[1], ZERO
        neg = False
        if cond in ("eq", "ne"):
            self._emit(U.XOR, out_reg, a, b)
            self._emit(U.SLTU, out_reg, ZERO, out_reg)      # != 0
            neg = cond == "eq"
        elif cond in ("lt", "ge"):
            self._emit(U.SLT, out_reg, a, b)
            neg = cond == "ge"
        elif cond in ("swap_lt", "swap_ge"):                # gt / le
            self._emit(U.SLT, out_reg, b, a)
            neg = cond == "swap_ge"
        elif cond in ("sign", "nsign"):
            if k == "cmpb":
                return None      # sub-word SF not reproducible (overflow)
            if k == "cmp":
                self._emit(U.SUB, out_reg, a, b)
                self._emit(U.SLT, out_reg, out_reg, ZERO)
            else:
                self._emit(U.SLT, out_reg, a, ZERO)
            neg = cond == "nsign"
        elif cond in ("ub", "uae"):                         # b / ae
            self._emit(U.SLTU, out_reg, a, b)
            neg = cond == "uae"
        elif cond in ("ua", "ube"):                         # a / be
            self._emit(U.SLTU, out_reg, b, a)
            neg = cond == "ube"
        else:
            return None
        if neg:
            self._emit(U.XORI, out_reg, out_reg, ZERO, 1)
        return out_reg

    def _subword_alu(self, opcode: int, src: Operand, dst: Operand,
                     pc: int, regs: np.ndarray, width: int) -> bool:
        """Byte/halfword ALU with a register destination: compute on
        sign-extended operands (bitwise low bits coincide; add/sub wrap at
        merge), merge into dst's low byte/word, and record sub-word flags
        — SUB keeps exact ("cmpb") compare flags, the rest expose ZF/SF of
        the sign-extended result."""
        if dst.kind != "reg" or dst.reg < 0 or opcode == U.MUL:
            return False
        msk = 0xFF if width == 1 else 0xFFFF
        sbit = msk ^ (msk >> 1)
        self._extend_reg(dst.reg, width, True, T2)
        if src.kind == "imm":
            v = src.imm & msk
            v = v - (msk + 1) if v & sbit else v
            self._const(v & M32, TCMP)
        elif src.kind == "reg" and src.reg >= 0:
            self._extend_reg(src.reg, width, True, TCMP)
        elif src.kind == "mem":
            if not self._subword_load_value(src, pc, regs, width, True,
                                            TCMP):
                return False
        else:
            return False
        self._emit(opcode, T5, T2, TCMP)
        self._emit(U.ANDI, T6, T5, ZERO, msk)
        self._emit(U.ANDI, dst.reg, dst.reg, ZERO, (~msk) & M32)
        self._emit(U.OR, dst.reg, dst.reg, T6)
        if opcode == U.SUB:
            self.flags_src = ("cmpb", T2, TCMP)
        else:
            self._extend_reg(T5, width, True, T1)
            self.flags_src = ("res", T1)
        return True

    def _lift_one(self, i: int, inst: Inst, regs: np.ndarray,
                  next_regs: np.ndarray, next_pc: int) -> bool:
        """Emit µops for macro-op i; returns False to request opaque demotion
        (caller rolls back).  Self-check against next_regs happens in the
        caller for all paths."""
        m = inst.mnemonic
        ops = inst.operands
        pc = inst.pc

        # --- EVEX strlen chain (vpxorq / vpcmpeqb→k / kmovd / tzcnt) ---
        handled = self._lift_vec_chain(m, ops, pc, regs)
        if handled is not None:
            return handled

        # --- scalar-SSE float (xmm low lanes → FADD..FDIV µops) ---
        if any(o.kind == "xmm" for o in ops):
            if self.FP_BASE is None or not getattr(self, "_has_xmm", False):
                # no captured xmm lanes (SHTRACE1/2) → the FP bank would
                # be unverifiable; demote rather than fail open
                return False
            return self._lift_fp(m, ops, pc, regs)

        # --- x86 string ops (one captured iteration per step) ---
        if _is_movs(inst):
            return self._lift_movs(inst, pc, regs)
        if _is_stos(inst):
            return self._lift_stos(inst, pc, regs)

        # --- moves ---
        if m in ("mov", "movq", "movl", "movb", "movw", "movabs", "movslq",
                 "movsxd", "cltq", "cdqe"):
            if m in ("cltq", "cdqe"):            # sign-extend eax→rax: low32 id
                return True                       # no-op in projection
            if len(ops) != 2:
                return False
            src, dst = ops
            width = {"movb": 1, "movw": 2}.get(m)
            if width is None:
                rws = [abs(o.width) // 8 for o in ops
                       if o.kind == "reg" and o.reg >= 0 and o.width]
                width = min(rws) if rws else 4
            if any(o.kind == "reg" and o.reg >= 0 and o.width < 0
                   for o in ops):
                return False      # %ah-family: not the low byte — demote
                                  # (a store writes no GPR, so the register
                                  # self-check could NOT catch this)
            if width < 4:
                # sub-word: byte/halfword stores, loads with partial-reg
                # merge, and partial-reg register moves
                msk = 0xFF if width == 1 else 0xFFFF
                if dst.kind == "mem":
                    if src.kind == "imm":
                        return self._subword_store(dst, pc, regs, width,
                                                   src_imm=src.imm)
                    if src.kind == "reg" and src.reg >= 0:
                        return self._subword_store(dst, pc, regs, width,
                                                   src_reg=src.reg)
                    return False
                if dst.kind == "reg" and dst.reg >= 0:
                    if src.kind == "imm":
                        self._emit(U.LUI, T6, ZERO, ZERO, src.imm & msk)
                    elif src.kind == "reg" and src.reg >= 0:
                        self._emit(U.ANDI, T6, src.reg, ZERO, msk)
                    elif src.kind == "mem":
                        if not self._subword_load_value(src, pc, regs,
                                                        width, False, T6):
                            return False
                    else:
                        return False
                    self._emit(U.ANDI, dst.reg, dst.reg, ZERO,
                               (~msk) & M32)
                    self._emit(U.OR, dst.reg, dst.reg, T6)
                    return True
                return False
            if dst.kind == "reg" and dst.reg >= 0:
                if src.kind == "imm":
                    self._emit(U.LUI, dst.reg, ZERO, ZERO, src.imm)
                    return True
                if src.kind == "reg" and src.reg >= 0:
                    self._emit(U.ADD, dst.reg, src.reg, ZERO)
                    return True
                if src.kind == "mem":
                    a = self._addr_uops(src, pc, T0)
                    if a is None:
                        return False
                    self._emit(U.LOAD, dst.reg, a[0], ZERO, a[1])
                    return True
                return False
            if dst.kind == "mem":
                if self._mem_width(inst, dst) < 4:
                    return False
                a = self._addr_uops(dst, pc, T0)
                if a is None:
                    return False
                if src.kind == "imm":
                    # mov writes no flags: T6, not T1 (flags_src may be T1)
                    self._emit(U.ADDI, T6, ZERO, ZERO, src.imm & M32)
                    self._emit(U.STORE, 0, a[0], T6, a[1])
                    return True
                if src.kind == "reg" and src.reg >= 0:
                    self._emit(U.STORE, 0, a[0], src.reg, a[1])
                    return True
                return False
            return False

        if m in ("movzbl", "movzwl", "movzbq", "movzwq",
                 "movsbl", "movswl", "movsbq", "movswq"):
            if len(ops) != 2:
                return False
            src, dst = ops
            width = 1 if m[4] == "b" else 2
            signed = m.startswith("movs")
            # 16-bit destinations (movzbw) merge into dst[15:0] on real
            # x86 — not handled; the *l/*q forms write the full register
            if dst.kind != "reg" or dst.reg < 0 or abs(dst.width) < 32:
                return False
            if src.kind == "reg" and src.reg >= 0 and src.width < 0:
                return False                      # %ah-family source
            if src.kind == "reg" and src.reg >= 0:
                self._extend_reg(src.reg, width, signed, dst.reg)
                return True
            if src.kind == "mem":
                return self._subword_load_value(src, pc, regs, width,
                                                signed, dst.reg)
            return False

        # --- xchg: three-move swap (lock prefix already folded away —
        # atomicity is meaningless to a single-context replay) ---
        if m in ("xchg", "xchgl", "xchgq") and len(ops) == 2:
            a_op, b_op = ops
            if all(o.kind == "reg" and o.reg >= 0 and abs(o.width) >= 32
                   for o in ops):
                # xchg writes no flags: scratch must stay off T1/T2/TCMP
                self._emit(U.ADD, T6, a_op.reg, ZERO)
                self._emit(U.ADD, a_op.reg, b_op.reg, ZERO)
                self._emit(U.ADD, b_op.reg, T6, ZERO)
                return True
            mem = next((o for o in ops if o.kind == "mem"), None)
            reg = next((o for o in ops if o.kind == "reg" and o.reg >= 0
                        and abs(o.width) >= 32), None)
            if mem is not None and reg is not None \
                    and self._mem_width(inst, mem) >= 4:
                a = self._addr_uops(mem, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T6, a[0], ZERO, a[1])
                self._emit(U.STORE, 0, a[0], reg.reg, a[1])
                self._emit(U.ADD, reg.reg, T6, ZERO)
                return True
            return False

        # --- 32-bit rotates: two shifts + OR.  64-bit rotates cross the
        # uint32 projection boundary (high bits rotate into the tracked
        # low word) and demote; the count is masked &31 exactly as x86
        # masks 32-bit rotate counts, and count==0 degenerates to
        # r | (r << 32&31) == r, so no special case is needed ---
        if m in ("rol", "roll", "ror", "rorl"):
            if len(ops) == 1:
                ops = [Operand("imm", imm=1)] + ops
            if len(ops) != 2:
                return False
            src, dst = ops
            if dst.kind != "reg" or dst.reg < 0 or abs(dst.width) != 32:
                return False
            if src.kind == "imm":
                self._emit(U.LUI, T3, ZERO, ZERO, src.imm & 31)
            elif src.kind == "reg" and src.reg == RCX_ARCH:
                self._emit(U.ANDI, T3, RCX_ARCH, ZERO, 31)
            else:
                return False
            self._emit(U.LUI, T4, ZERO, ZERO, 32)
            self._emit(U.SUB, T4, T4, T3)
            right_first = m.startswith("ror")
            self._emit(U.SRL if right_first else U.SLL, T5, dst.reg, T3)
            self._emit(U.SLL if right_first else U.SRL, T6, dst.reg, T4)
            self._emit(U.OR, dst.reg, T5, T6)
            return True

        # --- cmov: branch-free select (value-faithful under faults) ---
        if m.startswith("cmov"):
            base = m if m in _CMOV else m.rstrip("lqw")
            if base not in _CMOV or len(ops) != 2:
                return False
            src, dst = ops
            if dst.kind != "reg" or dst.reg < 0 or abs(dst.width) < 32:
                return False        # 16-bit cmov merges into dst[15:0]
            if src.kind == "reg" and src.reg >= 0:
                sreg = src.reg
            elif src.kind == "mem" and self._mem_width(inst, src) >= 4:
                a = self._addr_uops(src, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T5, a[0], ZERO, a[1])
                sreg = T5
            else:
                return False
            if self._cond_bool(_CMOV[base], T4) is None:
                return False
            # cmov preserves EFLAGS — T6/T7 scratch keeps a live flags_src
            # in T1/T2/TCMP intact for a later consumer
            self._emit(U.XOR, T6, dst.reg, sreg)
            self._emit(U.SUB, T7, ZERO, T4)        # 0 or all-ones
            self._emit(U.AND, T6, T6, T7)
            self._emit(U.XOR, dst.reg, dst.reg, T6)
            return True

        # --- byte/halfword compare & test: sign-extended operands preserve
        # both the signed and the unsigned ordering of the sub-word domain
        sub_cmp_w = None
        if m in ("cmpb", "cmpw"):
            sub_cmp_w = 1 if m == "cmpb" else 2
        elif m == "cmp" and len(ops) == 2:
            # AT&T spells byte compares "cmp %cl,(%rax)" when a register
            # operand implies the size — the hot byte-match loops of
            # compression workloads are exactly this form
            ws = {abs(o.width) for o in ops
                  if o.kind == "reg" and o.reg >= 0 and o.width}
            if ws and max(ws) <= 16:
                sub_cmp_w = 1 if max(ws) == 8 else 2
        if sub_cmp_w is not None:
            if len(ops) != 2:
                return False
            width = sub_cmp_w
            msk = 0xFF if width == 1 else 0xFFFF
            sbit = msk ^ (msk >> 1)
            src, dst = ops                        # flags of dst - src
            def _sext_operand(o, treg):
                if o.kind == "imm":
                    v = o.imm & msk
                    v = v - (msk + 1) if v & sbit else v
                    return self._const(v & M32, treg)
                if o.kind == "reg" and o.reg >= 0 and o.width > 0:
                    self._extend_reg(o.reg, width, True, treg)
                    return treg
                if o.kind == "mem" and self._subword_load_value(
                        o, pc, regs, width, True, treg):
                    return treg
                return None
            breg = _sext_operand(src, TCMP)
            areg = _sext_operand(dst, T2) if breg is not None else None
            if areg is None:
                return False
            # kind "cmpb" ≠ "cmp": SF of a sub-word cmp is bit 7/15 of the
            # *wrapped* sub-word difference, which the sext-operand SUB does
            # not reproduce on overflow — sign-consumers must demote
            self.flags_src = ("cmpb", areg, breg)
            return True
        if m in ("testb", "testw"):
            if len(ops) != 2:
                return False
            width = 1 if m == "testb" else 2
            a, b = ops
            if any(o.kind == "reg" and o.reg >= 0 and o.width < 0
                   for o in ops):
                return False                      # %ah-family
            if a.kind == "imm" and b.kind == "reg" and b.reg >= 0:
                self._emit(U.ANDI, T2, b.reg, ZERO,
                           a.imm & (0xFF if width == 1 else 0xFFFF))
            elif a.kind == "reg" and a.reg >= 0 and b.kind == "reg" \
                    and b.reg >= 0:
                self._emit(U.AND, T2, a.reg, b.reg)
                self._emit(U.ANDI, T2, T2, ZERO,
                           0xFF if width == 1 else 0xFFFF)
            else:
                return False
            # sign-extend the sub-word result so SF (js/jns) is faithful
            self._extend_reg(T2, width, True, T2)
            self.flags_src = ("res", T2)
            return True

        # --- lea: pure address arithmetic, NO remap (real addresses) ---
        if m == "lea" or m == "leaq":
            src, dst = ops if len(ops) == 2 else (None, None)
            if dst is None or dst.kind != "reg" or dst.reg < 0 \
                    or src.kind != "mem" or src.base == -3:
                return False
            if src.rip_rel:
                self._emit(U.LUI, dst.reg, ZERO, ZERO, src.disp)
                return True
            t = T0
            if src.index >= 0:
                if src.scale > 1:
                    sh = self._const(src.scale.bit_length() - 1, T3)
                    self._emit(U.SLL, t, src.index, sh)
                else:
                    self._emit(U.ADD, t, src.index, ZERO)
                if src.base >= 0:
                    self._emit(U.ADD, t, t, src.base)
                self._emit(U.ADDI, dst.reg, t, ZERO, src.disp)
            elif src.base >= 0:
                self._emit(U.ADDI, dst.reg, src.base, ZERO, src.disp)
            else:
                self._emit(U.LUI, dst.reg, ZERO, ZERO, src.disp)
            return True

        # --- two-operand ALU ---
        stem = stem_of(m, _ALU2, _SHIFTS) or m
        if m in _ALU2 or stem in _ALU2:
            opcode = _ALU2.get(m, _ALU2.get(stem))
            rws = [abs(o.width) for o in ops
                   if o.kind == "reg" and o.reg >= 0 and o.width]
            sfx = m[-1] if m not in _ALU2 else ""   # "subb" → 'b'; "sub" → ""
            sub_w = 0
            if sfx == "b" or (rws and min(rws) == 8):
                sub_w = 1
            elif sfx == "w" or (rws and min(rws) == 16):
                sub_w = 2
            if sub_w and len(ops) == 2:
                if any(o.kind == "reg" and o.reg >= 0 and o.width < 0
                       for o in ops):
                    return False              # %ah-family
                return self._subword_alu(opcode, ops[0], ops[1], pc, regs,
                                         sub_w)
            if len(ops) == 3 and m.startswith("imul"):
                # imul $imm, src, dst
                immv, src, dst = ops
                if immv.kind != "imm" or src.kind != "reg" or src.reg < 0 \
                        or dst.kind != "reg" or dst.reg < 0:
                    return False
                c = self._const(immv.imm, T1)
                self._emit(U.MUL, dst.reg, src.reg, c)
                self.flags_src = ("res", dst.reg)
                return True
            if len(ops) != 2:
                return False
            src, dst = ops
            if dst.kind == "reg" and dst.reg >= 0:
                if src.kind == "imm":
                    imm_map = {U.ADD: U.ADDI, U.AND: U.ANDI, U.OR: U.ORI,
                               U.XOR: U.XORI}
                    if opcode in imm_map:
                        self._emit(imm_map[opcode], dst.reg, dst.reg, ZERO,
                                   src.imm)
                    elif opcode == U.SUB:
                        self._emit(U.ADDI, dst.reg, dst.reg, ZERO,
                                   (-src.imm) & M32)
                    else:
                        c = self._const(src.imm, T1)
                        self._emit(opcode, dst.reg, dst.reg, c)
                elif src.kind == "reg" and src.reg >= 0:
                    if (opcode == U.MUL
                            and self.FP_BASE is not None
                            and any(abs(o.width) == 64 for o in ops
                                    if o.kind == "reg")
                            and int(regs[dst.reg]) <= M32
                            and int(regs[src.reg]) <= M32):
                        # 64-bit imul whose true operands fit u32: also
                        # stash the high product half — the adjacent
                        # `shr $c, reg` (c >= 32) of the divide-by-
                        # constant idiom consumes it (peephole below)
                        self._emit(U.MULHU, HSH, dst.reg, src.reg)
                        self._hi_shadow = (dst.reg, i)
                    self._emit(opcode, dst.reg, dst.reg, src.reg)
                elif src.kind == "mem":
                    if self._mem_width(inst, src) < 4:
                        return False
                    a = self._addr_uops(src, pc, T0)
                    if a is None:
                        return False
                    self._emit(U.LOAD, T1, a[0], ZERO, a[1])
                    self._emit(opcode, dst.reg, dst.reg, T1)
                else:
                    return False
                self.flags_src = ("res", dst.reg)
                return True
            if dst.kind == "mem":                 # RMW on memory
                if self._mem_width(inst, dst) < 4:
                    return False
                a = self._addr_uops(dst, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T1, a[0], ZERO, a[1])
                if src.kind == "imm":
                    c = self._const(src.imm, T2)
                    self._emit(opcode, T1, T1, c)
                elif src.kind == "reg" and src.reg >= 0:
                    self._emit(opcode, T1, T1, src.reg)
                else:
                    return False
                self._emit(U.STORE, 0, a[0], T1, a[1])
                self.flags_src = ("res", T1)
                return True
            return False

        # --- shifts ---
        if stem in _SHIFTS or m in _SHIFTS:
            opcode = _SHIFTS.get(m, _SHIFTS.get(stem))
            if len(ops) == 1:                     # implicit shift by 1
                ops = [Operand("imm", imm=1)] + ops
            if len(ops) != 2:
                return False
            src, dst = ops
            if dst.kind != "reg" or dst.reg < 0:
                return False
            if src.kind == "imm" and src.imm >= 32 and opcode == U.SRL \
                    and self._hi_shadow == (dst.reg, i - 1):
                # wide shift of the imul-peephole product: the result is
                # the HIGH half shifted by c-32 (true when the quotient
                # fits u32 — the self-check verifies exactly that)
                c = self._const((src.imm - 32) & 31, T1)
                self._emit(U.SRL, dst.reg, HSH, c)
                self.flags_src = ("res", dst.reg)
                return True
            if src.kind == "imm":
                c = self._const(src.imm & 31, T1)
                self._emit(opcode, dst.reg, dst.reg, c)
            elif src.kind == "reg" and src.reg == 1:   # %cl
                self._emit(opcode, dst.reg, dst.reg, 1)
            else:
                return False
            self.flags_src = ("res", dst.reg)
            return True

        # --- inc/dec/neg/not ---
        if m in ("inc", "incl", "incq"):
            d = ops[0]
            if d.kind != "reg" or d.reg < 0:
                return False
            self._emit(U.ADDI, d.reg, d.reg, ZERO, 1)
            self.flags_src = ("res", d.reg)
            return True
        if m in ("dec", "decl", "decq"):
            d = ops[0]
            if d.kind != "reg" or d.reg < 0:
                return False
            self._emit(U.ADDI, d.reg, d.reg, ZERO, M32)
            self.flags_src = ("res", d.reg)
            return True
        if m in ("neg", "negl", "negq"):
            d = ops[0]
            if d.kind != "reg" or d.reg < 0:
                return False
            self._emit(U.SUB, d.reg, ZERO, d.reg)
            self.flags_src = ("res", d.reg)
            return True
        if m in ("not", "notl", "notq"):
            d = ops[0]
            if d.kind != "reg" or d.reg < 0:
                return False
            self._emit(U.XORI, d.reg, d.reg, ZERO, M32)
            return True

        # --- cmp/test: record the flag source for the following jcc ---
        if m.startswith("cmp"):
            if len(ops) != 2:
                return False
            src, dst = ops                        # flags of dst - src
            breg = None
            if src.kind == "imm":
                breg = self._const(src.imm, TCMP)
            elif src.kind == "reg" and src.reg >= 0:
                breg = src.reg
            areg = None
            if dst.kind == "reg" and dst.reg >= 0:
                areg = dst.reg
            elif dst.kind == "mem" and self._mem_width(inst, dst) >= 4:
                a = self._addr_uops(dst, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T2, a[0], ZERO, a[1])
                areg = T2
            if areg is None or breg is None:
                return False
            self.flags_src = ("cmp", areg, breg)
            return True
        if m.startswith("test"):
            if len(ops) != 2:
                return False
            if any(o.kind == "reg" and o.reg >= 0 and o.width < 0
                   for o in ops):
                return False                      # %ah-family
            a, b = ops
            widths = [abs(o.width) // 8 for o in ops
                      if o.kind == "reg" and o.reg >= 0 and o.width]
            w = min(widths) if widths else 4
            if w < 4:
                # objdump spells sub-word tests either "testb $1,…" or
                # plain "test $1,%sil" — route both through the sub-word
                # handling (mask, then sign-extend so SF is faithful)
                msk = 0xFF if w == 1 else 0xFFFF
                if a.kind == "imm" and b.kind == "reg" and b.reg >= 0:
                    self._emit(U.ANDI, T2, b.reg, ZERO, a.imm & msk)
                elif a.kind == "reg" and a.reg >= 0 \
                        and b.kind == "reg" and b.reg >= 0:
                    self._emit(U.AND, T2, a.reg, b.reg)
                    self._emit(U.ANDI, T2, T2, ZERO, msk)
                else:
                    return False
                self._extend_reg(T2, w, True, T2)
                self.flags_src = ("res", T2)
                return True
            if a.kind == "imm" and b.kind == "reg" and b.reg >= 0:
                self._emit(U.ANDI, T2, b.reg, ZERO, a.imm & M32)
                self.flags_src = ("res", T2)
                return True
            if any(o.kind != "reg" or o.reg < 0 for o in ops):
                return False
            if a.reg == b.reg:
                self.flags_src = ("res", a.reg)
            else:
                self._emit(U.AND, T2, a.reg, b.reg)
                self.flags_src = ("res", T2)
            return True

        # --- stack ops ---
        if m in ("push", "pushq"):
            s = ops[0]
            if s.kind != "reg" or s.reg < 0:
                return False
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            self._emit(U.ADDI, 4, 4, ZERO, (-8) & M32)       # rsp -= 8
            self._emit(U.STORE, 0, 4, s.reg, delta)
            return True
        if m in ("pop", "popq"):
            d = ops[0]
            if d.kind != "reg" or d.reg < 0:
                return False
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            self._emit(U.LOAD, d.reg, 4, ZERO, delta)
            self._emit(U.ADDI, 4, 4, ZERO, 8)
            return True
        if m in ("call", "callq"):
            # direct or indirect: the only architectural effects are the
            # return-address push and rip (which follows the captured
            # stream); an indirect target read has no register effect, so
            # both forms lift identically — demoting indirect calls would
            # drop the push and desynchronize the later ret's stack slot
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            ra = self._const((pc + inst.length) & M32, T1)
            self._emit(U.ADDI, 4, 4, ZERO, (-8) & M32)
            self._emit(U.STORE, 0, 4, ra, delta)
            return True
        if m in ("ret", "retq"):
            cl = self.pc_cluster.get(pc)
            if cl is None:
                return False
            delta = self._remap_const(cl)
            # golden-sim guard: the stack slot must hold the captured
            # return target (it won't when the RA was pushed by an op that
            # demoted to opaque, whose memory effects are unrecoverable) —
            # else the integrity branch below would diverge on the golden
            # replay itself
            addr = (int(self.reg[4]) + delta) & M32
            if (addr & 3) or (addr >> 2) >= self.mem_words or \
                    int(self.mem[addr >> 2]) != (next_pc & M32):
                return False
            self._emit(U.LOAD, T1, 4, ZERO, delta)
            self._emit(U.ADDI, 4, 4, ZERO, 8)
            # return-address integrity check: corrupting the stack slot is a
            # control-flow divergence (the captured stream went to next_pc)
            ra = self._const(next_pc & M32, T2)
            self._emit(U.BEQ, 0, T1, T2, taken=1)
            self.stats.branches += 1
            self.stats.branches_lifted += 1
            return True

        # --- unconditional jump: control flow follows the stream (indirect
        # targets included — the captured next_pc is the truth either way,
        # and a jmp has no register or memory effect to model) ---
        if m in ("jmp", "jmpq"):
            return True

        # --- conditional branches ---
        if m in _JCC_SIGNED or m in _JCC_UNSIGNED:
            self.stats.branches += 1
            taken = 1 if next_pc != (pc + inst.length) else 0
            ok = self._lift_jcc(m, taken)
            if ok:
                self.stats.branches_lifted += 1
            else:
                self.stats.branches_dropped += 1
            return True                           # never demote to opaque
        if m.startswith("j"):
            self.stats.branches += 1
            self.stats.branches_dropped += 1
            return True

        if m in ("cltd", "cdq"):
            # edx = sign-fill of eax: SRA by 31 (cdq sets no flags, so T6)
            c31 = self._const(31, T6)
            self._emit(U.SRA, 2, 0, c31)
            return True

        # --- 32-bit division: edx:eax / src → eax=quot, edx=rem.  The
        # 32-bit projection computes eax/src directly; the edx:eax
        # precondition (cltd sign-fill / xor-zeroed) is validated by the
        # register self-check — a genuinely 64-bit dividend demotes. ---
        if m in ("idiv", "idivl", "div", "divl"):
            if len(ops) != 1:
                return False
            o = ops[0]
            signed = m.startswith("i")
            if o.kind == "reg" and o.reg >= 0 and abs(o.width) == 32:
                breg = o.reg
            elif o.kind == "mem" and self._mem_width(inst, o) >= 4 \
                    and not m.endswith(("q",)):
                a = self._addr_uops(o, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, T6, a[0], ZERO, a[1])
                breg = T6
            else:
                return False
            q_op, r_op = (U.DIV, U.REM) if signed else (U.DIVU, U.REMU)
            self._emit(r_op, T5, 0, breg)      # remainder from original rax
            self._emit(q_op, 0, 0, breg)       # rax = quotient
            self._emit(U.ADD, 2, T5, ZERO)     # rdx = remainder
            return True

        if m in ("nop", "nopw", "nopl", "endbr64", "cqo", "cqto"):
            # cqo writes rdx from rax bit 63 — outside the 32-bit
            # projection: demote unless rdx happens to match (self-check);
            # nops are free
            return m.startswith(("nop", "endbr"))

        return False

    # -- scalar-SSE float lift (VERDICT r3 #6) ---------------------------
    #
    # The FP bank is phys FX0+k = xmm{k}'s low 32 bits; arithmetic maps
    # 1:1 onto the FADD/FSUB/FMUL/FDIV µops (f32, FTZ, canonical NaN —
    # isa/uops.py), so an FP-bank REGFILE fault propagates through real
    # float dataflow on the device.  comiss/min/max use the monotone
    # integer-key trick: key = bits ^ (sra(bits,31) | 0x80000000) maps
    # IEEE-754 order onto unsigned integer order, so the existing SLTU
    # branch machinery consumes float compares unchanged (±0 and NaN
    # edge cases self-check at lift time and demote).

    def _fx(self, o: Operand) -> "int | None":
        if o.kind == "xmm" and 0 <= o.reg < 16 and abs(o.width) <= 128:
            return self.FP_BASE + o.reg
        return None

    def _fp_key(self, src_reg: int, dst_reg: int, tmp: int) -> int:
        """Monotone integer key of an f32 bit pattern → dst_reg."""
        self._emit(U.ADDI, tmp, ZERO, ZERO, 31)
        self._emit(U.SRA, dst_reg, src_reg, tmp)
        self._emit(U.ORI, dst_reg, dst_reg, ZERO, 0x80000000)
        self._emit(U.XOR, dst_reg, src_reg, dst_reg)
        return dst_reg

    def _fp_operand(self, o: Operand, pc: int, tmp: int) -> "int | None":
        """Register holding the f32 operand's bits (xmm lane or a loaded
        memory word)."""
        fx = self._fx(o)
        if fx is not None:
            return fx
        if o.kind == "mem":
            a = self._addr_uops(o, pc, T0)
            if a is None:
                return None
            self._emit(U.LOAD, tmp, a[0], ZERO, a[1])
            return tmp
        return None

    def _lift_fp(self, m: str, ops: list, pc: int,
                 regs: np.ndarray) -> bool:
        alu = {"addss": U.FADD, "subss": U.FSUB,
               "mulss": U.FMUL, "divss": U.FDIV}
        if m in alu and len(ops) == 2:
            src, dst = ops
            d = self._fx(dst)
            if d is None:
                return False
            a = self._fp_operand(src, pc, FT0)
            if a is None:
                return False
            self._emit(alu[m], d, d, a)
            return True
        if m in ("movss", "movaps", "movapd", "movups", "movdqa",
                 "movdqu", "movd") and len(ops) == 2:
            src, dst = ops
            sfx, dfx = self._fx(src), self._fx(dst)
            if sfx is not None and dfx is not None:
                self._emit(U.ADD, dfx, sfx, ZERO)        # bit copy (lane 0)
                return True
            if dfx is not None and src.kind == "mem":
                a = self._addr_uops(src, pc, T0)
                if a is None:
                    return False
                self._emit(U.LOAD, dfx, a[0], ZERO, a[1])
                return True
            if sfx is not None and dst.kind == "mem" and m == "movss":
                a = self._addr_uops(dst, pc, T0)
                if a is None:
                    return False
                self._emit(U.STORE, 0, a[0], sfx, a[1])
                return True
            # movd xmm↔GPR: the int/float boundary (bit-pattern move) —
            # severing it would erase FP-bank corruption exactly at the
            # program-output conversion
            if m == "movd":
                if sfx is not None and dst.kind == "reg" and dst.reg >= 0 \
                        and abs(dst.width) == 32:
                    self._emit(U.ADD, dst.reg, sfx, ZERO)
                    return True
                if dfx is not None and src.kind == "reg" and src.reg >= 0 \
                        and abs(src.width) == 32:
                    self._emit(U.ADD, dfx, src.reg, ZERO)
                    return True
            return False
        if m in ("pxor", "xorps", "xorpd") and len(ops) == 2:
            sfx, dfx = self._fx(ops[0]), self._fx(ops[1])
            if sfx is None or dfx is None:
                return False
            if sfx == dfx:
                self._emit(U.LUI, dfx, ZERO, ZERO, 0)    # zeroing idiom
            else:
                self._emit(U.XOR, dfx, dfx, sfx)
            return True
        if m in ("maxss", "minss") and len(ops) == 2:
            src, dst = ops
            d = self._fx(dst)
            if d is None:
                return False
            a = self._fp_operand(src, pc, FT0)
            if a is None:
                return False
            ka = self._fp_key(a, FT1, T6)
            kd = self._fp_key(d, T7, T6)
            # cond = (key_src > key_dst) for maxss, (key_src < key_dst)
            # for minss; x86 picks the SOURCE when the condition holds
            if m == "maxss":
                self._emit(U.SLTU, T6, kd, ka)
            else:
                self._emit(U.SLTU, T6, ka, kd)
            # branchless select: d ^= (d ^ a) & (-cond)
            self._emit(U.XOR, T7, d, a)
            self._emit(U.SUB, T6, ZERO, T6)
            self._emit(U.AND, T7, T7, T6)
            self._emit(U.XOR, d, d, T7)
            return True
        if m in ("comiss", "ucomiss") and len(ops) == 2:
            src, dst = ops                        # flags of dst ? src
            a = self._fp_operand(dst, pc, FT0)
            b = self._fp_operand(src, pc, FT1)
            if a is None or b is None or a == b:
                return False
            ka = self._fp_key(a, T1, T6)
            kb = self._fp_key(b, TCMP, T6)
            self.flags_src = ("fcmp", ka, kb)
            return True
        return False

    def _branch_cond(self, kind: str, a: int, b: int) -> tuple | None:
        """(opcode, src1, src2, extra_uops_emitted) for a signed cond."""
        table = {"eq": (U.BEQ, a, b), "ne": (U.BNE, a, b),
                 "lt": (U.BLT, a, b), "ge": (U.BGE, a, b),
                 "swap_lt": (U.BLT, b, a), "swap_ge": (U.BGE, b, a)}
        return table.get(kind)

    def _lift_jcc(self, m: str, taken: int) -> bool:
        if self.flags_src is None:
            return False
        kind = self.flags_src[0]
        if kind == "fcmp":
            # float keys order like unsigned ints: only the unordered-
            # style consumers compilers emit after comiss are valid
            if m in _JCC_SIGNED and _JCC_SIGNED[m][0] not in ("eq", "ne"):
                return False
            kind = "cmp"
        if kind in ("cmp", "cmpb"):
            _, a, b = self.flags_src
        else:                                     # result vs zero
            a, b = self.flags_src[1], ZERO
        if m in _JCC_SIGNED:
            cond = _JCC_SIGNED[m][0]
            if cond == "sign":
                br = (U.BLT, a, ZERO) if kind == "res" else None
            elif cond == "nsign":
                br = (U.BGE, a, ZERO) if kind == "res" else None
            else:
                br = self._branch_cond(cond, a, b)
            if br is None:
                return False
            op, s1, s2 = br
            if not self._branch_selfcheck(op, s1, s2, taken):
                return False
            self._emit(op, 0, s1, s2, taken=taken)
            return True
        # unsigned via SLTU
        mode = _JCC_UNSIGNED[m]
        if mode is False:                         # jb: a < b
            self._emit(U.SLTU, T3, a, b)
            br = (U.BNE, T3, ZERO)
        elif mode is True:                        # jae: !(a < b)
            self._emit(U.SLTU, T3, a, b)
            br = (U.BEQ, T3, ZERO)
        elif mode == "swap_b":                    # ja: b < a
            self._emit(U.SLTU, T3, b, a)
            br = (U.BNE, T3, ZERO)
        else:                                     # jbe: !(b < a)
            self._emit(U.SLTU, T3, b, a)
            br = (U.BEQ, T3, ZERO)
        op, s1, s2 = br
        if not self._branch_selfcheck(op, s1, s2, taken):
            # roll back the SLTU we emitted
            self._rollback(len(self.opcode) - 1)
            return False
        self._emit(op, 0, s1, s2, taken=taken)
        return True

    def _branch_selfcheck(self, op: int, s1: int, s2: int,
                          taken: int) -> bool:
        """The lifted condition under the golden sim must equal the captured
        direction, or the golden replay itself would 'diverge'."""
        a = int(self.reg[s1]) & M32
        b = int(self.reg[s2]) & M32
        if op == U.BEQ:
            cond = a == b
        elif op == U.BNE:
            cond = a != b
        elif op == U.BLT:
            cond = self._s32(a) < self._s32(b)
        else:
            cond = self._s32(a) >= self._s32(b)
        return int(cond) == taken

    def _rollback(self, mark: int) -> None:
        del self.opcode[mark:]
        del self.dst[mark:]
        del self.src1[mark:]
        del self.src2[mark:]
        del self.imm[mark:]
        del self.taken[mark:]
        del self.mem_cluster[mark:]

    # -- datapath-width hooks (ingest/lift64.py overrides all four) --------

    @staticmethod
    def _xmm_lanes(row: np.ndarray) -> np.ndarray | None:
        """16 captured xmm low lanes from a full SHTRACE3 step row."""
        if row.shape[0] < 26:
            return None
        packed = row[18:26]
        out = np.empty(16, np.uint64)
        out[0::2] = packed & np.uint64(M32)
        out[1::2] = packed >> np.uint64(32)
        return out

    def _seed_regs(self, step0: np.ndarray) -> None:
        self.reg[:] = 0
        self.reg[:N_GPR] = step0[:N_GPR] & np.uint64(M32)
        lanes = self._xmm_lanes(step0)
        self._has_xmm = lanes is not None
        if self.FP_BASE is not None and lanes is not None:
            self.reg[self.FP_BASE:self.FP_BASE + 16] = lanes

    def _regs_match(self, next_full: np.ndarray) -> bool:
        """Post-macro-op self-check against the captured register file —
        the lift's correctness authority (full 64-bit in lift64).  With an
        SHTRACE3 capture the FP bank is held to the same standard: every
        xmm low lane must match, every macro-op."""
        if not (self.reg[:N_GPR] == (next_full[:N_GPR]
                                     & np.uint64(M32))).all():
            return False
        lanes = self._xmm_lanes(next_full)
        if self.FP_BASE is not None and lanes is not None:
            return bool(
                (self.reg[self.FP_BASE:self.FP_BASE + 16] == lanes).all())
        return True

    def _resync_regs(self, next_full: np.ndarray) -> None:
        """Opaque demotion: overwrite every mismatched register with its
        captured value.  Each emitted LUI's µop index is recorded — a
        fault whose struck register meets a resync before its next read
        is provably severed in replay while silicon keeps it, and the
        host-diff harness escalates exactly those coordinates to the
        whole-program emulator oracle (ingest/hostdiff.py)."""
        want = next_full[:N_GPR] & np.uint64(M32)
        changed = np.nonzero(self.reg[:N_GPR] != want)[0]
        for r in changed:
            self._emit_resync(int(r), int(want[r]))
        lanes = self._xmm_lanes(next_full)
        if self.FP_BASE is not None and lanes is not None:
            fb = self.FP_BASE
            for k in np.nonzero(self.reg[fb:fb + 16] != lanes)[0]:
                self._emit_resync(fb + int(k), int(lanes[k]))

    # x86-64 syscall convention: number in rax, args rdi/rsi/rdx/r10/r8/r9
    # (canonical encoding indices)
    _SYSCALL_READS = [0, 2, 6, 7, 8, 9, 10]
    # implicit register reads by mnemonic family (canonical indices:
    # rax=0 rcx=1 rdx=2 rsp=4 rbp=5 rsi=6 rdi=7) — operand lists don't
    # carry these (objdump prints 'rep movsb' with no operands)
    _IMPLICIT_READS = {
        "movs": [1, 6, 7], "stos": [0, 1, 7], "lods": [0, 1, 6],
        "scas": [0, 1, 7], "cmps": [1, 6, 7],
        "push": [4], "pop": [4], "call": [4], "ret": [4],
        "leave": [4, 5], "enter": [4, 5],
        "div": [0, 2], "idiv": [0, 2], "mul": [0, 2],
        # sign-extend family: Intel spellings AND the AT&T ones objdump
        # actually prints (cwtd=cwd, cltd=cdq, cqto=cqo) — the lifter's
        # own decode matches the AT&T forms
        "cwd": [0], "cdq": [0], "cqo": [0],
        "cwtd": [0], "cltd": [0], "cqto": [0],
    }

    def _demoted_read_set(self, inst: "Inst | None") -> list[int]:
        """Arch registers a demoted instruction READS on silicon: every
        reg operand (conservatively incl. the dest — AT&T RMW), every mem
        base/index, xmm regs as 16+k, plus implicit families (string ops
        read rsi/rdi/rcx with no operand list; push/pop read rsp; div
        reads rax/rdx).  Undecoded bytes return [-1] (wildcard)."""
        if inst is None:
            return [-1]
        parts = inst.mnemonic.split()
        m0 = parts[0]
        if m0 == "syscall":
            return list(self._SYSCALL_READS)
        reads: set[int] = set()
        # 'rep movsb' → family 'movs'; bare 'movsb'/'stosq' too; one-op
        # div/mul ('divq (%rax)') keyed by stem.  String families apply
        # only to the real string forms (no operands, or %ds:/%es:
        # segment-printed ones) — 'movsd'/'movslq' also strip to 'movs'
        # but are ordinary 2-operand moves.
        STRING_FAMS = ("movs", "stos", "lods", "scas", "cmps")
        stringish = (not inst.operands
                     or any(getattr(o, "seg", "") for o in inst.operands))
        for tok in parts[:2]:
            # strip at most ONE trailing size-suffix letter ('pushq',
            # 'stosb'); rstrip would eat into the mnemonic itself
            # ('call'→'ca', 'mul'→'mu', 'cwd'/'cdq'→'c') and orphan those
            # implicit-read entries
            stem = tok if tok in self._IMPLICIT_READS else (
                tok[:-1] if tok and tok[-1] in "bwldq" else tok)
            if stem in self._IMPLICIT_READS \
                    and (stem not in STRING_FAMS or stringish):
                reads.update(self._IMPLICIT_READS[stem])
        for o in inst.operands:
            if o.kind == "reg" and 0 <= o.reg < N_GPR:
                reads.add(int(o.reg))
            elif o.kind == "xmm" and 0 <= o.reg < 16:
                reads.add(16 + int(o.reg))
            if o.base >= 0:
                reads.add(int(o.base))
            if o.index >= 0:
                reads.add(int(o.index))
        return sorted(reads)

    def _emit_resync(self, phys: int, value: int) -> None:
        """A demotion-resync LUI, recorded for the severed-fault test —
        every resync emission MUST go through here (ingest/hostdiff.py
        _resync_severed depends on the record being complete)."""
        self.resync_uops.append(len(self.opcode))
        self._emit(U.LUI, phys, ZERO, ZERO, value & M32)

    def _final_reg_expect(self, vals: np.ndarray) -> list:
        return [int(x) for x in (vals[:N_GPR] & np.uint64(M32))]

    # -- main loop ----------------------------------------------------------

    def run(self) -> tuple[Trace, dict]:
        self.build_memory_map()
        steps = self.nt.steps
        n_macro = len(steps) - 1
        # initial register file: captured GPRs (width per mode), specials 0
        self._seed_regs(steps[0])
        init_reg = self.reg.astype(np.uint32).copy()
        init_mem = self.mem.copy()

        for i in range(n_macro):
            if self.max_uops and len(self.opcode) >= self.max_uops:
                n_macro = i
                break
            pc = int(steps[i][16])
            next_pc = int(steps[i + 1][16])
            next_full = steps[i + 1]
            next_regs = next_full[:N_GPR] & np.uint64(M32)
            inst = self.insts.get(pc)
            self.uop_start.append(len(self.opcode))
            self.stats.macro_ops += 1
            mark = len(self.opcode)
            reg_snap = self.reg.copy()
            mem_before = None
            flags_before = self.flags_src
            ok = False
            if inst is not None:
                mem_before = self.mem.copy()
                ok = self._lift_one(i, inst, steps[i], next_regs, next_pc)
                if ok:
                    ok = self._regs_match(next_full)
            if ok:
                self.stats.lifted += 1
            else:
                # opaque demotion: rollback, then resync every changed GPR
                self._rollback(mark)
                self.reg = reg_snap
                if mem_before is not None:
                    self.mem = mem_before
                self.flags_src = flags_before
                self._resync_regs(next_full)
                self.stats.opaque += 1
                if inst is None or inst.mnemonic == "syscall":
                    # unknown effects may include vector/k state
                    self._vec_reset()
                mn = inst.mnemonic if inst else f"@{pc:x}"
                self.stats.opaque_mnemonics[mn] = \
                    self.stats.opaque_mnemonics.get(mn, 0) + 1
                self.demoted_reads.append(
                    (i, self._demoted_read_set(inst)))

        self.stats.uops = len(self.opcode)
        if not self.opcode:                       # degenerate: empty window
            self._emit(U.NOP, 0, 0, 0)
        trace = Trace(
            opcode=np.asarray(self.opcode, dtype=np.int32),
            dst=np.asarray(self.dst, dtype=np.int32),
            src1=np.asarray(self.src1, dtype=np.int32),
            src2=np.asarray(self.src2, dtype=np.int32),
            imm=np.asarray(self.imm, dtype=np.uint32),
            taken=np.asarray(self.taken, dtype=np.int32),
            init_reg=init_reg,
            init_mem=init_mem,
        )
        trace.validate()
        meta = {
            "source": "nativetrace",
            "begin": self.nt.begin,
            "end": self.nt.end,
            "macro_ops": n_macro,
            "uop_start": [int(x) for x in self.uop_start],
            "final_reg_expect": self._final_reg_expect(steps[n_macro]),
            "clusters": [tuple(int(v) for v in c) for c in self.clusters],
            "mem_cluster": [int(x) for x in self.mem_cluster],
            "resync_uops": [int(x) for x in self.resync_uops],
            "demoted_reads": [(int(s), [int(r) for r in rs])
                              for s, rs in self.demoted_reads],
            "map_regions": self.map_regions(),
            "stats": self.stats.to_dict(),
            "nphys": int(self.reg.shape[0]),
            "fp_bank": self.FP_BASE,
            "arch_regs": GPR_NAMES_64,
        }
        return trace, meta


def lift(trace_path: str, binary: str, max_uops: int | None = None,
         nt: NativeTrace | None = None,
         insts: "dict[int, Inst] | None" = None) -> tuple[Trace, dict]:
    """nativetrace capture + binary → (Trace, metadata).

    ``nt``/``insts`` accept pre-parsed inputs so callers that also scan the
    raw capture (e.g. hostdiff's output-event pass) parse once."""
    if nt is None:
        nt = read_nativetrace(trace_path)
    if insts is None:
        insts = static_decode(binary)
    try:
        from shrewd_tpu_torch.ingest.emu import elf_regions
        elf_regs = elf_regions(binary)
    except Exception:  # noqa: BLE001 — crash model degrades, lift survives
        elf_regs = []
    return Lifter(nt, insts, max_uops=max_uops, elf_regs=elf_regs).run()
