"""Post-window liveness: the program-visible state at window end.

The host-silicon oracle (tools/hostsfi.cc) classifies a perturbed run by
*program output* — the reference's golden-stdout classification
(``gem5 tests/gem5/verifier.py:158`` MatchStdout).  The replay
kernel classifies at *window end* by comparing architectural state.  Window-
end state that the post-window code never reads (registers it overwrites or
ignores, memory it overwrites or never loads) cannot reach the output, so
counting its corruption as SDC over-reports AVF — the 25-point gap VERDICT
r2 measured.

This module computes, from a second nativetrace capture of the *post-window*
region (kernel_end → process exit), the first-access liveness of every GPR
and every replay-modeled memory word:

- register: LIVE if first post-window occurrence is a read (including use
  as an address base/index), DEAD if it is a full-width write;
- memory word: LIVE if read before written, DEAD if overwritten first or
  never touched.

Classification then compares only the live set — the exact analog of the
reference campaign's end-to-end program-outcome classification
(``gem5 x86_spec/x86-spec-cpu2017.py:403-436``) projected onto
the window boundary.

The analysis needs only static decode (objdump) + the captured per-step
register file for effective addresses; no semantic lifting, so it is robust
on libc code the lifter would demote to opaque.  Unknown instructions are
handled conservatively (their operands count as reads).
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.ingest.lift import (M32, N_GPR, NativeTrace, Inst, Operand,
                                    read_nativetrace, static_decode)

# canonical encoding order (tools/ptrace_common.h / lift.GPR_NAMES_64):
# rax rcx rdx rbx rsp rbp rsi rdi r8..r15
RAX, RCX, RDX, RBX, RSP, RBP, RSI, RDI = range(8)
R8, R9, R10, R11, R12, R13, R14, R15 = range(8, 16)

# Linux x86-64 syscall ABI: number in rax, args rdi rsi rdx r10 r8 r9
_SYSCALL_ARG_REGS = (RDI, RSI, RDX, R10, R8, R9)
_SYS_WRITE, _SYS_EXIT, _SYS_EXIT_GROUP = 1, 60, 231

_UNKNOWN, _LIVE, _DEAD = 0, 1, 2

# mnemonic stems whose last (AT&T) operand is write-only at full width
# (string-op mnemonics like the exact "movsb" are dispatched before stem
# matching — only the ≥6-char sign-extending movsbl/movswq forms reach here)
_MOV_STEMS = {"mov", "movabs", "movzb", "movzw", "movzx", "movsb", "movsw",
              "movsl", "movsx", "movsxd", "lea", "set", "cmov"}
# read-modify-write stems (last operand read and written)
_RMW_STEMS = {"add", "sub", "and", "or", "xor", "adc", "sbb", "imul", "mul",
              "shl", "sal", "shr", "sar", "rol", "ror", "rcl", "rcr",
              "inc", "dec", "neg", "not", "bts", "btr", "btc", "xadd"}
# read-only stems (flags only / no architectural write)
_RO_STEMS = {"cmp", "test", "bt", "nop", "prefetch"}
_BRANCH_STEMS = {"jmp", "je", "jne", "jb", "jae", "ja", "jbe", "jl", "jge",
                 "jg", "jle", "js", "jns", "jo", "jno", "jp", "jnp", "jc",
                 "jnc", "jrcxz", "loop"}
_STRING_EXACT = {p + s for p in ("movs", "stos", "lods", "scas", "cmps")
                 for s in ("", "b", "w", "l", "q")}


def _stem(mnemonic: str) -> str:
    m = mnemonic
    if m.startswith("lock"):
        m = m[4:].lstrip()
    for stems in (_RMW_STEMS, _RO_STEMS, _BRANCH_STEMS, _MOV_STEMS):
        for s in sorted(stems, key=len, reverse=True):
            if m.startswith(s):
                return s
    return m.rstrip("bwlq")


class Access(NamedTuple):
    reg_reads: tuple
    reg_writes: tuple           # full-width (zero/64-bit) writes only
    mem_reads: tuple            # ((addr, nbytes), ...)
    mem_writes: tuple
    stop: bool                  # process exit reached
    unknown: bool


def _ea(op: Operand, regs: np.ndarray) -> int | None:
    if op.base in (-3, -4, -5) or op.seg:
        return None
    if op.rip_rel:
        return op.disp
    ea = op.disp
    if op.base >= 0:
        ea += int(regs[op.base])
    if op.index >= 0:
        ea += int(regs[op.index]) * op.scale
    return ea & 0xFFFFFFFFFFFFFFFF


_SIMD_WIDTHS = (("vmovdq", 32), ("vmovap", 32), ("vmovup", 32),
                ("vlddqu", 32),
                ("movdq", 16), ("movap", 16), ("movup", 16), ("lddqu", 16),
                ("movlp", 8), ("movhp", 8))


def _mem_width(inst: Inst) -> int:
    # SIMD moves carry xmm/ymm operands (reg=-2, width unknown); size them
    # by mnemonic so a 16/32-byte access doesn't get recorded as ≤8 bytes
    # (an under-sized DEAD marking could hide host-visible SDC)
    for pfx, w in _SIMD_WIDTHS:
        if inst.mnemonic.startswith(pfx) and w:
            return w
    for o in inst.operands:
        if o.kind == "reg" and o.reg >= 0:
            return max(1, abs(o.width) // 8)
    sfx = inst.mnemonic[-1]
    return {"b": 1, "w": 2, "l": 4, "q": 8}.get(sfx, 8)


def classify_access(inst: Inst, regs: np.ndarray) -> Access:
    """Read/write sets of one dynamic instruction (conservative)."""
    mnem = inst.mnemonic
    stem = _stem(mnem)
    ops = inst.operands
    rr: list[int] = []
    rw: list[int] = []
    mr: list[tuple] = []
    mw: list[tuple] = []

    def addr_regs(o: Operand) -> None:
        if o.base >= 0:
            rr.append(o.base)
        if o.index >= 0:
            rr.append(o.index)

    def read_op(o: Operand, width: int) -> None:
        if o.kind == "reg" and o.reg >= 0:
            rr.append(o.reg)
        elif o.kind == "mem":
            addr_regs(o)
            a = _ea(o, regs)
            if a is not None:
                mr.append((a, width))

    def write_op(o: Operand, width: int) -> None:
        if o.kind == "reg" and o.reg >= 0:
            # 8/16-bit destinations merge into the old value (a read);
            # 32-bit zero-extends and 64-bit overwrites → full write
            if 0 < abs(o.width) < 32:
                rr.append(o.reg)
            rw.append(o.reg)
        elif o.kind == "mem":
            addr_regs(o)
            a = _ea(o, regs)
            if a is not None:
                mw.append((a, width))

    w = _mem_width(inst)

    if mnem.startswith(("rep", "repz", "repe", "repnz", "repne")):
        # objdump tokenizes "rep movsq %ds:(%rsi),%es:(%rdi)" with "rep" as
        # the mnemonic, so the element size is unrecoverable here.  Treat
        # BOTH ranges as reads (LIVE) — never as writes: with unknown
        # element size and direction a mis-sized DEAD marking could hide a
        # host-visible SDC, and over-live only over-reports.
        count = int(regs[RCX])
        if count == 0:
            return Access((RCX,), (RCX,), (), (), False, False)
        span = min(count, 1 << 22) * 8
        df_down = bool(int(regs[17]) & (1 << 10)) if len(regs) > 17 else False
        def rrng(base_reg):
            start = int(regs[base_reg])
            return (start - span + 8, span) if df_down else (start, span)
        return Access((RCX, RSI, RDI, RAX), (RCX, RSI, RDI),
                      (rrng(RSI), rrng(RDI)), (), False, False)
    if mnem in _STRING_EXACT:
        esz = {"b": 1, "w": 2, "l": 4, "q": 8}.get(mnem[-1], 8)
        kind = mnem[:4]
        # DF affects the post-access pointer update, not the address of
        # this element's access — the accessed range starts at the pointer
        def srng(base_reg):
            return (int(regs[base_reg]), esz)
        if kind in ("movs", "lods", "cmps"):
            rr.append(RSI)
            mr.append(srng(RSI))
        if kind in ("movs", "stos"):
            rr.append(RDI)
            mw.append(srng(RDI))
            if kind == "stos":
                rr.append(RAX)
        if kind in ("cmps", "scas"):
            rr.append(RDI)
            mr.append(srng(RDI))
            if kind == "scas":
                rr.append(RAX)
        rw.extend([RSI, RDI])
        if kind == "lods":
            rw.append(RAX)
        return Access(tuple(rr), tuple(rw), tuple(mr), tuple(mw), False, False)

    if stem == "syscall" or mnem == "syscall":
        nr = int(regs[RAX])
        rr.append(RAX)
        rr.extend(_SYSCALL_ARG_REGS)
        if nr == _SYS_WRITE:
            mr.append((int(regs[RSI]), int(regs[RDX])))
        stop = nr in (_SYS_EXIT, _SYS_EXIT_GROUP)
        return Access(tuple(rr), (RAX, RCX, R11), tuple(mr), (), stop, False)

    if stem in ("push",):
        for o in ops:
            read_op(o, 8)
        rr.append(RSP)
        mw.append((int(regs[RSP]) - 8, 8))
        return Access(tuple(rr), (RSP,), tuple(mr), tuple(mw), False, False)
    if stem in ("pop",):
        rr.append(RSP)
        mr.append((int(regs[RSP]), 8))
        for o in ops:
            write_op(o, 8)
        rw.append(RSP)
        return Access(tuple(rr), tuple(rw), tuple(mr), tuple(mw), False, False)
    if stem.startswith("call"):
        for o in ops:
            if o.kind == "reg":
                read_op(o, 8)
            elif o.kind == "mem":
                addr_regs(o)
                a = _ea(o, regs)
                if a is not None:
                    mr.append((a, 8))
        rr.append(RSP)
        mw.append((int(regs[RSP]) - 8, 8))
        return Access(tuple(rr), (RSP,), tuple(mr), tuple(mw), False, False)
    if stem.startswith("ret"):
        rr.append(RSP)
        mr.append((int(regs[RSP]), 8))
        return Access(tuple(rr), (RSP,), tuple(mr), (), False, False)
    if stem == "leave":
        rr.append(RBP)
        mr.append((int(regs[RBP]), 8))
        return Access((RBP,), (RSP, RBP), tuple(mr), (), False, False)
    if stem in _BRANCH_STEMS:
        for o in ops:
            if o.kind == "reg":
                read_op(o, 8)
            elif o.kind == "mem":
                addr_regs(o)
                a = _ea(o, regs)
                if a is not None:
                    mr.append((a, 8))
        return Access(tuple(rr), (), tuple(mr), (), False, False)
    if stem == "lea":
        # address computation only — the mem operand is NOT accessed
        for o in ops[:-1]:
            if o.kind == "mem":
                addr_regs(o)
            elif o.kind == "reg":
                read_op(o, w)
        if ops and ops[-1].kind == "reg":
            write_op(ops[-1], w)
        return Access(tuple(rr), tuple(rw), (), (), False, False)
    if stem in _RO_STEMS:
        for o in ops:
            read_op(o, w)
        return Access(tuple(rr), (), tuple(mr), (), False, False)
    if stem in _MOV_STEMS:
        for o in ops[:-1]:
            read_op(o, w)
        if ops:
            if stem == "cmov":          # may leave dst unchanged → read too
                read_op(ops[-1], w)
            write_op(ops[-1], w)
        return Access(tuple(rr), tuple(rw), tuple(mr), tuple(mw), False, False)
    if stem in _RMW_STEMS or stem in ("xchg",):
        for o in ops:
            read_op(o, w)
        if ops:
            write_op(ops[-1], w)
        if stem == "xchg" and len(ops) == 2:
            write_op(ops[0], w)
        if stem in ("mul", "imul") and len(ops) == 1:
            rr.append(RAX)
            rw.extend([RAX, RDX])
        return Access(tuple(rr), tuple(rw), tuple(mr), tuple(mw), False, False)
    if stem in ("div", "idiv"):
        for o in ops:
            read_op(o, w)
        rr.extend([RAX, RDX])
        return Access(tuple(rr), (RAX, RDX), tuple(mr), (), False, False)
    if stem in ("cdq", "cqo", "cltq", "cdqe", "cwtl", "cltd", "cqto"):
        return Access((RAX,), (RDX,) if stem in ("cdq", "cqo", "cltd",
                                                 "cqto") else (RAX,),
                      (), (), False, False)
    if stem in ("endbr64", "endbr32", "hlt", "ud2", "int3", "pause",
                "mfence", "lfence", "sfence", "cld", "std"):
        return Access((), (), (), (), False, False)
    if stem == "rdtsc":
        return Access((), (RAX, RDX), (), (), False, False)
    if stem == "cpuid":
        return Access((RAX, RCX), (RAX, RBX, RCX, RDX), (), (), False, False)

    # unknown: conservative — every operand both read and written
    for o in ops:
        read_op(o, w)
        write_op(o, w)
    return Access(tuple(rr), (), tuple(mr), tuple(mw), False, True)


class Liveness(NamedTuple):
    reg_live: np.ndarray        # bool[N_GPR] — read-before-write post-window
    mem_live32: set             # low-32 byte addresses (word-aligned) live
    steps: int
    truncated: bool             # hit max_steps before process exit
    unknown_insts: int

    def mem_word_mask(self, clusters, mem_words: int) -> np.ndarray:
        """Project live byte addresses onto the replay word array."""
        mask = np.zeros(mem_words, dtype=bool)
        for lo, hi, word_off in clusters:
            for a in self.mem_live32:
                if lo <= a < hi:
                    mask[word_off + (a - lo) // 4] = True
        return mask


def analyze(nt: NativeTrace, insts: dict[int, Inst],
            track32: "set | None" = None) -> Liveness:
    """First-access liveness over a post-window capture.

    ``track32``: optional set of low-32 word-aligned addresses to track
    (e.g. the replay clusters' footprint); accesses outside it are ignored,
    which keeps the scan cheap on libc-heavy exit paths."""
    reg_state = np.zeros(N_GPR, dtype=np.int8)
    mem_state: dict[int, int] = {}
    unknown = 0
    steps = nt.steps
    stopped = False

    def touch_mem(addr: int, nbytes: int, state: int) -> None:
        # A DEAD marking requires the word to be FULLY overwritten; a
        # sub-word write leaves live neighbor bytes in the word, so the
        # partially-covered head/tail words are marked LIVE instead
        # (over-live over-reports; a wrong DEAD hides real SDC).
        a0 = addr & ~0x3
        for a in range(a0, addr + nbytes, 4):
            a32 = a & M32
            if track32 is not None and a32 not in track32:
                continue
            if a32 not in mem_state:
                covered = addr <= a and (a + 4) <= (addr + nbytes)
                mem_state[a32] = state if (state == _LIVE or covered) \
                    else _LIVE

    n = len(steps)
    all_regs_live = False
    for i in range(n):
        regs = steps[i]
        pc = int(regs[16])
        inst = insts.get(pc)
        if inst is None:
            # code outside the static decode (vdso etc.): its register
            # reads are invisible, so later writes must not mark regs DEAD
            # — conservatively pin every still-unknown register LIVE once
            if not all_regs_live:
                reg_state[reg_state == _UNKNOWN] = _LIVE
                all_regs_live = True
            unknown += 1
            continue
        acc = classify_access(inst, regs)
        if acc.unknown:
            unknown += 1
        for r in acc.reg_reads:
            if 0 <= r < N_GPR and reg_state[r] == _UNKNOWN:
                reg_state[r] = _LIVE
        for a, nb in acc.mem_reads:
            touch_mem(a, nb, _LIVE)
        for a, nb in acc.mem_writes:
            touch_mem(a, nb, _DEAD)
        for r in acc.reg_writes:
            if 0 <= r < N_GPR and reg_state[r] == _UNKNOWN:
                reg_state[r] = _DEAD
        if acc.stop:
            stopped = True
            break

    live32 = {a for a, s in mem_state.items() if s == _LIVE}
    return Liveness(reg_live=reg_state == _LIVE, mem_live32=live32,
                    steps=n, truncated=not stopped and n > 0,
                    unknown_insts=unknown)


def capture_post_window(tracer: Path, workload: Path, end_sym_addr: int,
                        out_bin: Path, max_steps: int = 2_000_000) -> NativeTrace:
    """nativetrace from the kernel_end marker to process exit (end marker 0
    is never hit, so the tracer runs until the child exits — rc 1 with
    'child exited mid-window' is the expected clean outcome here)."""
    proc = subprocess.run(
        [str(tracer), str(out_bin), f"{end_sym_addr:x}", "0",
         str(max_steps), str(workload)],
        capture_output=True, text=True)
    if proc.returncode not in (0, 1) or not out_bin.exists():
        raise RuntimeError(f"post-window capture failed: {proc.stderr}")
    return read_nativetrace(out_bin)


def post_window_liveness(paths, clusters, build_dir: Path | None = None,
                         max_steps: int = 2_000_000,
                         allow_truncated: bool = False) -> Liveness:
    """Full pipeline: capture kernel_end→exit, decode, analyze.

    ``paths``: ingest.hostdiff.BuildPaths; ``clusters``: meta["clusters"]
    from the window lift ((lo, hi, word_off) triples).

    Raises on a truncated capture (max_steps hit before process exit)
    unless ``allow_truncated``: state the un-captured tail would have read
    stays UNKNOWN = treated dead, which silently under-reports SDC."""
    bd = build_dir or paths.workload.parent
    out_bin = bd / f"{paths.workload.name}_post.bin"
    nt = capture_post_window(paths.tracer, paths.workload, paths.end,
                             out_bin, max_steps)
    insts = static_decode(str(paths.workload))
    track = set()
    for lo, hi, _ in clusters:
        for a in range(lo & ~0x3, hi, 4):
            track.add(a)
    res = analyze(nt, insts, track32=track)
    if res.truncated and not allow_truncated:
        raise RuntimeError(
            f"post-window capture truncated at {res.steps} steps — raise "
            "max_steps (liveness from a truncated capture under-reports)")
    return res
