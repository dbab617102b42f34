"""Differential AVF: the replay kernel vs the real host CPU (hostsfi).

Port of ``shrewd_tpu/ingest/hostdiff.py``: the device column is the
port's dense replay, batched over every coordinate on one device.  It
closes the self-referentiality gap: the campaign's outcomes are compared
trial-by-trial against a ground truth that shares **no code** with the framework — the host x86 CPU itself, perturbed
through ptrace exactly the way the reference's SFI campaigns perturb a
simulated core through ``ThreadContext::setReg``
(``src/cpu/thread_context.hh:190-207``) and classified by program output
like the reference's golden-stdout verifiers (``tests/gem5/verifier.py``
MatchStdout).

Pairing: the SAME (step, reg, bit) coordinates drive both sides.  The host
flips bit *b* of GPR *r* after *step* dynamic instructions inside the
window; the replay kernel injects KIND_REGFILE at cycle ``uop_start[step]``,
entry *r*, bit *b* on the lifted trace (ingest/lift.py maps macro steps to
µop indices).

Classification-scope caveat (inherent to windowed SFI): the host classifies
at *program end*, the replay kernel at *window end*.  The replay side
therefore compares memory plus the ABI live-out registers only — rsp, rbp,
rbx, r12–r15 are the registers the post-window code may legally read
(callee-saved, SysV ABI); caller-saved registers are dead at the
kernel_end call boundary, so their window-end corruption must not count.
Agreement is reported both per-class and binarized (vulnerable vs masked),
with Wilson CIs on both AVFs.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
#: where the workloads and the ptrace tools are built (gitignored)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# SysV AMD64 callee-saved registers (+ the stack pointer) in the canonical
# encoding order of tools/ptrace_common.h — the ABI-live-out comparison set.
LIVE_OUT_REGS = (3, 4, 5, 12, 13, 14, 15)     # rbx, rsp, rbp, r12..r15

HOST_OUTCOME = {"masked": 0, "sdc": 1, "due": 2}


class BuildPaths(NamedTuple):
    workload: Path
    tracer: Path
    hostsfi: Path
    begin: int
    end: int


def _build(out: Path, cmd: list[str]) -> None:
    """mtime-idempotent compile: skip when the output is newer than every
    source in the command line.  The compiler writes a private file that
    is renamed into place, so processes building the same tool at once
    never run a half-written one."""
    src_mtimes = [Path(c).stat().st_mtime for c in cmd if
                  c.endswith((".c", ".cc"))]
    if out.exists() and all(out.stat().st_mtime >= m for m in src_mtimes):
        return
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(cmd + ["-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def build_tracer(build_dir: Path | None = None) -> Path:
    """Compile the ptrace capture tool alone (idempotent) — the entry
    the ingest pipeline uses for SUBMITTED binaries, which arrive as ELF
    bytes with no workload source to build."""
    bd = build_dir or BUILD_DIR
    bd.mkdir(parents=True, exist_ok=True)
    tracer = bd / "nativetrace"
    _build(tracer, ["g++", "-O2", "-std=c++17",
                    str(REPO / "tools" / "nativetrace.cc")])
    return tracer


def elf_markers(binary) -> tuple[int, int]:
    """``(kernel_begin, kernel_end)`` marker addresses via ``nm``.

    Raises ``ValueError`` when the file is not a parseable ELF or lacks
    the marker symbols — the ingest pipeline's unparseable-submission
    quarantine trigger, kept loud and typed so the capture stage can
    tell poison (quarantine) from environment trouble (retry)."""
    try:
        nm = subprocess.run(["nm", str(binary)], check=True,
                            capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ValueError(
            f"{binary}: not a parseable ELF ({detail.strip()})")
    syms = {p[2]: int(p[0], 16) for p in
            (ln.split() for ln in nm.splitlines()) if len(p) == 3}
    if "kernel_begin" not in syms or "kernel_end" not in syms:
        raise ValueError(
            f"{binary}: no kernel_begin/kernel_end marker symbols")
    return syms["kernel_begin"], syms["kernel_end"]


def build_tools(workload_c: str = "workloads/sort.c",
                build_dir: Path | None = None) -> BuildPaths:
    """Compile the guest workload and both ptrace tools (idempotent)."""
    bd = build_dir or BUILD_DIR
    bd.mkdir(parents=True, exist_ok=True)
    wl_src = REPO / workload_c
    wl = bd / wl_src.stem
    sfi = bd / "hostsfi"
    _build(wl, ["gcc", "-O1", "-static", "-fno-pie", "-no-pie", str(wl_src)])
    tracer = build_tracer(bd)
    _build(sfi, ["g++", "-O2", "-std=c++17",
                 str(REPO / "tools" / "hostsfi.cc")])
    begin, end = elf_markers(wl)
    return BuildPaths(wl, tracer, sfi, begin, end)


#: attempts at a capture whose tracee misses its end: on the card's host a
#: capture now and then stops short of its window's end or single-steps
#: to ``max_steps`` without reaching it, and the next one does not
CAPTURE_ATTEMPTS = 3


def run_tracer(run, cmd: list, complete) -> subprocess.CompletedProcess:
    """Run the ptrace capture tool ``cmd`` through ``run`` (the caller's
    ``subprocess.run``) until ``complete(proc)`` holds, at most
    ``CAPTURE_ATTEMPTS`` times; each attempt that falls short is reported
    on stderr with the tracer's own last words → the last attempt."""
    import sys

    for attempt in range(1, CAPTURE_ATTEMPTS + 1):
        proc = run(cmd, capture_output=True, text=True)
        if complete(proc):
            break
        print(f"capture of {Path(cmd[-1]).name}, attempt {attempt} of "
              f"{CAPTURE_ATTEMPTS}: rc {proc.returncode}, "
              f"{proc.stderr.strip()[-200:]!r}", file=sys.stderr, flush=True)
    return proc


def window_complete(proc) -> bool:
    """A begin-to-end capture that reached its end marker."""
    return proc.returncode == 0


def exit_complete(proc) -> bool:
    """A capture to the program's exit (end marker 0) whose tracee exited,
    rather than stepping to ``max_steps``."""
    return proc.returncode in (0, 1) and "child exited" in proc.stderr


def stuck(trace_bin, tail: int = 100) -> bool:
    """The capture's last ``tail`` records are one state over and over: a
    tracee that stopped advancing (every real step changes rip or a
    register, ``rep`` iterations included)."""
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    steps = read_nativetrace(trace_bin).steps
    return len(steps) > tail and bool((steps[-tail:] == steps[-1]).all())


def passes(trace_bin, pc: int) -> bool:
    """The capture holds a step at ``pc``."""
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    return bool((read_nativetrace(trace_bin).steps[:, 16]
                 == np.uint64(pc)).any())


def _capture(paths: BuildPaths, suffix: str, consume,
             build_dir: Path | None = None, max_steps: int = 2_000_000):
    """Run the ptrace capture tool into a temp file and hand the file to
    ``consume`` (deleted afterwards) — the one place that knows the tracer
    CLI contract."""
    bd = build_dir or BUILD_DIR
    trace_bin = bd / f"{paths.workload.name}_{suffix}.{os.getpid()}.bin"
    try:
        cmd = [str(paths.tracer), str(trace_bin), f"{paths.begin:x}",
               f"{paths.end:x}", str(max_steps), str(paths.workload)]
        proc = run_tracer(subprocess.run, cmd, window_complete)
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, cmd,
                                                proc.stdout, proc.stderr)
        return consume(trace_bin)
    finally:
        trace_bin.unlink(missing_ok=True)


def capture_and_lift(paths: BuildPaths, build_dir: Path | None = None,
                     max_steps: int = 2_000_000):
    from shrewd_tpu_torch.ingest.lift import lift
    return _capture(paths, "trace",
                    lambda p: lift(str(p), str(paths.workload)),
                    build_dir, max_steps)


def capture_window_macro_ops(paths: BuildPaths,
                             build_dir: Path | None = None,
                             max_steps: int = 2_000_000) -> int:
    """Marker-to-marker macro-op count from a raw capture — no lift.

    The emu64 mode replays the raw capture itself, so paying the full
    operand-parse + dataflow-lift + self-check pass of ``lift()`` just to
    learn the window length wasted the dominant share of its setup time."""
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    def count(p):
        # the trailing record is state-at-end, not an executed step (the
        # same convention lift() uses: n_macro = len(steps) - 1)
        return max(len(read_nativetrace(p).steps) - 1, 0)

    return _capture(paths, "win", count, build_dir, max_steps)


def capture_and_lift_to_output(paths: BuildPaths,
                               build_dir: Path | None = None,
                               max_steps: int = 2_000_000,
                               lifter=None):
    """Capture and lift the *extended* window: kernel_begin → process exit.

    The replay then runs through the workload's own output stage (checksum
    + write syscall + exit), so classification can compare exactly the
    program-visible bytes — the same quantity the host oracle hashes from
    stdout (tools/hostsfi.cc; reference: MatchStdout,
    gem5 tests/gem5/verifier.py:158).  Adds to meta:

    - ``window_macro_ops``: macro steps inside [kernel_begin, kernel_end)
      — the fault-injection window (hostsfi injects only there);
    - ``output_words``: replay-memory word indices covering every byte the
      program passes to write(2) on stdout, at syscall time;
    - ``output_syscalls``: count of stdout writes found.
    """
    from shrewd_tpu_torch.ingest.lift import (M32, lift, read_nativetrace,
                                        static_decode)
    bd = build_dir or BUILD_DIR
    trace_bin = bd / f"{paths.workload.name}_full.{os.getpid()}.bin"
    try:
        proc = run_tracer(
            subprocess.run,
            [str(paths.tracer), str(trace_bin), f"{paths.begin:x}", "0",
             str(max_steps), str(paths.workload)],
            lambda p: exit_complete(p) and passes(trace_bin, paths.end))
        # rc 1 ("child exited mid-window") is the clean outcome with end=0
        if proc.returncode not in (0, 1) or not trace_bin.exists():
            raise RuntimeError(f"full capture failed: {proc.stderr}")
        nt = read_nativetrace(trace_bin)
        insts = static_decode(str(paths.workload))
        trace, meta = (lifter or lift)(str(trace_bin), str(paths.workload),
                                       nt=nt, insts=insts)
    finally:
        trace_bin.unlink(missing_ok=True)
    # executed steps only — the trailing record is state-at-end, not a step
    steps = nt.steps[:-1] if len(nt.steps) else nt.steps
    ends = np.nonzero(steps[:, 16] == np.uint64(paths.end))[0]
    if len(ends) == 0:
        raise RuntimeError("kernel_end marker never reached in full "
                           f"capture ({proc.stderr.strip()[-200:]!r})")
    window_end = int(ends[0])
    out_events = []                      # (macro_step, rsi, rdx)
    cand = np.nonzero((steps[:, 0] == 1) & (steps[:, 7] == 1))[0]
    for i in cand:
        inst = insts.get(int(steps[i][16]))
        if inst is not None and inst.mnemonic == "syscall":
            out_events.append((int(i), int(steps[i][6]), int(steps[i][2])))

    def words_of(a: int, ln: int) -> dict:
        """Replay word index → byte mask for the written range [a, a+ln).
        Byte-granular: an unaligned head/tail must not drag the dead bytes
        sharing its word into the comparison.  Raises on bytes outside
        every replay cluster — dropping them would silently under-report
        SDC on exactly the bytes the host oracle hashes."""
        masks: dict[int, int] = {}
        for b in range(a, a + ln):
            b32 = b & M32
            waddr = b32 & ~0x3
            for lo, hi, word_off in meta["clusters"]:
                if lo <= waddr < hi:
                    w = word_off + (waddr - lo) // 4
                    masks[w] = masks.get(w, 0) | (0xFF << (8 * (b32 & 3)))
                    break
            else:
                raise RuntimeError(
                    f"output byte {b32:#x} not in any replay cluster — the "
                    "write(2) buffer was never touched by a lifted store")
        return masks

    # Each output event is compared AT ITS SYSCALL µOP, not at window end:
    # the exit path reuses the stack frames that held the output buffer, so
    # the bytes at trace end are unrelated to what the kernel wrote out
    # (pushes of fault-corrupted callee-saved registers were landing on the
    # dead buffer and reading back as false SDC).
    uop_start = meta["uop_start"]
    meta["output_events"] = []
    for m, a, ln in out_events:
        masks = words_of(a, ln)
        ws = sorted(masks)
        meta["output_events"].append(
            {"macro": m, "cut_uop": int(uop_start[m]), "words": ws,
             "byte_masks": [masks[w] for w in ws]})
    meta["window_macro_ops"] = window_end
    meta["output_words"] = sorted(
        {w for ev in meta["output_events"] for w in ev["words"]})
    meta["output_syscalls"] = len(out_events)
    return trace, meta


def sample_coords(n_trials: int, window: int, seed: int = 0,
                  bit_range: int = 32, n_regs: int = 16) -> np.ndarray:
    """(step, reg, bit) samples.  ``bit_range=32`` restricts to the low
    half (the replay's 32-bit projection); ``bit_range=64`` samples
    the full register, for the emu64 whole-program re-execution path."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, window, n_trials),
        rng.integers(0, n_regs, n_trials),
        rng.integers(0, bit_range, n_trials),
    ], axis=1).astype(np.int64)


def run_host(paths: BuildPaths, coords: np.ndarray,
             build_dir: Path | None = None) -> np.ndarray:
    """hostsfi over the coordinate list → outcome classes int32[n].

    Coordinate/result files are run-scoped (pid-suffixed): two concurrent
    campaigns sharing a build dir must not truncate each other's open
    results stream."""
    bd = build_dir or BUILD_DIR
    cpath = bd / f"coords.{os.getpid()}.txt"
    rpath = bd / f"host_results.{os.getpid()}.jsonl"
    try:
        np.savetxt(cpath, coords, fmt="%d")
        subprocess.run([str(paths.hostsfi), str(cpath), str(rpath),
                        f"{paths.begin:x}", f"{paths.end:x}",
                        str(paths.workload)],
                       check=True, capture_output=True, text=True)
        out = np.full(len(coords), -1, dtype=np.int32)
        with open(rpath) as f:
            for line in f:
                r = json.loads(line)
                out[r["trial"]] = HOST_OUTCOME[r["outcome"]]
        if (out < 0).any():
            raise RuntimeError("missing host trial results")
        return out
    finally:
        for p in (cpath, rpath):
            p.unlink(missing_ok=True)


def memmap_from_meta(meta: dict, cut: int | None = None, device=None):
    """``ops.replay.MemMap`` tensors on ``device`` (the card when None)
    from lift metadata, or None when the lift predates the VA crash model
    (no mem_cluster/map_regions)."""
    import torch

    from shrewd_tpu_torch.ops.replay import MemMap
    from shrewd_tpu_torch.utils.device import resolve

    mc = np.asarray(meta.get("mem_cluster", []), dtype=np.int64)
    regions = meta.get("map_regions") or []
    clusters = meta.get("clusters") or []
    if mc.size == 0 or not regions or not clusters:
        return None
    if cut is not None:
        mc = mc[:cut]
    cl = np.asarray(clusters, dtype=np.int64)          # (k, 3) lo, hi, off
    ld = [(lo, span) for lo, span, _w in regions]
    st = [(lo, span) for lo, span, w in regions if w] or [(0, 0)]
    # the low-32 projections of the JAX package's uint32 arrays
    ld_lo, ld_span = (np.asarray(x, dtype=np.uint64).astype(np.uint32)
                      for x in zip(*ld))
    st_lo, st_span = (np.asarray(x, dtype=np.uint64).astype(np.uint32)
                      for x in zip(*st))
    dev = resolve(device)

    def t(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=dev)

    return MemMap(
        uop_cluster=t(mc.astype(np.int32)),
        cl_lo=t(cl[:, 0].astype(np.uint32)),
        cl_span=t((cl[:, 1] - cl[:, 0]).astype(np.uint32)),
        cl_word_off=t(cl[:, 2].astype(np.int32)),
        ld_lo=t(ld_lo), ld_span=t(ld_span),
        st_lo=t(st_lo), st_span=t(st_span))


def _coords_to_phys(meta: dict, reg: np.ndarray,
                    bit: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The ONE coords→phys-register mapping (shared by fault construction
    and the severed test): 64-bit hi lanes at +32, xmm lanes at fp_bank."""
    if int(meta.get("width", 32)) == 64:
        return reg + 32 * (bit >= 32), bit % 32
    if meta.get("fp_bank") is not None:
        fb = int(meta["fp_bank"])
        return np.where(reg >= 16, fb + (reg - 16), reg), bit
    return reg, bit


def _demoted_exposed(trace, meta: dict, coords: np.ndarray) -> np.ndarray:
    """bool[n_coords]: faults in a register some LATER demoted instruction
    READS on silicon, while the fault is still live in the replay.  The
    replay never models a demoted instruction's register consumption —
    e.g. a demoted ymm load through a corrupted base pointer is silicon's
    crash channel but invisible to the replay (the r4 strmix due→masked
    cell) — so those coordinates escalate to the whole-program emulator
    oracle alongside the diverged set.  A replayed WRITE to the faulted
    phys lane before the demoted step kills the fault on both executors
    (the lift models partial-width writes), so such coords stay
    on-device."""
    from shrewd_tpu_torch.isa import uops as U

    dr = meta.get("demoted_reads") or []
    out = np.zeros(len(coords), dtype=bool)
    if not dr:
        return out
    uop_start = np.asarray(meta["uop_start"], dtype=np.int64)
    n = trace.n
    dst = np.asarray(trace.dst)
    opcode = np.asarray(trace.opcode)
    src1 = np.asarray(trace.src1)
    src2 = np.asarray(trace.src2)
    wd = np.asarray(U.writes_dest(opcode))
    u1 = np.asarray(U.uses_src1(opcode))
    u2 = np.asarray(U.uses_src2(opcode))
    step, reg, bit = coords.T
    phys, _ = _coords_to_phys(meta, reg, bit)
    # demoted steps per arch read-reg (sorted by construction)
    by_reg: dict[int, list[int]] = {}
    wild: list[int] = []
    for s, regs in dr:
        for r in regs:
            (wild if r == -1 else by_reg.setdefault(r, [])).append(s)
    merged: dict[int, np.ndarray] = {}      # arch reg → sorted demoted steps
    kills: dict[int, np.ndarray] = {}       # phys → killing-write µop idxs
    for i in range(len(coords)):
        a = int(reg[i])
        if a not in merged:
            merged[a] = np.asarray(sorted(by_reg.get(a, []) + wild),
                                   dtype=np.int64)
        dsteps = merged[a]
        pos = np.searchsorted(dsteps, int(step[i]))
        if pos >= len(dsteps):
            continue
        d_uop = uop_start[min(int(dsteps[pos]), len(uop_start) - 1)]
        # a killing write replaces the whole lane WITHOUT reading it — a
        # read-modify-write (sub-word merge) keeps the fault live in both
        # executors and must not suppress the escalation
        p = int(phys[i])
        if p not in kills:
            kills[p] = np.nonzero((dst == p) & wd
                                  & ~((src1 == p) & u1)
                                  & ~((src2 == p) & u2))[0]
        writes = kills[p]
        w = np.searchsorted(writes, uop_start[step[i]])
        first_write = writes[w] if w < writes.size else n
        out[i] = d_uop <= first_write
    return out


def _resync_severed(trace, meta: dict, coords: np.ndarray) -> np.ndarray:
    """bool[n_coords]: faults whose struck phys register's first touch at
    or after the landing cycle is a demotion-resync LUI — severed in the
    replay (the constant overwrites the flip) but alive on silicon."""
    from shrewd_tpu_torch.isa import uops as U

    resync = meta.get("resync_uops") or []
    if not resync:
        return np.zeros(len(coords), dtype=bool)
    n = trace.n
    opcode = np.asarray(trace.opcode)
    src1 = np.asarray(trace.src1)
    src2 = np.asarray(trace.src2)
    dst = np.asarray(trace.dst)
    u1 = np.asarray(U.uses_src1(opcode))
    u2 = np.asarray(U.uses_src2(opcode))
    wd = np.asarray(U.writes_dest(opcode))
    is_resync = np.zeros(n, dtype=bool)
    is_resync[np.asarray(resync, dtype=np.int64)] = True

    uop_start = np.asarray(meta["uop_start"], dtype=np.int64)
    step, reg, bit = coords.T
    reg, _ = _coords_to_phys(meta, reg, bit)
    out = np.zeros(len(coords), dtype=bool)
    for r in np.unique(reg):
        touch = np.nonzero(((src1 == r) & u1) | ((src2 == r) & u2)
                           | ((dst == r) & wd))[0]
        if touch.size == 0:
            continue
        sel = np.nonzero(reg == r)[0]
        pos = np.searchsorted(touch, uop_start[step[sel]], side="left")
        has = pos < touch.size
        first = touch[np.minimum(pos, touch.size - 1)]
        out[sel] = has & is_resync[first]
    return out


def coord_faults(meta: dict, coords: np.ndarray, device):
    """The REGFILE faults of ``coords`` (step, reg, bit) on ``device``:
    each lands at its macro-op's first µop, on the physical register the
    coordinate maps to (pair-lane hi lanes / FP bank — the same mapping
    ``_resync_severed`` uses)."""
    import torch

    from shrewd_tpu_torch.models.o3 import Fault, KIND_REGFILE

    uop_start = np.asarray(meta["uop_start"], dtype=np.int64)
    step, reg, bit = coords.T
    reg, bit = _coords_to_phys(meta, reg, bit)

    def i32(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    return Fault(
        kind=i32(np.full(len(coords), KIND_REGFILE)),
        cycle=i32(uop_start[step]), entry=i32(reg), bit=i32(bit),
        shadow_u=torch.ones(len(coords), dtype=torch.float32,
                            device=device))


def run_device(trace, meta: dict, coords: np.ndarray,
               liveness=None, paths: BuildPaths | None = None,
               resolve_diverged: bool = True,
               report: dict | None = None, device=None) -> np.ndarray:
    """The same trials on the replay kernel → outcome classes int32[n].

    Dense kernel, no shadow detection (the host has no shadow FUs), every
    coordinate one lane of one batched replay on ``device`` (the card
    when None; ``"cpu"`` for the CPU).  With a measured ``liveness``
    (ingest.liveness.Liveness from the post-window capture), comparison is
    restricted to the registers and memory words the post-window code
    actually reads before writing — the program-visible state.  Without
    one, falls back to the static ABI heuristic (callee-saved registers +
    all memory), which over-reports SDC for state that is dead at the
    output boundary."""
    import torch

    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.utils.device import resolve

    dev = resolve(device)
    # graftlint: allow-jit -- a memmap'd kernel keys by its memmap's
    # identity (kernel_fingerprint), so a registry entry would never be
    # shared; the differential run owns this one kernel
    k = TrialKernel(trace, O3Config(enable_shrewd=False), device=dev,
                    memmap=memmap_from_meta(meta, device=dev))
    faults = coord_faults(meta, coords, dev)

    if "output_events" in meta:
        # Extended-window ("output") mode — exact host-oracle semantics:
        #   SDC  ⇔ the bytes passed to write(2) differ AT SYSCALL TIME
        #          (truncated replay per output event; the exit path reuses
        #          the buffer's stack frames, so window-end state is dead),
        #          or the exit status (low 8 bits of rdi at exit_group)
        #          differs, or control flow diverged (conservative),
        #   DUE  ⇔ the replay trapped anywhere up to process exit.
        # One truncated TrialKernel per output event (the workload
        # contract is a single batched write(2)).  Only the flags and
        # rdi are kept of the full replay: each lane's memory image is
        # released before the truncated replays run.
        rfull = k._replay(faults)
        diverged = rfull.diverged.cpu().numpy()
        trapped = rfull.trapped.cpu().numpy()
        detected = rfull.detected.cpu().numpy()
        rdi = rfull.reg[:, 7].cpu().numpy()
        del rfull
        sdc = diverged.copy()
        for ev in meta["output_events"]:
            cut = ev["cut_uop"]
            words = np.asarray(ev["words"], dtype=np.int64)
            if len(words) == 0 or cut == 0:
                continue
            tr_cut = trace.__class__(
                opcode=trace.opcode[:cut], dst=trace.dst[:cut],
                src1=trace.src1[:cut], src2=trace.src2[:cut],
                imm=trace.imm[:cut], taken=trace.taken[:cut],
                init_reg=trace.init_reg, init_mem=trace.init_mem)
            # graftlint: allow-jit -- a per-coordinate cut window with
            # its own memmap: used once, never shared
            k_cut = TrialKernel(tr_cut, O3Config(enable_shrewd=False),
                                device=dev,
                                memmap=memmap_from_meta(meta, cut=cut,
                                                        device=dev))
            widx = torch.as_tensor(words, device=dev)
            rcut = k_cut._replay(faults).mem[:, widx].cpu().numpy()
            gold_w = k_cut.golden.mem[0, widx].cpu().numpy()
            bmask = np.asarray(ev["byte_masks"], dtype=np.int64)
            delta = rcut ^ gold_w[None, :]
            sdc |= ((delta & bmask[None, :]) != 0).any(1)
        exit_diff = ((rdi ^ int(k.golden.reg[0, 7])) & 0xFF) != 0
        sdc |= exit_diff
        out = np.full(len(coords), C.OUTCOME_MASKED, dtype=np.int32)
        out[sdc] = C.OUTCOME_SDC
        out[trapped] = C.OUTCOME_DUE
        out[detected] = C.OUTCOME_DETECTED
        # Diverged-trial escalation: a wrong branch direction leaves the
        # captured window's dataflow entirely — the replay cannot follow
        # the wrong path.  Hand exactly those trials to the whole-program
        # emulator oracle, which executes the actual wrong path to its
        # real outcome (segfault → DUE / output diff → SDC /
        # re-convergence → masked).  masked/sdc/due class codes coincide
        # between HOST_OUTCOME and ops.classify.
        # Resync-severed coordinates: the struck register's first touch
        # after the landing cycle is a demotion-resync LUI, so the replay
        # provably drops a corruption silicon keeps — escalate those to
        # the oracle along with the diverged trials.
        sev = _resync_severed(trace, meta, coords) \
            | _demoted_exposed(trace, meta, coords)
        div_only = diverged & ~trapped & ~detected
        # severed/exposed trials escalate even when the replay trapped:
        # when silicon's behavior ran through a demoted instruction the
        # replay's own trap can be spurious (the emulator executes the
        # real path); plain traps stay DUE on-device
        div = (div_only | sev) & ~detected
        if report is not None:
            # device_diverged is the diverged escalation set;
            # resync_severed counts the trials the severed/exposed tests
            # ADD to it (trapped ones included); escalated_total =
            # device_diverged + resync_severed = the oracle's input size
            report["device_diverged"] = int(div_only.sum())
            report["resync_severed"] = int((sev & ~div_only
                                            & ~detected).sum())
            report["escalated_total"] = int(div.sum())
            report["device_memmap"] = k.memmap is not None
        if resolve_diverged and paths is not None and div.any():
            try:
                oracle = Emu64Oracle(paths)
                resolved = oracle.classify(coords[div])
            except Exception as e:  # noqa: BLE001 — a workload the
                # emulator cannot run whole-program must degrade to the
                # conservative diverged→SDC labeling, not lose the report
                if report is not None:
                    report["diverged_resolution_failed"] = \
                        f"{type(e).__name__}: {e}"[:200]
            else:
                out[div] = resolved
                if report is not None:
                    report["diverged_resolved"] = {
                        name: int((resolved == code).sum())
                        for name, code in HOST_OUTCOME.items()}
        return out

    mask = np.zeros(trace.nphys, dtype=bool)
    mem_mask = None
    if liveness is not None:
        mask[:len(liveness.reg_live)] = liveness.reg_live
        mem_mask = torch.as_tensor(liveness.mem_word_mask(
            meta["clusters"], trace.mem_words), device=dev)
    else:
        mask[list(LIVE_OUT_REGS)] = True
    return C.classify(k._replay(faults), k.golden, compare_regs=True,
                      reg_mask=torch.as_tensor(mask, device=dev),
                      mem_mask=mem_mask).cpu().numpy()


class Emu64Oracle:
    """Perturbed whole-program re-execution on the snapshot-seeded 64-bit
    emulator (ingest/emu.py run_program), classified by the host oracle's
    own criteria (stdout + exit status).  Covers the upper register halves
    and real wrong-path execution — the two things the 32-bit window
    replay cannot track.  Built once (snapshot capture + golden run), then
    ``classify`` maps any coordinate subset — the escalation tier the
    replay kernel hands its *diverged* trials to (run_device)."""

    def __init__(self, paths: BuildPaths, max_steps: int = 4_000_000):
        import subprocess

        from shrewd_tpu_torch.ingest.emu import elf_regions, run_program
        from shrewd_tpu_torch.ingest.lift import read_nativetrace, static_decode

        self._run_program = run_program
        self.max_steps = max_steps
        bd = paths.workload.parent
        trace_bin = bd / f"{paths.workload.name}_emu64.{os.getpid()}.bin"
        try:
            proc = subprocess.run(
                [str(paths.tracer), str(trace_bin), f"{paths.begin:x}", "0",
                 "1", str(paths.workload)],     # 1 step: snapshot only
                capture_output=True, text=True)
            if proc.returncode not in (0, 1) or not trace_bin.exists():
                raise RuntimeError(f"snapshot capture failed: {proc.stderr}")
            nt = read_nativetrace(trace_bin)
        finally:
            trace_bin.unlink(missing_ok=True)
        self.insts = static_decode(str(paths.workload))
        self.regs0 = nt.steps[0][:16]
        # snapshot regions first (writable, current values — they win on
        # overlap), then ALL of the binary's segments as fallback:
        # text/rodata plus the RELRO slice the writable-only snapshot
        # cannot see
        self.regions = [(v, d) for v, d in nt.regions]
        self.regions += elf_regions(str(paths.workload))
        self.pc0 = int(nt.steps[0][16])
        self.fs_base = nt.fs_base

        self.golden = run_program(self.insts, self.regs0, self.regions,
                                  self.pc0, max_steps, fs_base=self.fs_base)
        if self.golden.kind != "exit" or self.golden.exit_code != 0:
            raise RuntimeError(f"golden emu run failed: {self.golden.kind}")

    def classify_one(self, step: int, reg: int, bit: int) -> int:
        r = self._run_program(self.insts, self.regs0, self.regions,
                              self.pc0, self.max_steps,
                              fault=(int(step), int(reg), int(bit)),
                              fs_base=self.fs_base)
        if r.kind != "exit" or r.exit_code != 0:
            return HOST_OUTCOME["due"]
        if r.stdout != self.golden.stdout:
            return HOST_OUTCOME["sdc"]
        return HOST_OUTCOME["masked"]

    def classify(self, coords: np.ndarray) -> np.ndarray:
        out = np.zeros(len(coords), dtype=np.int32)
        for i, (step, reg, bit) in enumerate(coords):
            out[i] = self.classify_one(step, reg, bit)
        return out


def run_device_emu64(paths: BuildPaths, coords: np.ndarray,
                     max_steps: int = 4_000_000) -> np.ndarray:
    """The 64-bit classification path over a coordinate list — see
    Emu64Oracle."""
    return Emu64Oracle(paths, max_steps).classify(coords)


def wilson(successes: int, n: int, confidence: float = 0.95):
    from shrewd_tpu_torch.parallel.stopping import wilson as _w
    return _w(successes, n, confidence)


def compare(host: np.ndarray, dev: np.ndarray) -> dict:
    n = len(host)
    host_v = host != 0
    dev_v = dev != 0
    h_avf = wilson(int(host_v.sum()), n)
    d_avf = wilson(int(dev_v.sum()), n)
    conf = np.zeros((3, 4), dtype=int)      # host class × device class
    for h, d in zip(host, dev):
        conf[h, d] += 1
    return {
        "trials": n,
        "host_tally": {"masked": int((host == 0).sum()),
                       "sdc": int((host == 1).sum()),
                       "due": int((host == 2).sum())},
        "device_tally": {"masked": int((dev == 0).sum()),
                         "sdc": int((dev == 1).sum()),
                         "due": int((dev == 2).sum()),
                         "detected": int((dev == 3).sum())},
        "host_avf": float(host_v.mean()),
        "host_avf_ci": [h_avf.lo, h_avf.hi],
        "device_avf": float(dev_v.mean()),
        "device_avf_ci": [d_avf.lo, d_avf.hi],
        "avf_abs_err": abs(float(host_v.mean()) - float(dev_v.mean())),
        "agreement_exact": float((host == dev).mean()),
        "agreement_vulnerable": float((host_v == dev_v).mean()),
        "confusion_host_x_device": conf.tolist(),
        "cis_overlap": bool(h_avf.lo <= d_avf.hi and d_avf.lo <= h_avf.hi),
    }


def run_diff(n_trials: int = 500, seed: int = 0,
             workload_c: str = "workloads/sort.c",
             mode: str = "output", max_steps: int = 2_000_000,
             device=None) -> dict:
    """Paired host-vs-device differential AVF; the device column runs on
    ``device`` (the card when None; ``"cpu"`` for the CPU).

    ``mode``:
      - "output" (default): extended-window replay to process exit,
        classification on the written stdout bytes + exit code — the exact
        host-oracle semantics;
      - "liveness": [kernel_begin, kernel_end) window with measured
        post-window first-access liveness masks (ingest/liveness.py);
      - "abi": static callee-saved-register heuristic (the r2 baseline,
        kept for comparison — known to over-report);
      - "emu64": perturbed whole-program re-execution on the 64-bit
        emulator, sampling the FULL bit range [0,64) — upper register
        halves and wrong paths included;
      - "device64": the pair-lane 64-bit lift (ingest/lift64.py) on the
        replay KERNEL, sampling bits [0,64) — the device column is
        computed on-device, with the emulator serving only as the
        diverged-trial escalation tier.
    """
    from shrewd_tpu_torch.ingest.lift import GPR_NAMES_64
    from shrewd_tpu_torch.utils.device import resolve

    if mode != "emu64":
        device = resolve(device)     # no card: raise before any work
    paths = build_tools(workload_c)
    lv = None
    meta = None
    if mode == "emu64":
        # the emulator replays the raw capture — only the marker-window
        # *length* is needed, not a full lift of the window
        window = capture_window_macro_ops(paths, max_steps=max_steps)
        coords = sample_coords(n_trials, window, seed, bit_range=64)
        host = run_host(paths, coords)
        dev = run_device_emu64(paths, coords)
    else:
        bit_range = 32
        n_regs = 16
        if mode == "fp":
            # GPR + xmm fault space: regs 0..15 GPRs, 16..31 xmm low
            # lanes (hostsfi flips the latter via PTRACE_SETFPREGS)
            trace, meta = capture_and_lift_to_output(paths)
            window = meta["window_macro_ops"]
            n_regs = 32
        elif mode == "device64":
            from shrewd_tpu_torch.ingest.lift64 import lift64
            trace, meta = capture_and_lift_to_output(paths, lifter=lift64,
                                                     max_steps=max_steps)
            window = meta["window_macro_ops"]
            bit_range = 64
        elif mode == "output":
            trace, meta = capture_and_lift_to_output(paths,
                                                     max_steps=max_steps)
            window = meta["window_macro_ops"]
        else:
            trace, meta = capture_and_lift(paths, max_steps=max_steps)
            window = meta["macro_ops"]
            if mode == "liveness":
                from shrewd_tpu_torch.ingest.liveness import post_window_liveness
                lv = post_window_liveness(paths, meta["clusters"])
        coords = sample_coords(n_trials, window, seed,
                               bit_range=bit_range, n_regs=n_regs)
        host = run_host(paths, coords)
        dev_report: dict = {}
        dev = run_device(trace, meta, coords, liveness=lv, paths=paths,
                         report=dev_report, device=device)
    rep = compare(host, dev)
    if mode not in ("emu64",):
        rep.update(dev_report)
    rep["workload"] = workload_c
    rep["seed"] = seed
    rep["mode"] = mode
    if meta is not None:
        rep["lift_stats"] = meta["stats"]
    rep["window_macro_ops_sampled"] = window
    if mode == "output":
        rep["window_macro_ops"] = window
        rep["output_words"] = len(meta["output_words"])
        rep["output_syscalls"] = meta["output_syscalls"]
    if lv is not None:
        rep["liveness"] = {
            "live_regs": [GPR_NAMES_64[i] for i in
                          np.nonzero(lv.reg_live)[0]],
            "live_mem_words": int(lv.mem_word_mask(
                meta["clusters"], trace.mem_words).sum()),
            "post_window_steps": lv.steps,
            "truncated": lv.truncated,
            "unknown_insts": lv.unknown_insts,
        }
    return rep
