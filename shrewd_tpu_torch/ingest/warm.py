"""Restore + re-warm: checkpoint → replay-ready trace window (the port's
copy of ``shrewd_tpu/ingest/warm.py``).

gem5 checkpoints are architectural-only — O3 drains its pipeline before
serializing (``src/cpu/o3/cpu.cc:706-799``), so in-flight ROB/IQ/LSQ contents
never reach ``m5.cpt`` (SURVEY §5.4, hard part #3). The reference recovers
microarchitectural context by restoring arch state and running forward; this
module does the same on the framework side:

1. lift the snapshot's register values / memory image into the kernel's
   fixed-shape ``(nphys,)`` / ``(mem_words,)`` uint32 arrays,
2. advance ``warmup`` µops functionally (the scalar golden semantics —
   CheckerCPU analog) so the window starts from a warmed state,
3. emit a ``Trace`` whose window begins post-warmup.

Two window sources over the ingested state:

- ``window_from_snapshot_lifted`` — the REAL stream: the snapshot-seeded
  x86 emulator (ingest/emu.py) runs forward from the checkpoint PC over
  the checkpointed memory image, and the macro→µop lifter
  (ingest/lift.py) lifts that stream — restore-then-rewarm with the
  emulator standing in for the host CPU;
- ``window_from_snapshot`` — a synthetic stream over the snapshot state,
  for artifact-free runs (no binary available) and load benchmarks.
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.ingest.cpt import ArchSnapshot
from shrewd_tpu_torch.trace import synth
from shrewd_tpu_torch.trace.format import Trace


def window_from_snapshot_lifted(snap: ArchSnapshot, binary: str,
                                max_steps: int = 200_000,
                                max_uops: int | None = None
                                ) -> tuple[Trace, dict]:
    """Checkpoint → emulate forward from ``snap.pc`` → lift the real stream.

    Needs the checkpoint's region vaddrs (the config.json sidecar written
    by ``write_arch_snapshot``; the reference equivalently needs config.ini
    to place its stores).  Returns (trace, lift-meta); meta additionally
    records the emulator's stop point."""
    from shrewd_tpu_torch.ingest.emu import emulate_window
    from shrewd_tpu_torch.ingest.lift import lift, static_decode

    if not snap.regions:
        raise ValueError(
            "checkpoint lacks region vaddrs (config.json sidecar) — the "
            "lifted restore path cannot address the memory image; "
            "re-checkpoint via write_arch_snapshot or use the synthetic "
            "window_from_snapshot")
    if snap.int_regs.size < 16:
        raise ValueError(f"{snap.int_regs.size} integer registers in "
                         "checkpoint; need the 16 x86-64 GPRs")
    regions = []
    off = 0
    for vaddr, size in snap.regions:
        regions.append((int(vaddr), snap.mem[off:off + size].tobytes()))
        off += size
    insts = static_decode(binary)
    res = emulate_window(binary, snap.int_regs, regions, snap.pc, max_steps,
                         insts=insts)
    trace, meta = lift("<emu>", binary, max_uops=max_uops, nt=res.nt,
                       insts=insts)
    meta["emu_steps"] = res.steps
    meta["emu_stop_reason"] = res.stop_reason
    meta["emu_stop_pc"] = res.stop_pc
    return trace, meta


def lift_registers(snap: ArchSnapshot, nphys: int) -> np.ndarray:
    """Architectural uint64 regs → (nphys,) uint32 physical file.

    Low/high 32-bit halves interleave into consecutive entries (x86-64 arch
    values are 64-bit; the µop ISA is 32-bit). Physical registers beyond the
    architectural set start at a deterministic hash of (pc, index) — their
    true values are microarchitectural state a checkpoint cannot carry, and
    the warmup replay overwrites the ones that matter.
    """
    out = np.zeros(nphys, dtype=np.uint32)
    arch = snap.int_regs
    lo = (arch & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (arch >> np.uint64(32)).astype(np.uint32)
    inter = np.empty(2 * arch.size, dtype=np.uint32)
    inter[0::2], inter[1::2] = lo, hi
    if inter.size > nphys:
        raise ValueError(
            f"snapshot carries {arch.size} integer registers "
            f"({inter.size} uint32 halves) but nphys={nphys}; dropping "
            f"architectural state would silently corrupt the golden replay — "
            f"use nphys >= {inter.size}")
    n_arch = inter.size
    out[:n_arch] = inter
    if nphys > n_arch:
        idx = np.arange(n_arch, nphys, dtype=np.uint64)
        mix = (idx * np.uint64(0x9E3779B97F4A7C15)
               + np.uint64(snap.pc)) >> np.uint64(16)
        out[n_arch:] = mix.astype(np.uint32)
    return out


def lift_memory(snap: ArchSnapshot, mem_words: int,
                base_addr: int = 0) -> np.ndarray:
    """Physical image bytes → (mem_words,) little-endian uint32 words
    starting at ``base_addr`` (word-aligned); zero-fill past the image."""
    if base_addr % 4:
        raise ValueError("base_addr must be word-aligned")
    out = np.zeros(mem_words, dtype=np.uint32)
    raw = snap.mem[base_addr:base_addr + 4 * mem_words]
    usable = raw.size // 4
    if usable:
        out[:usable] = raw[:4 * usable].view("<u4")
    return out


def window_from_snapshot(snap: ArchSnapshot, cfg: synth.WorkloadConfig,
                         warmup: int = 0) -> Trace:
    """Build a replay window over ingested golden state.

    ``warmup`` µops are generated and *retired functionally* before the
    captured window starts (step 2 above); the returned trace's
    ``init_reg``/``init_mem`` is the post-warmup state.
    """
    full_cfg = type(cfg).from_dict({**cfg.to_dict(), "n": cfg.n + warmup})
    init_reg = lift_registers(snap, cfg.nphys)
    init_mem = lift_memory(snap, cfg.mem_words)
    if warmup == 0:
        return synth.generate(full_cfg, init_reg=init_reg, init_mem=init_mem)

    # the generator retires every µop as it goes; capture the post-warmup
    # state in-stream instead of replaying the prefix a second time
    full, reg, mem = synth.generate(full_cfg, init_reg=init_reg,
                                    init_mem=init_mem, capture_at=warmup)
    trace = Trace(opcode=full.opcode[warmup:], dst=full.dst[warmup:],
                  src1=full.src1[warmup:], src2=full.src2[warmup:],
                  imm=full.imm[warmup:], taken=full.taken[warmup:],
                  init_reg=reg, init_mem=mem)
    trace.validate()
    return trace
