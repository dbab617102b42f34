"""Chunked hierarchical replay: SimPoint-scale windows.

Port of ``shrewd_tpu/ops/chunked.py``.  The full-window paths replay the
whole window per trial, so a trial's cost grows with the window.  Here:

1. **Golden boundary states.**  One fault-free pass over the window, chunk
   by chunk (size S), records the architectural state at every chunk
   boundary (``native.boundary_pass``, the serial C++ golden replay; the
   dense scan for a VA-space memmap trace, which the C++ replay does not
   model).  With the NOP-padded SoA layout it is the *preprocessed
   window* (``ops/window.py``), built once and shared through a process
   registry and, given ``store=``, the artifact store.
2. **Landing-chunk start.**  Until its fault lands a trial IS the golden
   run, so it starts from the golden boundary of its landing chunk.
3. **Convergence resolution.**  At each boundary a trial froze (detected,
   trapped, diverged: final), converged (state equal to the golden
   boundary: masked), or carries its divergent state into the next chunk.

Two chunk engines share the driver:

- ``exact``: the dense scan (``ops/replay.py``) per chunk, full reg + mem
  state per lane.  A torch step loop: it runs the fallback lanes, the
  gates, and memmap traces (the only engine that takes them).
- ``taint``: the deviation-set chunk kernel per chunk (``ops/taint_cuda.py
  taint_chunk_cuda``, K2): the cross-chunk state is the k-entry deviation
  set.  Escape/overflow lanes re-run on the exact engine, so outcomes stay
  equal to exact (= dense).  The tensors' device picks K2 (CUDA) or its
  plain version (CPU), as for the full-window fast pass.

The JAX package's third engine, ``pallas``, was the TPU kernel; here the
kernel follows the device, and ``engine="pallas"`` raises.  The config's
``pallas*`` params are not read.

Per chunk the taint engine uploads nothing: the padded trace is on the
device once per window, and the chunk's golden record (``record_chunk``,
the C++ recorder) and K2's packed stream are built once per chunk and
shared by its waves.  Per wave it gathers the lanes' setup values
(``setup_gather``), launches K2, and resolves convergence, the carry
horizon (code -3) and the end classification on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch import native
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import (KIND_LATCH_OP, KIND_REGFILE, Fault,
                                        null_fault)
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops import window as W
from shrewd_tpu_torch.ops.replay import ReplayResult, TraceArrays, replay
from shrewd_tpu_torch.ops.taint import (EMPTY, GoldenRecord, record_chunk,
                                        setup_gather)
from shrewd_tpu_torch.ops.taint_cuda import pack_stream, taint_chunk_cuda
from shrewd_tpu_torch.parallel.exec_cache import trace_digest

ENGINES = ("exact", "taint")

#: sentinel horizon when carry_horizon is None (never reached: ages are
#: bounded by the chunk count)
_NO_HORIZON = 1 << 30

_NULL_LEAVES = dict(kind=0, cycle=-1, entry=-1, bit=0, shadow_u=1.0)


def _dtype(name: str):
    return np.float32 if name == "shadow_u" else np.int32


class _Carry(NamedTuple):
    """Unresolved exact-engine trials between chunks."""

    reg: torch.Tensor    # int64[K, nphys], on the device
    mem: torch.Tensor    # int64[K, mem_words]
    fault: dict          # host arrays [K] per Fault field
    orig: np.ndarray     # int64[K] original trial indices
    age: np.ndarray      # int64[K] chunks carried so far


# --------------------------------------------------------------------------
# window preprocessing
# --------------------------------------------------------------------------

def _build_window(kernel, S: int, digest: str) -> W.PreprocessedWindow:
    """Pad the trace into the SoA chunk layout and run the golden boundary
    pass: the native one, or for a memmap trace the dense scan chunk by
    chunk under the null fault (the JAX package's scan fallback)."""
    trace = kernel.trace
    n = int(trace.n)
    C_ = (n + S - 1) // S
    pad = C_ * S - n

    def padded(a, fill=0):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.full(pad, fill, a.dtype)]) if pad else a

    tr_host = {
        "opcode": padded(trace.opcode, U.NOP), "dst": padded(trace.dst),
        "src1": padded(trace.src1), "src2": padded(trace.src2),
        "imm": padded(np.asarray(trace.imm, np.uint32)),
        "taken": padded(trace.taken),
    }
    nphys = int(trace.init_reg.shape[0])
    mem_words = int(trace.init_mem.shape[0])
    gb_reg = np.empty((C_ + 1, nphys), np.uint32)
    gb_mem = np.empty((C_ + 1, mem_words), np.uint32)
    gb_reg[0] = np.asarray(trace.init_reg, np.uint32)
    gb_mem[0] = np.asarray(trace.init_mem, np.uint32)
    mm = kernel.memmap
    win = W.PreprocessedWindow(
        n=n, S=S, nphys=nphys, mem_words=mem_words, trace_digest=digest,
        tr=tr_host, gb_reg=gb_reg, gb_mem=gb_mem, memmap=mm,
        mm_cluster_pad=(padded(mm.uop_cluster.cpu().numpy(), -1)
                        if mm is not None else None))
    if mm is None:
        native.boundary_pass(tr_host, S, gb_reg, gb_mem)
    else:
        # coverage is inert under the null fault, so the pass streams zeros
        dev = kernel.device
        trd = win.tr_dev(dev)
        reg = torch.as_tensor(gb_reg[0].astype(np.int64), device=dev)
        mem = torch.as_tensor(gb_mem[0].astype(np.int64), device=dev)
        null = null_fault(dev)
        for c in range(C_):
            lo, hi = c * S, (c + 1) * S
            r = replay(TraceArrays(**{f: trd[f][lo:hi]
                                      for f in W.TRACE_FIELDS}),
                       reg, mem, null, torch.zeros(S, device=dev),
                       memmap=win.chunk_memmap(c, dev), index_offset=lo)
            reg, mem = r.reg[0], r.mem[0]
            gb_reg[c + 1] = reg.cpu().numpy()
            gb_mem[c + 1] = mem.cpu().numpy()
    W.STATS["builds"] += 1
    return win


def preprocess_window(kernel, chunk: int,
                      store=None) -> W.PreprocessedWindow:
    """The preprocessed window for ``(kernel.trace, chunk)``: a registry
    hit, then (given ``store``, memmap-free kernels) a store hit, else a
    build that back-fills both.  Store persistence is single-flighted on
    the ``(digest, S)`` object dir, so concurrent campaigns share one
    build."""
    n = int(kernel.trace.n)
    S = int(min(chunk, n))
    digest = trace_digest(kernel.trace)
    win = W.lookup(digest, S, kernel.memmap)
    if win is not None:
        return win
    if store is not None and kernel.memmap is None:
        from shrewd_tpu_torch.ingest.store import axes_key

        with store.lock(digest, axes_key(W.store_axes(S))):
            win = W.load_from_store(store, digest, S)
            if win is None:
                win = _build_window(kernel, S, digest)
                W.save_to_store(store, win)
        return W.register(win)
    return W.register(_build_window(kernel, S, digest))


# --------------------------------------------------------------------------
# the campaign
# --------------------------------------------------------------------------

class ChunkedCampaign:
    """Chunked execution strategy over a TrialKernel's trace and config.

    ``kernel`` supplies the trace, the fault sampler, the shadow coverage,
    the config and the device; this class adds the boundary-state pass and
    the wave driver.  ``chunk`` is the chunk length in µops; ``max_batch``
    caps the lanes per kernel call (exact engine default: the batch's
    memory images under ~256 MB; taint engine: 4096).

    ``engine``: ``"exact"``, ``"taint"``, or ``"auto"`` (exact for
    ``replay_kernel="dense"``, else taint).  Both give the same outcomes.
    ``window`` injects a prebuilt preprocessed window."""

    def __init__(self, kernel, chunk: int = 65536,
                 max_batch: int | None = None,
                 carry_horizon: int | None = None,
                 engine: str = "auto", store=None, window=None):
        """``carry_horizon`` (optional): classify a trial that stays
        divergent-but-live for more than this many chunks as SDC without
        replaying the rest of the window (masked→SDC and DUE→SDC only, the
        conservative direction).  None replays every carried trial to the
        window's end."""
        self.kernel = kernel
        self.device = kernel.device
        self.carry_horizon = carry_horizon
        trace = kernel.trace
        self.n = int(trace.n)
        self.S = int(min(chunk, self.n))
        self.C = (self.n + self.S - 1) // self.S
        self.nphys = int(trace.init_reg.shape[0])
        self.mem_words = int(trace.init_mem.shape[0])

        if engine == "auto":
            engine = ("exact" if kernel.memmap is not None
                      or kernel.cfg.replay_kernel == "dense" else "taint")
        if engine == "pallas":
            raise ValueError(
                "engine 'pallas' was the TPU kernel; in the PyTorch port "
                "the taint engine's kernel follows the device (the Hopper "
                "kernel for CUDA tensors) — use engine='taint'")
        if engine not in ENGINES:
            raise ValueError(f"unknown chunk engine {engine!r}")
        if engine != "exact" and kernel.memmap is not None:
            raise ValueError(
                "fast chunked engines carry deviation sets, not memory "
                "images, and cannot replay VA-space memmap traces — use "
                "engine='exact'")
        self.engine = engine

        if max_batch is None:
            if engine == "exact":
                budget = (1 << 28) // max(self.mem_words * 4, 1)
                max_batch = int(np.clip(
                    1 << int(np.log2(max(budget, 8))), 8, 1024))
            else:
                max_batch = 4096
        self.B = max_batch
        self.last_stats: dict | None = None   # set by outcomes_from_keys

        self.window = window if window is not None else preprocess_window(
            kernel, self.S, store=store)
        assert self.window.n == self.n and self.window.S == self.S
        self.gb_reg = self.window.gb_reg       # host (C+1, nphys) u32
        self.gb_mem = self.window.gb_mem       # host (C+1, mem_words) u32

        pad = self.C * self.S - self.n
        cov = kernel.shadow_cov.cpu().numpy().astype(np.float32)
        self.cov_pad_host = (np.concatenate(
            [cov, np.zeros(pad, np.float32)]) if pad else cov)
        self._cov = None
        self.golden_final = ReplayResult(
            reg=self._boundary(self.gb_reg, self.C),
            mem=self._boundary(self.gb_mem, self.C),
            detected=None, trapped=None, diverged=None)

    # ---- per-chunk device views --------------------------------------------

    def _boundary(self, gb: np.ndarray, c: int) -> torch.Tensor:
        return torch.as_tensor(gb[c].astype(np.int64), device=self.device)

    def _chunk(self, c: int) -> tuple[TraceArrays, torch.Tensor]:
        """Chunk ``c``'s trace and coverage: views of the window's padded
        arrays, uploaded once per window."""
        if self._cov is None:
            self._cov = torch.as_tensor(self.cov_pad_host,
                                        device=self.device)
        lo, hi = c * self.S, (c + 1) * self.S
        trd = self.window.tr_dev(self.device)
        return (TraceArrays(**{f: trd[f][lo:hi] for f in W.TRACE_FIELDS}),
                self._cov[lo:hi])

    def chunk_record(self, c: int) -> tuple[TraceArrays, torch.Tensor,
                                            GoldenRecord]:
        """Chunk ``c``'s trace, coverage and golden record (the C++
        recorder from the golden boundary ``c``; final state = boundary
        ``c + 1``)."""
        tr, cov = self._chunk(c)
        gold = record_chunk(tr, self._boundary(self.gb_reg, c),
                            self._boundary(self.gb_mem, c),
                            self._boundary(self.gb_reg, c + 1),
                            self._boundary(self.gb_mem, c + 1))
        return tr, cov, gold

    def _trial_chunk(self, c: int, reg_b, mem_b, fault_b: Fault, gb_r1,
                     gb_m1):
        """One chunk of the exact engine for B lanes → (reg', mem', det,
        trap, div, eq)."""
        tr, cov = self._chunk(c)
        r = replay(tr, reg_b, mem_b, fault_b, cov,
                   memmap=self.window.chunk_memmap(c, self.device),
                   index_offset=c * self.S)
        eq = (r.reg == gb_r1).all(1) & (r.mem == gb_m1).all(1)
        return r.reg, r.mem, r.detected, r.trapped, r.diverged, eq

    # ---- fast chunk (taint engine) -----------------------------------------

    def _fast_chunk_body(self, tr: TraceArrays, cov, gold: GoldenRecord,
                         reg0, fault_b: Fault, tags0, vals0, ages,
                         horizon: int, *, may_latch: bool, is_last: bool,
                         stream=None):
        """One chunk for B lanes on the deviation-set kernel → ``(code,
        frz, conv, tags, vals)``, all on the device.

        code ≥ 0: final outcome class; -1: carry to the next chunk; -2:
        escape/overflow → per-trial exact fallback; -3: carry-horizon SDC
        relabel (counted apart so ``horizon_sdc`` stays exact).  Fault
        coordinates arrive localized to this chunk (a carried lane's go
        negative: no fault phase re-fires); ``tags0``/``vals0`` are the
        carried sets.  ``gold`` is the chunk's record, ``reg0`` its start
        state and ``stream`` the record packed for K2 (None on the CPU),
        built once per chunk by the driver (the JAX package records inside
        its per-wave executable)."""
        k = int(self.kernel.cfg.taint_k)
        setup = setup_gather(gold, tr, reg0, fault_b)
        (tags, vals, _steps, det, trap, div, esc,
         ovf) = taint_chunk_cuda(gold, tr, cov, fault_b, *setup, tags0,
                                 vals0, k=k, may_latch=may_latch,
                                 stream=stream)
        frz = det | trap | div
        fb = esc | ovf
        boundary = torch.cat([gold.final_reg, gold.final_mem])
        ent = tags != EMPTY
        diff_full = ent & (vals != boundary[torch.where(ent, tags, 0)])
        conv = ~diff_full.any(1)
        if is_last:
            # end-of-window classification, identical to taint_replay's
            if self.kernel.cfg.compare_regs:
                state_diff = ~conv
            else:
                state_diff = (diff_full & (tags >= self.nphys)).any(1)
            out_surv = torch.where(state_diff, C.OUTCOME_SDC,
                                   C.OUTCOME_MASKED)
        else:
            out_surv = torch.where(conv, C.OUTCOME_MASKED, -1)
            # carry horizon: still divergent past it → SDC
            over = (out_surv == -1) & (ages + 1 > horizon)
            out_surv = torch.where(over, -3, out_surv)
        code = torch.where(
            fb, -2, torch.where(
                det, C.OUTCOME_DETECTED, torch.where(
                    trap, C.OUTCOME_DUE, torch.where(
                        div, C.OUTCOME_SDC, out_surv))))
        return code, frz, conv, tags, vals

    # ---- driver ----------------------------------------------------------

    def lane_width(self, n_trials: int) -> int:
        """Lanes per kernel call for a campaign of ``n_trials``: the cap,
        shrunk to the pow2 bucket of the campaign size."""
        return int(min(self.B,
                       1 << int(np.ceil(np.log2(max(n_trials, 8))))))

    def _fast_lane_width(self, n_trials: int) -> int:
        """Occupancy-aware wave width for both drivers: each trial is live
        in at most span = horizon+1 chunks (C when exact), so the mean wave
        carries ceil(n_trials·span/C) lanes.  Chunks drawing more than B
        lanes run extra waves; outcomes do not depend on B."""
        span = (self.C if self.carry_horizon is None
                else min(self.carry_horizon + 1, self.C))
        per_wave = -(-n_trials * span // self.C)
        return min(self.lane_width(n_trials), self.lane_width(per_wave))

    def outcomes_from_keys(self, keys: torch.Tensor, structure: str
                           ) -> np.ndarray:
        """Per-trial outcome classes (host int32[B_total], key order),
        equal to the dense kernel's on the same keys."""
        faults = self.kernel.sample_batch(keys, structure)
        return self.outcomes_of_faults(faults)

    def outcomes_of_faults(self, faults: Fault) -> np.ndarray:
        """Fault-level core of ``outcomes_from_keys``: runs constructed
        trials of any kind through the chunked strategy."""
        f_host = {k: v.cpu().numpy() for k, v in faults._asdict().items()}
        n_tr = f_host["cycle"].shape[0]
        # the fault's landing µop: REGFILE flips at `cycle`, every other
        # kind applies at µop `entry`
        landing = np.where(f_host["kind"] == KIND_REGFILE,
                           f_host["cycle"], f_host["entry"])
        outcomes = np.full(n_tr, -1, np.int32)
        # out-of-window landings never match a µop of the dense window, so
        # they are MASKED there; the padded chunk stream runs indices up to
        # C*S-1, where they could strike a padded NOP — resolve them here
        oow = (landing < 0) | (landing >= self.n)
        outcomes[oow] = C.OUTCOME_MASKED
        land_chunk = np.clip(landing, 0, self.n - 1) // self.S
        land_chunk[oow] = -1          # never scheduled into a wave
        st = {"waves": 0, "lanes_run": 0, "resolved_frozen": 0,
              "resolved_eq": 0, "carried": 0, "resolved_at_end": 0,
              "chunk_replays": 0, "horizon_sdc": 0,
              "oow_masked": int(oow.sum()),
              "engine": self.engine, "fallback_lanes": 0}
        self.last_stats = st    # live view — valid even on a failed run
        if self.engine == "exact":
            self._outcomes_exact(f_host, outcomes, land_chunk, st)
        else:
            self._outcomes_fast(f_host, outcomes, land_chunk, st)
        self.last_stats = st
        assert (outcomes >= 0).all(), "unresolved trials after last chunk"
        return outcomes

    def _wave_faults(self, parts: dict) -> Fault:
        return Fault(**{name: torch.as_tensor(parts[name],
                                              device=self.device)
                        for name in Fault._fields})

    @staticmethod
    def _waves(n_prev: int, fresh: np.ndarray, B: int):
        """(carried slice, fresh indices) per wave: carried lanes first,
        then fresh ones, B at a time."""
        cpos = fpos = 0
        while cpos < n_prev or fpos < fresh.size:
            k_carry = min(B, n_prev - cpos)
            carry_sl = slice(cpos, cpos + k_carry)
            cpos += k_carry
            new_idx = fresh[fpos:fpos + B - k_carry]
            fpos += new_idx.size
            yield carry_sl, new_idx

    # ---- fast driver (taint engine) ----------------------------------------

    def _outcomes_fast(self, f_host, outcomes, land_chunk, st) -> None:
        """Wave driver over the deviation-set chunk kernel.  Per-trial
        cross-chunk state is (orig, age, fault, k-entry set); every
        semantic decision happens in ``_fast_chunk_body``.  Escape/overflow
        lanes re-run per trial on the exact engine afterwards."""
        n_tr = land_chunk.shape[0]
        B = self._fast_lane_width(n_tr)
        k = int(self.kernel.cfg.taint_k)
        may_latch = bool((f_host["kind"] == KIND_LATCH_OP).any())
        horizon = (self.carry_horizon if self.carry_horizon is not None
                   else _NO_HORIZON)
        fb_ids: list[np.ndarray] = []
        carry: dict | None = None
        for c in range(self.C):
            fresh = np.nonzero(land_chunk == c)[0]
            prev, carry = carry, None
            n_prev = prev["orig"].size if prev is not None else 0
            if n_prev == 0 and fresh.size == 0:
                continue
            is_last = c == self.C - 1
            # once per chunk: trace views, golden record, boundary state,
            # the record packed for K2
            tr, cov, gold = self.chunk_record(c)
            reg0 = self._boundary(self.gb_reg, c)
            stream = (pack_stream(gold, tr, cov)
                      if self.device.type == "cuda" else None)
            start = c * self.S
            nxt: dict = {"orig": [], "age": [], "tags": [], "vals": [],
                         "fault": {name: [] for name in f_host}}
            for carry_sl, new_idx in self._waves(n_prev, fresh, B):
                k_carry = carry_sl.stop - carry_sl.start
                b = k_carry + new_idx.size
                pad = B - b
                orig = np.full(B, -1, np.int64)
                ages = np.zeros(B, np.int64)
                tags0 = np.full((B, k), EMPTY, np.int64)
                vals0 = np.zeros((B, k), np.int64)
                fw: dict[str, np.ndarray] = {}
                for name in f_host:
                    dt = _dtype(name)
                    parts = []
                    if k_carry:
                        parts.append(prev["fault"][name][carry_sl])
                    if new_idx.size:
                        parts.append(f_host[name][new_idx].astype(dt))
                    if pad:
                        parts.append(np.full(pad, _NULL_LEAVES[name], dt))
                    fw[name] = np.concatenate(parts).astype(dt)
                if k_carry:
                    orig[:k_carry] = prev["orig"][carry_sl]
                    ages[:k_carry] = prev["age"][carry_sl]
                    tags0[:k_carry] = prev["tags"][carry_sl]
                    vals0[:k_carry] = prev["vals"][carry_sl]
                if new_idx.size:
                    orig[k_carry:b] = new_idx
                # localize fault coordinates to THIS chunk from the global
                # originals: fresh lanes land in [0, S); carried lanes go
                # negative and no fault phase re-fires
                local = dict(fw)
                local["cycle"] = np.where(fw["kind"] == KIND_REGFILE,
                                          fw["cycle"] - start,
                                          fw["cycle"]).astype(np.int32)
                local["entry"] = np.where(fw["kind"] == KIND_REGFILE,
                                          fw["entry"],
                                          fw["entry"] - start
                                          ).astype(np.int32)
                dev = self.device
                code, frz, conv, tags, vals = self._fast_chunk_body(
                    tr, cov, gold, reg0, self._wave_faults(local),
                    torch.as_tensor(tags0, device=dev),
                    torch.as_tensor(vals0, device=dev),
                    torch.as_tensor(ages, device=dev), horizon,
                    may_latch=may_latch, is_last=is_last, stream=stream)
                code = code.cpu().numpy()[:b]
                frz = frz.cpu().numpy()[:b]
                conv = conv.cpu().numpy()[:b]
                st["waves"] += 1
                st["lanes_run"] += b
                st["chunk_replays"] += B     # padded lanes included
                fbm = code == -2
                st["resolved_frozen"] += int((frz & ~fbm).sum())
                final = code >= 0
                outcomes[orig[:b][final]] = code[final]
                st["resolved_eq"] += int((conv & ~frz & final).sum())
                if is_last:
                    st["resolved_at_end"] += int(
                        (~frz & ~conv & final).sum())
                if fbm.any():
                    fb_ids.append(orig[:b][fbm])
                    st["fallback_lanes"] += int(fbm.sum())
                hz = code == -3
                if hz.any():
                    outcomes[orig[:b][hz]] = C.OUTCOME_SDC
                    st["horizon_sdc"] += int(hz.sum())
                carried = code == -1
                if carried.any():
                    st["carried"] += int(carried.sum())
                    nxt["orig"].append(orig[:b][carried])
                    nxt["age"].append(ages[:b][carried] + 1)
                    nxt["tags"].append(tags.cpu().numpy()[:b][carried])
                    nxt["vals"].append(vals.cpu().numpy()[:b][carried])
                    for name in f_host:
                        nxt["fault"][name].append(fw[name][:b][carried])
            if nxt["orig"]:
                carry = {
                    "orig": np.concatenate(nxt["orig"]),
                    "age": np.concatenate(nxt["age"]),
                    "tags": np.concatenate(nxt["tags"]),
                    "vals": np.concatenate(nxt["vals"]),
                    "fault": {name: np.concatenate(nxt["fault"][name])
                              for name in f_host},
                }
        if fb_ids:
            # escape/overflow lanes re-run per trial on the exact engine
            # (from their landing chunk, fresh age — exactly what an
            # exact-everywhere run would have computed for them)
            ids = np.concatenate(fb_ids)
            sub = {name: f_host[name][ids] for name in f_host}
            sub_out = np.full(ids.size, -1, np.int32)
            self._outcomes_exact(sub, sub_out, land_chunk[ids], st)
            outcomes[ids] = sub_out

    # ---- exact driver ------------------------------------------------------

    def _outcomes_exact(self, f_host, outcomes, land_chunk, st) -> None:
        """Wave driver over the dense per-chunk scan (full reg+mem state
        carried per lane): the reference strategy and the fallback target
        for the taint engine's escapes."""
        n_tr = land_chunk.shape[0]
        B = self._fast_lane_width(n_tr)
        carry: _Carry | None = None
        for c in range(self.C):
            fresh = np.nonzero(land_chunk == c)[0]
            prev, carry = carry, None     # survivors accumulate for c+1
            n_prev = prev.orig.size if prev is not None else 0
            gb_r0 = self._boundary(self.gb_reg, c)
            gb_m0 = self._boundary(self.gb_mem, c)
            gb_r1 = self._boundary(self.gb_reg, c + 1)
            gb_m1 = self._boundary(self.gb_mem, c + 1)
            for carry_sl, new_idx in self._waves(n_prev, fresh, B):
                k_carry = carry_sl.stop - carry_sl.start
                b = k_carry + new_idx.size
                pad = B - b
                # lanes: carried first, then fresh (golden-boundary
                # start), then inert padding
                regs, mems = [], []
                fl: dict[str, list] = {k: [] for k in f_host}
                orig = np.full(B, -1, np.int64)
                ages = np.zeros(B, np.int64)
                if k_carry:
                    regs.append(prev.reg[carry_sl])
                    mems.append(prev.mem[carry_sl])
                    for k in f_host:
                        fl[k].append(prev.fault[k][carry_sl])
                    orig[:k_carry] = prev.orig[carry_sl]
                    ages[:k_carry] = prev.age[carry_sl]
                if b - k_carry + pad:
                    regs.append(gb_r0.expand(b - k_carry + pad, self.nphys))
                    mems.append(gb_m0.expand(b - k_carry + pad,
                                             self.mem_words))
                if new_idx.size:
                    for k in f_host:
                        fl[k].append(f_host[k][new_idx].astype(_dtype(k)))
                    orig[k_carry:b] = new_idx
                if pad:
                    for k in f_host:
                        fl[k].append(np.full(pad, _NULL_LEAVES[k],
                                             _dtype(k)))
                reg_b = torch.cat(regs)
                mem_b = torch.cat(mems)
                fault_np = {k: np.concatenate(fl[k]) for k in f_host}
                reg_o, mem_o, det, trap, div, eq = self._trial_chunk(
                    c, reg_b, mem_b, self._wave_faults(fault_np), gb_r1,
                    gb_m1)
                det, trap, div, eq = (x.cpu().numpy()[:b]
                                      for x in (det, trap, div, eq))
                lane_out = np.where(
                    det, C.OUTCOME_DETECTED,
                    np.where(trap, C.OUTCOME_DUE,
                             np.where(div, C.OUTCOME_SDC,
                                      np.where(eq, C.OUTCOME_MASKED, -1))))
                resolved = lane_out >= 0
                outcomes[orig[:b][resolved]] = lane_out[resolved]
                surv = np.nonzero(~resolved)[0]
                st["waves"] += 1
                st["lanes_run"] += b
                st["chunk_replays"] += B     # padded lanes included
                st["resolved_frozen"] += int((det | trap | div).sum())
                st["resolved_eq"] += int((eq & ~(det | trap | div)).sum())
                if c == self.C - 1:
                    # window end: classify survivors against golden final
                    if surv.size:
                        sidx = torch.as_tensor(surv, device=self.device)
                        none = torch.zeros(surv.size, dtype=torch.bool,
                                           device=self.device)
                        res = ReplayResult(reg=reg_o[sidx], mem=mem_o[sidx],
                                           detected=none, trapped=none,
                                           diverged=none)
                        outcomes[orig[:b][surv]] = C.classify(
                            res, self.golden_final,
                            self.kernel.cfg.compare_regs).cpu().numpy()
                        st["resolved_at_end"] += int(surv.size)
                    continue
                if not surv.size:
                    continue
                surv_age = ages[:b][surv] + 1
                if self.carry_horizon is not None:
                    # divergent past the horizon: SDC without replaying the
                    # rest of the window (conservative)
                    over = surv_age > self.carry_horizon
                    if over.any():
                        outcomes[orig[:b][surv[over]]] = C.OUTCOME_SDC
                        st["horizon_sdc"] += int(over.sum())
                        surv = surv[~over]
                        surv_age = surv_age[~over]
                if surv.size == 0:
                    continue
                st["carried"] += int(surv.size)
                sidx = torch.as_tensor(surv, device=self.device)
                new = _Carry(reg=reg_o[sidx], mem=mem_o[sidx],
                             fault={k: fault_np[k][surv] for k in f_host},
                             orig=orig[:b][surv], age=surv_age)
                carry = new if carry is None else _Carry(
                    reg=torch.cat([carry.reg, new.reg]),
                    mem=torch.cat([carry.mem, new.mem]),
                    fault={k: np.concatenate([carry.fault[k], new.fault[k]])
                           for k in f_host},
                    orig=np.concatenate([carry.orig, new.orig]),
                    age=np.concatenate([carry.age, new.age]))

    def run_keys(self, keys: torch.Tensor, structure: str) -> np.ndarray:
        """Outcome tally (N_OUTCOMES,), the campaign-facing surface."""
        out = self.outcomes_from_keys(keys, structure)
        return np.bincount(out, minlength=C.N_OUTCOMES).astype(np.int64)
