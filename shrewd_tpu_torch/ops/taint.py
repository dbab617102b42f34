"""Deviation-set ("taint") trial scan: the plain PyTorch fast pass and the
row pass.

Port of ``shrewd_tpu/ops/taint.py``.  A trial differs from the golden run
only where its fault propagated, so each lane carries a bounded *deviation
set* — k (tag, value) slots, tag = register r or ``nphys + w`` for memory
word w, EMPTY = −1 — and each step reads the golden run's per-step values
(uniform across lanes) plus O(k) lookups.

- ``record_golden`` records those golden streams (and, within the
  ``taint_*_timeline_mb`` budgets, the register/memory timelines);
  ``record_chunk`` records one chunk's streams through the serial C++
  recorder (``native.record_chunk``), with no step loop;
- ``fault_setup`` / ``setup_scan`` gather each lane's one-time setup values;
  ``setup_gather`` computes ``setup_scan``'s values from a chunk's record
  with one sort and one ``searchsorted``, with no step loop;
- ``taint_replay`` runs the scan: without the memory timeline it is the
  **plain version of the fast-pass kernel** (``ops/taint_cuda.py``; a load
  at an address the golden run did not touch this step *escapes*), with it
  it is the row pass that resolves those loads exactly;
- ``taint_chunk`` is the same scan over one chunk, seeded with the carried
  deviation sets: the **plain version of the chunk kernel**.

Exactness: outcomes equal the dense scan's (``ops/replay.py``) except on
lanes flagged escaped or overflowed, which the hybrid path
(``ops/trial.py``) re-runs.  Values are int64 tensors of uint32 (see
``ops/replay.py``); the step-uniform maybe-constant folding is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shrewd_tpu_torch import native
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import (Fault, KIND_FU, KIND_IQ_SRC1,
                                        KIND_IQ_SRC2, KIND_LATCH_IMM,
                                        KIND_LATCH_OP, KIND_LSQ_ADDR,
                                        KIND_LSQ_DATA, KIND_ROB_DST)
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.utils.device import host_sync
from shrewd_tpu_torch.ops.replay import (FaultPlan, M32, TraceArrays,
                                         _accum, _alu, _alu_op, _and,
                                         _div_bad, _not, _or, _where, _xor,
                                         lane_op, op_flags)

EMPTY = -1


class GoldenRecord(NamedTuple):
    """Golden-run streams consumed by the deviation-set scan (int64 values
    of uint32; bool flags), on the kernel's device."""

    a: torch.Tensor          # [n] operand 1 value
    b: torch.Tensor          # [n] operand 2 value
    ea: torch.Tensor         # [n] ALU / effective-address output
    res: torch.Tensor        # [n] writeback value (post-load for loads)
    st_old: torch.Tensor     # [n] pre-store content of the store target
    dst_old: torch.Tensor    # [n] pre-write content of the dest register
    wr: torch.Tensor         # bool[n] golden writes a register this step
    is_ld: torch.Tensor      # bool[n]
    is_st: torch.Tensor      # bool[n]
    reg_t: torch.Tensor | None   # [n, nphys] reg state BEFORE step i
    mem_t: torch.Tensor | None   # [n, mem_words] mem state BEFORE step i
    final_reg: torch.Tensor  # [nphys]
    final_mem: torch.Tensor  # [mem_words]

    def host(self) -> list[tuple]:
        """Per-step (a, b, ea, res, st_old, dst_old, wr, ld, st) as Python
        values — one device→host copy for the step loops."""
        with host_sync("golden-host"):
            cols = torch.stack([self.a, self.b, self.ea, self.res,
                                self.st_old, self.dst_old, self.wr.long(),
                                self.is_ld.long(),
                                self.is_st.long()]).T.tolist()
        return [tuple(c[:6]) + (bool(c[6]), bool(c[7]), bool(c[8]))
                for c in cols]


class TaintResult(NamedTuple):
    outcome: torch.Tensor    # int32[B] — valid iff not escaped/overflowed
    escaped: torch.Tensor    # bool[B] — load at unresolved address
    overflow: torch.Tensor   # bool[B] — deviation set full
    tags: torch.Tensor | None = None   # int64[B, k] final deviation set
    vals: torch.Tensor | None = None   # int64[B, k]
    steps: torch.Tensor | None = None  # int32[B] steps each lane ran live


def record_golden(tr: TraceArrays, init_reg: torch.Tensor,
                  init_mem: torch.Tensor, mem_timeline: bool,
                  reg_timeline: bool = True) -> GoldenRecord:
    """One fault-free recording replay → GoldenRecord, on the device of
    ``init_reg``.  The timelines are recorded only when asked (callers
    check the ``taint_*_timeline_mb`` budgets)."""
    dev = init_reg.device
    n = tr.n
    nphys, mem_words = init_reg.shape[0], init_mem.shape[0]
    reg = init_reg.to(torch.int64).clone()
    mem = init_mem.to(torch.int64).clone()
    streams = torch.empty((6, n), dtype=torch.int64, device=dev)
    reg_t = torch.empty((n, nphys), dtype=torch.int64, device=dev) \
        if reg_timeline else None
    mem_t = torch.empty((n, mem_words), dtype=torch.int64, device=dev) \
        if mem_timeline else None
    for i, (op, dstr, s1, s2, imm, _tk) in enumerate(tr.host()):
        a, b = reg[s1], reg[s2]
        eff = _alu_op(op, a, b, imm)
        slot = (eff >> 2) & (mem_words - 1)
        st_old = mem[slot]                 # pre-store content == load value
        res = st_old if op == U.LOAD else eff
        streams[:, i] = torch.stack([a, b, eff, res, st_old, reg[dstr]])
        if reg_t is not None:
            reg_t[i] = reg
        if mem_t is not None:
            mem_t[i] = mem
        if op == U.STORE:
            mem[slot] = b
        if U.writes_dest(op):
            reg[dstr] = res
    op_np = tr.opcode.cpu().numpy()

    def flag(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    return GoldenRecord(
        a=streams[0], b=streams[1], ea=streams[2], res=streams[3],
        st_old=streams[4], dst_old=streams[5],
        wr=flag(U.writes_dest(op_np)), is_ld=flag(U.is_load(op_np)),
        is_st=flag(U.is_store(op_np)), reg_t=reg_t, mem_t=mem_t,
        final_reg=reg, final_mem=mem)


def record_chunk(tr: TraceArrays, init_reg: torch.Tensor,
                 init_mem: torch.Tensor, final_reg: torch.Tensor,
                 final_mem: torch.Tensor) -> GoldenRecord:
    """One chunk's golden streams, from the chunk's start state (port of
    ``shrewd_tpu/ops/chunked.py:861-901 _record_chunk``).  The six value
    streams come from one serial C++ pass on the host
    (``native.record_chunk``, the oracle's ALU), the flags from the
    opcode; ``final_reg``/``final_mem`` are the chunk-end boundary, kept
    as given.  No timelines.  On the device of ``init_reg``."""
    dev = init_reg.device
    host = torch.stack(list(tr)).cpu().numpy()
    view = native.chunk_view(
        dict(zip(TraceArrays._fields, host)), 0, tr.n,
        init_reg.cpu().numpy(), init_mem.cpu().numpy())
    op_np = host[TraceArrays._fields.index("opcode")]
    wr = U.writes_dest(op_np)
    streams = native.record_chunk(view, wr)
    st = torch.as_tensor(streams.astype("int64"), device=dev)

    def flag(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    return GoldenRecord(a=st[0], b=st[1], ea=st[2], res=st[3],
                        st_old=st[4], dst_old=st[5], wr=flag(wr),
                        is_ld=flag(U.is_load(op_np)),
                        is_st=flag(U.is_store(op_np)), reg_t=None,
                        mem_t=None, final_reg=final_reg, final_mem=final_mem)


# --- deviation-set primitives on (B, k) sets (tags unique or EMPTY) -------

def _col(x):
    return x[:, None] if torch.is_tensor(x) and x.dim() == 1 else x


def _lookup(tags, vals, tag):
    hit = tags == _col(tag)
    return hit.any(1), torch.where(hit, vals, 0).sum(1) & M32


def _set(tags, vals, tag, val, enable):
    """Update-or-insert (tag, val) where enabled: the first matching slot,
    else the first empty one → (tags, vals, overflow = enabled & full)."""
    if enable is False:
        return tags, vals, False
    k = tags.shape[1]
    iota = torch.arange(k, device=tags.device)
    hit = tags == _col(tag)
    hit_idx = torch.where(hit, iota, k).amin(1)
    empty_idx = torch.where(tags == EMPTY, iota, k).amin(1)
    slot = torch.where(hit_idx < k, hit_idx, empty_idx)
    can = slot < k
    m = (iota == slot[:, None]) & (enable & can)[:, None]
    return (torch.where(m, _col(tag), tags), torch.where(m, _col(val), vals),
            enable & ~can)


def _remove(tags, tag, enable):
    if enable is False:
        return tags
    return torch.where((tags == _col(tag)) & _col(enable), EMPTY, tags)


def fault_setup(gold: GoldenRecord, tr: TraceArrays, faults: Fault):
    """One-time per-lane gathers from the register timeline →
    (gold_at_fault, alt1, alt2): the content of the flipped register when
    a REGFILE flip lands, and the golden values of the alternate registers
    an IQ-faulted µop reads."""
    nphys = gold.final_reg.shape[0]
    idx_mask = nphys - 1
    n = tr.n
    index_mask = faults.bit_as_index_mask()
    entry = faults.entry.to(torch.int64)
    cyc = faults.cycle.to(torch.int64).clamp(0, n - 1)
    gold_at_fault = gold.reg_t[cyc, entry & idx_mask]
    e = entry.clamp(0, n - 1)
    alt1 = gold.reg_t[e, (tr.src1[e] ^ index_mask) & idx_mask]
    alt2 = gold.reg_t[e, (tr.src2[e] ^ index_mask) & idx_mask]
    return gold_at_fault, alt1, alt2


def setup_scan(tr: TraceArrays, init_reg: torch.Tensor,
               init_mem: torch.Tensor, faults: Fault):
    """``fault_setup``'s three values without the register timeline: one
    golden replay that captures, at each step, the lanes whose capture
    point it is (state BEFORE the step)."""
    nphys = init_reg.shape[0]
    mem_words = init_mem.shape[0]
    idx_mask = nphys - 1
    n = tr.n
    index_mask = faults.bit_as_index_mask()
    entry = faults.entry.to(torch.int64)
    cycle = faults.cycle.to(torch.int64)
    e = entry.clamp(0, n - 1)
    gaf_reg = entry & idx_mask
    alt1_reg = (tr.src1[e] ^ index_mask) & idx_mask
    alt2_reg = (tr.src2[e] ^ index_mask) & idx_mask
    capture = set(cycle.tolist()) | set(e.tolist())
    reg = init_reg.to(torch.int64).clone()
    mem = init_mem.to(torch.int64).clone()
    gaf = torch.zeros_like(entry)
    alt1 = torch.zeros_like(entry)
    alt2 = torch.zeros_like(entry)
    for i, (op, dstr, s1, s2, imm, _tk) in enumerate(tr.host()):
        if i in capture:
            gaf = torch.where(cycle == i, reg[gaf_reg], gaf)
            alt1 = torch.where(e == i, reg[alt1_reg], alt1)
            alt2 = torch.where(e == i, reg[alt2_reg], alt2)
        a, b = reg[s1], reg[s2]
        eff = _alu_op(op, a, b, imm)
        slot = (eff >> 2) & (mem_words - 1)
        res = mem[slot] if op == U.LOAD else eff
        if op == U.STORE:
            mem[slot] = b
        if U.writes_dest(op):
            reg[dstr] = res
    return gaf, alt1, alt2


def setup_gather(gold: GoldenRecord, tr: TraceArrays,
                 init_reg: torch.Tensor, faults: Fault):
    """``setup_scan``'s three per-lane values, bit for bit, from a
    recording without the register timeline and without a step loop.

    The register r before step i is ``res[j]`` of the last step j < i
    that wrote r, else ``init_reg[r]``.  The writes are sorted by
    ``(register, step)`` once; one ``searchsorted`` finds j for every
    lane.  As in ``setup_scan``, ``gold_at_fault`` is 0 on a lane whose
    ``cycle`` is not a step of ``tr`` (a carried lane, a lane of another
    chunk), and the alternates are read at ``clip(entry, 0, n - 1)``."""
    nphys = init_reg.shape[0]
    idx_mask = nphys - 1
    n = tr.n
    dev = init_reg.device
    index_mask = faults.bit_as_index_mask()
    entry = faults.entry.to(torch.int64)
    cycle = faults.cycle.to(torch.int64)
    e = entry.clamp(0, n - 1)
    wj = torch.nonzero(gold.wr).flatten()
    key, order = torch.sort(tr.dst[wj] * n + wj)
    # a sentinel above every query keeps the gathers in range
    key = torch.cat([key, torch.tensor([nphys * n], device=dev)])
    wj = torch.cat([wj[order], torch.zeros(1, dtype=wj.dtype, device=dev)])

    def before(r, i):
        pos = torch.searchsorted(key, r * n + i) - 1
        j = pos.clamp(min=0)
        hit = (pos >= 0) & (key[j] // n == r)
        return torch.where(hit, gold.res[wj[j]], init_reg[r])

    in_tr = (cycle >= 0) & (cycle < n)
    gaf = torch.where(in_tr, before(entry & idx_mask, cycle.clamp(0, n - 1)),
                      0)
    alt1 = before((tr.src1[e] ^ index_mask) & idx_mask, e)
    alt2 = before((tr.src2[e] ^ index_mask) & idx_mask, e)
    return gaf, alt1, alt2


def _scan_deviation(gold: GoldenRecord, tr: TraceArrays, faults: Fault,
                    shadow_cov: torch.Tensor, k: int, setup,
                    may_latch: bool = True, init_sets=None):
    """The deviation-set scan over every µop of ``tr`` for a lane batch →
    the final ``(tags, vals, steps, detected, trapped, diverged, escaped,
    overflowed)``, ``steps`` counting the steps each lane ran live.  With
    ``gold.mem_t`` a load at a non-golden address reads the timeline row;
    without it, it escapes.  ``may_latch=False`` ignores LATCH_OP faults
    (the kernel's scalar-opcode variant).  ``init_sets`` = ``(tags0,
    vals0)``, each ``(B, k)``, seeds the sets (a chunk's carried state);
    None starts them EMPTY."""
    nphys = gold.final_reg.shape[0]
    mem_words = gold.final_mem.shape[0]
    idx_mask = nphys - 1
    dev = gold.final_reg.device
    B = faults.kind.shape[0]
    if setup is None:
        setup = fault_setup(gold, tr, faults)
    gold_at_fault, alt1, alt2 = setup
    fp = FaultPlan(faults)
    mask = fp.mask
    ftag = fp.entry & idx_mask
    mem_t = gold.mem_t

    if init_sets is None:
        tags = torch.full((B, k), EMPTY, dtype=torch.int64, device=dev)
        vals = torch.zeros((B, k), dtype=torch.int64, device=dev)
    else:
        tags = init_sets[0].to(torch.int64).clone()
        vals = init_sets[1].to(torch.int64) & M32
    live = torch.ones(B, dtype=torch.bool, device=dev)
    detected = torch.zeros_like(live)
    trapped = torch.zeros_like(live)
    diverged = torch.zeros_like(live)
    escaped = torch.zeros_like(live)
    overflowed = torch.zeros_like(live)
    steps = torch.full((B,), tr.n, dtype=torch.int32, device=dev)
    with host_sync("shadow-cov"):
        sc_host = shadow_cov.tolist()

    for i, ((op0, dstr, s1, s2, imm0, tk),
            (g_a, g_b, g_ea, g_res, g_st_old, g_dst_old, g_wr, g_ld, g_st)) \
            in enumerate(zip(tr.host(), gold.host())):
        # 1. storage-fault landing (REGFILE), tag masked to the registers
        flip = fp.flip(i)
        ovf0 = False
        if flip is not False:
            f0, v0 = _lookup(tags, vals, ftag)
            content = torch.where(f0, v0, gold_at_fault)
            tags, vals, ovf0 = _set(tags, vals, ftag, content ^ mask,
                                    flip & live)

        # 2. operand read (latch + IQ index faults)
        if may_latch:
            op, illegal = lane_op(op0, fp.xor_mask(KIND_LATCH_OP, i))
        else:
            op, illegal = op0, False
        illegal_now = _and(illegal, live)
        imm = _xor(imm0, fp.xor_mask(KIND_LATCH_IMM, i))
        iq1 = fp.here(KIND_IQ_SRC1, i)
        iq2 = fp.here(KIND_IQ_SRC2, i)
        f1, v1 = _lookup(tags, vals, _where(iq1, (s1 ^ mask)
                                            & idx_mask, s1))
        f2, v2 = _lookup(tags, vals, _where(iq2, (s2 ^ mask)
                                            & idx_mask, s2))
        a = torch.where(f1, v1, _where(iq1, alt1, g_a))
        b = torch.where(f2, v2, _where(iq2, alt2, g_b))

        # 3. execute
        raw = _alu(op, a, b, imm) if torch.is_tensor(op) \
            else _alu_op(op, a, b, imm)
        fu = fp.here(KIND_FU, i)
        eff = _xor(raw, fp.xor_mask(KIND_FU, i))
        detected_now = _and(fu, live, fp.shadow_u < sc_host[i]) \
            if fu is not False else False
        is_ld, is_st, is_br, writes_op, div_s, div_u = op_flags(op)

        # 4. memory access; x86 #DE on a bad divisor
        is_mem = _or(is_ld, is_st)
        slot_g = (g_ea >> 2) & (mem_words - 1)
        gtag = nphys + slot_g
        valid = same_slot = mtag = slot = None
        mem_trap = False
        if is_mem is not False:
            addr = _xor(eff, fp.xor_mask(KIND_LSQ_ADDR, i))
            valid = ((addr & 3) == 0) & ((addr >> 2) < mem_words)
            slot = (addr >> 2) & (mem_words - 1)
            mtag = nphys + slot
            same_slot = slot == slot_g
            mem_trap = _and(is_mem, ~valid, live)
        div_trap = False
        if _or(div_s, div_u) is not False:
            bad_s, bad_u = _div_bad(a, b)
            div_trap = _and(_or(_and(div_s, bad_s), _and(div_u, bad_u)),
                            live)
        trapped_now = _or(mem_trap, illegal_now, div_trap)

        # 4a. load value: deviation entry > golden same-slot value >
        # golden memory-timeline row (row pass) > escape (fast pass)
        ldval = None
        escaped_now = False
        if is_ld is not False:
            fm, vm = _lookup(tags, vals, mtag)
            golden_here = _and(same_slot, g_ld or g_st)
            g_mem_val = g_res if g_ld else g_st_old
            if mem_t is not None:
                ldval = torch.where(fm, vm, _where(golden_here, g_mem_val,
                                                   mem_t[i][slot]))
            else:
                ldval = torch.where(fm, vm, _where(golden_here, g_mem_val,
                                                   0))
                escaped_now = _and(is_ld, valid, live, _not(trapped_now),
                                   ~fm, _not(golden_here))

        # 5. branch resolution
        diverged_now = _and(_and(is_br, eff != 0) != bool(tk), live)

        stop = _or(detected_now, trapped_now, diverged_now, escaped_now)
        live_next = live if stop is False else live & ~stop

        # 4b. store updates: the trial's store, then a golden store the
        # trial missed
        ovf1 = ovf2 = False
        st_t = _and(is_st, valid, live_next) if is_st is not False \
            else False
        if st_t is not False:
            st_data = _xor(b, fp.xor_mask(KIND_LSQ_DATA, i))
            match_st = _and(st_t, g_st, same_slot, st_data == g_b)
            tags = _remove(tags, mtag, match_st)
            tags, vals, ovf1 = _set(tags, vals, mtag, st_data,
                                    _and(st_t, _not(match_st)))
        if g_st:
            miss_st = _and(live_next, _not(_and(st_t, same_slot)))
            fg, vg = _lookup(tags, vals, gtag)
            content_g = torch.where(fg, vg, g_st_old)
            m_coinc = _and(miss_st, content_g == g_b)
            tags = _remove(tags, gtag, m_coinc)
            tags, vals, ovf2 = _set(tags, vals, gtag, content_g,
                                    _and(miss_st, _not(m_coinc)))

        # 6. writeback (a ROB dest-index fault redirects the write), then
        # a golden register write the trial missed
        ovf3 = ovf4 = False
        writes_t = _and(_or(writes_op, is_ld), live_next)
        same_dst = None
        if writes_t is not False:
            rob = fp.here(KIND_ROB_DST, i)
            result = eff if is_ld is False else _where(is_ld, ldval, eff)
            wtag = _where(rob, (dstr ^ mask) & idx_mask, dstr)
            same_dst = True if rob is False else wtag == dstr
            g_post = g_res if g_wr else g_dst_old
            match_w = _and(writes_t, same_dst, result == g_post)
            tags = _remove(tags, dstr, match_w)
            tags, vals, ovf3 = _set(tags, vals, wtag, result,
                                    _and(writes_t, _not(match_w)))
        if g_wr:
            miss_w = _and(live_next, _not(_and(writes_t, same_dst)))
            fd, vd = _lookup(tags, vals, dstr)
            content_d = torch.where(fd, vd, g_dst_old)
            w_coinc = _and(miss_w, content_d == g_res)
            tags = _remove(tags, dstr, w_coinc)
            tags, vals, ovf4 = _set(tags, vals, dstr, content_d,
                                    _and(miss_w, _not(w_coinc)))

        overflow_now = _or(ovf0, ovf1, ovf2, ovf3, ovf4)
        if overflow_now is not False:
            live_next = live_next & ~overflow_now
            overflowed = overflowed | overflow_now
        if live_next is not live:
            steps = torch.where(live & ~live_next, i + 1, steps)
        live = live_next
        detected = _accum(detected, detected_now)
        trapped = _accum(trapped, trapped_now)
        diverged = _accum(diverged, diverged_now)
        escaped = _accum(escaped, escaped_now)

    return (tags, vals, steps, detected, trapped, diverged, escaped,
            overflowed)


def end_outcome(gold: GoldenRecord, tags, vals, detected, trapped,
                diverged, compare_regs: bool) -> torch.Tensor:
    """End classification: a surviving deviation that differs from the
    golden FINAL state is corruption (memory only without compare_regs)."""
    nphys = gold.final_reg.shape[0]
    final_state = torch.cat([gold.final_reg, gold.final_mem])
    ent = tags != EMPTY
    differs = ent & (vals != final_state[torch.where(ent, tags, 0)])
    if not compare_regs:
        differs = differs & (tags >= nphys)
    return C.outcome_of(detected, trapped, diverged | differs.any(1))


def taint_replay(gold: GoldenRecord, tr: TraceArrays, faults: Fault,
                 shadow_cov: torch.Tensor, k: int = 16,
                 compare_regs: bool = True, setup=None,
                 may_latch: bool = True) -> TaintResult:
    """A lane batch via deviation tracking; every dense fault kind is
    supported.  ``setup`` optionally supplies the lanes' precomputed
    ``(gold_at_fault, alt1, alt2)`` (from ``setup_scan``)."""
    (tags, vals, steps, detected, trapped, diverged, escaped,
     overflowed) = _scan_deviation(gold, tr, faults, shadow_cov, k, setup,
                                   may_latch)
    outcome = end_outcome(gold, tags, vals, detected, trapped, diverged,
                          compare_regs)
    return TaintResult(outcome=outcome, escaped=escaped, overflow=overflowed,
                       tags=tags, vals=vals, steps=steps)


def taint_fast_plain(gold: GoldenRecord, tr: TraceArrays,
                     shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                     alt1, alt2, k: int = 16, compare_regs: bool = True,
                     may_latch: bool = True) -> TaintResult:
    """The plain PyTorch version of the fast-pass kernel
    (``ops/taint_cuda.py taint_fast_cuda``, same signature): the scan
    without the memory timeline, so loads at non-golden addresses
    escape.  ``taint_fast_plain.card_calls`` counts its calls on card
    tensors, where the kernel's wrapper never calls it."""
    if faults.kind.device.type != "cpu":
        taint_fast_plain.card_calls += 1
    return taint_replay(gold._replace(mem_t=None), tr, faults, shadow_cov,
                        k=k, compare_regs=compare_regs,
                        setup=(gold_at_fault, alt1, alt2),
                        may_latch=may_latch)


taint_fast_plain.card_calls = 0


def taint_chunk(gold: GoldenRecord, tr: TraceArrays,
                shadow_cov: torch.Tensor, faults: Fault, gold_at_fault,
                alt1, alt2, tags0, vals0, k: int = 16,
                may_latch: bool = True):
    """One chunk of a lane batch via deviation tracking: the plain PyTorch
    version of the chunk kernel (``ops/taint_cuda.py taint_chunk_cuda``,
    same signature).  Port of ``shrewd_tpu/ops/taint.py:402-417``.

    ``gold``/``tr``/``shadow_cov`` cover one chunk; the fault coordinates
    are localized to it (a carried lane's go negative and no fault phase
    re-fires).  ``tags0``/``vals0`` ``(B, k)`` are the sets carried in
    (EMPTY/0 for a lane starting in its landing chunk).  Returns the raw
    ``(tags, vals, steps, detected, trapped, diverged, escaped,
    overflowed)``; convergence, horizon and end classification are the
    chunked driver's (``ops/chunked.py``)."""
    return _scan_deviation(gold._replace(mem_t=None), tr, faults,
                           shadow_cov, k, (gold_at_fault, alt1, alt2),
                           may_latch, init_sets=(tags0, vals0))
