"""The dense trial scan: inject → propagate, batched over lanes.

Port of ``shrewd_tpu/ops/replay.py`` (``TraceArrays``, ``MemMap``,
``_div4``, ``_mulhi``, ``_fp4``, ``_alu`` and ``replay``).  Each lane
carries its full machine state (nphys + mem_words words); a Python loop over
the µop window takes the place of ``lax.scan`` and the lane dimension is
written out where the JAX package used ``vmap``.  The fixed intra-step phase
order is the reference's:

  1. storage-fault landing (REGFILE flip at its cycle)
  2. operand read (with IQ source-index and latch faults applied)
  3. execute (ALU; FU result faults; shadow-FU detection)
  4. memory access (LSQ addr/data faults; trap check → DUE)
  5. branch resolution (divergence check)
  6. writeback/commit (with ROB dest-index faults applied)

**32-bit values.**  Every µop value is an int64 tensor holding a uint32 in
``[0, 2**32)``: torch has no unsigned 32-bit arithmetic on the CPU, and
int64 keeps add, shift, compare and divide exact; results are masked back
with ``M32``.  Signed views go through ``_signed``.

**Maybe-constant predicates.**  Step-uniform facts (the golden opcode, a
step no fault touches) are plain Python values, and the helpers ``_and``,
``_or``, ``_where`` fold them, so a phase whose enable is statically False
launches nothing.  This changes no result: a False enable writes nothing in
the reference either.  The state tensors are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.utils.device import host_sync
from shrewd_tpu_torch.models.o3 import (Fault, KIND_FU, KIND_IQ_SRC1,
                                        KIND_IQ_SRC2, KIND_LATCH_IMM,
                                        KIND_LATCH_OP, KIND_LSQ_ADDR,
                                        KIND_LSQ_DATA, KIND_REGFILE,
                                        KIND_ROB_DST)

M32 = 0xFFFFFFFF
QNAN = 0x7FC00000


class TraceArrays(NamedTuple):
    """Device-resident trace constants (int64 tensors; ``imm`` holds
    uint32 values), plus the host lists the step loops read."""

    opcode: torch.Tensor
    dst: torch.Tensor
    src1: torch.Tensor
    src2: torch.Tensor
    imm: torch.Tensor
    taken: torch.Tensor

    @classmethod
    def from_trace(cls, trace, device) -> "TraceArrays":
        def t(x):
            return torch.as_tensor(x.astype("int64"), device=device)
        return cls(opcode=t(trace.opcode), dst=t(trace.dst),
                   src1=t(trace.src1), src2=t(trace.src2),
                   imm=t(trace.imm), taken=t(trace.taken))

    @property
    def n(self) -> int:
        return int(self.opcode.shape[0])

    def host(self) -> list[tuple[int, ...]]:
        """Per-step (op, dst, src1, src2, imm, taken) as Python ints: one
        device→host copy, read by the step loops for uniform values."""
        with host_sync("trace-host"):
            cols = torch.stack(list(self)).T.tolist()
        return [tuple(c) for c in cols]


class MemMap(NamedTuple):
    """VA-space crash model for lifted traces (the silicon DUE channel),
    as ``shrewd_tpu/ops/replay.py MemMap``.

    The lift compacts the touched address clusters into one dense replay
    array, so "address in [0, mem_words)" is a far denser validity set
    than the host's page map.  With a MemMap the replay un-folds each
    access to its virtual address (replay address − the µop's cluster
    delta) and traps where silicon would: a load outside every mapped
    region, a store outside every writable one.  A valid hit in another
    cluster is routed to that cluster's words; a mapped VA that no
    cluster tracks goes to the scratch word ``mem_words - 1``.  A µop
    with ``uop_cluster < 0`` keeps the dense range test.

    Every field is an int64 tensor; the addresses are low-32 projections
    (uint32 values), as in the replay."""

    uop_cluster: torch.Tensor   # [n]  cluster index per µop (-1: legacy)
    cl_lo: torch.Tensor         # [k]  cluster VA lo
    cl_span: torch.Tensor       # [k]  hi − lo, bytes
    cl_word_off: torch.Tensor   # [k]  word offset in replay memory
    ld_lo: torch.Tensor         # [r]  mapped-region lo (load validity)
    ld_span: torch.Tensor       # [r]
    st_lo: torch.Tensor         # [w]  writable-region lo (store validity)
    st_span: torch.Tensor       # [w]

    def to(self, device) -> "MemMap":
        return MemMap(*(x.to(device) for x in self))


def _memmap_access(mm: MemMap, clu: int, addr, op, mem_words: int,
                   deltas: list):
    """(valid, slot) of a memory access at a µop of cluster ``clu`` ≥ 0
    under the VA map: (B, k) compares against the clusters and regions,
    values in int64 masked to 32 bits."""
    va = (addr - deltas[min(max(clu, 0), len(deltas) - 1)]) & M32
    offs = (va[:, None] - mm.cl_lo) & M32                 # (B, k)
    in_cl = offs < mm.cl_span
    any_cl = in_cl.any(1)
    slot_cl = torch.where(in_cl, (offs >> 2) + mm.cl_word_off, 0).sum(1)
    ld_ok = (((va[:, None] - mm.ld_lo) & M32) < mm.ld_span).any(1) | any_cl
    st_ok = (((va[:, None] - mm.st_lo) & M32) < mm.st_span).any(1)
    valid = _where(op == U.STORE, st_ok, ld_ok)
    slot = torch.where(any_cl, slot_cl, mem_words - 1) & (mem_words - 1)
    return valid, slot


class ReplayResult(NamedTuple):
    reg: torch.Tensor        # int64[B, nphys] final register file
    mem: torch.Tensor        # int64[B, mem_words] final memory
    detected: torch.Tensor   # bool[B] — shadow-FU caught the fault
    trapped: torch.Tensor    # bool[B] — invalid access / #DE / illegal op
    diverged: torch.Tensor   # bool[B] — branch outcome differed from golden


# --- maybe-constant helpers -------------------------------------------------

def _and(*xs):
    """Logical and of bool tensors and Python bools (False short-cuts)."""
    out = True
    for x in xs:
        if x is False:
            return False
        if x is True:
            continue
        out = x if out is True else out & x
    return out


def _or(*xs):
    out = False
    for x in xs:
        if x is True:
            return True
        if x is False:
            continue
        out = x if out is False else out | x
    return out


def _not(x):
    return (not x) if isinstance(x, bool) else ~x


def _where(c, x, y):
    if c is True:
        return x
    if c is False:
        return y
    return torch.where(c, x, y)


def _accum(flag, now):
    """flag |= now, where ``now`` may be a Python bool."""
    if now is False:
        return flag
    return flag | now


# --- 32-bit arithmetic on int64 tensors --------------------------------------

def _signed(x):
    """uint32 value → its int32 reading, as int64."""
    return x - ((x >> 31) << 32)


def _mul32(a, b):
    """low32(a*b) without overflowing int64 (16-bit split of b)."""
    return ((((a * (b >> 16)) & 0xFFFF) << 16) + a * (b & 0xFFFF)) & M32


def _mulhi(a, b):
    """high32(a*b) unsigned, exact: floor((a*bh + floor(a*bl / 2**16))
    / 2**16), every term below 2**49."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def _div_bad(a, b):
    """The x86 #DE predicates: (bad_s, bad_u)."""
    bad_s = (b == 0) | ((a == 0x80000000) & (b == M32))
    return bad_s, b == 0


def _div4(a, b):
    """(div, rem, divu, remu, bad_s, bad_u) with #DE lanes forced to 0,
    as ``shrewd_tpu/ops/replay.py:_div4``."""
    bad_s, bad_u = _div_bad(a, b)
    ai, bi = _signed(a), _signed(b)
    bs = torch.where(bad_s, 1, bi)
    q = torch.div(ai, bs, rounding_mode="trunc")
    r = ai - q * bs
    div = torch.where(bad_s, 0, q) & M32
    rem = torch.where(bad_s, 0, r) & M32
    bu = torch.where(bad_u, 1, b)
    divu = torch.where(bad_u, 0, torch.div(a, bu, rounding_mode="floor"))
    remu = torch.where(bad_u, 0, a % bu)
    return div, rem, divu, remu, bad_s, bad_u


def _fp_flush(bits):
    """Subnormal f32 bit patterns → signed zero (FTZ, the uops.py FP
    contract)."""
    mag = bits & 0x7FFFFFFF
    return torch.where((mag > 0) & (mag < 0x00800000), bits & 0x80000000,
                       bits)


def _as_f32(bits):
    return _signed(_fp_flush(bits)).to(torch.int32).view(torch.float32)


def _canon(r):
    bits = r.view(torch.int32).to(torch.int64) & M32
    return torch.where(torch.isnan(r), QNAN, _fp_flush(bits))


def _fp(op, a, b):
    """One FP µop's canonical result bits: IEEE round-to-nearest float32
    with FTZ inputs/outputs and the canonical quiet NaN."""
    af, bf = _as_f32(a), _as_f32(b)
    if op == U.FADD:
        r = af + bf
    elif op == U.FSUB:
        r = af - bf
    elif op == U.FMUL:
        r = af * bf
    else:
        r = af / bf
    return _canon(r)


def _fp4(a, b):
    return tuple(_fp(op, a, b) for op in (U.FADD, U.FSUB, U.FMUL, U.FDIV))


def _bool(x):
    return x.to(torch.int64)


def _alu_op(op: int, a, b, imm):
    """One opcode's result for every lane (the scalar-opcode ALU; ``op``
    is a Python int).  ``a``/``b`` are tensors, ``imm`` a tensor or int."""
    if op == U.NOP:
        return torch.zeros_like(a)
    if op in (U.ADD, U.SUB, U.AND, U.OR, U.XOR, U.MUL, U.MULHU):
        return {U.ADD: lambda: (a + b) & M32,
                U.SUB: lambda: (a - b) & M32,
                U.AND: lambda: a & b, U.OR: lambda: a | b,
                U.XOR: lambda: a ^ b,
                U.MUL: lambda: _mul32(a, b),
                U.MULHU: lambda: _mulhi(a, b)}[op]()
    if op in (U.SLL, U.SRL, U.SRA):
        sh = b & 31
        if op == U.SLL:
            return (a << sh) & M32
        if op == U.SRL:
            return a >> sh
        return (_signed(a) >> sh) & M32
    if op in (U.ADDI, U.LOAD, U.STORE):
        return (a + imm) & M32
    if op == U.ANDI:
        return a & imm
    if op == U.ORI:
        return a | imm
    if op == U.XORI:
        return a ^ imm
    if op == U.LUI:
        return a * 0 + imm
    if op in (U.SLT, U.BLT):
        return _bool(_signed(a) < _signed(b))
    if op == U.BGE:
        return _bool(_signed(a) >= _signed(b))
    if op == U.SLTU:
        return _bool(a < b)
    if op == U.BEQ:
        return _bool(a == b)
    if op == U.BNE:
        return _bool(a != b)
    if U.DIV <= op <= U.REMU:
        return _div4(a, b)[op - U.DIV]
    if U.FADD <= op <= U.FDIV:
        return _fp(op, a, b)
    raise ValueError(f"opcode {op} out of range")


def _alu(op: torch.Tensor, a, b, imm):
    """Per-lane-opcode ALU: all 32 candidates, selected by ``op``."""
    a, b, imm = torch.broadcast_tensors(a, b, torch.as_tensor(
        imm, dtype=torch.int64, device=a.device))
    cand = torch.stack([_alu_op(o, a, b, imm) for o in range(U.N_OPCODES)])
    idx = op.to(torch.int64).expand(a.shape)[None]
    return cand.gather(0, idx)[0]


def op_flags(op):
    """(is_ld, is_st, is_br, writes_op, is_div_s, is_div_u) of an opcode
    that is a Python int (→ bools) or a per-lane tensor (→ bool tensors)."""
    return (op == U.LOAD, op == U.STORE, (op >= U.BEQ) & (op <= U.BGE),
            ((op >= U.ADD) & (op <= U.REMU)) | ((op >= U.FADD)
                                                & (op <= U.MULHU)),
            (op == U.DIV) | (op == U.REM), (op == U.DIVU) | (op == U.REMU))


def lane_op(op0: int, latch_flip):
    """The opcode a lane executes: the golden one, or (LATCH_OP lanes at
    this µop) its flipped int32 reading, which is illegal outside
    [0, N_OPCODES) and clipped into it → (op, illegal-before-live)."""
    if latch_flip is False:
        return op0, False
    opv = _signed((op0 ^ latch_flip) & M32)
    illegal = (opv >= U.N_OPCODES) | (opv < 0)
    return opv.clamp(0, U.N_OPCODES - 1), illegal


class FaultPlan:
    """Per-batch fault predicates for the step loops.  ``here(kind, i)``
    is ``(fault.kind == kind) & (i + offset == fault.entry)`` as a bool
    tensor, or False when no lane of that kind is struck at µop i (host
    sets built with one device→host copy).  ``offset`` is the global index
    of step 0 (a chunk's start, ``replay``'s ``index_offset``): the fault
    coordinates stay global.  ``mask`` is ``1 << bit``: the reference's
    uint32 value flip mask and int32 index flip mask carry the same bits,
    so one int64 mask serves both."""

    def __init__(self, faults: Fault, offset: int = 0):
        self.offset = int(offset)
        self.kind = faults.kind.to(torch.int64)
        self.cycle = faults.cycle.to(torch.int64)
        self.entry = faults.entry.to(torch.int64)
        self.shadow_u = faults.shadow_u
        self.mask = faults.bit_as_index_mask()
        with host_sync("fault-plan"):
            kinds, cycles, entries = torch.stack(
                [self.kind, self.cycle, self.entry]).tolist()
        self.flip_steps = {c for kd, c in zip(kinds, cycles)
                           if kd == KIND_REGFILE}
        self.uop_steps: dict[int, set] = {}
        for kd, e in zip(kinds, entries):
            if kd != KIND_REGFILE:
                self.uop_steps.setdefault(kd, set()).add(e)

    def flip(self, i: int):
        i += self.offset
        if i not in self.flip_steps:
            return False
        return (self.kind == KIND_REGFILE) & (self.cycle == i)

    def here(self, kind: int, i: int):
        i += self.offset
        if i not in self.uop_steps.get(kind, ()):
            return False
        return (self.kind == kind) & (self.entry == i)

    def xor_mask(self, kind: int, i: int):
        """The flip mask on lanes struck by ``kind`` at µop i, else 0."""
        h = self.here(kind, i)
        return False if h is False else torch.where(h, self.mask, 0)


def _xor(x, m):
    return x if m is False else x ^ m


def _read(reg, lanes, idx, idx_mask):
    """Per-lane register read: a copy, never a view of ``reg``."""
    if torch.is_tensor(idx):
        return reg[lanes, idx & idx_mask]
    return reg[:, idx].clone()


def replay(tr: TraceArrays, init_reg: torch.Tensor, init_mem: torch.Tensor,
           faults: Fault, shadow_cov: torch.Tensor,
           memmap=None, index_offset: int = 0) -> ReplayResult:
    """Propagate a batch of trials over the whole window (dense state).

    ``init_reg``/``init_mem`` are the start state (int64 tensors of uint32
    values): one ``(nphys,)`` / ``(mem_words,)`` state for every lane, or
    one per lane, ``(B, nphys)`` / ``(B, mem_words)``.  ``shadow_cov`` is
    the per-µop detection probability.  ``index_offset`` is the global
    index of ``tr``'s first µop: the chunked path (``ops/chunked.py``)
    passes a chunk's start, so the faults' global coordinates land inside
    the chunk.  ``memmap`` (lifted traces only) switches the memory trap
    test from the dense range to the VA map (``MemMap``); its
    ``uop_cluster`` covers ``tr``'s µops."""
    dev = init_reg.device
    nphys = init_reg.shape[-1]
    mem_words = init_mem.shape[-1]
    idx_mask = nphys - 1
    B = faults.kind.shape[0]
    fp = FaultPlan(faults, index_offset)
    lanes = torch.arange(B, device=dev)
    reg = init_reg.to(torch.int64).expand(B, nphys).clone()
    mem = init_mem.to(torch.int64).expand(B, mem_words).clone()
    live = torch.ones(B, dtype=torch.bool, device=dev)
    detected = torch.zeros_like(live)
    trapped = torch.zeros_like(live)
    diverged = torch.zeros_like(live)
    ftag = fp.entry & idx_mask
    with host_sync("shadow-cov"):
        sc_host = shadow_cov.tolist()
    clu_host = None
    if memmap is not None:
        memmap = memmap.to(dev)
        clu_host = memmap.uop_cluster.tolist()
        # per-cluster fold delta, 4·word_off − lo (mod 2**32)
        deltas = [(4 * w - lo) & M32 for w, lo in zip(
            memmap.cl_word_off.tolist(), memmap.cl_lo.tolist())]

    for i, (op0, dstr, s1, s2, imm0, tk) in enumerate(tr.host()):
        # 1. storage-fault landing (entry masked to the register space)
        flip = fp.flip(i)
        if flip is not False:
            cur = reg[lanes, ftag]
            reg[lanes, ftag] = torch.where(flip, cur ^ fp.mask, cur)

        # 2. operand read with latch and IQ index faults
        op, illegal = lane_op(op0, fp.xor_mask(KIND_LATCH_OP, i))
        illegal_now = _and(illegal, live)
        imm = _xor(imm0, fp.xor_mask(KIND_LATCH_IMM, i))
        a = _read(reg, lanes, _xor(s1, fp.xor_mask(KIND_IQ_SRC1, i)),
                  idx_mask)
        b = _read(reg, lanes, _xor(s2, fp.xor_mask(KIND_IQ_SRC2, i)),
                  idx_mask)

        # 3. execute
        raw = _alu(op, a, b, imm) if torch.is_tensor(op) \
            else _alu_op(op, a, b, imm)
        fu = fp.here(KIND_FU, i)
        eff = _xor(raw, fp.xor_mask(KIND_FU, i))
        detected_now = _and(fu, live, fp.shadow_u < sc_host[i]) \
            if fu is not False else False
        is_ld, is_st, is_br, writes_op, div_s, div_u = op_flags(op)

        # 4. memory access with LSQ faults; x86 #DE on a bad divisor
        is_mem = _or(is_ld, is_st)
        mem_trap = False
        if is_mem is not False:
            addr = _xor(eff, fp.xor_mask(KIND_LSQ_ADDR, i))
            if clu_host is not None and clu_host[i] >= 0:
                valid, slot = _memmap_access(memmap, clu_host[i], addr, op,
                                             mem_words, deltas)
            else:
                valid = ((addr & 3) == 0) & ((addr >> 2) < mem_words)
                slot = (addr >> 2) & (mem_words - 1)
            mem_trap = _and(is_mem, ~valid, live)
        div_trap = False
        if _or(div_s, div_u) is not False:
            bad_s, bad_u = _div_bad(a, b)
            div_trap = _and(_or(_and(div_s, bad_s), _and(div_u, bad_u)),
                            live)
        trapped_now = _or(mem_trap, illegal_now, div_trap)

        # 5. branch resolution: effective control flow vs the golden one
        diverged_now = _and(_and(is_br, eff != 0) != bool(tk), live)

        stop = _or(detected_now, trapped_now, diverged_now)
        live_next = live if stop is False else live & ~stop

        # 6. writeback/commit with the ROB dest-index fault (every value
        # is read from the pre-step state before either update)
        writes = _and(_or(writes_op, is_ld), live_next)
        do_store = _and(is_st, valid, live_next) if is_st is not False \
            else False
        if writes is not False:
            result = eff if is_ld is False else \
                _where(is_ld, mem[lanes, slot], eff)
            de = _xor(dstr, fp.xor_mask(KIND_ROB_DST, i))
            if torch.is_tensor(de):
                de = de & idx_mask
                reg[lanes, de] = torch.where(writes, result, reg[lanes, de])
            else:
                reg[:, de] = torch.where(writes, result, reg[:, de])
        if do_store is not False:
            st_data = _xor(b, fp.xor_mask(KIND_LSQ_DATA, i))
            mem[lanes, slot] = torch.where(do_store, st_data,
                                           mem[lanes, slot])

        live = live_next
        detected = _accum(detected, detected_now)
        trapped = _accum(trapped, trapped_now)
        diverged = _accum(diverged, diverged_now)

    return ReplayResult(reg=reg, mem=mem, detected=detected,
                        trapped=trapped, diverged=diverged)
