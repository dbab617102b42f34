"""Ruby cache SRAM SEU model: cache-line AVF by lifetime analysis (the
port of ``shrewd_tpu/models/ruby.py``).

The golden cache behaviour is deterministic and fault-independent (an SEU
in a cache payload never changes *which* lines move, only the bytes they
carry), so the model splits in two:

1. **Host-side timeline build** (once per trace, numpy): a set-associative
   LRU write-back cache simulation over the golden memory-access stream
   emits, per SRAM slot, the event timeline that decides any fault's fate —
   word-granular data events (CONSUME, OVERWRITE, INVALIDATE) and
   line-granular tag/state events carrying (valid, dirty)-after-event.
   The access stream comes from the C++ golden pass
   (``native.record_chunk``'s effective addresses), where the reference
   replays the trace in Python.

2. **Device-side classification** (per trial, batched): a fault at (slot,
   word, bit, cycle) is classified by a binary search over the sorted
   timelines (``torch.searchsorted``) and a few gathers — no scan.  The
   first data event on the faulted word after the fault cycle decides:
   CONSUME → SDC, OVERWRITE/INVALIDATE → masked; tag/state faults read the
   line's (valid, dirty) at the fault cycle: valid∧dirty → SDC, else
   masked.  A fault still sitting in a valid dirty line at the window's end
   counts as SDC.

Protection (``parity`` / ``ecc`` per array) maps a consumed corruption to
DUE (parity) or MASKED (SECDED ECC).  A two-level hierarchy (private L1 +
shared L2) chains two simulations: L1 misses and dirty writebacks form the
L2 access stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.models.tier import TierKernel
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import ConfigObject, Param
from shrewd_tpu_torch.utils.device import resolve as resolve_device

# word-event types
EV_CONSUME = 0     # corrupted bits reach architecture → SDC
EV_OVERWRITE = 1   # slot rewritten before any read → masked
EV_INVALIDATE = 2  # line dropped clean → masked
EV_NAMES = ["consume", "overwrite", "invalidate"]

PROT_NONE = "none"
PROT_PARITY = "parity"
PROT_ECC = "ecc"
_PROTECTIONS = (PROT_NONE, PROT_PARITY, PROT_ECC)


class CacheConfig(ConfigObject):
    """One cache level's geometry + protection (CacheMemory params analog)."""

    n_sets = Param(int, 64, "sets (power of two)")
    n_ways = Param(int, 4, "associativity")
    words_per_line = Param(int, 8, "32-bit words per line (power of two)")
    tag_bits = Param(int, 20, "tag field width per line")
    state_bits = Param(int, 2, "coherence-state field width per line "
                       "(MESI encoding)")
    data_protection = Param(str, PROT_NONE, "none | parity | ecc")
    tag_protection = Param(str, PROT_NONE, "none | parity | ecc "
                           "(covers tag and state arrays)")

    def validate(self) -> None:
        for f in ("n_sets", "words_per_line"):
            v = getattr(self, f)
            if v & (v - 1) or v <= 0:
                raise ValueError(f"{f} must be a power of two, got {v}")
        for f in ("data_protection", "tag_protection"):
            if getattr(self, f) not in _PROTECTIONS:
                raise ValueError(f"{f} must be one of {_PROTECTIONS}")

    @property
    def n_slots(self) -> int:
        return self.n_sets * self.n_ways


class CacheTimeline(NamedTuple):
    """Sorted per-slot event timelines for one cache level (host arrays)."""

    # word-granular data events, sorted by key = (slot*wpl + word)*span + cycle
    wkey: np.ndarray      # int64[Ew]
    wtype: np.ndarray     # int32[Ew]   EV_*
    # line-granular events, sorted by key = slot*span + cycle
    lkey: np.ndarray      # int64[El]
    lvalid: np.ndarray    # int32[El]   line valid after event
    ldirty: np.ndarray    # int32[El]   line dirty after event
    end_valid: np.ndarray  # int32[n_slots] resident line at window end
    end_dirty: np.ndarray  # int32[n_slots]
    span: int             # cycle span (n_cycles + 1)
    n_cycles: int


class AccessStream(NamedTuple):
    """A (cycle, word, is_store, width) memory-access stream.  ``width`` is
    the transfer size in words starting at ``word`` — 1 for CPU word
    accesses, the *source level's* line width for inter-level fills and
    writebacks, so a consuming level with a different line size expands the
    transfer correctly (possibly across several of its own lines)."""

    cycle: np.ndarray     # int32[A]
    word: np.ndarray      # int32[A]
    is_store: np.ndarray  # bool[A]
    width: np.ndarray     # int32[A]


def golden_access_stream(trace) -> AccessStream:
    """The golden memory-access stream, one word access per load or store
    in program order (cycle = µop index), from the C++ golden pass's
    effective addresses.  A misaligned or out-of-range golden access
    raises, as the reference's golden replay asserts."""
    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.isa import uops as U

    op = np.asarray(trace.opcode)
    ea = native.record_chunk(trace, U.writes_dest(op))[2]
    at = np.nonzero(U.is_mem(op))[0]
    addr = ea[at].astype(np.int64) & 0xFFFFFFFF
    if ((addr & 3) != 0).any() or ((addr >> 2) >= trace.mem_words).any():
        raise ValueError("golden trace must be in-range: a golden load or "
                         "store is misaligned or past mem_words")
    return AccessStream(cycle=at.astype(np.int32),
                        word=(addr >> 2).astype(np.int32),
                        is_store=np.asarray(U.is_store(op[at]), bool),
                        width=np.ones(len(at), dtype=np.int32))


def simulate_cache(stream: AccessStream, cfg: CacheConfig, n_cycles: int
                   ) -> tuple[CacheTimeline, AccessStream]:
    """Run the set-assoc LRU write-back cache over an access stream.

    Returns the slot-event timelines and the *miss stream* (fills as
    line-wide reads, dirty writebacks as line-wide stores) that drives the
    next level down — the analog of Ruby's L1→L2 MessageBuffer traffic
    (`mem/ruby/network/MessageBuffer.hh:74`).
    """
    cfg.validate()
    wpl = cfg.words_per_line
    span = n_cycles + 1

    # per-slot resident line (-1 = invalid), dirty flag, LRU stamp
    resident = np.full((cfg.n_sets, cfg.n_ways), -1, dtype=np.int64)
    dirty = np.zeros((cfg.n_sets, cfg.n_ways), dtype=bool)
    lru = np.zeros((cfg.n_sets, cfg.n_ways), dtype=np.int64)

    wkey: list = []
    wtype: list = []
    lkey: list = []
    lval: list = []
    ldir: list = []
    miss: list = []   # (cycle, word0, is_store, line_wide)

    def slot_of(s: int, w: int) -> int:
        return s * cfg.n_ways + w

    def word_events(s: int, w: int, words, cyc: int, ev: int) -> None:
        base = slot_of(s, w) * wpl
        for wi in words:
            wkey.append((base + wi) * span + cyc)
            wtype.append(ev)

    def line_event(s: int, w: int, cyc: int, valid: bool, dty: bool) -> None:
        lkey.append(slot_of(s, w) * span + cyc)
        lval.append(int(valid))
        ldir.append(int(dty))

    stamp = 0

    def do_access(cyc: int, line: int, wis, is_store: bool) -> None:
        """One access touching word-in-line indices `wis` of `line`."""
        nonlocal stamp
        s = line % cfg.n_sets
        ways = resident[s]
        hit = np.nonzero(ways == line)[0]
        if hit.size:
            w = int(hit[0])
        else:
            # victim = LRU way (invalid ways first)
            invalid = np.nonzero(ways == -1)[0]
            w = int(invalid[0]) if invalid.size else int(np.argmin(lru[s]))
            if resident[s, w] != -1:
                # eviction of the current resident line
                if dirty[s, w]:
                    # dirty writeback consumes every word of the line and
                    # feeds a line-wide store to the next level
                    word_events(s, w, range(wpl), cyc, EV_CONSUME)
                    miss.append((cyc, int(resident[s, w]) * wpl, True, wpl))
                else:
                    word_events(s, w, range(wpl), cyc, EV_INVALIDATE)
                line_event(s, w, cyc, False, False)
            # fill from the next level (line-wide read there), overwriting
            # the slot's SRAM
            miss.append((cyc, line * wpl, False, wpl))
            word_events(s, w, range(wpl), cyc, EV_OVERWRITE)
            resident[s, w] = line
            dirty[s, w] = False
            line_event(s, w, cyc, True, False)
        # the access itself
        if is_store:
            word_events(s, w, wis, cyc, EV_OVERWRITE)
            if not dirty[s, w]:
                dirty[s, w] = True
                line_event(s, w, cyc, True, True)
        else:
            word_events(s, w, wis, cyc, EV_CONSUME)
        stamp += 1
        lru[s, w] = stamp

    for a in range(len(stream.cycle)):
        cyc = int(stream.cycle[a])
        word = int(stream.word[a])
        is_store = bool(stream.is_store[a])
        width = int(stream.width[a])
        # a transfer of `width` words may span several of THIS level's lines
        # (source and consumer line sizes can differ)
        for line in range(word // wpl, (word + width - 1) // wpl + 1):
            lo = max(word, line * wpl)
            hi = min(word + width, (line + 1) * wpl)
            do_access(cyc, line, range(lo - line * wpl, hi - line * wpl),
                      is_store)

    def sorted_cols(keys, *cols):
        k = np.asarray(keys, dtype=np.int64)
        order = np.argsort(k, kind="stable")
        return (k[order],) + tuple(
            np.asarray(c, dtype=np.int32)[order] for c in cols)

    wk, wt = sorted_cols(wkey, wtype) if wkey else (
        np.zeros(0, np.int64), np.zeros(0, np.int32))
    lk, lv, ld = sorted_cols(lkey, lval, ldir) if lkey else (
        np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int32))

    timeline = CacheTimeline(
        wkey=wk, wtype=wt, lkey=lk, lvalid=lv, ldirty=ld,
        end_valid=(resident != -1).astype(np.int32).reshape(-1),
        end_dirty=dirty.astype(np.int32).reshape(-1),
        span=span, n_cycles=n_cycles)
    if miss:
        mc, mw, ms, mwd = zip(*miss)
        miss_stream = AccessStream(
            cycle=np.asarray(mc, dtype=np.int32),
            word=np.asarray(mw, dtype=np.int32),
            is_store=np.asarray(ms, dtype=bool),
            width=np.asarray(mwd, dtype=np.int32))
    else:
        miss_stream = AccessStream(*(np.zeros(0, d) for d in
                                     (np.int32, np.int32, bool, np.int32)))
    return timeline, miss_stream


# --- device-side classification -------------------------------------------

_PROT_TABLE = {
    # what a consumed corrupted bit becomes under each protection scheme
    PROT_NONE: C.OUTCOME_SDC,
    PROT_PARITY: C.OUTCOME_DUE,    # detected, not correctable
    PROT_ECC: C.OUTCOME_MASKED,    # SECDED corrects single-bit faults
}

CACHE_STRUCTURES = ("data", "tag", "state")


class CacheFault(NamedTuple):
    """A batch of cache faults, int32[B] each."""
    slot: torch.Tensor   # set*ways + way
    word: torch.Tensor   # word within line (data faults; 0 otherwise)
    bit: torch.Tensor
    cycle: torch.Tensor


class CacheFaultSampler:
    """Uniform (slot, word, bit, cycle) draws for one cache structure."""

    def __init__(self, cfg: CacheConfig, n_cycles: int, structure: str):
        if structure not in CACHE_STRUCTURES:
            raise KeyError(f"unknown cache structure {structure!r} "
                           f"(known: {CACHE_STRUCTURES})")
        self.cfg = cfg
        self.n_cycles = n_cycles
        self.structure = structure
        self.n_bits = {"data": 32, "tag": cfg.tag_bits,
                       "state": cfg.state_bits}[structure]

    def sample_batch(self, keys: torch.Tensor) -> CacheFault:
        """(B, 2) keys → a CacheFault batch on the keys' device."""
        ks = prng.split(keys, 4)
        slot = prng.randint(ks[:, 0], 0, self.cfg.n_slots)
        word = (prng.randint(ks[:, 1], 0, self.cfg.words_per_line)
                if self.structure == "data" else torch.zeros_like(slot))
        bit = prng.randint(ks[:, 2], 0, self.n_bits)
        cycle = prng.randint(ks[:, 3], 0, self.n_cycles)
        return CacheFault(slot=slot, word=word, bit=bit, cycle=cycle)


class CacheKernel(TierKernel):
    """Fault classifier for one cache level, on ``device`` (None: the CUDA
    card), with the campaign protocol of ``models/tier.py``, so the
    campaign layer and the orchestrator drive cache structures like O3
    structures.  Structures: ``"data"``, ``"tag"``, ``"state"``.
    """

    def __init__(self, timeline: CacheTimeline, cfg: CacheConfig,
                 device=None):
        cfg.validate()
        self.cfg = cfg
        self.tl = timeline
        self.device = resolve_device(device)
        # the reference keeps its keys in int32 (jax without x64); the
        # same bound holds here so both packages accept the same windows
        max_key = cfg.n_slots * cfg.words_per_line * timeline.span
        if max_key >= 2**31:
            raise ValueError(
                f"timeline key space {max_key} overflows int32 "
                f"(shrink the window or the cache geometry)")
        # pad empty timelines with a key=-1 sentinel (sorts first, never
        # matches any fault's slot) so the gathers always have a row
        wk, wt = timeline.wkey, timeline.wtype
        if wk.size == 0:
            wk = np.array([-1], np.int64)
            wt = np.array([EV_INVALIDATE], np.int32)
        lk, lv, ld = timeline.lkey, timeline.lvalid, timeline.ldirty
        if lk.size == 0:
            lk = np.array([-1], np.int64)
            lv = ld = np.zeros(1, np.int32)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)

        self.wkey, self.wtype = dev(wk), dev(wt)
        self.lkey, self.lvalid, self.ldirty = dev(lk), dev(lv), dev(ld)
        self.end_valid = dev(timeline.end_valid)
        self.end_dirty = dev(timeline.end_dirty)
        self.span = timeline.span
        self.n_cycles = timeline.n_cycles
        self._data_consumed = _PROT_TABLE[cfg.data_protection]
        self._tag_consumed = _PROT_TABLE[cfg.tag_protection]

    def _build_on(self, device) -> "CacheKernel":
        return CacheKernel(self.tl, self.cfg, device=device)

    # -- classification (batched) --

    def _classify_data(self, f: CacheFault) -> torch.Tensor:
        wpl = self.cfg.words_per_line
        target = f.slot.to(torch.int64) * wpl + f.word
        key = target * self.span + f.cycle
        n_ev = self.wkey.shape[0]
        pos = torch.searchsorted(self.wkey, key, right=False)
        pc = torch.clamp(pos, max=max(n_ev - 1, 0))
        found = (pos < n_ev) & (self.wkey[pc] // self.span == target)
        consumed = found & (self.wtype[pc] == EV_CONSUME)
        # no further event: residue in a valid dirty line eventually writes
        # back (post-window) — count as consumed, matching the O3 kernel's
        # end-of-window residual-corruption convention
        slot = f.slot.to(torch.int64)
        residual = ~found & (self.end_valid[slot] == 1) & \
            (self.end_dirty[slot] == 1)
        return torch.where(consumed | residual, self._data_consumed,
                           C.OUTCOME_MASKED).to(torch.int32)

    def _classify_line_meta(self, f: CacheFault) -> torch.Tensor:
        """Tag/state-field fault: consumed iff the line is valid∧dirty when
        hit — the dirty payload is lost (flipped M-state) or lands at a
        corrupted address (flipped tag); clean lines refetch (masked)."""
        slot = f.slot.to(torch.int64)
        key = slot * self.span + f.cycle
        n_ev = self.lkey.shape[0]
        pos = torch.searchsorted(self.lkey, key, right=True) - 1
        pc = torch.clamp(pos, 0, max(n_ev - 1, 0))
        found = (pos >= 0) & (self.lkey[pc] // self.span == slot)
        hit = found & (self.lvalid[pc] == 1) & (self.ldirty[pc] == 1)
        return torch.where(hit, self._tag_consumed,
                           C.OUTCOME_MASKED).to(torch.int32)

    # -- sampling --

    def sampler(self, structure: str) -> CacheFaultSampler:
        return CacheFaultSampler(self.cfg, self.n_cycles, structure)

    def sample_batch(self, keys: torch.Tensor, structure: str) -> CacheFault:
        return self.sampler(structure).sample_batch(keys.to(self.device))

    # -- campaign protocol --

    def outcomes_of_faults(self, faults: CacheFault, structure: str
                           ) -> torch.Tensor:
        if structure == "data":
            return self._classify_data(faults)
        return self._classify_line_meta(faults)

    def strata_of(self, faults: CacheFault) -> torch.Tensor:
        """Fault-cycle octiles: cache-line AVF is strongly lifetime-position
        dependent (a flip just before the next fill is almost always
        masked), so cycle strata separate materially different rates."""
        from shrewd_tpu_torch.ops.trial import N_STRATA

        return torch.clamp(faults.cycle.to(torch.int64) * N_STRATA
                           // max(self.n_cycles, 1), 0, N_STRATA - 1)

class CacheHierarchy(NamedTuple):
    """MESI_Two_Level shape: private L1 + shared L2, chained timelines."""

    l1: CacheKernel
    l2: CacheKernel

    @classmethod
    def build(cls, trace, l1_cfg: CacheConfig | None = None,
              l2_cfg: CacheConfig | None = None,
              device=None) -> "CacheHierarchy":
        l1_cfg = l1_cfg or CacheConfig()
        l2_cfg = l2_cfg or CacheConfig(n_sets=256, n_ways=8)
        stream = golden_access_stream(trace)
        l1_tl, l1_miss = simulate_cache(stream, l1_cfg, trace.n)
        l2_tl, _ = simulate_cache(l1_miss, l2_cfg, trace.n)
        return cls(l1=CacheKernel(l1_tl, l1_cfg, device),
                   l2=CacheKernel(l2_tl, l2_cfg, device))

    def kernels(self) -> dict[str, CacheKernel]:
        return {"l1": self.l1, "l2": self.l2}
