"""N-core directory MESI with protocol-state, directory and TBE faults (the
port of ``shrewd_tpu/models/mesi.py``).

The fault targets are protocol state proper: the per-line MESI state of
the L1 controllers (``MESI_Two_Level-L1cache.sm``) in ``CacheMemory``
entry arrays, the **directory** that routes coherence
(``DirectoryMemory.hh:60``) and the **TBE table** holding each in-flight
transaction's transient record (``TBETable.hh``).  A corrupted directory
mis-steers the protocol: a dropped sharer bit skips an invalidation and
that L1 later serves stale hits; a flipped owner bit asks the wrong core
for a dirty line and the true dirty copy is silently lost; a flipped TBE
address or requester bit mis-routes the in-flight fill.

The protocol machine is one walk over the interleaved access stream
carrying (L1 state/tag/data/LRU, directory state/owner/sharers, L2 image),
with the fault landing as a bit flip at its access.  The reference runs it
as a ``lax.scan`` vmapped over trials; here ``mesi_replay`` is a torch
step loop over the stream's accesses, vectorised over the trial batch
(every carry array has a leading batch dimension).  The stream is the same
for every lane, so each step's core, word and load/store kind are host
integers and only the branch that the access takes is computed.
``scalar_mesi`` is the independent host oracle (CheckerCPU pattern).

Classification is program-visible: SDC ⇔ any loaded value differs from
golden or the final flushed memory image differs.  Parity/ECC on the
protocol arrays maps to DUE/MASKED as in models/ruby.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.models.ruby import PROT_ECC, PROT_NONE, PROT_PARITY
from shrewd_tpu_torch.models.tier import TierKernel
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import ConfigObject, Param
from shrewd_tpu_torch.utils.device import resolve as resolve_device

# L1 MESI encoding: the 2-bit state field under fault.
ST_I, ST_S, ST_E, ST_M = 0, 1, 2, 3

# directory states (2-bit, fault-targetable): not-present / shared /
# exclusive-granted (owner holds E or M)
DIR_NP, DIR_S, DIR_EM = 0, 1, 2

# fault targets
TGT_STATE = 0      # L1 state array
TGT_TAG = 1        # L1 tag array
TGT_DIR = 2        # directory entry (state | sharers | owner, see bit map)
TGT_TBE = 3        # in-flight transaction record (addr | requester bits)

MESI_STRUCTURES = {"state": TGT_STATE, "tag": TGT_TAG, "dir": TGT_DIR,
                   "tbe": TGT_TBE}


class MesiConfig(ConfigObject):
    """N-core private-L1 / shared-L2 directory geometry + protection."""

    n_cores = Param(int, 2, "cores (private L1 each, 2..16)")
    n_sets = Param(int, 4, "L1 sets (power of two)")
    n_ways = Param(int, 2, "L1 associativity")
    words_per_line = Param(int, 2, "32-bit words per line (power of two)")
    tag_bits = Param(int, 16, "tag field width (fault-targetable)")
    state_protection = Param(str, PROT_NONE,
                             "none | parity | ecc on the protocol arrays")

    def validate(self) -> None:
        for f in ("n_sets", "words_per_line"):
            v = getattr(self, f)
            if v & (v - 1):
                raise ValueError(f"{f}={v} must be a power of two")
        if not 2 <= self.n_cores <= 16:
            raise ValueError("n_cores must be in [2, 16] (sharers bitmask)")
        if self.state_protection not in (PROT_NONE, PROT_PARITY, PROT_ECC):
            raise ValueError(
                f"unknown state_protection {self.state_protection!r}")

    @property
    def owner_bits(self) -> int:
        return max(int(np.ceil(np.log2(self.n_cores))), 1)

    def dir_bits(self) -> int:
        """Directory-entry fault-bit space: 2 state bits, then one sharer
        bit per core, then the owner-id bits."""
        return 2 + self.n_cores + self.owner_bits

    def tbe_bits(self) -> int:
        """TBE fault-bit space: line-address bits then requester-id bits."""
        return 16 + self.owner_bits


class MesiFault(NamedTuple):
    """A batch of trials' coordinates, integer tensors of shape (B,).

    ``mset`` doubles as the directory line index for TGT_DIR faults; the
    ``bit`` index selects within the target's composite bit map
    (MesiConfig.dir_bits / tbe_bits)."""

    target: torch.Tensor   # TGT_*
    core: torch.Tensor
    mset: torch.Tensor     # L1 set, or directory line for TGT_DIR
    way: torch.Tensor
    bit: torch.Tensor
    cycle: torch.Tensor    # access index at which the flip lands


class AccessTrace(NamedTuple):
    """Interleaved N-core access stream (host numpy arrays)."""

    core: np.ndarray      # int32[A]
    word: np.ndarray      # int32[A] global word address
    is_store: np.ndarray  # bool[A]
    value: np.ndarray     # uint32[A] store data (ignored for loads)


def torture_stream(cfg: MesiConfig, n_accesses: int, mem_words: int,
                   seed: int = 0, sharing: float = 0.5) -> AccessTrace:
    """RubyTester-style random coherence torture: N cores hammering a
    small shared footprint (``sharing`` controls contention)."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, cfg.n_cores, n_accesses)
    shared = rng.random(n_accesses) < sharing
    span = max(cfg.n_sets * cfg.words_per_line, 4)
    word = np.where(shared, rng.integers(0, span, n_accesses),
                    rng.integers(0, mem_words, n_accesses))
    is_store = rng.random(n_accesses) < 0.4
    value = rng.integers(0, 1 << 32, n_accesses,
                         dtype=np.uint64).astype(np.uint32)
    return AccessTrace(core=core.astype(np.int32),
                       word=word.astype(np.int32),
                       is_store=is_store, value=value)


# --------------------------------------------------------------------------
# scalar oracle — an independent implementation (CheckerCPU pattern)
# --------------------------------------------------------------------------

def scalar_mesi(trace: AccessTrace, cfg: MesiConfig, init_mem: np.ndarray,
                fault: "tuple | None" = None, return_state: bool = False):
    """Python reference walk.  ``fault`` = (target, core, mset, way, bit,
    cycle) or None.  Returns (loads, final_mem)."""
    nc = cfg.n_cores
    wpl = cfg.words_per_line
    n_lines = len(init_mem) // wpl
    state = np.zeros((nc, cfg.n_sets, cfg.n_ways), dtype=np.int64)
    tag = np.zeros((nc, cfg.n_sets, cfg.n_ways), dtype=np.int64)
    data = np.zeros((nc, cfg.n_sets, cfg.n_ways, wpl), dtype=np.uint32)
    age = np.zeros((nc, cfg.n_sets, cfg.n_ways), dtype=np.int64)
    dstate = np.zeros(n_lines, dtype=np.int64)       # DIR_*
    downer = np.zeros(n_lines, dtype=np.int64)
    dsharers = np.zeros(n_lines, dtype=np.int64)     # bitmask over cores
    mem = np.asarray(init_mem, dtype=np.uint32).copy()
    loads = []
    core_np = np.asarray(trace.core)
    word_np = np.asarray(trace.word)
    st_np = np.asarray(trace.is_store)
    val_np = np.asarray(trace.value)
    ob = cfg.owner_bits

    def wb(c, s, w):
        if state[c, s, w] == ST_M:
            base = (tag[c, s, w] * cfg.n_sets + s) * wpl
            if 0 <= base <= len(mem) - wpl:
                mem[base:base + wpl] = data[c, s, w]

    def find(c, s, t):
        for w in range(cfg.n_ways):
            if state[c, s, w] != ST_I and tag[c, s, w] == t:
                return w
        return -1

    def dir_evict(c, s, w):
        """PutS/PutM: eviction notifies the directory."""
        ln = tag[c, s, w] * cfg.n_sets + s
        if not (0 <= ln < n_lines) or state[c, s, w] == ST_I:
            return
        dsharers[ln] &= ~(1 << c)
        # the owner field is deliberately left stale (don't-care outside
        # DIR_EM), as in the replay: a later dir-state FAULT can flip the
        # entry back to EM and make the stale owner live again
        if downer[ln] == c and dstate[ln] == DIR_EM:
            dstate[ln] = DIR_S if dsharers[ln] else DIR_NP
        elif dsharers[ln] == 0 and dstate[ln] == DIR_S:
            dstate[ln] = DIR_NP

    for i in range(len(core_np)):
        if fault is not None and fault[5] == i:
            tgt, fc, fs, fw, fb, _ = fault
            if tgt == TGT_STATE:
                state[fc, fs, fw] ^= (1 << fb)
            elif tgt == TGT_TAG:
                tag[fc, fs, fw] ^= (1 << fb)
            elif tgt == TGT_DIR and 0 <= fs < n_lines:
                if fb < 2:
                    dstate[fs] ^= (1 << fb)
                elif fb < 2 + nc:
                    dsharers[fs] ^= (1 << (fb - 2))
                else:
                    downer[fs] ^= (1 << (fb - 2 - nc))
                    downer[fs] &= (1 << ob) - 1
        c = int(core_np[i])
        wd = int(word_np[i])
        line = wd // wpl
        s = line % cfg.n_sets
        t = line // cfg.n_sets
        off = wd % wpl
        # TBE fault: corrupt the in-flight miss record being processed at
        # this access — the fill mis-routes (wrong line fetched / wrong
        # requester receives it)
        tbe_line, tbe_c = line, c
        if fault is not None and fault[5] == i and fault[0] == TGT_TBE:
            fb = fault[4]
            if fb < 16:
                tbe_line = (line ^ (1 << fb)) % max(n_lines, 1)
            else:
                tbe_c = (c ^ (1 << (fb - 16))) % nc
        w = find(c, s, t)
        if not st_np[i]:                      # -------- load --------
            filled = None
            if w < 0:
                # directory-routed miss service
                if dstate[line] == DIR_EM:
                    o = int(downer[line]) % nc
                    ow = find(o, s, t)
                    if ow >= 0:               # NACK analog on lookup miss
                        wb(o, s, ow)
                        state[o, s, ow] = ST_S
                    dsharers[line] = ((dsharers[line] | (1 << o))
                                      & ((1 << nc) - 1))
                    dstate[line] = DIR_S
                # fill via the (possibly corrupted) TBE record
                fs_ = tbe_line % cfg.n_sets
                ft_ = tbe_line // cfg.n_sets
                fc_ = tbe_c
                fw = int(np.argmin(age[fc_, fs_]))
                dir_evict(fc_, fs_, fw)
                wb(fc_, fs_, fw)
                base = tbe_line * wpl
                data[fc_, fs_, fw] = (mem[base:base + wpl]
                                      if 0 <= base <= len(mem) - wpl else 0)
                tag[fc_, fs_, fw] = ft_
                excl = dstate[line] == DIR_NP
                state[fc_, fs_, fw] = ST_E if excl else ST_S
                dsharers[line] |= (1 << c)
                if excl:
                    dstate[line] = DIR_EM
                    downer[line] = c
                else:
                    dstate[line] = DIR_S
                filled = (fc_, fs_, fw)
                w = find(c, s, t)             # may miss if fill mis-routed
            if w >= 0:
                loads.append(int(data[c, s, w][off]))
                age[c, s] -= 1
                age[c, s, w] = 0
            else:
                # mis-routed fill: requester retries straight from L2
                base = line * wpl
                v = int(mem[base + off]) if 0 <= base <= len(mem) - wpl \
                    else 0
                loads.append(v)
                fc_, fs_, fw = filled
                age[fc_, fs_] -= 1
                age[fc_, fs_, fw] = 0
        else:                                 # -------- store -------
            if w >= 0 and state[c, s, w] != ST_S:
                state[c, s, w] = ST_M
                dstate[line] = DIR_EM
                downer[line] = c
                dsharers[line] = 1 << c
            else:
                # invalidate per directory
                if dstate[line] == DIR_EM:
                    o = int(downer[line]) % nc
                    if o != c:
                        ow = find(o, s, t)
                        if ow >= 0:
                            wb(o, s, ow)
                            state[o, s, ow] = ST_I
                sh = int(dsharers[line])
                for o in range(nc):
                    if o != c and (sh >> o) & 1:
                        ow = find(o, s, t)
                        if ow >= 0:
                            state[o, s, ow] = ST_I
                if w < 0:
                    w = int(np.argmin(age[c, s]))
                    dir_evict(c, s, w)
                    wb(c, s, w)
                    base = line * wpl
                    data[c, s, w] = (mem[base:base + wpl]
                                     if 0 <= base <= len(mem) - wpl else 0)
                    tag[c, s, w] = t
                state[c, s, w] = ST_M
                dstate[line] = DIR_EM
                downer[line] = c
                dsharers[line] = 1 << c
            data[c, s, w][off] = np.uint32(val_np[i])
            age[c, s] -= 1
            age[c, s, w] = 0

    for c in range(nc):
        for s in range(cfg.n_sets):
            for w in range(cfg.n_ways):
                wb(c, s, w)
    out_loads = np.asarray(loads, dtype=np.uint32)
    if return_state:
        return out_loads, mem, (state, tag, dstate, downer, dsharers)
    return out_loads, mem


# --------------------------------------------------------------------------
# the replay — the same machine as a torch step loop over the stream
# --------------------------------------------------------------------------

def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (the reference's
    ``argmax`` of a bool), and 0 where there is none."""
    n = mask.shape[-1]
    ids = torch.arange(n, device=mask.device)
    first = torch.where(mask, ids, n).min(dim=-1).values
    return torch.where(first < n, first, 0)


def _first_min(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last dim (``argmin``'s first
    index, made explicit)."""
    n = x.shape[-1]
    ids = torch.arange(n, device=x.device)
    hit = x == x.min(dim=-1, keepdim=True).values
    return torch.where(hit, ids, n).min(dim=-1).values


def _bit(x: torch.Tensor) -> torch.Tensor:
    """1 << x for a non-negative int64 tensor."""
    return torch.bitwise_left_shift(torch.ones_like(x), x)


def mesi_replay(trace: AccessTrace, cfg: MesiConfig, init_mem,
                fault: MesiFault, return_state: bool = False):
    """A batch of protocol walks → (loads int64[B, A], final mem
    int64[B, mem_words]), 32-bit values; a store's load slot is 0.

    Lane b's fault lands at access ``fault.cycle[b]``; a cycle < 0 is the
    golden run.  The lanes run on ``fault``'s device.  ``return_state``
    appends the final protocol arrays (state, tag, dir_state, dir_owner,
    dir_sharers), each with the batch dimension first."""
    cfg.validate()
    dev = fault.cycle.device
    B = int(fault.cycle.shape[0])
    nc, wpl = cfg.n_cores, cfg.words_per_line
    NS, NW = cfg.n_sets, cfg.n_ways
    init = torch.as_tensor(np.asarray(init_mem, np.int64), device=dev)
    mw = int(init.shape[0])
    n_lines = mw // wpl
    last_line = max(n_lines - 1, 0)
    omask = (1 << cfg.owner_bits) - 1
    i64 = torch.int64

    bi = torch.arange(B, device=dev)
    wofs = torch.arange(wpl, device=dev)
    core_ids = torch.arange(nc, device=dev)
    state = torch.zeros((B, nc, NS, NW), dtype=i64, device=dev)
    tagv = torch.zeros_like(state)
    age = torch.zeros_like(state)
    data = torch.zeros((B, nc, NS, NW, wpl), dtype=i64, device=dev)
    dstate = torch.zeros((B, max(n_lines, 1)), dtype=i64, device=dev)
    downer = torch.zeros_like(dstate)
    dsharers = torch.zeros_like(dstate)
    mem = init.expand(B, mw).clone()

    tgt, f_core, f_set, f_way, f_bit, f_cyc = (
        torch.as_tensor(x, device=dev).to(i64) for x in fault)
    # each lane's flip masks, applied at its landing access; a slot out of
    # range flips nothing (the reference's scatter drops it), and the
    # clamped slot takes the lane's zero flip
    zero = torch.zeros_like(f_bit)
    in_slot = ((f_core >= 0) & (f_core < nc) & (f_set >= 0) & (f_set < NS)
               & (f_way >= 0) & (f_way < NW))
    fc = torch.clamp(f_core, 0, nc - 1)
    fs = torch.clamp(f_set, 0, NS - 1)
    fw = torch.clamp(f_way, 0, NW - 1)
    st_flip = torch.where((tgt == TGT_STATE) & in_slot, _bit(f_bit), zero)
    tg_flip = torch.where((tgt == TGT_TAG) & in_slot, _bit(f_bit), zero)
    is_dir = tgt == TGT_DIR
    dl = torch.clamp(f_set, 0, last_line)
    ds_flip = torch.where(is_dir & (f_bit < 2), _bit(f_bit), zero)
    dsh_flip = torch.where(is_dir & (f_bit >= 2) & (f_bit < 2 + nc),
                           _bit(torch.clamp(f_bit - 2, min=0)), zero)
    dow_flip = torch.where(is_dir & (f_bit >= 2 + nc),
                           _bit(torch.clamp(f_bit - 2 - nc, min=0)), zero)
    is_tbe = tgt == TGT_TBE
    tbe_addr = is_tbe & (f_bit < 16)
    tbe_req = is_tbe & (f_bit >= 16)
    tbe_line_flip = _bit(torch.clamp(f_bit, max=62))
    tbe_req_flip = _bit(torch.clamp(f_bit - 16, min=0))

    def slot(arr, core, s, way):
        return arr[bi, core, s, way]

    def writeback(mem, core, s, way, cond):
        """Write the slot's line back to ``mem`` where it is M, its
        address in range and ``cond`` holds; reads the step-start arrays
        (the reference's ``wb_into``)."""
        dirty = slot(state, core, s, way) == ST_M
        base = (slot(tagv, core, s, way) * NS + s) * wpl
        ok = (base >= 0) & (base + wpl <= mw)
        idx = torch.clamp(base[:, None] + wofs, 0, mw - 1)
        new = torch.where((dirty & ok & cond)[:, None],
                          slot(data, core, s, way), mem.gather(1, idx))
        return mem.scatter(1, idx, new)

    def find(core, s, t):
        """First way of set s of each lane's ``core`` holding tag t, or
        -1."""
        hits = (state[bi, core, s] != ST_I) & (tagv[bi, core, s] == t)
        return torch.where(hits.any(dim=1), _first_true(hits), -1)

    cores = np.asarray(trace.core).tolist()
    words = np.asarray(trace.word).tolist()
    stores = np.asarray(trace.is_store).tolist()
    values = (np.asarray(trace.value).astype(np.int64)).tolist()
    loads = []
    for i, (c, wd, is_st, val) in enumerate(zip(cores, words, stores,
                                                values)):
        # ---- fault landing ----
        land = f_cyc == i
        state[bi, fc, fs, fw] ^= torch.where(land, st_flip, zero)
        tagv[bi, fc, fs, fw] ^= torch.where(land, tg_flip, zero)
        dstate[bi, dl] ^= torch.where(land, ds_flip, zero)
        dsharers[bi, dl] ^= torch.where(land, dsh_flip, zero)
        cur = downer[bi, dl]
        downer[bi, dl] = torch.where(
            land & (dow_flip != 0), (cur ^ dow_flip) & omask, cur)
        line = wd // wpl
        s, t, off = line % NS, line // NS, wd % wpl
        dln = min(max(line, 0), last_line)
        w = find(c, s, t)
        have = w >= 0
        # the step-start directory entry (copies: the arrays change below)
        d_st = dstate[:, dln].clone()
        d_ow = downer[:, dln] % nc
        d_sh = dsharers[:, dln].clone()
        ow = find(d_ow, s, t)                 # owner lookup (NACK if -1)
        owner_hit = (d_st == DIR_EM) & (ow >= 0)
        ow_c = torch.clamp(ow, min=0)

        if not is_st:
            # ======== LOAD ========
            need = ~have
            # the (possibly corrupted) TBE record of this access
            tbe_line = torch.where(
                land & tbe_addr, (line ^ tbe_line_flip) % max(n_lines, 1),
                line)
            tbe_c = torch.where(land & tbe_req, (c ^ tbe_req_flip) % nc, c)
            fs_ = tbe_line % NS
            ft_ = tbe_line // NS
            victim = _first_min(age[bi, tbe_c, fs_])
            ev_raw = slot(tagv, tbe_c, fs_, victim) * NS + fs_
            ev_ln = torch.clamp(ev_raw, 0, last_line)
            # out-of-range lines (corrupted-tag victims) get no eviction
            # notice, as in the oracle's dir_evict
            ev_valid = ((slot(state, tbe_c, fs_, victim) != ST_I)
                        & (ev_raw >= 0) & (ev_raw < n_lines))
            # owner writeback + downgrade to S, then the victim's
            # writeback (both read the step-start arrays at set s)
            c_own = need & owner_hit
            mem = writeback(mem, d_ow, s, ow_c, c_own)
            mem = writeback(mem, tbe_c, s, victim, need)
            state[bi, d_ow, s, ow_c] = torch.where(
                c_own, ST_S, state[bi, d_ow, s, ow_c])
            # eviction notice for the victim line (PutS/PutM analog)
            sh0 = dsharers[bi, ev_ln]
            ds0 = dstate[bi, ev_ln]
            sh_ev = sh0 & ~_bit(tbe_c)
            notice = need & ev_valid
            dsharers[bi, ev_ln] = torch.where(notice, sh_ev, sh0)
            dstate[bi, ev_ln] = torch.where(
                notice & (((downer[bi, ev_ln] == tbe_c) & (ds0 == DIR_EM))
                          | ((sh_ev == 0) & (ds0 == DIR_S))),
                torch.where(sh_ev != 0, DIR_S, DIR_NP), ds0)
            # the fill
            base = tbe_line * wpl
            fill_ok = (base >= 0) & (base + wpl <= mw)
            fidx = torch.clamp(base[:, None] + wofs, 0, mw - 1)
            fill = torch.where(fill_ok[:, None], mem.gather(1, fidx), 0)
            excl = d_st == DIR_NP
            data[bi, tbe_c, fs_, victim] = torch.where(
                need[:, None], fill, slot(data, tbe_c, fs_, victim))
            tagv[bi, tbe_c, fs_, victim] = torch.where(
                need, ft_, slot(tagv, tbe_c, fs_, victim))
            state[bi, tbe_c, fs_, victim] = torch.where(
                need, torch.where(excl, ST_E, ST_S),
                slot(state, tbe_c, fs_, victim))
            # directory update for the REQUESTED line
            dsharers[:, dln] = torch.where(
                need, (dsharers[:, dln] | (1 << c)
                       | torch.where(d_st == DIR_EM, _bit(d_ow), 0))
                & ((1 << nc) - 1), dsharers[:, dln])
            dstate[:, dln] = torch.where(
                need, torch.where(excl, DIR_EM, DIR_S), dstate[:, dln])
            downer[:, dln] = torch.where(need & excl, c, downer[:, dln])
            # serve the load: re-find after the fill (a mis-routed fill
            # means the requester still misses → retry straight from L2)
            w2 = find(c, s, t)
            served = w2 >= 0
            w2c = torch.clamp(w2, min=0)
            lbase = line * wpl
            if lbase >= 0 and lbase + off < mw:
                from_l2 = mem[:, min(max(lbase + off, 0), mw - 1)]
            else:
                from_l2 = torch.zeros_like(w2)
            loads.append(torch.where(served, data[bi, c, s, w2c, off],
                                     from_l2))
            # LRU touch: the slot that served the request (for a
            # mis-routed fill, the slot the fill landed in)
            tc = torch.where(served, c, tbe_c)
            ts = torch.where(served, s, fs_)
            tw = torch.where(served, w2c, victim)
        else:
            # ======== STORE ========
            silent = have & (state[bi, c, s, torch.clamp(w, min=0)]
                             != ST_S)
            need = ~silent
            victim = _first_min(age[:, c, s])
            w_eff = torch.where(have, torch.clamp(w, min=0), victim)
            ev_raw = tagv[bi, c, s, victim] * NS + s
            ev_ln = torch.clamp(ev_raw, 0, last_line)
            ev_valid = ((state[bi, c, s, victim] != ST_I) & ~have
                        & (ev_raw >= 0) & (ev_raw < n_lines))
            # directory-routed invalidations: the owner writes back, then
            # the victim of a miss (both read the step-start arrays)
            c_own = need & owner_hit & (d_ow != c)
            mem = writeback(mem, d_ow, s, ow_c, c_own)
            mem = writeback(mem, c, s, victim, need & ~have)
            state[bi, d_ow, s, ow_c] = torch.where(
                c_own, ST_I, state[bi, d_ow, s, ow_c])
            # invalidate every directory-listed sharer's FIRST matching
            # way (the lookup semantics of find, which matters when a tag
            # fault has created a duplicate match in another way)
            sh_mask = (((d_sh[:, None] >> core_ids) & 1).bool()
                       & (core_ids != c))
            tag_match = (state[:, :, s] != ST_I) & (tagv[:, :, s] == t)
            first_w = _first_true(tag_match)                   # (B, nc)
            inv = sh_mask & tag_match.any(dim=2) & need[:, None]
            cur = state[bi[:, None], core_ids, s, first_w]
            state[bi[:, None], core_ids, s, first_w] = torch.where(
                inv, ST_I, cur)
            # the allocation (store fills are not TBE-corrupted in this
            # model: the store's transient record is the fan-out above)
            base = line * wpl
            if base >= 0 and base + wpl <= mw:
                fill = mem[:, base:base + wpl]
            else:
                fill = torch.zeros((B, wpl), dtype=i64, device=dev)
            data[bi, c, s, w_eff] = torch.where(
                have[:, None], data[bi, c, s, w_eff], fill)
            data[bi, c, s, w_eff, off] = val
            tagv[bi, c, s, w_eff] = torch.where(have, tagv[bi, c, s, w_eff],
                                                t)
            state[bi, c, s, w_eff] = ST_M
            sh0 = dsharers[bi, ev_ln]
            ds0 = dstate[bi, ev_ln]
            sh_ev = sh0 & ~(1 << c)
            notice = need & ev_valid
            dsharers[bi, ev_ln] = torch.where(notice, sh_ev, sh0)
            dstate[bi, ev_ln] = torch.where(
                notice & (((downer[bi, ev_ln] == c) & (ds0 == DIR_EM))
                          | ((sh_ev == 0) & (ds0 == DIR_S))),
                torch.where(sh_ev != 0, DIR_S, DIR_NP), ds0)
            dstate[:, dln] = DIR_EM
            downer[:, dln] = c
            dsharers[:, dln] = 1 << c
            loads.append(torch.zeros(B, dtype=i64, device=dev))
            tc = torch.full_like(w, c)
            ts = torch.full_like(w, s)
            tw = w_eff
        age[bi, tc, ts] -= 1
        age[bi, tc, ts, tw] = 0

    # the final flush, in the reference's (core, set, way) order: under a
    # fault two cores can hold one line dirty, and the later write wins
    for c in range(nc):
        for s in range(NS):
            for w in range(NW):
                dirty = state[:, c, s, w] == ST_M
                base = (tagv[:, c, s, w] * NS + s) * wpl
                ok = dirty & (base >= 0) & (base + wpl <= mw)
                idx = torch.clamp(base[:, None] + wofs, 0, mw - 1)
                mem = mem.scatter(1, idx, torch.where(
                    ok[:, None], data[:, c, s, w], mem.gather(1, idx)))
    loads = (torch.stack(loads, dim=1) if loads
             else torch.zeros((B, 0), dtype=i64, device=dev))
    if return_state:
        return loads, mem, (state, tagv, dstate, downer, dsharers)
    return loads, mem


class MesiKernel(TierKernel):
    """Campaign-facing kernel on ``device`` (None: the CUDA card), with the
    campaign protocol of ``models/tier.py``.  Structures: ``"state"``,
    ``"tag"``, ``"dir"``, ``"tbe"``."""

    def __init__(self, trace: AccessTrace, cfg: MesiConfig,
                 init_mem: np.ndarray, device=None):
        cfg.validate()
        self.cfg = cfg
        self.trace = trace
        self.device = resolve_device(device)
        self.init_mem = np.asarray(init_mem, dtype=np.uint32)
        self.n_accesses = int(len(trace.core))
        gold = MesiFault(*(torch.zeros(1, dtype=torch.int64,
                                       device=self.device),) * 5,
                         torch.full((1,), -1, dtype=torch.int64,
                                    device=self.device))
        loads, mem = mesi_replay(trace, cfg, self.init_mem, gold)
        self.golden_loads, self.golden_mem = loads[0], mem[0]

    def _build_on(self, device) -> "MesiKernel":
        return MesiKernel(self.trace, self.cfg, self.init_mem, device=device)

    def sample_batch(self, keys: torch.Tensor, structure: str) -> MesiFault:
        """(B, 2) keys → a MesiFault batch of int32 tensors on this
        kernel's device."""
        cfg = self.cfg
        n_lines = max(len(self.init_mem) // cfg.words_per_line, 1)
        tgt = MESI_STRUCTURES[structure]
        n_bits = {"state": 2, "tag": cfg.tag_bits,
                  "dir": cfg.dir_bits(), "tbe": cfg.tbe_bits()}[structure]
        ks = prng.split(keys.to(self.device), 5)
        core = prng.randint(ks[:, 0], 0, cfg.n_cores)
        mset_hi = n_lines if structure == "dir" else cfg.n_sets
        return MesiFault(
            target=torch.full_like(core, tgt), core=core,
            mset=prng.randint(ks[:, 1], 0, mset_hi),
            way=prng.randint(ks[:, 2], 0, cfg.n_ways),
            bit=prng.randint(ks[:, 3], 0, n_bits),
            cycle=prng.randint(ks[:, 4], 0, self.n_accesses))

    def outcomes_of_faults(self, faults: MesiFault,
                           structure: str | None = None) -> torch.Tensor:
        """Outcome classes int32[B] of a fault batch (its targets name the
        structure)."""
        B = int(faults.cycle.shape[0])
        prot = self.cfg.state_protection
        if prot == PROT_ECC or B == 0:
            # single-bit corrected: every lane is masked whatever its walk
            return torch.full((B,), C.OUTCOME_MASKED, dtype=torch.int32,
                              device=self.device)
        loads, mem = mesi_replay(self.trace, self.cfg, self.init_mem,
                                 faults)
        sdc = ((loads != self.golden_loads).any(dim=1)
               | (mem != self.golden_mem).any(dim=1))
        # parity detects the flip when the entry is next referenced but
        # cannot correct it: detected-uncorrectable = DUE, the mapping of
        # models/ruby.py
        hit = C.OUTCOME_DUE if prot == PROT_PARITY else C.OUTCOME_SDC
        return torch.where(sdc, hit, C.OUTCOME_MASKED).to(torch.int32)

    def strata_of(self, faults: MesiFault) -> torch.Tensor:
        """Landing-access octiles over the stream: late protocol-state
        flips have fewer chances to be exercised before the window ends,
        so per-octile rates differ."""
        from shrewd_tpu_torch.ops.trial import N_STRATA

        return torch.clamp(faults.cycle.to(torch.int64) * N_STRATA
                           // max(self.n_accesses, 1), 0, N_STRATA - 1)
