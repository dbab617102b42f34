"""Scoreboard timing model: dependence-driven pipeline timestamps that
replace the 1-IPC occupancy proxy for fault-landing distributions (the
port's copy of ``shrewd_tpu/models/timing.py``).

Structure residency drives AVF: a µop that sits 40 cycles in the ROB
presents a 40× larger strike cross-section than one that commits the next
cycle.  The split:

- **host precompute** (once per trace window, numpy, as in the reference):
  an in-order-dispatch / out-of-order-issue / in-order-commit scoreboard
  walks the window and assigns each µop its dispatch, issue, writeback and
  commit cycles under configured widths, latencies and ROB capacity, with
  the branch-predictor and L1D models on top;
- **device sampling** (torch): per-structure residency intervals become a
  cumulative-mass table; a trial draws one uniform integer and
  ``searchsorted``s it into the struck µop (``ResidencySampler``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import ConfigObject, Param, VectorParam


class TimingConfig(ConfigObject):
    """Pipeline widths and per-OpClass latencies.

    Defaults mirror the reference's DerivO3CPU/FuncUnitConfig shapes
    (issueWidth 8, 192-entry ROB; IntAlu opLat 1, IntMultDiv 3/20,
    FP_ALU 2, FP_MultDiv 4/12 — src/cpu/FuncUnitConfig.py) without copying
    its scheduler: this is a scoreboard, not a ticked pipeline."""

    dispatch_width = Param(int, 8, "µops entering the ROB per cycle")
    issue_width = Param(int, 8, "µops starting execution per cycle")
    commit_width = Param(int, 8, "µops retiring per cycle")
    rob_size = Param(int, 192, "reorder-buffer capacity")
    iq_size = Param(int, 64, "issue-queue capacity (approximated in "
                    "program order: the i-iq_size'th older µop must have "
                    "issued before µop i can dispatch)")
    lsq_size = Param(int, 32, "load/store-queue capacity (same "
                     "program-order approximation over mem µops)")
    op_latency = VectorParam(int, [1, 3, 4, 1, 1, 2, 4],
                             "result latency per OpClass "
                             "(IntAlu, IntMult, MemRead, MemWrite, "
                             "No_OpClass, FloatAdd, FloatMultDiv)")
    div_latency = Param(int, 20, "integer divide/remainder latency "
                        "(overrides IntMult for DIV..REMU)")
    fdiv_latency = Param(int, 12, "FDIV latency (overrides FloatMultDiv)")
    # --- speculation / wrong path (VERDICT r3 #7; reference: ROB squash
    # walk src/cpu/o3/rob.hh:207, bpred src/cpu/pred/bpred_unit.hh:99) ---
    # default "tournament" since round 5: gem5's own O3 default predictor
    # (BaseO3CPU.py branchPred = TournamentBP()); the r5 timing anchor
    # reconciled mispredict counts within ~15% both directions where the
    # r4 bimodal was off 3× (O3_TIMING_VALIDATE_r05).
    bpred = Param(str, "tournament", "branch predictor model: 'none' "
                  "(perfect prediction), 'bimodal' (per-branch 2-bit "
                  "counters), or 'tournament' (local + global + choice, "
                  "the reference's TournamentBP default)",
                  check=lambda s: s in ("none", "bimodal", "tournament"))
    bpred_bits = Param(int, 12, "log2 of the bimodal counter-table size")
    # TournamentBP geometry (reference src/cpu/pred/BranchPredictor.py:
    # localPredictorSize 2048, localHistoryTableSize 2048,
    # globalPredictorSize 8192, choicePredictorSize 8192, 2-bit ctrs)
    local_bits = Param(int, 11, "log2 local predictor/history-table size")
    global_bits = Param(int, 13, "log2 global/choice predictor size")
    redirect_penalty = Param(int, 6, "front-end refill cycles between a "
                             "mispredicted branch's resolution and the "
                             "first correct-path dispatch — the default "
                             "O3 stage-delay sum (fetch redirect 1 + "
                             "fetchToDecodeDelay 1 + decodeToRenameDelay "
                             "1 + renameToIEWDelay 2 + dispatch 1, "
                             "src/cpu/o3/BaseO3CPU.py defaults).  The "
                             "O3PipeView-measured refill bubble is ~14 "
                             "cycles, but the bubble lands on gem5's "
                             "2.4×-denser µop stream; on the compressed "
                             "31-op stream the stage sum minimizes "
                             "aggregate per-µop error over all seven "
                             "anchor windows (O3_TIMING_VALIDATE_r05 "
                             "penalty sweep)")
    # --- front-end supply (r5): x86 fetch breaks at taken branches (one
    # fetch group per predicted-taken control transfer), which caps
    # dispatch supply in branch-dense code — gem5 sort fetches 2.9
    # insts/cycle but sustains only ~1 macro/cycle through the break +
    # squash losses ---
    taken_fetch_break = Param(bool, True, "a taken branch ends its "
                              "dispatch group (fetch-group break)")
    # --- L1D model (r5): the validation config's cache (se.py --caches:
    # 32kB 8-way 2-cycle L1D over SimpleMemory 30ns) — a flat load-to-use
    # latency misses the memops-class windows by 6× ---
    dcache = Param(str, "classic", "'none' (flat MemRead latency) or "
                   "'classic' (set-assoc LRU walk over the golden access "
                   "stream; misses charge dcache_miss_latency)",
                   check=lambda s: s in ("none", "classic"))
    dcache_sets = Param(int, 64, "L1D sets (32kB / 8 ways / 64B lines)")
    dcache_ways = Param(int, 8, "L1D associativity")
    dcache_line_words = Param(int, 16, "32-bit words per 64B line")
    dcache_miss_latency = Param(int, 94, "load miss-to-use cycles: 30ns "
                                "SimpleMemory at 3GHz (90) + L1 lookup "
                                "and response (se.py latencies)")

    def validate(self) -> None:
        if min(self.dispatch_width, self.issue_width, self.commit_width) < 1:
            raise ValueError("pipeline widths must be >= 1")
        if len(self.op_latency) != U.N_OPCLASSES:
            raise ValueError("op_latency must have one entry per OpClass")


class Scoreboard(NamedTuple):
    """Per-µop pipeline timestamps (host int64 arrays, one per stage).

    With a branch-predictor model configured, ``mispredict`` flags the
    branches whose captured direction the predictor got wrong, and the
    ``wp_mass_*`` fields carry the total residency mass of the wrong-path
    µops those mispredicts injected into the ROB/IQ — entries that exist
    only to be squashed, so a fault striking one is masked by the squash
    walk (reference: ``src/cpu/o3/rob.hh:207``)."""

    dispatch: np.ndarray
    issue: np.ndarray
    writeback: np.ndarray
    commit: np.ndarray
    mispredict: np.ndarray | None = None
    wp_mass_rob: int = 0
    wp_mass_iq: int = 0
    wp_mass_fu: int = 0
    wp_mass_lsq: int = 0

    @property
    def n_cycles(self) -> int:
        return int(self.commit[-1]) + 1 if self.commit.size else 0

    @property
    def ipc(self) -> float:
        return self.commit.size / max(1, self.n_cycles)

    def wrongpath_mass(self, structure: str) -> int:
        """Squashed-entry residency mass added to a structure's strike
        cross-section (zero unless a predictor model ran).  Wrong-path
        µops occupy ROB and IQ slots from their dispatch to the branch's
        resolution; they also *execute* (the reference really runs the
        wrong path — squash walk ``src/cpu/o3/rob.hh:207`` over
        really-executed entries) so FU and LSQ carry wrong-path mass
        too (r5; bound validated against the reference's own
        issued-vs-committed gap, WRONGPATH_BOUND_r05)."""
        return {"rob": self.wp_mass_rob, "iq": self.wp_mass_iq,
                "fu": self.wp_mass_fu, "lsq": self.wp_mass_lsq}.get(
            structure, 0)

    def occupancy(self, structure: str, mem_mask: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """[start, end) residency interval per µop for ``structure``:
        rob = dispatch→commit, iq = dispatch→issue (inclusive of the issue
        cycle), fu = issue→writeback, lsq = dispatch→commit on mem µops
        (zero-length elsewhere so the mass table skips them)."""
        if structure == "rob":
            return self.dispatch, np.maximum(self.commit, self.dispatch + 1)
        if structure == "iq":
            return self.dispatch, self.issue + 1
        if structure == "fu":
            return self.issue, np.maximum(self.writeback, self.issue + 1)
        if structure == "lsq":
            if mem_mask is None:
                raise ValueError("lsq occupancy needs the mem-µop mask")
            end = np.where(mem_mask,
                           np.maximum(self.commit, self.dispatch + 1),
                           self.dispatch)
            return self.dispatch, end
        raise KeyError(f"unknown structure {structure!r}")


def _latencies(opcode: np.ndarray, cfg: TimingConfig) -> np.ndarray:
    lat = np.asarray(cfg.op_latency, np.int64)[U.opclass_of(opcode)]
    lat = np.where(U.is_div(opcode), cfg.div_latency, lat)
    lat = np.where(np.asarray(opcode) == U.FDIV, cfg.fdiv_latency, lat)
    return np.maximum(lat, 1)


def nonpipelined_busy(opcode: np.ndarray, cfg: TimingConfig) -> np.ndarray:
    """int64[n]: FU-busy cycles for µops whose unit is NOT pipelined —
    the divide family (reference ``OpDesc(pipelined=False)`` entries,
    ``src/cpu/o3/FuncUnitConfig.py:53,73-74``) holds its unit for the full
    latency; zero elsewhere (pipelined units free next cycle,
    ``FUPool::freeUnitNextCycle``).  Feed to ``FUPoolModel(busy_cycles=)``."""
    opcode = np.asarray(opcode)
    busy = np.zeros(opcode.shape[0], np.int64)
    busy[np.asarray(U.is_div(opcode))] = cfg.div_latency
    busy[opcode == U.FDIV] = cfg.fdiv_latency
    return busy


def approx_shadow_busy(opcode: np.ndarray, cfg: TimingConfig) -> np.ndarray:
    """int64[n]: unit-hold cycles when µop *i*'s shadow is granted on an
    approximate-capability unit.  The integer-div family's fallback target
    is the FP divider (IntDiv → FloatDiv, ``fu_pool.cc:221-231``), which is
    non-pipelined (``FuncUnitConfig.py:73``) — the shadow holds it for the
    full FP-divide latency.  Every other fallback is pipelined and frees
    next cycle (0 → granting unit's default) — including FDIV's, whose
    fallback target is IntAlu: the hold is governed by
    ``isPipelined(shadow_op_class)``, true for IntAlu
    (``inst_queue.cc:1050-1061``), so charging it the non-pipelined
    integer-divide latency inflated IntALU contention in FP-div-heavy
    windows."""
    opcode = np.asarray(opcode)
    busy = np.zeros(opcode.shape[0], np.int64)
    busy[np.asarray(U.is_div(opcode))] = cfg.fdiv_latency
    busy[opcode == U.FDIV] = 0    # FloatDiv → IntAlu check, pipelined
    return busy


def wrongpath_phantoms(trace, sb: "Scoreboard", cfg: TimingConfig
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Wrong-path issue mass → (opclass int32[P], issue_cycle int64[P]).

    The reference issues down mispredicted paths until the squash walk
    (``src/cpu/o3/rob.hh:207``); those µops claim FUs and request shadows,
    landing in the same IQ counters as correct-path ones.  The framework's
    trace is correct-path-only, so shadow-availability comparisons against
    gem5 must re-inject that mass: per mispredicted branch, phantoms issue
    from the cycle after the branch's dispatch until its writeback (the
    same span the wrong-path ROB/IQ residency model uses,
    ``compute_scoreboard``), at the window's average issue rate, with
    opclasses drawn deterministically from the µops following the branch
    (the wrong path is statistically the local code mix)."""
    zero = (np.zeros(0, np.int32), np.zeros(0, np.int64))
    if sb.mispredict is None or not sb.mispredict.any():
        return zero
    oc = np.asarray(U.opclass_of(np.asarray(trace.opcode)), np.int32)
    n = oc.shape[0]
    rate = _wrongpath_issue_rate(n, sb.n_cycles, cfg)
    ph_oc: list[int] = []
    ph_cyc: list[int] = []
    for i in np.nonzero(sb.mispredict)[0]:
        lo = int(sb.dispatch[i]) + 1
        hi = int(sb.writeback[i])
        span = hi - lo + 1
        if span <= 0:
            continue
        k = span * rate
        src = np.arange(k) % max(n - i - 1, 1) + i + 1 if i + 1 < n \
            else np.zeros(k, np.int64)
        ph_oc.extend(int(x) for x in oc[src])
        ph_cyc.extend(lo + j // rate for j in range(k))
    if not ph_oc:
        return zero
    return np.asarray(ph_oc, np.int32), np.asarray(ph_cyc, np.int64)


def _branch_identity_hash(trace, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(is_branch bool[n], hashed static identity int64[n] & (2^bits-1)).

    The trace window carries no static PCs, so the branch "address" is a
    hash of the µop's encoding — re-executions of the same static branch
    (identical rows, the common case in lifted loop windows) share a
    predictor entry, which is the property every PC-indexed scheme
    needs."""
    opcode = np.asarray(trace.opcode)
    is_br = np.asarray(U.is_branch(opcode))
    src1 = np.asarray(trace.src1)
    src2 = np.asarray(trace.src2)
    imm = np.asarray(trace.imm, np.uint64)
    mask = (1 << bits) - 1
    # FNV-ish static-identity hash per row
    h = (opcode.astype(np.uint64) * np.uint64(0x100000001B3)
         ^ src1.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ src2.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
         ^ imm)
    return is_br, ((h >> np.uint64(bits)) ^ h).astype(np.int64) & mask


def _wrongpath_issue_rate(n: int, n_cycles: int, cfg: TimingConfig) -> int:
    """Wrong-path issue rate (µops/cycle): the machine runs down the
    wrong path at roughly the window's average issue rate, width-capped —
    ONE definition shared by the phantom FU-pressure mass
    (``wrongpath_phantoms``) and the wp strike mass
    (``compute_scoreboard``), so calibrating one cannot silently diverge
    from the other."""
    return min(cfg.issue_width, max(1, round(n / max(n_cycles, 1))))


def predict_mispredicts(trace, cfg: TimingConfig) -> np.ndarray:
    """bool[n]: branches whose captured direction the predictor model got
    wrong (reference: ``src/cpu/pred/bpred_unit.hh:99``).

    ``bpred="bimodal"``: per-branch 2-bit saturating counters.
    ``bpred="tournament"``: the reference O3's default TournamentBP
    (``src/cpu/pred/BranchPredictor.py``; ``tournament.cc`` lookup) —
    a local predictor indexed through a per-branch history table, a
    global predictor indexed by the global history register, and a
    choice predictor picking between them, all 2-bit counters at the
    reference's table sizes."""
    is_br, h = _branch_identity_hash(trace, 30)
    taken = np.asarray(trace.taken) != 0
    n = is_br.shape[0]
    out = np.zeros(n, bool)
    if cfg.bpred == "bimodal":
        mask = (1 << cfg.bpred_bits) - 1
        table = np.ones(mask + 1, np.int8)      # weakly not-taken
        for i in np.nonzero(is_br)[0]:
            idx = int(h[i]) & mask
            pred = table[idx] >= 2
            t = bool(taken[i])
            out[i] = pred != t
            table[idx] = (min(3, table[idx] + 1) if t
                          else max(0, table[idx] - 1))
        return out
    # tournament
    lmask = (1 << cfg.local_bits) - 1
    gmask = (1 << cfg.global_bits) - 1
    local_hist = np.zeros(lmask + 1, np.int64)      # per-branch history
    # local pattern table: 2-bit counters indexed by the branch's local
    # history register (the reference's two-level local side,
    # tournament.cc lookup)
    local_pat = np.ones(lmask + 1, np.int8)
    global_ctr = np.ones(gmask + 1, np.int8)
    choice_ctr = np.full(gmask + 1, 2, np.int8)     # weakly prefer global
    ghist = 0
    for i in np.nonzero(is_br)[0]:
        li = int(h[i]) & lmask
        gi = ghist & gmask
        lpred = local_pat[int(local_hist[li]) & lmask] >= 2
        gpred = global_ctr[gi] >= 2
        use_global = choice_ctr[gi] >= 2
        pred = gpred if use_global else lpred
        t = bool(taken[i])
        out[i] = pred != t
        # choice trains toward whichever side was right (tournament.cc)
        if lpred != gpred:
            if gpred == t:
                choice_ctr[gi] = min(3, choice_ctr[gi] + 1)
            else:
                choice_ctr[gi] = max(0, choice_ctr[gi] - 1)
        lh = int(local_hist[li]) & lmask
        if t:
            local_pat[lh] = min(3, local_pat[lh] + 1)
            global_ctr[gi] = min(3, global_ctr[gi] + 1)
        else:
            local_pat[lh] = max(0, local_pat[lh] - 1)
            global_ctr[gi] = max(0, global_ctr[gi] - 1)
        local_hist[li] = ((lh << 1) | int(t)) & lmask
        # mask like the reference's historyRegisterMask — an unmasked
        # python int grows without bound and turns the pass quadratic
        ghist = ((ghist << 1) | int(t)) & gmask
    return out


def access_stream(trace) -> tuple | None:
    """The golden memory-access stream, in program order → (µop index,
    word index, is_store) arrays over the window's loads and stores; None
    when a golden access is misaligned or past ``mem_words``.  The
    effective addresses come from one serial fault-free C++ pass
    (``native.record_chunk``'s ``ea`` stream), so no Python replay runs."""
    from shrewd_tpu_torch import native

    op = np.asarray(trace.opcode)
    ea = native.record_chunk(trace, U.writes_dest(op))[2]
    at = np.nonzero(U.is_mem(op))[0]
    addr = ea[at].astype(np.int64)
    if ((addr & 3) != 0).any() or ((addr >> 2) >= trace.mem_words).any():
        return None
    return at, addr >> 2, U.is_store(op[at])


def dcache_latencies(trace, cfg: TimingConfig) -> np.ndarray | None:
    """Per-µop result latency with an L1D model: int64[n] or None when
    ``cfg.dcache == "none"``.

    Walks the golden memory-access stream (``access_stream``) through a
    set-assoc LRU cache at the validation config's geometry (se.py
    ``--caches``: 32kB / 8-way / 64B lines over a 30ns SimpleMemory).  A
    load that misses charges ``dcache_miss_latency``; hits keep the base
    MemRead latency.  Store misses allocate (write-back, write-allocate
    like the classic ``Cache``) but do not stall the pipeline
    (non-blocking write buffer).  Addresses are the folded replay word
    space — same locality structure as the VAs the lifter folded them
    from."""
    if cfg.dcache == "none":
        return None
    lat = _latencies(trace.opcode, cfg).copy()
    rec = access_stream(trace)
    if rec is None:
        # a golden access out of range or misaligned (hand-mutated test
        # traces) leaves no access stream — keep the flat latencies rather
        # than fail the whole scoreboard
        return lat
    n_sets, n_ways = cfg.dcache_sets, cfg.dcache_ways
    wpl = cfg.dcache_line_words
    resident = np.full((n_sets, n_ways), -1, np.int64)
    stamp = np.zeros((n_sets, n_ways), np.int64)
    tick = 0
    for i, word, is_store in zip(*rec):
        line = word // wpl
        s = line % n_sets
        tick += 1
        ways = resident[s]
        hit = np.nonzero(ways == line)[0]
        if hit.size:
            stamp[s, hit[0]] = tick
        else:
            if not is_store:
                lat[i] = cfg.dcache_miss_latency
            victim = int(np.argmin(stamp[s]))
            resident[s, victim] = line
            stamp[s, victim] = tick
    return lat


def compute_scoreboard(trace, cfg: TimingConfig | None = None) -> Scoreboard:
    """Walk the window once and assign pipeline timestamps.

    Model: fetch/rename are never the bottleneck (infinite front end);
    dispatch is in-order and stalls on ROB/IQ/LSQ space and width; a µop
    issues at the first cycle ≥ ready (operands written back, dispatched)
    with a free issue slot; writeback = issue + latency; commit is in-order,
    width-limited, the cycle after writeback at the earliest."""
    cfg = cfg or TimingConfig()
    cfg.validate()
    opcode = np.asarray(trace.opcode)
    n = opcode.shape[0]
    mispredict = (predict_mispredicts(trace, cfg)
                  if cfg.bpred != "none" else None)
    pending_redirect = 0            # earliest correct-path dispatch cycle
    lat = dcache_latencies(trace, cfg)
    if lat is None:
        lat = _latencies(opcode, cfg)
    u1 = U.uses_src1(opcode)
    u2 = U.uses_src2(opcode)
    wd = U.writes_dest(opcode)
    mem = U.is_mem(opcode)
    is_br = np.asarray(U.is_branch(opcode))
    taken_arr = np.asarray(trace.taken) != 0
    src1 = np.asarray(trace.src1)
    src2 = np.asarray(trace.src2)
    dst = np.asarray(trace.dst)

    dispatch = np.zeros(n, np.int64)
    issue = np.zeros(n, np.int64)
    writeback = np.zeros(n, np.int64)
    commit = np.zeros(n, np.int64)

    last_wb = np.zeros(int(trace.init_reg.shape[0]), np.int64)
    issue_used: dict[int, int] = {}
    mem_order = np.nonzero(mem)[0]
    mem_pos = np.full(n, -1, np.int64)
    mem_pos[mem_order] = np.arange(mem_order.size)

    disp_cycle = 0
    disp_used = 0
    commit_cycle = 0
    commit_used = 0
    for i in range(n):
        d = disp_cycle
        if pending_redirect:
            # front end is refilling after the previous mispredict — the
            # first correct-path µop cannot dispatch before redirect+refill
            d = max(d, pending_redirect)
            pending_redirect = 0
        if i >= cfg.rob_size:
            d = max(d, commit[i - cfg.rob_size] + 1)
        if i >= cfg.iq_size:
            d = max(d, issue[i - cfg.iq_size] + 1)
        p = mem_pos[i]
        if p >= cfg.lsq_size:
            d = max(d, commit[mem_order[p - cfg.lsq_size]] + 1)
        if d > disp_cycle:
            disp_cycle, disp_used = d, 0
        dispatch[i] = disp_cycle
        disp_used += 1
        if disp_used >= cfg.dispatch_width:
            disp_cycle += 1
            disp_used = 0
        elif cfg.taken_fetch_break and taken_arr[i] and is_br[i]:
            # x86 fetch breaks at a predicted-taken branch: one fetch
            # group (→ dispatch group) per taken control transfer — the
            # supply cap that holds branch-dense code near 1 macro/cycle
            # on the reference machine
            disp_cycle += 1
            disp_used = 0

        ready = dispatch[i] + 1
        if u1[i]:
            ready = max(ready, last_wb[src1[i]])
        if u2[i]:
            ready = max(ready, last_wb[src2[i]])
        t = ready
        while issue_used.get(t, 0) >= cfg.issue_width:
            t += 1
        issue_used[t] = issue_used.get(t, 0) + 1
        issue[i] = t
        writeback[i] = t + lat[i]
        if wd[i]:
            last_wb[dst[i]] = writeback[i]

        c = max(writeback[i] + 1, commit_cycle)
        if c > commit_cycle:
            commit_cycle, commit_used = c, 0
        commit[i] = commit_cycle
        commit_used += 1
        if commit_used >= cfg.commit_width:
            commit_cycle += 1
            commit_used = 0

        if mispredict is not None and mispredict[i]:
            # wrong-path fetch runs from the cycle after the branch's
            # dispatch until it resolves at writeback; the correct path
            # resumes redirect_penalty cycles later
            pending_redirect = writeback[i] + cfg.redirect_penalty

    wp_rob = wp_iq = wp_fu = wp_lsq = 0
    if mispredict is not None:
        # wrong-path EXECUTION mass: the machine issues and executes down
        # the wrong path at roughly the window's issue rate until the
        # squash; each executed wrong-path µop holds an FU ~1 cycle and
        # the mem fraction of them occupies LSQ slots to the squash
        n_cyc = int(commit[-1]) + 1 if n else 1
        issue_rate = _wrongpath_issue_rate(n, n_cyc, cfg)
        mem_frac = float(np.asarray(mem).mean()) if n else 0.0
        wp_span_total = 0
        # Residency mass of the squashed wrong-path entries: per
        # mispredicted branch, the front end dispatches dispatch_width
        # µops/cycle into the free ROB space from dispatch+1 until the
        # branch resolves at writeback, and every one of them dies in the
        # squash walk.  commit[] is non-decreasing (in-order commit), so
        # in-flight count at the branch's dispatch is a searchsorted.
        for i in np.nonzero(mispredict)[0]:
            span = int(writeback[i] - dispatch[i] - 1)
            if span <= 0:
                continue
            inflight = int(i + 1 - np.searchsorted(commit, dispatch[i],
                                                   side="right"))
            free = max(cfg.rob_size - inflight, 0)
            filled = 0
            mass = 0
            for c in range(span):
                take = min(cfg.dispatch_width, free - filled)
                if take <= 0:
                    break
                # dispatched at dispatch[i]+1+c, squashed at writeback[i]
                mass += take * (span - c)
                filled += take
            wp_rob += mass
            # wrong-path µops wait in the IQ too (their operands hang on
            # the unresolved branch's shadow); same mass, IQ-capped
            wp_iq += min(mass, cfg.iq_size * max(span, 0))
            # executed wrong-path µops: issue-rate × span capped by the
            # count that actually DISPATCHED (a ROB-full mispredict
            # admits no wrong-path µops at all), ~1 FU-cycle each; the
            # mem fraction sits in the LSQ from issue to squash (~half
            # the span on average)
            executed = min(issue_rate * span, filled)
            wp_fu += executed
            wp_lsq += min(int(mem_frac * executed * max(span, 2) / 2),
                          cfg.lsq_size * span)
            wp_span_total += span
        # overlap cap: dense mispredicts (random-outcome synthetic
        # streams hit ~50% rates) produce overlapping wrong-path spans,
        # but the machine has only n_cycles of wrong-path time — scale
        # every wp mass down to the physically available span budget
        if wp_span_total > n_cyc:
            f = n_cyc / wp_span_total
            wp_rob = int(wp_rob * f)
            wp_iq = int(wp_iq * f)
            wp_fu = int(wp_fu * f)
            wp_lsq = int(wp_lsq * f)

    return Scoreboard(dispatch, issue, writeback, commit,
                      mispredict=mispredict,
                      wp_mass_rob=int(wp_rob), wp_mass_iq=int(wp_iq),
                      wp_mass_fu=int(wp_fu), wp_mass_lsq=int(wp_lsq))


class ResidencySampler:
    """Occupancy-weighted µop draws on the keys' device.

    A draw is uniform over the structure's total residency mass
    Σᵢ(endᵢ - startᵢ): one randint + one ``searchsorted`` into the
    cumulative table.  The returned landing step equals the struck µop —
    every non-REGFILE fault kind applies when its µop executes, so that is
    the program-order point the corruption takes effect."""

    def __init__(self, start: np.ndarray, end: np.ndarray,
                 squashed_mass: int = 0):
        length = np.maximum(
            np.asarray(end, np.int64) - np.asarray(start, np.int64), 0)
        if length.sum() == 0:
            length = np.ones_like(length)        # degenerate: uniform
        squashed_mass = int(squashed_mass)
        # The draw is an int32 randint, as the reference's: halve the mass
        # (floor 1 for occupied entries, so none become unreachable) until
        # it fits instead of silently wrapping.
        while int(length.sum()) + squashed_mass >= 2 ** 31:
            length = np.where(length > 0, np.maximum(length >> 1, 1), 0)
            squashed_mass >>= 1
        self.cum = np.cumsum(length)             # int64, below 2**31
        # Wrong-path (squash-masked) mass rides past the last cumulative
        # entry: a draw landing there exceeds every cum value and gets the
        # sentinel entry ``n`` — a fault coordinate no replay step matches,
        # i.e. masked by construction (the squash walk discards the struck
        # entry before commit).
        self.total = int(length.sum()) + squashed_mass
        self.n = int(length.shape[0])
        self._cum_dev: dict = {}

    def _cum_on(self, device: torch.device) -> torch.Tensor:
        if device not in self._cum_dev:
            self._cum_dev[device] = torch.as_tensor(self.cum, device=device)
        return self._cum_dev[device]

    def sample(self, keys: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
        """(B, 2) keys → (entry, step) int32[B]: the struck µop,
        residency-mass weighted; the replay landing step is the µop
        itself.  The reference counts ``u >= cum`` over the whole table
        per draw; the right-bisection index is the same number for u in
        [0, total) and needs no B × n comparison matrix."""
        u = prng.randint(keys, 0, self.total)
        entry = torch.searchsorted(self._cum_on(keys.device),
                                   u.to(torch.int64), right=True)
        entry = entry.to(torch.int32)
        return entry, entry
