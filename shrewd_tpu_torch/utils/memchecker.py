"""Memory-ordering checker: the framework's MemChecker / sanitizer analog
(SURVEY §5.2; the port's copy of ``shrewd_tpu/utils/memchecker.py``).

Reference role: gem5's ``MemChecker`` (src/mem/mem_checker.hh:74-433) — a
per-byte transaction tracker where reads and writes carry [start, complete]
tick windows and ``completeRead`` verifies the observed value against the
set of values any legal serialization could produce.

Reading for the replay kernels: they are deterministic by construction
(one program-order scan; no event races to sanitize), so this module serves
two narrower, still-real purposes:

1. **Single-stream value checking** (``check_trace``): recompute every
   load's expected value from an independent store history over the window
   and compare against the replay kernel's golden record — a framework
   self-check that catches trace-construction and kernel bugs the
   differential C++ tests might share assumptions with (a fresh walk with
   its own store-history map, sharing only the scalar ALU).

2. **Transaction-window checking** (``MemChecker``): the full readable-set
   semantics for *overlapping* transactions, used by the MESI tier's
   interleaved two-core streams where visibility windows genuinely overlap.
   A read [s, c] of address A must return either (a) the data of some write
   whose window overlaps the read, or (b) the last write completed before
   s.  This is the reference's invariant, re-derived for word granularity
   (the framework's memory model is word-addressed throughout).

Violations raise ``MemoryViolation`` with the reference-style detail string
(expected-set vs observed) or are collected via ``check_all``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch.isa import uops as U


class MemoryViolation(Exception):
    """A load observed a value no legal serialization could produce."""


class LoadCheckResult(NamedTuple):
    n_loads: int
    n_violations: int
    first_violation: int          # µop index, -1 if clean
    detail: str


def expected_load_values(trace) -> tuple[np.ndarray, np.ndarray]:
    """(load_idx, expected_value) for every load in a single-stream trace.

    Independent of the replay kernels: a fresh program-order walk over a
    separately maintained store history — it shares only the scalar ALU
    (isa/semantics.alu) with the golden paths, keeping the memory model
    (addressing, last-writer lookup) independently derived."""
    from shrewd_tpu_torch.isa.semantics import alu

    op = np.asarray(trace.opcode)
    imm = np.asarray(trace.imm)
    reg = np.asarray(trace.init_reg, np.uint32).copy()
    n_words = int(trace.init_mem.shape[0])
    # store history per word: list of (µop index, value); reads resolve to
    # the newest entry, falling back to the initial image
    history: dict[int, int] = {}
    init = np.asarray(trace.init_mem, np.uint32)

    load_idx, expected = [], []
    for i in range(op.shape[0]):
        o = int(op[i])
        a = int(reg[trace.src1[i]])
        b = int(reg[trace.src2[i]])
        res = alu(o, a, b, int(imm[i]))
        if o == U.LOAD:
            addr = res
            if addr % 4 == 0 and (addr >> 2) < n_words:
                w = addr >> 2
                val = history.get(w, int(init[w]))
                load_idx.append(i)
                expected.append(val)
                reg[trace.dst[i]] = val
        elif o == U.STORE:
            addr = res
            if addr % 4 == 0 and (addr >> 2) < n_words:
                history[addr >> 2] = b
        elif U.writes_dest(np.int64(o)):
            reg[trace.dst[i]] = res
    return (np.asarray(load_idx, np.int64),
            np.asarray(expected, np.uint32))


def check_trace(trace, observed_loads: np.ndarray | None = None,
                golden_record=None) -> LoadCheckResult:
    """Verify a golden replay's load values against the independent store
    history.

    ``golden_record``: an ops.taint.GoldenRecord (device replay output,
    from whichever device recorded it); its ``res`` stream at load
    positions is the kernel's belief of each load's value.
    ``observed_loads`` may be passed directly instead."""
    op = np.asarray(trace.opcode)
    is_ld = op == U.LOAD
    if observed_loads is None:
        if golden_record is None:
            raise ValueError("need observed_loads or golden_record")
        res = golden_record.res
        res = res.cpu().numpy() if hasattr(res, "cpu") else np.asarray(res)
        observed_loads = res[is_ld]
    idx, expected = expected_load_values(trace)
    # align: expected covers non-trapping loads only; map into the full
    # load list
    ld_pos = np.nonzero(is_ld)[0]
    pos_of = {int(p): j for j, p in enumerate(ld_pos)}
    n_viol, first = 0, -1
    detail = ""
    for k, i in enumerate(idx):
        j = pos_of[int(i)]
        obs = np.uint32(np.asarray(observed_loads).ravel()[j])
        if obs != expected[k]:
            n_viol += 1
            if first < 0:
                first = int(i)
                detail = (f"load at µop {i}: observed {obs:#010x}, "
                          f"expected {expected[k]:#010x} "
                          "(last-writer serialization)")
    return LoadCheckResult(int(is_ld.sum()), n_viol, first, detail)


# --------------------------------------------------------------------------
# transaction-window checker (overlapping transactions, MESI streams)
# --------------------------------------------------------------------------

@dataclass
class _Write:
    serial: int
    data: int
    start: int
    complete: int | None = None     # None while outstanding


@dataclass
class _WordTracker:
    """Readable-set tracking for one memory word (the reference's per-byte
    ByteTracker, word-width here)."""

    last_committed: int = 0                      # value before any write
    writes: list = field(default_factory=list)   # completed + outstanding
    outstanding_reads: dict = field(default_factory=dict)

    def start_write(self, serial: int, start: int, data: int) -> None:
        self.writes.append(_Write(serial, data, start))

    def complete_write(self, serial: int, complete: int) -> None:
        for w in self.writes:
            if w.serial == serial:
                w.complete = complete
                break
        else:
            raise KeyError(f"completeWrite: unknown serial {serial}")
        self._gc(complete)

    def _gc(self, now: int) -> None:
        """Fold writes that completed before every outstanding window into
        last_committed (mem_checker.hh's cluster pruning)."""
        live_after = min((s for s, _ in self.outstanding_reads.values()),
                        default=now)
        keep = []
        newest = None
        for w in sorted(self.writes,
                        key=lambda w: (w.complete is None, w.complete or 0)):
            if w.complete is not None and w.complete < live_after:
                newest = w
            else:
                keep.append(w)
        if newest is not None:
            self.last_committed = newest.data
            # writes completed before the folded one are subsumed
            keep = [w for w in keep
                    if w.complete is None or w.complete >= newest.complete]
        self.writes = keep

    def start_read(self, serial: int, start: int) -> None:
        self.outstanding_reads[serial] = (start, None)

    def readable_set(self, start: int, complete: int) -> set:
        vals = {self.last_committed}
        last_before = None
        for w in self.writes:
            if w.complete is not None and w.complete <= start:
                if last_before is None or w.complete > last_before.complete:
                    last_before = w
        if last_before is not None:
            vals = {last_before.data}
        for w in self.writes:
            overlaps = (w.complete is None or w.complete > start) \
                and w.start <= complete
            if overlaps:
                vals.add(w.data)
        return vals

    def complete_read(self, serial: int, complete: int, data: int
                      ) -> tuple[bool, set]:
        """→ (serializable?, the readable set checked against) — the set is
        computed from the read's REAL start tick, so a violation message
        shows exactly what was legal."""
        if serial not in self.outstanding_reads:
            raise KeyError(f"completeRead: unknown serial {serial}")
        start, _ = self.outstanding_reads.pop(serial)
        vals = self.readable_set(start, complete)
        return data in vals, vals


class MemChecker:
    """Word-granular transaction-window memory checker.

    API mirrors the reference (startRead/startWrite return a serial;
    completeRead verifies): mem_checker.hh:393-433."""

    def __init__(self, init_mem: np.ndarray | None = None):
        self._next_serial = 0
        self._trackers: dict[int, _WordTracker] = {}
        self._init = (np.asarray(init_mem, np.uint32)
                      if init_mem is not None else None)
        self.violations: list[str] = []

    def _tracker(self, word: int) -> _WordTracker:
        t = self._trackers.get(word)
        if t is None:
            init = int(self._init[word]) if self._init is not None else 0
            t = self._trackers[word] = _WordTracker(last_committed=init)
        return t

    def start_read(self, start: int, word: int) -> int:
        s = self._next_serial
        self._next_serial += 1
        self._tracker(word).start_read(s, start)
        return s

    def start_write(self, start: int, word: int, data: int) -> int:
        s = self._next_serial
        self._next_serial += 1
        self._tracker(word).start_write(s, start, int(data) & 0xFFFFFFFF)
        return s

    def complete_write(self, serial: int, complete: int, word: int) -> None:
        self._tracker(word).complete_write(serial, complete)

    def complete_read(self, serial: int, complete: int, word: int,
                      data: int) -> bool:
        """True iff ``data`` is serializable; records a violation detail
        otherwise (the reference's getErrorMessage contract)."""
        t = self._tracker(word)
        ok, legal = t.complete_read(serial, complete,
                                    int(data) & 0xFFFFFFFF)
        if not ok:
            self.violations.append(
                f"word {word}: read (serial {serial}) returned "
                f"{data:#010x} not in readable set "
                f"{sorted(legal)} at tick {complete}")
        return ok

    def assert_clean(self) -> None:
        if self.violations:
            raise MemoryViolation("; ".join(self.violations[:3]))


def check_mesi_trace(trace, cfg, init_mem: np.ndarray,
                     loads: np.ndarray) -> int:
    """Run the transaction checker over a two-core MESI access stream and
    its golden per-access load values: each access is a zero-latency
    transaction at its stream index (the MESI replay's serialization
    point), so the readable set reduces to last-writer — a cheap coherence
    self-check for the MESI tier's golden replay.  Returns the violation
    count."""
    mc = MemChecker(init_mem)
    word = np.asarray(trace.word)
    is_store = np.asarray(trace.is_store)
    value = np.asarray(trace.value)
    loads = np.asarray(loads)
    li = 0
    for a in range(word.shape[0]):
        w = int(word[a])
        if is_store[a]:
            s = mc.start_write(a, w, int(value[a]))
            mc.complete_write(s, a, w)
        else:
            s = mc.start_read(a, w)
            mc.complete_read(s, a, w, int(loads[li]))
            li += 1
    return len(mc.violations)
