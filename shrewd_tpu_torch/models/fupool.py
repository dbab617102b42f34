"""Shadow-FU pool model — the SHREWD microarchitecture proper (the port's
copy of ``shrewd_tpu/models/fupool.py``, plain numpy on the host).

The reference's defining addition is redundant execution through *shadow*
functional units: at issue, an ALU/FP µop may claim a second FU that
re-executes and checks its result (``src/cpu/o3/inst_queue.cc:897-903``).
Whether a shadow unit is available is a structural question answered by the
FU pool — ``FUPool::getUnit(capability, is_shadow, approx_capability)``
(``src/cpu/o3/fu_pool.hh:175-180``, ``fu_pool.cc:177-294``) hands out a free
unit whose capability set matches the µop's OpClass exactly or, failing that,
an *approximate* capability the caller is willing to accept; the sentinel
``NoShadowFU`` (``fu_pool.hh:148``) denies the request.  With
``priorityToShadow`` false, shadow requests are deferred to a second pass
after all primary issues that cycle (``inst_queue.cc:1029-1066``,
``requestShadow`` ``:1082-1096``).

Mapping: there is no event-driven FU acquisition to replicate.
Shadow availability is a *deterministic function of the trace* under the
framework's 1-IPC issue proxy — µop *i* issues in cycle ``i // issue_width``
alongside its cycle-mates, and a greedy in-order allocation over the pool's
free units decides, per µop, whether a shadow was granted (exact), granted
approximately, or denied.  The allocator runs once per (trace, config) on the
host; the replay scans and the fast-pass kernel consume a per-µop coverage
array (``coverage()``), so detection is a single gather + compare.  Per-OpClass
availability statistics mirror the reference's IQ counters
(``src/cpu/o3/inst_queue.hh:581-606``).
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.utils.config import Child, ConfigObject, Param, VectorParam

# Shadow grant classes (per µop).
GRANT_NONE = 0      # not shadow-eligible, or pool had no free unit
GRANT_EXACT = 1     # shadow on an exactly-matching unit
GRANT_APPROX = 2    # shadow on an approximate-capability unit


class FUDesc(ConfigObject):
    """One functional-unit type (``src/cpu/o3/FuncUnitConfig.py`` analog).

    ``capabilities`` lists the OpClass codes the unit executes;
    ``approx_capabilities`` lists OpClasses it can *check* approximately when
    claimed as a shadow (the ``approx_capability`` relaxation of
    ``FUPool::getUnit``, ``fu_pool.hh:175-180``).  ``pipelined`` units are
    freed the cycle after issue regardless of ``op_lat``
    (``FUPool::freeUnitNextCycle``, ``inst_queue.cc:934-963``); only
    non-pipelined units (the reference's divider/sqrt ``OpDesc``s,
    ``FuncUnitConfig.py``) stay busy for the full latency."""

    count = Param(int, 1, "number of units of this type")
    op_lat = Param(int, 1, "operation latency in cycles")
    pipelined = Param(bool, True, "freed next cycle if true, else busy "
                      "for op_lat cycles (reference OpDesc.pipelined)")
    capabilities = VectorParam(int, [], "OpClass codes executed")
    approx_capabilities = VectorParam(
        int, [], "OpClass codes checkable approximately as a shadow")


class IntALU(FUDesc):
    """Reference ``IntALU`` (count 6 in the default O3 pool,
    ``src/cpu/o3/FUPool.py``).  As a shadow it approximately checks the FP
    classes — the reference's ``FloatAdd/Mult/Div/Sqrt → IntAlu`` fallback
    (``fu_pool.cc:233-277``)."""
    count = Param(int, 6, "number of units of this type")
    capabilities = VectorParam(int, [U.OC_INT_ALU], "OpClass codes executed")
    approx_capabilities = VectorParam(
        int, [U.OC_FP_ALU, U.OC_FP_MULT],
        "OpClass codes checkable approximately")


class IntMultDiv(FUDesc):
    """Reference ``IntMultDiv`` (count 2 in the default pool; IntMult
    opLat 3 pipelined, IntDiv opLat 20 non-pipelined —
    ``FuncUnitConfig.py:50-56``).  Nothing falls back *to* this unit in the
    reference's shadow scheme (``fu_pool.cc:177-294``)."""
    count = Param(int, 2, "number of units of this type")
    op_lat = Param(int, 3, "operation latency in cycles")
    capabilities = VectorParam(int, [U.OC_INT_MULT], "OpClass codes executed")


class FP_ALU(FUDesc):
    """Reference ``FP_ALU`` (count 4, FloatAdd/Cmp/Cvt ops, opLat 2,
    ``FuncUnitConfig.py:59-65``).  As a shadow it approximately checks
    integer ALU ops — the reference's ``IntAlu → FloatAdd, FloatCmp``
    fallback (``fu_pool.cc:193-209``)."""
    count = Param(int, 4, "number of units of this type")
    op_lat = Param(int, 2, "operation latency in cycles")
    capabilities = VectorParam(int, [U.OC_FP_ALU], "OpClass codes executed")
    approx_capabilities = VectorParam(
        int, [U.OC_INT_ALU], "OpClass codes checkable approximately")


class FP_MultDiv(FUDesc):
    """Reference ``FP_MultDiv`` (count 2; FloatMult opLat 4 pipelined,
    FloatDiv/Sqrt non-pipelined, ``FuncUnitConfig.py:68-76``).  As a shadow
    it approximately checks integer multiplies/divides — the reference's
    ``IntMult → FloatMult`` / ``IntDiv → FloatDiv`` fallback
    (``fu_pool.cc:210-231``)."""
    count = Param(int, 2, "number of units of this type")
    op_lat = Param(int, 4, "operation latency in cycles")
    capabilities = VectorParam(int, [U.OC_FP_MULT],
                               "OpClass codes executed")
    approx_capabilities = VectorParam(
        int, [U.OC_INT_MULT], "OpClass codes checkable approximately")


class RdWrPort(FUDesc):
    """Reference ``RdWrPort`` (count 4): the load/store AGU+port units.
    Memory µops are not shadow-eligible (SHREWD re-executes ALU/FP work;
    re-issuing a memory access is not a containment-safe check)."""
    count = Param(int, 4, "number of units of this type")
    capabilities = VectorParam(int, [U.OC_MEM_READ, U.OC_MEM_WRITE],
                               "OpClass codes executed")


class FUPoolConfig(ConfigObject):
    """The issue-stage functional-unit pool (``src/cpu/o3/FUPool.py`` analog,
    reduced to this framework's OpClass granularity)."""

    int_alu = Child(IntALU)
    int_mult = Child(IntMultDiv)
    fp_alu = Child(FP_ALU)
    fp_mult = Child(FP_MultDiv)
    mem_port = Child(RdWrPort)
    shadow_eligible = VectorParam(
        int, [U.OC_INT_ALU, U.OC_INT_MULT, U.OC_FP_ALU, U.OC_FP_MULT],
        "OpClasses that request shadow re-execution when issued")
    approx_coverage = Param(
        float, 1.0, "detection probability when the shadow runs on an "
        "approximate-capability unit (1.0 = approx check is exact)")

    def descs(self) -> list[FUDesc]:
        """Pool scan order — declaration order, like the reference's
        ``fuPerCapList`` walk in ``FUPool::getUnit``."""
        return [self.int_alu, self.int_mult, self.fp_alu, self.fp_mult,
                self.mem_port]


class FUPoolModel:
    """Greedy per-cycle FU allocation over a µop trace.

    Produces, per µop: the shadow grant class (``grants``) and the derived
    detection-coverage array (``coverage()``) the replay kernel gathers from.
    Collects the per-OpClass availability counters the reference keeps in the
    IQ (``inst_queue.hh:581-606``) plus the classic ``statFuBusy`` analog.

    ``issue_cycle`` (optional, int64[n]) assigns each µop its issue cycle —
    pass ``Scoreboard.issue`` from ``models.timing.compute_scoreboard`` to
    drive contention with the anchored timing model's schedule instead of
    the dense ``i // issue_width`` proxy.  Within a cycle, µops contend in
    trace order (the reference's oldest-first ``listOrder`` walk,
    ``inst_queue.cc:850``).

    ``busy_cycles`` (optional, int64[n]) overrides how long the *primary*
    unit claimed by µop *i* stays busy — use it to mark non-pipelined divide
    µops (reference ``OpDesc(pipelined=False)``, ``FuncUnitConfig.py:53``)
    that hold a unit for their full latency while everything else frees the
    next cycle.  ``approx_busy_cycles`` does the same for an
    *approximately-granted shadow* (an IntDiv checked on a FloatDiv unit
    holds it for the non-pipelined FloatDiv latency, ``fu_pool.cc:221-231``
    + ``FuncUnitConfig.py:73``).

    ``retry_primary`` (default True) models the IQ's FU-busy retry loop:
    a µop whose OpClass has no free unit stays in the ready list and
    re-attempts each cycle (``statFuBusy`` bump + ``++order_it``,
    ``inst_queue.cc:1020-1024``) — it *slips* to the first cycle a capable
    unit frees, and its one-shot shadow request fires in that cycle.  With
    ``retry_primary=False`` a failed µop abandons the claim (the pre-r5
    behavior; µop proceeds unmodelled).

    ``phantom_opclass``/``phantom_cycle`` inject *wrong-path* issue mass:
    the reference issues down mispredicted paths and those µops claim FUs
    and request shadows exactly like correct-path ones (their counters land
    in the same IQ stats) until the squash walk kills them.  Phantoms
    contend and are tallied in ``phantom_*`` counters (availability() can
    fold them in) but never receive a ``grants`` entry — they have no
    replay coordinates.  Phantoms do not retry (a squashed µop stops
    re-attempting).
    """

    def __init__(self, opclass: np.ndarray, issue_width: int = 8,
                 pool: FUPoolConfig | None = None,
                 priority_to_shadow: bool = False,
                 issue_cycle: np.ndarray | None = None,
                 busy_cycles: np.ndarray | None = None,
                 approx_busy_cycles: np.ndarray | None = None,
                 retry_primary: bool = True,
                 phantom_opclass: np.ndarray | None = None,
                 phantom_cycle: np.ndarray | None = None,
                 phantom_busy_cycles: np.ndarray | None = None,
                 phantom_approx_busy_cycles: np.ndarray | None = None,
                 phantom_retry: bool = False):
        self.pool = pool if pool is not None else FUPoolConfig()
        self.issue_width = int(issue_width)
        self.priority_to_shadow = bool(priority_to_shadow)
        self.retry_primary = bool(retry_primary)
        # decomposition-mass phantoms (committed µops of a finer-grained
        # ISA) retry like real µops; wrong-path phantoms die at the squash
        self._ph_retry = bool(phantom_retry)
        oc = np.asarray(opclass, dtype=np.int32)
        self.n = int(oc.shape[0])

        descs = self.pool.descs()
        counts = np.array([d.count for d in descs], dtype=np.int64)
        # Busy time of a claimed unit: pipelined units free next cycle
        # (FUPool::freeUnitNextCycle, inst_queue.cc:934-963); non-pipelined
        # ones at completion (FUCompletion::setFreeFU).
        hold = np.array([1 if d.pipelined else d.op_lat for d in descs],
                        dtype=np.int64)
        cap = np.zeros((len(descs), U.N_OPCLASSES), dtype=bool)
        approx = np.zeros_like(cap)
        for di, d in enumerate(descs):
            cap[di, list(d.capabilities)] = True
            approx[di, list(d.approx_capabilities)] = True
        eligible = np.zeros(U.N_OPCLASSES, dtype=bool)
        eligible[list(self.pool.shadow_eligible)] = True

        # Stats (per OpClass).  phantom_* mirror the shadow_* trio for
        # wrong-path contenders (the reference folds both into one counter
        # set; kept separate here so real-µop coverage stays clean).
        self.shadow_requests = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.shadow_granted = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.shadow_granted_approx = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.shadow_denied = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.fu_busy = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.phantom_requests = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.phantom_granted = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.phantom_granted_approx = np.zeros(U.N_OPCLASSES,
                                               dtype=np.int64)
        self.phantom_denied = np.zeros(U.N_OPCLASSES, dtype=np.int64)
        self.phantom_fu_busy = np.zeros(U.N_OPCLASSES, dtype=np.int64)

        self.grants = np.zeros(self.n, dtype=np.int8)
        self.slip = np.zeros(self.n, dtype=np.int64)   # retry wait, cycles

        unit_desc = np.repeat(np.arange(len(descs)), counts)
        self._unit_hold = hold[unit_desc]
        self._free_at = np.zeros(len(unit_desc), dtype=np.int64)
        self._busy = (None if busy_cycles is None
                      else np.asarray(busy_cycles, dtype=np.int64))
        if self._busy is not None and self._busy.shape[0] != self.n:
            raise ValueError("busy_cycles length != opclass length")
        self._approx_busy = (None if approx_busy_cycles is None
                             else np.asarray(approx_busy_cycles,
                                             dtype=np.int64))
        if self._approx_busy is not None \
                and self._approx_busy.shape[0] != self.n:
            raise ValueError("approx_busy_cycles length != opclass length")
        # Loop-invariant unit-scan lists per OpClass (pool order).
        cap_units = [list(np.nonzero(cap[unit_desc, c])[0])
                     for c in range(U.N_OPCLASSES)]
        approx_units = [list(np.nonzero(approx[unit_desc, c])[0])
                        for c in range(U.N_OPCLASSES)]

        if issue_cycle is None:
            W = self.issue_width
            cyc_of = np.arange(self.n, dtype=np.int64) // W
        else:
            cyc_of = np.asarray(issue_cycle, dtype=np.int64)
            if cyc_of.shape[0] != self.n:
                raise ValueError("issue_cycle length != opclass length")

        # Merge real µops (ids 0..n-1) and phantoms (ids ≥ n) into one
        # cycle-ordered walk; within a cycle real µops go first (the
        # wrong-path entries are younger than every already-ready
        # correct-path µop in the reference's age-ordered listOrder walk).
        if phantom_opclass is not None:
            poc = np.asarray(phantom_opclass, dtype=np.int32)
            pcyc = np.asarray(phantom_cycle, dtype=np.int64)
            if poc.shape != pcyc.shape:
                raise ValueError("phantom arrays must match in length")
            all_oc = np.concatenate([oc, poc])
            all_cyc = np.concatenate([cyc_of, pcyc])
            for name, arr in (("phantom_busy_cycles", phantom_busy_cycles),
                              ("phantom_approx_busy_cycles",
                               phantom_approx_busy_cycles)):
                if arr is not None and np.asarray(arr).shape != poc.shape:
                    raise ValueError(f"{name} length != phantom length")
            self._ph_busy = (None if phantom_busy_cycles is None
                             else np.asarray(phantom_busy_cycles, np.int64))
            self._ph_approx_busy = (
                None if phantom_approx_busy_cycles is None
                else np.asarray(phantom_approx_busy_cycles, np.int64))
        else:
            all_oc, all_cyc = oc, cyc_of
            self._ph_busy = self._ph_approx_busy = None
        total = all_oc.shape[0]

        order = np.argsort(all_cyc, kind="stable")
        # µops waiting for a free unit, keyed by their next attempt cycle
        # (the IQ ready list: a FU-busy µop stays and re-attempts,
        # inst_queue.cc:1020-1024).  Retried µops are older than any
        # fresh µop of the attempt cycle, so they go first — that is what
        # makes the reference's priority mode pair-atomic: at cycle start
        # every pipelined unit is free, so the head-of-list retried µop
        # always forms a full (primary, shadow) pair.
        waiting: dict[int, list[tuple[int, int]]] = {}

        g0 = 0
        while g0 < total or waiting:
            cyc = None
            if g0 < total:
                cyc = int(all_cyc[order[g0]])
            if waiting:
                wmin = min(waiting)
                cyc = wmin if cyc is None else min(cyc, wmin)
            deferred: list[tuple[int, int]] = []
            issued = [0]     # width-bounded issue per cycle (totalWidth)

            def attempt(i, oc_i):
                real = i < self.n
                if issued[0] >= self.issue_width:
                    # the width-bounded issue loop never reaches this µop
                    # this cycle — it stays in the ready list (no
                    # statFuBusy: the FU was never asked).  Phantoms die
                    # at the squash unless phantom_retry says otherwise —
                    # same squash semantics as the FU-busy branch below.
                    if real or self._ph_retry:
                        waiting.setdefault(cyc + 1, []).append((i, oc_i))
                    return
                if real:
                    h = (int(self._busy[i])
                         if self._busy is not None else 0)
                else:
                    h = (int(self._ph_busy[i - self.n])
                         if self._ph_busy is not None else 0)
                units = cap_units[oc_i]
                if not units:
                    return                               # NoCapableFU
                busy_ctr = self.fu_busy if real else self.phantom_fu_busy
                if not self._claim(cyc, units, h):
                    if self.retry_primary and (real or self._ph_retry):
                        # re-enter the ready list at the earliest cycle a
                        # capable unit frees; statFuBusy counts the wait
                        t = int(min(self._free_at[u] for u in units))
                        t = max(t, cyc + 1)
                        busy_ctr[oc_i] += t - cyc
                        if real:
                            self.slip[i] += t - cyc
                        waiting.setdefault(t, []).append((i, oc_i))
                    else:
                        # phantoms die at the squash; non-retry abandons
                        busy_ctr[oc_i] += 1
                    return
                issued[0] += 1
                # requestShadow only fires for a successfully issued
                # primary (inst_queue.cc:1082+ guard)
                if eligible[oc_i]:
                    if self.priority_to_shadow:
                        # shadow claimed immediately at issue
                        # (inst_queue.cc:897-903)
                        self._shadow(cyc, i, oc_i, cap_units, approx_units)
                    else:
                        deferred.append((i, oc_i))

            # oldest first: matured retries, then this cycle's fresh µops
            for i, oc_i in waiting.pop(cyc, []):
                attempt(i, oc_i)
            while g0 < total and all_cyc[order[g0]] == cyc:
                i = int(order[g0])
                g0 += 1
                oc_i = int(all_oc[i])
                if oc_i != U.OC_NONE:
                    attempt(i, oc_i)
            # deferred shadow pass after all primaries issued
            # (inst_queue.cc:1029-1066)
            for i, oc_i in deferred:
                self._shadow(cyc, i, oc_i, cap_units, approx_units)

    def _claim(self, cyc: int, units, hold_override: int = 0) -> bool:
        for u in units:
            if self._free_at[u] <= cyc:
                h = hold_override if hold_override else self._unit_hold[u]
                self._free_at[u] = cyc + h
                return True
        return False

    def _shadow(self, cyc: int, i: int, oc_i: int, cap_units,
                approx_units) -> None:
        real = i < self.n
        req = self.shadow_requests if real else self.phantom_requests
        req[oc_i] += 1
        # Exact shadows re-run the µop's own class — non-pipelined µops
        # (divides) hold the shadow unit just like the primary; approximate
        # shadows run as the approx_capability class (fu_pool.cc:188-294):
        # per-µop approx_busy_cycles for div-family fallbacks, else the
        # granting unit's own hold.
        if real:
            h = int(self._busy[i]) if self._busy is not None else 0
            ah = (int(self._approx_busy[i])
                  if self._approx_busy is not None else 0)
        else:
            h = (int(self._ph_busy[i - self.n])
                 if self._ph_busy is not None else 0)
            ah = (int(self._ph_approx_busy[i - self.n])
                  if self._ph_approx_busy is not None else 0)
        if self._claim(cyc, cap_units[oc_i], h):
            (self.shadow_granted if real else self.phantom_granted)[oc_i] += 1
            if real:
                self.grants[i] = GRANT_EXACT
        elif self._claim(cyc, approx_units[oc_i], ah):
            (self.shadow_granted_approx if real
             else self.phantom_granted_approx)[oc_i] += 1
            if real:
                self.grants[i] = GRANT_APPROX
        else:
            (self.shadow_denied if real else self.phantom_denied)[oc_i] += 1

    def availability(self, include_phantoms: bool = False
                     ) -> dict[str, dict[str, float | int]]:
        """Per-OpClass shadow availability, the reference's
        ``<Class>ShadowAvailable / (Available + NotAvailable)`` ratio
        (``inst_queue.hh:581-606``).  A *grant* of either kind counts as
        available — the reference bumps ``shadowAvailable`` for exact and
        approximate units alike (``requestShadow``,
        ``inst_queue.cc:1082-1096``).  ``include_phantoms`` folds the
        wrong-path contenders into the counters — the comparable surface
        when checking against gem5, whose IQ stats don't distinguish
        wrong-path requests."""
        out = {}
        for c in range(U.N_OPCLASSES):
            exact = int(self.shadow_granted[c])
            app = int(self.shadow_granted_approx[c])
            den = int(self.shadow_denied[c])
            if include_phantoms:
                exact += int(self.phantom_granted[c])
                app += int(self.phantom_granted_approx[c])
                den += int(self.phantom_denied[c])
            req = exact + app + den
            if not req:
                continue
            out[U.OPCLASS_NAMES[c]] = {
                "requests": req, "available": exact + app,
                "not_available": den,
                "availability": round((exact + app) / req, 4),
                "same_fu": exact,
                "not_same_fu": app,
            }
        return out

    def coverage(self) -> np.ndarray:
        """Per-µop shadow detection probability, float32[n]."""
        cov = np.zeros(self.n, dtype=np.float32)
        cov[self.grants == GRANT_EXACT] = 1.0
        cov[self.grants == GRANT_APPROX] = np.float32(self.pool.approx_coverage)
        return cov

    def stats_group(self, name: str = "fupool"):
        """Availability counters as a stats Group (the per-OpClass counters
        of ``inst_queue.hh:581-606`` plus ``statFuBusy``)."""
        from shrewd_tpu_torch import stats
        g = stats.Group(name)
        for attr, desc in (
                ("shadow_requests", "shadow FU requests"),
                ("shadow_granted", "shadow granted on exact-capability unit"),
                ("shadow_granted_approx", "shadow granted on approx unit"),
                ("shadow_denied", "shadow denied (NoShadowFU)"),
                ("fu_busy", "primary issue found no free unit")):
            v = stats.Vector(attr, U.N_OPCLASSES, desc,
                             subnames=list(U.OPCLASS_NAMES))
            v += getattr(self, attr)
            setattr(g, attr, v)
        return g
