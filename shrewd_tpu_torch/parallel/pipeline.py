"""Pipelined campaign engine: sync intervals and run-until-CI on the device
(the port of ``shrewd_tpu/parallel/pipeline.py``).

The serial loop (``campaign/orchestrator.py`` → ``parallel/campaign.py``)
dispatches one batch, copies its tally to the host, then runs every
host-side consumer — canary salting, tally invariants, audit sampling,
stats, checkpoint decisions — before the next dispatch.  Two engines cut
the per-batch host round trips:

- **sync-interval accumulation** (``PipelinedEngine``) — one multi-batch
  step (``ShardedCampaign.dispatch_interval``) accumulates ``sync_every``
  batches' tallies (and strata) on the device and copies them to the host
  ONCE per interval; up to ``depth`` intervals are dispatched ahead.
  Stopping-rule checks, integrity invariants and canary verification run
  at interval boundaries on the cumulative deltas.  Per-batch tallies are
  pure functions of their frozen PRNG keys and integer sums commute, so
  the interval tally is **bit-identical** to the serial loop's.  The
  ``DeviceWatchdog`` deadline is *armed at dispatch* and *enforced at
  materialization* (``resilience.call_armed``).
- **run-until-CI** (``UntilCIEngine``) — the stopping rule evaluated on
  the device after every batch (``ShardedCampaign.dispatch_until_ci``),
  one transfer per super-interval, the consumed batch count equal to the
  serial loop's.
- **serial recovery** — any failure at materialization (wedge, backend
  error, shard mismatch) or any interval-boundary integrity problem drops
  the in-flight window and re-dispatches the interval's batches one by one
  through the integrity-checked resilience ladder on the same frozen keys:
  recovery is bit-identical because the serial path is.

The port's batch step still syncs inside (the fast pass's escape
compaction), so a dispatched interval has done its device work by the time
dispatch returns; what the engines save are the per-batch tally copies and
host checks.  ``PerfStats`` counts the port's own transfers.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.utils import debug
from shrewd_tpu_torch.utils.config import ConfigObject, Param

debug.register_flag("Pipeline", "pipelined campaign engine")


class PipelineConfig(ConfigObject):
    """Knobs for the pipelined engine (a ``CampaignPlan`` child, so a
    campaign's pipelining posture is reproducible from its config dump)."""

    sync_every = Param(int, 1,
                       "batches accumulated on device per host transfer "
                       "(1 = serial semantics, exactly today's loop; keep "
                       "1 for chaos/elastic runs unless testing them "
                       "pipelined)", check=lambda v: v >= 1)
    depth = Param(int, 2,
                  "max sync intervals in flight (2 = double buffering)",
                  check=lambda v: v >= 1)
    compilation_cache_dir = Param(str, "",
                                  "opt-in persistent compilation cache "
                                  "directory of the JAX package (the port "
                                  "compiles no executables and raises "
                                  "for a non-empty value)")
    until_ci = Param(bool, False,
                     "device-resident run-until-CI: evaluate the Wilson/"
                     "post-stratified stopping rule on the device after "
                     "every batch — ONE host "
                     "transfer per super-interval instead of one per "
                     "batch, with per-batch decision cadence (results "
                     "bit-identical to the serial loop, INCLUDING the "
                     "consumed trial count).  Supersedes sync_every "
                     "where it applies; off for chaos/elastic runs "
                     "unless testing them fused")
    max_super_interval = Param(int, 64,
                               "max batches per device-resident "
                               "super-interval: bounds the while-loop "
                               "budget (integrity checks still gate "
                               "every cumulative delta) and the "
                               "shape-specialized executable variety",
                               check=lambda v: v >= 1)


class PerfStats:
    """Host-side perf ledger for the ``campaign.perf.*`` stats group —
    the speedup must be observable, not asserted."""

    def __init__(self):
        self.device_step_seconds = 0.0   # dispatch → materialized, summed
        # per interval (includes device queue time at depth > 1)
        self.device_wait_seconds = 0.0   # host BLOCKED in materialization
        # (the non-overlapped remainder of device_step_seconds)
        self.host_seconds = 0.0          # host-side work while intervals
        # were in flight (checks, stats, checkpoints, audit)
        self.dispatches = 0              # intervals dispatched
        self.intervals = 0               # intervals believed pipelined
        self.serial_fallbacks = 0        # intervals recovered serially
        self.depth_hwm = 0               # in-flight high-water mark
        # device-resident run-until-CI (UntilCIEngine): the stopping rule
        # runs on device, so the host sees one transfer per super-interval
        self.super_intervals = 0         # super-intervals believed fused
        self.host_roundtrips_saved = 0   # serial transfers minus the port's
        self.hw_trajectory_final = float("nan")  # last observed half-width
        self.auto_sync_every = 0         # last planned super-interval len

    def overlap_fraction(self) -> float:
        """Fraction of device latency hidden behind host work: 1.0 means
        the host never blocked (compute fully overlapped), 0.0 means the
        serial posture (every device second was a host wait second)."""
        if self.device_step_seconds <= 0:
            return 0.0
        return max(0.0, 1.0 - self.device_wait_seconds
                   / self.device_step_seconds)

    def to_dict(self) -> dict:
        return {
            "device_step_seconds": round(self.device_step_seconds, 4),
            "device_wait_seconds": round(self.device_wait_seconds, 4),
            "host_seconds": round(self.host_seconds, 4),
            "overlap_fraction": round(self.overlap_fraction(), 4),
            "dispatches": self.dispatches,
            "intervals": self.intervals,
            "serial_fallbacks": self.serial_fallbacks,
            "depth_hwm": self.depth_hwm,
            "super_intervals": self.super_intervals,
            "host_roundtrips_saved": self.host_roundtrips_saved,
            "hw_trajectory_final": round(self.hw_trajectory_final, 6)
            if self.hw_trajectory_final == self.hw_trajectory_final
            else None,
            "auto_sync_every": self.auto_sync_every,
        }


def _frozen_keys(sk, batch_size: int, batch_id: int):
    """The frozen per-batch trial keys — ONE derivation shared by both
    engines and their serial recovery paths, so the
    pure-function-of-coordinates contract cannot drift between them."""
    from shrewd_tpu_torch.utils import prng

    return prng.trial_keys(prng.batch_key(sk, batch_id), batch_size)


def _believe_device_result(engine, tally, strata, n_batches: int, b0: int,
                           audit_keys, esc0, tt0, recover):
    """The shared believe/quarantine path both engines run on a
    materialized device result covering ``n_batches`` batches: armed
    corruption hook, invariants + canaries on the cumulative delta,
    shard-counter sync, then the per-batch deterministic audit — any
    problem rolls the kernel's escape counters back to (esc0, tt0),
    records the quarantine and recovers through ``recover()`` (the
    serial ladder).  → (believed doc, recovered flag); ONE copy so the
    two engines' mismatch ledgers cannot drift."""
    kernel = engine.campaign.kernel
    res = resil.DispatchResult(np.asarray(tally, dtype=np.int64),
                               None if strata is None
                               else np.asarray(strata, dtype=np.int64),
                               resil.TIER_DEVICE, 1)
    res = engine.monitor.apply_corruption(res)
    problems = engine.checked.check_result(
        res, n_batches * engine.batch_size, batch_id=b0)
    engine.checked.sync_shard_counters(b0)
    if problems:
        if esc0 is not None:
            kernel.escapes = esc0
        if tt0 is not None:
            kernel.taint_trials = tt0
        engine.monitor.record_quarantine({
            "kind": problems[0]["kind"], "simpoint": engine.sp_name,
            "structure": engine.structure, "batch_id": int(b0),
            "interval": int(n_batches),
            "tier": resil.TIERS[resil.TIER_DEVICE],
            "problems": problems, "fatal": False})
        engine.monitor.requeues += 1
        doc = recover()
        engine.monitor.recovered += 1
        return doc, True
    for i, keys in enumerate(audit_keys):
        # same deterministic per-batch audit sample as the serial loop:
        # the mismatch ledger is identical whichever loop ran
        engine.checked.audit_batch(keys, b0 + i)
    return {
        "batch_id": int(b0),
        "n_batches": int(n_batches),
        "batch_size": int(engine.batch_size),
        "tally": res.tally.tolist(),
        "strata": (None if res.strata is None else res.strata.tolist()),
        "tier": int(res.tier),
        "tiers": [int(res.tier)] * int(n_batches),
        "attempts": 1,
    }, False


class _Pending(NamedTuple):
    b0: int                 # first batch id of the interval
    k: int                  # batches in the interval
    keys: list              # per-batch key arrays (audit / serial recovery)
    handle: object          # ShardedCampaign in-flight interval handle


class PipelinedEngine:
    """Per-(simpoint, structure) pipelined dispatch over one campaign.

    ``obtain(b0, k, stratified)`` returns the interval's believed result
    document (the ``_compute_batch`` doc shape plus ``n_batches`` /
    ``tiers``): materialize the head interval, keep ``depth`` intervals in
    flight behind it, run the interval-boundary integrity checks, and fall
    back to the serial per-batch checked ladder on any failure."""

    def __init__(self, campaign, checked, structure_key, batch_size: int,
                 ceiling_batches: int, sync_every: int, depth: int,
                 monitor, chaos=None, perf: PerfStats | None = None,
                 sp_name: str = "", structure: str = ""):
        self.campaign = campaign
        self.checked = checked            # integrity.CheckedDispatcher
        self.sk = structure_key
        self.batch_size = int(batch_size)
        self.ceiling = int(ceiling_batches)
        self.sync_every = max(int(sync_every), 1)
        self.depth = max(int(depth), 1)
        self.monitor = monitor
        self.chaos = chaos
        self.perf = perf if perf is not None else PerfStats()
        self.sp_name = sp_name
        self.structure = structure
        self._q: deque[_Pending] = deque()
        self._last_return: float | None = None

    # --- keys -----------------------------------------------------------

    def _keys(self, batch_id: int):
        return _frozen_keys(self.sk, self.batch_size, batch_id)

    # --- dispatch-ahead -------------------------------------------------

    def _drop_inflight(self) -> None:
        """Discard the in-flight queue, CLOSING each interval's async
        span (same name/coords as its "B", so exporters pair them):
        routinely-dropped speculation must not read as wedged dispatches
        in the flight recorder — unclosed spans are the wedge signal."""
        for p in self._q:
            obs_trace.tracer().emit(
                "interval_inflight", cat="dispatch", ph="E",
                sp=self.sp_name, structure=self.structure,
                b0=int(p.b0), k=int(p.k), dropped=True)
        self._q.clear()

    def _fill(self, b0: int, k: int) -> None:
        q = self._q
        if q and (q[0].b0 != b0 or q[0].k != k):
            # realignment (resume, recovery, interval-length change):
            # in-flight results are pure device work with no host side
            # effects — dropping them costs compute, never correctness
            debug.dprintf("Pipeline", "%s/%s: dropping %d stale in-flight "
                          "intervals (head %d!=%d)", self.sp_name,
                          self.structure, len(q), q[0].b0, b0)
            self._drop_inflight()
        while len(q) < self.depth:
            nb = (q[-1].b0 + q[-1].k) if q else b0
            if nb >= self.ceiling:
                break
            # prefetch length follows the caller's CURRENT ask, not the
            # plan ceiling: when the orchestrator's half-width-adaptive
            # interval shrinks toward convergence (k → 1), speculative
            # dispatch-ahead shrinks with it — batches past the stopping
            # point are wasted device work, and near convergence is
            # exactly where the next ask will be short
            kk = min(k, self.sync_every, self.ceiling - nb)
            if not q:
                kk = k            # the head must match the caller's ask
            keys = [self._keys(b) for b in range(nb, nb + kk)]
            # async-span begin: the interval is now in flight — the
            # matching "E" lands at materialization, so the exported
            # timeline shows dispatch-ahead overlap and queue depth
            obs_trace.tracer().emit(
                "interval_inflight", cat="dispatch", ph="B",
                sp=self.sp_name, structure=self.structure,
                b0=int(nb), k=int(kk))
            handle = self.campaign.dispatch_interval(keys)
            q.append(_Pending(nb, kk, keys, handle))
            self.perf.dispatches += 1
            self.perf.depth_hwm = max(self.perf.depth_hwm, len(q))
            obs_trace.tracer().counter(
                "dispatch_depth", len(q), cat="dispatch",
                sp=self.sp_name, structure=self.structure)
        if not q or q[0].b0 != b0:
            raise RuntimeError(
                f"{self.sp_name}/{self.structure}: interval at batch {b0} "
                f"is beyond the campaign ceiling ({self.ceiling} batches)")

    # --- the believed-interval protocol ---------------------------------

    def obtain(self, b0: int, k: int, stratified: bool = False) -> dict:
        now = obs_clock.monotonic()
        if self._last_return is not None:
            # host-side time since the last interval was handed over:
            # stats/stopping/checkpoint work that ran while the next
            # intervals computed — the overlapped half of the ledger
            self.perf.host_seconds += now - self._last_return
        try:
            return self._obtain(b0, k, stratified)
        finally:
            self._last_return = obs_clock.monotonic()

    def _obtain(self, b0: int, k: int, stratified: bool) -> dict:
        try:
            # dispatch failures (an interval-step compile the backend
            # rejects, an enqueue-time crash) must degrade like any other
            # device failure — the serial ladder is the recovery path for
            # the whole interval, exactly as for a materialization wedge
            self._fill(b0, k)
            head = self._q.popleft()
            if self.chaos is not None:
                # armed device-tier chaos faults fire at consume time, the
                # pipelined analog of the ladder's per-dispatch hook
                self.chaos.maybe_backend_error(resil.TIER_DEVICE)
            # the per-batch watchdog deadline scales by interval length x
            # in-flight depth: a prefetched interval legitimately queues
            # behind everything dispatched ahead of it
            wd = self.campaign.watchdog
            tmo = (wd.timeout * k * self.depth
                   if wd is not None and wd.timeout > 0 else None)
            # snapshot the kernel's escape counters: materialization bumps
            # them, but a quarantined interval's bump must be rolled back
            # before serial recovery re-adds the believed values (the
            # _CounterGuard discipline of the serial checked dispatch)
            kernel = self.campaign.kernel
            esc0 = getattr(kernel, "escapes", None)
            tt0 = getattr(kernel, "taint_trials", None)
            t0 = obs_clock.monotonic()
            tally, strata = self.campaign.materialize_interval(
                head.handle, timeout=tmo)
            t1 = obs_clock.monotonic()
            self.perf.device_wait_seconds += t1 - t0
            self.perf.device_step_seconds += t1 - head.handle.armed_at
            obs_trace.tracer().emit(
                "interval_inflight", cat="dispatch", ph="E",
                sp=self.sp_name, structure=self.structure,
                b0=int(b0), k=int(k))
        except Exception as e:  # noqa: BLE001 — wedge, backend crash,
            # shard-sum mismatch: every dispatch/materialization failure
            # recovers through the serial per-batch ladder on frozen keys
            debug.dprintf("Pipeline", "%s/%s interval [%d,%d): "
                          "pipelined dispatch failed (%s) — serial "
                          "recovery", self.sp_name, self.structure,
                          b0, b0 + k, e)
            return self._recover(b0, k, stratified)
        doc, recovered = _believe_device_result(
            self, tally, strata, k, b0, head.keys, esc0, tt0,
            lambda: self._recover(b0, k, stratified))
        if not recovered:
            self.perf.intervals += 1
        return doc

    def _recover(self, b0: int, k: int, stratified: bool) -> dict:
        """Serial per-batch recovery on the frozen keys: the in-flight
        window is untrusted (a wedged backend may poison everything
        dispatched to it), so drop it and route each batch through the
        integrity-checked resilience ladder — the exact serial path, so
        recovery is bit-identical by the ladder's own contract."""
        self._drop_inflight()
        obs_trace.tracer().emit(
            "serial_recovery", cat="dispatch", sp=self.sp_name,
            structure=self.structure, b0=int(b0), k=int(k))
        return _serial_batches(self.checked, self._keys, b0, k, stratified,
                               self.batch_size, self.perf)


def _serial_batches(checked, keys_fn, b0: int, k: int, stratified: bool,
                    batch_size: int, perf: PerfStats,
                    stop_after=None) -> dict:
    """The shared serial per-batch ladder loop behind both engines'
    recovery paths (and the until-CI recovery's host-rule replay):
    ``stop_after(j, res)`` — called after batch ``b0 + j`` is believed —
    may end the loop early (the until-CI path re-derives the device's
    stopping decision with the HOST rule, so a quarantined super-interval
    recovers bit-identically without trusting the device-decided batch
    count)."""
    from shrewd_tpu_torch.ops import classify as C

    perf.serial_fallbacks += 1
    tally = np.zeros(C.N_OUTCOMES, dtype=np.int64)
    strata_sum = None
    tiers: list[int] = []
    attempts = 0
    for j in range(k):
        b = b0 + j
        res = checked.tally_batch(keys_fn(b), stratified=stratified,
                                  batch_id=b)
        tally += np.asarray(res.tally, dtype=np.int64)
        if res.strata is not None:
            s = np.asarray(res.strata, dtype=np.int64)
            strata_sum = s if strata_sum is None else strata_sum + s
        tiers.append(int(res.tier))
        attempts += int(res.attempts)
        if stop_after is not None and stop_after(j, res):
            break
    return {
        "batch_id": int(b0),
        "n_batches": len(tiers),
        "batch_size": int(batch_size),
        "tally": tally.tolist(),
        "strata": (None if strata_sum is None else strata_sum.tolist()),
        "tier": int(max(tiers)),
        "tiers": tiers,
        "attempts": int(attempts),
    }


class UntilCIEngine:
    """Device-resident run-until-CI driver for one campaign (the fused
    stopping rule of ``ShardedCampaign.dispatch_until_ci``).

    ``obtain(b0, S, tallies, strata, strat_rule)`` dispatches ONE
    super-interval — the device consumes up to ``S`` frozen-key batches,
    checking the Wilson/post-stratified half-width against the target
    after each, and the host transfers ONE result when the rule fires or
    the budget runs out.  The believed-result document is the interval
    doc shape with ``n_batches`` = the device-decided consumed count,
    plus the half-width trajectory tail for the orchestrator's
    super-interval planner.

    Integrity stance: the super-interval is bounded (``S``), and the
    interval-boundary invariants, canary battery and sampled audit still
    gate the cumulative delta before a converged result is believed.  A
    quarantined or failed super-interval re-dispatches down the serial
    per-batch ladder on the same frozen keys, re-deriving the stopping
    decision with the HOST rule after every believed batch — so recovery
    never trusts the device-decided count and is bit-identical by the
    decision-parity contract (stopping.wilson_halfwidth_device)."""

    def __init__(self, campaign, checked, structure_key, batch_size: int,
                 monitor, *, min_trials: int, target_halfwidth: float,
                 confidence: float, chaos=None,
                 perf: PerfStats | None = None,
                 sp_name: str = "", structure: str = ""):
        self.campaign = campaign
        self.checked = checked            # integrity.CheckedDispatcher
        self.sk = structure_key
        self.batch_size = int(batch_size)
        self.monitor = monitor
        self.min_trials = int(min_trials)
        self.target_halfwidth = float(target_halfwidth)
        self.confidence = float(confidence)
        self.chaos = chaos
        self.perf = perf if perf is not None else PerfStats()
        self.sp_name = sp_name
        self.structure = structure

    def _keys(self, batch_id: int):
        return _frozen_keys(self.sk, self.batch_size, batch_id)

    def obtain(self, b0: int, S: int, tallies, strata,
               strat_rule: bool) -> dict:
        """One believed super-interval starting at batch ``b0`` with
        budget ``S``, given the campaign's cumulative state (``tallies``
        int64 (N_OUTCOMES,), ``strata`` int64 | None)."""
        self.perf.auto_sync_every = int(S)
        trials0 = int(np.asarray(tallies).sum())
        keys = [self._keys(b) for b in range(b0, b0 + S)]
        kernel = self.campaign.kernel
        esc0 = getattr(kernel, "escapes", None)
        tt0 = getattr(kernel, "taint_trials", None)
        tr0 = self.campaign.transfers
        try:
            obs_trace.tracer().emit(
                "super_interval_inflight", cat="dispatch", ph="B",
                sp=self.sp_name, structure=self.structure,
                b0=int(b0), k=int(S))
            handle = self.campaign.dispatch_until_ci(
                keys, tallies, strata, trials0, self.min_trials,
                self.target_halfwidth, self.confidence, strat_rule)
            self.perf.dispatches += 1
            if self.chaos is not None:
                # armed device-tier chaos faults fire at consume time,
                # exactly like the pipelined interval path
                self.chaos.maybe_backend_error(resil.TIER_DEVICE)
            wd = self.campaign.watchdog
            tmo = (wd.timeout * S if wd is not None and wd.timeout > 0
                   else None)
            t0 = obs_clock.monotonic()
            tally, strata_d, consumed, hw_tail = \
                self.campaign.materialize_until_ci(handle, timeout=tmo)
            copies = self.campaign.transfers - tr0
            t1 = obs_clock.monotonic()
            self.perf.device_wait_seconds += t1 - t0
            self.perf.device_step_seconds += t1 - handle.armed_at
            obs_trace.tracer().emit(
                "super_interval_inflight", cat="dispatch", ph="E",
                sp=self.sp_name, structure=self.structure,
                b0=int(b0), k=int(S), consumed=int(consumed))
        except Exception as e:  # noqa: BLE001 — wedge, backend crash,
            # shard-sum mismatch: recover serially on frozen keys with
            # the host stopping rule deciding where to stop
            debug.dprintf("Pipeline", "%s/%s until-CI super-interval "
                          "[%d,%d): device loop failed (%s) — serial "
                          "recovery", self.sp_name, self.structure,
                          b0, b0 + S, e)
            return self._recover(b0, S, tallies, strata, strat_rule)
        doc, recovered = _believe_device_result(
            self, tally, strata_d, consumed, b0, keys[:consumed],
            esc0, tt0,
            lambda: self._recover(b0, S, tallies, strata, strat_rule))
        if recovered:
            return doc
        # super_intervals is the fused loop's own counter; perf.intervals
        # stays pipelined-path-only (its stats description says so)
        self.perf.super_intervals += 1
        # the serial host loop would have paid one copy per batch; the
        # device loop paid what its campaign counted (the stop-flag reads
        # and the final copies), so the saving may be negative
        self.perf.host_roundtrips_saved += consumed - copies
        if len(hw_tail):
            self.perf.hw_trajectory_final = float(hw_tail[-1])
        doc["hw_tail"] = [float(h) for h in hw_tail]
        return doc

    def _recover(self, b0: int, S: int, tallies, strata,
                 strat_rule: bool) -> dict:
        """Serial per-batch ladder replay of the super-interval on the
        same frozen keys, with the HOST stopping rule re-deriving the
        consumed batch count (never trusting a device-decided count from
        an untrusted result)."""
        from shrewd_tpu_torch.parallel import stopping

        obs_trace.tracer().emit(
            "serial_recovery", cat="dispatch", sp=self.sp_name,
            structure=self.structure, b0=int(b0), k=int(S),
            host_rule=True)

        cum = np.asarray(tallies, dtype=np.int64).copy()
        cum_strata = (None if strata is None
                      else np.asarray(strata, dtype=np.int64).copy())

        def stop_after(_j, res) -> bool:
            nonlocal cum, cum_strata
            cum = cum + np.asarray(res.tally, dtype=np.int64)
            if res.strata is not None:
                s = np.asarray(res.strata, dtype=np.int64)
                cum_strata = (s.copy() if cum_strata is None
                              else cum_strata + s)
            trials = int(cum.sum())
            if strat_rule:
                return stopping.should_stop_stratified(
                    stopping.pairs_from_strata(cum_strata),
                    self.target_halfwidth, self.confidence,
                    self.min_trials)
            from shrewd_tpu_torch.ops import classify as C

            vul = int(cum[C.OUTCOME_SDC] + cum[C.OUTCOME_DUE])
            return stopping.should_stop(vul, trials,
                                        self.target_halfwidth,
                                        self.confidence, self.min_trials)

        return _serial_batches(self.checked, self._keys, b0, S,
                               self.campaign.stratify, self.batch_size,
                               self.perf, stop_after=stop_after)
