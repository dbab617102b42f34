"""Backend resilience: watchdog, retry/backoff, degradation ladder, budget
(the port of ``shrewd_tpu/resilience.py``).

A campaign must (a) notice a wedged dispatch in bounded time, (b) retry it
when the backend heals, and (c) finish on a lower tier while accounting for
the substitution.  This module is that layer.  It mirrors the reference's
stance: the
CheckerCPU (``src/cpu/checker/cpu.hh``) is an *always-available oracle*, but
the reference never silently swaps it in for the timing CPU — every tier
substitution here is counted, reported, and budgeted.

Four pieces, composable and individually testable:

- ``DeviceWatchdog`` — bounded-time dispatch.  A device call runs on a
  dedicated dispatch thread; if it does not complete within the timeout
  the watchdog abandons that thread (a wedge in C cannot be interrupted,
  only orphaned; CUDA work cannot be cancelled) and raises
  ``DispatchTimeout``.
- ``BackoffPolicy`` — exponential backoff with jitter for re-dispatch.
  Host-side only: backoff timing never influences sampled faults.
- ``ReprobeQueue`` — a long-running background re-probe loop.  Deferred
  work is enqueued and fires at the *first
  healthy window* instead of a fixed retry schedule.
- ``EscalationBudget`` + ``ResilientDispatcher`` — the degradation ladder
  device → host oracle (the serial C++ golden kernel).  Every batch
  re-dispatched down the ladder reuses the *same frozen PRNG keys*, so
  tallies are bit-identical regardless of where they ran (every tier
  consumes ``keys`` and nothing else); the budget makes the device/host
  mix a first-class campaign stat with a configurable threshold.

Every descent shows: in the batch document's ``tier``, the orchestrator's
``BackendDegraded`` probe and ``resilience.tier_trials``.

A campaign on the card has the device tier alone, and a failure of it
(a kernel that fails to build or launch, a lost device) raises out of the
dispatch: the port never moves a card campaign to the CPU or the host
oracle, where a broken kernel would end as a warning.  The reference's
CPU tier re-runs a campaign on the host's device; a CPU campaign skips it
(the same device cannot help), so the port has none, and ``allow_cpu``
is kept for the plan's JSON only.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np

from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.utils import debug
from shrewd_tpu_torch.utils.config import ConfigObject, Param

debug.register_flag("Resilience", "watchdog / retry / degradation ladder")

# The degradation ladder, healthiest first.  Index into per-tier tallies —
# NEVER reorder (checkpoints and stats record tier indices).
TIERS = ("device", "cpu", "oracle")
TIER_DEVICE, TIER_CPU, TIER_ORACLE = range(3)


class BackendError(RuntimeError):
    """A dispatch failed in a way worth retrying or degrading over."""


class DispatchTimeout(BackendError):
    """The watchdog declared an in-flight dispatch wedged."""


class LadderExhausted(BackendError):
    """Every tier of the degradation ladder failed for one batch."""


class ResilienceConfig(ConfigObject):
    """Knobs for the resilience layer (a ``CampaignPlan`` child, so every
    campaign's failure posture is reproducible from its config dump)."""

    dispatch_timeout = Param(float, 0.0,
                             "seconds per device dispatch before the "
                             "watchdog declares it wedged (0 = no watchdog; "
                             "first-compile on a real chip needs minutes)")
    max_retries = Param(int, 2,
                        "re-dispatch attempts per tier before degrading",
                        check=lambda v: v >= 0)
    backoff_base = Param(float, 0.05, "first-retry backoff seconds",
                         check=lambda v: v >= 0)
    backoff_max = Param(float, 5.0, "backoff ceiling seconds")
    backoff_jitter = Param(float, 0.25,
                           "uniform jitter fraction on each backoff delay",
                           check=lambda v: 0 <= v <= 1)
    escalation_threshold = Param(float, 0.05,
                                 "max fraction of trials allowed off the "
                                 "device tier before the run is flagged",
                                 check=lambda v: 0 <= v <= 1)
    escalation_action = Param(str, "warn",
                              "off | warn | abort when the escalation rate "
                              "exceeds the threshold",
                              check=lambda v: v in ("off", "warn", "abort"))
    probe_interval = Param(float, 30.0,
                           "background re-probe cadence seconds",
                           check=lambda v: v > 0)
    allow_cpu = Param(bool, True, "permit the CPU fallback tier (the "
                      "port has none: kept for the plan's JSON)")
    allow_oracle = Param(bool, True,
                         "permit the host-oracle fallback tier")


class BackoffPolicy:
    """Exponential backoff with uniform jitter (the classic retry shape;
    the reference has no analog because a wedged EventQueue just deadlocks).

    ``delay(attempt)`` is pure given the instance's RNG stream; ``sleep``
    goes through an injectable sleeper so tests never wall-wait."""

    def __init__(self, base: float = 0.05, cap: float = 5.0,
                 jitter: float = 0.25, seed: int | None = None,
                 sleeper: Callable[[float], None] = time.sleep):
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleeper

    @classmethod
    def from_config(cls, cfg: ResilienceConfig,
                    sleeper: Callable[[float], None] = time.sleep
                    ) -> "BackoffPolicy":
        return cls(cfg.backoff_base, cfg.backoff_max, cfg.backoff_jitter,
                   sleeper=sleeper)

    def delay(self, attempt: int) -> float:
        d = min(self.base * (2 ** max(attempt, 0)), self.cap)
        if self.jitter:
            d *= 1 + self._rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d:
            self._sleep(d)
        return d


class DeviceWatchdog:
    """Run dispatches with a hard completion deadline.

    A wedged device call blocks inside C code where no Python exception
    can reach it, so the watchdog's only safe move on timeout is to
    *abandon* the dispatch thread (daemon; it dies with the process) and
    surface ``DispatchTimeout`` to the caller.  ``timeout=0``
    disables the thread hop entirely (zero overhead on the hot path)."""

    #: abandoned-thread count past which the watchdog warns: each wedged
    #: dispatch orphans one daemon thread (plus whatever C-level state it
    #: pins), so unbounded accumulation is a slow leak worth surfacing
    leak_warn_cap = 8

    def __init__(self, timeout: float = 0.0, name: str = "device"):
        self.timeout = float(timeout)
        self.name = name
        self.healthy = True
        self.dispatches = 0
        self.timeouts = 0
        self._abandoned: list[threading.Thread] = []
        self._leak_warned = False
        self.chaos = None            # optional chaos.ChaosEngine (wedge hook)

    @property
    def leaked_threads(self) -> int:
        """Abandoned dispatch threads still alive (a wedged thread that
        eventually finishes drops off; one that never does is a leak)."""
        self._abandoned = [t for t in self._abandoned if t.is_alive()]
        return len(self._abandoned)

    def call(self, fn: Callable, *args, timeout: float | None = None):
        """``fn(*args)`` bounded by ``timeout`` (default: the instance's).

        Raises ``DispatchTimeout`` on deadline; any exception from ``fn``
        propagates unchanged (the retry loop decides what is retryable)."""
        tmo = self.timeout if timeout is None else float(timeout)
        self.dispatches += 1
        if self.chaos is not None and tmo > 0:
            # chaos wedge hook (only on deadline-bearing dispatches — the
            # ladder also routes fallback tiers through here with tmo=0,
            # which must neither consume nor misreport the wedge):
            # substitute a dispatch that sleeps past the deadline, so the
            # injected fault exercises the REAL timeout machinery (thread
            # hop, abandonment, DispatchTimeout) rather than a synthetic
            # raise.  The injected call runs under the spec's own short
            # deadline so the campaign's real deadline can stay generous
            # enough for a first kernel build.
            wedged = self.chaos.take_wedge(tmo)
            if wedged is not None:
                fn, args, tmo = wedged["fn"], (), wedged["deadline"]
        if tmo <= 0:
            return fn(*args)
        # a plain daemon thread, NOT ThreadPoolExecutor: pool workers are
        # non-daemon and concurrent.futures' atexit hook joins them, so a
        # wedged dispatch would block interpreter exit forever
        box: dict = {}
        done = threading.Event()

        def _runner():
            try:
                box["out"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised in caller
                box["err"] = e
            finally:
                done.set()

        th = threading.Thread(
            target=_runner, daemon=True,
            name=f"watchdog-{self.name}-{self.dispatches}")
        th.start()
        if not done.wait(tmo):
            self.timeouts += 1
            self.healthy = False
            obs_trace.tracer().emit(
                "watchdog_fire", cat="resilience", watchdog=self.name,
                timeout_s=round(tmo, 3), dispatch=self.dispatches)
            # the dispatch thread is stuck in C; abandon it (daemon — it
            # dies with the process) and let the caller's ladder decide.
            # Track the orphan: repeated wedges accumulate threads (and
            # whatever backend state they pin), which is a leak worth a
            # stat and, past the cap, a warning.
            self._abandoned.append(th)
            leaked = self.leaked_threads
            if leaked > self.leak_warn_cap and not self._leak_warned:
                self._leak_warned = True
                warnings.warn(
                    f"DeviceWatchdog {self.name}: {leaked} abandoned "
                    f"dispatch threads still alive (cap "
                    f"{self.leak_warn_cap}) — the backend is wedging "
                    "repeatedly; each orphan pins backend state until it "
                    "finishes or the process exits", RuntimeWarning,
                    stacklevel=2)
            debug.dprintf("Resilience",
                          "watchdog %s: dispatch wedged after %.1fs "
                          "(%d threads leaked)", self.name, tmo, leaked)
            raise DispatchTimeout(
                f"{self.name}: dispatch exceeded {tmo:.1f}s") from None
        if "err" in box:
            raise box["err"]
        self.healthy = True
        return box["out"]

    # --- future-based mode (pipelined async dispatch) -------------------
    #
    # The serial loop wraps a step that ends with its tally on the host in
    # `call`, so the deadline covers dispatch AND completion of one batch.
    # The pipelined engine copies its accumulators to the host only at
    # materialization, after waiting on the step's CUDA event — so the
    # deadline must be armed at dispatch time and enforced at
    # materialization, or a wedged backend would hide inside the
    # never-awaited in-flight window.

    def arm(self) -> float:
        """Future mode, dispatch side: stamp the moment a dispatch was
        enqueued.  Pass the token to ``call_armed`` at materialization."""
        obs_trace.tracer().emit("watchdog_arm", cat="resilience",
                                watchdog=self.name,
                                dispatch=self.dispatches)
        return obs_clock.monotonic()

    #: minimum materialization grace even when the armed deadline has
    #: fully elapsed while the host did other work: an already-complete
    #: result returns instantly, and a genuinely wedged one still
    #: surfaces as DispatchTimeout in bounded (small) time
    armed_floor = 0.05

    def call_armed(self, fn: Callable, armed_at: float,
                   timeout: float | None = None):
        """Future mode, materialization side: run ``fn()`` (the blocking
        device_get / block_until_ready) under the REMAINING deadline,
        measured from ``armed_at`` — the wedge-detection guarantee of the
        serial loop, preserved without per-batch blocking."""
        tmo = self.timeout if timeout is None else float(timeout)
        if tmo <= 0:
            return self.call(fn, timeout=0.0)
        remaining = tmo - (obs_clock.monotonic() - armed_at)
        return self.call(fn, timeout=max(remaining, self.armed_floor))

    def probe(self, fn: Callable, timeout: float | None = None) -> bool:
        """Health probe: True iff ``fn()`` completes in time without
        raising.  Updates ``healthy``."""
        try:
            self.call(fn, timeout=timeout)
            return True
        except Exception:  # noqa: BLE001 — any failure means unhealthy
            self.healthy = False
            return False


class ReprobeQueue:
    """Long-running background re-probe with deferred work.

    Callers enqueue callbacks with ``defer``; a daemon thread probes the
    backend on a backoff schedule and fires every queued callback at the
    FIRST healthy window instead of on a fixed retry schedule.  Deferred
    callbacks run on the probe thread; keep them short or have them hand
    off."""

    def __init__(self, probe_fn: Callable[[], bool],
                 interval: float = 30.0,
                 backoff: BackoffPolicy | None = None):
        self._probe = probe_fn
        self._interval = float(interval)
        self._backoff = backoff
        self._deferred: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._healthy = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.probes = 0

    @property
    def healthy(self) -> bool:
        return self._healthy.is_set()

    def start(self) -> "ReprobeQueue":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="reprobe-queue", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        attempt = 0
        while not self._stop.is_set():
            self.probes += 1
            ok = False
            try:
                ok = bool(self._probe())
            except Exception:  # noqa: BLE001 — probe failure = unhealthy
                ok = False
            if ok:
                self._healthy.set()
                self._fire()
                return
            wait = (self._backoff.delay(attempt) if self._backoff
                    else self._interval)
            attempt += 1
            self._stop.wait(wait)

    def _fire(self) -> None:
        with self._lock:
            work, self._deferred = self._deferred, []
        for fn in work:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — one callback must not
                # starve the rest of the queue
                debug.dprintf("Resilience", "deferred callback failed: %s",
                              e)

    def defer(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` at the first healthy window (immediately if already
        healthy)."""
        if self._healthy.is_set():
            fn()
            return
        with self._lock:
            self._deferred.append(fn)
        # a late defer after the probe thread exited healthy still fires
        if self._healthy.is_set():
            self._fire()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until healthy (or timeout); True iff healthy."""
        return self._healthy.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class EscalationBudget:
    """Per-tier trial accounting — the 'is this number really a device
    number' ledger: a run that escalates trials below the device tier
    past the threshold is flagged."""

    def __init__(self, counts=None):
        self.counts = (np.zeros(len(TIERS), dtype=np.int64)
                       if counts is None
                       else np.asarray(counts, dtype=np.int64).copy())
        if self.counts.shape != (len(TIERS),):
            raise ValueError(f"need {len(TIERS)} tier counters, "
                             f"got shape {self.counts.shape}")

    def record(self, tier: int, n_trials: int) -> None:
        self.counts[tier] += int(n_trials)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    @property
    def escalated(self) -> int:
        """Trials that did NOT run on the device tier."""
        return int(self.counts[1:].sum())

    def rate(self) -> float:
        return self.escalated / max(self.total, 1)

    def over(self, threshold: float) -> bool:
        return self.total > 0 and self.rate() > threshold

    def to_dict(self) -> dict:
        return {"tier_trials": {t: int(c) for t, c in zip(TIERS, self.counts)},
                "escalation_rate": self.rate()}

    @classmethod
    def from_states(cls, tier_arrays) -> "EscalationBudget":
        b = cls()
        for a in tier_arrays:
            b.counts += np.asarray(a, dtype=np.int64)
        return b


class DispatchResult(NamedTuple):
    tally: np.ndarray                 # (N_OUTCOMES,) int64
    strata: np.ndarray | None         # (N_STRATA, N_OUTCOMES) or None
    tier: int                         # TIERS index that produced the tally
    attempts: int                     # total dispatch attempts consumed


class ResilientDispatcher:
    """Retry + degradation ladder around one campaign's batch dispatch.

    ``tiers`` is an ordered list of ``(tier_index, fn)`` where
    ``fn(keys, stratified) -> (tally, strata|None)``; every fn consumes the
    same frozen PRNG keys, which is the whole bit-identity argument — a
    batch's outcomes are a pure function of its keys on every tier (the
    parity contract tests/test_native_diff.py and tests/test_chunked.py
    pin).  Tier order is descent order; a tier whose retries exhaust marks
    the watchdog unhealthy and falls through to the next."""

    def __init__(self, tiers, config: ResilienceConfig | None = None,
                 watchdog: DeviceWatchdog | None = None,
                 backoff: BackoffPolicy | None = None,
                 device_deadline: bool = True, chaos=None):
        """``device_deadline=False`` when the campaign enforces its own
        per-step deadline (ShardedCampaign built with a watchdog): the
        dispatcher then calls the device tier directly instead of adding a
        second thread hop + timer around the same work.

        ``chaos`` (chaos.ChaosEngine, optional): the deterministic
        fault-injection harness — armed per-tier ``BackendError`` faults
        fire here, exercising the retry/degradation machinery exactly as a
        real backend failure would."""
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers = list(tiers)
        self.cfg = config if config is not None else ResilienceConfig()
        self.watchdog = (watchdog if watchdog is not None
                         else DeviceWatchdog(self.cfg.dispatch_timeout))
        self.backoff = (backoff if backoff is not None
                        else BackoffPolicy.from_config(self.cfg))
        self.device_deadline = device_deadline
        self.chaos = chaos
        self.retries = 0          # re-dispatches beyond each first attempt
        self.degradations = 0     # tier descents taken

    def sub_ladder(self, below: int) -> "ResilientDispatcher | None":
        """The ladder restricted to tiers strictly below ``below`` (in
        descent order), or None when nothing is left.  Used by the
        integrity layer to re-dispatch a quarantined batch on a tier other
        than the one that produced the corrupt result; watchdog/config/
        backoff are shared so health accounting stays campaign-wide."""
        pos = next((i for i, (t, _) in enumerate(self.tiers) if t == below),
                   None)
        if pos is None or pos + 1 >= len(self.tiers):
            return None
        return ResilientDispatcher(
            self.tiers[pos + 1:], self.cfg, watchdog=self.watchdog,
            backoff=self.backoff, device_deadline=self.device_deadline,
            chaos=self.chaos)

    def tally_batch(self, keys, stratified: bool = False) -> DispatchResult:
        attempts = 0
        errors: list[str] = []
        for pos, (tier, fn) in enumerate(self.tiers):
            # only the device tier goes through the watchdog deadline (and
            # only when the campaign isn't already enforcing its own): the
            # fallbacks are host-owned work that must be allowed to finish
            tmo = (self.cfg.dispatch_timeout
                   if tier == TIER_DEVICE and self.device_deadline else 0.0)
            for attempt in range(self.cfg.max_retries + 1):
                attempts += 1
                if attempt:
                    self.retries += 1
                    self.backoff.sleep(attempt - 1)
                try:
                    if self.chaos is not None:
                        # chaos ladder hook: an armed per-tier fault raises
                        # here, consuming one attempt like a real failure
                        self.chaos.maybe_backend_error(tier)
                    tally, strata = self.watchdog.call(
                        fn, keys, stratified, timeout=tmo)
                    return DispatchResult(
                        np.asarray(tally, dtype=np.int64),
                        None if strata is None
                        else np.asarray(strata, dtype=np.int64),
                        tier, attempts)
                except BackendError as e:
                    errors.append(f"{TIERS[tier]}: {e}")
                    debug.dprintf(
                        "Resilience", "%s dispatch failed "
                        "(attempt %d/%d): %s", TIERS[tier], attempt + 1,
                        self.cfg.max_retries + 1, e)
            if pos + 1 < len(self.tiers):
                self.degradations += 1
                debug.dprintf("Resilience", "degrading %s -> %s",
                              TIERS[tier], TIERS[self.tiers[pos + 1][0]])
        raise LadderExhausted("; ".join(errors)[-500:])


# --------------------------------------------------------------------------
# ladder construction for a ShardedCampaign (campaign modules imported
# lazily)
# --------------------------------------------------------------------------

def _device_tier(campaign):
    """The campaign's own step.  On the CPU any exception becomes a
    ``BackendError`` so the ladder descends; on the card it propagates."""
    on_card = campaign.kernel.device.type == "cuda"

    from shrewd_tpu_torch.parallel.exec_cache import AdmissionError

    def fn(keys, stratified):
        try:
            if stratified:
                strata = np.asarray(campaign.tally_batch_stratified(keys))
                return strata.sum(axis=0), strata
            return np.asarray(campaign.tally_batch(keys)), None
        except (BackendError, AdmissionError):
            # a certification refusal is a verdict on the step: the
            # ladder must not descend past it
            raise
        except Exception as e:  # noqa: BLE001 — a crashing backend (out
            # of memory, a failing host step) is the other common failure
            # mode besides the wedge; without this wrap the ladder would
            # only ever engage on timeouts
            if on_card:
                raise
            raise BackendError(f"device tier failed: {e}") from e
    return fn


def _oracle_tier(campaign):
    """Host-oracle re-dispatch: the serial C++ golden kernel (the
    CheckerCPU analog, ``csrc/``, through the port's ``native``)
    classifies the SAME sampled faults.  Valid for TrialKernel campaigns
    without a VA-space memmap; ``oracle_available`` gates construction."""
    def fn(keys, stratified):
        try:
            from shrewd_tpu_torch import native
            from shrewd_tpu_torch.ops import classify as C
            kernel = campaign.kernel
            faults = kernel.sampler(campaign.structure).sample_batch(
                keys.to(kernel.device))
            f = [x.cpu().numpy() for x in faults]
            out = native.golden_trials(
                kernel.trace, *f, kernel.shadow_cov.cpu().numpy(),
                compare_regs=kernel.cfg.compare_regs)
            tally = np.bincount(out, minlength=C.N_OUTCOMES
                                ).astype(np.int64)
            if not stratified:
                return tally, None
            from shrewd_tpu_torch.ops.trial import N_STRATA
            strata_id = kernel.strata_of(
                faults, campaign.structure).cpu().numpy()
            strata = np.zeros((N_STRATA, C.N_OUTCOMES), np.int64)
            np.add.at(strata, (strata_id, out), 1)
            return tally, strata
        except BackendError:
            raise
        except Exception as e:  # noqa: BLE001
            raise BackendError(f"oracle tier failed: {e}") from e
    return fn


def oracle_available(campaign) -> bool:
    """The native golden kernel covers TrialKernel structures only, and
    not the VA-space memmap path (lifted traces trap differently there)."""
    kernel = campaign.kernel
    return (hasattr(kernel, "trace") and hasattr(kernel, "shadow_cov")
            and hasattr(kernel, "sampler")
            and getattr(kernel, "memmap", None) is None)


def dispatcher_for_campaign(campaign, cfg: ResilienceConfig | None = None,
                            watchdog: DeviceWatchdog | None = None,
                            chaos=None) -> ResilientDispatcher:
    """Build the ladder for one ShardedCampaign: the device tier, then,
    for a CPU campaign, the host oracle where valid.  A campaign on the
    card gets the device tier alone (module docstring)."""
    cfg = cfg if cfg is not None else ResilienceConfig()
    tiers = [(TIER_DEVICE, _device_tier(campaign))]
    if (campaign.kernel.device.type != "cuda" and cfg.allow_oracle
            and oracle_available(campaign)):
        tiers.append((TIER_ORACLE, _oracle_tier(campaign)))
    # a campaign with its own watchdog enforces the per-step deadline
    # inside tally_batch (around only the device step, so a late orphaned
    # dispatch has no host side effects to corrupt) — don't stack a second
    # deadline around the same call
    return ResilientDispatcher(
        tiers, cfg, watchdog=watchdog,
        device_deadline=getattr(campaign, "watchdog", None) is None,
        chaos=chaos)


# --------------------------------------------------------------------------
# crash-safe document IO (checkpoint v4 helpers)
# --------------------------------------------------------------------------

def doc_checksum(doc: dict) -> str:
    """Content checksum over everything EXCEPT the checksum field itself,
    canonical-JSON-serialized (sort_keys) so dict order never matters."""
    body = {k: v for k, v in doc.items() if k != "checksum"}
    blob = json.dumps(body, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: ``os.replace`` makes a rename visible, but the
    new directory entry itself lives in the directory's data blocks — on a
    power loss before the directory syncs, the rename can vanish and the
    file with it.  POSIX durability for a rename is file-fsync + rename +
    directory-fsync; this is the third step."""
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, doc: dict) -> None:
    """tmp + fsync + rename + dir-fsync: a crash mid-write can truncate
    only the tmp file, never the live document, and a power loss after the
    rename cannot drop the renamed entry."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
    notify_durability("rename", path)


# --------------------------------------------------------------------------
# durability-boundary observation (the crashcheck seam)
# --------------------------------------------------------------------------
#
# The crash-point model checker (analysis/crashcheck.py) needs to see
# every instant at which durable state changes — each WAL append, each
# journal compaction, each atomic-rename commit — so it can re-execute
# recovery from the filesystem state at EVERY boundary.  One process-
# wide hook, notified by the durable writers right after their fsync
# lands; None (the default) costs one ``is not None`` check.

_durability_hook = None


def set_durability_hook(fn):
    """Install (``fn``) or clear (``None``) the process-wide durability
    observer; returns the previous hook so shims can nest."""
    global _durability_hook
    prev = _durability_hook
    _durability_hook = fn
    return prev


def notify_durability(event: str, path: str, **meta) -> None:
    """Report one durability boundary (``event`` in append/compact/
    rename) to the installed observer, if any.  Called by the durable
    writers AFTER the bytes are on disk — the boundary is the moment a
    crash could no longer un-happen the write."""
    if _durability_hook is not None:
        _durability_hook(event, path, **meta)


def load_json_verified(path: str) -> dict:
    """Load + checksum-verify a document written by ``write_json_atomic``.
    Raises ``ValueError`` on truncation/corruption/checksum mismatch;
    documents from before checksums (no ``checksum`` field) load as-is."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: truncated or corrupt JSON "
                             f"({e})") from e
    want = doc.get("checksum")
    if want is not None and doc_checksum(doc) != want:
        raise ValueError(f"{path}: checksum mismatch "
                         "(partial write or tampering)")
    return doc
