"""The campaign step, its interval and until-CI steps, and the run-until-CI
loop on one device (port of ``shrewd_tpu/parallel/campaign.py`` for one
card).

``ShardedCampaign`` binds a ``TrialKernel`` and a structure and turns a
batch of per-trial keys into an outcome tally; ``run_until_ci`` draws
batches from the campaign's key tree until the AVF interval is tight enough
(``parallel/stopping.py``).  The routes of ``tally_batch`` are the
reference's:

- ``resolution="device"`` (the default, for ``replay_kernel`` taint and
  hybrid): the budgeted path, ``TrialKernel.run_keys_device``;
- ``resolution="host"``: the fast pass, then unbounded exact resolution of
  every escaped lane (``TrialKernel.resolve_escapes``);
- ``replay_kernel="dense"``: every lane through the dense scan;
- ``chunked=`` (an ``ops.chunked.ChunkedCampaign`` over the same kernel):
  outcomes from the chunked wave driver, the SimPoint-scale route.

The pipelined engines (``parallel/pipeline.py``) drive two multi-batch
steps.  The reference's are jitted programs (a ``lax.scan`` over S batches
plus a ``psum``; a ``lax.while_loop`` that evaluates the stopping rule on
the device); here each is a loop over S batches that accumulates the
tallies on the kernel's device (``TrialKernel.tally_on_device``), and only
``materialize_interval`` / ``materialize_until_ci`` copy them to the host.
The until-CI step evaluates the float32 rule on the device after each
batch and reads one ``done`` flag; it runs no batch past the boundary
where the rule fires.  The batch step itself still syncs inside (the
fast pass's escape compaction), so dispatch returns once the device work
is done and the watchdog's deadline, armed at dispatch, is enforced at
materialization by waiting on a CUDA event.

The campaign runs on the kernel's own device: ``mesh`` must be None.  The
reference's multi-device sharding comes with a later slice.  With
``integrity_check=True`` every device step counts one shard-vs-sum check
(``shard_checks``, which ``stats.json`` reports as the reference does):
on one device the shard-local accumulator is the total, so the check
itself (``integrity.shard_sum_violations``) can never fail and is not
run until the multi-device slice gives a real local accumulator.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.trial import N_STRATA
from shrewd_tpu_torch.parallel import stopping
from shrewd_tpu_torch.resilience import TIERS, DispatchTimeout
from shrewd_tpu_torch.utils import debug, prng

debug.register_flag("CampaignStep", "per-batch campaign steps")

_LATER = "comes with a later slice of the PyTorch port"


class ShardedCampaign:
    """One (kernel, structure) campaign on the kernel's device.

    Honors the kernel's ``replay_kernel`` config: "dense" runs the dense
    protocol; "taint"/"hybrid" take the budgeted device resolution by
    default, or the host-driven exact path with ``resolution="host"``.
    ``stratify=True`` offers ``tally_batch_stratified`` for the
    post-stratified stopping rule.

    ``watchdog`` (``resilience.DeviceWatchdog``, optional): every device
    step runs through ``watchdog.call`` so a wedged step surfaces as
    ``DispatchTimeout`` in bounded time; a timed-out step raises before any
    host counter moves.  ``integrity_check``: see the module docstring."""

    def __init__(self, kernel, mesh, structure: str,
                 resolution: str = "device", stratify: bool = False,
                 watchdog=None, integrity_check: bool = False,
                 chunked=None):
        if mesh is not None:
            raise NotImplementedError(
                f"a device mesh {_LATER} (multi-GPU); pass mesh=None to run "
                f"on the kernel's own device")
        if resolution not in ("device", "host"):
            raise ValueError(f"unknown resolution {resolution!r}")
        if stratify and not hasattr(kernel, "run_keys_stratified"):
            raise ValueError(
                f"{type(kernel).__name__} has no stratified tally path")
        if chunked is not None and chunked.kernel is not kernel:
            raise ValueError("chunked campaign wraps a different kernel")
        if stratify and resolution != "device" and chunked is None:
            # the stratified tally uses the budgeted device resolution; a
            # host-resolution campaign would make summed strata disagree
            # with tally_batch on over-budget batches
            raise ValueError("stratify=True requires resolution='device'")
        self.kernel = kernel
        self.mesh = mesh
        self.structure = structure
        self.resolution = resolution
        self.stratify = stratify
        self.watchdog = watchdog
        self.integrity_check = integrity_check
        self.chunked = chunked
        self.shard_checks = 0        # shard-vs-sum verifications counted
        # deadlines on a device step (the reference counts them as the
        # first symptom of a lost peer in a multi-host mesh)
        self.collective_timeouts = 0
        # device→host copies made by this campaign's steps (a tally with
        # its unresolved count is one copy; the until-CI step adds one per
        # stop-flag read): PerfStats.host_roundtrips_saved reads it
        self.transfers = 0
        self.mode = getattr(getattr(kernel, "cfg", None),
                            "replay_kernel", "dense")

    def _count(self, n_unres, n_trials: int) -> None:
        """The kernel's escape statistics, as the reference's steps keep
        them (dense replay has no escape machinery)."""
        if self.mode != "dense":
            self.kernel.escapes += int(n_unres)
            self.kernel.taint_trials += n_trials

    def _dispatch(self, work):
        """One device step, through the watchdog when configured.  ``work``
        ends with its result on the host, so the deadline covers the
        device work as well as the launch."""
        if self.watchdog is None:
            return work()
        try:
            return self.watchdog.call(work)
        except DispatchTimeout:
            self.collective_timeouts += 1
            raise

    def _guarded_dispatch(self, work, n_batches: int):
        """Deadline-guarded dispatch side of the interval and until-CI
        steps, the per-batch deadline scaled by the batch count."""
        if self.watchdog is not None and self.watchdog.timeout > 0:
            try:
                return self.watchdog.call(
                    work, timeout=self.watchdog.timeout * n_batches)
            except DispatchTimeout:
                self.collective_timeouts += 1
                raise
        return work()

    def _guarded_fetch(self, fetch, handle: "InflightInterval",
                       timeout: float | None):
        """Deadline-enforcing materialization: the deadline armed at
        dispatch is enforced here (default-scaled by the in-flight batch
        count) while the watchdog's thread waits on the step's CUDA
        event and copies the accumulators to the host."""
        if self.watchdog is None:
            return fetch()
        if timeout is None and self.watchdog.timeout > 0:
            timeout = self.watchdog.timeout * handle.n_batches
        try:
            return self.watchdog.call_armed(fetch, handle.armed_at,
                                            timeout=timeout)
        except DispatchTimeout:
            self.collective_timeouts += 1
            raise

    def _device_tally(self, keys: torch.Tensor, stratified: bool):
        """The budgeted (or dense) tally of one batch, copied to the host
        inside the watchdog's deadline: → (tally, n_unresolved), numpy."""
        def work():
            t, nu = self.kernel.tally_on_device(keys, self.structure,
                                                stratified=stratified)
            return _to_host(t, nu)

        tally, n_unres = self._dispatch(work)
        self.transfers += 1
        if self.integrity_check:
            self.shard_checks += 1
        self._count(n_unres, int(keys.shape[0]))
        return tally

    def tally_batch_stratified(self, keys: torch.Tensor) -> torch.Tensor:
        """Keys (B, 2) → (N_STRATA, N_OUTCOMES) int32 tally on the CPU for
        the post-stratified estimator; summing over strata gives
        ``tally_batch`` exactly (same outcomes, same resolution)."""
        if not self.stratify:
            raise ValueError("campaign built without stratify=True")
        if self.chunked is not None:
            return self._tally_chunked(keys, stratified=True)
        return torch.as_tensor(self._device_tally(keys, stratified=True))

    def _tally_chunked(self, keys: torch.Tensor, stratified: bool
                       ) -> torch.Tensor:
        """Chunked-strategy tally: outcomes from the chunked wave driver,
        binned on the host.  Same keys → same outcomes as the dense
        protocol."""
        kernel = self.kernel
        faults = kernel.sample_batch(keys, self.structure)
        out = self.chunked.outcomes_of_faults(faults)
        if not stratified:
            return torch.as_tensor(np.bincount(
                out, minlength=C.N_OUTCOMES).astype(np.int32))
        strata = kernel.strata_of(faults, self.structure).cpu().numpy()
        tally = np.zeros((N_STRATA, C.N_OUTCOMES), np.int32)
        np.add.at(tally, (strata, out), 1)
        return torch.as_tensor(tally)

    def tally_batch(self, keys: torch.Tensor) -> torch.Tensor:
        """Keys (B, 2) → int32 tally (N_OUTCOMES,) on the CPU."""
        kernel, structure = self.kernel, self.structure
        if self.chunked is not None:
            return self._tally_chunked(keys, stratified=False)
        if self.mode == "dense" or self.resolution == "device":
            return torch.as_tensor(self._device_tally(keys,
                                                      stratified=False))

        def work():
            faults = kernel.sample_batch(keys, structure)
            res = kernel.taint_fast(faults, may_latch=structure == "latch")
            return (faults, res.outcome.cpu().numpy().copy(),
                    res.escaped.cpu().numpy(), res.overflow.cpu().numpy())

        faults, out, esc, ovf = self._dispatch(work)
        if self.mode == "taint":        # conservative, no re-runs
            out[esc | ovf] = C.OUTCOME_SDC
            self._count((esc | ovf).sum(), out.size)
        elif (esc | ovf).any():
            out = kernel.resolve_escapes(faults, out, esc, ovf)
        else:
            # zero-escape batches still count toward the escape-rate stats
            kernel.taint_trials += out.size
        return torch.as_tensor(
            np.bincount(out, minlength=C.N_OUTCOMES).astype(np.int32))

    # --- sync-interval machinery (pipelined engine, parallel/pipeline.py)

    @property
    def supports_intervals(self) -> bool:
        """Whether the multi-batch steps apply: the host-resolution taint
        path does per-batch host re-runs (nothing to accumulate on the
        device) and the chunked strategy is host-orchestrated."""
        return self.chunked is None and (self.mode == "dense"
                                         or self.resolution == "device")

    def _arm(self) -> float:
        return (self.watchdog.arm() if self.watchdog is not None
                else time.monotonic())

    def _event(self):
        """A CUDA event recorded after the step's last launch (None on the
        CPU, where the work is done when the step returns)."""
        if self.kernel.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _fetch(self, handle: "InflightInterval"):
        """Wait for the step's device work and copy its outputs to the
        host (runs inside the watchdog's thread when one is set): the
        accumulator with its unresolved count in one copy, and the
        until-CI step's half-width buffer in a second."""
        if handle.event is not None:
            handle.event.synchronize()
        acc, nu, *rest = handle.out
        acc, nu = _to_host(acc, nu)
        self.transfers += 1
        if rest:
            consumed, hw_buf = rest
            self.transfers += 1
            return acc, nu, consumed, hw_buf.cpu().numpy()
        return acc, nu

    def dispatch_interval(self, keys_list) -> "InflightInterval":
        """One sync interval (len(keys_list) batches): each batch's tally
        is added to accumulators on the kernel's device, and nothing comes
        back to the host until ``materialize_interval``.  Integer
        per-batch tallies commute, so the result is bit-identical to S
        serial ``tally_batch`` calls summed on the host.  The watchdog
        deadline is armed now and enforced at materialization."""
        if not self.supports_intervals:
            raise ValueError(f"{self.structure}: campaign does not support "
                             "sync-interval accumulation")
        S = len(keys_list)
        B = int(keys_list[0].shape[0])
        armed_at = self._arm()

        def dispatch_work():
            acc = nu = None
            for keys in keys_list:
                t, n = self.kernel.tally_on_device(
                    keys, self.structure, stratified=self.stratify)
                acc = t if acc is None else acc + t
                nu = n if nu is None else nu + n
            return (acc, nu), self._event()

        out, event = self._guarded_dispatch(dispatch_work, S)
        return InflightInterval(out, armed_at, S, S * B, event)

    def materialize_interval(self, handle: "InflightInterval",
                             timeout: float | None = None):
        """Block for / copy one interval to the host — ONE transfer per
        sync interval.  Enforces the deadline armed at dispatch, counts
        a shard-vs-sum check on the interval accumulator, and
        updates the kernel's escape counters exactly as the serial
        per-batch loop would.  → (tally int64 (N_OUTCOMES,),
        strata int64 | None)."""
        acc, n_unres = self._guarded_fetch(lambda: self._fetch(handle),
                                           handle, timeout)
        if self.integrity_check:
            self.shard_checks += 1
        strata = None
        if self.stratify:
            strata = np.asarray(acc, dtype=np.int64)
            tally = strata.sum(axis=0)
        else:
            tally = np.asarray(acc, dtype=np.int64)
        self._count(int(n_unres), handle.n_trials)
        return tally, strata

    def tally_interval(self, keys_list):
        """Blocking convenience: dispatch + materialize one interval."""
        return self.materialize_interval(self.dispatch_interval(keys_list))

    # --- run-until-CI with the stopping rule on the device ---------------

    def dispatch_until_ci(self, keys_list, initial_tallies,
                          initial_strata, trials0: int, min_trials: int,
                          target_halfwidth: float, confidence: float,
                          strat_rule: bool) -> "InflightInterval":
        """One until-CI super-interval (budget = len(keys_list) batches):
        after each batch the float32 Wilson (pooled) or post-stratified
        half-width of the cumulative tally is evaluated on the device and
        one ``done`` flag is read; the loop ends at the first batch
        boundary where the rule fires, or when the budget runs out.  The
        half-width buffer holds one entry per consumed batch and NaN past
        the boundary."""
        if not self.supports_intervals:
            raise ValueError(f"{self.structure}: campaign does not support "
                             "device-resident until-CI accumulation")
        if strat_rule and not self.stratify:
            raise ValueError("stratified stopping rule needs a stratified "
                             "campaign")
        S = len(keys_list)
        B = int(keys_list[0].shape[0])
        armed_at = self._arm()
        dev = self.kernel.device

        def dispatch_work():
            tal0 = torch.as_tensor(np.asarray(initial_tallies, np.int64),
                                   dtype=torch.int32, device=dev)
            if self.stratify:
                s0 = (np.zeros((N_STRATA, C.N_OUTCOMES), np.int64)
                      if initial_strata is None
                      else np.asarray(initial_strata))
                strat0 = torch.as_tensor(s0, dtype=torch.int32, device=dev)
            z = torch.tensor(stopping.z_value(float(confidence)),
                             dtype=torch.float32, device=dev)
            target = torch.tensor(float(target_halfwidth),
                                  dtype=torch.float32, device=dev)
            hw_buf = torch.full((S,), float("nan"), dtype=torch.float32,
                                device=dev)
            acc = nu = None
            consumed = 0
            for i, keys in enumerate(keys_list):
                t, n = self.kernel.tally_on_device(
                    keys, self.structure, stratified=self.stratify)
                acc = t if acc is None else acc + t
                nu = n if nu is None else nu + n
                consumed = i + 1
                trials = int(trials0) + consumed * B
                if strat_rule:
                    hw = stopping.post_stratified_halfwidth_device(
                        strat0 + acc, z)
                else:
                    cum = tal0 + (acc.sum(dim=0) if self.stratify else acc)
                    hw = stopping.wilson_halfwidth_device(
                        cum[C.OUTCOME_SDC] + cum[C.OUTCOME_DUE],
                        torch.tensor(trials, dtype=torch.int32,
                                     device=dev), z)
                hw_buf[i] = hw
                if trials >= int(min_trials):
                    self.transfers += 1          # the stop flag
                    if bool(hw <= target):
                        break
            return (acc, nu, consumed, hw_buf), self._event()

        out, event = self._guarded_dispatch(dispatch_work, S)
        return InflightInterval(out, armed_at, S, S * B, event)

    def materialize_until_ci(self, handle: "InflightInterval",
                             timeout: float | None = None):
        """Block for / copy one until-CI super-interval — ONE transfer
        however many batches were consumed.  → (tally_delta int64
        (N_OUTCOMES,), strata_delta int64 | None, batches_consumed int,
        hw_trace float32 (consumed,)).  Escape counters update from the
        consumed batch count, and a shard-vs-sum check is counted on the
        accumulator exactly like the interval path."""
        acc, n_unres, consumed, hw_buf = self._guarded_fetch(
            lambda: self._fetch(handle), handle, timeout)
        consumed = int(consumed)
        strata = None
        if self.stratify:
            strata = np.asarray(acc, dtype=np.int64)
            tally = strata.sum(axis=0)
        else:
            tally = np.asarray(acc, dtype=np.int64)
        if self.integrity_check:
            self.shard_checks += 1
        B = handle.n_trials // max(handle.n_batches, 1)
        self._count(int(n_unres), consumed * B)
        return tally, strata, consumed, np.asarray(hw_buf)[:consumed]


def _to_host(tally: torch.Tensor, n_unres: torch.Tensor):
    """One device→host copy of a tally and its unresolved count →
    (int32 numpy tally of the same shape, int)."""
    flat = torch.cat([tally.reshape(-1).to(torch.int32),
                      n_unres.reshape(1).to(torch.int32)]).cpu().numpy()
    return flat[:-1].reshape(tuple(tally.shape)), int(flat[-1])


class InflightInterval(NamedTuple):
    """A dispatched sync interval: its accumulators, still on the device,
    the watchdog arm time, the interval's shape, and the CUDA event
    recorded after its last launch (None on the CPU)."""
    out: tuple               # device tensors (and host scalars)
    armed_at: float          # watchdog deadline epoch (resilience.arm)
    n_batches: int
    n_trials: int
    event: object = None


class CampaignResult(NamedTuple):
    structure: str
    tallies: np.ndarray          # (N_OUTCOMES,)
    trials: int
    batches: int
    avf: float
    avf_interval: stopping.Interval
    sdc_interval: stopping.Interval
    wall_seconds: float
    trials_per_second: float
    converged: bool
    strata_tallies: np.ndarray | None = None   # (N_STRATA, N_OUTCOMES)
    tier_trials: np.ndarray | None = None      # per-tier count (dispatcher)
    escalation_rate: float = 0.0               # fraction run below device


def run_until_ci(campaign: ShardedCampaign, *, seed: int, simpoint_id: int,
                 structure_id: int, batch_size: int = 4096,
                 target_halfwidth: float = 0.01, confidence: float = 0.95,
                 max_trials: int = 1_000_000, min_trials: int = 1000,
                 start_batch: int = 0,
                 initial_tallies: np.ndarray | None = None,
                 initial_strata: np.ndarray | None = None,
                 dispatcher=None) -> CampaignResult:
    """Accumulate batches until the AVF CI is tight enough.
    ``start_batch``/``initial_tallies`` (and, for a stratified campaign,
    ``initial_strata``) resume a checkpointed campaign without replaying
    old batches.  A stratified run resumed WITHOUT its strata falls back to
    the pooled Wilson interval over everything it has, so the reported
    interval always covers every counted trial.  Keys are derived on the
    campaign kernel's device.

    ``dispatcher`` (``resilience.ResilientDispatcher``, optional): route
    every batch through the retry/degradation ladder; the result then
    carries per-tier trial counts and the escalation rate."""
    device = campaign.kernel.device
    sk = prng.structure_key(
        prng.simpoint_key(prng.campaign_key(seed, device), simpoint_id),
        structure_id)
    stratified = campaign.stratify
    tallies = (np.zeros(C.N_OUTCOMES, dtype=np.int64)
               if initial_tallies is None
               else np.asarray(initial_tallies, dtype=np.int64).copy())
    strata = None
    if stratified:
        strata = (np.zeros((N_STRATA, C.N_OUTCOMES), dtype=np.int64)
                  if initial_strata is None
                  else np.asarray(initial_strata, dtype=np.int64).copy())
    trials = int(tallies.sum())
    batch_id = start_batch
    t0 = time.monotonic()
    converged = False
    tier_trials = np.zeros(len(TIERS), dtype=np.int64)
    while trials < max_trials:
        keys = prng.trial_keys(prng.batch_key(sk, batch_id), batch_size)
        if dispatcher is not None:
            res = dispatcher.tally_batch(keys, stratified=stratified)
            tier_trials[res.tier] += batch_size
            if stratified:
                strata += res.strata
            t = res.tally
        elif stratified:
            th = campaign.tally_batch_stratified(keys).numpy().astype(
                np.int64)
            strata += th
            t = th.sum(axis=0)
        else:
            t = campaign.tally_batch(keys).numpy().astype(np.int64)
        tallies += t
        trials += batch_size
        batch_id += 1
        vulnerable = int(tallies[C.OUTCOME_SDC] + tallies[C.OUTCOME_DUE])
        # strata cover every counted trial only when the whole history ran
        # stratified (fresh run, or resume that passed initial_strata)
        if stratified and stopping.strata_cover_trials(strata, trials):
            if stopping.should_stop_stratified(
                    stopping.pairs_from_strata(strata), target_halfwidth,
                    confidence, min_trials):
                converged = True
                break
        elif stopping.should_stop(vulnerable, trials, target_halfwidth,
                                  confidence, min_trials):
            converged = True
            break
    wall = time.monotonic() - t0
    vulnerable = int(tallies[C.OUTCOME_SDC] + tallies[C.OUTCOME_DUE])
    done = trials - int(0 if initial_tallies is None
                        else np.asarray(initial_tallies).sum())
    return CampaignResult(
        structure=campaign.structure,
        tallies=tallies,
        trials=trials,
        batches=batch_id - start_batch,
        avf=vulnerable / max(trials, 1),
        avf_interval=(stopping.post_stratified(
            stopping.pairs_from_strata(strata), confidence)
            if stratified and stopping.strata_cover_trials(strata, trials)
            else stopping.wilson(vulnerable, trials, confidence)),
        sdc_interval=stopping.wilson(
            int(tallies[C.OUTCOME_SDC]), trials, confidence),
        wall_seconds=wall,
        trials_per_second=done / wall if wall > 0 else float("inf"),
        converged=converged,
        strata_tallies=strata,
        tier_trials=tier_trials if dispatcher is not None else None,
        escalation_rate=(
            float(tier_trials[1:].sum() / max(tier_trials.sum(), 1))
            if dispatcher is not None else 0.0),
    )
