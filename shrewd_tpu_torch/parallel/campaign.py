"""The sharded campaign step, its interval and until-CI steps, and the
run-until-CI loop (port of ``shrewd_tpu/parallel/campaign.py``).

``ShardedCampaign`` binds a kernel, a device mesh (``parallel/mesh.py``) and
a structure and turns a batch of per-trial keys into an outcome tally;
``run_until_ci`` draws batches from the campaign's key tree until the AVF
interval is tight enough (``parallel/stopping.py``).  Each shard of the
batch runs on its own mesh device, through the kernel's replica there
(``kernel.on_device``).  Shards on distinct devices run in threads of
their own, one per device, so that the host syncs inside one shard's step
(the fast pass's escape compaction, the dense step loop) do not hold the
other cards back; shards that share a device (the CPU listed n times) run
one after another.  The local shards' tallies are summed, and the sum is
reduced across processes with ``all_reduce(SUM)`` (``Mesh.all_reduce``) —
the reference's ``shard_map`` body plus its ``psum``.  The routes of ``tally_batch`` are
the reference's:

- ``resolution="device"`` (the default, for ``replay_kernel`` taint and
  hybrid): the budgeted path, ``TrialKernel.tally_on_device`` per shard.
  The escape budget applies per shard, as in the reference, so a batch
  split over more shards may resolve more lanes;
- ``resolution="host"``: the fast pass per shard, then unbounded exact
  resolution of every escaped lane of this process's rows
  (``TrialKernel.resolve_escapes``);
- ``replay_kernel="dense"`` (and the tier kernels): every lane through the
  kernel's own outcomes, per shard;
- ``chunked=`` (an ``ops.chunked.ChunkedCampaign`` over the same kernel):
  outcomes from the chunked wave loop on each shard's device, the
  SimPoint-scale route (host-orchestrated; its per-trial outcomes are the
  dense protocol's, so the tally does not depend on the sharding).

With ``integrity_check=True`` every device step (the budgeted, dense,
interval and until-CI steps, as in the reference) checks the shard-vs-sum
invariant over the real shards: every process's local tallies are gathered
(``Mesh.all_gather``) and must sum to the reduced tally
(``integrity.shard_sum_violations``); a mismatch counts in
``shard_mismatches`` and raises ``IntegrityError``.

The pipelined engines (``parallel/pipeline.py``) drive two multi-batch
steps.  The reference's are jitted programs (a ``lax.scan`` over S batches
plus a ``psum``; a ``lax.while_loop`` that evaluates the stopping rule on
the device); here each is a loop over S batches that accumulates each
shard's tallies on its device, and only ``materialize_interval`` /
``materialize_until_ci`` copy them to the host.  The until-CI step sums
the shards' batch tallies on the first mesh device, evaluates the float32
rule there after each batch and reads one ``done`` flag; it runs no batch
past the boundary where the rule fires.  Like the reference's, both gate
on a single process.  The batch step itself still syncs inside (the fast
pass's escape compaction), so dispatch returns once the device work is
done and the watchdog's deadline, armed at dispatch, is enforced at
materialization by waiting on a CUDA event.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.trial import N_STRATA
from shrewd_tpu_torch.parallel import stopping
from shrewd_tpu_torch.parallel.mesh import (make_mesh, shard_batch_stack,
                                            shard_keys)
from shrewd_tpu_torch.resilience import TIERS, DispatchTimeout
from shrewd_tpu_torch.utils import debug, prng

debug.register_flag("CampaignStep", "per-batch campaign steps")


def _chunked_on(chunked, kernel):
    """The chunked campaign for ``kernel`` (a shard's replica): the same
    chunking and preprocessed window."""
    if kernel is chunked.kernel:
        return chunked
    from shrewd_tpu_torch.ops.chunked import ChunkedCampaign

    return ChunkedCampaign(kernel, chunk=chunked.S, max_batch=chunked.B,
                           carry_horizon=chunked.carry_horizon,
                           engine=chunked.engine, window=chunked.window)


class ShardedCampaign:
    """One (kernel, structure) campaign over a device mesh.

    Honors the kernel's ``replay_kernel`` config: "dense" runs the dense
    protocol; "taint"/"hybrid" take the budgeted device resolution by
    default, or the host-driven exact path with ``resolution="host"``.
    ``stratify=True`` offers ``tally_batch_stratified`` for the
    post-stratified stopping rule.  ``mesh=None`` is a one-device mesh on
    the kernel's device.

    ``watchdog`` (``resilience.DeviceWatchdog``, optional): every device
    step, its collective included, runs through ``watchdog.call`` so a
    wedged step (or a lost peer) surfaces as ``DispatchTimeout`` in
    bounded time; a timed-out step raises before any host counter moves.
    ``integrity_check``: see the module docstring."""

    def __init__(self, kernel, mesh, structure: str,
                 resolution: str = "device", stratify: bool = False,
                 watchdog=None, integrity_check: bool = False,
                 chunked=None):
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
        self.mesh = mesh if mesh is not None else make_mesh([kernel.device])
        self.structure = structure
        self.resolution = resolution
        self.stratify = stratify
        self.watchdog = watchdog
        self.integrity_check = integrity_check
        self.chunked = chunked
        # each local shard's kernel: the kernel itself on its own device,
        # its cached replica on any other
        self.kernels = [kernel.on_device(d) for d in self.mesh.devices]
        self.chunkeds = (None if chunked is None else
                         [_chunked_on(chunked, k) for k in self.kernels])
        self.shard_checks = 0        # shard-vs-sum verifications run
        self.shard_mismatches = 0    # ... that failed (each also raises)
        # deadlines on a device step: in a multi-process mesh the step is
        # a collective, and a deadline may mean a lost peer
        self.collective_timeouts = 0
        # device→host copies made by this campaign's steps (a shard's
        # tally with its unresolved count is one copy; the until-CI step
        # adds one per stop-flag read): PerfStats.host_roundtrips_saved
        # reads it
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
        device work and the collective as well as the launch."""
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

    def _on_shards(self, fn, items) -> list:
        """``[fn(i, items[i])]`` over the local shards, in shard order: one
        thread per distinct device (each with its card current, its shards
        in order), or this thread alone when every shard shares one
        device."""
        groups: dict = {}
        for i, d in enumerate(self.mesh.devices):
            groups.setdefault(d, []).append(i)
        if len(groups) == 1:
            return [fn(i, x) for i, x in enumerate(items)]
        out = [None] * len(items)

        def run(dev, idx):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                for i in idx:
                    out[i] = fn(i, items[i])

        with ThreadPoolExecutor(len(groups)) as pool:
            for f in [pool.submit(run, d, idx) for d, idx in groups.items()]:
                f.result()
        return out

    # --- the reduction and the shard-vs-sum invariant --------------------

    def _reduce(self, local: np.ndarray, *extra: int, check: bool = True):
        """(local_size, ...) shard tallies of this process → (the tally
        summed over every shard of every process, the ``extra`` counts
        summed the same way, every process's shard tallies stacked on the
        global shard axis or None).  One ``all_reduce`` carries the tally
        and the counts; the gather runs only under ``integrity_check``
        (and ``check``: the host and chunked routes check nothing, as the
        reference's do not)."""
        local = np.asarray(local, dtype=np.int64)
        flat = np.concatenate([local.sum(axis=0).reshape(-1),
                               np.asarray(extra, dtype=np.int64)])
        red = self.mesh.all_reduce(flat)
        n = red.size - len(extra)
        total = red[:n].reshape(local.shape[1:])
        shards = (self._gather_locals(local)
                  if self.integrity_check and check else None)
        return total, [int(x) for x in red[n:]], shards

    def _gather_locals(self, local: np.ndarray) -> np.ndarray:
        """Every process's shard tallies on the global shard axis."""
        return self.mesh.all_gather(local)

    def _verify_shards(self, shards, total) -> None:
        """The shard-vs-sum invariant (integrity layer): the tallies each
        shard computed must sum to the reduced tally every process
        believes — a corrupted collective or a stale buffer cannot
        pass."""
        from shrewd_tpu_torch import integrity as integ

        self.shard_checks += 1
        viol = integ.shard_sum_violations(shards, total)
        if viol:
            self.shard_mismatches += 1
            raise integ.IntegrityError(f"{self.structure}: {viol[0]}")

    def _believe(self, reduced, n_trials: int) -> np.ndarray:
        """A reduced step (``_reduce``'s result): verify the shards when
        asked and count the escapes → the global tally (int32).  Runs
        after the deadline-guarded dispatch, so a timed-out step moves no
        host counter."""
        total, (n_unres,), shards = reduced
        if self.integrity_check:
            self._verify_shards(shards, total)
        self._count(n_unres, n_trials)
        return total.astype(np.int32)

    # --- the per-batch steps ----------------------------------------------

    def _device_tally(self, keys: torch.Tensor, stratified: bool):
        """The budgeted (or dense) tally of one batch, per shard on its
        device, reduced inside the watchdog's deadline → int32 numpy."""
        shards = shard_keys(self.mesh, keys)

        def work():
            host = self._on_shards(
                lambda i, s: _to_host(*self.kernels[i].tally_on_device(
                    s, self.structure, stratified=stratified)), shards)
            return self._reduce(np.stack([t for t, _ in host]),
                                sum(nu for _, nu in host))

        reduced = self._dispatch(work)
        self.transfers += len(shards)
        return self._believe(reduced, int(keys.shape[0]))

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
        """Chunked-strategy tally: per shard, outcomes from the chunked
        wave loop on the shard's device, binned on the host.  Same keys
        → same outcomes as the dense protocol."""
        def shard(i, ks):
            kern = self.kernels[i]
            faults = kern.sample_batch(ks, self.structure)
            out = self.chunkeds[i].outcomes_of_faults(faults)
            if not stratified:
                return np.bincount(out, minlength=C.N_OUTCOMES)
            strata = kern.strata_of(faults, self.structure).cpu().numpy()
            tally = np.zeros((N_STRATA, C.N_OUTCOMES), np.int64)
            np.add.at(tally, (strata, out), 1)
            return tally

        local = self._on_shards(shard, shard_keys(self.mesh, keys))
        total, _, _ = self._reduce(np.stack(local), check=False)
        return torch.as_tensor(total.astype(np.int32))

    def tally_batch(self, keys: torch.Tensor) -> torch.Tensor:
        """Keys (B, 2) → int32 tally (N_OUTCOMES,) on the CPU."""
        if self.chunked is not None:
            return self._tally_chunked(keys, stratified=False)
        if self.mode == "dense" or self.resolution == "device":
            return torch.as_tensor(self._device_tally(keys,
                                                      stratified=False))
        kernel, structure = self.kernel, self.structure
        shards = shard_keys(self.mesh, keys)

        def shard(i, s):
            k = self.kernels[i]
            r = k.taint_fast(k.sample_batch(s, structure),
                             may_latch=structure == "latch")
            return (r.outcome.cpu().numpy(), r.escaped.cpu().numpy(),
                    r.overflow.cpu().numpy())

        def work():
            res = self._on_shards(shard, shards)
            return tuple(np.concatenate(part) for part in zip(*res))

        out, esc, ovf = self._dispatch(work)
        out = out.copy()
        # the escape counters move by the global counts below, not by what
        # this process's resolution counted
        esc0, trials0 = kernel.escapes, kernel.taint_trials
        if self.mode == "taint":        # conservative, no re-runs
            out[esc | ovf] = C.OUTCOME_SDC
            kernel.escapes += int((esc | ovf).sum())
        elif (esc | ovf).any():
            # this process's rows, resolved exactly on the main kernel
            local_keys = torch.cat([s.to(kernel.device) for s in shards])
            faults = kernel.sample_batch(local_keys, structure)
            out = kernel.resolve_escapes(faults, out, esc, ovf)
        tally = np.bincount(out, minlength=C.N_OUTCOMES)[None]
        total, (n_esc,), _ = self._reduce(tally, kernel.escapes - esc0,
                                          check=False)
        kernel.escapes = esc0 + n_esc
        kernel.taint_trials = trials0 + int(keys.shape[0])
        return torch.as_tensor(total.astype(np.int32))

    # --- sync-interval machinery (pipelined engine, parallel/pipeline.py)

    @property
    def supports_intervals(self) -> bool:
        """Whether the multi-batch steps apply: the host-resolution taint
        path does per-batch host re-runs (nothing to accumulate on the
        device), the chunked strategy is host-orchestrated, and a
        multi-process mesh would need a collective per batch."""
        return (self.chunked is None and self.mesh.world_size == 1
                and (self.mode == "dense" or self.resolution == "device"))

    def _arm(self) -> float:
        return (self.watchdog.arm() if self.watchdog is not None
                else time.monotonic())

    def _event(self):
        """A CUDA event recorded after the step's last launch on each card
        (None on the CPU, where the work is done when the step returns)."""
        cards = [d for d in self.mesh.devices if d.type == "cuda"]
        if not cards:
            return None
        events = []
        for d in dict.fromkeys(cards):
            with torch.cuda.device(d):
                ev = torch.cuda.Event()
                ev.record()
                events.append(ev)
        return events[0] if len(events) == 1 else events

    def _sum_shards(self, parts: list) -> torch.Tensor:
        """Shard tensors summed on the first mesh device (no host copy)."""
        dev0 = self.mesh.devices[0]
        acc = parts[0].to(dev0)
        for p in parts[1:]:
            acc = acc + p.to(dev0)
        return acc

    def _fetch(self, handle: "InflightInterval"):
        """Wait for the step's device work and copy its outputs to the
        host (runs inside the watchdog's thread when one is set): the
        summed accumulator with its unresolved count in one copy, the
        until-CI step's half-width buffer in a second, and, under the
        integrity check on more than one shard, the shards' own
        accumulators."""
        events = handle.event
        for ev in (events if isinstance(events, list)
                   else [events] if events is not None else []):
            ev.synchronize()
        acc, nu, *rest = handle.out
        acc, nu = _to_host(acc, nu)
        self.transfers += 1
        locals_ = None
        if self.integrity_check:
            if len(handle.locals) == 1:
                locals_ = acc[None].astype(np.int64)
            else:
                locals_ = np.stack([t.cpu().numpy() for t in handle.locals]
                                   ).astype(np.int64)
                self.transfers += len(handle.locals)
        if rest:
            consumed, hw_buf = rest
            self.transfers += 1
            return acc, nu, locals_, consumed, hw_buf.cpu().numpy()
        return acc, nu, locals_

    def dispatch_interval(self, keys_list) -> "InflightInterval":
        """One sync interval (len(keys_list) batches): each shard's batch
        tallies are added to accumulators on its device, the shards'
        accumulators summed on the first mesh device, and nothing comes
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

        def shard(i, shard_batches):
            acc = nu = None
            for keys in shard_batches:
                t, n = self.kernels[i].tally_on_device(
                    keys, self.structure, stratified=self.stratify)
                acc = t if acc is None else acc + t
                nu = n if nu is None else nu + n
            return acc, nu

        def dispatch_work():
            res = self._on_shards(shard,
                                  shard_batch_stack(self.mesh, keys_list))
            locals_ = [acc for acc, _ in res]
            out = (self._sum_shards(locals_),
                   self._sum_shards([nu for _, nu in res]))
            return out, locals_, self._event()

        out, locals_, event = self._guarded_dispatch(dispatch_work, S)
        return InflightInterval(out, armed_at, S, S * B, event, locals_)

    def materialize_interval(self, handle: "InflightInterval",
                             timeout: float | None = None):
        """Block for / copy one interval to the host — ONE transfer per
        sync interval (plus the shards' accumulators under the integrity
        check on a multi-shard mesh).  Enforces the deadline armed at
        dispatch, verifies the shard-vs-sum invariant on the interval
        accumulators, and updates the kernel's escape counters exactly as
        the serial per-batch loop would.  → (tally int64 (N_OUTCOMES,),
        strata int64 | None)."""
        acc, n_unres, locals_ = self._guarded_fetch(
            lambda: self._fetch(handle), handle, timeout)
        if self.integrity_check:
            self._verify_shards(locals_, acc)
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
        after each batch the shards' tallies are summed on the first mesh
        device, the float32 Wilson (pooled) or post-stratified half-width
        of the cumulative tally is evaluated there and one ``done`` flag is
        read; the loop ends at the first batch boundary where the rule
        fires, or when the budget runs out.  The half-width buffer holds
        one entry per consumed batch and NaN past the boundary."""
        if not self.supports_intervals:
            raise ValueError(f"{self.structure}: campaign does not support "
                             "device-resident until-CI accumulation")
        if strat_rule and not self.stratify:
            raise ValueError("stratified stopping rule needs a stratified "
                             "campaign")
        S = len(keys_list)
        B = int(keys_list[0].shape[0])
        armed_at = self._arm()
        dev = self.mesh.devices[0]

        def dispatch_work():
            per_shard = shard_batch_stack(self.mesh, keys_list)
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
            locals_ = [None] * len(self.kernels)
            acc = nu = None
            consumed = 0
            for i in range(S):
                res = self._on_shards(
                    lambda j, batches: self.kernels[j].tally_on_device(
                        batches[i], self.structure, stratified=self.stratify),
                    per_shard)
                for j, (t, _) in enumerate(res):
                    locals_[j] = t if locals_[j] is None else locals_[j] + t
                t = self._sum_shards([t for t, _ in res])
                n = self._sum_shards([n for _, n in res])
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
            return (acc, nu, consumed, hw_buf), locals_, self._event()

        out, locals_, event = self._guarded_dispatch(dispatch_work, S)
        return InflightInterval(out, armed_at, S, S * B, event, locals_)

    def materialize_until_ci(self, handle: "InflightInterval",
                             timeout: float | None = None):
        """Block for / copy one until-CI super-interval — ONE transfer
        however many batches were consumed.  → (tally_delta int64
        (N_OUTCOMES,), strata_delta int64 | None, batches_consumed int,
        hw_trace float32 (consumed,)).  Escape counters update from the
        consumed batch count, and the shard-vs-sum invariant is verified
        on the accumulators exactly like the interval path."""
        acc, n_unres, locals_, consumed, hw_buf = self._guarded_fetch(
            lambda: self._fetch(handle), handle, timeout)
        consumed = int(consumed)
        strata = None
        if self.stratify:
            strata = np.asarray(acc, dtype=np.int64)
            tally = strata.sum(axis=0)
        else:
            tally = np.asarray(acc, dtype=np.int64)
        if self.integrity_check:
            self._verify_shards(locals_, acc)
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
    """A dispatched sync interval: its accumulators summed over the
    shards, still on the first mesh device, the watchdog arm time, the
    interval's shape, the CUDA event(s) recorded after its last launch
    (None on the CPU) and each shard's own accumulator on its device."""
    out: tuple               # device tensors (and host scalars)
    armed_at: float          # watchdog deadline epoch (resilience.arm)
    n_batches: int
    n_trials: int
    event: object = None
    locals: list = ()


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
