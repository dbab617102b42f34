"""The campaign step and the run-until-CI loop on one device (port of
``shrewd_tpu/parallel/campaign.py`` for one card).

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

In this slice the campaign runs on the kernel's own device: ``mesh`` must
be None.  The reference's multi-device sharding, its watchdog and integrity
hooks, its interval and until-CI steps (``parallel/pipeline.py``) and the
resilient dispatcher come with later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.trial import N_STRATA
from shrewd_tpu_torch.parallel import stopping
from shrewd_tpu_torch.utils import prng

_LATER = "comes with a later slice of the PyTorch port"


class ShardedCampaign:
    """One (kernel, structure) campaign on the kernel's device.

    Honors the kernel's ``replay_kernel`` config: "dense" runs the dense
    protocol; "taint"/"hybrid" take the budgeted device resolution by
    default, or the host-driven exact path with ``resolution="host"``.
    ``stratify=True`` offers ``tally_batch_stratified`` for the
    post-stratified stopping rule."""

    def __init__(self, kernel, mesh, structure: str,
                 resolution: str = "device", stratify: bool = False,
                 watchdog=None, integrity_check: bool = False,
                 chunked=None):
        if mesh is not None:
            raise NotImplementedError(
                f"a device mesh {_LATER} (multi-GPU); pass mesh=None to run "
                f"on the kernel's own device")
        if watchdog is not None:
            raise NotImplementedError(f"the device watchdog {_LATER} "
                                      f"(resilience)")
        if integrity_check:
            raise NotImplementedError(f"the shard-vs-sum integrity check "
                                      f"{_LATER} (integrity layer)")
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
        self.chunked = chunked
        self.mode = getattr(getattr(kernel, "cfg", None),
                            "replay_kernel", "dense")

    def _count(self, n_unres, n_trials: int) -> None:
        """The kernel's escape statistics, as the reference's steps keep
        them (dense replay has no escape machinery)."""
        if self.mode != "dense":
            self.kernel.escapes += int(n_unres)
            self.kernel.taint_trials += n_trials

    def tally_batch_stratified(self, keys: torch.Tensor) -> torch.Tensor:
        """Keys (B, 2) → (N_STRATA, N_OUTCOMES) int32 tally on the CPU for
        the post-stratified estimator; summing over strata gives
        ``tally_batch`` exactly (same outcomes, same resolution)."""
        if not self.stratify:
            raise ValueError("campaign built without stratify=True")
        if self.chunked is not None:
            return self._tally_chunked(keys, stratified=True)
        tally_h, n_unres = self.kernel.run_keys_stratified(keys,
                                                           self.structure)
        self._count(n_unres, int(keys.shape[0]))
        return tally_h

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
        if self.mode == "dense":
            return C.tally(kernel.outcomes_from_keys(keys, structure)).cpu()
        if self.resolution == "device":
            tally, n_unres = kernel.run_keys_device(keys, structure)
            self._count(n_unres, int(keys.shape[0]))
            return tally
        faults = kernel.sample_batch(keys, structure)
        res = kernel.taint_fast(faults, may_latch=structure == "latch")
        out = res.outcome.cpu().numpy().copy()
        esc = res.escaped.cpu().numpy()
        ovf = res.overflow.cpu().numpy()
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
    campaign kernel's device."""
    if dispatcher is not None:
        raise NotImplementedError(f"the resilient dispatcher {_LATER} "
                                  f"(resilience)")
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
    while trials < max_trials:
        keys = prng.trial_keys(prng.batch_key(sk, batch_id), batch_size)
        if stratified:
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
    )
