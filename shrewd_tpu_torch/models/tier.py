"""The campaign protocol shared by the tier kernels (``models/ruby.py
CacheKernel``, ``models/mesi.py MesiKernel``, ``models/noc.py NocKernel``):
the TrialKernel surface that ``parallel/campaign.py`` and the orchestrator
drive.  A subclass gives ``device``, ``sample_batch``,
``outcomes_of_faults`` and ``strata_of``; every tally it returns counts
all of its trials, so the unresolved count is always zero."""

from __future__ import annotations

import torch

from shrewd_tpu_torch.ops import classify as C


class TierKernel:
    """Keys → outcomes and tallies on the kernel's ``device``."""

    device: torch.device
    default_structure: str | None = None

    def sample_batch(self, keys: torch.Tensor, structure: str):
        raise NotImplementedError

    def outcomes_of_faults(self, faults, structure: str) -> torch.Tensor:
        """Outcome classes int32[B] of a fault batch."""
        raise NotImplementedError

    def strata_of(self, faults) -> torch.Tensor:
        raise NotImplementedError

    def _build_on(self, device) -> "TierKernel":
        """A new kernel of the same inputs on ``device``."""
        raise NotImplementedError

    def on_device(self, device) -> "TierKernel":
        """This kernel's replica on ``device`` (itself on its own device),
        built once per device and cached: a mesh shard's kernel."""
        from shrewd_tpu_torch.parallel.mesh import same_device

        if same_device(device, self.device):
            return self
        reps = self.__dict__.setdefault("_replicas", {})
        key = str(torch.device(device))
        if key not in reps:
            reps[key] = self._build_on(device)
        return reps[key]

    def sampler(self, structure: str | None = None):
        kernel, structure = self, structure or self.default_structure

        class _Sampler:
            def sample_batch(self, keys):
                return kernel.sample_batch(keys, structure)

        return _Sampler()

    def outcomes_from_keys(self, keys: torch.Tensor,
                           structure: str | None = None) -> torch.Tensor:
        """Per-trial keys → outcome classes int32[B] on this kernel's
        device."""
        structure = structure or self.default_structure
        return self.outcomes_of_faults(self.sample_batch(keys, structure),
                                       structure)

    def tally_on_device(self, keys: torch.Tensor,
                        structure: str | None = None,
                        stratified: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys → (int32 tally, (N_OUTCOMES,) or (N_STRATA, N_OUTCOMES)
        when ``stratified``, and a zero unresolved count), left on this
        kernel's device for the campaign steps to accumulate there."""
        from shrewd_tpu_torch.ops.trial import N_STRATA

        structure = structure or self.default_structure
        faults = self.sample_batch(keys, structure)
        out = self.outcomes_of_faults(faults, structure)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if stratified:
            return (C.tally_stratified(out, self.strata_of(faults),
                                       N_STRATA), zero)
        return C.tally(out), zero

    def run_keys(self, keys: torch.Tensor,
                 structure: str | None = None) -> torch.Tensor:
        """Keys → int32 tally (N_OUTCOMES,) on the CPU."""
        return self.tally_on_device(keys, structure)[0].cpu()

    def run_keys_stratified(self, keys: torch.Tensor,
                            structure: str | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys → ((N_STRATA, N_OUTCOMES) tally, 0), both on the CPU
        (ops/trial.py contract)."""
        tally, zero = self.tally_on_device(keys, structure, stratified=True)
        return tally.cpu(), zero.cpu()
