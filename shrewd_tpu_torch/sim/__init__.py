"""Simulation-control tier: the typed exit events of the campaign
stream."""

from shrewd_tpu_torch.sim.exit_event import ExitEvent

__all__ = ["ExitEvent"]
