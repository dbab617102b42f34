"""Simulation-control tier: exit events + the Simulator automation API."""

from shrewd_tpu_torch.sim.exit_event import ExitEvent
from shrewd_tpu_torch.sim.simulator import Simulator

__all__ = ["ExitEvent", "Simulator"]
