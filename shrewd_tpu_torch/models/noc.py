"""The NoC tier's config (the port's copy of
``shrewd_tpu/models/noc.py NocConfig``).

Only the config is ported, so that a plan's JSON round-trips.  The NoC
fault kernel comes with a later slice: the ``noc:*`` structures raise
``NotImplementedError`` in ``Orchestrator`` before any trial runs.
"""

from __future__ import annotations

from shrewd_tpu_torch.utils.config import ConfigObject, Param

BASELINE_TEMPERATURE_C = 71.0     # the reference FaultModel's baseline


class NocConfig(ConfigObject):
    """X-Y mesh interconnect geometry (garnet-style parameters)."""

    mesh_x = Param(int, 2, "mesh columns")
    mesh_y = Param(int, 2, "mesh rows")
    n_vnets = Param(int, 3, "virtual networks (req/fwd/resp)")
    vcs_per_vnet = Param(int, 4, "virtual channels per vnet")
    buffers_per_data_vc = Param(int, 4, "flit buffers per data VC")
    buffers_per_ctrl_vc = Param(int, 1, "flit buffers per control VC")
    flit_bits = Param(int, 128, "bits per flit")
    temperature_c = Param(float, BASELINE_TEMPERATURE_C, "die temperature")

    def validate(self) -> None:
        if self.mesh_x < 1 or self.mesh_y < 1:
            raise ValueError("mesh dims must be >= 1")

    @property
    def n_routers(self) -> int:
        return self.mesh_x * self.mesh_y
