"""The ``plan.chaos`` config child (the port's copy of
``shrewd_tpu/chaos.py ChaosConfig``).

Only the config is ported, so that a plan's JSON round-trips.  The
deterministic fault-injection engine it names comes with a later slice of
the port: ``ChaosConfig.build`` raises ``NotImplementedError`` for a
non-empty chaos plan, before any trial runs.
"""

from __future__ import annotations

from shrewd_tpu_torch.utils.config import ConfigObject, Param

LATER = "comes with a later slice of the PyTorch port"


class ChaosConfig(ConfigObject):
    """The ``plan.chaos`` config child: where this campaign's failure
    schedule comes from, so a chaos run is reproducible from its config
    dump like every other campaign posture."""

    plan_path = Param(str, "", "path to a chaos-plan JSON file "
                               "(empty = no chaos)")
    spec = Param(str, "", "inline chaos-plan JSON (overrides plan_path)")

    def build(self, worker: str = ""):
        """None for an empty plan; a chaos plan raises."""
        if self.spec or self.plan_path:
            raise NotImplementedError(f"the chaos engine {LATER}")
        return None
