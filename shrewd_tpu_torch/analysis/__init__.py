"""Analysis: the plan's certification posture and the crash-point checker.

- ``config.py``     — the ``plan.analysis`` config, so a plan's JSON
  round-trips (the jaxpr/HLO replay-safety audit it configures has no
  counterpart in the port yet: a campaign with ``certify`` other than
  ``"off"`` is refused);
- ``crashcheck.py`` — dynamic, exhaustive crash-point model checking of
  the fleet WAL (``run_crashcheck``) and of the federation gateway's WAL
  (``run_gateway_crashcheck``): recovery re-executed from every recorded
  durability boundary, with bit-identical final tallies required at
  each.

``crashcheck`` loads on first use (``analysis.crashcheck``): it reaches
the service layer, which itself imports the plan and so this package.
"""

from shrewd_tpu_torch.analysis.config import AnalysisConfig

__all__ = ["AnalysisConfig", "crashcheck"]


def __getattr__(name):
    if name == "crashcheck":
        import importlib

        return importlib.import_module(f"{__name__}.crashcheck")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
