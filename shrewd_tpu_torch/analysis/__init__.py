"""Static certification posture: the port carries the ``plan.analysis``
config (``analysis/config.py``) so a plan's JSON round-trips; the jaxpr/HLO
replay-safety audit it configures has no counterpart in the port yet."""

from shrewd_tpu_torch.analysis.config import AnalysisConfig

__all__ = ["AnalysisConfig"]
