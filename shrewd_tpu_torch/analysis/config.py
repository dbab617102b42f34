"""The ``plan.analysis`` config child (the port's copy of
``shrewd_tpu/analysis/config.py AnalysisConfig``).

Only the config is ported: the audit it switches on certifies jax
executables, and the port compiles none.  ``Orchestrator`` raises
``NotImplementedError`` for any ``certify`` other than "off" before a
trial runs.
"""

from __future__ import annotations

from shrewd_tpu_torch.utils.config import ConfigObject, Param


class AnalysisConfig(ConfigObject):
    """The ``plan.analysis`` child: whether compiled campaign steps are
    statically certified (jaxpr/HLO replay-safety audit) when they are
    admitted to the executable cache."""

    certify = Param(str, "off",
                    "certify executables at cache admission: 'off' (no "
                    "auditor), 'warn' (audit + report, never refuse), "
                    "'strict' (a violating executable is refused — "
                    "exec_cache.AdmissionError)",
                    check=lambda v: v in ("off", "warn", "strict"))
    transfer_budget = Param(int, 1,
                            "max device→host transfers per executable "
                            "invocation (1 = the ONE-device_get-per-sync-"
                            "interval contract of parallel/pipeline.py)",
                            check=lambda v: v >= 1)
