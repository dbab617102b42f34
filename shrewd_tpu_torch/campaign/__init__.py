"""Campaign layer: plans, orchestration, checkpoint/resume (the port of
``shrewd_tpu/campaign``).

A *plan* (simpoints × structures × precision targets) elaborates into
trial kernels on the card; the orchestrator advances them batch by batch
through the integrity-checked resilience ladder, owns the stats tree and
the output directory, and checkpoints campaign progress as JSON that
either package resumes.
"""

from shrewd_tpu_torch.campaign.plan import (CampaignPlan, CheckpointSpec,
                                            SimPointSpec, TraceFileSpec,
                                            WorkloadSpec)
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

__all__ = ["CampaignPlan", "SimPointSpec", "WorkloadSpec", "TraceFileSpec",
           "CheckpointSpec", "Orchestrator"]
