"""The campaign layers: the one-device campaign step, its interval and
until-CI steps and the run-until-CI loop (``campaign``), the engines that
drive those steps (``pipeline``), the stopping rule (``stopping``), and the
trace digest and shared kernel registry (``exec_cache``)."""

from shrewd_tpu_torch.parallel import campaign, stopping
from shrewd_tpu_torch.parallel.campaign import (CampaignResult,
                                                ShardedCampaign,
                                                run_until_ci)

__all__ = ["CampaignResult", "ShardedCampaign", "campaign", "run_until_ci",
           "stopping"]
