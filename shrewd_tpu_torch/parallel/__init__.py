"""The campaign layers: the one-device campaign step and run-until-CI loop
(``campaign``), the stopping rule (``stopping``), and the trace digest that
keys preprocessed windows (``exec_cache``)."""

from shrewd_tpu_torch.parallel import campaign, stopping
from shrewd_tpu_torch.parallel.campaign import (CampaignResult,
                                                ShardedCampaign,
                                                run_until_ci)

__all__ = ["CampaignResult", "ShardedCampaign", "campaign", "run_until_ci",
           "stopping"]
