"""The campaign layers: the sharded campaign step, its interval and
until-CI steps and the run-until-CI loop (``campaign``), the device mesh over
``torch.distributed`` (``mesh``), the engines that drive the steps
(``pipeline``), the stopping rule (``stopping``), the elastic lease board
(``elastic``), the multi-process launcher (``launch``), and the trace digest
and shared kernel registry (``exec_cache``)."""

from shrewd_tpu_torch.parallel import campaign, mesh, stopping
from shrewd_tpu_torch.parallel.campaign import (CampaignResult,
                                                ShardedCampaign,
                                                run_until_ci)
from shrewd_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                            shard_keys)

__all__ = ["CampaignResult", "ShardedCampaign", "campaign",
           "init_distributed", "make_mesh", "mesh", "run_until_ci",
           "shard_keys", "stopping"]
