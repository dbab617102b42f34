from shrewd_tpu_torch.ops import (chunked, classify, replay, taint,
                                  taint_cuda, trial, window)
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
from shrewd_tpu_torch.ops.replay import TraceArrays
from shrewd_tpu_torch.ops.trial import TrialKernel

__all__ = ["ChunkedCampaign", "TraceArrays", "TrialKernel", "chunked",
           "classify", "replay", "taint", "taint_cuda", "trial", "window"]
