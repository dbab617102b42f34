"""Streaming ingest: a workload binary in, campaign-ready windows out.

Port of ``shrewd_tpu/ingest/``: the ptrace capture (``hostdiff``), the
macro→µop lifters (``lift``, ``lift64``), the 64-bit emulator (``emu``),
liveness, SimPoint selection, the content-addressed ``ArtifactStore``
and the journaled ``IngestPipeline``.  The gem5 checkpoint, config and
stats readers (``cpt``, ``configfile``, ``statsfile``, ``warm``) come
with a later slice.
"""

from shrewd_tpu_torch.ingest.pipeline import (DEFAULT_AXES, STAGES,
                                              IngestPipeline,
                                              IngestQuarantine,
                                              normalize_axes)
from shrewd_tpu_torch.ingest.store import ArtifactStore, axes_key, data_digest

__all__ = [
    "ArtifactStore", "DEFAULT_AXES", "IngestPipeline", "IngestQuarantine",
    "STAGES", "axes_key", "data_digest", "normalize_axes",
]
