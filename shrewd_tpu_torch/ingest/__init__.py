"""Snapshot ingestion and streaming ingest: golden-run artifacts and
workload binaries → typed arrays and campaign-ready windows.

Port of ``shrewd_tpu/ingest/``: the gem5 checkpoint (``cpt``, the
``m5.cpt`` ini format, reference ``src/sim/serialize.hh:68-85``), the
``config.ini``/``config.json`` elaboration dumps (``configfile``,
``src/python/m5/simulate.py:106-124``) and ``stats.txt`` (``statsfile``,
``src/base/stats/text.cc``) readers, restore + re-warm (``warm``); the
ptrace capture (``hostdiff``), the macro→µop lifters (``lift``,
``lift64``), the 64-bit emulator (``emu``), liveness, SimPoint selection,
the content-addressed ``ArtifactStore`` and the journaled
``IngestPipeline``.
"""

from shrewd_tpu_torch.ingest.cpt import (ArchSnapshot, CheckpointIn,
                                         CheckpointOut, load_arch_snapshot,
                                         snapshot_from_capture,
                                         write_arch_snapshot)
from shrewd_tpu_torch.ingest.pipeline import (DEFAULT_AXES, STAGES,
                                              IngestPipeline,
                                              IngestQuarantine,
                                              normalize_axes)
from shrewd_tpu_torch.ingest.store import ArtifactStore, axes_key, data_digest
from shrewd_tpu_torch.ingest.configfile import (load_config_ini,
                                                load_config_json)
from shrewd_tpu_torch.ingest.statsfile import load_stats_txt
from shrewd_tpu_torch.ingest.warm import (window_from_snapshot,
                                          window_from_snapshot_lifted)

__all__ = [
    "ArchSnapshot", "ArtifactStore", "CheckpointIn", "CheckpointOut",
    "DEFAULT_AXES", "IngestPipeline", "IngestQuarantine", "STAGES",
    "axes_key", "data_digest", "normalize_axes",
    "load_arch_snapshot", "snapshot_from_capture", "write_arch_snapshot",
    "load_config_ini", "load_config_json", "load_stats_txt",
    "window_from_snapshot", "window_from_snapshot_lifted",
]
