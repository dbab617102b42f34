"""The campaign service's host layers (port of ``shrewd_tpu/service/``).

Only ``journal.py`` is ported so far: the fleet's write-ahead journal,
which the streaming ingest pipeline (``ingest/pipeline.py``) keeps its
stage records in.  The submission queue and the resident scheduler come
with a later slice.
"""

from shrewd_tpu_torch.service.journal import (FleetJournal, is_dirty,
                                              journal_path)

__all__ = ["FleetJournal", "is_dirty", "journal_path"]
