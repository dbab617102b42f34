"""Multi-tenant campaign service: a resident scheduler over one mesh
(port of ``shrewd_tpu/service/``).

ONE resident process owns the mesh and interleaves many concurrent
campaigns (*tenants*) through the pipelined engine
(``parallel/pipeline.py``), under a global dispatch-depth budget, with
weighted fair-share + strict-priority scheduling, per-tenant stopping,
checkpoints, and integrity/chaos state.

- ``queue.py``     — ``TenantSpec`` + the durable submission spool
  (atomic claims over a shared directory, the elastic coord-dir idiom),
  so tenants can be submitted while the fleet runs, plus the
  ``ServerLock`` single-server guard and the ``bad/`` quarantine for
  poisoned submissions;
- ``scheduler.py`` — ``CampaignScheduler``, the resident scheduler that
  ticks each tenant's ``StepDriver`` one batch/interval at a time, with
  the poison-tenant retry/quarantine ladder and the per-tenant tick
  watchdog;
- ``journal.py``   — the fleet's write-ahead journal: fsync'd
  checksummed records for every scheduler state transition, compacted
  into ``fleet.json``, so ``CampaignScheduler.recover()`` survives a
  hard kill (SIGKILL/OOM) at any instruction boundary.  The streaming
  ingest pipeline (``ingest/pipeline.py``) keeps its stage records in
  it too.

The invariant: each tenant's final tallies are bit-identical to its solo
serial run (frozen per-batch PRNG keys), including under preemption,
mid-fleet chaos, and drain/resume — co-scheduling changes wall-clock,
never results.  The fleet's on-disk state (``fleet.json``, the journal,
each tenant's v5 checkpoint) is the reference's, so a fleet drained by
either package resumes in the other.
"""

from shrewd_tpu_torch.service.journal import (FleetJournal, is_dirty,
                                              journal_path)
from shrewd_tpu_torch.service.queue import (LockHeld, ServerLock,
                                            SubmissionQueue, TenantSpec)
from shrewd_tpu_torch.service.scheduler import (IDLE, CampaignScheduler,
                                                FleetKilled, TenantKilled)

__all__ = ["CampaignScheduler", "FleetJournal", "FleetKilled", "IDLE",
           "LockHeld", "ServerLock", "SubmissionQueue", "TenantKilled",
           "TenantSpec", "is_dirty", "journal_path"]
