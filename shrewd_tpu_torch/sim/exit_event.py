"""Typed exit events — the framework↔user automation contract (the port's
copy of ``shrewd_tpu/sim/exit_event.py``).

The reference's public automation API is the ``ExitEvent`` enum plus a
user-generator mapping (``python/gem5/simulate/exit_event.py:39-58``,
``simulator.py:208``; SURVEY §A.4 records it as the protocol to keep). The
TPU campaign's control points differ — there is no guest OS raising
hypercalls — so the event *vocabulary* is campaign-shaped, but the protocol
(event → generator, ``yield True`` stops the run) is the same.
"""

from __future__ import annotations

import enum


class ExitEvent(enum.Enum):
    # one sharded trial batch finished (payload: BatchInfo)
    BATCH_COMPLETE = "batch_complete"
    # a (simpoint, structure) campaign met its CI target (payload: result)
    CI_CONVERGED = "ci_converged"
    # a (simpoint, structure) campaign hit its trial cap unconverged
    MAX_TRIALS = "max_trials"
    # campaign checkpoint written (payload: checkpoint dir)
    CHECKPOINT = "checkpoint"
    # a batch ran below the device tier (payload: DegradeInfo) — the
    # resilience ladder substituted CPU-JAX or the host oracle
    BACKEND_DEGRADED = "backend_degraded"
    # the device→host escalation rate crossed the configured budget
    # (payload: EscalationInfo); emitted once, then the run continues
    # (action=warn) or the event stream ends early (action=abort)
    ESCALATION_EXCEEDED = "escalation_exceeded"
    # a batch failed the integrity layer's canary/invariant checks or the
    # audit mismatch budget was exceeded (payload: evidence dict from
    # integrity.IntegrityMonitor, or integrity.AuditBudgetInfo for the
    # budget gate).  Quarantined batches that recover via re-dispatch emit
    # this with kind="recovered"; an unrecoverable violation or an
    # audit_action=abort breach ends the stream after a resumable
    # checkpoint (rc 3)
    INTEGRITY_VIOLATION = "integrity_violation"
    # SIGTERM/SIGINT drain: the in-flight batch finished, a resumable
    # checkpoint was written, and the event stream ends (payload: the
    # checkpoint dir, or None without an outdir).  The CLI exits rc 4.
    PREEMPTED = "preempted"
    # an elastic peer stopped heartbeating and its batch lease was revoked
    # (payload: elastic.WorkerLostInfo — who died, the reclaimed batch,
    # the surviving membership); the campaign continues on the survivors
    WORKER_LOST = "worker_lost"
    # one simpoint finished all structures (payload: simpoint name)
    SIMPOINT_COMPLETE = "simpoint_complete"
    # the whole plan finished (payload: {(simpoint, structure): result})
    CAMPAIGN_COMPLETE = "campaign_complete"
