"""Outcome classification (port of ``shrewd_tpu/ops/classify.py:21-81``).

Precedence mirrors the reference: detection happens at execute (before any
corrupt commit), a trap ends the program (DUE), and control divergence or
any architectural state difference without detection is silent data
corruption.  Functions take a batch of lanes, where the reference was
written for one trial and vmapped.
"""

from __future__ import annotations

import torch

from shrewd_tpu_torch.ops.replay import ReplayResult

OUTCOME_MASKED = 0
OUTCOME_SDC = 1
OUTCOME_DUE = 2
OUTCOME_DETECTED = 3
N_OUTCOMES = 4
OUTCOME_NAMES = ["masked", "sdc", "due", "detected"]


def outcome_of(detected, trapped, corrupt) -> torch.Tensor:
    """The precedence ladder on bool[B] flags → int32[B] classes."""
    out = torch.where(corrupt, OUTCOME_SDC, OUTCOME_MASKED)
    out = torch.where(trapped, OUTCOME_DUE, out)
    return torch.where(detected, OUTCOME_DETECTED, out).to(torch.int32)


def classify(result: ReplayResult, golden: ReplayResult,
             compare_regs: bool = True, reg_mask: torch.Tensor | None = None,
             mem_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane outcome classes int32[B]; ``golden`` is a batch of one (or
    of B).  ``reg_mask`` (bool[nphys]) / ``mem_mask`` (bool[mem_words])
    restrict the comparison to the state the code after the window reads
    (``ingest/hostdiff.py``, ``ingest/liveness.py``)."""
    mem_diff = result.mem != golden.mem
    if mem_mask is not None:
        mem_diff = mem_diff & mem_mask
    state_diff = mem_diff.any(dim=-1)
    if compare_regs:
        reg_diff = result.reg != golden.reg
        if reg_mask is not None:
            reg_diff = reg_diff & reg_mask
        state_diff = state_diff | reg_diff.any(dim=-1)
    return outcome_of(result.detected, result.trapped,
                      result.diverged | state_diff)


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of each value of ``idx`` in [0, n), int32[n]: a scatter-add
    into n bins (``torch.bincount`` reads the indices' minimum and maximum
    on the host, two syncs on the card)."""
    idx = idx.reshape(-1).to(torch.int64)
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx)).to(torch.int32)


def tally(outcomes: torch.Tensor) -> torch.Tensor:
    """Outcome-class counts, int32[N_OUTCOMES]."""
    return _counts(outcomes, N_OUTCOMES)


def tally_stratified(outcomes: torch.Tensor, strata: torch.Tensor,
                     n_strata: int) -> torch.Tensor:
    """Per-stratum outcome counts, int32[n_strata, N_OUTCOMES]."""
    flat = strata.to(torch.int64) * N_OUTCOMES + outcomes.to(torch.int64)
    return _counts(flat, n_strata * N_OUTCOMES).reshape(n_strata,
                                                        N_OUTCOMES)


def avf(tallies: torch.Tensor) -> torch.Tensor:
    """Architectural vulnerability factor: (SDC + DUE) / trials."""
    total = tallies.sum()
    return (tallies[OUTCOME_SDC] + tallies[OUTCOME_DUE]) / torch.clamp(
        total, min=1)


def sdc_rate(tallies: torch.Tensor) -> torch.Tensor:
    return tallies[OUTCOME_SDC] / torch.clamp(tallies.sum(), min=1)
