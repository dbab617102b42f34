"""MinorCPU pipeline-latch transient-fault model (port of
``shrewd_tpu/models/minor.py``).

The reference's MinorCPU is a 4-stage in-order pipeline — fetch1 → fetch2 →
decode → execute — whose stages communicate through explicit latch buffers
(`src/cpu/minor/pipeline.hh:72`, `src/cpu/minor/buffers.hh`).  A particle
strike flips one bit of an in-flight µop's *metadata* while it sits in an
inter-stage latch, before the consuming stage reads it.

Under the 1-IPC in-order timing proxy, µop *i* enters fetch1 at cycle *i*
and occupies latch *s* (s ∈ {0..depth-2}) at cycle *i + s*.  A fault drawn
at (latch s, cycle c) therefore corrupts µop ``entry = c - s``; if that
index falls outside the trace window (negative, or ≥ n) the latch held a
bubble and the fault is masked, because no replay step matches it.

Latch payload fields and their fault kinds:

  field   width           kind
  ------  --------------  --------------
  opcode  OPCODE_BITS     KIND_LATCH_OP
  dst     log2(nphys)     KIND_ROB_DST
  src1    log2(nphys)     KIND_IQ_SRC1
  src2    log2(nphys)     KIND_IQ_SRC2
  imm     32              KIND_LATCH_IMM

Bit positions are drawn uniformly over the *total* latch width, so a
field's fault probability is proportional to its width.
"""

from __future__ import annotations

import numpy as np
import torch

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.o3 import (Fault, KIND_IQ_SRC1, KIND_IQ_SRC2,
                                        KIND_LATCH_IMM, KIND_LATCH_OP,
                                        KIND_ROB_DST, STRUCTURES)
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import ConfigObject, Param

# Bits needed to hold any opcode.
OPCODE_BITS = int(np.ceil(np.log2(U.N_OPCODES)))

FIELD_OP = 0
FIELD_DST = 1
FIELD_SRC1 = 2
FIELD_SRC2 = 3
FIELD_IMM = 4
FIELD_NAMES = ["opcode", "dst", "src1", "src2", "imm"]

_FIELD_KINDS = np.array(STRUCTURES["latch"], dtype=np.int32)
if list(_FIELD_KINDS) != [KIND_LATCH_OP, KIND_ROB_DST, KIND_IQ_SRC1,
                          KIND_IQ_SRC2, KIND_LATCH_IMM]:
    raise ImportError("o3.STRUCTURES['latch'] kind order must match the "
                      "latch field order")


class MinorConfig(ConfigObject):
    """Machine knobs for the latch model (Minor pipeline analog).  The
    outcome-classification knobs stay on ``O3Config``; this object only
    shapes fault sampling."""

    depth = Param(int, 4, "pipeline depth; latches = depth - 1 "
                  "(reference Minor: fetch1/fetch2/decode/execute)")


class MinorFaultSampler:
    """Draws latch faults for one trace, exactly as the reference's
    ``MinorFaultSampler.sample`` under vmap."""

    def __init__(self, trace: Trace, cfg: MinorConfig | None = None):
        self.cfg = cfg if cfg is not None else MinorConfig()
        self.n = trace.n
        self.n_latches = self.cfg.depth - 1
        idx_bits = int(np.log2(trace.nphys))
        self.widths = np.array([OPCODE_BITS, idx_bits, idx_bits, idx_bits,
                                32], dtype=np.int32)
        # cumulative field boundaries over the flattened latch word
        self.bounds = np.cumsum(self.widths).astype(np.int32)
        self.total_bits = int(self.widths.sum())

    def sample_batch(self, keys: torch.Tensor) -> Fault:
        """(B, 2) keys → a Fault batch on the keys' device."""
        sub = prng.split(keys, 3)            # kc, ks, kb
        # a uniform (cycle, latch) coordinate over the pipe's whole
        # occupancy [0, n + n_latches)
        cycle = prng.randint(sub[:, 0], 0, self.n + self.n_latches)
        stage = prng.randint(sub[:, 1], 0, self.n_latches)
        entry = cycle - stage        # may be out of window → bubble → masked
        flat = prng.randint(sub[:, 2], 0, self.total_bits).to(torch.int64)
        bounds = torch.as_tensor(self.bounds.astype(np.int64),
                                 device=keys.device)
        field = (flat[:, None] >= bounds).sum(1)
        lo = torch.where(field == 0, 0,
                         bounds[torch.clamp(field - 1, min=0)])
        kinds = torch.as_tensor(_FIELD_KINDS, device=keys.device)
        return Fault(kind=kinds[field], cycle=entry, entry=entry,
                     bit=(flat - lo).to(torch.int32),
                     shadow_u=torch.ones_like(entry, dtype=torch.float32))
