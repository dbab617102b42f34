"""O3 fault-target model: structures, fault descriptors, samplers.

Port of ``shrewd_tpu/models/o3.py``: the ``KIND_*`` codes, ``STRUCTURES``,
``Fault``/``null_fault``, ``O3Config`` (same param names, defaults and
children, so ``to_dict()`` compares equal to the reference's),
``compute_shadow_cov`` for both shadow models (the per-OpClass coverage and
the structural FU pool, ``models/fupool.py``) and ``FaultSampler`` for
regfile, fu, rob, iq and lsq under both timing models (the 1-IPC proxy and
the scoreboard's residency draw, ``models/timing.py``).  Latch faults are
drawn by ``models/minor.py``.

The µop's trace index doubles as its timestamp; ROB/IQ/LSQ entry faults
are addressed by the struck µop index.  A residency draw that lands in the
wrong-path mass gets the sentinel entry ``n``, which no replay step
matches: masked by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.fupool import FUPoolConfig, FUPoolModel
from shrewd_tpu_torch.models.timing import (ResidencySampler, TimingConfig,
                                            compute_scoreboard)
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import (Child, ConfigObject, Param,
                                           VectorParam)

# --- fault kinds -----------------------------------------------------------

KIND_NONE = 0
KIND_REGFILE = 1
KIND_FU = 2
KIND_ROB_DST = 3
KIND_IQ_SRC1 = 4
KIND_IQ_SRC2 = 5
KIND_LSQ_ADDR = 6
KIND_LSQ_DATA = 7
KIND_LATCH_OP = 8
KIND_LATCH_IMM = 9

# the reference's Pallas golden-block width; kept only because O3Config's
# pallas_u_steps check reads it
PALLAS_S_CHUNK = 128

# structure name → kinds drawn for it
STRUCTURES = {
    "regfile": (KIND_REGFILE,),
    "fu": (KIND_FU,),
    "rob": (KIND_ROB_DST,),
    "iq": (KIND_IQ_SRC1, KIND_IQ_SRC2),
    "lsq": (KIND_LSQ_ADDR, KIND_LSQ_DATA),
    "latch": (KIND_LATCH_OP, KIND_ROB_DST, KIND_IQ_SRC1, KIND_IQ_SRC2,
              KIND_LATCH_IMM),
}


class Fault(NamedTuple):
    """A batch of trials' fault coordinates: 1-D tensors of one length B
    (int32 fields, float32 ``shadow_u``) on one device."""

    kind: torch.Tensor      # KIND_*
    cycle: torch.Tensor     # step at which a storage flip lands
    entry: torch.Tensor     # register index (REGFILE) or µop index (others)
    bit: torch.Tensor
    shadow_u: torch.Tensor  # uniform draw for shadow-FU detection

    def bit_as_index_mask(self) -> torch.Tensor:
        """The flip mask ``1 << bit`` as an int64 tensor; 0 where the bit
        lies outside [0, 32), as jax's shift gives."""
        bit = self.bit.to(torch.int64)
        ok = (bit >= 0) & (bit < 32)
        return torch.where(ok, torch.ones_like(bit) << bit.clamp(0, 31), 0)

    def to(self, device) -> "Fault":
        return Fault(*(x.to(device) for x in self))

    def index(self, idx) -> "Fault":
        return Fault(*(x[idx] for x in self))


def null_fault(device) -> Fault:
    """A batch of one fault-free trial (golden replay)."""
    z = torch.zeros(1, dtype=torch.int32, device=device)
    return Fault(kind=z, cycle=z, entry=z, bit=z,
                 shadow_u=torch.ones(1, dtype=torch.float32, device=device))


class O3Config(ConfigObject):
    """Machine-model knobs, param for param the reference's
    (``shrewd_tpu/models/o3.py:102-190``).

    ``pallas``, ``pallas_b_tile`` and ``pallas_u_steps`` tuned the TPU
    kernel; they stay so the config dicts compare equal, and the port does
    not read them: its fast pass is chosen by the tensors' device alone
    (``ops/trial.py``)."""

    rob_size = Param(int, 192, "in-flight window for entry-fault sampling")
    issue_width = Param(int, 8, "µops issued per cycle")
    compare_regs = Param(bool, True,
                         "classify end-of-window register diffs as SDC "
                         "(conservative); False compares memory only")
    # "dense" — full-state scan (ops/replay.py), exact;
    # "taint" — deviation-set fast pass, escapes counted as SDC;
    # "hybrid" — fast pass + exact re-run of escaped lanes.
    replay_kernel = Param(str, "hybrid",
                          check=lambda s: s in ("dense", "taint", "hybrid"))
    taint_k = Param(int, 16, "deviation-set capacity per trial;"
                    " overflow escapes to the dense kernel")
    taint_mem_timeline_mb = Param(int, 256,
                                  "record the golden memory timeline when "
                                  "n*mem_words*4 fits this budget")
    taint_reg_timeline_mb = Param(int, 256,
                                  "keep the golden register timeline when "
                                  "n*nphys*4 fits this budget, else run "
                                  "the per-batch setup scan")
    escape_budget = Param(int, 256,
                          "exact-resolution capacity of the budgeted path "
                          "(ops/trial.py run_keys_device): up to this many "
                          "escaped/overflowed lanes per call are re-run "
                          "dense, lanes beyond it count as SDC; 0 disables")
    pallas = Param(str, "auto", check=lambda s: s in ("auto", "on", "off"))
    pallas_b_tile = Param(int, 1024,
                          check=lambda v: v >= 128 and v % 128 == 0)
    pallas_u_steps = Param(int, 2,
                           check=lambda v: v >= 1
                           and PALLAS_S_CHUNK % v == 0)
    enable_shrewd = Param(bool, True,
                          "master switch for shadow-FU detection")
    priority_to_shadow = Param(bool, False,
                               "shadow FU claimed at issue (True) vs "
                               "deferred pass (False)")
    shadow_model = Param(str, "coverage",
                         check=lambda s: s in ("coverage", "fupool"))
    shadow_coverage = VectorParam(float, [0.0] * U.N_OPCLASSES,
                                  "per-OpClass shadow detection probability "
                                  "(shadow_model='coverage')")
    fu_pool = Child(FUPoolConfig)
    timing = Param(str, "scoreboard",
                   check=lambda s: s in ("proxy", "scoreboard"))
    timing_cfg = Child(TimingConfig)


def compute_shadow_cov(opclass, cfg: O3Config, **schedule):
    """Per-µop shadow detection coverage → (float32[n], FUPoolModel | None).

    The FUPoolModel is returned (structural model only) so callers can read
    its per-OpClass availability counters.  ``schedule`` kwargs
    (issue_cycle, busy_cycles, approx_busy_cycles, phantom_opclass,
    phantom_cycle) drive the structural model with a real issue schedule and
    wrong-path contention — TrialKernel passes the scoreboard's when
    ``timing="scoreboard"``."""
    opclass = np.asarray(opclass, dtype=np.int32)
    if not cfg.enable_shrewd:
        return np.zeros(opclass.shape[0], dtype=np.float32), None
    if cfg.shadow_model == "fupool":
        m = FUPoolModel(opclass, cfg.issue_width, cfg.fu_pool,
                        cfg.priority_to_shadow, **schedule)
        return m.coverage(), m
    return np.asarray(cfg.shadow_coverage, dtype=np.float32)[opclass], None


class FaultSampler:
    """Draws fault batches for one (trace, structure) pair from per-trial
    keys, exactly as the reference's ``FaultSampler.sample`` under vmap.
    The µop index tables (mem-op positions for LSQ faults) and the
    residency table are built on the host once."""

    def __init__(self, trace: Trace, structure: str, cfg: O3Config,
                 scoreboard=None):
        if structure not in STRUCTURES:
            raise KeyError(f"unknown structure {structure!r} "
                           f"(known: {sorted(STRUCTURES)})")
        if structure == "latch":
            raise ValueError("latch faults are drawn by "
                             "models.minor.MinorFaultSampler "
                             "(TrialKernel.sampler dispatches there)")
        self.structure = structure
        self.cfg = cfg
        self.n = trace.n
        self.nphys = trace.nphys
        self.idx_bits = int(np.log2(trace.nphys))
        self.rob_size = min(cfg.rob_size, self.n)

        mem_idx = np.nonzero(U.is_mem(trace.opcode))[0]
        store_idx = np.nonzero(U.is_store(trace.opcode))[0]
        # degenerate traces: point at µop 0 (the fault lands on a non-mem
        # µop and is architecturally masked: "the LSQ is empty")
        self.mem_idx = (mem_idx if mem_idx.size
                        else np.zeros(1, np.int64)).astype(np.int32)
        self.store_idx = (store_idx if store_idx.size
                          else np.zeros(1, np.int64)).astype(np.int32)
        self.store_mask = np.asarray(U.is_store(trace.opcode), bool)
        self._dev: dict = {}

        self._res: ResidencySampler | None = None
        if cfg.timing == "scoreboard" and structure in ("rob", "iq", "lsq",
                                                        "fu"):
            # the scoreboard is per-(trace, timing_cfg); TrialKernel passes
            # its cached one so four samplers don't redo the host walk
            sb = scoreboard if scoreboard is not None else \
                compute_scoreboard(trace, cfg.timing_cfg)
            mem_mask = np.asarray(U.is_mem(trace.opcode))
            start, end = sb.occupancy(structure,
                                      mem_mask if structure == "lsq"
                                      else None)
            # wrong-path entries (bpred model) add squash-masked strike
            # cross-section — drawn as the sentinel entry n
            self._res = ResidencySampler(
                start, end, squashed_mass=sb.wrongpath_mass(structure))

    def _tables(self, device: torch.device):
        """(mem_idx, store_idx, store_mask) on ``device``, uploaded once."""
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.mem_idx, self.store_idx, self.store_mask))
        return self._dev[device]

    def sample_batch(self, keys: torch.Tensor) -> Fault:
        """(B, 2) keys → a Fault batch on the keys' device."""
        sub = prng.split(keys, 5)            # kc, ke, kb, kk, ks
        kc, ke, kb, kk = (sub[:, j] for j in range(4))
        cycle = prng.randint(kc, 0, self.n)
        shadow_u = prng.uniform(sub[:, 4])

        def const(kind):
            return torch.full_like(cycle, kind)

        if self.structure == "regfile":
            # the register array is fully resident at all times: uniform
            # over (entry, cycle) is the physically correct draw
            entry = prng.randint(ke, 0, self.nphys)
            bit = prng.randint(kb, 0, 32)
            kind = const(KIND_REGFILE)
        elif self.structure == "fu":
            if self._res is not None:
                # FU occupancy = issue→writeback: a 20-cycle divide
                # presents 20× the strike cross-section of an ALU op
                entry, cycle = self._res.sample(ke)
            else:
                entry = cycle                # fault at execute of µop cycle
            bit = prng.randint(kb, 0, 32)
            kind = const(KIND_FU)
        elif self.structure == "rob":
            entry, cycle = self._resident(ke, cycle)
            bit = prng.randint(kb, 0, self.idx_bits)
            kind = const(KIND_ROB_DST)
        elif self.structure == "iq":
            entry, cycle = self._resident(ke, cycle)
            bit = prng.randint(kb, 0, self.idx_bits)
            kind = torch.where(prng.bernoulli(kk), KIND_IQ_SRC1,
                               KIND_IQ_SRC2).to(torch.int32)
        else:  # lsq
            mem_idx, store_idx, store_mask = self._tables(keys.device)
            which = prng.bernoulli(kk)       # addr vs data field
            if self._res is not None:
                # residency-weighted over mem µops (non-mem intervals carry
                # zero mass); the data field exists only on stores, and
                # the sentinel entry n reads the clamped store mask
                entry, cycle = self._res.sample(ke)
                is_st = store_mask[entry.to(torch.int64).clamp(0,
                                                               self.n - 1)]
                kind = torch.where(which & is_st, KIND_LSQ_DATA,
                                   KIND_LSQ_ADDR).to(torch.int32)
            else:
                # uniform over mem µops; both indices come from the same
                # key ke, over different spans, as in the reference
                i_mem = prng.randint(ke, 0, self.mem_idx.shape[0])
                i_st = prng.randint(ke, 0, self.store_idx.shape[0])
                entry = torch.where(which, mem_idx[i_mem.to(torch.int64)],
                                    store_idx[i_st.to(torch.int64)])
                kind = torch.where(which, KIND_LSQ_ADDR,
                                   KIND_LSQ_DATA).to(torch.int32)
            bit = prng.randint(kb, 0, 32)
        return Fault(kind=kind, cycle=cycle, entry=entry, bit=bit,
                     shadow_u=shadow_u)

    def _resident(self, key: torch.Tensor, cycle: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """A µop resident in the ROB/IQ at the struck cycle: residency-mass
        weighted under the scoreboard, else the 1-IPC proxy (index in
        [cycle, cycle+rob_size), clamped to the window)."""
        if self._res is not None:
            return self._res.sample(key)
        off = prng.randint(key, 0, self.rob_size)
        return torch.clamp(cycle + off, max=self.n - 1), cycle
