"""Trial batches: keys → faults → fast pass → exact resolution → tally.

Port of ``shrewd_tpu/ops/trial.py``.  One ``TrialKernel`` binds a trace
window, the machine config (with SHREWD's structural shadow-FU model when
``shadow_model="fupool"``) and a device; its golden run and golden streams
are recorded on first use.  ``run_keys(keys, structure)`` is the campaign
unit, for every structure of ``models/o3.py STRUCTURES``:

- ``replay_kernel="dense"``: every lane through the dense scan;
- ``"taint"``: the deviation-set fast pass, unresolved lanes count as SDC;
- ``"hybrid"`` (default): the fast pass on every lane, then the row pass
  for lanes that escaped on a load and the dense scan for sets that
  overflowed — outcomes equal the dense path's.

``run_keys_device`` / ``run_keys_stratified`` are the campaign loop's
budgeted path (the reference's in-graph resolution): the first
``escape_budget`` unresolved lanes, in index order, are re-run dense and
the rest count as SDC — a different tally from ``run_keys`` once a batch
has more escapes than the budget.

The fast pass goes through ``ops/taint_cuda.py taint_fast_cuda``, which
launches the Hopper kernel for CUDA tensors and runs its plain version for
CPU tensors: the kernel's device alone decides.  The config's ``pallas*``
params are not read.

A kernel with a ``memmap`` (``ops/replay.py MemMap``, lifted traces only)
takes the dense scan on every path, as the reference's: the VA-space trap
model lives in the dense replay alone, and the fast pass's validity test
would disagree on memory faults.
"""

from __future__ import annotations

import numpy as np
import torch

from shrewd_tpu_torch import native
from shrewd_tpu_torch.isa import uops as U
from shrewd_tpu_torch.models.minor import MinorFaultSampler
from shrewd_tpu_torch.models.o3 import (Fault, FaultSampler, O3Config,
                                        compute_shadow_cov, null_fault)
from shrewd_tpu_torch.models.timing import (approx_shadow_busy,
                                            compute_scoreboard,
                                            nonpipelined_busy,
                                            wrongpath_phantoms)
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.ops.replay import ReplayResult, TraceArrays, replay
from shrewd_tpu_torch.ops.taint import (TaintResult, fault_setup,
                                        record_golden, setup_scan,
                                        taint_replay)
from shrewd_tpu_torch.ops.taint_cuda import pack_stream, taint_fast_cuda
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils.device import host_sync
from shrewd_tpu_torch.utils.device import resolve as resolve_device

# strata count for the post-stratified tally: the 7 OpClasses and 8 cycle
# octiles
N_STRATA = 8


class TrialKernel:
    def __init__(self, trace: Trace, cfg: O3Config | None = None,
                 minor_cfg=None, device=None, memmap=None):
        """``minor_cfg`` (``models.minor.MinorConfig``) shapes latch
        faults.  ``device=None`` means the CUDA card; it raises when there
        is none.  Pass ``device="cpu"`` to run on the CPU.  ``memmap``
        (``ops/replay.py MemMap``) is a lifted trace's VA-space map."""
        self.device = resolve_device(device)
        self.memmap = memmap.to(self.device) if memmap is not None else None
        self.cfg = cfg if cfg is not None else O3Config()
        self.minor_cfg = minor_cfg
        self.trace = trace
        self.tr = TraceArrays.from_trace(trace, self.device)
        self.init_reg = torch.as_tensor(trace.init_reg.astype(np.int64),
                                        device=self.device)
        self.init_mem = torch.as_tensor(trace.init_mem.astype(np.int64),
                                        device=self.device)
        opclass = U.opclass_of(trace.opcode)
        # With scoreboard timing the structural FU-pool model contends
        # under the scoreboard's issue schedule and wrong-path phantoms,
        # as the reference's; the scoreboard is shared with the samplers.
        self._scoreboard = None
        sched = {}
        if (self.cfg.shadow_model == "fupool" and self.cfg.enable_shrewd
                and self.scoreboard is not None):
            tcfg = self.cfg.timing_cfg
            ph_oc, ph_cyc = wrongpath_phantoms(trace, self.scoreboard, tcfg)
            sched = dict(
                issue_cycle=self.scoreboard.issue,
                busy_cycles=nonpipelined_busy(trace.opcode, tcfg),
                approx_busy_cycles=approx_shadow_busy(trace.opcode, tcfg),
                phantom_opclass=ph_oc, phantom_cycle=ph_cyc)
        cov, self.fu_model = compute_shadow_cov(opclass, self.cfg, **sched)
        self.shadow_cov = torch.as_tensor(cov, device=self.device)
        self._opclass = torch.as_tensor(opclass.astype(np.int64),
                                        device=self.device)
        self._golden: ReplayResult | None = None
        self._golden_rec = None
        self._stream = None
        self._samplers: dict = {}
        self._replicas: dict = {}       # on_device: one per other device
        # taint observability: escape counts feed campaign stats
        self.escapes = 0
        self.taint_trials = 0

    def with_shrewd(self, enable: bool | None = None,
                    priority_to_shadow: bool | None = None
                    ) -> "TrialKernel":
        """Runtime SHREWD toggles, functional-style: the reference's
        ``setEnableShrewd`` / ``setPriorityToShadow`` setters
        (``cpu/o3/cpu.hh:298-302``) flip them mid-run; here a fresh kernel
        on the same device is returned instead of mutating this one."""
        cfg = type(self.cfg).from_dict(self.cfg.to_dict())
        if enable is not None:
            cfg.enable_shrewd = enable
        if priority_to_shadow is not None:
            cfg.priority_to_shadow = priority_to_shadow
        # graftlint: allow-jit -- a toggled copy of this kernel for the
        # caller to hold (the reference's runtime setters), not a
        # campaign's kernel of a window
        return TrialKernel(self.trace, cfg, self.minor_cfg,
                           device=self.device, memmap=self.memmap)

    def on_device(self, device) -> "TrialKernel":
        """This kernel's replica on ``device`` (itself on its own device),
        built once per device and cached: a mesh shard's kernel.  Same
        window and configs, so the same outcomes for the same keys."""
        from shrewd_tpu_torch.parallel.mesh import same_device

        if same_device(device, self.device):
            return self
        key = str(torch.device(device))
        if key not in self._replicas:
            # graftlint: allow-jit -- the per-device replica of a mesh
            # shard, cached on this kernel, which the registry holds
            self._replicas[key] = TrialKernel(self.trace, self.cfg,
                                              self.minor_cfg, device=device,
                                              memmap=self.memmap)
        return self._replicas[key]

    # --- dense path ---------------------------------------------------------

    @property
    def golden(self) -> ReplayResult:
        """The fault-free dense replay (a batch of one), recorded once."""
        if self._golden is None:
            with host_sync("golden-record"):
                self._golden = self._replay(null_fault(self.device))
        return self._golden

    def _replay(self, faults: Fault) -> ReplayResult:
        return replay(self.tr, self.init_reg, self.init_mem, faults,
                      self.shadow_cov, memmap=self.memmap)

    def run_batch(self, faults: Fault) -> torch.Tensor:
        """Fault batch → outcome classes int32[B] through the dense scan
        (the in-framework oracle path)."""
        faults = faults.to(self.device)
        return C.classify(self._replay(faults), self.golden,
                          self.cfg.compare_regs)

    # --- sampling -----------------------------------------------------------

    @property
    def scoreboard(self):
        """The window's scoreboard under ``timing="scoreboard"`` (computed
        on first use, then shared by the FU-pool schedule and the
        samplers); None under the 1-IPC proxy."""
        if self._scoreboard is None and self.cfg.timing == "scoreboard":
            self._scoreboard = compute_scoreboard(self.trace,
                                                  self.cfg.timing_cfg)
        return self._scoreboard

    def sampler(self, structure: str):
        """The structure's sampler: ``MinorFaultSampler`` for latch, else a
        ``FaultSampler``; regfile draws need no scoreboard."""
        if structure not in self._samplers:
            if structure == "latch":
                sampler = MinorFaultSampler(self.trace, self.minor_cfg)
            elif structure == "regfile":
                sampler = FaultSampler(self.trace, structure, self.cfg)
            else:
                sampler = FaultSampler(self.trace, structure, self.cfg,
                                       scoreboard=self.scoreboard)
            self._samplers[structure] = sampler
        return self._samplers[structure]

    def sample_batch(self, keys: torch.Tensor, structure: str) -> Fault:
        """(B, 2) keys → the Fault batch on this kernel's device."""
        return self.sampler(structure).sample_batch(keys.to(self.device))

    def outcomes_from_keys(self, keys: torch.Tensor, structure: str
                           ) -> torch.Tensor:
        """Per-trial keys → outcome classes int32[B] on this kernel's
        device, through the dense scan (the reference's campaign
        protocol)."""
        return self.run_batch(self.sample_batch(keys, structure))

    # --- deviation-set fast path --------------------------------------------

    @property
    def golden_rec(self):
        """Golden streams for the deviation-set scans (recorded on first
        use); the timelines are kept only within the config's budgets."""
        if self._golden_rec is None:
            n, mw, nphys = self.trace.n, self.trace.mem_words, \
                self.trace.nphys
            with_mem_t = n * mw * 4 <= self.cfg.taint_mem_timeline_mb << 20
            with_reg_t = n * nphys * 4 <= self.cfg.taint_reg_timeline_mb << 20
            with host_sync("golden-record"):
                self._golden_rec = record_golden(
                    self.tr, self.init_reg, self.init_mem, with_mem_t,
                    reg_timeline=with_reg_t)
        return self._golden_rec

    @property
    def packed_stream(self):
        """The golden record packed for the Hopper kernels
        (``ops/taint_cuda.py pack_stream``), packed on first use; None on
        the CPU, where the fast pass is the plain scan."""
        if self._stream is None and self.device.type == "cuda":
            with host_sync("golden-record"):
                self._stream = pack_stream(self.golden_rec, self.tr,
                                           self.shadow_cov)
        return self._stream

    def _setup_batch(self, faults: Fault):
        """Per-lane (gold_at_fault, alt1, alt2): timeline gathers when the
        register timeline is kept, else the setup scan."""
        if self.golden_rec.reg_t is not None:
            return fault_setup(self.golden_rec, self.tr, faults)
        return setup_scan(self.tr, self.init_reg, self.init_mem, faults)

    def taint_batch(self, faults: Fault, use_row: bool) -> TaintResult:
        """Fault batch → TaintResult.  ``use_row=False`` is the fast pass,
        ``taint_fast`` (loads at non-golden addresses escape);
        ``use_row=True`` is the row pass, the plain scan that reads the
        memory timeline and resolves those loads.  It raises when the
        timeline was not recorded (over its budget)."""
        if not use_row:
            return self.taint_fast(faults)
        if self.golden_rec.mem_t is None:
            raise RuntimeError("the row pass needs the memory timeline, "
                               "which is over taint_mem_timeline_mb here")
        faults = faults.to(self.device)
        return taint_replay(self.golden_rec, self.tr, faults,
                            self.shadow_cov,
                            k=self.cfg.taint_k,
                            compare_regs=self.cfg.compare_regs,
                            setup=self._setup_batch(faults))

    def taint_fast(self, faults: Fault, may_latch: bool = True
                   ) -> TaintResult:
        """The fast pass: the Hopper kernel for a CUDA kernel object, its
        plain version for a CPU one (``ops/taint_cuda.py``)."""
        faults = faults.to(self.device)
        gaf, alt1, alt2 = self._setup_batch(faults)
        return taint_fast_cuda(self.golden_rec, self.tr, self.shadow_cov,
                               faults, gaf, alt1, alt2, k=self.cfg.taint_k,
                               compare_regs=self.cfg.compare_regs,
                               may_latch=may_latch,
                               stream=self.packed_stream)

    @staticmethod
    def _bucket(idx: np.ndarray) -> np.ndarray:
        """Pad indices to a power-of-two bucket ≥ 64 (the reference's
        recompile bound; here it keeps the exact passes' shapes few)."""
        m = max(64, 1 << int(np.ceil(np.log2(len(idx)))))
        return np.concatenate([idx, np.zeros(m - len(idx), dtype=idx.dtype)])

    def run_batch_hybrid(self, faults: Fault,
                         may_latch: bool = True) -> np.ndarray:
        """Fast pass for all lanes → row pass for load escapes → dense
        scan for overflows; outcomes equal ``run_batch``'s.  With a
        memmap every lane takes the dense scan."""
        if self.memmap is not None:
            return self.run_batch(faults).cpu().numpy()
        res = self.taint_fast(faults, may_latch=may_latch)
        out = res.outcome.cpu().numpy().copy()
        return self.resolve_escapes(faults, out, res.escaped.cpu().numpy(),
                                    res.overflow.cpu().numpy())

    def resolve_escapes(self, faults: Fault, outcomes: np.ndarray,
                        esc: np.ndarray, ovf: np.ndarray) -> np.ndarray:
        """Passes 2 and 3 of the hybrid, on the bucketed escaped lanes."""
        faults = faults.to(self.device)
        self.escapes += int((esc | ovf).sum())
        self.taint_trials += len(outcomes)
        idx = np.nonzero(esc & ~ovf)[0]     # load escapes: row pass resolves
        dense_idx = np.nonzero(ovf)[0]      # overflows: only dense resolves
        if len(idx) and self.golden_rec.mem_t is not None:
            sub = faults.index(torch.as_tensor(self._bucket(idx),
                                               device=self.device))
            res2 = self.taint_batch(sub, True)
            outcomes[idx] = res2.outcome.cpu().numpy()[:len(idx)]
            still = (res2.escaped | res2.overflow).cpu().numpy()[:len(idx)]
            dense_idx = np.concatenate([dense_idx, idx[still]])
        elif len(idx):                      # no timeline recorded
            dense_idx = np.concatenate([dense_idx, idx])
        if len(dense_idx):
            sub = faults.index(torch.as_tensor(self._bucket(dense_idx),
                                               device=self.device))
            outcomes[dense_idx] = self.run_batch(sub).cpu().numpy()[
                :len(dense_idx)]
        return outcomes

    def oracle_outcomes(self, faults: Fault) -> np.ndarray:
        """Per-trial outcomes from the serial C++ oracle (``csrc/``, via
        the port's ``native``).  A missing or broken native build raises.
        The C++ oracle has no VA-space memmap model, so a memmap kernel's
        oracle is its dense scan, as the reference's."""
        if self.memmap is not None:
            return self.run_batch(faults).cpu().numpy()
        f = [x.cpu().numpy() for x in faults]
        return native.golden_trials(self.trace, *f,
                                    self.shadow_cov.cpu().numpy(),
                                    compare_regs=self.cfg.compare_regs)

    # --- the campaign unit --------------------------------------------------

    def strata_of(self, faults: Fault, structure: str) -> torch.Tensor:
        """Stratum ids for the post-stratified estimator: fault-cycle
        octiles for regfile, the struck µop's OpClass otherwise."""
        if structure == "regfile":
            return torch.clamp(faults.cycle.to(torch.int64) * N_STRATA
                               // max(self.trace.n, 1), 0, N_STRATA - 1)
        entry = torch.clamp(faults.entry.to(torch.int64), 0,
                            self.trace.n - 1)
        return torch.clamp(self._opclass[entry.to(self._opclass.device)],
                           0, N_STRATA - 1)

    def _outcomes_device(self, keys: torch.Tensor, structure: str):
        """Keys → (outcomes int32[B], faults, n_unresolved) on this
        kernel's device: the core of the budgeted tallies.  The fast pass
        runs on every lane; the first ``cfg.escape_budget`` escaped or
        overflowed lanes, in index order, are re-run through the dense
        scan and written back, and lanes beyond the budget count as SDC.
        Only the picked lanes are re-run, so no filler lane is written
        (the reference pads its fixed-size pick with an out-of-range index
        that its scatter drops)."""
        faults = self.sample_batch(keys, structure)
        if self.cfg.replay_kernel == "dense" or self.memmap is not None:
            # memmap (VA-trap) semantics exist only in the dense scan
            return (self.run_batch(faults), faults,
                    torch.zeros((), dtype=torch.int32, device=self.device))
        res = self.taint_fast(faults, may_latch=structure == "latch")
        unresolved = res.escaped | res.overflow
        n_unres = unresolved.sum().to(torch.int32)
        out = torch.where(unresolved, C.OUTCOME_SDC,
                          res.outcome).to(torch.int32)
        budget = min(self.cfg.escape_budget, int(keys.shape[0]))
        if self.cfg.replay_kernel == "hybrid" and budget:
            # the escaped lanes, compacted for the exact re-run
            with host_sync("escape-rerun"):
                idx = torch.nonzero(unresolved).flatten()[:budget]
            if idx.numel():
                out[idx] = self.run_batch(faults.index(idx))
        return out, faults, n_unres

    def run_keys_device(self, keys: torch.Tensor, structure: str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys → (tally int32[N_OUTCOMES], n_unresolved), both on the
        CPU; see ``_outcomes_device``."""
        tally, n_unres = self.tally_on_device(keys, structure)
        return tally.cpu(), n_unres.cpu()

    def run_keys_stratified(self, keys: torch.Tensor, structure: str
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys → ((N_STRATA, N_OUTCOMES) tally, n_unresolved), both on
        the CPU; the same outcomes as ``run_keys_device`` (summing over
        strata gives its tally)."""
        tally, n_unres = self.tally_on_device(keys, structure,
                                              stratified=True)
        return tally.cpu(), n_unres.cpu()

    def tally_on_device(self, keys: torch.Tensor, structure: str,
                        stratified: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The budgeted tally left on this kernel's device: (int32
        (N_OUTCOMES,) tally, or (N_STRATA, N_OUTCOMES) when
        ``stratified``, and the int32 unresolved count), for the interval
        and until-CI steps to accumulate there; ``run_keys_device`` and
        ``run_keys_stratified`` copy the same tensors to the host."""
        out, faults, n_unres = self._outcomes_device(keys, structure)
        if stratified:
            return (C.tally_stratified(out, self.strata_of(faults, structure),
                                       N_STRATA), n_unres)
        return C.tally(out), n_unres

    def run_keys_traceable(self, keys: torch.Tensor, structure: str
                           ) -> torch.Tensor:
        """Keys → tally through the budgeted path, for any
        ``replay_kernel`` (the reference's name for it)."""
        return self.run_keys_device(keys, structure)[0]

    def run_keys(self, keys: torch.Tensor, structure: str) -> torch.Tensor:
        """Per-trial keys → outcome tally int32[N_OUTCOMES] (on the CPU).
        "taint" counts unresolved lanes as SDC; "hybrid" resolves them
        all, whatever their number."""
        mode = self.cfg.replay_kernel
        faults = self.sample_batch(keys, structure)
        if mode == "dense":
            out = self.run_batch(faults).cpu().numpy()
        elif mode == "taint":
            res = self.taint_fast(faults, may_latch=structure == "latch")
            unresolved = (res.escaped | res.overflow).cpu().numpy()
            out = res.outcome.cpu().numpy().copy()
            out[unresolved] = C.OUTCOME_SDC
            self.escapes += int(unresolved.sum())
            self.taint_trials += len(out)
        else:
            out = self.run_batch_hybrid(faults,
                                        may_latch=structure == "latch")
        return torch.as_tensor(
            np.bincount(out, minlength=C.N_OUTCOMES).astype(np.int32))
