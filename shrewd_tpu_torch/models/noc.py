"""NoC (network-on-chip) fault model: per-router fault probabilities plus a
message-level fault-injection path for the coherence interconnect (the
port of ``shrewd_tpu/models/noc.py``).

Reference role: gem5's garnet ``FaultModel``
(src/mem/ruby/network/fault_model/FaultModel.hh:59-126, FaultModel.cc:136-276)
— a per-router probability calculator over ten variation-induced fault
types, scaled by temperature.

- The database lookup is a **parametric area model**: each fault type's
  per-cycle probability is proportional to the number of susceptible
  storage/logic bits implied by the declared router geometry, times a
  per-bit base rate, times an Arrhenius-style temperature factor clamped
  to [0, 125] °C (FaultModel.cc:189-201).  Computed on the host in float64
  (``FaultModel.fault_vectors``).
- On top of the calculator, a **message-level injection kernel**
  (``NocKernel``) routes the MESI tier's coherence traffic over an X-Y mesh
  and classifies per-(router, cycle, type) faults into the standard
  outcome taxonomy, batched over trials.  The four credit and allocation
  types run a flit/credit pipeline (``flit_sim``), which the reference
  runs as a ``lax.scan`` over cycles and the port as a torch step loop
  over cycles, vectorised over the lanes that carry those types.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.models.mesi import AccessTrace, MesiConfig, _first_true
from shrewd_tpu_torch.models.tier import TierKernel
from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.utils import prng
from shrewd_tpu_torch.utils.config import ConfigObject, Param
from shrewd_tpu_torch.utils.device import resolve as resolve_device

# fault-type indices (same ten categories as FaultModel.hh:71-84)
FT_DATA_FEW_BITS = 0      # data corruption: few bits of a flit
FT_DATA_ALL_BITS = 1      # data corruption: a whole flit
FT_FLIT_DUP = 2           # flit conservation: duplication
FT_FLIT_LOSS = 3          # flit conservation: loss or split
FT_MISROUTE = 4           # misrouting
FT_CREDIT_GEN = 5         # credit conservation: spurious credit
FT_CREDIT_LOSS = 6        # credit conservation: credit loss
FT_ALLOC_VC = 7           # erroneous VC allocation
FT_ALLOC_SW = 8           # erroneous switch allocation
FT_ARBITRATION = 9        # unfair arbitration
N_FAULT_TYPES = 10

FAULT_TYPE_NAMES = (
    "data_corruption__few_bits", "data_corruption__all_bits",
    "flit_conservation__flit_duplication", "flit_conservation__flit_loss_or_split",
    "misrouting", "credit_conservation__credit_generation",
    "credit_conservation__credit_loss", "erroneous_allocation__VC",
    "erroneous_allocation__switch", "unfair_arbitration",
)

# stratum class per fault type (post-stratified tallies,
# run_keys_stratified): data / flit-conservation / misroute / credit /
# allocation+arbitration.  Keyed by the FT_* constants so adding or
# reordering a type without classifying it fails at import, not by a
# silent clamped gather.
_TYPE_CLASS = {FT_DATA_FEW_BITS: 0, FT_DATA_ALL_BITS: 0,
               FT_FLIT_DUP: 1, FT_FLIT_LOSS: 1,
               FT_MISROUTE: 2,
               FT_CREDIT_GEN: 3, FT_CREDIT_LOSS: 3,
               FT_ALLOC_VC: 4, FT_ALLOC_SW: 4, FT_ARBITRATION: 4}
TYPE_CLASS_TABLE = np.array([_TYPE_CLASS[t] for t in range(N_FAULT_TYPES)],
                            np.int32)
N_TYPE_CLASSES = int(TYPE_CLASS_TABLE.max()) + 1

# per-bit base probability of an upset per cycle at the baseline
# temperature, by susceptibility class.  The absolute scale is arbitrary
# (the reference's database is likewise unitless per-cycle probability);
# what the model preserves is the *relative* structure: SRAM buffer cells
# dominate, control FSM bits are rarer, combinational logic rarer still.
_RATE_SRAM = 1e-12        # buffer storage cells
_RATE_FSM = 3e-13         # sequential control state (credits, allocator)
_RATE_LOGIC = 1e-13       # combinational (route compute, arbiter muxes)

BASELINE_TEMPERATURE_C = 71.0     # FaultModel.hh:45
_TEMP_SCALE_C = 18.0              # e-fold per 18 °C (Arrhenius-like slope)


def fault_type_to_string(idx: int) -> str:
    return FAULT_TYPE_NAMES[idx]


class NocConfig(ConfigObject):
    """X-Y mesh interconnect geometry (garnet-style parameters)."""

    mesh_x = Param(int, 2, "mesh columns")
    mesh_y = Param(int, 2, "mesh rows")
    n_vnets = Param(int, 3, "virtual networks (req/fwd/resp)")
    vcs_per_vnet = Param(int, 4, "virtual channels per vnet")
    buffers_per_data_vc = Param(int, 4, "flit buffers per data VC")
    buffers_per_ctrl_vc = Param(int, 1, "flit buffers per control VC")
    flit_bits = Param(int, 128, "bits per flit")
    temperature_c = Param(float, BASELINE_TEMPERATURE_C, "die temperature")

    def validate(self) -> None:
        if self.mesh_x < 1 or self.mesh_y < 1:
            raise ValueError("mesh dims must be >= 1")

    @property
    def n_routers(self) -> int:
        return self.mesh_x * self.mesh_y


class RouterGeom(NamedTuple):
    """One router's declared geometry (FaultModel::declare_router args)."""

    n_inputs: int
    n_outputs: int
    vcs_per_vnet: int
    n_vnets: int
    buffers_per_data_vc: int
    buffers_per_ctrl_vc: int
    flit_bits: int


def _geom_bits(g: RouterGeom) -> np.ndarray:
    """Susceptible-bit counts per fault type for one router geometry.

    data faults ∝ buffer SRAM bits; flit-conservation and credit faults ∝
    per-VC sequential state; misrouting ∝ route-compute logic; allocation
    and arbitration ∝ allocator/arbiter state.  One data vnet carries wide
    buffers; the remaining vnets are control-sized (the reference makes the
    same data/ctrl VC split in its conf records, FaultModel.hh:88-95)."""
    vcs = g.vcs_per_vnet * g.n_vnets
    data_vcs = g.vcs_per_vnet                 # one data-class vnet
    ctrl_vcs = vcs - data_vcs
    buf_bits = g.n_inputs * g.flit_bits * (
        data_vcs * g.buffers_per_data_vc + ctrl_vcs * g.buffers_per_ctrl_vc)
    vc_state = g.n_inputs * vcs * 8           # per-VC FSM + pointers
    credit_bits = g.n_outputs * vcs * 4       # credit counters
    route_logic = g.n_inputs * max(1, g.n_outputs).bit_length() * 4
    alloc_state = (g.n_inputs * vcs) + (g.n_inputs * g.n_outputs)
    arb_state = g.n_outputs * vcs             # round-robin priority
    return np.array([
        buf_bits * 0.75,          # few-bit data corruption
        buf_bits * 0.25,          # whole-flit corruption (clustered upset)
        vc_state * 0.5,           # duplication (read-pointer state)
        vc_state * 0.5,           # loss/split (write-pointer state)
        route_logic,              # misrouting
        credit_bits * 0.5,        # spurious credit
        credit_bits * 0.5,        # credit loss
        alloc_state * 0.6,        # VC allocation
        alloc_state * 0.4,        # switch allocation
        arb_state,                # unfair arbitration
    ], dtype=np.float64)


_CLASS_RATE = np.array([
    _RATE_SRAM, _RATE_SRAM, _RATE_FSM, _RATE_FSM, _RATE_LOGIC,
    _RATE_FSM, _RATE_FSM, _RATE_FSM, _RATE_FSM, _RATE_LOGIC,
], dtype=np.float64)


def temperature_factor(temp_c) -> np.ndarray:
    """Arrhenius-style acceleration, clamped to the reference's supported
    [0, 125] °C range (out-of-range queries clamp rather than fail, the
    same recovery FaultModel.cc:189-201 applies).  float64 throughout: the
    per-type probabilities are ~1e-7/cycle, below float32's epsilon around
    1.0, so the union 1-∏(1-p) would round to zero in single precision."""
    t = np.clip(np.asarray(temp_c, np.float64), 0.0, 125.0)
    return np.exp((t - BASELINE_TEMPERATURE_C) / _TEMP_SCALE_C)


class FaultModel:
    """Per-router fault-probability calculator (garnet FaultModel parity).

    Routers are declared with their geometry (heterogeneous meshes are
    fine); queries are vectorized over routers and temperatures."""

    def __init__(self) -> None:
        self._geoms: list[RouterGeom] = []
        self._base: np.ndarray | None = None     # (R, 10) at baseline temp

    def declare_router(self, n_inputs: int, n_outputs: int,
                       vcs_per_vnet: int, buffers_per_data_vc: int,
                       buffers_per_ctrl_vc: int, n_vnets: int = 3,
                       flit_bits: int = 128) -> int:
        """Returns the router id (FaultModel.cc:136-146 contract; invalid
        geometry raises instead of fatal())."""
        if min(n_inputs, n_outputs, vcs_per_vnet) < 1 or min(
                buffers_per_data_vc, buffers_per_ctrl_vc) < 1:
            raise ValueError("declare_router: non-positive geometry")
        self._geoms.append(RouterGeom(n_inputs, n_outputs, vcs_per_vnet,
                                      n_vnets, buffers_per_data_vc,
                                      buffers_per_ctrl_vc, flit_bits))
        self._base = None
        return len(self._geoms) - 1

    @classmethod
    def for_mesh(cls, cfg: NocConfig) -> "FaultModel":
        """Declare every router of an X-Y mesh (5-port interior routers,
        fewer ports on edges/corners — heterogeneity the reference's
        nearest-configuration matching also models)."""
        fm = cls()
        for y in range(cfg.mesh_y):
            for x in range(cfg.mesh_x):
                ports = 1 + (x > 0) + (x < cfg.mesh_x - 1) \
                          + (y > 0) + (y < cfg.mesh_y - 1)
                fm.declare_router(ports, ports, cfg.vcs_per_vnet,
                                  cfg.buffers_per_data_vc,
                                  cfg.buffers_per_ctrl_vc,
                                  n_vnets=cfg.n_vnets,
                                  flit_bits=cfg.flit_bits)
        return fm

    @property
    def n_routers(self) -> int:
        return len(self._geoms)

    def _baseline(self) -> np.ndarray:
        if self._base is None:
            rows = [_geom_bits(g) * _CLASS_RATE for g in self._geoms]
            self._base = np.stack(rows) if rows else np.zeros((0, 10))
        return self._base

    def fault_vectors(self, temp_c=BASELINE_TEMPERATURE_C) -> np.ndarray:
        """(R, 10) per-cycle fault probabilities for every router at once;
        ``temp_c`` may be a scalar or a per-router (R,) vector.  Computed
        host-side in float64 (see temperature_factor)."""
        base = self._baseline()
        f = np.broadcast_to(np.atleast_1d(temperature_factor(temp_c)),
                            (self.n_routers,))
        return base * f[:, None]

    def fault_vector(self, router_id: int,
                     temp_c=BASELINE_TEMPERATURE_C) -> np.ndarray:
        return self.fault_vectors(temp_c)[router_id]

    def fault_prob(self, router_id: int,
                   temp_c=BASELINE_TEMPERATURE_C) -> float:
        """Aggregate per-cycle fault probability (any type) for one router:
        1 - ∏(1 - p_i), the exact union rather than the reference's sum."""
        v = self.fault_vector(router_id, temp_c)
        return float(1.0 - np.prod(1.0 - v))

    def aggregate_prob(self, temp_c=BASELINE_TEMPERATURE_C) -> float:
        """Whole-network per-cycle fault probability."""
        v = np.asarray(self.fault_vectors(temp_c), np.float64)
        return float(1.0 - np.prod(1.0 - v))

    def mtbf_cycles(self, temp_c=BASELINE_TEMPERATURE_C) -> float:
        p = self.aggregate_prob(temp_c)
        return math.inf if p <= 0 else 1.0 / p

    def summary(self) -> str:
        lines = [f"FaultModel: {self.n_routers} routers"]
        for r in range(self.n_routers):
            v = self.fault_vector(r)
            lines.append(f"  router {r}: aggregate/cycle "
                         f"{self.fault_prob(r):.3e} "
                         f"(max type {FAULT_TYPE_NAMES[int(v.argmax())]})")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# message-level injection over the MESI tier's traffic
# --------------------------------------------------------------------------

# message kinds
MSG_REQ = 0          # L1 → home L2 request (GETS/GETX): control
MSG_RESP = 1         # home L2 → L1 data response: data for a load/store miss
MSG_WB = 2           # L1 → home L2 writeback (dirty eviction): data


class MessageTrace(NamedTuple):
    """Golden coherence traffic flattened to host arrays.

    ``route`` holds the router ids each message traverses (X-Y dimension-
    order routing), padded with -1; message m occupies ``route[m, h]`` at
    cycle ``depart[m] + h``.  Outcomes depend only on the message *kind*:
    both load- and store-miss responses carry line data whose corruption
    is architecturally consumed (the store overwrites at most its own
    word; the rest of the fill stays live), so no per-access metadata is
    kept."""

    kind: np.ndarray      # int32[M]
    route: np.ndarray     # int32[M, H] router ids, -1 padded
    hops: np.ndarray      # int32[M]
    depart: np.ndarray    # int32[M] network-entry cycle


def _xy_route(src: int, dst: int, mesh_x: int) -> list[int]:
    """Dimension-order (X then Y) route, inclusive of both endpoints."""
    sx, sy = src % mesh_x, src // mesh_x
    dx, dy = dst % mesh_x, dst // mesh_x
    path = [src]
    x, y = sx, sy
    while x != dx:
        x += 1 if dx > x else -1
        path.append(y * mesh_x + x)
    while y != dy:
        y += 1 if dy > y else -1
        path.append(y * mesh_x + x)
    return path


def build_message_trace(trace: AccessTrace, mesi_cfg: MesiConfig,
                        noc_cfg: NocConfig,
                        cycles_per_access: int = 4) -> MessageTrace:
    """Replay the private-L1 hit/miss behavior of ``trace`` (same geometry
    as the MESI tier) and emit the golden request/response/writeback
    traffic.  Cores sit at routers 0..n_cores-1; a line's home L2 slice is
    address-interleaved across all routers (the standard S-NUCA layout)."""
    mesi_cfg.validate()
    noc_cfg.validate()
    core = np.asarray(trace.core)
    word = np.asarray(trace.word)
    is_store = np.asarray(trace.is_store)
    wpl = mesi_cfg.words_per_line
    n_routers = noc_cfg.n_routers
    if mesi_cfg.n_cores > n_routers:
        raise ValueError("more cores than mesh routers")

    # per-core set-associative LRU directory of resident lines
    tags = np.full((mesi_cfg.n_cores, mesi_cfg.n_sets, mesi_cfg.n_ways), -1,
                   np.int64)
    dirty = np.zeros_like(tags, dtype=bool)
    lru = np.zeros_like(tags)
    tick = 0

    kind, routes, depart = [], [], []

    def emit(k, src, dst, cyc):
        kind.append(k)
        routes.append(_xy_route(src, dst, noc_cfg.mesh_x))
        depart.append(cyc)

    for a in range(len(core)):
        c = int(core[a])
        line = int(word[a]) // wpl
        s = line % mesi_cfg.n_sets
        t = line // mesi_cfg.n_sets
        cyc = a * cycles_per_access
        home = line % n_routers
        ways = tags[c, s]
        hit = np.nonzero(ways == t)[0]
        tick += 1
        if hit.size:
            w = int(hit[0])
        else:
            w = int(lru[c, s].argmin())
            if tags[c, s, w] >= 0 and dirty[c, s, w]:
                emit(MSG_WB, c, int(tags[c, s, w] * mesi_cfg.n_sets + s)
                     % n_routers, cyc)
            emit(MSG_REQ, c, home, cyc)
            emit(MSG_RESP, home, c, cyc + 1)
            tags[c, s, w] = t
            dirty[c, s, w] = False
        if is_store[a]:
            dirty[c, s, w] = True
        lru[c, s, w] = tick

    if not kind:       # all-hit stream: one NOP message keeps shapes static
        emit(MSG_REQ, 0, 0, 0)
    hops = np.array([len(r) for r in routes], np.int32)
    H = int(hops.max())
    route = np.full((len(routes), H), -1, np.int32)
    for m, r in enumerate(routes):
        route[m, :len(r)] = r
    return MessageTrace(
        kind=np.asarray(kind, np.int32), route=route, hops=hops,
        depart=np.asarray(depart, np.int32))


class NocFault(NamedTuple):
    """A batch of trials, integer tensors of shape (B,): a fault of
    ``ftype`` at ``router`` on cycle ``cycle``.  ``vc`` selects the VC
    class for credit-level faults (flit/credit pipeline below);
    table-classified types ignore it."""

    router: torch.Tensor
    cycle: torch.Tensor
    ftype: torch.Tensor
    vc: torch.Tensor


# outcome of a fault type *given it hits a message*, by message kind.
# Rationale (docstring of NocKernel): data corruption of a consumed data
# payload is silent corruption; corrupted/lost/duplicated control and lost
# credits surface as protocol assertions or timeouts (DUE); misrouting and
# allocation/arbitration faults cost latency only (masked).
_HIT_OUTCOME = np.zeros((N_FAULT_TYPES, 3), np.int32)
_HIT_OUTCOME[FT_DATA_FEW_BITS] = (C.OUTCOME_DUE,   # malformed request
                                  C.OUTCOME_SDC, C.OUTCOME_SDC)
_HIT_OUTCOME[FT_DATA_ALL_BITS] = (C.OUTCOME_DUE,
                                  C.OUTCOME_SDC, C.OUTCOME_SDC)
_HIT_OUTCOME[FT_FLIT_DUP] = (C.OUTCOME_MASKED,     # TBE filters re-delivery
                             C.OUTCOME_MASKED, C.OUTCOME_MASKED)
_HIT_OUTCOME[FT_FLIT_LOSS] = (C.OUTCOME_DUE,       # timeout on every kind
                              C.OUTCOME_DUE, C.OUTCOME_DUE)
_HIT_OUTCOME[FT_MISROUTE] = (C.OUTCOME_MASKED,) * 3
_HIT_OUTCOME[FT_CREDIT_GEN] = (C.OUTCOME_MASKED,) * 3
_HIT_OUTCOME[FT_CREDIT_LOSS] = (C.OUTCOME_DUE,) * 3   # starves → deadlock
_HIT_OUTCOME[FT_ALLOC_VC] = (C.OUTCOME_MASKED,) * 3
_HIT_OUTCOME[FT_ALLOC_SW] = (C.OUTCOME_MASKED,) * 3
_HIT_OUTCOME[FT_ARBITRATION] = (C.OUTCOME_MASKED,) * 3


class NocKernel(TierKernel):
    """Campaign-facing NoC fault-injection kernel on ``device`` (None: the
    CUDA card), with the campaign protocol of ``models/tier.py``
    (structure ``"router"``).

    A trial samples (router, cycle, fault type) — router weighted
    uniformly, type weighted by the FaultModel's per-router probabilities
    at the configured temperature — and classifies it against the golden
    message trace: a fault that coincides with no traversing message is
    masked; otherwise the (type, message-kind) table above maps it to
    masked/SDC/DUE.  The four ``PIPELINE_TYPES`` instead take the outcome
    of the flit/credit pipeline.  The reference runs the pipeline on every
    lane and discards it for the others; here it runs on the pipeline
    lanes alone, compacted (``torch.nonzero``, one host sync, counted in
    ``host_syncs``), and their outcomes are scattered back."""

    default_structure = "router"

    def __init__(self, msgs: MessageTrace, noc_cfg: NocConfig,
                 fault_model: FaultModel | None = None, device=None):
        noc_cfg.validate()
        self.cfg = noc_cfg
        self.msgs = msgs
        self.device = resolve_device(device)
        self.fm = fault_model or FaultModel.for_mesh(noc_cfg)
        self.n_cycles = int(np.asarray(msgs.depart).max()
                            + np.asarray(msgs.hops).max() + 1)
        # per-router type distribution (normalized fault vector): float64
        # on the host, compared in float32 as the reference compares it
        fv = np.asarray(self.fm.fault_vectors(noc_cfg.temperature_c),
                        np.float64)
        self._type_cdf = torch.as_tensor(
            np.cumsum(fv / fv.sum(axis=1, keepdims=True),
                      axis=1).astype(np.float32), device=self.device)
        # flit/credit pipeline horizon: golden completion plus slack — a
        # faulted run still incomplete there is starved/deadlocked (DUE)
        gold_del, _ = scalar_flit_sim(msgs, noc_cfg, fault=None)
        if (gold_del < 0).any():
            raise RuntimeError("golden flit pipeline did not complete")
        self._horizon = int(gold_del.max() * 2 + 32)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)

        self._route, self._hops = dev(msgs.route), dev(msgs.hops)
        self._depart, self._kind = dev(msgs.depart), dev(msgs.kind)
        self._table = dev(_HIT_OUTCOME.reshape(-1))
        self._type_class = dev(TYPE_CLASS_TABLE)
        # the pipeline's own accounting: host syncs (the lane compaction
        # and the pipeline's quiescence checks), lanes, steps run
        self.host_syncs = 0
        self.pipeline_lanes = 0
        self.pipeline_steps = 0

    def _build_on(self, device) -> "NocKernel":
        return NocKernel(self.msgs, self.cfg, self.fm, device=device)

    def sample_batch(self, keys: torch.Tensor, structure: str = "router"
                     ) -> NocFault:
        """(B, 2) keys → a NocFault batch of int32 tensors on this
        kernel's device."""
        if structure != "router":
            raise ValueError(f"unknown NoC structure {structure!r}")
        ks = prng.split(keys.to(self.device), 4)
        r = prng.randint(ks[:, 0], 0, self.cfg.n_routers)
        cyc = prng.randint(ks[:, 1], 0, self.n_cycles)
        u = prng.uniform(ks[:, 2])
        ftype = (u[:, None] >= self._type_cdf[r.to(torch.int64)]).sum(dim=1)
        return NocFault(router=r, cycle=cyc,
                        ftype=torch.clamp(ftype, max=N_FAULT_TYPES - 1).to(
                            torch.int32),
                        vc=prng.randint(ks[:, 3], 0, N_VC))

    def outcomes_of_faults(self, f: NocFault,
                           structure: str | None = None) -> torch.Tensor:
        """Outcome classes int32[B] of a fault batch."""
        i64 = torch.int64
        route = self._route
        M, H = route.shape
        cyc = f.cycle.to(i64)
        router = f.router.to(i64)
        ftype = f.ftype.to(i64)
        # message m occupies route[m, h] at depart[m] + h
        h = cyc[:, None] - self._depart
        in_hop = (h >= 0) & (h < self._hops)
        hc = torch.clamp(h, 0, H - 1)
        at = route.reshape(-1)[torch.arange(M, device=self.device) * H + hc]
        hit = in_hop & (at == router[:, None])
        # first (lowest-index) hit message decides the outcome
        first = _first_true(hit)
        kind = self._kind[first]
        out = torch.where(hit.any(dim=1),
                          self._table[ftype * 3 + kind], C.OUTCOME_MASKED)
        # credit/VC/allocation faults: simulated on the flit pipeline —
        # starvation/deadlock and buffer-overflow corruption emerge from
        # the flow control instead of a static mapping
        is_pipe = torch.isin(ftype, torch.as_tensor(
            PIPELINE_TYPES, dtype=i64, device=self.device))
        lanes = torch.nonzero(is_pipe).flatten()
        self.host_syncs += 1
        if lanes.numel():
            sub = NocFault(*(x[lanes] for x in f))
            deliver, corrupt, steps, syncs = _flit_run(
                self.msgs, self.cfg, sub, self._horizon,
                tensors=(route, self._hops, self._depart, self._kind))
            self.pipeline_lanes += int(lanes.numel())
            self.pipeline_steps += steps
            self.host_syncs += syncs
            ok = deliver >= 0
            req = self._kind == MSG_REQ
            bad_req = (corrupt & req & ok).any(dim=1)
            bad_data = (corrupt & ~req & ok).any(dim=1)
            pipe = torch.where(
                (~ok).any(dim=1) | bad_req, C.OUTCOME_DUE,
                torch.where(bad_data, C.OUTCOME_SDC, C.OUTCOME_MASKED))
            out = out.index_put((lanes,), pipe)
        return out.to(torch.int32)

    def strata_of(self, faults: NocFault) -> torch.Tensor:
        """Fault-TYPE classes (data / flit-conservation / misroute /
        credit / allocation+arbitration): the outcome is largely
        type-determined, so within-stratum variance is small and the
        post-stratified CI tightens far faster than the pooled one."""
        return self._type_class[faults.ftype.to(torch.int64)]


# --------------------------------------------------------------------------
# flit/credit pipeline: credit- and VC-level faults simulated, not
# table-looked-up
# --------------------------------------------------------------------------
#
# An aggregated-VC-class wormhole model: two VC classes (REQ control /
# RESP+WB data — the protocol-deadlock split garnet's vnets exist for),
# per-(router, class) credit counters initialized to the class's aggregate
# buffer capacity, one-flit messages, dimension-order routes, lowest-index
# round-robin arbitration per (router, class) per cycle.  Reference
# analog: garnet's credit-based VC flow control
# (src/mem/ruby/network/garnet/Router.hh:74, CreditLink/flow control).
#
# Credit/VC faults then have *emergent* outcomes: a lost credit on a
# capacity-1 class starves every later message through that router
# (deadlock → DUE at the horizon); a spurious credit lets a flit advance
# into a full buffer and corrupt its resident (SDC/DUE by payload kind); a
# flipped VC allocation moves a message into the other class's credit pool;
# a perturbed switch allocation inverts one cycle's arbitration (usually
# latency-only → masked).

VC_REQ, VC_RESP = 0, 1
N_VC = 2
PIPELINE_TYPES = (FT_CREDIT_GEN, FT_CREDIT_LOSS, FT_ALLOC_VC, FT_ALLOC_SW)

_KIND_VC = np.array([VC_REQ, VC_RESP, VC_RESP], np.int32)  # REQ/RESP/WB


def _vc_caps(cfg: NocConfig) -> np.ndarray:
    return np.array([max(cfg.buffers_per_ctrl_vc, 1) * cfg.vcs_per_vnet,
                     max(cfg.buffers_per_data_vc, 1) * cfg.vcs_per_vnet],
                    np.int64)


def scalar_flit_sim(msgs: MessageTrace, cfg: NocConfig,
                    fault: "tuple | None" = None,
                    horizon: int | None = None):
    """Python oracle: → (deliver_cycle i64[M] (-1 if never), corrupt
    bool[M]).  ``fault`` = (router, cycle, ftype, vc) or None."""
    route = np.asarray(msgs.route)
    hops = np.asarray(msgs.hops)
    depart = np.asarray(msgs.depart)
    kind = np.asarray(msgs.kind)
    M = len(kind)
    caps = _vc_caps(cfg)
    R = cfg.n_routers
    credits = np.tile(caps, (R, 1)).astype(np.int64)
    occ = np.zeros((R, N_VC), np.int64)
    vc = _KIND_VC[kind].astype(np.int64).copy()
    pos = np.full(M, -1, np.int64)
    deliver = np.full(M, -1, np.int64)
    corrupt = np.zeros(M, bool)
    if horizon is None:
        horizon = int(depart.max() + hops.max() * 4 + M * 2 + 32)
    for t in range(horizon):
        if fault is not None and fault[1] == t:
            rf, _, ft, vcf = fault[0], fault[1], fault[2], fault[3]
            if ft == FT_CREDIT_LOSS:
                credits[rf, vcf] = max(credits[rf, vcf] - 1, 0)
            elif ft == FT_CREDIT_GEN:
                credits[rf, vcf] += 1
            elif ft == FT_ALLOC_VC:
                at = [m for m in range(M)
                      if pos[m] >= 0 and deliver[m] < 0
                      and route[m, pos[m]] == rf]
                if at:
                    vc[at[0]] ^= 1
        sw_here = (fault is not None and fault[1] == t
                   and fault[2] == FT_ALLOC_SW)
        pos[(pos < 0) & (depart <= t)] = 0
        # single-hop messages deliver at injection
        for m in range(M):
            if pos[m] == 0 and deliver[m] < 0 and hops[m] == 1:
                deliver[m] = t
        # arbitration: per (next router, vc class), one winner per cycle
        winners: dict[tuple, int] = {}
        order = list(range(M))
        for m in order:
            if pos[m] < 0 or deliver[m] >= 0 or pos[m] + 1 >= hops[m]:
                continue
            nr = int(route[m, pos[m] + 1])
            key = (nr, int(vc[m]))
            prefer_high = sw_here and nr == fault[0]
            if key not in winners:
                winners[key] = m
            elif prefer_high and m > winners[key]:
                winners[key] = m
        # batched cycle semantics (identical to the scan kernel): grant
        # decisions read the cycle-start credit snapshot; all deltas and
        # the overflow check apply at end of cycle, then deliveries drain
        snap = credits.copy()
        advanced = []
        for key, m in sorted(winners.items()):
            nr, v = key
            if snap[nr, v] <= 0:
                continue
            if pos[m] >= 1:
                lr = int(route[m, pos[m]])
                credits[lr, v] += 1
                occ[lr, v] -= 1
            credits[nr, v] -= 1
            occ[nr, v] += 1
            pos[m] += 1
            advanced.append((m, nr, v))
        # overflow corruption: any over-capacity pool clobbers residents
        for m2 in range(M):
            if pos[m2] >= 1 and deliver[m2] < 0:
                r2, v2 = int(route[m2, pos[m2]]), int(vc[m2])
                if occ[r2, v2] > caps[v2]:
                    corrupt[m2] = True
        for m, nr, v in advanced:
            if pos[m] == hops[m] - 1:
                deliver[m] = t
                credits[nr, v] += 1           # drain on delivery
                occ[nr, v] -= 1
    return deliver, corrupt

# cycles between the pipeline's quiescence checks (one host sync each)
QUIESCE_CHECK = 64


def flit_sim(msgs: MessageTrace, cfg: NocConfig, fault: NocFault,
             horizon: int):
    """The pipeline over a fault batch, on ``fault``'s device: a torch step
    loop over cycles, vectorised over the lanes → (deliver int64[B, M]
    (-1 if never), corrupt bool[B, M]), the reference's ``lax.scan``
    result."""
    deliver, corrupt, _steps, _syncs = _flit_run(msgs, cfg, fault, horizon)
    return deliver, corrupt


def _flit_run(msgs: MessageTrace, cfg: NocConfig, fault: NocFault,
              horizon: int, tensors=None):
    """``flit_sim`` → (deliver, corrupt, cycles run, host syncs).

    The loop may stop before ``horizon``: past the last injection and the
    last fault landing the machine changes state only when a message
    advances, and an advance always raises its position; so once the
    summed positions stand still over a check interval, no lane can move
    again and the remaining cycles would leave every output as it is."""
    i64 = torch.int64
    dev = fault.cycle.device
    if tensors is None:
        tensors = tuple(torch.as_tensor(np.asarray(x, np.int64), device=dev)
                        for x in (msgs.route, msgs.hops, msgs.depart,
                                  msgs.kind))
    route, hops, depart, kind = tensors
    M, H = route.shape
    R = cfg.n_routers
    B = int(fault.cycle.shape[0])
    rflat = route.reshape(-1)
    midx = torch.arange(M, device=dev)
    mrow = midx * H
    caps = torch.as_tensor(_vc_caps(cfg), device=dev).repeat(R)  # (R*N_VC,)
    fcyc = fault.cycle.to(i64)
    fr = torch.clamp(fault.router.to(i64), 0, R - 1)
    ft = fault.ftype.to(i64)
    slot_f = (fr * N_VC + torch.clamp(fault.vc.to(i64), 0, N_VC - 1))[:, None]
    loss, gen = ft == FT_CREDIT_LOSS, ft == FT_CREDIT_GEN
    vcflip, swflip = ft == FT_ALLOC_VC, ft == FT_ALLOC_SW
    rev = M - 1 - midx

    pos = torch.full((B, M), -1, dtype=i64, device=dev)
    deliver = torch.full((B, M), -1, dtype=i64, device=dev)
    corrupt = torch.zeros((B, M), dtype=torch.bool, device=dev)
    vc = torch.as_tensor(_KIND_VC, device=dev).to(i64)[kind].expand(
        B, M).clone()
    credits = caps.expand(B, R * N_VC).clone()
    occ = torch.zeros_like(credits)
    single = hops == 1
    last_event = int(depart.max()) if M else 0
    if B:
        last_event = max(last_event, int(fcyc.max()))
    syncs = 1
    moved = None
    t = -1
    for t in range(horizon):
        # ---- fault landing ----
        land = fcyc == t
        cur = credits.gather(1, slot_f).squeeze(1)
        credits.scatter_(1, slot_f, torch.where(
            land & loss, torch.clamp(cur - 1, min=0),
            torch.where(land & gen, cur + 1, cur))[:, None])
        here = rflat[mrow + torch.clamp(pos, min=0)]
        at_rf = (pos >= 0) & (deliver < 0) & (here == fr[:, None])
        first_at = torch.clamp(torch.where(at_rf, midx, M).min(dim=1).values,
                               max=M - 1)[:, None]
        v0 = vc.gather(1, first_at)
        vc.scatter_(1, first_at, torch.where(
            (land & vcflip & at_rf.any(dim=1))[:, None], v0 ^ 1, v0))
        # ---- injection + single-hop delivery ----
        pos = torch.where((pos < 0) & (depart <= t), 0, pos)
        deliver = torch.where((pos == 0) & (deliver < 0) & single, t,
                              deliver)
        # ---- arbitration: per (next router, vc class), one winner ----
        wants = (pos >= 0) & (deliver < 0) & (pos + 1 < hops)
        nr = rflat[mrow + torch.clamp(pos + 1, 0, H - 1)]
        key = torch.clamp(nr, 0, R - 1) * N_VC + vc
        idxv = torch.where((land & swflip)[:, None] & (nr == fr[:, None]),
                           rev, midx)
        tbl = torch.full((B, R * N_VC), M, dtype=i64, device=dev)
        tbl = tbl.scatter_reduce(1, key, torch.where(wants, idxv, M),
                                 reduce="amin", include_self=True)
        adv = (wants & (tbl.gather(1, key) == idxv)
               & (credits.gather(1, key) > 0))
        # ---- apply advances (``here`` is the message's current router:
        # injection only moves a position from -1 to 0) ----
        lslot = torch.clamp(here, 0, R - 1) * N_VC + vc
        rel = (adv & (pos >= 1)).to(i64)
        a = adv.to(i64)
        credits.scatter_add_(1, lslot, rel)
        occ.scatter_add_(1, lslot, -rel)
        credits.scatter_add_(1, key, -a)
        occ.scatter_add_(1, key, a)
        pos = pos + a
        # overflow corruption: any pool over capacity clobbers residents
        over = occ > caps
        in_pool = (pos >= 1) & (deliver < 0)
        corrupt |= in_pool & over.gather(1, torch.where(adv, key, lslot))
        # delivery drain
        done = adv & (pos == hops - 1)
        deliver = torch.where(done, t, deliver)
        d = done.to(i64)
        credits.scatter_add_(1, key, d)
        occ.scatter_add_(1, key, -d)
        if t >= last_event and (t + 1) % QUIESCE_CHECK == 0:
            total = int(pos.sum())
            syncs += 1
            if moved is not None and total == moved:
                break
            moved = total
    return deliver, corrupt, t + 1, syncs
