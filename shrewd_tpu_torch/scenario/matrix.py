"""Scenario matrices: one declarative plan → a cross-product tenant set.

The reference's headline artifact is a *campaign driver* that sweeps
workloads through candidate microarchitectures one gem5 process per
point (``x86_spec/x86-spec-cpu2017.py``).  A ``ScenarioMatrix`` is the
fleet-native form of that sweep: declarative axes —

- **workloads**   named windows (each a list of SimPoint specs, the
  plan's ``simpoints`` documents verbatim);
- **targets**     fault structures spanning every validated model family
  ({O3 regfile/ROB/IQ/LSQ, latch, cache:*, mesi:*, noc:router});
- **schemes**     protection options (the ``search/protect.py`` Scheme
  fields as a dict: detect/correct/area, optional outcome-conditioned
  detection);
- **thermal**     die-temperature envelopes feeding Arrhenius-scaled
  fault *rates* (``models/noc.temperature_factor``); only NoC cells bake
  the temperature into the plan (the flit fault-type mix shifts with
  it) — for every other family the envelope scales the analysis rate,
  never the campaign, so envelope-mates share executables;

— that ``expand()`` deterministically flattens into cells, each cell one
``TenantSpec`` for the resident fleet (``service/scheduler.py``).

Determinism contracts (pinned in ``tests/test_scenario.py``):

- **Stable cell names**: ``<tag>.<workload>.<window>.<target>.<scheme>.
  <thermal>`` (sanitized) — the cell name is the tenant identity, the
  checkpoint namespace, and the Pareto provenance key, so expansion
  order and naming may never drift between processes.
- **Shared measurement seeds**: a cell's campaign seed derives from its
  *measurement* coordinates (workload, window, target) only — scheme-
  and thermal-mates replay the same frozen PRNG keys over the same
  window content, so their raw tallies are directly comparable, the
  cells on one window share one kernel through the content-keyed
  registry (no new kernel for a cell sharing a window), and the
  scheme/thermal axes cost only the analytic fold, exactly the economy
  ``search/protect`` is built on.
- **Coherence collapse**: plan-level targets (``mesi:*``/``noc:*``)
  measure plan-level synthetic traffic independent of any window, so
  the workload×window axes collapse to the reserved ``coherence`` cell
  coordinate — one cell per (target, scheme, thermal), never one per
  window (which would multiply identical campaigns).

Per-axis scheduling inheritance: any axis entry may carry ``priority``
(summed across axes), ``weight`` (multiplied), and ``quota_batches``
(tightest non-zero wins) — e.g. de-weight an expensive scheme so its
cells trail the cheap ones and the Pareto prune can kill them early.

Port of ``shrewd_tpu/scenario/matrix.py``.  Host only: a matrix is
pure data, and device work starts when the scheduler elaborates a
cell's plan.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple

from shrewd_tpu_torch.service.queue import TenantSpec, sanitize

MATRIX_SCHEMA = 1

#: the collapsed workload/window coordinate of plan-level (mesi:/noc:)
#: cells — matches campaign/plan.py COHERENCE_SP_NAME by design (the
#: orchestrator reports those tiers under the same pseudo-simpoint)
COHERENCE = "coherence"

_PLAN_LEVEL = ("mesi", "noc")

#: structure names a matrix may target (kept in sync with
#: models/o3.STRUCTURES + plan.TIER_STRUCTURES; re-validated against the
#: real tables at expand time via campaign.plan on first elaboration)
KNOWN_TARGETS = (
    "regfile", "fu", "rob", "iq", "lsq", "latch",
    "cache:data", "cache:tag", "cache:state",
    "mesi:state", "mesi:tag", "noc:router",
)


def _is_plan_level(target: str) -> bool:
    return target.split(":", 1)[0] in _PLAN_LEVEL


def cell_seed(base_seed: int, workload: str, window: str,
              target: str) -> int:
    """Deterministic campaign seed from the MEASUREMENT coordinates only
    (scheme/thermal excluded — see module docstring): crc32 keeps it
    stable across processes, platforms and matrix edits."""
    h = zlib.crc32(f"{base_seed}|{workload}|{window}|{target}".encode())
    return int(h & 0x7FFFFFFF)


def default_bits(target: str, plan: dict) -> int:
    """Storage-size proxy (bits) for one fault target, read from the
    cell's own plan document — the ``StructureProfile.bits`` the Pareto
    fold uses for fault-rate and area weighting.  Deliberately simple,
    deterministic formulas (the reference's per-structure entry counts
    scaled to bits); override per target-axis entry with ``bits`` when a
    design has real numbers."""
    machine = plan.get("machine") or {}
    rob = int(machine.get("rob_size", 192))
    iw = int(machine.get("issue_width", 8))
    sp0 = (plan.get("simpoints") or [{}])[0]
    nphys = int(((sp0.get("workload")) or {}).get("nphys", 64))
    cache = plan.get("cache") or {}
    c_sets = int(cache.get("n_sets", 64))
    c_ways = int(cache.get("n_ways", 4))
    c_words = int(cache.get("words_per_line", 8))
    mesi = plan.get("mesi") or {}
    m_cores = int(mesi.get("n_cores", 2))
    m_sets = int(mesi.get("n_sets", 4))
    m_ways = int(mesi.get("n_ways", 2))
    m_tag = int(mesi.get("tag_bits", 16))
    noc = plan.get("noc") or {}
    n_routers = int(noc.get("mesh_x", 2)) * int(noc.get("mesh_y", 2))
    vcs = int(noc.get("vcs_per_vnet", 4)) * int(noc.get("n_vnets", 3))
    flit = int(noc.get("flit_bits", 128))
    bufs = (int(noc.get("vcs_per_vnet", 4))
            * int(noc.get("buffers_per_data_vc", 4))
            + (vcs - int(noc.get("vcs_per_vnet", 4)))
            * int(noc.get("buffers_per_ctrl_vc", 1)))
    table = {
        "regfile": nphys * 32,
        "fu": iw * 128,                    # FU logic-area proxy
        "rob": rob * 8,                    # dst-index metadata per entry
        "iq": (rob // 2) * 16,             # 2 src indices per IQ entry
        "lsq": (rob // 4) * 48,            # addr+data per LSQ entry
        "latch": iw * 96,                  # inter-stage pipeline latches
        "cache:data": c_sets * c_ways * c_words * 32,
        "cache:tag": c_sets * c_ways * 20,
        "cache:state": c_sets * c_ways * 4,
        # L1 state/tag arrays per core + the directory's copy (the
        # sharers vector is the "+2"): mirrors models/mesi geometry
        "mesi:state": m_cores * m_sets * m_ways * 4
                      + m_sets * m_ways * (m_cores + 2),
        "mesi:tag": (m_cores + 1) * m_sets * m_ways * m_tag,
        # 5-port mesh router, one data-class vnet — a simplified
        # models/noc._geom_bits (buffer SRAM dominates, as there)
        "noc:router": n_routers * 5 * flit * bufs,
    }
    return int(table[target])


def _norm_entry(e, axis: str) -> dict:
    """Axis entries may be bare names (targets) or dicts; normalize to a
    dict with a ``name``."""
    if isinstance(e, str):
        e = {"name": e}
    if not isinstance(e, dict) or not e.get("name"):
        raise ValueError(f"{axis} entry needs a name: {e!r}")
    return dict(e)


def _validate_scheme(s: dict) -> dict:
    det = float(s.get("detect", 0.0))
    cor = float(s.get("correct", 0.0))
    area = float(s.get("area", 1.0))
    for d in (det, s.get("detect_sdc"), s.get("detect_due")):
        if d is None:
            continue
        if not (0.0 <= float(d) and 0.0 <= cor
                and float(d) + cor <= 1.0):
            raise ValueError(
                f"scheme {s['name']!r}: need detect+correct in [0,1]")
    if area < 1.0:
        raise ValueError(f"scheme {s['name']!r}: area multiplier < 1")
    return s


class Cell(NamedTuple):
    """One expanded matrix cell = one fleet tenant."""

    name: str            # stable tenant identity (see module docstring)
    workload: str
    window: str          # simpoint name (COHERENCE for mesi:/noc: cells)
    target: str          # fault structure
    scheme: dict         # protection-scheme document
    thermal: dict        # {"name", "temperature_c", ...}
    plan: dict           # the cell's full CampaignPlan document
    priority: int
    weight: float
    quota_batches: int
    bits: int            # StructureProfile storage proxy
    fit_per_bit: float

    @property
    def prune_group(self) -> tuple:
        """Cells comparable under Pareto domination: scheme-mates over
        one measurement (same raw distribution, same frozen keys)."""
        return (self.workload, self.window, self.target,
                self.thermal["name"])

    @property
    def system_group(self) -> tuple:
        """Cells composing one system design point: every target of one
        (workload, window, thermal) — the DesignSpace fit group."""
        return (self.workload, self.window, self.thermal["name"])

    def spec(self) -> TenantSpec:
        return TenantSpec(name=self.name, plan=self.plan,
                          priority=self.priority, weight=self.weight,
                          quota_batches=self.quota_batches)

    def build_plan(self):
        from shrewd_tpu_torch.campaign.plan import CampaignPlan

        return CampaignPlan.from_dict(self.plan)

    def to_dict(self) -> dict:
        return {"name": self.name, "workload": self.workload,
                "window": self.window, "target": self.target,
                "scheme": dict(self.scheme),
                "thermal": dict(self.thermal),
                "priority": self.priority, "weight": self.weight,
                "quota_batches": self.quota_batches, "bits": self.bits,
                "fit_per_bit": self.fit_per_bit}


class ScenarioMatrix:
    """The declarative cross-product plan (see module docstring)."""

    def __init__(self, tag: str, workloads: list, targets: list,
                 schemes: list, thermal: list | None = None,
                 base: dict | None = None, seed: int = 0,
                 fit_per_bit: float = 1.0e-3, sdc_target: float = 0.0,
                 tenant: dict | None = None):
        if not tag:
            raise ValueError("matrix needs a non-empty tag")
        self.tag = str(tag)
        self.seed = int(seed)
        self.fit_per_bit = float(fit_per_bit)
        self.sdc_target = float(sdc_target)
        self.base = dict(base or {})
        self.tenant = {"priority": 0, "weight": 1.0, "quota_batches": 0}
        self.tenant.update(tenant or {})
        self.workloads = [self._norm_workload(w) for w in workloads]
        self.targets = [_norm_entry(t, "target") for t in targets]
        self.schemes = [_validate_scheme(_norm_entry(s, "scheme"))
                        for s in schemes]
        self.thermal = [_norm_entry(t, "thermal") for t in (
            thermal or [{"name": "tnom"}])]
        for th in self.thermal:
            th.setdefault("temperature_c", 71.0)   # NoC baseline temp
        for t in self.targets:
            if t["name"] not in KNOWN_TARGETS:
                raise ValueError(f"unknown target {t['name']!r} "
                                 f"(known: {sorted(KNOWN_TARGETS)})")
        for axis, entries in (("workload", self.workloads),
                              ("target", self.targets),
                              ("scheme", self.schemes),
                              ("thermal", self.thermal)):
            if not entries:
                raise ValueError(f"matrix {self.tag!r}: empty {axis} axis")
            names = [e["name"] for e in entries]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate {axis} names: {names}")
        if (any(not _is_plan_level(t["name"]) for t in self.targets)
                and not any(w["simpoints"] for w in self.workloads)):
            # raised even when plan-level targets would still expand:
            # silently dropping the per-window coverage (a misspelled
            # or missing "simpoints" key) must never produce a matrix
            # that runs and emits an artifact anyway
            raise ValueError("per-window targets need at least one "
                             "workload simpoint")

    @staticmethod
    def _norm_workload(w) -> dict:
        w = _norm_entry(w, "workload")
        w["simpoints"] = [dict(s) for s in (w.get("simpoints") or [])]
        for s in w["simpoints"]:
            if not s.get("name"):
                raise ValueError(
                    f"workload {w['name']!r}: simpoint needs a name")
        return w

    # --- expansion --------------------------------------------------------

    def _inherit(self, *entries) -> tuple[int, float, int]:
        pri = int(self.tenant["priority"])
        weight = float(self.tenant["weight"])
        quotas = [int(self.tenant["quota_batches"])]
        for e in entries:
            pri += int(e.get("priority", 0))
            weight *= float(e.get("weight", 1.0))
            quotas.append(int(e.get("quota_batches", 0)))
        live = [q for q in quotas if q > 0]
        return pri, weight, (min(live) if live else 0)

    def _cell_plan(self, target: str, simpoint: dict | None,
                   thermal: dict, seed: int) -> dict:
        import copy

        plan = copy.deepcopy(self.base)
        plan["structures"] = [target]
        plan["simpoints"] = [dict(simpoint)] if simpoint else []
        plan["seed"] = seed
        if target.startswith("noc:"):
            # the flit fault-type mix is temperature-dependent, so NoC
            # cells bake the envelope into the plan; every other family
            # keeps one plan across envelopes (executables shared) and
            # the envelope scales only the analytic rate
            noc = dict(plan.get("noc") or {})
            noc["temperature_c"] = float(thermal["temperature_c"])
            plan["noc"] = noc
        return plan

    def _name(self, *parts: str) -> str:
        return ".".join(sanitize(p) for p in (self.tag,) + parts)

    def expand(self) -> list[Cell]:
        """The full deterministic cross-product, in axis order
        (workloads → windows → targets → schemes → thermal), coherence
        cells after the windowed ones — identical output for identical
        documents, every time (pinned)."""
        cells: list[Cell] = []
        per_win = [t for t in self.targets
                   if not _is_plan_level(t["name"])]
        coh = [t for t in self.targets if _is_plan_level(t["name"])]

        def emit(wl_name: str, win_name: str, tg: dict, sc: dict,
                 th: dict, simpoint: dict | None, *inherit_extra):
            target = tg["name"]
            seed = cell_seed(self.seed, wl_name, win_name, target)
            plan = self._cell_plan(target, simpoint, th, seed)
            pri, weight, quota = self._inherit(tg, sc, th,
                                               *inherit_extra)
            cells.append(Cell(
                name=self._name(wl_name, win_name, target, sc["name"],
                                th["name"]),
                workload=wl_name, window=win_name, target=target,
                scheme=dict(sc), thermal=dict(th), plan=plan,
                priority=pri, weight=weight, quota_batches=quota,
                bits=int(tg.get("bits") or default_bits(target, plan)),
                fit_per_bit=float(tg.get("fit_per_bit",
                                         self.fit_per_bit))))

        for wl in self.workloads:
            for sp in wl["simpoints"]:
                for tg in per_win:
                    for sc in self.schemes:
                        for th in self.thermal:
                            emit(wl["name"], sp["name"], tg, sc, th,
                                 sp, wl)
        for tg in coh:
            for sc in self.schemes:
                for th in self.thermal:
                    emit(COHERENCE, COHERENCE, tg, sc, th, None)
        names = [c.name for c in cells]
        if len(set(names)) != len(names):
            dup = sorted(n for n in set(names) if names.count(n) > 1)
            raise ValueError(f"cell-name collision after sanitize: {dup}")
        return cells

    def tenant_specs(self) -> list[TenantSpec]:
        return [c.spec() for c in self.expand()]

    # --- round trip -------------------------------------------------------

    def to_dict(self) -> dict:
        return {"schema": MATRIX_SCHEMA, "tag": self.tag,
                "seed": self.seed, "fit_per_bit": self.fit_per_bit,
                "sdc_target": self.sdc_target, "base": dict(self.base),
                "tenant": dict(self.tenant),
                "workloads": [dict(w) for w in self.workloads],
                "targets": [dict(t) for t in self.targets],
                "schemes": [dict(s) for s in self.schemes],
                "thermal": [dict(t) for t in self.thermal]}

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioMatrix":
        d = dict(d)
        schema = d.pop("schema", MATRIX_SCHEMA)
        if schema != MATRIX_SCHEMA:
            raise ValueError(f"matrix schema {schema} != {MATRIX_SCHEMA}")
        return cls(tag=d["tag"], workloads=d.get("workloads", []),
                   targets=d["targets"], schemes=d["schemes"],
                   thermal=d.get("thermal"), base=d.get("base"),
                   seed=d.get("seed", 0),
                   fit_per_bit=d.get("fit_per_bit", 1.0e-3),
                   sdc_target=d.get("sdc_target", 0.0),
                   tenant=d.get("tenant"))
