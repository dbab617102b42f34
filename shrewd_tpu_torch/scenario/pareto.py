"""The closed Pareto loop: live cell tallies → protection front → prune.

``search/protect.py`` evaluates protection *analytically* over measured
raw outcome distributions; before this module it ran post-hoc, over one
finished campaign.  Here the same algebra folds the fleet's **live**
per-cell tallies after scheduler ticks:

- every cell gets a *point*: its scheme's (area, SDC-rate) with
  conservative bounds — ``sdc_lo``/``sdc_hi`` bracket the rate the cell
  could still converge to, from a Wilson interval over the SDC count
  alone (the reported ``halfwidth`` stays the stopping rule's combined
  vulnerable-proportion estimator — see ``cell_point``);
- a still-running cell is **Pareto-dominated** when some *converged*
  scheme-mate (same measurement coordinates, ``Cell.prune_group``) is
  at least as good on both axes even against the runner's most
  optimistic bound — ``dom.area <= run.area`` and ``dom.sdc_hi <=
  run.sdc_lo`` with at least one strict — at which point its remaining
  service is withdrawn through the scheduler's journaled
  ``revoke_quota`` seam (status ``pruned``; the decision replays
  exactly after a hard kill because the journal record precedes any
  state change);
- converged cells re-fit ``StructureProfile``s per ``system_group``
  (workload × window × thermal) and ``DesignSpace.search`` emits the
  area-vs-system-SDC front over the full scheme assignment space —
  the reference's protection/area trade-off as a first-class campaign
  artifact (``PARETO_<tag>.json``, atomic).

Thermal envelopes enter as Arrhenius rate acceleration
(``models/noc.temperature_factor``) on ``fit_per_bit`` — hotter
envelopes weight the same raw distribution with a higher arrival rate
(and NoC cells additionally measured under the envelope's fault mix,
matrix.py).

Port of ``shrewd_tpu/scenario/pareto.py``: numpy algebra here; the
device enters through ``search/protect`` inside ``design_search``, on
the device it is given.
"""

from __future__ import annotations

import os

import numpy as np

from shrewd_tpu_torch.resilience import write_json_atomic
from shrewd_tpu_torch.scenario.matrix import Cell, ScenarioMatrix
from shrewd_tpu_torch.utils import debug

debug.register_flag("Scenario", "scenario matrix / Pareto closed loop")

PARETO_SCHEMA = 1


def artifact_path(outdir: str, tag: str) -> str:
    return os.path.join(outdir, f"PARETO_{tag}.json")


def thermal_factor(temp_c: float) -> float:
    """Arrhenius acceleration of the fault-arrival rate at one envelope
    (the models/noc curve — one definition, reused)."""
    from shrewd_tpu_torch.models.noc import temperature_factor

    return float(temperature_factor(temp_c))


def cell_point(cell: Cell, tallies, trials: int, halfwidth: float,
               converged: bool, status: str,
               confidence: float = 0.95) -> dict:
    """One cell's live design point: the protect.py scheme algebra over
    its (possibly unconverged) raw tally, with conservative SDC-rate
    bounds from an SDC-specific Wilson interval.

    ``halfwidth`` is reported as the cell's convergence distance (the
    stopping rule's estimator over the COMBINED vulnerable proportion)
    but is NOT what brackets ``sdc_lo``/``sdc_hi``: at a large DUE
    share the combined interval is narrower than the SDC proportion's
    own, so bounds borrowed from it would not contain the rate the cell
    could still converge to — breaking the domination guarantee.  The
    prune bounds therefore come from ``stopping.wilson`` over the SDC
    count alone (always a valid CI on ``p_sdc``, stratified or not).

    Mirrors ``DesignSpace`` exactly: arrival rate = fit_per_bit × bits ×
    thermal factor × area factor (protection bits are targets too);
    residual SDC uses the outcome-conditioned detection probability when
    the scheme carries one."""
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.parallel import stopping

    t = np.asarray(tallies, dtype=np.float64)
    n = float(max(trials, 1))
    p_sdc = float(t[C.OUTCOME_SDC]) / n
    p_due = float(t[C.OUTCOME_DUE]) / n
    hw = float(halfwidth)
    sc = cell.scheme
    d_sdc = float(sc.get("detect_sdc") if sc.get("detect_sdc") is not None
                  else sc.get("detect", 0.0))
    d_due = float(sc.get("detect_due") if sc.get("detect_due") is not None
                  else sc.get("detect", 0.0))
    cor = float(sc.get("correct", 0.0))
    areaf = float(sc.get("area", 1.0))
    tf = thermal_factor(float(cell.thermal["temperature_c"]))
    rate = cell.fit_per_bit * cell.bits * tf * areaf
    resid_sdc = max(0.0, 1.0 - d_sdc - cor)
    resid_due = max(0.0, 1.0 - d_due - cor)
    sdc = rate * resid_sdc * p_sdc
    iv = stopping.wilson(float(t[C.OUTCOME_SDC]), float(trials),
                         confidence)   # trials<=0 → [0, 1]
    return {
        "cell": cell.name, "status": status, "trials": int(trials),
        "converged": bool(converged), "halfwidth": hw,
        "tallies": np.asarray(tallies).astype(np.int64).tolist(),
        "p_sdc": p_sdc, "area": cell.bits * areaf,
        "sdc": sdc, "due": rate * resid_due * p_due,
        "sdc_lo": rate * resid_sdc * iv.lo,
        "sdc_hi": rate * resid_sdc * iv.hi,
        "thermal_factor": tf,
        "prune_group": list(cell.prune_group),
        "system_group": list(cell.system_group),
    }


def dominates(dom: dict, run: dict) -> bool:
    """Conservative Pareto domination: the converged point beats the
    running cell's *most optimistic* reachable position on both axes,
    strictly on at least one — the running cell can no longer earn a
    place on the front, whatever its remaining trials say."""
    if not (dom["area"] <= run["area"]
            and dom["sdc_hi"] <= run["sdc_lo"]):
        return False
    return dom["area"] < run["area"] or dom["sdc_hi"] < run["sdc_lo"]


#: tenant statuses a prune decision may still target (anything terminal
#: — complete/aborted/quota/quarantined/pruned — is past revoking)
_PRUNABLE = ("queued", "running")


def prune_decisions(cells: list[Cell], points: dict,
                    revoked: dict | None = None) -> list[dict]:
    """Deterministic prune set at the current tallies: for every
    still-prunable cell, the first converged prune-group mate (cell
    order — which is expansion order, stable) that dominates it.
    ``revoked`` maps already-revoked cell names (skipped: the journal,
    not this function, owns decisions already made)."""
    revoked = revoked or {}
    by_group: dict[tuple, list[Cell]] = {}
    for c in cells:
        by_group.setdefault(c.prune_group, []).append(c)
    out = []
    for c in cells:
        pt = points.get(c.name)
        if pt is None or c.name in revoked:
            continue
        if pt["status"] not in _PRUNABLE or pt["converged"]:
            continue
        for mate in by_group[c.prune_group]:
            if mate.name == c.name:
                continue
            mpt = points.get(mate.name)
            if mpt is None or not mpt["converged"]:
                continue
            if dominates(mpt, pt):
                out.append({"cell": c.name, "dominated_by": mate.name})
                break
    return out


def design_search(matrix: ScenarioMatrix, cells: list[Cell],
                  points: dict, device=None) -> dict:
    """Per system group (workload × window × thermal): re-fit
    ``StructureProfile``s from the converged cells and run the full
    ``DesignSpace`` assignment search — the area-vs-system-SDC front.

    Profile fit picks, per target, the converged cell with the most
    trials (scheme-mates share frozen keys, so any of them measures the
    same distribution; ties break on cell name).  Groups with no
    converged cell yet are skipped — the front grows as the matrix
    converges.  Each group's ``DesignSpace`` is built on ``device``
    (None resolves to the card)."""
    from shrewd_tpu_torch.search.protect import (DesignSpace, Scheme,
                                                 StructureProfile)

    schemes = [Scheme(name=s["name"],
                      detect=float(s.get("detect", 0.0)),
                      correct=float(s.get("correct", 0.0)),
                      area=float(s.get("area", 1.0)),
                      detect_sdc=s.get("detect_sdc"),
                      detect_due=s.get("detect_due"))
               for s in matrix.schemes]
    groups: dict[tuple, dict[str, Cell]] = {}
    for c in cells:
        pt = points.get(c.name)
        if pt is None or not pt["converged"]:
            continue
        best = groups.setdefault(c.system_group, {})
        cur = best.get(c.target)
        if cur is None or (points[cur.name]["trials"], cur.name) < (
                pt["trials"], c.name):
            best[c.target] = c
    out = {}
    for group, by_target in sorted(groups.items()):
        profiles = []
        provenance = {}
        for target in sorted(by_target):
            c = by_target[target]
            pt = points[c.name]
            tf = pt["thermal_factor"]
            profiles.append(StructureProfile.from_tally(
                target, c.bits, pt["tallies"],
                fit_per_bit=c.fit_per_bit * tf,
                halfwidth=pt["halfwidth"]))
            provenance[target] = c.name
        ds = DesignSpace(profiles, schemes=schemes, device=device)
        target_rate = (matrix.sdc_target if matrix.sdc_target > 0
                       else float("inf"))
        res = ds.search(target_rate)
        out["/".join(group)] = {
            "cells": provenance,
            "feasible": bool(res.feasible),
            "assignment": res.assignment,
            "area": res.area, "sdc_rate": res.sdc_rate,
            "due_rate": res.due_rate,
            "baseline_area": res.baseline_area,
            "baseline_sdc": res.baseline_sdc,
            "n_configs": res.n_configs,
            "pareto": [{"area": a, "sdc_rate": s, "assignment": asg}
                       for a, s, asg in res.pareto],
        }
    return out


def artifact(matrix: ScenarioMatrix, cells: list[Cell], points: dict,
             decisions: list[dict], fleet: dict | None = None,
             device=None) -> dict:
    """The PARETO document: front + per-cell provenance + the prune
    decisions that shaped the run (each one also a journaled ``revoke``
    record in the fleet WAL — the artifact cites, the journal proves).
    The design search runs on ``device`` (None resolves to the card)."""
    return {
        "schema": PARETO_SCHEMA,
        "tag": matrix.tag,
        "sdc_target": matrix.sdc_target,
        "axes": {
            "workloads": [w["name"] for w in matrix.workloads],
            "windows": sorted({c.window for c in cells}),
            "targets": [t["name"] for t in matrix.targets],
            "schemes": [s["name"] for s in matrix.schemes],
            "thermal": [dict(t) for t in matrix.thermal],
        },
        "cells": {name: points[name] for name in sorted(points)},
        "decisions": sorted(decisions, key=lambda d: d["cell"]),
        "search": design_search(matrix, cells, points, device=device),
        "fleet": dict(fleet or {}),
    }


def write_artifact(outdir: str, doc: dict) -> str:
    path = artifact_path(outdir, doc["tag"])
    write_json_atomic(path, doc)
    debug.dprintf("Scenario", "PARETO artifact -> %s (%d cells, %d "
                  "decisions)", path, len(doc["cells"]),
                  len(doc["decisions"]))
    return path
