"""Scenario-matrix execution: the matrix as a fleet tenant set.

``ScenarioRunner`` admits a matrix's expanded cells through the resident
``CampaignScheduler`` and closes the loop: every ``pareto_every`` fleet
ticks it folds the live per-cell tallies (the same estimator surfaces
the fleet's metrics publish uses), revokes the quota of Pareto-dominated
cells through the scheduler's journaled seam, and re-emits the
``PARETO_<tag>.json`` artifact atomically.

Partial-matrix survivability: the matrix document itself is persisted
into the fleet outdir (``matrix.json``) before any cell runs, so a
hard-killed fleet recovers the WHOLE matrix — ``ScenarioRunner.
recover`` replays the fleet WAL (completed cells keep their recorded
results, running cells resume from their namespaced checkpoints,
journaled prune decisions re-apply exactly) and re-admits any cell the
kill landed before, then continues to the same bit-identical end state
an undisturbed run reaches.

Determinism: the fold cadence is counted in fleet ticks (never wall
clock), decisions depend only on converged tallies (bit-identical by
the frozen-key invariant) and static areas, and revocation is
journaled before any state change — so the prune *set* of a recovered
matrix equals the undisturbed run's, pinned in tests.

Port of ``shrewd_tpu/scenario/runner.py``.  ``FederatedScenarioRunner``
is exported but raises ``NotImplementedError``: it drives the
federation layer, which the port does not have yet.
"""

from __future__ import annotations

import json
import os

from shrewd_tpu_torch.resilience import (doc_checksum,
                                         load_json_verified,
                                         write_json_atomic)
from shrewd_tpu_torch.scenario import pareto
from shrewd_tpu_torch.scenario.matrix import COHERENCE, ScenarioMatrix
from shrewd_tpu_torch.service.scheduler import CampaignScheduler
from shrewd_tpu_torch.utils import debug

MATRIX_DOC = "matrix.json"

#: prefix of the revoke reason the Pareto loop writes — decisions are
#: recoverable from tenant state alone (reason = "pareto:<dominator>")
PRUNE_REASON = "pareto:"


def _cell_lane(cell) -> str:
    """The one result lane a cell measures (simpoint/target)."""
    sp_name = (COHERENCE if cell.window == COHERENCE
               else cell.plan["simpoints"][0]["name"])
    return f"{sp_name}/{cell.target}"


def _live_point(cell, tallies, trials, strata, converged: bool,
                status: str) -> dict:
    """One cell's design point from raw row state, with the half-width
    computed by the SAME estimator selection the stopping rule and the
    metrics publish use (``stopping.live_halfwidth``) — shared by the
    solo and federated folds so both report identical points for
    identical rows (the frozen-key invariant makes the rows identical;
    this keeps the folds from diverging on arithmetic)."""
    import numpy as np

    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.parallel import stopping

    trials = int(trials)
    vul = int(np.asarray(tallies)[C.OUTCOME_SDC]
              + np.asarray(tallies)[C.OUTCOME_DUE])
    conf = float(cell.plan.get("confidence", 0.95))
    hw = (stopping.live_halfwidth(
        vul, trials, strata,
        bool(cell.plan.get("stratify", False)), conf)
        if trials > 0 else 1.0)
    return pareto.cell_point(cell, tallies, trials, hw, bool(converged),
                             status, confidence=conf)


class ScenarioRunner:
    """Drive one matrix through one fleet (see module docstring)."""

    def __init__(self, matrix: ScenarioMatrix, outdir: str,
                 prune: bool = True, pareto_every: int = 4,
                 on_tick=None, **sched_kw):
        self.matrix = matrix
        self.cells = matrix.expand()
        self._by_name = {c.name: c for c in self.cells}
        self.outdir = outdir
        self.prune = bool(prune)
        self.pareto_every = max(1, int(pareto_every))
        self._user_on_tick = on_tick
        self._sched_kw = dict(sched_kw)
        self.sched: CampaignScheduler | None = None

    # --- construction -----------------------------------------------------

    def _persist_matrix(self) -> None:
        """The matrix document is a RECOVERY INPUT (a hard-killed fleet
        rebuilds the whole matrix from it), so it carries a content
        checksum like every other crash-surface artifact — recovery
        verifies it rather than trusting whatever bytes survived."""
        os.makedirs(self.outdir, exist_ok=True)
        doc = self.matrix.to_dict()
        doc["checksum"] = doc_checksum(doc)
        write_json_atomic(os.path.join(self.outdir, MATRIX_DOC), doc)

    def _admit_missing(self) -> int:
        """Admit every cell the scheduler does not already know — all of
        them on a fresh serve, only the not-yet-admitted remainder after
        a recovery (cells already in the replayed roster keep their
        recorded state untouched)."""
        n = 0
        for cell in self.cells:
            if cell.name not in self.sched.tenants:
                self.sched.admit(cell.spec())
                n += 1
        return n

    def serve(self) -> int:
        """Fresh matrix: persist the document, admit every cell, run the
        fleet to completion, emit the final artifact."""
        self._persist_matrix()
        self.sched = CampaignScheduler(outdir=self.outdir,
                                       on_tick=self._on_tick,
                                       **self._sched_kw)
        self._admit_missing()
        return self.run()

    @classmethod
    def recover(cls, outdir: str, prune: bool = True,
                pareto_every: int = 4, on_tick=None,
                **sched_kw) -> "ScenarioRunner":
        """Rebuild a matrix fleet after ANY shutdown from its persisted
        matrix document + the fleet WAL (``CampaignScheduler.recover``
        semantics; journaled prune decisions replay exactly).  The
        matrix document is checksum-verified: recovering a whole matrix
        from torn bytes would be worse than refusing."""
        matrix = ScenarioMatrix.from_dict(
            load_json_verified(os.path.join(outdir, MATRIX_DOC)))
        runner = cls(matrix, outdir, prune=prune,
                     pareto_every=pareto_every, on_tick=on_tick,
                     **sched_kw)
        runner.sched = CampaignScheduler.recover(
            outdir, on_tick=runner._on_tick, **runner._sched_kw)
        runner._admit_missing()
        return runner

    def run(self) -> int:
        rc = self.sched.run()
        try:
            self.emit_artifact()
        except Exception as e:  # noqa: BLE001 — the artifact is DERIVED
            # state (journal + per-tenant results are the ground truth,
            # and tools/scenario.py --pareto can re-fold any time): a
            # fold that cannot compute must not discard the fleet rc of
            # a fully served matrix.  The --pareto one-shot surface
            # calls emit_artifact() directly and DOES raise.
            debug.dprintf("Scenario", "final pareto fold failed: %s", e)
            import sys

            print(f"scenario: final pareto fold failed ({e}) — re-fold "
                  "with tools/scenario.py --pareto", file=sys.stderr)
        return rc

    # --- the closed loop --------------------------------------------------

    def _on_tick(self, sched) -> None:
        if self._user_on_tick is not None:
            self._user_on_tick(sched)
        if sched.ticks % self.pareto_every:
            return
        try:
            self._fold(sched)
        except Exception as e:  # noqa: BLE001 — the Pareto loop is a
            # supervisor over the fleet, never a dependency of it: a
            # fold that cannot compute (a cell mid-elaboration, a model
            # import failing) skips this tick and the fleet keeps
            # serving; decisions are monotonic so a later fold makes
            # the same calls
            debug.dprintf("Scenario", "pareto fold skipped: %s", e)

    def _fold(self, sched) -> dict:
        points = self.points(sched)
        decisions = self.decisions(sched)
        if self.prune:
            for d in pareto.prune_decisions(self.cells, points,
                                            revoked=dict(decisions)):
                if sched.revoke_quota(
                        d["cell"], PRUNE_REASON + d["dominated_by"]):
                    decisions[d["cell"]] = d["dominated_by"]
                    debug.dprintf("Scenario", "pruned %s (dominated by "
                                  "%s)", d["cell"], d["dominated_by"])
        doc = pareto.artifact(
            self.matrix, self.cells, points,
            [{"cell": c, "dominated_by": by}
             for c, by in sorted(decisions.items())],
            fleet={"ticks": sched.ticks,
                   "by_status": sched._by_status()},
            device=sched.mesh.devices[0])
        pareto.write_artifact(self.outdir, doc)
        return doc

    def emit_artifact(self) -> dict:
        """The final fold (also the ``--pareto`` one-shot surface)."""
        return self._fold(self.sched)

    def decisions(self, sched) -> dict:
        """Prune decisions already made, recovered from tenant state
        alone — the revoke reasons the WAL replayed carry the dominator,
        so a recovered matrix reports the exact decision set of its
        killed predecessor."""
        out = {}
        for name, t in sched.tenants.items():
            if name in self._by_name and t.revoked.startswith(
                    PRUNE_REASON):
                out[name] = t.revoked[len(PRUNE_REASON):]
        return out

    # --- live cell state --------------------------------------------------

    def points(self, sched) -> dict:
        """Every cell's live design point: terminal cells from their
        recorded results, running cells from their orchestrator's live
        state (the half-width arithmetic is shared with the federated
        fold — ``_live_point``)."""
        out = {}
        for cell in self.cells:
            t = sched.tenants.get(cell.name)
            if t is None:
                continue
            lane = _cell_lane(cell)
            sp_name = lane.split("/", 1)[0]
            tallies = trials = None
            strata = None
            converged = False
            if t.results and lane in t.results:
                row = t.results[lane]
                tallies = row["tallies"]
                trials = int(row["trials"])
                strata = row.get("strata")
                converged = bool(row["converged"])
            elif t.orch is not None:
                st = t.orch.state.get((sp_name, cell.target))
                if st is not None:
                    tallies = st.tallies
                    trials = st.trials
                    strata = st.strata
                    converged = bool(st.converged)
            if tallies is None:
                continue
            out[cell.name] = _live_point(cell, tallies, trials, strata,
                                         converged, t.status)
        return out

    # --- read-only status -------------------------------------------------

    @staticmethod
    def status(outdir: str) -> dict:
        """Read-only matrix status from the persisted surfaces (matrix
        document + per-tick ``metrics.json`` + the fleet snapshot) — no
        lock, no journal replay, safe against a live server."""
        from shrewd_tpu_torch.obs import metrics as obs_metrics

        mdoc = load_json_verified(os.path.join(outdir, MATRIX_DOC))
        out = {"tag": mdoc["tag"], "outdir": outdir, "tenants": {},
               "fleet": {}}
        try:
            snap = obs_metrics.read(outdir)
            out["fleet"] = snap.get("fleet", {})
            out["tenants"] = snap.get("tenants", {})
        except (OSError, ValueError):
            pass
        apath = pareto.artifact_path(outdir, mdoc["tag"])
        if os.path.exists(apath):
            with open(apath) as f:
                doc = json.load(f)
            out["decisions"] = doc.get("decisions", [])
            out["search"] = {g: {"area": r["area"],
                                 "sdc_rate": r["sdc_rate"],
                                 "front": len(r["pareto"])}
                             for g, r in doc.get("search", {}).items()}
        return out


class FederatedScenarioRunner:
    """The closed Pareto loop with a federation of pods as the fleet
    (the reference's ``FederatedScenarioRunner``).  It drives the
    federation layer (gateway, pod pool, autoscaler), which the port
    does not have yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FederatedScenarioRunner drives the federation layer, which "
            "comes with the port's federation slice; use ScenarioRunner "
            "for one fleet")

    @classmethod
    def recover(cls, *args, **kwargs):
        raise NotImplementedError(
            "FederatedScenarioRunner.recover drives the federation layer, "
            "which comes with the port's federation slice")
