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

``FederatedScenarioRunner`` is the same loop with the FEDERATION as the
fleet: cells admitted through the ``Gateway`` spread across an elastic
pod pool (autoscaled when an ``Autoscaler`` is attached), the fold runs
on the driver's per-round seam, and prunes execute fleet-wide through
whichever pod hosts the dominated cell.  The Pareto front is pinned
bit-identical to the solo runner's — prune timing may differ across
pool schedules, converged rows (frozen keys) cannot.

Port of ``shrewd_tpu/scenario/runner.py``; the design search of each
fold runs on the fleet's (or the federation's) first mesh device.
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
    """Drive one matrix through one FEDERATION: the same closed Pareto
    loop as ``ScenarioRunner``, but the fleet is the elastic pod pool.

    Cells are admitted through the ``Gateway`` (its ETA-weighted
    routing spreads the matrix across pods; an attached ``Autoscaler``
    grows and shrinks the pool under the matrix's pressure), the fold
    runs once per federation round on the driver's ``on_round`` seam,
    and a prune decision executes FLEET-WIDE through whichever pod
    currently hosts the dominated cell — the pod's journaled
    ``revoke_quota`` seam, so the decision survives that pod's crash
    exactly like a solo fleet's would.  Decisions already executed are
    recovered from the gateway ledger alone (the pruned done-doc's
    ``reason`` carries the dominator), so a recovered federation
    reports the exact decision set of its killed predecessor without
    consulting any pod.

    Front equality with the solo runner is structural, not incidental:
    scheme-mates share frozen PRNG keys on their measurement
    coordinates, so every converged row is bit-identical wherever (and
    on however many pods) it ran, and ``pareto.design_search`` builds
    the front from converged rows only — prune *timing* may differ
    across pool schedules, the front cannot.  The CI gate pins exactly
    that: the ``PARETO_FED_<tag>.json`` front equals the solo run's.

    The artifact and the matrix document live at the federation ROOT
    (beside ``gateway/`` and ``pods/``) — one recovery surface for the
    whole matrix, whatever the pool did."""

    def __init__(self, matrix: ScenarioMatrix, root: str,
                 pod_names=("pod0", "pod1", "pod2"), prune: bool = True,
                 pareto_every: int = 1, on_round=None, **fed_kw):
        self.matrix = matrix
        self.cells = matrix.expand()
        self._by_name = {c.name: c for c in self.cells}
        self.root = root
        self.pod_names = tuple(pod_names)
        self.prune = bool(prune)
        self.pareto_every = max(1, int(pareto_every))
        self._user_on_round = on_round
        self._fed_kw = dict(fed_kw)
        self.fed = None               # federation.driver.Federation

    # --- construction -----------------------------------------------------

    def _persist_matrix(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        doc = self.matrix.to_dict()
        doc["checksum"] = doc_checksum(doc)
        write_json_atomic(os.path.join(self.root, MATRIX_DOC), doc)

    def _admit_missing(self) -> int:
        n = 0
        for cell in self.cells:
            if cell.name not in self.fed.gateway.entries:
                self.fed.submit(cell.spec())
                n += 1
        return n

    def serve(self) -> int:
        """Fresh matrix: persist the document, admit every cell through
        the gateway, serve the federation to convergence, emit the
        final artifact."""
        from shrewd_tpu_torch.federation.driver import Federation

        self._persist_matrix()
        self.fed = Federation(self.root, pod_names=self.pod_names,
                              on_round=self._on_round, **self._fed_kw)
        self._admit_missing()
        return self.run()

    @classmethod
    def recover(cls, root: str, pod_names=("pod0", "pod1", "pod2"),
                prune: bool = True, pareto_every: int = 1,
                on_round=None, **fed_kw) -> "FederatedScenarioRunner":
        """Rebuild a federated matrix after ANY shutdown: verify the
        matrix document, recover the federation (gateway WAL replay —
        including every pool transition — then pod WALs lazily),
        re-admit cells the kill landed before their accept record.
        Prune decisions replay from the ledger; the pool replays from
        its journaled scale/retire records."""
        from shrewd_tpu_torch.federation.driver import Federation

        matrix = ScenarioMatrix.from_dict(
            load_json_verified(os.path.join(root, MATRIX_DOC)))
        runner = cls(matrix, root, pod_names=pod_names, prune=prune,
                     pareto_every=pareto_every, on_round=on_round,
                     **fed_kw)
        runner.fed = Federation.recover(
            root, pod_names=runner.pod_names,
            on_round=runner._on_round, **runner._fed_kw)
        runner._admit_missing()
        return runner

    def run(self) -> int:
        rc = self.fed.serve()
        try:
            self.emit_artifact()
        except Exception as e:  # noqa: BLE001 — same posture as the
            # solo runner: the artifact is DERIVED state; a final fold
            # that cannot compute must not discard the rc of a served
            # matrix
            debug.dprintf("Scenario", "final pareto fold failed: %s", e)
            import sys

            print(f"scenario: final pareto fold failed ({e}) — re-fold "
                  "with python -m shrewd_tpu_torch.tools.scenario --pareto", file=sys.stderr)
        return rc

    # --- the closed loop --------------------------------------------------

    def _on_round(self, fed) -> None:
        if self._user_on_round is not None:
            self._user_on_round(fed)
        if fed.round % self.pareto_every:
            return
        try:
            self._fold(fed)
        except Exception as e:  # noqa: BLE001 — the Pareto loop is a
            # supervisor over the federation, never a dependency of it
            # (same contract as the solo runner's _on_tick): decisions
            # are monotonic, a later fold makes the same calls
            debug.dprintf("Scenario", "pareto fold skipped: %s", e)

    def _fold(self, fed) -> dict:
        points = self.points(fed)
        decisions = self.decisions(fed)
        if self.prune:
            for d in pareto.prune_decisions(self.cells, points,
                                            revoked=dict(decisions)):
                if self._revoke(fed, d["cell"], d["dominated_by"]):
                    decisions[d["cell"]] = d["dominated_by"]
                    debug.dprintf("Scenario", "pruned %s fleet-wide "
                                  "(dominated by %s)", d["cell"],
                                  d["dominated_by"])
        doc = pareto.artifact(
            self.matrix, self.cells, points,
            [{"cell": c, "dominated_by": by}
             for c, by in sorted(decisions.items())],
            fleet={"rounds": fed.round,
                   "by_status": fed.gateway._by_status(),
                   "pool": fed.gateway.pool_status()},
            device=fed.mesh.devices[0] if fed.mesh is not None else None)
        pareto.write_artifact(self.root, doc)
        return doc

    def _revoke(self, fed, cell: str, dominator: str) -> bool:
        """Execute one prune on whichever pod hosts the cell — the
        pod-side journaled seam, exactly the division of authority the
        driver uses for shard-convergence revocations.  A cell not yet
        placed (or whose pod is dead/partitioned this round) is simply
        retried next fold: decisions are re-derived from converged
        tallies, which never un-converge."""
        e = fed.gateway.entries.get(cell)
        if e is None or e.status != "placed" or not e.pod:
            return False
        pod = fed.pods.get(e.pod)
        if pod is None or pod.dead or pod.partitioned \
                or pod.sched is None or cell not in pod.sched.tenants:
            return False
        return pod.sched.revoke_quota(cell, PRUNE_REASON + dominator)

    def emit_artifact(self) -> dict:
        """The final fold (also the ``--pareto`` one-shot surface)."""
        return self._fold(self.fed)

    def decisions(self, fed) -> dict:
        """Prune decisions already made, fleet-wide: executed ones from
        the gateway ledger (the pruned done-doc's ``reason`` carries
        the dominator — survives every pod), in-flight ones from the
        hosting pods' live tenant state (revoked, drain pending)."""
        out = {}
        for name, e in fed.gateway.entries.items():
            if name not in self._by_name:
                continue
            reason = str((e.result or {}).get("reason") or "")
            if reason.startswith(PRUNE_REASON):
                out[name] = reason[len(PRUNE_REASON):]
        for pod in fed.pods.values():
            if pod.sched is None or pod.dead:
                continue
            for name, t in pod.sched.tenants.items():
                if name in self._by_name \
                        and t.revoked.startswith(PRUNE_REASON):
                    out.setdefault(name,
                                   t.revoked[len(PRUNE_REASON):])
        return out

    # --- live cell state --------------------------------------------------

    def points(self, fed) -> dict:
        """Every cell's live design point, fleet-wide: done cells from
        the gateway ledger's authoritative done-doc (each tenant
        counted exactly once, per the routing ledger — whichever pods
        its history visited), placed cells from their hosting pod's
        live scheduler state.  Point arithmetic is shared with the solo
        runner (``_live_point``)."""
        out = {}
        for cell in self.cells:
            e = fed.gateway.entries.get(cell.name)
            if e is None:
                continue
            lane = _cell_lane(cell)
            sp_name = lane.split("/", 1)[0]
            tallies = trials = None
            strata = None
            converged = False
            status = "queued"
            res = (e.result or {}).get("results") or {}
            if lane in res:
                row = res[lane]
                tallies = row["tallies"]
                trials = int(row["trials"])
                strata = row.get("strata")
                converged = bool(row.get("converged", False))
                status = str((e.result or {}).get("status")
                             or "complete")
            elif e.pod:
                pod = fed.pods.get(e.pod)
                t = (pod.sched.tenants.get(cell.name)
                     if pod is not None and not pod.dead
                     and pod.sched is not None else None)
                if t is not None:
                    status = t.status
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
                                         converged, status)
        return out
