"""Scenario-matrix driver — the CLI over ``shrewd_tpu_torch/scenario/``
(port of the JAX package's ``tools/scenario.py``, with its flags), run as
``python -m shrewd_tpu_torch.tools.scenario``.  Cells run on the card
unless ``--platform cpu`` asks for the CPU; ``--certify warn|strict`` is
the certification floor of every cell's campaign steps
(``shrewd_tpu_torch/analysis/``).

One declarative plan (see README "Scenario matrix" for the schema)
expands to the full (workloads × windows × fault targets × protection
schemes × thermal envelopes) cross-product and runs it as a tenant set
through the resident fleet, with the closed Pareto loop pruning
dominated cells and emitting ``PARETO_<tag>.json``:

- **serve** — expand, admit, run the fleet to completion with the
  closed loop folding every ``--pareto-every`` ticks::

      python -m shrewd_tpu_torch.tools.scenario --plan matrix.json \\
          --serve --outdir m_out

- **recover** — rebuild a killed matrix fleet from its persisted
  ``matrix.json`` + the write-ahead journal and continue (completed
  cells keep their results, journaled prune decisions re-apply
  exactly)::

      python -m shrewd_tpu_torch.tools.scenario --recover m_out

- **status** — read-only matrix progress from the persisted surfaces
  (``matrix.json`` + per-tick ``metrics.json`` + the PARETO artifact);
  safe against a live server::

      python -m shrewd_tpu_torch.tools.scenario --status m_out

- **pareto** — one-shot fold: rebuild the fleet state (no cells run)
  and re-emit the artifact from the recorded tallies::

      python -m shrewd_tpu_torch.tools.scenario --pareto m_out

- **expand** — print the expanded cell set without running anything
  (plan debugging)::

      python -m shrewd_tpu_torch.tools.scenario --plan matrix.json \\
          --expand

``python -m shrewd_tpu_torch.tools.fleet --matrix matrix.json`` is the
OPEN-loop sibling: it
admits the same expanded cell set into a plain fleet (no Pareto fold,
no pruning) for when the full cross-product is wanted measured.
"""

from __future__ import annotations

import argparse
import json
import sys


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load_matrix(path: str):
    from shrewd_tpu_torch.scenario import ScenarioMatrix

    with open(path) as f:
        return ScenarioMatrix.from_dict(json.load(f))


def cmd_expand(a) -> int:
    matrix = _load_matrix(a.plan)
    cells = matrix.expand()
    print(json.dumps({"tag": matrix.tag, "n_cells": len(cells),
                      "cells": [c.to_dict() for c in cells]}, indent=1))
    return 0


def _mesh(a):
    """``--platform``: every card when absent (``gpu``/``cuda`` name
    it), one CPU device for ``cpu``."""
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    if a.platform in (None, "", "gpu", "cuda"):
        return None
    if a.platform == "cpu":
        return make_mesh(["cpu"])
    raise SystemExit(f"unknown --platform {a.platform!r} (cpu | gpu)")


def cmd_serve(a) -> int:
    from shrewd_tpu_torch.scenario import ScenarioRunner
    from shrewd_tpu_torch.service import LockHeld, ServerLock, is_dirty

    if a.trace:
        from shrewd_tpu_torch.obs import trace as obs_trace

        obs_trace.enable()
    lock = ServerLock(a.recover or a.outdir)
    try:
        lock.acquire()
    except LockHeld as e:
        _log(f"another server owns this fleet: {e}")
        return 2
    try:
        kw = dict(prune=not a.no_prune, pareto_every=a.pareto_every,
                  mesh=_mesh(a), certify=a.certify)
        if a.chaos_plan:
            from shrewd_tpu_torch.chaos import ChaosEngine

            kw["chaos"] = ChaosEngine.from_path(a.chaos_plan,
                                                worker="fleet")
        if a.recover:
            runner = ScenarioRunner.recover(a.recover, **kw)
            _log(f"recovered matrix {runner.matrix.tag!r}: "
                 f"{runner.sched.recoveries} recoveries, "
                 f"{len(runner.decisions(runner.sched))} prune "
                 "decisions replayed")
            rc = runner.run()
        else:
            if is_dirty(a.outdir):
                _log(f"{a.outdir}: dirty shutdown detected — refusing "
                     "to serve over un-recovered state; run --recover "
                     "first")
                return 2
            runner = ScenarioRunner(_load_matrix(a.plan), a.outdir, **kw)
            rc = runner.serve()
        sched = runner.sched
        for name, t in sched.tenants.items():
            _log(f"  {name}: {t.status} ({t.trials} trials"
                 + (f", pruned: {t.revoked}" if t.revoked else "") + ")")
        from shrewd_tpu_torch.scenario import pareto as par

        _log(f"matrix {runner.matrix.tag!r}: {sched.ticks} ticks, "
             f"statuses {sched._by_status()}; artifact "
             f"{par.artifact_path(runner.outdir, runner.matrix.tag)}")
        return rc
    finally:
        lock.release()


def cmd_status(a) -> int:
    from shrewd_tpu_torch.scenario import ScenarioRunner

    print(json.dumps(ScenarioRunner.status(a.status), indent=1))
    return 0


def cmd_pareto(a) -> int:
    """One-shot fold over the recorded state: recover the fleet ledgers
    (no cell runs — recovery only replays the journal) and re-emit the
    artifact."""
    from shrewd_tpu_torch.scenario import ScenarioRunner
    from shrewd_tpu_torch.service import LockHeld, ServerLock

    lock = ServerLock(a.pareto)
    try:
        lock.acquire()
    except LockHeld as e:
        _log(f"another server owns this fleet: {e}")
        return 2
    try:
        runner = ScenarioRunner.recover(a.pareto, prune=False,
                                        mesh=_mesh(a))
        doc = runner.emit_artifact()
        print(json.dumps({"tag": doc["tag"],
                          "cells": len(doc["cells"]),
                          "decisions": len(doc["decisions"]),
                          "groups": list(doc["search"])}, indent=1))
        return 0
    finally:
        lock.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="scenario-matrix campaigns (shrewd_tpu_torch/scenario/)")
    ap.add_argument("--plan", default="",
                    help="ScenarioMatrix JSON document (see README "
                         "'Scenario matrix' for the schema)")
    ap.add_argument("--serve", action="store_true",
                    help="expand --plan and run it through the resident "
                         "fleet with the closed Pareto loop")
    ap.add_argument("--expand", action="store_true",
                    help="print the expanded cell set of --plan and exit")
    ap.add_argument("--recover", default="",
                    help="rebuild a killed matrix fleet from this outdir "
                         "(matrix.json + write-ahead journal) and "
                         "continue it")
    ap.add_argument("--status", default="",
                    help="read-only matrix progress from this outdir")
    ap.add_argument("--pareto", default="",
                    help="one-shot fold: re-emit PARETO_<tag>.json from "
                         "this outdir's recorded state")
    ap.add_argument("--outdir", default="scenario_out",
                    help="fleet artifact root for --serve")
    ap.add_argument("--no-prune", action="store_true",
                    help="disable the closed-loop quota revocation "
                         "(measure the FULL cross-product; the artifact "
                         "still folds every --pareto-every ticks)")
    ap.add_argument("--pareto-every", type=int, default=4,
                    help="fleet ticks between Pareto folds (tick-"
                         "counted, never wall clock; default 4)")
    ap.add_argument("--certify", default="",
                    choices=("", "off", "warn", "strict"),
                    help="admission-time certification floor "
                         "applied to every cell's campaign steps")
    ap.add_argument("--chaos-plan", default="",
                    help="fleet-level chaos plan JSON (survivability "
                         "drills)")
    ap.add_argument("--trace", action="store_true",
                    help="install the process-wide tracer (obs/)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the cells on the CPU; the default (or "
                         "gpu) is every visible card")
    a = ap.parse_args(argv)

    if a.expand:
        if not a.plan:
            _log("--expand needs --plan")
            return 2
        return cmd_expand(a)
    if a.status:
        return cmd_status(a)
    if a.pareto:
        return cmd_pareto(a)
    if a.serve or a.recover:
        if a.serve and not (a.plan or a.recover):
            _log("--serve needs --plan")
            return 2
        return cmd_serve(a)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
