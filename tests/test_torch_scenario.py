"""The port's scenario matrix and closed Pareto loop
(``shrewd_tpu_torch/scenario/`` and ``tools/scenario.py``) against the
JAX package's, on the CPU.

``expand()`` gives the same cells — names, order, seeds, plans, bits —
and the Pareto algebra the same points, dominations and decisions.  One
matrix of the O3, MESI and NoC families, two schemes where one dominates
(``parity`` over ``secded``, the parity cells a strict-priority class
above) and two thermal envelopes runs through both packages' closed
loops (``pareto_every=1``): the per-cell tallies, the journal's
``revoke`` records, every cell's status and ``PARETO_<tag>.json`` are
equal, the front's assignments exactly and its floats within
``rtol=1e-6`` (float32 sums over structures in another order, as in
``test_torch_search.py``).  A ``kill_fleet`` between a prune decision
and its drain recovers to the same decision in both packages, and the
CLIs' ``--expand``, ``--status`` and ``--pareto`` print the same
documents for the same state but for wall-clock fields.  The reference's
``tests/test_scenario.py`` windows are used: ``n=96, nphys=32,
mem_words=64``, ``coherence_accesses=64``.

Module fixture: R1 and R4, as in ``test_torch_orchestrator.py``.
"""

import contextlib
import copy
import importlib.util
import io
import json
import os

import jax
import numpy as np
import pytest

from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu.scenario import matrix as ref_matrix
from shrewd_tpu.scenario import pareto as ref_pareto
from shrewd_tpu.scenario import runner as ref_runner
from shrewd_tpu.scenario.runner import PRUNE_REASON
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.parallel.mesh import make_mesh
from shrewd_tpu_torch.scenario import matrix as port_matrix
from shrewd_tpu_torch.scenario import pareto as port_pareto
from shrewd_tpu_torch.scenario import runner as port_runner
from shrewd_tpu_torch.sim.exit_event import ExitEvent
from shrewd_tpu_torch.tools import scenario as port_cli

from test_torch_fleet import (PORT, REF, _reference_on_jax_09,  # noqa: F401
                              journal_records)
from test_torch_ruby import one_torch_thread  # noqa: F401

# float32 sums over structures in another order (module docstring)
RTOL = 1e-6
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _sp(name="w0", seed=7):
    return {"type": "WorkloadSpec", "name": name,
            "workload": {"n": 96, "nphys": 32, "mem_words": 64,
                         "working_set_words": 32, "seed": seed}}


def _base(n_batches=2, batch_size=32, **kw):
    base = {"batch_size": batch_size, "target_halfwidth": 0.2,
            "max_trials": batch_size * n_batches,
            "min_trials": batch_size * n_batches,
            "integrity": {"canary_trials": 0, "audit_rate": 0.0},
            "resilience": {"backoff_base": 0.0},
            "coherence_accesses": 64, "coherence_mem_words": 64}
    base.update(kw)
    return base


def matrix_doc(tag, targets=("regfile", "mesi:state", "noc:router"),
               schemes=None, thermal=None, base=None, **kw):
    return ref_matrix.ScenarioMatrix(
        tag=tag, workloads=[{"name": "wl", "simpoints": [_sp()]}],
        targets=list(targets),
        schemes=schemes or [
            {"name": "parity", "detect": 1.0, "area": 1.03,
             "priority": 1},
            {"name": "secded", "correct": 1.0, "area": 1.22}],
        thermal=thermal or [{"name": "tnom"},
                            {"name": "hot", "temperature_c": 100.0}],
        base=base or _base(), seed=3, **kw).to_dict()


def ref_mesh():
    return ref_make_mesh(jax.devices()[:1])


def cell_rows(sched):
    return {n: t.results for n, t in sched.tenants.items()}


def pareto_doc(outdir, tag):
    with open(os.path.join(outdir, f"PARETO_{tag}.json")) as f:
        return json.load(f)


def split_floats(x):
    """(the document with every float replaced by a marker, the floats
    in document order)."""
    floats = []

    def walk(v):
        if isinstance(v, float):
            floats.append(v)
            return "<float>"
        if isinstance(v, dict):
            return {k: walk(w) for k, w in v.items()}
        if isinstance(v, list):
            return [walk(w) for w in v]
        return v

    return walk(x), floats


def assert_docs_close(got, want):
    g, gf = split_floats(got)
    w, wf = split_floats(want)
    assert g == w
    np.testing.assert_allclose(gf, wf, rtol=RTOL)


# --- expansion and the Pareto algebra ----------------------------------------

def test_expand_matches_reference():
    doc = matrix_doc("m", targets=("regfile", "rob", "mesi:state",
                                   "noc:router"),
                     thermal=[{"name": "tnom"},
                              {"name": "hot", "temperature_c": 101.5,
                               "weight": 0.5}])
    want = ref_matrix.ScenarioMatrix.from_dict(doc).expand()
    got = compat.matrix_from_dict(doc).expand()
    assert [c.name for c in got] == [c.name for c in want]
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert [c.plan for c in got] == [c.plan for c in want]
    assert [c.plan["seed"] for c in got] == [
        port_matrix.cell_seed(3, c.workload, c.window, c.target)
        for c in got]
    assert [c.prune_group for c in got] == [c.prune_group for c in want]
    for c in got:
        PP.CampaignPlan.from_dict(c.plan)       # every plan elaborates
    assert compat.tenant_spec_from_dict(want[0].spec().to_dict()
                                        ).to_dict() == got[0].spec().to_dict()
    for t in port_matrix.KNOWN_TARGETS:
        assert port_matrix.default_bits(t, _base()) == \
            ref_matrix.default_bits(t, _base())
    with pytest.raises(ValueError, match="unknown target"):
        port_matrix.ScenarioMatrix(tag="m", workloads=[], schemes=[],
                                   targets=["bogus"])


def test_pareto_algebra_matches_reference():
    """``cell_point`` over seeded tallies (both schemes, both envelopes,
    zero trials), ``dominates`` and ``prune_decisions``."""
    doc = matrix_doc("alg", targets=("regfile", "noc:router"))
    rcells = ref_matrix.ScenarioMatrix.from_dict(doc).expand()
    pcells = compat.matrix_from_dict(doc).expand()
    rng = np.random.default_rng(0)
    rpts, ppts = {}, {}
    for i, (rc, pc) in enumerate(zip(rcells, pcells)):
        tallies = rng.integers(0, 50, 4)
        trials = int(tallies.sum()) if i % 5 else 0
        args = (tallies, trials, float(rng.uniform(0, 0.3)),
                bool(i % 2), ("running", "complete", "queued")[i % 3])
        rpts[rc.name] = ref_pareto.cell_point(rc, *args)
        ppts[pc.name] = port_pareto.cell_point(pc, *args)
        assert ppts[pc.name] == rpts[rc.name]
    for a in ppts.values():
        for b in ppts.values():
            assert port_pareto.dominates(a, b) == \
                ref_pareto.dominates(a, b)
    assert port_pareto.prune_decisions(pcells, ppts) == \
        ref_pareto.prune_decisions(rcells, rpts)
    assert port_pareto.thermal_factor(100.0) == \
        ref_pareto.thermal_factor(100.0)


# --- the closed loop ---------------------------------------------------------

@pytest.fixture(scope="module")
def closed_loop(tmp_path_factory):
    """The three-family, two-scheme, two-envelope matrix through both
    runners with the Pareto fold after every tick."""
    root = tmp_path_factory.mktemp("scenario")
    doc = matrix_doc("loop")
    out = {}
    for pkg, mod, mesh in ((REF, ref_runner, ref_mesh),
                           (PORT, port_runner, lambda: make_mesh(["cpu"]))):
        d = str(root / pkg.name)
        matrix = (ref_matrix.ScenarioMatrix.from_dict(doc)
                  if pkg is REF else compat.matrix_from_dict(doc))
        with journal_records(pkg) as recs:
            runner = mod.ScenarioRunner(matrix, d, pareto_every=1,
                                        mesh=mesh())
            rc = runner.serve()
        out[pkg.name] = (runner, rc, recs, d)
    return doc, out


def test_closed_loop_matches_reference(closed_loop):
    doc, out = closed_loop
    (rr, rrc, rrecs, rdir), (pr, prc, precs, pdir) = out["ref"], out["port"]
    assert prc == rrc == 0
    assert len(pr.cells) == 12
    assert cell_rows(pr.sched) == cell_rows(rr.sched)
    assert {n: t.status for n, t in pr.sched.tenants.items()} == \
        {n: t.status for n, t in rr.sched.tenants.items()}
    revokes = [d for k, d in precs if k == "revoke"]
    assert revokes == [d for k, d in rrecs if k == "revoke"]
    # parity dominates secded in every prune group: at least one secded
    # cell is pruned by its parity mate, every other cell completes
    assert revokes
    for r in revokes:
        assert ".secded." in r["tenant"]
        assert r["reason"] == PRUNE_REASON + r["tenant"].replace(
            ".secded.", ".parity.")
    statuses = {t.status for t in pr.sched.tenants.values()}
    assert statuses <= {"complete", "pruned"} and "pruned" in statuses
    assert pr.decisions(pr.sched) == rr.decisions(rr.sched)
    want = pareto_doc(rdir, "loop")
    got = pareto_doc(pdir, "loop")
    assert {n: c["status"] for n, c in got["cells"].items()} == \
        {n: c["status"] for n, c in want["cells"].items()}
    for g in want["search"]:
        assert [p["assignment"] for p in got["search"][g]["pareto"]] == \
            [p["assignment"] for p in want["search"][g]["pareto"]]
        assert got["search"][g]["assignment"] == \
            want["search"][g]["assignment"]
    assert_docs_close(got, want)


def test_closed_loop_raw_tallies_shared_by_thermal_mates(closed_loop):
    """Only NoC cells bake the envelope into the plan: the regfile and
    MESI cells' raw tallies are equal across their thermal mates, and
    one completed O3 cell and one completed coherence cell each equal a
    solo serial run of the cell's plan."""
    _, out = closed_loop
    runner = out["port"][0]
    by = {}
    for c in runner.cells:
        t = runner.sched.tenants[c.name]
        if t.status == "complete":
            by.setdefault((c.target, c.scheme["name"]), []).append(
                t.results)
    for (target, _), rows in by.items():
        if target != "noc:router" and len(rows) == 2:
            assert rows[0] == rows[1]
    for target in ("regfile", "mesi:state"):
        cell = next(c for c in runner.cells if c.target == target
                    and runner.sched.tenants[c.name].status == "complete")
        orch = Orchestrator(PP.CampaignPlan.from_dict(cell.plan),
                            device="cpu")
        events = list(orch.events())
        assert events[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
        solo = {f"{sp}/{st}": r.tallies.tolist()
                for (sp, st), r in dict(events[-1][1]).items()}
        got = runner.sched.tenants[cell.name].results
        assert {k: v["tallies"] for k, v in got.items()} == solo


def _ref_cli():
    spec = importlib.util.spec_from_file_location(
        "ref_tools_scenario", os.path.join(ROOT, "tools", "scenario.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _status(text, outdir):
    doc = json.loads(text)
    assert doc.pop("outdir") == outdir
    for k in ("cache_compiled", "cache_reused", "cache_hit_rate"):
        doc["fleet"].pop(k)
    for row in doc["tenants"].values():
        for k in ("trials_per_s", "queue_latency_s", "eta_s"):
            row.pop(k, None)
    return doc


def test_cli_status_pareto_and_expand_match_reference(closed_loop,
                                                      tmp_path):
    doc, out = closed_loop
    rdir, pdir = out["ref"][3], out["port"][3]
    ref_cli = _ref_cli()
    rc, rtext, _ = _cli(ref_cli.main, ["--status", rdir])
    pc, ptext, _ = _cli(port_cli.main, ["--status", pdir])
    assert rc == pc == 0
    assert_docs_close(_status(ptext, pdir), _status(rtext, rdir))
    before = pareto_doc(pdir, "loop")
    rc, rtext, _ = _cli(ref_cli.main, ["--pareto", rdir])
    pc, ptext, _ = _cli(port_cli.main, ["--pareto", pdir, "--platform",
                                        "cpu"])
    assert rc == pc == 0 and json.loads(ptext) == json.loads(rtext)
    again = pareto_doc(pdir, "loop")
    before["fleet"].pop("ticks"), again["fleet"].pop("ticks")
    assert again == before              # the one-shot fold re-emits it
    path = str(tmp_path / "m.json")
    json.dump(doc, open(path, "w"))
    rc, rtext, _ = _cli(ref_cli.main, ["--plan", path, "--expand"])
    pc, ptext, _ = _cli(port_cli.main, ["--plan", path, "--expand"])
    assert rc == pc == 0 and ptext == rtext
    assert json.loads(ptext)["n_cells"] == 12
    assert _cli(port_cli.main, ["--serve"])[0] == 2     # needs --plan


def test_cli_serve_on_the_cpu(tmp_path):
    """``--serve --platform cpu`` runs a small matrix through the
    port's CLI to rc 0 and writes the artifact the runner writes, with
    every cell's campaign steps certified (``--certify strict``) and none
    refused."""
    from shrewd_tpu_torch.parallel import exec_cache

    doc = matrix_doc("cli", targets=("regfile",), thermal=[
        {"name": "tnom"}])
    path = str(tmp_path / "m.json")
    json.dump(doc, open(path, "w"))
    outdir = str(tmp_path / "out")
    refused = exec_cache.cache().refused
    try:
        rc, _, err = _cli(port_cli.main, ["--plan", path, "--serve",
                                          "--outdir", outdir, "--platform",
                                          "cpu", "--pareto-every", "1",
                                          "--certify", "strict"])
        auditor = exec_cache.current_auditor()
    finally:
        exec_cache.clear_auditor()
    assert rc == 0, err
    # cells on one window share their step certificates in the ledger
    assert auditor.strict and auditor.failed == 0
    certs = exec_cache.cache().certificates.values()
    assert certs and all(c["ok"] for c in certs)
    assert exec_cache.cache().refused == refused
    art = pareto_doc(outdir, "cli")
    assert set(art) == {"schema", "tag", "sdc_target", "axes", "cells",
                        "decisions", "search", "fleet"}
    assert art["decisions"] == [{"cell": "cli.wl.w0.regfile.secded.tnom",
                                 "dominated_by":
                                 "cli.wl.w0.regfile.parity.tnom"}]


# --- a kill between a prune decision and its drain ---------------------------

def _prune_doc(tag):
    """``tests/test_scenario.py _prune_matrix``: parity dominates dmr,
    de-weighted so it still runs when parity converges."""
    return matrix_doc(tag, targets=("regfile",), thermal=[{"name": "tnom"}],
                      base=_base(n_batches=6),
                      schemes=[{"name": "parity", "detect": 1.0,
                                "area": 1.03},
                               {"name": "dmr", "detect": 1.0, "area": 2.0,
                                "weight": 0.2}])


def test_prune_decision_survives_hard_kill_like_the_reference(tmp_path):
    """The journaled revoke IS the decision: killed after it and before
    the revoked cell's drain, the recovered fleet prunes it without
    elaboration at the decision-time trials, in both packages, equal to
    the undisturbed run."""
    results = {}
    for pkg, mod, mesh, mfrom in (
            (REF, ref_runner, ref_mesh, ref_matrix.ScenarioMatrix.from_dict),
            (PORT, port_runner, lambda: make_mesh(["cpu"]),
             compat.matrix_from_dict)):
        seen = {}

        def watch(sched):
            if "tick" not in seen and any(t.revoked for t in
                                          sched.tenants.values()):
                seen["tick"] = sched.ticks

        r0 = mod.ScenarioRunner(mfrom(_prune_doc("pk")),
                                str(tmp_path / pkg.name / "ref"),
                                pareto_every=1, on_tick=watch, mesh=mesh())
        assert r0.serve() == 0
        dmr, parity = "pk.wl.w0.regfile.dmr.tnom", \
            "pk.wl.w0.regfile.parity.tnom"
        ref_t = r0.sched.tenants[dmr]
        assert ref_t.status == "pruned"
        eng = pkg.ChaosEngine({"faults": [{"kind": "kill_fleet",
                                           "at_tick": seen["tick"] - 1}]})
        eng.kill_action = lambda rc, pkg=pkg: (_ for _ in ()).throw(
            pkg.FleetKilled(rc))
        outdir = str(tmp_path / pkg.name / "killed")
        runner = mod.ScenarioRunner(mfrom(_prune_doc("pk")), outdir,
                                    pareto_every=1, chaos=eng, mesh=mesh())
        with pytest.raises(pkg.FleetKilled):
            runner.serve()
        killed = runner.sched.tenants[dmr]
        assert killed.revoked == PRUNE_REASON + parity
        assert killed.status == "running"
        rec = mod.ScenarioRunner.recover(outdir, pareto_every=1,
                                         mesh=mesh())
        assert rec.sched.tenants[dmr].revoked == PRUNE_REASON + parity
        assert rec.run() == 0
        t = rec.sched.tenants[dmr]
        assert t.status == "pruned" and t.failures == 0
        assert t.trials == ref_t.trials
        assert rec.decisions(rec.sched) == {dmr: parity}
        results[pkg.name] = (copy.deepcopy(cell_rows(rec.sched)),
                             pareto_doc(outdir, "pk"))
    assert results["port"][0] == results["ref"][0]
    assert results["port"][1]["decisions"] == \
        results["ref"][1]["decisions"]
    assert_docs_close(results["port"][1], results["ref"][1])
