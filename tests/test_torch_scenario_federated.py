"""The port's ``FederatedScenarioRunner`` against the JAX package's and
against the port's solo ``ScenarioRunner``, on the CPU (continued from
``test_torch_scenario.py``, whose matrices and helpers this module
shares; the module fixture of ``test_torch_orchestrator.py`` works
around the reference's faults R1 and R4).

The closed loop's 12-cell matrix runs through a federation of two pods
with an ``Autoscaler``: its front is bitwise the solo runner's and
equals the reference's federated front.  A federated matrix whose driver
is killed after a prune recovers the killed predecessor's decisions from
the gateway ledger and finishes as the undisturbed run does, in both
packages.
"""

import numpy as np
import pytest

from shrewd_tpu.scenario import matrix as ref_matrix
from shrewd_tpu.scenario import runner as ref_runner
from shrewd_tpu.scenario.runner import PRUNE_REASON
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.parallel.mesh import make_mesh
from shrewd_tpu_torch.scenario import runner as port_runner

from test_torch_fleet import PORT, REF, _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401
from test_torch_scenario import (RTOL, _prune_doc, matrix_doc, pareto_doc,
                                 ref_mesh, split_floats)


def _front(doc):
    """The design search's front without the per-group ``cells`` key:
    which scheme-mate supplied a profile is provenance that may differ
    across pool schedules; everything the front decides on may not."""
    return {g: {k: v for k, v in r.items() if k != "cells"}
            for g, r in doc["search"].items()}


def _fed_runner(pkg, mod, mesh, matrix, root, **kw):
    from shrewd_tpu.federation import Autoscaler as RefAutoscaler
    from shrewd_tpu_torch.federation import Autoscaler

    auto = (RefAutoscaler if pkg is REF else Autoscaler)(
        min_pods=2, max_pods=3, up_trials=64.0, down_trials=16.0,
        cooldown_rounds=1)
    return mod.FederatedScenarioRunner(
        matrix, root, pod_names=("pod0", "pod1"), pareto_every=1,
        autoscale=auto, mesh=mesh(), **kw)


def test_federated_runner_front_matches_reference_and_solo(tmp_path):
    """The closed loop's matrix (``test_torch_scenario.py``) through a
    federation of two pods with an
    autoscaler: the port's federated front is bitwise the port's solo
    runner's, and equals the reference's federated front (assignments
    exactly, floats within ``RTOL``); the pool grows and contracts alike
    in both packages."""
    doc = matrix_doc("loop")
    solo = port_runner.ScenarioRunner(
        compat.matrix_from_dict(doc), str(tmp_path / "solo"),
        pareto_every=1, mesh=make_mesh(["cpu"]))
    assert solo.serve() == 0
    solo_doc = pareto_doc(str(tmp_path / "solo"), "loop")
    fronts = {}
    for pkg, mod, mesh, mfrom in (
            (REF, ref_runner, ref_mesh, ref_matrix.ScenarioMatrix.from_dict),
            (PORT, port_runner, lambda: make_mesh(["cpu"]),
             compat.matrix_from_dict)):
        root = str(tmp_path / pkg.name)
        runner = _fed_runner(pkg, mod, mesh, mfrom(doc), root)
        assert runner.serve() == 0
        fed = runner.fed
        assert fed.scale_ups >= 1 and fed.retired == fed.scale_ups
        assert sorted(fed.gateway.pods) == ["pod0", "pod1"]
        fronts[pkg.name] = (pareto_doc(root, "loop"), runner.decisions(fed),
                            (fed.scale_ups, fed.retired, fed.round))
    got, decisions, pool = fronts["port"]
    assert _front(got) == _front(solo_doc)
    assert got["search"]
    assert (decisions, pool) == fronts["ref"][1:]
    want = fronts["ref"][0]
    for g in want["search"]:
        assert [p["assignment"] for p in got["search"][g]["pareto"]] == \
            [p["assignment"] for p in want["search"][g]["pareto"]]
    g, gf = split_floats(_front(got))
    w, wf = split_floats(_front(want))
    assert g == w
    np.testing.assert_allclose(gf, wf, rtol=RTOL)


def test_federated_recover_reports_killed_predecessors_decisions(tmp_path):
    """A federated matrix (one pod, so the de-weighted ``dmr`` cell is
    still running when ``parity`` converges) whose driver dies hard once
    a prune has been
    executed: the recovered runner reports the killed predecessor's
    decisions from the gateway ledger alone, before any pod is rebuilt,
    then finishes with the undisturbed run's decisions and cells — in
    both packages alike."""

    class DriverKilled(Exception):
        pass

    def die(fed):
        for e in fed.gateway.entries.values():
            if str((e.result or {}).get("reason") or "").startswith(
                    PRUNE_REASON):
                raise DriverKilled()

    dmr, parity = "pk.wl.w0.regfile.dmr.tnom", \
        "pk.wl.w0.regfile.parity.tnom"
    results = {}
    for pkg, mod, mesh, mfrom in (
            (REF, ref_runner, ref_mesh, ref_matrix.ScenarioMatrix.from_dict),
            (PORT, port_runner, lambda: make_mesh(["cpu"]),
             compat.matrix_from_dict)):
        calm = mod.FederatedScenarioRunner(
            mfrom(_prune_doc("pk")), str(tmp_path / pkg.name / "calm"),
            pod_names=("pod0",), pareto_every=1, mesh=mesh())
        assert calm.serve() == 0
        assert calm.decisions(calm.fed) == {dmr: parity}
        root = str(tmp_path / pkg.name / "killed")
        runner = mod.FederatedScenarioRunner(
            mfrom(_prune_doc("pk")), root, pod_names=("pod0",),
            pareto_every=1, mesh=mesh(), on_round=die)
        with pytest.raises(DriverKilled):
            runner.serve()
        before = runner.decisions(runner.fed)
        rec = mod.FederatedScenarioRunner.recover(
            root, pod_names=("pod0",), pareto_every=1, mesh=mesh())
        assert all(p.sched is None for p in rec.fed.pods.values())
        assert rec.decisions(rec.fed) == before == {dmr: parity}
        assert rec.run() == 0
        assert rec.decisions(rec.fed) == calm.decisions(calm.fed)
        rows = {n: e.result["results"] for n, e in
                sorted(rec.fed.gateway.entries.items())
                if (e.result or {}).get("results")}
        assert rows == {n: e.result["results"] for n, e in
                        sorted(calm.fed.gateway.entries.items())
                        if (e.result or {}).get("results")}
        results[pkg.name] = (rec.decisions(rec.fed), rows,
                             pareto_doc(root, "pk")["decisions"])
    assert results["port"] == results["ref"]
