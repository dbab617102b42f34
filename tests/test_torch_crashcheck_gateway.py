"""The port's gateway-WAL crash sweep (``analysis/crashcheck.py
run_gateway_crashcheck``) on the CPU (continued from
``test_torch_crashcheck.py``; the module fixture of
``test_torch_federation.py`` works around the reference's faults R1 and
R4).

The reference's gateway sweeps become port cases, bounded as the
reference bounds them: the two-phase placement's boundaries
(``tests/test_federation.py``, eight points), a sharded campaign's merge
ledger swept whole, and the autoscaled pool's ``pool_*`` appends (the
streaming-ingest surface is ``test_torch_crashcheck_ingest.py``).  Each
recovery re-executed from a crash point
serves every tenant to the undisturbed run's tallies with each placed
tenant on exactly one pod: zero divergent recoveries.  Each sweep's
crash surface is held against the reference's recorder on the same
federation.
"""

import os

from test_torch_federation import (PORT, REF,  # noqa: F401
                                   _reference_on_jax_09)
from test_torch_ruby import one_torch_thread  # noqa: F401

POOL_KINDS = ("pool_scale_up", "pool_retire_begin", "pool_retire_done")


def ref_surface(tmp_path, plans, **kw):
    """The reference's recorded crash surface of the same federation:
    its recorder's labels, in order."""
    cc = REF.crashcheck
    pts = str(tmp_path / "ref_pts")
    os.makedirs(pts)
    rec_dir = str(tmp_path / "ref_rec")
    shards = kw.get("shards") or {}
    with cc.GatewayRecorder(rec_dir, pts) as rec:
        fed = REF.Federation(rec_dir, pod_names=kw["pod_names"],
                             mesh=REF.mesh(),
                             autoscale=kw["autoscale"]()
                             if kw.get("autoscale") else None)
        for name, plan in plans.items():
            fed.submit(REF.Spec(name=name, plan=plan,
                                shards=int(shards.get(name, 1))))
        assert fed.serve() == 0
    return [pt.label() for pt in rec.points]


def test_gateway_crashcheck_sweep(tmp_path):
    cc = PORT.crashcheck
    plans = cc.small_fleet_plans(seeds=(3,), n_batches=2)
    doc = cc.run_gateway_crashcheck(str(tmp_path / "sweep"), plans=plans,
                                    max_points=8, mesh=PORT.mesh())
    assert doc["failures"] == []
    assert doc["points_checked"] == 8 and doc["points_dropped"] > 0
    assert doc["torn_checks"] >= 1
    assert doc["boundaries_by_event"].get("append", 0) >= 3
    assert doc["events"] == ref_surface(tmp_path, plans,
                                        pod_names=("pod0", "pod1"))


def test_gateway_sharded_crashcheck_sweep(tmp_path):
    cc = PORT.crashcheck
    plans = cc.small_fleet_plans(seeds=(3,), n_batches=4)
    doc = cc.run_gateway_crashcheck(
        str(tmp_path / "sweep"), plans=plans, pod_names=("pod0", "pod1"),
        shards={"t0": 2}, mesh=PORT.mesh())
    assert doc["ok"] is True and doc["failures"] == []
    assert doc["shards"] == {"t0": 2}
    by_kind = doc["boundaries_by_kind"]
    assert by_kind.get("shard_split", 0) >= 1
    assert by_kind.get("shard_fold", 0) >= 1
    assert by_kind.get("shard_converged", 0) >= 1
    assert doc["torn_checks"] >= 3
    assert doc["events"] == ref_surface(tmp_path, plans,
                                        pod_names=("pod0", "pod1"),
                                        shards={"t0": 2})


def test_gateway_autoscaled_pool_boundary_crashcheck(tmp_path):
    cc = PORT.crashcheck
    plans = cc.small_fleet_plans(seeds=(3, 5), n_batches=2)

    def auto(pkg):
        return lambda: pkg.Autoscaler(min_pods=1, max_pods=2,
                                      up_trials=64.0, down_trials=16.0,
                                      cooldown_rounds=1)

    doc = cc.run_gateway_crashcheck(
        str(tmp_path / "cc"), plans, pod_names=("pod0",),
        autoscale=auto(PORT), mesh=PORT.mesh(),
        point_filter=lambda pt: pt.kind in POOL_KINDS)
    assert doc["autoscaled"] is True
    assert doc["failures"] == [] and doc["ok"] is True
    for kind in POOL_KINDS:
        assert doc["boundaries_by_kind"].get(kind, 0) >= 1
    assert doc["events"] == ref_surface(tmp_path, plans,
                                        pod_names=("pod0",),
                                        autoscale=auto(REF))
