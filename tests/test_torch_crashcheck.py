"""The port's durability seam and crash-point checker
(``resilience.set_durability_hook`` / ``notify_durability``,
``analysis/crashcheck.py``) against the JAX package's, on the CPU
(continued from ``test_torch_federation.py``, whose module fixture works
around the reference's faults R1 and R4 and whose helpers this module
shares).

The seam is held first: on the same fleet, and on the same federation,
the port's recorder sees the reference's durability boundaries — each
journal append (with its seq and record kind), each compaction, each
atomic rename — in the reference's order.  The sweep enumerates its
crash points from those events, so their order is part of the result.
Then the reference's crash-check cases (``tests/test_fleet_survive.py``)
run on the port: the torn-tail model, the snapshot scrub, deterministic
enumeration, the negative control and the exhaustive sweep of a
3-tenant fleet.  The gateway sweeps are in
``test_torch_crashcheck_gateway.py``.
"""

import os

import numpy as np

from shrewd_tpu_torch.service.journal import journal_path

from test_torch_federation import (PKGS, PORT, REF,  # noqa: F401
                                   _reference_on_jax_09, make_fed)
from test_torch_ruby import one_torch_thread  # noqa: F401

def recorded_fleet(pkg, root, seeds=(3, 5, 7), n_batches=1,
                   compact_every=8):
    """The crash surface of one small fleet in ``pkg``: the recorder's
    labels, in order."""
    cc = pkg.crashcheck
    plans = cc.small_fleet_plans(seeds=seeds, n_batches=n_batches)
    rec_dir = os.path.join(root, f"rec_{pkg.name}")
    pts_dir = os.path.join(root, f"pts_{pkg.name}")
    os.makedirs(pts_dir)
    with cc.DurabilityRecorder(rec_dir, pts_dir) as rec:
        _sched, rc = cc._run_fleet(rec_dir, plans, mesh=pkg.mesh(),
                                   compact_every=compact_every)
    assert rc == 0
    return [pt.label() for pt in rec.points]


def test_durability_seam_fires_the_reference_events(tmp_path):
    """Appends (seq, kind), compactions and renames of a fleet that
    compacts every 4 records, in the reference's order."""
    port = recorded_fleet(PORT, str(tmp_path), (3, 5), 2, 4)
    ref = recorded_fleet(REF, str(tmp_path), (3, 5), 2, 4)
    assert port == ref
    events = {pt["event"] for pt in port}
    assert events == {"append", "compact", "rename"}
    seqs = [pt["seq"] for pt in port if pt["event"] == "append"]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def _gateway_events(pkg, root):
    cc = pkg.crashcheck
    pts = os.path.join(root, f"gpts_{pkg.name}")
    os.makedirs(pts)
    rec_dir = os.path.join(root, f"grec_{pkg.name}")
    with cc.GatewayRecorder(rec_dir, pts) as rec:
        fed = make_fed(pkg, rec_dir, ("pod0", "pod1"))
        for name, plan in cc.small_fleet_plans(seeds=(3, 5)).items():
            fed.submit(pkg.Spec(name=name, plan=plan))
        assert fed.serve() == 0
    return [pt.label() for pt in rec.points]


def test_gateway_recorder_sees_the_reference_boundaries(tmp_path):
    """The gateway sweep's crash surface — its WAL, its snapshot and the
    pod-spool handoffs of the two-phase placement — equals the
    reference's on the same federation."""
    port = _gateway_events(PORT, str(tmp_path))
    assert port == _gateway_events(REF, str(tmp_path))
    kinds = [pt["kind"] for pt in port]
    assert kinds.count("route") == kinds.count("place") == 2
    handoffs = [pt for pt in port if pt["path"].startswith("pods")]
    assert len(handoffs) == 2
    assert all(pt["event"] == "rename" for pt in handoffs)


def test_durability_hook_nests_and_clears():
    from shrewd_tpu_torch import resilience as resil

    seen = []
    prev = resil.set_durability_hook(lambda *a, **k: seen.append((a, k)))
    try:
        resil.notify_durability("append", "/x", seq=3, kind="tick")
        inner = resil.set_durability_hook(None)
        resil.notify_durability("rename", "/y")
        assert resil.set_durability_hook(inner) is None
    finally:
        resil.set_durability_hook(prev)
    assert seen == [(("append", "/x"), {"seq": 3, "kind": "tick"})]


# --- the reference's crash-check cases --------------------------------------

def test_tear_journal_tail_semantics(tmp_path):
    cc = PORT.crashcheck
    outdir = str(tmp_path)
    path = journal_path(outdir)
    assert cc.tear_journal_tail(outdir) is False
    j = PORT.Journal(path)
    for i in range(3):
        j.append("tick", {"i": i})
    j.close()
    assert cc.tear_journal_tail(outdir) is True
    recs, torn, _ = PORT.Journal.replay_path(path)
    assert [r["seq"] for r in recs] == [0, 1] and torn == 1
    assert cc.tear_journal_tail(outdir) is False
    # the reference's replay drops the same torn record
    recs2, torn2, _ = REF.Journal.replay_path(path)
    assert recs2 == recs and torn2 == torn


def test_snapshot_tree_scrubs_non_durable(tmp_path):
    src = tmp_path / "src"
    (src / "fleet_ckpt").mkdir(parents=True)
    (src / "fleet_ckpt" / "fleet.json").write_text("{}")
    (src / "metrics.json").write_text("{}")
    (src / "fleet_stats.json").write_text("{}")
    (src / "fleet_ckpt" / "fleet.json.tmp").write_text("{")
    (src / "hb_pod0.json").write_text("{}")
    (src / ".lock").write_text("1")
    kept = {}
    for pkg in PKGS:
        dst = str(tmp_path / f"dst_{pkg.name}")
        pkg.crashcheck.snapshot_tree(str(src), dst)
        kept[pkg.name] = sorted(os.path.relpath(os.path.join(r, f), dst)
                                for r, _d, fs in os.walk(dst) for f in fs)
    assert kept["port"] == kept["ref"] == \
        [os.path.join("fleet_ckpt", "fleet.json")]


def test_crash_point_enumeration_is_deterministic(tmp_path):
    a = recorded_fleet(PORT, str(tmp_path / "a"), (3,), 1)
    b = recorded_fleet(PORT, str(tmp_path / "b"), (3,), 1)
    assert a == b == recorded_fleet(REF, str(tmp_path / "r"), (3,), 1)
    assert any(pt["event"] == "append" for pt in a)
    assert any(pt["event"] == "rename" for pt in a)


def test_crashcheck_catches_divergence(tmp_path):
    cc = PORT.crashcheck
    plans = cc.small_fleet_plans(seeds=(3,), n_batches=1)
    pts = str(tmp_path / "pts")
    os.makedirs(pts)
    with cc.DurabilityRecorder(str(tmp_path / "rec"), pts) as rec:
        _s, rc = cc._run_fleet(str(tmp_path / "rec"), plans,
                               mesh=PORT.mesh())
    assert rc == 0
    base_sched, rc = cc._run_fleet(str(tmp_path / "base"), plans,
                                   mesh=PORT.mesh())
    assert rc == 0
    baseline = cc._tallies(base_sched)
    for lanes in baseline.values():
        for k in lanes:
            lanes[k] = lanes[k] + 1
    res = cc.check_point(rec.points[-1], str(tmp_path / "chk"), plans,
                         baseline, mesh=PORT.mesh())
    assert res["ok"] is False and res["identical"] is False


def test_crashcheck_three_tenant_fleet_exhaustive(tmp_path):
    """Every boundary of a 3-tenant fleet (and a torn tail of every
    append) recovers to the undisturbed tallies, journal seqs never
    regressing — and the surface swept is the reference's."""
    cc = PORT.crashcheck
    plans = cc.small_fleet_plans(seeds=(3, 5, 7), n_batches=1)
    doc = cc.run_crashcheck(str(tmp_path / "sweep"), plans=plans,
                            mesh=PORT.mesh())
    assert doc["ok"], doc["failures"][:3]
    assert doc["failures"] == [] and doc["seq_monotonic"]
    assert doc["points"] >= 15 and doc["torn_checks"] >= 8
    assert set(doc["boundaries_by_event"]) >= {"append", "rename"}
    assert sorted(doc["tenants"]) == ["t0", "t1", "t2"]
    assert doc["points_dropped"] == 0
    assert doc["events"] == recorded_fleet(REF, str(tmp_path / "r"))
    # the baseline is the reference's tallies of the same fleet
    ref_sched, rc = REF.crashcheck._run_fleet(
        str(tmp_path / "refbase"), REF.crashcheck.small_fleet_plans(
            seeds=(3, 5, 7), n_batches=1), mesh=REF.mesh())
    assert rc == 0
    ref_tallies = REF.crashcheck._tallies(ref_sched)
    assert doc["baseline_digest"] == cc._tally_digest(
        {n: {k: np.asarray(v, dtype=np.int64) for k, v in lanes.items()}
         for n, lanes in ref_tallies.items()})
