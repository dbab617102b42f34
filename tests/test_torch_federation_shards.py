"""Single-campaign sharding in the port's federation against the JAX
package's, on the CPU (continued from ``test_torch_federation.py``,
whose module fixture works around the reference's faults R1 and R4 and
whose helpers this module shares).

The reference's sharding cases of ``tests/test_federation.py`` become
parity cases: the shard chaos kinds refuse and fire alike; a campaign
striped over three pods, one stripe, more stripes than pods, a stripe
killed by ``kill_shard``, the sibling-aware failover pick and a
partition during the merge each journal the same gateway records as the
reference's (wall-clock fields aside) and fold to merged tallies equal
to the unsharded solo serial run.  The merge fold (``stopping.
merged_fold``) stays float64 on the host in both packages.  One case
holds the port where the reference fails (fault R9, ROADMAP Queue 3): a
stripe failed over in the round its campaign converges.
"""

import os

import pytest

from test_torch_federation import (PKGS, PORT, REF,  # noqa: F401
                                   _reference_on_jax_09, assert_matches,
                                   ledger, make_fed, run_both, solo, spec,
                                   strip)
from test_torch_ruby import one_torch_thread  # noqa: F401

SHARD_BAD_PLANS = [
    [{"kind": "kill_shard", "shard": "t+shard0"}],
    [{"kind": "partition_during_merge"}],
    [{"kind": "kill_shard", "at_tick": 1, "at_batch": 2}],
    [{"kind": "partition_during_merge", "at_fold": 1, "at_round": 2}],
    [{"kind": "partition_during_merge", "at_fold": 1, "rounds": 0}],
]


@pytest.mark.parametrize("faults", SHARD_BAD_PLANS)
def test_shard_chaos_kinds_validation(faults):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(pkg.ChaosPlanError) as ei:
            pkg.ChaosEngine({"faults": faults})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _shard_hooks(pkg):
    eng = pkg.ChaosEngine({"faults": [
        {"kind": "kill_shard", "shard": "camp+shard1", "at_round": 3},
        {"kind": "partition_during_merge", "pod": "p1", "at_fold": 2,
         "rounds": 3}]})
    killed = []
    eng.kill_action = lambda rc: killed.append(rc)
    trace = []
    for shard, rnd in (("camp+shard0", 3), ("camp+shard1", 2),
                       ("camp+shard1", 3), ("camp+shard1", 3)):
        eng.maybe_kill_shard(shard, round=rnd)
        trace.append(list(killed))
    merge = [eng.partition_merge_active(p, folds=f, round=r)
             for p, f, r in (("p1", 1, 4), ("p1", 2, 5), ("p1", 7, 7),
                             ("p1", 7, 8), ("p0", 9, 6))]
    eng2 = pkg.ChaosEngine({"faults": [
        {"kind": "kill_shard", "shard": "s", "at_round": 0},
        {"kind": "partition_during_merge", "pod": "p", "at_fold": 0}]})
    eng2.begin_batch(0)
    return trace, merge, dict(eng.injected), dict(eng2._armed)


def test_shard_chaos_hooks_fire_deterministically():
    got = _shard_hooks(PORT)
    assert got == _shard_hooks(REF)
    trace, merge, injected, armed = got
    assert trace == [[], [], [137], [137]]
    assert merge == [False, True, True, False, False]
    assert injected == {"kill_shard": 1, "partition_during_merge": 1}
    assert armed == {}


def _no_orphans(fed):
    for pod in fed.pods.values():
        if pod.sched is None:
            continue
        assert not [t for t in pod.sched.tenants.values()
                    if t.status in ("queued", "running")]


def test_federation_sharded_campaign_bit_identical(tmp_path):
    """One campaign striped over three pods, merged at the gateway: the
    merged tallies equal the unsharded solo run, and the admission doc
    and the merge ledger equal the reference's."""
    docs = {}
    for pkg in PKGS:
        fed = make_fed(pkg, str(tmp_path / f"adm_{pkg.name}"))
        docs[pkg.name] = fed.submit(spec(pkg, "camp", 3, 6, shards=3))
    doc = docs["port"]
    assert strip(doc) == strip(docs["ref"])
    assert doc["shards"] == [f"camp+shard{i}" for i in range(3)]
    assert doc["eta_trials"] == pytest.approx(192.0)
    fed, _, recs = run_both(tmp_path, [("camp", 3, 6, {"shards": 3})])
    e = fed.gateway.entries["camp"]
    assert e.status == "done" and e.converged
    assert e.result["status"] == "complete" and e.result["rc"] == 0
    assert e.result["trials"] == 192 and e.result["folds"] >= 1
    kids = [fed.gateway.entries[n] for n in e.shards]
    assert len({c.history[0]["pod"] for c in kids}) == 3
    _no_orphans(fed)
    assert set(fed.counters()["busy_s"]) == {"pod0", "pod1", "pod2"}
    kinds = [k for k, _ in recs]
    assert {"shard_split", "shard_fold", "shard_converged"} <= set(kinds)


def test_federation_shards_one_is_unsharded(tmp_path):
    kinds = {}
    for pkg in PKGS:
        for tag, extra in (("sharded1", {"shards": 1}), ("plain", {})):
            root = str(tmp_path / f"{pkg.name}_{tag}")
            fed = make_fed(pkg, root, ("pod0", "pod1"))
            fed.submit(spec(pkg, "t", 3, 4, **extra))
            assert fed.serve() == 0
            assert_matches(fed, "t", solo(3, 4))
            assert list(fed.gateway.entries) == ["t"]
            e = fed.gateway.entries["t"]
            assert e.shards == [] and e.fold_seq == 0
            records, _torn, _valid = pkg.Journal.replay_path(
                pkg.gateway.gateway_journal_path(
                    os.path.join(root, "gateway")))
            kinds[pkg.name, tag] = [r["kind"] for r in records]
    assert kinds["port", "sharded1"] == kinds["port", "plain"] \
        == kinds["ref", "plain"]
    assert "shard_split" not in kinds["port", "sharded1"]


def test_federation_shards_exceed_pods_queue_surplus(tmp_path):
    placed = {}
    for pkg in PKGS:
        fed = make_fed(pkg, str(tmp_path / f"adm_{pkg.name}"),
                       ("pod0", "pod1"))
        doc = fed.submit(spec(pkg, "camp", 3, 4, shards=4))
        assert len(doc["shards"]) == 4
        e = fed.gateway.entries["camp"]
        placed[pkg.name] = [fed.gateway.entries[n].status
                            for n in e.shards]
    assert placed["port"] == placed["ref"]
    assert placed["port"].count("placed") == 2
    assert placed["port"].count("accepted") == 2
    fed, _, _ = run_both(tmp_path, [("camp", 3, 4, {"shards": 4})],
                         pods=("pod0", "pod1"))
    e = fed.gateway.entries["camp"]
    assert all(fed.gateway.entries[n].status == "done" for n in e.shards)
    assert e.result["trials"] == 128
    _no_orphans(fed)


def test_federation_kill_shard_failover_bit_identical(tmp_path):
    fed, chaos, _ = run_both(
        tmp_path, [("camp", 3, 6, {"shards": 3})], expiry_rounds=2,
        faults=[{"kind": "kill_shard", "shard": "camp+shard1",
                 "at_round": 2}])
    assert chaos.injected == {"kill_shard": 1}
    assert chaos.survived == {"kill_shard": 1}
    assert len(fed.gateway.dead_pods) == 1
    assert fed.failovers >= 1
    dead = next(iter(fed.gateway.dead_pods))
    c = fed.gateway.entries["camp+shard1"]
    assert any(h["pod"] == dead for h in c.history)
    assert c.pod != dead and c.status == "done"


def _sibling_failover(pkg, root):
    pods = ("pod0", "pod1", "pod2", "pod3")
    fed = make_fed(pkg, root, pods)
    fed.submit(spec(pkg, "camp", 3, 6, shards=3))
    gw = fed.gateway
    hosts = {gw.entries[f"camp+shard{i}"].pod for i in range(3)}
    assert len(hosts) == 3
    spare = next(n for n in pods if n not in hosts)
    fed.submit(spec(pkg, "filler", 5, 6))
    assert gw.entries["filler"].pod == spare
    victim = gw.entries["camp+shard1"].pod
    gw.pod_dead(victim)
    e = gw.entries["camp+shard1"]
    assert e.pod == spare
    assert any(h["reason"] == "failover" for h in e.history)
    victim2 = gw.entries["camp+shard0"].pod
    gw.pod_dead(victim2)
    assert gw.entries["camp+shard0"].pod in {
        n for n in pods if n not in (victim, victim2)}
    return ledger(fed)


def test_shard_failover_prefers_pod_without_siblings(tmp_path):
    assert _sibling_failover(PORT, str(tmp_path / "port")) == \
        _sibling_failover(REF, str(tmp_path / "ref"))


def test_federation_partition_during_merge_bit_identical(tmp_path):
    fed, chaos, _ = run_both(
        tmp_path, [("camp", 3, 9, {"shards": 3})], expiry_rounds=2,
        faults=[{"kind": "partition_during_merge", "pod": "pod2",
                 "at_fold": 1, "rounds": 3}])
    assert chaos.injected == {"partition_during_merge": 1}
    assert chaos.survived == {"partition_during_merge": 1}
    assert "pod2" not in fed.gateway.dead_pods
    assert fed.gateway.entries["camp"].result["converged"] is True


def test_revocation_waits_for_a_failed_over_stripe_to_be_claimed(tmp_path):
    """Reference fault R9 (ROADMAP Queue 3): when ``kill_shard`` fails a
    stripe over in the round in which the merged trajectory converges,
    the reference's driver revokes the stripe on its new pod before that
    pod has claimed it from its spool, and ``revoke_quota`` raises
    ``KeyError``.  The port's driver waits a round for the claim (as it
    waits for a dead or partitioned pod) and folds to the unsharded solo
    run."""
    faults = {"faults": [{"kind": "kill_shard", "shard": "camp+shard1",
                          "at_round": 2}]}
    ref = make_fed(REF, str(tmp_path / "ref"), expiry_rounds=1,
                   chaos=REF.ChaosEngine(faults))
    ref.submit(spec(REF, "camp", 3, 3, shards=3))
    with pytest.raises(KeyError, match="camp\\+shard1"):
        ref.serve()
    chaos = PORT.ChaosEngine(faults)
    fed = make_fed(PORT, str(tmp_path / "port"), expiry_rounds=1,
                   chaos=chaos)
    fed.submit(spec(PORT, "camp", 3, 3, shards=3))
    assert fed.serve() == 0
    assert chaos.injected == chaos.survived == {"kill_shard": 1}
    assert fed.failovers == 1
    e = fed.gateway.entries["camp"]
    assert e.result["status"] == "complete" and e.converged
    assert fed.gateway.entries["camp+shard1"].status == "done"
    assert_matches(fed, "camp", solo(3, 3))
