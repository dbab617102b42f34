"""The port's elastic pod pool (``federation/autoscale.py`` and the
gateway's pool ledger) against the JAX package's, on the CPU (continued
from ``test_torch_federation.py``, whose module fixture works around the
reference's faults R1 and R4 and whose helpers this module shares).

The reference's ``tests/test_autoscale.py`` is slow-tier, so these port
cases are the only check of the autoscaler that the quick tier runs.
Each reference case becomes a parity case: the pool chaos kinds refuse
and fire alike; the pool ledger journals and recovers the same records;
a retiring pod is fenced out of placement; the autoscaler's decisions
on a duck-typed gateway equal the reference's; an autoscaled pool grows
and contracts, also under ``kill_new_pod`` and ``kill_during_retire``,
and a recovery mid-retire completes the transition — each journaling the
same gateway records as the reference's (wall-clock fields aside) with
every tenant equal to its solo serial run; the pool's obs surfaces and
the HTTP front's ``/pool`` read back.  The pool-boundary crash sweep is
in ``test_torch_crashcheck.py``.

The reference's two compile-cache cases become the port's side of
departure D5 (ROADMAP Queue 3): the artifact store keeps the reference's
layout but for the ``exec/`` kind, which the port never makes, and pods
of one process share a window's ``TrialKernel`` through the kernel
registry instead of a persistent compile cache.
"""

import json
import os
import urllib.error
import urllib.request

import pytest

from shrewd_tpu.ingest.store import ArtifactStore as RefStore
from shrewd_tpu_torch.ingest.store import ArtifactStore
from shrewd_tpu_torch.parallel import exec_cache

from test_torch_federation import (PKGS, PORT, REF,  # noqa: F401
                                   _reference_on_jax_09, assert_matches,
                                   gateway_records, ledger, make_fed,
                                   solo, spec, strip)
from test_torch_ruby import one_torch_thread  # noqa: F401

POOL_BAD_PLANS = [
    [{"kind": "kill_during_retire"}],
    [{"kind": "kill_new_pod"}],
    [{"kind": "kill_new_pod", "at_scale": [1], "at_tick": [1]}],
    [{"kind": "kill_during_retire", "at_scale": [1], "at_round": [2]}],
    [{"kind": "kill_pod", "at_tick": [1], "at_scale": [1]}],
]


@pytest.mark.parametrize("faults", POOL_BAD_PLANS)
def test_pool_chaos_kinds_validation(faults):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(pkg.ChaosPlanError) as ei:
            pkg.ChaosEngine({"faults": faults})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _pool_hooks(pkg):
    eng = pkg.ChaosEngine({"faults": [
        {"kind": "kill_during_retire", "at_scale": [3], "pod": "auto1"},
        {"kind": "kill_new_pod", "at_scale": [2]}]})
    fired = []
    eng.kill_action = lambda rc=None: fired.append(rc)
    trace = []
    for call, pod, scale in (("retire", "auto1", 2), ("retire", "pod0", 3),
                             ("retire", "auto1", 3), ("retire", "auto1", 3),
                             ("new", "auto2", 1), ("new", "auto2", 2)):
        if call == "retire":
            eng.maybe_kill_during_retire(pod, scale)
        else:
            eng.maybe_kill_new_pod(pod, scale)
        trace.append((dict(eng.injected), len(fired)))
    return trace


def test_pool_chaos_hooks_fire_deterministically():
    trace = _pool_hooks(PORT)
    assert trace == _pool_hooks(REF)
    assert trace[1] == ({}, 0)
    assert trace[3] == ({"kill_during_retire": 1}, 1)
    assert trace[4] == ({"kill_during_retire": 1}, 1)
    assert trace[5] == ({"kill_during_retire": 1, "kill_new_pod": 1}, 2)


# --- the journaled pool ledger ----------------------------------------------

def _pool_ledger(pkg, root):
    with gateway_records(pkg) as recs:
        fed = make_fed(pkg, root, ("pod0", "pod1"))
        gw = fed.gateway
        name = gw.pool_scale_up(reason="pressure",
                                pressure={"score": 9000.0}, round=4)
        assert name == "auto1" and gw.scale_seq == 1
        assert gw.scaled_pods == {"auto1": 1}
        assert "auto1" in gw.pods and "auto1" in gw.live_pods()
        scale = gw.pool_retire_begin("auto1", reason="idle", round=7)
        assert scale == 2 and gw.scale_seq == 2
        assert "auto1" in gw.retiring and "auto1" not in gw.live_pods()
        st = gw.pool_status()
        assert st["pending_scale_decisions"] == 1 and st["size"] == 3
        assert st["retire_drain_rounds"] == {"auto1": None}
        with pytest.raises(ValueError):
            gw.pool_retire_begin("auto1")
        with pytest.raises(ValueError):
            gw.pool_retire_begin("nope")
        ports = {n: p.port for n, p in fed.pods.items()}
        gw2 = pkg.Gateway.recover(gw.outdir, pods=ports)
        assert gw2.scale_seq == 2 and gw2.scaled_pods == {"auto1": 1}
        assert "auto1" in gw2.pods and "auto1" in gw2.retiring
        assert gw2.retires["auto1"]["scale"] == 2
        assert "auto1" not in gw2.live_pods()
        gw2.pool_retire_done("auto1", round=9)
        assert "auto1" not in gw2.pods and not gw2.retiring
        assert gw2.retires["auto1"]["done_round"] == 9
        gw2.pool_retire_done("auto1", round=10)
        assert gw2.retires["auto1"]["done_round"] == 9
        assert gw2.pool_status()["retire_drain_rounds"] == {"auto1": 2}
        assert gw2.pool_scale_up(reason="again") == "auto3"
    up = [d for k, d in recs if k == "pool_scale_up"]
    assert up[0]["pod"] == "auto1" and up[0]["scale"] == 1
    assert up[0]["pressure"]["score"] == 9000.0
    return recs, gw2.pool_status()


def test_gateway_pool_ledger_journaled_and_recoverable(tmp_path):
    recs, status = _pool_ledger(PORT, str(tmp_path / "port"))
    rrecs, rstatus = _pool_ledger(REF, str(tmp_path / "ref"))
    assert strip(recs) == strip(rrecs)
    assert status == rstatus


def test_gateway_refuses_retire_that_empties_pool(tmp_path):
    msgs = []
    for pkg in PKGS:
        fed = make_fed(pkg, str(tmp_path / pkg.name), ("pod0",))
        with pytest.raises(RuntimeError,
                           match="no live pod would remain") as ei:
            fed.gateway.pool_retire_begin("pod0")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# --- retire fencing ---------------------------------------------------------

def _fenced_retire(pkg, root):
    with gateway_records(pkg) as recs:
        fed = make_fed(pkg, root, ("pod0", "pod1"))
        gw = fed.gateway
        fed.submit(spec(pkg, "t3", 3, 2))
        victim = gw.entries["t3"].pod
        other = [n for n in ("pod0", "pod1") if n != victim][0]
        gw.pool_retire_begin(victim, reason="test", round=1)
        fed.pods[victim].beat()
        assert victim not in gw.live_pods()
        assert gw._pick_pod() == other
        fed.submit(spec(pkg, "t5", 5, 2))
        assert gw.entries["t5"].pod == other
        assert gw.migrate("t5", victim, "test") is False
        assert fed.serve() == 0
    kinds = [(k, d.get("tenant") or d.get("pod")) for k, d in recs]
    assert kinds.index(("pool_retire_begin", victim)) \
        < kinds.index(("route", "t5"))
    assert fed.retired == 1
    assert gw.retires[victim]["done_round"] is not None
    assert gw.entries["t3"].pod == other
    assert any(h["reason"] == "migrate" and h["pod"] == other
               for h in gw.entries["t3"].history)
    return fed, recs


def test_retiring_pod_heartbeat_cannot_win_placement(tmp_path):
    fed, recs = _fenced_retire(PORT, str(tmp_path / "port"))
    rfed, rrecs = _fenced_retire(REF, str(tmp_path / "ref"))
    assert strip(recs) == strip(rrecs)
    assert ledger(fed) == ledger(rfed)
    assert_matches(fed, "t3", solo(3, 2))
    assert_matches(fed, "t5", solo(5, 2))


# --- the pressure control loop ----------------------------------------------

class _FakeGW:
    """A duck-typed gateway exposing exactly the decision surface the
    Autoscaler reads and the two journaling seams it may call."""

    def __init__(self, live, scores):
        self._live = list(live)
        self.scores = dict(scores)
        self.entries = {}
        self.retiring = set()
        self.scaled_pods = {n: i + 1 for i, n in enumerate(self._live)
                            if n.startswith("auto")}
        self.ups, self.downs = [], []

    def live_pods(self):
        return sorted(self._live)

    def pod_load(self, name):
        return {"score": self.scores[name]}

    def pool_scale_up(self, reason="", pressure=None, round=None):
        name = f"auto{len(self.ups) + 1}"
        self.ups.append((name, round, pressure))
        self._live.append(name)
        self.scores[name] = 0.0
        self.scaled_pods[name] = len(self.ups)
        return name

    def pool_retire_begin(self, pod, reason="", round=None):
        self.downs.append((pod, round))
        self._live.remove(pod)
        self.retiring.add(pod)
        return 99


def _control_loop(pkg):
    gw = _FakeGW(["pod0", "pod1"], {"pod0": 9000.0, "pod1": 7000.0})
    auto = pkg.Autoscaler(min_pods=1, max_pods=4, up_trials=1000.0,
                          down_trials=100.0, cooldown_rounds=2)
    out = [auto.tick(gw, 0), auto.tick(gw, 1), auto.tick(gw, 2)]
    gw.scores.update({n: 9000.0 for n in gw.scores})
    out.append(auto.tick(gw, 4))
    gw.scores.update({"pod0": 0.0, "pod1": 50.0,
                      "auto1": 30.0, "auto2": 10.0})
    out += [auto.tick(gw, 6), auto.tick(gw, 8)]
    gw.retiring.clear()
    out.append(auto.tick(gw, 10))
    gw.retiring.clear()
    del gw.scaled_pods["auto1"], gw.scaled_pods["auto2"]
    out.append(auto.tick(gw, 12))
    gw.retiring.clear()
    out.append(auto.tick(gw, 14))
    return out, gw.ups, gw.downs


def test_autoscaler_thresholds_cooldown_and_victim_policy():
    got = _control_loop(PORT)
    assert got == _control_loop(REF)
    out, ups, _downs = got
    assert out[0]["action"] == "scale_up" and out[0]["pod"] == "auto1"
    assert ups[0][2]["score"] == 8000.0
    assert out[1] is None
    assert out[2]["pod"] == "auto2" and out[3] is None
    assert out[4]["action"] == "retire" and out[4]["pod"] == "auto2"
    assert out[5] is None and out[6]["pod"] == "auto1"
    assert out[7]["pod"] == "pod0" and out[8] is None


def _backlog(pkg, root):
    fed = make_fed(pkg, root, ("pod0",))
    gw = fed.gateway
    fed.submit(spec(pkg, "t3", 3, 2))
    auto = pkg.Autoscaler()
    p = auto.pressure(gw)
    e = gw.entries["t3"]
    e.status, e.pod = "accepted", ""
    return p, auto.pressure(gw)


def test_autoscaler_pressure_reads_unplaced_backlog(tmp_path):
    p, p2 = _backlog(PORT, str(tmp_path / "port"))
    assert (p, p2) == _backlog(REF, str(tmp_path / "ref"))
    assert p["live"] == 1 and p["unplaced"] == 0 and p["score"] > 0
    assert p2["unplaced"] == 1 and p2["backlog_trials"] > 0


# --- the elastic pool end-to-end --------------------------------------------

def _auto(pkg):
    return pkg.Autoscaler(min_pods=1, max_pods=3, up_trials=64.0,
                          down_trials=16.0, cooldown_rounds=1)


SEEDS = (3, 5, 7, 11)


def test_federation_autoscaled_pool_grows_and_contracts(tmp_path):
    tenants = [(f"t{s}", s, 2, {}) for s in SEEDS]
    out = {}
    for pkg in PKGS:
        with gateway_records(pkg) as recs:
            fed = make_fed(pkg, str(tmp_path / pkg.name), ("pod0",),
                           autoscale=_auto(pkg))
            for name, seed, nb, _ in tenants:
                fed.submit(spec(pkg, name, seed, nb))
            assert fed.serve() == 0
        out[pkg.name] = (fed, recs)
    fed, recs = out["port"]
    rfed, rrecs = out["ref"]
    assert strip(recs) == strip(rrecs)
    assert ledger(fed) == ledger(rfed)
    assert (fed.scale_ups, fed.retired) == (rfed.scale_ups, rfed.retired)
    gw = fed.gateway
    assert fed.scale_ups >= 1 and fed.retired == fed.scale_ups
    assert sorted(gw.pods) == ["pod0"] and not gw.scaled_pods
    assert not gw.retiring
    st = gw.pool_status()
    assert st == rfed.gateway.pool_status()
    assert st["scale_seq"] == fed.scale_ups + fed.retired
    assert st["pending_scale_decisions"] == 0
    assert len(gw.retires) == fed.retired
    for pod, rec in gw.retires.items():
        assert pod.startswith("auto") and rec["done_round"] is not None
    for name, seed, nb, _ in tenants:
        assert_matches(fed, name, solo(seed, nb))
    pool = PORT.metrics.read_pool(gw.outdir)
    assert pool["scale_seq"] == st["scale_seq"] and pool["retiring"] == []
    with open(os.path.join(gw.outdir, "pool.prom")) as f:
        assert f"shrewd_fleet_pool_scale_seq {st['scale_seq']}" in f.read()


def test_federation_pool_chaos_killed_pods_survived(tmp_path):
    tenants = [(f"t{s}", s, 2, {}) for s in SEEDS]
    out = {pkg.name: None for pkg in PKGS}
    for pkg in PKGS:
        chaos = pkg.ChaosEngine({"faults": [
            {"kind": "kill_new_pod", "at_scale": [1]},
            {"kind": "kill_during_retire", "at_scale": [4]}]})
        with gateway_records(pkg) as recs:
            fed = make_fed(pkg, str(tmp_path / pkg.name), ("pod0",),
                           autoscale=_auto(pkg), chaos=chaos,
                           expiry_rounds=2)
            for name, seed, nb, _ in tenants:
                fed.submit(spec(pkg, name, seed, nb))
            assert fed.serve() == 0
        out[pkg.name] = (fed, chaos, recs)
    fed, chaos, recs = out["port"]
    assert strip(recs) == strip(out["ref"][2])
    assert ledger(fed) == ledger(out["ref"][0])
    assert chaos.injected == {"kill_new_pod": 1, "kill_during_retire": 1}
    assert chaos.survived == {"kill_new_pod": 1, "kill_during_retire": 1}
    gw = fed.gateway
    assert sorted(gw.pods) == ["pod0"] and not gw.retiring
    for rec in gw.retires.values():
        assert rec["done_round"] is not None
    for name, seed, nb, _ in tenants:
        assert_matches(fed, name, solo(seed, nb))


def _mid_retire(pkg, root):
    fed = make_fed(pkg, root, ("pod0", "pod1"))
    fed.submit(spec(pkg, "t3", 3, 2))
    victim = fed.gateway.entries["t3"].pod
    fed.gateway.pool_retire_begin(victim, reason="test", round=0)
    fed.gateway.checkpoint()
    fed2 = pkg.Federation.recover(root, pod_names=("pod0", "pod1"),
                                  mesh=pkg.mesh())
    assert victim in fed2.gateway.retiring
    assert fed2.serve() == 0
    assert not fed2.gateway.retiring
    assert fed2.gateway.retires[victim]["done_round"] is not None
    assert fed2.gateway.entries["t3"].pod != victim
    return fed2


def test_federation_recover_mid_retire_completes_transition(tmp_path):
    fed = _mid_retire(PORT, str(tmp_path / "port"))
    assert ledger(fed) == ledger(_mid_retire(REF, str(tmp_path / "ref")))
    assert_matches(fed, "t3", solo(3, 2))


# --- obs + HTTP surfaces ----------------------------------------------------

def test_pool_obs_surfaces_roundtrip(tmp_path):
    pool = {"size": 3, "live": 2, "retiring": ["auto1"],
            "pending_scale_decisions": 1, "scale_seq": 3,
            "scaled_pods": {"auto1": 1},
            "retire_drain_rounds": {"auto1": None, "auto2": 2}}
    texts = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        pkg.metrics.publish_pool(d, pool)
        assert pkg.metrics.read_pool(d) == pool
        with open(os.path.join(d, "pool.prom")) as f:
            texts[pkg.name] = f.read()
    text = texts["port"]
    assert text == texts["ref"]
    assert "shrewd_fleet_pool_size 3" in text
    assert "shrewd_fleet_pool_live 2" in text
    assert "shrewd_fleet_pool_pending_scale_decisions 1" in text
    assert "shrewd_fleet_pool_scale_seq 3" in text
    assert 'shrewd_fleet_pool_retire_drain_rounds{pod="auto2"} 2' in text
    assert 'pod="auto1"' not in text


def test_http_front_pool_endpoint(tmp_path):
    gw_dir = str(tmp_path / "gateway")
    front = PORT.HTTPFront(gw_dir, port=0).start()
    try:
        base = f"http://127.0.0.1:{front.port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/pool", timeout=10)
        assert ei.value.code == 404
        # a pool surface the reference's driver published reads back
        REF.metrics.publish_pool(gw_dir, {"size": 2, "live": 2,
                                          "scale_seq": 1})
        with urllib.request.urlopen(f"{base}/pool", timeout=10) as r:
            doc = json.load(r)
        assert doc["size"] == 2 and doc["scale_seq"] == 1
    finally:
        front.stop()


# --- departure D5: no persistent compile cache ------------------------------

def test_store_exec_dir_is_an_artifact_kind(tmp_path):
    """The reference's store has an ``exec/`` kind for jax's persistent
    compile cache; the port's keeps every other part of the layout and
    has no such kind (D5), so a federation root the port serves holds
    no ``store/exec/``."""
    ref = RefStore(str(tmp_path / "ref"))
    st = ArtifactStore(str(tmp_path / "port"))
    assert os.path.isdir(ref.exec_dir())
    assert not hasattr(st, "exec_dir")
    assert sorted(os.listdir(st.root)) == \
        sorted(n for n in os.listdir(ref.root) if n != "exec")
    assert (os.path.relpath(st.bin_dir, st.root),
            os.path.relpath(st.obj_root, st.root)) == \
        (os.path.relpath(ref.bin_dir, ref.root),
         os.path.relpath(ref.obj_root, ref.root))
    fed = make_fed(PORT, str(tmp_path / "fed"), ("pod0",))
    fed.submit(spec(PORT, "t3", 3, 2))
    assert fed.serve() == 0
    assert not os.path.exists(str(tmp_path / "fed" / "store" / "exec"))


def test_scheduler_enables_cross_pod_compile_cache(tmp_path):
    """Where the reference points every pod at one persistent compile
    cache in the shared store, the port's pods of one process share one
    ``TrialKernel`` per window through the kernel registry: a second pod
    serving a tenant on a window the first pod built builds no kernel."""
    ledger_ = exec_cache.cache()
    a = PORT.Sched(outdir=str(tmp_path / "podA"), mesh=PORT.mesh(),
                   store_dir=str(tmp_path / "store"))
    a.admit(spec(PORT, "x", 3, 2))
    assert a.run() == 0
    before, reused = ledger_.compiled, ledger_.reused
    b = PORT.Sched(outdir=str(tmp_path / "podB"), mesh=PORT.mesh(),
                   store_dir=str(tmp_path / "store"))
    b.admit(spec(PORT, "y", 5, 2))
    assert b.run() == 0
    assert ledger_.compiled == before
    assert ledger_.reused >= reused + 1
    assert not os.path.exists(os.path.join(str(tmp_path / "store"),
                                           "exec"))
