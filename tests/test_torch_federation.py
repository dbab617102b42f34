"""The port's federation (``shrewd_tpu_torch/federation/``) against the JAX
package's, on the CPU.

The reference's ``tests/test_federation.py`` cases become parity cases:
the pod chaos kinds refuse and fire alike, the ETA estimator and its
metrics publication agree, the scheduler's ``step()``/``evict()`` seams
behave as the reference's, the pod supervisor's lease expiry is counted
in polls alike, and a federation of pods — routed by ETA, under
``kill_pod`` and ``partition_pod`` chaos, rebalanced, recovered from a
crash between the route decision and the pod handoff, recovered onto a
smaller pod set, re-placing a refused placement, fed through the HTTP
front — journals the same gateway records as the reference's (but for
their wall-clock fields: ``deadline_s`` is projected from the pods'
wall-clock serving rate, ``wall_s`` and a spec's ``submitted_at`` are
times) and ends with every tenant's tallies equal to its solo serial
run.  Two cases cross the packages: a gateway WAL, its spool and the
pods' state written by one package's killed driver recover in the
other's.

Module fixture: R1 and R4, as in ``test_torch_orchestrator.py``; the
reference runs its pods on a one-device mesh, the port on
``make_mesh(["cpu"])``.  ``test_torch_federation_shards.py``,
``test_torch_autoscale.py`` and ``test_torch_crashcheck.py`` share the
helpers below.
"""

import contextlib
import copy
import json
import os
import shutil
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from shrewd_tpu import chaos as ref_chaos
from shrewd_tpu import federation as ref_federation
from shrewd_tpu.analysis import crashcheck as ref_crashcheck
from shrewd_tpu.federation import gateway as ref_gateway
from shrewd_tpu.obs import metrics as ref_metrics
from shrewd_tpu.parallel import elastic as ref_elastic
from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu.parallel import stopping as ref_stopping
from shrewd_tpu.service import journal as ref_journal
from shrewd_tpu.service import queue as ref_queue
from shrewd_tpu.service import scheduler as ref_scheduler
from shrewd_tpu_torch import chaos as port_chaos
from shrewd_tpu_torch import federation as port_federation
from shrewd_tpu_torch.analysis import crashcheck as port_crashcheck
from shrewd_tpu_torch.federation import gateway as port_gateway
from shrewd_tpu_torch.obs import metrics as port_metrics
from shrewd_tpu_torch.parallel import elastic as port_elastic
from shrewd_tpu_torch.parallel import stopping as port_stopping
from shrewd_tpu_torch.parallel.mesh import make_mesh
from shrewd_tpu_torch.service import journal as port_journal
from shrewd_tpu_torch.service import queue as port_queue
from shrewd_tpu_torch.service import scheduler as port_scheduler

from test_torch_fleet import plan_doc, solo_tallies
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401


def _pkg(name, fed, gateway, chaos, crashcheck, metrics, elastic, stopping,
         queue, journal, sched, mesh):
    return types.SimpleNamespace(
        name=name, fed=fed, gateway=gateway, Federation=fed.Federation,
        Gateway=fed.Gateway, Autoscaler=fed.Autoscaler,
        HTTPFront=fed.GatewayHTTPFront, Supervisor=fed.PodSupervisor,
        ChaosEngine=chaos.ChaosEngine, ChaosPlanError=chaos.ChaosPlanError,
        chaos=chaos, crashcheck=crashcheck, metrics=metrics,
        HeartbeatWriter=elastic.HeartbeatWriter, stopping=stopping,
        Spec=queue.TenantSpec, Queue=queue.SubmissionQueue,
        Journal=journal.FleetJournal, Sched=sched.CampaignScheduler,
        IDLE=sched.IDLE, mesh=mesh)


REF = _pkg("ref", ref_federation, ref_gateway, ref_chaos, ref_crashcheck,
           ref_metrics, ref_elastic, ref_stopping, ref_queue, ref_journal,
           ref_scheduler, lambda: ref_make_mesh(jax.devices()[:1]))
PORT = _pkg("port", port_federation, port_gateway, port_chaos,
            port_crashcheck, port_metrics, port_elastic, port_stopping,
            port_queue, port_journal, port_scheduler,
            lambda: make_mesh(["cpu"]))
PKGS = (REF, PORT)

#: gateway-record and spec fields that hold wall-clock time or a
#: projection from the pods' wall-clock serving rate
WALL = ("wall_s", "deadline_s", "submitted_at")

_SOLO = {}


def solo(seed, n_batches):
    """The port's solo serial run of ``plan_doc(seed, n_batches)``
    (memoized: many cases share a plan)."""
    key = (seed, n_batches)
    if key not in _SOLO:
        _SOLO[key] = solo_tallies(plan_doc(seed, n_batches=n_batches))
    return _SOLO[key]


def spec(pkg, name, seed=3, n_batches=4, **kw):
    return pkg.Spec(name=name, plan=plan_doc(seed, n_batches=n_batches),
                    **kw)


def strip(obj):
    """A journal record (or any nested document) without ``WALL``."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in WALL}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


@contextlib.contextmanager
def gateway_records(pkg):
    """Every record the package's gateway WAL appends within the block,
    as (kind, data) in append order (read at the append: compaction
    truncates the file)."""
    recs = []
    real = pkg.Journal.append
    tail = os.path.join("gateway_ckpt", "journal.jsonl")

    def append(self, kind, data=None):
        if self.path.endswith(tail):
            recs.append((kind, copy.deepcopy(dict(data or {}))))
        return real(self, kind, data)

    pkg.Journal.append = append
    try:
        yield recs
    finally:
        pkg.Journal.append = real


def make_fed(pkg, root, pods=("pod0", "pod1", "pod2"), **kw):
    return pkg.Federation(root, pod_names=pods, mesh=pkg.mesh(), **kw)


def serve_fed(pkg, root, tenants, pods=("pod0", "pod1", "pod2"),
              faults=None, **kw):
    """A federation of ``pods`` in ``pkg`` serving ``tenants`` ((name,
    seed, n_batches, spec fields)) to convergence; returns (federation,
    its chaos engine, the gateway's records)."""
    chaos = pkg.ChaosEngine({"faults": faults}) if faults else None
    with gateway_records(pkg) as recs:
        fed = make_fed(pkg, root, pods, chaos=chaos, **kw)
        for name, seed, nb, extra in tenants:
            fed.submit(spec(pkg, name, seed, nb, **extra))
        assert fed.serve() == 0
    return fed, chaos, recs


def counters(fed):
    c = dict(fed.counters())
    c.pop("busy_s")
    return c


def ledger(fed):
    """The gateway's routing ledger, comparable across packages."""
    return {n: strip({"status": e.status, "pod": e.pod, "epoch": e.epoch,
                      "history": e.history, "shards": list(e.shards)})
            for n, e in fed.gateway.entries.items()}


def assert_matches(fed, name, want):
    got = fed.tenant_tallies(name)
    assert got.keys() == want.keys()
    for k, t in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), t)


def assert_same_federation(out, tenants):
    """Both packages' runs journaled the same gateway records, left the
    same ledger and counters, and every tenant equals its solo run."""
    (rf, rchaos, rrecs), (pf, pchaos, precs) = out["ref"], out["port"]
    assert strip(precs) == strip(rrecs)
    assert ledger(pf) == ledger(rf)
    assert counters(pf) == counters(rf)
    if pchaos is not None:
        assert pchaos.injected == rchaos.injected
        assert pchaos.survived == rchaos.survived
    for name, seed, nb, _ in tenants:
        assert_matches(pf, name, solo(seed, nb))
        assert_matches(rf, name, solo(seed, nb))


def run_both(tmp_path, tenants, **kw):
    out = {pkg.name: serve_fed(pkg, str(tmp_path / pkg.name), tenants,
                               **kw)
           for pkg in PKGS}
    assert_same_federation(out, tenants)
    return out["port"]


# --- chaos DSL: the pod kinds -----------------------------------------------

POD_BAD_PLANS = [
    [{"kind": "kill_pod", "pod": "p0"}],
    [{"kind": "partition_pod"}],
    [{"kind": "kill_pod", "at_tick": 1, "at_batch": 2}],
    [{"kind": "partition_pod", "at_round": 1, "at_tick": 2}],
    [{"kind": "kill_fleet", "at_tick": 1, "at_batch": 0}],
    [{"kind": "partition_pod", "at_round": 1, "rounds": 0}],
]


@pytest.mark.parametrize("faults", POD_BAD_PLANS)
def test_pod_chaos_kinds_validation(faults):
    """Each plan the reference refuses, the port refuses with the same
    message."""
    msgs = []
    for pkg in PKGS:
        with pytest.raises(pkg.ChaosPlanError) as ei:
            pkg.ChaosEngine({"faults": faults})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _pod_hooks(pkg):
    eng = pkg.ChaosEngine({"faults": [
        {"kind": "kill_pod", "pod": "p0", "at_tick": 5},
        {"kind": "partition_pod", "pod": "p1", "at_round": 2,
         "rounds": 3}]})
    killed = []
    eng.kill_action = lambda rc: killed.append(rc)
    trace = []
    for pod, tick in (("p1", 5), ("p0", 4), ("p0", 5), ("p0", 5)):
        eng.maybe_kill_pod(pod, tick=tick)
        trace.append(list(killed))
    parts = [eng.partition_active(p, r) for p, r in
             (("p1", 1), ("p1", 2), ("p1", 4), ("p1", 5), ("p0", 3))]
    eng2 = pkg.ChaosEngine({"faults": [
        {"kind": "kill_pod", "pod": "p", "at_tick": 0},
        {"kind": "partition_pod", "pod": "p", "at_round": 0}]})
    eng2.begin_batch(0)
    return trace, parts, dict(eng.injected), dict(eng2._armed)


def test_pod_chaos_hooks_fire_deterministically():
    got = _pod_hooks(PORT)
    assert got == _pod_hooks(REF)
    trace, parts, injected, armed = got
    assert trace == [[], [], [137], [137]]
    assert parts == [False, True, True, False, False]
    assert injected == {"kill_pod": 1, "partition_pod": 1}
    assert armed == {}


# --- the ETA estimator + its metrics publication ----------------------------

def test_eta_trials_estimator():
    """``eta_trials`` (float64 on the host) equals the reference's on a
    grid of trajectories, pooled and stratified."""
    strata = [[3, 40], [1, 30], [0, 10]]
    cases = [(0, 0, None, False, 0.95, 0.1, 500),
             (5, 4000, None, False, 0.95, 0.05, 100),
             (50, 200, None, False, 0.95, 0.01, 100),
             (4, 80, strata, True, 0.95, 0.02, 64),
             (4, 80, strata, True, 0.99, 0.2, 64),
             (17, 96, None, False, 0.9, 0.03, 512)]
    for c in cases:
        assert PORT.stopping.eta_trials(*c) == REF.stopping.eta_trials(*c)
    assert PORT.stopping.eta_trials(5, 4000, None, False, 0.95, 0.05,
                                    100) == 0.0
    hw = PORT.stopping.wilson(50, 200, 0.95).halfwidth
    assert PORT.stopping.eta_trials(50, 200, None, False, 0.95, 0.01,
                                    100) == pytest.approx(
        200 * ((hw / 0.01) ** 2 - 1.0))


def _eta_rows(pkg, outdir):
    seen = []

    def grab(s):
        try:
            seen.append(pkg.metrics.read(outdir))
        except (OSError, ValueError):
            pass

    sched = pkg.Sched(outdir=outdir, mesh=pkg.mesh(), on_tick=grab)
    sched.admit(spec(pkg, "t", 3, 4))
    assert sched.run() == 0
    rows = [s["tenants"]["t"] for s in seen
            if "eta_trials" in s.get("tenants", {}).get("t", {})]
    return rows, pkg.metrics.prometheus_text(seen[-1])


def test_metrics_publish_eta(tmp_path):
    rows, prom = _eta_rows(PORT, str(tmp_path / "port"))
    rrows, _ = _eta_rows(REF, str(tmp_path / "ref"))
    etas = [r["eta_trials"] for r in rows]
    assert etas == [r["eta_trials"] for r in rrows]
    assert [r["eta_ticks"] for r in rows] == \
        [r["eta_ticks"] for r in rrows]
    assert etas and all(a >= b for a, b in zip(etas, etas[1:]))
    assert etas[-1] == 0.0
    assert "eta_ticks" in rows[-1] and "eta_s" in rows[-1]
    assert "shrewd_fleet_tenant_eta_trials" in prom


# --- scheduler seams: step() and evict() ------------------------------------

def test_step_loop_is_exactly_run():
    logs = {}
    for pkg in PKGS:
        a = pkg.Sched(mesh=pkg.mesh())
        a.admit(spec(pkg, "x", 3))
        a.admit(spec(pkg, "y", 5))
        assert a.run() == 0
        b = pkg.Sched(mesh=pkg.mesh())
        b.admit(spec(pkg, "x", 3))
        b.admit(spec(pkg, "y", 5))
        while True:
            rc = b.step()
            assert rc is not pkg.IDLE
            if rc is not None:
                break
        assert rc == 0
        assert a.schedule_log == b.schedule_log
        for n in ("x", "y"):
            for k, t in a.tenant_tallies(n).items():
                np.testing.assert_array_equal(b.tenant_tallies(n)[k], t)
        logs[pkg.name] = b.schedule_log
    assert logs["port"] == logs["ref"]


def _evict_mid_campaign(pkg, root):
    pod_a, pod_b = os.path.join(root, "podA"), os.path.join(root, "podB")
    sched = pkg.Sched(outdir=pod_a, mesh=pkg.mesh())
    sched.admit(spec(pkg, "m", 3, 6))
    steps = 0
    while True:
        rc = sched.step()
        if isinstance(rc, int):
            break
        steps += 1
        if steps == 3:
            assert sched.evict("m", "rebalance") is True
    t = sched.tenants["m"]
    assert rc == 0 and t.status == "evicted" and t.evicted == "rebalance"
    assert 0 < t.trials < 32 * 6
    assert sched.evict("m") is False
    with pytest.raises(KeyError):
        sched.evict("nobody")
    os.makedirs(os.path.join(pod_b, "tenants"), exist_ok=True)
    shutil.copytree(os.path.join(pod_a, "tenants", "m"),
                    os.path.join(pod_b, "tenants", "m"))
    sched_b = pkg.Sched(outdir=pod_b, mesh=pkg.mesh())
    sched_b.admit(spec(pkg, "m", 3, 6))
    assert sched_b.run() == 0
    return t.trials, sched_b.tenant_tallies("m")


def test_evict_drains_and_recovers_elsewhere_bit_identical(tmp_path):
    trials, got = _evict_mid_campaign(PORT, str(tmp_path / "port"))
    rtrials, _ = _evict_mid_campaign(REF, str(tmp_path / "ref"))
    assert trials == rtrials
    for k, v in solo(3, 6).items():
        np.testing.assert_array_equal(got[k], v)


def test_evict_queued_releases_without_elaboration(tmp_path):
    sched = PORT.Sched(outdir=str(tmp_path), mesh=PORT.mesh())
    sched.admit(PORT.Spec(name="q", plan={"nonsense": True}))
    assert sched.evict("q", "moved") is True
    t = sched.tenants["q"]
    assert t.status == "evicted" and t.orch is None and t.failures == 0


def test_evict_decision_survives_hard_kill(tmp_path):
    outdir = str(tmp_path / "pod")
    sched = PORT.Sched(outdir=outdir, mesh=PORT.mesh())
    sched.admit(spec(PORT, "m", 3, 6))
    for _ in range(3):
        sched.step()
    assert sched.evict("m", "migrate") is True
    rec = PORT.Sched.recover(outdir, mesh=PORT.mesh())
    t = rec.tenants["m"]
    assert t.evicted == "migrate" and t.status == "queued"
    assert rec.run() == 0
    assert t.status == "evicted" and t.orch is None


# --- the pod supervisor -----------------------------------------------------

def _lease_trace(pkg, coord, writer):
    sup = pkg.Supervisor(coord, expiry_rounds=2)
    hb = writer.HeartbeatWriter(coord, "p0")
    out = []
    for beat in (True, True, False, False, True):
        if beat:
            hb.beat()
        out.append(sup.observe(["p0"])["p0"])
    sup2 = pkg.Supervisor(coord, expiry_rounds=2)
    sup2.observe(["ghost"])
    out.append(sup2.observe(["ghost"])["ghost"])
    return out


def test_pod_supervisor_round_counted_lease_expiry(tmp_path):
    """The lease verdicts of the reference's sequence, also when the
    heartbeats come from the other package's writer."""
    want = [True, True, True, False, True, False]
    for i, (sup, writer) in enumerate(((PORT, PORT), (PORT, REF),
                                       (REF, PORT))):
        assert _lease_trace(sup, str(tmp_path / f"c{i}"), writer) == want


def test_tenant_spec_slo_roundtrip():
    s = PORT.Spec(name="t", plan={"seed": 1}, slo_s=120.0)
    assert PORT.Spec.from_dict(s.to_dict()).slo_s == 120.0
    assert REF.Spec.from_dict(s.to_dict()).slo_s == 120.0
    assert PORT.Spec.from_dict(REF.Spec(
        name="t", plan={}, slo_s=7.5).to_dict()).slo_s == 7.5
    assert PORT.Spec.from_dict({"name": "old", "plan": {}}).slo_s == 0.0
    with pytest.raises(ValueError):
        PORT.Spec(name="t", plan={}, slo_s=-1.0)


# --- the federation (gateway + pods + driver) -------------------------------

def test_federation_routes_serves_bit_identical(tmp_path):
    from shrewd_tpu_torch.resilience import load_json_verified

    tenants = [(f"t{s}", s, 4, {}) for s in (3, 5, 7)]
    fed, _, recs = run_both(tmp_path, tenants, pods=("pod0", "pod1"))
    assert {e.pod for e in fed.gateway.entries.values()} == \
        {"pod0", "pod1"}
    assert [k for k, _ in recs].count("route") == 3
    snap = load_json_verified(os.path.join(
        str(tmp_path / "port"), "gateway", "gateway_ckpt", "gateway.json"))
    assert {e["status"] for e in snap["entries"]} == {"done"}


def test_federation_kill_pod_failover_bit_identical(tmp_path):
    tenants = [(f"t{s}", s, 6, {}) for s in (3, 5, 7)]
    fed, chaos, _ = run_both(
        tmp_path, tenants, expiry_rounds=2,
        faults=[{"kind": "kill_pod", "pod": "pod0", "at_tick": 3}])
    assert chaos.injected == {"kill_pod": 1}
    assert chaos.survived == {"kill_pod": 1}
    assert fed.gateway.dead_pods == {"pod0"}
    assert fed.failovers >= 1
    moved = [e for e in fed.gateway.entries.values()
             if any(h["pod"] == "pod0" for h in e.history)]
    assert moved and all(e.pod != "pod0" for e in moved)


def test_federation_partition_heals_without_duplicate(tmp_path):
    tenants = [(f"t{s}", s, 8, {}) for s in (3, 5)]
    fed, chaos, _ = run_both(
        tmp_path, tenants, pods=("pod0", "pod1"), expiry_rounds=2,
        faults=[{"kind": "partition_pod", "pod": "pod0", "at_round": 2,
                 "rounds": 4}])
    assert chaos.injected == {"partition_pod": 1}
    assert "pod0" not in fed.gateway.dead_pods
    assert fed.failovers >= 1
    for name, *_ in tenants:
        e = fed.gateway.entries[name]
        assert e.status == "done" and e.result is not None
    if fed.fenced:
        pod0 = fed.pods["pod0"].sched
        assert [t for t in (pod0.tenants.values() if pod0 else [])
                if t.status == "evicted"]


def test_federation_rebalances_on_eta_runaway(tmp_path):
    tenants = [(f"t{s}", s, 6, {}) for s in (3, 5, 7)]
    fed, _, _ = run_both(tmp_path, tenants, pods=("pod0", "pod1"),
                         rebalance_every=2, rebalance_factor=0.5)
    assert fed.migrations >= 1
    assert [e for e in fed.gateway.entries.values() if e.epoch > 1]


def _route_then_crash(pkg, root):
    """A crash between the route decision and the pod handoff, then two
    recoveries: returns (decided pod, pods holding the ticket, the
    recovered federation)."""
    fed = make_fed(pkg, root, ("pod0", "pod1"))

    class Boom(Exception):
        pass

    def explode(self, e):
        raise Boom()

    orig = pkg.Gateway._place
    pkg.Gateway._place = explode
    try:
        with pytest.raises(Boom):
            fed.submit(spec(pkg, "t3", 3))
    finally:
        pkg.Gateway._place = orig
    e = fed.gateway.entries["t3"]
    assert e.status == "routed" and not e.pod_ticket
    decided = e.pod
    ports = {n: p.port for n, p in fed.pods.items()}
    for p in fed.pods.values():
        assert pkg.gateway.find_spool_ticket(p.spool_dir, "t3") is None
    gw2 = pkg.Gateway.recover(os.path.join(root, "gateway"), pods=ports)
    assert gw2.recoveries == 1
    assert gw2.entries["t3"].status == "placed"
    assert gw2.entries["t3"].pod == decided
    gw3 = pkg.Gateway.recover(os.path.join(root, "gateway"), pods=ports)
    hits = [n for n, p in fed.pods.items()
            if pkg.gateway.find_spool_ticket(p.spool_dir, "t3")]
    assert len(os.listdir(os.path.join(
        fed.pods[decided].spool_dir, "pending"))) == 1
    fed.gateway = gw3
    assert fed.serve() == 0
    return decided, hits, fed


def test_gateway_recover_replays_route_without_double_place(tmp_path):
    decided, hits, fed = _route_then_crash(PORT, str(tmp_path / "port"))
    rdecided, rhits, rfed = _route_then_crash(REF, str(tmp_path / "ref"))
    assert hits == [decided] and (decided, hits) == (rdecided, rhits)
    assert ledger(fed) == ledger(rfed)
    assert_matches(fed, "t3", solo(3, 4))


def _smaller_pod_set(pkg, root):
    fed = make_fed(pkg, root, ("pod0", "pod1", "pod2"))
    fed.submit(spec(pkg, "t3", 3))
    placed_on = fed.gateway.entries["t3"].pod
    fed.gateway.checkpoint()
    survivors = tuple(n for n in ("pod0", "pod1", "pod2")
                      if n != placed_on)
    fed2 = pkg.Federation.recover(root, pod_names=survivors,
                                  mesh=pkg.mesh())
    e = fed2.gateway.entries["t3"]
    assert e.pod in survivors and e.status == "placed"
    assert any(h["reason"] == "failover" for h in e.history)
    assert fed2.serve() == 0
    return fed2


def test_gateway_recover_with_smaller_pod_set_fails_over(tmp_path):
    fed = _smaller_pod_set(PORT, str(tmp_path / "port"))
    assert ledger(fed) == ledger(_smaller_pod_set(REF,
                                                  str(tmp_path / "ref")))
    assert_matches(fed, "t3", solo(3, 4))


def _refused(pkg, root):
    fed = make_fed(pkg, root, ("pod0", "pod1"))
    fed.submit(spec(pkg, "t3", 3))
    e = fed.gateway.entries["t3"]
    first = e.pod
    pkg.Queue(fed.pods[first].spool_dir).mark_done(
        e.pod_ticket, {"tenant": "t3", "status": "refused",
                       "error": "tenant 't3' already admitted"})
    fed.gateway.poll()
    assert e.status == "placed" and e.pod != first
    assert any(h["reason"] == "refused" for h in e.history)
    assert fed.serve() == 0
    return fed


def test_gateway_refused_placement_is_rerouted_not_adopted(tmp_path):
    fed = _refused(PORT, str(tmp_path / "port"))
    assert ledger(fed) == ledger(_refused(REF, str(tmp_path / "ref")))
    assert_matches(fed, "t3", solo(3, 4))


# --- the thin HTTP front ----------------------------------------------------

def test_http_front_submit_and_status(tmp_path):
    root = str(tmp_path / "fed")
    gw_dir = os.path.join(root, "gateway")
    front = PORT.HTTPFront(gw_dir, port=0).start()
    try:
        assert front.host == "127.0.0.1"
        base = f"http://127.0.0.1:{front.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.load(r)["ok"] is True
        # a reference spec document over the wire: the format is shared
        s = REF.Spec(name="web", plan=plan_doc(3, n_batches=3), slo_s=600)
        req = urllib.request.Request(
            f"{base}/submit", data=json.dumps(s.to_dict()).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.load(r)
        assert doc["tenant"] == "web" and doc["ticket"]
        bad = urllib.request.Request(f"{base}/submit", data=b"{nope")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=10)
        assert ei.value.code == 400
        fed = make_fed(PORT, root, ("pod0", "pod1"))
        assert fed.serve() == 0
        assert_matches(fed, "web", solo(3, 3))
        assert fed.gateway.entries["web"].spec.slo_s == 600
        with urllib.request.urlopen(f"{base}/status", timeout=10) as r:
            snap = json.load(r)
        assert [e["spec"]["name"] for e in snap["entries"]] == ["web"]
        assert snap["entries"][0]["status"] == "done"
    finally:
        front.stop()


# --- across the packages ----------------------------------------------------

class DriverKilled(Exception):
    pass


def _killed_driver(pkg, root, tenants, at_round, faults=None):
    """A federation whose driver process dies hard at ``at_round`` (no
    drain, no snapshot, dirty WALs everywhere)."""
    chaos = pkg.ChaosEngine({"faults": faults}) if faults else None

    def die(fed):
        if fed.round == at_round:
            raise DriverKilled()

    fed = make_fed(pkg, root, chaos=chaos, on_round=die, expiry_rounds=2)
    for name, seed, nb, extra in tenants:
        fed.submit(spec(pkg, name, seed, nb, **extra))
    with pytest.raises(DriverKilled):
        fed.serve()
    return fed


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_gateway_wal_recovers_across_packages(tmp_path, writer, reader):
    """A gateway WAL, its spool and every pod's WAL and checkpoints
    written by one package's killed driver (one pod already dead by
    ``kill_pod``) recover in the other package, which serves every
    tenant to its solo tallies; a same-package recovery of a copy of
    that root journals the same records."""
    tenants = [(f"t{s}", s, 6, {}) for s in (3, 5, 7)]
    root = str(tmp_path / "fed")
    killed = _killed_driver(
        writer, root, tenants, at_round=4,
        faults=[{"kind": "kill_pod", "pod": "pod1", "at_tick": 2}])
    assert killed.pods["pod1"].dead
    twin = str(tmp_path / "twin")
    shutil.copytree(root, twin)
    out = {}
    for pkg, where in ((reader, root), (writer, twin)):
        with gateway_records(pkg) as recs:
            fed = pkg.Federation.recover(where, pod_names=(
                "pod0", "pod1", "pod2"), mesh=pkg.mesh(), expiry_rounds=2)
            assert fed.gateway.recoveries == 1
            assert fed.serve() == 0
        out[pkg.name] = (fed, recs)
    fed, recs = out[reader.name]
    assert strip(recs) == strip(out[writer.name][1])
    assert ledger(fed) == ledger(out[writer.name][0])
    for name, seed, nb, _ in tenants:
        assert_matches(fed, name, solo(seed, nb))
        assert fed.gateway.entries[name].status == "done"
