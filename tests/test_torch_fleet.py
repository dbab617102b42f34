"""The port's resident fleet (``shrewd_tpu_torch/service/``,
``obs/metrics.py`` and ``tools/fleet.py``) against the JAX package's, on
the CPU.

The same tenants, on the reference tests' tiny window (``n=96, nphys=32,
mem_words=64``, batch 32; ``tests/test_fleet.py _plan``), go through both
packages' ``CampaignScheduler``s: under ``fair`` and ``priority`` each
tenant's tallies are equal, and equal to its solo serial ``Orchestrator``
run; the schedule (the tenants of the journal's tick records, in order)
is equal; every journal record is equal but for its wall-clock seconds;
``fleet.json``'s tenants, the metrics snapshot and its Prometheus text
are equal but for the wall-clock fields and the kernel-registry counters
(the reference counts compiled executables, the port ``TrialKernel``s
built: ``OWN``).  The depth budget, quota, revocation of queued and
running tenants, a chaos ``kill_worker`` rescoped to its tenant, kernel
sharing on one window, the fleet CLI and one binary-in tenant are held
the same way.

Module fixture: R1 and R4, as in ``test_torch_orchestrator.py``; the
reference runs on a one-device mesh, the port on ``make_mesh(["cpu"])``.
"""

import base64
import contextlib
import copy
import hashlib
import io
import json
import os
import types

import jax
import numpy as np
import pytest

from shrewd_tpu import chaos as ref_chaos
from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu.obs import metrics as ref_metrics
from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu.service import journal as ref_journal
from shrewd_tpu.service import queue as ref_queue
from shrewd_tpu.service import scheduler as ref_scheduler
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu_torch import chaos as port_chaos
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.obs import metrics as port_metrics
from shrewd_tpu_torch.parallel import exec_cache
from shrewd_tpu_torch.parallel.mesh import make_mesh
from shrewd_tpu_torch.service import journal as port_journal
from shrewd_tpu_torch.service import queue as port_queue
from shrewd_tpu_torch.service import scheduler as port_scheduler
from shrewd_tpu_torch.sim.exit_event import ExitEvent

from test_torch_lift import needs_toolchain, shared_captures
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

# metrics fields that hold wall-clock time or count each package's own
# machinery (everything else in a snapshot must be equal)
OWN_FLEET = ("cache_compiled", "cache_reused", "cache_hit_rate")
OWN_TENANT = ("trials_per_s", "queue_latency_s", "eta_s")
OWN_PROM = ("shrewd_fleet_cache_hit_rate",
            "shrewd_fleet_tenant_trials_per_s",
            "shrewd_fleet_tenant_queue_latency_s",
            "shrewd_fleet_tenant_eta_s")


def _pkg(name, sched, queue, journal, metrics, chaos, mesh):
    return types.SimpleNamespace(
        name=name, Sched=sched.CampaignScheduler, Spec=queue.TenantSpec,
        Queue=queue.SubmissionQueue, ServerLock=queue.ServerLock,
        LockHeld=queue.LockHeld, FleetKilled=sched.FleetKilled,
        Journal=journal.FleetJournal, journal_path=journal.journal_path,
        is_dirty=journal.is_dirty, metrics=metrics,
        ChaosEngine=chaos.ChaosEngine, mesh=mesh)


REF = _pkg("ref", ref_scheduler, ref_queue, ref_journal, ref_metrics,
           ref_chaos, lambda: ref_make_mesh(jax.devices()[:1]))
PORT = _pkg("port", port_scheduler, port_queue, port_journal, port_metrics,
            port_chaos, lambda: make_mesh(["cpu"]))
PKGS = (REF, PORT)


def plan_doc(seed=3, n_batches=6, batch_size=32, mode="hybrid",
             stratify=False, sync_every=1, chaos=None, ckpt_every=0,
             depth=None, **kw):
    """``tests/test_fleet.py _plan`` as a plan document."""
    defaults = dict(structures=["regfile"], batch_size=batch_size,
                    target_halfwidth=0.2,
                    max_trials=batch_size * n_batches,
                    min_trials=batch_size * n_batches,
                    stratify=stratify, checkpoint_every=ckpt_every)
    defaults.update(kw)
    plan = RP.CampaignPlan(
        simpoints=[RP.WorkloadSpec(
            name="w0", workload=rsynth.WorkloadConfig(
                n=96, nphys=32, mem_words=64, working_set_words=32,
                seed=7))],
        seed=seed, **defaults)
    plan.machine.replay_kernel = mode
    plan.integrity.canary_trials = 0
    plan.integrity.audit_rate = 0.0
    plan.resilience.backoff_base = 0.0
    plan.pipeline.sync_every = sync_every
    if depth is not None:
        plan.pipeline.depth = depth
    if chaos:
        plan.chaos.spec = json.dumps(chaos)
    return plan.to_dict()


def solo_tallies(doc):
    """The port's run-to-completion serial campaign of one plan document
    → {(simpoint, structure): tallies}."""
    orch = Orchestrator(PP.CampaignPlan.from_dict(doc), device="cpu")
    events = list(orch.events())
    assert events[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
    return {k: np.asarray(v.tallies, dtype=np.int64)
            for k, v in dict(events[-1][1]).items()}


@contextlib.contextmanager
def journal_records(pkg):
    """Every record the package's fleet journals append within the
    block, as (kind, data), in append order — compaction truncates the
    file, so the records are read at the append."""
    recs = []
    real = pkg.Journal.append

    def append(self, kind, data=None):
        recs.append((kind, copy.deepcopy(dict(data or {}))))
        return real(self, kind, data)

    pkg.Journal.append = append
    try:
        yield recs
    finally:
        pkg.Journal.append = real


def strip_wall(recs):
    """Journal records without their wall-clock seconds and the queue
    latency a spool admission carries."""
    out = []
    for kind, data in recs:
        data = {k: v for k, v in data.items() if k != "wall_s"}
        if "spec" in data:
            data["spec"] = {k: v for k, v in data["spec"].items()
                            if k != "submitted_at"}
        out.append((kind, data))
    return out


def tick_order(recs):
    return [d["tenant"] for k, d in recs if k == "tick"]


def run_fleet(pkg, outdir, tenants, on_tick=None, **kw):
    """One fleet of ``tenants`` ((name, plan document, spec fields)) in
    ``pkg``; returns (scheduler, rc, journal records)."""
    with journal_records(pkg) as recs:
        sched = pkg.Sched(outdir=outdir, mesh=pkg.mesh(), on_tick=on_tick,
                          **kw)
        for name, doc, extra in tenants:
            sched.admit(pkg.Spec(name=name, plan=doc, **extra))
        rc = sched.run()
    return sched, rc, recs


def tallies_of(sched):
    return {n: {k: v.tolist() for k, v in sched.tenant_tallies(n).items()}
            for n in sched.tenants}


def fleet_doc(outdir):
    with open(os.path.join(outdir, "fleet_ckpt", "fleet.json")) as f:
        doc = json.load(f)
    doc.pop("checksum")
    for t in doc["tenants"]:
        t.pop("wall_s")
        t.pop("queue_latency_s")
    return doc


def snapshot_doc(snap):
    snap = copy.deepcopy(snap)
    snap.pop("wall_time")
    for k in OWN_FLEET:
        snap["fleet"].pop(k)
    for row in snap["tenants"].values():
        for k in OWN_TENANT:
            row.pop(k, None)
    return snap


def prom_lines(text):
    return [ln for ln in text.splitlines()
            if not any(ln.startswith(p) or ln.startswith(f"# HELP {p} ")
                       or ln.startswith(f"# TYPE {p} ") for p in OWN_PROM)]


def assert_fleets_equal(ref, port, rdir, pdir):
    (rs, rrc, rrecs), (ps, prc, precs) = ref, port
    assert prc == rrc
    assert tallies_of(ps) == tallies_of(rs)
    assert ps.schedule_log == rs.schedule_log
    assert tick_order(precs) == tick_order(rrecs)
    assert strip_wall(precs) == strip_wall(rrecs)
    assert {n: t.status for n, t in ps.tenants.items()} == \
        {n: t.status for n, t in rs.tenants.items()}
    if rdir:
        assert fleet_doc(pdir) == fleet_doc(rdir)
        assert snapshot_doc(port_metrics.read(pdir)) == \
            snapshot_doc(ref_metrics.read(rdir))
        with open(os.path.join(pdir, "metrics.prom")) as a, \
                open(os.path.join(rdir, "metrics.prom")) as b:
            assert prom_lines(a.read()) == prom_lines(b.read())


# --- specs and the spool across packages ------------------------------------

def test_tenant_spec_and_spool_cross_packages(tmp_path):
    """A spec document is the same in both packages, and a spool written
    by either is claimed by the other, bad documents quarantined alike."""
    doc = plan_doc()
    for a, b in ((REF, PORT), (PORT, REF)):
        spec = a.Spec(name="t0", plan=doc, priority=2, weight=0.5,
                      quota_batches=7, binary_b64="AAEC",
                      binary_digest=hashlib.sha256(b"\0\1\2").hexdigest(),
                      ingest={"interval": 10})
        back = b.Spec.from_dict(json.loads(json.dumps(spec.to_dict())))
        assert back.to_dict() == spec.to_dict()
        assert back.verify_binary() == b"\0\1\2"
        q = a.Queue(str(tmp_path / f"spool_{a.name}"))
        t1 = q.submit(a.Spec(name="x", plan=doc))
        t2 = q.submit(a.Spec(name="y/z", plan=doc))
        # a complete document that fails its checksum is poison
        path = os.path.join(q.pending_dir, t2)
        d = json.load(open(path))
        d["priority"] = 9
        json.dump(d, open(path, "w"))
        other = b.Queue(q.root)
        claimed = other.claim()
        assert [t for t, _ in claimed] == [t1]
        assert claimed[0][1].to_dict() == a.Spec.from_dict(
            json.load(open(os.path.join(q.claimed_dir, t1)))).to_dict()
        assert other.bad_count() == 1 and a.Queue(q.root).bad_count() == 1
        assert t2.endswith("_y+z.json")
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.Spec(name="t", plan={}, weight=0.0)
        with pytest.raises(ValueError):
            pkg.Spec(name="t", plan={}, binary_b64="AA")


# --- the fleet under both policies ------------------------------------------

@pytest.mark.parametrize("policy", ["fair", "priority"])
def test_fleet_matches_reference_and_solo(tmp_path, policy):
    """Three tenants — pooled serial, pipelined (sync 2) and stratified —
    interleaved by the policy: every tenant's tallies, the schedule and
    every journal record equal the reference's; fleet.json, the metrics
    snapshot and the Prometheus text equal it but for OWN; and each
    tenant equals its solo serial run."""
    tenants = [
        ("a", plan_doc(3, n_batches=6), {"weight": 1.0, "priority": 0}),
        ("b", plan_doc(5, n_batches=6, sync_every=2),
         {"weight": 3.0, "priority": 1 if policy == "priority" else 0}),
        ("c", plan_doc(11, n_batches=4, stratify=True),
         {"weight": 2.0, "priority": 0}),
    ]
    out = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        out[pkg.name] = (run_fleet(pkg, d, tenants, policy=policy), d)
    (ref, rdir), (port, pdir) = out["ref"], out["port"]
    assert port[1] == 0
    assert_fleets_equal(ref, port, rdir, pdir)
    ps = port[0]
    if policy == "priority":
        hi = ps.tenants["b"].ticks
        assert ps.schedule_log[:hi] == ["b"] * hi
    for name, doc, _ in tenants:
        assert {k: v.tolist() for k, v in ps.tenant_tallies(name).items()} \
            == {k: v.tolist() for k, v in solo_tallies(doc).items()}
    # the published surfaces read back equal to what publish returned
    snap = port_metrics.snapshot(ps)
    assert snapshot_doc(port_metrics.read(pdir)) == snapshot_doc(snap)
    assert snap["fleet"]["by_status"] == {"complete": 3}
    with open(os.path.join(pdir, "fleet_stats.json")) as f:
        fs = json.load(f)["fleet"]
    with open(os.path.join(rdir, "fleet_stats.json")) as f:
        rfs = json.load(f)["fleet"]
    for k in ("tenant_throughput", "cache_hit_rate"):
        fs.pop(k), rfs.pop(k)
    assert fs == rfs


def test_depth_budget_rebalances_as_tenants_come_and_go():
    """``depth_budget // running`` per tenant, the plan's depth as the
    ceiling, re-divided when a tenant leaves and when one arrives."""
    for pkg in PKGS:
        sched = pkg.Sched(mesh=pkg.mesh(), depth_budget=4)
        for name, seed in (("a", 3), ("b", 5)):
            sched.admit(pkg.Spec(name=name, plan=plan_doc(
                seed, n_batches=2, sync_every=2, depth=4)))
        both = sched._candidates()
        assert [t.orch.pcfg.depth for t in both] == [2, 2]
        sched.admit(pkg.Spec(name="c", plan=plan_doc(
            7, n_batches=2, sync_every=2, depth=1)))
        three = sched._candidates()
        assert [t.orch.pcfg.depth for t in three] == [1, 1, 1]
        sched.tenants["a"].status = "complete"
        sched.tenants["c"].status = "complete"
        sched._rebalance()
        assert sched.tenants["b"].orch.pcfg.depth == 4
        assert all(e.depth == 4
                   for e in sched.tenants["b"].orch._engines.values())


def test_quota_drains_to_resumable_checkpoint(tmp_path):
    tenants = [("q", plan_doc(3, n_batches=8), {"quota_batches": 3})]
    runs = {pkg.name: run_fleet(pkg, str(tmp_path / pkg.name), tenants)
            for pkg in PKGS}
    assert_fleets_equal(runs["ref"], runs["port"], str(tmp_path / "ref"),
                        str(tmp_path / "port"))
    t = runs["port"][0].tenants["q"]
    assert t.status == "quota" and t.batches == 3
    # the port's tenant checkpoint resumes in the reference (and so the
    # fleet's on-disk state is interchangeable per tenant)
    ckpt = str(tmp_path / "port" / "tenants" / "q" / "campaign_ckpt")
    ro = RefOrch.resume(ckpt, mesh=REF.mesh())
    list(ro.events())
    assert ro.state[("w0", "regfile")].tallies.tolist() == \
        solo_tallies(plan_doc(3, n_batches=8))[("w0", "regfile")].tolist()


# --- revocation --------------------------------------------------------------

def test_revoke_queued_and_running_tenants_matches_reference(tmp_path):
    """A queued tenant is pruned without elaboration; a running one
    drains to ``pruned`` and keeps its partial tallies; the journaled
    ``revoke`` records and every status equal the reference's."""
    def revoker(state):
        def on_tick(s):
            t = s.tenants["running"]
            if not state and 0 < t.trials < 32 * 8:
                state.append(s.revoke_quota("running", "test: dominated"))
                state.append(s.revoke_quota("running", "again"))
        return on_tick

    tenants = [("running", plan_doc(3, n_batches=8), {}),
               ("queued", plan_doc(5, n_batches=2), {"priority": -1}),
               ("bystander", plan_doc(7, n_batches=2), {})]
    runs = {}
    for pkg in PKGS:
        state = []
        d = str(tmp_path / pkg.name)
        with journal_records(pkg) as recs:
            sched = pkg.Sched(outdir=d, mesh=pkg.mesh(),
                              on_tick=revoker(state))
            for name, doc, extra in tenants:
                sched.admit(pkg.Spec(name=name, plan=doc, **extra))
            assert sched.revoke_quota("queued", "operator: superseded")
            with pytest.raises(KeyError):
                sched.revoke_quota("nobody")
            rc = sched.run()
        assert state == [True, False]
        runs[pkg.name] = (sched, rc, recs)
    assert_fleets_equal(runs["ref"], runs["port"], str(tmp_path / "ref"),
                        str(tmp_path / "port"))
    ps, _, precs = runs["port"]
    revokes = [d for k, d in precs if k == "revoke"]
    assert [r["tenant"] for r in revokes] == ["queued", "running"]
    q, r = ps.tenants["queued"], ps.tenants["running"]
    assert q.status == "pruned" and q.trials == 0 and q.failures == 0
    assert r.status == "pruned" and r.rc == Orchestrator.RC_PREEMPTED
    assert 0 < r.trials < 32 * 8
    assert r.results["w0/regfile"]["trials"] == r.trials
    assert not ps.revoke_quota("running", "too late")
    assert port_metrics.snapshot(ps)["fleet"]["pruned"] == 2


# --- chaos isolation ---------------------------------------------------------

def test_kill_worker_rescoped_to_tenant_matches_reference(tmp_path):
    """A chaos ``kill_worker`` tears down only its tenant's driver; the
    scheduler rebuilds it from its namespaced checkpoint and both
    tenants end equal to their solo runs and to the reference's."""
    victim = plan_doc(3, chaos={"faults": [{"kind": "kill_worker",
                                            "at_batch": 2}]}, ckpt_every=1)
    tenants = [("victim", victim, {}),
               ("bystander", plan_doc(5, n_batches=4), {})]
    runs = {pkg.name: run_fleet(pkg, str(tmp_path / pkg.name), tenants)
            for pkg in PKGS}
    assert_fleets_equal(runs["ref"], runs["port"], str(tmp_path / "ref"),
                        str(tmp_path / "port"))
    ps = runs["port"][0]
    v = ps.tenants["victim"]
    assert v.kills == 1 and v.status == "complete"
    assert v.orch.chaos.injected == {"kill_worker": 1}
    assert v.orch.chaos.survived == {"kill_worker": 1}
    assert ps.tenants["bystander"].kills == 0
    want = solo_tallies(plan_doc(3, ckpt_every=1))
    assert ps.tenant_tallies("victim")[("w0", "regfile")].tolist() == \
        want[("w0", "regfile")].tolist()


# --- kernel sharing ----------------------------------------------------------

def test_second_tenant_on_shared_window_builds_no_kernel():
    """The port's form of "zero new compiles": a fleet over a window a
    solo run already built shares its ``TrialKernel`` — the registry's
    ``compiled`` stays put and its hits grow."""
    warm = Orchestrator(PP.CampaignPlan.from_dict(plan_doc(3)),
                        device="cpu")
    list(warm.events())
    ledger = exec_cache.cache()
    before, reused = ledger.compiled, ledger.reused
    sched = PORT.Sched(mesh=PORT.mesh())
    sched.admit(PORT.Spec(name="x", plan=plan_doc(3)))
    sched.admit(PORT.Spec(name="y", plan=plan_doc(23)))
    assert sched.run() == 0
    assert ledger.compiled == before
    assert ledger.reused >= reused + 2
    assert ledger.stats()["compiled"] == ledger.compiled


# --- the fleet CLI -----------------------------------------------------------

def test_fleet_cli_matches_reference(tmp_path):
    """``python -m shrewd_tpu_torch.tools.fleet --plans … --platform
    cpu`` against the reference's ``tools/fleet.py`` on the same plan
    files: rc 0 and equal fleet.json tenants; ``--certify`` exits rc 2."""
    import importlib.util

    from shrewd_tpu_torch.tools import fleet as port_fleet

    spec = importlib.util.spec_from_file_location(
        "ref_tools_fleet", os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "fleet.py"))
    ref_fleet = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_fleet)
    paths = []
    for i, seed in enumerate((3, 5)):
        p = str(tmp_path / f"p{i}.json")
        json.dump(plan_doc(seed, n_batches=3), open(p, "w"))
        paths.append(p)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert ref_fleet.main(["--plans", *paths, "--outdir",
                               str(tmp_path / "ref")]) == 0
        assert port_fleet.main(["--plans", *paths, "--outdir",
                                str(tmp_path / "port"),
                                "--platform", "cpu"]) == 0
        assert port_fleet.main(["--plans", *paths, "--outdir",
                                str(tmp_path / "cert"), "--platform",
                                "cpu", "--certify", "strict"]) == 2
    assert "not in the port" in err.getvalue()
    assert fleet_doc(str(tmp_path / "port")) == \
        fleet_doc(str(tmp_path / "ref"))
    with pytest.raises(NotImplementedError):
        PORT.Sched(mesh=PORT.mesh(), certify="warn")


# --- a binary-in tenant ------------------------------------------------------

AXES = {"interval": 1500, "k": 2, "max_steps": 20000}


@needs_toolchain
def test_binary_in_tenant_matches_plan_twin_and_reference(tmp_path):
    """One ``workloads/sort.c`` tenant submitted as a binary: the port's
    scheduler ingests it (``IngestPipeline``) and its tallies equal its
    plan-path twin's (the resolved plan admitted as a plain tenant) and
    the reference's binary-in tenant's, both packages lifting one shared
    capture (``test_torch_lift.shared_captures``)."""
    from shrewd_tpu.ingest import pipeline as ref_pipeline
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest import pipeline as port_pipeline

    data = open(hd.build_tools("workloads/sort.c").workload, "rb").read()
    base = {"structures": ["regfile"], "batch_size": 64,
            "max_trials": 128, "min_trials": 128,
            "target_halfwidth": 0.01, "seed": 3,
            "integrity": {"canary_trials": 0, "audit_rate": 0.0}}
    spec_fields = dict(binary_b64=base64.b64encode(data).decode(),
                       binary_digest=hashlib.sha256(data).hexdigest(),
                       ingest=AXES)
    scheds = {}
    with shared_captures(port_pipeline, ref_pipeline, cache={}):
        for pkg in PKGS:
            d = str(tmp_path / pkg.name)
            sched = pkg.Sched(outdir=d, mesh=pkg.mesh())
            sched.admit(pkg.Spec(name="bin", plan=base, **spec_fields))
            assert sched.run() == 0
            scheds[pkg.name] = sched
    ps = scheds["port"]
    assert ps.tenants["bin"].status == "complete"
    assert (ps.ingest_captures, ps.ingest_lifts) == (
        scheds["ref"].ingest_captures, scheds["ref"].ingest_lifts)
    assert ps.ingest_captures >= 1
    assert tallies_of(ps) == tallies_of(scheds["ref"])
    # the plan-path twin: the ingest's resolved plan as a plain tenant
    pipe = port_pipeline.IngestPipeline(
        str(tmp_path / "port" / "tenants" / "bin" / "ingest"), ps.store,
        spec_fields["binary_digest"], axes=AXES)
    twin = PORT.Sched(mesh=PORT.mesh())
    twin.admit(PORT.Spec(name="twin", plan=pipe.resolved_plan(base)))
    assert twin.run() == 0
    assert tallies_of(twin)["twin"] == tallies_of(ps)["bin"]
    assert len(tallies_of(ps)["bin"]) == 2          # two SimPoint windows
