"""Fleet survivability in the port against the JAX package's, on the CPU
(continued from ``test_torch_fleet.py``, whose module fixture works
around the reference's faults R1 and R4 and whose helpers this module
shares).

The reference's ``tests/test_fleet_survive.py`` cases become parity
cases: ``kill_fleet`` at a fleet tick and at a journal ordinal, a torn
journal tail, compaction and clean shutdown, a poison tenant's
tick-counted backoff and durable quarantine, the tick watchdog, a
``corrupt_submission`` and a bad checksum routed to the bad spool, the
``ServerLock`` takeover of a stale lock, and a fleet drained (or killed)
by one package and resumed (or recovered) by the other, both ways.  Each
run's journal records, statuses and tallies equal the reference's and
the undisturbed run's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from shrewd_tpu.campaign import plan as RP
from shrewd_tpu_torch.resilience import load_json_verified

from test_torch_fleet import (PKGS, PORT, REF, _reference_on_jax_09,  # noqa: F401
                              fleet_doc, journal_records, plan_doc,
                              run_fleet, solo_tallies, strip_wall,
                              tallies_of)
from test_torch_ruby import one_torch_thread  # noqa: F401


def raising_kill(pkg, plan):
    eng = pkg.ChaosEngine(plan, worker="fleet")

    def _k(rc):
        raise pkg.FleetKilled(rc)

    eng.kill_action = _k
    return eng


THREE = {"a": plan_doc(3, ckpt_every=1), "b": plan_doc(5, n_batches=4),
         "c": plan_doc(7, n_batches=3)}


def killed_then_recovered(pkg, outdir, chaos_plan, plans, **kw):
    """A fleet of ``plans`` hard-killed by ``chaos_plan``, then
    recovered in the same package; returns (killed, recovered, journal
    records of both lives)."""
    eng = raising_kill(pkg, chaos_plan)
    with journal_records(pkg) as recs:
        sched = pkg.Sched(outdir=outdir, mesh=pkg.mesh(), chaos=eng, **kw)
        for n, p in plans.items():
            sched.admit(pkg.Spec(name=n, plan=p))
        with pytest.raises(pkg.FleetKilled):
            sched.run()
        assert pkg.is_dirty(outdir)
        rec = pkg.Sched.recover(outdir, mesh=pkg.mesh())
        assert not pkg.is_dirty(outdir)
        assert rec.recoveries == 1
        assert rec.run() == 0
    return sched, rec, recs


@pytest.mark.parametrize("fault", [
    {"kind": "kill_fleet", "at_tick": 5},
    {"kind": "kill_fleet", "at_journal": 4},
    {"kind": "torn_journal", "at_journal": 6},
], ids=["kill_at_tick", "kill_at_journal", "torn_tail"])
def test_hard_kill_recovers_like_the_reference(tmp_path, fault):
    """Killed mid-fleet (no drain, no checkpoint call), recovered from
    the snapshot and the write-ahead journal: every tenant equals its
    undisturbed solo run, and both lives' journal records, the replayed
    ledgers and the torn count equal the reference's."""
    plan = {"faults": [fault]}
    out = {pkg.name: killed_then_recovered(
        pkg, str(tmp_path / pkg.name), plan, THREE) for pkg in PKGS}
    (rk, rr, rrecs), (pk, pr, precs) = out["ref"], out["port"]
    assert strip_wall(precs) == strip_wall(rrecs)
    assert pk.schedule_log == rk.schedule_log
    assert pr.journal_torn == rr.journal_torn
    assert pr.journal_torn == (1 if fault["kind"] == "torn_journal" else 0)
    assert pk.chaos.injected == {fault["kind"]: 1}
    assert tallies_of(pr) == tallies_of(rr)
    assert pr._by_status() == {"complete": 3}
    for n, p in THREE.items():
        assert {k: v.tolist() for k, v in pr.tenant_tallies(n).items()} == \
            {k: v.tolist() for k, v in solo_tallies(p).items()}
    assert fleet_doc(str(tmp_path / "port")) == \
        fleet_doc(str(tmp_path / "ref"))
    if fault["kind"] == "torn_journal":
        with pytest.raises(ValueError, match="dirty"):
            eng = raising_kill(PORT, plan)
            s = PORT.Sched(outdir=str(tmp_path / "again"),
                           mesh=PORT.mesh(), chaos=eng)
            s.admit(PORT.Spec(name="a", plan=THREE["a"]))
            with pytest.raises(PORT.FleetKilled):
                s.run()
            PORT.Sched.resume(str(tmp_path / "again"), mesh=PORT.mesh())


def test_compaction_and_clean_shutdown(tmp_path):
    """A tiny ``compact_every`` folds the journal into the snapshot
    mid-run; a clean shutdown leaves an empty journal behind a current
    snapshot — in both packages, with equal snapshots."""
    scheds = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        sched, rc, _ = run_fleet(pkg, d, [("a", plan_doc(3, n_batches=3),
                                           {})], compact_every=3)
        assert rc == 0 and not pkg.is_dirty(d)
        recs, torn, _ = pkg.Journal.replay_path(pkg.journal_path(d))
        assert recs == [] and torn == 0
        scheds[pkg.name] = sched
    assert scheds["port"]._journal.compactions == \
        scheds["ref"]._journal.compactions >= 2
    snap = load_json_verified(str(tmp_path / "port" / "fleet_ckpt" /
                                  "fleet.json"))
    assert snap["version"] == 2 and snap["journal_seq"] >= 3
    assert fleet_doc(str(tmp_path / "port")) == \
        fleet_doc(str(tmp_path / "ref"))


def _poison(tmp_path):
    return RP.CampaignPlan(simpoints=[RP.TraceFileSpec(
        name="w0", path=str(tmp_path / "missing.npz"))],
        structures=["regfile"], batch_size=32, max_trials=64,
        min_trials=64).to_dict()


def test_poison_tenant_backoff_and_durable_quarantine(tmp_path):
    """A tenant whose plan cannot elaborate retries on the tick-counted
    exponential backoff, lands in durable ``quarantined`` with its
    ledger persisted and stays there across ``recover``; the good
    tenants' tallies and their fair-share order are untouched — at the
    same fleet ticks as the reference's."""
    good = {"g1": plan_doc(3), "g2": plan_doc(5, n_batches=4)}
    clean = run_fleet(PORT, None, [(n, p, {}) for n, p in good.items()])[0]
    runs = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        tenants = [("poison", _poison(tmp_path), {})] + [
            (n, p, {}) for n, p in good.items()]
        runs[pkg.name] = run_fleet(pkg, d, tenants, retry_budget=3,
                                   backoff_ticks=1)
    (rs, _, rrecs), (ps, prc, precs) = runs["ref"], runs["port"]
    assert prc == 0
    t, r = ps.tenants["poison"], rs.tenants["poison"]
    assert t.status == "quarantined" and t.failures == 4
    ticks = [e["tick"] for e in t.errors]
    assert ticks == [e["tick"] for e in r.errors]
    assert all(g >= 2 ** k for k, g in enumerate(np.diff(ticks)))
    # the same failure records, at the same ticks (the messages name
    # each package's own exception text)
    assert [(k, d.get("fleet_tick"), d.get("retry_at")) for k, d in precs
            if k in ("failure", "quarantine")] == \
        [(k, d.get("fleet_tick"), d.get("retry_at")) for k, d in rrecs
         if k in ("failure", "quarantine")]
    assert ps.schedule_log == rs.schedule_log
    assert [n for n in ps.schedule_log if n != "poison"] == \
        clean.schedule_log
    qdoc = load_json_verified(str(tmp_path / "port" / "tenants" /
                                  "poison" / "quarantine.json"))
    assert qdoc["failures"] == 4 and len(qdoc["errors"]) == 4
    for n, p in good.items():
        assert {k: v.tolist() for k, v in ps.tenant_tallies(n).items()} \
            == {k: v.tolist() for k, v in solo_tallies(p).items()}
    rec = PORT.Sched.recover(str(tmp_path / "port"), mesh=PORT.mesh())
    assert rec.tenants["poison"].status == "quarantined"
    assert rec.run() == 0
    assert rec.tenants["poison"].failures == 4


def test_tick_watchdog_preempts_livelocked_tenant():
    """A tick that never returns is abandoned at the ``DeviceWatchdog``
    deadline and the tenant takes the quarantine path, in both
    packages alike."""
    class Wedged:
        done = False
        results = None
        rc = 0

        def tick(self):
            time.sleep(3)

        def request_drain(self):
            pass

    for pkg in PKGS:
        sched = pkg.Sched(mesh=pkg.mesh(), tick_timeout=0.3,
                          retry_budget=0)
        sched.admit(pkg.Spec(name="live", plan=plan_doc(3, n_batches=2)))
        [t] = sched._candidates()
        t.driver = Wedged()
        t0 = time.monotonic()
        assert sched.run() == 0
        assert time.monotonic() - t0 < 2.5
        assert t.status == "quarantined"
        assert "DispatchTimeout" in t.errors[0]["error"]


def test_corrupt_submission_and_bad_checksum_go_to_bad_spool(tmp_path):
    """The ``corrupt_submission`` chaos kind poisons the scheduled spool
    document in place; a hand-rotted checksum does the same without
    chaos: both land in ``bad/`` with a reason, the fleet keeps serving
    and the good tenant equals its solo run — as in the reference."""
    runs = {}
    for pkg in PKGS:
        q = pkg.Queue(str(tmp_path / pkg.name / "spool"))
        late = q.submit(pkg.Spec(name="late", plan=plan_doc(13, 2)))
        rot = q.submit(pkg.Spec(name="rot", plan=plan_doc(17, 2)))
        path = os.path.join(q.pending_dir, rot)
        doc = json.load(open(path))
        doc["checksum"] = "0" * 64
        json.dump(doc, open(path, "w"))
        ok = q.submit(pkg.Spec(name="ok", plan=plan_doc(19, 2)))
        eng = pkg.ChaosEngine({"faults": [{"kind": "corrupt_submission",
                                           "at_submission": 0}]},
                              worker="fleet")
        sched, rc, recs = run_fleet(
            pkg, None, [("good", plan_doc(3, n_batches=2), {})],
            queue=q, chaos=eng)
        assert rc == 0 and eng.injected == {"corrupt_submission": 1}
        assert sorted(sched.tenants) == ["good", "ok"]
        assert q.bad_count() == 2 and q.pending() == []
        assert q.done(ok)["status"] == "complete"
        for ticket, why in ((late, "checksum"), (rot, "checksum")):
            reason = load_json_verified(
                os.path.join(q.bad_dir, ticket + ".reason"))
            assert why in reason["error"]
        runs[pkg.name] = (sched, recs)
    assert tallies_of(runs["port"][0]) == tallies_of(runs["ref"][0])
    assert strip_wall(runs["port"][1]) == strip_wall(runs["ref"][1])
    assert tallies_of(runs["port"][0])["good"] == {
        k: v.tolist()
        for k, v in solo_tallies(plan_doc(3, n_batches=2)).items()}


def test_server_lock_excl_and_stale_takeover(tmp_path):
    """One server per spool, whichever package holds it; a lock whose
    pid is dead, or whose content is torn, is reaped and taken."""
    root = str(tmp_path / "spool")
    for holder, other in ((REF, PORT), (PORT, REF)):
        lock = holder.ServerLock(root).acquire()
        with pytest.raises(other.LockHeld, match="held by live pid"):
            other.ServerLock(root).acquire()
        lock.release()
        with other.ServerLock(root):
            pass
    proc = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    with open(os.path.join(root, "server.lock"), "w") as f:
        f.write(f"{int(proc.stdout)}\n")
    lock = PORT.ServerLock(root).acquire()
    assert lock._holder() == os.getpid()
    lock.release()
    with open(os.path.join(root, "server.lock"), "w") as f:
        f.write("not-a-pid")
    PORT.ServerLock(root).acquire().release()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_fleet_drained_in_one_package_resumes_in_the_other(tmp_path,
                                                           writer, reader):
    """``fleet.json``, the journal and every tenant's v5 checkpoint are
    one format: a fleet drained by one package resumes in the other,
    and a fleet hard-killed by one recovers in the other, each to the
    undisturbed run's tallies."""
    plans = {"a": plan_doc(3), "b": plan_doc(5, sync_every=2),
             "c": plan_doc(7, n_batches=4, stratify=True)}
    want = {n: {k: v.tolist() for k, v in solo_tallies(p).items()}
            for n, p in plans.items()}

    def drain_at_3(s):
        if s.ticks == 3:
            s.request_drain()

    drained = str(tmp_path / "drained")
    sched, rc, _ = run_fleet(writer, drained,
                             [(n, p, {}) for n, p in plans.items()],
                             on_tick=drain_at_3)
    assert rc == 4 and sched._by_status() == {"preempted": 3}
    resumed = reader.Sched.resume(drained, mesh=reader.mesh())
    assert resumed.run() == 0
    assert resumed._by_status() == {"complete": 3}
    assert tallies_of(resumed) == want

    killed = str(tmp_path / "killed")
    eng = raising_kill(writer, {"faults": [{"kind": "kill_fleet",
                                            "at_tick": 4}]})
    s = writer.Sched(outdir=killed, mesh=writer.mesh(), chaos=eng)
    for n, p in plans.items():
        s.admit(writer.Spec(name=n, plan=p))
    with pytest.raises(writer.FleetKilled):
        s.run()
    assert reader.is_dirty(killed)
    rec = reader.Sched.recover(killed, mesh=reader.mesh())
    assert rec.recoveries == 1 and rec.run() == 0
    assert tallies_of(rec) == want


def test_recover_republishes_lost_done_doc(tmp_path):
    q = PORT.Queue(str(tmp_path / "spool"))
    ticket = q.submit(PORT.Spec(name="t", plan=plan_doc(3, n_batches=2)))
    sched = PORT.Sched(outdir=str(tmp_path / "out"), queue=q,
                       mesh=PORT.mesh())
    assert sched.run() == 0
    assert q.done(ticket)["status"] == "complete"
    os.unlink(os.path.join(q.done_dir, ticket))
    open(os.path.join(q.claimed_dir, ticket), "w").close()
    PORT.Sched.recover(str(tmp_path / "out"), queue=q, mesh=PORT.mesh())
    done = q.done(ticket)
    assert done["status"] == "complete" and done["results"]
    assert not os.path.exists(os.path.join(q.claimed_dir, ticket))


def test_revoke_journals_before_any_mutation(tmp_path, monkeypatch):
    """The write-ahead contract: a kill inside the ``revoke`` append
    leaves the decision unmade in memory."""
    sched = PORT.Sched(outdir=str(tmp_path), mesh=PORT.mesh())
    sched.admit(PORT.Spec(name="t", plan=plan_doc(3, n_batches=1)))
    t = sched.tenants["t"]
    real = PORT.Journal.append

    def boom(self, kind, data=None):
        if kind == "revoke":
            raise RuntimeError("kill inside append")
        return real(self, kind, data)

    monkeypatch.setattr(PORT.Journal, "append", boom)
    with pytest.raises(RuntimeError, match="inside append"):
        sched.revoke_quota("t", "pareto:rival")
    assert t.revoked == "" and t.status == "queued"
    monkeypatch.setattr(PORT.Journal, "append", real)
    assert sched.revoke_quota("t", "pareto:rival") is True
    assert t.revoked == "pareto:rival" and t.status == "pruned"


def test_survivability_stats_match_reference(tmp_path):
    docs = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        eng = raising_kill(pkg, {"faults": [{"kind": "kill_fleet",
                                             "at_tick": 3}]})
        sched = pkg.Sched(outdir=d, mesh=pkg.mesh(), chaos=eng)
        sched.admit(pkg.Spec(name="a", plan=plan_doc(3, n_batches=3)))
        with pytest.raises(pkg.FleetKilled):
            sched.run()
        rec = pkg.Sched.recover(d, mesh=pkg.mesh())
        assert rec.run() == 0
        with open(os.path.join(d, "fleet_stats.json")) as f:
            fleet = json.load(f)["fleet"]
        for k in ("tenant_throughput", "cache_hit_rate"):
            fleet.pop(k)
        docs[pkg.name] = fleet
    assert docs["port"] == docs["ref"]
    fleet = docs["port"]
    assert fleet["recoveries"] == 1 and fleet["journal_records"] > 0
    assert fleet["journal_compactions"] >= 1
    assert fleet["tenants_by_status"] == {"complete": 1}
