"""The port's elastic layer against the JAX package's, on the CPU.

The lease board (atomic claims, checksummed results, revocation with the
ABA guard) and heartbeat membership; a single elastic worker equals the
plain run; workers of the two packages share one coordination directory
and adopt each other's published results bit for bit (the documents are
the reference's); a lost worker's lease is revoked and its batch
reclaimed as the reference does; and a peer's result computed at another
effective batch size is refused.  The module fixture of
``test_torch_orchestrator.py`` works around the reference's faults R1 and
R4 under jax 0.9 (the reference's own elastic cases fail under R1).
"""

import os
import time

import numpy as np
import pytest

from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu.parallel import elastic as RE
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.chaos import tear_file
from shrewd_tpu_torch.parallel import elastic as PE
from shrewd_tpu_torch.sim.exit_event import ExitEvent
# the R1/R4 fixture (autouse), the one-device mesh and helpers
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     mesh, port_plan, result_key,
                                     tiny_plan)


def _plan():
    """Four batches (min_trials == max_trials), stratified, with the
    integrity checks at their defaults."""
    return tiny_plan("serial", stratify=True, max_batches=4,
                     min_trials=128)


def _results(orch):
    events = list(orch.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"     # either package
    return events, {k: result_key(r) for k, r in orch.results.items()}


@pytest.fixture(scope="module")
def clean():
    return _results(Orchestrator(port_plan(_plan()), device="cpu"))[1]


# --- the lease board and membership ---------------------------------------

def test_lease_board_claims_publishes_and_revokes(tmp_path):
    a = PE.LeaseBoard(str(tmp_path), "a")
    b = PE.LeaseBoard(str(tmp_path), "b")
    assert a.claim("w0.regfile.0")
    assert not b.claim("w0.regfile.0")          # exactly one winner
    assert a.owner("w0.regfile.0") == "a"
    assert b.done("w0.regfile.0") is None
    b.publish("w0.regfile.0", {"tally": [1, 2], "worker": "b"})
    assert a.done("w0.regfile.0")["tally"] == [1, 2]
    assert not a.revoke("w0.regfile.0", expected_owner="c")   # ABA guard
    assert a.owner("w0.regfile.0") == "a"       # ...gave the lease back
    assert a.revoke("w0.regfile.0", expected_owner="a")
    assert not a.revoke("w0.regfile.0")         # one winner among revokers
    assert b.claim("w0.regfile.0")              # reclaimable after revoke
    # a torn result reads as absent; a retract removes result and lease
    tear_file(b._done("w0.regfile.0"))
    assert a.done("w0.regfile.0") is None
    b.retract("w0.regfile.0")
    assert a.owner("w0.regfile.0") is None


def test_the_two_packages_read_each_others_board(tmp_path):
    """The same documents and checksums: a result one package publishes
    is a verified result to the other."""
    doc = {"batch_id": 3, "batch_size": 32, "tally": [20, 9, 3, 0],
           "strata": None, "tier": 0, "attempts": 1, "escapes": 2,
           "taint_trials": 32, "worker": "p"}
    PE.LeaseBoard(str(tmp_path), "p").publish("w0.fu.3", doc)
    ref = RE.LeaseBoard(str(tmp_path), "r")
    assert ref.done("w0.fu.3") == PE.LeaseBoard(str(tmp_path),
                                                "x").done("w0.fu.3")
    ref.publish("w0.fu.4", dict(doc, batch_id=4))
    assert PE.LeaseBoard(str(tmp_path), "p").done("w0.fu.4")["batch_id"] == 4
    assert ref.claim("w0.fu.5")
    assert PE.LeaseBoard(str(tmp_path), "p").owner("w0.fu.5") == "r"


def test_membership_sees_graceful_leave_and_staleness(tmp_path):
    hb = PE.HeartbeatWriter(str(tmp_path), "alpha", interval=0.05)
    m = PE.Membership(str(tmp_path), timeout=5.0)
    assert not m.alive("alpha")
    hb.start()
    assert m.alive("alpha") and m.workers() == ["alpha"]
    assert RE.Membership(str(tmp_path), timeout=5.0).workers() == ["alpha"]
    hb.stop()
    assert not m.alive("alpha")                 # graceful leave = gone
    hb.beat()
    old = time.time() - 100
    os.utime(hb.path, (old, old))
    assert not m.alive("alpha")                 # stale = lost


def test_obtain_gives_up_on_a_live_holder_and_drains(tmp_path):
    cfg = PE.ElasticConfig(poll_interval=0.01, claim_wait=0.1, lookahead=0)
    holder = PE.ElasticContext(str(tmp_path), "holder", cfg)
    holder.heartbeat.beat()                     # stays "alive"
    assert holder.board.claim("k")
    ctx = PE.ElasticContext(str(tmp_path), "waiter", cfg)
    with pytest.raises(PE.ElasticError):
        ctx.obtain("k", lambda: {"tally": []})
    with pytest.raises(PE.DrainRequested):
        ctx.obtain("k", lambda: {"tally": []}, should_abort=lambda: True)


# --- workers --------------------------------------------------------------

def test_a_single_worker_equals_the_plain_run(tmp_path, clean):
    ctx = PE.ElasticContext(str(tmp_path), "solo")
    orch = Orchestrator(port_plan(_plan()), device="cpu")
    orch.attach_elastic(ctx)
    try:
        _, got = _results(orch)
    finally:
        ctx.stop()
    assert got == clean
    n = sum(st.next_batch for st in orch.state.values())
    assert (ctx.claimed, ctx.adopted) == (n, 0)
    doc = ctx.board.done(ctx.key("w0", "regfile", 0))
    assert doc["worker"] == "solo" and sum(doc["tally"]) == 32
    assert {"tier", "escapes", "strata", "batch_size"} <= set(doc)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_workers_of_the_two_packages_adopt_each_other(tmp_path, mesh,
                                                      clean, first):
    """The first worker publishes every batch; a worker of the other
    package joins after it and adopts them all, compute-free, to the same
    results (agreement without a barrier, across packages)."""
    workers = {
        "reference": lambda: (RefOrch(_plan(), mesh=mesh),
                              RE.ElasticContext(str(tmp_path), "ref")),
        "port": lambda: (Orchestrator(port_plan(_plan()), device="cpu"),
                         PE.ElasticContext(str(tmp_path), "port"))}
    order = [first, "port" if first == "reference" else "reference"]
    got = {}
    for who in order:
        orch, ctx = workers[who]()
        orch.attach_elastic(ctx)
        try:
            got[who] = (_results(orch)[1], ctx.counters(), orch)
        finally:
            ctx.stop()
    n = sum(st.next_batch for st in got[order[0]][2].state.values())
    assert got[order[0]][1]["leases_claimed"] == n
    assert got[order[1]][1]["leases_adopted"] == n
    assert got[order[1]][1]["leases_claimed"] == 0
    assert got["port"][0] == got["reference"][0] == clean
    # the adopting worker's state (strata included) is the computing one's
    for key, st in got[order[0]][2].state.items():
        other = got[order[1]][2].state[key]
        np.testing.assert_array_equal(st.strata, other.strata)


def test_a_lost_workers_lease_is_revoked_and_reclaimed(tmp_path, clean):
    # a ghost worker claims batch 0, beats once, then "dies"
    ghost = PE.ElasticContext(str(tmp_path), "ghost")
    ghost.heartbeat.beat()
    assert ghost.board.claim(ghost.key("w0", "regfile", 0))
    old = time.time() - 100
    os.utime(ghost.heartbeat.path, (old, old))
    plan = port_plan(_plan())
    plan.elastic.heartbeat_timeout = 1.0
    ctx = PE.ElasticContext(str(tmp_path), "survivor", plan.elastic)
    orch = Orchestrator(plan, device="cpu")
    orch.attach_elastic(ctx)
    try:
        events, got = _results(orch)
    finally:
        ctx.stop()
    assert got == clean
    lost = [p for e, p in events if e is ExitEvent.WORKER_LOST]
    assert len(lost) == 1 and lost[0].worker == "ghost"
    assert "survivor" in lost[0].survivors
    assert ctx.counters() == {"workers_lost": 1, "leases_claimed": 8,
                              "leases_adopted": 0, "leases_revoked": 1,
                              "batches_reclaimed": 1}
    from shrewd_tpu_torch import stats
    assert "campaign.elastic.leases_revoked" in stats.dump_text(orch.stats)


def test_heterogeneous_batch_sizes_are_refused(tmp_path):
    """A peer whose mesh rounds the plan's batch size differently leases
    differently keyed batches under the same id: adoption fails loudly."""
    ctx = PE.ElasticContext(str(tmp_path), "b")
    ctx.board.publish(ctx.key("w0", "regfile", 0), {
        "worker": "a", "batch_id": 0, "batch_size": 36,
        "tally": [36, 0, 0, 0], "strata": None, "tier": 0, "attempts": 1,
        "escapes": 0, "taint_trials": 0})
    orch = Orchestrator(port_plan(_plan()), device="cpu")
    orch.attach_elastic(ctx)
    try:
        with pytest.raises(PE.ElasticError, match="batch_size"):
            list(orch.events())
    finally:
        ctx.stop()


def test_an_invalid_adopted_result_is_retracted_and_recomputed(tmp_path,
                                                              clean):
    ctx = PE.ElasticContext(str(tmp_path), "b")
    orch = Orchestrator(port_plan(_plan()), device="cpu")
    ctx.board.publish(ctx.key("w0", "regfile", 0), {
        "worker": "evil", "batch_id": 0, "batch_size": 32,
        "tally": [32, 0, 1, 0], "strata": None, "tier": 0, "attempts": 1,
        "escapes": 0, "taint_trials": 0})      # sum != batch_size
    orch.attach_elastic(ctx)
    try:
        _, got = _results(orch)
    finally:
        ctx.stop()
    assert got == clean
    assert orch.monitor.quarantined == 1
    assert orch.monitor.quarantine_log[0]["kind"] == "adopted"
