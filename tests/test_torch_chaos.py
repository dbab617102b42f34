"""The port's chaos engine against the JAX package's, on the CPU.

The plan DSL's validation (the same plans refused with the same messages),
the seeded schedules and every hook's bookkeeping (``to_dict`` after the
same call sequence, the service- and federation-level hooks included) must
equal the reference's.  Each campaign-level fault kind — ``wedge``,
``backend_error`` (transient, and permanent on the device tier, which a
CPU campaign survives on the oracle tier), ``corrupt_tally``,
``torn_checkpoint`` and ``kill_worker`` — runs through both orchestrators
on the same plan: the events, results, checkpoint and ``stats.json`` (less
``PERF_OWN``; its ``chaos`` and ``integrity`` groups included) must be
equal, and the results the undisturbed run's.  ``kill_worker`` ends a
process with ``os._exit``; here both engines get a raising ``kill_action``
(a real kill runs in a child process, ``test_torch_multiprocess.py``).
The module fixture of ``test_torch_orchestrator.py`` works around the
reference's faults R1 and R4 under jax 0.9.
"""

import json

import pytest

from shrewd_tpu import chaos as RC
from shrewd_tpu import stats as ref_stats
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch import chaos as PC
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.resilience import BackendError
# the R1/R4 fixture (autouse), the one-device mesh and helpers
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     ckpt_doc, event_log, mesh, port_plan,
                                     result_key, stats_doc, tiny_plan)

# --- the plan DSL -------------------------------------------------------------

_BAD = {
    "unknown kind": {"faults": [{"kind": "meteor", "at_batch": 0}]},
    "no trigger": {"faults": [{"kind": "wedge"}]},
    "no ckpt trigger": {"faults": [{"kind": "torn_checkpoint"}]},
    "unknown tier": {"faults": [{"kind": "backend_error", "at_batch": 0,
                                 "tier": "gpu"}]},
    "no faults list": {"not_faults": []},
    "stray trigger": {"faults": [{"kind": "kill_pod", "at_batch": 1}]},
    "partition rounds": {"faults": [{"kind": "partition_pod",
                                     "at_round": 1, "rounds": 0}]},
}


@pytest.mark.parametrize("name", sorted(_BAD))
def test_bad_plans_are_refused_as_the_reference_refuses_them(name):
    with pytest.raises(RC.ChaosPlanError) as want:
        RC.ChaosEngine(_BAD[name])
    with pytest.raises(PC.ChaosPlanError) as got:
        PC.ChaosEngine(_BAD[name])
    assert str(got.value) == str(want.value)


_PLANS = {
    "campaign": {"seed": 3, "faults": [
        {"kind": "wedge", "at_batch": [0, 2], "times": 2},
        {"kind": "backend_error", "sample": {"k": 3, "of": 20},
         "tier": "device"},
        {"kind": "backend_error", "at_batch": 1, "tier": "oracle",
         "permanent": True},
        {"kind": "corrupt_tally", "at_batch": 1, "delta": 2},
        {"kind": "torn_checkpoint", "at_ckpt": [0, 2]},
        {"kind": "kill_worker", "after_dispatches": 4, "worker": "w1"}]},
    "seeded": {"seed": 12, "faults": [
        {"kind": "corrupt_tally", "sample": {"k": 5, "of": 50}},
        {"kind": "wedge", "sample": {"k": 2, "of": 9},
         "structure": "fu"}]},
    "service": {"faults": [
        {"kind": "kill_fleet", "at_tick": 3},
        {"kind": "torn_journal", "at_journal": [1, 4]},
        {"kind": "corrupt_submission", "at_submission": 0},
        {"kind": "kill_pod", "at_round": 2, "pod": "pod1"},
        {"kind": "partition_pod", "at_round": 1, "rounds": 2},
        {"kind": "kill_shard", "at_tick": 5, "shard": "t+shard1"},
        {"kind": "partition_during_merge", "at_fold": 1},
        {"kind": "corrupt_binary", "at_stage": 2},
        {"kind": "kill_during_lift", "at_stage": 3},
        {"kind": "kill_during_retire", "at_scale": 1},
        {"kind": "kill_new_pod", "at_scale": 2}]},
}


class _Killed(Exception):
    pass


def _drive(mod, plan):
    """One fixed sequence of every hook on an engine → (to_dict, the
    hooks' own returns)."""
    eng = mod.ChaosEngine(json.loads(json.dumps(plan)), worker="w1")

    def kill(rc):
        raise _Killed(rc)

    eng.kill_action = kill
    seen = []

    def note(f, *a, **k):
        try:
            seen.append(f(*a, **k))
        except _Killed as e:
            seen.append(("killed", e.args[0]))
        except Exception as e:  # noqa: BLE001 — the injected errors
            seen.append((type(e).__name__, str(e)))

    for b in range(6):
        eng.begin_batch(b, "w0", "fu" if b % 2 else "regfile")
        note(eng.next_batch_fault, b, "w0", "fu")
        note(eng.maybe_kill)
        wedge = eng.take_wedge(1.0)
        seen.append(None if wedge is None else wedge["deadline"])
        for tier in (0, 2):
            note(eng.maybe_backend_error, tier)
        note(eng.take_corrupt_tally)
        note(eng.take_torn_checkpoint)
        eng.end_batch()
    eng.begin_batches([7, 8, 9], "w0", "regfile")
    eng.end_batch()
    for t in range(6):
        note(eng.maybe_kill_fleet, tick=t, journal_seq=t)
        note(eng.take_torn_journal, t)
        note(eng.take_corrupt_submission)
        note(eng.maybe_kill_pod, "pod1", tick=t, round=t)
        note(eng.partition_active, "pod0", t)
        note(eng.maybe_kill_shard, "t+shard1", tick=t, round=t)
        note(eng.partition_merge_active, "pod0", t, t)
        note(eng.take_corrupt_binary, t)
        note(eng.maybe_kill_during_lift, t)
        note(eng.maybe_kill_during_retire, "pod2", t)
        note(eng.maybe_kill_new_pod, "pod3", t)
    eng.note_survived("wedge")
    return eng.to_dict(), json.loads(json.dumps(eng.faults)), seen


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_schedules_and_hooks_match_the_reference(name):
    got = _drive(PC, _PLANS[name])
    want = _drive(RC, _PLANS[name])
    assert got == want
    assert got[0]["injected"]           # the sequence fired something


def test_file_corruptors_match_the_reference(tmp_path):
    doc = {"a": list(range(40)), "checksum": "x"}
    for mod, tag in ((PC, "p"), (RC, "r")):
        for kind in ("tear", "rot", "json"):
            path = tmp_path / f"{tag}_{kind}.json"
            path.write_text(json.dumps(doc))
            {"tear": lambda p: mod.tear_file(p, 0.25),
             "rot": mod.rot_file,
             "json": mod.corrupt_json_checksum}[kind](str(path))
    for kind in ("tear", "rot", "json"):
        assert ((tmp_path / f"p_{kind}.json").read_bytes()
                == (tmp_path / f"r_{kind}.json").read_bytes())


# --- every campaign-level kind through both orchestrators -----------------

_KINDS = {
    "wedge": ([{"kind": "wedge", "at_batch": 0, "times": 1}],
              dict(dispatch_timeout=60.0)),
    "backend_error": ([{"kind": "backend_error", "at_batch": 1,
                        "tier": "device", "times": 1}], {}),
    "backend_error_permanent": ([{"kind": "backend_error", "at_batch": 0,
                                  "tier": "device", "permanent": True}],
                                dict(max_retries=0)),
    "corrupt_tally": ([{"kind": "corrupt_tally", "at_batch": 1,
                        "delta": 3}], {}),
    "torn_checkpoint": ([{"kind": "torn_checkpoint", "at_ckpt": 1}], {}),
}


def _chaos_plan(faults, mode="serial", **resilience):
    plan = tiny_plan(mode, stratify=True, checkpoint_every=1)
    plan.chaos.spec = json.dumps({"faults": faults})
    for k, v in resilience.items():
        setattr(plan.resilience, k, v)
    return plan


def _run_both(ref_plan, mesh, tmp_path):
    ro = RefOrch(ref_plan, mesh=mesh, outdir=str(tmp_path / "r"))
    po = Orchestrator(port_plan(ref_plan), outdir=str(tmp_path / "p"),
                      device="cpu")
    assert po.chaos is not None and po.watchdog.chaos is po.chaos
    return ro, list(ro.events()), po, list(po.events())


@pytest.fixture(scope="module")
def clean(mesh):
    po = Orchestrator(port_plan(tiny_plan("serial", stratify=True)),
                      device="cpu")
    list(po.events())
    return {k: result_key(r) for k, r in po.results.items()}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_each_kind_is_survived_as_the_reference_survives_it(
        mesh, tmp_path, clean, kind):
    faults, resilience = _KINDS[kind]
    ro, rev, po, pev = _run_both(_chaos_plan(faults, **resilience), mesh,
                                 tmp_path)
    assert pev[-1][0].name == "CAMPAIGN_COMPLETE"
    assert event_log(pev) == event_log(rev)
    assert {k: result_key(r) for k, r in po.results.items()} == clean
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)
    kind0 = faults[0]["kind"]
    assert po.chaos.injected == po.chaos.survived == {kind0: 1}
    assert po.chaos.to_dict() == ro.chaos.to_dict()
    if kind == "wedge":
        assert po.watchdog.timeouts == ro.watchdog.timeouts == 1
    if kind == "corrupt_tally":
        assert po.monitor.quarantined == po.monitor.recovered == 1
    if kind == "backend_error_permanent":
        # a CPU campaign descends to the oracle tier, as the reference's
        assert any(ev.name == "BACKEND_DEGRADED" for ev, _ in pev)


@pytest.mark.parametrize("mode", ["sync", "until"])
def test_faults_mid_interval_match_the_reference(mesh, tmp_path, clean,
                                                 mode):
    """The pipelined and until-CI engines arm the union of an interval's
    faults and recover serially on frozen keys, as the reference's do."""
    faults = [{"kind": "backend_error", "at_batch": 2, "tier": "device"},
              {"kind": "corrupt_tally", "at_batch": 5}]
    ro, rev, po, pev = _run_both(_chaos_plan(faults, mode), mesh, tmp_path)
    assert event_log(pev) == event_log(rev)
    assert {k: result_key(r) for k, r in po.results.items()} == clean
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    assert po.chaos.to_dict() == ro.chaos.to_dict()
    assert po.chaos.injected


def test_kill_worker_fires_where_the_reference_fires(mesh, tmp_path):
    faults = [{"kind": "kill_worker", "after_dispatches": 3, "rc": 137}]
    plan = _chaos_plan(faults)
    got = []
    for orch in (RefOrch(plan, mesh=mesh),
                 Orchestrator(port_plan(plan), device="cpu")):
        def kill(rc):
            raise _Killed(rc)

        orch.chaos.kill_action = kill
        n = 0
        with pytest.raises(_Killed, match="137"):
            for ev, _ in orch.events():
                n += ev.name == "BATCH_COMPLETE"
        got.append((n, orch.chaos.to_dict()))
    assert got[0] == got[1] and got[1][0] == 2


def test_a_backend_error_is_a_backend_error():
    eng = PC.ChaosEngine({"faults": [{"kind": "backend_error",
                                      "at_batch": 0}]})
    eng.begin_batch(0)
    with pytest.raises(BackendError, match="chaos: injected device-tier"):
        eng.maybe_backend_error(0)
