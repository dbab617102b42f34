"""The port's campaign plan against the JAX package's, on the CPU.

A plan's JSON must load in either package and dump back unchanged: the
default plan and one with every child and param off its default.  A
``TraceFileSpec`` window saved by either package loads in the other, and
a ``WorkloadSpec`` window is the reference's, array for array.  Every
option whose engine comes with a later slice raises
``NotImplementedError`` before a trial runs, and a default plan reaches
none of them; a plan naming a tier structure runs, and so does a plan
with a chaos plan inline or in a file (the chaos engine came with the
multi-device slice), as do a mesh, ``attach_chaos`` and
``attach_elastic``, and (since the checkpoint slice) a ``CheckpointSpec``
simpoint on the reference's literal checkpoint (``tests/test_ingest.py``),
whose ``build_trace`` gives a valid window."""

import json

import numpy as np
import pytest

from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.trace import format as rformat
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.trace import format as pformat
from shrewd_tpu_torch.trace import synth as psynth
from test_torch_ruby import one_torch_thread  # noqa: F401

_WL = dict(n=96, nphys=32, mem_words=64, working_set_words=32, seed=7)


def _full_plan(P, synth):
    """Every param and child off its default."""
    plan = P.CampaignPlan(
        simpoints=[P.WorkloadSpec(name="w0", workload=synth.WorkloadConfig(
                       n=200, nphys=64, mem_words=128, working_set_words=64,
                       frac_alu=0.4, frac_fp=0.1, locality=0.6, seed=3)),
                   P.TraceFileSpec(name="t1", path="win.npz"),
                   P.CheckpointSpec(name="c2", cpt_dir="cpt", thread=1,
                                    warmup=16, binary="a.out")],
        structures=["regfile", "fu", "rob", "iq", "lsq", "latch",
                    "cache:data", "mesi:state", "noc:router"],
        batch_size=512, target_halfwidth=0.02, confidence=0.99,
        max_trials=10_000, min_trials=2000, seed=11, checkpoint_every=3,
        stratify=True, coherence_accesses=64, coherence_mem_words=32,
        shard_index=1, shard_count=3)
    plan.machine.shadow_model = "fupool"
    plan.machine.replay_kernel = "dense"
    plan.resilience.dispatch_timeout = 30.0
    plan.resilience.escalation_action = "abort"
    plan.resilience.allow_cpu = False
    plan.integrity.canary_trials = 4
    plan.integrity.audit_alternate = "chunked"
    plan.integrity.audit_rate = 0.05
    plan.elastic.lookahead = 5
    plan.chaos.spec = '{"faults": []}'
    plan.pipeline.sync_every = 8
    plan.pipeline.until_ci = True
    plan.pipeline.compilation_cache_dir = "jaxcache"
    plan.analysis.certify = "warn"
    plan.cache.data_protection = "ecc"
    plan.mesi.n_cores = 4
    plan.noc.mesh_x = 3
    return plan


@pytest.mark.parametrize("which", ["default", "full"])
def test_plan_round_trips_through_both_packages(which):
    ref = (RP.CampaignPlan(simpoints=[RP.WorkloadSpec(name="w0")])
           if which == "default" else _full_plan(RP, rsynth))
    mine = (PP.CampaignPlan(simpoints=[PP.WorkloadSpec(name="w0")])
            if which == "default" else _full_plan(PP, psynth))
    d = ref.to_dict()
    assert mine.to_dict() == d
    # through JSON, both ways
    doc = json.loads(json.dumps(d))
    assert PP.CampaignPlan.from_dict(doc).to_dict() == d
    assert RP.CampaignPlan.from_dict(
        json.loads(json.dumps(PP.CampaignPlan.from_dict(doc).to_dict()))
    ).to_dict() == d


def test_config_dump_json_matches_reference(tmp_path):
    ref, mine = _full_plan(RP, rsynth), _full_plan(PP, psynth)
    ref.dump_json(tmp_path / "ref.json")
    mine.dump_json(tmp_path / "mine.json")
    assert ((tmp_path / "mine.json").read_text()
            == (tmp_path / "ref.json").read_text())


def test_workload_window_matches_reference():
    cfg = dict(_WL, frac_alu=0.35, frac_fp=0.15, seed=5)
    ref = rsynth.generate(rsynth.WorkloadConfig(**cfg))
    mine = PP.WorkloadSpec(
        name="w", workload=psynth.WorkloadConfig(**cfg)).build_trace()
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(mine, f)
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert a.dtype == b.dtype, f


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trace_file_spec_round_trips(tmp_path, writer):
    t = rsynth.generate(rsynth.WorkloadConfig(**_WL))
    path = tmp_path / "win.npz"
    (rformat if writer == "reference" else pformat).save(
        path, t, meta={"source": "synth"})
    mine = PP.TraceFileSpec(name="t", path=str(path)).build_trace()
    ref = RP.TraceFileSpec(name="t", path=str(path)).build_trace()
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    _, meta = pformat.load(path)
    assert meta == {"source": "synth", "format_version": 1}


def _tiny(**kw):
    plan = PP.CampaignPlan(
        simpoints=[PP.WorkloadSpec(name="w0",
                                   workload=psynth.WorkloadConfig(**_WL))],
        structures=["regfile"], batch_size=32, max_trials=64, **kw)
    return plan


def _later_options():
    def certify(p):
        p.analysis.certify = "strict"

    def cache_dir(p):
        p.pipeline.compilation_cache_dir = "cache"

    def checkpoint_spec(p):
        # came with the checkpoint slice: held as working, on the literal
        # checkpoint (test_later_slice_options_raise_before_a_trial)
        p.simpoints.append(PP.CheckpointSpec(
            name="c", cpt_dir="cpt", warmup=16,
            workload=psynth.WorkloadConfig(**_WL)))

    return {"certify": certify, "compilation_cache_dir": cache_dir,
            "checkpoint_spec": checkpoint_spec}


def _literal_cpt(tmp_path) -> str:
    """The reference's literal checkpoint (``tests/test_ingest.py``)."""
    import gzip

    from test_ingest import _CPT_TEXT

    d = tmp_path / "cpt.1000500"
    d.mkdir()
    (d / "m5.cpt").write_text(_CPT_TEXT)
    with gzip.open(d / "system.physmem.store0.pmem", "wb") as f:
        f.write(bytes(range(32)))
    return str(d)


_CHAOS = {"faults": [{"kind": "corrupt_tally", "at_batch": 1}]}


@pytest.mark.parametrize("option", ["chaos_spec", "chaos_path"])
def test_chaos_plan_options_run(option, tmp_path):
    """A chaos plan inline (``chaos.spec``) or in a file
    (``chaos.plan_path``) builds the engine when the orchestrator is made,
    and the run survives its fault with the undisturbed tally."""
    plan = _tiny()
    if option == "chaos_spec":
        plan.chaos.spec = json.dumps(_CHAOS)
    else:
        path = tmp_path / "chaos.json"
        path.write_text(json.dumps(_CHAOS))
        plan.chaos.plan_path = str(path)
    orch = Orchestrator(PP.CampaignPlan.from_dict(plan.to_dict()),
                        device="cpu")
    assert orch.chaos is not None and orch.watchdog.chaos is orch.chaos
    events = list(orch.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    clean = Orchestrator(_tiny(), device="cpu")
    list(clean.events())
    key = ("w0", "regfile")
    np.testing.assert_array_equal(orch.results[key].tallies,
                                  clean.results[key].tallies)
    assert orch.chaos.injected == orch.chaos.survived == {
        "corrupt_tally": 1}


def _no_o3_step(monkeypatch) -> list:
    """Record every call of the O3 batch step instead of running it."""
    from shrewd_tpu_torch.ops import trial

    ran: list = []
    monkeypatch.setattr(trial.TrialKernel, "tally_on_device",
                        lambda *a, **k: ran.append(1))
    return ran


@pytest.mark.parametrize("option", sorted(_later_options()))
def test_later_slice_options_raise_before_a_trial(option, monkeypatch,
                                                  tmp_path):
    """Every option of a later slice raises before the first trial.  A
    ``CheckpointSpec`` simpoint came with the checkpoint slice: its plan
    runs both simpoints to the end."""
    plan = _tiny()
    _later_options()[option](plan)
    if option == "checkpoint_spec":
        plan.simpoints[-1].cpt_dir = _literal_cpt(tmp_path)
        events = list(Orchestrator(plan, device="cpu").events())
        assert events[-1][0].name == "CAMPAIGN_COMPLETE"
        results = events[-1][1]
        assert sorted(results) == [("c", "regfile"), ("w0", "regfile")]
        assert all(r.trials == 64 for r in results.values())
        return
    ran = _no_o3_step(monkeypatch)
    with pytest.raises(NotImplementedError, match="later slice|jax"):
        list(Orchestrator(plan, device="cpu").events())
    assert not ran


@pytest.mark.parametrize("structure", ["cache:data", "cache:tag",
                                       "cache:state", "mesi:state",
                                       "mesi:tag", "noc:router"])
def test_tier_structures_run_without_the_o3_step(structure, monkeypatch):
    """A plan naming one tier structure completes on the tier's own
    kernel, and the O3 batch step never runs."""
    ran = _no_o3_step(monkeypatch)
    plan = _tiny()
    plan.structures = [structure]
    plan.coherence_accesses = 48
    events = list(Orchestrator(plan, device="cpu").events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    assert [k[1] for k in events[-1][1]] == [structure]
    assert not ran


@pytest.mark.parametrize("what", ["mesh", "attach_chaos", "attach_elastic",
                                  "checkpoint_spec_build"])
def test_later_slice_entry_points_raise(what, tmp_path):
    """A mesh, ``attach_chaos`` and ``attach_elastic`` came with the
    multi-device slice and ``CheckpointSpec.build_trace`` with the
    checkpoint slice; each is held here as working: each run gives the
    plain run's tally, and ``build_trace`` on the literal checkpoint a
    valid window over its state, the reference's."""
    if what == "checkpoint_spec_build":
        from shrewd_tpu.ingest import load_arch_snapshot

        cpt = _literal_cpt(tmp_path)
        spec = PP.CheckpointSpec(name="c", cpt_dir=cpt, warmup=0,
                                 workload=psynth.WorkloadConfig(**_WL))
        trace = spec.build_trace()
        trace.validate()
        assert trace.n == _WL["n"]
        assert trace.init_reg[:8].tolist() == [1, 0, 2, 0, 0xFFFFFFFF, 0,
                                               0x100, 0]
        assert trace.init_mem[:8].tolist() == [
            int.from_bytes(bytes(range(4 * i, 4 * i + 4)), "little")
            for i in range(8)]
        ref = RP.CheckpointSpec.from_dict(spec.to_dict()).build_trace()
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(trace, f), getattr(ref, f))
        assert load_arch_snapshot(cpt).pc == 4198400
        return
    from shrewd_tpu_torch.chaos import ChaosEngine
    from shrewd_tpu_torch.parallel.elastic import ElasticContext
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    plain = Orchestrator(_tiny(), device="cpu")
    list(plain.events())
    if what == "mesh":
        orch = Orchestrator(_tiny(), mesh=make_mesh(["cpu"] * 2))
        assert orch.mesh.size == 2 and orch.batch_size == 32
        with pytest.raises(ValueError, match="not on the mesh"):
            Orchestrator(_tiny(), mesh=orch.mesh, device="cuda:3")
    else:
        orch = Orchestrator(_tiny(), device="cpu")
        if what == "attach_chaos":
            orch.attach_chaos(ChaosEngine({"faults": [
                {"kind": "backend_error", "at_batch": 0}]}))
        else:
            ctx = ElasticContext(str(tmp_path), "w0")
            orch.attach_elastic(ctx)
    events = list(orch.events())
    if what == "attach_elastic":
        ctx.stop()
        assert ctx.claimed == 2
    if what == "attach_chaos":
        assert orch.chaos.survived == {"backend_error": 1}
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    key = ("w0", "regfile")
    np.testing.assert_array_equal(orch.results[key].tallies,
                                  plain.results[key].tallies)


def test_default_plan_reaches_no_later_slice_option():
    plan = _tiny()
    orch = Orchestrator(plan, device="cpu")
    events = list(orch.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    assert orch.results[("w0", "regfile")].trials == 64
