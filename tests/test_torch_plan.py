"""The port's campaign plan against the JAX package's, on the CPU.

A plan's JSON must load in either package and dump back unchanged: the
default plan and one with every child and param off its default.  A
``TraceFileSpec`` window saved by either package loads in the other, and
a ``WorkloadSpec`` window is the reference's, array for array.  Every
option whose engine comes with a later slice raises
``NotImplementedError`` before a trial runs, and a default plan reaches
none of them."""

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
    def chaos(p):
        p.chaos.spec = '{"faults": []}'

    def chaos_path(p):
        p.chaos.plan_path = "chaos.json"

    def certify(p):
        p.analysis.certify = "strict"

    def cache_dir(p):
        p.pipeline.compilation_cache_dir = "cache"

    def checkpoint_spec(p):
        p.simpoints.append(PP.CheckpointSpec(name="c", cpt_dir="cpt"))

    opts = {"chaos_spec": chaos, "chaos_path": chaos_path,
            "certify": certify, "compilation_cache_dir": cache_dir,
            "checkpoint_spec": checkpoint_spec}
    for s in ("cache:data", "cache:tag", "cache:state", "mesi:state",
              "mesi:tag", "noc:router"):
        opts[s] = (lambda s: lambda p: p.structures.append(s))(s)
    return opts


@pytest.mark.parametrize("option", sorted(_later_options()))
def test_later_slice_options_raise_before_a_trial(option, monkeypatch):
    from shrewd_tpu_torch.ops import trial

    ran = []
    monkeypatch.setattr(trial.TrialKernel, "tally_on_device",
                        lambda *a, **k: ran.append(1))
    plan = _tiny()
    _later_options()[option](plan)
    with pytest.raises(NotImplementedError, match="later slice|jax"):
        list(Orchestrator(plan, device="cpu").events())
    assert not ran


@pytest.mark.parametrize("what", ["mesh", "attach_chaos", "attach_elastic",
                                  "checkpoint_spec_build"])
def test_later_slice_entry_points_raise(what):
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="mesh"):
            Orchestrator(_tiny(), mesh=object(), device="cpu")
    elif what == "checkpoint_spec_build":
        with pytest.raises(NotImplementedError, match="ingest"):
            PP.CheckpointSpec(name="c", cpt_dir="cpt").build_trace()
    else:
        orch = Orchestrator(_tiny(), device="cpu")
        with pytest.raises(NotImplementedError, match="later slice"):
            getattr(orch, what)(None)


def test_default_plan_reaches_no_later_slice_option():
    plan = _tiny()
    orch = Orchestrator(plan, device="cpu")
    events = list(orch.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    assert orch.results[("w0", "regfile")].trials == 64
