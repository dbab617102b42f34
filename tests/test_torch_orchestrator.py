"""The port's ``Orchestrator`` and CLI against the JAX package's, on the
CPU.

On ``_tiny_plan``-sized plans (a 96-µop window, regfile and fu, batch 32;
serial, ``sync_every=4`` and until-CI; pooled and stratified) the port's
results, event streams, checkpoint documents and ``stats.json`` must equal
the reference's.  Only wall-clock fields and the counters that count each
package's own machinery differ: ``perf``'s seconds and overlap, the
executable/kernel registry counts and ``host_roundtrips_saved`` (the
port counts its own device→host copies).  A checkpoint written by either
package resumes in the other to the same final result, and the CLI's
``run`` / ``resume --platform cpu`` give the reference CLI's return codes
and files.

Two faults of the reference under jax 0.9 are worked around in a module
fixture, without editing ``shrewd_tpu/``: ``jax.core.trace_state_clean``
moved to ``jax._src.core`` (R1), and ``jax.shard_map`` now checks the
varying manual axes of scan and while-loop carries, which the reference's
interval and until-CI steps fail (R4): the reference then recovers every
interval serially, bit-identical in tallies but not in its integrity
counters.  The fixture gives the reference's campaign module a
``shard_map`` with ``check_vma=False``, as the reference itself does for
jax 0.4's ``check_rep``.  The reference runs on a one-device mesh, as the
port runs on one device.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

import shrewd_tpu.parallel.campaign as ref_campaign_mod
from shrewd_tpu import stats as ref_stats
from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu.parallel import make_mesh
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.sim.exit_event import ExitEvent

# the perf fields that hold wall-clock time or count each package's own
# machinery (everything else in stats.json must be equal)
PERF_OWN = ("device_step_seconds", "device_wait_seconds", "host_seconds",
            "overlap_fraction", "host_roundtrips_saved",
            "executables_compiled", "executables_reused",
            "executables_certified", "executables_refused",
            "exec_cache_keys")


@pytest.fixture(autouse=True, scope="module")
def _reference_on_jax_09():
    """R1 (``trace_state_clean``) and R4 (``check_vma``), see the module
    docstring; both undone after the module."""
    missing = not hasattr(jax.core, "trace_state_clean")
    if missing:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    shard_map = ref_campaign_mod.shard_map
    if hasattr(jax, "shard_map"):
        ref_campaign_mod.shard_map = functools.partial(jax.shard_map,
                                                       check_vma=False)
    yield
    ref_campaign_mod.shard_map = shard_map
    if missing:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:1])


def tiny_plan(mode="serial", stratify=False, target=0.08,
              structures=("regfile", "fu"), batch_size=32, max_batches=64,
              min_trials=64, audit_rate=0.01, **kw):
    """The reference's plan (``tests/test_until_ci.py _tiny_plan`` with both
    structures); the port loads it from its dict."""
    plan = RP.CampaignPlan(
        simpoints=[RP.WorkloadSpec(
            name="w0", workload=rsynth.WorkloadConfig(
                n=96, nphys=32, mem_words=64, working_set_words=32,
                seed=7))],
        structures=list(structures), batch_size=batch_size,
        target_halfwidth=target, confidence=0.95,
        max_trials=batch_size * max_batches, min_trials=min_trials,
        stratify=stratify, **kw)
    plan.integrity.audit_rate = audit_rate
    plan.resilience.backoff_base = 0.0
    if mode == "sync":
        plan.pipeline.sync_every = 4
    elif mode == "until":
        plan.pipeline.until_ci = True
    return plan


def port_plan(ref_plan):
    return PP.CampaignPlan.from_dict(ref_plan.to_dict())


def stats_doc(orch, mod):
    """stats.json as a dict, without the fields of PERF_OWN."""
    d = json.loads(mod.dump_json(orch.stats))
    for k in PERF_OWN:
        d["perf"].pop(k)
    return d


def event_log(events):
    """The event stream (either package's) with payloads reduced to
    comparable values."""
    out = []
    for ev, p in events:
        if ev.name == "BATCH_COMPLETE":
            p = (p.simpoint, p.structure, p.batch_id, p.trials,
                 p.tallies.tolist(), p.avf, p.tier)
        elif ev.name in ("CI_CONVERGED", "MAX_TRIALS"):
            p = result_key(p)
        elif ev.name == "CAMPAIGN_COMPLETE":
            p = sorted((k, result_key(r)) for k, r in p.items())
        elif ev.name == "CHECKPOINT":
            p = os.path.basename(p)
        out.append((ev.name, p))
    return out


def result_key(r):
    return (r.simpoint, r.structure, r.tallies.tolist(), r.trials, r.avf,
            tuple(r.avf_interval), tuple(r.sdc_interval), r.converged)


def ckpt_doc(outdir):
    with open(os.path.join(outdir, "campaign_ckpt", "campaign.json")) as f:
        return json.load(f)


def run_both(ref_plan, mesh, tmp_path, tag=""):
    rdir, pdir = str(tmp_path / f"ref{tag}"), str(tmp_path / f"port{tag}")
    ro = RefOrch(ref_plan, mesh=mesh, outdir=rdir)
    rev = list(ro.events())
    po = Orchestrator(port_plan(ref_plan), outdir=pdir, device="cpu")
    pev = list(po.events())
    return ro, rev, po, pev


def check_matches_reference(mesh, tmp_path, mode, stratify):
    """One campaign in both packages: the same events, results,
    stats.json (less PERF_OWN) and periodic checkpoint document."""
    ref_plan = tiny_plan(mode, stratify=stratify, checkpoint_every=2)
    ro, rev, po, pev = run_both(ref_plan, mesh, tmp_path)
    assert event_log(pev) == event_log(rev)
    assert pev[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
    for key, r in po.results.items():
        assert result_key(r) == result_key(ro.results[key])
        assert r.converged
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)
    # the reference's regfile result on this plan (any mode, pooled)
    if not stratify:
        rr = po.results[("w0", "regfile")]
        assert (rr.tallies.tolist(), rr.trials) == ([83, 60, 17, 0], 160)
    if mode != "serial":
        perf = stats.to_dict(po.stats)["perf"]
        assert perf["serial_fallbacks"] == 0
        assert perf["intervals" if mode == "sync" else "super_intervals"] > 0


@pytest.mark.parametrize("mode", ["serial", "sync"])
@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_orchestrator_matches_reference(mesh, tmp_path, mode, stratify):
    check_matches_reference(mesh, tmp_path, mode, stratify)


def test_outputs_and_final_checkpoint_match_reference(mesh, tmp_path):
    ref_plan = tiny_plan("serial", stratify=True)
    ro, _, po, _ = run_both(ref_plan, mesh, tmp_path)
    for o in (ro, po):
        o.write_outputs()
        o.checkpoint()
    for name in ("config.json",):
        with open(os.path.join(po.outdir, name)) as a, \
                open(os.path.join(ro.outdir, name)) as b:
            assert a.read() == b.read()
    with open(os.path.join(po.outdir, "stats.json")) as f:
        got = json.load(f)
    for k in PERF_OWN:
        got["perf"].pop(k)
    assert got == stats_doc(ro, ref_stats)
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)


def test_orchestrator_defaults_to_the_card(tmp_path):
    """``Orchestrator(device=None)`` and the CLI without ``--platform``
    run on the card and raise without one."""
    import torch

    from shrewd_tpu_torch import main as main_mod

    plan = port_plan(tiny_plan())
    if torch.cuda.is_available():
        assert Orchestrator(plan).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(plan)
    path = str(tmp_path / "plan.json")
    plan.dump_json(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_mod.main(["run", path, "--outdir", str(tmp_path / "out")])
