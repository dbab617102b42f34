"""The port's ``Orchestrator`` on a 4-device mesh against the JAX package's,
on the CPU.

The port runs on ``make_mesh(["cpu"] * 4)``, the reference on
``make_mesh(jax.devices()[:4])``, with a plan batch size of 30 that both
round up to 32 (and the seed canaries to a multiple of 4), with a warning.
Events, results, ``stats.json`` (less ``PERF_OWN``) and the checkpoint
documents must be equal in the serial, sync-interval and until-CI modes;
a checkpoint written on the 4-mesh by either package resumes in the other;
and a resume on a mesh that rounds the plan's batch size differently is
refused by both.  The module fixture of ``test_torch_orchestrator.py``
works around the reference's faults R1 and R4 under jax 0.9.
"""

import jax
import pytest

from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.parallel.mesh import make_mesh
from shrewd_tpu_torch.sim.exit_event import ExitEvent
from shrewd_tpu import stats as ref_stats
# the R1/R4 fixture (autouse) and the two-package helpers
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     ckpt_doc, event_log, port_plan,
                                     result_key, stats_doc, tiny_plan)
from test_torch_orchestrator_resume import _stop_after

N = 4
BATCH = 30          # rounds up to 32 on the 4-mesh


@pytest.fixture(scope="module")
def meshes():
    return ref_make_mesh(jax.devices()[:N]), make_mesh(["cpu"] * N)


def _plan(mode="serial", stratify=False, **kw):
    return tiny_plan(mode, stratify=stratify, batch_size=BATCH, **kw)


def _both(ref_plan, meshes, tmp_path, tag=""):
    rmesh, pmesh = meshes
    with pytest.warns(RuntimeWarning, match="rounded up to 32"):
        ro = RefOrch(ref_plan, mesh=rmesh, outdir=str(tmp_path / f"r{tag}"))
    with pytest.warns(RuntimeWarning, match="rounded up to 32"):
        po = Orchestrator(port_plan(ref_plan), mesh=pmesh,
                          outdir=str(tmp_path / f"p{tag}"))
    assert ro.batch_size == po.batch_size == 32
    return ro, list(ro.events()), po, list(po.events())


@pytest.mark.parametrize("mode,stratify", [
    ("serial", False), ("sync", False), ("until", True)])
def test_four_mesh_matches_reference(meshes, tmp_path, mode, stratify):
    ref_plan = _plan(mode, stratify=stratify, checkpoint_every=2)
    ro, rev, po, pev = _both(ref_plan, meshes, tmp_path)
    assert pev[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
    assert event_log(pev) == event_log(rev)
    for key, r in po.results.items():
        assert result_key(r) == result_key(ro.results[key])
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)
    # the shard-vs-sum check ran over the four shards, and the seed
    # canaries were rounded to the mesh
    camp = next(iter(po._campaigns.values()))
    assert camp.mesh.size == 4 and camp.shard_checks > 0
    assert all(c._battery.seed_keys.shape[0] % 4 == 0
               for c in po._checked.values())
    if mode != "serial":
        perf = stats.to_dict(po.stats)["perf"]
        assert perf["intervals" if mode == "sync" else "super_intervals"] > 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_four_mesh_checkpoint_resumes_across_packages(meshes, tmp_path,
                                                      writer):
    rmesh, pmesh = meshes
    ref_plan = _plan("serial", stratify=True)
    with pytest.warns(RuntimeWarning):
        full = RefOrch(ref_plan, mesh=rmesh)
    list(full.events())
    with pytest.warns(RuntimeWarning):
        if writer == "reference":
            ckpt = _stop_after(RefOrch(ref_plan, mesh=rmesh,
                                       outdir=str(tmp_path / "a")), 3)
            resumed = Orchestrator.resume(ckpt, mesh=pmesh,
                                          outdir=str(tmp_path / "b"))
        else:
            ckpt = _stop_after(Orchestrator(port_plan(ref_plan), mesh=pmesh,
                                            outdir=str(tmp_path / "a")), 3)
            resumed = RefOrch.resume(ckpt, mesh=rmesh,
                                     outdir=str(tmp_path / "b"))
    events = list(resumed.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    for key, r in full.results.items():
        assert result_key(resumed.results[key]) == result_key(r)


@pytest.mark.parametrize("size", [1, 3])
def test_resume_on_a_mesh_that_rounds_differently_is_refused(
        meshes, tmp_path, size):
    """32 trials a batch on the 4-mesh; a 1- or 3-mesh runs the plan's 30:
    the batch keys would diverge from the checkpointed history."""
    ref_plan = _plan("serial")
    with pytest.warns(RuntimeWarning):
        ckpt = _stop_after(Orchestrator(port_plan(ref_plan),
                                        mesh=meshes[1],
                                        outdir=str(tmp_path / "a")), 2)
    with pytest.raises(ValueError, match="rounds the plan's 30 to 30"):
        Orchestrator.resume(ckpt, mesh=make_mesh(["cpu"] * size))
    with pytest.raises(ValueError, match="rounds the plan's 30 to 30"):
        RefOrch.resume(ckpt, mesh=ref_make_mesh(jax.devices()[:size]))
