"""A tier campaign's checkpoint, drained in the middle of the coherence
sweep, resumes in the other package to the same final state, both ways
(the plan of ``test_torch_orchestrator_tiers.py``, whose equality with
the reference's uninterrupted run that module holds).  The module fixture
of ``test_torch_orchestrator.py`` works around the reference's faults R1
and R4."""

import os

import pytest

from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
# the module's R1/R4 fixture (autouse), the one-device mesh and helpers
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     mesh, port_plan, result_key)
from test_torch_orchestrator_tiers import tier_plan
from test_torch_ruby import one_torch_thread  # noqa: F401


def _drain_in_coherence(orch, after: int):
    """Drive ``orch`` until ``after`` coherence batches are believed, then
    drain to a checkpoint, as SIGTERM does."""
    seen = 0
    for ev, p in orch.events():
        if ev.name == "BATCH_COMPLETE" and p.simpoint == "coherence":
            seen += 1
            if seen == after:
                orch.request_drain()
        if ev.name == "PREEMPTED":
            break
    assert orch.preempted and seen == after
    return os.path.join(orch.outdir, "campaign_ckpt")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_mid_coherence_resumes_across_packages(mesh, tmp_path,
                                                          writer):
    ref_plan = tier_plan(checkpoint_every=1)
    full = Orchestrator(port_plan(ref_plan), device="cpu")
    list(full.events())
    if writer == "reference":
        ckpt = _drain_in_coherence(
            RefOrch(ref_plan, mesh=mesh, outdir=str(tmp_path / "a")), 3)
        resumed = Orchestrator.resume(ckpt, outdir=str(tmp_path / "b"),
                                      device="cpu")
    else:
        ckpt = _drain_in_coherence(
            Orchestrator(port_plan(ref_plan), outdir=str(tmp_path / "a"),
                         device="cpu"), 3)
        resumed = RefOrch.resume(ckpt, mesh=mesh,
                                 outdir=str(tmp_path / "b"))
    evs = list(resumed.events())
    assert evs[-1][0].name == "CAMPAIGN_COMPLETE"
    # the drain came after the per-simpoint structures finished
    assert set(resumed.results) == {k for k in full.results
                                    if k[0] == "coherence"}
    for key, r in full.results.items():
        assert resumed.state[key].to_dict() == full.state[key].to_dict()
        if key in resumed.results:
            assert result_key(resumed.results[key]) == result_key(r)
