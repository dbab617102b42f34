"""A ``CheckpointSpec`` campaign through the port against the JAX
package's, on the CPU (continued from ``test_torch_warm.py``, whose
restored window of ``workloads/sort.c`` this module shares).

A plan with one ``CheckpointSpec(binary=…, max_steps=500)`` simpoint
(regfile, batches of 128, pooled and stratified) gives the reference's
events, results, ``stats.json`` (less ``PERF_OWN``) and v5 checkpoint
document in the port's ``Orchestrator(device="cpu")``; a run drained
after one batch and resumed in either package (the window re-built from
the spec: the emulator is deterministic for a given snapshot) ends equal
to the uninterrupted run; and the CLI's ``run --platform cpu`` on the
plan file gives the same ``stats.json``.

Module fixture: R1 and R4, as in ``test_torch_orchestrator.py``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from shrewd_tpu import stats as ref_stats
from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.main import main

from test_torch_lift import needs_toolchain
from test_torch_orchestrator import (PERF_OWN, _reference_on_jax_09,  # noqa: F401
                                     ckpt_doc, event_log, mesh, result_key,
                                     stats_doc)
from test_torch_orchestrator_resume import _stop_after
from test_torch_warm import STEPS, restored  # noqa: F401

pytestmark = needs_toolchain

BATCH = 128


def _plan(cpt_dir, binary, stratify, batches=1, **kw):
    return {"type": "CampaignPlan", "structures": ["regfile"],
            "batch_size": BATCH, "max_trials": BATCH * batches,
            "min_trials": BATCH * batches, "target_halfwidth": 0.01,
            "stratify": stratify, "seed": 3,
            "simpoints": [RP.CheckpointSpec(
                name="cpt", cpt_dir=cpt_dir, binary=binary,
                max_steps=STEPS).to_dict()], **kw}


@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_checkpoint_spec_campaign_matches_reference(restored, mesh,
                                                    stratify):
    root, cpt_dir, binary, _ = restored
    doc = _plan(cpt_dir, binary, stratify)
    tag = "strat" if stratify else "pooled"
    ro = RefOrch(RP.CampaignPlan.from_dict(doc), mesh=mesh,
                 outdir=str(root / f"ref_{tag}"))
    rev = list(ro.events())
    po = Orchestrator(PP.CampaignPlan.from_dict(doc), device="cpu",
                      outdir=str(root / f"port_{tag}"))
    pev = list(po.events())
    assert event_log(pev) == event_log(rev)
    assert sorted(po.results) == [("cpt", "regfile")]
    for key, r in po.results.items():
        assert result_key(r) == result_key(ro.results[key])
        assert r.trials == BATCH
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    po.checkpoint()
    ro.checkpoint()
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)


def test_checkpoint_spec_campaign_resumes_equal(restored, mesh):
    """Drained after one batch of two and resumed in either package: the
    window is re-built from the spec, and the end equals the
    uninterrupted run's."""
    root, cpt_dir, binary, _ = restored
    doc = _plan(cpt_dir, binary, True, batches=2)
    full = Orchestrator(PP.CampaignPlan.from_dict(doc), device="cpu")
    list(full.events())
    ckpt = _stop_after(Orchestrator(PP.CampaignPlan.from_dict(doc),
                                    device="cpu",
                                    outdir=str(root / "drained")), 1)
    mine = Orchestrator.resume(ckpt, outdir=str(root / "resumed"),
                               device="cpu")
    ref = RefOrch.resume(ckpt, mesh=mesh, outdir=str(root / "ref_resumed"))
    for o in (mine, ref):
        list(o.events())
    key = ("cpt", "regfile")
    assert full.results[key].trials == 2 * BATCH
    for o in (mine, ref):
        assert result_key(o.results[key]) == result_key(full.results[key])
        np.testing.assert_array_equal(o.state[key].tallies,
                                      full.state[key].tallies)
        assert o.state[key].to_dict()["strata"] == \
            full.state[key].to_dict()["strata"]


def test_cli_runs_the_checkpoint_plan(restored, mesh):
    root, cpt_dir, binary, _ = restored
    doc = _plan(cpt_dir, binary, False)
    path = str(root / "plan.json")
    PP.CampaignPlan.from_dict(doc).dump_json(path)
    out = str(root / "cli_out")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["run", path, "--outdir", out, "--platform", "cpu"]) == 0
    ro = RefOrch(RP.CampaignPlan.from_dict(doc), mesh=mesh)
    list(ro.events())
    with open(os.path.join(out, "stats.json")) as f:
        got = json.load(f)
    for k in PERF_OWN:
        got["perf"].pop(k)
    assert got == stats_doc(ro, ref_stats)
