"""The port's ``Orchestrator`` and CLI against the JAX package's, on the
CPU (continued from ``test_torch_orchestrator.py``, whose module fixture
works around the reference's faults R1 and R4 and whose helpers this
module shares): the until-CI mode, checkpoint resume across packages both
ways, the v1→v5 upgrade chain, the torn-checkpoint fallback, and the CLI's
``run`` / ``resume --platform cpu`` against the reference CLI."""

import json
import os

import numpy as np
import pytest

from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
# the module's R1/R4 fixture (autouse), the one-device mesh and helpers
from test_torch_orchestrator import (PERF_OWN, _reference_on_jax_09,  # noqa: F401
                                     check_matches_reference, ckpt_doc,
                                     mesh, port_plan, result_key, tiny_plan)


@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_orchestrator_until_ci_matches_reference(mesh, tmp_path, stratify):
    """The until-CI mode: the consumed batch count, and so every result,
    is the serial loop's and the reference's."""
    check_matches_reference(mesh, tmp_path, "until", stratify)


def _stop_after(orch, n_batches):
    """Drive ``orch`` until ``n_batches`` BATCH_COMPLETE events, then
    drain to a checkpoint, as SIGTERM does."""
    seen = 0
    for ev, _ in orch.events():
        if ev.name == "BATCH_COMPLETE":
            seen += 1
            if seen == n_batches:
                orch.request_drain()
        if ev.name == "PREEMPTED":
            break
    assert orch.preempted
    return os.path.join(orch.outdir, "campaign_ckpt")


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_checkpoint_resumes_across_packages(mesh, tmp_path, writer,
                                            stratify):
    ref_plan = tiny_plan("serial", stratify=stratify)
    full = RefOrch(ref_plan, mesh=mesh)
    list(full.events())
    if writer == "reference":
        ckpt = _stop_after(RefOrch(ref_plan, mesh=mesh,
                                   outdir=str(tmp_path / "a")), 3)
        resumed = Orchestrator.resume(ckpt, outdir=str(tmp_path / "b"),
                                      device="cpu")
    else:
        ckpt = _stop_after(Orchestrator(port_plan(ref_plan),
                                        outdir=str(tmp_path / "a"),
                                        device="cpu"), 3)
        resumed = RefOrch.resume(ckpt, mesh=mesh,
                                 outdir=str(tmp_path / "b"))
    list(resumed.events())
    for key, r in full.results.items():
        assert result_key(resumed.results[key]) == result_key(r)
        np.testing.assert_array_equal(
            resumed.state[key].tallies, full.state[key].tallies)
        assert resumed.state[key].to_dict()["strata"] == \
            full.state[key].to_dict()["strata"]


def test_checkpoint_v1_upgrades_and_resumes(mesh, tmp_path):
    """A v1 document (no escape counters, strata, tiers or integrity) is
    upgraded to v5 as the reference upgrades it, and resumes."""
    from shrewd_tpu.campaign.orchestrator import upgrade_checkpoint as rup
    from shrewd_tpu_torch.campaign.orchestrator import upgrade_checkpoint

    ref_plan = tiny_plan("serial")
    ckpt = _stop_after(RefOrch(ref_plan, mesh=mesh,
                               outdir=str(tmp_path / "a")), 2)
    path = os.path.join(ckpt, "campaign.json")
    with open(path) as f:
        doc = json.load(f)
    doc["version"] = 1
    doc.pop("integrity")
    doc.pop("checksum")
    for per in doc["state"].values():
        for st in per.values():
            for k in ("escapes", "taint_trials", "strata", "tier_trials"):
                st.pop(k)
    assert upgrade_checkpoint(json.loads(json.dumps(doc))) == \
        rup(json.loads(json.dumps(doc)))
    with open(path, "w") as f:
        json.dump(doc, f)
    mine = Orchestrator.resume(ckpt, device="cpu")
    ref = RefOrch.resume(ckpt, mesh=mesh)
    list(mine.events())
    list(ref.events())
    assert sorted((k, result_key(r)) for k, r in mine.results.items()) == \
        sorted((k, result_key(r)) for k, r in ref.results.items())


def test_torn_latest_checkpoint_falls_back_to_prev(tmp_path):
    """The checkpoint after batch 2, then the drain's after batch 3: a
    torn latest document falls back to the previous one."""
    plan = PP.CampaignPlan.from_dict(tiny_plan("serial",
                                               checkpoint_every=2).to_dict())
    orch = Orchestrator(plan, outdir=str(tmp_path), device="cpu")
    _stop_after(orch, 3)
    ckpt = os.path.join(str(tmp_path), "campaign_ckpt")
    latest = Orchestrator.load_checkpoint_doc(ckpt)
    assert latest["state"]["w0"]["regfile"]["next_batch"] == 3
    with open(os.path.join(ckpt, "campaign.json"), "r+") as f:
        f.truncate(40)
    doc = Orchestrator.load_checkpoint_doc(ckpt)
    assert doc["version"] == 5
    assert doc["state"]["w0"]["regfile"]["next_batch"] == 2
    with open(os.path.join(ckpt, "campaign.prev.json"), "w") as f:
        f.write("{")
    with pytest.raises(ValueError, match="no valid campaign checkpoint"):
        Orchestrator.load_checkpoint_doc(ckpt)


def _cli_run(main, tmp_path, tag, plan_path, extra=()):
    out = str(tmp_path / tag)
    rc = main(["run", plan_path, "--outdir", out, "--platform", "cpu",
               *extra])
    return rc, out


@pytest.mark.parametrize("flags", [(), ("--sync-every", "4"),
                                   ("--until-ci",)],
                         ids=["serial", "sync", "until"])
def test_cli_run_and_resume_match_reference(mesh, tmp_path, monkeypatch,
                                            flags):
    """``run`` and ``resume --platform cpu``: rc 0 and the reference CLI's
    config.json, stats.json (less PERF_OWN) and final checkpoint."""
    from shrewd_tpu import main as ref_main_mod
    from shrewd_tpu_torch import main as main_mod

    monkeypatch.setattr(RefOrch, "__init__", _ref_init_on(mesh))
    plan_path = str(tmp_path / "plan.json")
    tiny_plan("serial", stratify=True, checkpoint_every=2).dump_json(
        plan_path)
    rc_r, out_r = _cli_run(ref_main_mod.main, tmp_path, "ref", plan_path,
                           flags)
    rc_p, out_p = _cli_run(main_mod.main, tmp_path, "port", plan_path,
                           flags)
    assert rc_p == rc_r == 0
    for name in ("config.json", "stats.txt"):
        assert os.path.exists(os.path.join(out_p, name))
    with open(os.path.join(out_p, "config.json")) as a, \
            open(os.path.join(out_r, "config.json")) as b:
        assert a.read() == b.read()
    docs = []
    for out in (out_p, out_r):
        with open(os.path.join(out, "stats.json")) as f:
            d = json.load(f)
        for k in PERF_OWN:
            d["perf"].pop(k)
        docs.append(d)
    assert docs[0] == docs[1]
    assert ckpt_doc(out_p) == ckpt_doc(out_r)
    # resume a finished campaign: nothing left to run, rc 0, same result
    rc = main_mod.main(["resume", os.path.join(out_r, "campaign_ckpt"),
                        "--outdir", str(tmp_path / "again"),
                        "--platform", "cpu", *flags])
    assert rc == 0
    assert ckpt_doc(str(tmp_path / "again"))["state"] == \
        ckpt_doc(out_r)["state"]


def _ref_init_on(mesh):
    """The reference CLI builds its orchestrator on the default mesh (all
    eight virtual CPU devices here); pin it to the one-device mesh."""
    init = RefOrch.__init__

    def wrapped(self, plan, mesh=None, outdir=None):
        init(self, plan, mesh=one, outdir=outdir)
    one = mesh
    return wrapped


def test_cli_later_subcommands_exit_nonzero(capsys):
    """``bench`` needs a benchmark of the port's own, which does not exist
    yet (rc 2).  ``hostdiff`` came with the ingest slice and ``trace``
    with the checkpoint slice; like every entry point they run on the
    card unless ``--platform cpu``: without a card each raises before any
    build, capture or golden record (tests/test_torch_hostdiff.py and
    tests/test_torch_exec_trace.py run them)."""
    import torch

    from shrewd_tpu_torch import main as main_mod

    assert main_mod.main(["bench"]) == 2
    assert "no benchmark" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main_mod.main(["hostdiff", "--workload", "no/such.c"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main_mod.main(["trace", "-n", "4"])
    assert main_mod.main(["trace", "-n", "4", "--platform", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 4


