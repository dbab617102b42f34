"""The port's certification on its entry points, on the CPU (continued
from ``test_torch_certify.py``): ``run --certify strict`` gives the
reference CLI's strict ``stats.json`` and the certify-off run's, and every
structure's batch and until-CI steps certify clean."""

import json
import os

import pytest

from shrewd_tpu import main as ref_main_mod
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch import main as main_mod
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.parallel import exec_cache
# the reference's jax 0.9 aliases (R1, R4; R10) as autouse module
# fixtures, the auditor cleanup after each test, and helpers
from test_torch_certify import (_no_auditor_left,  # noqa: F401
                                _reference_audits_on_jax_09)
from test_torch_certify_campaign import _results
from test_torch_orchestrator import (PERF_OWN, _reference_on_jax_09,  # noqa: F401
                                     mesh, tiny_plan)
from test_torch_orchestrator_resume import _cli_run, _ref_init_on

def test_cli_certify_strict_matches_reference(mesh, tmp_path, monkeypatch):
    """``run --certify strict --platform cpu``: rc 0, and stats.json (less
    PERF_OWN) equal to the certify-off run's and to the reference CLI's
    strict run's."""
    monkeypatch.setattr(RefOrch, "__init__", _ref_init_on(mesh))
    plan_path = str(tmp_path / "plan.json")
    tiny_plan("serial", structures=("regfile",)).dump_json(plan_path)
    flags = ("--until-ci", "--certify", "strict")
    refused = exec_cache.cache().refused
    rc_r, out_r = _cli_run(ref_main_mod.main, tmp_path, "ref", plan_path,
                           flags)
    rc_p, out_p = _cli_run(main_mod.main, tmp_path, "port", plan_path,
                           flags)
    exec_cache.clear_auditor()
    rc_o, out_o = _cli_run(main_mod.main, tmp_path, "off", plan_path,
                           ("--until-ci", "--certify", "off"))
    assert rc_p == rc_r == rc_o == 0
    assert exec_cache.cache().refused == refused
    docs = []
    for out in (out_p, out_r, out_o):
        with open(os.path.join(out, "stats.json")) as f:
            d = json.load(f)
        for k in PERF_OWN:
            d["perf"].pop(k)
        docs.append(d)
    assert docs[0] == docs[1] == docs[2]
    with open(os.path.join(out_p, "config.json")) as f:
        assert json.load(f)["analysis"]["certify"] == "strict"


@pytest.mark.parametrize("structures", [
    ("fu", "rob", "iq", "lsq", "latch"),
    ("cache:data", "mesi:state", "noc:router")], ids=["o3", "tiers"])
def test_every_structure_certifies(structures):
    """Every structure's batch and until-CI steps certify clean: each
    host read on their paths is a designed one."""
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, WorkloadSpec
    from shrewd_tpu_torch.trace.synth import WorkloadConfig

    plan = CampaignPlan(
        simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
            n=96, nphys=32, mem_words=64, working_set_words=32, seed=7))],
        structures=list(structures), batch_size=32, target_halfwidth=0.08,
        max_trials=128, min_trials=64, coherence_accesses=48)
    plan.pipeline.until_ci = True
    plan.analysis.certify = "strict"
    orch = Orchestrator(plan, device="cpu")
    _results(orch)
    certs = list(exec_cache.cache().certificates.values())
    assert {c["kind"] for c in certs} == {"batch", "until_ci"}
    assert len(certs) == 2 * len(structures)
    assert all(c["ok"] for c in certs), [c["violations"] for c in certs]
    assert orch.auditor.failed == 0
