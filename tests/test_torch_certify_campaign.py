"""The port's certification through the campaign layers, on the CPU
(continued from ``test_torch_certify.py``, whose module fixtures give the
reference its jax 0.9 aliases): a strict ``Orchestrator`` gives the
certify-off run's and the reference's strict run's tallies, a 2-shard
mesh certifies at one transfer, and the until-CI step copies its result
to the host once per super-interval."""

import numpy as np
import pytest

from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu.parallel import exec_cache as ref_exec_cache
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.parallel import ShardedCampaign
from shrewd_tpu_torch.parallel import campaign as campaign_mod
from shrewd_tpu_torch.parallel import exec_cache
from test_torch_campaign import _kernels, _keys, window  # noqa: F401
# the reference's jax 0.9 aliases (R1, R4; R10) as autouse module
# fixtures, the auditor cleanup after each test, and helpers
from test_torch_certify import (_no_auditor_left,  # noqa: F401
                                _reference_audits_on_jax_09)
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     mesh, port_plan, tiny_plan)

def _graftlint_plan(certify, ref=False):
    """The reference's end-to-end plan (``tests/test_graftlint.py``)."""
    from shrewd_tpu.campaign.plan import CampaignPlan, WorkloadSpec
    from shrewd_tpu.trace.synth import WorkloadConfig

    p = CampaignPlan(
        simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
            n=64, nphys=32, mem_words=64, working_set_words=32, seed=3))],
        structures=["regfile"], batch_size=32, target_halfwidth=0.5,
        max_trials=64, min_trials=64)
    p.integrity.canary_trials = 0
    p.integrity.audit_rate = 0.0
    p.resilience.backoff_base = 0.0
    p.analysis.certify = certify
    return p if ref else port_plan(p)


def _results(orch):
    events = list(orch.events())
    assert events[-1][0].name == "CAMPAIGN_COMPLETE"
    return {k: r.tallies.tolist() for k, r in events[-1][1].items()}


@pytest.mark.parametrize("mode", ["serial", "until"])
def test_orchestrator_strict_certification_end_to_end(mesh, mode):
    """``plan.analysis.certify='strict'``: every dispatched step kind
    certifies, nothing is refused, and the tallies equal the certify-off
    run's and the reference's strict run's."""
    def plan(certify, ref=False):
        p = _graftlint_plan(certify, ref)
        p.pipeline.until_ci = mode == "until"
        return p

    clean = _results(Orchestrator(plan("off"), device="cpu"))
    exec_cache.cache().clear()
    refused = exec_cache.cache().refused
    orch = Orchestrator(plan("strict"), device="cpu")
    certified = _results(orch)
    assert certified == clean
    assert orch.auditor is not None and orch.auditor.strict
    assert orch.auditor.audited > 0 and orch.auditor.failed == 0
    assert exec_cache.cache().certificates
    assert all(c["ok"] and c["transfers"] == 1
               for c in exec_cache.cache().certificates.values())
    assert exec_cache.cache().refused == refused
    kinds = {c["kind"] for c in exec_cache.cache().certificates.values()}
    assert kinds == ({"until_ci"} if mode == "until" else {"batch"}), kinds
    ref_exec_cache.cache().clear()
    ref = RefOrch(plan("strict", ref=True), mesh=mesh)
    assert _results(ref) == certified
    assert ref.auditor.audited > 0 and ref.auditor.failed == 0


@pytest.mark.parametrize("mode", ["serial", "sync", "until"])
def test_two_shard_mesh_certifies_at_one_transfer(mode):
    """On a 2-shard mesh each step still copies its result once (the
    shards' tallies are stacked on the first device first), so each step
    kind certifies at the ONE-transfer budget with the integrity check on;
    the tallies are the one-shard run's."""
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    def plan(certify):
        p = port_plan(tiny_plan(mode, structures=("regfile",)))
        p.analysis.certify = certify
        return p

    want = _results(Orchestrator(plan("off"), device="cpu"))
    orch = Orchestrator(plan("strict"), mesh=make_mesh(["cpu"] * 2))
    assert _results(orch) == want
    certs = list(exec_cache.cache().certificates.values())
    assert certs and all(c["ok"] and c["transfers"] == 1 for c in certs)


# --- the until-CI step's one result copy ---------------------------------------

@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_until_ci_makes_one_result_copy(window, mesh, stratify, monkeypatch):
    """One device→host result copy per super-interval, however many
    batches it consumed (plus one stop-flag read per batch past
    min_trials), with the reference's results."""
    from shrewd_tpu.parallel import ShardedCampaign as RefCampaign

    copies = []
    to_host = campaign_mod._to_host

    def counted(*parts):
        copies.append(len(parts))
        return to_host(*parts)

    monkeypatch.setattr(campaign_mod, "_to_host", counted)
    rk, mk = _kernels(window)
    ks = [_keys(140 + i, 64) for i in range(5)]
    camp = ShardedCampaign(mk, None, "fu", stratify=stratify)
    args = (np.zeros(4, np.int64), None, 0, 128, 0.06, 0.95, stratify)
    got = camp.materialize_until_ci(camp.dispatch_until_ci(
        [m for _, m in ks], *args))
    assert copies == [3]                 # acc, n_unres, hw_buf: one copy
    consumed = got[2]
    assert camp.transfers == 1 + (consumed - 1)
    rcamp = RefCampaign(rk, mesh, "fu", stratify=stratify)
    want = rcamp.materialize_until_ci(rcamp.dispatch_until_ci(
        [r for r, _ in ks], *args))
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    if stratify:
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
