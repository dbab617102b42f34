"""The tier structures through the port's ``Orchestrator`` against the JAX
package's, on the CPU.

One small plan names the cache tier's three structures (per simpoint, on
the window's golden access stream), the two MESI structures and the NoC
router (once per plan, under the ``coherence`` pseudo-simpoint, on a
48-access torture stream) and regfile, stratified.  Run serially, the
port's event stream (``SIMPOINT_COMPLETE coherence`` included), results,
``stats.json`` (without the fields of ``PERF_OWN``) and checkpoint
document equal the reference's, and the seed canaries of every tier
campaign run and pass; the interval and until-CI engines reach the same
results and final state.  The module fixture of
``test_torch_orchestrator.py`` works around the reference's faults R1 and
R4; ``test_torch_orchestrator_tiers_resume.py`` resumes this plan across
packages."""

import pytest

from shrewd_tpu import stats as ref_stats
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.sim.exit_event import ExitEvent
# the module's R1/R4 fixture (autouse), the one-device mesh and helpers
from test_torch_orchestrator import (_reference_on_jax_09,  # noqa: F401
                                     ckpt_doc, event_log, mesh, port_plan,
                                     result_key, stats_doc, tiny_plan)
from test_torch_ruby import one_torch_thread  # noqa: F401

TIERS = ("cache:data", "cache:tag", "cache:state", "mesi:state",
         "mesi:tag", "noc:router")


def tier_plan(mode="serial", **kw):
    """regfile and the six tier structures, stratified, without the audit
    (which tier kernels do not run)."""
    plan = tiny_plan(mode, stratify=True, structures=("regfile",) + TIERS,
                     coherence_accesses=48, coherence_mem_words=64, **kw)
    plan.integrity.audit_rate = 0.0
    return plan


@pytest.fixture(scope="module")
def reference(mesh, tmp_path_factory):
    """The reference's serial run of the tier plan and its events."""
    ro = RefOrch(tier_plan(checkpoint_every=2), mesh=mesh,
                 outdir=str(tmp_path_factory.mktemp("ref")))
    return ro, list(ro.events())


def test_tier_plan_matches_reference(reference, tmp_path):
    ro, rev = reference
    po = Orchestrator(port_plan(ro.plan), outdir=str(tmp_path),
                      device="cpu")
    pev = list(po.events())
    assert event_log(pev) == event_log(rev)
    assert [p for ev, p in pev if ev is ExitEvent.SIMPOINT_COMPLETE] == \
        ["w0", "coherence"]
    assert pev[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
    assert set(po.results) == ({("w0", s) for s in ("regfile",) + TIERS[:3]}
                               | {("coherence", s) for s in TIERS[3:]})
    for key, r in po.results.items():
        assert result_key(r) == result_key(ro.results[key])
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)
    # every campaign's seed canaries ran and passed
    mon = po.monitor
    assert mon.canary_runs >= sum(
        1 for ev, _ in pev if ev is ExitEvent.BATCH_COMPLETE)
    assert mon.canary_failures == 0 and mon.quarantined == 0
    assert mon.invariant_violations == 0


@pytest.mark.parametrize("mode", ["sync", "until"])
def test_tier_plan_engines_match_reference(reference, tmp_path, mode):
    """The interval and until-CI engines accumulate the tier kernels'
    tallies on the device and reach the serial run's results."""
    ro, _ = reference
    plan = port_plan(tier_plan(mode))
    po = Orchestrator(plan, outdir=str(tmp_path), device="cpu")
    assert list(po.events())[-1][0] is ExitEvent.CAMPAIGN_COMPLETE
    for key, r in ro.results.items():
        assert result_key(po.results[key]) == result_key(r)
        assert po.state[key].to_dict()["strata"] == \
            ro.state[key].to_dict()["strata"]
    perf = stats.to_dict(po.stats)["perf"]
    assert perf["serial_fallbacks"] == 0
    assert perf["intervals" if mode == "sync" else "super_intervals"] > 0
    assert po.monitor.canary_failures == 0
