"""The port's SHREWD shadow-FU pool model against the JAX package's, on
the CPU: grants, slips, coverage and the per-OpClass availability
counters must agree exactly, under both shadow priorities, with SHREWD off,
under the dense issue proxy and under the scoreboard's schedule with
wrong-path phantoms, and with approximate shadows that detect with
probability below 1."""

import numpy as np
import pytest

from shrewd_tpu.isa import uops as ref_uops
from shrewd_tpu.models import fupool as RF
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.models import timing as RT
from shrewd_tpu.trace import synth
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import fupool as F
from shrewd_tpu_torch.models import o3 as O
from shrewd_tpu_torch.models import timing as T

_COUNTERS = ("grants", "slip", "shadow_requests", "shadow_granted",
             "shadow_granted_approx", "shadow_denied", "fu_busy",
             "phantom_requests", "phantom_granted", "phantom_granted_approx",
             "phantom_denied", "phantom_fu_busy")


@pytest.fixture(scope="module")
def window():
    """A generated window of ALU, multiply, memory, branch and FP µops,
    with the integer divide family planted at every 11th non-branch µop
    (the generator emits none)."""
    t = synth.generate(synth.WorkloadConfig(
        n=480, nphys=64, mem_words=512, working_set_words=128,
        frac_alu=0.35, frac_mul=0.08, frac_branch=0.1, frac_fp=0.15,
        seed=9))
    op = np.asarray(t.opcode).copy()
    at = [i for i in range(3, t.n, 11) if not ref_uops.is_branch(op[i])]
    op[at] = ref_uops.DIV
    op[at[::2]] = ref_uops.REMU
    ref = t._replace(opcode=op)
    return ref, compat.trace_from_arrays(*ref)


def _same_model(a, b):
    for name in _COUNTERS:
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == y.dtype, name
    np.testing.assert_array_equal(a.coverage(), b.coverage())
    assert b.coverage().dtype == np.float32
    for ph in (False, True):
        assert a.availability(ph) == b.availability(ph)


def _schedule(mod, trace, tcfg):
    sb = mod.compute_scoreboard(trace, tcfg)
    ph_oc, ph_cyc = mod.wrongpath_phantoms(trace, sb, tcfg)
    return dict(issue_cycle=sb.issue,
                busy_cycles=mod.nonpipelined_busy(trace.opcode, tcfg),
                approx_busy_cycles=mod.approx_shadow_busy(trace.opcode,
                                                          tcfg),
                phantom_opclass=ph_oc, phantom_cycle=ph_cyc)


def test_pool_config_dict_matches_reference():
    ref = RF.FUPoolConfig().to_dict()
    assert F.FUPoolConfig().to_dict() == ref
    assert F.FUPoolConfig.from_dict(ref).to_dict() == ref
    assert O.O3Config(shadow_model="fupool").to_dict() == \
        RO.O3Config(shadow_model="fupool").to_dict()


@pytest.mark.parametrize("priority", [False, True])
@pytest.mark.parametrize("schedule", ["proxy", "scoreboard"])
@pytest.mark.parametrize("approx", [1.0, 0.375])
def test_fupool_model_matches_reference(window, priority, schedule, approx):
    ref, mine = window
    d = RF.FUPoolConfig(approx_coverage=approx).to_dict()
    rpool, mpool = RF.FUPoolConfig.from_dict(d), F.FUPoolConfig.from_dict(d)
    # a narrow pool, so that shadows are denied and primaries slip
    for p in (rpool, mpool):
        p.int_alu.count = 2
        p.fp_mult.count = 1
    rsched = msched = {}
    if schedule == "scoreboard":
        rsched = _schedule(RT, ref, RT.TimingConfig())
        msched = _schedule(T, mine, T.TimingConfig())
        assert msched["phantom_opclass"].size > 0
    oc = ref_uops.opclass_of(np.asarray(ref.opcode))
    a = RF.FUPoolModel(oc, 4, rpool, priority, **rsched)
    b = F.FUPoolModel(oc, 4, mpool, priority, **msched)
    _same_model(a, b)
    assert b.slip.any() and b.fu_busy.any()
    assert b.shadow_denied.any() or (b.grants == F.GRANT_APPROX).any()
    if not priority:
        # deferred shadows find the exact units taken and fall back
        assert (b.grants == F.GRANT_APPROX).any()
        assert (b.coverage() == np.float32(approx)).any()


def test_phantoms_that_retry_and_a_model_without_retry(window):
    ref, mine = window
    oc = ref_uops.opclass_of(np.asarray(ref.opcode))
    rsched = _schedule(RT, ref, RT.TimingConfig())
    msched = _schedule(T, mine, T.TimingConfig())
    for kw in (dict(phantom_retry=True), dict(retry_primary=False)):
        _same_model(RF.FUPoolModel(oc, 3, None, False, **rsched, **kw),
                    F.FUPoolModel(oc, 3, None, False, **msched, **kw))


@pytest.mark.parametrize("enable,priority,timing", [
    (True, False, "scoreboard"), (True, True, "proxy"),
    (False, False, "scoreboard")])
def test_compute_shadow_cov_matches_reference(window, enable, priority,
                                              timing):
    """Through ``compute_shadow_cov`` with an O3Config, as TrialKernel
    calls it; SHREWD off gives zero coverage and no model."""
    ref, mine = window
    rcfg = RO.O3Config(shadow_model="fupool", enable_shrewd=enable,
                       priority_to_shadow=priority, timing=timing)
    mcfg = compat.config_from_dict(rcfg.to_dict())
    oc = ref_uops.opclass_of(np.asarray(ref.opcode))
    rsched = msched = {}
    if timing == "scoreboard":
        rsched = _schedule(RT, ref, rcfg.timing_cfg)
        msched = _schedule(T, mine, mcfg.timing_cfg)
    a_cov, a = RO.compute_shadow_cov(oc, rcfg, **rsched)
    b_cov, b = O.compute_shadow_cov(oc, mcfg, **msched)
    np.testing.assert_array_equal(a_cov, b_cov)
    if not enable:
        assert a is None and b is None and not b_cov.any()
        return
    _same_model(a, b)
    assert b_cov.any()


def _stats_dumps(model, stats_mod):
    import io

    g = model.stats_group()
    text, js = io.StringIO(), io.StringIO()
    stats_mod.dump_text(g, text)
    stats_mod.dump_json(g, js)
    return text.getvalue(), js.getvalue()


def test_stats_group_waits_for_the_stats_package(window):
    """The stats package is ported now: the group of the default pool
    dumps as the reference's."""
    from shrewd_tpu import stats as ref_stats
    from shrewd_tpu_torch import stats

    ref, mine = window
    oc = ref_uops.opclass_of(np.asarray(mine.opcode))
    a, b = RF.FUPoolModel(oc), F.FUPoolModel(oc)
    assert _stats_dumps(b, stats) == _stats_dumps(a, ref_stats)


@pytest.mark.parametrize("priority", [False, True])
@pytest.mark.parametrize("schedule", ["proxy", "scoreboard"])
def test_stats_group_matches_reference(window, priority, schedule):
    """A narrow pool (denials, slips, approximate grants), both
    priorities and both schedules: ``stats_group`` dumps to the
    reference's text and JSON."""
    from shrewd_tpu import stats as ref_stats
    from shrewd_tpu_torch import stats

    ref, mine = window
    d = RF.FUPoolConfig(approx_coverage=0.5).to_dict()
    rpool, mpool = RF.FUPoolConfig.from_dict(d), F.FUPoolConfig.from_dict(d)
    for p in (rpool, mpool):
        p.int_alu.count = 2
        p.fp_mult.count = 1
    rsched = msched = {}
    if schedule == "scoreboard":
        rsched = _schedule(RT, ref, RT.TimingConfig())
        msched = _schedule(T, mine, T.TimingConfig())
    oc = ref_uops.opclass_of(np.asarray(ref.opcode))
    a = RF.FUPoolModel(oc, 4, rpool, priority, **rsched)
    b = F.FUPoolModel(oc, 4, mpool, priority, **msched)
    got = _stats_dumps(b, stats)
    assert got == _stats_dumps(a, ref_stats)
    assert '"shadow_denied"' in got[1]
