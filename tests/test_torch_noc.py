"""The port's NoC tier (``models/noc.py``) against the JAX package's, on
the CPU.

The fault model's per-router vectors and the temperature factor, the
message trace, the flit/credit pipeline (the port's step loop over cycles
against the reference's ``lax.scan`` and the scalar oracle, for each
pipeline fault type, on a mesh tight enough that lost credits deadlock),
and per-key outcomes and type-class strata are equal.  Short torture
streams keep the reference's pipeline, which it runs on every lane, inside
the module's time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu.models import mesi as RM
from shrewd_tpu.models import noc as RN
from shrewd_tpu.ops import classify as RC
from shrewd_tpu.ops.trial import N_STRATA
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import mesi as M
from shrewd_tpu_torch.models import noc as N
from test_torch_ruby import one_torch_thread  # noqa: F401

# a mesh whose classes hold one flit each, so that a lost credit starves
TIGHT = dict(vcs_per_vnet=1, buffers_per_data_vc=1, buffers_per_ctrl_vc=1)


def _both(cls_r, cls_p, **kw):
    r = cls_r(**kw)
    return r, cls_p.from_dict(r.to_dict())


@pytest.mark.parametrize("temp", [71.0, -20.0, 30.5, 125.0, 200.0])
def test_temperature_factor_matches_reference(temp):
    assert N.temperature_factor(temp) == RN.temperature_factor(temp)
    v = np.array([temp, 0.0, 99.25])
    np.testing.assert_array_equal(N.temperature_factor(v),
                                  RN.temperature_factor(v))


@pytest.mark.parametrize("geom", [dict(), dict(mesh_x=4, mesh_y=4),
                                  dict(mesh_x=3, mesh_y=1, n_vnets=2,
                                       vcs_per_vnet=2, flit_bits=64)],
                         ids=["2x2", "4x4", "3x1"])
def test_fault_vectors_match_reference(geom):
    rcfg, cfg = _both(RN.NocConfig, N.NocConfig, **geom)
    rfm, fm = RN.FaultModel.for_mesh(rcfg), N.FaultModel.for_mesh(cfg)
    assert fm.n_routers == rfm.n_routers == cfg.n_routers
    temps = [RN.BASELINE_TEMPERATURE_C, 40.0, 130.0,
             np.linspace(20.0, 110.0, cfg.n_routers)]
    for t in temps:
        np.testing.assert_array_equal(fm.fault_vectors(t),
                                      rfm.fault_vectors(t))
        assert fm.aggregate_prob(t) == rfm.aggregate_prob(t)
        assert fm.mtbf_cycles(t) == rfm.mtbf_cycles(t)
    for r in range(cfg.n_routers):
        assert fm.fault_prob(r) == rfm.fault_prob(r)
    assert fm.summary() == rfm.summary()


def _streams(n_cores, n_accesses, seed=0, **noc):
    rm, m = _both(RM.MesiConfig, M.MesiConfig, n_cores=n_cores)
    rn, n = _both(RN.NocConfig, N.NocConfig, **noc)
    rtr = RM.torture_stream(rm, n_accesses, 64, seed=seed)
    tr = M.torture_stream(m, n_accesses, 64, seed=seed)
    return (rm, rn, RN.build_message_trace(rtr, rm, rn)), \
        (m, n, N.build_message_trace(tr, m, n))


@pytest.mark.parametrize("n_cores,noc", [(2, {}), (4, dict(mesh_x=3, **TIGHT)),
                                         (16, dict(mesh_x=4, mesh_y=4))],
                         ids=["2c-2x2", "4c-3x2", "16c-4x4"])
def test_message_trace_matches_reference(n_cores, noc):
    (_, _, rmsgs), (_, _, msgs) = _streams(n_cores, 96, **noc)
    for f in RN.MessageTrace._fields:
        want = np.asarray(getattr(rmsgs, f))
        np.testing.assert_array_equal(getattr(msgs, f), want)
    assert set(np.unique(msgs.kind)) == {N.MSG_REQ, N.MSG_RESP, N.MSG_WB}


@pytest.fixture(scope="module")
def tight():
    """The tight mesh's reference and port kernels on 64 accesses."""
    (rm, rn, rmsgs), (m, n, msgs) = _streams(4, 64, seed=2, **TIGHT)
    return (RN.NocKernel(rmsgs, rn), rmsgs, rn), \
        (N.NocKernel(msgs, n, device="cpu"), msgs, n)


@pytest.mark.parametrize("ftype", N.PIPELINE_TYPES)
def test_flit_sim_matches_reference_and_oracle(tight, ftype):
    (rk, rmsgs, rn), (pk, msgs, n) = tight
    assert pk._horizon == rk._horizon and pk.n_cycles == rk.n_cycles
    rng = np.random.default_rng(ftype)
    lanes = 24
    co = [rng.integers(0, n.n_routers, lanes),
          rng.integers(0, pk.n_cycles, lanes),
          np.full(lanes, ftype), rng.integers(0, N.N_VC, lanes)]
    rf = RN.NocFault(*(jnp.asarray(x, jnp.int32) for x in co))
    want_d, want_c = jax.jit(jax.vmap(
        lambda f: RN.flit_sim(rmsgs, rn, f, rk._horizon)))(rf)
    d, c = N.flit_sim(msgs, n, N.NocFault(*(torch.as_tensor(x)
                                            for x in co)), pk._horizon)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    for b in range(0, lanes, 3):
        sd, sc = N.scalar_flit_sim(msgs, n, fault=tuple(int(x[b])
                                                        for x in co),
                                   horizon=pk._horizon)
        np.testing.assert_array_equal(d[b].numpy(), sd)
        np.testing.assert_array_equal(c[b].numpy(), sc)
    if ftype == N.FT_CREDIT_LOSS:
        assert (d < 0).any(), "no lost credit starved the pipeline"


def test_golden_pipeline_matches_oracle(tight):
    _, (pk, msgs, n) = tight
    f = N.NocFault(*(torch.zeros(1, dtype=torch.int64),) * 2,
                   torch.zeros(1, dtype=torch.int64),
                   torch.zeros(1, dtype=torch.int64))
    f = f._replace(cycle=torch.full((1,), -1))
    d, c = N.flit_sim(msgs, n, f, pk._horizon)
    sd, sc = N.scalar_flit_sim(msgs, n, fault=None)
    np.testing.assert_array_equal(d[0].numpy(), sd)
    assert not c.any() and not sc.any()


@pytest.mark.parametrize("stream", ["2c-2x2", "tight"])
def test_outcomes_and_strata_match_reference(tight, stream):
    if stream == "tight":
        (rk, _, _), (pk, _, _) = tight
    else:
        (_, rn, rmsgs), (_, n, msgs) = _streams(2, 48)
        rk, pk = RN.NocKernel(rmsgs, rn), N.NocKernel(msgs, n, device="cpu")
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(3), 1024)
    keys = compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu")
    rf, pf = rk.sample_batch(rkeys), pk.sample_batch(keys)
    for x, y in zip(pf, rf):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert x.dtype == torch.int32
    want = np.asarray(jax.jit(jax.vmap(rk._classify))(rf))
    got = pk.outcomes_from_keys(keys)
    np.testing.assert_array_equal(got.numpy(), want)
    strata = RN.TYPE_CLASS_TABLE[np.asarray(rf.ftype)]
    pt, pn = pk.run_keys_stratified(keys)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(
        RC.tally_stratified(jnp.asarray(want), jnp.asarray(strata),
                            N_STRATA)))
    assert int(pn) == 0
    np.testing.assert_array_equal(pk.run_keys(keys).numpy(),
                                  np.bincount(want, minlength=4))
    # the batch drew pipeline lanes, which ran compacted
    assert pk.pipeline_lanes > 0
    assert pk.pipeline_lanes == int(np.isin(np.asarray(rf.ftype),
                                            N.PIPELINE_TYPES).sum()) * 3


def test_unknown_structure_is_refused(tight):
    _, (pk, _, _) = tight
    with pytest.raises(ValueError, match="unknown NoC structure"):
        pk.sample_batch(torch.zeros((2, 2), dtype=torch.int64), "link")
