"""The port's thermal RC network (``shrewd_tpu_torch/utils/thermal.py``)
against the JAX package's, on the CPU.

Both factor ``A = G + C/dt`` once in float32 and step backward Euler
from it (the reference a ``lax.scan`` of ``lu_solve``, the port a loop of
``torch.linalg.lu_solve``).  Tolerance: ``trajectory`` and
``steady_state`` agree within ``rtol=1e-5`` — two float32 LU
factorizations and solves (LAPACK's against XLA's), whose rounding may
differ.  The reference's ``tests/test_thermal.py`` cases (step response,
steady state, two-node chain, cooling, activity power to the NoC fault
rate, an empty network rejected) run in the port against their closed
forms too.
"""

import numpy as np
import pytest
import torch

from shrewd_tpu.models import timing as ref_timing
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu.utils import thermal as RT
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models import timing as port_timing
from shrewd_tpu_torch.models.noc import temperature_factor
from shrewd_tpu_torch.utils import thermal as PT

from test_torch_ruby import one_torch_thread  # noqa: F401

# two float32 LU solves (module docstring)
RTOL = 1e-5


def single_rc(mod, r=2.0, c=5.0, step=0.01, ambient=45.0):
    return (mod.ThermalNetwork(n_nodes=1, ambient_c=ambient, step_s=step)
            .resistor(0, -1, r).capacitor(0, -1, c))


def chain(mod):
    return (mod.ThermalNetwork(n_nodes=2, ambient_c=40.0, step_s=0.01)
            .resistor(0, 1, 1.5).resistor(1, -1, 0.5)
            .capacitor(0, -1, 2.0).capacitor(1, -1, 10.0))


def four_node(mod):
    """A die of four blocks in a ring over a spreader to ambient."""
    net = mod.ThermalNetwork(n_nodes=4, ambient_c=45.0, step_s=0.005)
    for i in range(4):
        net.resistor(i, (i + 1) % 4, 0.8 + 0.1 * i)
        net.resistor(i, -1, 2.0 + 0.5 * i)
        net.capacitor(i, -1, 0.3 + 0.05 * i)
    return net


def both(make, power, t0=None):
    ref = make(RT).build()
    port = make(PT).build(device="cpu")
    want = np.asarray(ref.trajectory(power, t0_c=t0))
    got = port.trajectory(power, t0_c=t0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want, port, ref


def test_step_response_matches_reference_and_closed_form():
    r, c, p, step = 2.0, 5.0, 10.0, 0.01
    got, want, _, _ = both(single_rc, np.full((12000, 1), p))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    t = np.arange(1, 12001) * step
    exact = 45.0 + p * r * (1.0 - np.exp(-t / (r * c)))
    assert np.abs(got[:, 0] - exact).max() < 0.1
    assert got[-1, 0] == pytest.approx(45.0 + p * r, abs=0.05)


def test_steady_state_and_two_node_chain():
    port = single_rc(PT, r=3.0, c=1.0).build(device="cpu")
    ref = single_rc(RT, r=3.0, c=1.0).build()
    np.testing.assert_allclose(port.steady_state(np.array([7.0])).numpy(),
                               np.asarray(ref.steady_state(
                                   np.array([7.0]))), rtol=RTOL)
    assert float(port.steady_state(np.array([7.0]))[0]) == \
        pytest.approx(66.0, abs=1e-3)
    power = np.broadcast_to(np.array([8.0, 0.0]), (30000, 2))
    got, want, port, ref = both(chain, power)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    ss = port.steady_state(np.array([8.0, 0.0])).numpy()
    np.testing.assert_allclose(ss, np.asarray(ref.steady_state(
        np.array([8.0, 0.0]))), rtol=RTOL)
    assert ss[0] == pytest.approx(56.0, abs=1e-3)
    assert ss[1] == pytest.approx(44.0, abs=1e-3)
    np.testing.assert_allclose(got[-1], ss, atol=0.05)


def test_cooling_from_hot_start():
    got, want, _, _ = both(single_rc, np.zeros((12000, 1)),
                           t0=np.array([95.0]))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0, 0] < 95.0
    assert got[-1, 0] == pytest.approx(45.0, abs=0.2)
    assert (np.diff(got[:, 0]) <= 1e-9).all()


def test_four_node_network_random_power():
    """The shape ``chip_smoke.py`` runs on the card: four coupled nodes
    under a seeded random power trace."""
    rng = np.random.default_rng(0)
    power = rng.uniform(0.0, 6.0, (2000, 4))
    got, want, _, _ = both(four_node, power)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_activity_power_chain_to_fault_rate():
    """Window activity → power → temperature → NoC fault-rate
    acceleration; ``activity_power`` equals the reference's exactly."""
    ref_t = rsynth.generate(rsynth.WorkloadConfig(
        n=2048, nphys=64, mem_words=256, working_set_words=64, seed=3))
    port_t = compat.trace_from_arrays(*ref_t)
    rsb = ref_timing.compute_scoreboard(ref_t, ref_timing.TimingConfig())
    psb = port_timing.compute_scoreboard(port_t,
                                         port_timing.TimingConfig())
    want = RT.activity_power(ref_t, rsb, interval_cycles=256)
    p = PT.activity_power(port_t, psb, interval_cycles=256)
    np.testing.assert_array_equal(p, want)
    assert p.shape[0] >= 1 and (p > 0).all()
    got, want_traj, _, _ = both(
        lambda m: single_rc(m, r=1.0, c=0.05, step=0.001), p[:, None])
    np.testing.assert_allclose(got, want_traj, rtol=RTOL)
    assert (got >= 45.0 - 1e-6).all()
    f_hot = np.asarray(temperature_factor(float(got.max())))
    f_amb = np.asarray(temperature_factor(45.0))
    assert (f_hot >= f_amb - 1e-12).all()


def test_empty_network_rejected():
    with pytest.raises(ValueError):
        PT.ThermalNetwork(n_nodes=1).build(device="cpu")
    with pytest.raises(ValueError):
        PT.ThermalNetwork(n_nodes=1).resistor(0, -1, -2.0)
    with pytest.raises(ValueError):
        PT.ThermalNetwork(n_nodes=1).capacitor(0, -1, 0.0)


def test_build_defaults_to_the_card():
    net = single_rc(PT)
    if torch.cuda.is_available():
        assert net.build().G.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            net.build()
