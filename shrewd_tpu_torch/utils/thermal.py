"""Thermal RC network — the reference's ThermalModel (port of
``shrewd_tpu/utils/thermal.py``).

The reference solves a lumped RC thermal circuit by nodal analysis once
per step: every entity (``ThermalResistor``, ``ThermalCapacitor``,
``ThermalReference``, power-injecting ``ThermalDomain``) contributes a
row to a linear system that is Gauss-eliminated each tick
(``src/sim/power/thermal_model.cc:151-172`` ``doStep`` /
``LinearEquation::solve``; entity stamps ``:77-139``), with domain power
coming from ``MathExprPowerModel`` expressions over stats.

Redesign: the circuit is compiled ONCE into dense nodal matrices and
the whole trajectory runs as a loop of backward-Euler steps —

    (G + C/dt) · T[k+1] = (C/dt) · T[k] + b + P[k]

with ``A = G + C/dt`` factored a single time (the step is fixed, like
the reference's ``_step``), so each step is one matrix-vector solve on
the device.  The JAX package factors with ``jax.scipy.linalg.lu_factor``
and scans ``lu_solve`` (XLA code, not a Pallas kernel); the port factors
with ``torch.linalg.lu_factor`` and runs ``torch.linalg.lu_solve`` in a
step loop, float32 on an explicit device (``build(device=…)``; None is
the card).  Power per domain
comes from window activity: a per-OpClass energy table over the
scoreboard's per-interval issue counts (the MathExprPowerModel analog —
an expression over the framework's own stats).

The trajectory feeds ``models.noc.FaultModel``'s per-router temperature
(its Arrhenius acceleration, ``models/noc.py temperature_factor``),
closing the reference's power→thermal→fault-rate chain
(``src/mem/ruby/network/fault_model``, ``sim/power``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.utils.config import ConfigObject, Param
from shrewd_tpu_torch.utils.device import resolve as resolve_device

KELVIN = 273.15


class ThermalNetwork(ConfigObject):
    """Circuit description: ``n_nodes`` free nodes plus one ambient
    reference (node index -1).  Components are added with ``resistor`` /
    ``capacitor`` calls before ``build``."""

    n_nodes = Param(int, 1, "free (non-reference) thermal nodes")
    ambient_c = Param(float, 45.0, "reference temperature (°C) — the "
                      "reference's ThermalReference node")
    step_s = Param(float, 0.01, "solver step (the reference's "
                   "ThermalModel.step, seconds)")

    def __post_init__(self):
        self._res: list[tuple[int, int, float]] = []
        self._cap: list[tuple[int, int, float]] = []

    # ConfigObject may not call __post_init__; lazy-init the lists
    def _lists(self):
        if not hasattr(self, "_res"):
            self._res = []
            self._cap = []
        return self._res, self._cap

    def resistor(self, n1: int, n2: int, r_kpw: float) -> "ThermalNetwork":
        """Thermal resistance between nodes (K/W); -1 = ambient
        (``ThermalResistor::getEquation``, thermal_model.cc:77)."""
        if r_kpw <= 0:
            raise ValueError("resistance must be > 0")
        res, _ = self._lists()
        res.append((int(n1), int(n2), float(r_kpw)))
        return self

    def capacitor(self, n1: int, n2: int, c_jpk: float) -> "ThermalNetwork":
        """Thermal capacitance (J/K) between nodes
        (``ThermalCapacitor::getEquation``, thermal_model.cc:112)."""
        if c_jpk <= 0:
            raise ValueError("capacitance must be > 0")
        _, cap = self._lists()
        cap.append((int(n1), int(n2), float(c_jpk)))
        return self

    def build(self, device=None) -> "CompiledThermal":
        """Factor the circuit on ``device`` (None is the card; ``"cpu"``
        the CPU): the nodal matrices in float32, as the reference's."""
        res, cap = self._lists()
        if not res and not cap:
            raise ValueError("empty thermal network")
        n = int(self.n_nodes)
        G = np.zeros((n, n))
        C = np.zeros((n, n))
        b = np.zeros(n)          # constant injections from ambient ties
        amb = self.ambient_c + KELVIN
        for n1, n2, r in res:
            g = 1.0 / r
            for a, o in ((n1, n2), (n2, n1)):
                if a < 0:
                    continue
                G[a, a] += g
                if o < 0:
                    b[a] += g * amb
                else:
                    G[a, o] -= g
        for n1, n2, c in cap:
            for a, o in ((n1, n2), (n2, n1)):
                if a < 0:
                    continue
                C[a, a] += c
                if o >= 0:
                    C[a, o] -= c
        dt = float(self.step_s)
        A = G + C / dt
        dev = resolve_device(device)
        return CompiledThermal(
            A_lu=torch.linalg.lu_factor(_f32(A, dev)),
            G=_f32(G, dev), C_dt=_f32(C / dt, dev), b=_f32(b, dev),
            ambient_k=amb, step_s=dt, n_nodes=n)


def _f32(x, device) -> torch.Tensor:
    """Host values (or a tensor) → float32 on ``device``, each float64
    value rounded once, as jax without x64 takes them."""
    if not torch.is_tensor(x):
        x = np.array(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class CompiledThermal(NamedTuple):
    """Factored backward-Euler stepper (tensors on one device)."""

    A_lu: tuple
    G: torch.Tensor
    C_dt: torch.Tensor
    b: torch.Tensor
    ambient_k: float
    step_s: float
    n_nodes: int

    def trajectory(self, power_w, t0_c=None) -> torch.Tensor:
        """Temperatures (°C, [steps, n_nodes], float32 on the factor's
        device) for a power trace ([steps, n_nodes] watts) — one loop of
        pre-factored solves (the whole reference event loop collapses
        into it).

        Iterates the DELTA from ambient, not absolute Kelvin: for a
        network referenced to one ambient, the constant injections
        cancel exactly (b ≡ G·amb for the tie rows), and deltas of a few
        tens of K keep single precision exact where absolute ~330 K
        accumulates visible f32 drift."""
        lu, piv = self.A_lu
        dev = lu.device
        power = _f32(power_w, dev)
        amb_c = self.ambient_k - KELVIN
        d = (torch.zeros(self.n_nodes, dtype=torch.float32, device=dev)
             if t0_c is None else
             _f32(t0_c, dev) - np.float32(amb_c))
        out = torch.empty((power.shape[0], self.n_nodes),
                          dtype=torch.float32, device=dev)
        for k in range(power.shape[0]):
            rhs = self.C_dt @ d + power[k]
            d = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
            out[k] = d
        return out + np.float32(amb_c)

    def steady_state(self, power_w) -> torch.Tensor:
        """Equilibrium temperatures (°C) for constant power — capacitor
        currents vanish, leaving the conductance solve G·T = b + P."""
        rhs = self.b + _f32(power_w, self.G.device)
        return (torch.linalg.solve(self.G, rhs[:, None])[:, 0]
                - np.float32(KELVIN))


def activity_power(trace, sb, energy_pj=None, interval_cycles: int = 1024,
                   static_w: float = 0.5, cycle_time_ns: float = 0.333
                   ) -> np.ndarray:
    """Per-interval dynamic power (W, [steps]) from window activity —
    the MathExprPowerModel analog (``sim/power/mathexpr_powermodel.cc``):
    energy per issued µop by OpClass over the scoreboard's issue
    schedule, plus static power."""
    from shrewd_tpu_torch.isa import uops as U

    if energy_pj is None:
        # per-µop dynamic energy by OpClass (pJ): IntAlu, IntMult,
        # MemRead, MemWrite, No_OpClass, FloatAdd, FloatMultDiv
        energy_pj = np.array([8.0, 24.0, 30.0, 30.0, 0.0, 16.0, 40.0])
    oc = np.asarray(U.opclass_of(np.asarray(trace.opcode)))
    issue = np.asarray(sb.issue)
    n_cyc = int(issue.max()) + 1 if issue.size else 1
    steps = max((n_cyc + interval_cycles - 1) // interval_cycles, 1)
    e = np.zeros(steps)
    np.add.at(e, np.minimum(issue // interval_cycles, steps - 1),
              energy_pj[oc])
    dt_s = interval_cycles * cycle_time_ns * 1e-9
    return e * 1e-12 / dt_s + static_w
