"""SHREWD replication design-space search: pick protected structures for
SDC < target at minimum area (BASELINE configs[4]; SURVEY §7 build-plan #7).

The reference explores protection by *running* gem5 once per candidate
microarchitecture (shadow FUs on/off, per-structure knobs) — each point a
full serial campaign.  The TPU framework inverts this: the Monte-Carlo
campaign measures each structure's **raw** conditional outcome distribution
P(outcome | fault in s) once, and protection is then evaluated analytically
over the whole design space at once — a vmapped sweep over protection
assignments that reuses the trial outcomes instead of re-simulating them.

Model
-----
A *scheme* protects one structure with detection probability ``d`` (fault
intercepted and reported — the shadow-FU/ parity/ DMR class) and correction
probability ``c`` (fault scrubbed — ECC/TMR class), at an area multiplier.
A fault in structure *s* under scheme *k* lands:

  masked':  c + (1-c-d)·P(masked|s)
  sdc':         (1-c-d)·P(sdc|s)
  due':         (1-c-d)·P(due|s)
  detected': d + (1-c-d)·P(detected|s)

Fault arrival per structure is ``fit_per_bit × bits × area_factor`` — extra
protection bits are themselves targets (conservative).  System SDC rate is
the rate-weighted sum of sdc' across structures; total area the bit-weighted
sum of factors.  The search returns the minimum-area assignment meeting the
SDC target, plus the area/SDC Pareto front for the full space.

Raw distributions must come from an **unprotected** campaign
(``O3Config(enable_shrewd=False)``) so protection is not double-counted;
the shadow-FU scheme's detection probability is derated by structural
availability via ``shadow_scheme(kernel)`` (models/fupool.py).

Port of ``shrewd_tpu/search/protect.py``.  The reference's sweep is XLA
code (``jax.jit(jax.vmap(one))``), not a Pallas kernel; here it is plain
torch on an explicit device: the per-scheme tables are gathered by the
``[N, S]`` config indices and the products summed over the structures,
in float32 and in the reference's order of products, chunked at
``EVAL_CHUNK``.  Departure: the reference routes its compiled sweep
through the content-keyed executable cache; torch compiles nothing, so
there is no executable to share and no routing.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from shrewd_tpu_torch.ops import classify as C
from shrewd_tpu_torch.utils.device import resolve as resolve_device


class Scheme(NamedTuple):
    """One protection option (applies to a single structure).

    ``detect`` may hide outcome correlation: a structural scheme's
    coverage varies per fault site, and sites whose faults would be SDC
    can have below-average coverage (PROTECT_VALIDATE_r05 measured the
    uniform-mean model underpredicting shadow-FU SDC by 26%).
    ``detect_sdc``/``detect_due`` optionally carry the
    outcome-conditioned detection probabilities E[cov | outcome] —
    estimable from an UNPROTECTED campaign (per-trial outcome × the
    fault site's coverage), so the search still never needs protected
    runs.  None falls back to the scalar."""

    name: str
    detect: float    # P(fault intercepted and reported)
    correct: float   # P(fault scrubbed before consumption)
    area: float      # area multiplier on the protected structure
    detect_sdc: float | None = None   # E[detect | fault would be SDC]
    detect_due: float | None = None   # E[detect | fault would be DUE]

    def validate(self) -> "Scheme":
        for d in (self.detect, self.detect_sdc, self.detect_due):
            if d is None:
                continue
            if not (0.0 <= d and 0.0 <= self.correct
                    and d + self.correct <= 1.0):
                raise ValueError(
                    f"{self.name}: need detect+correct in [0,1]")
        if self.area < 1.0:
            raise ValueError(f"{self.name}: area multiplier < 1")
        return self

    @property
    def d_sdc(self) -> float:
        return self.detect if self.detect_sdc is None else self.detect_sdc

    @property
    def d_due(self) -> float:
        return self.detect if self.detect_due is None else self.detect_due


# The classic SEU-protection ladder.  Area factors are the conventional
# storage overheads (parity: 1 bit/word proxy; SECDED on 32-bit words:
# 7/32; DMR/TMR: full replication) — all overridable per design space.
NONE = Scheme("none", 0.0, 0.0, 1.0)
PARITY = Scheme("parity", 1.0, 0.0, 1.0 + 1 / 32)
SECDED = Scheme("secded", 0.0, 1.0, 1.0 + 7 / 32)
DMR = Scheme("dmr", 1.0, 0.0, 2.0)
TMR = Scheme("tmr", 0.0, 1.0, 3.0)
DEFAULT_SCHEMES = [NONE, PARITY, SECDED, DMR, TMR]


def shadow_scheme(kernel, area: float = 1.5, name: str = "shadow",
                  keys=None, structure: str = "fu") -> Scheme:
    """The SHREWD scheme itself: redundant execution on shadow FUs.

    Detection probability = the availability-derated per-µop coverage the FU
    pool grants (mean over the uniform-over-µops FU fault model) — i.e. what
    the reference's per-OpClass availability stats (inst_queue.hh:581-606)
    aggregate to.  ``area`` is the FU-pool overhead of provisioning shadows
    (no extra architectural state, so the default is a logic-area estimate).

    With ``keys`` (``(B, 2)`` threefry keys), also estimates the
    outcome-CONDITIONED detection probabilities from one *unprotected*
    campaign: coverage is structural (pool pressure at the fault µop's
    issue cycle) and correlates with the fault's would-be outcome, so
    ``E[cov | SDC]`` differs from the uniform mean (measured 26% lower on
    the sort window, PROTECT_VALIDATE_r05).  Still zero protected runs —
    the search's core economy.  The unprotected batch runs the kernel's
    hybrid path (the fast pass, then exact resolution of the lanes that
    escape), whose outcomes equal the dense scan's lane for lane."""
    cov = kernel.shadow_cov.detach().cpu().numpy().astype(np.float64)
    d = float(cov.mean())
    d_sdc = d_due = None
    if keys is not None:
        if structure != "fu":
            raise ValueError("shadow_scheme conditions on FU fault sites; "
                             f"structure={structure!r} samplers emit "
                             "entries (sentinels, register indices) that "
                             "are not µop coverage sites")
        faults = kernel.sample_batch(torch.as_tensor(keys), structure)
        k_off = kernel.with_shrewd(enable=False)
        out = np.asarray(k_off.run_batch_hybrid(faults, may_latch=False))
        entry = faults.entry.cpu().numpy()
        # wrong-path draws carry the past-window sentinel (entry == n,
        # squash-masked, never detected) — their coverage is zero
        onpath = (0 <= entry) & (entry < cov.shape[0])
        site_cov = np.where(onpath, cov[np.clip(entry, 0,
                                                cov.shape[0] - 1)], 0.0)
        # the scalar must be the coverage mean over the SAMPLER's site
        # distribution (residency-weighted), not the trace-uniform mean —
        # P(detected) = E_sampled[cov] (PROTECT_VALIDATE_r05: the
        # trace-uniform mean read 0.52 where the sampled mean is 0.26)
        d = float(site_cov.mean())
        for code, which in ((C.OUTCOME_SDC, "sdc"), (C.OUTCOME_DUE, "due")):
            sel = out == code
            if sel.any():
                val = float(site_cov[sel].mean())
                if which == "sdc":
                    d_sdc = val
                else:
                    d_due = val
    return Scheme(name, d, 0.0, float(area),
                  detect_sdc=d_sdc, detect_due=d_due).validate()


class StructureProfile(NamedTuple):
    """One structure's measured raw vulnerability profile.

    ``halfwidth`` carries the live CI half-width of the tally the
    profile was fit from (0.0 = treat as exact): profiles may now be
    fit from *running* campaigns — the scenario-matrix Pareto loop
    (``shrewd_tpu/scenario/``) re-fits after every fleet fold — and a
    decision made over an unconverged tally must know how far the
    point estimate could still move."""

    name: str
    bits: int               # storage size (area & fault-rate proxy)
    probs: np.ndarray       # P(outcome | fault in s), shape (N_OUTCOMES,)
    fit_per_bit: float = 1.0e-3   # raw upset rate per bit (FIT-style unit)
    halfwidth: float = 0.0  # live CI half-width of the source tally

    @classmethod
    def from_tally(cls, name: str, bits: int, tally,
                   fit_per_bit: float = 1.0e-3, halfwidth: float = 0.0,
                   conservative: bool = False) -> "StructureProfile":
        """Fit from a raw outcome tally — converged or LIVE.

        With ``halfwidth`` the profile records the tally's current CI
        half-width; with ``conservative=True`` the vulnerable outcome
        probabilities (SDC, DUE) are additionally raised to their
        ``+halfwidth`` upper bounds (each clipped to [0,1]) and the
        non-vulnerable mass rescaled so the distribution still sums to
        one — the *worst* distribution the running campaign could still
        converge to, which is the safe side for pruning a design point
        early."""
        t = np.asarray(tally, dtype=np.float64)
        n = t.sum()
        if n <= 0:
            raise ValueError(f"{name}: empty tally")
        hw = float(halfwidth)
        if not 0.0 <= hw <= 1.0:
            raise ValueError(f"{name}: halfwidth {hw} outside [0, 1]")
        probs = t / n
        if conservative and hw > 0.0:
            probs = probs.copy()
            vul = np.zeros_like(probs, dtype=bool)
            vul[C.OUTCOME_SDC] = vul[C.OUTCOME_DUE] = True
            # raise each vulnerable outcome toward its +halfwidth bound,
            # but cap the ADDED mass at the distribution's remaining
            # headroom (scaled proportionally when both bounds cannot
            # fit) — the conservative probabilities may never fall
            # below the observed point estimates, whatever the bounds
            # sum to (a post-hoc renormalize would shrink them)
            add = np.minimum(1.0, probs[vul] + hw) - probs[vul]
            headroom = max(0.0, 1.0 - probs[vul].sum())
            if add.sum() > headroom:
                add *= (headroom / add.sum()) if add.sum() > 0 else 0.0
            probs[vul] += add
            rest = probs[~vul].sum()
            spare = max(0.0, 1.0 - probs[vul].sum())
            probs[~vul] *= (spare / rest) if rest > 0 else 0.0
            probs = probs / probs.sum()
        return cls(name, int(bits), probs, float(fit_per_bit), hw)

    @property
    def fit(self) -> float:
        return self.fit_per_bit * self.bits

    def p_lo(self, outcome: int) -> float:
        """Lower CI bound of one outcome probability at the recorded
        half-width (the most optimistic value still reachable)."""
        return float(max(0.0, self.probs[outcome] - self.halfwidth))

    def p_hi(self, outcome: int) -> float:
        """Upper CI bound of one outcome probability at the recorded
        half-width (the most pessimistic value still reachable)."""
        return float(min(1.0, self.probs[outcome] + self.halfwidth))


class SearchResult(NamedTuple):
    feasible: bool
    assignment: dict            # structure name → scheme name (best config)
    area: float                 # total area (bit-weighted) of best config
    sdc_rate: float             # system SDC rate of best config
    due_rate: float
    baseline_area: float        # unprotected-reference-config area
    baseline_sdc: float         # unprotected-reference-config SDC rate
    pareto: list                # [(area, sdc_rate, assignment dict), ...]
    n_configs: int


class DesignSpace:
    """Structures × allowed schemes, evaluated in one batched pass on
    ``device`` (None resolves to the card; ``"cpu"`` runs on the CPU).

    ``allowed`` restricts per-structure scheme choices (e.g. the FU pool is
    protected by shadows or nothing — parity on a logic path is meaningless):
    a dict ``structure name → list of scheme indices``.
    """

    def __init__(self, profiles: list[StructureProfile],
                 schemes: list[Scheme] | None = None,
                 allowed: dict[str, list[int]] | None = None,
                 device=None):
        if not profiles:
            raise ValueError("need at least one structure profile")
        self.device = resolve_device(device)
        self.profiles = list(profiles)
        self.schemes = [s.validate() for s in (schemes or DEFAULT_SCHEMES)]
        names = [p.name for p in profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate structure names: {names}")
        all_k = list(range(len(self.schemes)))
        allowed = allowed or {}
        unknown = set(allowed) - set(names)
        if unknown:
            raise KeyError(f"allowed{sorted(unknown)} not in profiles {names}")
        self.allowed = [list(allowed.get(n, all_k)) for n in names]
        for n, ks in zip(names, self.allowed):
            bad = [k for k in ks if not 0 <= k < len(self.schemes)]
            if bad:
                raise IndexError(f"{n}: scheme indices {bad} out of range")

        # Device-resident evaluation tables in float32, as the reference's
        # (jax without x64 rounds each float64 value to float32 once).
        def table(values) -> torch.Tensor:
            return torch.as_tensor(np.asarray(values, dtype=np.float64)
                                   .astype(np.float32), device=self.device)

        probs = np.stack([np.asarray(p.probs, dtype=np.float64)
                          for p in self.profiles])
        self._p_sdc = table(probs[:, C.OUTCOME_SDC])
        self._p_due = table(probs[:, C.OUTCOME_DUE])
        self._fit = table([p.fit for p in self.profiles])
        self._bits = table([float(p.bits) for p in self.profiles])
        self._det_sdc = table([s.d_sdc for s in self.schemes])
        self._det_due = table([s.d_due for s in self.schemes])
        self._cor = table([s.correct for s in self.schemes])
        self._area = table([s.area for s in self.schemes])

        # The unprotected reference config: per structure, the identity
        # scheme (detect=0, correct=0, area=1) if allowed, else the
        # structure's minimum-area allowed scheme.
        def baseline_choice(ks: list[int]) -> int:
            ident = [k for k in ks if self.schemes[k].detect == 0.0
                     and self.schemes[k].correct == 0.0
                     and self.schemes[k].area == 1.0]
            return ident[0] if ident else min(
                ks, key=lambda k: self.schemes[k].area)
        self._baseline_cfg = np.array(
            [baseline_choice(ks) for ks in self.allowed], dtype=np.int32)

    def _evaluate(self, cfg: torch.Tensor) -> tuple:
        """One chunk of configs (int64[N, S] on the device) → (sdc, due,
        area), float32[N] each: the reference's per-config ``one`` over
        all N at once, its products in its order, each sum over the
        structures taken left to right."""
        cor = self._cor[cfg]
        areaf = self._area[cfg]
        # outcome-conditioned residuals: the SDC term uses
        # E[detect | SDC-bound fault] (see Scheme docstring)
        resid_sdc = 1.0 - self._det_sdc[cfg] - cor
        resid_due = 1.0 - self._det_due[cfg] - cor
        rate = self._fit * areaf        # protection bits are targets too

        def total(terms: torch.Tensor) -> torch.Tensor:
            acc = torch.zeros(terms.shape[0], dtype=terms.dtype,
                              device=terms.device)
            for j in range(terms.shape[1]):
                acc = acc + terms[:, j]
            return acc

        return (total(rate * resid_sdc * self._p_sdc),
                total(rate * resid_due * self._p_due),
                total(self._bits * areaf))

    # Enumeration guard: the cross product grows as len(schemes)^n_structures;
    # past this many configs the host materialization alone is multi-GB.
    MAX_CONFIGS = 1 << 24

    @property
    def n_configs(self) -> int:
        n = 1
        for ks in self.allowed:
            n *= len(ks)
        return n

    def enumerate(self) -> np.ndarray:
        """All assignments, int32[n_configs, n_structures] of scheme ids."""
        n = self.n_configs
        if n > self.MAX_CONFIGS:
            raise ValueError(
                f"design space has {n:,} configs (> {self.MAX_CONFIGS:,}); "
                f"restrict per-structure choices via `allowed` or search a "
                f"subset explicitly — exhaustive enumeration would exhaust "
                f"host/device memory")
        return np.array(list(itertools.product(*self.allowed)),
                        dtype=np.int32)

    # Device pass chunking: bounds peak device memory for large spaces
    # (ADVICE r1: ~10 structures × 5 schemes ≈ 10M configs).
    EVAL_CHUNK = 1 << 20

    def evaluate(self, configs) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """(sdc_rate, due_rate, area) per config, float32 tensors on the
        space's device — batched device passes, chunked at
        ``EVAL_CHUNK`` configs to bound peak device memory."""
        configs = torch.as_tensor(np.asarray(configs, dtype=np.int64),
                                  device=self.device)
        if len(configs) <= self.EVAL_CHUNK:
            return self._evaluate(configs)
        outs = [self._evaluate(configs[i:i + self.EVAL_CHUNK])
                for i in range(0, len(configs), self.EVAL_CHUNK)]
        return tuple(torch.cat([o[j] for o in outs]) for j in range(3))

    def search(self, sdc_target: float) -> SearchResult:
        """Minimum-area assignment with sdc_rate ≤ target, plus the Pareto
        front over the full space."""
        configs = self.enumerate()
        sdc, due, area = (x.cpu().numpy() for x in self.evaluate(configs))
        names = [p.name for p in self.profiles]

        def assignment(i: int) -> dict:
            return {n: self.schemes[k].name
                    for n, k in zip(names, configs[i])}

        # Pareto front: ascending area, strictly improving SDC.
        order = np.lexsort((sdc, area))
        pareto: list[tuple[float, float, dict]] = []
        best_sdc = np.inf
        for i in order:
            if sdc[i] < best_sdc:
                best_sdc = float(sdc[i])
                pareto.append((float(area[i]), float(sdc[i]),
                               assignment(int(i))))

        feasible = sdc <= sdc_target
        base_sdc, _, base_area = (
            float(x.cpu().numpy()[0])
            for x in self.evaluate(self._baseline_cfg[None, :]))
        if feasible.any():
            # min area among feasible; SDC breaks area ties
            cand = np.nonzero(feasible)[0]
            best = int(cand[np.lexsort((sdc[cand], area[cand]))[0]])
            ok = True
        else:
            best = int(np.argmin(sdc))   # closest approach, reported infeasible
            ok = False
        return SearchResult(
            feasible=ok, assignment=assignment(best),
            area=float(area[best]), sdc_rate=float(sdc[best]),
            due_rate=float(due[best]),
            baseline_area=base_area, baseline_sdc=base_sdc,
            pareto=pareto, n_configs=len(configs))
