"""Protection-search validation: analytic prediction against a measured
protected campaign — the port of the JAX package's
``tools/protect_validate.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.protect_validate``.  Trials run on the
card unless ``--platform cpu`` asks for the CPU; without a card the default
raises.

``search/protect.py`` evaluates protection schemes *analytically* over
raw unprotected outcome distributions: a scheme with detection
probability ``d`` predicts ``sdc' = (1-d)·P(sdc | fault)``.  That
algebra assumes detection is independent of the trial's would-be
outcome.  The SHREWD shadow scheme violates independence in principle —
coverage is a *structural* function of the fault's µop (pool pressure
at its issue cycle), and SDC propensity is a *dataflow* function of the
same µop — so this tool measures the real thing:

  unprotected:  TrialKernel(enable_shrewd=False), ``fu`` faults
  protected:    TrialKernel(shadow_model="fupool"), same keys
  prediction:   the Scheme algebra with d = shadow_scheme(kernel).detect
                (mean availability-derated coverage) applied to the
                unprotected tally
  parity leg:   regfile + parity (detect=1) — predicted sdc' = 0; the
                measured analog reclassifies every consumed regfile
                fault as detected (a parity read check fires on first
                use), so the two must agree exactly.

Pass ⇔ measured protected SDC fraction lies inside the analytic
prediction ± the Wilson 95% CI of the measurement, for the shadow leg;
and the parity leg agrees identically.  The exit code is 1 when it does
not pass.

Both kernels carry the lifted window's memmap, so every lane runs the
memmap dense replay.

Where the port departs from the reference (ROADMAP Queue 3 D8): the
document goes to ``--out``, by default ``protect_validate_torch.json`` in
the current directory (the reference writes ``PROTECT_VALIDATE_r05.json``
into the repository's root), and records ``card``, the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (null on the CPU).

Usage: python -m shrewd_tpu_torch.tools.protect_validate [--trials 8192]
           [--workload workloads/sort.c] [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return (max(0.0, c - h), min(1.0, c + h))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shrewd_tpu_torch.tools.protect_validate")
    ap.add_argument("--trials", type=int, default=8192)
    ap.add_argument("--workload", default="workloads/sort.c")
    ap.add_argument("--out", default="protect_validate_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    import numpy as np

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.search.protect import Scheme, shadow_scheme
    from shrewd_tpu_torch.tools.northstar import card_identity, device_of
    from shrewd_tpu_torch.utils import prng

    dev = device_of(a.platform)
    paths = hd.build_tools(a.workload)
    trace, meta = hd.capture_and_lift(paths)
    memmap = hd.memmap_from_meta(meta, device=dev)
    keys = prng.trial_keys(prng.campaign_key(77, dev), a.trials)

    # ---- shadow-FU leg (fu faults) --------------------------------------
    k_off = TrialKernel(trace, O3Config(enable_shrewd=False), memmap=memmap,
                        device=dev)
    t_off = k_off.run_keys(keys, "fu").numpy().astype(np.float64)
    k_on = TrialKernel(trace, O3Config(shadow_model="fupool"),
                       memmap=memmap, device=dev)
    t_on = k_on.run_keys(keys, "fu").numpy().astype(np.float64)

    # conditioned detection estimated on an INDEPENDENT key set (out-of-
    # sample: the validation keys never feed the estimator)
    est_keys = prng.trial_keys(prng.campaign_key(78, dev), a.trials)
    sch = shadow_scheme(k_on, keys=est_keys)
    sch_naive = shadow_scheme(k_on)
    n = t_off.sum()
    p_off = t_off / n
    pred = {
        "sdc": (1.0 - sch.d_sdc) * p_off[C.OUTCOME_SDC],
        "due": (1.0 - sch.d_due) * p_off[C.OUTCOME_DUE],
        "detected": sch.detect,      # E[cov] (unprotected never detects)
    }
    pred["masked"] = 1.0 - pred["sdc"] - pred["due"] - pred["detected"]
    pred_naive_sdc = (1.0 - sch_naive.detect) * p_off[C.OUTCOME_SDC]
    meas = {name: t_on[code] / n for name, code in
            (("masked", C.OUTCOME_MASKED), ("sdc", C.OUTCOME_SDC),
             ("due", C.OUTCOME_DUE), ("detected", C.OUTCOME_DETECTED))}
    ci = {name: wilson(int(t_on[code]), int(n)) for name, code in
          (("sdc", C.OUTCOME_SDC), ("detected", C.OUTCOME_DETECTED))}
    shadow_ok = (ci["sdc"][0] <= pred["sdc"] <= ci["sdc"][1]
                 and ci["detected"][0] <= pred["detected"]
                 <= ci["detected"][1])

    # ---- parity leg (regfile faults) ------------------------------------
    # parity (detect=1) intercepts every *consumed* fault at its first
    # read; faults that would be masked by overwrite/non-consumption stay
    # masked.  Prediction from the unprotected campaign: everything that
    # was NOT masked becomes detected; measured analog: reclassify the
    # unprotected per-trial outcomes the same way — exact agreement is
    # the test that the Scheme algebra's bookkeeping (not the kernel)
    # is consistent, since the kernel has no regfile-parity mechanism.
    t_rf = k_off.run_keys(keys, "regfile").numpy().astype(np.float64)
    parity = Scheme("parity", 1.0, 0.0, 1.0 + 1 / 32).validate()
    resid_p = 1.0 - parity.detect
    pred_parity_sdc = resid_p * (t_rf[C.OUTCOME_SDC] / n)
    out_rf = k_off.outcomes_from_keys(keys, "regfile").cpu().numpy()
    meas_parity = np.where(out_rf == C.OUTCOME_MASKED,
                           C.OUTCOME_MASKED, C.OUTCOME_DETECTED)
    meas_parity_sdc = float((meas_parity == C.OUTCOME_SDC).sum()) / n
    parity_ok = abs(meas_parity_sdc - pred_parity_sdc) < 1e-12

    doc = {
        "workload": a.workload,
        "trials": a.trials,
        "window_uops": int(trace.n),
        "shadow_leg": {
            "scheme_detect": round(sch.detect, 4),
            "scheme_detect_sdc": round(sch.d_sdc, 4),
            "scheme_detect_due": round(sch.d_due, 4),
            "naive_uniform_predicted_sdc": round(float(pred_naive_sdc), 4),
            "note": "the uniform-mean model underpredicts SDC (coverage "
                    "anti-correlates with SDC-prone fault sites); the "
                    "outcome-conditioned estimator (unprotected campaign "
                    "+ coverage array, out-of-sample keys) is the "
                    "search-facing fix",
            "unprotected_tally": [int(x) for x in t_off],
            "protected_tally": [int(x) for x in t_on],
            "predicted": {k: round(v, 4) for k, v in pred.items()},
            "measured": {k: round(v, 4) for k, v in meas.items()},
            "measured_ci95": {k: [round(x, 4) for x in v]
                              for k, v in ci.items()},
            "sdc_within_ci": bool(ci["sdc"][0] <= pred["sdc"]
                                  <= ci["sdc"][1]),
            "detected_within_ci": bool(ci["detected"][0] <= pred["detected"]
                                       <= ci["detected"][1]),
            "pass": bool(shadow_ok),
        },
        "parity_leg": {
            "predicted_sdc": round(float(pred_parity_sdc), 4),
            "measured_sdc": round(meas_parity_sdc, 4),
            "pass": bool(parity_ok),
        },
        "pass": bool(shadow_ok and parity_ok),
        "card": card_identity(dev),
    }
    with open(a.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({"pass": doc["pass"],
                      "shadow_pred_sdc": doc["shadow_leg"]["predicted"]["sdc"],
                      "shadow_meas_sdc": doc["shadow_leg"]["measured"]["sdc"],
                      "ci": doc["shadow_leg"]["measured_ci95"]["sdc"]}))
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
