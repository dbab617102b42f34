"""SimPoint-weighted AVF, end to end on a real program — the port of the
JAX package's ``tools/simpoint_avf.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.simpoint_avf``.  Trials run on the card
unless ``--platform cpu`` asks for the CPU.

gem5's methodology at SPEC scale: profile basic-block vectors over the
whole measured region, k-means to representative intervals, simulate each
representative, report the population-weighted metric
(``src/cpu/simple/probes/simpoint.hh:82``, ``x86-spec-cpu2017.py``).
Here: capture the marker window of a real workload, select K
representative intervals, emulate+lift each (restore-then-rewarm, no
checkpoint file), run a REGFILE campaign per window on the replay kernel,
and report the weighted AVF next to the whole-window AVF it approximates
(``--whole-window`` lifts and campaigns the full capture as the
validation baseline).

The document goes to ``--out``, by default ``simpoint_avf_torch.json`` in
the current directory (the reference writes into the repository's root;
ROADMAP Queue 3 D7), and records ``platform`` and ``card``, the card's
name and power limit (null on the CPU).

Usage: python -m shrewd_tpu_torch.tools.simpoint_avf
           [--workload workloads/lzss_small.c] [--k 4] [--interval 4000]
           [--trials 2048] [--whole-window] [--seed 0] [--out FILE]
           [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.simpoint_avf")
    ap.add_argument("--workload", default="workloads/lzss_small.c")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--interval", type=int, default=4000)
    ap.add_argument("--trials", type=int, default=2048)
    ap.add_argument("--max-steps", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--whole-window", action="store_true",
                    help="also lift + campaign the FULL capture: the "
                         "baseline the weighted AVF approximates")
    ap.add_argument("--out", default="simpoint_avf_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.simpoint import simpoint_windows
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.tools.northstar import (card_identity, device_of,
                                                  platform_name)
    from shrewd_tpu_torch.utils import prng

    dev = device_of(a.platform)
    t0 = time.time()
    paths = hd.build_tools(a.workload)
    windows, sps, profile = simpoint_windows(
        paths, interval=a.interval, k=a.k, max_steps=a.max_steps,
        seed=a.seed)
    out = {"workload": a.workload, "interval_macro_ops": a.interval,
           "seed": a.seed,
           "k_requested": a.k, "k_selected": len(windows),
           "n_intervals": int(len(sps.labels)),
           "trials_per_window": a.trials,
           "select_seconds": round(time.time() - t0, 1),
           "platform": platform_name(dev),
           "card": card_identity(dev),
           "windows": []}
    root = prng.campaign_key(a.seed, dev)
    weighted = 0.0
    for trace, meta in windows:
        t1 = time.time()
        k = TrialKernel(trace, O3Config(), device=dev)
        # full PRNG address: (seed, simpoint, structure, batch) — keeps
        # every window's samples independent and single-trial replayable
        keys = prng.trial_keys(prng.batch_key(prng.structure_key(
            prng.simpoint_key(root, meta["simpoint_interval"]), 0), 0),
            a.trials)
        tally = k.run_keys(keys, "regfile")
        avf = float(C.avf(tally))
        weighted += meta["simpoint_weight"] * avf
        row = {"interval": meta["simpoint_interval"],
               "weight": round(meta["simpoint_weight"], 4),
               "uops": trace.n,
               "lift_rate": round(meta["stats"]["lift_rate"], 4),
               "avf": round(avf, 4),
               "tally": [int(x) for x in tally.tolist()],
               "seconds": round(time.time() - t1, 1)}
        out["windows"].append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    out["weighted_avf"] = round(weighted, 4)
    if a.whole_window:
        t1 = time.time()
        trace, meta = hd.capture_and_lift(paths, max_steps=a.max_steps)
        k = TrialKernel(trace, O3Config(), device=dev)
        keys = prng.trial_keys(prng.batch_key(prng.structure_key(
            prng.simpoint_key(root, 10**6), 0), 0), a.trials)
        tally = k.run_keys(keys, "regfile")
        out["whole_window"] = {
            "uops": trace.n,
            "lift_rate": round(meta["stats"]["lift_rate"], 4),
            "avf": round(float(C.avf(tally)), 4),
            "tally": [int(x) for x in tally.tolist()],
            "seconds": round(time.time() - t1, 1)}
        out["weighted_vs_whole_abs_err"] = round(
            abs(out["weighted_avf"] - out["whole_window"]["avf"]), 4)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"weighted_avf": out["weighted_avf"],
                      "k": len(windows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
