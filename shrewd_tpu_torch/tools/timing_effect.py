"""Timing-model AVF sensitivity — the port of the JAX package's
``tools/timing_effect.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.timing_effect``.  Trials run on the card
unless ``--platform cpu`` asks for the CPU; without a card the default
raises.

Per structure, the same trial budget under three fault-landing models:

- proxy:       1-IPC occupancy window
- scoreboard:  dependence-driven residency mass
- squash:      scoreboard + bimodal-mispredict wrong-path mass — faults
               landing in would-be-squashed entries are masked by the
               squash walk (reference rob.hh:207)

Each (structure, model) is one ``TrialKernel.run_keys``: one launch of the
fast-pass kernel on the card, 12 in all.

Where the port departs from the reference (ROADMAP Queue 3 D8): the
document goes to ``--out``, by default ``timing_effect_torch.json`` in the
current directory (the reference writes ``TIMING_EFFECT.json`` into the
repository's root), and records ``card``, the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (null on the CPU).

Usage: python -m shrewd_tpu_torch.tools.timing_effect [--trials 8192]
           [--workload workloads/sort.c] [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

STRUCTURES = ("rob", "iq", "lsq", "fu")


def models() -> dict:
    """The three fault-landing models, by name."""
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.models.timing import TimingConfig

    return {
        "proxy": O3Config(timing="proxy"),
        "scoreboard": O3Config(timing="scoreboard"),
        "squash": O3Config(timing="scoreboard",
                           timing_cfg=TimingConfig(bpred="bimodal")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.timing_effect")
    ap.add_argument("--trials", type=int, default=8192)
    ap.add_argument("--workload", default="workloads/sort.c")
    ap.add_argument("--out", default="timing_effect_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.tools.northstar import card_identity, device_of
    from shrewd_tpu_torch.utils import prng

    dev = device_of(a.platform)
    paths = hd.build_tools(a.workload)
    trace, meta = hd.capture_and_lift(paths)
    keys = prng.trial_keys(prng.campaign_key(17, dev), a.trials)

    out = {"workload": a.workload, "trials": a.trials,
           "window_uops": trace.n, "structures": {},
           "card": card_identity(dev)}
    cfgs = models()
    for structure in STRUCTURES:
        row = {}
        for name, cfg in cfgs.items():
            k = TrialKernel(trace, cfg, device=dev)
            tally = k.run_keys(keys, structure).numpy()
            avf = float((tally[1] + tally[2]) / max(tally.sum(), 1))
            row[name] = {"avf": round(avf, 4),
                         "tally": [int(x) for x in tally]}
            if name == "squash":
                sb = k.scoreboard
                row[name]["mispredicts"] = int(sb.mispredict.sum())
                row[name]["wp_mass"] = sb.wrongpath_mass(structure)
        row["avf_delta_scoreboard"] = round(
            row["scoreboard"]["avf"] - row["proxy"]["avf"], 4)
        row["avf_delta_squash"] = round(
            row["squash"]["avf"] - row["scoreboard"]["avf"], 4)
        out["structures"][structure] = row
        print(f"{structure}: proxy {row['proxy']['avf']:.4f} "
              f"scoreboard {row['scoreboard']['avf']:.4f} "
              f"squash {row['squash']['avf']:.4f}", file=sys.stderr)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({s: {m: out["structures"][s][m]["avf"]
                          for m in ("proxy", "scoreboard", "squash")}
                      for s in out["structures"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
