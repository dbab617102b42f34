"""The host-silicon differential campaigns over a workload list — the port
of the JAX package's ``tools/diff_artifacts.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.diff_artifacts``.  The device column
runs on the card unless ``--platform cpu`` asks for the CPU; without a card
the default raises.

Runs ``ingest.hostdiff.run_diff`` over a workload list in one process and
writes the aggregate document.  Every per-workload failure is recorded as
that workload's row (``error``) instead of aborting the sweep.

Where the port departs from the reference (ROADMAP Queue 3 D8): the
document records ``card``, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (null on the CPU); and the sweep does not clear a compile cache
between workloads (the reference calls ``jax.clear_caches()`` there to
bound XLA's compile state; torch keeps none).  ``--out`` stays required.

Usage:
    python -m shrewd_tpu_torch.tools.diff_artifacts --mode device64 \\
        --trials 200 --out diff_64bit.json
    python -m shrewd_tpu_torch.tools.diff_artifacts --mode output \\
        --trials 500 --out diff_workloads.json [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

DEFAULT_WORKLOADS = [
    "workloads/sort.c", "workloads/intmm.c", "workloads/divmix.c",
    "workloads/bytehash.c", "workloads/memops.c", "workloads/ptrchase.c",
    "workloads/rotmix.c", "workloads/strmix.c",
]

KEEP = ("trials", "host_avf", "device_avf", "avf_abs_err",
        "agreement_exact", "agreement_vulnerable", "cis_overlap",
        "device_diverged", "resync_severed", "escalated_total",
        "diverged_resolved",
        "diverged_resolution_failed", "window_macro_ops_sampled")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.diff_artifacts")
    ap.add_argument("--mode", default="output")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--workloads", nargs="*", default=DEFAULT_WORKLOADS)
    ap.add_argument("--max-steps", type=int, default=2_000_000,
                    help="ptrace capture budget (raise for full-length "
                         "windows, e.g. the 2.1M-macro lzss capture)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.ingest.hostdiff import run_diff
    from shrewd_tpu_torch.tools.northstar import card_identity, device_of

    dev = device_of(a.platform)
    out = {"mode": a.mode, "trials_per_workload": a.trials, "seed": a.seed,
           "bit_range": 64 if a.mode in ("emu64", "device64") else 32,
           "workloads": {}, "card": card_identity(dev)}
    for wl in a.workloads:
        t0 = time.time()
        try:
            rep = run_diff(a.trials, a.seed, wl, mode=a.mode,
                           max_steps=a.max_steps, device=dev)
            row = {k: rep[k] for k in KEEP if k in rep}
            if "lift_stats" in rep:
                row["lift_rate"] = round(rep["lift_stats"]["lift_rate"], 4)
                row["uops"] = rep["lift_stats"]["uops"]
        except Exception as e:  # noqa: BLE001 — record, keep sweeping
            row = {"error": f"{type(e).__name__}: {e}"[:300]}
        row["seconds"] = round(time.time() - t0, 1)
        out["workloads"][wl] = row
        print(f"{wl}: {json.dumps(row)[:200]}", file=sys.stderr, flush=True)
    ok = [w for w in out["workloads"].values() if "agreement_exact" in w]
    if ok:
        out["summary"] = {
            "workloads_ok": len(ok),
            "min_agreement_exact": min(w["agreement_exact"] for w in ok),
            "min_agreement_vulnerable": min(w["agreement_vulnerable"]
                                            for w in ok),
            "max_avf_abs_err": max(w["avf_abs_err"] for w in ok),
        }
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out.get("summary", {})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
