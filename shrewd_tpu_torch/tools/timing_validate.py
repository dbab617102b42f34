"""Scoreboard timing against the host CPU's own cycle counter (rdtsc) —
the port of the JAX package's ``tools/timing_validate.py``, with its flags,
run as ``python -m shrewd_tpu_torch.tools.timing_validate``.

The scoreboard was only self-consistent: no external timing truth existed.
The host x86 core IS a wide out-of-order machine (the same class the
reference's O3 and this scoreboard approximate), so its measured cycle
count for the exact traced kernel is a legitimate external anchor: the
scoreboard's predicted cycles for the lifted window should land within a
small factor of silicon, and closer than the 1-IPC proxy.

The tool has no device work (the harness, the capture, the lift and the
scoreboard all run on the host); ``--platform`` records where it ran.

Where the port departs from the reference (ROADMAP Queue 3 D8):

- **Output path.**  The document goes to ``--out``, by default
  ``timing_validate_torch.json`` in the current directory (the reference
  writes ``TIMING_VALIDATE.json`` into the repository's root).
- **Card identity.**  The document records ``card``, the card's name and
  power limit as ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` gives them (null on the CPU).
- **Build directory.**  The rdtsc harness is built into the port's
  ``shrewd_tpu_torch/_build/``, beside its other binaries (the reference
  builds into ``tests/_build/``).

Usage: python -m shrewd_tpu_torch.tools.timing_validate
           [--workload workloads/sort.c] [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def build_harness(workload: str) -> Path:
    """The rdtsc harness around ``workload``'s kernel, built into the
    port's build directory → its path."""
    from shrewd_tpu_torch.ingest.hostdiff import BUILD_DIR, REPO

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    harness = BUILD_DIR / f"rdtsc_{Path(workload).stem}"
    subprocess.run(
        ["gcc", "-O1", "-static", "-fno-pie", "-no-pie",
         f"-DWORKLOAD=\"{Path(workload).name}\"",
         str(REPO / "workloads" / "rdtsc_harness.c"), "-o", str(harness)],
        check=True, capture_output=True, text=True,
        cwd=str(REPO / "workloads"))
    return harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.timing_validate")
    ap.add_argument("--workload", default="workloads/sort.c")
    ap.add_argument("--out", default="timing_validate_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.models.timing import TimingConfig, compute_scoreboard
    from shrewd_tpu_torch.tools.northstar import card_identity, device_of

    dev = device_of(a.platform)
    # 1. host truth: median rdtsc cycles over the exact kernel call
    harness = build_harness(a.workload)
    host_cycles = int(subprocess.run(
        [str(harness)], check=True, capture_output=True,
        text=True).stdout.strip())

    # 2. model predictions on the lifted marker window
    paths = hd.build_tools(a.workload)
    trace, meta = hd.capture_and_lift(paths)
    sb = compute_scoreboard(trace, TimingConfig(bpred="none"))
    sb_sq = compute_scoreboard(trace, TimingConfig(bpred="bimodal"))
    out = {
        "workload": a.workload,
        "host_cycles_median": host_cycles,
        "macro_ops": meta["macro_ops"],
        "uops": trace.n,
        "host_ipc_macro": round(meta["macro_ops"] / host_cycles, 3),
        "proxy_cycles": trace.n,               # the 1-IPC occupancy proxy
        "scoreboard_cycles": sb.n_cycles,
        "scoreboard_squash_cycles": sb_sq.n_cycles,
        "scoreboard_ipc_uop": round(sb.ipc, 3),
        "ratio_proxy_vs_host": round(trace.n / host_cycles, 3),
        "ratio_scoreboard_vs_host": round(sb.n_cycles / host_cycles, 3),
        "ratio_squash_vs_host": round(sb_sq.n_cycles / host_cycles, 3),
        "note": ("host = this machine's OoO x86 core via rdtsc (median of "
                 "21 warm runs of the exact traced kernel); the model "
                 "closer to ratio 1.0 carries the more faithful residency "
                 "timeline.  The lift can contract macro-ops (deferred "
                 "flag compares emit no µops) or expand them (sub-word/"
                 "guard sequences), so µop and macro counts differ."),
        "card": card_identity(dev),
    }
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
