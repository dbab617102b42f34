"""Three-way differential on identical fault coordinates — the port of the
JAX package's ``tools/threeway_diff.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.threeway_diff``:

  gem5    — the actual reference binary (checkpoint-patch-restore trials
            recorded in a committed ``GEM5_GOLDEN_*.json``)
  host    — real x86 silicon (hostsfi ptrace flips; re-run here to pin
            run-to-run stability, must match the artifact's host column)
  device  — the port's replay kernel, 64-bit pair-lane lift
            (ingest/lift64.py), diverged trials escalated to the
            whole-program emulator oracle; on the card unless
            ``--platform cpu`` asks for the CPU (without a card the
            default raises)

All three flip the same (reg, bit) of the same architected GPR at the
same kernel_begin marker of the same binary and classify by program
outcome (masked / sdc / due).  The gem5 leg is the reference's own
restore+perturb loop (serialized thread context, the
ThreadContext::setReg shape — reference src/cpu/thread_context.hh:190).

The workload is built with this machine's gcc and must be the binary gem5
perturbed: a binary whose sha256 differs from the golden's ``binary_sha``
is refused (``BinaryMismatch``) before any host or device trial runs.

Where the port departs from the reference (ROADMAP Queue 3 D8): the
document goes to ``--out``, by default ``threeway_torch.json`` in the
current directory (the reference writes ``THREEWAY_r04.json`` into the
repository's root), and records ``card``, the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (null on the CPU).

Usage: python -m shrewd_tpu_torch.tools.threeway_diff
           [--golden GEM5_GOLDEN_r04.json] [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

CLASSES = ("masked", "sdc", "due")


class BinaryMismatch(RuntimeError):
    """The workload built here is not the binary the golden artifact's
    gem5 leg perturbed."""


def tally(seq):
    t = {c: 0 for c in CLASSES}
    for s in seq:
        t[s] += 1
    return t


def golden_workload(golden: dict) -> str:
    """The workload source the golden artifact names: it records
    'workloads/<x>.c (gcc ...)', or a bare stem before ``--workload``."""
    workload_c = golden["workload"].split(" ")[0]
    if "/" not in workload_c:
        workload_c = f"workloads/{workload_c}"
    return workload_c


def check_binary(paths, golden: dict, workload_c: str) -> None:
    """Raise ``BinaryMismatch`` unless the built workload's sha256 is the
    golden's ``binary_sha``."""
    with open(paths.workload, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    if sha != golden["binary_sha"]:
        raise BinaryMismatch(
            f"built {workload_c} sha {sha[:12]} != golden artifact's "
            f"{golden['binary_sha'][:12]} — the three-way would compare "
            "different binaries")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.threeway_diff")
    ap.add_argument("--golden", default=None,
                    help="default: the repository's GEM5_GOLDEN_r04.json")
    ap.add_argument("--out", default="threeway_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.ingest.hostdiff import (HOST_OUTCOME, REPO,
                                                  build_tools,
                                                  capture_and_lift_to_output,
                                                  run_device, run_host)
    from shrewd_tpu_torch.ingest.lift64 import lift64
    from shrewd_tpu_torch.tools.northstar import card_identity, device_of

    dev = device_of(a.platform)
    with open(a.golden or REPO / "GEM5_GOLDEN_r04.json") as f:
        golden = json.load(f)
    trials = golden["trials"]
    if not trials or "host" not in trials[0]:
        raise ValueError("golden artifact lacks per-trial host outcomes")

    names = {v: k for k, v in HOST_OUTCOME.items()}
    # build the SAME workload and prove it is the same binary gem5 perturbed
    workload_c = golden_workload(golden)
    paths = build_tools(workload_c)
    check_binary(paths, golden, workload_c)
    coords = np.array([[0, t["reg"], t["bit"]] for t in trials],
                      dtype=np.int64)

    # host leg re-run: silicon outcomes must reproduce the artifact's
    host = run_host(paths, coords)
    host_cls = [names[int(h)] for h in host]
    host_stable = sum(h == t["host"] for h, t in zip(host_cls, trials))

    # device leg: 64-bit pair-lane lift on the replay kernel
    trace, meta = capture_and_lift_to_output(paths, lifter=lift64)
    report: dict = {}
    dev_out = run_device(trace, meta, coords, paths=paths, report=report,
                         device=dev)
    dev_cls = [names[int(d)] for d in dev_out]

    n = len(trials)
    gem5_cls = [t["gem5"] for t in trials]

    def pair(x, y):
        return sum(p == q for p, q in zip(x, y)) / n

    def vuln(x, y):
        return sum((p != "masked") == (q != "masked")
                   for p, q in zip(x, y)) / n

    def avf(c):
        return sum(v != "masked" for v in c) / n

    doc = {
        "experiment": golden["experiment"],
        "workload": golden["workload"],
        "binary_sha": golden["binary_sha"],
        "coords": n,
        "tallies": {"gem5": tally(gem5_cls), "host": tally(host_cls),
                    "device": tally(dev_cls)},
        "avf": {"gem5": avf(gem5_cls), "host": avf(host_cls),
                "device": avf(dev_cls)},
        "agreement_exact": {
            "gem5_vs_host": pair(gem5_cls, host_cls),
            "gem5_vs_device": pair(gem5_cls, dev_cls),
            "host_vs_device": pair(host_cls, dev_cls),
            "all_three": sum(g == h == d for g, h, d in
                             zip(gem5_cls, host_cls, dev_cls)) / n,
        },
        "agreement_vulnerable": {
            "gem5_vs_device": vuln(gem5_cls, dev_cls),
            "host_vs_device": vuln(host_cls, dev_cls),
        },
        "host_rerun_stability": host_stable / n,
        "device_report": {k: int(v) if isinstance(v, (int, np.integer))
                          else v for k, v in report.items()},
        "disagreements_total": sum(not (g == h == d) for g, h, d in
                                   zip(gem5_cls, host_cls, dev_cls)),
        "disagreements": [
            {"reg": t["reg"], "bit": t["bit"], "gem5": g, "host": h,
             "device": d}
            for t, g, h, d in zip(trials, gem5_cls, host_cls, dev_cls)
            if not (g == h == d)][:64],
        "note": ("One binary, one marker, one coordinate list, three "
                 "executors.  The gem5 column is the reference binary's "
                 "own checkpoint-perturb-restore loop; the device column "
                 "is computed by this framework's replay kernel over the "
                 "64-bit pair-lane lift, with diverged trials escalated "
                 "to the whole-program emulator oracle."),
        "card": card_identity(dev),
    }
    with open(a.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({k: doc[k] for k in
                      ("avf", "agreement_exact", "agreement_vulnerable",
                       "host_rerun_stability")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
