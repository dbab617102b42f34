"""The large-window pipeline — the port of the JAX package's
``tools/bigwindow.py``, with its flags, run as
``python -m shrewd_tpu_torch.tools.bigwindow``.

Captures a workload once, lifts windows of several lengths, caches them
as .npz traces, and measures replay throughput per window length on the
card (or the CPU with ``--platform cpu``) — the dense kernel and/or the
chunked hierarchical campaign (``ops/chunked.py``).  The reference analog
is the SPEC-SimPoint flow (30B-instruction measured regions,
``x86_spec/x86-spec-cpu2017.py:404``); here the capture is a ptrace
single-step of the marked kernel and the window is the lifted µop stream.

The dense rate's path is the fast pass (K1, ``csrc/taint_fast.cu``), the
row pass over the escaped lanes and the dense re-run of the overflowed
ones; the chunked rate's is the chunk kernel's fast waves (K2) and the
exact fallback.

Where the port departs from the reference (ROADMAP Queue 3 D9):

- **Build directory.**  The windows and the capture go to the port's
  ``shrewd_tpu_torch/_build/``, beside its other binaries (the reference
  caches them in ``tests/_build/``).
- **A capture cut by ``--max-steps``.**  The tracer stops at
  ``--max-steps`` macro-steps (its rc 1) when the window is longer; the
  reference's build raises there, the port's lifts the prefix it holds
  and records ``capture_truncated``, and raises if a length asked for is
  longer than that prefix lifts to.  A capture whose program exits
  before the end marker, or whose last steps repeat one state, is taken
  again (``hostdiff.run_tracer``), then raises.
- **The accelerator's batch.**  On the card the default batches take the
  reference's accelerator branch: ``min(131072, (1<<29)//n)`` dense and
  ``min(16384, (1<<26)//(n//64))`` chunked; on the CPU its CPU branch.
- **Timing.**  Each timed call ends on a device sync; the dense row also
  records the ``tally`` of its last timed call.
- **Card identity.**  The document records ``workload``, ``platform``
  (``"gpu"`` or ``"cpu"``), ``card``, the card's name and power limit as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them (null on the CPU), and ``setup``: the seconds to build the tools,
  and per window to load it and build its kernel (the dense golden record
  is built in the warm call, as in the reference).
- **Output path.**  The document goes to ``--out``, by default
  ``bigwindow_torch.json`` in the current directory.

Usage:
    python -m shrewd_tpu_torch.tools.bigwindow --build          # capture+lift
    python -m shrewd_tpu_torch.tools.bigwindow --rate           # dense
    python -m shrewd_tpu_torch.tools.bigwindow --rate --chunked # chunked
    python -m shrewd_tpu_torch.tools.bigwindow --build --rate --chunked \\
        --lengths 4096 --max-steps 50000 --platform cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from shrewd_tpu_torch.ingest.hostdiff import BUILD_DIR as CACHE

LENGTHS = (4096, 65536, 524288)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_path(stem: str, n: int) -> Path:
    return CACHE / f"{stem}_w{'full' if n == 0 else n}.npz"


def build(lengths=LENGTHS, workload="workloads/lzss.c",
          max_steps=4_000_000, setup: dict | None = None) -> dict:
    """Capture ``workload``'s marked kernel once and lift a window of each
    length (0: the whole capture) into the cache → the capture's steps and
    seconds and each window's µops, lift rate and seconds.  ``setup`` takes
    the tools' build seconds."""
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.lift import (lift, read_nativetrace,
                                              static_decode)
    from shrewd_tpu_torch.trace import format as tfmt

    stem = Path(workload).stem
    t0 = time.time()
    paths = hd.build_tools(workload)
    if setup is not None:
        setup["tools_seconds"] = round(time.time() - t0, 1)
    trace_bin = CACHE / f"{stem}_capture.{os.getpid()}.bin"
    info = {}
    try:
        t0 = time.time()
        # rc 1 without "child exited": the window is longer than
        # max_steps, and the capture holds the prefix it stepped
        proc = hd.run_tracer(
            subprocess.run,
            [str(paths.tracer), str(trace_bin), f"{paths.begin:x}",
             f"{paths.end:x}", str(max_steps), str(paths.workload)],
            lambda p: hd.window_complete(p) or (
                p.returncode == 1 and "child exited" not in p.stderr
                and not hd.stuck(trace_bin)))
        if proc.returncode not in (0, 1) or "child exited" in proc.stderr:
            raise RuntimeError(f"capture failed (rc {proc.returncode}): "
                               f"{proc.stderr.strip()}")
        nt = read_nativetrace(trace_bin)
        insts = static_decode(str(paths.workload))
        info["capture_steps"] = len(nt.steps) - 1
        info["capture_seconds"] = round(time.time() - t0, 1)
        info["capture_truncated"] = proc.returncode == 1
        log(f"capture: {info['capture_steps']} macro-steps "
            f"in {info['capture_seconds']}s"
            + (" (cut at --max-steps)" if proc.returncode else ""))
        for n in lengths:
            t0 = time.time()
            tr, meta = lift(str(trace_bin), str(paths.workload),
                            max_uops=n or None, nt=nt, insts=insts)
            if info["capture_truncated"] and (n == 0 or tr.n < n):
                raise RuntimeError(
                    f"the capture was cut at {max_steps} macro-steps and "
                    f"lifts to {tr.n} µops, short of "
                    f"{n or 'the whole window'}: raise --max-steps")
            tfmt.save(cache_path(stem, n), tr, meta)
            key = f"lift_{n or 'full'}"
            info[key] = {
                "uops": tr.n,
                "lift_rate": round(meta["stats"]["lift_rate"], 4),
                "seconds": round(time.time() - t0, 1),
            }
            log(f"lift {n or 'full'}: {tr.n} µops, rate "
                f"{info[key]['lift_rate']} in {info[key]['seconds']}s")
    finally:
        trace_bin.unlink(missing_ok=True)
    return info


def default_batch(n: int, on_card: bool, chunked: bool) -> int:
    """The reference's default batch for a window of ``n`` µops, on its
    accelerator branch on the card and its CPU branch on the CPU."""
    if chunked:
        return max(512, min(16384 if on_card else 2048,
                            (1 << 26) // max(n // 64, 1)))
    return max(256, min(131072 if on_card else 8192, (1 << 29) // max(n, 1)))


def _timed(sync, fn):
    """``fn()``'s result and its seconds, between two device syncs."""
    sync()
    t0 = time.time()
    got = fn()
    sync()
    return got, time.time() - t0


def rate(lengths=LENGTHS, batch=None, reps: int = 3,
         workload="workloads/lzss.c", chunked=False,
         chunk: int = 65536, trials: int = 0, horizon: int = 0,
         device=None, setup: dict | None = None) -> dict:
    """Trials/s of each cached window on ``device`` (the card when None),
    dense or chunked, regfile: one warm call, then the median of ``reps``
    timed calls.  ``setup`` takes each window's load + kernel-build
    seconds."""
    import torch

    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.tools.northstar import device_of, platform_name
    from shrewd_tpu_torch.trace import format as tfmt
    from shrewd_tpu_torch.utils import prng

    dev = device if device is not None else device_of(None)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    stem = Path(workload).stem
    out = {"platform": platform_name(dev),
           "mode": "chunked" if chunked else "dense", "rates": {}}
    if chunked:
        out["chunk"] = chunk
    for n in lengths:
        p = cache_path(stem, n)
        if not p.exists():
            log(f"skip {n}: {p} missing (run --build)")
            continue
        t0 = time.time()
        tr, meta = tfmt.load(p)
        k = TrialKernel(tr, O3Config(), device=dev)
        sync()
        if setup is not None:
            setup.setdefault("kernel_seconds", {})[str(tr.n)] = round(
                time.time() - t0, 1)
        row = {"lift_rate": round(meta["stats"]["lift_rate"], 4)
               if "stats" in meta else None}
        if chunked:
            from shrewd_tpu_torch.ops.chunked import ChunkedCampaign

            b = trials or default_batch(tr.n, on_card, True)
            t0 = time.time()
            ch = ChunkedCampaign(k, chunk=chunk,
                                 carry_horizon=horizon or None)
            if horizon:
                row["carry_horizon"] = horizon
            row["setup_seconds"] = round(time.time() - t0, 1)
            run = ch.run_keys
        else:
            b = batch or default_batch(tr.n, on_card, False)
            run = k.run_keys
        keys = prng.trial_keys(prng.campaign_key(0, dev), b)
        # warm at the same lane-width bucket the timed reps use
        _, s = _timed(sync, lambda: run(keys, "regfile"))
        row["compile_seconds"] = round(s, 1)
        rates = []
        tally = None
        for _ in range(reps):
            tally, s = _timed(sync, lambda: run(keys, "regfile"))
            rates.append(b / s)
        rates.sort()
        row.update(trials_per_sec=round(rates[len(rates) // 2], 2), batch=b,
                   tally=[int(x) for x in tally])
        if chunked:
            row.update(chunks=ch.C, lanes_per_call=ch.lane_width(b),
                       resolution=dict(ch.last_stats))
        out["rates"][str(tr.n)] = row
        log(f"window {tr.n}: {row['trials_per_sec']:,} trials/s "
            f"({out['mode']})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.bigwindow")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--chunked", action="store_true")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--horizon", type=int, default=0,
                    help="chunked mode: carry_horizon (0 = exact)")
    ap.add_argument("--lengths", type=int, nargs="*", default=list(LENGTHS),
                    help="window lengths in µops; 0 = the full capture")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--trials", type=int, default=0,
                    help="chunked mode: trial count per measurement")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=4_000_000)
    ap.add_argument("--workload", default="workloads/lzss.c")
    ap.add_argument("--out", default="bigwindow_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.tools.northstar import (card_identity, device_of,
                                                  platform_name)

    dev = device_of(a.platform)
    setup: dict = {}
    result = {}
    if a.build:
        result["build"] = build(a.lengths, a.workload, a.max_steps, setup)
    if a.rate:
        result["rate"] = rate(a.lengths, a.batch, a.reps, a.workload,
                              chunked=a.chunked, chunk=a.chunk,
                              trials=a.trials, horizon=a.horizon,
                              device=dev, setup=setup)
    result.update(workload=a.workload, platform=platform_name(dev),
                  card=card_identity(dev), setup=setup)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
