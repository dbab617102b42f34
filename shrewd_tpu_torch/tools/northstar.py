"""The north-star campaign, end to end — the port of the JAX package's
``tools/northstar.py``, with its names and flags, run as
``python -m shrewd_tpu_torch.tools.northstar``.  Campaigns run on the card
unless ``--platform cpu`` asks for the CPU; without a card the default
raises.

BASELINE.json's metric: *wall-clock to AVF ±1% CI* per (workload,
structure) — every workload × its SimPoint representatives × every O3
fault structure {regfile, rob, iq, lsq, fu, latch}, each window run
through ``parallel.campaign.run_until_ci`` (batched accumulation until the
95% Wilson interval half-width ≤ 0.01) on one device.

Per (workload, structure) the document reports: per-SimPoint AVF + CI +
trials + seconds, the SimPoint-weighted AVF (gem5's population-weighted
metric, ``src/cpu/simple/probes/simpoint.hh:82``), and the summed
wall-clock.  The grand total is the headline: wall-clock to ±1% CI across
all structures × all workloads × SimPoints on one device.

``--fleet`` re-runs the same sweep as ONE interleaved multi-tenant fleet
(``shrewd_tpu_torch/service/``): every (workload, SimPoint, structure)
campaign becomes a tenant on one shared mesh, batches interleaved through
the pipelined engine under a global dispatch-depth budget.  With
``--also-serial`` both arms run back to back at the same scale and the
measured speedup lands in ``--bench-out``.

Where the port departs from the reference (ROADMAP Queue 3 D7):

- **Output paths.**  The reference writes its documents into the
  repository's root by default; the port's default to files of its own in
  the current directory (``northstar_torch.json``,
  ``northstar_torch_fleet.json``, ``northstar_torch_speedup.json``).
  ``--serial-baseline`` has no default: ``--fleet`` without
  ``--also-serial`` and without a baseline exits 2 before any work.
- **Card identity.**  Beside ``platform`` (``"gpu"`` or ``"cpu"``) every
  document records ``card``, the card's name and power limit as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them (null on the CPU).
- **Set-up seconds.**  Every document also carries ``setup`` (the
  port's own): each workload's ingest seconds and its windows' lengths
  and weights, and in the serial arm each workload's kernel builds (its
  golden records are built there, before the first campaign); the
  ``--also-serial`` run writes the serial arm's document to ``--out`` as
  well.
- **The cache statistics.**  ``exec_cache`` is the port's kernel-registry
  ledger (``parallel/exec_cache.py``), under the reference's key: torch
  compiles no executable per step, so it counts ``TrialKernel``s built and
  shared (ROADMAP Queue 3 D5).  The cold start between the arms clears the
  registry, so the fleet arm builds its own kernels (golden records,
  scoreboards).

Usage: python -m shrewd_tpu_torch.tools.northstar [--k 3] [--interval 4000]
           [--out FILE] [--platform cpu]
       python -m shrewd_tpu_torch.tools.northstar --fleet --also-serial
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

WORKLOADS = ["workloads/sort.c", "workloads/intmm.c", "workloads/divmix.c",
             "workloads/bytehash.c", "workloads/memops.c",
             "workloads/ptrchase.c", "workloads/rotmix.c",
             "workloads/strmix.c"]
STRUCTURES = ["regfile", "rob", "iq", "lsq", "fu", "latch"]


def device_of(platform: str | None):
    """``--platform``: the card when absent (``gpu``/``cuda`` name it; it
    raises without one), the CPU for ``cpu``."""
    from shrewd_tpu_torch.utils.device import resolve

    if platform in (None, "", "gpu", "cuda"):
        return resolve(None)
    if platform == "cpu":
        return resolve("cpu")
    raise SystemExit(f"unknown --platform {platform!r} (cpu | gpu)")


def card_identity(device) -> str | None:
    """The card's name and power limit from ``nvidia-smi`` (null on the
    CPU): every number of a run stands beside them."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def platform_name(device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _build_windows(a, setup: dict | None = None) -> dict:
    """Ingest phase, shared by both arms: {workload: [(trace, meta)]}.
    ``setup`` (the port's own record) takes each workload's ingest
    seconds and its windows' lengths and weights."""
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.simpoint import simpoint_windows

    out = {}
    for wl in a.workloads:
        t0 = time.time()
        paths = hd.build_tools(wl)
        windows, _sps, _profile = simpoint_windows(
            paths, interval=a.interval, k=a.k, seed=a.seed)
        out[wl] = windows
        took = time.time() - t0
        if setup is not None:
            setup.setdefault("ingest_s", {})[wl] = round(took, 1)
            setup.setdefault("windows", {})[wl] = [
                {"interval": m["simpoint_interval"], "uops": t.n,
                 "macro_ops": m["macro_ops"],
                 "weight": round(m["simpoint_weight"], 4)}
                for t, m in windows]
        print(f"{wl}: {len(windows)} SimPoint windows ({took:.1f} s)",
              file=sys.stderr, flush=True)
    return out


def _run_serial(a, windows_by_wl: dict, setup: dict | None = None) -> dict:
    """The serial sweep: one ``run_until_ci`` campaign at a time (the
    reference's posture — campaigns queue behind each other).  The
    document's ``setup`` (the port's own) is ``setup`` plus each
    workload's kernel builds (golden record included) in seconds."""
    from shrewd_tpu_torch.models.minor import MinorConfig
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel.campaign import (ShardedCampaign,
                                                    run_until_ci)
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    dev = device_of(a.platform)
    mesh = make_mesh([dev])             # one device — the metric's unit
    grand_t0 = time.time()
    doc = {"metric": "wall-clock to AVF ±1% CI (95%), one chip",
           "platform": platform_name(dev),
           "card": card_identity(dev),
           "halfwidth_target": a.halfwidth,
           "simpoint_interval_macro_ops": a.interval,
           "k_per_workload": a.k,
           "max_trials": a.max_trials,
           "batch": a.batch,
           "workloads": {}}
    doc["setup"] = dict(setup or {}, kernel_build_s={})
    grand_trials = 0
    for wl, windows in windows_by_wl.items():
        t_wl = time.time()
        row = {"n_simpoints": len(windows), "structures": {}}
        kernels = [(TrialKernel(trace, O3Config(), MinorConfig(),
                                device=dev), meta)
                   for trace, meta in windows]
        for kernel, _meta in kernels:
            _ = kernel.golden_rec              # built here, timed as set-up
        doc["setup"]["kernel_build_s"][wl] = round(time.time() - t_wl, 1)
        for structure in a.structures:
            t_s = time.time()
            weighted = 0.0
            s_trials = 0
            sp_rows = []
            converged_all = True
            for kernel, meta in kernels:
                camp = ShardedCampaign(kernel, mesh, structure)
                res = run_until_ci(
                    camp, seed=a.seed,
                    simpoint_id=meta["simpoint_interval"],
                    structure_id=STRUCTURES.index(structure),
                    batch_size=a.batch, target_halfwidth=a.halfwidth,
                    max_trials=a.max_trials)
                weighted += meta["simpoint_weight"] * res.avf
                s_trials += res.trials
                converged_all &= res.converged
                sp_rows.append({
                    "interval": meta["simpoint_interval"],
                    "weight": round(meta["simpoint_weight"], 4),
                    "avf": round(res.avf, 4),
                    "ci95": [round(res.avf_interval.lo, 4),
                             round(res.avf_interval.hi, 4)],
                    "trials": res.trials,
                    "trials_per_sec": round(res.trials_per_second, 1),
                })
            row["structures"][structure] = {
                "weighted_avf": round(weighted, 4),
                "trials": s_trials,
                "wall_clock_s": round(time.time() - t_s, 1),
                "converged": converged_all,
                "simpoints": sp_rows,
            }
            grand_trials += s_trials
            print(f"{wl} {structure}: weighted AVF {weighted:.4f} "
                  f"({s_trials} trials, "
                  f"{row['structures'][structure]['wall_clock_s']}s)",
                  file=sys.stderr, flush=True)
        row["wall_clock_s"] = round(time.time() - t_wl, 1)
        doc["workloads"][wl] = row
    doc["total_wall_clock_s"] = round(time.time() - grand_t0, 1)
    doc["total_trials"] = grand_trials
    doc["campaigns"] = sum(len(r["structures"]) * r["n_simpoints"]
                           for r in doc["workloads"].values())
    return doc


def _fleet_tenants(a, windows_by_wl: dict, spool: str) -> list:
    """Every (workload, SimPoint, structure) campaign as a tenant:
    [(name, plan, weight, workload, structure)], each window spilled to
    ``spool`` as .npz once so every tenant's plan round-trips (the service
    contract: a tenant is reproducible from its spec document)."""
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
    from shrewd_tpu_torch.trace import format as tf

    tenants = []
    for wl, windows in windows_by_wl.items():
        base = os.path.splitext(os.path.basename(wl))[0]
        for trace, meta in windows:
            npz = os.path.join(
                spool, f"{base}_sp{meta['simpoint_interval']}.npz")
            if not os.path.exists(npz):
                tf.save(npz, trace, meta)
            for structure in a.structures:
                sp_name = f"{base}.sp{meta['simpoint_interval']}"
                # the fleet's batch may be SMALLER than the serial arm's:
                # the interval machinery decouples stopping granularity
                # (one batch) from device-call granularity (sync_every
                # batches accumulated in one step), so the fleet checks
                # convergence at fleet_batch granularity.  min_trials
                # floors at one full interval so the first convergence
                # check matches the serial arm's (its first check is at
                # one serial batch = one fleet interval).
                fb = a.fleet_batch or a.batch
                plan = CampaignPlan(
                    simpoints=[TraceFileSpec(name=sp_name, path=npz)],
                    structures=[structure], batch_size=fb,
                    target_halfwidth=a.halfwidth,
                    max_trials=a.max_trials, seed=a.seed,
                    min_trials=max(1000, fb * a.sync_every))
                # parity with the serial arm's BARE run_until_ci loop: no
                # canaries/audit/invariants and no watchdog in either arm
                # — interleaving + interval accumulation is the variable
                # under measurement, nothing else
                plan.integrity.canary_trials = 0
                plan.integrity.audit_rate = 0.0
                plan.integrity.invariants = False
                plan.resilience.backoff_base = 0.0
                plan.resilience.dispatch_timeout = 0.0
                plan.pipeline.sync_every = a.sync_every
                tenants.append((f"{base}.sp{meta['simpoint_interval']}"
                                f".{structure}", plan,
                                meta["simpoint_weight"], wl, structure))
    return tenants


def _run_fleet(a, windows_by_wl: dict, spool: str | None = None) -> dict:
    """The same sweep as ONE interleaved fleet: each (workload, SimPoint,
    structure) campaign is a tenant; one mesh, one resident scheduler,
    batches interleaved through the pipelined engine.  The windows' .npz
    files go to ``spool`` when given (kept), else to a temporary directory
    removed after the run."""
    if spool is None:
        with tempfile.TemporaryDirectory(prefix="northstar_fleet_") as d:
            return _run_fleet(a, windows_by_wl, d)
    from shrewd_tpu_torch.parallel import exec_cache
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    from shrewd_tpu_torch.service import CampaignScheduler, TenantSpec

    dev = device_of(a.platform)
    mesh = make_mesh([dev])             # the same one-device unit
    tenants = _fleet_tenants(a, windows_by_wl, spool)
    sched = CampaignScheduler(outdir=None, mesh=mesh,
                              depth_budget=a.depth_budget)
    for name, plan, _w, _wl, _s in tenants:
        sched.admit(TenantSpec(name=name, plan=plan.to_dict()))
    t0 = time.time()
    rc = sched.run()
    fleet_s = time.time() - t0
    doc = {"metric": "wall-clock to AVF ±1% CI (95%), one chip, "
                     "interleaved multi-tenant fleet",
           "platform": platform_name(dev),
           "card": card_identity(dev),
           "halfwidth_target": a.halfwidth,
           "simpoint_interval_macro_ops": a.interval,
           "k_per_workload": a.k,
           "max_trials": a.max_trials,
           "batch": a.fleet_batch or a.batch,
           "serial_arm_batch": a.batch,
           "sync_every": a.sync_every,
           "depth_budget": a.depth_budget,
           "policy": "fair",
           "rc": rc,
           "tenants": len(tenants),
           "fleet_ticks": sched.ticks,
           "fairness_index": round(sched.fairness_index(), 4),
           "workloads": {}}
    grand_trials = 0
    for name, _plan, weight, wl, structure in tenants:
        t = sched.tenants[name]
        row = doc["workloads"].setdefault(
            wl, {"structures": {}})["structures"].setdefault(
            structure, {"weighted_avf": 0.0, "trials": 0,
                        "converged": True, "tenants": []})
        summary = list((t.results or {}).values())
        avf = summary[0]["avf"] if summary else 0.0
        conv = summary[0]["converged"] if summary else False
        row["weighted_avf"] = round(row["weighted_avf"]
                                    + weight * (avf or 0.0), 4)
        row["trials"] += t.trials
        row["converged"] = bool(row["converged"] and conv)
        row["tenants"].append({
            "tenant": name, "avf": round(avf or 0.0, 4),
            "trials": t.trials, "ticks": t.ticks,
            "status": t.status})
        grand_trials += t.trials
    doc["total_wall_clock_s"] = round(fleet_s, 1)
    doc["total_trials"] = grand_trials
    doc["campaigns"] = len(tenants)
    doc["exec_cache"] = exec_cache.cache().stats()
    return doc


def _write(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.northstar")
    ap.add_argument("--workloads", nargs="*", default=WORKLOADS)
    ap.add_argument("--structures", nargs="*", default=STRUCTURES)
    ap.add_argument("--k", type=int, default=3, help="SimPoints/workload")
    ap.add_argument("--interval", type=int, default=4000)
    ap.add_argument("--halfwidth", type=float, default=0.01)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-trials", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="northstar_torch.json")
    ap.add_argument("--fleet", action="store_true",
                    help="run the sweep as ONE interleaved multi-tenant "
                         "fleet (shrewd_tpu_torch/service/) instead of the "
                         "serial campaign-after-campaign loop")
    ap.add_argument("--also-serial", action="store_true",
                    help="[fleet] run the serial sweep too (same scale, "
                         "same process) and record the measured speedup")
    ap.add_argument("--sync-every", type=int, default=4,
                    help="[fleet] batches per device sync interval")
    ap.add_argument("--fleet-batch", type=int, default=0,
                    help="[fleet] per-tenant batch size (default: --batch)."
                         "  A smaller fleet batch with sync-every "
                         "accumulation keeps the serial arm's per-device-"
                         "call trial count while stopping at finer "
                         "granularity — less over-sampling per campaign")
    ap.add_argument("--depth-budget", type=int, default=4,
                    help="[fleet] global dispatch-depth budget")
    ap.add_argument("--fleet-out", default="northstar_torch_fleet.json")
    ap.add_argument("--bench-out", default="northstar_torch_speedup.json")
    ap.add_argument("--serial-baseline", default=None,
                    help="[fleet] serial document (this tool's --out) to "
                         "compare against when --also-serial is not given "
                         "(scales must match for the comparison to mean "
                         "anything)")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)
    if a.fleet and not a.also_serial and not a.serial_baseline:
        print("northstar: --fleet needs --also-serial or --serial-baseline",
              file=sys.stderr)
        return 2
    device_of(a.platform)

    setup: dict = {}
    windows_by_wl = _build_windows(a, setup)

    if not a.fleet:
        doc = _run_serial(a, windows_by_wl, setup)
        _write(a.out, doc)
        print(json.dumps({"total_wall_clock_s": doc["total_wall_clock_s"],
                          "total_trials": doc["total_trials"],
                          "campaigns": doc["campaigns"],
                          "platform": doc["platform"],
                          "card": doc["card"]}))
        return 0

    serial_doc = None
    if a.also_serial:
        serial_doc = _run_serial(a, windows_by_wl, setup)
        _write(a.out, serial_doc)
        # cold-start parity: both arms pay their own kernel builds — the
        # process-wide kernel registry would otherwise hand the second arm
        # the first arm's golden records and scoreboards
        from shrewd_tpu_torch.parallel import exec_cache

        exec_cache.cache().clear()
        exec_cache.clear_kernels()
    fleet_doc = _run_fleet(a, windows_by_wl)
    fleet_doc["setup"] = setup
    if serial_doc is not None:
        serial_s = serial_doc["total_wall_clock_s"]
        serial_src = "measured (--also-serial, same scale/process)"
        serial_trials = serial_doc["total_trials"]
    else:
        with open(a.serial_baseline) as f:
            base = json.load(f)
        serial_s = base["total_wall_clock_s"]
        serial_src = a.serial_baseline
        serial_trials = base.get("total_trials")
    fleet_doc["serial_wall_clock_s"] = serial_s
    fleet_doc["serial_source"] = serial_src
    fleet_doc["speedup_vs_serial"] = round(
        serial_s / max(fleet_doc["total_wall_clock_s"], 1e-9), 3)
    _write(a.fleet_out, fleet_doc)
    bench = {
        "benchmark": "NORTHSTAR sweep: interleaved multi-tenant fleet "
                     "vs serial campaign-after-campaign",
        "platform": fleet_doc["platform"],
        "card": fleet_doc["card"],
        "campaigns": fleet_doc["campaigns"],
        "config": {"workloads": a.workloads, "structures": a.structures,
                   "k": a.k, "interval": a.interval,
                   "halfwidth": a.halfwidth, "batch": a.batch,
                   "fleet_batch": a.fleet_batch or a.batch,
                   "max_trials": a.max_trials,
                   "sync_every": a.sync_every,
                   "depth_budget": a.depth_budget},
        "serial_wall_clock_s": serial_s,
        "serial_source": serial_src,
        "serial_trials": serial_trials,
        "fleet_wall_clock_s": fleet_doc["total_wall_clock_s"],
        "fleet_trials": fleet_doc["total_trials"],
        "speedup": fleet_doc["speedup_vs_serial"],
        "fairness_index": fleet_doc["fairness_index"],
        "exec_cache": fleet_doc["exec_cache"],
    }
    _write(a.bench_out, bench)
    print(json.dumps({"serial_s": serial_s,
                      "fleet_s": fleet_doc["total_wall_clock_s"],
                      "speedup": fleet_doc["speedup_vs_serial"],
                      "campaigns": fleet_doc["campaigns"],
                      "card": fleet_doc["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
