"""The framework CLI — the ``m5.main`` analog (the port of
``shrewd_tpu/main.py``).

``python -m shrewd_tpu_torch <subcommand>`` runs a campaign over every
visible CUDA card, with the reference's flags.  A campaign is reproducible
from its config dump alone:

    python -m shrewd_tpu_torch run plan.json --outdir out --debug-flags Campaign
    python -m shrewd_tpu_torch resume out/campaign_ckpt --outdir out2
    python -m shrewd_tpu_torch run plan.json --elastic-dir coord --worker w0
    python -m shrewd_tpu_torch hostdiff --workload workloads/sort.c --trials 32

(the third, started once per worker process with the same plan and
directory, shares the campaign over a lease board; ``--chaos-plan`` adds a
deterministic failure schedule; ``hostdiff`` builds the workload and the
ptrace tools, flips the same register bits on the host CPU and in the
replay, and prints the agreement as one JSON line).

    python -m shrewd_tpu_torch trace -n 64 --all
    python -m shrewd_tpu_torch trace --pipeline -n 32
    python -m shrewd_tpu_torch trace --workload workloads/sort.c -n 16

(an Exec-style trace of a window's golden record, recorded on the card,
or its scoreboard pipeline timelines).  ``--platform cpu`` runs on the
CPU instead.  Run artifacts land in ``--outdir`` as ``config.json`` /
``stats.txt`` / ``stats.json`` (``python/m5/main.py:227-248`` m5out
analog).  ``bench`` needs a benchmark of the port's own, which does not
exist yet, and exits with rc 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _apply_common(args) -> None:
    from shrewd_tpu_torch.utils import debug

    if args.debug_flags:
        debug.enable(*args.debug_flags.split(","))


def _device(args):
    """``--platform``: the card when absent (``gpu``/``cuda`` name it),
    ``cpu`` for the CPU."""
    platform = getattr(args, "platform", None)
    if platform in (None, "", "gpu", "cuda"):
        return None
    if platform == "cpu":
        return "cpu"
    raise SystemExit(f"unknown --platform {platform!r} (cpu | gpu)")


def _apply_obs(args) -> None:
    """--trace installs the process-wide tracer BEFORE the orchestrator
    is built (elaboration events are part of the run's story); without
    it the tracer stays the zero-overhead no-op constant."""
    if getattr(args, "trace", None):
        from shrewd_tpu_torch.obs import trace as obs_trace

        obs_trace.enable(ring=getattr(args, "trace_ring", None)
                         or obs_trace.DEFAULT_RING)


def _apply_resilience_overrides(orch, args) -> None:
    """CLI flags override the plan's resilience posture (and land in the
    config/checkpoint dumps, so the overridden run stays reproducible)."""
    cfg = orch.rcfg
    if getattr(args, "escalation_threshold", None) is not None:
        cfg.escalation_threshold = args.escalation_threshold
    if getattr(args, "escalation_action", None):
        cfg.escalation_action = args.escalation_action
    if getattr(args, "dispatch_timeout", None) is not None:
        cfg.dispatch_timeout = args.dispatch_timeout
        orch.watchdog.timeout = float(args.dispatch_timeout)
    if getattr(args, "max_retries", None) is not None:
        cfg.max_retries = args.max_retries
    icfg = orch.icfg
    if getattr(args, "audit_rate", None) is not None:
        icfg.audit_rate = args.audit_rate
    if getattr(args, "audit_threshold", None) is not None:
        icfg.audit_threshold = args.audit_threshold
    if getattr(args, "audit_action", None):
        icfg.audit_action = args.audit_action
    if getattr(args, "canary_trials", None) is not None:
        icfg.canary_trials = args.canary_trials
    if getattr(args, "certify", None):
        from shrewd_tpu_torch import analysis as analysis_mod
        from shrewd_tpu_torch.parallel import exec_cache

        orch.plan.analysis.certify = args.certify   # reproducible dump
        if args.certify == "off":
            # an EXPLICIT off must disarm a plan-installed auditor, or
            # the dumped config ('off') and the run's behavior (strict)
            # would disagree — the reproducibility contract
            exec_cache.clear_auditor()
            orch.auditor = None
        else:
            orch.auditor = analysis_mod.install_step_auditor(
                args.certify, orch.plan.analysis.transfer_budget)
    pcfg = orch.pcfg
    if getattr(args, "sync_every", None) is not None:
        pcfg.sync_every = args.sync_every
    if getattr(args, "pipeline_depth", None) is not None:
        pcfg.depth = args.pipeline_depth
    if getattr(args, "until_ci", None):
        pcfg.until_ci = True
    if getattr(args, "max_super_interval", None) is not None:
        pcfg.max_super_interval = args.max_super_interval
    if getattr(args, "compilation_cache_dir", None):
        raise NotImplementedError(
            "--compilation-cache-dir configures jax's persistent "
            "compilation cache, which the port has no counterpart of")


def _apply_chaos_elastic(orch, args) -> None:
    """--chaos-plan attaches the deterministic failure schedule;
    --elastic-dir joins (or starts) an elastic multi-host campaign over a
    shared coordination directory.  ``--worker`` names this process in
    both (default ``w<pid>``)."""
    worker = getattr(args, "worker", "") or f"w{os.getpid()}"
    if getattr(args, "chaos_plan", None):
        from shrewd_tpu_torch.chaos import ChaosEngine

        orch.plan.chaos.plan_path = args.chaos_plan   # reproducible dump
        orch.attach_chaos(ChaosEngine.from_path(args.chaos_plan,
                                                worker=worker))
    if getattr(args, "elastic_dir", None):
        from shrewd_tpu_torch.parallel.elastic import ElasticContext

        orch.attach_elastic(ElasticContext(args.elastic_dir, worker,
                                           orch.plan.elastic))


def _drive(orch, args) -> int:
    """Drive the orchestrator's event loop to completion (the stdlib
    Simulator.run analog: typed exit events → handlers,
    ``python/gem5/simulate/simulator.py:530``)."""
    _apply_resilience_overrides(orch, args)
    restore_signals = None
    try:
        _apply_chaos_elastic(orch, args)
        # graceful preemption: SIGTERM/SIGINT finish the in-flight batch,
        # write a resumable checkpoint, and exit rc 4 (distinct from the
        # budget-abort rc 3 so schedulers can tell drain from distrust)
        restore_signals = orch.install_signal_handlers()
        t0 = time.monotonic()
        n_batches = _drive_events(orch, orch.plan.checkpoint_every)
    finally:
        # the second-signal KeyboardInterrupt escape hatch (and any
        # ladder/elastic error) must still restore handlers and leave the
        # elastic membership gracefully — a stale heartbeat file would
        # make peers burn a full timeout declaring us lost and pollute
        # the shared coordination dir for later campaigns
        if restore_signals is not None:
            restore_signals()
        if orch._elastic is not None:
            orch._elastic.stop()      # graceful leave: peers see it
    orch.write_outputs()
    return _drive_outputs(orch, args, t0, n_batches)


def _drive_events(orch, ckpt_every: int) -> int:
    """Consume the orchestrator's event stream, logging each typed event;
    returns the number of completed batches."""
    from shrewd_tpu_torch.resilience import TIERS
    from shrewd_tpu_torch.sim.exit_event import ExitEvent

    n_batches = 0
    for event, payload in orch.events():
        if event == ExitEvent.BATCH_COMPLETE:
            n_batches += 1
            if ckpt_every and n_batches % ckpt_every == 0:
                orch.checkpoint()
        elif event in (ExitEvent.CI_CONVERGED, ExitEvent.MAX_TRIALS):
            r = payload
            hw = (r.avf_interval.hi - r.avf_interval.lo) / 2
            _log(f"  {r.simpoint}/{r.structure}: trials={r.trials} "
                 f"avf={r.avf:.4f} ±{hw:.4f}"
                 + ("" if r.converged else " (trial cap, unconverged)"))
        elif event == ExitEvent.BACKEND_DEGRADED:
            d = payload
            _log(f"  {d.simpoint}/{d.structure} batch {d.batch_id}: "
                 f"ran on {TIERS[d.tier]} tier "
                 f"({d.attempts} dispatch attempts)")
        elif event == ExitEvent.INTEGRITY_VIOLATION:
            from shrewd_tpu_torch.integrity import AuditBudgetInfo
            if isinstance(payload, AuditBudgetInfo):
                _log(f"AUDIT MISMATCH BUDGET EXCEEDED: {payload.rate:.1%} "
                     f"of audited trials disagreed (threshold "
                     f"{payload.threshold:.1%}, action={payload.action}) "
                     f"— reasons {payload.reasons}")
            else:
                _log(f"INTEGRITY: {payload}")
        elif event == ExitEvent.ESCALATION_EXCEEDED:
            e = payload
            _log(f"ESCALATION BUDGET EXCEEDED: {e.rate:.1%} of trials ran "
                 f"below the device tier (threshold {e.threshold:.1%}, "
                 f"action={e.action}) — tiers {e.tier_trials}")
        elif event == ExitEvent.WORKER_LOST:
            _log(f"WORKER LOST: {payload.worker} (lease {payload.batch_key}"
                 f" revoked; survivors: "
                 f"{', '.join(payload.survivors) or 'this worker'})")
        elif event == ExitEvent.PREEMPTED:
            _log(f"PREEMPTED: drained to checkpoint "
                 f"{payload or '(no outdir — progress lost)'}")
        elif event == ExitEvent.SIMPOINT_COMPLETE:
            _log(f"simpoint {payload}: done")
        elif event == ExitEvent.CAMPAIGN_COMPLETE:
            break
    return n_batches


def _drive_outputs(orch, args, t0, n_batches) -> int:
    from shrewd_tpu_torch.resilience import TIERS

    if orch.outdir:
        orch.checkpoint()
    esc = orch.budget
    if esc.escalated:
        _log(f"escalation: {esc.escalated}/{esc.total} trials "
             f"({esc.rate():.1%}) ran below the device tier "
             f"({', '.join(f'{t}={int(c)}' for t, c in zip(TIERS, esc.counts))})")
    mon = orch.monitor
    if mon.ledger.audited or mon.canary_trials or mon.quarantined:
        _log(f"integrity: {mon.canary_trials} canary trials "
             f"({mon.canary_failures} failed), {mon.ledger.audited} "
             f"audited ({mon.ledger.mismatched} mismatched), "
             f"{mon.quarantined} batches quarantined "
             f"({mon.recovered} recovered)")
    chaos = orch.chaos
    if chaos is not None and chaos.injected:
        _log(f"chaos: injected {dict(chaos.injected)}, "
             f"survived {dict(chaos.survived)}")
    el = orch._elastic
    if el is not None:
        _log(f"elastic ({el.worker}): {el.counters()}")
    if orch.preempted:
        _log(f"campaign PREEMPTED after {n_batches} batches in "
             f"{time.monotonic() - t0:.1f}s"
             + (f" → {orch.outdir} (resumable)" if orch.outdir else ""))
        return 4
    if orch.aborted:
        _log(f"campaign ABORTED by "
             f"{orch.abort_reason or 'escalation budget'} after "
             f"{n_batches} batches in {time.monotonic() - t0:.1f}s"
             + (f" → {orch.outdir} (resumable)" if orch.outdir else ""))
        return 3
    _log(f"campaign complete: {n_batches} batches in "
         f"{time.monotonic() - t0:.1f}s"
         + (f" → {orch.outdir}" if orch.outdir else ""))
    return 0


def cmd_run(args) -> int:
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan

    _apply_obs(args)
    with open(args.plan) as f:
        plan = CampaignPlan.from_dict(json.load(f))
    orch = Orchestrator(plan, outdir=args.outdir, device=_device(args))
    return _drive(orch, args)


def cmd_resume(args) -> int:
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

    _apply_obs(args)
    orch = Orchestrator.resume(args.ckpt_dir, outdir=args.outdir,
                               device=_device(args))
    return _drive(orch, args)


def cmd_hostdiff(args) -> int:
    from shrewd_tpu_torch.ingest import hostdiff as hd

    rep = hd.run_diff(args.trials, args.seed, args.workload, mode=args.mode,
                      device=_device(args))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps({k: rep[k] for k in
                      ("trials", "host_avf", "device_avf", "avf_abs_err",
                       "agreement_exact", "agreement_vulnerable",
                       "cis_overlap")}))
    return 0


def cmd_trace(args) -> int:
    """Dump an Exec-style instruction trace of a replay window
    (trace/exec_trace.py; the reference's --debug-flags Exec family,
    src/cpu/exetrace.cc).  The golden record is made on the card unless
    ``--platform cpu``."""
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.trace.exec_trace import exec_trace
    from shrewd_tpu_torch.utils import debug

    if args.all:
        debug.enable("ExecAll")
    elif not debug.enabled("Exec"):
        debug.enable("Exec")
    if args.results:
        debug.enable("ExecResult")
    if args.workload:
        from shrewd_tpu_torch.ingest import hostdiff as hd

        paths = hd.build_tools(workload_c=args.workload)
        tr, _meta = hd.capture_and_lift(paths)
    else:
        from shrewd_tpu_torch.trace.synth import WorkloadConfig, generate

        tr = generate(WorkloadConfig(n=args.window, nphys=64,
                                     mem_words=1024,
                                     working_set_words=256,
                                     seed=args.seed))
    if args.pipeline:
        from shrewd_tpu_torch.models.timing import compute_scoreboard
        from shrewd_tpu_torch.trace.pipeview import dump_pipeview

        sb = compute_scoreboard(tr)
        n = dump_pipeview(tr, sb, out=sys.stdout, start=args.start,
                          count=args.n)
        _log(f"rendered {n} µops")
        return 0
    # graftlint: allow-jit -- `trace` prints one window's golden record
    # and exits: no campaign shares this kernel
    kern = TrialKernel(tr, O3Config(pallas="off"), device=_device(args))
    n = exec_trace(tr, kern.golden_rec, out=sys.stdout, start=args.start,
                   count=args.n)
    _log(f"traced {n} µops")
    return 0


def cmd_bench(args) -> int:
    """``bench``: the port has no benchmark of its own yet."""
    _log("bench: the PyTorch port has no benchmark of its own yet "
         "(python -m shrewd_tpu bench runs the JAX package's)")
    return 2


def main(argv: list[str] | None = None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--debug-flags", default=os.environ.get(
        "SHREWD_DEBUG_FLAGS", ""), help="comma-separated debug flags "
        "(the reference's --debug-flags, python/m5/main.py)")
    common.add_argument("--platform", default=None,
                        help="device override: cpu (default: the CUDA "
                             "card)")
    ap = argparse.ArgumentParser(
        prog="python -m shrewd_tpu_torch",
        description="statistical fault-injection framework (PyTorch/CUDA "
                    "port)",
        parents=[common])
    sub = ap.add_subparsers(dest="cmd", required=True)

    resil = argparse.ArgumentParser(add_help=False)
    resil.add_argument("--escalation-threshold", type=float, default=None,
                       help="max fraction of trials allowed off the device "
                            "tier before the run is flagged "
                            "(plan.resilience.escalation_threshold)")
    resil.add_argument("--escalation-action", default=None,
                       choices=("off", "warn", "abort"),
                       help="what to do when the escalation budget is "
                            "exceeded (abort exits rc=3, resumable)")
    resil.add_argument("--dispatch-timeout", type=float, default=None,
                       help="watchdog seconds per device dispatch "
                            "(0 = no watchdog)")
    resil.add_argument("--max-retries", type=int, default=None,
                       help="re-dispatch attempts per tier before the "
                            "ladder degrades")
    resil.add_argument("--audit-rate", type=float, default=None,
                       help="fraction of each batch re-run on the "
                            "alternate kernel for the differential audit "
                            "(plan.integrity.audit_rate, default 0.01; "
                            "0 disables)")
    resil.add_argument("--audit-threshold", type=float, default=None,
                       help="max audited-trial mismatch rate before the "
                            "run is flagged (plan.integrity)")
    resil.add_argument("--audit-action", default=None,
                       choices=("off", "warn", "abort"),
                       help="what to do when the audit mismatch budget is "
                            "exceeded (abort exits rc=3, resumable)")
    resil.add_argument("--canary-trials", type=int, default=None,
                       help="seed-canary trials salted per batch "
                            "(0 disables canaries)")
    resil.add_argument("--chaos-plan", default=None,
                       help="chaos-plan JSON file: a deterministic "
                            "failure schedule injected at the watchdog/"
                            "ladder/integrity/checkpoint hook points "
                            "(shrewd_tpu_torch/chaos.py)")
    resil.add_argument("--elastic-dir", default=None,
                       help="shared coordination directory for an elastic "
                            "multi-process campaign (heartbeats + batch "
                            "leases; parallel/elastic.py).  Start N "
                            "processes with the same plan and dir; lost "
                            "workers' batches are re-dispatched by "
                            "survivors bit-identically")
    resil.add_argument("--worker", default=None,
                       help="worker name for elastic/chaos runs "
                            "(default: w<pid>)")
    resil.add_argument("--sync-every", type=int, default=None,
                       help="batches accumulated on device per host "
                            "transfer (plan.pipeline.sync_every; 1 = the "
                            "serial loop, >1 enables the pipelined "
                            "engine — bit-identical tallies either way)")
    resil.add_argument("--pipeline-depth", type=int, default=None,
                       help="max sync intervals in flight "
                            "(plan.pipeline.depth, default 2 = double "
                            "buffering)")
    resil.add_argument("--compilation-cache-dir", default=None,
                       help="the JAX package's persistent compilation "
                            "cache (no counterpart in the port: raises)")
    resil.add_argument("--until-ci", action="store_true", default=None,
                       help="device-resident run-until-CI: evaluate "
                            "the Wilson/post-stratified stopping rule on "
                            "the card after every batch — one tally "
                            "copy per super-interval, results "
                            "bit-identical to the serial loop including "
                            "the consumed trial count "
                            "(plan.pipeline.until_ci)")
    resil.add_argument("--max-super-interval", type=int, default=None,
                       help="max batches per device-resident until-CI "
                            "super-interval "
                            "(plan.pipeline.max_super_interval)")
    resil.add_argument("--trace", action="store_true", default=None,
                       help="install the process-wide tracer "
                            "(obs/): structured events at "
                            "every load-bearing seam, Perfetto "
                            "trace.json in --outdir, flight-recorder "
                            "dump on abnormal exits.  Off by default "
                            "(the disabled tracer is a no-op constant)")
    resil.add_argument("--trace-ring", type=int, default=None,
                       help="flight-recorder ring capacity in events "
                            "(default 8192; bounds memory and dump "
                            "size, never correctness — drops are "
                            "counted in campaign.obs.events_dropped)")
    resil.add_argument("--certify", default=None,
                       choices=("off", "warn", "strict"),
                       help="certify every campaign step kind on its "
                            "first dispatch (the step auditor of "
                            "shrewd_tpu_torch/analysis/): 'strict' "
                            "refuses a violating step before its result "
                            "is counted (plan.analysis.certify)")

    p = sub.add_parser("run", help="run a campaign plan to completion",
                       parents=[common, resil])
    p.add_argument("plan", help="CampaignPlan config.json")
    p.add_argument("--outdir", default="m5out",
                   help="artifact directory (config.json/stats.txt/json)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("resume", help="resume a checkpointed campaign",
                       parents=[common, resil])
    p.add_argument("ckpt_dir", help="campaign_ckpt directory")
    p.add_argument("--outdir", default="m5out")
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser("hostdiff", parents=[common],
                       help="host-silicon differential AVF campaign")
    p.add_argument("--trials", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workload", default="workloads/sort.c")
    p.add_argument("--mode", default="output",
                   choices=("output", "liveness", "abi", "emu64", "device64",
                            "fp"))
    p.add_argument("--out", default="")
    p.set_defaults(fn=cmd_hostdiff)

    p = sub.add_parser("trace", parents=[common],
                       help="Exec-style instruction trace of a window")
    p.add_argument("--workload", default="",
                   help="C workload to capture+lift (default: synth trace)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("-n", type=int, default=64, help="µops to print")
    p.add_argument("--window", type=int, default=256,
                   help="synthetic window length (independent of -n)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--all", action="store_true",
                   help="ExecAll (results + opclasses)")
    p.add_argument("--results", action="store_true", help="ExecResult")
    p.add_argument("--pipeline", action="store_true",
                   help="render scoreboard pipeline timelines "
                        "(the o3-pipeview analog) instead of exec lines")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("bench", parents=[common],
                       help="headline benchmark (none in the port yet: "
                            "rc 2)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    _apply_common(args)
    return args.fn(args)
