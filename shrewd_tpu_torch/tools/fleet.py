"""Multi-tenant fleet driver — the CLI over ``shrewd_tpu_torch/service/``
(port of the JAX package's ``tools/fleet.py``, with its flags), run as
``python -m shrewd_tpu_torch.tools.fleet``.  Tenants run on the card
unless ``--platform cpu`` asks for the CPU; ``--certify`` with a value
exits rc 2 (the port has no static certification yet).

Three modes:

- **serve** — run the resident scheduler over a submission spool; tenants
  can be submitted while the fleet runs, and SIGTERM drains every tenant
  to a namespaced resumable checkpoint (rc 4)::

      python -m shrewd_tpu_torch.tools.fleet --serve --queue /spool \\
          --outdir fleet_out

- **submit** — spool one tenant (a plan JSON + scheduling identity) from
  any process; returns the ticket name::

      python -m shrewd_tpu_torch.tools.fleet --submit plan.json \\
          --queue /spool \\
          --name exp42 --priority 1 --weight 2 --quota-batches 100

- **direct** — admit plan files straight into a fleet and run it to
  completion (the embarrassingly-simple mode benchmarks and the
  northstar fleet sweep use)::

      python -m shrewd_tpu_torch.tools.fleet --plans a.json b.json \\
          --outdir fleet_out

``--resume fleet_out`` rebuilds a CLEANLY drained fleet from its
checkpoint; ``--recover fleet_out`` replays checkpoint + write-ahead
journal after a HARD kill (SIGKILL/OOM — ``service/journal.py``) and
continues every resumable tenant bit-identically.  ``--resume``
auto-detects a dirty shutdown and routes to recovery; ``--serve`` over
a dirty outdir refuses (run ``--recover`` first).  Every server mode
takes an O_EXCL+pid lock on the spool (or fleet) directory so two
servers cannot double-claim one fleet; a lock whose pid is dead is
reaped automatically.  ``--chaos-plan`` arms the service-level chaos
kinds (``kill_fleet`` / ``torn_journal`` / ``corrupt_submission``) for
reproducible survivability drills.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cmd_submit(a) -> int:
    from shrewd_tpu_torch.service import SubmissionQueue, TenantSpec

    if not a.queue:
        _log("--submit needs --queue")
        return 2
    with open(a.submit) as f:
        plan = json.load(f)
    name = a.name or os.path.splitext(os.path.basename(a.submit))[0]
    ticket = SubmissionQueue(a.queue).submit(TenantSpec(
        name=name, plan=plan, priority=a.priority, weight=a.weight,
        quota_batches=a.quota_batches))
    print(json.dumps({"ticket": ticket, "tenant": name}))
    return 0


def _report(sched) -> None:
    for name, t in sched.tenants.items():
        _log(f"  {name}: {t.status} (rc={t.rc}, {t.trials} trials, "
             f"{t.ticks} ticks, {t.wall_s:.1f}s"
             + (f", {t.kills} kills survived" if t.kills else "")
             + (f", {t.failures} failures" if t.failures else "") + ")")
    _log(f"fleet: {sched.ticks} ticks, fairness "
         f"{sched.fairness_index():.3f}, statuses {sched._by_status()}"
         + (f", {sched.recoveries} recoveries" if sched.recoveries
            else ""))


def _mesh(a):
    """``--platform``: every card when absent (``gpu``/``cuda`` name
    it), one CPU device for ``cpu``."""
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    if a.platform in (None, "", "gpu", "cuda"):
        return None
    if a.platform == "cpu":
        return make_mesh(["cpu"])
    raise SystemExit(f"unknown --platform {a.platform!r} (cpu | gpu)")


def cmd_serve(a) -> int:
    from shrewd_tpu_torch.service import (CampaignScheduler, LockHeld,
                                          ServerLock, SubmissionQueue,
                                          TenantSpec, is_dirty)

    if a.trace:
        from shrewd_tpu_torch.obs import trace as obs_trace

        obs_trace.enable(ring=a.trace_ring or obs_trace.DEFAULT_RING)
    queue = SubmissionQueue(a.queue) if a.queue else None
    chaos = None
    if a.chaos_plan:
        from shrewd_tpu_torch.chaos import ChaosEngine

        chaos = ChaosEngine.from_path(a.chaos_plan, worker="fleet")
    # single-server guard: one O_EXCL+pid lock per spool (or, spool-less,
    # per fleet dir) — two servers racing one fleet would silently split
    # its tenants across two schedulers and two journals
    lock = ServerLock(a.queue or a.recover or a.resume or a.outdir)
    try:
        lock.acquire()
    except LockHeld as e:
        _log(f"another server owns this fleet: {e}")
        return 2
    try:
        common = dict(queue=queue, mesh=_mesh(a),
                      idle_exit=not a.stay_resident, chaos=chaos)
        # only explicit CLI values override the snapshot's persisted
        # knobs on --resume/--recover (argparse default is None)
        if a.retry_budget is not None:
            common["retry_budget"] = a.retry_budget
        if a.tick_timeout is not None:
            common["tick_timeout"] = a.tick_timeout
        if a.recover:
            sched = CampaignScheduler.recover(a.recover, **common)
            _log(f"recovered fleet: {sched.recoveries} recoveries, "
                 f"{sched.journal_torn} torn journal records dropped")
        elif a.resume:
            if is_dirty(a.resume):
                _log("dirty shutdown detected (journal ahead of "
                     "snapshot) — recovering")
                sched = CampaignScheduler.recover(a.resume, **common)
            else:
                sched = CampaignScheduler.resume(a.resume, **common)
        else:
            if is_dirty(a.outdir):
                _log(f"{a.outdir}: dirty shutdown detected — refusing "
                     "to serve over un-recovered state; run --recover "
                     "first")
                return 2
            sched = CampaignScheduler(
                outdir=a.outdir, depth_budget=a.depth_budget,
                policy=a.policy, **common)
        for i, path in enumerate(a.plans):
            with open(path) as f:
                plan = json.load(f)
            name = f"t{i}_{os.path.splitext(os.path.basename(path))[0]}"
            sched.admit(TenantSpec(name=name, plan=plan))
        if a.matrix:
            # open-loop scenario matrix: admit the expanded cell set as
            # plain tenants (full cross-product, no Pareto prune — the
            # closed loop lives in tools.scenario --serve).  The
            # matrix document is persisted so tools.scenario
            # --status/--pareto work over this fleet's outdir too.
            from shrewd_tpu_torch.resilience import write_json_atomic
            from shrewd_tpu_torch.scenario import MATRIX_DOC, ScenarioMatrix

            with open(a.matrix) as f:
                matrix = ScenarioMatrix.from_dict(json.load(f))
            if sched.outdir:
                os.makedirs(sched.outdir, exist_ok=True)
                write_json_atomic(os.path.join(sched.outdir, MATRIX_DOC),
                                  matrix.to_dict())
            n = 0
            for spec in matrix.tenant_specs():
                if spec.name not in sched.tenants:
                    sched.admit(spec)
                    n += 1
            _log(f"matrix {matrix.tag!r}: admitted {n} cells "
                 "(open loop — no Pareto prune; use "
                 "shrewd_tpu_torch.tools.scenario --serve for the closed "
                 "loop)")
        restore = sched.install_signal_handlers()
        try:
            rc = sched.run()
        finally:
            restore()
        _report(sched)
        if sched.outdir:
            _log(f"live metrics: {sched.outdir}/metrics.json (+ .prom)")
        return rc
    finally:
        lock.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-tenant campaign fleet (shrewd_tpu_torch/service/)")
    ap.add_argument("--serve", action="store_true",
                    help="run the resident scheduler")
    ap.add_argument("--submit", metavar="PLAN_JSON", default="",
                    help="spool one tenant into --queue and exit")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="plan JSONs admitted directly (no spool needed)")
    ap.add_argument("--matrix", default="",
                    help="ScenarioMatrix JSON: admit the expanded "
                         "cross-product cell set as plain tenants "
                         "(open loop; closed-loop pruning lives in "
                         "shrewd_tpu_torch.tools.scenario --serve)")
    ap.add_argument("--queue", default="",
                    help="submission spool directory (service/queue.py)")
    ap.add_argument("--outdir", default="fleet_out",
                    help="fleet artifact root (per-tenant namespaces under "
                         "tenants/, fleet checkpoint under fleet_ckpt/)")
    ap.add_argument("--resume", default="",
                    help="resume a drained fleet from this outdir "
                         "(auto-recovers on a detected dirty shutdown)")
    ap.add_argument("--recover", default="",
                    help="replay checkpoint + write-ahead journal after "
                         "a hard kill and continue the fleet")
    ap.add_argument("--chaos-plan", default="",
                    help="fleet-level chaos plan JSON (kill_fleet / "
                         "torn_journal / corrupt_submission) for "
                         "reproducible survivability drills")
    ap.add_argument("--retry-budget", type=int, default=None,
                    help="tick-exception retries per tenant before "
                         "durable quarantine (backoff is tick-counted "
                         "exponential; default 3, resume/recover keep "
                         "the snapshot's value unless overridden)")
    ap.add_argument("--tick-timeout", type=float, default=None,
                    help="per-tenant tick watchdog deadline seconds "
                         "(0 = off, the default): a livelocked tenant "
                         "is preempted and quarantined instead of "
                         "wedging the fleet")
    ap.add_argument("--depth-budget", type=int, default=4,
                    help="global dispatch-depth budget shared by running "
                         "tenants")
    ap.add_argument("--policy", default="fair",
                    choices=("fair", "priority"),
                    help="fair = strict priority classes + weighted "
                         "fair-share stride within a class; priority = "
                         "strict priority, FIFO within a class")
    ap.add_argument("--certify", default="",
                    choices=("", "off", "warn", "strict"),
                    help="admission-time certification floor (not in "
                         "the port yet: any value exits rc 2)")
    ap.add_argument("--trace", action="store_true",
                    help="install the process-wide tracer "
                         "(shrewd_tpu_torch/obs/): per-tenant event lanes, "
                         "Perfetto trace.json, flight-recorder dump on "
                         "quarantine/hard-kill")
    ap.add_argument("--trace-ring", type=int, default=0,
                    help="flight-recorder ring capacity in events "
                         "(default 8192)")
    ap.add_argument("--stay-resident", action="store_true",
                    help="keep serving an empty queue (SIGTERM drains); "
                         "default exits when all tenants are terminal "
                         "and the spool is empty")
    ap.add_argument("--name", default="", help="[submit] tenant name")
    ap.add_argument("--priority", type=int, default=0,
                    help="[submit] strict-priority class (higher first)")
    ap.add_argument("--weight", type=float, default=1.0,
                    help="[submit] fair-share weight within the class")
    ap.add_argument("--quota-batches", type=int, default=0,
                    help="[submit] scheduler-level batch quota "
                         "(0 = none; at quota the tenant drains to a "
                         "resumable checkpoint)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the tenants on the CPU; the default "
                         "(or gpu) is every visible card")
    a = ap.parse_args(argv)

    if a.certify:
        _log(f"--certify {a.certify}: static certification is not in the "
             "port yet (it comes with the analysis layer)")
        return 2
    if a.submit:
        return cmd_submit(a)
    if a.serve or a.plans or a.matrix or a.resume or a.recover:
        return cmd_serve(a)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
