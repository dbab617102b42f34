"""Multi-process campaign launcher (the port's copy of the reference's
``tools/dist_launch.py``), on localhost:

    python -m shrewd_tpu_torch.parallel.launch --num-processes 2 \\
        --local-devices 2 --platform cpu

**Collective mode** (the default): N worker processes join one
``torch.distributed`` group (gloo for the CPU, NCCL for the card), each
builds a mesh over its local devices that spans the group
(``parallel/mesh.py``), and each runs the SAME sharded campaign batch over
the global mesh (the budgeted device route with the shard-vs-sum check and
an escape budget of one lane per shard, so the budget applies per shard
and the shards' tallies are gathered) and prints the reduced tally.  The
supervisor checks that every worker agrees and that the tally equals a
single-process run of the same batch on a mesh of the same global size,
bit for bit (placement must not change outcomes).  On the card each
worker takes its own cards, so N × L cards are needed.

**Elastic mode** exercises the failure story the collective mode cannot
have: N *independent* orchestrator processes share one campaign through
the lease board (``parallel/elastic.py`` — per-process meshes, no
cross-process collective to wedge), and ``--kill-worker N --at-batch B``
hard-kills worker N at its B-th dispatched batch through the chaos
harness (``chaos.py``, rc 137).  The supervisor checks that the
survivors revoke the dead worker's lease, finish the campaign, and agree
with each other and, unless ``--no-reference``, with an undisturbed
single-process run of the same plan, bit for bit:

    python -m shrewd_tpu_torch.parallel.launch --mode elastic \\
        --num-processes 2 --kill-worker 1 --at-batch 2 --platform cpu

``--plan plan.json`` runs a plan file instead of the built-in small one.
Every child has a timeout; ports are chosen free.  The last line of the
supervisor's output is one JSON object with ``"ok"``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile


# the collective run's per-shard escape budget: 1, so that every shard's
# escapes exceed it and the tally shows the budget applying per shard
ESCAPE_BUDGET = 1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _devices(args, process_id: int = 0, count: int | None = None) -> list:
    """This process's local devices: the CPU listed ``count`` times, or
    its own cards."""
    n = args.local_devices if count is None else count
    if args.platform == "cpu":
        return ["cpu"] * n
    return [f"cuda:{process_id * n + j}" for j in range(n)]


def _child_env() -> dict:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    return env


def _k1_launches() -> int:
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda

    return int(taint_fast_cuda.launches)


def _k1_counts(orch, computed: int) -> dict:
    """An elastic worker's K1 launches beside what should have launched
    them: the batches it computed, its integrity monitor's re-dispatches,
    canary runs and audit samples, and the calls of K1's plain version on
    card tensors (none on a healthy run)."""
    from shrewd_tpu_torch.ops.taint import taint_fast_plain

    mon = orch.monitor
    return {"k1_launches": _k1_launches(),
            "k1_plain_card_calls": int(taint_fast_plain.card_calls),
            "batches_computed": int(computed), "requeues": mon.requeues,
            "canary_runs": mon.canary_runs,
            "audit_batches": mon.audit_batches}


# --------------------------------------------------------------------------
# collective mode
# --------------------------------------------------------------------------

def run_campaign_batch(args, devices) -> tuple:
    """One budgeted sharded batch, integrity-checked, on a mesh over
    ``devices`` (spanning the process group when one is initialised)."""
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel.campaign import ShardedCampaign
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    from shrewd_tpu_torch.trace.synth import WorkloadConfig, generate
    from shrewd_tpu_torch.utils import prng

    trace = generate(WorkloadConfig(
        n=args.uops, nphys=32, mem_words=64, working_set_words=32,
        seed=args.seed))
    mesh = make_mesh(devices)
    kernel = TrialKernel(trace, O3Config(escape_budget=ESCAPE_BUDGET),
                         device=mesh.devices[0])
    camp = ShardedCampaign(kernel, mesh, "regfile", integrity_check=True)
    keys = prng.trial_keys(prng.campaign_key(args.seed, mesh.devices[0]),
                           args.batch)
    tally = camp.tally_batch(keys).tolist()
    return tally, mesh, camp, kernel


def worker(args) -> int:
    from shrewd_tpu_torch.parallel import mesh as M

    M.init_distributed(f"localhost:{args.port}", args.num_processes,
                       args.process_id,
                       backend="gloo" if args.platform == "cpu" else "nccl")
    try:
        tally, mesh, camp, kernel = run_campaign_batch(
            args, _devices(args, args.process_id))
        print(json.dumps({
            "process_id": args.process_id, "world_size": mesh.world_size,
            "mesh_size": mesh.size, "backend": mesh.backend,
            "reductions": mesh.reductions, "tally": tally,
            "shard_checks": camp.shard_checks, "escapes": kernel.escapes,
            "k1_launches": _k1_launches()}), flush=True)
    finally:
        M.shutdown_distributed()
    return 0


def reference(args) -> int:
    tally, mesh, camp, kernel = run_campaign_batch(
        args, _devices(args, 0, args.num_processes * args.local_devices))
    print(json.dumps({"tally": tally, "mesh_size": mesh.size,
                      "escapes": kernel.escapes}), flush=True)
    return 0


def _run_children(argvs, timeout: float) -> list:
    """Start every child at once; → [(rc, stdout, stderr)], a child past
    ``timeout`` killed (rc None)."""
    procs = [subprocess.Popen(a, env=_child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
            out.append((None, o, e))
    return out


def _result_line(stdout: str) -> dict | None:
    line = next((ln for ln in reversed(stdout.splitlines())
                 if ln.startswith("{")), None)
    return None if line is None else json.loads(line)


def _common_argv(args) -> list:
    return ["--batch", str(args.batch), "--uops", str(args.uops),
            "--seed", str(args.seed), "--platform", args.platform,
            "--local-devices", str(args.local_devices),
            "--num-processes", str(args.num_processes),
            "--num-batches", str(args.num_batches),
            "--timeout", str(args.timeout)] + (
        ["--plan", args.plan] if args.plan else [])


def supervise(args) -> int:
    me = [sys.executable, "-m", "shrewd_tpu_torch.parallel.launch"]
    port = _free_port()
    runs = _run_children(
        [me + ["--role", "worker", "--process-id", str(pid),
               "--port", str(port)] + _common_argv(args)
         for pid in range(args.num_processes)], args.timeout)
    results, failures = {}, {}
    for pid, (rc, out, err) in enumerate(runs):
        res = _result_line(out) if rc == 0 else None
        if res is None:
            failures[pid] = f"rc={rc}\n{err[-800:]}"
        else:
            results[pid] = res
    ref = None
    if args.platform == "cpu":
        (rc, out, err), = _run_children(
            [me + ["--role", "reference"] + _common_argv(args)],
            args.timeout)
        ref = _result_line(out) if rc == 0 else None
        if ref is None:
            failures["reference"] = f"rc={rc}\n{err[-800:]}"
    for who, why in failures.items():
        print(f"{who}: {why}", file=sys.stderr)
    vals = [r["tally"] for r in results.values()]
    agree = len(vals) == args.num_processes and all(v == vals[0]
                                                    for v in vals)
    result = {
        "ok": bool(not failures and agree
                   and (ref is None or ref["tally"] == vals[0])),
        "mode": "collective",
        "num_processes": args.num_processes,
        "global_devices": results[0]["mesh_size"] if 0 in results else None,
        "workers_agree": agree,
        "tally": vals[0] if vals else None,
        "single_process_tally": None if ref is None else ref["tally"],
        "matches_single_process": (None if ref is None
                                   else bool(vals) and ref["tally"] ==
                                   vals[0]),
        "workers": results,
    }
    print(json.dumps(result))
    return 0 if result["ok"] else 1


# --------------------------------------------------------------------------
# elastic mode: lease-board campaign + chaos kill + bit-identity check
# --------------------------------------------------------------------------

def _elastic_plan(args):
    """The shared campaign every elastic role runs: ``--plan``'s, or a
    small dense one whose min_trials == max_trials pins the batch count,
    so the undisturbed reference and the kill/recover run converge on the
    same batch set."""
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, WorkloadSpec
    from shrewd_tpu_torch.trace.synth import WorkloadConfig

    if args.plan:
        with open(args.plan) as f:
            return CampaignPlan.from_dict(json.load(f))
    trials = args.batch * args.num_batches
    plan = CampaignPlan(
        simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
            n=args.uops, nphys=32, mem_words=64, working_set_words=32,
            seed=args.seed))],
        structures=["regfile"], batch_size=args.batch,
        target_halfwidth=0.5, max_trials=trials, min_trials=trials,
        seed=args.seed)
    plan.machine.replay_kernel = "dense"
    plan.integrity.canary_trials = 0
    plan.integrity.audit_rate = 0.0
    plan.elastic.heartbeat_interval = 0.2
    plan.elastic.heartbeat_timeout = 2.0
    return plan


def _final_results(orch) -> dict:
    from shrewd_tpu_torch.sim.exit_event import ExitEvent

    events = list(orch.events())
    ev, _ = events[-1]
    if ev is not ExitEvent.CAMPAIGN_COMPLETE:
        raise RuntimeError(f"campaign ended with {ev}")
    return {f"{sp}/{s}": {
        "tallies": st.tallies.tolist(), "trials": int(st.trials),
        "batches": int(st.next_batch),
        "strata": None if st.strata is None else st.strata.tolist()}
        for (sp, s), st in orch.state.items()}


def _device_arg(args):
    return "cpu" if args.platform == "cpu" else None


def elastic_worker(args) -> int:
    import time

    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.parallel.elastic import ElasticContext

    plan = _elastic_plan(args)
    orch = Orchestrator(plan, device=_device_arg(args))
    if args.kill_at_batch >= 0:
        from shrewd_tpu_torch.chaos import ChaosEngine

        eng = ChaosEngine(
            {"faults": [{"kind": "kill_worker",
                         "after_dispatches": args.kill_at_batch}]},
            worker=args.worker)

        def report_and_die(rc):
            # the hard death itself is os._exit; first one line for the
            # supervisor (what this worker launched before it died).  The
            # kill fires at the boundary before the claimed batch's work,
            # so that batch was claimed and not computed.
            print(json.dumps({"worker": args.worker, "killed": True,
                              "dispatches": eng.dispatches,
                              **_k1_counts(orch, ctx.claimed - 1)}),
                  flush=True)
            os._exit(rc)

        eng.kill_action = report_and_die
        orch.attach_chaos(eng)
    ctx = ElasticContext(args.coord_dir, args.worker, plan.elastic)
    if args.wait_for_lost:
        # deterministic kill/recover scenario: hold all claims until the
        # target worker has JOINED (first heartbeat seen) and then DIED
        # (heartbeat stale) — the survivor then demonstrably recovers the
        # dead worker's leased batches rather than winning a startup race
        hb = ctx.membership._hb_path(args.wait_for_lost)
        deadline = time.monotonic() + args.timeout / 2
        while time.monotonic() < deadline:
            if os.path.exists(hb) \
                    and not ctx.membership.alive(args.wait_for_lost):
                break
            time.sleep(0.1)
        else:
            print(f"timed out waiting for {args.wait_for_lost} to die",
                  file=sys.stderr)
            return 1
    orch.attach_elastic(ctx)
    try:
        results = _final_results(orch)
    finally:
        ctx.stop()
    print(json.dumps({"worker": args.worker, "results": results,
                      "elastic": ctx.counters(),
                      **_k1_counts(orch, ctx.claimed)}), flush=True)
    return 0


def elastic_reference(args) -> int:
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator

    print(json.dumps({"results": _final_results(Orchestrator(
        _elastic_plan(args), device=_device_arg(args)))}), flush=True)
    return 0


def _published_by(board_dir: str) -> dict:
    """Published done documents per worker on a lease board."""
    counts: dict = {}
    for name in sorted(os.listdir(board_dir)):
        if name.startswith("done_") and name.endswith(".json"):
            try:
                with open(os.path.join(board_dir, name)) as f:
                    w = json.load(f).get("worker", "")
            except (OSError, ValueError):
                continue
            counts[w] = counts.get(w, 0) + 1
    return counts


def supervise_elastic(args) -> int:
    me = [sys.executable, "-m", "shrewd_tpu_torch.parallel.launch"]
    with tempfile.TemporaryDirectory(prefix="shrewd_elastic_") as coord:
        argvs = []
        for pid in range(args.num_processes):
            argv = me + ["--role", "elastic-worker", "--coord-dir", coord,
                         "--worker", f"w{pid}"] + _common_argv(args)
            if pid == args.kill_worker:
                argv += ["--kill-at-batch", str(args.at_batch)]
            elif args.kill_worker >= 0:
                # survivors hold claims until the target has joined and
                # died, so the run demonstrably RECOVERS leased batches
                # instead of winning a startup race against the victim
                argv += ["--wait-for-lost", f"w{args.kill_worker}"]
            argvs.append(argv)
        runs = _run_children(argvs, args.timeout)
        published = _published_by(os.path.join(coord, "board"))
    results, failures, workers = {}, {}, {}
    for pid, (rc, out, err) in enumerate(runs):
        res = _result_line(out)
        workers[f"w{pid}"] = {"rc": rc, **(res or {})}
        workers[f"w{pid}"].pop("results", None)
        if pid == args.kill_worker:
            # the chaos kill exits rc 137 by design; a killed worker that
            # "succeeded" means the kill never fired
            if rc != 137 or not (res or {}).get("killed"):
                failures[pid] = f"kill target rc={rc}\n{err[-500:]}"
            continue
        if rc != 0 or res is None:
            failures[pid] = f"rc={rc}\n{err[-800:]}"
            continue
        results[pid] = res
    ref = None
    if not args.no_reference:
        (rc, out, err), = _run_children(
            [me + ["--role", "elastic-reference"] + _common_argv(args)],
            args.timeout)
        ref = (_result_line(out) or {}).get("results") if rc == 0 else None
        if ref is None:
            failures["reference"] = f"rc={rc}\n{err[-800:]}"
    for who, why in failures.items():
        print(f"worker {who}: {why}", file=sys.stderr)
    survivor = [r["results"] for r in results.values()]
    expect = args.num_processes - (
        1 if 0 <= args.kill_worker < args.num_processes else 0)
    agree = (len(survivor) == expect > 0
             and all(t == survivor[0] for t in survivor))
    reclaimed = sum(r["elastic"]["batches_reclaimed"]
                    for r in results.values())
    revoked = sum(r["elastic"]["leases_revoked"] for r in results.values())
    result = {
        "ok": bool(not failures and agree
                   and (ref is None or survivor[0] == ref)
                   and (args.kill_worker < 0 or reclaimed >= 1)),
        "mode": "elastic",
        "survivors": sorted(results),
        "survivors_agree": agree,
        "results": survivor[0] if survivor else None,
        "single_process_results": ref,
        "matches_single_process": (None if args.no_reference
                                   else bool(survivor)
                                   and survivor[0] == ref),
        "batches_reclaimed": reclaimed,
        "leases_revoked": revoked,
        "published_by": published,
        "workers": workers,
    }
    print(json.dumps(result))
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "shrewd_tpu_torch.parallel.launch")
    ap.add_argument("--role", default="supervisor",
                    choices=("supervisor", "worker", "reference",
                             "elastic-worker", "elastic-reference"))
    ap.add_argument("--mode", default="collective",
                    choices=("collective", "elastic"),
                    help="collective: one torch.distributed mesh (a dead "
                         "worker wedges the all_reduce); elastic: "
                         "independent per-process meshes over a shared "
                         "lease board (a dead worker's batches are "
                         "reclaimed)")
    ap.add_argument("--platform", default="gpu", choices=("cpu", "gpu"),
                    help="cpu: gloo and CPU meshes; gpu (default): NCCL "
                         "and the cards")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--uops", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=420.0,
                    help="seconds each child may take")
    ap.add_argument("--plan", default="",
                    help="elastic: a plan JSON to run instead of the "
                         "built-in small plan")
    ap.add_argument("--no-reference", action="store_true",
                    help="elastic: skip the undisturbed single-process run")
    ap.add_argument("--num-batches", type=int, default=4,
                    help="elastic: batches in the built-in plan")
    ap.add_argument("--coord-dir", default="",
                    help="elastic worker: shared coordination directory")
    ap.add_argument("--worker", default="w0",
                    help="elastic worker: worker name")
    ap.add_argument("--kill-worker", type=int, default=-1,
                    help="elastic supervisor: worker index to hard-kill "
                         "(-1 = none)")
    ap.add_argument("--at-batch", type=int, default=2,
                    help="elastic supervisor: kill the worker at its Nth "
                         "dispatched batch (1-based)")
    ap.add_argument("--kill-at-batch", type=int, default=-1,
                    help="elastic worker (internal): self-kill at the Nth "
                         "dispatched batch")
    ap.add_argument("--wait-for-lost", default="",
                    help="elastic worker (internal): hold claims until "
                         "this worker has joined and died")
    args = ap.parse_args(argv)
    roles = {"worker": worker, "reference": reference,
             "elastic-worker": elastic_worker,
             "elastic-reference": elastic_reference}
    if args.role in roles:
        return roles[args.role](args)
    if args.mode == "elastic":
        return supervise_elastic(args)
    return supervise(args)


if __name__ == "__main__":
    sys.exit(main())
