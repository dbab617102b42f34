"""Federated fleet-of-fleets driver — the CLI over
``shrewd_tpu_torch/federation/`` (port of the JAX package's
``tools/federation.py``, with its flags), run as
``python -m shrewd_tpu_torch.tools.federation``.  Every pod runs its
tenants on the card unless ``--platform cpu`` asks for the CPU;
``--certify warn|strict`` is the certification floor every pod applies
(``shrewd_tpu_torch/analysis/``).

Modes:

- **direct** — admit plan files through the gateway and serve the
  federation to convergence (the FED smoke / benchmark mode)::

      python -m shrewd_tpu_torch.tools.federation --plans a.json b.json c.json \\
          --outdir fed_out --pods 3

- **serve** — run the federation resident over the gateway spool;
  tenants arrive while it runs (``--submit`` below, or the HTTP front
  with ``--http PORT``)::

      python -m shrewd_tpu_torch.tools.federation --serve --outdir fed_out --pods 3

- **submit** — spool one tenant at the gateway from any process::

      python -m shrewd_tpu_torch.tools.federation --submit plan.json \\
          --outdir fed_out --name exp42 --slo 600

- **recover** — rebuild the whole tier after a hard kill of the driver
  process: the gateway replays its routing WAL (finishing any
  interrupted placement without double-placing), each pod replays its
  own WAL, and every tenant continues from its namespaced checkpoint
  bit-identically::

      python -m shrewd_tpu_torch.tools.federation --recover fed_out

- **status** — print the gateway's persisted routing ledger.

``--chaos-plan`` arms the federation-level chaos kinds (``kill_pod`` /
``partition_pod``) for reproducible survivability drills; pod-level
and campaign-level chaos ride the tenant plans as always.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _pod_names(n: int) -> tuple:
    return tuple(f"pod{i}" for i in range(n))


def _mesh(a):
    """``--platform``: every card when absent (``gpu``/``cuda`` name
    it), one CPU device for ``cpu``."""
    from shrewd_tpu_torch.parallel.mesh import make_mesh

    if a.platform in (None, "", "gpu", "cuda"):
        return None
    if a.platform == "cpu":
        return make_mesh(["cpu"])
    raise SystemExit(f"unknown --platform {a.platform!r} (cpu | gpu)")


def cmd_submit(a) -> int:
    from shrewd_tpu_torch.service import SubmissionQueue, TenantSpec

    with open(a.submit) as f:
        plan = json.load(f)
    name = a.name or os.path.splitext(os.path.basename(a.submit))[0]
    ticket = SubmissionQueue(
        os.path.join(a.outdir, "gateway", "spool")).submit(TenantSpec(
            name=name, plan=plan, priority=a.priority, weight=a.weight,
            quota_batches=a.quota_batches, slo_s=a.slo))
    print(json.dumps({"ticket": ticket, "tenant": name}))
    return 0


def cmd_status(a) -> int:
    from shrewd_tpu_torch.federation import gateway_snap_path
    from shrewd_tpu_torch.resilience import load_json_verified

    snap = load_json_verified(gateway_snap_path(
        os.path.join(a.status, "gateway")))
    out = {"pods": snap.get("pods"), "dead_pods": snap.get("dead_pods"),
           "recoveries": snap.get("recoveries"),
           "tenants": {e["spec"]["name"]: {
               "status": e["status"], "pod": e["pod"],
               "epoch": e["epoch"], "deadline_s": e["deadline_s"],
               "slo_s": e["spec"].get("slo_s", 0.0)}
               for e in snap.get("entries", [])}}
    print(json.dumps(out, indent=1))
    return 0


def _report(fed) -> None:
    for name, e in sorted(fed.gateway.entries.items()):
        path = "->".join(h["pod"] for h in e.history) or "-"
        _log(f"  {name}: {e.status} on {e.pod or '-'} "
             f"(epoch {e.epoch}, path {path})")
    _log(f"federation: {json.dumps(fed.counters())}")


def cmd_run(a) -> int:
    from shrewd_tpu_torch.federation import Federation, GatewayHTTPFront
    from shrewd_tpu_torch.service import LockHeld, ServerLock, TenantSpec

    if a.trace:
        from shrewd_tpu_torch.obs import trace as obs_trace

        obs_trace.enable(ring=a.trace_ring or obs_trace.DEFAULT_RING)
    chaos = None
    if a.chaos_plan:
        from shrewd_tpu_torch.chaos import ChaosEngine

        chaos = ChaosEngine.from_path(a.chaos_plan, worker="federation")
    lock = ServerLock(a.recover or a.outdir)
    try:
        lock.acquire()
    except LockHeld as e:
        _log(f"another driver owns this federation: {e}")
        return 2
    front = None
    try:
        kw = dict(chaos=chaos, mesh=_mesh(a), quantum=a.quantum,
                  expiry_rounds=a.expiry_rounds,
                  rebalance_every=a.rebalance_every,
                  idle_exit=not a.serve)
        if a.certify:
            kw["certify"] = a.certify
        if a.recover:
            fed = Federation.recover(a.recover,
                                     pod_names=_pod_names(a.pods), **kw)
            _log(f"recovered federation: gateway recoveries "
                 f"{fed.gateway.recoveries}, dead pods "
                 f"{sorted(fed.gateway.dead_pods)}")
        else:
            fed = Federation(a.outdir, pod_names=_pod_names(a.pods),
                             **kw)
        for path in a.plans or ():
            with open(path) as f:
                plan = json.load(f)
            name = f"t{len(fed.gateway.entries)}_" \
                   f"{os.path.splitext(os.path.basename(path))[0]}"
            doc = fed.submit(TenantSpec(name=name, plan=plan,
                                        slo_s=a.slo))
            _log(f"admitted {name} -> {doc['pod']} "
                 f"(deadline ~{doc['deadline_s']}s, "
                 f"eta {doc['eta_trials']} trials)")
        if a.http is not None:
            front = GatewayHTTPFront(
                os.path.join(fed.root, "gateway"), port=a.http).start()
            _log(f"http front on 127.0.0.1:{front.port}")
        rc = fed.serve()
        _report(fed)
        return rc
    finally:
        if front is not None:
            front.stop()
        lock.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="federated fleet-of-fleets driver "
                    "(shrewd_tpu_torch/federation/)")
    ap.add_argument("--outdir", default="fed_out",
                    help="federation root (gateway/ + pods/ + coord/)")
    ap.add_argument("--pods", type=int, default=3,
                    help="number of scheduler pods (default 3)")
    ap.add_argument("--plans", nargs="+", default=None,
                    help="plan JSONs to admit directly (direct mode)")
    ap.add_argument("--serve", action="store_true",
                    help="serve resident over the gateway spool")
    ap.add_argument("--submit", default=None, metavar="PLAN",
                    help="spool one tenant at the gateway and exit")
    ap.add_argument("--recover", default=None, metavar="DIR",
                    help="recover a federation after a hard kill and "
                         "continue serving")
    ap.add_argument("--status", default=None, metavar="DIR",
                    help="print the gateway's routing ledger and exit")
    ap.add_argument("--name", default=None, help="tenant name (--submit)")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--weight", type=float, default=1.0)
    ap.add_argument("--quota-batches", type=int, default=0)
    ap.add_argument("--slo", type=float, default=0.0,
                    help="completion SLO in seconds (advisory; the "
                         "admission doc reports feasibility against "
                         "the deadline estimate)")
    ap.add_argument("--quantum", type=int, default=1,
                    help="scheduler steps per pod per federation round")
    ap.add_argument("--expiry-rounds", type=int, default=3,
                    help="supervisor polls without a heartbeat before "
                         "a pod's lease expires")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="rounds between ETA-runaway rebalancing "
                         "checks (0 = off)")
    ap.add_argument("--certify", default="",
                    choices=["", "off", "warn", "strict"],
                    help="admission-time certification floor applied "
                         "by every pod")
    ap.add_argument("--chaos-plan", default=None,
                    help="federation-level chaos plan JSON "
                         "(kill_pod / partition_pod)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="also serve the HTTP front (0 = ephemeral)")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-ring", type=int, default=0)
    ap.add_argument("--platform", default=None,
                    help="cpu runs every pod's tenants on the CPU; the "
                         "default (or gpu) is every visible card")
    a = ap.parse_args(argv)

    if a.submit:
        return cmd_submit(a)
    if a.status:
        return cmd_status(a)
    if not (a.plans or a.serve or a.recover):
        ap.error("one of --plans / --serve / --submit / --recover / "
                 "--status is required")
    return cmd_run(a)


if __name__ == "__main__":
    sys.exit(main())
