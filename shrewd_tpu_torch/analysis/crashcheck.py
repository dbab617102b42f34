"""crashcheck: exhaustive crash-point model checking of the fleet WAL.

The static layer (``replay_lint.py``) certifies the crash-safety
*preconditions*; this dynamic layer proves the *property*: run a small
real fleet under an instrumented VFS shim that records every durability
boundary — each write-ahead-journal append, each journal compaction,
each atomic-rename commit — then **exhaustively** re-execute
``CampaignScheduler.recover()`` from the filesystem state at every one
of those boundaries (plus a torn-tail variant of every append) and
assert that each recovered fleet reaches final tallies bit-identical to
the undisturbed run, with journal sequence numbers never regressing.
This replaces the single-kill-point chaos smoke with full coverage of
the crash surface, in the same spirit the coherence models are
validated by exhaustive checking against the SLICC sources
(MESI_SLICC_VALIDATE, PARITY §2.6).

The model, and its one approximation:

- a crash AT boundary *i* leaves exactly the durable bytes the recorder
  snapshotted at *i* (every durable writer fsyncs before the hook
  fires, and the fleet is single-threaded between boundaries);
- files written WITHOUT fsync (per-tick metrics, Perfetto exports,
  stats dumps) may not survive a real crash even though a same-process
  snapshot sees them — so the recorder **scrubs** them from every
  snapshot, which doubles as a proof that recovery never depends on a
  non-durable file;
- a crash *between* boundaries leaves the same durable state as the
  boundary before it, so boundary enumeration is exhaustive;
- a crash *during* an append is the torn-tail variant: the snapshot's
  last journal line is truncated mid-record, exactly the prefix a
  power loss would leave.

Device work starts when the fleets run (on ``mesh``: every card by
default, ``make_mesh(["cpu"])`` for the CPU); the recorder itself is
pure host-side file work.  Port of ``shrewd_tpu/analysis/crashcheck.py``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from dataclasses import dataclass

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.service.journal import FleetJournal, journal_path
from shrewd_tpu_torch.utils import debug

#: files written without fsync — scrubbed from every crash-point
#: snapshot (a real crash may lose them; recovery must not need them)
NON_DURABLE = ("metrics.json", "metrics.prom", "pool.json", "pool.prom",
               "trace.json", "fleet_stats.txt", "fleet_stats.json",
               "flightrec.json")


@dataclass
class CrashPoint:
    """One durability boundary of the recorded run."""

    index: int
    event: str                 # append | compact | rename
    path: str                  # boundary file, relative to the outdir
    seq: int | None = None     # journal seq (append boundaries)
    kind: str | None = None    # journal record kind (append boundaries)
    snapshot: str = ""         # directory holding the durable state

    def label(self) -> dict:
        return {"index": self.index, "event": self.event,
                "path": self.path, "seq": self.seq, "kind": self.kind}


class DurabilityRecorder:
    """The instrumented VFS shim: observes every durability boundary
    under ``outdir`` (via ``resilience.set_durability_hook``) and
    snapshots the durable filesystem state at each — the crash-point
    enumeration the checker replays from."""

    def __init__(self, outdir: str, points_dir: str):
        self.outdir = os.path.abspath(outdir)
        self.points_dir = points_dir
        self.points: list[CrashPoint] = []
        self._prev = None

    def __enter__(self) -> "DurabilityRecorder":
        self._prev = resil.set_durability_hook(self)
        return self

    def __exit__(self, *exc) -> None:
        resil.set_durability_hook(self._prev)

    def __call__(self, event: str, path: str, seq=None, kind=None,
                 **meta) -> None:
        path = os.path.abspath(path)
        if not path.startswith(self.outdir + os.sep):
            return                   # a boundary outside the watched fleet
        idx = len(self.points)
        snap = os.path.join(self.points_dir, f"{idx:04d}")
        snapshot_tree(self.outdir, snap)
        self.points.append(CrashPoint(
            index=idx, event=event,
            path=os.path.relpath(path, self.outdir),
            seq=seq, kind=kind, snapshot=snap))


def snapshot_tree(src: str, dst: str) -> None:
    """Copy the durable state of ``src`` into ``dst``, scrubbing the
    known non-durable (unsynced) files — see module doc."""
    shutil.copytree(src, dst)
    for root, _dirs, files in os.walk(dst):
        for name in files:
            if name in NON_DURABLE or name.endswith(".tmp") \
                    or ".tmp." in name or name == ".lock" \
                    or name.startswith("hb_"):
                # heartbeats are unsynced liveness signals (their loss
                # on crash IS the signal) — recovery must not read
                # them; ``.tmp.``-infixed scratch (artifact-store
                # staging, ingest scratch captures) is pre-rename and
                # non-durable by construction; a ``.lock`` is the
                # store's single-flight guard, which a crash orphans
                # and the reaper must handle WITHOUT the file
                # surviving into the snapshot as live state
                os.unlink(os.path.join(root, name))


def tear_journal_tail(outdir: str, keep_fraction: float = 0.5,
                      jpath: str | None = None) -> bool:
    """Truncate a journal's LAST record mid-line — the byte prefix a
    power loss during the append would leave.  Returns False when there
    is no complete record to tear.  ``jpath`` overrides the default
    fleet journal (the gateway sweep tears the gateway WAL instead)."""
    jp = jpath if jpath is not None else journal_path(outdir)
    if not os.path.exists(jp) or os.path.getsize(jp) == 0:
        return False
    with open(jp, "rb") as f:
        data = f.read()
    if not data.endswith(b"\n"):
        return False                 # already torn
    body = data[:-1]
    start = body.rfind(b"\n") + 1
    line = data[start:]
    keep = start + max(1, int(len(line) * keep_fraction))
    with open(jp, "r+b") as f:
        f.truncate(keep)
        f.flush()
        os.fsync(f.fileno())
    return True


# --------------------------------------------------------------------------
# fleet construction + comparison
# --------------------------------------------------------------------------

def small_fleet_plans(seeds=(3, 5, 7), n_batches: int = 2,
                      batch_size: int = 32) -> dict:
    """The bounded quick-crashcheck fleet: N tiny synth-workload tenants
    over ONE shared window (the kernel registry shares one
    ``TrialKernel`` across tenants and across crash-point
    re-executions)."""
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, WorkloadSpec
    from shrewd_tpu_torch.trace.synth import WorkloadConfig

    plans = {}
    for i, seed in enumerate(seeds):
        p = CampaignPlan(
            simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
                n=96, nphys=32, mem_words=64, working_set_words=32,
                seed=7))],
            seed=seed, structures=["regfile"], batch_size=batch_size,
            target_halfwidth=0.2, max_trials=batch_size * n_batches,
            min_trials=batch_size * n_batches)
        p.integrity.canary_trials = 0
        p.integrity.audit_rate = 0.0
        p.resilience.backoff_base = 0.0
        plans[f"t{i}"] = p.to_dict()
    return plans


def _run_fleet(outdir: str, plans: dict, **sched_kw):
    from shrewd_tpu_torch.service.queue import TenantSpec
    from shrewd_tpu_torch.service.scheduler import CampaignScheduler

    sched = CampaignScheduler(outdir=outdir, **sched_kw)
    for name, plan in plans.items():
        sched.admit(TenantSpec(name=name, plan=plan))
    rc = sched.run()
    return sched, rc


def _tallies(sched) -> dict:
    import numpy as np

    out = {}
    for name, t in sched.tenants.items():
        out[name] = {k: np.asarray(v["tallies"], dtype=np.int64)
                     for k, v in (t.results or {}).items()}
    return out


def _tallies_equal(a: dict, b: dict) -> bool:
    import numpy as np

    if a.keys() != b.keys():
        return False
    for name in a:
        if a[name].keys() != b[name].keys():
            return False
        for k in a[name]:
            if not np.array_equal(a[name][k], b[name][k]):
                return False
    return True


def _tally_digest(tallies: dict) -> dict:
    return {name: hashlib.sha256(
        b"".join(lanes[k].tobytes() for k in sorted(lanes))).hexdigest()
        for name, lanes in tallies.items()}


def _max_durable_seq(outdir: str) -> int:
    """The highest journal seq visible in a crash-point snapshot
    (snapshot's ``journal_seq`` or the last valid journal record) —
    the floor the recovered fleet's seqs must never dip below."""
    hi = -1
    try:
        snap = resil.load_json_verified(
            os.path.join(outdir, "fleet_ckpt", "fleet.json"))
        hi = int(snap.get("journal_seq", -1))
    except (OSError, ValueError):
        pass
    jp = journal_path(outdir)
    if os.path.exists(jp):
        records, _torn, _valid = FleetJournal.replay_path(jp)
        if records:
            hi = max(hi, int(records[-1]["seq"]))
    return hi


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------

def check_point(point: CrashPoint, scratch: str, plans: dict,
                baseline: dict, torn: bool = False, mesh=None) -> dict:
    """Re-execute recovery from one crash point: copy the snapshot,
    optionally tear the last journal record (the mid-append crash),
    ``recover()``, re-admit any tenant the crash landed before its
    admit record, run to completion, and compare against the
    undisturbed baseline."""
    from shrewd_tpu_torch.service.queue import TenantSpec
    from shrewd_tpu_torch.service.scheduler import CampaignScheduler

    shutil.copytree(point.snapshot, scratch)
    if torn and not tear_journal_tail(scratch):
        shutil.rmtree(scratch, ignore_errors=True)
        return {**point.label(), "torn": True, "skipped": True,
                "ok": True}
    pre_max = _max_durable_seq(scratch)
    if torn:
        # the torn record was never acknowledged: the durable floor is
        # everything strictly before it
        pre_max = min(pre_max, (point.seq or 0) - 1)
    result = {**point.label(), "torn": torn, "ok": False}
    try:
        sched = CampaignScheduler.recover(scratch, mesh=mesh)
        for name, plan in plans.items():
            if name not in sched.tenants:
                # the crash landed before this tenant's admit record
                # became durable: the operator (here: the checker)
                # resubmits, exactly like the spool would
                sched.admit(TenantSpec(name=name, plan=plan))
        rc = sched.run()
        got = _tallies(sched)
        statuses = {n: t.status for n, t in sched.tenants.items()}
        post_max = _max_durable_seq(scratch)
        result.update(
            rc=rc,
            identical=_tallies_equal(got, baseline),
            statuses=statuses,
            seq_monotonic=post_max >= max(pre_max, 0),
            recoveries=sched.recoveries)
        result["ok"] = (rc == 0 and result["identical"]
                        and result["seq_monotonic"]
                        and all(s == "complete" for s in
                                statuses.values()))
    except Exception as e:  # noqa: BLE001 — a crash point that breaks
        # recovery outright is the most important finding of all; it
        # must land in the report, not abort the sweep
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return result


def run_crashcheck(workdir: str, plans: dict | None = None,
                   torn: bool = True, max_points: int | None = None,
                   compact_every: int = 8, mesh=None, **sched_kw) -> dict:
    """The full sweep (see module doc).  Returns the machine-readable
    report; ``report["ok"]`` is the gate bit.  Every fleet, recovered
    ones included, runs on ``mesh``."""
    plans = plans if plans is not None else small_fleet_plans()
    # 1. the undisturbed reference run
    sched, rc = _run_fleet(os.path.join(workdir, "baseline"), plans,
                           compact_every=compact_every, mesh=mesh,
                           **sched_kw)
    if rc != 0:
        raise RuntimeError(f"crashcheck baseline fleet rc {rc}")
    baseline = _tallies(sched)
    # 2. the recorded run: identical fleet, every durability boundary
    #    snapshotted by the VFS shim
    rec_dir = os.path.join(workdir, "recorded")
    points_dir = os.path.join(workdir, "points")
    os.makedirs(points_dir, exist_ok=True)
    with DurabilityRecorder(rec_dir, points_dir) as recorder:
        sched2, rc2 = _run_fleet(rec_dir, plans,
                                 compact_every=compact_every, mesh=mesh,
                                 **sched_kw)
    if rc2 != 0 or not _tallies_equal(_tallies(sched2), baseline):
        raise RuntimeError(
            "crashcheck recorded run diverged from baseline — the "
            "recorder must be observation-only")
    points = recorder.points
    dropped = 0
    if max_points is not None and len(points) > max_points:
        dropped = len(points) - max_points
        points = points[:max_points]
        debug.dprintf("Crashcheck", "bounded sweep: checking %d of %d "
                      "crash points", max_points, max_points + dropped)
    # 3. exhaustive recovery re-execution
    results = []
    for pt in points:
        scratch = os.path.join(workdir, f"chk_{pt.index:04d}")
        results.append(check_point(pt, scratch, plans, baseline,
                                   mesh=mesh))
        if torn and pt.event == "append":
            scratch = os.path.join(workdir, f"chk_{pt.index:04d}_torn")
            results.append(check_point(pt, scratch, plans, baseline,
                                       torn=True, mesh=mesh))
    failures = [r for r in results if not r["ok"]]
    doc = {
        "tool": "crashcheck",
        "tenants": sorted(plans),
        "points": len(recorder.points),
        "points_checked": len(points),
        "points_dropped": dropped,
        "checks": len(results),
        "torn_checks": sum(1 for r in results if r["torn"]),
        "events": [pt.label() for pt in recorder.points],
        "boundaries_by_event": _count_by(recorder.points, "event"),
        "baseline_digest": _tally_digest(baseline),
        "failures": failures,
        "seq_monotonic": all(r.get("seq_monotonic", True)
                             for r in results),
        "ok": not failures and dropped == 0,
    }
    return doc


def _count_by(points, field: str) -> dict:
    out: dict = {}
    for pt in points:
        key = getattr(pt, field)
        out[key] = out.get(key, 0) + 1
    return out


# --------------------------------------------------------------------------
# the gateway sweep (federation tier)
# --------------------------------------------------------------------------
#
# The fleet sweep above proves one pod's WAL; this sweep proves the tier
# over it: the GATEWAY's routing ledger.  The hazardous window is the
# two-phase placement — route-decision journal, THEN the handoff
# submission into the pod's spool, THEN the place-commitment journal —
# where a kill must replay the journaled decision (place on the SAME
# pod, exactly once) and never re-decide into a double placement.  The
# recorder watches the whole federation root (a consistent snapshot
# needs gateway + pods together) but enumerates crash points only at
# gateway-WAL boundaries and at the handoff writes themselves.
#
# Sharded campaigns (``TenantSpec.shards > 1``) extend the crash
# surface with the MERGE LEDGER: shard_split / shard_fold /
# shard_converged records, each journaled before the gateway's fold
# state mutates.  Passing ``shards=`` sweeps those boundaries too —
# every ``shard_fold`` append (plus its torn-tail variant) becomes a
# crash point, and the recovered federation must re-fold to merged
# tallies bit-identical to the undisturbed run (run-to-cap plans: the
# merged stopping rule can only revoke after every stripe is complete,
# so the final merge is timing-independent).

class GatewayRecorder(DurabilityRecorder):
    """Snapshot the full federation tree, but make a crash point only
    of gateway-owned durability boundaries (its WAL appends, its
    snapshot renames, its spool) and of pod-spool handoff writes —
    the seam the two-phase placement crosses."""

    def __call__(self, event: str, path: str, seq=None, kind=None,
                 **meta) -> None:
        apath = os.path.abspath(path)
        if not apath.startswith(self.outdir + os.sep):
            return
        rel = os.path.relpath(apath, self.outdir)
        parts = rel.split(os.sep)
        gateway_owned = parts[0] == "gateway"
        handoff = (parts[0] == "pods" and len(parts) >= 4
                   and parts[2] == "spool" and parts[3] == "pending")
        # the streaming-ingest crash surface: the federation-shared
        # artifact store (payload/doc renames at <root>/store) and each
        # tenant's per-pod ingest WAL (appends at
        # pods/<pod>/tenants/<t>/ingest/) — recovery from any of these
        # must resume the pipeline mid-flight from the last durable
        # stage with bit-identical downstream windows
        store_owned = parts[0] == "store"
        ingest_wal = (parts[0] == "pods" and "tenants" in parts
                      and "ingest" in parts)
        if not (gateway_owned or handoff or store_owned or ingest_wal):
            return
        idx = len(self.points)
        snap = os.path.join(self.points_dir, f"{idx:04d}")
        snapshot_tree(self.outdir, snap)
        self.points.append(CrashPoint(
            index=idx, event=event, path=rel, seq=seq, kind=kind,
            snapshot=snap))


def _fed_tallies(fed, plans: dict) -> dict:
    return {name: fed.tenant_tallies(name) for name in plans}


def _placements(root: str, pod_names, tenants) -> dict:
    """tenant -> pods whose spool holds a LIVE submission for it (the
    double-placement probe: every tenant must appear on EXACTLY one
    pod).  Live means pending/claimed or terminal with a real result —
    a migration (including a pool retire's drain) legitimately leaves
    an ``evicted`` done-doc behind on the source pod, which is history,
    not a placement.  ``pod_names`` is extended with whatever pod
    directories exist on disk so autoscaled pods are probed too."""
    from shrewd_tpu_torch.federation.gateway import find_spool_ticket
    from shrewd_tpu_torch.service.queue import SubmissionQueue

    pods_root = os.path.join(root, "pods")
    try:
        all_pods = sorted(set(pod_names) | set(os.listdir(pods_root)))
    except OSError:
        all_pods = sorted(set(pod_names))
    out = {}
    for name in tenants:
        hosts = []
        for p in all_pods:
            spool = os.path.join(pods_root, p, "spool")
            hit = find_spool_ticket(spool, name)
            if hit is None:
                continue
            sub, ticket = hit
            if sub == "bad":
                continue
            if sub == "done":
                doc = SubmissionQueue(spool).done(ticket)
                if doc is None or doc.get("status") in ("evicted",
                                                        "refused"):
                    continue
            hosts.append(p)
        out[name] = hosts
    return out


def check_gateway_point(point: CrashPoint, scratch: str, plans: dict,
                        pod_names, baseline: dict, torn: bool = False,
                        shards: dict | None = None,
                        binaries: dict | None = None,
                        tear: tuple | None = None, mesh=None) -> dict:
    """Re-execute federation recovery from one gateway crash point:
    copy the snapshot, optionally tear the gateway WAL's last record,
    ``Federation.recover()`` (gateway replay + placement repair +
    merge-fold repair; pods replay their own WALs lazily), re-admit
    tenants the crash landed before their accept record, serve to
    convergence — then assert aggregate tallies bit-identical to the
    undisturbed run AND every placed tenant on exactly one pod.  The
    placement probe runs over the recovered LEDGER's placed entries: a
    sharded parent never touches a pod spool (it splits at the
    gateway) and a surplus shard pruned while queued never places —
    neither may be held to the exactly-one-spool rule."""
    from shrewd_tpu_torch.federation.driver import Federation
    from shrewd_tpu_torch.federation.gateway import gateway_journal_path
    from shrewd_tpu_torch.service.queue import TenantSpec

    shards = shards or {}
    binaries = binaries or {}
    shutil.copytree(point.snapshot, scratch)
    if torn and not tear_journal_tail(
            scratch, jpath=gateway_journal_path(
                os.path.join(scratch, "gateway"))):
        shutil.rmtree(scratch, ignore_errors=True)
        return {**point.label(), "torn": True, "skipped": True,
                "ok": True}
    if tear is not None:
        # the ingest crash surface's damage variants: a torn ingest-WAL
        # tail (power loss mid-append) or a torn store payload (the
        # rename landed, the content didn't survive) — recovery must
        # fall back to the previous durable stage / re-lift, never
        # diverge
        from shrewd_tpu_torch.chaos import tear_file

        mode, rel = tear
        tgt = os.path.join(scratch, rel)
        ok_tear = os.path.exists(tgt) and os.path.getsize(tgt) > 0 and (
            tear_journal_tail(scratch, jpath=tgt) if mode == "journal"
            else (tear_file(tgt, 0.5) or True))
        if not ok_tear:
            shutil.rmtree(scratch, ignore_errors=True)
            return {**point.label(), "torn": True, "tear": list(tear),
                    "skipped": True, "ok": True}
    result = {**point.label(), "torn": torn or tear is not None,
              "ok": False}
    if tear is not None:
        result["tear"] = list(tear)
    try:
        fed = Federation.recover(scratch, pod_names=tuple(pod_names),
                                 mesh=mesh)
        for name, plan in plans.items():
            if name not in fed.gateway.entries:
                fed.gateway.admit(TenantSpec(
                    name=name, plan=plan,
                    shards=int(shards.get(name, 1)),
                    **binaries.get(name, {})))
        rc = fed.serve()
        got = _fed_tallies(fed, plans)
        probe = sorted(
            n for n, e in fed.gateway.entries.items()
            if not e.shards and e.pod)
        placements = _placements(scratch, pod_names, probe)
        result.update(
            rc=rc,
            identical=_tallies_equal(got, baseline),
            placements=placements,
            placed_once=all(len(v) == 1 for v in placements.values()),
            statuses={n: e.status
                      for n, e in fed.gateway.entries.items()},
            recoveries=fed.gateway.recoveries)
        result["ok"] = (rc == 0 and result["identical"]
                        and result["placed_once"])
    except Exception as e:  # noqa: BLE001 — a crash point that breaks
        # recovery outright is the most important finding of all
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return result


def run_gateway_crashcheck(workdir: str, plans: dict | None = None,
                           pod_names=("pod0", "pod1"), torn: bool = True,
                           max_points: int | None = None,
                           shards: dict | None = None,
                           binaries: dict | None = None,
                           point_filter=None,
                           autoscale=None, mesh=None) -> dict:
    """The gateway-WAL sweep (see section comment).  ``shards`` maps
    tenant name -> shard count (``TenantSpec.shards``): those tenants
    run split across pods and the sweep covers the merge ledger's
    durability boundaries — every ``shard_split`` / ``shard_fold`` /
    ``shard_converged`` append plus torn-tail variants.  ``binaries``
    maps tenant name -> ``{binary_b64, binary_digest, ingest}``
    TenantSpec fields: those tenants submit a RAW BINARY and the sweep
    grows the streaming-ingest crash surface — every ingest-WAL append
    and artifact-store rename becomes a crash point, ingest-WAL appends
    get torn-tail variants, and store-payload renames get
    torn-payload variants (recovery must resume mid-pipeline from the
    last durable stage / silently re-lift, with final tallies
    bit-identical to the undisturbed run).  ``point_filter`` (a
    ``CrashPoint -> bool`` callable) narrows the sweep to a chosen
    surface — e.g. only ingest-WAL appends and store renames — so a
    test can exhaustively cover ONE seam in bounded time; ``ok`` then
    certifies every selected point.  ``autoscale`` is a ZERO-ARG
    FACTORY returning a fresh ``Autoscaler`` (the controller carries
    cooldown state, so baseline and recorded runs each need their own):
    the sweep then covers the elastic-pool crash surface — every
    ``pool_scale_up`` / ``pool_retire_begin`` / ``pool_retire_done``
    append plus torn-tail variants.  Recovery re-executes WITHOUT an
    autoscaler attached: the journaled ledger alone must carry every
    pending pool transition to completion (the driver reconciles;
    deciding was already durable).  Every federation, recovered ones
    included, runs its pods on ``mesh``.  Returns the machine-readable
    report; ``report["ok"]`` is the gate bit."""
    from shrewd_tpu_torch.federation.driver import Federation
    from shrewd_tpu_torch.service.queue import TenantSpec

    plans = plans if plans is not None else small_fleet_plans(
        seeds=(3, 5))
    shards = shards or {}
    binaries = binaries or {}

    def _run(root):
        fed = Federation(root, pod_names=tuple(pod_names), mesh=mesh,
                         autoscale=autoscale() if autoscale else None)
        for name, plan in plans.items():
            fed.submit(TenantSpec(name=name, plan=plan,
                                  shards=int(shards.get(name, 1)),
                                  **binaries.get(name, {})))
        rc = fed.serve()
        return fed, rc

    # 1. the undisturbed reference federation
    fed, rc = _run(os.path.join(workdir, "baseline"))
    if rc != 0:
        raise RuntimeError(f"gateway crashcheck baseline rc {rc}")
    baseline = _fed_tallies(fed, plans)
    # 2. the recorded run
    rec_dir = os.path.join(workdir, "recorded")
    points_dir = os.path.join(workdir, "points")
    os.makedirs(points_dir, exist_ok=True)
    with GatewayRecorder(rec_dir, points_dir) as recorder:
        fed2, rc2 = _run(rec_dir)
    if rc2 != 0 or not _tallies_equal(_fed_tallies(fed2, plans),
                                      baseline):
        raise RuntimeError(
            "gateway crashcheck recorded run diverged from baseline — "
            "the recorder must be observation-only")
    points = recorder.points
    if point_filter is not None:
        points = [pt for pt in points if point_filter(pt)]
    selected = len(points)
    dropped = 0
    if max_points is not None and len(points) > max_points:
        dropped = len(points) - max_points
        points = points[:max_points]
        debug.dprintf("Crashcheck", "bounded gateway sweep: checking "
                      "%d of %d crash points", max_points,
                      max_points + dropped)
    # 3. exhaustive recovery re-execution from every gateway boundary
    results = []
    for pt in points:
        scratch = os.path.join(workdir, f"gchk_{pt.index:04d}")
        results.append(check_gateway_point(pt, scratch, plans,
                                           pod_names, baseline,
                                           shards=shards,
                                           binaries=binaries, mesh=mesh))
        if torn and pt.event == "append" \
                and pt.path.startswith("gateway" + os.sep):
            scratch = os.path.join(workdir, f"gchk_{pt.index:04d}_torn")
            results.append(check_gateway_point(
                pt, scratch, plans, pod_names, baseline, torn=True,
                shards=shards, binaries=binaries, mesh=mesh))
        if torn and pt.event == "append" \
                and pt.path.endswith(os.sep + "ingest.jsonl"):
            # torn ingest-WAL tail: the stage record's append lost its
            # last line — recovery replays the shorter WAL and re-runs
            # from the previous durable stage
            scratch = os.path.join(workdir, f"gchk_{pt.index:04d}_torn")
            results.append(check_gateway_point(
                pt, scratch, plans, pod_names, baseline,
                shards=shards, binaries=binaries,
                tear=("journal", pt.path), mesh=mesh))
        if torn and pt.event == "rename" \
                and pt.kind == "store_payload":
            # torn store payload: the artifact's rename is durable but
            # its bytes are not — get_doc's sha re-verification must
            # read it as a miss and the pipeline must re-lift
            scratch = os.path.join(workdir, f"gchk_{pt.index:04d}_rot")
            results.append(check_gateway_point(
                pt, scratch, plans, pod_names, baseline,
                shards=shards, binaries=binaries,
                tear=("file", pt.path), mesh=mesh))
    failures = [r for r in results if not r["ok"]]
    return {
        "tool": "crashcheck-gateway",
        "tenants": sorted(plans),
        "pods": list(pod_names),
        "shards": {n: int(v) for n, v in sorted(shards.items())},
        "binaries": sorted(binaries),
        "autoscaled": autoscale is not None,
        "points": len(recorder.points),
        "points_selected": selected,
        "points_checked": len(points),
        "points_dropped": dropped,
        "checks": len(results),
        "torn_checks": sum(1 for r in results if r["torn"]),
        "events": [pt.label() for pt in recorder.points],
        "boundaries_by_event": _count_by(recorder.points, "event"),
        "boundaries_by_kind": _count_by(recorder.points, "kind"),
        "baseline_digest": _tally_digest(
            {n: baseline[n] for n in baseline}),
        "failures": failures,
        "ok": not failures and dropped == 0,
    }
