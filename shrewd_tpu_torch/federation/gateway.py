"""The federation gateway: a crash-safe routing tier over N scheduler pods.

One ``Gateway`` owns the service surface of a fleet-of-fleets: it
accepts tenant submissions (the existing spool doc format — plus the
thin HTTP front in ``http_front.py``), decides which pod serves each
tenant, and survives its own hard kill the same way the pods survive
theirs — every routing decision is journaled to a write-ahead log
(``service/journal.py``'s ``FleetJournal``, reused verbatim) BEFORE any
in-memory ledger mutates, and ``Gateway.recover()`` replays
snapshot+journal back to the exact decision state.

**Routing is convergence-distance routing.**  Each pod's scheduler
publishes per-tenant ``eta_trials`` (the half-width-trajectory
trials-still-needed estimate — ``stopping.eta_trials``, the SAME
estimator its own interval planner consumes) and ``trials_per_s`` in
its ``metrics.json``; the gateway scores a pod by the ETA mass it is
already carrying plus the backlog the gateway has placed but the pod
has not yet surfaced, and routes to the minimum.  Admission therefore
returns a **deadline estimate** (projected seconds to this tenant's
convergence on the chosen pod), and a tenant's ``slo_s`` rides its
spec: the admission doc says up front whether the SLO looks feasible,
and the rebalancer uses the same projection to decide migrations.

**Placement is a two-phase handoff, and the WAL makes it exact.**  The
``route`` record (decision) is journaled first; then the tenant's spec
is submitted into the chosen pod's spool (the handoff — an fsync'd
atomic document); then the ``place`` record (commitment) is journaled.
A hard kill in EITHER window replays to safety: recovery re-scans the
decided pod's spool for the tenant's ticket — found means the handoff
landed (repair the ``place`` record), absent means it never did
(re-submit to the SAME journaled pod).  A tenant can never be placed
on two pods, because the only re-submission path replays the journaled
decision instead of re-deciding — the property ``crashcheck``'s
gateway sweep proves from every durability boundary.

**Migration is free because identity is bits.**  Every pod resumes a
tenant from its namespaced checkpoint on frozen per-batch PRNG keys,
so drain-on-pod-A → copy checkpoint → recover-on-pod-B finishes
bit-identical to an undisturbed solo run.  The same path serves both
planned rebalancing (``migrate``: evict on the source, re-place on the
target) and pod-death failover (``failover_pod``: the supervisor's
lease verdict, then re-place every stranded tenant from its last
checkpoint) — one mechanism, proven once.

The gateway is pure host-side routing; device work runs inside the
pods.  Port of ``shrewd_tpu/federation/gateway.py``.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.federation.pods import PodPort
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.service.journal import FleetJournal
from shrewd_tpu_torch.service.queue import SubmissionQueue, TenantSpec, sanitize
from shrewd_tpu_torch.utils import debug

GATEWAY_CKPT_VERSION = 1

#: the gateway's durable names (under ``<outdir>/gateway_ckpt/``)
GATEWAY_SNAP = "gateway.json"
GATEWAY_JOURNAL = "journal.jsonl"

#: trials assumed for a plan that does not bound itself (deadline math
#: only — routing still works, the estimate is just labeled a guess)
DEFAULT_EST_TRIALS = 4096.0

#: entry statuses: accepted → routed → placed → done, with draining
#: (migration eviction pending on the source pod) re-entering routed
TERMINAL = ("done",)


def gateway_ckpt_dir(outdir: str) -> str:
    return os.path.join(outdir, "gateway_ckpt")


def gateway_journal_path(outdir: str) -> str:
    return os.path.join(gateway_ckpt_dir(outdir), GATEWAY_JOURNAL)


def gateway_snap_path(outdir: str) -> str:
    return os.path.join(gateway_ckpt_dir(outdir), GATEWAY_SNAP)


def est_trials(spec: TenantSpec) -> float:
    """Upper-bound trials estimate for one tenant (deadline math)."""
    plan = spec.plan or {}
    for key in ("max_trials", "min_trials"):
        v = plan.get(key)
        if v:
            return float(v)
    return DEFAULT_EST_TRIALS


def find_spool_ticket(spool_root: str, tenant: str):
    """``(subdir, ticket)`` of the named tenant's NEWEST submission
    anywhere in a pod's spool (pending/claimed/done/bad), or None — the
    handoff existence probe recovery replays the route decision
    against.  Matches the FULL ticket shape (6-digit seq + exact
    sanitized name — a bare suffix match would let tenant ``b_a``'s
    ticket answer for tenant ``a``); newest (highest seq) because a
    returning migration leaves the earlier placement's evicted ticket
    behind in ``done/``: the live placement is always the latest."""
    pat = re.compile(r"^\d{6}_" + re.escape(sanitize(tenant))
                     + r"\.json$")
    best = None
    for sub in ("pending", "claimed", "done", "bad"):
        d = os.path.join(spool_root, sub)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for fn in names:
            if pat.match(fn) and (best is None or fn > best[1]):
                best = (sub, fn)
    return best


def copy_tenant_checkpoint(src_outdir: str, dst_outdir: str,
                           tenant: str) -> bool:
    """Migrate a tenant's namespaced state by bit-identity: copy
    ``tenants/<name>/`` (checkpoints + artifacts) from one pod's outdir
    to another's, then fsync the copied tree BEFORE the handoff — the
    checkpoint must be durable on the target before the target can be
    told to resume from it.  Idempotent (re-copy overwrites); returns
    False when the source has no namespace yet (a tenant that never
    started migrates as a fresh start — bit-identical anyway, frozen
    keys)."""
    src = os.path.join(src_outdir, "tenants", sanitize(tenant))
    if not os.path.isdir(src):
        return False
    dst = os.path.join(dst_outdir, "tenants", sanitize(tenant))
    shutil.copytree(src, dst, dirs_exist_ok=True)
    for root, _dirs, files in os.walk(dst):
        for name in files:
            with open(os.path.join(root, name), "rb") as f:
                os.fsync(f.fileno())
        resil.fsync_dir(root)
    return True


class RouteEntry:
    """One tenant's life at the gateway: spec + placement + ledgers."""

    def __init__(self, spec: TenantSpec, order: int, ticket: str = ""):
        self.spec = spec
        self.order = order           # acceptance order (tiebreak)
        self.ticket = ticket         # gateway-spool ticket ("" = direct)
        self.pod = ""                # the authoritative placement
        self.pod_ticket = ""         # ticket in the pod's spool
        self.from_pod = ""           # migration/failover source pod
        self.epoch = 0               # placements so far (route counter)
        self.status = "accepted"
        self.migrate_to = ""         # pending migration target
        self.deadline_s = None       # admission deadline estimate (s)
        self.eta_trials = None       # pod ETA mass at admission
        self.result = None           # the pod's done-doc
        self.history: list[dict] = []  # [{pod, reason, epoch}]
        # single-campaign sharding (spec.shards > 1): a PARENT entry
        # holds the merge ledger (never placed on any pod itself — its
        # status is "sharded" until the merged campaign completes); a
        # CHILD (sub-tenant) entry carries its parent's name and its
        # stripe index and is otherwise an ordinary routed tenant —
        # migration, failover and fencing need no shard-specific mode
        self.shard_of = ""           # child: parent tenant name
        self.shard_index = -1        # child: round-robin stripe offset
        self.shards: list[str] = []  # parent: children in stripe order
        self.fold_shards: dict = {}  # parent: last folded shard reports
        self.fold_merged: dict = {}  # parent: last merged lane state
        self.fold_seq = 0            # parent: shard_fold records so far
        self.converged = False       # parent: merged stopping rule fired

    def to_dict(self) -> dict:
        return {"spec": self.spec.to_dict(), "order": self.order,
                "ticket": self.ticket, "pod": self.pod,
                "pod_ticket": self.pod_ticket, "from_pod": self.from_pod,
                "epoch": self.epoch, "status": self.status,
                "migrate_to": self.migrate_to,
                "deadline_s": self.deadline_s,
                "eta_trials": self.eta_trials,
                "result": self.result, "history": list(self.history),
                "shard_of": self.shard_of,
                "shard_index": self.shard_index,
                "shards": list(self.shards),
                "fold_shards": dict(self.fold_shards),
                "fold_merged": dict(self.fold_merged),
                "fold_seq": self.fold_seq,
                "converged": self.converged}

    @classmethod
    def from_dict(cls, d: dict) -> "RouteEntry":
        e = cls(TenantSpec.from_dict(d["spec"]),
                order=int(d.get("order", 0)),
                ticket=d.get("ticket", ""))
        e.pod = str(d.get("pod") or "")
        e.pod_ticket = str(d.get("pod_ticket") or "")
        e.from_pod = str(d.get("from_pod") or "")
        e.epoch = int(d.get("epoch", 0))
        e.status = str(d.get("status", "accepted"))
        e.migrate_to = str(d.get("migrate_to") or "")
        e.deadline_s = d.get("deadline_s")
        e.eta_trials = d.get("eta_trials")
        e.result = d.get("result")
        e.history = list(d.get("history") or [])
        e.shard_of = str(d.get("shard_of") or "")
        e.shard_index = int(d.get("shard_index", -1))
        e.shards = list(d.get("shards") or [])
        e.fold_shards = dict(d.get("fold_shards") or {})
        e.fold_merged = dict(d.get("fold_merged") or {})
        e.fold_seq = int(d.get("fold_seq", 0))
        e.converged = bool(d.get("converged", False))
        return e


class Gateway:
    """The crash-safe routing tier (see module doc).

    ``pods`` maps pod name → ``PodPort`` (or anything with
    ``.spool``/``.outdir``); the gateway only ever touches a pod
    through its spool and its published durable surfaces, so the same
    gateway code serves in-process pods and separate server
    processes."""

    def __init__(self, outdir: str, pods: dict | None = None,
                 spool: SubmissionQueue | None = None,
                 compact_every: int = 64):
        self.outdir = outdir
        self.pods: dict[str, PodPort] = {}
        for name, p in (pods or {}).items():
            self.pods[name] = (p if isinstance(p, PodPort)
                               else PodPort(name, p.spool_dir, p.outdir)
                               if hasattr(p, "spool_dir")
                               else PodPort(name, p.spool, p.outdir))
        self.spool = spool if spool is not None else SubmissionQueue(
            os.path.join(outdir, "spool"))
        self.compact_every = max(1, int(compact_every))
        self.entries: dict[str, RouteEntry] = {}
        self.dead_pods: set[str] = set()
        # --- the elastic pool ledger (autoscaling) ---
        # every pool transition is journaled BEFORE any pod is touched
        # (pool_scale_up / pool_retire_begin / pool_retire_done), so the
        # pool membership below is pure WAL-derived state: recovery
        # replays it, the obs gauges read it, and nothing else may be a
        # second source of truth for what pods exist
        self.retiring: set[str] = set()      # retire begun, not done
        self.scale_seq = 0                   # journaled scale ordinal
        self.scaled_pods: dict[str, int] = {}  # autoscaled pod -> ordinal
        self.retires: dict[str, dict] = {}   # pod -> retire bookkeeping
        self.recoveries = 0
        self.journal_torn = 0
        self._journal: FleetJournal | None = None
        self._journal_floor = 0

    # --- the write-ahead routing ledger -----------------------------------

    def _open_journal(self) -> FleetJournal:
        if self._journal is None:
            floor = self._journal_floor
            if floor == 0:
                try:
                    snap = resil.load_json_verified(
                        gateway_snap_path(self.outdir))
                    floor = int(snap.get("journal_seq", -1)) + 1
                except (OSError, ValueError):
                    pass
            self._journal = FleetJournal(
                gateway_journal_path(self.outdir), next_seq=floor)
            self._journal.append("gw_config", {
                "pods": sorted(self.pods),
                "compact_every": self.compact_every})
        return self._journal

    def _jlog(self, kind: str, data: dict | None = None) -> None:
        """Durably journal one routing transition BEFORE the in-memory
        ledgers are trusted — the same WAL contract the pod schedulers
        carry (GL201-certified): a hard kill can interrupt the gateway
        between any two instructions and replay reconstructs the exact
        decision state."""
        self._open_journal().append(kind, data)

    def _maybe_compact(self) -> None:
        j = self._journal
        if j is not None and j.since_compact >= self.compact_every:
            self.checkpoint()

    # --- load / routing policy --------------------------------------------

    def live_pods(self) -> list[str]:
        """Pods eligible to receive placements.  A RETIRING pod is
        fenced out the instant ``pool_retire_begin`` lands — it may
        keep beating while it drains (a hung retire may beat for a long
        time), but no placement decision can ever choose it again: the
        journaled retire IS the fence, not the lease."""
        return [n for n in sorted(self.pods)
                if n not in self.dead_pods and n not in self.retiring]

    def pod_load(self, name: str) -> dict:
        """One pod's live load, read from its published ``metrics.json``
        (never its internals): the ETA mass it is carrying
        (``eta_trials`` summed over non-terminal tenants — convergence
        distance, not instantaneous throughput), its serving rate, and
        the backlog the gateway has placed but the pod has not yet
        surfaced in metrics."""
        port = self.pods[name]
        load = {"pod": name, "eta_trials": 0.0, "trials_per_s": 0.0,
                "tenants": 0, "backlog_trials": 0.0,
                "dead": name in self.dead_pods}
        try:
            from shrewd_tpu_torch.obs import metrics as obs_metrics

            snap = obs_metrics.read(port.outdir)
        except (OSError, ValueError):
            snap = {}
        seen = set()
        for tname, row in (snap.get("tenants") or {}).items():
            seen.add(tname)
            if row.get("status") in ("queued", "running"):
                load["tenants"] += 1
                load["eta_trials"] += float(row.get("eta_trials") or 0.0)
                load["trials_per_s"] += float(row.get("trials_per_s")
                                              or 0.0)
        for e in self.entries.values():
            if e.pod == name and e.status in ("routed", "placed") \
                    and e.spec.name not in seen:
                load["backlog_trials"] += est_trials(e.spec)
        load["score"] = load["eta_trials"] + load["backlog_trials"]
        return load

    def pod_loads(self) -> dict:
        return {n: self.pod_load(n) for n in sorted(self.pods)}

    def _rate(self, loads: dict) -> float:
        """Observed serving rate for deadline projection: the mean
        per-pod trials/s where data exists (0.0 = no data yet — the
        estimate is withheld rather than invented).  LIVE pods only: a
        dead pod's frozen metrics would keep inflating the projection
        and report feasible SLOs the survivors cannot meet."""
        rates = [ld["trials_per_s"] for ld in loads.values()
                 if ld["trials_per_s"] > 0 and not ld["dead"]]
        return sum(rates) / len(rates) if rates else 0.0

    def _pick_pod(self, exclude=(), loads: dict | None = None,
                  avoid=()) -> str:
        """The routing decision: the live pod carrying the least ETA
        mass (score = published ETA + unplaced backlog), ties broken by
        name — reproducible given the same published metrics.
        ``loads`` lets a caller that already read the pods' metrics
        reuse them (one read per placement, not one per question).
        ``avoid`` is a SOFT preference (``exclude`` is hard): candidates
        outside it win when any exist, but when every live pod is
        avoided the pick falls back to the full set — liveness over
        spread."""
        cands = [n for n in self.live_pods() if n not in exclude]
        if not cands:
            raise RuntimeError("no live pod to route to")
        preferred = [n for n in cands if n not in avoid] or cands
        if loads is None:
            loads = {n: self.pod_load(n) for n in cands}
        return min(preferred, key=lambda n: (loads[n]["score"], n))

    def _migration_target(self, e: RouteEntry) -> str:
        """Where a drained tenant goes: the journaled ``migrate``
        target while that pod is still alive, else a fresh pick — the
        target's lease may have expired between the migrate decision
        and the source drain completing, and a placement on a dead pod
        would strand the tenant forever."""
        if e.migrate_to and e.migrate_to in self.pods \
                and e.migrate_to not in self.dead_pods \
                and e.migrate_to not in self.retiring:
            return e.migrate_to
        return self._pick_pod(exclude=(e.pod,))

    # --- admission --------------------------------------------------------

    def admit(self, spec: TenantSpec, ticket: str = "") -> dict:
        """Accept one tenant, decide its pod, hand it off.  Returns the
        admission doc: placement, the deadline estimate (projected
        seconds to convergence on the chosen pod, from the ETA mass
        ahead of it and the observed serving rate), and whether the
        spec's SLO looks feasible against it."""
        if spec.name in self.entries:
            raise ValueError(f"tenant {spec.name!r} already admitted")
        if spec.shards > 1:
            # collision check BEFORE the accept record becomes durable:
            # a refused admission must leave no zombie ledger entry
            for nm in self._shard_names(spec):
                if nm in self.entries:
                    raise ValueError(
                        f"tenant {spec.name!r}: sub-tenant name {nm!r} "
                        "already admitted")
        e = RouteEntry(spec, order=len(self.entries), ticket=ticket)
        self._jlog("accept", {"tenant": spec.name,
                              "spec": spec.to_dict(), "ticket": ticket,
                              "order": e.order})
        self.entries[spec.name] = e
        obs_trace.tracer().emit(
            "gw_accept", cat="federation", tenant=spec.name,
            order=e.order, slo_s=spec.slo_s)
        if spec.shards > 1:
            self._shard_split(e)
            self._maybe_compact()
            kids = [self.entries[n] for n in e.shards]
            dls = [c.deadline_s for c in kids if c.deadline_s is not None]
            # the sharded campaign finishes when its LAST shard does;
            # each shard's deadline already reflects only its slice of
            # the batch space (est_trials on the scaled sub-plan), so
            # the max is the N-way-parallel finish estimate — not the
            # solo trajectory overstated by N
            deadline = max(dls) if dls and len(dls) == len(kids) else None
            doc = {"tenant": spec.name, "pod": "", "ticket": "",
                   "shards": list(e.shards), "deadline_s": deadline,
                   "eta_trials": sum(c.eta_trials or 0.0 for c in kids),
                   "slo_s": spec.slo_s}
            doc["slo_ok"] = (None if not spec.slo_s or deadline is None
                             else deadline <= spec.slo_s)
            return doc
        loads = self.pod_loads()
        pod = self._pick_pod(loads=loads)
        self._route_to(e, pod, reason="admit", loads=loads)
        self._maybe_compact()
        doc = {"tenant": spec.name, "pod": e.pod,
               "ticket": e.pod_ticket, "deadline_s": e.deadline_s,
               "eta_trials": e.eta_trials, "slo_s": spec.slo_s}
        doc["slo_ok"] = (None if not spec.slo_s or e.deadline_s is None
                         else e.deadline_s <= spec.slo_s)
        return doc

    def poll_spool(self) -> int:
        """Claim pending gateway-spool submissions into admission (the
        service front: ``tools/federation.py --submit`` and the HTTP
        front both land here)."""
        n = 0
        for ticket, spec in self.spool.claim():
            try:
                self.admit(spec, ticket=ticket)
                n += 1
            except ValueError as e:
                debug.dprintf("Federation", "refused %s: %s", ticket, e)
                self.spool.mark_done(ticket, {
                    "tenant": spec.name, "status": "refused",
                    "error": str(e)})
        return n

    # --- placement (the two-phase handoff) --------------------------------

    def _route_to(self, e: RouteEntry, pod: str, reason: str,
                  from_pod: str = "", loads: dict | None = None) -> None:
        """Journal the route DECISION, then perform the handoff.  The
        decision record carries everything replay needs to finish the
        placement without re-deciding (pod, epoch, migration source);
        the deadline estimate rides along as observability."""
        if loads is None:
            loads = self.pod_loads()
        rate = self._rate(loads)
        ahead = loads[pod]["score"]
        eta = ahead + est_trials(e.spec)
        deadline = round(eta / rate, 2) if rate > 0 else None
        epoch = e.epoch + 1
        self._jlog("route", {"tenant": e.spec.name, "pod": pod,
                             "epoch": epoch, "reason": reason,
                             "from": from_pod,
                             "eta_trials": round(eta, 1),
                             "deadline_s": deadline})
        e.pod = pod
        e.from_pod = from_pod
        e.epoch = epoch
        e.status = "routed"
        e.migrate_to = ""
        e.eta_trials = round(eta, 1)
        e.deadline_s = deadline
        e.history.append({"pod": pod, "reason": reason, "epoch": epoch})
        obs_trace.tracer().emit(
            "gw_route", cat="federation", tenant=e.spec.name, pod=pod,
            reason=reason, epoch=epoch)
        debug.dprintf("Federation", "%s -> %s (%s, epoch %d, eta %.0f "
                      "trials)", e.spec.name, pod, reason, epoch, eta)
        self._place(e)

    def _place(self, e: RouteEntry) -> None:
        """The handoff: migrate the checkpoint (durable BEFORE the pod
        can be told to resume from it), submit the spec into the
        decided pod's spool, journal the ``place`` commitment.  A kill
        before the submit replays the route and re-submits; a kill
        after it finds the ticket by scan and repairs the record —
        either way the tenant lands on exactly one pod."""
        port = self.pods[e.pod]
        if e.from_pod and e.from_pod in self.pods:
            copy_tenant_checkpoint(self.pods[e.from_pod].outdir,
                                   port.outdir, e.spec.name)
        ticket = SubmissionQueue(port.spool).submit(e.spec)
        self._jlog("place", {"tenant": e.spec.name, "pod": e.pod,
                             "ticket": ticket, "epoch": e.epoch})
        e.pod_ticket = ticket
        e.status = "placed"
        obs_trace.tracer().emit(
            "gw_place", cat="federation", tenant=e.spec.name,
            pod=e.pod, ticket=ticket)

    # --- results / completion ---------------------------------------------

    def _mark_done(self, e: RouteEntry, doc: dict) -> None:
        self._jlog("done", {"tenant": e.spec.name, "pod": e.pod,
                            "epoch": e.epoch, "result": dict(doc)})
        e.result = dict(doc)
        e.status = "done"
        obs_trace.tracer().emit(
            "gw_done", cat="federation", tenant=e.spec.name, pod=e.pod,
            status=str(doc.get("status")))
        if e.ticket:
            self.spool.mark_done(e.ticket, {
                "tenant": e.spec.name, "pod": e.pod,
                "status": doc.get("status"), "rc": doc.get("rc"),
                "trials": doc.get("trials"),
                "results": doc.get("results")})
        debug.dprintf("Federation", "%s done on %s (%s)", e.spec.name,
                      e.pod, doc.get("status"))

    def _pod_done_doc(self, pod: str, e: RouteEntry) -> dict | None:
        if not e.pod_ticket:
            return None
        return SubmissionQueue(self.pods[pod].spool).done(e.pod_ticket)

    def poll(self) -> None:
        """Learn completions and advance in-flight migrations from the
        pods' published done-docs — the gateway's only result channel,
        so it works identically for in-process and subprocess pods."""
        for e in self.entries.values():
            if e.status not in ("placed", "draining") \
                    or e.pod not in self.pods:
                continue         # unknown pods are the failover pass's job
            doc = self._pod_done_doc(e.pod, e)
            if doc is None:
                continue
            status = doc.get("status")
            if status == "evicted":
                # the eviction this gateway requested (migration) — or
                # a fencing eviction replayed late; either way the
                # checkpoint is free to move now.  (A campaign that
                # finished before the drain landed publishes its real
                # terminal doc instead: nothing left to migrate.)
                self._route_to(e, self._migration_target(e),
                               reason="migrate", from_pod=e.pod)
            elif status == "refused":
                # the pod could not serve this placement — e.g. a
                # healed partition's stale TERMINAL copy of the name
                # still holds its roster slot.  A refusal carries no
                # results, so it must never be adopted as the final
                # doc: place elsewhere (the checkpoint the last drain
                # left makes the move free, and bit-identity makes a
                # staler checkpoint merely recompute, never diverge)
                self._route_to(e, self._pick_pod(exclude=(e.pod,)),
                               reason="refused", from_pod=e.from_pod)
            else:
                self._mark_done(e, doc)
        for e in list(self.entries.values()):
            if e.status == "sharded":
                self._advance_shards(e)
        self._maybe_compact()

    # --- single-campaign sharding (the merge fold) --------------------------
    #
    # One tenant with ``shards: N`` splits into N journaled sub-tenants,
    # each serving the round-robin stripe {i, i+N, ...} of the parent's
    # frozen batch-id space (plan.shard_index/shard_count — the
    # orchestrator re-dispatches on the same frozen per-batch PRNG
    # keys).  The gateway folds the shards' per-stratum tallies with an
    # ORDER-FIXED merge (ascending shard index — the psum-vs-shard
    # invariant integrity.py checks per batch, lifted one level), so
    # the merged trajectory is bit-identical to the solo run.  Every
    # fold transition is journaled BEFORE the merge ledger mutates
    # (shard_split / shard_fold / shard_converged — the same GL201 WAL
    # contract as routing), which is what makes a mid-merge pod kill
    # replayable from the gateway WAL: crashcheck sweeps every fold
    # boundary like every placement boundary.

    def _shard_names(self, spec: TenantSpec) -> list[str]:
        n, _ceiling, _bs = self._shard_geometry(spec)
        return [f"{spec.name}+shard{i}" for i in range(n)]

    def _shard_geometry(self, spec: TenantSpec) -> tuple[int, int, int]:
        """(effective shard count, parent ceiling batches, batch size):
        the shard count is clamped to the parent's batch ceiling — a
        stripe with no batch ids would be a zero-work sub-tenant."""
        plan = spec.plan or {}
        bs = int(plan.get("batch_size") or 4096)
        ceiling = max(1, -(-int(est_trials(spec)) // bs))
        return min(int(spec.shards), ceiling), ceiling, bs

    def _shard_specs(self, spec: TenantSpec) -> list[TenantSpec]:
        """Derive the sub-tenant specs: shard i of N gets the stripe
        {i, i+N, ...} below the parent ceiling, and its plan's
        min/max_trials are BOTH set to the stripe's trial budget — a
        shard must never self-converge early (the stopping rule runs on
        the MERGED trajectory at the gateway), and its published ETA /
        admission deadline then reflect exactly its share of the
        remaining batch space instead of overstating the sharded
        campaign's finish time by N×."""
        n, ceiling, bs = self._shard_geometry(spec)
        quota = int(spec.quota_batches or 0)
        out = []
        for i in range(n):
            p = dict(spec.plan)
            p["shard_index"] = i
            p["shard_count"] = n
            slice_batches = (ceiling - i + n - 1) // n
            p["max_trials"] = p["min_trials"] = slice_batches * bs
            out.append(TenantSpec(
                name=f"{spec.name}+shard{i}", plan=p,
                priority=spec.priority, weight=spec.weight,
                quota_batches=((quota - i + n - 1) // n if quota else 0),
                submitted_at=spec.submitted_at, slo_s=0.0, shards=1))
        return out

    def _shard_split(self, e: RouteEntry) -> None:
        """Journal the split decision, then create + place the
        sub-tenants.  The record carries the full child specs so replay
        reconstructs the exact same stripes without re-deriving
        anything; placement itself goes through the ordinary journaled
        route→handoff→place protocol per child."""
        specs = self._shard_specs(e.spec)
        names = [s.name for s in specs]
        self._jlog("shard_split", {"tenant": e.spec.name,
                                   "shards": names,
                                   "specs": [s.to_dict() for s in specs]})
        e.status = "sharded"
        e.shards = names
        for i, s in enumerate(specs):
            if s.name in self.entries:
                continue             # replayed split already built it
            c = RouteEntry(s, order=len(self.entries))
            c.shard_of = e.spec.name
            c.shard_index = i
            self.entries[s.name] = c
        obs_trace.tracer().emit(
            "gw_shard_split", cat="federation", tenant=e.spec.name,
            shards=len(names))
        debug.dprintf("Federation", "%s split into %d shards",
                      e.spec.name, len(names))
        self._place_shards(e)

    def _place_shards(self, e: RouteEntry) -> int:
        """Place every still-queued sub-tenant on a live pod hosting no
        LIVE sibling (distinct pods — the point of sharding is stripe
        parallelism).  With more shards than free pods the surplus
        stays queued at the gateway ("accepted", no pod) and lands here
        again when a sibling finishes — admission never fails on
        shards > pods.  Failover is deliberately NOT held to the
        distinct-pod rule (liveness over spread): only this initial/
        backfill placement is."""
        placed = 0
        kids = [self.entries[n] for n in e.shards if n in self.entries]
        for c in kids:
            if c.status != "accepted":
                continue
            busy = {k.pod for k in kids
                    if k is not c and k.pod
                    and k.status in ("routed", "placed", "draining")}
            cands = [p for p in self.live_pods() if p not in busy]
            if not cands:
                continue
            loads = self.pod_loads()
            pod = min(cands, key=lambda n: (loads[n]["score"], n))
            self._route_to(c, pod, reason="shard", loads=loads)
            placed += 1
        return placed

    def _shard_report(self, c: RouteEntry, last: dict | None) -> dict:
        """One sub-tenant's freshest per-lane cumulative counts: the
        final done-doc when terminal (authoritative), else the hosting
        pod's published metrics row (``lanes`` — the same live numbers
        the pod's own stopping rule reads).  Monotone against the last
        folded report: a shard recovered from pod death resumes from
        its last checkpoint, which may trail its last published
        metrics — the fold keeps the deeper prefix (any cumulative
        snapshot of a frozen-key stripe is exact; deeper is simply
        closer to done)."""
        def total(lanes: dict) -> int:
            return sum(int(v.get("trials") or 0) for v in lanes.values())

        if c.result is not None:
            res = c.result.get("results") or {}
            lanes = {lane: {"tallies": row["tallies"],
                            "trials": row["trials"],
                            "strata": row.get("strata")}
                     for lane, row in res.items()}
            if lanes or not last:
                return lanes
            return dict(last)
        row = None
        if c.pod and c.pod in self.pods:
            try:
                from shrewd_tpu_torch.obs import metrics as obs_metrics

                snap = obs_metrics.read(self.pods[c.pod].outdir)
                row = (snap.get("tenants") or {}).get(c.spec.name)
            except (OSError, ValueError):
                row = None
        lanes = dict((row or {}).get("lanes") or {})
        if last and total(last) > total(lanes):
            return dict(last)
        return lanes

    def _merged_fold(self, e: RouteEntry, lanes_by_shard: dict) -> dict:
        """The order-fixed merge + merged stopping evaluation, with the
        PARENT plan's precision target (``stopping.merged_fold`` — the
        same rule selection the solo campaign's convergence check
        applies; float64 on the host, whatever device the pods ran on)."""
        from shrewd_tpu_torch.parallel import stopping

        plan = e.spec.plan or {}
        return stopping.merged_fold(
            lanes_by_shard, bool(plan.get("stratify")),
            float(plan.get("confidence") or 0.95),
            float(plan.get("target_halfwidth") or 0.01),
            int(plan.get("min_trials") or 0))

    def _expected_lanes(self, plan: dict) -> int:
        """Lane count of the merged campaign (simpoints × per-simpoint
        structures + plan-level coherence tiers) — the merged stopping
        rule may only revoke shard quota once EVERY lane's merged CI is
        tight, so a lane no shard has started yet must block
        convergence, not be invisible to it."""
        sps = len(plan.get("simpoints") or [])
        per_sp = [s for s in plan.get("structures") or []
                  if s.split(":", 1)[0] not in ("mesi", "noc")]
        plan_level = [s for s in plan.get("structures") or []
                      if s.split(":", 1)[0] in ("mesi", "noc")]
        return sps * len(per_sp) + len(plan_level)

    def _advance_shards(self, e: RouteEntry) -> None:
        """One merge-fold pass for one sharded parent: backfill queued
        shards, fold the freshest per-shard cumulative tallies
        (journaled BEFORE the merge ledger mutates), evaluate the
        merged stopping rule, and finalize the parent when every shard
        is terminal.  Idempotent per poll — a fold with no new trials
        journals nothing."""
        if e.status != "sharded":
            return
        self._place_shards(e)
        kids = [self.entries[n] for n in e.shards if n in self.entries]
        reports = {c.spec.name: self._shard_report(
            c, e.fold_shards.get(c.spec.name)) for c in kids}
        merged = self._merged_fold(
            e, {c.shard_index: reports[c.spec.name] for c in kids})
        prev = sum(int(m.get("trials") or 0)
                   for m in e.fold_merged.values())
        cur = sum(int(m.get("trials") or 0) for m in merged.values())
        if cur > prev or e.fold_seq == 0:
            self._jlog("shard_fold", {"tenant": e.spec.name,
                                      "fold": e.fold_seq + 1,
                                      "shards": reports,
                                      "merged": merged})
            e.fold_shards = reports
            e.fold_merged = merged
            e.fold_seq += 1
            obs_trace.tracer().emit(
                "gw_shard_fold", cat="federation", tenant=e.spec.name,
                fold=e.fold_seq, trials=cur)
            debug.dprintf("Federation", "%s fold %d: %d merged trials",
                          e.spec.name, e.fold_seq, cur)
        if not e.converged:
            m = e.fold_merged
            if m and len(m) >= self._expected_lanes(e.spec.plan or {}) \
                    and all(v.get("converged") for v in m.values()):
                # the merged trajectory satisfies the until-CI stopping
                # rule on every lane: journal the verdict, then revoke
                # what remains.  Late-arriving shard trials past this
                # fold stay honest — they are valid frozen-key trials
                # the final merge simply includes, exactly like the
                # pipelined engine's honest late stop.
                self._jlog("shard_converged", {"tenant": e.spec.name,
                                               "fold": e.fold_seq})
                e.converged = True
                obs_trace.tracer().emit(
                    "gw_shard_converged", cat="federation",
                    tenant=e.spec.name, fold=e.fold_seq, trials=cur)
                debug.dprintf("Federation",
                              "%s converged at fold %d (%d trials)",
                              e.spec.name, e.fold_seq, cur)
        if e.converged:
            for c in kids:
                if c.status == "accepted":
                    # a queued surplus shard never reached any pod: its
                    # revocation is a pure gateway decision
                    self._mark_done(c, {
                        "tenant": c.spec.name, "status": "pruned",
                        "rc": 4, "trials": 0, "batches": 0,
                        "results": {}, "reason": "shard-converged"})
        if kids and all(c.status in TERMINAL for c in kids):
            self._finalize_shards(e, kids)

    def shard_revocations(self) -> list[tuple[str, str]]:
        """[(sub-tenant, pod)] whose remaining quota must be revoked on
        the hosting pod — the merged trajectory converged.  The driver
        executes these through the pods' journaled ``revoke_quota``
        seam; the list is re-derived from the ledger every poll, so a
        crash between the verdict and any revocation replays to the
        same pending set (pod-side revoke_quota is idempotent)."""
        out = []
        for e in self.entries.values():
            if e.status != "sharded" or not e.converged:
                continue
            for n in e.shards:
                c = self.entries.get(n)
                if c is not None and c.status in ("routed", "placed") \
                        and c.pod and c.pod not in self.dead_pods:
                    out.append((n, c.pod))
        return out

    @property
    def folds(self) -> int:
        """Total shard_fold records across every sharded tenant — the
        deterministic merge-progress ordinal chaos triggers key on
        (``partition_during_merge``'s ``at_fold``)."""
        return sum(e.fold_seq for e in self.entries.values())

    def _finalize_shards(self, e: RouteEntry, kids: list) -> None:
        """Every shard terminal: build the parent's merged done-doc
        from each shard's DEEPEST exact evidence — its final done-doc
        or, when deeper, its last journaled fold (order-fixed merge of
        complete runs and revocation-pruned partials — both
        first-class: a pruned shard's tallies are exact cumulative
        counts over its consumed stripe prefix) and mark the parent
        done through the ordinary journaled completion path.  The fold
        ledger can legitimately be AHEAD of a shard's final result: a
        crash after a ``shard_fold`` record became durable rolls the
        pod back to older checkpoints, and the replayed convergence
        verdict then prunes the resumed shard before it recomputes
        trials the WAL already folded — the journaled fold is exact
        durable evidence of that deeper prefix, so the final merge
        keeps it (bit-identity to the undisturbed run is exactly this
        monotone rule, the one ``_shard_report`` applies live)."""
        def total(lanes: dict) -> int:
            return sum(int(v.get("trials") or 0) for v in lanes.values())

        lanes_by_shard = {}
        for c in kids:
            res = (c.result or {}).get("results") or {}
            lanes = {lane: {"tallies": row["tallies"],
                            "trials": row["trials"],
                            "strata": row.get("strata")}
                     for lane, row in res.items()}
            last = e.fold_shards.get(c.spec.name)
            if last and total(last) > total(lanes):
                lanes = dict(last)
            lanes_by_shard[c.shard_index] = lanes
        merged = self._merged_fold(e, lanes_by_shard)
        results = {lane: {"tallies": m["tallies"], "trials": m["trials"],
                          "avf": m["avf"], "converged": m["converged"],
                          "strata": m["strata"]}
                   for lane, m in merged.items()}
        bad = [c for c in kids if (c.result or {}).get("status")
               not in ("complete", "pruned")]
        doc = {
            "tenant": e.spec.name,
            "status": ("complete" if not bad
                       else str((bad[0].result or {}).get("status"))),
            "rc": (0 if not bad else (bad[0].result or {}).get("rc")),
            "trials": sum(int(m["trials"]) for m in merged.values()),
            "batches": sum(int((c.result or {}).get("batches") or 0)
                           for c in kids),
            "wall_s": max([float((c.result or {}).get("wall_s") or 0.0)
                           for c in kids] or [0.0]),
            "results": results,
            "shards": {c.spec.name: {
                "status": (c.result or {}).get("status"),
                "trials": (c.result or {}).get("trials"),
                "pod": c.pod} for c in kids},
            "folds": e.fold_seq,
            "converged": e.converged,
        }
        self._mark_done(e, doc)

    # --- migration / failover ----------------------------------------------

    def migrate(self, tenant: str, to_pod: str, reason: str = "") -> bool:
        """Begin a live rebalancing migration: journal the intent, mark
        the entry draining.  The caller (the federation driver) evicts
        the tenant on the source pod; ``poll()`` completes the move
        when the source publishes the eviction done-doc.  Returns False
        when the tenant is not currently placed."""
        e = self.entries.get(tenant)
        if e is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        if e.status != "placed" or to_pod not in self.pods \
                or to_pod in self.dead_pods or to_pod in self.retiring \
                or to_pod == e.pod:
            return False
        self._jlog("migrate", {"tenant": tenant, "from": e.pod,
                               "to": to_pod,
                               "reason": reason or "rebalance"})
        e.migrate_to = to_pod
        e.status = "draining"
        obs_trace.tracer().emit(
            "gw_migrate", cat="federation", tenant=tenant,
            src=e.pod, dst=to_pod, reason=reason or "rebalance")
        debug.dprintf("Federation", "migrating %s: %s -> %s (%s)",
                      tenant, e.pod, to_pod, reason or "rebalance")
        return True

    def pod_dead(self, pod: str) -> list[str]:
        """The supervisor's verdict: the pod's lease expired.  Journal
        the death, then fail every stranded tenant over to a surviving
        pod from its namespaced checkpoint (tenants that already
        published a final done-doc keep their result — the dead pod's
        spool is durable state, not a liveness surface).  Returns the
        tenants that moved."""
        if pod in self.dead_pods or pod not in self.pods:
            return []
        self._jlog("pod_dead", {"pod": pod})
        self.dead_pods.add(pod)
        obs_trace.tracer().emit("gw_pod_dead", cat="federation", pod=pod)
        debug.dprintf("Federation", "pod %s declared dead", pod)
        return self._failover_stranded()

    def _failover_stranded(self) -> list[str]:
        """Re-place every non-terminal tenant whose pod is dead — or
        UNKNOWN: a recovery with a smaller pod set than the snapshot's
        (``--recover --pods N``) must fail the orphans over, not crash
        on them.  Called on a death verdict AND from recovery repair (a
        crash mid-failover leaves stranded entries; this pass is
        idempotent)."""
        moved = []
        for e in self.entries.values():
            stranded = e.pod in self.dead_pods \
                or (e.pod and e.pod not in self.pods)
            if e.status in TERMINAL or not stranded:
                continue
            if e.status in ("placed", "draining") and e.pod in self.pods:
                doc = self._pod_done_doc(e.pod, e)
                if doc is not None and doc.get("status") != "evicted":
                    # completed before the death: the result is durable
                    # in the dead pod's spool — adopt it, don't recompute
                    self._mark_done(e, doc)
                    continue
            # loads re-read per tenant ON PURPOSE: each placement adds
            # backlog to its target, so stranded tenants spread across
            # survivors instead of piling onto one snapshot's minimum
            loads = self.pod_loads()
            target = self._pick_pod(exclude=(e.pod,), loads=loads,
                                    avoid=self._sibling_pods(e))
            self._route_to(e, target, reason="failover",
                           from_pod=e.pod, loads=loads)
            moved.append(e.spec.name)
        return moved

    def _sibling_pods(self, e: RouteEntry) -> set[str]:
        """Pods already hosting a LIVE sibling shard of this entry's
        parent (empty for unsharded tenants): the stripe-aware failover
        preference.  Initial shard placement enforces distinct pods
        hard; failover only PREFERS them (soft ``avoid``) — a shard
        must land somewhere even when every survivor hosts a sibling."""
        if not e.shard_of:
            return set()
        parent = self.entries.get(e.shard_of)
        if parent is None:
            return set()
        return {c.pod for n in parent.shards
                if n != e.spec.name
                and (c := self.entries.get(n)) is not None
                and c.pod
                and c.status in ("routed", "placed", "draining")}

    def pod_heal(self, pod: str) -> list[str]:
        """A dead-declared pod resumed beating (a partition healed, not
        a death).  Journal the heal and return the tenants the healed
        pod may still be serving STALELY (failed over meanwhile): the
        driver fences those — evicts them on the healed pod — and the
        authoritative placement in this ledger guarantees each tenant
        is counted exactly once no matter what the stale pod computed
        (its copy's tallies are bit-identical anyway; only the ledger
        decides who reports)."""
        if pod not in self.dead_pods:
            return []
        self._jlog("pod_heal", {"pod": pod})
        self.dead_pods.discard(pod)
        obs_trace.tracer().emit("gw_pod_heal", cat="federation", pod=pod)
        debug.dprintf("Federation", "pod %s healed", pod)
        stale = []
        for e in self.entries.values():
            if e.pod != pod and any(h["pod"] == pod
                                    for h in e.history):
                stale.append(e.spec.name)
        return stale

    # --- the elastic pool (autoscaling transitions) -------------------------
    #
    # The gateway's pool membership is itself WAL state: an autoscaler
    # (federation/autoscale.py) DECIDES scale events, but the decision
    # only exists once its record is durable — ``pool_scale_up`` before
    # any pod directory is touched, ``pool_retire_begin`` before any
    # tenant is drained, ``pool_retire_done`` after the last one left.
    # Retirement rides the ordinary drain-here/recover-there migration
    # path (the federation driver migrates every non-terminal tenant off
    # the fenced pod), and a hung retire is safe because the fence is
    # the journaled record, not the pod's cooperation: ``live_pods``
    # excludes retiring pods, so a retiring pod that beats one last time
    # can never be re-placed onto, and lease expiry (``pod_dead``) moves
    # its tenants if it dies mid-drain.  Recovery replays the pool
    # ledger like every routing decision — the driver reconciles pod
    # processes to it, never the other way around.

    def _pool_port(self, name: str) -> PodPort:
        """The canonical pod layout for an autoscaled pod — derived
        from the federation root (the gateway outdir's parent), never
        journaled as an absolute path: pool records must replay after
        the whole tree is relocated (crashcheck copies snapshots into
        scratch roots)."""
        root = os.path.join(os.path.dirname(self.outdir), "pods", name)
        return PodPort(name, os.path.join(root, "spool"),
                       os.path.join(root, "out"))

    def pool_scale_up(self, reason: str = "", pressure: dict | None = None,
                      round: int | None = None) -> str:
        """Journal one scale-up decision and add the new pod to the
        pool.  The pod's name derives from the scale ordinal
        (``auto<n>`` — never reused), its layout from ``_pool_port``;
        the record carries the pressure evidence so every autoscaling
        decision is auditable from the WAL alone.  Returns the new pod
        name; the driver spawns the actual ``PodHandle`` by reconciling
        against the ledger."""
        scale = self.scale_seq + 1
        name = f"auto{scale}"
        if name in self.pods:
            raise ValueError(f"pool pod {name!r} already exists")
        self._jlog("pool_scale_up", {"pod": name, "scale": scale,
                                     "reason": reason,
                                     "pressure": dict(pressure or {}),
                                     "round": round})
        self.scale_seq = scale
        self.scaled_pods[name] = scale
        self.pods[name] = self._pool_port(name)
        obs_trace.tracer().emit(
            "gw_pool_scale_up", cat="federation", pod=name, scale=scale,
            reason=reason)
        debug.dprintf("Federation", "pool scale-up -> %s (scale=%d, %s)",
                      name, scale, reason)
        self._maybe_compact()
        return name

    def pool_retire_begin(self, pod: str, reason: str = "",
                          round: int | None = None) -> int:
        """Journal one retire decision and fence the pod out of every
        future placement.  The pod keeps serving what it already holds;
        the driver drains it through the journaled migration path and
        calls ``pool_retire_done`` when nothing non-terminal remains.
        Returns the retire's scale ordinal (the chaos trigger
        coordinate for ``kill_during_retire``)."""
        if pod not in self.pods or pod in self.retiring:
            raise ValueError(f"pod {pod!r} not retirable")
        if not [n for n in self.live_pods() if n != pod]:
            raise RuntimeError(
                f"refusing to retire {pod!r}: no live pod would remain")
        scale = self.scale_seq + 1
        self._jlog("pool_retire_begin", {"pod": pod, "scale": scale,
                                         "reason": reason,
                                         "round": round})
        self.scale_seq = scale
        self.retiring.add(pod)
        self.retires[pod] = {"scale": scale, "begin_round": round,
                             "done_round": None}
        obs_trace.tracer().emit(
            "gw_pool_retire_begin", cat="federation", pod=pod,
            scale=scale, reason=reason)
        debug.dprintf("Federation", "pool retire begin: %s (scale=%d, %s)",
                      pod, scale, reason)
        return scale

    def pool_retire_done(self, pod: str, round: int | None = None) -> None:
        """Journal the retire's completion and drop the pod from the
        pool.  Idempotent (a replayed completion is a no-op); the pod's
        durable tree stays on disk — done-docs already adopted live in
        the routing ledger, and the tree is evidence, not state."""
        if pod not in self.retiring:
            return
        rec = self.retires.get(pod) or {}
        self._jlog("pool_retire_done", {"pod": pod,
                                        "scale": rec.get("scale"),
                                        "round": round})
        self.retiring.discard(pod)
        rec["done_round"] = round
        self.retires[pod] = rec
        self.pods.pop(pod, None)
        self.dead_pods.discard(pod)
        self.scaled_pods.pop(pod, None)
        obs_trace.tracer().emit(
            "gw_pool_retire_done", cat="federation", pod=pod,
            scale=rec.get("scale"))
        debug.dprintf("Federation", "pool retire done: %s", pod)
        self._maybe_compact()

    def pool_status(self) -> dict:
        """The pool ledger's observable view — pure WAL-derived state
        (the obs gauges and the HTTP front read THIS, never a second
        count of pod processes).  ``retire_drain_rounds`` is the
        per-pod drain duration in federation rounds (in-flight retires
        report their duration so far as None until done)."""
        drains = {}
        for pod, rec in sorted(self.retires.items()):
            b, d = rec.get("begin_round"), rec.get("done_round")
            drains[pod] = (d - b if d is not None and b is not None
                           else None)
        return {"size": len(self.pods),
                "live": len(self.live_pods()),
                "retiring": sorted(self.retiring),
                "pending_scale_decisions": len(self.retiring),
                "scale_seq": self.scale_seq,
                "scaled_pods": dict(self.scaled_pods),
                "retire_drain_rounds": drains}

    # --- aggregate results -------------------------------------------------

    def all_done(self) -> bool:
        return bool(self.entries) and all(
            e.status in TERMINAL for e in self.entries.values())

    def results(self) -> dict:
        return {n: e.result for n, e in self.entries.items()}

    def tenant_tallies(self, name: str) -> dict:
        """{(simpoint, structure): int64 tallies} for one tenant, from
        its AUTHORITATIVE placement's done-doc — the bit-identity
        surface the federation tests pin against solo runs.  Each
        tenant is counted exactly once, per the routing ledger."""
        e = self.entries[name]
        out = {}
        for key, row in ((e.result or {}).get("results") or {}).items():
            sp, st = key.split("/", 1)
            out[(sp, st)] = np.asarray(row["tallies"], dtype=np.int64)
        return out

    def status(self) -> dict:
        """JSON-able service status (the CLI/HTTP read surface)."""
        return {
            "pods": {n: {"dead": n in self.dead_pods,
                         **{k: v for k, v in self.pod_load(n).items()
                            if k != "pod"}}
                     for n in sorted(self.pods)},
            "tenants": {n: {"status": e.status, "pod": e.pod,
                            "epoch": e.epoch,
                            "deadline_s": e.deadline_s,
                            "slo_s": e.spec.slo_s,
                            "history": list(e.history)}
                        for n, e in sorted(self.entries.items())},
            "dead_pods": sorted(self.dead_pods),
            "pool": self.pool_status(),
            "recoveries": self.recoveries,
        }

    # --- persistence / recovery -------------------------------------------

    def checkpoint(self) -> str:
        """Snapshot the routing ledger (atomic, checksummed) and compact
        the WAL behind it — the scheduler's snapshot-first ordering:
        a crash between the two leaves seq-deduped duplicates, never a
        gap."""
        ckpt_dir = gateway_ckpt_dir(self.outdir)
        os.makedirs(ckpt_dir, exist_ok=True)
        doc = {"version": GATEWAY_CKPT_VERSION,
               "pods": sorted(self.pods),
               "dead_pods": sorted(self.dead_pods),
               "retiring": sorted(self.retiring),
               "scale_seq": self.scale_seq,
               "scaled_pods": dict(self.scaled_pods),
               "retires": {p: dict(rec)
                           for p, rec in self.retires.items()},
               "recoveries": self.recoveries,
               "compact_every": self.compact_every,
               "journal_seq": (self._journal.next_seq - 1
                               if self._journal is not None else
                               self._journal_floor - 1),
               "entries": [e.to_dict() for e in self.entries.values()]}
        doc["checksum"] = resil.doc_checksum(doc)
        resil.write_json_atomic(gateway_snap_path(self.outdir), doc)
        if self._journal is not None:
            self._journal.compact()
        return ckpt_dir

    def shutdown(self) -> None:
        self._jlog("gw_shutdown", {"statuses": self._by_status()})
        self.checkpoint()

    def _by_status(self) -> dict:
        out: dict[str, int] = {}
        for e in self.entries.values():
            out[e.status] = out.get(e.status, 0) + 1
        return out

    def _apply_record(self, r: dict) -> None:
        """Replay one journal record onto the routing ledger
        (idempotent: records carry absolute values)."""
        kind = r.get("kind")
        if kind in ("gw_config", "gw_shutdown", "gw_recover"):
            # lifecycle markers: nothing to restore, handled explicitly
            # so the GL202 exhaustiveness check proves every appended
            # kind has a considered replay story
            return
        if kind == "pod_dead":
            self.dead_pods.add(str(r.get("pod")))
            return
        if kind == "pod_heal":
            self.dead_pods.discard(str(r.get("pod")))
            return
        if kind == "pool_scale_up":
            name = str(r.get("pod"))
            self.scale_seq = max(self.scale_seq, int(r.get("scale", 0)))
            self.scaled_pods[name] = int(r.get("scale", 0))
            if name not in self.pods:
                # ports are re-derived from the relocatable layout, not
                # the record: the snapshot tree may have moved
                self.pods[name] = self._pool_port(name)
            return
        if kind == "pool_retire_begin":
            pod = str(r.get("pod"))
            self.scale_seq = max(self.scale_seq, int(r.get("scale", 0)))
            self.retiring.add(pod)
            self.retires[pod] = {"scale": int(r.get("scale", 0)),
                                 "begin_round": r.get("round"),
                                 "done_round": None}
            return
        if kind == "pool_retire_done":
            pod = str(r.get("pod"))
            self.retiring.discard(pod)
            rec = self.retires.setdefault(
                pod, {"scale": r.get("scale"), "begin_round": None})
            rec["done_round"] = r.get("round")
            self.pods.pop(pod, None)
            self.dead_pods.discard(pod)
            self.scaled_pods.pop(pod, None)
            return
        if kind == "accept":
            if r.get("tenant") not in self.entries:
                e = RouteEntry(TenantSpec.from_dict(r["spec"]),
                               order=int(r.get("order", 0)),
                               ticket=r.get("ticket", ""))
                self.entries[e.spec.name] = e
            return
        if kind == "shard_split":
            e = self.entries.get(r.get("tenant", ""))
            if e is not None:
                e.status = "sharded"
                e.shards = list(r.get("shards") or [])
            for i, sd in enumerate(r.get("specs") or []):
                if sd.get("name") in self.entries:
                    continue
                c = RouteEntry(TenantSpec.from_dict(sd),
                               order=len(self.entries))
                c.shard_of = str(r.get("tenant") or "")
                c.shard_index = i
                self.entries[c.spec.name] = c
            return
        e = self.entries.get(r.get("tenant", ""))
        if e is None:
            return
        if kind == "route":
            e.pod = str(r.get("pod"))
            e.from_pod = str(r.get("from") or "")
            e.epoch = int(r.get("epoch", e.epoch))
            e.status = "routed"
            e.migrate_to = ""
            e.eta_trials = r.get("eta_trials")
            e.deadline_s = r.get("deadline_s")
            e.history.append({"pod": e.pod,
                              "reason": str(r.get("reason") or "route"),
                              "epoch": e.epoch})
        elif kind == "place":
            e.pod_ticket = str(r.get("ticket") or "")
            e.status = "placed"
        elif kind == "migrate":
            e.migrate_to = str(r.get("to") or "")
            e.status = "draining"
        elif kind == "shard_fold":
            # the record IS the fold (journaled before the ledger
            # mutated): replay restores the exact merge trajectory,
            # which is what makes a mid-merge kill replayable
            e.fold_shards = dict(r.get("shards") or {})
            e.fold_merged = dict(r.get("merged") or {})
            e.fold_seq = int(r.get("fold", e.fold_seq + 1))
        elif kind == "shard_converged":
            e.converged = True
        elif kind == "done":
            e.result = r.get("result")
            e.status = "done"

    def _repair(self) -> None:
        """Post-replay repair: finish every placement the crash
        interrupted, WITHOUT re-deciding anything a journal record
        already decided.

        - ``accepted``: the route decision never became durable — make
          it now (a fresh decision is correct: none was ever made).
        - ``routed``: the decision is durable, the handoff uncertain —
          scan the DECIDED pod's spool; a found ticket means the
          handoff landed (repair the ``place`` record), absent means
          re-submit to the journaled pod.  Never a second pod.
        - stranded on a dead pod: re-run the failover pass (idempotent).
        - sharded parents: an ``accepted`` parent means the accept
          became durable but the split didn't — perform it now; queued
          sub-tenants are placed by the fold pass (the distinct-pod
          rule), never by the plain accepted clause.
        """
        for e in list(self.entries.values()):
            if e.status == "accepted":
                if e.spec.shards > 1:
                    self._shard_split(e)
                    continue
                if e.shard_of:
                    continue     # queued surplus shard: the fold pass
                self._route_to(e, self._pick_pod(), reason="admit")
            elif e.status == "routed" and e.pod in self.pods:
                # a decided pod no longer in the recovered pod set is
                # an orphan: the failover pass below re-places it
                hit = self._live_ticket(e)
                if hit is not None:
                    self._jlog("place", {"tenant": e.spec.name,
                                         "pod": e.pod,
                                         "ticket": hit,
                                         "epoch": e.epoch,
                                         "repaired": True})
                    e.pod_ticket = hit
                    e.status = "placed"
                else:
                    self._place(e)
        self._failover_stranded()
        for e in list(self.entries.values()):
            if e.status == "sharded":
                # finish any merge the crash interrupted (idempotent:
                # a fold with no new trials journals nothing, and an
                # already-journaled convergence only re-derives the
                # pending revocation set)
                self._advance_shards(e)

    def _live_ticket(self, e: RouteEntry) -> str | None:
        """The decided pod's LIVE ticket for this tenant, or None when
        the handoff must be (re-)performed.  A scan hit is live when it
        is still pending/claimed, or terminal with a REAL result — a
        returning migration leaves the earlier epoch's ticket behind in
        ``done/`` with status ``evicted`` (and ``bad/`` holds poisoned
        docs): adopting one of those as the placement would turn the
        repair into a spurious re-migration or a results-free final
        doc.  A terminal ``complete`` doc from an earlier epoch IS safe
        to adopt: frozen keys make any completed run of this tenant
        bit-identical."""
        port = self.pods[e.pod]
        hit = find_spool_ticket(port.spool, e.spec.name)
        if hit is None:
            return None
        sub, ticket = hit
        if sub in ("pending", "claimed"):
            return ticket
        if sub == "done":
            doc = SubmissionQueue(port.spool).done(ticket)
            if doc is not None and doc.get("status") not in ("evicted",
                                                            "refused"):
                return ticket
        return None

    @classmethod
    def recover(cls, outdir: str, pods: dict | None = None,
                **kw) -> "Gateway":
        """Rebuild the gateway after ANY shutdown — clean or hard kill —
        by replaying snapshot + journal, then repairing interrupted
        placements (see ``_repair``).  A fresh outdir recovers to an
        empty gateway: the restart path IS the cold-start path."""
        snap = None
        snap_path = gateway_snap_path(outdir)
        if os.path.exists(snap_path):
            snap = resil.load_json_verified(snap_path)
            if snap.get("version") != GATEWAY_CKPT_VERSION:
                raise ValueError(
                    f"gateway checkpoint version {snap.get('version')} "
                    f"!= {GATEWAY_CKPT_VERSION}")
        jpath = gateway_journal_path(outdir)
        records, torn, _valid = (FleetJournal.replay_path(jpath)
                                 if os.path.exists(jpath) else ([], 0, 0))
        snap_seq = int(snap.get("journal_seq", -1)) if snap else -1
        fresh = [r for r in records if int(r["seq"]) > snap_seq]
        dirty = any(r["kind"] != "gw_config" for r in fresh) or torn > 0
        gw = cls(outdir, pods=pods,
                 compact_every=kw.pop(
                     "compact_every",
                     snap.get("compact_every", 64) if snap else 64),
                 **kw)
        gw.journal_torn = torn
        if snap:
            gw.recoveries = int(snap.get("recoveries", 0))
            gw.dead_pods = set(snap.get("dead_pods") or [])
            gw.retiring = set(snap.get("retiring") or [])
            gw.scale_seq = int(snap.get("scale_seq", 0))
            gw.scaled_pods = {k: int(v) for k, v in
                              (snap.get("scaled_pods") or {}).items()}
            gw.retires = {k: dict(v) for k, v in
                          (snap.get("retires") or {}).items()}
            for ed in sorted(snap["entries"], key=lambda d: d["order"]):
                e = RouteEntry.from_dict(ed)
                gw.entries[e.spec.name] = e
        for r in fresh:
            gw._apply_record(r)
        # reconcile the pod map to the replayed pool ledger: snapshot-
        # restored scaled pods get their relocatable ports back, and a
        # completed retire drops its pod even when the caller's static
        # pod set still names it — the WAL, not the constructor
        # argument, owns pool membership
        for name in gw.scaled_pods:
            if name not in gw.pods:
                gw.pods[name] = gw._pool_port(name)
        for pod in gw.retires:
            if pod not in gw.retiring:
                gw.pods.pop(pod, None)
                gw.scaled_pods.pop(pod, None)
        gw._journal_floor = max(
            snap_seq + 1, (records[-1]["seq"] + 1) if records else 0)
        gw._open_journal()
        if dirty:
            gw.recoveries += 1
            gw._jlog("gw_recover", {"recoveries": gw.recoveries,
                                    "replayed": len(fresh),
                                    "torn_dropped": torn})
            obs_trace.tracer().emit(
                "gw_recover", cat="federation",
                recoveries=gw.recoveries, replayed=len(fresh))
            debug.dprintf("Federation", "recovered dirty gateway: %d "
                          "records replayed, %d torn dropped",
                          len(fresh), torn)
        gw._repair()
        gw.checkpoint()
        return gw
