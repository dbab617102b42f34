"""Elastic multi-process campaigns: heartbeats, batch leases, re-mesh on
loss (the port of ``shrewd_tpu/parallel/elastic.py``).

gem5's distributed mode has no failure story: one dead node wedges the
hand-rolled TCP barrier forever (``dev/net/dist_iface.hh:102``,
``util/dist/gem5-dist.sh``), and a collective mesh inherits the same fate
— with ``torch.distributed`` and a global mesh, a lost or preempted
process stalls every surviving worker inside the next ``all_reduce``.

This module is the elastic alternative.  The key move is to stop sharing a
*collective* and share only *work*:

- every worker owns a mesh over **its own local devices** (its reduction
  is process-local, so no peer can wedge it — the "re-mesh onto surviving
  devices" is structural: the surviving workers' meshes ARE the surviving
  devices);
- batches are **leased per batch_id** from a shared coordination directory
  (claims are atomic ``os.link`` creations; results are atomic JSON
  documents), so any worker can compute any batch;
- workers announce liveness with **heartbeat files**; a worker that stops
  beating past the timeout is declared lost, its leases are revoked, and
  survivors re-dispatch the orphaned batch_ids — on the same frozen PRNG
  keys, so the recovered tally is bit-identical to an undisturbed run
  (the same discipline as the resilience ladder and the integrity
  quarantine: a batch's outcomes are a pure function of its coordinates,
  never of where or when it ran);
- a **bounded speculation window** (``lookahead``) lets workers run ahead
  of the batch currently blocking accumulation, so the campaign
  parallelizes across workers without any ordering collective.

Every worker accumulates every batch's published tally in batch-id order,
so all survivors converge to the same cumulative state and apply the
stopping rule identically — agreement without a barrier.

The lease-board documents are the reference's, byte for byte in their
fields and checksums (``resilience.doc_checksum``), so workers of the two
packages sharing one coordination directory adopt each other's published
results.  Pure host-side file coordination: the compute callables passed
in own all device work.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, NamedTuple

from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.resilience import load_json_verified, write_json_atomic
from shrewd_tpu_torch.utils import debug
from shrewd_tpu_torch.utils.config import ConfigObject, Param

debug.register_flag("Elastic", "membership / leases / re-mesh")


class ElasticError(RuntimeError):
    """The elastic layer could not make progress (e.g. a lease held past
    ``claim_wait`` by a worker that still appears alive)."""


class DrainRequested(Exception):
    """Raised out of a blocked ``obtain`` when the caller's drain
    predicate turns true: a SIGTERM must not wait out a peer's lease —
    the scheduler's kill grace is usually far shorter than
    ``claim_wait``."""


class ElasticConfig(ConfigObject):
    """Knobs for the elastic layer (a ``CampaignPlan`` child, so a
    campaign's survivability posture is reproducible from its config
    dump).  The coordination directory and worker name are *runtime*
    identity, not plan state — they come from the CLI/launcher."""

    heartbeat_interval = Param(float, 0.5,
                               "seconds between liveness beats",
                               check=lambda v: v > 0)
    heartbeat_timeout = Param(float, 5.0,
                              "seconds without a beat before a worker is "
                              "declared lost and its leases are revoked",
                              check=lambda v: v > 0)
    lookahead = Param(int, 2,
                      "batches a worker may speculatively run ahead of the "
                      "one blocking accumulation (bounds wasted work past "
                      "convergence)", check=lambda v: v >= 0)
    poll_interval = Param(float, 0.05,
                          "seconds between lease-board polls while blocked",
                          check=lambda v: v > 0)
    claim_wait = Param(float, 120.0,
                       "max seconds blocked on a live peer's lease before "
                       "the worker gives up (guards against undetectable "
                       "wedges; lost workers are revoked, not waited out)",
                       check=lambda v: v > 0)


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.+-]", "+", name)


class HeartbeatWriter:
    """Periodic atomic liveness beats: ``hb_<worker>.json`` in the
    coordination directory.  ``stop()`` removes the file — a graceful
    leave is visible immediately, only a *dead* worker goes stale."""

    def __init__(self, coord_dir: str, worker: str, interval: float = 0.5):
        self.path = os.path.join(coord_dir, f"hb_{_sanitize(worker)}.json")
        self.worker = worker
        self.interval = float(interval)
        self.beats = 0
        self._thread = None
        self._stop = None

    def beat(self) -> None:
        """Atomic but deliberately UNSYNCED (plain tmp-write + rename, no
        fsyncs): a beat is a liveness signal whose loss on crash IS the
        signal — paying two synchronous flushes per beat per worker
        against the shared directory would buy nothing."""
        import json

        self.beats += 1
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            # graftlint: allow-raw-write -- liveness beat: atomic rename,
            # deliberately unsynced; its loss on crash IS the signal
            json.dump({"worker": self.worker, "beats": self.beats}, f)
        os.replace(tmp, self.path)

    def start(self) -> "HeartbeatWriter":
        import threading

        if self._thread is not None:
            return self
        self.beat()                      # liveness visible before any claim
        self._stop = threading.Event()

        def _loop():
            while not self._stop.wait(self.interval):
                self.beat()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name=f"heartbeat-{self.worker}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            os.unlink(self.path)         # graceful leave
        except OSError:
            pass


class Membership:
    """Liveness view over the heartbeat files."""

    def __init__(self, coord_dir: str, timeout: float = 5.0):
        self.coord_dir = coord_dir
        self.timeout = float(timeout)

    def _hb_path(self, worker: str) -> str:
        return os.path.join(self.coord_dir, f"hb_{_sanitize(worker)}.json")

    def alive(self, worker: str) -> bool:
        try:
            # graftlint: allow-wall-clock -- heartbeat staleness is
            # wall-clock liveness, not a trigger decision: tallies stay
            # bit-identical under any membership (frozen-key re-dispatch)
            # graftlint: allow-clock -- lease revocation compares against
            # real filesystem mtimes, so this read must NOT route through
            # the fake-able obs.clock seam (a test-installed clock would
            # mass-revoke live workers or never revoke dead ones)
            age = time.time() - os.stat(self._hb_path(worker)).st_mtime
        except OSError:
            return False                 # left gracefully or never joined
        return age < self.timeout

    def workers(self) -> list[str]:
        out = []
        for name in sorted(os.listdir(self.coord_dir)):
            if name.startswith("hb_") and name.endswith(".json"):
                try:
                    out.append(load_json_verified(
                        os.path.join(self.coord_dir, name))["worker"])
                except (OSError, ValueError, KeyError):
                    continue             # torn beat mid-read: skip
        return out


class LeaseBoard:
    """Per-batch leases + published results in a shared directory.

    ``claim`` is an atomic ``os.link`` of a fully-written temp file onto
    the lease path — two workers racing a batch cannot both win, and a
    reader never sees a half-written lease.  ``publish`` writes the done
    document atomically; after a revocation two workers may both compute
    (and publish) the same batch, which is harmless by construction: the
    tally is a pure function of the frozen keys, so both documents are
    bit-identical."""

    def __init__(self, coord_dir: str, worker: str):
        self.dir = os.path.join(coord_dir, "board")
        os.makedirs(self.dir, exist_ok=True)
        self.worker = worker

    def _lease(self, key: str) -> str:
        return os.path.join(self.dir, f"lease_{_sanitize(key)}.json")

    def _done(self, key: str) -> str:
        return os.path.join(self.dir, f"done_{_sanitize(key)}.json")

    def claim(self, key: str) -> bool:
        path = self._lease(key)
        tmp = f"{path}.{os.getpid()}.claim"
        with open(tmp, "w") as f:
            import json
            # graftlint: allow-raw-write -- lease claim: fsync'd tmp +
            # atomic os.link is the commit point; no torn lease is
            # observable and the board path must stay write_json-free
            json.dump({"worker": self.worker, "key": key}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def owner(self, key: str) -> str | None:
        try:
            return load_json_verified(self._lease(key)).get("worker")
        except (OSError, ValueError):
            return None

    def revoke(self, key: str, expected_owner: str | None = None) -> bool:
        """Remove the lease (the owner was declared lost).  True when this
        call actually removed a lease held by ``expected_owner``.

        The observe-owner → check-alive → revoke sequence is not atomic,
        so a naive unlink could delete a lease a LIVE worker re-claimed
        after an earlier revocation (the ABA race).  Instead the lease is
        atomically renamed into a per-revoker graveyard name, its content
        is read, and a mismatched owner is restored via ``os.link`` —
        one winner among racing revokers, and a re-claimed lease is never
        silently destroyed.  ``expected_owner=None`` skips the check
        (unconditional revoke, single-revoker callers/tests)."""
        path = self._lease(key)
        grave = f"{path}.{os.getpid()}.revoked"
        try:
            os.rename(path, grave)
        except OSError:
            return False                 # lost the race: someone else won
        try:
            if expected_owner is not None:
                try:
                    owner = load_json_verified(grave).get("worker")
                except (OSError, ValueError):
                    owner = None
                if owner != expected_owner:
                    # ABA: a live worker re-claimed between our
                    # observation and the rename — give the lease back
                    # (if a third claim landed meanwhile, the link fails
                    # and the re-claimer's publish still stands)
                    try:
                        os.link(grave, path)
                    except OSError:
                        pass
                    return False
            return True
        finally:
            try:
                os.unlink(grave)
            except OSError:
                pass

    def publish(self, key: str, doc: dict) -> None:
        """Done documents carry a content checksum (resilience.doc_checksum)
        so a result torn/corrupted on the shared filesystem reads as
        ABSENT (``done`` returns None → someone recomputes) rather than
        being adopted into a survivor's cumulative tally."""
        from shrewd_tpu_torch.resilience import doc_checksum

        doc = dict(doc)
        doc["checksum"] = doc_checksum(doc)
        write_json_atomic(self._done(key), doc)

    def done(self, key: str) -> dict | None:
        try:
            return load_json_verified(self._done(key))
        except (OSError, ValueError):
            return None

    def retract(self, key: str) -> None:
        """Remove a published result AND its lease (an adopted document
        that failed validation): the batch reads as never-run, so the
        caller can claim and recompute it from its frozen coordinates."""
        for path in (self._done(key), self._lease(key)):
            try:
                os.unlink(path)
            except OSError:
                pass


class WorkerLostInfo(NamedTuple):
    """Payload of ``ExitEvent.WORKER_LOST``: who died, which batch lease
    was revoked, and who survives (the re-meshed membership)."""
    worker: str
    batch_key: str
    survivors: tuple


class ElasticContext:
    """One worker's view of an elastic campaign: heartbeat + membership +
    lease board + the accounting the ``campaign.elastic.*`` stats group
    reports."""

    def __init__(self, coord_dir: str, worker: str,
                 cfg: ElasticConfig | None = None):
        self.cfg = cfg if cfg is not None else ElasticConfig()
        self.coord_dir = coord_dir
        os.makedirs(coord_dir, exist_ok=True)
        self.worker = worker
        self.heartbeat = HeartbeatWriter(coord_dir, worker,
                                         self.cfg.heartbeat_interval)
        self.membership = Membership(coord_dir, self.cfg.heartbeat_timeout)
        self.board = LeaseBoard(coord_dir, worker)
        # the campaign.elastic.* ledgers
        self.claimed = 0          # leases this worker won
        self.adopted = 0          # batches accumulated from a peer's result
        self.revoked = 0          # leases revoked after owner loss
        self.reclaimed = 0        # revoked batches this worker re-computed
        self.lost_workers: set[str] = set()
        self._pending_lost: list[WorkerLostInfo] = []
        self._reclaim_pending = False

    def start(self) -> "ElasticContext":
        self.heartbeat.start()
        return self

    def stop(self) -> None:
        self.heartbeat.stop()

    def key(self, simpoint: str, structure: str, batch_id: int) -> str:
        return f"{simpoint}.{structure}.{int(batch_id)}"

    def take_lost(self) -> list[WorkerLostInfo]:
        ev, self._pending_lost = self._pending_lost, []
        return ev

    def counters(self) -> dict:
        return {"workers_lost": len(self.lost_workers),
                "leases_claimed": self.claimed,
                "leases_adopted": self.adopted,
                "leases_revoked": self.revoked,
                "batches_reclaimed": self.reclaimed}

    # --- the ensure loop -------------------------------------------------

    def obtain(self, target_key: str,
               compute: Callable[[], dict],
               speculate: Callable[[], bool] | None = None,
               should_abort: Callable[[], bool] | None = None
               ) -> tuple[dict, bool]:
        """Ensure ``target_key``'s done document exists and return
        ``(doc, adopted)``.

        Order of preference each round: adopt a published result; claim
        and compute it ourselves; revoke a lost owner's lease; speculate
        one batch ahead (``speculate()`` returns True when it did work);
        otherwise poll.  Blocked-on-a-live-peer time is bounded by
        ``claim_wait`` (progress resets the clock).  ``should_abort``
        (e.g. the orchestrator's drain flag) is re-checked while blocked
        and raises ``DrainRequested`` — a graceful preemption must not
        wait out a peer's lease."""
        waited = 0.0
        while True:
            if should_abort is not None and should_abort():
                raise DrainRequested(target_key)
            doc = self.board.done(target_key)
            if doc is not None:
                mine = doc.get("worker") == self.worker
                if not mine:
                    self.adopted += 1
                    obs_trace.tracer().emit(
                        "lease_adopt", cat="elastic", key=target_key,
                        peer=str(doc.get("worker", "")))
                # a revocation we won may have been computed by a third
                # worker first: the reclaim credit belongs to whoever
                # computed it, not to our next unrelated claim
                self._reclaim_pending = False
                return doc, not mine
            if self.board.claim(target_key):
                self.claimed += 1
                obs_trace.tracer().emit(
                    "lease_claim", cat="elastic", key=target_key,
                    worker=self.worker)
                if self._reclaim_pending:
                    self.reclaimed += 1
                    self._reclaim_pending = False
                doc = compute()
                doc["worker"] = self.worker
                self.board.publish(target_key, doc)
                return doc, False
            owner = self.board.owner(target_key)
            if owner is None:
                continue                 # lease vanished between checks
            if not self.membership.alive(owner):
                if self.board.revoke(target_key, expected_owner=owner):
                    self.revoked += 1
                    obs_trace.tracer().emit(
                        "lease_revoke", cat="elastic", key=target_key,
                        lost=owner)
                    self.lost_workers.add(owner)
                    self._reclaim_pending = True
                    self._pending_lost.append(WorkerLostInfo(
                        owner, target_key,
                        tuple(w for w in self.membership.workers()
                              if self.membership.alive(w))))
                    debug.dprintf(
                        "Elastic", "%s: revoked %s held by lost worker %s",
                        self.worker, target_key, owner)
                continue
            if speculate is not None and speculate():
                waited = 0.0             # progress: reset the give-up clock
                continue
            time.sleep(self.cfg.poll_interval)
            waited += self.cfg.poll_interval
            if waited > self.cfg.claim_wait:
                raise ElasticError(
                    f"{self.worker}: blocked {waited:.0f}s on "
                    f"{target_key} held by live worker {owner!r}")
