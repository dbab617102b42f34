"""Tenant specs + the durable submission queue (atomic spool directory).

A **tenant** is one campaign plan plus its scheduling identity: a name,
a strict-priority class, a fair-share weight, and an optional batch
quota.  ``TenantSpec`` is the JSON-round-trippable submission unit — the
whole tenant is reproducible from its spec document alone, exactly like
a campaign from its ``config.json`` (the plan rides inside the spec).

The **submission queue** is a spool directory with the same durability
discipline as the elastic lease board (``parallel/elastic.py``): every
document is written via ``resilience.write_json_atomic`` (tmp + fsync +
rename + dir-fsync) and carries a content checksum, so a torn submission
reads as absent, never as a half-tenant.  Claims are atomic renames
(``pending/`` → ``claimed/``), so two servers racing a spool cannot both
admit one tenant, and tenants can be submitted while the fleet runs —
the scheduler polls ``pending/`` between ticks.

Layout::

    <root>/pending/   NNNNNN_<name>.json   submitted, unclaimed
    <root>/claimed/   NNNNNN_<name>.json   admitted by a scheduler
    <root>/done/      NNNNNN_<name>.json   final per-tenant result doc
    <root>/bad/       NNNNNN_<name>.json   poisoned submission + .reason
    <root>/server.lock                     O_EXCL+pid single-server guard

A **poisoned** submission — complete JSON whose checksum fails, or a
document the spec validator rejects — is deterministically bad (an
atomic replace can never heal it), so ``claim`` moves it to ``bad/``
with a ``.reason`` doc and counts it, instead of raising out of the
scheduler's poll loop or skipping it forever.  Only documents that do
not PARSE stay pending: that is the in-flight signature of the atomic
submit (O_EXCL placeholder → atomic replace).

Host only: pure file coordination, no device work (the plan inside a
spec is elaborated only by the scheduler).
"""

from __future__ import annotations

import json
import os
import re

from shrewd_tpu_torch.obs import clock as obs_clock
from shrewd_tpu_torch.resilience import (doc_checksum,
                                         load_json_verified,
                                         write_json_atomic)
from shrewd_tpu_torch.utils import debug

debug.register_flag("Fleet", "multi-tenant scheduler / submission queue")

_TICKET_RE = re.compile(r"^(\d{6})_.*\.json$")


def sanitize(name: str) -> str:
    """Filesystem-safe tenant name (the elastic ``_sanitize`` discipline;
    one definition here so spool tickets and per-tenant output
    directories cannot disagree)."""
    return re.sub(r"[^A-Za-z0-9_.+-]", "+", name)


class TenantSpec:
    """One tenant's submission: plan + scheduling identity.

    ``plan`` is the ``CampaignPlan.to_dict()`` document (kept as a dict
    so the spec round-trips without building anything); ``priority`` is
    a strict class (higher preempts lower entirely), ``weight`` the
    fair-share stride within a class, and ``quota_batches`` an optional
    scheduler-level resource cap — a tenant at quota is drained to a
    resumable checkpoint (status ``quota``), never silently truncated."""

    def __init__(self, name: str, plan: dict, priority: int = 0,
                 weight: float = 1.0, quota_batches: int = 0,
                 submitted_at: float = 0.0, slo_s: float = 0.0,
                 shards: int = 1, binary_b64: str = "",
                 binary_digest: str = "", ingest: dict | None = None):
        if not name:
            raise ValueError("tenant needs a non-empty name")
        if bool(binary_b64) != bool(binary_digest):
            raise ValueError(
                f"tenant {name!r}: binary_b64 and binary_digest come "
                f"together (a payload without its claimed digest — or a "
                f"digest with no payload — cannot be verified)")
        if ingest and not binary_digest:
            raise ValueError(f"tenant {name!r}: ingest axes only apply "
                             f"to a binary-carrying submission")
        if not float(weight) > 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0 "
                             f"(got {weight})")
        if int(quota_batches) < 0:
            raise ValueError(f"tenant {name!r}: quota_batches must be >= 0")
        if float(slo_s) < 0:
            raise ValueError(f"tenant {name!r}: slo_s must be >= 0")
        if int(shards) < 1:
            raise ValueError(f"tenant {name!r}: shards must be >= 1")
        self.name = str(name)
        self.plan = dict(plan)
        self.priority = int(priority)
        self.weight = float(weight)
        self.quota_batches = int(quota_batches)
        self.submitted_at = float(submitted_at)
        #: completion SLO in seconds (0 = none): advisory — the
        #: federation gateway compares it against its half-width-
        #: trajectory deadline estimate at admission and when deciding
        #: rebalancing migrations; schedulers never consume it (no
        #: wall clock enters any scheduling decision)
        self.slo_s = float(slo_s)
        #: single-campaign sharding degree (federation/gateway.py): the
        #: gateway splits the plan's frozen batch-id space round-robin
        #: across ``shards`` journaled sub-tenants on distinct pods and
        #: folds their tallies bit-identically to the solo run; 1 (the
        #: default) is byte-for-byte the unsharded path.  Plain pod
        #: schedulers ignore the field — sub-tenant specs always carry
        #: shards=1 (the split happens once, at the gateway).
        self.shards = int(shards)
        #: binary-in submission (the streaming-ingest path,
        #: ingest/pipeline.py): the raw workload ELF rides the spec
        #: base64-encoded with its claimed sha256.  ``plan`` then
        #: carries only scenario axes (structures, trial counts, seed)
        #: — the scheduler fills ``simpoints`` from the artifact store
        #: after the journaled ingest pipeline runs.  ``ingest`` is the
        #: optional ingest-axes dict (interval/k/seed/...), normalized
        #: and digest-keyed by the pipeline.
        self.binary_b64 = str(binary_b64)
        self.binary_digest = str(binary_digest)
        self.ingest = dict(ingest) if ingest else None

    def binary_bytes(self) -> bytes:
        """Decode the carried binary (raises ValueError on bad base64)."""
        import base64
        import binascii

        try:
            return base64.b64decode(self.binary_b64, validate=True)
        except (binascii.Error, ValueError) as e:
            raise ValueError(f"tenant {self.name!r}: binary_b64 does "
                             f"not decode: {e}")

    def verify_binary(self) -> bytes:
        """Decode AND verify the carried binary against its claimed
        digest; raises ValueError on any mismatch.  A spec whose payload
        no longer hashes to its digest is deterministically poisoned
        (rot or tamper in the spool) — ``claim()`` routes that to
        ``bad/`` exactly like a checksum-failed document."""
        import hashlib

        data = self.binary_bytes()
        got = hashlib.sha256(data).hexdigest()
        if got != self.binary_digest:
            raise ValueError(
                f"tenant {self.name!r}: binary digest mismatch "
                f"(claimed {self.binary_digest[:12]}, payload hashes "
                f"to {got[:12]}) — poisoned submission")
        return data

    def build_plan(self):
        from shrewd_tpu_torch.campaign.plan import CampaignPlan

        return CampaignPlan.from_dict(self.plan)

    def to_dict(self) -> dict:
        d = {"name": self.name, "plan": dict(self.plan),
             "priority": self.priority, "weight": self.weight,
             "quota_batches": self.quota_batches,
             "submitted_at": self.submitted_at,
             "slo_s": self.slo_s, "shards": self.shards}
        # binary fields ride only when set, so plan-only submission
        # documents stay byte-identical to pre-ingest releases
        if self.binary_digest:
            d["binary_b64"] = self.binary_b64
            d["binary_digest"] = self.binary_digest
            if self.ingest is not None:
                d["ingest"] = dict(self.ingest)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        return cls(name=d["name"], plan=d["plan"],
                   priority=d.get("priority", 0),
                   weight=d.get("weight", 1.0),
                   quota_batches=d.get("quota_batches", 0),
                   submitted_at=d.get("submitted_at", 0.0),
                   slo_s=d.get("slo_s", 0.0),
                   shards=d.get("shards", 1),
                   binary_b64=d.get("binary_b64", ""),
                   binary_digest=d.get("binary_digest", ""),
                   ingest=d.get("ingest"))


class SubmissionQueue:
    """The durable spool (see module docstring)."""

    def __init__(self, root: str):
        self.root = root
        self.pending_dir = os.path.join(root, "pending")
        self.claimed_dir = os.path.join(root, "claimed")
        self.done_dir = os.path.join(root, "done")
        self.bad_dir = os.path.join(root, "bad")
        for d in (self.pending_dir, self.claimed_dir, self.done_dir,
                  self.bad_dir):
            os.makedirs(d, exist_ok=True)

    # --- submission ------------------------------------------------------

    def _next_seq(self) -> int:
        seq = 0
        for d in (self.pending_dir, self.claimed_dir, self.done_dir,
                  self.bad_dir):
            for name in os.listdir(d):
                m = _TICKET_RE.match(name)
                if m:
                    seq = max(seq, int(m.group(1)) + 1)
        return seq

    def submit(self, spec: TenantSpec) -> str:
        """Spool one tenant; returns the ticket name.  The sequence
        number is reserved with an O_EXCL placeholder (two racing
        submitters cannot share a ticket), then the real document
        atomically replaces it — a poll between the two sees an invalid
        document and skips it, never a half-spec."""
        doc = spec.to_dict()
        if not doc.get("submitted_at"):
            # submission timestamp feeds the queue-latency observability
            # stat only; scheduling decisions are pure functions of
            # admission order and batch counts, and tallies are
            # frozen-key pure either way.  Routed through the sanctioned
            # obs.clock seam (GL106).
            doc["submitted_at"] = obs_clock.now()
        # content checksum: a claimed doc that PARSES but fails this is
        # definitively poisoned (bit-rot, tampering) and takes the bad/
        # quarantine path, never the in-flight-skip path
        doc["checksum"] = doc_checksum(doc)
        seq = self._next_seq()
        while True:
            ticket = f"{seq:06d}_{sanitize(spec.name)}.json"
            path = os.path.join(self.pending_dir, ticket)
            try:
                os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                break
            except FileExistsError:
                seq += 1
        write_json_atomic(path, doc)
        debug.dprintf("Fleet", "submitted %s (priority=%d weight=%g)",
                      ticket, spec.priority, spec.weight)
        return ticket

    # --- the scheduler side ----------------------------------------------

    def pending(self) -> list[str]:
        return sorted(n for n in os.listdir(self.pending_dir)
                      if _TICKET_RE.match(n))

    def claim(self) -> list[tuple[str, TenantSpec]]:
        """Claim every currently-valid pending submission, in ticket
        order.  The claim is an atomic rename into ``claimed/`` — a
        racing second server loses with OSError and skips.

        Documents that do not PARSE (in-flight placeholder, torn write)
        stay pending for a later poll — they become claimable once
        their atomic replace lands.  Documents that parse but are
        poisoned (checksum mismatch, spec the validator rejects) can
        never heal: they move to ``bad/`` with a reason doc instead of
        wedging the poll loop forever or raising out of the scheduler."""
        out = []
        for ticket in self.pending():
            src = os.path.join(self.pending_dir, ticket)
            try:
                with open(src) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue             # placeholder / in-flight: not ours yet
            try:
                if not isinstance(doc, dict):
                    raise ValueError("submission is not a JSON object")
                want = doc.get("checksum")
                if want is not None and doc_checksum(doc) != want:
                    raise ValueError("checksum mismatch "
                                     "(corrupt submission)")
                spec = TenantSpec.from_dict(doc)
                if spec.binary_digest:
                    # the document-checksum split, applied to the payload: a
                    # binary that no longer hashes to its claimed digest
                    # is poison (bad/ + reason), never an in-flight skip
                    spec.verify_binary()
            except Exception as e:  # noqa: BLE001 — a complete-but-
                # poisoned document is deterministically bad; quarantine
                # it so the spool keeps serving
                self.quarantine_bad(ticket, e)
                continue
            dst = os.path.join(self.claimed_dir, ticket)
            try:
                # graftlint: allow-fsync-rename -- cross-dir move of an
                # already-durable document (content fsync'd at submit);
                # a power loss that drops the rename re-pends the
                # ticket, and re-claim is safe: admission refuses
                # duplicate tenant names loudly
                os.rename(src, dst)
            except OSError:
                continue             # lost the claim race
            out.append((ticket, spec))
            debug.dprintf("Fleet", "claimed %s", ticket)
        return out

    def quarantine_bad(self, ticket: str, err: Exception) -> None:
        """Move a poisoned pending submission to ``bad/`` (atomic
        rename — a racing server loses and skips) and publish the
        refusal evidence next to it as ``<ticket>.reason``."""
        src = os.path.join(self.pending_dir, ticket)
        dst = os.path.join(self.bad_dir, ticket)
        try:
            # graftlint: allow-fsync-rename -- cross-dir move of an
            # already-durable (if poisoned) document; losing the rename
            # re-pends the ticket and the next poll re-quarantines it —
            # the decision is deterministic, so replaying it is free
            os.rename(src, dst)
        except OSError:
            return                   # raced away (claimed or re-quarantined)
        write_json_atomic(dst + ".reason", {
            "ticket": ticket, "error": f"{type(err).__name__}: {err}"})
        debug.dprintf("Fleet", "quarantined bad submission %s: %s",
                      ticket, err)

    def bad_count(self) -> int:
        """Poisoned submissions quarantined in ``bad/`` (the
        ``campaign.fleet.submissions_bad`` stat)."""
        return len([n for n in os.listdir(self.bad_dir)
                    if _TICKET_RE.match(n)])

    def mark_done(self, ticket: str, result: dict) -> None:
        """Publish the tenant's final result document (atomic, like every
        persisted artifact) and retire the claimed ticket."""
        write_json_atomic(os.path.join(self.done_dir, ticket), dict(result))
        try:
            os.unlink(os.path.join(self.claimed_dir, ticket))
        except OSError:
            pass

    def done(self, ticket: str) -> dict | None:
        try:
            return load_json_verified(os.path.join(self.done_dir, ticket))
        except (OSError, ValueError):
            return None


# --- single-server guard ----------------------------------------------------

class LockHeld(RuntimeError):
    """Another live server owns the fleet's lock file."""


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False            # never signal pgid 0 / invalid pids
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True             # exists, owned by someone else
    except OSError:
        return False
    return True


class ServerLock:
    """O_EXCL + pid lock file: one server per spool/fleet directory.

    Two ``fleet.py --serve`` processes racing one spool would each win
    half the atomic claims and split the fleet's tenants across two
    schedulers with two journals — silently.  The lock makes the race
    loud: the file is created with ``O_CREAT|O_EXCL`` (atomic on POSIX)
    and records the holder's pid; a second server fails with
    ``LockHeld``.

    A **stale** lock — the recorded pid is not alive (the previous
    server was SIGKILLed, which is exactly the hard-kill scenario the
    journal exists for), or the content is unreadable (torn pid write)
    — is reaped and re-raced through the same O_EXCL create, so crash
    recovery never needs a human to rm a lock file.  Same-host pid
    liveness only: a multi-host spool needs the elastic heartbeat
    membership instead, and says so in README.
    """

    def __init__(self, root: str, name: str = "server.lock"):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, name)
        self._owned = False

    def _holder(self) -> int | None:
        try:
            with open(self.path) as f:
                return int(f.read().strip() or "0")
        except (OSError, ValueError):
            return None

    def _reap_stale(self) -> None:
        """Remove a stale lock under a reap MUTEX (its own O_EXCL file):
        the holder re-reads the lock content before unlinking, so a
        reaper acting on an old read can never unlink a lock another
        server just validly acquired (the naive read-then-unlink TOCTOU
        would split the fleet across two owners — the exact hazard the
        lock exists to prevent)."""
        reap = self.path + ".reap"
        try:
            fd = os.open(reap, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # another reaper holds the mutex; if ITS holder died between
            # unlink(lock) and unlink(reap), clear the orphan
            try:
                with open(reap) as f:
                    rpid = int(f.read().strip() or "0")
            except (OSError, ValueError):
                rpid = 0
            if not _pid_alive(rpid):
                try:
                    os.unlink(reap)
                except OSError:
                    pass
            return
        try:
            os.write(fd, f"{os.getpid()}\n".encode())
        finally:
            os.close(fd)
        try:
            # re-read under the mutex: only unlink if STILL stale
            pid = self._holder()
            if pid is None or not _pid_alive(pid):
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
        finally:
            try:
                os.unlink(reap)
            except OSError:
                pass

    def acquire(self) -> "ServerLock":
        for _ in range(8):
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                pid = self._holder()
                if pid is not None and _pid_alive(pid):
                    raise LockHeld(
                        f"{self.path}: held by live pid {pid}")
                # stale (dead pid / unreadable content): reap under the
                # reap mutex, then re-race the O_EXCL create
                self._reap_stale()
                continue
            try:
                os.write(fd, f"{os.getpid()}\n".encode())
                os.fsync(fd)
            finally:
                os.close(fd)
            self._owned = True
            debug.dprintf("Fleet", "server lock %s (pid %d)",
                          self.path, os.getpid())
            return self
        raise LockHeld(f"{self.path}: could not settle lock ownership")

    def release(self) -> None:
        if not self._owned:
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass
        self._owned = False

    def __enter__(self) -> "ServerLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
