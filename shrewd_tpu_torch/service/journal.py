"""The fleet's write-ahead journal: crash-safe scheduler state.

``fleet.json`` (the scheduler snapshot) is written only at checkpoints —
a SIGKILL/OOM/node loss between them would lose the fleet's admission
ledger, fair-share virtual times and quota accounting even though every
tenant's tallies are individually recoverable from its namespaced
campaign checkpoint.  The journal closes that window: every scheduler
state transition (admit, tick-complete with its vtime/quota deltas,
status change, failure, quarantine, shutdown) is appended here BEFORE
the in-memory ledgers are trusted, so ``CampaignScheduler.recover()``
can replay snapshot + journal after a hard kill at ANY instruction
boundary and resume every tenant bit-identically.

Append discipline (the WAL contract):

- one JSON record per line, each carrying a monotonic ``seq`` and a
  content ``checksum`` (``resilience.doc_checksum``);
- every append is ``flush`` + ``fsync`` before it is acknowledged — a
  record the scheduler acted on is durable;
- a torn tail (power loss / SIGKILL mid-append) reads as an invalid
  last line; ``replay_path`` drops it and everything after the first
  invalid record, because bytes after a torn record are untrusted;
- **compaction**: once a snapshot covering ``seq <= journal_seq`` is
  durable (``fleet.json`` via ``write_json_atomic``), the journal is
  atomically replaced with an empty file.  The ordering is
  snapshot-fsync THEN truncate, so a crash between the two leaves
  duplicate records (skipped by ``seq`` at replay), never a gap.

A clean shutdown therefore leaves an EMPTY journal behind a current
snapshot; ``is_dirty`` detecting records (or a torn tail) beyond the
snapshot's ``journal_seq`` is the hard-kill signature that routes
``tools/fleet.py`` to ``--recover``.

Service-level chaos rides the same seam: ``torn_journal`` tears an
append exactly the way a power loss would (prefix bytes, fsync'd, then
process death through the engine's ``kill_action``), and ``kill_fleet``
with ``at_journal`` fires right after a record lands — both on the
deterministic chaos schedule, never a clock.

Import discipline: jax-free (pure host-side durability; the journal
must work in the spool-only processes that never build a mesh).
"""

from __future__ import annotations

import json
import os

from shrewd_tpu_torch import resilience as resil
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.utils import debug

#: the journal file inside ``<outdir>/fleet_ckpt/``
JOURNAL_NAME = "journal.jsonl"


def journal_path(outdir: str) -> str:
    return os.path.join(outdir, "fleet_ckpt", JOURNAL_NAME)


class FleetJournal:
    """Append-only, fsync'd, checksummed record log (see module doc).

    ``next_seq`` continues from the larger of the caller's floor (the
    snapshot's ``journal_seq + 1``) and the last valid record already in
    the file, so sequence numbers stay monotonic across reopen,
    compaction and recovery.  Opening a file with a torn tail truncates
    the untrusted bytes first — appends never follow garbage.
    """

    def __init__(self, path: str, next_seq: int = 0, chaos=None):
        self.path = path
        self.chaos = chaos
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        records, torn, valid = ([], 0, 0)
        if os.path.exists(path):
            records, torn, valid = self.replay_path(path)
            if torn:
                # a torn tail is by definition not durable state: drop it
                # before appending, or the new records would sit behind
                # garbage and be dropped at the next replay
                with open(path, "r+b") as f:
                    f.truncate(valid)
                    f.flush()
                    os.fsync(f.fileno())
        self.torn_dropped = torn
        self.next_seq = max(int(next_seq),
                            records[-1]["seq"] + 1 if records else 0)
        self.since_compact = len(records)
        self.appended = 0        # records fsync'd by THIS process
        self.compactions = 0
        self._f = open(path, "a")

    # --- replay -----------------------------------------------------------

    @staticmethod
    def replay_path(path: str) -> tuple[list[dict], int, int]:
        """``(records, torn, valid_bytes)``: every checksummed record up
        to the first invalid one.  ``torn`` counts the invalid record
        (0 or 1 — everything after the first bad line is untrusted and
        not inspected); ``valid_bytes`` is the byte offset the trusted
        prefix ends at (the truncation point)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return [], 0, 0
        records: list[dict] = []
        pos = valid = 0
        torn = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                torn = 1             # unterminated tail: torn mid-append
                break
            try:
                rec = json.loads(data[pos:nl])
                if not isinstance(rec, dict):
                    raise ValueError("record is not a JSON object")
                want = rec.get("checksum")
                if want is None or resil.doc_checksum(rec) != want:
                    raise ValueError("checksum mismatch")
                int(rec["seq"])
            except (ValueError, KeyError, TypeError):
                torn = 1
                break
            records.append(rec)
            pos = valid = nl + 1
        return records, torn, valid

    # --- append -----------------------------------------------------------

    def append(self, kind: str, data: dict | None = None) -> int:
        """Durably append one record; returns its ``seq``.  The record
        is fsync'd before this returns — a caller that proceeds may
        trust a hard kill cannot un-happen the transition."""
        rec: dict = {"seq": self.next_seq, "kind": str(kind)}
        if data:
            rec.update(data)
        rec["checksum"] = resil.doc_checksum(rec)
        line = json.dumps(rec, default=str) + "\n"
        if self.chaos is not None:
            torn = self.chaos.take_torn_journal(rec["seq"])
            if torn is not None:
                # a torn append IS a process death mid-write: persist the
                # prefix a power loss would leave, then die through the
                # kill seam (default os._exit; tests install a raising
                # action so the "dead" fleet can assert recovery
                # in-process)
                keep = float(torn.get("keep_fraction", 0.5))
                self._f.write(line[:max(1, int(len(line) * keep))])
                self._f.flush()
                os.fsync(self._f.fileno())
                self.chaos.kill_now(torn.get("rc"))
                return rec["seq"]    # only under a non-exiting test action
        self._f.write(line)
        self._f.flush()
        os.fsync(self._f.fileno())
        # the durability boundary: a crash from here on replays this
        # record (the crashcheck model checker enumerates these)
        resil.notify_durability("append", self.path, seq=rec["seq"],
                                kind=rec["kind"])
        self.next_seq += 1
        self.appended += 1
        self.since_compact += 1
        obs_trace.tracer().emit("journal_append", cat="journal",
                                kind=rec["kind"], seq=rec["seq"])
        if self.chaos is not None:
            # kill_fleet at a journal ordinal: the boundary right after
            # record ``seq`` became durable (mid-tick, from the
            # scheduler's point of view)
            self.chaos.maybe_kill_fleet(journal_seq=rec["seq"])
        return rec["seq"]

    # --- compaction / lifecycle -------------------------------------------

    def compact(self) -> None:
        """Truncate the journal after a durable snapshot now owns every
        record.  Atomic (empty tmp + rename + dir-fsync): a crash
        mid-compaction leaves either the old journal (duplicates —
        skipped by seq) or the empty one, never a partial file."""
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        resil.fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        resil.notify_durability("compact", self.path,
                                next_seq=self.next_seq)
        self._f = open(self.path, "a")
        self.compactions += 1
        self.since_compact = 0
        obs_trace.tracer().emit("journal_compact", cat="journal",
                                next_seq=self.next_seq)
        debug.dprintf("Fleet", "journal compacted (next seq %d)",
                      self.next_seq)

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def is_dirty(outdir: str) -> bool:
    """The hard-kill signature: the journal holds records (or a torn
    tail) beyond the snapshot's ``journal_seq``.  A clean shutdown
    compacts the journal behind a current snapshot, so any trailing
    state means the fleet died without draining."""
    path = journal_path(outdir)
    if not os.path.exists(path):
        return False
    records, torn, _valid = FleetJournal.replay_path(path)
    if torn:
        return True
    if not records:
        return False
    try:
        snap = resil.load_json_verified(
            os.path.join(outdir, "fleet_ckpt", "fleet.json"))
        snap_seq = int(snap.get("journal_seq", -1))
    except (OSError, ValueError):
        # journal records with no readable snapshot: everything is
        # unsnapshotted state
        return True
    return any(r["seq"] > snap_seq for r in records)
