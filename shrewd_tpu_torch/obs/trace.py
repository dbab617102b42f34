"""The process-wide tracer + flight recorder (see package docstring; the
port's copy of ``shrewd_tpu/obs/trace.py``).

Event model — one flat dict per event, JSON-able by construction::

    {"seq": 17,                  # per-tracer append ordinal (deterministic)
     "name": "batch",            # what happened
     "cat": "dispatch",          # which subsystem lane
     "ph": "B" | "E" | "i" | "C",  # span begin/end, instant, counter
     "args": {...},              # semantic coordinates (sp, structure,
                                 #  batch_id, tenant, seq, ...) — identity
     "ts": 12.34 | None}         # obs.clock timestamp (None = clock off)

Determinism contract: ``seq``, ``name``, ``cat``, ``ph`` and ``args``
are pure functions of campaign coordinates and host control flow, so two
identical runs emit byte-identical streams once ``ts``/``dur`` are
stripped (``obs.export.normalize``); the trace-determinism tests pin it.
Emission never reads PRNG state, never branches campaign control flow,
and holds no locks around device work — tracing on vs. off is
bit-identical in every tally (also pinned).

The **disabled tracer is a no-op constant**: ``tracer()`` returns the
module-level ``NULL_TRACER`` singleton whose methods are empty and whose
``span``/``scope`` return a shared reusable null context manager — no
allocation, no branching on the caller side, ≈zero overhead.

The **flight recorder** is the tracer's bounded ring: ``flight_dump``
writes the recent-event window atomically (``resilience.
write_json_atomic``) to ``<outdir>/flightrec.json`` with the abnormal-
exit reason, and ``set_flight_path``/``maybe_flight_dump`` let seams
that know no outdir (the chaos hard-kill path) dump to a pre-registered
location before the process dies.
"""

from __future__ import annotations

from collections import deque

from shrewd_tpu_torch.obs import clock

#: default bounded-ring capacity (events kept for the flight recorder);
#: the cap bounds memory AND flight-dump size, never correctness — the
#: dropped count is part of every dump, so truncation is observable
DEFAULT_RING = 8192

FLIGHT_NAME = "flightrec.json"


class _NullCtx:
    """Reusable no-op context manager (the null tracer's span/scope)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _Scope:
    """Ambient-coordinate scope: merged into every event emitted while
    entered (the scheduler wraps each tenant tick so nested seams —
    exec cache, watchdog, integrity — land in that tenant's lane
    without threading tenant identity through every call)."""

    __slots__ = ("_tracer", "_coords", "_saved")

    def __init__(self, tracer, coords):
        self._tracer = tracer
        self._coords = coords
        self._saved = None

    def __enter__(self):
        self._saved = self._tracer._scope
        merged = dict(self._saved)
        merged.update(self._coords)
        self._tracer._scope = merged
        return self

    def __exit__(self, *exc):
        self._tracer._scope = self._saved
        return False


class _Span:
    """Context-manager span: ``B`` on enter, ``E`` on exit (same name/
    cat/coords, so exporters pair them without object identity)."""

    __slots__ = ("_tracer", "_name", "_cat", "_coords")

    def __init__(self, tracer, name, cat, coords):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._coords = coords

    def __enter__(self):
        self._tracer.emit(self._name, cat=self._cat, ph="B", **self._coords)
        return self

    def __exit__(self, *exc):
        self._tracer.emit(self._name, cat=self._cat, ph="E", **self._coords)
        return False


class _NullTracer:
    """The disabled tracer: a no-op constant.  Every counter the stats
    bridge reads exists (zeros), every method is empty, and the context
    managers are one shared reusable object."""

    __slots__ = ()

    enabled = False
    emitted = 0
    dropped = 0
    flight_dumps = 0
    by_name: dict = {}
    flight_path = None

    def emit(self, name, cat="campaign", ph="i", **coords) -> None:
        pass

    def counter(self, name, value, cat="campaign", **coords) -> None:
        pass

    def span(self, name, cat="campaign", **coords):
        return _NULL_CTX

    def scope(self, **coords):
        return _NULL_CTX

    def snapshot(self) -> list:
        return []

    def set_flight_path(self, path) -> None:
        pass

    def flight_dump(self, path, reason, **extra) -> None:
        pass

    def maybe_flight_dump(self, reason, **extra) -> None:
        pass


class Tracer:
    """The live tracer: bounded ring + append counters + flight dump.

    Emission is append-only onto a ``deque`` (GIL-atomic; dispatch is
    single-threaded per process, and the few background threads —
    heartbeats, reprobe — do not emit)."""

    enabled = True

    def __init__(self, ring: int = DEFAULT_RING, timestamps: bool = True):
        self._ring: deque = deque(maxlen=int(ring))
        self._timestamps = bool(timestamps)
        self._scope: dict = {}
        self.seq = 0           # next event ordinal (deterministic)
        self.emitted = 0
        self.dropped = 0       # ring overwrites (emitted - retained)
        self.by_name: dict[str, int] = {}
        self.flight_path: str | None = None
        self.flight_dumps = 0

    # --- emission -------------------------------------------------------

    def emit(self, name, cat="campaign", ph="i", **coords) -> None:
        """One structured event.  ``coords`` are the event's semantic
        identity — campaign coordinates only (the determinism contract);
        ambient scope coordinates merge underneath them."""
        args = dict(self._scope)
        if coords:
            args.update(coords)
        ev = {"seq": self.seq, "name": str(name), "cat": str(cat),
              "ph": str(ph), "args": args,
              "ts": clock.monotonic() if self._timestamps else None}
        self.seq += 1
        self.emitted += 1
        self.by_name[ev["name"]] = self.by_name.get(ev["name"], 0) + 1
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(ev)

    def counter(self, name, value, cat="campaign", **coords) -> None:
        self.emit(name, cat=cat, ph="C", value=value, **coords)

    def span(self, name, cat="campaign", **coords):
        return _Span(self, name, cat, coords)

    def scope(self, **coords):
        return _Scope(self, coords)

    # --- inspection -----------------------------------------------------

    def snapshot(self) -> list[dict]:
        """The retained event window, oldest first (copies the ring, not
        the event dicts — callers must not mutate events)."""
        return list(self._ring)

    # --- the flight recorder --------------------------------------------

    def set_flight_path(self, path: str | None) -> None:
        """Pre-register where an abnormal-exit dump lands (the chaos
        hard-kill seam knows no outdir at fire time)."""
        self.flight_path = path

    def flight_dump(self, path: str, reason: str, **extra) -> None:
        """Dump the ring atomically to ``path`` with the abnormal-exit
        reason.  Atomic (tmp + fsync + rename + dir-fsync) because the
        dump races the very failure it documents."""
        from shrewd_tpu_torch import resilience as resil

        doc = {"reason": str(reason), "coords": dict(extra),
               "emitted": self.emitted, "dropped": self.dropped,
               "events": self.snapshot()}
        resil.write_json_atomic(path, doc)
        self.flight_dumps += 1

    def maybe_flight_dump(self, reason: str, **extra) -> None:
        """Dump to the pre-registered flight path, if any (best-effort:
        an observability write must never turn one failure into two)."""
        if not self.flight_path:
            return
        try:
            self.flight_dump(self.flight_path, reason, **extra)
        except OSError:
            pass


NULL_TRACER = _NullTracer()

_TRACER = NULL_TRACER


def tracer():
    """The process-wide tracer (the ``NULL_TRACER`` constant while
    tracing is disabled — the zero-overhead default)."""
    return _TRACER


def enable(ring: int = DEFAULT_RING, timestamps: bool = True) -> Tracer:
    """Install a FRESH live tracer (event ordinals restart at 0, so a
    traced run's stream is self-contained) and return it."""
    global _TRACER
    _TRACER = Tracer(ring=ring, timestamps=timestamps)
    return _TRACER


def disable():
    """Back to the no-op constant; returns the tracer that was live (so
    callers can still export/inspect its window)."""
    global _TRACER
    prev = _TRACER
    _TRACER = NULL_TRACER
    return prev


def flight_dump(outdir: str | None, reason: str, **extra) -> str | None:
    """Dump the live tracer's ring to ``<outdir>/flightrec.json``;
    no-op (None) when tracing is disabled or there is no outdir.
    Best-effort like ``maybe_flight_dump``: every caller sits on a
    failure path (quarantine, abort) or in the scheduler loop, and an
    observability write must never turn one failure into two — a full
    disk loses the dump, not the fleet."""
    t = _TRACER
    if not t.enabled or not outdir:
        return None
    import os

    path = os.path.join(outdir, FLIGHT_NAME)
    try:
        os.makedirs(outdir, exist_ok=True)
        t.flight_dump(path, reason, **extra)
    except OSError:
        return None
    return path
