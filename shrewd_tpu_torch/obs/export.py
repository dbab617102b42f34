"""Trace exporters: Perfetto/Chrome ``trace_event`` JSON, stream
normalization, and text summaries (the port's copy of
``shrewd_tpu/obs/export.py``).

The Chrome trace-event format (also loaded by Perfetto's legacy
importer) renders the async pipeline timeline the tracer records:
span events (``ph`` B/E) become *async* begin/end pairs — overlapping
in-flight intervals draw as parallel tracks instead of a malformed
stack — instants stay instants, counters stay counters.  Lanes:

- **pid** = tenant (``args.tenant``; events with no tenant land in the
  shared "campaign" process) — the per-tenant lanes of fleet mode;
- **tid** = ``sp/structure`` when the event carries campaign
  coordinates, else the event category — one thread track per campaign
  lane (dispatch, integrity, chaos, fleet, ...).

Both are assigned in first-seen order (deterministic: the stream itself
is deterministic) and named via metadata events.

``normalize`` strips the only wall-clock-bearing fields (``ts``/
``dur``) so byte-identity of two runs' streams is checkable
(``canonical_bytes``); events with no timestamp export with their
deterministic ``seq`` as the time axis, so a clock-free trace still
renders in order.

Import discipline: stdlib-only.
"""

from __future__ import annotations

import json

#: trace-event phases the tracer emits -> the async phases exported
_ASYNC = {"B": "b", "E": "e"}


def normalize(events: list[dict]) -> list[dict]:
    """Timestamp-normalized view: everything except ``ts``/``dur`` —
    exactly the deterministic identity of the stream."""
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in events]


def canonical_bytes(events: list[dict]) -> bytes:
    """Canonical serialization of the normalized stream (sorted keys,
    tight separators): the byte-identity comparison surface of the
    trace-determinism tests."""
    return json.dumps(normalize(events), sort_keys=True,
                      separators=(",", ":"), default=str).encode()


def _lane(ev: dict) -> str:
    a = ev.get("args", {})
    sp, st = a.get("sp"), a.get("structure")
    if sp is not None and st is not None:
        return f"{sp}/{st}"
    return ev.get("cat", "events")


def _span_id(ev: dict) -> str:
    """Deterministic async-pair id from semantic coordinates: B and E of
    one span carry the same name+coords, so they get the same id."""
    a = ev.get("args", {})
    parts = [ev.get("name", "")]
    for key in ("tenant", "sp", "structure", "b0", "batch_id", "seq_no"):
        if key in a:
            parts.append(f"{key}={a[key]}")
    return ":".join(parts)


def to_trace_event(events: list[dict]) -> dict:
    """Chrome/Perfetto ``trace_event`` document for the event stream."""
    out: list[dict] = []
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    t0 = None
    for ev in events:
        ts = ev.get("ts")
        if ts is not None:
            t0 = ts if t0 is None else min(t0, ts)

    def pid_of(tenant: str) -> int:
        if tenant not in pids:
            pids[tenant] = len(pids) + 1
            out.append({"ph": "M", "name": "process_name",
                        "pid": pids[tenant], "tid": 0,
                        "args": {"name": tenant}})
        return pids[tenant]

    def tid_of(pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name",
                        "pid": pid, "tid": tids[key],
                        "args": {"name": lane}})
        return tids[key]

    for ev in events:
        tenant = str(ev.get("args", {}).get("tenant", "campaign"))
        pid = pid_of(tenant)
        tid = tid_of(pid, _lane(ev))
        ts = ev.get("ts")
        # clock-free traces render on the deterministic seq axis (µs
        # ticks); timed ones on microseconds from the earliest event
        us = (float(ev["seq"]) if ts is None
              else (ts - (t0 or 0.0)) * 1e6)
        ph = ev.get("ph", "i")
        rec = {"name": ev.get("name", ""), "cat": ev.get("cat", ""),
               "pid": pid, "tid": tid, "ts": us,
               "args": dict(ev.get("args", {}))}
        if ph in _ASYNC:
            rec["ph"] = _ASYNC[ph]
            rec["id"] = _span_id(ev)
        elif ph == "C":
            rec["ph"] = "C"
            val = rec["args"].pop("value", 0)
            rec["args"] = {ev.get("name", "value"): val}
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def summarize(events: list[dict]) -> dict:
    """Counts + span statistics: events by name/category, span
    wall-durations (where both ends carried timestamps), and the
    distinct tenants/lanes seen — ``tools/obs.py --summarize``."""
    by_name: dict[str, int] = {}
    by_cat: dict[str, int] = {}
    tenants: set = set()
    lanes: set = set()
    open_spans: dict[str, float | None] = {}
    durs: dict[str, list[float]] = {}
    for ev in events:
        by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
        by_cat[ev.get("cat", "")] = by_cat.get(ev.get("cat", ""), 0) + 1
        a = ev.get("args", {})
        if "tenant" in a:
            tenants.add(str(a["tenant"]))
        lanes.add(_lane(ev))
        ph = ev.get("ph")
        if ph == "B":
            open_spans[_span_id(ev)] = ev.get("ts")
        elif ph == "E":
            t_b = open_spans.pop(_span_id(ev), None)
            ts = ev.get("ts")
            if t_b is not None and ts is not None:
                durs.setdefault(ev["name"], []).append(ts - t_b)
    span_stats = {
        name: {"count": len(ds),
               "total_s": round(sum(ds), 6),
               "max_s": round(max(ds), 6)}
        for name, ds in sorted(durs.items())}
    return {"events": sum(by_name.values()),
            "by_name": dict(sorted(by_name.items())),
            "by_cat": dict(sorted(by_cat.items())),
            "tenants": sorted(tenants),
            "lanes": sorted(lanes),
            "spans": span_stats,
            "unclosed_spans": len(open_spans)}


def render_text(events: list[dict], width: int = 100) -> str:
    """Human-readable timeline of an event stream / flight-recorder
    window: one line per event, seq-ordered, with span nesting marks."""
    lines = []
    for ev in events:
        a = ev.get("args", {})
        coord = " ".join(f"{k}={a[k]}" for k in sorted(a))
        mark = {"B": "+", "E": "-", "C": "#"}.get(ev.get("ph"), ".")
        ts = ev.get("ts")
        stamp = f"{ts:.6f}" if ts is not None else f"@{ev['seq']}"
        line = (f"{ev['seq']:>6} {stamp:>14} {mark} "
                f"{ev.get('cat', ''):<10} {ev['name']:<24} {coord}")
        lines.append(line[:width])
    return "\n".join(lines)
