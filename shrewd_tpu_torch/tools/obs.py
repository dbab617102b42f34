"""Observability CLI — the operator surface over ``shrewd_tpu_torch/obs/``
(the port of the JAX package's ``tools/obs.py``, with its flags), run as
``python -m shrewd_tpu_torch.tools.obs``.

Three modes:

- **summarize** — event counts, span statistics, tenants and lanes of a
  trace artifact (a raw event stream, a ``flightrec.json`` dump, or a
  Perfetto ``trace.json``)::

      python -m shrewd_tpu_torch.tools.obs --summarize out/trace.json

- **timeline** — human-readable seq-ordered rendering of a flight
  recorder dump (the "why did this tenant quarantine" artifact)::

      python -m shrewd_tpu_torch.tools.obs --timeline \
          fleet_out/flightrec.json

- **tail** — the live fleet metrics snapshot the resident scheduler
  publishes each tick (``metrics.json`` / ``metrics.prom``)::

      python -m shrewd_tpu_torch.tools.obs --tail fleet_out   # one-shot
      python -m shrewd_tpu_torch.tools.obs --tail fleet_out --follow

All three read artifacts only — they never touch scheduler or
orchestrator internals, which is the point: everything an operator
needs is in the published files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


#: Perfetto async phases back to the tracer's span phases
_FROM_ASYNC = {"b": "B", "e": "E"}


def load_doc(path: str):
    with open(path) as f:
        return json.load(f)


def events_of(doc, path: str) -> list[dict]:
    """Events from any trace artifact this repo writes: a raw event
    list, a flight-recorder dump (``{"events": [...]}``) or a Perfetto
    ``trace_event`` document (``{"traceEvents": [...]}`` — metadata
    records are dropped, async phases map back to B/E)."""
    if isinstance(doc, list):
        return doc
    if "events" in doc:
        return doc["events"]
    if "traceEvents" in doc:
        out = []
        for i, rec in enumerate(r for r in doc["traceEvents"]
                                if r.get("ph") != "M"):
            # a Perfetto doc's ts axis is microseconds-from-t0 (or the
            # bare seq ordinal for clock-free traces) — not the second-
            # denominated timestamps summarize's span durations expect.
            # Drop it: counts/lanes/pairing still summarize; durations
            # come from the raw stream artifacts (flightrec.json).
            out.append({"seq": i, "name": rec.get("name", ""),
                        "cat": rec.get("cat", ""),
                        "ph": _FROM_ASYNC.get(rec.get("ph"),
                                              rec.get("ph", "i")),
                        "args": rec.get("args", {}),
                        "ts": None})
        return out
    raise ValueError(f"{path}: not a recognized trace artifact "
                     "(raw events / flightrec.json / trace.json)")


def cmd_summarize(path: str) -> int:
    from shrewd_tpu_torch.obs import export

    doc = load_doc(path)
    summary = export.summarize(events_of(doc, path))
    if isinstance(doc, dict) and "reason" in doc:
        # flight-recorder dumps carry the abnormal-exit reason — the
        # first thing a post-mortem wants to see
        summary = {"reason": doc["reason"], "coords": doc.get("coords"),
                   "emitted": doc.get("emitted"),
                   "dropped": doc.get("dropped"), **summary}
    print(json.dumps(summary, indent=1))
    return 0


def cmd_timeline(path: str, width: int) -> int:
    from shrewd_tpu_torch.obs import export

    doc = load_doc(path)
    if isinstance(doc, dict) and "reason" in doc:
        _log(f"flight recorder: reason={doc['reason']} "
             f"coords={doc.get('coords')} emitted={doc.get('emitted')} "
             f"dropped={doc.get('dropped')}")
    print(export.render_text(events_of(doc, path), width=width))
    return 0


def _render_snapshot(snap: dict) -> str:
    fleet = snap.get("fleet", {})
    lines = [f"tick {snap.get('tick', 0)}: "
             f"{fleet.get('tenants', 0)} tenants {fleet.get('by_status')}"
             f" fairness={fleet.get('fairness_index')}"
             f" cache_hit={fleet.get('cache_hit_rate')}"
             f" journal_depth={fleet.get('journal_depth')}"]
    for name, row in sorted(snap.get("tenants", {}).items()):
        hw = row.get("halfwidth") or {}
        hw_s = (" hw=" + ",".join(f"{k}:{v}" for k, v in sorted(hw.items()))
                if hw else "")
        lines.append(
            f"  {name}: {row.get('status')} trials={row.get('trials')}"
            f" ({row.get('trials_per_s')}/s) vtime={row.get('vtime')}"
            f" ticks={row.get('ticks')}"
            + (f" failures={row['failures']}" if row.get("failures") else "")
            + (f" eta={row['eta_trials']:g}tr"
               + (f"/{row['eta_s']:g}s" if row.get("eta_s") is not None
                  else "")
               if row.get("eta_trials") is not None else "")
            + hw_s)
    return "\n".join(lines)


def cmd_tail(outdir: str, follow: bool, interval: float) -> int:
    from shrewd_tpu_torch.obs import metrics

    last_tick = None
    while True:
        try:
            snap = metrics.read(outdir)
        except (OSError, ValueError):
            if not follow:
                _log(f"{outdir}: no metrics.json (is the fleet serving "
                     "with an --outdir?)")
                return 1
            time.sleep(interval)
            continue
        if snap.get("tick") != last_tick:
            last_tick = snap.get("tick")
            print(_render_snapshot(snap), flush=True)
        if not follow:
            return 0
        time.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="trace/metrics/flight-recorder tooling "
                    "(shrewd_tpu_torch/obs/)")
    ap.add_argument("--summarize", metavar="TRACE",
                    help="event counts + span statistics of a trace "
                         "artifact (raw events / flightrec.json / "
                         "Perfetto trace.json)")
    ap.add_argument("--timeline", metavar="FLIGHTREC",
                    help="render a flight-recorder dump (or any event "
                         "stream) as a seq-ordered timeline")
    ap.add_argument("--tail", metavar="OUTDIR",
                    help="print the fleet's latest metrics snapshot")
    ap.add_argument("--follow", action="store_true",
                    help="[tail] keep polling; print on every new tick")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="[tail --follow] poll seconds (default 1)")
    ap.add_argument("--width", type=int, default=100,
                    help="[timeline] max line width")
    a = ap.parse_args(argv)

    if a.summarize:
        return cmd_summarize(a.summarize)
    if a.timeline:
        return cmd_timeline(a.timeline, a.width)
    if a.tail:
        try:
            return cmd_tail(a.tail, a.follow, a.interval)
        except KeyboardInterrupt:
            return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:      # `--timeline ... | head` is normal
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
