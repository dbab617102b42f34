"""Pipeline-activity viewer: render scoreboard timestamps as per-µop
timelines (SURVEY §5.1 trace visualization; the port's copy of
``shrewd_tpu/trace/pipeview.py``).

Reference role: gem5's O3PipeView flow — the O3 probe emits per-inst stage
ticks and ``util/o3-pipeview.py`` renders them as aligned ASCII timelines.
Here the scoreboard timing model (models/timing.py) already holds every
stage timestamp, so the renderer reads it directly — no trace file, no
second pass.

One row per µop::

    [.D==I**W...C]   17: add    r5, r3, r7

``D`` dispatch, ``I`` issue, ``W`` writeback, ``C`` commit; ``=`` waiting
in the IQ (dispatched, not yet issued), ``*`` executing (issued, result
not yet written back), ``.`` elsewhere-in-flight (ROB residency).  The
window auto-scales: cycles compress by ``scale`` when the span exceeds
``max_width`` columns.
"""

from __future__ import annotations

import sys
from typing import IO

from shrewd_tpu_torch.trace.exec_trace import disassemble


def render_row(dispatch: int, issue: int, writeback: int, commit: int,
               t0: int, t1: int, scale: int) -> str:
    """One µop's timeline over display window [t0, t1)."""
    cols = (t1 - t0 + scale - 1) // scale

    def col(t: int) -> int:
        return min(max((t - t0) // scale, 0), cols - 1)

    row = [" "] * cols

    def paint(a: int, b: int, ch: str) -> None:
        """Fill columns covering cycle range [a, b) — per COLUMN, not per
        cycle (a 192-cycle ROB residency must not cost 192 writes for at
        most max_width columns)."""
        a, b = max(a, t0), min(b, t1)
        if a < b:
            for c in range(col(a), col(b - 1) + 1):
                row[c] = ch

    paint(dispatch, commit + 1, ".")
    paint(dispatch, issue, "=")
    paint(issue, writeback, "*")
    # stage markers last so they survive compression
    if t0 <= dispatch < t1:
        row[col(dispatch)] = "D"
    if t0 <= issue < t1:
        row[col(issue)] = "I"
    if t0 <= writeback < t1:
        row[col(writeback)] = "W"
    if t0 <= commit < t1:
        row[col(commit)] = "C"
    return "".join(row)


def dump_pipeview(trace, scoreboard, out: IO = None, start: int = 0,
                  count: int = 32, max_width: int = 100) -> int:
    """Render ``count`` µops from ``start`` as aligned pipeline timelines.
    Returns the number of rows written."""
    out = out or sys.stderr
    n = trace.n
    start = min(max(start, 0), n)
    end = min(n, start + max(count, 0))
    if end <= start:
        return 0
    sb = scoreboard
    t0 = int(sb.dispatch[start])
    t1 = int(sb.commit[end - 1]) + 1
    scale = max(1, -(-(t1 - t0) // max_width))
    hdr = (f"cycles [{t0}, {t1}) at {scale}/col — "
           "D dispatch, = in IQ, I issue, * executing, W writeback, "
           ". in ROB, C commit")
    print(hdr, file=out)
    for i in range(start, end):
        line = render_row(int(sb.dispatch[i]), int(sb.issue[i]),
                          int(sb.writeback[i]), int(sb.commit[i]),
                          t0, t1, scale)
        print(f"[{line}] {i:6d}: {disassemble(trace, i)}", file=out)
    return end - start
