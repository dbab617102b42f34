"""Collate the window-scaling story from ``tools.bigwindow`` documents —
the port of the JAX package's ``tools/window_scale_r05.py``, run as
``python -m shrewd_tpu_torch.tools.window_scale``.

Collates: the lift pipeline at every length, dense vs chunked rates on
one platform, the resolution statistics, and the honest scaling model:

  per-trial work (exact)    ≈ S·E[chunks replayed]  — resolution-mix
                              dependent (SDC-heavy trials carry to the
                              window end)
  per-trial work (horizon)  ≤ S·(horizon+1)         — bounded, with only
                              vulnerable-preserving relabelings

Where the port departs from the reference (ROADMAP Queue 3 D9):

- **Measured numbers only.**  The reference writes a CPU and a TPU round's
  numbers into its document by hand and projects TPU rates from CPU ones
  by a measured TPU/CPU ratio (its ``dense_cpu_r4``, ``dense_tpu_r4`` and
  ``tpu_projection``).  The port fills the same structure only from the
  ``bigwindow`` documents it reads: ``--dense`` (a dense ``--rate`` run),
  ``--chunked`` (an exact ``--rate --chunked`` run) and ``--big-rate`` (a
  ``--rate --chunked --horizon`` run); ``build`` comes from whichever of
  them ran ``--build``.  It projects nothing.
- **Resolution statistics** per chunked window: ``per_trial_lane_steps_
  real`` is ``lanes_run * S / batch`` with the window's own chunk length
  ``S = min(chunk, n)`` (the reference's arithmetic, which fixes S at
  65536).
- **One platform and one card.**  Every document read must come from the
  ``--platform`` asked for (the card by default) and name one card; the
  collation records ``platform`` and ``card``.
- **Output path.**  ``--out``, by default ``window_scale_torch.json`` in
  the current directory.

Usage: python -m shrewd_tpu_torch.tools.window_scale --dense d.json
           --chunked c.json [--big-rate h.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

NOTES = [
    "chunked == dense outcomes bit-for-bit (tests/test_torch_bigwindow.py; "
    "chip_smoke.py phase 24 on the 4096-µop window)",
    "exact chunked pays for the resolution mix: divergent trials replay "
    "to the window end, so exact per-trial work grows with the SDC share "
    "and chunking's win is the masked/frozen fraction",
    "carry_horizon bounds per-trial work at (horizon+1) chunks with only "
    "masked→SDC / DUE→SDC relabelings (vulnerable set never shrinks)",
    "every rate is one bigwindow run's median on the platform and card "
    "recorded here; no number is projected",
]


def resolution(row: dict, chunk: int) -> dict | None:
    """A chunked row's resolution statistics with the real lane-steps a
    trial costs (lanes run × chunk length / batch; padded lanes
    excluded).  ``chunk`` is the window's own chunk length: the chunk
    asked for, or the window where it is shorter."""
    res = row.get("resolution") or {}
    if not (res.get("chunk_replays") and row.get("batch")):
        return None
    return {"lanes_run": res["lanes_run"],
            "chunk_replays": res["chunk_replays"], "batch": row["batch"],
            "chunk": chunk,
            "per_trial_lane_steps_real": int(
                res["lanes_run"] * chunk / row["batch"])}


def collate(docs: dict, platform: str) -> dict:
    """{"dense" | "chunked" | "big_rate": bigwindow document} → the
    collation.  Raises ``ValueError`` on a document of another platform,
    two cards, or a document of the wrong mode."""
    cards = set()
    for name, d in docs.items():
        if d.get("platform") != platform:
            raise ValueError(f"--{name.replace('_', '-')}: a "
                             f"{d.get('platform')} document, not {platform}")
        cards.add(d.get("card"))
    if len(cards) > 1:
        raise ValueError(f"documents from more than one card: {cards}")
    doc = {"platform": platform, "card": cards.pop() if cards else None,
           "build": {}}
    for d in docs.values():
        b = d.get("build")
        if b:
            doc["build"][Path(d["workload"]).stem] = {
                "capture_steps": b["capture_steps"],
                "capture_seconds": b["capture_seconds"],
                "lifts": {str(v["uops"]): v["lift_rate"] for k, v in
                          b.items() if k.startswith("lift_")}}
    want = {"dense": "dense", "chunked": "chunked", "big_rate": "chunked"}
    rates = {}
    for name, d in docs.items():
        r = d.get("rate")
        if r is None:
            continue
        if r["mode"] != want[name]:
            raise ValueError(f"--{name.replace('_', '-')}: a {r['mode']} "
                             f"rate document")
        rates[name] = r
    if "dense" in rates:
        doc["dense"] = {n: row["trials_per_sec"]
                        for n, row in rates["dense"]["rates"].items()}
    if "chunked" in rates:
        doc["chunked_exact"] = {
            n: row["trials_per_sec"]
            for n, row in rates["chunked"]["rates"].items()}
    if "big_rate" in rates:
        doc["chunked_horizon"] = dict(rates["big_rate"]["rates"])
    for name in ("chunked", "big_rate"):
        if name not in rates:
            continue
        for n, row in rates[name]["rates"].items():
            res = resolution(row, min(rates[name]["chunk"], int(n)))
            if res is not None:
                doc.setdefault("resolution", {}).setdefault(
                    name, {})[n] = res
    doc["notes"] = NOTES
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shrewd_tpu_torch.tools.window_scale")
    ap.add_argument("--dense", default=None,
                    help="a bigwindow --rate document")
    ap.add_argument("--chunked", default=None,
                    help="a bigwindow --rate --chunked document (exact)")
    ap.add_argument("--big-rate", default=None,
                    help="a bigwindow --rate --chunked --horizon document")
    ap.add_argument("--out", default="window_scale_torch.json")
    ap.add_argument("--platform", default=None,
                    help="cpu | gpu (default: the card)")
    a = ap.parse_args(argv)

    from shrewd_tpu_torch.tools.northstar import device_of, platform_name

    platform = platform_name(device_of(a.platform))
    docs = {name: json.loads(Path(p).read_text()) for name, p in (
        ("dense", a.dense), ("chunked", a.chunked),
        ("big_rate", a.big_rate)) if p is not None}
    if not docs:
        ap.error("give at least one of --dense, --chunked, --big-rate")
    try:
        doc = collate(docs, platform)
    except ValueError as e:
        print(f"window_scale: {e}", file=sys.stderr)
        return 2
    with open(a.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({
        "chunked_horizon": {n: r.get("trials_per_sec") for n, r in
                            doc.get("chunked_horizon", {}).items()},
        "resolution": doc.get("resolution", {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
