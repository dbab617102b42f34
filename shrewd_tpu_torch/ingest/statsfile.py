"""``stats.txt`` reader (the port's copy of
``shrewd_tpu/ingest/statsfile.py``).

Parses the reference's text stat dumps (``src/base/stats/text.cc`` layout:
``name  value  # desc`` rows between ``Begin``/``End`` marker lines; one
block per dump/reset epoch) into a list of ``{name: value}`` dicts — the
ingestion side of the golden-diff test pattern (MatchStdout analog,
``tests/gem5/verifier.py:158``). Reads this framework's own
``stats.dump_text`` output too (same layout by construction).
"""

from __future__ import annotations

_BEGIN = "---------- Begin Simulation Statistics ----------"
_END = "---------- End Simulation Statistics   ----------"


def _parse_value(tok: str) -> float | str:
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok  # e.g. 'nan' parses above; symbolic values stay strings


def load_stats_txt(path_or_file) -> list[dict[str, float]]:
    """All dump blocks in file order. A file with no Begin markers is read
    as a single block (some tools strip them)."""
    if hasattr(path_or_file, "read"):
        lines = path_or_file.read().splitlines()
    else:
        with open(path_or_file) as f:
            lines = f.read().splitlines()

    blocks: list[dict[str, float]] = []
    current: dict[str, float] | None = None
    saw_marker = False
    for line in lines:
        stripped = line.strip()
        if stripped.startswith(_BEGIN):
            saw_marker = True
            current = {}
            blocks.append(current)
            continue
        if stripped.startswith(_END):
            current = None
            continue
        if not stripped:
            continue
        if current is None:
            if saw_marker:
                continue  # prose between blocks
            current = {}
            blocks.append(current)
        payload = stripped.split("#", 1)[0].strip()  # drop desc comment
        if not payload:
            continue
        parts = payload.split()
        if len(parts) < 2:
            continue  # tolerate prose lines (simulation banners)
        name, raw = parts[0], parts[1]
        current[name] = _parse_value(raw)
    return [b for b in blocks if b]


def diff_stats(a: dict[str, float], b: dict[str, float],
               rel_tol: float = 0.0,
               ignore: tuple[str, ...] = ()) -> list[str]:
    """Names whose values differ beyond rel_tol, plus one-sided keys —
    the MatchStdoutNoPerf-style masked comparison
    (reference ``tests/gem5/verifier.py:181``)."""
    bad: list[str] = []
    keys = set(a) | set(b)
    for k in sorted(keys):
        if any(k.startswith(p) for p in ignore):
            continue
        if k not in a or k not in b:
            bad.append(k)
            continue
        va, vb = a[k], b[k]
        if isinstance(va, str) or isinstance(vb, str):
            if str(va) != str(vb):
                bad.append(k)
            continue
        a_nan = isinstance(va, float) and va != va
        b_nan = isinstance(vb, float) and vb != vb
        if a_nan or b_nan:
            if a_nan != b_nan:   # nan on one side only is always a diff
                bad.append(k)
            continue
        if va != vb:
            denom = max(abs(va), abs(vb))
            if denom == 0 or abs(va - vb) / denom > rel_tol:
                bad.append(k)
    return bad
