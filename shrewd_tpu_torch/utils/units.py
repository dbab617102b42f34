"""Unit parsing/formatting for typed params (the port's copy of
``shrewd_tpu/utils/units.py``).

Re-imagines the conversion helpers behind gem5's param types
(``src/python/m5/params.py:155`` and ``src/base/str.hh``): human-friendly
strings like ``"2GiB"``, ``"3GHz"``, ``"10ns"`` convert to canonical integers
or floats.  Canonical units: bytes, hertz, seconds, ticks.
"""

from __future__ import annotations

import math
import re

# Binary-prefix multipliers (memory sizes).  gem5 treats "MB" as 2**20 for
# memory params; we accept both IEC ("MiB") and JEDEC-style ("MB") spellings
# as binary.  The trailing B/b is optional and always means bytes.
_BINARY = {
    "": 1,
    "k": 1 << 10, "ki": 1 << 10,
    "m": 1 << 20, "mi": 1 << 20,
    "g": 1 << 30, "gi": 1 << 30,
    "t": 1 << 40, "ti": 1 << 40,
    "p": 1 << 50, "pi": 1 << 50,
}

# Metric multipliers (frequencies).
_METRIC = {"": 1.0, "k": 1e3, "m": 1e6, "g": 1e9, "t": 1e12}

# Time suffix → seconds.
_TIME = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9, "ps": 1e-12, "fs": 1e-15}

_NUM = r"([0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)"


class UnitError(ValueError):
    pass


def to_bytes(value: str | int | float) -> int:
    """``"2GiB"`` / ``"64kB"`` / ``4096`` → bytes (int)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if value != int(value):
            raise UnitError(f"memory size is not a whole number of bytes: {value!r}")
        return int(value)
    if not isinstance(value, str):
        raise UnitError(f"cannot parse memory size: {value!r}")
    m = re.fullmatch(_NUM + r"\s*([KkMmGgTtPp]i?)?[Bb]?", value.strip())
    if not m:
        raise UnitError(f"cannot parse memory size: {value!r}")
    num, prefix = m.group(1), (m.group(2) or "").lower()
    out = float(num) * _BINARY[prefix]
    if out != int(out):
        raise UnitError(f"memory size is not a whole number of bytes: {value!r}")
    return int(out)


def to_frequency(value: str | float | int) -> float:
    """``"3GHz"`` / ``"200MHz"`` / ``1e9`` → hertz (float)."""
    if isinstance(value, (int, float)):
        return float(value)
    m = re.fullmatch(_NUM + r"\s*([KkMmGgTt])?[Hh]z", value.strip())
    if not m:
        raise UnitError(f"cannot parse frequency: {value!r}")
    return float(m.group(1)) * _METRIC[(m.group(2) or "").lower()]


def to_seconds(value: str | float | int) -> float:
    """``"10ns"`` / ``"1.5us"`` / ``2e-9`` → seconds (float)."""
    if isinstance(value, (int, float)):
        return float(value)
    m = re.fullmatch(_NUM + r"\s*(fs|ps|ns|us|ms|s)", value.strip())
    if not m:
        raise UnitError(f"cannot parse time: {value!r}")
    return float(m.group(1)) * _TIME[m.group(2)]


def format_bytes(n: int) -> str:
    for suffix, mult in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= mult and n % mult == 0:
            return f"{n // mult}{suffix}"
    return f"{n}B"


def format_count(n: float) -> str:
    """Human-friendly count: 12500000 → '12.5M'."""
    if n == 0:
        return "0"
    # Round to 3 significant digits BEFORE choosing the suffix, so boundary
    # values promote cleanly (999999 → '1M', never '1e+03k').
    exp = math.floor(math.log10(abs(n)))
    r = round(n, -(exp - 2))
    if abs(r) >= 1e15:
        return f"{r:.4g}"     # beyond the suffix table: plain e-notation
    for suffix, mult in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(r) >= mult:
            return f"{r / mult:.4g}{suffix}"
    return f"{r:.4g}"
