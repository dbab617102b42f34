"""Debug flags + DPRINTF analog (the port's copy of
``shrewd_tpu/utils/debug.py``).

Re-imagines gem5's compile-time debug-flag registry plus runtime selection
(``src/base/trace.hh:203-244``, ``src/base/debug.{hh,cc}``,
``--debug-flags=...`` in ``src/python/m5/main.py``): here flags are a plain
runtime registry; ``dprintf`` is a no-op unless its flag is enabled.  Host-side
only.
"""

from __future__ import annotations

import os
import sys
import time

_registry: dict[str, str] = {}
_enabled: set[str] = set()
_compound: dict[str, tuple[str, ...]] = {}
_t0 = time.monotonic()


def register_flag(name: str, desc: str = "") -> None:
    _registry[name] = desc


def register_compound(name: str, members: tuple[str, ...], desc: str = "") -> None:
    _registry[name] = desc
    _compound[name] = members


def all_flags() -> dict[str, str]:
    return dict(_registry)


def enable(*names: str) -> None:
    unknown = [n for n in names if n not in _registry]
    if unknown:
        raise KeyError(f"unknown debug flags {unknown!r} "
                       f"(known: {sorted(_registry)})")
    for name in names:
        _enabled.add(name)
        for member in _compound.get(name, ()):
            _enabled.add(member)


def disable(*names: str) -> None:
    unknown = [n for n in names if n not in _registry]
    if unknown:
        raise KeyError(f"unknown debug flags {unknown!r} "
                       f"(known: {sorted(_registry)})")
    for name in names:
        _enabled.discard(name)
        for member in _compound.get(name, ()):
            _enabled.discard(member)


def enabled(name: str) -> bool:
    return name in _enabled


def enable_from_env(var: str = "SHREWD_DEBUG_FLAGS") -> None:
    """Honor e.g. ``SHREWD_DEBUG_FLAGS=Campaign,Replay`` (the --debug-flags CLI analog)."""
    val = os.environ.get(var, "")
    if val:
        enable(*[f for f in val.split(",") if f])


def dprintf(flag: str, fmt: str, *args) -> None:
    if flag in _enabled:
        t = time.monotonic() - _t0
        sys.stderr.write(f"{t:12.6f}: {flag}: {fmt % args if args else fmt}\n")


# Core flags (consumers register their own alongside their module).
register_flag("Campaign", "campaign orchestration events")
register_flag("Replay", "trial replay kernel tracing")
register_flag("Inject", "fault injection coordinates")
register_flag("Stats", "statistics dump/reset events")
register_flag("Checkpoint", "campaign checkpoint/restore")
register_flag("Native", "C++ runtime bindings")
register_compound("All", ("Campaign", "Replay", "Inject", "Stats", "Checkpoint", "Native"))
