"""The ONE sanctioned clock seam for instrumented modules (the port's copy
of ``shrewd_tpu/obs/clock.py``).

Every deterministic layer of this codebase promises that wall clock never
enters a trigger, schedule or replay decision (graftlint GL102), yet
observability *needs* timestamps — perf ledgers, event times, queue
latencies.  The resolution is a single seam: instrumented modules read
time only through this module (enforced by graftlint GL106), so

- every clock read in an instrumented region is auditable at one import
  site rather than scattered ``time.*`` calls;
- tests can install a fake clock (``install``) and get fully
  deterministic timestamps — the trace-determinism tests normalize
  timestamps away, and the fake clock proves nothing else leaks;
- the no-wall-clock-in-decisions contract stays checkable: GL102 keeps
  banning ``time.time`` in deterministic modules, and this module is the
  one place that carries the waiver.

Import discipline: stdlib-only (the seam must be importable everywhere,
including processes that never touch the card).
"""

from __future__ import annotations

import time

# test-seam overrides (None = the real clocks).  ``install`` swaps both
# at once so a fake clock cannot mix real and fake time bases.
_mono_override = None
_wall_override = None


def monotonic() -> float:
    """Monotonic seconds — interval/perf timing (never schedule-bearing)."""
    if _mono_override is not None:
        return _mono_override()
    return time.monotonic()


def now() -> float:
    """Wall-clock epoch seconds — event timestamps and cross-process
    latency observability ONLY (the GL102 contract: no trigger, schedule
    or replay decision may consume this)."""
    if _wall_override is not None:
        return _wall_override()
    # graftlint: allow-wall-clock -- this IS the sanctioned wall-clock
    # seam: the one audited read every instrumented module routes
    # through (GL106), used only for timestamps/latency observability
    return time.time()


def install(mono=None, wall=None) -> None:
    """Install fake clocks (tests): ``mono``/``wall`` are zero-arg
    callables returning seconds.  ``None`` leaves that clock real."""
    global _mono_override, _wall_override
    _mono_override = mono
    _wall_override = wall


def reset() -> None:
    """Restore the real clocks (test teardown)."""
    install(None, None)
