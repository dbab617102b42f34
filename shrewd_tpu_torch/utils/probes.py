"""Typed probe framework — decoupled pub/sub instrumentation (the port's
copy of ``shrewd_tpu/utils/probes.py``).

Analog of gem5's probe bus (``src/sim/probe/probe.hh:101-161``): models expose
named ``ProbePoint``s; listeners attach without the model knowing who is
observing.  In the batched design probes fire on the *host* at batch
granularity (a notify carries a whole batch's worth of data, e.g. the outcome
vector of a trial batch), since per-trial host callbacks would defeat the
device pipeline.
"""

from __future__ import annotations

from typing import Any, Callable


class ProbePoint:
    """A named instrumentation point; ``notify`` fans out to listeners."""

    def __init__(self, manager: "ProbeManager", name: str):
        self.manager = manager
        self.name = name
        self._listeners: list[Callable[[Any], None]] = []

    def connect(self, fn: Callable[[Any], None]) -> None:
        self._listeners.append(fn)

    def disconnect(self, fn: Callable[[Any], None]) -> None:
        self._listeners.remove(fn)

    def notify(self, payload: Any) -> None:
        for fn in self._listeners:
            fn(payload)


class ProbeManager:
    """Per-object registry of probe points (``ProbeManager``, probe.hh:161)."""

    def __init__(self, owner_name: str):
        self.owner_name = owner_name
        self._points: dict[str, ProbePoint] = {}

    def add_point(self, name: str) -> ProbePoint:
        if name in self._points:
            raise KeyError(f"duplicate probe point {name!r} on {self.owner_name}")
        pp = ProbePoint(self, name)
        self._points[name] = pp
        return pp

    def get(self, name: str) -> ProbePoint:
        return self._points[name]

    def listen(self, name: str, fn: Callable[[Any], None]) -> None:
        self._points[name].connect(fn)

    def points(self) -> list[str]:
        return sorted(self._points)
