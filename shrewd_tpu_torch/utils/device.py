"""Where the port's entry points run, and the host-sync seam.

``resolve`` picks the device: the CUDA card unless the caller asks for
another.  (The JAX package ran on JAX's default device; it has no
counterpart of this module.)

The seam marks the host reads a campaign step makes by design.  On the card
every read of a device tensor (``item``, ``tolist``, ``cpu``, a
``torch.nonzero``, …) stops the host until the card has caught up.  A step
that reads more than it was designed to read costs that stall on every
batch, and a read the design did not plan is also a hidden channel that the
certificate must see (``analysis/step_audit.py``).  So:

- ``host_sync(reason)`` wraps a designed control read (the escape count
  that sizes the exact re-run, the until-CI stop flag, a lazily built host
  table); the auditor counts it under its reason and does not flag it;
- ``result_copy()`` wraps the one copy of a step's result to the host
  (``parallel/campaign.py _to_host``); the auditor counts it as a transfer.

Outside an audit both cost one thread-local list append and pop.
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: the reason of the step's result copy (``result_copy``)
RESULT = "result"

_LOCAL = threading.local()


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; any
    other value is taken as given (``"cpu"`` runs on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _reasons() -> list:
    stack = getattr(_LOCAL, "reasons", None)
    if stack is None:
        stack = _LOCAL.reasons = []
    return stack


@contextlib.contextmanager
def host_sync(reason: str):
    """Mark the host reads inside as designed, under ``reason``."""
    stack = _reasons()
    stack.append(reason)
    try:
        yield
    finally:
        stack.pop()


def sync_reason() -> str | None:
    """The innermost ``host_sync`` reason of this thread, or None."""
    stack = getattr(_LOCAL, "reasons", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def result_copy():
    """Mark the step's one device→host result copy (a transfer)."""
    obs = observer()
    if obs is not None:
        obs.result_copy()
    with host_sync(RESULT):
        yield


def observer():
    """The audit session watching this thread (``analysis/step_audit.py``),
    or None."""
    return getattr(_LOCAL, "observer", None)


def set_observer(obs) -> object:
    """Install ``obs`` as this thread's audit session → the previous one."""
    prev = observer()
    _LOCAL.observer = obs
    return prev


def worker_context(obs):
    """The context a step's worker thread runs in: the audit session
    ``obs`` (taken from the dispatching thread with ``observer()``)
    watching this thread too, or nothing."""
    return obs.watch() if obs is not None else contextlib.nullcontext()
