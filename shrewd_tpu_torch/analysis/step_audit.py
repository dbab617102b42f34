"""Replay-safety certification of the port's campaign steps (the port's
counterpart of ``shrewd_tpu/analysis/jaxpr_audit.py``).

Every campaign step computes a tally that the framework promises is a pure
function of its frozen PRNG keys: that promise is what makes recovery,
degradation, elasticity and pipelining bit-identical.  The JAX package
proves the program-level preconditions from a step's jaxpr and lowered HLO.
The port has neither: a torch step is Python that launches kernels as it
runs.  So the port certifies a step by running it once, on example
arguments, under two of torch's interception modes:

- a ``TorchFunctionMode`` sees every call at the Python level.  It is the
  only place where a host read shows on the CPU: ``tolist``, ``cpu`` and
  ``numpy`` of a CPU tensor dispatch nothing, and a census built from aten
  ops alone would certify on the CPU a step that stalls the card;
- a ``TorchDispatchMode`` sees every aten op: the RNG ops, the ops that
  write an argument in place, and the op count.

The rules, each the counterpart of one of the reference's:

- **RNG lineage** — no aten op that draws from a torch ``Generator``
  (``FORBIDDEN_RNG``): every random bit comes from the counter-based
  threefry of ``utils/prng.py``, which runs as plain integer ops;
- **no hidden host channel** — a host read (``CALLBACK_PRIMS``: ``item``,
  ``tolist``, ``numpy``, ``cpu``, ``to`` a CPU device, ``__bool__``, …) or a
  data-dependent-shape op (``DATA_DEPENDENT``: ``nonzero``,
  ``masked_select``, ``unique``, a boolean-mask index, …) outside the
  host-sync seam (``utils/device.py host_sync``) and outside the result
  copy (``result_copy``) is a ``side-effect`` violation;
- **transfer budget** — ``transfers`` counts the step's result copies
  (``parallel/campaign.py _to_host``) plus its unsanctioned host reads, the
  counterpart of the reference's one ``device_get`` plus one per callback;
  it must stay within ``transfer_budget``;
- **donation** — an aten op whose schema writes an argument
  (``alias_info.is_write``) that shares storage with one of the example
  arguments mutates the caller's data; it must be declared.

The counts are dynamic: one call, one count.  The reference's are static,
so a loop body that reads the host S times reads 1 + S here against its 2
(ROADMAP Queue 3 D6).  Designed control reads (the escape count that sizes
the exact re-run, the until-CI stop flag) are counted in ``syncs`` under
their reason and are not violations.

``syncs`` is the census of the call's host syncs by reason.  On the card it
counts what stalls there: reads of CUDA tensors, the data-dependent ops
(``bincount`` twice: its minimum and maximum), and blocking host→device
copies (reason ``upload`` outside the seam); ``sync_debug=True`` also
counts torch's own ``set_sync_debug_mode("warn")`` warnings over the same
call, which ``chip_smoke.py`` and the card tests hold the census against.
On the CPU it counts the same calls as if their tensors lay on the card,
but for uploads, which the CPU cannot tell from no-ops.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import warnings
from collections import Counter

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from shrewd_tpu_torch.utils import device as devmod

#: the frozen-key threefry lineage (``utils/prng.py``): pure functions of
#: their key operands, built from integer aten ops — sanctioned
ALLOWED_RNG = frozenset({
    "threefry_2x32", "threefry_seed", "fold_in", "split", "random_bits",
    "uniform", "randint", "bernoulli",
})

#: aten ops that draw from a torch Generator: forbidden in campaign steps
FORBIDDEN_RNG = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "uniform", "uniform_", "normal", "normal_", "bernoulli",
    "bernoulli_", "exponential", "exponential_", "geometric",
    "geometric_", "log_normal", "log_normal_", "cauchy", "cauchy_",
    "multinomial", "poisson", "random", "random_", "native_dropout",
    "_standard_gamma", "_sample_dirichlet", "binomial", "rrelu_with_noise",
})

#: Python-level calls that read a device tensor on the host: each is a
#: device→host channel, forbidden in campaign steps outside the seam
CALLBACK_PRIMS = frozenset({
    "item", "tolist", "numpy", "cpu", "to", "__bool__", "__int__",
    "__float__", "__index__", "__repr__", "__format__", "__array__",
})

#: ops whose output shape depends on the data: the host must read a count
#: first (on the card a sync); values are the syncs each makes there.
#: ``__getitem__``/``__setitem__`` count a boolean mask, and each 0-dim
#: integer tensor index, which torch reads with ``.item()``
DATA_DEPENDENT = {
    "nonzero": 1, "argwhere": 1, "masked_select": 1, "unique": 1,
    "unique_consecutive": 1, "_unique": 1, "_unique2": 1, "bincount": 2,
    "repeat_interleave": 1, "where": 1, "__getitem__": 1,
    "__setitem__": 1, "index_put_": 1,
}

_FACTORIES = frozenset({"tensor", "as_tensor"})


class CertificationError(RuntimeError):
    """A strict-mode audit found violations (see ``.certificate``)."""

    def __init__(self, msg: str, certificate: dict):
        super().__init__(msg)
        self.certificate = certificate


def _tensors(x):
    """Every tensor inside nested tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _ptr(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def _is_bool_index(idx) -> bool:
    return any(t.dtype == torch.bool for t in _tensors(idx))


_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _caller() -> str:
    """``file:line`` of the innermost frame outside this module and torch
    (where an unsanctioned read was made)."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not (path.startswith(_TORCH) or os.path.dirname(path) == _HERE
                and path.endswith("step_audit.py")
                or "contextlib" in path):
            return f"{os.path.basename(path)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _target_device(args, kwargs):
    """The device a ``Tensor.to(...)`` call moves to, or None."""
    dev = kwargs.get("device")
    for a in args:
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    return dev


def _to_host_literal(args, kwargs) -> bool:
    """A ``Tensor.to("cpu")`` call: on the CPU the one ``to`` that says it
    copies to the host (``to(device)`` with the step's own CPU device is
    the card's no-op)."""
    dev = args[1] if len(args) > 1 else kwargs.get("device")
    return isinstance(dev, str) and dev == "cpu"


class _Session:
    """What one audited call did: counts shared by the modes of every
    thread the step runs on."""

    def __init__(self, example_args: tuple):
        self.lock = threading.Lock()
        self.census: Counter = Counter()       # aten op → calls
        self.callbacks: Counter = Counter()    # unsanctioned host reads
        self.sites: Counter = Counter()        # ... by "file:line name"
        self.syncs: Counter = Counter()        # reason → host syncs
        self.rng: Counter = Counter()
        self.results = 0                       # result copies
        self.written: set[int] = set()         # example args written
        self.arg_of: dict[int, int] = {}
        for i, a in enumerate(example_args):
            for t in _tensors(a):
                p = _ptr(t)
                if p:
                    self.arg_of.setdefault(p, i)
        self.card = any(t.is_cuda for t in _tensors(example_args))
        # tensors that hold host data by construction (CPU runs, where a
        # device tensor and a host copy share the device type)
        self._host: list = []
        self._host_ids: set[int] = set()

    # --- the seam ------------------------------------------------------

    def result_copy(self) -> None:
        with self.lock:
            self.results += 1

    def _event(self, name: str, n: int = 1, upload: bool = False) -> None:
        reason = devmod.sync_reason()
        with self.lock:
            if reason is not None:
                self.syncs[reason] += n
            elif upload:
                self.syncs["upload"] += n
            else:
                self.callbacks[name] += 1
                self.sites[f"{_caller()} {name}"] += 1
                self.syncs["unsanctioned"] += n

    def _mark_host(self, t) -> None:
        if isinstance(t, torch.Tensor) and id(t) not in self._host_ids:
            self._host.append(t)
            self._host_ids.add(id(t))

    def _on_device(self, t) -> bool:
        """Whether reading ``t`` reads device data: a CUDA tensor on the
        card; on the CPU any tensor not known to be a host copy."""
        if not isinstance(t, torch.Tensor):
            return False
        if self.card:
            return t.is_cuda
        return id(t) not in self._host_ids

    # --- the Python-level rules ----------------------------------------

    def before(self, func, args, kwargs) -> None:
        name = getattr(func, "__name__", "")
        self_t = args[0] if args else None
        if name in ("__getitem__", "__setitem__"):
            if len(args) > 1 and self._on_device(self_t):
                idx = args[1]
                # a 0-dim integer tensor index is read with .item()
                reads = sum(1 for t in (idx if isinstance(idx, tuple)
                                        else (idx,))
                            if isinstance(t, torch.Tensor) and t.dim() == 0
                            and not t.is_floating_point()
                            and t.dtype != torch.bool
                            and self._on_device(t))
                reads += _is_bool_index(idx)
                if reads:
                    self._event(name, reads)
                elif self.card and (
                        isinstance(idx, list) or any(
                            not t.is_cuda for t in _tensors(idx)
                            if t.dim() > 0)):
                    self._event(name, 1, upload=True)
            return
        if name == "to":
            dev = _target_device(args[1:], kwargs)
            if dev is None or not isinstance(self_t, torch.Tensor):
                return
            dev = torch.device(dev)
            if self.card:
                if dev.type == "cpu" and self_t.is_cuda:
                    self._event(name)
                elif (dev.type == "cuda" and not self_t.is_cuda
                      and not kwargs.get("non_blocking", False)):
                    self._event(name, upload=True)
            elif _to_host_literal(args, kwargs):
                if self._on_device(self_t):
                    self._event(name)
            return
        if name == "cuda":
            if (self.card and isinstance(self_t, torch.Tensor)
                    and not self_t.is_cuda
                    and not kwargs.get("non_blocking", False)):
                self._event(name, upload=True)
            return
        if name == "copy_":
            if self.card and len(args) > 1 and isinstance(
                    args[1], torch.Tensor) and (
                    self_t.is_cuda != args[1].is_cuda) and not (
                    kwargs.get("non_blocking", False)):
                self._event(name, upload=self_t.is_cuda)
            return
        if name in _FACTORIES:
            dev = kwargs.get("device")
            if self.card and dev is not None and \
                    torch.device(dev).type == "cuda" and not (
                        args and isinstance(args[0], torch.Tensor)
                        and args[0].is_cuda):
                self._event(name, upload=True)
            return
        if name in CALLBACK_PRIMS:
            if self._on_device(self_t):
                self._event(name)
            return
        if name in DATA_DEPENDENT:
            if name == "where" and len(args) + len(kwargs) != 1:
                return
            if name == "repeat_interleave" and (
                    "output_size" in kwargs or not any(
                        isinstance(a, torch.Tensor) for a in args[1:2])):
                return
            if any(self._on_device(t) for t in _tensors(args)):
                self._event(name, DATA_DEPENDENT[name])

    def after(self, func, args, kwargs, out) -> None:
        if self.card:
            return
        name = getattr(func, "__name__", "")
        if name == "cpu" or (name == "to"
                             and _to_host_literal(args, kwargs)):
            self._mark_host(out)
        elif name == "from_numpy" or (name in _FACTORIES
                                      and kwargs.get("device") is None):
            self._mark_host(out)

    # --- the aten-level rules ------------------------------------------

    def op(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        written = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = (args[i] if i < len(args) and not a.kwarg_only
                   else kwargs.get(a.name))
            for t in _tensors(val):
                idx = self.arg_of.get(_ptr(t))
                if idx is not None:
                    written.append(idx)
        with self.lock:
            self.census[name] += 1
            if name in FORBIDDEN_RNG:
                self.rng[name] += 1
            self.written.update(written)

    # --- the modes -----------------------------------------------------

    @contextlib.contextmanager
    def watch(self):
        """Both modes on this thread, with this session as its observer
        (the step's own thread, and each worker thread of its shards:
        ``utils/device.py worker_context``)."""
        prev = devmod.set_observer(self)
        try:
            with _FunctionMode(self), _DispatchMode(self):
                yield
        finally:
            devmod.set_observer(prev)

    # --- the verdict ---------------------------------------------------

    def certificate(self, kind: str, transfer_budget, declared) -> dict:
        violations: list[str] = []
        for name in sorted(self.rng):
            violations.append(
                f"rng: forbidden aten op '{name}' ({self.rng[name]}x) — "
                "randomness drawn from a torch Generator, outside the "
                "frozen-key threefry lineage, makes the step "
                "order-dependent")
        callbacks = {k: self.callbacks[k] for k in sorted(self.callbacks)}
        for name, n in callbacks.items():
            violations.append(
                f"side-effect: '{name}' ({n}x) outside the host-sync seam — "
                "a device→host read the step was not designed to make "
                "(a hidden transfer; on the card a stall)")
        transfers = self.results + sum(callbacks.values())
        if transfer_budget is not None and transfers > transfer_budget:
            violations.append(
                f"transfer budget: {transfers} device→host transfers per "
                f"invocation > budget {transfer_budget} (the ONE-result-"
                "copy-per-sync-interval contract)")
        donated = sorted(self.written)
        undeclared = sorted(set(donated) - set(declared))
        if undeclared:
            violations.append(
                f"donation: arguments {undeclared} are written in place by "
                "the step but not declared by the caller — an undeclared "
                "mutation of the caller's buffers")
        return {
            "kind": kind,
            "ok": not violations,
            "violations": violations,
            "transfers": transfers,
            "transfer_budget": transfer_budget,
            "callbacks": callbacks,
            "sites": dict(sorted(self.sites.items())),
            "rng": dict(sorted(self.rng.items())),
            "donated_args": donated,
            "n_eqns": int(sum(self.census.values())),
            "syncs": dict(sorted(self.syncs.items())),
        }


class _FunctionMode(TorchFunctionMode):
    def __init__(self, session: _Session):
        super().__init__()
        self.session = session

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.session.before(func, args, kwargs)
        out = func(*args, **kwargs)
        self.session.after(func, args, kwargs, out)
        return out


class _DispatchMode(TorchDispatchMode):
    def __init__(self, session: _Session):
        super().__init__()
        self.session = session

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.session.op(func, args, kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _sync_debug_count(on: bool):
    """Count torch's own sync warnings (``set_sync_debug_mode("warn")``)
    over the block → a one-element list holding the count, or None."""
    if not (on and torch.cuda.is_available()):
        yield None
        return
    box = [0]
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # (enabling the mode warns once per process about itself: not a sync)
    box[0] = sum(1 for w in caught
                 if "called a synchronizing" in str(w.message))


def primitive_census(fn, example_args: tuple) -> Counter:
    """Aten op counts of one call of ``fn`` — the raw material every rule
    below reads."""
    session = _Session(example_args)
    with session.watch():
        fn(*example_args)
    return Counter(session.census)


def audit_callable(fn, example_args: tuple, *, kind: str = "step",
                   transfer_budget: int | None = 1,
                   declared_donations: tuple = (),
                   sync_debug: bool = False) -> dict:
    """Run ``fn`` once on ``example_args`` under the modes and certify the
    replay-safety rules → the certificate (``cert["ok"]`` is the verdict);
    the caller decides whether a failed certificate refuses the step
    (``exec_cache`` strict mode) or only reports (warn mode).
    ``sync_debug=True`` (on the card) adds ``sync_debug``: torch's count
    of synchronizing calls over the same call."""
    session = _Session(tuple(example_args))
    with _sync_debug_count(sync_debug) as box:
        # the step's lazily built host tables (golden record, scoreboard)
        # are built by the first call; torch.cuda.synchronize makes no
        # sync warning, so the count starts clean
        with session.watch():
            fn(*example_args)
        if box is not None:
            torch.cuda.synchronize()
    cert = session.certificate(kind, transfer_budget, declared_donations)
    if box is not None:
        cert["sync_debug"] = box[0]
    return cert


class StepAuditor:
    """The ``exec_cache`` auditor hook: certify each campaign step kind on
    its first dispatch.

    ``strict=True`` raises ``CertificationError`` on a failed certificate —
    the ledger then refuses the step.  ``on_cert`` (optional) observes
    every certificate (the CLI's reporting path)."""

    def __init__(self, transfer_budget: int = 1, strict: bool = False,
                 on_cert=None):
        self.transfer_budget = int(transfer_budget)
        self.strict = bool(strict)
        self.on_cert = on_cert
        self.audited = 0
        self.failed = 0

    def __call__(self, fn, example_args: tuple, key) -> dict:
        kind = key[0] if isinstance(key, tuple) and key else "step"
        cert = audit_callable(fn, example_args, kind=str(kind),
                              transfer_budget=self.transfer_budget)
        self.audited += 1
        if not cert["ok"]:
            self.failed += 1
        if self.on_cert is not None:
            self.on_cert(key, cert)
        if self.strict and not cert["ok"]:
            raise CertificationError(
                f"campaign step {kind!r} failed replay-safety "
                f"certification: {'; '.join(cert['violations'])}", cert)
        return cert
