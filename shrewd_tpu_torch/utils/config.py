"""Typed, hierarchical configuration objects.

The port's copy of ``ConfigObject``, ``Param``, ``VectorParam`` and
``Child`` from ``shrewd_tpu/utils/config.py`` (the SimObject-param analog:
declarative typed params, metaclass capture, ``to_dict``/``from_dict``
round trip), so that a port config's ``to_dict()`` can be held against the
reference's; the unit-string param types (``MemorySize``, ``Frequency``,
``Time``); and the reproducibility dumps, ``dump_json`` (the
``config.json`` a campaign writes) and ``dump_ini`` (the ``config.ini``
that ``ingest/configfile.py`` reads back).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterator

from shrewd_tpu_torch.utils import units

_REQUIRED = object()


# --- convertible unit types -------------------------------------------------

class MemorySize(int):
    """Byte count; accepts '64KiB'-style strings."""
    def __new__(cls, value):
        return super().__new__(cls, units.to_bytes(value))


class Frequency(float):
    """Hertz; accepts '3GHz'-style strings."""
    def __new__(cls, value):
        return super().__new__(cls, units.to_frequency(value))


class Time(float):
    """Seconds; accepts '10ns'-style strings."""
    def __new__(cls, value):
        return super().__new__(cls, units.to_seconds(value))


def _convert(type_: type, value: Any) -> Any:
    if type_ is bool and isinstance(value, str):
        low = value.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool: {value!r}")
    if isinstance(value, type_) and type(value) is type_:
        return value
    return type_(value)


class Param:
    """Typed parameter descriptor (analog of a ``Param.*`` declaration)."""

    def __init__(self, type_: type, default: Any = _REQUIRED, desc: str = "",
                 check: Callable[[Any], bool] | None = None):
        self.type = type_
        self.default = default
        self.desc = desc
        self.check = check
        self.name: str = "<unbound>"

    def __set_name__(self, owner, name):
        self.name = name

    def convert(self, value: Any) -> Any:
        out = _convert(self.type, value)
        if self.check is not None and not self.check(out):
            raise ValueError(f"param {self.name}={value!r} failed validation")
        return out

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._values[self.name]

    def __set__(self, obj, value):
        obj._values[self.name] = self.convert(value)


class VectorParam(Param):
    """Homogeneous list parameter."""

    def convert(self, value: Any) -> list:
        out = [_convert(self.type, v) for v in value]
        if self.check is not None and not self.check(out):
            raise ValueError(f"param {self.name}={value!r} failed validation")
        return out


class Child:
    """A nested ConfigObject slot (the object-hierarchy edge)."""

    def __init__(self, type_: type, default_factory: Callable | None = None,
                 desc: str = ""):
        self.type = type_
        self.default_factory = default_factory if default_factory is not None else type_
        self.desc = desc
        self.name: str = "<unbound>"

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._children[self.name]

    def __set__(self, obj, value):
        if not isinstance(value, self.type):
            raise TypeError(
                f"child {self.name} must be {self.type.__name__}, got {type(value).__name__}")
        obj._children[self.name] = value


class ConfigObject:
    """Base of every configuration node.

    Subclasses declare ``Param``/``VectorParam``/``Child`` class attributes;
    ``__init_subclass__`` collects them (the metaclass-capture analog of
    ``MetaSimObject``, reference ``src/python/m5/SimObject.py:136``), including
    inherited ones, so subclassing a config refines it the way SimObject
    subclassing does.
    """

    _params: dict[str, Param] = {}
    _child_slots: dict[str, Child] = {}
    # Name → class registry so from_dict can rebuild the *recorded* subclass
    # of a Child slot, not just the declared base (polymorphic round-trip).
    _registry: dict[str, type] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        ConfigObject._registry[cls.__name__] = cls
        params: dict[str, Param] = {}
        children: dict[str, Child] = {}
        for klass in reversed(cls.__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    params[name] = attr
                elif isinstance(attr, Child):
                    children[name] = attr
        cls._params = params
        cls._child_slots = children

    def __init__(self, **overrides):
        self._values: dict[str, Any] = {}
        self._children: dict[str, ConfigObject] = {}
        for name, p in self._params.items():
            if name in overrides:
                setattr(self, name, overrides.pop(name))
            elif p.default is not _REQUIRED:
                setattr(self, name, p.default)
            else:
                raise ValueError(
                    f"{type(self).__name__}: required param {name!r} not given")
        for name, c in self._child_slots.items():
            if name in overrides:
                setattr(self, name, overrides.pop(name))
            else:
                setattr(self, name, c.default_factory())
        if overrides:
            raise TypeError(
                f"{type(self).__name__}: unknown params {sorted(overrides)}")

    # --- traversal ---

    def descendants(self, prefix: str = "root") -> Iterator[tuple[str, "ConfigObject"]]:
        yield prefix, self
        for name, child in self._children.items():
            yield from child.descendants(f"{prefix}.{name}")

    # --- dumps (the config.ini / config.json reproducibility contract) ---

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"type": type(self).__name__}
        for name in self._params:
            v = self._values[name]
            out[name] = list(v) if isinstance(v, list) else v
        for name, child in self._children.items():
            out[name] = child.to_dict()
        return out

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
            f.write("\n")

    def dump_ini(self, path) -> None:
        lines = []
        for secname, obj in self.descendants():
            lines.append(f"[{secname}]")
            lines.append(f"type={type(obj).__name__}")
            for name in obj._params:
                v = obj._values[name]
                if isinstance(v, list):
                    v = " ".join(str(x) for x in v)
                lines.append(f"{name}={v}")
            if obj._children:
                lines.append("children=" + " ".join(obj._children))
            lines.append("")
        with open(path, "w") as f:
            f.write("\n".join(lines))

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigObject":
        d = dict(d)
        typename = d.pop("type", None)
        if typename is not None and typename != cls.__name__:
            actual = cls._registry.get(typename)
            if actual is None or not issubclass(actual, cls):
                raise TypeError(
                    f"recorded type {typename!r} is not a known subclass of "
                    f"{cls.__name__}")
            cls = actual
        kwargs: dict[str, Any] = {}
        for name, v in d.items():
            if name in cls._child_slots:
                kwargs[name] = cls._child_slots[name].type.from_dict(v)
            else:
                kwargs[name] = v
        return cls(**kwargs)

    def __repr__(self):
        parts = [f"{k}={self._values[k]!r}" for k in self._params]
        parts += [f"{k}=..." for k in self._children]
        return f"{type(self).__name__}({', '.join(parts)})"
