"""Statistics framework (the port's copy of ``shrewd_tpu/stats``).

Re-imagines gem5's stats core (``src/base/statistics.hh``: ``Scalar`` :1929,
``Vector`` :921, ``Distribution``/``Histogram``, ``Formula`` :1552; hierarchy
``base/stats/group.hh``; text writer ``base/stats/text.cc``) for a batched
campaign: device code produces *tally arrays* (reductions on the card);
host-side stat objects absorb them at batch granularity, and dump in a
stats.txt-compatible layout so existing gem5 diffing tooling works on the new
framework's output.

The hierarchy mirrors the reference: every model owns a ``Group``; groups nest
(``statistics::Group`` bound to the SimObject tree, reference
``python/m5/simulate.py:143-145``); ``dump()`` walks the tree.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Iterator

import numpy as np

__all__ = [
    "Scalar", "Vector", "Distribution", "Histogram", "Formula", "Text",
    "Group", "dump_text", "dump_json", "to_dict",
]


class StatBase:
    def __init__(self, name: str, desc: str = ""):
        self.name = name
        self.desc = desc

    def reset(self) -> None:
        raise NotImplementedError

    # Each stat yields (name, value, desc) rows for the text writer.
    def rows(self, prefix: str) -> Iterator[tuple[str, Any, str]]:
        raise NotImplementedError

    def to_value(self) -> Any:
        raise NotImplementedError


class Scalar(StatBase):
    """A single accumulating number (``statistics::Scalar``)."""

    def __init__(self, name: str, desc: str = "", init: float = 0):
        super().__init__(name, desc)
        self._init = init
        self.value: float = init

    def __iadd__(self, x) -> "Scalar":
        self.value += float(x)
        return self

    def set(self, x) -> None:
        self.value = float(x)

    def reset(self) -> None:
        self.value = self._init

    def rows(self, prefix):
        yield f"{prefix}{self.name}", self.value, self.desc

    def to_value(self):
        return self.value


class Vector(StatBase):
    """Fixed-length vector of counters with optional subnames
    (``statistics::Vector``); dumps per-element rows plus a total."""

    def __init__(self, name: str, size: int, desc: str = "",
                 subnames: list[str] | None = None):
        super().__init__(name, desc)
        if subnames is not None and len(subnames) != size:
            raise ValueError(f"{name}: {len(subnames)} subnames for size {size}")
        self.subnames = subnames
        self.value = np.zeros(size, dtype=np.float64)

    def __iadd__(self, x) -> "Vector":
        arr = np.asarray(x, dtype=np.float64)
        if arr.shape != self.value.shape:
            raise ValueError(f"{self.name}: shape {arr.shape} != {self.value.shape}")
        self.value += arr
        return self

    def __getitem__(self, i) -> float:
        return float(self.value[i])

    def add(self, i: int, x: float = 1) -> None:
        self.value[i] += x

    def total(self) -> float:
        return float(self.value.sum())

    def reset(self) -> None:
        self.value[:] = 0

    def rows(self, prefix):
        for i, v in enumerate(self.value):
            sub = self.subnames[i] if self.subnames else str(i)
            yield f"{prefix}{self.name}::{sub}", float(v), self.desc
        yield f"{prefix}{self.name}::total", self.total(), self.desc

    def to_value(self):
        out = {(self.subnames[i] if self.subnames else str(i)): float(v)
               for i, v in enumerate(self.value)}
        out["total"] = self.total()
        return out


class Distribution(StatBase):
    """Fixed-range bucketed distribution with moments
    (``statistics::Distribution``)."""

    def __init__(self, name: str, lo: float, hi: float, n_buckets: int,
                 desc: str = ""):
        super().__init__(name, desc)
        self.lo, self.hi, self.n_buckets = lo, hi, n_buckets
        self.bucket_size = (hi - lo) / n_buckets
        self.reset()

    def reset(self) -> None:
        self.counts = np.zeros(self.n_buckets, dtype=np.float64)
        self.underflow = 0.0
        self.overflow = 0.0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.min_val = math.inf
        self.max_val = -math.inf

    def sample(self, values, weights=None) -> None:
        """Absorb a batch of samples (array-friendly: one host call/batch)."""
        v = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if weights is None:
            w = np.ones_like(v)
        else:
            try:
                w = np.broadcast_to(
                    np.asarray(weights, dtype=np.float64), v.shape).copy()
            except ValueError:
                raise ValueError(
                    f"{self.name}: weights shape "
                    f"{np.shape(weights)} does not broadcast to {v.shape}")
        if v.size == 0:
            return
        self.underflow += w[v < self.lo].sum()
        self.overflow += w[v >= self.hi].sum()
        in_range = (v >= self.lo) & (v < self.hi)
        if in_range.any():
            idx = ((v[in_range] - self.lo) / self.bucket_size).astype(np.int64)
            # float division can round a value just below hi onto n_buckets
            idx = np.clip(idx, 0, self.n_buckets - 1)
            np.add.at(self.counts, idx, w[in_range])
        self.sum += float((v * w).sum())
        self.sum_sq += float((v * v * w).sum())
        self.min_val = min(self.min_val, float(v.min()))
        self.max_val = max(self.max_val, float(v.max()))

    @property
    def samples(self) -> float:
        return float(self.counts.sum() + self.underflow + self.overflow)

    def mean(self) -> float:
        n = self.samples
        return self.sum / n if n else float("nan")

    def stdev(self) -> float:
        n = self.samples
        if n < 2:
            return float("nan")
        var = (self.sum_sq - self.sum * self.sum / n) / (n - 1)
        return math.sqrt(max(var, 0.0))

    def rows(self, prefix):
        base = f"{prefix}{self.name}"
        yield f"{base}::samples", self.samples, self.desc
        yield f"{base}::mean", self.mean(), self.desc
        yield f"{base}::stdev", self.stdev(), self.desc
        yield f"{base}::underflows", self.underflow, self.desc
        for i, c in enumerate(self.counts):
            lo = self.lo + i * self.bucket_size
            hi = lo + self.bucket_size
            yield f"{base}::{lo:g}-{hi:g}", float(c), self.desc
        yield f"{base}::overflows", self.overflow, self.desc
        yield f"{base}::min_value", self.min_val, self.desc
        yield f"{base}::max_value", self.max_val, self.desc

    def to_value(self):
        return {
            "samples": self.samples, "mean": self.mean(), "stdev": self.stdev(),
            "underflow": self.underflow, "overflow": self.overflow,
            "min": self.min_val, "max": self.max_val,
            "counts": self.counts.tolist(),
            "lo": self.lo, "hi": self.hi,
        }


class Histogram(Distribution):
    """Auto-ranging histogram (``statistics::Histogram``): doubles its range
    by merging adjacent buckets when a sample lands above ``hi``."""

    def __init__(self, name: str, n_buckets: int, desc: str = ""):
        if n_buckets % 2:
            raise ValueError("Histogram needs an even bucket count")
        super().__init__(name, 0.0, float(n_buckets), n_buckets, desc)

    def reset(self) -> None:
        # restore the original range/granularity, like HistStor::reset
        self.hi = float(self.n_buckets)
        self.bucket_size = 1.0
        super().reset()

    def sample(self, values, weights=None) -> None:
        v = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if v.size == 0:
            return
        if not np.isfinite(v).all():
            raise ValueError(f"{self.name}: non-finite sample")
        if (v < 0).any():
            raise ValueError(f"{self.name}: Histogram range starts at 0; "
                             f"negative sample rejected (use Distribution)")
        while float(v.max()) >= self.hi:
            # merge pairs: counts[i] = counts[2i] + counts[2i+1]; double range
            merged = self.counts.reshape(-1, 2).sum(axis=1)
            self.counts = np.concatenate(
                [merged, np.zeros(self.n_buckets // 2)])
            self.hi = self.lo + 2 * (self.hi - self.lo)
            self.bucket_size *= 2
        super().sample(v, weights)


class Formula(StatBase):
    """Derived stat evaluated lazily at dump time (``statistics::Formula``),
    e.g. AVF = sdc_count / trials."""

    def __init__(self, name: str, fn: Callable[[], Any], desc: str = ""):
        super().__init__(name, desc)
        self.fn = fn

    def reset(self) -> None:
        pass

    def rows(self, prefix):
        val = self.fn()
        if isinstance(val, dict):
            for k, v in val.items():
                yield f"{prefix}{self.name}::{k}", v, self.desc
        else:
            yield f"{prefix}{self.name}", val, self.desc

    def to_value(self):
        return self.fn()


class Text(StatBase):
    """A string-valued stat (the reference's ``statistics::Info`` prose
    fields): run identity, posture labels, abort reasons.  Every dump
    backend is string-safe for it — ``dump_hdf5`` writes a variable-
    length string dataset (the same fallback dict-valued Formulas with
    string leaves already get), so a prose value never trips the
    numeric-only Formula contract."""

    def __init__(self, name: str, value: str = "", desc: str = ""):
        super().__init__(name, desc)
        self.value = str(value)

    def set(self, value) -> None:
        self.value = str(value)

    def reset(self) -> None:
        self.value = ""

    def rows(self, prefix):
        yield f"{prefix}{self.name}", self.value, self.desc

    def to_value(self):
        return self.value


class Group:
    """Hierarchical stat container (``statistics::Group``).

    Stats and subgroups register by attribute assignment::

        g = Group("o3")
        g.trials = Scalar("trials", "total trials run")
        g.outcomes = Vector("outcomes", 4, subnames=[...])
    """

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_stats", {})
        object.__setattr__(self, "_groups", {})

    def __setattr__(self, key, value):
        # Validate BEFORE mutating the registry so a rejected rebind leaves
        # the existing registrations intact.
        old = getattr(self, key, None)
        if isinstance(value, StatBase):
            clash = self._stats.get(value.name)
            if clash is not None and clash is not old:
                raise ValueError(
                    f"duplicate stat name {value.name!r} in group {self.name!r}")
        elif isinstance(value, Group):
            clash = self._groups.get(value.name)
            if clash is not None and clash is not old:
                raise ValueError(
                    f"duplicate subgroup name {value.name!r} in group {self.name!r}")
        # rebinding an attribute drops its previous registration (only if the
        # registration actually points at the object being replaced)
        if isinstance(old, StatBase) and self._stats.get(old.name) is old:
            del self._stats[old.name]
        elif isinstance(old, Group) and self._groups.get(old.name) is old:
            del self._groups[old.name]
        if isinstance(value, StatBase):
            self._stats[value.name] = value
        elif isinstance(value, Group):
            self._groups[value.name] = value
        object.__setattr__(self, key, value)

    def add(self, stat_or_group):
        setattr(self, "_anon_%d" % (len(self._stats) + len(self._groups)),
                stat_or_group)
        return stat_or_group

    def reset(self) -> None:
        """m5.stats.reset() analog (reference python/m5/stats/__init__.py:433)."""
        for s in self._stats.values():
            s.reset()
        for g in self._groups.values():
            g.reset()

    def rows(self, prefix: str = "") -> Iterator[tuple[str, Any, str]]:
        base = f"{prefix}{self.name}." if self.name else prefix
        for s in self._stats.values():
            yield from s.rows(base)
        for g in self._groups.values():
            yield from g.rows(base)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {s.name: s.to_value() for s in self._stats.values()}
        for g in self._groups.values():
            out[g.name] = g.to_dict()
        return out


# --- writers (base/stats/text.cc + gem5stats JSON analogs) ---

_BEGIN = "---------- Begin Simulation Statistics ----------"
_END = "---------- End Simulation Statistics   ----------"


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if v != v:
            return "nan"
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.6f}"
    return str(v)


def dump_text(group: Group, fileobj=None, desc: bool = True) -> str:
    """stats.txt-format dump: ``name  value  # desc`` between Begin/End
    markers, matching the reference's text layout so diff tooling carries
    over (``base/stats/text.cc``)."""
    lines = [_BEGIN, ""]
    for name, value, d in group.rows():
        row = f"{name:<50} {_fmt(value):>20}"
        if desc and d:
            row += f"  # {d}"
        lines.append(row)
    lines += ["", _END, ""]
    text = "\n".join(lines)
    if fileobj is not None:
        fileobj.write(text)
    return text


def to_dict(group: Group) -> dict:
    return group.to_dict()


def _json_safe(v: Any) -> Any:
    """Strict-JSON projection: ``NaN``/``±inf`` (e.g. ``Distribution.mean``
    with zero samples) become ``null`` — ``json.dumps``'s non-strict
    default would emit bare ``NaN``/``Infinity`` tokens that strict
    parsers reject."""
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def dump_json(group: Group, fileobj=None) -> str:
    """Structured dump (the ``get_simstat`` analog,
    reference ``python/m5/stats/gem5stats.py:351``).  Strict JSON:
    non-finite values serialize as ``null`` (``allow_nan=False`` enforces
    the contract — a regression reappearing fails loudly here, not in the
    consumer's parser)."""
    text = json.dumps(_json_safe(group.to_dict()), indent=2, default=float,
                      allow_nan=False)
    if fileobj is not None:
        fileobj.write(text)
    return text


def dump_hdf5(group: Group, path: str) -> None:
    """HDF5 dump (the reference's ``--stats-file=h5://`` backend,
    ``src/base/stats/hdf5.cc``): one HDF5 group per stats Group, one
    dataset per stat.  Scalars/Formulas land as 0-d float datasets,
    Vectors as 1-d arrays with a ``subnames`` attribute, Distributions/
    Histograms as bucket-count arrays with lo/hi/underflow/overflow/
    moment attributes.  One dump per call (overwrite semantics)."""
    import h5py

    def write_dict(h5g, d: dict, path: str) -> None:
        """Dict-valued Formula payloads, possibly nested (e.g. the
        per-content-key executable-cache ledger) and possibly carrying
        string leaves — strings land as variable-length string scalars,
        numbers as float64.  Non-numeric leaves raise with the full
        stat path, like the scalar branch below."""
        for key, val in d.items():
            leaf = f"{path}.{key}"
            if isinstance(val, dict):
                write_dict(h5g.require_group(str(key)), val, leaf)
            elif isinstance(val, str):
                h5g.create_dataset(str(key), data=val)
            else:
                try:
                    fv = float(val)
                except (TypeError, ValueError):
                    raise TypeError(
                        f"stat {leaf!r}: Formula must be numeric, got "
                        f"{type(val).__name__} ({val!r}) — return a "
                        "number (NaN is fine), a dict of numbers/"
                        "strings, or use stats.Text for prose") from None
                h5g.create_dataset(str(key), data=fv)

    def write_group(h5g, g: Group, prefix: str) -> None:
        for s in g._stats.values():
            stat_path = f"{prefix}{s.name}"
            if isinstance(s, Distribution):      # includes Histogram
                v = s.to_value()
                ds = h5g.create_dataset(
                    s.name, data=np.asarray(v["counts"], np.float64))
                for key in ("lo", "hi", "underflow", "overflow",
                            "samples", "mean", "stdev", "min", "max"):
                    ds.attrs[key] = float(v[key])
            elif isinstance(s, Vector):
                ds = h5g.create_dataset(
                    s.name, data=np.asarray(s.value, np.float64))
                if s.subnames:
                    ds.attrs["subnames"] = [str(x) for x in s.subnames]
            else:                                 # Scalar / Formula / Text
                v = s.to_value()
                if isinstance(v, dict):           # dict-valued Formula
                    write_dict(h5g.require_group(s.name), v, stat_path)
                elif isinstance(v, str):          # Text / prose Formula:
                    # the same string-safe fallback write_dict gives
                    # nested string leaves
                    h5g.create_dataset(s.name, data=v)
                else:
                    try:
                        fv = float(v)
                    except (TypeError, ValueError):
                        # name the offending stat: the bare float(v)
                        # TypeError gives no path to it
                        raise TypeError(
                            f"stat {stat_path!r}: Formula must be "
                            f"numeric, got {type(v).__name__} ({v!r}) — "
                            "return a number (NaN is fine), a dict of "
                            "numbers/strings, or use stats.Text for "
                            "prose") from None
                    h5g.create_dataset(s.name, data=fv)
            h5g[s.name].attrs["description"] = s.desc
        for sub in g._groups.values():
            write_group(h5g.require_group(sub.name), sub,
                        f"{prefix}{sub.name}.")

    with h5py.File(path, "w") as f:
        root = f.require_group(group.name) if group.name else f["/"]
        write_group(root, group, f"{group.name}." if group.name else "")


__all__.append("dump_hdf5")
