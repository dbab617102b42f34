"""Elaboration-dump readers: ``config.ini`` / ``config.json`` (the port's
copy of ``shrewd_tpu/ingest/configfile.py``).

The reference dumps its fully-elaborated object tree at instantiate
(``src/python/m5/simulate.py:106-124``): an ini file with one section per
SimObject (dotted path, ``children=`` edge list) and a nested json. These
readers recover a nested dict so campaign tooling can pull machine parameters
(ROB size, cache geometry, FU pool shape) out of a golden run's output
directory without re-parsing gem5 Python.

They also read this framework's own ``ConfigObject.dump_ini/dump_json``
output (utils/config.py keeps the same shape on purpose).
"""

from __future__ import annotations

import json
import re

_SECTION_RE = re.compile(r"^\[(.+)\]$")


def parse_ini(f, what: str = "ini") -> dict[str, dict[str, str]]:
    """Shared ini-database parser (the IniFile analog) used for both
    ``config.ini`` and ``m5.cpt`` — one format, one parser."""
    sections: dict[str, dict[str, str]] = {}
    current: dict[str, str] | None = None
    for raw in f:
        line = raw.strip()
        if not line or line.startswith((";", "#")):
            continue
        m = _SECTION_RE.match(line)
        if m:
            current = sections.setdefault(m.group(1), {})
            continue
        if current is None or "=" not in line:
            raise ValueError(f"malformed {what} line: {raw!r}")
        key, _, value = line.partition("=")
        current[key.strip()] = value.strip()
    return sections


def load_config_ini(path: str) -> dict[str, dict[str, str]]:
    """Flat view: dotted-path section → {param: raw string}."""
    with open(path) as f:
        return parse_ini(f, "config.ini")


def tree_from_ini(sections: dict[str, dict[str, str]]) -> dict:
    """Re-nest a flat ini dump using the ``children=`` edges."""
    def build(path: str) -> dict:
        sec = dict(sections[path])
        node: dict = {k: v for k, v in sec.items() if k != "children"}
        for child in sec.get("children", "").split():
            child_path = f"{path}.{child}"
            if child_path in sections:
                node[child] = build(child_path)
        return node

    roots = [p for p in sections if "." not in p]
    return {r: build(r) for r in roots}


def load_config_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_params(tree: dict, name: str) -> list[tuple[str, object]]:
    """All (dotted.path, value) occurrences of a param name in a nested
    config tree — the `Parent.any` style lookup done offline."""
    out: list[tuple[str, object]] = []

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}.{k}" if prefix else k)
            elif k == name:
                out.append((f"{prefix}.{k}" if prefix else k, v))

    walk(tree, "")
    return out
