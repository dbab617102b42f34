"""gem5 checkpoint (`m5.cpt`) reader/writer (the port's copy of
``shrewd_tpu/ingest/cpt.py``; a checkpoint written by either package
reads the same in the other).

Implements the reference's checkpoint container format from its observed
behavior (none of this is a code translation):

- ini database: ``[dotted.object.path]`` sections, ``name=value`` entries
  (``sim/serialize.hh:68-85``: ``CheckpointIn`` wraps ``IniFile``; section
  header written by ``Serializable::ScopedCheckpointSection`` as
  ``\\n[path]\\n``).
- arrays are space-separated scalars on one line (``arrayParamOut``); byte
  arrays print each byte as an unsigned int (``ShowParam<unsigned char>``,
  ``sim/serialize_handlers.hh:133-146``); bools print ``true``/``false``
  (``:148``).
- ``[Globals]`` holds ``curTick`` and the space-separated ``version_tags``
  set (``sim/globals.cc:59-87``).
- thread contexts serialize one flattened byte array per register class,
  keyed ``regs.<class>`` (free function ``serialize(const ThreadContext&)``,
  ``src/cpu/thread_context.cc``), and the PC state as ``_pc``/``_upc``
  (+ ``_npc``/``_nupc`` on delayed-slot ISAs,
  ``src/arch/generic/pcstate.hh:143-151``).
- physical memory stores write ``store_id``/``filename``/``range_size``
  entries and a gzipped raw image next to ``m5.cpt``
  (``PhysicalMemory::serializeStore``, ``src/mem/physical.cc:364-405``).

The writer emits the same shape so the golden gem5 binary can restore state
this framework produces (differential-testing in both directions).
"""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Iterator, NamedTuple

import numpy as np

from shrewd_tpu_torch.ingest import configfile


def _numeric_aware_key(name: str) -> tuple:
    """Sort key splitting digit runs so cpu2 < cpu10 and store2 < store10
    (plain lexicographic sort would misorder indices ≥ 10)."""
    return tuple(int(tok) if tok.isdigit() else tok
                 for tok in re.split(r"(\d+)", name))


class CheckpointIn:
    """Parsed checkpoint database + directory for sibling store files."""

    def __init__(self, cpt_dir: str):
        self.cpt_dir = cpt_dir
        path = os.path.join(cpt_dir, "m5.cpt")
        with open(path) as f:
            self._db: dict[str, dict[str, str]] = configfile.parse_ini(
                f, "m5.cpt")

    # --- CheckpointIn API shape (sim/serialize.hh:86-93) ---

    def sections(self) -> list[str]:
        return list(self._db)

    def section_exists(self, section: str) -> bool:
        return section in self._db

    def entry_exists(self, section: str, entry: str) -> bool:
        return entry in self._db.get(section, {})

    def find(self, section: str, entry: str) -> str:
        try:
            return self._db[section][entry]
        except KeyError:
            raise KeyError(f"checkpoint has no [{section}] {entry}=") from None

    # --- typed getters ---

    def get_int(self, section: str, entry: str) -> int:
        return int(self.find(section, entry), 0)

    def get_bool(self, section: str, entry: str) -> bool:
        v = self.find(section, entry)
        if v not in ("true", "false"):
            raise ValueError(f"[{section}] {entry}={v!r} is not a cpt bool")
        return v == "true"

    def get_array(self, section: str, entry: str, dtype=np.uint64) -> np.ndarray:
        text = self.find(section, entry)
        vals = [int(x, 0) for x in text.split()] if text else []
        return np.array(vals, dtype=dtype)

    def get_bytes(self, section: str, entry: str) -> np.ndarray:
        return self.get_array(section, entry, dtype=np.uint8)

    def find_sections(self, pattern: str) -> Iterator[str]:
        """Sections whose dotted path matches `pattern` (regex, full match)."""
        rx = re.compile(pattern)
        for name in self._db:
            if rx.fullmatch(name):
                yield name

    # --- memory stores ---

    def load_store(self, section: str) -> tuple[int, np.ndarray]:
        """One physical-memory store → (range_size, bytes)."""
        filename = self.find(section, "filename")
        range_size = self.get_int(section, "range_size")
        path = os.path.join(self.cpt_dir, filename)
        with gzip.open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        if data.size != range_size:
            raise ValueError(
                f"store {filename}: {data.size} bytes != range_size {range_size}")
        return range_size, data


class CheckpointOut:
    """Checkpoint writer mirroring the reference's on-disk shape."""

    def __init__(self, cpt_dir: str):
        self.cpt_dir = cpt_dir
        os.makedirs(cpt_dir, exist_ok=True)
        self._lines: list[str] = []

    def begin_section(self, name: str) -> None:
        self._lines.append(f"\n[{name}]")

    def param(self, name: str, value) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._lines.append(f"{name}={value}")

    def array(self, name: str, values) -> None:
        if isinstance(values, np.ndarray):
            values = values.ravel().tolist()
        self._lines.append(
            f"{name}={' '.join(str(v) for v in values)}")

    def store(self, name: str, store_id: int, data: np.ndarray) -> str:
        """Write a gzipped memory image + its section entries; returns the
        store filename (`<name>.store<id>.pmem`, physical.cc:368-369)."""
        filename = f"{name}.store{store_id}.pmem"
        self.param("store_id", store_id)
        self.param("filename", filename)
        self.param("range_size", int(data.size))
        with gzip.open(os.path.join(self.cpt_dir, filename), "wb") as f:
            f.write(np.asarray(data, dtype=np.uint8).tobytes())
        return filename

    def close(self) -> None:
        with open(os.path.join(self.cpt_dir, "m5.cpt"), "w") as f:
            f.write("\n".join(self._lines).lstrip("\n") + "\n")


class ArchSnapshot(NamedTuple):
    """Architectural state lifted from a checkpoint — the capture side of
    SURVEY §5.4: checkpoints hold *architectural* state only (O3 drains its
    pipeline before serializing, ``src/cpu/o3/cpu.cc:706-799``), so this is
    the restore+re-warm input, not a live pipeline image."""

    cur_tick: int
    version_tags: tuple[str, ...]
    pc: int
    int_regs: np.ndarray      # uint64[n_int]
    float_regs: np.ndarray    # uint64[n_float]
    mem: np.ndarray           # uint8 — stores concatenated in section order
    thread_section: str
    # (section, size) per memory store. The cpt format records no base
    # address per store (the reference restores by object identity,
    # physical.cc:442-449; address ranges live in config.ini) — so for
    # multi-store checkpoints, flat offsets into `mem` are per-store
    # offsets plus the preceding stores' sizes, NOT physical addresses.
    store_layout: tuple[tuple[str, int], ...] = ()
    # (vaddr, size) per store, from the checkpoint dir's config.json
    # sidecar when present.  The m5.cpt format itself records no base
    # addresses (the reference keeps address ranges in config.ini,
    # physical.cc:442-449); the sidecar plays config.ini's role so
    # snapshot-seeded emulation (ingest/emu.py) can address the image.
    regions: tuple = ()


def _thread_sections(cpt: CheckpointIn) -> list[str]:
    return sorted((s for s, entries in cpt._db.items()
                   if "regs.integer" in entries), key=_numeric_aware_key)


def load_arch_snapshot(cpt_dir: str, thread: int = 0) -> ArchSnapshot:
    """Lift one thread's architectural state + the physical memory image.

    Multi-store checkpoints concatenate store images in numeric section
    order; see ``ArchSnapshot.store_layout`` for the boundaries (the cpt
    format itself carries no per-store base address).
    """
    cpt = CheckpointIn(cpt_dir)
    threads = _thread_sections(cpt)
    if not threads:
        raise ValueError(f"{cpt_dir}: no thread context (regs.integer) found")
    if not 0 <= thread < len(threads):
        raise ValueError(
            f"{cpt_dir}: thread index {thread} out of range — checkpoint has "
            f"{len(threads)} thread context(s): {threads}")
    tsec = threads[thread]

    def regs(entry: str) -> np.ndarray:
        arr = cpt.get_bytes(tsec, entry)
        if arr.size % 8:
            raise ValueError(f"[{tsec}] {entry}: {arr.size} bytes "
                             f"is not a whole uint64 count")
        return arr

    int_regs = regs("regs.integer")
    float_regs = (regs("regs.floating_point")
                  if cpt.entry_exists(tsec, "regs.floating_point")
                  else np.zeros(0, np.uint8))

    stores = sorted((s for s, e in cpt._db.items() if "filename" in e
                     and "range_size" in e), key=_numeric_aware_key)
    images = [cpt.load_store(s)[1] for s in stores]
    mem = (np.concatenate(images) if images else np.zeros(0, np.uint8))
    layout = tuple((s, int(img.size)) for s, img in zip(stores, images))

    regions: tuple = ()
    side = os.path.join(cpt_dir, "config.json")
    if os.path.exists(side):
        with open(side) as f:
            cfg = json.load(f)
        by_sec = {e["section"]: int(e["vaddr"])
                  for e in cfg.get("stores", [])}
        if all(s in by_sec for s in stores):
            regions = tuple((by_sec[s], int(img.size))
                            for s, img in zip(stores, images))

    return ArchSnapshot(
        cur_tick=cpt.get_int("Globals", "curTick"),
        version_tags=tuple(cpt.find("Globals", "version_tags").split()),
        pc=cpt.get_int(tsec, "_pc"),
        int_regs=int_regs.view(np.uint64),
        float_regs=(float_regs.view(np.uint64) if float_regs.size else
                    np.zeros(0, np.uint64)),
        mem=mem,
        thread_section=tsec,
        store_layout=layout,
        regions=regions,
    )


VERSION_TAGS = ("shrewd-tpu-v1",)


def write_arch_snapshot(cpt_dir: str, snap: ArchSnapshot,
                        system: str = "system") -> None:
    """Emit an m5.cpt-shaped checkpoint from typed arrays (round-trip and
    golden-restore support)."""
    out = CheckpointOut(cpt_dir)
    out.begin_section("Globals")
    out.param("curTick", snap.cur_tick)
    out.array("version_tags", list(snap.version_tags or VERSION_TAGS))

    tsec = snap.thread_section or f"{system}.cpu.xc.0"
    out.begin_section(tsec)
    out.array("regs.integer", snap.int_regs.view(np.uint8))
    if snap.float_regs.size:
        out.array("regs.floating_point", snap.float_regs.view(np.uint8))
    out.param("_pc", snap.pc)
    out.param("_upc", 0)

    sidecar_stores = []
    if snap.regions:
        # one store per region + a config.json sidecar carrying the vaddrs
        # (the role config.ini plays in the reference)
        off = 0
        for sid, (vaddr, size) in enumerate(snap.regions):
            sec = f"{system}.physmem.store{sid}"
            out.begin_section(sec)
            out.store(f"{system}.physmem", sid,
                      snap.mem[off:off + size])
            sidecar_stores.append({"section": sec, "vaddr": int(vaddr),
                                   "size": int(size)})
            off += size
    elif snap.mem.size:
        out.begin_section(f"{system}.physmem.store0")
        out.store(f"{system}.physmem", 0, snap.mem)
    out.close()
    if sidecar_stores:
        with open(os.path.join(cpt_dir, "config.json"), "w") as f:
            json.dump({"stores": sidecar_stores}, f, indent=1)


def snapshot_from_capture(nt, cur_tick: int = 0) -> ArchSnapshot:
    """A nativetrace capture's initial state → ArchSnapshot.

    The capture already holds exactly what a drained checkpoint holds —
    architectural registers + memory image at the window boundary (SURVEY
    §5.4) — so the tracer doubles as the framework's SE-mode checkpointing
    tool; ``write_arch_snapshot`` of this result produces an m5.cpt that
    ``CheckpointSpec`` restores without the original process."""
    step0 = nt.steps[0]
    return ArchSnapshot(
        cur_tick=cur_tick,
        version_tags=VERSION_TAGS,
        pc=int(step0[16]),
        int_regs=np.asarray(step0[:16], dtype=np.uint64),
        float_regs=np.zeros(0, np.uint64),
        mem=np.concatenate([np.frombuffer(d, dtype=np.uint8)
                            for _, d in nt.regions])
        if nt.regions else np.zeros(0, np.uint8),
        thread_section="system.cpu.xc.0",
        store_layout=tuple(
            (f"system.physmem.store{i}", len(d))
            for i, (_, d) in enumerate(nt.regions)),
        regions=tuple((int(v), len(d)) for v, d in nt.regions),
    )
