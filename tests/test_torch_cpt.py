"""The port's gem5 checkpoint reader and writer against the JAX package's.

``shrewd_tpu_torch/ingest/cpt.py`` keeps its own copy of the ``m5.cpt``
format (the ini database, byte arrays of unsigned ints, ``true``/``false``
bools, gzipped memory stores and the ``config.json`` sidecar of region
vaddrs).  On the reference's hand-written literal checkpoint
(``tests/test_ingest.py``) both packages read the same sections, entries
and ``ArchSnapshot``; a snapshot written by either package reads back in
the other, and the two writers' files are equal (``m5.cpt`` and
``config.json`` as text, the stores decompressed: gzip stamps each
header with the time).  Errors raise the same exception types, and the
numeric-aware section order is the same.
"""

import gzip
import json
import os

import numpy as np
import pytest

from shrewd_tpu.ingest import cpt as RC
from shrewd_tpu_torch.ingest import cpt as PC
from test_ingest import _CPT_TEXT

PACKAGES = {"reference": RC, "port": PC}


@pytest.fixture
def literal(tmp_path):
    """The reference's literal checkpoint, as ``test_ingest.cpt_dir``
    writes it."""
    d = tmp_path / "cpt.1000500"
    d.mkdir()
    (d / "m5.cpt").write_text(_CPT_TEXT)
    with gzip.open(d / "system.physmem.store0.pmem", "wb") as f:
        f.write(bytes(range(32)))
    return str(d)


def snapshot_fields(snap) -> dict:
    """An ``ArchSnapshot`` of either package as comparable values."""
    return {f: (np.asarray(v).dtype.str, np.asarray(v).tolist())
            if isinstance(v, np.ndarray) else v
            for f, v in zip(snap._fields, snap)}


def test_literal_checkpoint_reads_the_same(literal):
    mine, ref = PC.CheckpointIn(literal), RC.CheckpointIn(literal)
    assert mine.sections() == ref.sections()
    assert mine._db == ref._db
    for sec in ref.sections():
        for entry in ref._db[sec]:
            assert mine.find(sec, entry) == ref.find(sec, entry)
            assert mine.entry_exists(sec, entry)
    assert mine.get_int("Globals", "curTick") == 1000500
    for sec, entry in (("system.cpu0.xc.0", "regs.integer"),
                       ("system.cpu0.xc.0", "regs.floating_point")):
        for getter in ("get_array", "get_bytes"):
            got = getattr(mine, getter)(sec, entry)
            want = getattr(ref, getter)(sec, entry)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    got, want = (c.load_store("system.physmem.store0") for c in (mine, ref))
    assert got[0] == want[0] == 32
    np.testing.assert_array_equal(got[1], want[1])
    assert list(mine.find_sections(r"system\.cpu\d+\.xc\.\d+")) == \
        list(ref.find_sections(r"system\.cpu\d+\.xc\.\d+"))
    assert snapshot_fields(PC.load_arch_snapshot(literal)) == \
        snapshot_fields(RC.load_arch_snapshot(literal))


def _snapshot(mod, n_regions: int, seed: int = 3):
    """A snapshot with a float file and ``n_regions`` stores, each with a
    vaddr (so the writer emits the config.json sidecar)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 6)) * 4 for _ in range(n_regions)]
    return mod.ArchSnapshot(
        cur_tick=77, version_tags=("shrewd-tpu-v1", "extra"),
        pc=0x401000,
        int_regs=rng.integers(0, 2**63, 16, dtype=np.uint64),
        float_regs=rng.integers(0, 2**63, 2, dtype=np.uint64),
        mem=rng.integers(0, 256, sum(sizes), dtype=np.uint8),
        thread_section="system.cpu.xc.0",
        regions=tuple((0x600000 + 0x1000 * i, s)
                      for i, s in enumerate(sizes)))


def _files(d: str) -> dict:
    """A checkpoint directory's files: text as text, stores decompressed."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".pmem"):
            with gzip.open(path, "rb") as f:
                out[name] = f.read()
        else:
            with open(path) as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("n_regions", [0, 1, 12])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_written_by_one_reads_in_the_other(tmp_path, writer,
                                                    n_regions):
    """Each writer's checkpoint reads back to the same snapshot in both
    packages, and the two writers' files are equal.  With 12 regions the
    stores' numeric-aware order (store2 before store10) decides where
    each image lands."""
    snaps = {name: _snapshot(mod, max(n_regions, 1))
             for name, mod in PACKAGES.items()}
    if n_regions == 0:
        snaps = {name: s._replace(regions=()) for name, s in snaps.items()}
    dirs = {}
    for name, mod in PACKAGES.items():
        dirs[name] = str(tmp_path / name)
        mod.write_arch_snapshot(dirs[name], snaps[name])
    assert _files(dirs["port"]) == _files(dirs["reference"])
    assert ("config.json" in os.listdir(dirs["port"])) == (n_regions > 0)
    back = {name: snapshot_fields(mod.load_arch_snapshot(dirs[writer]))
            for name, mod in PACKAGES.items()}
    assert back["port"] == back["reference"]
    assert back["port"]["regions"] == snaps["port"].regions
    np.testing.assert_array_equal(back["port"]["mem"][1], snaps["port"].mem)


def test_snapshot_from_capture_equals_reference(tmp_path):
    """A nativetrace-shaped capture (steps of 16 GPRs + pc, and regions)
    gives the same snapshot and the same written checkpoint."""
    rng = np.random.default_rng(5)

    class Capture:
        steps = rng.integers(0, 2**63, (4, 18), dtype=np.uint64)
        regions = [(0x400000, bytes(rng.integers(0, 256, 12, np.uint8))),
                   (0x7ff000, bytes(rng.integers(0, 256, 20, np.uint8)))]

    mine = PC.snapshot_from_capture(Capture, cur_tick=9)
    ref = RC.snapshot_from_capture(Capture, cur_tick=9)
    assert snapshot_fields(mine) == snapshot_fields(ref)
    PC.write_arch_snapshot(str(tmp_path / "p"), mine)
    RC.write_arch_snapshot(str(tmp_path / "r"), ref)
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "r"))


def _break(literal: str, how: str):
    """One malformed checkpoint per ``how`` → the call that must raise."""
    path = os.path.join(literal, "m5.cpt")
    if how == "missing_entry":
        return lambda mod: mod.CheckpointIn(literal).find("Globals",
                                                          "nonesuch")
    if how == "bad_thread":
        return lambda mod: mod.load_arch_snapshot(literal, thread=1)
    if how == "negative_thread":
        return lambda mod: mod.load_arch_snapshot(literal, thread=-1)
    if how == "not_a_bool":
        return lambda mod: mod.CheckpointIn(literal).get_bool("Globals",
                                                              "curTick")
    if how == "truncated_store":
        with gzip.open(os.path.join(literal, "system.physmem.store0.pmem"),
                       "wb") as f:
            f.write(bytes(range(20)))
    elif how == "odd_register_bytes":
        text = _CPT_TEXT.replace("regs.integer=1 0 0 0 0 0 0 0 2",
                                 "regs.integer=1 0 0 0 0 0 0 2")
        with open(path, "w") as f:
            f.write(text)
    elif how == "no_thread":
        text = _CPT_TEXT.replace("regs.integer=", "regs.other=")
        with open(path, "w") as f:
            f.write(text)
    elif how == "malformed_line":
        with open(path, "a") as f:
            f.write("no equals sign here\n")
    return lambda mod: mod.load_arch_snapshot(literal)


@pytest.mark.parametrize("how", [
    "missing_entry", "bad_thread", "negative_thread", "not_a_bool",
    "truncated_store", "odd_register_bytes", "no_thread", "malformed_line"])
def test_errors_raise_the_same_exceptions(literal, how):
    call = _break(literal, how)
    raised = {}
    for name, mod in PACKAGES.items():
        with pytest.raises(Exception) as info:
            call(mod)
        raised[name] = (type(info.value), str(info.value))
    assert raised["port"] == raised["reference"]
    assert raised["port"][0] in (KeyError, ValueError)


def test_numeric_aware_section_order():
    names = ["system.physmem.store10", "system.cpu2.xc.0",
             "system.physmem.store2", "system.cpu10.xc.0", "Globals",
             "system.physmem.store1", "system.cpu1.xc.11",
             "system.cpu1.xc.2"]
    assert sorted(names, key=PC._numeric_aware_key) == \
        sorted(names, key=RC._numeric_aware_key)
    assert sorted(names, key=PC._numeric_aware_key).index(
        "system.physmem.store2") < sorted(
            names, key=PC._numeric_aware_key).index(
                "system.physmem.store10")


def test_thread_sections_pick_the_same_thread(tmp_path):
    """Three thread contexts named so that a plain sort would misorder
    them: ``thread=i`` picks the same one in both packages."""
    text = _CPT_TEXT
    for i, sec in ((2, "system.cpu10.xc.0"), (3, "system.cpu2.xc.0")):
        text += (f"\n[{sec}]\nregs.integer=" + " ".join(
            str(i if j == 0 else 0) for j in range(8)) + "\n_pc=" +
            str(4096 * i) + "\n_upc=0\n")
    d = tmp_path / "cpt"
    d.mkdir()
    (d / "m5.cpt").write_text(text)
    with gzip.open(d / "system.physmem.store0.pmem", "wb") as f:
        f.write(bytes(range(32)))
    for thread in range(3):
        mine = PC.load_arch_snapshot(str(d), thread)
        ref = RC.load_arch_snapshot(str(d), thread)
        assert snapshot_fields(mine) == snapshot_fields(ref)
    assert PC.load_arch_snapshot(str(d), 1).thread_section == \
        "system.cpu2.xc.0"


def test_sidecar_missing_a_store_leaves_regions_empty(tmp_path):
    snap = _snapshot(PC, 2)
    for name, mod in PACKAGES.items():
        d = str(tmp_path / name)
        mod.write_arch_snapshot(d, snap)
        side = os.path.join(d, "config.json")
        with open(side) as f:
            doc = json.load(f)
        doc["stores"] = doc["stores"][:1]
        with open(side, "w") as f:
            json.dump(doc, f)
    assert PC.load_arch_snapshot(str(tmp_path / "port")).regions == () == \
        RC.load_arch_snapshot(str(tmp_path / "reference")).regions
