"""The port's capture readers and lifters against the JAX package's.

``shrewd_tpu_torch.ingest`` keeps its own copies of the host-side ingest
modules (``lift``, ``lift64``, ``emu``, ``liveness``, ``simpoint``) and of
``isa/semantics.py``.  Each is held here against the reference, exactly,
on the same inputs.

A ptrace capture is not reproducible from run to run: the workload's exit
path reads values the kernel randomizes (rdx after ``kernel_end`` differs
between two captures of ``sort.c``).  So both packages lift ONE capture:
``shared_captures`` runs the tracer once per command line and replays its
bytes to every later call, in either package's ``hostdiff``.  The binaries
are built once, by the port's ``build_tools``, into
``shrewd_tpu_torch/_build``; the reference reads the same files.

Needs gcc, g++, objdump and nm, like the reference's ingest tests.
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import types

import numpy as np
import pytest

from shrewd_tpu.ingest import hostdiff as ref_hd
from shrewd_tpu_torch.ingest import hostdiff as hd

needs_toolchain = pytest.mark.skipif(
    shutil.which("gcc") is None or shutil.which("g++") is None
    or shutil.which("objdump") is None or shutil.which("nm") is None,
    reason="host toolchain required")

pytestmark = needs_toolchain


@contextlib.contextmanager
def shared_captures(*modules, cache: dict):
    """Within the block, every run of the ptrace tracer by ``modules``
    (``hostdiff`` or ``pipeline`` of either package) writes the bytes of
    the first run with the same arguments and binary, and returns that
    run's exit status."""
    real = subprocess.run

    def run(cmd, *a, **kw):
        if not str(cmd[0]).endswith("nativetrace"):
            return real(cmd, *a, **kw)
        # the binary by content: the packages' stores hold it at two paths
        with open(cmd[-1], "rb") as f:
            binary = hashlib.sha256(f.read()).hexdigest()
        key = tuple(str(c) for c in cmd[2:-1]) + (binary,)
        if key not in cache:
            out = f"{cmd[1]}.first"
            proc = real([cmd[0], out, *cmd[2:]], capture_output=True,
                        text=True)
            with open(out, "rb") as f:
                cache[key] = (f.read(), proc.returncode, proc.stderr)
            with contextlib.suppress(OSError):
                os.unlink(out)
        data, rc, err = cache[key]
        with open(cmd[1], "wb") as f:
            f.write(data)
        if rc and kw.get("check"):
            raise subprocess.CalledProcessError(rc, cmd, "", err)
        return subprocess.CompletedProcess(cmd, rc, "", err)

    shim = types.SimpleNamespace(run=run, CalledProcessError=(
        subprocess.CalledProcessError))
    saved = [m.subprocess for m in modules]
    for m in modules:
        m.subprocess = shim
    try:
        yield
    finally:
        for m, s in zip(modules, saved):
            m.subprocess = s


def sort_paths():
    return hd.build_tools("workloads/sort.c")


def ref_paths(paths):
    return ref_hd.BuildPaths(*paths)


def assert_trace_equal(got, ref):
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def plain(x):
    """A lifter record (NamedTuples and dataclasses of either package)
    as plain nested tuples."""
    if dataclasses.is_dataclass(x):
        x = dataclasses.astuple(x)
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    return x


def meta_json(meta: dict) -> str:
    return json.dumps(meta, sort_keys=True, default=lambda x: np.asarray(
        x).tolist())


@pytest.fixture(scope="module")
def paths():
    return sort_paths()


@pytest.fixture(scope="module")
def captures():
    return {}


@pytest.fixture(scope="module")
def window_lifts(paths, captures):
    with shared_captures(hd, ref_hd, cache=captures):
        got = hd.capture_and_lift(paths)
        ref = ref_hd.capture_and_lift(ref_paths(paths),
                                      build_dir=hd.BUILD_DIR)
    return got, ref


def test_read_nativetrace_equals_reference(paths, captures):
    """Both packages' readers of one capture file agree."""
    from shrewd_tpu.ingest.lift import read_nativetrace as ref_read
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    cap = hd.BUILD_DIR / "sort_read.bin"
    with shared_captures(hd, cache=captures):
        hd.subprocess.run([str(paths.tracer), str(cap), f"{paths.begin:x}",
                           f"{paths.end:x}", "2000000", str(paths.workload)],
                          check=True)
    try:
        got, ref = read_nativetrace(str(cap)), ref_read(str(cap))
    finally:
        cap.unlink()
    np.testing.assert_array_equal(got.steps, ref.steps)
    assert got.fs_base == ref.fs_base
    assert [(v, bytes(d)) for v, d in got.regions] == \
        [(v, bytes(d)) for v, d in ref.regions]


SEGMENT_PREFIXES = ("cs", "ds", "es", "ss")


@pytest.fixture(scope="module")
def decoded(paths):
    from shrewd_tpu.ingest.lift import static_decode as ref_decode
    from shrewd_tpu_torch.ingest.lift import static_decode

    return static_decode(str(paths.workload)), ref_decode(
        str(paths.workload))


@pytest.fixture(scope="module")
def decoded_unprefixed(paths):
    """The reference's decode of the binary's listing with every segment
    override token taken out ("cs nopw 0x0(%rax,%rax,1)" → "nopw
    0x0(%rax,%rax,1)")."""
    import re

    from shrewd_tpu.ingest import lift as ref_lift

    real = subprocess.run

    def run(cmd, *a, **kw):
        proc = real(cmd, *a, **kw)
        proc.stdout = re.sub(r"(?<=[\t ])(?:cs|ds|es|ss) (?=\S)", "",
                             proc.stdout)
        return proc
    ref_lift.subprocess.run = run
    try:
        return ref_lift.static_decode(str(paths.workload))
    finally:
        ref_lift.subprocess.run = real


def test_static_decode_equals_reference(decoded, decoded_unprefixed):
    """Equal to the reference's decode, but for the instructions whose
    listing starts with a segment override: the reference takes the
    prefix for the mnemonic (its emulator then stops there: "unsupported
    cs"), the port folds it, as it folds lock, bnd, notrack and data16,
    and decodes what the reference decodes without it."""
    got, ref = decoded
    assert got.keys() == ref.keys() == decoded_unprefixed.keys()
    prefixed = [a for a in ref if ref[a].mnemonic in SEGMENT_PREFIXES]
    assert prefixed            # gcc pads loop heads with "cs nopw"
    for a in ref:
        assert plain(got[a]) == plain(decoded_unprefixed[a]), hex(a)
        if a not in prefixed:
            assert plain(got[a]) == plain(ref[a]), hex(a)


def test_capture_and_lift_equals_reference(window_lifts):
    (trace, meta), (rtrace, rmeta) = window_lifts
    assert_trace_equal(trace, rtrace)
    assert meta_json(meta) == meta_json(rmeta)
    assert trace.n > 1000 and meta["stats"]["lift_rate"] > 0.25


@pytest.mark.parametrize("lifter", ["lift", "lift64"])
def test_capture_and_lift_to_output_equals_reference(paths, captures,
                                                     lifter):
    """The extended window (kernel_begin → exit) with its output events,
    through the 32-bit lift and the pair-lane 64-bit lift."""
    from shrewd_tpu.ingest import lift as ref_lift, lift64 as ref_lift64
    from shrewd_tpu_torch.ingest import lift as port_lift, lift64

    port = {"lift": port_lift.lift, "lift64": lift64.lift64}[lifter]
    ref = {"lift": ref_lift.lift, "lift64": ref_lift64.lift64}[lifter]
    with shared_captures(hd, ref_hd, cache=captures):
        trace, meta = hd.capture_and_lift_to_output(paths, lifter=port)
        rtrace, rmeta = ref_hd.capture_and_lift_to_output(
            ref_paths(paths), build_dir=hd.BUILD_DIR, lifter=ref)
    assert_trace_equal(trace, rtrace)
    assert meta_json(meta) == meta_json(rmeta)
    assert meta["output_syscalls"] >= 1 and meta["output_events"]
    assert int(meta.get("width", 32)) == (64 if lifter == "lift64" else 32)


def _window_capture(paths, captures):
    from shrewd_tpu_torch.ingest.lift import read_nativetrace

    cap = hd.BUILD_DIR / "sort_window.bin"
    with shared_captures(hd, cache=captures):
        hd.subprocess.run([str(paths.tracer), str(cap), f"{paths.begin:x}",
                           f"{paths.end:x}", "2000000", str(paths.workload)],
                          check=True)
    try:
        return read_nativetrace(str(cap))
    finally:
        cap.unlink()


def test_liveness_analyze_equals_reference(paths, captures, decoded,
                                           window_lifts):
    from shrewd_tpu.ingest import liveness as ref_lv
    from shrewd_tpu_torch.ingest import liveness

    nt, insts = _window_capture(paths, captures), decoded[0]
    track = {a for lo, hi, _ in window_lifts[0][1]["clusters"]
             for a in range(lo & ~0x3, hi, 4)}
    for kw in ({}, {"track32": track}):
        got, ref = liveness.analyze(nt, insts, **kw), ref_lv.analyze(
            nt, insts, **kw)
        np.testing.assert_array_equal(got.reg_live, ref.reg_live)
        assert got.mem_live32 == ref.mem_live32
        assert (got.steps, got.truncated, got.unknown_insts) == \
            (ref.steps, ref.truncated, ref.unknown_insts)
    clusters = window_lifts[0][1]["clusters"]
    np.testing.assert_array_equal(
        got.mem_word_mask(clusters, window_lifts[0][0].mem_words),
        ref.mem_word_mask(clusters, window_lifts[0][0].mem_words))


@pytest.mark.parametrize("interval,k,seed", [(500, 3, 0), (1500, 2, 0),
                                             (2000, 4, 7)])
def test_bbv_and_simpoints_equal_reference(paths, captures, interval, k,
                                           seed):
    from shrewd_tpu.ingest import simpoint as ref_sp
    from shrewd_tpu_torch.ingest import simpoint

    nt = _window_capture(paths, captures)
    pcs = nt.steps[:-1][:, 16]
    prof, rprof = simpoint.bbv_profile(pcs, interval), ref_sp.bbv_profile(
        pcs, interval)
    for f in rprof._fields:
        np.testing.assert_array_equal(np.asarray(getattr(prof, f)),
                                      np.asarray(getattr(rprof, f)),
                                      err_msg=f)
    got = simpoint.choose_simpoints(prof, k, seed=seed)
    ref = ref_sp.choose_simpoints(rprof, k, seed=seed)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)


def test_semantics_scalar_replay_equals_reference():
    """``isa/semantics.py``, which the lifter's self-check runs: the ALU
    on random operands of every opcode, and the scalar replay of a
    generated window."""
    from shrewd_tpu.isa import semantics as ref_sem
    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.isa import semantics, uops as U

    rng = np.random.default_rng(5)
    for op in range(U.N_OPCODES):
        for a, b, imm in rng.integers(0, 1 << 32, (16, 3)).tolist():
            assert semantics.alu(op, a, b, imm) == ref_sem.alu(op, a, b,
                                                               imm), op
    t = native.generate_trace(seed=3, n=512, nphys=64, mem_words=256,
                              working_set_words=64)
    state, rstate = ((t.init_reg.copy(), t.init_mem.copy(), [])
                     for _ in range(2))
    assert semantics.scalar_replay(t, *state) == ref_sem.scalar_replay(
        t, *rstate)
    for g, r in zip(state, rstate):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert len(state[2]) > 0
