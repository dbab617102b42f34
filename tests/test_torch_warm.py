"""Restore + re-warm through the port against the JAX package's, on the
CPU: ``ingest/warm.py`` and ``CheckpointSpec.build_trace``.

``lift_registers``, ``lift_memory`` and the synthetic
``window_from_snapshot`` (cold and warmed) are held array for array.
Then ONE ptrace capture of ``workloads/sort.c``'s marker window (two
captures differ, ``test_torch_lift.py``) is written once as an
``m5.cpt`` with its ``config.json`` sidecar, and both packages restore
it: ``window_from_snapshot_lifted`` (the emulator runs forward from the
checkpoint's PC over its memory image, and the lifter lifts the stream)
and ``CheckpointSpec(binary=…).build_trace()`` give equal traces and
meta.  ``test_torch_warm_campaign.py`` runs campaigns on that window.

Needs gcc, objdump and nm, like the reference's ingest tests, for the
restored window.
"""

import subprocess

import numpy as np
import pytest

from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.ingest import cpt as RC
from shrewd_tpu.ingest import warm as RW
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.ingest import cpt as PC
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.ingest import warm as PW
from shrewd_tpu_torch.ingest.lift import read_nativetrace
from shrewd_tpu_torch.trace import synth as psynth

from test_torch_lift import assert_trace_equal, meta_json, needs_toolchain

STEPS = 500


def _snapshot(mod, nregs=8, mem_bytes=4096, pc=0x1000, seed=3):
    """``tests/test_ingest.py _mk_snapshot`` in either package."""
    rng = np.random.default_rng(seed)
    return mod.ArchSnapshot(
        cur_tick=42, version_tags=("t",), pc=pc,
        int_regs=rng.integers(0, 1 << 63, size=nregs, dtype=np.uint64),
        float_regs=np.zeros(0, np.uint64),
        mem=rng.integers(0, 256, size=mem_bytes, dtype=np.uint8),
        thread_section="system.cpu.xc.0")


@pytest.mark.parametrize("nregs,nphys", [(2, 16), (8, 16), (16, 64),
                                         (16, 256)])
def test_lift_registers_agrees(nregs, nphys):
    mine = PW.lift_registers(_snapshot(PC, nregs), nphys)
    ref = RW.lift_registers(_snapshot(RC, nregs), nphys)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


def test_lift_registers_refuses_truncation_alike():
    msgs = []
    for mod, w in ((PC, PW), (RC, RW)):
        with pytest.raises(ValueError) as info:
            w.lift_registers(_snapshot(mod, 8), 8)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mem_bytes,words,base", [(8, 4, 0), (4096, 64, 0),
                                                  (4096, 1024, 64),
                                                  (30, 16, 4)])
def test_lift_memory_agrees(mem_bytes, words, base):
    mine = PW.lift_memory(_snapshot(PC, mem_bytes=mem_bytes), words, base)
    ref = RW.lift_memory(_snapshot(RC, mem_bytes=mem_bytes), words, base)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)
    with pytest.raises(ValueError, match="word-aligned"):
        PW.lift_memory(_snapshot(PC), 4, base_addr=2)


@pytest.mark.parametrize("warmup", [0, 16, 200])
def test_window_from_snapshot_agrees(warmup):
    kw = dict(n=64, nphys=32, mem_words=64, working_set_words=32, seed=11)
    mine = PW.window_from_snapshot(_snapshot(PC), psynth.WorkloadConfig(**kw),
                                   warmup)
    ref = RW.window_from_snapshot(_snapshot(RC), rsynth.WorkloadConfig(**kw),
                                  warmup)
    assert mine.n == 64
    assert_trace_equal(mine, ref)


# --- the restored window of a real capture --------------------------------

@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """One capture of sort.c's marker window, written once as a
    checkpoint by the port (both packages write the same files,
    ``test_torch_cpt.py``)."""
    paths = hd.build_tools("workloads/sort.c")
    root = tmp_path_factory.mktemp("warm")
    cap = root / "sort_win.bin"
    subprocess.run([str(paths.tracer), str(cap), f"{paths.begin:x}",
                    f"{paths.end:x}", "2000000", str(paths.workload)],
                   check=True, capture_output=True, text=True)
    nt = read_nativetrace(str(cap))
    cpt_dir = str(root / "cpt")
    PC.write_arch_snapshot(cpt_dir, PC.snapshot_from_capture(nt))
    return root, cpt_dir, str(paths.workload), nt


@needs_toolchain
def test_lifted_window_equals_reference(restored):
    _, cpt_dir, binary, nt = restored
    mine, mmeta = PW.window_from_snapshot_lifted(
        PC.load_arch_snapshot(cpt_dir), binary, max_steps=STEPS)
    ref, rmeta = RW.window_from_snapshot_lifted(
        RC.load_arch_snapshot(cpt_dir), binary, max_steps=STEPS)
    assert_trace_equal(mine, ref)
    assert meta_json(mmeta) == meta_json(rmeta)
    assert mmeta["emu_steps"] == STEPS
    assert mmeta["stats"]["lift_rate"] >= 0.95
    assert len(nt.steps) > STEPS


@needs_toolchain
def test_lifted_path_refuses_a_checkpoint_without_vaddrs(restored):
    _, cpt_dir, binary, _ = restored
    msgs = []
    for cpt, warm in ((PC, PW), (RC, RW)):
        snap = cpt.load_arch_snapshot(cpt_dir)._replace(regions=())
        with pytest.raises(ValueError) as info:
            warm.window_from_snapshot_lifted(snap, binary, max_steps=8)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@needs_toolchain
@pytest.mark.parametrize("lifted", [True, False], ids=["binary", "synth"])
def test_checkpoint_spec_builds_the_reference_trace(restored, lifted):
    _, cpt_dir, binary, _ = restored
    ref_spec = RP.CheckpointSpec(
        name="cpt", cpt_dir=cpt_dir, binary=binary if lifted else "",
        max_steps=STEPS, warmup=64,
        workload=rsynth.WorkloadConfig(n=128, nphys=64, mem_words=256,
                                       working_set_words=64, seed=2))
    spec = PP.CheckpointSpec.from_dict(ref_spec.to_dict())
    mine, ref = spec.build_trace(), ref_spec.build_trace()
    mine.validate()
    assert_trace_equal(mine, ref)


@needs_toolchain
def test_lifted_window_golden_record_is_the_capture(restored):
    """The restored window's golden replay (the port's, on the CPU; the
    card's in tests/test_torch_cuda.py) neither diverges nor traps, its 16
    GPRs are the capture's after the same steps masked to 32 bits
    (``tests/test_emu.py``), and every load checks clean against the
    independent store history, as the reference checks it."""
    from shrewd_tpu.utils import memchecker as RMC
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.utils import memchecker as PMC

    _, cpt_dir, binary, nt = restored
    trace, _ = PW.window_from_snapshot_lifted(
        PC.load_arch_snapshot(cpt_dir), binary, max_steps=STEPS)
    kernel = TrialKernel(trace, O3Config(enable_shrewd=False), device="cpu")
    g = kernel.golden
    assert not bool(g.diverged) and not bool(g.trapped)
    want = nt.steps[STEPS][:16].astype(np.uint64) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(g.reg[0, :16].numpy(), want.astype(np.int64))
    got = PMC.check_trace(trace, golden_record=kernel.golden_rec)
    res = kernel.golden_rec.res.numpy()
    assert tuple(got) == tuple(RMC.check_trace(
        trace, observed_loads=res[np.asarray(trace.opcode) == RMC.U.LOAD]))
    assert got.n_violations == 0 and got.n_loads > 0
