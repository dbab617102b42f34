"""The port's Exec tracer, pipeline viewer and ``trace`` CLI against the
JAX package's, on the CPU.

``disassemble``, ``format_line`` (with a fault annotation) and
``exec_trace`` give the same text for the same window and each
package's own golden record; ``dump_pipeview`` the same timelines for
each package's scoreboard; and ``python -m shrewd_tpu_torch trace
--platform cpu`` the reference CLI's stdout, byte for byte, for ``-n 8
--all``, ``--results`` and ``--pipeline``.  A ``--workload`` run captures
the binary anew in each package (two captures differ,
``test_torch_lift.py``), so only its line count and mnemonics are
compared.

Module fixture: R1, as in ``test_torch_orchestrator.py`` (the reference's
``TrialKernel.golden_rec`` reaches ``jax.core.trace_state_clean``).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import main as ref_main_mod
from shrewd_tpu.isa import uops as RU
from shrewd_tpu.models import o3 as RO3
from shrewd_tpu.models.timing import compute_scoreboard as ref_scoreboard
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.trace import exec_trace as RX
from shrewd_tpu.trace import pipeview as RPV
from shrewd_tpu.trace import synth as rsynth
from shrewd_tpu.utils import debug as rdebug
from shrewd_tpu_torch import main as main_mod
from shrewd_tpu_torch.models import o3 as PO3
from shrewd_tpu_torch.models.timing import compute_scoreboard
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.trace import exec_trace as PX
from shrewd_tpu_torch.trace import pipeview as PPV
from shrewd_tpu_torch.trace import synth as psynth
from shrewd_tpu_torch.utils import debug as pdebug

from test_torch_lift import needs_toolchain
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401

FLAGS = ("Exec", "ExecResult", "ExecOpClass")


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    for d in (pdebug, rdebug):
        d.disable(*FLAGS)


def _traces(n=64, seed=2):
    kw = dict(n=n, nphys=64, mem_words=256, working_set_words=64, seed=seed)
    return (psynth.generate(psynth.WorkloadConfig(**kw)),
            rsynth.generate(rsynth.WorkloadConfig(**kw)))


def test_disassemble_equals_reference():
    mine, ref = _traces(96, seed=5)
    forms = [RU.LOAD, RU.STORE, RU.ADDI, RU.NOP, RU.LUI, RU.BEQ, RU.XORI,
             RU.FADD]
    op = np.asarray(ref.opcode).copy()
    op[:len(forms)] = forms
    mine, ref = mine._replace(opcode=op), ref._replace(opcode=op.copy())
    got = [PX.disassemble(mine, i) for i in range(mine.n)]
    assert got == [RX.disassemble(ref, i) for i in range(ref.n)]
    assert got[3] == "nop" and got[0].startswith("load")


@pytest.mark.parametrize("flags", [("Exec",), ("Exec", "ExecResult"),
                                   ("ExecAll",)])
def test_exec_trace_equals_reference(flags):
    mine, ref = _traces(48)
    pk = TrialKernel(mine, PO3.O3Config(pallas="off"), device="cpu")
    rk = RefKernel(ref, RO3.O3Config(pallas="off"))
    outs = []
    for d, x, tr, rec in ((pdebug, PX, mine, pk.golden_rec),
                          (rdebug, RX, ref, rk.golden_rec)):
        d.enable(*flags)
        buf = io.StringIO()
        assert x.exec_trace(tr, rec, out=buf, start=3, count=40) == 40
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    if "ExecAll" in flags:
        assert "D=0x" in outs[0] and "IntAlu" in outs[0]


def test_format_line_with_a_fault_equals_reference():
    mine, ref = _traces(16)
    pk = TrialKernel(mine, PO3.O3Config(pallas="off"), device="cpu")
    rk = RefKernel(ref, RO3.O3Config(pallas="off"))
    pf = PO3.Fault(kind=torch.tensor(PO3.KIND_FU, dtype=torch.int32),
                   cycle=torch.tensor(5, dtype=torch.int32),
                   entry=torch.tensor(5, dtype=torch.int32),
                   bit=torch.tensor(3, dtype=torch.int32),
                   shadow_u=torch.tensor(1.0))
    rf = RO3.Fault(kind=jnp.int32(RO3.KIND_FU), cycle=jnp.int32(5),
                   entry=jnp.int32(5), bit=jnp.int32(3),
                   shadow_u=jnp.float32(1.0))
    for d in (pdebug, rdebug):
        d.enable("ExecAll")
    got = [PX.format_line(mine, pk.golden_rec, i, pf) for i in range(16)]
    assert got == [RX.format_line(ref, rk.golden_rec, i, rf)
                   for i in range(16)]
    assert [ln for ln in got if "<-- fault" in ln][0].startswith("     5:")
    buf = io.StringIO()
    PX.exec_trace(mine, fault=pf, out=buf)
    assert sum("<-- fault" in ln for ln in buf.getvalue().splitlines()) == 1


def test_exec_trace_is_flag_gated():
    mine, _ = _traces(16)
    buf = io.StringIO()
    assert PX.exec_trace(mine, out=buf) == 0 and buf.getvalue() == ""


@pytest.mark.parametrize("start,count,width", [(0, 32, 100), (10, 64, 20),
                                               (1000, 8, 100)])
def test_pipeview_equals_reference(start, count, width):
    mine, ref = _traces(64)
    outs = []
    for pv, tr, sb in ((PPV, mine, compute_scoreboard(mine)),
                       (RPV, ref, ref_scoreboard(ref))):
        buf = io.StringIO()
        n = pv.dump_pipeview(tr, sb, out=buf, start=start, count=count,
                             max_width=width)
        outs.append((n, buf.getvalue()))
    assert outs[0] == outs[1]
    assert PPV.render_row(3, 5, 9, 12, 0, 16, 2) == \
        RPV.render_row(3, 5, 9, 12, 0, 16, 2)


def _stdout(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv,lines", [
    (["-n", "8", "--all"], 8), (["--results"], 64), (["--pipeline"], 65),
    (["-n", "16", "--start", "200", "--window", "300", "--seed", "4",
      "--all"], 16)], ids=["all", "results", "pipeline", "window"])
def test_cli_trace_stdout_equals_reference(argv, lines):
    rc_p, mine = _stdout(main_mod.main, ["trace", *argv, "--platform",
                                         "cpu"])
    rc_r, ref = _stdout(ref_main_mod.main, ["trace", *argv])
    assert rc_p == rc_r == 0
    assert mine == ref
    assert len(mine.splitlines()) == lines


@needs_toolchain
def test_cli_trace_workload_lines_match_reference():
    argv = ["trace", "--workload", "workloads/sort.c", "-n", "16"]
    rc_p, mine = _stdout(main_mod.main, [*argv, "--platform", "cpu"])
    rc_r, ref = _stdout(ref_main_mod.main, argv)
    assert rc_p == rc_r == 0
    mine, ref = mine.splitlines(), ref.splitlines()
    assert len(mine) == len(ref) == 16
    assert [ln.split()[:2] for ln in mine] == [ln.split()[:2] for ln in ref]
