"""The port's ``tools.protect_validate`` against the JAX package's, on the
CPU.

``shrewd_tpu_torch/tools/protect_validate.py`` is held against the repo's
``tools/protect_validate.py`` (imported by path) on ``workloads/sort.c`` at
128 trials, both from ONE ptrace capture: the shadow leg's unprotected and
protected tallies, the schemes' detection estimates, the prediction, the
measured fractions and their Wilson intervals, the parity leg, ``pass`` and
the exit code (1 when it does not pass) must be equal once the port's
``card`` is dropped.  Both kernels carry the lifted window's memmap, so
every lane runs the memmap dense replay in both packages.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json

import pytest

from shrewd_tpu_torch.tools import protect_validate

from test_torch_lift import needs_toolchain
from test_torch_northstar import load_reference, scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401
from test_torch_timing_tools import run_both

pytestmark = needs_toolchain


def test_protect_validate_equals_the_reference(monkeypatch, tmp_path,
                                               capsys):
    got, ref, rc, ref_rc = run_both(monkeypatch, tmp_path,
                                    "protect_validate", protect_validate.main,
                                    ["--trials", "128"], {})
    assert rc == ref_rc == (0 if ref["pass"] else 1)
    assert got["card"] is None
    assert scrub(got) == ref
    leg = got["shadow_leg"]
    assert sum(leg["unprotected_tally"]) == sum(leg["protected_tally"]) == 128
    assert leg["protected_tally"][3] > 0        # the shadow FUs detect
    assert got["parity_leg"]["pass"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1])


@pytest.mark.parametrize("k,n", [(0, 0), (0, 128), (27, 128), (128, 128),
                                 (401, 8192)])
def test_wilson_equals_the_reference(k, n):
    ref = load_reference("protect_validate")
    assert protect_validate.wilson(k, n) == ref.wilson(k, n)
