"""The port's ``tools.timing_effect`` against the JAX package's, on the CPU.

``shrewd_tpu_torch/tools/timing_effect.py`` is held against the repo's
``tools/timing_effect.py`` (imported by path) on ``workloads/rotmix.c``
(its 2946-µop marker window, the smallest of the repo's workloads) at 64
trials, both from ONE ptrace capture: the twelve tallies (rob, iq, lsq and
fu under the proxy, scoreboard and squash models), the squash rows'
mispredicts and wrong-path mass and the deltas must be equal once the
port's ``card`` is dropped.  On the CPU each of the twelve ``run_keys``
walks the window step by step in torch (K1's plain version, then the row
pass), a few seconds each, so this module holds one case alone.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.  Needs gcc, g++, objdump and nm.
"""

import json

from shrewd_tpu_torch.tools import timing_effect

from test_torch_lift import needs_toolchain
from test_torch_northstar import scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401
from test_torch_timing_tools import run_both

pytestmark = needs_toolchain


def test_timing_effect_equals_the_reference(monkeypatch, tmp_path, capsys):
    got, ref, rc, ref_rc = run_both(monkeypatch, tmp_path, "timing_effect",
                                    timing_effect.main,
                                    ["--trials", "64",
                                     "--workload", "workloads/rotmix.c"], {})
    assert rc == ref_rc == 0
    assert got["card"] is None
    assert scrub(got) == ref
    assert got["window_uops"] == 2946
    for s in timing_effect.STRUCTURES:
        row = got["structures"][s]
        assert all(sum(row[m]["tally"]) == 64 for m in
                   ("proxy", "scoreboard", "squash"))
        assert row["squash"]["mispredicts"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1])
