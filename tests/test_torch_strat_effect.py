"""The port's ``tools.strat_effect`` against the JAX package's, on the CPU.

``shrewd_tpu_torch/tools/strat_effect.py`` is held against the repo's
``tools/strat_effect.py`` (imported by path) at ``--batches 2 --batch
64``: every tier's mean AVF, batch and trials-reduction factor — the O3
regfile and fu tiers on the generated 2048-µop window, MESI state, dir and
tbe on the torture stream, the NoC router on its message trace — must be
equal once the port's ``card`` is dropped.

Module fixtures: R1 and R4, as in ``test_torch_orchestrator.py``, and one
torch thread.
"""

import json
import sys

from shrewd_tpu_torch.tools import strat_effect

from test_torch_northstar import load_reference, scrub
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401
from test_torch_ruby import one_torch_thread  # noqa: F401

TIERS = ["o3:regfile", "o3:fu", "mesi:state", "mesi:dir", "mesi:tbe",
         "noc:router"]


def test_strat_effect_equals_the_reference(monkeypatch, tmp_path, capsys):
    argv = ["--batches", "2", "--batch", "64"]
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert strat_effect.main([*argv, "--out", str(port_out),
                              "--platform", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["strat_effect.py", *argv,
                                      "--out", str(ref_out)])
    assert load_reference("strat_effect").main() == 0
    got = json.loads(port_out.read_text())
    ref = json.loads(ref_out.read_text())
    assert got["card"] is None
    assert scrub(got) == ref
    assert list(got["tiers"]) == TIERS
    assert all(t["batch"] == 64 and t["trials_reduction_factor"] > 0
               for t in got["tiers"].values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == json.loads(lines[1])
