"""The port stands alone: no jax, nothing of ``shrewd_tpu``, and entry
points that run on the card unless the caller asks for the CPU.  The no-jax
subprocess drives the trial path, the chunked path on both engines, every
O3 structure with the FU-pool model and the campaign loop."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shrewd_tpu_torch import compat, native
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.utils import prng

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import shrewd_tpu_torch, shrewd_tpu_torch.compat
from shrewd_tpu_torch import native
from shrewd_tpu_torch.ops.trial import TrialKernel
from shrewd_tpu_torch.utils import prng
t = native.generate_trace(seed=1, n=64, nphys=64, mem_words=256,
                          working_set_words=64)
tally = TrialKernel(t, device="cpu").run_keys(
    prng.trial_keys(prng.campaign_key(0, "cpu"), 32), "regfile")
assert int(tally.sum()) == 32, tally
from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
keys = prng.trial_keys(prng.campaign_key(1, "cpu"), 32)
for engine in ("taint", "exact"):
    out = ChunkedCampaign(TrialKernel(t, device="cpu"), chunk=24,
                          engine=engine).outcomes_from_keys(keys, "regfile")
    assert out.shape == (32,), out
import shrewd_tpu_torch.models.fupool, shrewd_tpu_torch.models.minor
import shrewd_tpu_torch.models.timing
import shrewd_tpu_torch.parallel.campaign, shrewd_tpu_torch.parallel.stopping
from shrewd_tpu_torch.models.o3 import O3Config
from shrewd_tpu_torch.parallel import ShardedCampaign, run_until_ci
k = TrialKernel(t, O3Config(shadow_model="fupool"), device="cpu")
for s in ("fu", "rob", "iq", "lsq", "latch"):
    assert int(k.run_keys(keys, s).sum()) == 32, s
r = run_until_ci(ShardedCampaign(k, None, "fu", stratify=True), seed=0,
                 simpoint_id=0, structure_id=1, batch_size=32,
                 max_trials=64)
assert r.trials == 64, r
loaded = sorted(m for m in sys.modules
                if m == "shrewd_tpu" or m.startswith("shrewd_tpu."))
assert not loaded, loaded
print("ok", tally.tolist())
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_runs_without_jax_or_the_reference():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_trial_kernel_defaults_to_the_card():
    t = native.generate_trace(seed=1, n=32, nphys=64, mem_words=256,
                              working_set_words=64)
    if torch.cuda.is_available():
        assert TrialKernel(t).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrialKernel(t)
    assert TrialKernel(t, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda: prng.campaign_key(0),
    lambda: prng.threefry_seed(7),
    lambda: prng.trial_key(0, 1, 2, 3, 4),
    lambda: compat.keys_from_key_data(np.zeros((4, 2), np.uint32)),
    lambda: compat.fault_from_arrays(*([np.zeros(4)] * 5)),
], ids=["campaign_key", "threefry_seed", "trial_key", "keys_from_key_data",
        "fault_from_arrays"])
def test_keys_and_inputs_default_to_the_card(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, alone)):
        env = _env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=240)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
