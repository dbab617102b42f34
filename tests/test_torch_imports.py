"""The port stands alone: no jax, nothing of ``shrewd_tpu``, and entry
points that run on the card unless the caller asks for the CPU.  The no-jax
subprocess imports every module of the port and drives the trial path, the
chunked path on both engines, every O3 structure with the FU-pool model,
the campaign loop, the cache, MESI and NoC tier kernels, the campaign
CLI (``run`` in all three modes and ``resume``, and a tier plan), a
campaign on a 3-shard mesh under a chaos plan as an elastic worker, and
the multi-process launcher (its elastic mode, whose worker process runs
without the block) on the CPU."""

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
import pkgutil, importlib, os, tempfile, json
import shrewd_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, "shrewd_tpu_torch."):
    if info.name != "shrewd_tpu_torch.__main__":
        importlib.import_module(info.name)
from shrewd_tpu_torch.campaign.plan import CampaignPlan, WorkloadSpec
from shrewd_tpu_torch.main import main
from shrewd_tpu_torch.trace.synth import WorkloadConfig
plan = CampaignPlan(simpoints=[WorkloadSpec(name="w0", workload=WorkloadConfig(
    n=96, nphys=32, mem_words=64, working_set_words=32, seed=7))],
    structures=["regfile", "fu"], batch_size=32, target_halfwidth=0.08,
    max_trials=2048, min_trials=64, checkpoint_every=2)
with tempfile.TemporaryDirectory() as d:
    plan.dump_json(os.path.join(d, "plan.json"))
    for i, flags in enumerate(([], ["--sync-every", "4"], ["--until-ci"])):
        out = os.path.join(d, f"out{i}")
        assert main(["run", os.path.join(d, "plan.json"), "--outdir", out,
                     "--platform", "cpu", *flags]) == 0
        with open(os.path.join(out, "campaign_ckpt", "campaign.json")) as f:
            st = json.load(f)["state"]["w0"]
        assert st["regfile"]["tallies"] == [83, 60, 17, 0], st
    assert main(["resume", os.path.join(out, "campaign_ckpt"), "--outdir",
                 os.path.join(d, "again"), "--platform", "cpu"]) == 0
from shrewd_tpu_torch.models import mesi as M, noc as N
from shrewd_tpu_torch.models.ruby import CacheHierarchy
h = CacheHierarchy.build(t, device="cpu")
for s in ("data", "tag", "state"):
    assert int(h.l1.run_keys(keys, s).sum()) == 32, s
mcfg = M.MesiConfig()
stream = M.torture_stream(mcfg, 48, 64, seed=0)
mk = M.MesiKernel(stream, mcfg, list(range(64)), device="cpu")
for s in ("state", "tag", "dir", "tbe"):
    assert int(mk.run_keys(keys, s).sum()) == 32, s
nk = N.NocKernel(N.build_message_trace(stream, mcfg, N.NocConfig()),
                 N.NocConfig(), device="cpu")
assert int(nk.run_keys(keys).sum()) == 32
tiers = CampaignPlan(simpoints=[WorkloadSpec(name="w0",
    workload=WorkloadConfig(n=96, nphys=32, mem_words=64,
                            working_set_words=32, seed=7))],
    structures=["cache:data", "mesi:state", "noc:router"], batch_size=32,
    target_halfwidth=0.08, max_trials=2048, min_trials=64,
    coherence_accesses=48)
with tempfile.TemporaryDirectory() as d:
    tiers.dump_json(os.path.join(d, "tiers.json"))
    assert main(["run", os.path.join(d, "tiers.json"), "--outdir", d,
                 "--platform", "cpu", "--until-ci"]) == 0
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.chaos import ChaosEngine
from shrewd_tpu_torch.parallel.elastic import ElasticContext
from shrewd_tpu_torch.parallel.launch import main as launch
from shrewd_tpu_torch.parallel.mesh import make_mesh
import warnings
plan.chaos.spec = json.dumps({"faults": [{"kind": "corrupt_tally",
                                          "at_batch": 0}]})
with warnings.catch_warnings(), tempfile.TemporaryDirectory() as d:
    warnings.simplefilter("ignore")     # 32 rounds to 33 on 3 shards
    o = Orchestrator(plan, mesh=make_mesh(["cpu"] * 3))
    o.attach_elastic(ElasticContext(d, "w0"))
    assert list(o.events())[-1][0].name == "CAMPAIGN_COMPLETE"
    o._elastic.stop()
    assert o.chaos.survived == {"corrupt_tally": 1}
    assert o._elastic.claimed >= 2
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert launch(["--mode", "elastic", "--num-processes", "1",
                   "--platform", "cpu", "--num-batches", "2",
                   "--no-reference"]) == 0
assert json.loads(out.getvalue())["ok"]
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
