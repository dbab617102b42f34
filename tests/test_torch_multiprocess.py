"""The port's multi-process launcher (``python -m
shrewd_tpu_torch.parallel.launch``) on the CPU.

Collective mode: two processes of two CPU shards each join one gloo group;
every worker's reduced tally (the budgeted route, an escape budget of 1
exceeded per shard, the shards gathered for the shard-vs-sum check) must
equal the single-process 4-shard run and the JAX reference's on a 4-device
mesh.  Elastic mode: two orchestrator processes share a small campaign
through the lease board, worker 1 is hard-killed (rc 137) at its second
dispatched batch, and the survivor revokes its lease, reclaims the batch
and finishes with the undisturbed single-process results.  Every child has
a timeout; the group is process-wide, so it lives only in the children.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from shrewd_tpu.models.o3 import O3Config
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import make_mesh as ref_make_mesh
from shrewd_tpu.trace.synth import WorkloadConfig, generate
from shrewd_tpu.utils import prng as ref_prng
# R1 and R4 for the reference (autouse, module scope)
from test_torch_orchestrator import _reference_on_jax_09  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _launch(*argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "shrewd_tpu_torch.parallel.launch",
         "--platform", "cpu", "--timeout", "120", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.stdout.strip(), proc.stderr[-2000:]
    return proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1]), \
        proc.stderr


def test_two_gloo_processes_equal_one_process_and_the_reference():
    rc, res, err = _launch("--num-processes", "2", "--local-devices", "2",
                           "--batch", "128")
    assert rc == 0 and res["ok"], (res, err[-2000:])
    assert res["global_devices"] == 4 and res["workers_agree"]
    assert res["matches_single_process"]
    for w in res["workers"].values():
        assert (w["world_size"], w["backend"]) == (2, "gloo")
        # one all_reduce and one all_gather, one shard-vs-sum check
        assert (w["reductions"], w["shard_checks"]) == (2, 1)
    # the JAX reference on a 4-device mesh, same window, keys and budget
    kernel = RefKernel(generate(WorkloadConfig(
        n=96, nphys=32, mem_words=64, working_set_words=32, seed=0)),
        O3Config(escape_budget=1))
    camp = RefCampaign(kernel, ref_make_mesh(jax.devices()[:4]), "regfile",
                       integrity_check=True)
    want = camp.tally_batch(ref_prng.trial_keys(ref_prng.campaign_key(0),
                                                128))
    np.testing.assert_array_equal(res["tally"], np.asarray(want))
    assert res["workers"]["0"]["escapes"] == kernel.escapes


def test_elastic_survivor_recovers_a_killed_worker_bit_identically():
    rc, res, err = _launch("--mode", "elastic", "--num-processes", "2",
                           "--kill-worker", "1", "--at-batch", "2")
    assert rc == 0 and res["ok"], (res, err[-2000:])
    w1 = res["workers"]["w1"]
    assert (w1["rc"], w1["killed"], w1["dispatches"]) == (137, True, 2)
    assert res["published_by"].get("w1", 0) >= 1     # before it died
    assert res["survivors"] == [0] and res["matches_single_process"]
    assert res["leases_revoked"] >= 1 and res["batches_reclaimed"] >= 1
    assert res["workers"]["w0"]["elastic"]["workers_lost"] == 1
    # each batch computed once between them; the dense CPU plan never
    # reaches K1 or its plain version on card tensors
    w0 = res["workers"]["w0"]
    assert w0["batches_computed"] + w1["batches_computed"] == 4
    assert w0["batches_computed"] >= 1 and w1["batches_computed"] == 1
    for w in (w0, w1):
        assert (w["k1_launches"], w["k1_plain_card_calls"]) == (0, 0)
