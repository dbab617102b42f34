"""The port stands alone: no jax, nothing of ``shrewd_tpu``, and entry
points that run on the card unless the caller asks for the CPU.  The no-jax
subprocess imports every module of the port and drives the trial path, the
chunked path on both engines, every O3 structure with the FU-pool model,
the campaign loop, the cache, MESI and NoC tier kernels, the campaign
CLI (``run`` in all three modes and ``resume``, and a tier plan), a
campaign on a 3-shard mesh under a chaos plan as an elastic worker, and
the multi-process launcher (its elastic mode, whose worker process runs
without the block), the gem5 artifacts (an ``m5.cpt`` written and
restored, a ``CheckpointSpec`` campaign through the ``Simulator``, its
``config.ini`` and ``stats.txt`` read back, ``memchecker`` on its golden
record) and the CLI's ``trace``, and, where the host toolchain is
present, the ingest of a workload binary (``IngestPipeline.run`` with its
preprocess stage), ``hostdiff.run_device`` with and without escalation
and the lifted restore of a captured window, on the CPU, and the fleet
and scenario CLIs (``tools.fleet --plans`` and ``tools.scenario --serve``
and ``--status`` with ``--platform cpu``), the protection search and the
thermal network, and the federation CLI (``tools.federation --plans``
under ``kill_pod`` chaos with the HTTP front, then ``--status``, with
``--platform cpu``, and again with ``--certify warn``) and a gateway
crash sweep, and the analysis layer: the standard step certificates on
the CPU, ``tools.graftlint`` over the port's tree and ``tools.obs`` over
the fleet's artifacts.  A second no-jax subprocess runs the north-star
tools, ``tools.northstar`` (serial, then ``--fleet --also-serial``) and
``tools.simpoint_avf``, on ``workloads/rotmix.c`` with ``--platform
cpu``, and a no-jax subprocess for each validation tool
(``timing_validate``, ``timing_effect``, ``protect_validate``,
``strat_effect``, ``diff_artifacts``, ``threeway_diff``) and each
window-scale tool (``bigwindow`` on a cut ``lzss.c`` capture,
``window_scale`` over its document) runs it at a small size with
``--platform cpu``; without ``--platform`` each raises before any work on
a host without a card.  The fleet's mesh, a
federation pod's mesh, ``DesignSpace`` and the thermal factorization
default to the card too; the port's version is the reference's."""

import functools
import json
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
from shrewd_tpu_torch.campaign.plan import CheckpointSpec
from shrewd_tpu_torch.ingest import configfile, cpt, statsfile, warm
from shrewd_tpu_torch.sim import Simulator
from shrewd_tpu_torch.trace import exec_trace, pipeview
from shrewd_tpu_torch.utils import memchecker, units
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert main(["trace", "-n", "8", "--all", "--platform", "cpu"]) == 0
    assert main(["trace", "--pipeline", "-n", "4", "--platform", "cpu"]) == 0
assert len(out.getvalue().splitlines()) == 13, out.getvalue()
import numpy as np
rng = np.random.default_rng(0)
with tempfile.TemporaryDirectory() as d:
    cpt.write_arch_snapshot(os.path.join(d, "cpt"), cpt.ArchSnapshot(
        cur_tick=0, version_tags=cpt.VERSION_TAGS, pc=0x1000,
        int_regs=rng.integers(0, 2**63, 16, dtype=np.uint64),
        float_regs=np.zeros(0, np.uint64),
        mem=rng.integers(0, 256, 64, dtype=np.uint8),
        thread_section="system.cpu.xc.0", regions=((0x600000, 64),)))
    cp = CampaignPlan(simpoints=[CheckpointSpec(
        name="c", cpt_dir=os.path.join(d, "cpt"), warmup=8,
        workload=WorkloadConfig(n=96, nphys=32, mem_words=64,
                                working_set_words=32, seed=7))],
        structures=["regfile"], batch_size=32, max_trials=64, min_trials=64)
    res = Simulator(cp, outdir=os.path.join(d, "out"), device="cpu").run()
    assert res[("c", "regfile")].trials == 64, res
    st = statsfile.load_stats_txt(os.path.join(d, "out", "stats.txt"))
    assert st[0]["campaign.c.regfile.trials"] == 64, st
    cp.dump_ini(os.path.join(d, "config.ini"))
    tree = configfile.tree_from_ini(configfile.load_config_ini(
        os.path.join(d, "config.ini")))
    assert configfile.find_params(tree, "batch_size") == [
        ("root.batch_size", "32")], tree
    tr = cp.simpoints[0].build_trace()
    gold = TrialKernel(tr, device="cpu").golden_rec
    assert memchecker.check_trace(tr, golden_record=gold).n_violations == 0
    assert units.to_bytes("2KiB") == 2048
import shutil
if all(shutil.which(x) for x in ("gcc", "g++", "objdump", "nm")):
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.pipeline import IngestPipeline
    from shrewd_tpu_torch.ingest.store import ArtifactStore
    paths = hd.build_tools("workloads/sort.c")
    lt, meta = hd.capture_and_lift_to_output(paths)
    c = hd.sample_coords(8, meta["window_macro_ops"], 0)
    assert hd.run_device(lt, meta, c, resolve_diverged=False,
                         device="cpu").shape == (8,)
    assert hd.run_device(lt, meta, c[:2], paths=paths,
                         device="cpu").shape == (2,)
    with tempfile.TemporaryDirectory() as d:
        st = ArtifactStore(os.path.join(d, "store"))
        dig = st.put_binary(open(paths.workload, "rb").read())
        ing = IngestPipeline(os.path.join(d, "t"), st, dig, axes={
            "interval": 1500, "k": 2, "max_steps": 20000,
            "preprocess": True, "chunk": 512})
        assert len(ing.run()["simpoints"]) == 2
        from shrewd_tpu_torch.ingest.lift import read_nativetrace
        cap = os.path.join(d, "win.bin")
        import subprocess
        subprocess.run([str(paths.tracer), cap, f"{paths.begin:x}",
                        f"{paths.end:x}", "2000000", str(paths.workload)],
                       check=True, capture_output=True)
        cpt.write_arch_snapshot(os.path.join(d, "sort_cpt"),
                                cpt.snapshot_from_capture(
                                    read_nativetrace(cap)))
        lt, meta = warm.window_from_snapshot_lifted(
            cpt.load_arch_snapshot(os.path.join(d, "sort_cpt")),
            str(paths.workload), max_steps=200)
        assert meta["emu_steps"] == 200 and lt.n > 0, meta
from shrewd_tpu_torch.search import DesignSpace, StructureProfile
from shrewd_tpu_torch.utils.thermal import ThermalNetwork
from shrewd_tpu_torch.tools import fleet as fleet_cli
from shrewd_tpu_torch.tools import scenario as scenario_cli
ds = DesignSpace([StructureProfile.from_tally("a", 64, [5, 3, 2, 0]),
                  StructureProfile.from_tally("b", 32, [7, 1, 2, 0])],
                 device="cpu")
assert ds.search(0.0).feasible
th = ThermalNetwork(n_nodes=1).resistor(0, -1, 2.0).capacitor(0, -1, 5.0)
assert th.build(device="cpu").trajectory(np.ones((8, 1))).shape == (8, 1)
tiny = {"type": "WorkloadSpec", "name": "w0", "workload": {
    "n": 96, "nphys": 32, "mem_words": 64, "working_set_words": 32,
    "seed": 7}}
small = {"structures": ["regfile"], "batch_size": 32, "max_trials": 64,
         "min_trials": 64, "target_halfwidth": 0.2, "simpoints": [tiny],
         "integrity": {"canary_trials": 0, "audit_rate": 0.0},
         "coherence_accesses": 48, "coherence_mem_words": 64}
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stderr(io.StringIO()), \
        contextlib.redirect_stdout(io.StringIO()):
    json.dump(small, open(os.path.join(d, "p.json"), "w"))
    assert fleet_cli.main(["--plans", os.path.join(d, "p.json"),
                           os.path.join(d, "p.json"), "--outdir",
                           os.path.join(d, "fleet"), "--platform",
                           "cpu"]) == 0
    json.dump({"tag": "t", "workloads": [{"name": "wl",
                                          "simpoints": [tiny]}],
               "targets": ["regfile", "mesi:state"],
               "schemes": [{"name": "parity", "detect": 1.0,
                            "area": 1.03, "priority": 1},
                           {"name": "secded", "correct": 1.0,
                            "area": 1.22}],
               "base": {k: v for k, v in small.items()
                        if k != "simpoints"}},
              open(os.path.join(d, "m.json"), "w"))
    assert scenario_cli.main(["--plan", os.path.join(d, "m.json"),
                              "--serve", "--outdir",
                              os.path.join(d, "m"), "--platform",
                              "cpu", "--pareto-every", "1"]) == 0
    assert scenario_cli.main(["--status", os.path.join(d, "m")]) == 0
    assert os.path.exists(os.path.join(d, "m", "PARETO_t.json"))
import shrewd_tpu_torch.federation.autoscale
import shrewd_tpu_torch.federation.driver
import shrewd_tpu_torch.federation.gateway
import shrewd_tpu_torch.federation.http_front
import shrewd_tpu_torch.federation.pods
from shrewd_tpu_torch import federation
from shrewd_tpu_torch.analysis import crashcheck
from shrewd_tpu_torch.tools import federation as federation_cli
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stderr(io.StringIO()), \
        contextlib.redirect_stdout(io.StringIO()) as out:
    json.dump(small, open(os.path.join(d, "p.json"), "w"))
    json.dump({"faults": [{"kind": "kill_pod", "pod": "pod0",
                           "at_tick": 1}]},
              open(os.path.join(d, "chaos.json"), "w"))
    fed_root = os.path.join(d, "fed")
    assert federation_cli.main([
        "--plans", os.path.join(d, "p.json"), os.path.join(d, "p.json"),
        "--outdir", fed_root, "--pods", "2", "--expiry-rounds", "2",
        "--chaos-plan", os.path.join(d, "chaos.json"), "--http", "0",
        "--platform", "cpu"]) == 0
    assert federation_cli.main(["--status", fed_root]) == 0
    status = json.loads(out.getvalue()[out.getvalue().index("{"):])
    assert sorted(status["tenants"]) == ["t0_p", "t1_p"], status
    assert status["dead_pods"] == ["pod0"], status
    assert federation_cli.main(["--plans", os.path.join(d, "p.json"),
                                "--outdir", os.path.join(d, "fed2"),
                                "--platform", "cpu", "--certify",
                                "warn"]) == 0
    from shrewd_tpu_torch.parallel import exec_cache
    assert exec_cache.current_auditor() is not None
    exec_cache.clear_auditor()
    doc = crashcheck.run_gateway_crashcheck(
        os.path.join(d, "sweep"), crashcheck.small_fleet_plans(
            seeds=(3,), n_batches=1), mesh=make_mesh(["cpu"]),
        point_filter=lambda pt: pt.kind in ("route", "place"))
    assert doc["ok"] and doc["points_checked"] == 2, doc
from shrewd_tpu_torch.analysis.certify import certify_standard_executables
from shrewd_tpu_torch.tools import graftlint as graftlint_cli
from shrewd_tpu_torch.tools import obs as obs_cli
cdoc = certify_standard_executables(batch_size=8, sync_every=2, device="cpu")
assert cdoc["ok"] and cdoc["fixture_rejected"], cdoc
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stdout(io.StringIO()):
    assert graftlint_cli.main(["--no-jaxpr", "--strict", "--audit-waivers",
                               "--sarif", os.path.join(d, "l.sarif")]) == 0
    json.dump({"faults": []}, open(os.path.join(d, "chaos.json"), "w"))
    json.dump(small, open(os.path.join(d, "p.json"), "w"))
    assert fleet_cli.main(["--plans", os.path.join(d, "p.json"),
                           "--outdir", os.path.join(d, "fleet"), "--trace",
                           "--platform", "cpu"]) == 0
    assert obs_cli.main(["--tail", os.path.join(d, "fleet")]) == 0
    events = [{"seq": 0, "name": "tenant_start", "cat": "fleet",
               "ph": "i", "ts": 0.0, "args": {"tenant": "a"}}]
    json.dump(events, open(os.path.join(d, "ev.json"), "w"))
    assert obs_cli.main(["--summarize", os.path.join(d, "ev.json")]) == 0
    assert obs_cli.main(["--timeline", os.path.join(d, "ev.json")]) == 0
loaded = sorted(m for m in sys.modules
                if m == "shrewd_tpu" or m.startswith("shrewd_tpu."))
assert not loaded, loaded
print("ok", tally.tolist())
"""


_NO_JAX_NORTHSTAR = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import contextlib, io, json, os, tempfile
from shrewd_tpu_torch.tools import northstar, simpoint_avf
small = ["--workloads", "workloads/rotmix.c", "--structures", "regfile",
         "--k", "1", "--batch", "64", "--max-trials", "128",
         "--fleet-batch", "64", "--sync-every", "2", "--platform", "cpu"]
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stderr(io.StringIO()), \
        contextlib.redirect_stdout(io.StringIO()):
    out = [os.path.join(d, n) for n in ("s.json", "f.json", "b.json",
                                        "a.json")]
    assert northstar.main([*small, "--out", out[0]]) == 0
    assert json.load(open(out[0]))["total_trials"] == 128
    assert northstar.main([*small, "--fleet", "--also-serial", "--out",
                           out[0], "--fleet-out", out[1], "--bench-out",
                           out[2]]) == 0
    assert json.load(open(out[2]))["fleet_trials"] == 128
    assert simpoint_avf.main(["--workload", "workloads/rotmix.c", "--k",
                              "1", "--trials", "64", "--platform", "cpu",
                              "--out", out[3]]) == 0
    assert sum(json.load(open(out[3]))["windows"][0]["tally"]) == 64
loaded = sorted(m for m in sys.modules
                if m == "shrewd_tpu" or m.startswith("shrewd_tpu."))
assert not loaded, loaded
print("ok")
"""


# the validation tools and the window-scale tools, each in a no-jax
# process of its own at a small size on the CPU: (tool, its arguments, a
# check of its document; window_scale collates a bigwindow run's)
_VALIDATION = {
    "timing_validate": ([], "doc['uops'] == doc['proxy_cycles'] > 0"),
    "timing_effect": (["--workload", "workloads/rotmix.c", "--trials", "8"],
                      "sum(doc['structures']['fu']['squash']['tally']) == 8"),
    "protect_validate": (["--workload", "workloads/rotmix.c", "--trials",
                          "32"],
                         "sum(doc['shadow_leg']['protected_tally']) == 32"),
    "strat_effect": (["--batches", "1", "--batch", "16"],
                     "len(doc['tiers']) == 6"),
    "diff_artifacts": (["--workloads", "workloads/rotmix.c", "--trials",
                        "2"], "doc['summary']['workloads_ok'] == 1"),
    "threeway_diff": (["--golden", "GOLDEN"],
                      "doc['coords'] == 2 and doc['binary_sha']"),
    "bigwindow": (["--build", "--rate", "--chunked", "--lengths", "256",
                   "--max-steps", "600", "--chunk", "128", "--trials", "16",
                   "--reps", "1"],
                  "sum(doc['rate']['rates']['256']['tally']) == 16"),
    "window_scale": (["--chunked", "BIGWINDOW"],
                     "list(doc['chunked_exact']) == ['256']"),
}

_NO_JAX_VALIDATION = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import contextlib, io, importlib, json, os, tempfile
tool, argv, check = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
mod = importlib.import_module(f"shrewd_tpu_torch.tools.{tool}")
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stderr(io.StringIO()), \
        contextlib.redirect_stdout(io.StringIO()):
    if "GOLDEN" in argv:
        with open("GEM5_GOLDEN_ROTMIX_r04.json") as f:
            golden = json.load(f)
        golden["trials"] = golden["trials"][:2]
        with open(os.path.join(d, "golden.json"), "w") as f:
            json.dump(golden, f)
        argv[argv.index("GOLDEN")] = os.path.join(d, "golden.json")
    if tool in ("bigwindow", "window_scale"):
        from pathlib import Path
        from shrewd_tpu_torch.tools import bigwindow
        bigwindow.CACHE = Path(d)       # the windows in the temporary dir
    if "BIGWINDOW" in argv:
        bw = os.path.join(d, "bw.json")
        assert bigwindow.main([*json.loads(sys.argv[4]), "--out", bw,
                               "--platform", "cpu"]) == 0
        argv[argv.index("BIGWINDOW")] = bw
    out = os.path.join(d, "out.json")
    rc = mod.main([*argv, "--out", out, "--platform", "cpu"])
    doc = json.load(open(out))
assert rc in (0, 1) and doc["card"] is None, (rc, doc)
assert eval(check), doc
loaded = sorted(m for m in sys.modules
                if m == "shrewd_tpu" or m.startswith("shrewd_tpu."))
assert not loaded, loaded
print("ok")
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


@pytest.mark.skipif(not all(shutil.which(x) for x in
                             ("gcc", "g++", "objdump", "nm")),
                    reason="host toolchain required")
def test_north_star_tools_run_without_jax_or_the_reference():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_NORTHSTAR],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.skipif(not all(shutil.which(x) for x in
                             ("gcc", "g++", "objdump", "nm")),
                    reason="host toolchain required")
@pytest.mark.parametrize("tool", sorted(_VALIDATION))
def test_validation_tools_run_without_jax_or_the_reference(tool):
    argv, check = _VALIDATION[tool]
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_VALIDATION, tool,
                           json.dumps(argv), check,
                           json.dumps(_VALIDATION["bigwindow"][0])],
                          cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("tool", sorted(_VALIDATION))
def test_validation_tools_default_to_the_card(tool, tmp_path):
    """Without ``--platform`` each tool runs on the card, and without one
    it raises before any work: no document is written."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this host has a card: tests/test_torch_cuda.py runs "
                    "the tools there")
    mod = importlib.import_module(f"shrewd_tpu_torch.tools.{tool}")
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--out", str(out)])
    assert not out.exists()


def test_trial_kernel_defaults_to_the_card():
    t = native.generate_trace(seed=1, n=32, nphys=64, mem_words=256,
                              working_set_words=64)
    if torch.cuda.is_available():
        assert TrialKernel(t).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrialKernel(t)
    assert TrialKernel(t, device="cpu").device.type == "cpu"


def _design_space():
    from shrewd_tpu_torch.search import DesignSpace, StructureProfile

    return DesignSpace([StructureProfile.from_tally("a", 8, [1, 1, 0, 0])])


def _thermal():
    from shrewd_tpu_torch.utils.thermal import ThermalNetwork

    return ThermalNetwork(n_nodes=1).resistor(0, -1, 2.0).build()


def _fleet_mesh():
    from shrewd_tpu_torch.service import CampaignScheduler

    return CampaignScheduler().mesh


def _pod_mesh(tmp_path):
    from shrewd_tpu_torch.federation import Federation

    fed = Federation(str(tmp_path / "fed"), pod_names=("pod0",))
    return fed.pods["pod0"].build().mesh


def _northstar_device():
    from shrewd_tpu_torch.tools import northstar

    return northstar.device_of(None)


@pytest.mark.parametrize("make", [
    lambda: prng.campaign_key(0),
    lambda: prng.threefry_seed(7),
    lambda: prng.trial_key(0, 1, 2, 3, 4),
    lambda: compat.keys_from_key_data(np.zeros((4, 2), np.uint32)),
    lambda: compat.fault_from_arrays(*([np.zeros(4)] * 5)),
    lambda: _design_space().device,
    lambda: _thermal().G,
    lambda: _fleet_mesh().devices[0],
    lambda tmp_path: _pod_mesh(tmp_path).devices[0],
    lambda: torch.empty(0, device=_northstar_device()),
], ids=["campaign_key", "threefry_seed", "trial_key", "keys_from_key_data",
        "fault_from_arrays", "design_space", "thermal", "fleet_mesh",
        "federation_pod_mesh", "northstar"])
def test_keys_and_inputs_default_to_the_card(make, tmp_path):
    if make.__code__.co_argcount:
        make = functools.partial(make, tmp_path)
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_version_is_the_reference_version():
    from shrewd_tpu._version import __version__ as ref
    import shrewd_tpu_torch

    assert shrewd_tpu_torch.__version__ == ref


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
