"""The pins behind ``chip_smoke.py`` phase 14 (d), the campaign CLI over
the six tier structures, recomputed on the CPU: the orchestrator derives
its batch keys as ``run_until_ci`` does (simpoint 0 for the cache; the
coherence pseudo-simpoint 1,000,000 for MESI and NoC; the frozen
structure ids 6-11), on a 64-access coherence stream, so the pins are the
JAX reference's ``run_until_ci`` results; the port's ``Orchestrator`` on
the CPU reaches them too."""

import json
import os

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import mesi as RM
from shrewd_tpu.models import noc as RN
from shrewd_tpu.models import ruby as RR
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import run_until_ci as ref_run_until_ci
from shrewd_tpu_torch import native
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
from shrewd_tpu_torch.trace import format as tf
# the module's R1/R4 fixture (autouse) and the one-device mesh
from test_torch_orchestrator import _reference_on_jax_09, mesh  # noqa: F401
from test_torch_tier_pins import _coherence
from test_torch_trial import _chip_smoke
from test_torch_ruby import one_torch_thread  # noqa: F401


def test_tier_cli_pins_for_chip_smoke(mesh, tmp_path):
    smoke = _chip_smoke()
    trace = ref_native.generate_trace(**smoke.FLAGSHIP)
    cache_cfg = RR.CacheConfig()
    tl, _ = RR.simulate_cache(RR.golden_access_stream(trace), cache_cfg,
                              trace.n)
    cache = RR.CacheKernel(tl, cache_cfg)
    cfg, stream, init = _coherence(smoke, smoke.TIER_CLI_ACCESSES)
    mesi = RM.MesiKernel(stream, cfg, init)
    noc = RN.NocKernel(RN.build_message_trace(stream, cfg, RN.NocConfig()),
                       RN.NocConfig())
    routes = {"cache:data": (cache, 0, 6), "cache:tag": (cache, 0, 7),
              "cache:state": (cache, 0, 8), "mesi:state": (mesi, 10**6, 9),
              "mesi:tag": (mesi, 10**6, 10), "noc:router": (noc, 10**6, 11)}
    for (sp, s), pin in smoke.PIN_TIER_CLI.items():
        kernel, sp_id, s_id = routes[s]
        r = ref_run_until_ci(
            RefCampaign(kernel, mesh, s.split(":")[1], stratify=True),
            seed=0, simpoint_id=sp_id, structure_id=s_id,
            batch_size=smoke.CI_BATCH, target_halfwidth=smoke.CI_TARGET)
        assert r.converged
        assert dict(tallies=r.tallies.tolist(), trials=r.trials,
                    batches=r.batches,
                    strata=r.strata_tallies.tolist()) == pin, (sp, s)
    # the port's orchestrator on the CPU, over the same plan as the script
    npz = os.path.join(tmp_path, "flagship.npz")
    tf.save(npz, native.generate_trace(**smoke.FLAGSHIP),
            meta={"source": "native.generate_trace"})
    plan = CampaignPlan(
        simpoints=[TraceFileSpec(name="flagship", path=npz)],
        structures=[s for _, s in smoke.PIN_TIER_CLI],
        batch_size=smoke.CI_BATCH, target_halfwidth=smoke.CI_TARGET,
        stratify=True, coherence_accesses=smoke.TIER_CLI_ACCESSES)
    orch = Orchestrator(CampaignPlan.from_dict(json.loads(json.dumps(
        plan.to_dict()))), device="cpu")
    list(orch.events())
    for (sp, s), pin in smoke.PIN_TIER_CLI.items():
        st = orch.state[(sp, s)].to_dict()
        assert dict(tallies=st["tallies"], trials=sum(st["tallies"]),
                    batches=st["next_batch"], strata=st["strata"]) == pin
