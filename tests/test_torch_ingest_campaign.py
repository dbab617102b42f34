"""A real workload binary through the port, end to end, on the CPU:
``IngestPipeline(...).run()`` → ``resolved_plan(plan)`` → ``Orchestrator``,
as the JAX package's scheduler calls them.

``workloads/sort.c`` is ingested at the reference test's axes (two
SimPoint windows of 593 and 1063 µops).  The resolved plan — an ordinary
``CampaignPlan`` of ``TraceFileSpec`` windows in the port's store — runs
one regfile batch per window in both packages' orchestrators: the same
events, results, checkpoint document and ``stats.json`` (less the
``perf`` fields that time or count each package's own machinery,
``PERF_OWN``).  The port's CLI runs the same plan file to the same
``stats.json``.

Module fixture: R1 (``jax.core.trace_state_clean``) and R4 (the
reference's ``shard_map`` with ``check_vma=False``), as in
``test_torch_orchestrator.py``.
"""

import contextlib
import io
import json
import os

import pytest

from shrewd_tpu import stats as ref_stats
from shrewd_tpu.campaign import plan as RP
from shrewd_tpu.campaign.orchestrator import Orchestrator as RefOrch
from shrewd_tpu_torch import stats
from shrewd_tpu_torch.campaign import plan as PP
from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.ingest.pipeline import IngestPipeline
from shrewd_tpu_torch.ingest.store import ArtifactStore
from shrewd_tpu_torch.main import main

from test_torch_lift import needs_toolchain
from test_torch_orchestrator import (PERF_OWN, _reference_on_jax_09,  # noqa: F401
                                     ckpt_doc, event_log, mesh, result_key,
                                     stats_doc)

pytestmark = needs_toolchain

AXES = {"interval": 1500, "k": 2, "max_steps": 20000}
BATCH = 128


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_campaign")
    store = ArtifactStore(str(root / "store"))
    digest = store.put_binary(open(hd.build_tools(
        "workloads/sort.c").workload, "rb").read())
    pipe = IngestPipeline(str(root / "tenant" / "ingest"), store, digest,
                          axes=AXES)
    pipe.run()
    return root, pipe


def _plan_doc(pipe, stratify: bool) -> dict:
    base = {"structures": ["regfile"], "batch_size": BATCH,
            "max_trials": BATCH, "min_trials": BATCH,
            "target_halfwidth": 0.01, "stratify": stratify, "seed": 3}
    return pipe.resolved_plan(base)


@pytest.mark.parametrize("stratify", [False, True],
                         ids=["pooled", "stratified"])
def test_ingested_windows_campaign_matches_reference(ingested, mesh,
                                                     stratify):
    root, pipe = ingested
    doc = _plan_doc(pipe, stratify)
    assert [s["type"] for s in doc["simpoints"]] == ["TraceFileSpec"] * 2
    tag = "strat" if stratify else "pooled"
    ro = RefOrch(RP.CampaignPlan.from_dict(doc), mesh=mesh,
                 outdir=str(root / f"ref_{tag}"))
    rev = list(ro.events())
    po = Orchestrator(PP.CampaignPlan.from_dict(doc), device="cpu",
                      outdir=str(root / f"port_{tag}"))
    pev = list(po.events())
    assert event_log(pev) == event_log(rev)
    assert sorted(po.results) == [("sp3", "regfile"), ("sp6", "regfile")]
    for key, r in po.results.items():
        assert result_key(r) == result_key(ro.results[key])
        assert r.trials == BATCH
    assert stats_doc(po, stats) == stats_doc(ro, ref_stats)
    po.checkpoint()
    ro.checkpoint()
    assert ckpt_doc(po.outdir) == ckpt_doc(ro.outdir)


def test_cli_runs_the_resolved_plan(ingested, mesh):
    root, pipe = ingested
    doc = _plan_doc(pipe, False)
    path = str(root / "resolved.json")
    PP.CampaignPlan.from_dict(doc).dump_json(path)
    out = str(root / "cli_out")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["run", path, "--outdir", out, "--platform", "cpu"]) == 0
    ro = RefOrch(RP.CampaignPlan.from_dict(doc), mesh=mesh)
    list(ro.events())
    with open(os.path.join(out, "stats.json")) as f:
        got = json.load(f)
    for k in PERF_OWN:
        got["perf"].pop(k)
    assert got == stats_doc(ro, ref_stats)
