"""The port's gateway-WAL crash sweep over the streaming-ingest surface
of a raw-binary tenant (``tests/test_ingest_pipeline.py``'s bounded
sweep), on the CPU, under the host-toolchain skip (continued from
``test_torch_crashcheck_gateway.py``; the module fixture of
``test_torch_federation.py`` works around the reference's faults R1 and
R4).

Recovery re-executed from ingest-WAL appends and artifact-store renames,
with torn-tail and torn-payload variants, four points as the
reference's case bounds it: each recovered federation resumes the
pipeline from its last durable stage (or re-lifts) and serves the
tenant to the undisturbed run's tallies.  Each point re-runs the
pipeline's capture and lift of ``workloads/sort.c``, so this is the
slowest module of the crash checks.
"""

import base64

from shrewd_tpu_torch.ingest import hostdiff as hd
from shrewd_tpu_torch.ingest.store import data_digest

from test_torch_federation import (PORT, _reference_on_jax_09)  # noqa: F401
from test_torch_lift import needs_toolchain
from test_torch_ruby import one_torch_thread  # noqa: F401


@needs_toolchain
def test_ingest_crashcheck_sweep_bounded(tmp_path):
    """Recovery from the streaming-ingest surface of a raw-binary tenant
    (ingest-WAL appends and store renames, with torn-tail and
    torn-payload variants), bounded to four points as the reference's
    case is."""
    from shrewd_tpu_torch.ingest.pipeline import STAGES

    cc = PORT.crashcheck
    data = open(hd.build_tools("workloads/sort.c").workload, "rb").read()
    axes = {"interval": 1500, "k": 2, "max_steps": 20000}
    binaries = {"b0": {"binary_b64": base64.b64encode(data).decode(),
                       "binary_digest": data_digest(data),
                       "ingest": axes}}
    plan = {"structures": ["regfile"], "batch_size": 8, "max_trials": 8,
            "min_trials": 8, "target_halfwidth": 0.5, "seed": 3}
    doc = cc.run_gateway_crashcheck(
        str(tmp_path / "sweep"), plans={"b0": plan}, binaries=binaries,
        max_points=4, mesh=PORT.mesh(),
        point_filter=lambda pt: (pt.kind or "").startswith(("ingest",
                                                            "store")))
    assert doc["failures"] == []
    assert doc["binaries"] == ["b0"]
    assert doc["points_selected"] >= 8
    assert doc["points_checked"] == 4
    assert doc["torn_checks"] >= 1
    by_kind = doc["boundaries_by_kind"]
    assert by_kind.get("ingest_stage", 0) >= len(STAGES)
    assert by_kind.get("ingest_done", 0) >= 1
    assert by_kind.get("store_payload", 0) >= 4
