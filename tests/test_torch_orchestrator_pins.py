"""The pins behind ``chip_smoke.py`` phase 13 (the campaign CLI at target
0.005): the JAX reference's run on the flagship window, recomputed on the
CPU and held equal to the script's constants.  The orchestrator derives
its batch keys as ``run_until_ci`` does (seed 0, simpoint 0, the
structure's frozen id), which ``test_torch_orchestrator.py`` holds at a
small size; fu at 0.005 converges in its first batch, as at 0.01, so its
pin is ``PIN_CI``'s and only regfile is recomputed here."""

import jax

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import run_until_ci as ref_run_until_ci
# the module's R1 alias fixture (autouse) and the one-device mesh
from test_torch_campaign import _trace_state_alias, mesh  # noqa: F401
from test_torch_trial import _chip_smoke


def test_orchestrator_pins_for_chip_smoke(mesh):
    assert jax.config.jax_threefry_partitionable
    smoke = _chip_smoke()
    assert smoke.PIN_CLI["fu"] == {k: smoke.PIN_CI["fu"][k] for k in
                                   smoke.PIN_CLI["fu"]}
    kernel = RefKernel(ref_native.generate_trace(**smoke.FLAGSHIP),
                       RO.O3Config(shadow_model="fupool"))
    r = ref_run_until_ci(
        RefCampaign(kernel, mesh, "regfile", stratify=True), seed=0,
        simpoint_id=0, structure_id=0, batch_size=smoke.CI_BATCH,
        target_halfwidth=smoke.CLI_TARGET)
    pin = smoke.PIN_CLI["regfile"]
    assert r.converged
    got = dict(tallies=r.tallies.tolist(), trials=r.trials,
               batches=r.batches, strata=r.strata_tallies.tolist())
    assert got == pin
