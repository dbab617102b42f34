"""The pins behind ``chip_smoke.py`` phase 12: the JAX reference's
``run_until_ci`` on the flagship window, recomputed on the CPU and held
equal to the script's constants (the port at that size runs on the card,
in phase 12)."""

import jax
import pytest

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.parallel import ShardedCampaign as RefCampaign
from shrewd_tpu.parallel import run_until_ci as ref_run_until_ci
# the module's R1 alias fixture (autouse) and the one-device mesh
from test_torch_campaign import _trace_state_alias, mesh  # noqa: F401
from test_torch_trial import _chip_smoke


@pytest.mark.parametrize("structure", ["regfile", "fu"])
def test_campaign_pins_for_chip_smoke(mesh, structure):
    """chip_smoke.py holds the port's ``run_until_ci`` on the flagship
    window against constants: they must be the reference's."""
    assert jax.config.jax_threefry_partitionable
    smoke = _chip_smoke()
    kernel = RefKernel(ref_native.generate_trace(**smoke.FLAGSHIP),
                       RO.O3Config(shadow_model="fupool"))
    r = ref_run_until_ci(
        RefCampaign(kernel, mesh, structure, stratify=True), seed=0,
        simpoint_id=0, structure_id=list(RO.STRUCTURES).index(structure),
        batch_size=smoke.CI_BATCH, target_halfwidth=smoke.CI_TARGET)
    pin = smoke.PIN_CI[structure]
    assert r.converged
    assert r.tallies.tolist() == pin["tallies"]
    assert r.strata_tallies.tolist() == pin["strata"]
    assert (r.trials, r.batches) == (pin["trials"], pin["batches"])
    assert tuple(r.avf_interval) == pin["avf_interval"]
