"""The pins behind ``chip_smoke.py`` phase 11: the JAX reference's tally of
the first 1024 flagship keys for each structure under
``O3Config(shadow_model="fupool")``, recomputed on the CPU and held equal
to the script's constants (the port at that size runs on the card, in
phase 11)."""

import jax
import numpy as np
import pytest

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import o3 as RO
from shrewd_tpu.ops.trial import TrialKernel as RefKernel
from shrewd_tpu.utils import prng as ref_prng
# the module's R1 alias fixture (autouse)
from test_torch_structures import OTHERS, _trace_state_alias  # noqa: F401
from test_torch_trial import _chip_smoke


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture(scope="module")
def flagship(smoke):
    """One reference kernel on the flagship window for every structure."""
    t = ref_native.generate_trace(**smoke.FLAGSHIP)
    return RefKernel(t, RO.O3Config(shadow_model="fupool"))


@pytest.mark.parametrize("structure", OTHERS)
def test_structure_pins_for_chip_smoke(smoke, flagship, structure):
    """chip_smoke.py holds each structure's tally of the first 1024
    flagship keys against a constant: it must be the reference's, under
    ``O3Config(shadow_model="fupool")``."""
    assert jax.config.jax_threefry_partitionable
    keys = ref_prng.trial_keys(ref_prng.campaign_key(0), smoke.N_PIN_S)
    tally = np.asarray(flagship.run_keys(keys, structure))
    assert tally.tolist() == smoke.PIN_STRUCTURES[structure]
