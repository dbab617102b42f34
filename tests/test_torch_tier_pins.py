"""The pins behind ``chip_smoke.py`` phase 14 (b), the tier structures:
the JAX reference's tallies of the first keys of
``trial_keys(campaign_key(0), ·)`` on the flagship window's L1 and chained
L2 (``CacheHierarchy.build``), and on the MESI and NoC kernels at the
plan's defaults (512 accesses over 256 words, seed 0, the orchestrator's
memory image), recomputed on the CPU and held equal to the script's
constants.  ``test_torch_tier_cli_pins.py`` recomputes phase 14 (d)'s."""

import jax
import numpy as np

from shrewd_tpu import native as ref_native
from shrewd_tpu.models import mesi as RM
from shrewd_tpu.models import noc as RN
from shrewd_tpu.models import ruby as RR
from shrewd_tpu.utils import prng as ref_prng
from test_torch_trial import _chip_smoke
from test_torch_ruby import one_torch_thread  # noqa: F401


def _coherence(smoke, n_accesses):
    cfg = RM.MesiConfig()
    stream = RM.torture_stream(cfg, n_accesses, smoke.COHERENCE_MEM_WORDS,
                               seed=0)
    init = np.random.default_rng(0).integers(
        0, 1 << 32, smoke.COHERENCE_MEM_WORDS,
        dtype=np.uint64).astype(np.uint32)
    return cfg, stream, init


def test_tier_pins_for_chip_smoke():
    assert jax.config.jax_threefry_partitionable
    smoke = _chip_smoke()
    keys = ref_prng.trial_keys(ref_prng.campaign_key(0), smoke.N_PIN_CACHE)
    hier = RR.CacheHierarchy.build(ref_native.generate_trace(
        **smoke.FLAGSHIP))
    got = {lvl: {s: np.asarray(getattr(hier, lvl).run_keys(keys, s))
                 .tolist() for s in ("data", "tag", "state")}
           for lvl in ("l1", "l2")}
    assert got == smoke.PIN_CACHE
    cfg, stream, init = _coherence(smoke, smoke.COHERENCE_ACCESSES)
    mesi = RM.MesiKernel(stream, cfg, init)
    keys = ref_prng.trial_keys(ref_prng.campaign_key(0), smoke.N_PIN_MESI)
    got = {s: np.asarray(mesi.run_keys(keys, s)).tolist()
           for s in ("state", "tag", "dir", "tbe")}
    assert got == smoke.PIN_MESI
    noc = RN.NocKernel(RN.build_message_trace(stream, cfg, RN.NocConfig()),
                       RN.NocConfig())
    keys = ref_prng.trial_keys(ref_prng.campaign_key(0), smoke.N_PIN_NOC)
    assert np.asarray(noc.run_keys(keys)).tolist() == smoke.PIN_NOC
