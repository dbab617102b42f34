"""The port's threefry PRNG against jax.random, bit for bit.

A trial key fixes its fault, so the port must derive the same key data
and draw the same bits as the JAX package (jax's partitionable threefry
layout).  Tolerance: exact equality everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrewd_tpu import native as ref_native
from shrewd_tpu.models.o3 import FaultSampler as RefSampler
from shrewd_tpu.models.o3 import O3Config as RefConfig
from shrewd_tpu.utils import prng as ref_prng
from shrewd_tpu_torch import compat
from shrewd_tpu_torch.models.o3 import FaultSampler, O3Config
from shrewd_tpu_torch.utils import prng


def _kd(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def test_partitionable_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 12345, -1, 2**31 - 1, -2**31])
def test_campaign_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.campaign_key(seed, "cpu").numpy(),
                                  _kd(ref_prng.campaign_key(seed)))


def test_fold_in_split_and_trial_keys_match_jax():
    rk, pk = ref_prng.campaign_key(0), prng.campaign_key(0, "cpu")
    np.testing.assert_array_equal(prng.fold_in(pk, 7).numpy(),
                                  _kd(jax.random.fold_in(rk, 7)))
    np.testing.assert_array_equal(prng.split(pk, 5).numpy(),
                                  _kd(jax.random.split(rk, 5)))
    rb = ref_prng.batch_key(ref_prng.structure_key(
        ref_prng.simpoint_key(rk, 3), 1), 2)
    pb = prng.batch_key(prng.structure_key(prng.simpoint_key(pk, 3), 1), 2)
    np.testing.assert_array_equal(pb.numpy(), _kd(rb))
    keys = prng.trial_keys(pb, 4096)
    np.testing.assert_array_equal(keys.numpy(),
                                  _kd(ref_prng.trial_keys(rb, 4096)))
    np.testing.assert_array_equal(
        prng.trial_key(0, 3, 1, 2, 77, "cpu").numpy(), keys[77].numpy())
    # batched split: one (5, 2) block per key
    np.testing.assert_array_equal(prng.split(keys[:3], 5)[2].numpy(),
                                  _kd(jax.random.split(
                                      ref_prng.trial_keys(rb, 3)[2], 5)))


def test_trial_keys_of_the_flagship_campaign():
    keys = prng.trial_keys(prng.campaign_key(0, "cpu"), 2)
    assert keys.tolist() == [[1797259609, 2579123966],
                             [928981903, 3453687069]]


@pytest.mark.parametrize("lo,hi", [(0, 32), (0, 256), (0, 300), (0, 4096),
                                   (0, 1000), (-5, 300), (0, 2**31 - 1),
                                   (0, 1)])
def test_randint_matches_jax(lo, hi):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(9), 4096)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), lo, hi, dtype=jnp.int32))(rkeys))
    got = prng.randint(
        compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu"), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_with_a_shape_matches_jax():
    rk = ref_prng.campaign_key(4)
    want = np.asarray(jax.random.randint(rk, (3, 5), 0, 300,
                                         dtype=jnp.int32))
    np.testing.assert_array_equal(
        prng.randint(prng.campaign_key(4, "cpu"), 0, 300, (3, 5)).numpy(),
        want)


def test_uniform_matches_jax():
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(5), 4096)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), dtype=jnp.float32))(rkeys))
    got = prng.uniform(
        compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("n", [256, 300])
def test_regfile_sampler_matches_reference(n):
    t = ref_native.generate_trace(seed=2, n=n, nphys=64, mem_words=256,
                                  working_set_words=64)
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(1), 1024)
    want = RefSampler(t, "regfile", RefConfig()).sample_batch(rkeys)
    got = FaultSampler(compat.trace_from_arrays(*t), "regfile",
                       O3Config()).sample_batch(
        compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu"))
    for name in ("kind", "cycle", "entry", "bit"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(
        got.shadow_u.numpy().view(np.uint32),
        np.asarray(want.shadow_u).view(np.uint32))


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_bernoulli_matches_jax(p):
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(6), 4096)
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p))(rkeys))
    got = prng.bernoulli(
        compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu"), p)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_other_structures_wait_for_a_later_slice():
    """The other O3 structures, once a later slice of the port: their
    samplers draw what the reference's draw; latch faults come from the
    Minor sampler, and an unknown structure is refused."""
    t = ref_native.generate_trace(seed=2, n=64, nphys=64, mem_words=256,
                                  working_set_words=64)
    mine = compat.trace_from_arrays(*t)
    rkeys = ref_prng.trial_keys(ref_prng.campaign_key(1), 256)
    keys = compat.keys_from_key_data(jax.random.key_data(rkeys), "cpu")
    for structure in ("fu", "rob", "iq", "lsq"):
        want = RefSampler(t, structure, RefConfig()).sample_batch(rkeys)
        got = FaultSampler(mine, structure, O3Config()).sample_batch(keys)
        for name in ("kind", "cycle", "entry", "bit"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="MinorFaultSampler"):
        FaultSampler(mine, "latch", O3Config())
    with pytest.raises(KeyError):
        FaultSampler(mine, "l2", O3Config())
