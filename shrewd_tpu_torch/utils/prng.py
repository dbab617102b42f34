"""Counter-based threefry PRNG, bit-exact with ``jax.random``.

Port of ``shrewd_tpu/utils/prng.py``.  A trial key fixes its fault, so the
port must draw the very bits the JAX package draws: this module re-implements
jax's threefry2x32 key derivation and samplers in torch, for jax's
``jax_threefry_partitionable=True`` layout (the default since jax 0.5).

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32 words
of ``jax.random.key_data`` (values in ``[0, 2**32)``); every function here is
batched over the leading dimensions, where the JAX package used ``vmap``.
Sources followed: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``).
"""

from __future__ import annotations

import torch

from shrewd_tpu_torch.utils.device import resolve as resolve_device

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry_2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function on broadcastable int64 tensors of
    uint32 values → the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for rnd in range(5):
        for r in _ROT[rnd % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(rnd + 1) % 3]) & M32
        x[1] = (x[1] + ks[(rnd + 2) % 3] + rnd + 1) & M32
    return x[0], x[1]


def threefry_seed(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` key data.  jax (32-bit mode) takes the seed
    as an int32, so the high word is 0 and the low word is its bits.  The
    key lies on ``device``: ``None`` is the CUDA card (raises without
    one), so keys derived from it are derived there."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit jax's int32 seed")
    return torch.tensor([0, seed & M32], dtype=torch.int64,
                        device=resolve_device(device))


def _hash(key: torch.Tensor, hi, lo) -> tuple[torch.Tensor, torch.Tensor]:
    return threefry_2x32(key[..., 0], key[..., 1], hi, lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair (0, data).
    ``data`` is an int or an integer tensor broadcast against the key's
    batch shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b1, b2 = _hash(key, torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` in its fold-like (partitionable) form:
    (..., 2) → (..., num, 2); new key i hashes the counter pair (0, i)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key[..., None, :], torch.zeros_like(idx), idx)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32-bit ``random_bits`` (partitionable): the element at flat index c
    of ``shape`` is the xor of the two threefry words of counter pair
    (c >> 32, c & M32).  Result shape: key batch shape + ``shape``."""
    count = 1
    for d in shape:
        count *= d
    c = torch.arange(count, dtype=torch.int64,
                     device=key.device).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    b1, b2 = _hash(k, c >> 32, c & M32)
    return b1 ^ b2


def randint(key: torch.Tensor, minval: int, maxval: int,
            shape: tuple = ()) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    two 32-bit draws combined by jax's modular multiply → int32 tensor."""
    imax = (1 << 31) - 1
    out_of_range = maxval > imax
    lo = max(min(minval, imax), -(1 << 31))
    hi = max(min(maxval, imax), -(1 << 31))
    span = (hi - lo) & M32
    if hi <= lo:
        span = 1
    if out_of_range and hi > lo:
        span = (span + 1) & M32
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    if span == 0:           # span 2**32 wrapped: the remainders are no-ops
        offset = (higher * 0 + lower) & M32
    else:
        mult = (1 << 16) % span
        # jax squares in uint32: for spans above 2**16 the square of 2**16
        # wraps to 0, so mult is below 2**16 and the product below 2**48
        mult = ((mult * mult) & M32) % span
        offset = ((higher % span) * mult) & M32
        offset = ((offset + lower % span) & M32) % span
    val = (lo + offset) & M32
    return (val - ((val >> 31) << 32)).to(torch.int32)


def uniform(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.uniform`` over [0, 1) in float32: 23 random mantissa
    bits under exponent 0 give a float in [1, 2), minus 1.  (jax's scale
    and shift by the range is exact for [0, 1); other ranges are not
    offered, because XLA may fuse that scale and shift into one FMA.)"""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: tuple = ()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key) < p`` in float32 → bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


# --- campaign key derivation (shrewd_tpu/utils/prng.py:21-55) -------------

def campaign_key(seed: int, device=None) -> torch.Tensor:
    """Root key for a campaign, on ``device`` (``None``: the CUDA card)."""
    return threefry_seed(seed, device)


def simpoint_key(root: torch.Tensor, simpoint_id: int) -> torch.Tensor:
    return fold_in(root, simpoint_id)


def structure_key(sp_key: torch.Tensor, structure_id: int) -> torch.Tensor:
    return fold_in(sp_key, structure_id)


def batch_key(st_key: torch.Tensor, batch_id: int) -> torch.Tensor:
    return fold_in(st_key, batch_id)


def trial_keys(bk: torch.Tensor, n_trials: int) -> torch.Tensor:
    """Per-trial keys, shape ``(n_trials, 2)``: ``fold_in(bk, t)``, so
    ``trial_keys(bk, n)[t]`` equals the fully addressed ``trial_key``."""
    return fold_in(bk, torch.arange(n_trials, dtype=torch.int64,
                                    device=bk.device))


def trial_key(seed: int, simpoint_id: int, structure_id: int,
              batch_id: int, trial_id: int, device=None) -> torch.Tensor:
    """Fully-addressed single-trial key (the reproducibility contract)."""
    k = campaign_key(seed, device)
    for coord in (simpoint_id, structure_id, batch_id, trial_id):
        k = fold_in(k, coord)
    return k
