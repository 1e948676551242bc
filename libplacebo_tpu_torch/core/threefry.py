"""JAX's default PRNG (threefry2x32) on the host, in numpy.

The reference package draws deband's random tables with `jax.random`
(ops/deband.py::deband_rng_tables).  A torch.Generator gives other
numbers, so the port carries a bit-exact copy of the draws it makes:
`PRNGKey`, `split`, `randint` and `uniform` (float32) as JAX 0.9.0
computes them with `jax_threefry_partitionable=True`, its default — the
key's two words hash a 64-bit iota over the output's flat index
(jax/_src/prng.py: threefry_2x32, _threefry_split_foldlike,
_threefry_random_bits_partitionable; jax/_src/random.py: _randint,
_uniform).  All arithmetic is uint32 and wraps, as on the device.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["threefry2x32", "PRNGKey", "split", "random_bits", "randint",
           "uniform"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection after every 4."""
    k = np.array([k1, k2], _U32)
    ks = [k[0:1], k[1:2], k[0:1] ^ k[1:2] ^ np.array([0x1BD11BDA], _U32)]
    x0 = np.asarray(x1, _U32) + ks[0]
    x1 = np.asarray(x2, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.array([i + 1], _U32)
    return x0, x1


def _iota_2x32(shape):
    """(high, low) 32-bit words of a uint64 iota over `shape`."""
    n = math.prod(shape)
    c = np.arange(n, dtype=np.uint64)
    return ((c >> np.uint64(32)).astype(_U32).reshape(shape),
            c.astype(_U32).reshape(shape))


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the key (0, seed)."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2^31)")
    return np.array([0, int(seed)], _U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) keys."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits for every element of `shape`."""
    hi, lo = _iota_2x32(tuple(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) as int32: two draws
    of 32 bits folded by the span's modulus."""
    k1, k2 = split(key)
    span = _U32(maxval - minval if maxval > minval else 1)
    mult = (_U32(2 ** 16) % span) * (_U32(2 ** 16) % span) % span
    lower = random_bits(k2, shape) % span
    if mult:
        lower = ((random_bits(k1, shape) % span) * mult + lower) % span
    return (np.int64(minval) + lower.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.uniform(key, shape, float32) in [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)
