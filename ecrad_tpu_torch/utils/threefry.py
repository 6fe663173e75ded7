"""The part of jax.random that the McICA cloud generator uses, bit for bit.

ecrad_tpu/solvers/cloud_generator.py:73-85 draws its random numbers with
jax.random: key = fold_in(PRNGKey(seed_offset), iseed) per column, four
subkeys by split(key, 4), and uniform floats of shape (ng,) and
(nlev, ng). This module reproduces those bits in PyTorch, for jax's
`jax_threefry_partitionable=True` mode (jax/_src/prng.py: threefry_2x32,
_threefry_split_foldlike, threefry_fold_in,
_threefry_random_bits_partitionable; jax/_src/random.py: _uniform), so
the port's McICA subcolumns are the JAX package's own.

uint32 arithmetic runs in int64 with `& 0xFFFFFFFF` after each add and
shift (PyTorch's uint32 support is partial). A float32 uniform takes
the 23 high bits of bits1 ^ bits2, a float64 one the 52 high bits of the
64-bit word (bits1 << 32) | bits2, each as the mantissa of a number in
[1, 2) minus 1.
"""
from __future__ import annotations

import torch

from . import hooks

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k0, k1); all int64 tensors holding uint32 values,
    broadcast against each other. Returns the pair of hashed words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32: (2,) int64."""
    return hooks.sync("upload.threefry", torch.tensor,
                      [(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                      device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """jax.random.fold_in for a batch: key (..., 2), data (...) integer
    (taken mod 2**32). Returns keys (..., 2)."""
    d = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], -1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """jax.random.split(key, num), batched: (..., 2) -> (..., num, 2)."""
    n = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(n), n)
    return torch.stack([y0, y1], -1)


def uniform(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype) in [0, 1), batched over the
    leading axes of key (..., 2): returns (..., *shape)."""
    numel = 1
    for s in shape:
        numel *= s
    n = torch.arange(numel, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(n), n)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        out = bits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        out = bits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform takes float32 or float64, not {dtype}")
    return out.reshape(*lead, *shape)
