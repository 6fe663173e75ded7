"""The McICA cloud generator's random fields in one CUDA kernel
(csrc/threefry.cu), beside their plain PyTorch version.

Replaces no TPU kernel: the JAX package draws with jax.random
(ecrad_tpu/solvers/cloud_generator.py:73-85): key =
fold_in(PRNGKey(seed_offset), iseed) per column, four subkeys by
split(key, 4), and uniforms of shape (ng,) and (nlev, ng), in jax's
threefry_partitionable mode. The plain version, utils/threefry.py, gives
those bits in int64 tensor passes (1,412 launches and two uploads of the
key a McICA radiation call at 2048 x 137 on an H100); the kernel hashes in
uint32 registers and writes each uniform once, the same bits in one
launch a generator call.

`random_fields` runs the plain version on CPU tensors and the kernel on
any other, which raises unless the seeds are a contiguous CUDA tensor of
int32 or int64 and the draws float32 or float64.
"""
from __future__ import annotations

import torch

from ..utils import hooks, threefry
from . import _cuda

#: launches of the kernel (incremented only where it is launched)
launches = 0
# values one block of the kernel owns (csrc/threefry.cu rng::SPAN); its
# flat indices are 32-bit, so a draw holds fewer than 2**31 - SPAN values
SPAN = 2048


def key_words(seed_offset: int):
    """jax.random.PRNGKey(seed_offset) as the kernel takes it: the two
    unsigned 32-bit words (seed_offset >> 32, seed_offset mod 2**32), the
    words of threefry.prng_key, with no upload to the device."""
    return (seed_offset >> 32) & threefry.MASK, seed_offset & threefry.MASK


def random_fields_plain(iseed, ng: int, nlev: int, dtype,
                        seed_offset: int = 0):
    """rand_top (ncol, ng) and rand_cloud, u1, u2 (ncol, nlev, ng) through
    utils/threefry.py (the last three are views of one tensor)."""
    key = threefry.fold_in(threefry.prng_key(seed_offset, iseed.device),
                           iseed)
    sub = threefry.split(key, 4)                       # (ncol, 4, 2)
    rand_top = threefry.uniform(sub[:, 0], (ng,), dtype)
    rest = threefry.uniform(sub[:, 1:], (nlev, ng), dtype)
    return rand_top, rest[:, 0], rest[:, 1], rest[:, 2]


def random_fields_kernel(iseed, ng: int, nlev: int, dtype,
                         seed_offset: int = 0):
    """The kernel; arguments and results as random_fields_plain, each
    result contiguous. iseed (ncol,) is read on the device, each seed
    taken mod 2**32 as fold_in does."""
    global launches
    if not iseed.is_cuda:
        raise ValueError(f"iseed: expected a CUDA tensor, got {iseed.device}")
    if iseed.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"iseed: the kernel takes int32 or int64, got "
                        f"{iseed.dtype}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel draws float32 or float64, not {dtype}")
    if iseed.dim() != 1 or not iseed.is_contiguous():
        raise ValueError("iseed: the kernel takes a contiguous (ncol,) "
                         "tensor")
    ncol = iseed.shape[0]
    if ncol * max(nlev, 1) * ng >= 2**31 - SPAN:
        raise ValueError(f"{ncol} x {nlev} x {ng} values a draw: the kernel "
                         f"indexes fewer than 2**31 - {SPAN}")
    dev = iseed.device
    top = torch.empty((ncol, ng), dtype=dtype, device=dev)
    rest = [torch.empty((ncol, nlev, ng), dtype=dtype, device=dev)
            for _ in range(3)]
    if ncol * ng == 0:
        return (top, *rest)
    _cuda.launch("threefry_fields", iseed, int(iseed.dtype == torch.int64),
                 *key_words(seed_offset), ncol, nlev, ng,
                 int(dtype == torch.float64), top, *rest)
    launches += 1
    hooks.count("threefry.kernel")
    if hooks.LHOOK:
        hooks.count(f"launch.threefry_fields.{_cuda.tag(dtype)}")
    return (top, *rest)


def random_fields(iseed, ng: int, nlev: int, dtype, seed_offset: int = 0):
    """The generator's uniforms: the plain version for CPU tensors, the
    kernel for any other."""
    if iseed.device.type == "cpu":
        return random_fields_plain(iseed, ng, nlev, dtype, seed_offset)
    return random_fields_kernel(iseed, ng, nlev, dtype, seed_offset)
