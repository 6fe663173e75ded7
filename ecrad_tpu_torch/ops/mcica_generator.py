"""McICA's cloud generator in one CUDA kernel a generator call
(csrc/mcica_generator.cu): the cloud cover, each subcolumn's walk down
the levels and its draw from the cloud water PDF.

Replaces no TPU kernel: the JAX package's generator is lax.scan and
while_loop under vmap. Its plain version is
solvers/cloud_generator.cloud_generator_plain, which takes the same
arguments: tensor passes with level loops issued from Python (about
7,200 launches a generator call at 2048 x 137 on an H100, with a host
sync before each pass of the Exp-Exp merge loop). The kernel gives the
same od_scaling and total cover, the cover up to the order of its
cumulative sums (a few ulps).

`generator_kernel` raises unless the cloud fields and the uniforms are
contiguous CUDA tensors of one dtype, float32 or float64, of the shapes
it documents; solvers/cloud_generator.cloud_generator calls it for any
tensors that are not on the CPU.
"""
from __future__ import annotations

import torch

from ..solvers.pdf_sampler import CHEB_DEGREE
from . import _cuda

#: launches of the kernel (incremented only where it is launched)
launches = 0


def generator_kernel(overlap_scheme, frac_threshold: float, frac,
                     overlap_param, decorrelation_scaling: float,
                     fractional_std, pdf_sampler, is_beta_overlap: bool,
                     table, rand_top, rand_cloud, u1, u2):
    """od_scaling (ncol, nlev, ng) and total_cloud_cover (ncol,) from
    frac, fractional_std (ncol, nlev), overlap_param (ncol, nlev-1) and
    the generator's uniforms rand_top (ncol, ng) and rand_cloud, u1, u2
    (ncol, nlev, ng). `table` is the sampler's pdf_table on the device:
    its Chebyshev table where it has one, else its `val` in frac's
    dtype; the sample form follows the plain version."""
    global launches
    dtype = frac.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"frac: the kernel takes float32 or float64, got "
                        f"{dtype}")
    ncol, nlev = frac.shape
    ng = rand_top.shape[-1]
    if nlev < 1 or ng < 1:
        raise ValueError(f"the kernel takes nlev >= 1 and ng >= 1, got "
                         f"{nlev} and {ng}")
    operands = (("frac", frac, (ncol, nlev)),
                ("overlap_param", overlap_param, (ncol, nlev - 1)),
                ("fractional_std", fractional_std, (ncol, nlev)),
                ("rand_top", rand_top, (ncol, ng)),
                ("rand_cloud", rand_cloud, (ncol, nlev, ng)),
                ("u1", u1, (ncol, nlev, ng)), ("u2", u2, (ncol, nlev, ng)))
    # type, shape and layout first, so that each refusal shows on the CPU
    for name, t, shape in operands:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    for name, t, _ in operands:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")
    dev = frac.device
    nfsd, ncdf = pdf_sampler.nfsd, pdf_sampler.ncdf
    cheb = val = None
    if pdf_sampler.cheb is not None:
        cheb = table
        _cuda.check(cheb, torch.float32, (nfsd, CHEB_DEGREE + 1), "cheb")
    else:
        val = table
        _cuda.check(val, dtype, (ncdf, nfsd), "val")
    od_scaling = torch.empty((ncol, nlev, ng), dtype=dtype, device=dev)
    total = torch.empty((ncol,), dtype=dtype, device=dev)
    _cuda.launch("mcica_generator", frac, overlap_param, fractional_std,
                 rand_top, rand_cloud, u1, u2, cheb, val, ncol, nlev, ng,
                 int(overlap_scheme), int(is_beta_overlap), nfsd, ncdf,
                 frac_threshold, 1.0 / decorrelation_scaling,
                 pdf_sampler.fsd1, pdf_sampler.inv_fsd_interval,
                 pdf_sampler.z0 + pdf_sampler.z1,
                 pdf_sampler.z1 - pdf_sampler.z0, od_scaling, total,
                 dtype=dtype)
    launches += 1
    return od_scaling, total
