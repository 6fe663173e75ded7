"""Stochastic cloud generator for McICA.

Port of ecrad_tpu/solvers/cloud_generator.py:33-159
(radiation_cloud_generator.F90): for each g-point subcolumn pick a cloud
top by inverse CDF of the cumulative cloud cover, walk down with the
pair-cloud-cover Markov conditionals, and scale the cloud optical depth
by a draw from the water-content PDF with vertically correlated random
numbers (Exp-Ran and Max-Ran correlate within contiguous cloudy runs,
Exp-Exp over the whole trigger..base span).

The random numbers are the JAX package's own: ops/random_fields.py gives
the bits of its jax.random chain, so both programs draw the same
subcolumns (one CUDA kernel a generator call on the card, the int64
passes of utils/threefry.py on the CPU). From those uniforms the card
runs the cover, the walk and the sample in one more kernel a generator
call (ops/mcica_generator.py, scope `ecrad.cloud_generator.kernel`).
On the CPU they run as `cloud_generator_plain`, the kernel's plain
version: its two level scans (`_level_walk`) are Python loops over
levels of (ncol, ng) tensors, about 22 launches a level, 3,051 a
generator call at 137 levels, and the Exp-Exp cover about 4,000 more,
as many as its merge passes make, with a host sync before each pass;
the PDF sample 163 (2048 x 137 on an H100).

The plain stages run in their own scopes (utils/hooks.py):
`ecrad.cloud_generator.cover`, `.walk` and `.sample`; the random fields
in `.random` on either device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import Overlap
from ..ops import mcica_generator
from ..ops import random_fields as fields
from ..utils import hooks
from .cloud_cover import (cum_cloud_cover_exp_exp, cum_cloud_cover_exp_ran,
                          cum_cloud_cover_max_ran)
from .pdf_sampler import PdfSampler, sample_pdf, sample_pdf_fast


@hooks.hooked("ecrad.cloud_generator.random")
def random_fields(iseed, ng: int, nlev: int, dtype, seed_offset: int = 0):
    """The generator's uniforms per column (cloud_generator.py:73-85):
    rand_top (ncol, ng) and rand_cloud, u1, u2 (ncol, nlev, ng), from
    ops/random_fields.py (the kernel on the card, utils/threefry.py on
    the CPU)."""
    return fields.random_fields(iseed, ng, nlev, dtype, seed_offset)


@hooks.hooked("ecrad.cloud_generator.walk")
def _level_walk(frac, overlap_param, decorrelation_scaling, cum_cc, pcc,
                total_cloud_cover, rand_top, rand_cloud, u1, u2,
                exp_exp: bool):
    """Each subcolumn's cloud top (inverse CDF of the cumulative cover),
    the Markov walk down the levels and the vertically correlated
    inhomogeneity draws. Returns is_cloudy (ncol, nlev, ng) bool and
    rand_inhom (ncol, nlev, ng)."""
    ncol, nlev = frac.shape
    ng, dev = rand_top.shape[-1], frac.device
    overhang = cum_cc[:, 1:] - cum_cc[:, :-1]
    cloudy_lev = frac > 0.0
    ibegin = cloudy_lev.to(torch.uint8).argmax(1)            # (ncol,)
    iend = nlev - 1 - cloudy_lev.flip(1).to(torch.uint8).argmax(1)
    alpha_inhom = torch.where(
        overlap_param > 0.0,
        overlap_param ** (1.0 / decorrelation_scaling), overlap_param)

    # ---- cloud-top trigger per (col, g) ----
    levels = torch.arange(nlev, device=dev)
    trigger = rand_top * total_cloud_cover[:, None]         # (ncol, ng)
    in_range = ((levels[None, :] >= ibegin[:, None])
                & (levels[None, :] <= iend[:, None]))       # (ncol,nlev)
    hit = ((cum_cc[:, :, None] >= trigger[:, None, :])
           & in_range[:, :, None])
    itrigger = torch.where(hit.any(1), hit.to(torch.uint8).argmax(1),
                           iend[:, None])                   # (ncol, ng)

    # ---- masked Markov walk over levels ----
    pad = lambda x: torch.cat([torch.zeros_like(x[:, :1]), x], 1)
    frac_prev, cum_prev = pad(frac[:, :-1]), pad(cum_cc[:, :-1])
    pcc_prev, over_prev = pad(pcc), pad(overhang)
    cloudy = torch.zeros((ncol, ng), dtype=torch.bool, device=dev)
    is_cloudy = []
    for lev in range(nlev):
        u = rand_cloud[:, lev, :]
        fp = frac_prev[:, lev, None]
        cond_stay = u * fp < (frac[:, lev, None] + fp
                              - pcc_prev[:, lev, None])
        clear_denom = cum_prev[:, lev, None] - fp
        cond_birth = u * clear_denom < (pcc_prev[:, lev, None]
                                        - over_prev[:, lev, None] - fp)
        active = (lev > itrigger) & (lev <= iend[:, None])
        cloudy = (itrigger == lev) | (
            active & torch.where(cloudy, cond_stay, cond_birth))
        is_cloudy.append(cloudy)

    # ---- vertically correlated inhomogeneity ----
    alpha_prev = pad(alpha_inhom)
    r = u1[:, 0, :]
    rand_inhom = []
    for lev in range(nlev):
        keep = u2[:, lev, :] < alpha_prev[:, lev, None]
        if exp_exp:
            keep = keep & (lev > itrigger) & (lev <= iend[:, None])
        elif lev > 0:
            keep = keep & is_cloudy[lev] & is_cloudy[lev - 1]
        else:
            keep = torch.zeros_like(keep)
        r = torch.where(keep, r, u1[:, lev, :])
        rand_inhom.append(r)
    return torch.stack(is_cloudy, 1), torch.stack(rand_inhom, 1)


def cloud_generator(ng: int, iseed, overlap_scheme: Overlap,
                    frac_threshold: float, frac, overlap_param,
                    decorrelation_scaling: float, fractional_std,
                    pdf_sampler: PdfSampler, is_beta_overlap: bool = False,
                    seed_offset: int = 0, table=None) -> Tuple:
    """od_scaling (ncol, nlev, ng) and total_cloud_cover (ncol,).
    frac (ncol, nlev); overlap_param (ncol, nlev-1); iseed (ncol,)
    integer; `table` the sampler's pdf_table on frac's device. The plain
    stages for CPU tensors, the kernel for any other."""
    uniforms = random_fields(iseed, ng, frac.shape[1], frac.dtype,
                             seed_offset)
    if frac.device.type == "cpu":
        return cloud_generator_plain(
            overlap_scheme, frac_threshold, frac, overlap_param,
            decorrelation_scaling, fractional_std, pdf_sampler,
            is_beta_overlap, table, *uniforms)
    with hooks.hook("ecrad.cloud_generator.kernel"):
        return mcica_generator.generator_kernel(
            overlap_scheme, frac_threshold, frac.contiguous(),
            overlap_param.contiguous(), decorrelation_scaling,
            fractional_std.contiguous(), pdf_sampler, is_beta_overlap, table,
            *uniforms)


def cloud_generator_plain(overlap_scheme: Overlap, frac_threshold: float,
                          frac, overlap_param, decorrelation_scaling: float,
                          fractional_std, pdf_sampler: PdfSampler,
                          is_beta_overlap: bool, table, rand_top, rand_cloud,
                          u1, u2) -> Tuple:
    """od_scaling and total_cloud_cover from the generator's uniforms
    (rand_top (ncol, ng), rand_cloud, u1, u2 (ncol, nlev, ng)): the
    cover, the walk and the PDF sample as tensor passes; the plain
    version of ops/mcica_generator.generator_kernel, with its
    arguments."""
    ng = rand_top.shape[-1]
    dtype, dev = frac.dtype, frac.device
    with hooks.hook("ecrad.cloud_generator.cover"):
        if overlap_scheme == Overlap.EXPONENTIAL_RANDOM:
            cum_cc, pcc = cum_cloud_cover_exp_ran(frac, overlap_param,
                                                  is_beta_overlap)
        elif overlap_scheme == Overlap.MAXIMUM_RANDOM:
            cum_cc, pcc = cum_cloud_cover_max_ran(frac)
        else:
            cum_cc, pcc = cum_cloud_cover_exp_exp(frac, overlap_param,
                                                  is_beta_overlap)

    total_cloud_cover = cum_cc[:, -1]
    has_cloud = total_cloud_cover >= frac_threshold
    zero = torch.zeros((), dtype=dtype, device=dev)
    total_cloud_cover = torch.where(has_cloud, total_cloud_cover, zero)

    is_cloudy, rand_inhom = _level_walk(
        frac, overlap_param, decorrelation_scaling, cum_cc, pcc,
        total_cloud_cover, rand_top, rand_cloud, u1, u2,
        overlap_scheme == Overlap.EXPONENTIAL_EXPONENTIAL)

    # ---- PDF sample on cloudy cells ----
    with hooks.hook("ecrad.cloud_generator.sample"):
        if pdf_sampler.cheb is not None:
            scaling = sample_pdf_fast(pdf_sampler, fractional_std,
                                      rand_inhom, table)
        else:
            scaling = sample_pdf(pdf_sampler, fractional_std[:, :, None]
                                 * torch.ones((1, 1, ng), dtype=dtype,
                                              device=dev), rand_inhom, table)
        od_scaling = torch.where(is_cloudy & has_cloud[:, None, None],
                                 scaling, zero)
    return od_scaling, total_cloud_cover
