"""LW flux derivatives for the Hogan & Bozzo (2015) approximate updates.

Port of ecrad_tpu/solvers/lw_derivatives.py:26-84: the ICA form
(radiation_lw_derivatives.F90:42, calc_lw_derivatives_ica) of the
Cloudless, Homogeneous and McICA solvers, the per-g surface upward flux,
normalised, propagated up through the layer transmittances; and the
region form (:199, calc_lw_derivatives_region) of Tripleclouds, which
mixes the regions through the upward overlap matrix U at each interface
before each layer's per-region transmittance. Copied from
ecrad_tpu_torch/solvers/lw_derivatives.py.
"""
from __future__ import annotations

import torch


def lw_derivatives_ica(transmittance, flux_up_surf):
    """transmittance g-first (nlev, ng, ncol), TOA first; flux_up_surf
    (ncol, ng). Returns (ncol, nlev+1), 1 at the surface."""
    norm = flux_up_surf / torch.clamp(flux_up_surf.sum(-1, keepdim=True),
                                      min=1e-30)
    # P(l) = prod_{j >= l} trans(j)
    pprod = torch.cumprod(transmittance.flip(0), 0).flip(0)
    deriv = (norm.T[None] * pprod).sum(1).T
    return torch.cat([deriv, torch.ones_like(deriv[:, :1])], 1)


def lw_derivatives_region(trans, um, flux_up_surf):
    """trans (nlev, nreg, ng, ncol) per-region diffuse transmittance, TOA
    first; um (nlev+1, nreg, nreg, ncol) upward overlap matrices (the
    interface i above layer i); flux_up_surf (ncol, ng), summed over the
    regions. Returns (ncol, nlev+1), 1 at the surface."""
    nlev = trans.shape[0]
    norm = (flux_up_surf / torch.clamp(flux_up_surf.sum(-1, keepdim=True),
                                       min=1e-30)).T
    # the surface as one clear layer: region 0 only
    v = torch.zeros_like(trans[0])                       # (nreg, ng, ncol)
    v[0] = norm
    deriv = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        v = trans[l] * (um[l + 1][:, :, None, :] * v[None]).sum(1)
        deriv[l] = v.sum((0, 1))
    return torch.stack(deriv + [torch.ones_like(deriv[0])], 1)
