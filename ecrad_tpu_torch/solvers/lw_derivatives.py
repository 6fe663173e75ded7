"""LW flux derivatives for the Hogan & Bozzo (2015) approximate updates.

Port of ecrad_tpu/solvers/lw_derivatives.py:26-48, the ICA form
(radiation_lw_derivatives.F90:42, calc_lw_derivatives_ica) used by the
Cloudless and McICA solvers: the per-g surface upward flux, normalised,
propagated up through the layer transmittances. The region and matrix
forms come with Tripleclouds and SPARTACUS (ROADMAP.md Queue A).
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
