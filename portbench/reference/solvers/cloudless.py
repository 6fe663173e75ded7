"""The flux containers and layout helpers of the solvers, copied from
ecrad_tpu_torch/solvers/cloudless.py. Fluxes are g-first, (nlev+1, ng,
ncol).
"""
from __future__ import annotations

from typing import NamedTuple

import torch



class LwFluxes(NamedTuple):
    up: torch.Tensor          # (nlev+1, ng, ncol)
    dn: torch.Tensor


class SwFluxes(NamedTuple):
    up: torch.Tensor          # (nlev+1, ng, ncol)
    dn_diffuse: torch.Tensor
    dn_direct: torch.Tensor


def _gf(x):
    """(ncol, nlev, ng) -> contiguous (nlev, ng, ncol)."""
    return x.permute(1, 2, 0).contiguous()


def daylight(cos_sza, fluxes: SwFluxes) -> SwFluxes:
    """Zero the columns with the sun below the horizon."""
    day = (cos_sza > 0.0)[None, None, :]
    zero = torch.zeros((), dtype=fluxes.up.dtype, device=fluxes.up.device)
    return SwFluxes(*(torch.where(day, f, zero) for f in fluxes))
