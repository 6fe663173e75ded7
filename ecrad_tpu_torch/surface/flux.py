"""Surface fluxes at the tile facets.

Port of ecrad_tpu/surface/flux.py (radsurf/radsurf_flux.F90,
surface_flux_type :27-49).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..types import _Replace


@dataclass
class SurfaceFlux(_Replace):
    """Broadband fluxes into each facet of the surface (W m-2): facet
    fields (ncol, nfacet), canopy absorption (ncol, ntile)."""
    lw_dn_facet: Optional[torch.Tensor] = None
    lw_up_facet: Optional[torch.Tensor] = None
    lw_abs_canopy: Optional[torch.Tensor] = None
    sw_dn_facet: Optional[torch.Tensor] = None
    sw_dn_direct_facet: Optional[torch.Tensor] = None
    sw_up_facet: Optional[torch.Tensor] = None
    sw_abs_canopy: Optional[torch.Tensor] = None

    def fields(self):
        """(name, tensor) for every field that is set."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]
