"""Surface tile description: flat, homogeneous-vegetation and urban-3D
tiles.

Port of ecrad_tpu/surface/properties.py (radsurf/radsurf_properties.F90:
tile codes :28-41, surface_type :48-122, facet indices :223-271, the
NetCDF reader :389-443). The tile representation is static Python
metadata (a tuple of tile codes) that selects each tile's branch; the
per-column fields are tensors with the columns leading and the spectral
axis innermost.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..interface import resolve_device
from ..io.netcdf import NetcdfFile
from ..types import _Replace

# Tile representation codes (radsurf_properties.F90:28-32), 1-based as
# the input files store them
ITileFlat = 1
ITileVegetation = 2
ITileUrban3D = 3

TILE_NAMES = {ITileFlat: "Flat",
              ITileVegetation: "HomogeneousVegetation",
              ITileUrban3D: "Urban3D"}
# facets and regions of each tile type (radsurf_properties.F90:40-41)
N_TILE_FACETS = {ITileFlat: 1, ITileVegetation: 1, ITileUrban3D: 3}
N_TILE_REGIONS = {ITileFlat: 0, ITileVegetation: 1, ITileUrban3D: 1}


def facet_region_indices(representation: Tuple[int, ...]):
    """(ground, roof, wall, region): dicts from tile index to its 0-based
    facet or region index, None where the tile has none
    (radsurf_properties.F90:249-269)."""
    ground, roof, wall, region = {}, {}, {}, {}
    ifacet = iregion = 0
    for jtile, rep in enumerate(representation):
        ground[jtile] = ifacet
        ifacet += 1
        roof[jtile] = wall[jtile] = region[jtile] = None
        if rep == ITileVegetation:
            region[jtile] = iregion
            iregion += 1
        elif rep == ITileUrban3D:
            roof[jtile] = ifacet
            wall[jtile] = ifacet + 1
            ifacet += 2
            region[jtile] = iregion
            iregion += 1
        elif rep != ITileFlat:
            raise ValueError(f"tile representation {rep} not understood")
    return ground, roof, wall, region


@dataclass
class SurfaceDescription(_Replace):
    """Physical description of the surface tiles
    (radsurf_properties.F90:48). skin_temperature (ncol, nfacet);
    sw_albedo, sw_albedo_direct (ncol, nfacet, nalbedobands);
    lw_emissivity (ncol, nfacet, nemissbands); the per-tile fields
    (ncol, ntile); vegetation_sw_albedo (ncol, ntile, nalbedobands),
    vegetation_lw_emissivity (ncol, ntile, nemissbands)."""
    skin_temperature: torch.Tensor
    sw_albedo: torch.Tensor
    lw_emissivity: torch.Tensor
    sw_albedo_direct: Optional[torch.Tensor] = None
    tile_fraction: Optional[torch.Tensor] = None
    canopy_depth: Optional[torch.Tensor] = None
    canopy_temperature: Optional[torch.Tensor] = None
    building_fraction: Optional[torch.Tensor] = None
    building_normalized_perimeter: Optional[torch.Tensor] = None
    vegetation_optical_depth: Optional[torch.Tensor] = None
    vegetation_fractional_std: Optional[torch.Tensor] = None
    vegetation_sw_albedo: Optional[torch.Tensor] = None
    vegetation_lw_emissivity: Optional[torch.Tensor] = None
    representation: Tuple[int, ...] = (ITileFlat,)

    @property
    def is_simple(self) -> bool:
        return self.representation == (ITileFlat,)

    @property
    def ntile(self) -> int:
        return len(self.representation)

    @property
    def nfacet(self) -> int:
        return sum(N_TILE_FACETS[r] for r in self.representation)

    @property
    def nregion(self) -> int:
        return sum(N_TILE_REGIONS[r] for r in self.representation)

    @property
    def ncol(self) -> int:
        return self.skin_temperature.shape[0]

    @property
    def nalbedobands(self) -> int:
        return self.sw_albedo.shape[2]

    @property
    def nemissbands(self) -> int:
        return self.lw_emissivity.shape[2]

    def indices(self):
        return facet_region_indices(self.representation)


def read_surface(path_or_file, device="cuda",
                 dtype=torch.float32) -> SurfaceDescription:
    """The tiled surface of a driver input file (a path or an open
    NetcdfFile), as ecrad_tpu/surface/properties.py:124-197 reads it: a
    2-D albedo or emissivity (column, facet) is one band, and without
    building_normalized_perimeter the perimeter comes from building_scale
    as 4 f (1 - f) / max(1e-8, scale) (radsurf_properties.F90:425-429).
    On the GPU unless `device` says otherwise."""
    device = resolve_device(device)
    close = isinstance(path_or_file, str)
    f = NetcdfFile(path_or_file) if close else path_or_file

    def as_t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    def one_band(x):
        return x[:, :, None] if x.ndim == 2 else x

    def opt2d(name):
        return as_t(np.atleast_2d(f.read(name))) if f.exists(name) else None

    def opt3d(name):
        return as_t(one_band(f.read(name))) if f.exists(name) else None

    try:
        rep = tuple(int(v) for v in np.atleast_1d(
            f.read("tile_representation")))
        bf = opt2d("building_fraction")
        if f.exists("building_normalized_perimeter"):
            perimeter = opt2d("building_normalized_perimeter")
        elif f.exists("building_scale") and bf is not None:
            scale = np.atleast_2d(f.read("building_scale"))
            bf_np = bf.cpu().numpy()
            perimeter = as_t(4.0 * bf_np * (1.0 - bf_np)
                             / np.maximum(1.0e-8, scale))
        else:
            perimeter = None
        return SurfaceDescription(
            skin_temperature=as_t(np.atleast_2d(f.read("skin_temperature"))),
            sw_albedo=as_t(one_band(f.read("sw_albedo"))),
            lw_emissivity=as_t(one_band(f.read("lw_emissivity"))),
            sw_albedo_direct=opt3d("sw_albedo_direct"),
            tile_fraction=opt2d("tile_fraction"),
            canopy_depth=opt2d("canopy_depth"),
            canopy_temperature=opt2d("canopy_temperature"),
            building_fraction=bf,
            building_normalized_perimeter=perimeter,
            vegetation_optical_depth=opt2d("vegetation_optical_depth"),
            vegetation_fractional_std=opt2d("vegetation_fractional_std"),
            vegetation_sw_albedo=opt3d("vegetation_sw_albedo"),
            vegetation_lw_emissivity=opt3d("vegetation_lw_emissivity"),
            representation=rep)
    finally:
        if close:
            f.close()


def input_has_tiled_surface(path: str) -> bool:
    """True if the driver input file carries a complex surface description
    (driver/ecrad_driver_read_input.F90 detects it by the tile
    variables)."""
    with NetcdfFile(path) as f:
        return f.exists("tile_representation") and f.exists("tile_fraction")


def print_surface_representation(representation: Tuple[int, ...]) -> str:
    """The tiles, facets and regions, one per line
    (radsurf_properties.F90:347-385)."""
    lines = ["Surface tile representation:"]
    if representation == (ITileFlat,):
        lines.append("  Simple (one flat tile)")
        return "\n".join(lines)
    ifacet, iregion = 1, 1
    for jtile, rep in enumerate(representation, start=1):
        lines.append(f"  Tile {jtile}: {TILE_NAMES[rep]}")
        lines.append(f"    Facet {ifacet}: ground")
        ifacet += 1
        if rep == ITileVegetation:
            lines.append(f"    Region {iregion}: vegetation canopy")
            iregion += 1
        elif rep == ITileUrban3D:
            lines.append(f"    Facet {ifacet}: roof")
            lines.append(f"    Facet {ifacet + 1}: wall")
            ifacet += 2
            lines.append(f"    Region {iregion}: street canyon")
            iregion += 1
    return "\n".join(lines)
