"""The tiled surface and canopy scheme of the port (radsurf/): tile
descriptions, the effective boundary conditions they give the
atmosphere, and the partition of the surface fluxes onto the facets."""
from .flux import SurfaceFlux
from .intermediate import (SurfaceIntermediate, calc_boundary_conditions,
                           partition_fluxes)
from .properties import (ITileFlat, ITileUrban3D, ITileVegetation,
                         SurfaceDescription, print_surface_representation,
                         read_surface)

__all__ = [
    "ITileFlat", "ITileVegetation", "ITileUrban3D", "SurfaceDescription",
    "read_surface", "print_surface_representation", "SurfaceFlux",
    "SurfaceIntermediate", "calc_boundary_conditions", "partition_fluxes",
]
