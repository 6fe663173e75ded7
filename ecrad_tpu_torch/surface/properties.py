"""Surface properties: so far only whether an input file describes a
tiled surface.

Port of ecrad_tpu/surface/properties.py:200-206. The rest of the surface
scheme (properties, intermediate, flux), and with it the driver's
tiled-surface branch, comes with ROADMAP.md Queue A slice 8; the port's
driver refuses a tiled-surface input until then.
"""
from __future__ import annotations

from ..io.netcdf import NetcdfFile


def input_has_tiled_surface(path: str) -> bool:
    """True if the driver input file carries a complex surface description
    (driver/ecrad_driver_read_input.F90 detects it by the tile
    variables)."""
    with NetcdfFile(path) as f:
        return f.exists("tile_representation") and f.exists("tile_fraction")
