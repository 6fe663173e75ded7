"""The reference's NetCDF reader: classic files through scipy, variables
as float64 with scale_factor/add_offset applied (the lookup tables the
benchmark writes are classic NetCDF)."""
from __future__ import annotations

import numpy as np


class NetcdfFile:
    """Read-only classic NetCDF file."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        self.path = path
        self._sp = netcdf_file(path, "r", mmap=False)

    def exists(self, name: str) -> bool:
        return name in self._sp.variables

    def read(self, name: str) -> np.ndarray:
        if name not in self._sp.variables:
            raise KeyError(f"variable '{name}' not in {self.path}")
        var = self._sp.variables[name]
        data = np.asarray(var[...]).copy()
        scale = getattr(var, "scale_factor", None)
        offset = getattr(var, "add_offset", None)
        if scale is not None or offset is not None:
            data = data * (1.0 if scale is None else scale) + (
                0.0 if offset is None else offset)
        return data.astype(np.float64) if data.dtype.kind == "f" else data

    def close(self):
        self._sp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
