"""Read-only NetCDF access without the netCDF4 package (numpy only).

The lookup of ecrad_tpu/io/netcdf.py:24-120 (utilities/easy_netcdf.F90):
classic NetCDF (CDF-1/2) files through scipy.io.netcdf_file, NetCDF4/HDF5
files through h5py (imported only when such a file is opened), variable
names matched case-insensitively, arrays returned in C order as stored,
floating variables as float64 with scale_factor/add_offset applied.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


class NetcdfFile:
    """Read-only NetCDF file with case-insensitive variable lookup."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._h5 = self._sp = None
        with open(path, "rb") as f:
            is_hdf5 = f.read(8) == _HDF5_MAGIC
        if is_hdf5:
            import h5py
            self._h5 = h5py.File(path, "r")
        else:
            from scipy.io import netcdf_file
            self._sp = netcdf_file(path, "r", mmap=False)

    def variables(self) -> List[str]:
        if self._h5 is not None:
            return list(self._h5.keys())
        return list(self._sp.variables.keys())

    def _resolve(self, name: str) -> Optional[str]:
        names = self.variables()
        if name in names:
            return name
        return next((n for n in names if n.lower() == name.lower()), None)

    def exists(self, name: str) -> bool:
        return self._resolve(name) is not None

    def read(self, name: str) -> np.ndarray:
        """A variable as a float64 array (integer variables stay int)."""
        resolved = self._resolve(name)
        if resolved is None:
            raise KeyError(f"variable '{name}' not in {self.path}")
        if self._h5 is not None:
            data = np.asarray(self._h5[resolved])
        else:
            var = self._sp.variables[resolved]
            data = np.asarray(var[...]).copy()
            scale = getattr(var, "scale_factor", None)
            offset = getattr(var, "add_offset", None)
            if scale is not None or offset is not None:
                data = data * (1.0 if scale is None else scale) + (
                    0.0 if offset is None else offset)
        if data.dtype.kind == "f":
            data = data.astype(np.float64)
        return data

    def close(self):
        for f in (self._h5, self._sp):
            if f is not None:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
