"""NetCDF reading and writing without the netCDF4 package (numpy only).

Port of ecrad_tpu/io/netcdf.py (utilities/easy_netcdf.F90): classic
NetCDF (CDF-1/2) files through scipy.io.netcdf_file, NetCDF4/HDF5 files
through h5py (imported only when such a file is opened or written),
variable names matched case-insensitively, arrays returned in C order as
stored, floating variables as float64 with scale_factor/add_offset
applied. `write_netcdf` writes classic NetCDF, or HDF5 with hdf5=True.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

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

    def dimensions(self) -> Dict[str, int]:
        """Dimension lengths (-1 for an unlimited one); for HDF5, one
        entry "<variable>_<axis>" per variable axis."""
        if self._h5 is not None:
            return {f"{k}_{i}": n for k, v in self._h5.items()
                    if hasattr(v, "shape") for i, n in enumerate(v.shape)}
        return {k: (-1 if v is None else v)
                for k, v in self._sp.dimensions.items()}

    def dim(self, name: str) -> int:
        """A classic file's dimension length (an unlimited one from a
        variable that uses it)."""
        if self._sp is None:
            raise KeyError(name)
        d = self._sp.dimensions.get(name)
        if d is None:
            for v in self._sp.variables.values():
                if name in v.dimensions:
                    return v.shape[list(v.dimensions).index(name)]
        return d

    def read(self, name: str, default=None) -> np.ndarray:
        """A variable as a float64 array (integer variables stay int);
        `default` where it is absent, if given."""
        resolved = self._resolve(name)
        if resolved is None:
            if default is not None:
                return default
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

    def read_any(self, names: Sequence[str], default=None
                 ) -> Tuple[Optional[np.ndarray], Optional[str]]:
        """The first of `names` that exists: (data, its name), else
        (default, None)."""
        for n in names:
            if self.exists(n):
                return self.read(n), n
        return default, None

    def attr(self, varname: str, attrname: str, default=None):
        resolved = self._resolve(varname)
        if resolved is None:
            return default
        if self._h5 is not None:
            val = self._h5[resolved].attrs.get(attrname, default)
        else:
            val = getattr(self._sp.variables[resolved], attrname, default)
        return val.decode() if isinstance(val, bytes) else val

    def global_attr(self, attrname: str, default=None):
        if self._h5 is not None:
            return self._h5.attrs.get(attrname, default)
        val = getattr(self._sp, attrname, default)
        return val.decode() if isinstance(val, bytes) else val

    def close(self):
        for f in (self._h5, self._sp):
            if f is not None:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_netcdf(path: str, dims: Dict[str, int],
                 variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]],
                 attrs: Optional[Dict[str, Dict[str, str]]] = None,
                 global_attrs: Optional[Dict[str, str]] = None,
                 hdf5: bool = False, deflate_level: int = 2,
                 shuffle: bool = True,
                 double_precision: bool = False) -> None:
    """Write classic NetCDF3 (64-bit offset) through scipy, or with
    hdf5=True NetCDF4-compatible HDF5 with deflate compression through
    h5py (ecrad_tpu/io/netcdf.py:144-231; easy_netcdf.F90
    create_netcdf_file). variables: name -> (dim names, array); attrs:
    name -> {attribute: value}. float64 arrays are written as float32
    unless double_precision."""
    if hdf5:
        return _write_hdf5(path, dims, variables, attrs, global_attrs,
                           deflate_level, shuffle, double_precision)
    from scipy.io import netcdf_file
    attrs = attrs or {}
    with netcdf_file(path, "w", version=2) as f:
        for dname, dlen in dims.items():
            f.createDimension(dname, dlen)
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            if data.dtype == np.float64 and not double_precision:
                data = data.astype(np.float32)
            typecode = {np.dtype(np.float32): "f",
                        np.dtype(np.float64): "d",
                        np.dtype(np.int32): "i",
                        np.dtype(np.int64): "i"}.get(data.dtype, "f")
            if data.dtype == np.int64:
                data = data.astype(np.int32)
            var = f.createVariable(vname, typecode, vdims)
            var[...] = data
            for aname, aval in attrs.get(vname, {}).items():
                setattr(var, aname, aval)
        for aname, aval in (global_attrs or {}).items():
            setattr(f, aname, aval)


def _write_hdf5(path, dims, variables, attrs, global_attrs, deflate_level,
                shuffle, double_precision):
    """NetCDF4-compatible HDF5 (h5py): a dimension-scale dataset per
    dimension attached to every variable axis, gzip deflate and byte
    shuffle."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("do_write_hdf5 needs the h5py package, which is "
                          "not installed; write classic NetCDF instead "
                          "(do_write_hdf5 = false)") from e
    attrs = attrs or {}
    comp = dict(compression="gzip",
                compression_opts=int(max(0, min(9, deflate_level))),
                shuffle=bool(shuffle)) if deflate_level > 0 else {}
    with h5py.File(path, "w") as f:
        scales = {}
        for i, (dname, dlen) in enumerate(dims.items()):
            # the phony dimension-scale dataset netCDF4 writes for a
            # dimension without a coordinate variable
            if dname in variables:
                continue
            d = f.create_dataset(dname, shape=(dlen,), dtype="f4")
            d.make_scale(dname)
            d.attrs["_Netcdf4Dimid"] = np.int32(i)
            scales[dname] = d
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            if data.dtype.kind == "f":
                data = data.astype(np.float64 if double_precision
                                   else np.float32)
            elif data.dtype == np.int64:
                data = data.astype(np.int32)
            v = f.create_dataset(vname, data=data,
                                 **(dict(comp) if data.ndim > 0 else {}))
            if vname in dims:                # a coordinate variable
                v.make_scale(vname)
                scales[vname] = v
            for aname, aval in attrs.get(vname, {}).items():
                v.attrs[aname] = aval
        for vname, (vdims, _) in variables.items():
            if vname in scales:
                continue
            for ax, dname in enumerate(vdims):
                if dname in scales:
                    f[vname].dims[ax].attach_scale(scales[dname])
        for aname, aval in (global_attrs or {}).items():
            f.attrs[aname] = aval
