"""Loading driver inputs and outputs, and the fields derived from them.

Port of ecrad_tpu/analysis/io.py (practical/ecradplot/io.py: load_inputs
and load_ecRAD with the derived pressure_fl, net fluxes, cloud radiative
effect and heating rates, -(g/cp) dFnet/dp in K/day, io.py:73-78), numpy
only, on the port's own NetCDF reader: plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..io.netcdf import NetcdfFile

# 24*3600 * g / cp, as in practical/ecradplot/io.py:72
HEATING_RATE_FACTOR = 24.0 * 3600.0 * (9.81 / 1004.0)


def load_inputs(path: str) -> Dict[str, np.ndarray]:
    """Load a driver input file; adds pressure_fl and aerosol groupings
    (io.py:13-38)."""
    out: Dict[str, np.ndarray] = {}
    with NetcdfFile(path) as f:
        for name in f.variables():
            out[name] = f.read(name)
    if "pressure_hl" in out:
        p = out["pressure_hl"]
        out["pressure_fl"] = 0.5 * (p[:, :-1] + p[:, 1:])
    if "aerosol_mmr" in out and out["aerosol_mmr"].ndim == 3:
        mmr = out["aerosol_mmr"]  # (col, type, lev)
        out["sea_salt"] = mmr[:, 0:3].sum(axis=1)
        out["dust"] = mmr[:, 3:6].sum(axis=1)
        out["organics"] = mmr[:, 6:8].sum(axis=1)
        out["black_carbon"] = mmr[:, 8:10].sum(axis=1)
        if mmr.shape[1] > 10:
            out["sulphate"] = mmr[:, 10]
    return out


def load_fluxes(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with NetcdfFile(path) as f:
        for name in f.variables():
            out[name] = f.read(name)
    return out


def derive_fields(flux: Dict[str, np.ndarray],
                  inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Net fluxes, CRE and heating rates (io.py:64-82)."""
    ds = dict(flux)
    p_hl = inputs.get("pressure_hl", ds.get("pressure_hl"))
    if p_hl is None:
        raise ValueError("pressure_hl needed for derived fields")
    dp = np.diff(p_hl, axis=1)

    def hr(net):
        return -HEATING_RATE_FACTOR * np.diff(net, axis=1) / dp

    for band in ("lw", "sw"):
        up, dn = f"flux_up_{band}", f"flux_dn_{band}"
        if up in ds and dn in ds:
            ds[f"flux_net_{band}"] = ds[dn] - ds[up]
            ds[f"heating_rate_{band}"] = hr(ds[f"flux_net_{band}"])
        upc, dnc = f"flux_up_{band}_clear", f"flux_dn_{band}_clear"
        if upc in ds and dnc in ds:
            ds[f"flux_net_{band}_clear"] = ds[dnc] - ds[upc]
            ds[f"heating_rate_{band}_clear"] = hr(
                ds[f"flux_net_{band}_clear"])
        if all(k in ds for k in (up, dn, upc, dnc)):
            ds[f"cloud_radiative_effect_{band}"] = (
                (ds[dn] - ds[dnc]) - (ds[up] - ds[upc]))
    return ds
