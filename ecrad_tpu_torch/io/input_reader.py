"""Read the offline driver's NetCDF input into the port's data types.

Port of ecrad_tpu/io/input_reader.py:21-205
(driver/ecrad_driver_read_input.F90): the variable-name fallbacks (`q`,
`h2o_mmr` or `h2o_vmr`; `<gas>_mmr`, `<gas>_vmr` or `<gas>`), volume
mixing ratios converted to mass, per-column `iseed` (1..ncol when
absent), the optional cloud fields, the driver namelist's overrides and
scalings, and the aerosol field read as stored (column, aerosol_type,
level) and transposed to (column, level, type). Input whose pressure
falls with the level index (height-increasing) is flipped here to TOA
first; `return_orientation` reports it so that the driver flips the
fluxes back.

As the JAX reader does, every field is built in float32 (and the
overrides and scalings applied there); the dataclasses come back in
`dtype` on `device`, the GPU unless the caller asks for another.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DriverConfig
from ..constants import GAS_INDEX, GAS_MOLAR_MASS, GAS_NAMES, \
    MOLAR_MASS_DRY_AIR, NUM_GASES
from ..interface import resolve_device
from ..types import Aerosol, Cloud, GasConcs, SingleLevel, Thermodynamics
from .netcdf import NetcdfFile


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


def read_input(path: str, driver_config: Optional[DriverConfig] = None,
               return_orientation: bool = False, device="cuda",
               dtype=torch.float32):
    """(SingleLevel, Thermodynamics, GasConcs, Cloud, Aerosol), with
    is_reversed as a sixth item if return_orientation."""
    device = resolve_device(device)
    dc = driver_config or DriverConfig()
    with NetcdfFile(path) as f:
        out, is_reversed = _read(f, dc)
    out = tuple(_to(x, device, dtype) for x in out)
    return out + (is_reversed,) if return_orientation else out


def _to(obj, device, dtype):
    """A dataclass with its float tensors in dtype on device."""
    return obj.replace(**{
        k: v.to(device=device, dtype=dtype if v.is_floating_point()
                else v.dtype)
        for k, v in vars(obj).items() if isinstance(v, torch.Tensor)})


def _read(f: NetcdfFile, dc: DriverConfig):
    pressure_hl = f.read("pressure_hl")
    temperature_hl = f.read("temperature_hl")
    ncol, nlevp1 = pressure_hl.shape
    nlev = nlevp1 - 1
    # height-increasing input: flipped to TOA first here
    # (radiation_interface.F90:283-290)
    is_reversed = bool(pressure_hl[0, 1] < pressure_hl[0, 0])

    def orient(arr):
        if not is_reversed or arr is None or np.ndim(arr) <= 1:
            return arr
        return np.flip(arr, axis=1)

    # ---- single level ----
    cos_sza, _ = f.read_any(["cos_solar_zenith_angle", "cos_sza"])
    skin_t = f.read("skin_temperature")
    if skin_t.ndim == 2:
        # tiled surface (ncol, nfacet): the first (ground) facet
        skin_t = skin_t[:, 0]

    def per_band(arr):
        """(ncol,) -> (ncol, 1); tiled (ncol, nfacet, nband) -> facet 0."""
        if arr is None or arr.ndim == 2:
            return arr
        return arr[:, None] if arr.ndim == 1 else arr[:, 0, :]

    sw_albedo = per_band(f.read("sw_albedo"))
    sw_albedo_direct = per_band(f.read_any(["sw_albedo_direct"])[0])
    lw_emissivity = per_band(f.read("lw_emissivity"))
    solar_irradiance = float(np.asarray(f.read("solar_irradiance",
                                               np.float64(1366.0))))
    if dc.solar_irradiance_override > 0.0:
        solar_irradiance = dc.solar_irradiance_override
    iseed, _ = f.read_any(["iseed"])
    if iseed is None:
        iseed = np.arange(1, ncol + 1)
    if dc.cos_sza_override >= 0.0:
        cos_sza = np.full(ncol, dc.cos_sza_override)
    if dc.skin_temperature_override >= 0.0:
        skin_t = np.full(ncol, dc.skin_temperature_override)
    if dc.sw_albedo_override >= 0.0:
        sw_albedo = np.full_like(sw_albedo, dc.sw_albedo_override)
        if sw_albedo_direct is not None:
            sw_albedo_direct = np.full_like(sw_albedo_direct,
                                            dc.sw_albedo_override)
    if dc.lw_emissivity_override >= 0.0:
        lw_emissivity = np.full_like(lw_emissivity,
                                     dc.lw_emissivity_override)
    single_level = SingleLevel(
        cos_sza=_f32(cos_sza), skin_temperature=_f32(skin_t),
        sw_albedo=_f32(sw_albedo),
        sw_albedo_direct=(None if sw_albedo_direct is None
                          else _f32(sw_albedo_direct)),
        lw_emissivity=_f32(lw_emissivity),
        solar_irradiance=solar_irradiance,
        iseed=torch.as_tensor(np.asarray(iseed), dtype=torch.int32))
    thermodynamics = Thermodynamics(pressure_hl=_f32(orient(pressure_hl)),
                                    temperature_hl=_f32(orient(
                                        temperature_hl)))

    # ---- gases ----
    mixing_ratio = torch.zeros((ncol, nlev, NUM_GASES))
    scalings = {
        "h2o": dc.h2o_scaling, "co2": dc.co2_scaling, "o3": dc.o3_scaling,
        "ch4": dc.ch4_scaling, "n2o": dc.n2o_scaling, "co": dc.co_scaling,
        "no2": dc.nox_scaling, "cfc11": dc.cfc11_scaling,
        "cfc12": dc.cfc12_scaling, "hcfc22": dc.hcfc22_scaling,
        "ccl4": dc.ccl4_scaling,
    }
    for name in GAS_NAMES:
        candidates = ([f"{name}_mmr", f"{name}_vmr", name] if name != "h2o"
                      else ["q", "h2o_mmr", "h2o_vmr"])
        data, found = f.read_any(candidates)
        if data is None:
            continue
        if np.ndim(data) == 2:
            data = orient(data)
        data = _f32(data)
        if found.endswith("_vmr"):
            data = data * (GAS_MOLAR_MASS[name] / MOLAR_MASS_DRY_AIR)
        i = GAS_INDEX[name]
        mixing_ratio[:, :, i] = data
        s = scalings.get(name, 1.0)
        if s != 1.0:
            mixing_ratio[:, :, i] = mixing_ratio[:, :, i] * s
    gas = GasConcs(mixing_ratio=mixing_ratio)

    # ---- cloud ----
    q_liq = orient(f.read_any(["q_liquid", "q_liq"],
                              np.zeros((ncol, nlev)))[0])
    q_ice = orient(f.read_any(["q_ice"], np.zeros((ncol, nlev)))[0])
    re_liq = orient(f.read_any(["re_liquid"],
                               np.full((ncol, nlev), 10e-6))[0])
    re_ice = orient(f.read_any(["re_ice"], np.full((ncol, nlev), 50e-6))[0])
    frac = orient(f.read_any(["cloud_fraction"], np.zeros((ncol, nlev)))[0])
    if dc.cloud_fraction_override >= 0.0:
        frac = np.where(np.asarray(frac) > 0.0, dc.cloud_fraction_override,
                        0.0)
    fsd = orient(f.read_any(["fractional_std"])[0])
    if dc.fractional_std > 0.0:
        fsd = np.full((ncol, nlev), dc.fractional_std)
    overlap = orient(f.read_any(["overlap_param"])[0])
    inv_eff = orient(f.read_any(["inv_cloud_effective_size"])[0])
    inv_inhom = orient(f.read_any(["inv_inhom_effective_size"])[0])
    opt = lambda x: None if x is None else _f32(x)           # noqa: E731
    cloud = Cloud(q_liq=_f32(q_liq) * dc.q_liquid_scaling,
                  q_ice=_f32(q_ice) * dc.q_ice_scaling,
                  re_liq=_f32(re_liq), re_ice=_f32(re_ice),
                  fraction=_f32(frac), fractional_std=opt(fsd),
                  overlap_param=opt(overlap),
                  inv_cloud_effective_size=opt(inv_eff),
                  inv_inhom_effective_size=opt(inv_inhom))
    op = cloud.overlap_param
    if dc.overlap_decorr_length > 0.0:
        cloud = cloud.set_overlap_param(thermodynamics,
                                        dc.overlap_decorr_length)
    elif op is not None and dc.overlap_decorr_length_scaling > 0.0:
        # alpha -> alpha^(1/scaling) (ecrad_driver_read_input.F90:213-221)
        cloud = cloud.replace(overlap_param=torch.where(
            op > 0.0, op ** (1.0 / dc.overlap_decorr_length_scaling), op))
    elif op is not None and dc.overlap_decorr_length_scaling == 0.0:
        cloud = cloud.replace(overlap_param=torch.zeros_like(op))

    # ---- aerosol: stored (column, type, level) ----
    aer_mmr, _ = f.read_any(["aerosol_mmr"])
    aerosol = Aerosol(mixing_ratio=(
        torch.zeros((ncol, nlev, 1)) if aer_mmr is None
        else _f32(orient(np.transpose(aer_mmr, (0, 2, 1))))))
    return (single_level, thermodynamics, gas, cloud, aerosol), is_reversed
