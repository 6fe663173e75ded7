"""Write fluxes, inputs and per-g radiative properties to NetCDF.

Port of ecrad_tpu/io/output.py (radiation/radiation_save.F90:
save_fluxes :34-304, save_inputs :719, save_radiative_properties :411;
radsurf/radsurf_save.F90 for save_surface_fluxes): the same variable
names, units and layouts, so downstream tools read either package's
files. `save_fluxes` writes every field of the Flux that is set (a field
that is None is skipped), the canopy-top fluxes and the band or g-point
profiles of do_save_spectral_flux included; `save_surface_fluxes` the
facet and canopy fluxes of a tiled surface. `save_inputs` writes
aerosol_mmr as (column, level, aerosol_type), as the JAX package does,
while the reader takes (column, aerosol_type, level): the round trip
with aerosols is broken in both packages (ROADMAP.md Queue C).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import GAS_NAMES
from ..types import Flux, Thermodynamics
from .netcdf import write_netcdf


def _numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class _Vars:
    """Variables of one file: dimensions taken from the arrays' shapes,
    every array written as float32."""

    def __init__(self):
        self.dims, self.variables, self.attrs = {}, {}, {}

    def add(self, name, dims, data, units=None, long_name=None):
        if data is None:
            return
        data = _numpy(data)
        for dname, dlen in zip(dims, data.shape):
            self.dims.setdefault(dname, dlen)
        self.variables[name] = (dims, data.astype(np.float32))
        if units is not None:
            self.attrs[name] = {"units": units, "long_name": long_name}


def save_fluxes(path: str, flux: Flux,
                thermodynamics: Optional[Thermodynamics] = None,
                **nc_kwargs) -> None:
    """nc_kwargs go to write_netcdf (hdf5=, deflate_level=,
    double_precision=: the driver's do_write_hdf5 and
    do_write_double_precision)."""
    v = _Vars()
    if thermodynamics is not None:
        v.add("pressure_hl", ("column", "half_level"),
              thermodynamics.pressure_hl, "Pa", "Pressure on half-levels")
    cl = ("column", "half_level")
    for name, field, units, long_name in (
            ("flux_up_lw", flux.lw_up, "W m-2", "Upwelling longwave flux"),
            ("flux_dn_lw", flux.lw_dn, "W m-2",
             "Downwelling longwave flux"),
            ("flux_up_sw", flux.sw_up, "W m-2", "Upwelling shortwave flux"),
            ("flux_dn_sw", flux.sw_dn, "W m-2",
             "Downwelling shortwave flux"),
            ("flux_dn_direct_sw", flux.sw_dn_direct, "W m-2",
             "Downwelling direct shortwave flux"),
            ("flux_up_lw_clear", flux.lw_up_clear, "W m-2",
             "Upwelling clear-sky longwave flux"),
            ("flux_dn_lw_clear", flux.lw_dn_clear, "W m-2",
             "Downwelling clear-sky longwave flux"),
            ("flux_up_sw_clear", flux.sw_up_clear, "W m-2",
             "Upwelling clear-sky shortwave flux"),
            ("flux_dn_sw_clear", flux.sw_dn_clear, "W m-2",
             "Downwelling clear-sky shortwave flux"),
            ("flux_dn_direct_sw_clear", flux.sw_dn_direct_clear, "W m-2",
             "Downwelling clear-sky direct shortwave flux"),
            ("lw_derivative", flux.lw_derivatives, "1",
             "Derivative of upwelling LW flux w.r.t. surface value")):
        v.add(name, cl, field, units, long_name)
    v.add("cloud_cover_lw", ("column",), flux.cloud_cover_lw, "1",
          "Total cloud cover diagnosed by longwave solver")
    v.add("cloud_cover_sw", ("column",), flux.cloud_cover_sw, "1",
          "Total cloud cover diagnosed by shortwave solver")
    # surface spectral fluxes (radiation_save.F90:270-282)
    sw = ("column", "band_sw")
    v.add("spectral_flux_dn_sw_surf", sw, flux.sw_dn_surf_band, "W m-2",
          "Spectral downwelling shortwave flux at surface")
    v.add("spectral_flux_dn_direct_sw_surf", sw, flux.sw_dn_direct_surf_band,
          "W m-2", "Spectral downwelling direct shortwave flux at surface")
    v.add("spectral_flux_dn_sw_surf_clear", sw, flux.sw_dn_surf_clear_band,
          "W m-2", "Spectral downwelling clear-sky shortwave flux at "
          "surface")
    v.add("spectral_flux_dn_direct_sw_surf_clear", sw,
          flux.sw_dn_direct_surf_clear_band, "W m-2",
          "Spectral downwelling clear-sky direct shortwave flux at surface")
    v.add("flux_dn_lw_surf_band", ("column", "band_lw"),
          flux.lw_dn_surf_band, "W m-2",
          "Surface downwelling longwave flux in each band")
    # canopy-top fluxes (radiation_save.F90 canopy_flux_*)
    v.add("canopy_flux_dn_diffuse_sw_surf", ("column", "canopy_band_sw"),
          flux.sw_dn_diffuse_surf_canopy, "W m-2",
          "Surface downwelling diffuse shortwave flux in canopy bands")
    v.add("canopy_flux_dn_direct_sw_surf", ("column", "canopy_band_sw"),
          flux.sw_dn_direct_surf_canopy, "W m-2",
          "Surface downwelling direct shortwave flux in canopy bands")
    v.add("canopy_flux_dn_lw_surf", ("column", "canopy_band_lw"),
          flux.lw_dn_surf_canopy, "W m-2",
          "Surface downwelling longwave flux in canopy bands")
    # band-resolved profiles (do_save_spectral_flux)
    for region, fields in (
            ("sw", (("spectral_flux_up_sw", flux.sw_up_band,
                     "Spectral upwelling shortwave flux"),
                    ("spectral_flux_dn_sw", flux.sw_dn_band,
                     "Spectral downwelling shortwave flux"),
                    ("spectral_flux_dn_direct_sw", flux.sw_dn_direct_band,
                     "Spectral downwelling direct shortwave flux"),
                    ("spectral_flux_up_sw_clear", flux.sw_up_band_clear,
                     "Spectral clear-sky upwelling shortwave flux"),
                    ("spectral_flux_dn_sw_clear", flux.sw_dn_band_clear,
                     "Spectral clear-sky downwelling shortwave flux"),
                    ("spectral_flux_dn_direct_sw_clear",
                     flux.sw_dn_direct_band_clear,
                     "Spectral clear-sky downwelling direct shortwave "
                     "flux"))),
            ("lw", (("spectral_flux_up_lw", flux.lw_up_band,
                     "Spectral upwelling longwave flux"),
                    ("spectral_flux_dn_lw", flux.lw_dn_band,
                     "Spectral downwelling longwave flux"),
                    ("spectral_flux_up_lw_clear", flux.lw_up_band_clear,
                     "Spectral clear-sky upwelling longwave flux"),
                    ("spectral_flux_dn_lw_clear", flux.lw_dn_band_clear,
                     "Spectral clear-sky downwelling longwave flux")))):
        for name, field, long_name in fields:
            v.add(name, ("column", "half_level", f"band_{region}"), field,
                  "W m-2", long_name)
    write_netcdf(path, v.dims, v.variables, v.attrs,
                 global_attrs={"title": "Radiative fluxes from ecRad-TPU"},
                 **nc_kwargs)


def save_inputs(path: str, single_level, thermo, gas, cloud,
                aerosol) -> None:
    """The scheme's inputs under the driver's names (do_save_inputs;
    radiation_save.F90:719), so that the file can be fed back in."""
    v = _Vars()
    v.add("pressure_hl", ("column", "half_level"), thermo.pressure_hl)
    v.add("temperature_hl", ("column", "half_level"), thermo.temperature_hl)
    v.add("cos_solar_zenith_angle", ("column",), single_level.cos_sza)
    v.add("skin_temperature", ("column",), single_level.skin_temperature)
    v.add("sw_albedo", ("column", "sw_albedo_band"), single_level.sw_albedo)
    v.add("lw_emissivity", ("column", "lw_emiss_band"),
          single_level.lw_emissivity)
    cl = ("column", "level")
    for name in GAS_NAMES:
        field = _numpy(gas.get(name))
        if np.any(field != 0.0):
            v.add(f"{name}_mmr" if name != "h2o" else "q", cl, field)
    if cloud is not None:
        v.add("cloud_fraction", cl, cloud.fraction)
        v.add("q_liquid", cl, cloud.q_liq)
        v.add("q_ice", cl, cloud.q_ice)
        v.add("re_liquid", cl, cloud.re_liq)
        v.add("re_ice", cl, cloud.re_ice)
        v.add("fractional_std", cl, cloud.fractional_std)
        v.add("overlap_param", ("column", "level_interface"),
              cloud.overlap_param)
        v.add("inv_cloud_effective_size", cl, cloud.inv_cloud_effective_size)
    if (aerosol is not None and aerosol.mixing_ratio is not None
            and np.any(_numpy(aerosol.mixing_ratio) != 0.0)):
        v.add("aerosol_mmr", ("column", "level", "aerosol_type"),
              aerosol.mixing_ratio)
    write_netcdf(path, v.dims, v.variables,
                 global_attrs={"title": "ecRad-TPU scheme inputs"})


def save_radiative_properties(path: str, setup, single_level, thermo,
                              gas) -> None:
    """The per-g radiative properties entering the solver
    (do_save_radiative_properties; radiation_save.F90:411), from the
    port's gas optics."""
    from ..interface import get_albedos
    from ..optics.rrtmg.gas_optics import gas_optics
    cfg = setup.config
    go = gas_optics(thermo.pressure_hl, thermo.temperature_hl,
                    gas.mixing_ratio, single_level.skin_temperature,
                    single_level.cos_sza, single_level.solar_irradiance,
                    setup.maps, setup.gas,
                    lw_albedo=get_albedos(setup, single_level)[2],
                    min_gas_od_lw=cfg.min_gas_od_lw,
                    min_gas_od_sw=cfg.min_gas_od_sw)
    v = _Vars()
    clg, csg = ("column", "level", "g_lw"), ("column", "level", "g_sw")
    v.add("od_lw", clg, go.od_lw)
    v.add("od_sw", csg, go.od_sw)
    v.add("ssa_sw", csg, go.ssa_sw)
    v.add("planck_hl", ("column", "half_level", "g_lw"), go.planck_hl)
    v.add("lw_emission", ("column", "g_lw"), go.lw_emission)
    v.add("incoming_sw", ("column", "g_sw"), go.incoming_sw)
    write_netcdf(path, v.dims, v.variables,
                 global_attrs={"title":
                               "ecRad-TPU per-g radiative properties"})


def save_surface_fluxes(path: str, surface_flux) -> None:
    """The facet and canopy fluxes of a tiled surface (a
    surface.SurfaceFlux) under radsurf_save.F90's names (:24-140):
    (column, facet) and (column, tile), float32."""
    v = _Vars()
    cf, ct = ("column", "facet"), ("column", "tile")
    v.add("flux_dn_lw_facet", cf, surface_flux.lw_dn_facet, "W m-2",
          "Longwave flux into facet of surface")
    v.add("flux_up_lw_facet", cf, surface_flux.lw_up_facet, "W m-2",
          "Longwave flux out of facet of surface")
    v.add("absorption_lw_canopy", ct, surface_flux.lw_abs_canopy, "W m-2",
          "Longwave absorption by tile canopy")
    v.add("flux_dn_sw_facet", cf, surface_flux.sw_dn_facet, "W m-2",
          "Shortwave flux into facet of surface")
    v.add("flux_dn_direct_sw_facet", cf, surface_flux.sw_dn_direct_facet,
          "W m-2", "Shortwave direct flux into facet of surface")
    v.add("flux_up_sw_facet", cf, surface_flux.sw_up_facet, "W m-2",
          "Shortwave flux out of facet of surface")
    v.add("absorption_sw_canopy", ct, surface_flux.sw_abs_canopy, "W m-2",
          "Shortwave absorption by tile canopy")
    write_netcdf(path, v.dims, v.variables, v.attrs,
                 global_attrs={"title": "Surface fluxes from ecRad-TPU"})
