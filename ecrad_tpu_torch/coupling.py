"""Host-model coupling: the IFS RADIATION_SCHEME adapter.

Port of ecrad_tpu/coupling.py (ifs/radiation_scheme.F90 and the
parameterisations it calls: liquid_effective_radius.F90 (Martin et al.
1994), ice_effective_radius.F90 (Sun and Rikus 1999, rev. Sun 2001) and
cloud_overlap_decorr_len.F90). `radiation_scheme` packs a host model's
arrays (numpy arrays or tensors) into the port's types on the setup's
device and dtype (the GPU unless setup_radiation was asked for another
device), derives the effective radii and the overlap parameter and runs
radiation(); `unpack_host_outputs` computes what RADIATION_SCHEME hands
back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .constants import ACCEL_DUE_TO_GRAVITY
from .interface import (RadiationSetup, _group_index, _indexed_sum,
                        radiation)
from .optics.rrtmg.gas_optics import WAVENUM1_SW, WAVENUM2_SW
from .types import Aerosol, Cloud, GasConcs, SingleLevel, Thermodynamics

RD = 287.058
RTT = 273.16
RRE2DE = 0.64952  # effective radius / effective diameter (Fu convention)
SIGMA_SB = 5.670374419e-8


def _pick(cond, a, b, like):
    """a where cond else b, in like's dtype and on its device."""
    t = lambda v: torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.where(cond, t(a), t(b))


def liquid_effective_radius(pressure, temperature, cloud_frac, q_liq,
                            q_rain, land_frac, ccn_land=900.0,
                            ccn_sea=50.0):
    """Martin et al. (1994) droplet effective radius (m)
    (ifs/liquid_effective_radius.F90 case 2). land_frac broadcasts
    against the (ncol, nlev) fields (the caller's land_frac[:, None])."""
    land = land_frac >= 0.5
    spectral_dispersion = _pick(land, 0.69, 0.77, pressure)
    ccn = _pick(land, ccn_land, ccn_sea, pressure)
    ntot_cm3 = torch.where(land, -2.10e-4 * ccn * ccn + 0.568 * ccn - 27.9,
                           -1.15e-3 * ccn * ccn + 0.963 * ccn + 5.30)
    ratio = (0.222 / spectral_dispersion) ** 0.333
    air_density_gm3 = 1000.0 * pressure / (RD * temperature)
    frac = torch.clamp(cloud_frac, min=1e-3)
    lwc = air_density_gm3 * q_liq / frac
    rwc = air_density_gm3 * q_rain / frac
    rain_ratio = rwc / torch.clamp(lwc, min=1e-12)
    one = torch.ones((), dtype=lwc.dtype, device=lwc.device)
    wood_factor = torch.where(
        lwc > 1e-12,
        (1.0 + rain_ratio) ** 0.666 / (1.0 + 0.2 * ratio * rain_ratio), one)
    re_cubed = (3.0 * (lwc + rwc)) / (
        4.0 * math.pi * (ntot_cm3 * spectral_dispersion))
    four = 4.0 * one
    re_um = torch.where(
        re_cubed > 1e-12,
        torch.clamp(wood_factor * 100.0 * torch.exp(
            0.333 * torch.log(torch.clamp(re_cubed, min=1e-12))), 4.0, 30.0),
        four)
    active = (cloud_frac >= 0.001) & (q_liq + q_rain > 0.0)
    return torch.where(active, re_um, four) * 1e-6


def ice_effective_radius(pressure, temperature, cloud_frac, q_ice,
                         q_snow, min_diameter_um=20.0):
    """Sun and Rikus (1999) rev. Sun (2001) ice effective radius (m)
    (ifs/ice_effective_radius.F90 case 1)."""
    air_density_gm3 = 1000.0 * pressure / (RD * temperature)
    frac = torch.clamp(cloud_frac, min=1e-3)
    iwc = torch.clamp(air_density_gm3 * (q_ice + q_snow) / frac, min=1e-12)
    t_c = temperature - RTT
    aiwc = 45.8966 * iwc ** 0.2214
    biwc = 0.7957 * iwc ** 0.2535
    diameter_um = torch.clamp((1.2351 + 0.0105 * t_c)
                              * (aiwc + biwc * (temperature - 83.15)),
                              min_diameter_um, 155.0)
    active = (cloud_frac >= 0.001) & (q_ice + q_snow > 0.0)
    return torch.where(active, diameter_um * RRE2DE,
                       torch.full_like(diameter_um, 80.0 * RRE2DE)) * 1e-6


def cloud_overlap_decorr_len(sin_latitude, scheme=1):
    """Latitude-dependent overlap decorrelation length (km)
    (ifs/cloud_overlap_decorr_len.F90): Shonk et al. (2010) Eq. 13
    (scheme 1), else the variant smoothed at the equator."""
    lat = torch.asin(torch.as_tensor(sin_latitude))
    if scheme == 1:
        return 2.899 - 0.02759 * (torch.abs(lat) * (180.0 / math.pi))
    cos_lat = torch.cos(lat)
    return 0.75 + 2.149 * cos_lat * cos_lat


def get_sw_weights(wavelength1: float, wavelength2: float):
    """(band_indices, weights), numpy, 0-based: the fraction of each SW
    band inside a wavelength range (radiation_config.F90:1304-1366), at
    setup for the UV (0.2-0.4415 um) and PAR (0.4-0.7 um) diagnostics
    (ifs/radiation_setup.F90:341-344)."""
    wn1, wn2 = 0.01 / wavelength2, 0.01 / wavelength1
    bands, weights = [], []
    for jband in range(len(WAVENUM1_SW)):
        if wn1 < WAVENUM2_SW[jband] and wn2 > WAVENUM1_SW[jband]:
            bands.append(jband)
            weights.append(
                (min(wn2, WAVENUM2_SW[jband]) - max(wn1, WAVENUM1_SW[jband]))
                / (WAVENUM2_SW[jband] - WAVENUM1_SW[jband]))
    if not bands:
        raise ValueError(f"wavelength range {wavelength1}..{wavelength2} m "
                         f"outside the shortwave bands")
    return np.asarray(bands), np.asarray(weights)


def uv_par_fluxes(flux):
    """Surface UV and PAR from the band-resolved surface fluxes
    (ifs/radiation_scheme.F90:467-482), which need
    do_surface_sw_spectral_flux: (flux_uv, flux_par, flux_par_clear), each
    (ncol,), the last zero without the clear sky."""
    if flux.sw_dn_surf_band is None:
        raise ValueError("uv_par_fluxes needs do_surface_sw_spectral_flux")
    band = flux.sw_dn_surf_band

    def weighted(x, wavelengths):
        ib, w = get_sw_weights(*wavelengths)
        w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
        return (x[:, torch.as_tensor(ib, device=x.device)] * w).sum(-1)
    uv, par = (0.2e-6, 0.4415e-6), (0.4e-6, 0.7e-6)
    par_clear = (weighted(flux.sw_dn_surf_clear_band, par)
                 if flux.sw_dn_surf_clear_band is not None
                 else torch.zeros_like(band[:, 0]))
    return weighted(band, uv), weighted(band, par), par_clear


class HostOutputs(NamedTuple):
    """What RADIATION_SCHEME hands back to the host model
    (ifs/radiation_scheme.F90:445-512), in IFS naming."""
    flux_sw: torch.Tensor            # net SW profile (ncol, nlev+1)
    flux_lw: torch.Tensor            # net LW profile
    flux_sw_clear: torch.Tensor
    flux_lw_clear: torch.Tensor
    flux_sw_dn: torch.Tensor         # surface downwelling (ncol,)
    flux_lw_dn: torch.Tensor
    flux_sw_dn_clear: torch.Tensor
    flux_lw_dn_clear: torch.Tensor
    flux_dir: torch.Tensor           # surface direct SW
    flux_dir_clear: torch.Tensor
    flux_dir_into_sun: torch.Tensor  # direct normal irradiance
    flux_sw_dn_toa: torch.Tensor
    flux_uv: torch.Tensor
    flux_par: torch.Tensor
    flux_par_clear: torch.Tensor
    emis_out: torch.Tensor           # effective broadband emissivity
    lw_derivative: Optional[torch.Tensor]
    sw_diffuse_band: Optional[torch.Tensor]  # (ncol, n_albedo_bands)
    sw_direct_band: Optional[torch.Tensor]


def unpack_host_outputs(setup: RadiationSetup, flux, *, cos_sza,
                        skin_temperature, lw_emissivity) -> HostOutputs:
    """Everything RADIATION_SCHEME computes after radiation()
    (ifs/radiation_scheme.F90:445-512): net-flux profiles, surface and
    TOA values, the direct normal irradiance, UV and PAR, the effective
    broadband emissivity, the LW derivatives, and the diffuse and direct
    surface SW per albedo band of the approximate SW update
    (LAPPROXSWUPDATE; each SW band summed into its albedo band, the
    nearest one or with overlap weights the one of largest weight, by the
    gather-and-sum of interface._indexed_sum)."""
    like = flux.sw_dn
    t = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
    net_lw = flux.lw_dn - flux.lw_up
    lw_dn_surf = flux.lw_dn[:, -1]
    fdir = flux.sw_dn_direct[:, -1]
    fdir_clear = (flux.sw_dn_direct_clear[:, -1]
                  if flux.sw_dn_direct_clear is not None
                  else torch.zeros_like(fdir))
    mu0 = t(cos_sza)
    dir_into_sun = torch.where(mu0 > 1e-10,
                               fdir / torch.clamp(mu0, min=1e-10),
                               torch.zeros_like(fdir))
    flux_uv, flux_par, flux_par_clear = uv_par_fluxes(flux)
    # effective broadband emissivity (ifs/radiation_scheme.F90:487-492)
    emissivity = t(lw_emissivity)
    if emissivity.ndim > 1:
        emissivity = emissivity[:, 0]
    black_net = lw_dn_surf - SIGMA_SB * t(skin_temperature) ** 4
    emis_out = torch.where(torch.abs(black_net) > 1e-5,
                           net_lw[:, -1] / black_net, emissivity)
    sw_diffuse_band = sw_direct_band = None
    if (flux.sw_dn_surf_band is not None
            and flux.sw_dn_direct_surf_band is not None):
        alb_from_band = (np.asarray(setup.sw_albedo_map)
                         if setup.sw_albedo_map is not None
                         else np.argmax(np.asarray(setup.sw_albedo_weights),
                                        axis=0))
        idx = _group_index(alb_from_band, int(alb_from_band.max()) + 1,
                           like.device)
        sw_diffuse_band = _indexed_sum(
            flux.sw_dn_surf_band - flux.sw_dn_direct_surf_band, idx, 1)
        sw_direct_band = _indexed_sum(flux.sw_dn_direct_surf_band, idx, 1)
    return HostOutputs(
        flux_sw=flux.sw_dn - flux.sw_up, flux_lw=net_lw,
        flux_sw_clear=flux.sw_dn_clear - flux.sw_up_clear,
        flux_lw_clear=flux.lw_dn_clear - flux.lw_up_clear,
        flux_sw_dn=flux.sw_dn[:, -1], flux_lw_dn=lw_dn_surf,
        flux_sw_dn_clear=flux.sw_dn_clear[:, -1],
        flux_lw_dn_clear=flux.lw_dn_clear[:, -1],
        flux_dir=fdir, flux_dir_clear=fdir_clear,
        flux_dir_into_sun=dir_into_sun, flux_sw_dn_toa=flux.sw_dn[:, 0],
        flux_uv=flux_uv, flux_par=flux_par, flux_par_clear=flux_par_clear,
        emis_out=emis_out, lw_derivative=flux.lw_derivatives,
        sw_diffuse_band=sw_diffuse_band, sw_direct_band=sw_direct_band)


def radiation_scheme(setup: RadiationSetup, *, pressure_hl,
                     temperature_hl, cos_sza, skin_temperature,
                     sw_albedo, lw_emissivity, q, q_liq, q_ice,
                     cloud_frac, sin_latitude, land_frac,
                     co2_vmr=415e-6, ch4_vmr=1.8e-6, n2o_vmr=330e-9,
                     o3_mmr=None, q_rain=None, q_snow=None,
                     aerosol_mmr=None, solar_irradiance=1361.0,
                     iseed=None, spectral_solar_scaling=None):
    """Pack a host model's arrays, derive the cloud inputs and run the
    radiation scheme (ifs/radiation_scheme.F90:237-442), on setup.device
    in setup.dtype: levels TOA first, (ncol, nlev+1) half levels, (ncol,
    nlev) layers, (ncol,) surface fields; sw_albedo and lw_emissivity
    (ncol,) or (ncol, nintervals). The gases are well mixed but for water
    vapour and ozone; iseed defaults to 1..ncol. spectral_solar_scaling
    (14,) scales the solar source per band where the configuration has
    use_spectral_solar_scaling. The overlap parameter comes from each
    column's decorrelation length, or from one length where sin_latitude
    is a scalar."""
    dev, dt = setup.device, setup.dtype
    t = lambda x: None if x is None else torch.as_tensor(x, dtype=dt,
                                                         device=dev)
    pressure_hl, temperature_hl = t(pressure_hl), t(temperature_hl)
    q_liq, q_ice, cloud_frac = t(q_liq), t(q_ice), t(cloud_frac)
    ncol, nlev = q_liq.shape
    p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    q_rain = t(q_rain) if q_rain is not None else torch.zeros_like(q_liq)
    q_snow = t(q_snow) if q_snow is not None else torch.zeros_like(q_ice)
    sw_albedo, lw_emissivity = t(sw_albedo), t(lw_emissivity)
    single_level = SingleLevel(
        cos_sza=t(cos_sza), skin_temperature=t(skin_temperature),
        sw_albedo=sw_albedo if sw_albedo.ndim == 2 else sw_albedo[:, None],
        lw_emissivity=(lw_emissivity if lw_emissivity.ndim == 2
                       else lw_emissivity[:, None]),
        solar_irradiance=float(solar_irradiance),
        spectral_solar_scaling=t(spectral_solar_scaling),
        iseed=(torch.as_tensor(iseed, dtype=torch.int32, device=dev)
               if iseed is not None else
               torch.arange(1, ncol + 1, dtype=torch.int32, device=dev)))
    thermo = Thermodynamics(pressure_hl=pressure_hl,
                            temperature_hl=temperature_hl)
    gas = GasConcs.create(ncol, nlev, device=dev).put("h2o", t(q))
    for name, vmr in (("co2", co2_vmr), ("ch4", ch4_vmr),
                      ("n2o", n2o_vmr), ("o2", 0.20944)):
        gas = gas.put_well_mixed_vmr(name, vmr, ncol, nlev)
    if o3_mmr is not None:
        gas = gas.put("o3", t(o3_mmr))

    land = t(land_frac)[:, None]
    cloud = Cloud(
        q_liq=q_liq, q_ice=q_ice,
        re_liq=liquid_effective_radius(p_fl, t_fl, cloud_frac, q_liq, q_rain,
                                       land),
        re_ice=ice_effective_radius(p_fl, t_fl, cloud_frac, q_ice, q_snow),
        fraction=cloud_frac, fractional_std=torch.ones_like(cloud_frac))
    decorr_km = cloud_overlap_decorr_len(t(sin_latitude))
    if decorr_km.ndim == 0:
        cloud = cloud.set_overlap_param(thermo,
                                        decorr_km.mean().item() * 1000.0)
    else:
        cloud = cloud.replace(overlap_param=_overlap_from_decorr(
            thermo, decorr_km * 1000.0))
    aerosol = Aerosol(mixing_ratio=(
        t(aerosol_mmr) if aerosol_mmr is not None else
        torch.zeros((ncol, nlev, 1), device=dev)))
    return radiation(setup, single_level, thermo, gas, cloud, aerosol)


def _overlap_from_decorr(thermo, decorr_len_m):
    """The overlap parameter, (ncol, nlev-1), from a decorrelation length
    (m) per column: Cloud.set_overlap_param's separations."""
    p = torch.clamp(thermo.pressure_hl, min=1.0)
    t = thermo.temperature_hl
    dz = (287.0 / ACCEL_DUE_TO_GRAVITY) * 0.5 * (t[:, :-1] + t[:, 1:]) \
        * torch.log(p[:, 1:] / p[:, :-1])
    sep = 0.5 * (dz[:, :-1] + dz[:, 1:])
    return torch.exp(-torch.abs(sep) / decorr_len_m[:, None])
