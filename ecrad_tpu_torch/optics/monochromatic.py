"""Monochromatic gas and cloud optics: one band, one g-point.

Port of ecrad_tpu/optics/monochromatic.py (radiation/
radiation_monochromatic.F90:37-379), the idealised model of the
reference's driver/test_solver.F90: the total optical depths of the
configuration spread over the layers in proportion to their pressure
thickness, Planck either sigma T^4 (broadband) or at one wavelength, and
geometric-optics cloud optical depths. It reads no table; its spectral
mapping is spectral_mapping.single_g_mapping.
"""
from __future__ import annotations

import math

import torch

from ..config import RadiationConfig
from ..constants import ACCEL_DUE_TO_GRAVITY, STEFAN_BOLTZMANN
from .cloud import delta_eddington
from .rrtmg.gas_optics import GasOptics

PLANCK = 6.62607015e-34
BOLTZMANN = 1.380649e-23
SPEED_OF_LIGHT = 299792458.0
DENSITY_LIQUID_WATER = 1000.0
DENSITY_SOLID_ICE = 916.7

#: the same fields as the RRTMG gas optics, each with one g-point
MonoGasOptics = GasOptics


def planck_function_mono(wavelength: float, temperature: torch.Tensor):
    """Spectral radiance (W sr-1 m-3) at one wavelength (m)
    (radiation_monochromatic.F90:348)."""
    x = PLANCK * SPEED_OF_LIGHT / (wavelength * BOLTZMANN
                                   * torch.clamp(temperature, min=1e-3))
    val = (2.0 * PLANCK * SPEED_OF_LIGHT ** 2
           / (wavelength ** 5 * (torch.exp(x) - 1.0)))
    return torch.where(temperature > 0.0, val, torch.zeros_like(val))


def gas_optics_mono(config: RadiationConfig, single_level,
                    thermodynamics) -> MonoGasOptics:
    """od_lw/od_sw/ssa_sw (ncol, nlev, 1), planck_hl (ncol, nlev+1, 1),
    lw_emission and incoming_sw (ncol, 1)."""
    p_hl = thermodynamics.pressure_hl
    ncol = p_hl.shape[0]
    # the reference normalises by pressure_hl(nlev), the second-to-last
    # half level
    frac = (p_hl[:, 1:] - p_hl[:, :-1]) / torch.clamp(p_hl[:, -2:-1],
                                                      min=1e-3)
    od_lw = (config.mono_lw_total_od * frac)[..., None]
    od_sw = (config.mono_sw_total_od * frac)[..., None]
    t_hl = thermodynamics.temperature_hl
    emissivity = single_level.lw_emissivity[:, 0]
    if config.mono_lw_wavelength <= 0.0:
        planck_hl = STEFAN_BOLTZMANN * t_hl ** 4
        emission = (STEFAN_BOLTZMANN * single_level.skin_temperature ** 4
                    * emissivity)
    else:
        wl = config.mono_lw_wavelength
        planck_hl = math.pi * planck_function_mono(wl, t_hl)
        emission = (math.pi * planck_function_mono(
            wl, single_level.skin_temperature) * emissivity)
    return MonoGasOptics(
        od_lw=od_lw, od_sw=od_sw, ssa_sw=torch.full_like(od_sw, 0.999999),
        planck_hl=planck_hl[..., None], lw_emission=emission[:, None],
        incoming_sw=torch.full((ncol, 1), single_level.solar_irradiance,
                               dtype=p_hl.dtype, device=p_hl.device))


def cloud_optics_mono(config: RadiationConfig, thermodynamics, cloud):
    """Geometric-optics cloud properties (radiation_monochromatic.F90:
    253-310): (od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw), each (ncol,
    nlev, 1), as optics.cloud.cloud_optics returns them for one band."""
    dp = (thermodynamics.pressure_hl[:, 1:]
          - thermodynamics.pressure_hl[:, :-1])
    frac = cloud.fraction
    zero = torch.zeros((), dtype=frac.dtype, device=frac.device)
    factor = dp / (ACCEL_DUE_TO_GRAVITY * torch.clamp(frac, min=1e-12))
    incloud = frac > 0.0
    lwp = torch.where(incloud, factor * cloud.q_liq, zero)
    iwp = torch.where(incloud, factor * cloud.q_ice, zero)
    ice_od = (3.0 / (2.0 * DENSITY_SOLID_ICE)) * iwp / cloud.re_ice
    od_sw = ((3.0 / (2.0 * DENSITY_LIQUID_WATER)) * lwp / cloud.re_liq
             + ice_od)[..., None]
    od_lw = (lwp * 137.22 + ice_od)[..., None]
    ssa_sw = torch.full_like(od_sw, config.mono_sw_single_scattering_albedo)
    g_sw = torch.full_like(od_sw, config.mono_sw_asymmetry_factor)
    cloudy = incloud[..., None]
    od_sw, ssa_sw, g_sw = (torch.where(cloudy, x, zero)
                           for x in delta_eddington(od_sw, ssa_sw, g_sw))
    if config.do_lw_cloud_scattering:
        ssa_lw = torch.full_like(od_lw,
                                 config.mono_lw_single_scattering_albedo)
        g_lw = torch.full_like(od_lw, config.mono_lw_asymmetry_factor)
        od_lw, ssa_lw, g_lw = (torch.where(cloudy, x, zero)
                               for x in delta_eddington(od_lw, ssa_lw, g_lw))
    else:
        ssa_lw = g_lw = torch.zeros_like(od_lw)
        od_lw = torch.where(
            cloudy, od_lw * (1.0 - config.mono_lw_single_scattering_albedo),
            zero)
    return od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw
