"""Homogeneous (plane-parallel) solvers.

Port of ecrad_tpu/solvers/homogeneous.py:22-87
(radiation_homogeneous_sw.F90:33, radiation_homogeneous_lw.F90:30): the
cloud fills each cloudy grid box (the cloud stage takes its water path as
dp/g), its properties merge into the gas and aerosol ones per g-point and
one adding pass gives the total-sky fluxes; the clear sky is the
Cloudless solver on gas and aerosols. It runs kernels B3 and B3' and no
kernel of its own.
"""
from __future__ import annotations

import torch

from ..config import RadiationConfig
from ..optics.cloud import delta_eddington
from ..optics.combine import combine_cloud_gas_lw, combine_cloud_gas_sw
from . import two_stream as ts
from .adding import adding_lw, adding_sw, lw_no_scattering_fluxes
from .cloudless import (LwFluxes, SwFluxes, _gf, daylight,
                        solver_cloudless_lw, solver_cloudless_sw)
from .lw_derivatives import lw_derivatives_ica


def solver_homogeneous_sw(config: RadiationConfig, band_from_g, cloud, od,
                          ssa, g, od_cloud, ssa_cloud, g_cloud, incoming_sw,
                          cos_sza, albedo_diffuse, albedo_direct):
    """Returns (total SwFluxes, clear SwFluxes)."""
    clear = solver_cloudless_sw(od, ssa, g, incoming_sw, cos_sza,
                                albedo_diffuse, albedo_direct)
    cloud_mask = (cloud.fraction >= config.cloud_fraction_threshold)[..., None]
    od_t, ssa_t, g_t = combine_cloud_gas_sw(
        od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
        cloud_mask=cloud_mask)
    if config.do_sw_delta_scaling_with_gases:
        od_t, ssa_t, g_t = delta_eddington(od_t, ssa_t, g_t)
    od_t, ssa_t, g_t = _gf(od_t), _gf(ssa_t), _gf(g_t)
    mu0_col = torch.clamp(cos_sza, min=1e-10)
    mu0 = mu0_col[None, :]
    r, t, rd, tdd, tdir = ts.sw_reftrans(mu0, od_t, ssa_t,
                                         *ts.sw_gammas(mu0, ssa_t, g_t))
    total = adding_sw(r, t, rd, tdd, tdir, incoming_sw.T.contiguous(),
                      albedo_diffuse.T.contiguous(),
                      albedo_direct.T.contiguous(), mu0_col.contiguous())
    return daylight(cos_sza, SwFluxes(*total)), clear


def solver_homogeneous_lw(config: RadiationConfig, band_from_g, cloud, od,
                          ssa, g, od_cloud, ssa_cloud, g_cloud, planck_hl,
                          emission, albedo):
    """Returns (total LwFluxes, clear LwFluxes, extras)."""
    clear, t_clear = solver_cloudless_lw(
        od, ssa, g, planck_hl, emission, albedo,
        do_scattering=config.do_lw_aerosol_scattering, want_trans=True)
    cloud_mask = (cloud.fraction >= config.cloud_fraction_threshold)[..., None]
    od_t, ssa_t, g_t = combine_cloud_gas_lw(
        od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
        config.do_lw_cloud_scattering, cloud_mask=cloud_mask)
    planck_g = _gf(planck_hl)
    planck_top, planck_bot = planck_g[:-1], planck_g[1:]
    emis_g, alb_g = emission.T.contiguous(), albedo.T.contiguous()
    if config.do_lw_cloud_scattering:
        r, t, su, sd = ts.lw_reftrans(
            _gf(od_t), *ts.lw_gammas(_gf(ssa_t), _gf(g_t)), planck_top,
            planck_bot)
        up, dn = adding_lw(r, t, su, sd, emis_g, alb_g)
    else:
        t, su, sd = ts.lw_no_scattering_transmittance(_gf(od_t), planck_top,
                                                      planck_bot)
        up, dn = lw_no_scattering_fluxes(t, su, sd, emis_g, alb_g)
    extras = {}
    if config.do_lw_derivatives:
        # the total-sky transmittance in columns with cloud, the clear
        # one elsewhere (radiation_homogeneous_lw.F90:301-307)
        extras["lw_derivatives"] = torch.where(
            cloud_mask.any(1), lw_derivatives_ica(t, up[-1].T),
            lw_derivatives_ica(t_clear, clear.up[-1].T))
    return LwFluxes(up=up, dn=dn), clear, extras
