"""Boundary conditions from a tiled surface, and the partition of the
surface fluxes onto its facets.

Port of ecrad_tpu/surface/intermediate.py (radsurf/radsurf_intermediate.F90:
calc_boundary_conditions_sw :277-562, _lw :567-925, the driver
:955-1038, partition_fluxes :1042-1314). Each tile adds its share of an
effective albedo, emissivity and emission to the single-level boundary
condition the atmosphere sees: a flat tile its facet's values, a
vegetation canopy a one-layer two-stream plus adding step, an urban
canyon its wall exchange folded into two-stream rates in physical
coordinates. Once the atmosphere is solved, partition_fluxes spreads the
canopy-top downwelling fluxes back onto the ground, roof and wall facets
and the canopy absorption.

All columns at once; the tile loop is a static Python loop over the
representation, writing each tile's region and facet values into
preallocated tensors. The spectral sums are plain sums over the last
axis (no atomics: a run repeats bit for bit).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..constants import STEFAN_BOLTZMANN
from ..optics.rrtmg.gas_optics import planck_store, reorder
from ..optics.spectral_mapping import expand_to_g
from ..solvers.two_stream import (LW_DIFFUSIVITY, lw_gammas,
                                  lw_reftrans_isothermal, sw_gammas,
                                  sw_reftrans, sw_reftrans_z)
from ..types import _Replace
from .flux import SurfaceFlux
from .properties import ITileFlat, ITileVegetation, SurfaceDescription


@dataclass
class SurfaceIntermediate(_Replace):
    """Facet and region properties kept from the boundary conditions for
    the partition (radsurf_intermediate.F90:27-106): facet fields (ncol,
    nfacet, nbands), region fields (ncol, nregion, nbands)."""
    planck_facet: Optional[torch.Tensor] = None
    lw_emissivity: Optional[torch.Tensor] = None
    sw_albedo_direct: Optional[torch.Tensor] = None
    sw_albedo_diffuse: Optional[torch.Tensor] = None
    planck_region: Optional[torch.Tensor] = None
    sw_ref_dif: Optional[torch.Tensor] = None
    sw_tra_dif: Optional[torch.Tensor] = None
    sw_ref_dir: Optional[torch.Tensor] = None
    sw_tra_dir_dif: Optional[torch.Tensor] = None
    sw_tra_dir_dir: Optional[torch.Tensor] = None
    sw_wall_abs_dir: Optional[torch.Tensor] = None
    sw_air_abs_dir: Optional[torch.Tensor] = None
    sw_wall_abs_frac_dif: Optional[torch.Tensor] = None
    sw_albedo_diffuse_reg: Optional[torch.Tensor] = None
    sw_albedo_direct_reg: Optional[torch.Tensor] = None
    lw_reflectance: Optional[torch.Tensor] = None
    lw_transmittance: Optional[torch.Tensor] = None
    lw_source: Optional[torch.Tensor] = None
    lw_wall_abs_frac: Optional[torch.Tensor] = None
    lw_total_wall_emission: Optional[torch.Tensor] = None
    lw_total_canopy_emission: Optional[torch.Tensor] = None


class BoundaryConditions(NamedTuple):
    """The effective single-level boundary condition of a tiled
    surface."""
    sw_albedo_diffuse: torch.Tensor   # (ncol, nswbands)
    sw_albedo_direct: torch.Tensor    # (ncol, nswbands)
    lw_emissivity: torch.Tensor       # (ncol, nlwbands)
    lw_emission: torch.Tensor         # (ncol, nlwbands), W m-2
    intermediate: SurfaceIntermediate


def _expand_sw(setup, values):
    return expand_to_g(values, *setup.intervals["sw"], setup.maps.band_sw)


def _expand_lw(setup, values):
    return expand_to_g(values, *setup.intervals["lw"], setup.maps.band_lw)


def _per_facet(expand, values):
    """expand (ncol, n) -> (ncol, ng) applied to (ncol, nfacet, n)."""
    ncol, nfacet, n = values.shape
    return expand(values.reshape(ncol * nfacet, n)).reshape(ncol, nfacet,
                                                            -1)


def _facet_albedos_sw(setup, surface: SurfaceDescription):
    """(diffuse, direct) facet albedos, (ncol, nfacet, nsw), per g with
    use_canopy_full_spectrum_sw (radsurf_intermediate.F90:356-377)."""
    alb = surface.sw_albedo
    alb_dir = (surface.sw_albedo_direct
               if surface.sw_albedo_direct is not None else alb)
    if setup.config.use_canopy_full_spectrum_sw:
        expand = lambda x: _expand_sw(setup, x)          # noqa: E731
        return _per_facet(expand, alb), _per_facet(expand, alb_dir)
    return alb, alb_dir


def _facet_emissivity_planck_lw(setup, surface: SurfaceDescription):
    """(emissivity, Planck) of the facets (ncol, nfacet, nlw) and the
    canopies' Planck per tile (ncol, ntile, nlw), per g with
    use_canopy_full_spectrum_lw (radsurf_intermediate.F90:646-696): the
    band Planck of the skin and canopy temperatures times the fixed
    per-g Planck fractions of a surface without a gas profile
    (radiation_ifs_rrtm.F90:809-849). Broadband: sigma T^4 (the
    reference's region Planck lacks the ** 4, :692; the JAX package
    takes T^4)."""
    emiss = surface.lw_emissivity
    skin_t = surface.skin_temperature
    canopy_t = (surface.canopy_temperature
                if surface.canopy_temperature is not None
                else skin_t[:, :1] * torch.ones(
                    (1, surface.ntile), dtype=skin_t.dtype,
                    device=skin_t.device))
    if setup.config.use_canopy_full_spectrum_lw:
        t, band_g = setup.gas, setup.maps.band_lw
        pfrac = reorder(t.lw_fixed_pfrac, setup.maps.g_lw)
        planck_facet = planck_store(skin_t, t.totplnk, t.delwave)[
            :, :, band_g] * pfrac
        planck_canopy = planck_store(canopy_t, t.totplnk, t.delwave)[
            :, :, band_g] * pfrac
        return (_per_facet(lambda x: _expand_lw(setup, x), emiss),
                planck_facet, planck_canopy)
    if surface.nemissbands != 1:
        raise ValueError("broadband canopy LW requires one emissivity band"
                         " (radsurf_intermediate.F90:674-677)")
    return (emiss, (STEFAN_BOLTZMANN * skin_t ** 4)[:, :, None],
            (STEFAN_BOLTZMANN * canopy_t ** 4)[:, :, None])


_REGION_FIELDS = (
    "planck_region", "sw_ref_dif", "sw_tra_dif", "sw_ref_dir",
    "sw_tra_dir_dif", "sw_tra_dir_dir", "sw_wall_abs_dir", "sw_air_abs_dir",
    "sw_wall_abs_frac_dif", "sw_albedo_diffuse_reg", "sw_albedo_direct_reg",
    "lw_reflectance", "lw_transmittance", "lw_source", "lw_wall_abs_frac",
    "lw_total_wall_emission", "lw_total_canopy_emission")


def calc_boundary_conditions(setup, surface: SurfaceDescription,
                             cos_sza: torch.Tensor,
                             ext_sw_air: Optional[torch.Tensor] = None,
                             ssa_sw_air: Optional[torch.Tensor] = None,
                             g_sw_air: Optional[torch.Tensor] = None,
                             ext_lw_air: Optional[torch.Tensor] = None,
                             ) -> BoundaryConditions:
    """The tiled surface folded into an effective albedo, emissivity and
    emission (radsurf_intermediate.F90:277-925). The *_air arguments are
    the lowest model level's extinction properties (m-1) at the canopy's
    spectral resolution, (ncol, nbands), for gas absorption inside the
    canopies (do_canopy_gases_*). Runs where the surface's tensors
    are."""
    alb_diff, alb_dir = _facet_albedos_sw(setup, surface)
    emiss, planck_facet, planck_canopy_t = _facet_emissivity_planck_lw(
        setup, surface)
    if surface.is_simple:
        return BoundaryConditions(
            sw_albedo_diffuse=alb_diff[:, 0, :],
            sw_albedo_direct=alb_dir[:, 0, :],
            lw_emissivity=emiss[:, 0, :],
            lw_emission=emiss[:, 0, :] * planck_facet[:, 0, :],
            intermediate=SurfaceIntermediate(
                planck_facet=planck_facet, lw_emissivity=emiss,
                sw_albedo_direct=alb_dir, sw_albedo_diffuse=alb_diff))

    ncol, n_sw, n_lw = surface.ncol, alb_diff.shape[-1], emiss.shape[-1]
    dtype, dev = alb_diff.dtype, alb_diff.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                       device=dev)
    nregion = max(surface.nregion, 1)
    reg = {k: zeros(ncol, nregion, n_lw if k.startswith(("lw", "planck"))
                    else n_sw) for k in _REGION_FIELDS}
    sw_albedo, sw_albedo_dir = zeros(ncol, n_sw), zeros(ncol, n_sw)
    lw_emissivity, lw_emission = zeros(ncol, n_lw), zeros(ncol, n_lw)
    ground_i, roof_i, wall_i, region_i = surface.indices()
    mu0 = torch.clamp(cos_sza, min=1.0e-6)[:, None]   # sun-down columns

    for jtile, rep in enumerate(surface.representation):
        frac = surface.tile_fraction[:, jtile][:, None]
        ig = ground_i[jtile]
        if rep == ITileFlat:
            sw_albedo = sw_albedo + frac * alb_diff[:, ig, :]
            sw_albedo_dir = sw_albedo_dir + frac * alb_dir[:, ig, :]
            lw_emissivity = lw_emissivity + frac * emiss[:, ig, :]
            lw_emission = lw_emission + frac * (
                planck_facet[:, ig, :] * emiss[:, ig, :])
            continue

        ir = region_i[jtile]
        depth = surface.canopy_depth[:, jtile][:, None]
        if rep == ITileVegetation:
            # SW: Sellers-like one-layer canopy and adding
            veg_od = surface.vegetation_optical_depth[:, jtile][:, None]
            veg_alb = surface.vegetation_sw_albedo[:, jtile, :]
            if veg_alb.shape[-1] != n_sw:
                veg_alb = _expand_sw(setup, veg_alb)
            if ext_sw_air is not None:
                od_air = depth * ext_sw_air
                od_reg = od_air + veg_od
                ssa_reg = (ssa_sw_air * od_air + veg_od * veg_alb) \
                    / torch.clamp(od_reg, min=1e-12)
                g_reg = (g_sw_air * ssa_sw_air * od_air
                         / torch.clamp(ssa_reg * od_reg, min=1e-12))
            else:
                od_reg = veg_od * torch.ones((1, n_sw), dtype=dtype,
                                             device=dev)
                ssa_reg = veg_alb * torch.ones_like(od_reg)
                g_reg = torch.zeros_like(od_reg)
            ssa_reg = torch.clamp(ssa_reg, 0.0, 1.0)
            g1, g2, g3 = sw_gammas(mu0, ssa_reg, g_reg)
            rdif, tdif, rdir, tdirdif, tdirdir = sw_reftrans(
                mu0, od_reg, ssa_reg, g1, g2, g3)
            inv_den = 1.0 / (1.0 - alb_diff[:, ig, :] * rdif)
            alb_dif_r = rdif + tdif ** 2 * alb_diff[:, ig, :] * inv_den
            alb_dir_r = rdir + (tdirdir * alb_dir[:, ig, :]
                                + tdirdif * alb_diff[:, ig, :]) \
                * tdif * inv_den
            sw_albedo = sw_albedo + frac * alb_dif_r
            sw_albedo_dir = sw_albedo_dir + frac * alb_dir_r
            for k, v in (("sw_ref_dif", rdif), ("sw_tra_dif", tdif),
                         ("sw_ref_dir", rdir), ("sw_tra_dir_dif", tdirdif),
                         ("sw_tra_dir_dir", tdirdir),
                         ("sw_albedo_diffuse_reg", alb_dif_r),
                         ("sw_albedo_direct_reg", alb_dir_r)):
                reg[k][:, ir, :] = v

            # LW
            veg_emiss = surface.vegetation_lw_emissivity[:, jtile, :]
            if veg_emiss.shape[-1] != n_lw:
                veg_emiss = _expand_lw(setup, veg_emiss)
            if ext_lw_air is not None:
                od_reg_lw = depth * ext_lw_air + veg_od
                ssa_reg_lw = veg_od * (1.0 - veg_emiss) \
                    / torch.clamp(od_reg_lw, min=1e-12)
            else:
                od_reg_lw = veg_od * torch.ones((1, n_lw), dtype=dtype,
                                                device=dev)
                ssa_reg_lw = 1.0 - veg_emiss
            pl_canopy = planck_canopy_t[:, jtile, :]
            g1l, g2l = lw_gammas(torch.clamp(ssa_reg_lw, 0.0, 1.0),
                                 torch.zeros_like(ssa_reg_lw))
            ref_l, tra_l, src_l = lw_reftrans_isothermal(
                od_reg_lw, g1l, g2l, pl_canopy)
            inv_den_lw = 1.0 / (1.0 - (1.0 - emiss[:, ig, :]) * ref_l)
            lw_emissivity = lw_emissivity + frac * (
                1.0 - (ref_l + tra_l ** 2 * (1.0 - emiss[:, ig, :])
                       * inv_den_lw))
            lw_emission = lw_emission + frac * (
                src_l * (1.0 + inv_den_lw * (1.0 - emiss[:, ig, :]) * tra_l)
                + planck_facet[:, ig, :] * emiss[:, ig, :] * tra_l
                * inv_den_lw)
            for k, v in (("lw_reflectance", ref_l),
                         ("lw_transmittance", tra_l), ("lw_source", src_l),
                         ("planck_region", pl_canopy)):
                reg[k][:, ir, :] = v
            continue

        # ITileUrban3D: a SPARTACUS-style street canyon
        iw, irf = wall_i[jtile], roof_i[jtile]
        bfrac = surface.building_fraction[:, jtile][:, None]
        bperim = surface.building_normalized_perimeter[:, jtile][:, None]
        canyon = torch.clamp(1.0 - bfrac, min=1.0e-6)
        fdiff = 0.5 * bperim / canyon
        tan_sza = torch.sqrt(torch.clamp(1.0 / (mu0 * mu0) - 1.0, min=0.0))
        fdir = bperim * tan_sza / (math.pi * canyon)

        # SW: the wall exchange rates folded into a z-coordinate
        # two-stream (radsurf_intermediate.F90:478-528)
        if ext_sw_air is not None:
            ext_r, ssa_r, g_r = ext_sw_air, ssa_sw_air, g_sw_air
        else:
            ext_r = ssa_r = g_r = zeros(ncol, n_sw)
        g1, g2, g3 = sw_gammas(mu0, ssa_r, g_r)
        wall_dif = fdiff * (1.0 - alb_diff[:, iw, :])
        wall_abs_frac_dif = wall_dif / torch.clamp(
            ext_r * (g1 - g2) + wall_dif, min=1.0e-8)
        gamma0 = ext_r / mu0 + fdir
        gamma1 = ext_r * g1 + fdiff * (1.0 - 0.5 * alb_diff[:, iw, :])
        gamma2 = ext_r * g2 + fdiff * 0.5 * alb_diff[:, iw, :]
        gamma3 = ext_r * ssa_r * g3 + 0.5 * fdir * alb_dir[:, iw, :]
        # the reference passes gamma3 as both gamma3 and gamma4
        # (radsurf_intermediate.F90:513-515), and so does the JAX package
        rdif, tdif, rdir, tdirdif, tdirdir = sw_reftrans_z(
            mu0, depth, gamma0, gamma1, gamma2, gamma3, gamma3)
        rdif, tdif, rdir, tdirdif = (torch.clamp(x, 0.0, 1.0)
                                     for x in (rdif, tdif, rdir, tdirdif))
        wall_abs_dir = ((1.0 - tdirdir) * fdir
                        * (1.0 - alb_dir[:, iw, :]) * mu0
                        / torch.clamp(fdir * mu0 + ext_r, min=1.0e-8))
        air_abs_dir = ((1.0 - tdirdir) * ext_r * (1.0 - ssa_r)
                       / torch.clamp(fdir * mu0 + ext_r, min=1.0e-8))
        # the roof, then the canyon by single-layer adding
        sw_albedo = sw_albedo + frac * bfrac * alb_diff[:, irf, :]
        sw_albedo_dir = sw_albedo_dir + frac * bfrac * alb_dir[:, irf, :]
        inv_den = 1.0 / (1.0 - alb_diff[:, ig, :] * rdif)
        alb_dif_r = rdif + tdif ** 2 * alb_diff[:, ig, :] * inv_den
        alb_dir_r = rdir + (tdirdir * alb_dir[:, ig, :]
                            + tdirdif * alb_diff[:, ig, :]) * tdif * inv_den
        sw_albedo = sw_albedo + frac * canyon * alb_dif_r
        sw_albedo_dir = sw_albedo_dir + frac * canyon * alb_dir_r
        for k, v in (("sw_ref_dif", rdif), ("sw_tra_dif", tdif),
                     ("sw_ref_dir", rdir), ("sw_tra_dir_dif", tdirdif),
                     ("sw_tra_dir_dir", tdirdir),
                     ("sw_wall_abs_dir", wall_abs_dir),
                     ("sw_air_abs_dir", air_abs_dir),
                     ("sw_wall_abs_frac_dif", wall_abs_frac_dif),
                     ("sw_albedo_diffuse_reg", alb_dif_r),
                     ("sw_albedo_direct_reg", alb_dir_r)):
            reg[k][:, ir, :] = v

        # LW: the canyon as an isothermal layer whose walls have the
        # optical depth of the Harman et al. (2004) street-to-sky
        # transmittance (radsurf_intermediate.F90:816-823)
        hw = 0.5 * bperim * depth / canyon
        od_wall = -torch.log(torch.sqrt(hw * hw + 1.0) - hw) / LW_DIFFUSIVITY
        wall_emis_tot = (LW_DIFFUSIVITY * od_wall * emiss[:, iw, :]
                         * planck_facet[:, iw, :])
        if ext_lw_air is not None:
            od_air_lw = ext_lw_air * depth
            od_reg_lw = od_air_lw + od_wall
            ssa_reg_lw = od_wall * (1.0 - emiss[:, iw, :]) \
                / torch.clamp(od_reg_lw, min=1.0e-6)
            can_emis_tot = (LW_DIFFUSIVITY * od_air_lw
                            * planck_canopy_t[:, jtile, :])
            pl_canopy = (wall_emis_tot + can_emis_tot) / torch.clamp(
                od_reg_lw * (1.0 - ssa_reg_lw) * LW_DIFFUSIVITY, min=1.0e-6)
            wall_abs_frac = od_wall * emiss[:, iw, :] / torch.clamp(
                od_reg_lw * (1.0 - ssa_reg_lw), min=1.0e-6)
        else:
            od_reg_lw = od_wall * torch.ones((1, n_lw), dtype=dtype,
                                             device=dev)
            ssa_reg_lw = 1.0 - emiss[:, iw, :]
            wall_abs_frac = torch.ones((ncol, n_lw), dtype=dtype,
                                       device=dev)
            can_emis_tot = zeros(ncol, n_lw)
            pl_canopy = planck_facet[:, iw, :]
        g1l, g2l = lw_gammas(torch.clamp(ssa_reg_lw, 0.0, 1.0),
                             torch.zeros_like(ssa_reg_lw))
        ref_l, tra_l, src_l = lw_reftrans_isothermal(
            od_reg_lw, g1l, g2l, pl_canopy)
        lw_emissivity = lw_emissivity + frac * bfrac * emiss[:, irf, :]
        lw_emission = lw_emission + frac * bfrac * (
            emiss[:, irf, :] * planck_facet[:, irf, :])
        inv_den_lw = 1.0 / (1.0 - (1.0 - emiss[:, ig, :]) * ref_l)
        emiss_region = 1.0 - (ref_l + tra_l ** 2 * (1.0 - emiss[:, ig, :])
                              * inv_den_lw)
        emission_region = (
            src_l * (1.0 + inv_den_lw * (1.0 - emiss[:, ig, :]) * tra_l)
            + planck_facet[:, ig, :] * emiss[:, ig, :] * tra_l * inv_den_lw)
        lw_emissivity = lw_emissivity + frac * canyon * emiss_region
        lw_emission = lw_emission + frac * canyon * emission_region
        for k, v in (("lw_reflectance", ref_l), ("lw_transmittance", tra_l),
                     ("lw_source", src_l),
                     ("lw_wall_abs_frac", wall_abs_frac),
                     ("lw_total_wall_emission", wall_emis_tot),
                     ("lw_total_canopy_emission", can_emis_tot),
                     ("planck_region", pl_canopy)):
            reg[k][:, ir, :] = v

    return BoundaryConditions(
        sw_albedo_diffuse=torch.clamp(sw_albedo, 0.0, 1.0),
        sw_albedo_direct=torch.clamp(sw_albedo_dir, 0.0, 1.0),
        lw_emissivity=torch.clamp(lw_emissivity, 0.0, 1.0),
        lw_emission=lw_emission,
        intermediate=SurfaceIntermediate(
            planck_facet=planck_facet, lw_emissivity=emiss,
            sw_albedo_direct=alb_dir, sw_albedo_diffuse=alb_diff, **reg))


def partition_fluxes(surface: SurfaceDescription,
                     inter: SurfaceIntermediate, flux) -> SurfaceFlux:
    """The canopy-top downwelling fluxes spread onto the facets
    (radsurf_intermediate.F90:1042-1314). `flux` carries the canopy-top
    fields lw_dn_surf_canopy, sw_dn_diffuse_surf_canopy and
    sw_dn_direct_surf_canopy and the broadband profiles, surface last
    (TOA-first levels, as radiation() returns them before the driver
    flips a height-increasing input back)."""
    ncol, nfacet, ntile = surface.ncol, surface.nfacet, surface.ntile
    dtype = inter.sw_albedo_diffuse.dtype
    dev = inter.sw_albedo_diffuse.device
    zeros = lambda n: torch.zeros((ncol, n), dtype=dtype,  # noqa: E731
                                  device=dev)
    lw_dn_f, lw_up_f, lw_abs_c = zeros(nfacet), zeros(nfacet), zeros(ntile)
    sw_dn_f, sw_dn_dir_f = zeros(nfacet), zeros(nfacet)
    sw_up_f, sw_abs_c = zeros(nfacet), zeros(ntile)
    ground_i, roof_i, wall_i, region_i = surface.indices()

    surf = lambda x: None if x is None else x[:, -1]      # noqa: E731
    lw_dn_surf, lw_up_surf = surf(flux.lw_dn), surf(flux.lw_up)
    sw_dn_surf, sw_up_surf = surf(flux.sw_dn), surf(flux.sw_up)
    sw_dn_dir_surf = surf(flux.sw_dn_direct)
    lw_dn_can = flux.lw_dn_surf_canopy                 # (ncol, nlw)
    sw_dn_dif_can = flux.sw_dn_diffuse_surf_canopy
    sw_dn_dir_can = flux.sw_dn_direct_surf_canopy
    do_lw, do_sw = lw_dn_can is not None, sw_dn_dif_can is not None
    emiss, planck = inter.lw_emissivity, inter.planck_facet
    alb_dif, alb_dir = inter.sw_albedo_diffuse, inter.sw_albedo_direct

    for jtile, rep in enumerate(surface.representation):
        ig = ground_i[jtile]
        if rep == ITileFlat:
            if do_lw:
                lw_dn_f[:, ig] = lw_dn_surf
                lw_up_f[:, ig] = (emiss[:, ig, :] * planck[:, ig, :]
                                  + (1.0 - emiss[:, ig, :]) * lw_dn_can
                                  ).sum(-1)
            if do_sw:
                sw_dn_f[:, ig] = sw_dn_surf
                sw_dn_dir_f[:, ig] = sw_dn_dir_surf
                sw_up_f[:, ig] = (alb_dif[:, ig, :] * sw_dn_dif_can
                                  + alb_dir[:, ig, :] * sw_dn_dir_can
                                  ).sum(-1)
            continue

        ir = region_i[jtile]
        if do_lw:
            # downwelling below the canopy at each spectral point
            lw_dn_g = ((inter.lw_transmittance[:, ir, :] * lw_dn_can
                        + inter.lw_reflectance[:, ir, :] * emiss[:, ig, :]
                        * planck[:, ig, :]
                        + inter.lw_source[:, ir, :])
                       / (1.0 - (1.0 - emiss[:, ig, :])
                          * inter.lw_reflectance[:, ir, :]))
            lw_up_g = ((1.0 - emiss[:, ig, :]) * lw_dn_g
                       + emiss[:, ig, :] * planck[:, ig, :])
            lw_dn_f[:, ig] = lw_dn_g.sum(-1)
            lw_up_f[:, ig] = lw_up_g.sum(-1)
        if do_sw:
            sw_dn_direct_g = inter.sw_tra_dir_dir[:, ir, :] * sw_dn_dir_can
            sw_up_g = sw_dn_direct_g * alb_dir[:, ig, :]
            sw_dn_diffuse_g = ((inter.sw_tra_dif[:, ir, :] * sw_dn_dif_can
                                + inter.sw_ref_dif[:, ir, :] * sw_up_g
                                + inter.sw_tra_dir_dif[:, ir, :]
                                * sw_dn_dir_can)
                               / (1.0 - alb_dif[:, ig, :]
                                  * inter.sw_ref_dif[:, ir, :]))
            sw_up_g = sw_up_g + sw_dn_diffuse_g * alb_dif[:, ig, :]
            sw_dn_dir_f[:, ig] = sw_dn_direct_g.sum(-1)
            sw_dn_f[:, ig] = sw_dn_direct_g.sum(-1) + sw_dn_diffuse_g.sum(-1)
            sw_up_f[:, ig] = sw_up_g.sum(-1)

        if rep == ITileVegetation:
            if do_lw:
                lw_abs_c[:, jtile] = (lw_dn_surf - lw_up_surf
                                      - lw_dn_f[:, ig] + lw_up_f[:, ig])
            if do_sw:
                sw_abs_c[:, jtile] = (sw_dn_surf - sw_up_surf
                                      - sw_dn_f[:, ig] + sw_up_f[:, ig])
            continue

        # Urban3D: the roof and wall fluxes
        irf, iw = roof_i[jtile], wall_i[jtile]
        wall_scaling = (1.0 - surface.building_fraction[:, jtile]) \
            / torch.clamp(surface.building_normalized_perimeter[:, jtile]
                          * surface.canopy_depth[:, jtile], min=1.0e-4)
        if do_sw:
            sw_dn_f[:, irf] = sw_dn_surf
            sw_dn_dir_f[:, irf] = sw_dn_dir_surf
            sw_up_f[:, irf] = (alb_dif[:, irf, :] * sw_dn_dif_can
                               + alb_dir[:, irf, :] * sw_dn_dir_can).sum(-1)
            # the wall's direct interception
            denom_dir = torch.clamp(1.0 - alb_dir[:, iw, :], min=1e-6)
            sw_abs_g = sw_dn_dir_can * inter.sw_wall_abs_dir[:, ir, :]
            sw_dn_dir_f[:, iw] = wall_scaling * (sw_abs_g / denom_dir).sum(-1)
            sw_up_f[:, iw] = wall_scaling * (
                sw_abs_g * alb_dir[:, iw, :] / denom_dir).sum(-1)
            sw_abs_c[:, jtile] = (sw_dn_dir_can
                                  * inter.sw_air_abs_dir[:, ir, :]).sum(-1)
            # diffuse absorption within the canyon
            sw_abs_dif_g = (
                sw_dn_dir_can * (1.0 - inter.sw_albedo_direct_reg[:, ir, :])
                + sw_dn_dif_can
                * (1.0 - inter.sw_albedo_diffuse_reg[:, ir, :])
                - sw_dn_direct_g - sw_dn_diffuse_g + sw_up_g - sw_abs_g)
            wall_frac = inter.sw_wall_abs_frac_dif[:, ir, :]
            sw_abs_c[:, jtile] += (sw_abs_dif_g * (1.0 - wall_frac)).sum(-1)
            denom_dif = torch.clamp(1.0 - alb_dif[:, iw, :], min=1e-6)
            sw_up_f[:, iw] += wall_scaling * (
                sw_abs_dif_g * wall_frac * alb_dif[:, iw, :]
                / denom_dif).sum(-1)
            sw_dn_f[:, iw] = sw_dn_dir_f[:, iw] + wall_scaling * (
                sw_abs_dif_g * wall_frac / denom_dif).sum(-1)
        if do_lw:
            lw_dn_f[:, irf] = lw_dn_surf
            lw_up_f[:, irf] = (emiss[:, irf, :] * planck[:, irf, :]
                               + (1.0 - emiss[:, irf, :]) * lw_dn_can
                               ).sum(-1)
            lw_abs_g = ((lw_dn_can + lw_up_g)
                        * (1.0 - inter.lw_reflectance[:, ir, :]
                           - inter.lw_transmittance[:, ir, :])
                        + inter.lw_total_wall_emission[:, ir, :]
                        + inter.lw_total_canopy_emission[:, ir, :]
                        - 2.0 * inter.lw_source[:, ir, :])
            wall_emiss = torch.clamp(emiss[:, iw, :], min=1e-6)
            lw_dn_f[:, iw] = wall_scaling * (
                inter.lw_wall_abs_frac[:, ir, :] * lw_abs_g
                / wall_emiss).sum(-1)
            lw_up_f[:, iw] = lw_dn_f[:, iw] + wall_scaling * (
                inter.lw_total_wall_emission[:, ir, :]
                - inter.lw_wall_abs_frac[:, ir, :] * lw_abs_g).sum(-1)
            lw_abs_c[:, jtile] = (
                lw_abs_g * (1.0 - inter.lw_wall_abs_frac[:, ir, :])
                - inter.lw_total_canopy_emission[:, ir, :]).sum(-1)

    lw = lambda x: x if do_lw else None                   # noqa: E731
    sw = lambda x: x if do_sw else None                   # noqa: E731
    return SurfaceFlux(
        lw_dn_facet=lw(lw_dn_f), lw_up_facet=lw(lw_up_f),
        lw_abs_canopy=lw(lw_abs_c), sw_dn_facet=sw(sw_dn_f),
        sw_dn_direct_facet=sw(sw_dn_dir_f), sw_up_facet=sw(sw_up_f),
        sw_abs_canopy=sw(sw_abs_c))
