"""SPARTACUS longwave solver.

Port of ecrad_tpu/solvers/spartacus_lw.py:40-223 and :313-339
(radiation_spartacus_lw.F90): the 2 nreg two-stream generator with the
lateral exchange scaled by the cloud-side effective emissivity
(:128-146), emission through the particular solution, the per-layer
reflectance/transmittance/source matrices (kernel B7,
ops/spartacus_reftrans.py), the upward albedo/source accumulation and the
downward pass (kernel B9, ops/spartacus_adding.py; the matrix form with
3D effects or multilayer effects on, else the diagonal form), the
matrix-form LW derivatives, and the clear sky (kernel B3' with aerosol
scattering, B3 `lw_noscat` without). State is g-first, in the SPARTACUS g
order (`band_from_g` is setup.maps.band_lw).
"""
from __future__ import annotations

import torch

from ..config import RadiationConfig
from ..ops.spartacus_adding import lw_adding_sweeps, lw_pack_cols
from ..ops.spartacus_reftrans import _diag_g, lw_reftrans_levels
from . import two_stream as ts
from .adding import adding_lw, lw_no_scattering_fluxes
from .cloudless import LwFluxes, _gf
from .lw_derivatives import lw_derivatives_matrix
from .spartacus_sw import (TAN_DIFFUSE_ANGLE_3D, _zeros, geometry,
                           regions_and_overlap, shift_down, transfer_rates)

SIDE_EMISS_THIN = 1.4107


def _side_emissivity(cfg, cloud, reg_fracs, dz, od_r, ssa_r, g_r, has_3d):
    """Cloud-side effective emissivity, (nlev, ng, ncol)
    (radiation_spartacus_lw.F90:636-655)."""
    nreg = reg_fracs.shape[-1]
    inv_size = torch.clamp(cloud.inv_cloud_effective_size,
                           max=1.0 / cfg.min_cloud_effective_size)
    aspect = 1.0 / torch.clamp(inv_size * reg_fracs[:, :, 0] * dz,
                               min=1e-12)                 # (ncol, nlev)
    ssa_c, g_c = ssa_r[:, 1], g_r[:, 1]
    abs_od = (od_r[:, 1:] * (1.0 - ssa_r[:, 1:])).sum(1)
    lateral_od = (aspect.T / (nreg - 1.0))[:, None, :] * abs_od
    s1ms = torch.sqrt(torch.clamp(1.0 - ssa_c, min=0.0))
    thick = 2.0 * s1ms / torch.clamp(
        s1ms + torch.sqrt(torch.clamp(1.0 - ssa_c * g_c, min=0.0)),
        min=1e-12)
    side_emiss = (SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
    active = (has_3d & (reg_fracs[:, :, 0] > 0.0)
              & (reg_fracs[:, :, 1] > 0.0)).T[:, None, :]
    return torch.where(active, side_emiss, torch.ones_like(side_emiss))


def solver_spartacus_lw(cfg: RadiationConfig, band_from_g, thermo, cloud, od,
                        ssa, g, od_cloud, ssa_cloud, g_cloud, planck_hl,
                        emission, albedo):
    """od/ssa/g (ncol, nlev, ng); cloud properties (ncol, nlev, nbands);
    planck_hl (ncol, nlev+1, ng); emission and albedo (ncol, ng). Returns
    (total LwFluxes, clear LwFluxes, cloud_cover (ncol,), extras)."""
    ncol, nlev, ng = od.shape
    nreg = cfg.nregions
    reg_fracs, od_scaling, um, vm, tcc = regions_and_overlap(cfg, cloud)
    dz, edge_len, cloudy, has_3d = geometry(cfg, cloud, reg_fracs, thermo)
    tr = transfer_rates(cfg, reg_fracs, edge_len, dz, TAN_DIFFUSE_ANGLE_3D,
                        has_3d)

    # per-region optical properties, (nlev, nreg, ng, ncol)
    od_g, ssa_g, g_g = _gf(od), _gf(ssa), _gf(g)
    odc, ssac, gc = (_gf(x)[:, band_from_g, :]
                     for x in (od_cloud, ssa_cloud, g_cloud))
    sc_g = od_scaling.permute(1, 2, 0)
    cmask = cloudy.T[:, None, :]
    zero = _zeros(od)
    od_l, ssa_l, g_l = [od_g], [ssa_g], [g_g]
    for r in range(1, nreg):
        odc_r = odc * sc_g[:, r][:, None, :]
        od_sum = od_g + odc_r
        if cfg.do_lw_cloud_scattering:
            scat = ssa_g * od_g + ssac * odc_r
            ssa_t = torch.where(od_sum > 0,
                                scat / torch.clamp(od_sum, min=1e-30), zero)
            g_t = torch.where(scat > 0,
                              (g_g * ssa_g * od_g + gc * ssac * odc_r)
                              / torch.clamp(scat, min=1e-30), zero)
        else:
            ssa_t = g_t = torch.zeros_like(od_sum)
        od_l.append(torch.where(cmask, torch.clamp(od_sum,
                                                   max=cfg.max_cloud_od),
                                od_g))
        ssa_l.append(torch.where(cmask, ssa_t, zero))
        g_l.append(torch.where(cmask, g_t, zero))
    od_r, ssa_r, g_r = (torch.stack(x, 1) for x in (od_l, ssa_l, g_l))

    if (cfg.do_lw_side_emissivity and cfg.do_3d_effects
            and cloud.inv_cloud_effective_size is not None):
        se = _side_emissivity(cfg, cloud, reg_fracs, dz, od_r, ssa_r, g_r,
                              has_3d)
    else:
        se = torch.ones_like(od_g)
    planck_g = _gf(planck_hl)
    planck_top, planck_bot = planck_g[:-1], planck_g[1:]
    use3d = ((has_3d.T.contiguous()[:, None, :] | cfg.use_expm_everywhere)
             & (od_g <= cfg.max_gas_od_3d))
    clear_lay = ~cloudy
    hist = lw_reftrans_levels(
        cfg.max_gas_od_3d, cfg.do_lw_cloud_scattering, od_r, ssa_r, g_r, tr,
        se.contiguous(), planck_top.contiguous(), planck_bot.contiguous(),
        reg_fracs.permute(1, 2, 0).contiguous(), use3d,
        clear_lay.T.contiguous())
    del od_r, ssa_r, g_r, se

    true_col = torch.ones_like(clear_lay[:, :1])
    cols = lw_pack_cols(um, vm, clear_lay.T,
                        shift_down(clear_lay, true_col).T,
                        torch.cat([clear_lay[:, 1:], true_col], 1).T)
    alb0 = _diag_g(albedo.T.expand(nreg, ng, ncol), nreg)
    src0 = emission.T[None] * reg_fracs[:, -1].T[:, None, :]
    init_up = torch.cat([alb0.reshape(nreg * nreg, ng, ncol), src0])
    use_matrix = cfg.do_3d_effects or cfg.do_3d_lw_multilayer_effects
    src_top, dn = lw_adding_sweeps(cfg, use_matrix, hist, cols, init_up)
    up = torch.cat([src_top.sum(0)[None], dn[:, :nreg].sum(1)])
    total = LwFluxes(up=up, dn=torch.cat([torch.zeros_like(up[:1]),
                                          dn[:, nreg:].sum(1)]))
    extras = {}
    if cfg.do_lw_derivatives:
        # the matrix form (radiation_spartacus_lw.F90:1057-1066) on the
        # layers' transmittance matrices, rows nreg^2 .. 2 nreg^2 of hist
        trans = hist[:, nreg * nreg:2 * nreg * nreg].reshape(
            nlev, nreg, nreg, ng, ncol)
        extras["lw_derivatives"] = lw_derivatives_matrix(trans, um,
                                                         up[-1].T)
    del hist

    # the clear sky: scattering follows do_lw_aerosol_scattering
    emis_g, alb_g = emission.T.contiguous(), albedo.T.contiguous()
    if cfg.do_lw_aerosol_scattering:
        up_c, dn_c = adding_lw(*ts.lw_reftrans(
            od_g, *ts.lw_gammas(ssa_g, g_g), planck_top, planck_bot),
            emis_g, alb_g)
    else:
        up_c, dn_c = lw_no_scattering_fluxes(
            *ts.lw_no_scattering_transmittance(od_g, planck_top, planck_bot),
            emis_g, alb_g)
    return total, LwFluxes(up=up_c, dn=dn_c), tcc, extras
