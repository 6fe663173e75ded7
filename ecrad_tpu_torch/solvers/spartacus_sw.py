"""SPARTACUS shortwave solver: 3D radiative transfer through the region-
coupled two-stream equations.

Port of ecrad_tpu/solvers/spartacus_sw.py:49-115 (geometry), :123-310
(the solver) and :475-503 (`_sw_finish`) (radiation_spartacus_sw.F90):
cloud edge lengths from the inverse effective sizes, lateral transfer
rates for the direct and diffuse streams, per-region optical properties,
the per-layer reflectance/transmittance matrices (kernel B6,
ops/spartacus_reftrans.py), the upward total-albedo accumulation with
entrapment and the downward flux pass (kernel B8, ops/spartacus_adding.py),
and the clear sky by the ICA adding (kernel B3). State is g-first, (nlev,
[nreg,] ng, ncol); the g-points are in the SPARTACUS order
(`band_from_g` is setup.maps.band_sw). The per-(g, column)
3D mask `use3d` stands for the reference's per-layer ng3D prefix: a cell
takes the matrix exponential where its layer has cloud edges, its gas
optical depth is at most max_gas_od_3d and the sun is up, and the
Meador-Weaver terms elsewhere.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PdfShape, RadiationConfig
from ..ops.spartacus_adding import (pack_cols, sw_adding_sweeps,
                                    sw_adding_sweeps_plain)
from ..ops.spartacus_reftrans import _diag_g, sw_reftrans_levels
from ..utils import hooks
from . import two_stream as ts
from .adding import adding_sw
from .cloudless import SwFluxes, _gf
from .matrix import mv_gu
from .tripleclouds import calc_overlap_matrices, calc_region_properties

FOUR_OVER_PI = 4.0 / np.pi
R_OVER_G = 287.0 / 9.80665
MIN_MU0_3D = 0.06
# tan of the effective diffuse zenith angle (diffusivity 2)
TAN_DIFFUSE_ANGLE_3D = float(np.sqrt(3.0))
EPS_FRAC = 1.2e-7


def _zeros(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def edge_length(cfg: RadiationConfig, cloud, reg_fracs):
    """Cloud edge length per interface type, (ncol, nlev, 3)
    (radiation_spartacus_sw.F90:434-478)."""
    inv_size = torch.clamp(cloud.inv_cloud_effective_size,
                           max=1.0 / cfg.min_cloud_effective_size)
    f1 = reg_fracs[:, :, 0]
    e1 = FOUR_OVER_PI * f1 * (1.0 - f1) * inv_size
    inv_inhom = inv_size
    if cloud.inv_inhom_effective_size is not None:
        inv_inhom = torch.clamp(cloud.inv_inhom_effective_size,
                                max=1.0 / cfg.min_cloud_effective_size)
    # the last region (the JAX package's index 2 clamps to it with two)
    f3 = reg_fracs[:, :, min(2, reg_fracs.shape[-1] - 1)]
    e2 = FOUR_OVER_PI * f3 * (1.0 - f3) * inv_inhom
    if cfg.clear_to_thick_fraction > 0.0:
        e3 = cfg.clear_to_thick_fraction * torch.minimum(e1, e2)
        e1, e2 = e1 - e3, e2 - e3
    else:
        e3 = torch.zeros_like(e1)
    active = cloud.inv_cloud_effective_size > 0.0
    return torch.stack([torch.where(active, e, _zeros(e))
                        for e in (e1, e2, e3)], -1)


def layer_depth(thermo):
    """Hydrostatic layer depth (m), (ncol, nlev)."""
    p, t = thermo.pressure_hl, thermo.temperature_hl
    return (R_OVER_G * (p[:, 1:] - p[:, :-1]) * (t[:, :-1] + t[:, 1:])
            / torch.clamp(p[:, :-1] + p[:, 1:], min=1e-3))


def transfer_rates(cfg, reg_fracs, edge_len, dz, tan_angle, has_3d):
    """Lateral transfer rates, (nlev, nreg, nreg, ncol) g-first
    (radiation_spartacus_sw.F90:560-600): tan_angle a float or (ncol, 1);
    zero outside the layers with 3D transfer (has_3d (ncol, nlev))."""
    ncol, nlev, nreg = reg_fracs.shape
    tr = reg_fracs.new_zeros((ncol, nlev, nreg, nreg))
    zero = _zeros(dz)

    def rate(base, f, ok=True):
        return torch.where((f > EPS_FRAC) & ok,
                           base / torch.clamp(f, min=EPS_FRAC), zero)

    for j in range(nreg - 1):
        base = dz * edge_len[:, :, j] * tan_angle
        tr[:, :, j, j + 1] = rate(base, reg_fracs[:, :, j])
        tr[:, :, j + 1, j] = rate(base, reg_fracs[:, :, j + 1])
    if nreg == 3:
        # the clear <-> thick interface
        base3 = dz * edge_len[:, :, 2] * tan_angle
        has3 = edge_len[:, :, 2] > 0.0
        tr[:, :, 0, 2] = rate(base3, reg_fracs[:, :, 0], has3)
        tr[:, :, 2, 0] = rate(base3, reg_fracs[:, :, 2], has3)
    tr = torch.clamp(tr, max=cfg.max_3d_transfer_rate)
    tr = torch.where(has_3d[:, :, None, None], tr, zero)
    return tr.permute(1, 2, 3, 0).contiguous()


def geometry(cfg, cloud, reg_fracs, thermo):
    """(dz, edge_len, cloudy, has_3d): layer depths, edge lengths (zero
    without effective sizes or 3D effects), cloudy layers and the layers
    with 3D transfer, each (ncol, nlev[, 3])."""
    ncol, nlev = cloud.fraction.shape
    dz = layer_depth(thermo)
    if cloud.inv_cloud_effective_size is not None and cfg.do_3d_effects:
        edge_len = edge_length(cfg, cloud, reg_fracs)
    else:
        edge_len = dz.new_zeros((ncol, nlev, 3))
    cloudy = cloud.fraction > 0.0
    return dz, edge_len, cloudy, cloudy & (edge_len[:, :, 0] > 0.0)


def regions_and_overlap(cfg, cloud):
    reg_fracs, od_scaling = calc_region_properties(
        cfg.nregions, cfg.i_cloud_pdf_shape == PdfShape.GAMMA,
        cloud.fraction, cloud.fractional_std, cfg.cloud_fraction_threshold)
    u, v, tcc = calc_overlap_matrices(
        reg_fracs, cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
        cfg.cloud_fraction_threshold, cfg.use_beta_overlap)
    # (nlev+1, nreg, nreg, ncol)
    return (reg_fracs, od_scaling, u.permute(1, 2, 3, 0).contiguous(),
            v.permute(1, 2, 3, 0).contiguous(), tcc)


def shift_down(x, first):
    """x (ncol, nlev, ...) moved one level down, `first` on top: the
    values of the layer above each layer."""
    return torch.cat([first, x[:, :-1]], 1)


def solver_spartacus_sw(cfg: RadiationConfig, band_from_g, cos_sza, thermo,
                        cloud, od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                        incoming_sw, albedo_diffuse, albedo_direct):
    """od/ssa/g (ncol, nlev, ng); cloud properties (ncol, nlev, nbands);
    incoming_sw and albedos (ncol, ng); cos_sza (ncol,). Returns (total
    SwFluxes, clear SwFluxes, cloud_cover (ncol,), extras): extras holds
    with do_print_entrapment_data the entrapment internals of the first
    g-point, (x_direct, x_diffuse, direct_dn, flux_dn) each (nlev, nreg,
    ncol), from the plain sweeps on that g-point alone; the fluxes still
    come from sw_adding_sweeps (kernel B8 on the GPU)."""
    ncol, nlev, ng = od.shape
    nreg = cfg.nregions
    mu0 = torch.clamp(cos_sza, min=1e-10)
    one_over_mu0 = 1.0 / mu0
    tan_sza = torch.where(
        mu0 < MIN_MU0_3D,
        torch.full_like(mu0, math.sqrt(1.0 / (MIN_MU0_3D * MIN_MU0_3D)
                                       - 1.0)),
        torch.where(one_over_mu0 > 1.0,
                    torch.sqrt(torch.clamp(one_over_mu0 ** 2 - 1.0
                                           + cfg.overhead_sun_factor,
                                           min=0.0)),
                    torch.sqrt(torch.full_like(mu0,
                                               cfg.overhead_sun_factor))))
    reg_fracs, od_scaling, um, vm, tcc = regions_and_overlap(cfg, cloud)
    dz, edge_len, cloudy, has_3d = geometry(cfg, cloud, reg_fracs, thermo)
    trd = transfer_rates(cfg, reg_fracs, edge_len, dz, tan_sza[:, None],
                         has_3d)
    trf = transfer_rates(cfg, reg_fracs, edge_len, dz, TAN_DIFFUSE_ANGLE_3D,
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
        scat = ssa_g * od_g + ssac * odc_r
        ssa_t = torch.where(od_sum > 0, scat / torch.clamp(od_sum, min=1e-30),
                            zero)
        g_t = torch.where(scat > 0, (g_g * ssa_g * od_g + gc * ssac * odc_r)
                          / torch.clamp(scat, min=1e-30), zero)
        od_l.append(torch.where(cmask, torch.clamp(od_sum,
                                                   max=cfg.max_cloud_od),
                                od_g))
        ssa_l.append(torch.where(cmask, ssa_t, ssa_g))
        g_l.append(torch.where(cmask, g_t, g_g))
    od_r, ssa_r, g_r = (torch.stack(x, 1) for x in (od_l, ssa_l, g_l))

    # the 3D mask, (nlev, ng, ncol): sub-horizon columns are left out as
    # the reference's early cycle does (radiation_spartacus_sw.F90:360)
    use3d = ((has_3d.T.contiguous()[:, None, :] | cfg.use_expm_everywhere)
             & (od_g <= cfg.max_gas_od_3d)
             & (cos_sza > 1.0e-10)[None, None, :])
    clear_lay = ~cloudy
    hist = sw_reftrans_levels(cfg.max_gas_od_3d, od_r, ssa_r, g_r, trd, trf,
                              mu0, use3d, clear_lay.T.contiguous())

    inv_eff = cloud.inv_cloud_effective_size
    inv_eff_prev = (shift_down(inv_eff, inv_eff[:, :1]) if inv_eff is not None
                    else dz.new_zeros((ncol, nlev)))
    overlap_prev = torch.cat([torch.ones_like(dz[:, :1]),
                              cloud.overlap_param], 1)
    x_layer_diffuse = dz * TAN_DIFFUSE_ANGLE_3D / float(np.sqrt(2.0))
    x_layer_direct = dz * torch.sqrt(tan_sza[:, None] ** 2
                                     + TAN_DIFFUSE_ANGLE_3D ** 2) * 0.5
    true_col = torch.ones_like(clear_lay[:, :1])
    cols = pack_cols(
        um, vm, cloud.fraction.T, dz.T, x_layer_diffuse.T, x_layer_direct.T,
        shift_down(edge_len, edge_len[:, :1]).permute(1, 2, 0),
        inv_eff_prev.T, overlap_prev.T, reg_fracs.permute(1, 2, 0),
        shift_down(reg_fracs, reg_fracs[:, :1]).permute(1, 2, 0),
        clear_lay.T, shift_down(clear_lay, true_col).T,
        torch.cat([clear_lay[:, 1:], true_col], 1).T, tan_sza)
    alb0 = _diag_g(albedo_diffuse.T.expand(nreg, ng, ncol), nreg)
    albdir0 = _diag_g((mu0[None, :] * albedo_direct.T).expand(nreg, ng, ncol),
                      nreg)
    init_up = torch.cat([alb0.reshape(nreg * nreg, ng, ncol),
                         albdir0.reshape(nreg * nreg, ng, ncol)])
    direct0 = (incoming_sw.T[None] * reg_fracs[:, 0].T[:, None, :]
               ).contiguous()
    _, albdir_top, dn = sw_adding_sweeps(cfg, hist, cols, init_up, direct0)
    extras = {}
    if cfg.do_print_entrapment_data:
        g0 = slice(0, 1)
        if hist.device.type != "cpu":
            hooks.plain_on_device("spartacus_entrapment_dump")
        dump = sw_adding_sweeps_plain(cfg, hist[:, :, g0], cols,
                                      init_up[:, g0], direct0[:, g0],
                                      dump=True)[3]
        extras["entrapment_data"] = tuple(x[:, :, 0] for x in dump)
    del hist

    def profile(top, per_level):
        # top (nreg, ng, ncol), per_level (nlev, nreg, ng, ncol)
        return torch.cat([top.sum(0)[None], per_level.sum(1)])

    total = SwFluxes(
        up=profile(mv_gu(albdir_top, direct0), dn[:, :nreg]),
        dn_diffuse=profile(torch.zeros_like(direct0), dn[:, nreg:2 * nreg]),
        dn_direct=profile(direct0, dn[:, 2 * nreg:]) * mu0)

    # the clear sky: the ICA adding on gas and aerosols
    mu0_c = mu0[None, None, :]
    clear = SwFluxes(*adding_sw(
        *ts.sw_reftrans(mu0_c, od_g, ssa_g, *ts.sw_gammas(mu0_c, ssa_g, g_g)),
        incoming_sw.T.contiguous(), albedo_diffuse.T.contiguous(),
        albedo_direct.T.contiguous(), mu0.contiguous()))
    day = (cos_sza > 1.0e-10)[None, None, :]
    total, clear = (SwFluxes(*(torch.where(day, f, zero) for f in x))
                    for x in (total, clear))
    tcc = torch.where(cos_sza > 1.0e-10, tcc, torch.full_like(tcc, -1.0))
    return total, clear, tcc, extras
