"""Tripleclouds solvers: one clear and one or two cloudy regions per layer.

Port of ecrad_tpu/solvers/tripleclouds.py:47-576:
  - region fractions and optical-depth scalings (radiation_regions.F90:
    35-199; gamma or lognormal, 2 or 3 regions);
  - the directional overlap matrices U and V per interface
    (radiation_overlap.F90:64-632; alpha or beta overlap);
  - the SW and LW solvers (radiation_tripleclouds_sw.F90:100-608,
    radiation_tripleclouds_lw.F90): per-region layer optics, an upward
    sweep of albedos (and LW sources) mixed through V (U) at interfaces,
    then a downward sweep of fluxes mixed through V, skipping the mixing
    where a layer and its neighbour are both clear. The clear sky is the
    ICA adding on gas and aerosols.

State layout: region-leading g-first, (nlev, nreg, ng, ncol). The two
sweeps are kernel B5 (ops/adding_fused.py `tc_sw_sweeps_fused`,
`tc_lw_sweeps_fused`, csrc/tc_sweeps.cu) on CUDA tensors and their plain
versions `tc_sw_sweeps_plain`/`tc_lw_sweeps_plain` here on CPU tensors.
Both return the region-summed profiles the solver needs, summed in region
order, and write the 3x3 mixing as an explicit left-to-right sum
(ecrad_tpu/solvers/matrix.py:147-156 `mv_gu`).

As in the JAX package, a layer counts as clear for the sweeps where its
cloud fraction is 0 (`fraction > 0`), while the region split uses
`fraction >= cloud_fraction_threshold`.
"""
from __future__ import annotations

import torch

from ..config import PdfShape, RadiationConfig
from ..ops import adding_fused
from ..optics.cloud import delta_eddington
from ..utils import hooks
from . import two_stream as ts
from .adding import adding_lw, adding_sw, lw_no_scattering_fluxes
from .cloud_cover import beta2alpha
from .cloudless import LwFluxes, SwFluxes, _gf, daylight
from .lw_derivatives import lw_derivatives_region

# radiation_regions.F90 constants
MIN_GAMMA_OD_SCALING = 0.025
MIN_LOWER_FRAC = 0.5
MAX_LOWER_FRAC = 0.9
FSD_AT_MIN = 1.5
FSD_AT_MAX = 3.725
LOWER_FRAC_GRAD = (MAX_LOWER_FRAC - MIN_LOWER_FRAC) / (FSD_AT_MAX
                                                       - FSD_AT_MIN)
LOWER_FRAC_INTERCEPT = MIN_LOWER_FRAC - FSD_AT_MIN * LOWER_FRAC_GRAD


def calc_region_properties(nreg: int, do_gamma: bool, cloud_fraction,
                           frac_std, frac_threshold=1.0e-20):
    """Region fractions and optical-depth scalings
    (radiation_regions.F90:35-199). cloud_fraction, frac_std (ncol,
    nlev). Returns (reg_fracs, od_scaling), each (ncol, nlev, nreg), the
    clear region's scaling 1."""
    cf, fsd = cloud_fraction, frac_std
    one = torch.ones_like(cf)
    if nreg == 2:
        return torch.stack([1.0 - cf, cf], -1), torch.stack([one, one], -1)
    if nreg != 3:
        raise ValueError("Tripleclouds takes 2 or 3 regions")
    if do_gamma:
        f2 = cf * torch.clamp(LOWER_FRAC_INTERCEPT + fsd * LOWER_FRAC_GRAD,
                              MIN_LOWER_FRAC, MAX_LOWER_FRAC)
        s2 = MIN_GAMMA_OD_SCALING + (1.0 - MIN_GAMMA_OD_SCALING) * torch.exp(
            -fsd * (1.0 + 0.5 * fsd * (1.0 + 0.5 * fsd)))
        f3 = cf - f2
        s3 = (cf - f2 * s2) / torch.clamp(f3, min=1e-12)
    else:
        s2 = torch.exp(-torch.sqrt(torch.log(fsd ** 2 + 1.0))) / torch.sqrt(
            fsd ** 2 + 1.0)
        f2 = 0.5 * cf
        f3 = 0.5 * cf
        s3 = 2.0 - s2
    cloudy = cf >= frac_threshold
    zero = torch.zeros_like(cf)
    return (torch.stack([torch.where(cloudy, 1.0 - cf, one),
                         torch.where(cloudy, f2, zero),
                         torch.where(cloudy, f3, zero)], -1),
            torch.stack([one, torch.where(cloudy, s2, one),
                         torch.where(cloudy, s3, one)], -1))


def calc_overlap_matrices(reg_fracs, overlap_param, decorr_scaling,
                          frac_threshold, use_beta=False):
    """Directional overlap matrices per interface
    (radiation_overlap.F90:280-632, alpha form :130). reg_fracs (ncol,
    nlev, nreg), overlap_param (ncol, nlev-1). Returns (u, v, cloud_cover):
    u, v (ncol, nlev+1, nreg, nreg) with u[a, b] = overlap(a above, b
    below) / frac_below(b) and v[a, b] = overlap(b above, a below) /
    frac_above(b); cloud_cover (ncol,)."""
    ncol, nlev, nreg = reg_fracs.shape
    # the boundaries above the top and below the surface are clear
    edge = torch.zeros_like(reg_fracs[:, :1])
    edge[..., 0] = 1.0
    frac_upper = torch.cat([edge, reg_fracs], 1)       # (ncol, nlev+1, nreg)
    frac_lower = torch.cat([reg_fracs, edge], 1)
    ones = torch.ones_like(reg_fracs[:, :1, 0])
    op1 = torch.cat([ones, overlap_param, ones], 1)
    op_inhom = torch.where(op1 >= 0.0, op1 ** (1.0 / decorr_scaling), op1)
    cf_upper = frac_upper[..., 1:].sum(-1)
    cf_lower = frac_lower[..., 1:].sum(-1)
    if use_beta:
        op_eff = beta2alpha(op1, cf_upper, cf_lower)
        opi_eff = beta2alpha(op_inhom, cf_upper, cf_lower)
    else:
        op_eff, opi_eff = op1, op_inhom
    pcc = (op_eff * torch.maximum(cf_upper, cf_lower)
           + (1.0 - op_eff) * (cf_upper + cf_lower - cf_upper * cf_lower))

    m = reg_fracs.new_zeros((ncol, nlev + 1, nreg, nreg))
    m[..., 0, 0] = 1.0 - pcc
    if nreg == 2:
        m[..., 0, 1] = pcc - cf_upper
        m[..., 1, 0] = pcc - cf_lower
        m[..., 1, 1] = cf_upper + cf_lower - pcc
    else:
        inv_low = 1.0 / torch.clamp(cf_lower, min=1e-6)
        inv_up = 1.0 / torch.clamp(cf_upper, min=1e-6)
        m[..., 0, 1] = (pcc - cf_upper) * frac_lower[..., 1] * inv_low
        m[..., 0, 2] = (pcc - cf_upper) * frac_lower[..., 2] * inv_low
        m[..., 1, 0] = (pcc - cf_lower) * frac_upper[..., 1] * inv_up
        m[..., 2, 0] = (pcc - cf_lower) * frac_upper[..., 2] * inv_up
        frac_both = cf_upper + cf_lower - pcc
        cu = frac_upper[..., 2] * inv_up
        clo = frac_lower[..., 2] * inv_low
        pcc2 = (opi_eff * torch.maximum(cu, clo)
                + (1.0 - opi_eff) * (cu + clo - cu * clo))
        m[..., 1, 1] = frac_both * (1.0 - pcc2)
        m[..., 1, 2] = frac_both * (pcc2 - cu)
        m[..., 2, 1] = frac_both * (pcc2 - clo)
        m[..., 2, 2] = frac_both * (cu + clo - pcc2)

    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    fl = frac_lower[:, :, None, :]
    fu = frac_upper[:, :, None, :]
    u = torch.where(fl >= frac_threshold, m / torch.clamp(fl, min=1e-30),
                    zero)
    v = torch.where(fu >= frac_threshold,
                    m.transpose(-1, -2) / torch.clamp(fu, min=1e-30), zero)
    cloud_cover = 1.0 - torch.prod(v[:, :, 0, 0], 1)
    return u, v, cloud_cover


@hooks.hooked("ecrad.layer_optics")
def _region_props_sw_g(od_g, ssa_g, g_g, odc_g, ssac_g, gc_g, sc_g,
                       cmask_g):
    """Per-region SW optical properties, g-first: inputs (nlev, ng, ncol)
    (cloud fields band-expanded), sc_g (nlev, nreg, ncol), cmask_g (nlev,
    1, ncol). Returns (od, ssa, g), each (nlev, nreg, ng, ncol)
    (ecrad_tpu/solvers/tripleclouds.py:156-185)."""
    zero = torch.zeros((), dtype=od_g.dtype, device=od_g.device)
    outs = [[od_g], [ssa_g], [g_g]]
    for r in range(1, sc_g.shape[1]):
        odc_r = odc_g * sc_g[:, r][:, None, :]
        od_t = od_g + odc_r
        scat = ssa_g * od_g + ssac_g * odc_r
        ssa_t = torch.where(od_t > 0, scat / torch.clamp(od_t, min=1e-30),
                            zero)
        g_t = torch.where(scat > 0,
                          (g_g * ssa_g * od_g + gc_g * ssac_g * odc_r)
                          / torch.clamp(scat, min=1e-30), zero)
        for out, x, base in zip(outs, (od_t, ssa_t, g_t), (od_g, ssa_g, g_g)):
            out.append(torch.where(cmask_g, x, base))
    return tuple(torch.stack(o, 1) for o in outs)


# ---- the region sweeps (kernel B5's plain versions) ----

def _mix(m, x, transpose=False):
    """y[i] = sum_j m[i, j] x[j] (m[j, i] with transpose), left to right;
    m (nreg, nreg, ncol) per-column rows, x a list of (ng, ncol)."""
    n = len(x)
    a = (lambda i, j: m[j, i]) if transpose else (lambda i, j: m[i, j])
    out = []
    for i in range(n):
        s = a(i, 0) * x[0]
        for j in range(1, n):
            s = s + a(i, j) * x[j]
        out.append(s)
    return out


def _rsum(x):
    """Region sum in region order."""
    s = x[0]
    for y in x[1:]:
        s = s + y
    return s


def _zero_cloudy(x, is_clear):
    """Zero the cloudy regions where the layer is clear."""
    zero = torch.zeros((), dtype=x[0].dtype, device=x[0].device)
    return [x[0]] + [torch.where(is_clear, zero, y) for y in x[1:]]


def _pick(keep, a, b):
    return [torch.where(keep, x, y) for x, y in zip(a, b)]


def tc_sw_sweeps_plain(ref, trans, ref_dir, tdd, tdir, v_mat, clear,
                       albedo_diffuse, albedo_direct, mu0, incoming,
                       frac_top):
    """The SW region sweeps of solver_tripleclouds_sw
    (ecrad_tpu/solvers/tripleclouds.py:273-347). Layer optics (nlev,
    nreg, ng, ncol); v_mat (nlev+1, nreg, nreg, ncol); clear (nlev, ncol)
    bool; albedos and incoming (ng, ncol); mu0 (ncol,); frac_top (nreg,
    ncol), the top layer's region fractions. Returns (up, dn_diffuse,
    dn_direct), each (nlev+1, ng, ncol), summed over the regions, the
    direct flux scaled by mu0."""
    nlev, nreg = ref.shape[:2]
    lev = lambda x, l: [x[l, r] for r in range(nreg)]
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    # surface albedo in the cloudy regions only below a cloudy layer
    bottom_clear = clear[-1]
    alb_dir = mu0[None, :] * albedo_direct
    alb = [albedo_diffuse] + [torch.where(bottom_clear, zero, albedo_diffuse)
                              for _ in range(1, nreg)]
    albdir = [alb_dir] + [torch.where(bottom_clear, zero, alb_dir)
                          for _ in range(1, nreg)]
    below = [None] * nlev           # (alb, albdir) below each layer
    for l in range(nlev - 1, -1, -1):
        below[l] = (alb, albdir)
        r, t, rd, td, tdl = (lev(x, l) for x in (ref, trans, ref_dir, tdd,
                                                 tdir))
        inv = [1.0 / (1.0 - a * rr) for a, rr in zip(alb, r)]
        alb_b = [rr + tt * tt * a * i for rr, tt, a, i in zip(r, t, alb, inv)]
        albdir_b = [rdd + (tl * ad + tdd_ * a) * tt * i for rdd, tl, ad, tdd_,
                    a, tt, i in zip(rd, tdl, albdir, td, alb, t, inv)]
        alb_b = _zero_cloudy(alb_b, clear[l])
        albdir_b = _zero_cloudy(albdir_b, clear[l])
        both_clear = clear[l] & (clear[l - 1] if l > 0 else True)
        alb = _pick(both_clear, alb_b, _mix(v_mat[l], alb_b, True))
        albdir = _pick(both_clear, albdir_b, _mix(v_mat[l], albdir_b, True))
    direct = [incoming * frac_top[r] for r in range(nreg)]
    fdn = [torch.zeros_like(incoming)] * nreg
    up = [_rsum([d * a for d, a in zip(direct, albdir)])]
    dn_diff = [torch.zeros_like(incoming)]
    dn_dir = [_rsum(direct) * mu0]
    for l in range(nlev):
        alb_b, albdir_b = below[l]
        r, t, rd, td, tdl = (lev(x, l) for x in (ref, trans, ref_dir, tdd,
                                                 tdir))
        inv = [1.0 / (1.0 - rr * a) for rr, a in zip(r, alb_b)]
        fdn_new = [(tt * f + d * (tl * ad * rr + tdd_)) * i for tt, f, d, tl,
                   ad, rr, tdd_, i in zip(t, fdn, direct, tdl, albdir_b, r,
                                          td, inv)]
        ddn_new = [tl * d for tl, d in zip(tdl, direct)]
        fdn_new = _zero_cloudy(fdn_new, clear[l])
        ddn_new = _zero_cloudy(ddn_new, clear[l])
        up.append(_rsum([d * ad + f * a for d, ad, f, a in
                         zip(ddn_new, albdir_b, fdn_new, alb_b)]))
        both_clear = clear[l] & (clear[l + 1] if l + 1 < nlev else True)
        fdn = _pick(both_clear, fdn_new, _mix(v_mat[l + 1], fdn_new))
        direct = _pick(both_clear, ddn_new, _mix(v_mat[l + 1], ddn_new))
        dn_diff.append(_rsum(fdn))
        dn_dir.append(_rsum(direct) * mu0)
    return torch.stack(up), torch.stack(dn_diff), torch.stack(dn_dir)


def tc_lw_sweeps_plain(ref, trans, src_up, src_dn, v_mat, u_mat, clear,
                       emission, albedo, frac_bot):
    """The LW region sweeps of solver_tripleclouds_lw
    (ecrad_tpu/solvers/tripleclouds.py:499-553). Layer optics and
    sources (nlev, nreg, ng, ncol); v_mat (nlev+1, nreg, nreg, ncol);
    u_mat (nlev, nreg, nreg, ncol) (interfaces 0..nlev-1); clear (nlev,
    ncol) bool; emission and albedo (ng, ncol); frac_bot (nreg, ncol), the
    bottom layer's region fractions. Returns (up, dn), each (nlev+1, ng,
    ncol), summed over the regions."""
    nlev, nreg = ref.shape[:2]
    lev = lambda x, l: [x[l, r] for r in range(nreg)]
    alb = [albedo] * nreg
    src = [frac_bot[r] * emission for r in range(nreg)]
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        below[l] = (alb, src)
        r, t, su, sd = (lev(x, l) for x in (ref, trans, src_up, src_dn))
        inv = [1.0 / (1.0 - a * rr) for a, rr in zip(alb, r)]
        alb_b = [rr + tt * tt * a * i for rr, tt, a, i in zip(r, t, alb, inv)]
        src_b = [s_u + tt * (s + a * s_d) * i for s_u, tt, s, a, s_d, i in
                 zip(su, t, src, alb, sd, inv)]
        alb_b = _zero_cloudy(alb_b, clear[l])
        src_b = _zero_cloudy(src_b, clear[l])
        both_clear = clear[l] & (clear[l - 1] if l > 0 else True)
        alb = _pick(both_clear, alb_b, _mix(v_mat[l], alb_b, True))
        src = _pick(both_clear, src_b, _mix(u_mat[l], src_b))
    fdn = [torch.zeros_like(emission)] * nreg
    up = [_rsum(src)]
    dn = [torch.zeros_like(emission)]
    for l in range(nlev):
        alb_b, src_b = below[l]
        r, t, sd = (lev(x, l) for x in (ref, trans, src_dn))
        inv = [1.0 / (1.0 - rr * a) for rr, a in zip(r, alb_b)]
        fdn_new = [(tt * f + rr * s + s_d) * i for tt, f, rr, s, s_d, i in
                   zip(t, fdn, r, src_b, sd, inv)]
        fdn_new = _zero_cloudy(fdn_new, clear[l])
        up.append(_rsum([s + f * a for s, f, a in zip(src_b, fdn_new,
                                                        alb_b)]))
        both_clear = clear[l] & (clear[l + 1] if l + 1 < nlev else True)
        fdn = _pick(both_clear, fdn_new, _mix(v_mat[l + 1], fdn_new))
        dn.append(_rsum(fdn))
    return torch.stack(up), torch.stack(dn)


@hooks.hooked("ecrad.sweeps")
def tc_sw_sweeps(*args):
    """The SW region sweeps: the plain loops on CPU tensors, kernel B5 on
    any other (which raises unless it is CUDA float32)."""
    if args[0].device.type == "cpu":
        return tc_sw_sweeps_plain(*args)
    return adding_fused.tc_sw_sweeps_fused(*args)


@hooks.hooked("ecrad.sweeps")
def tc_lw_sweeps(*args):
    """The LW region sweeps: the plain loops on CPU tensors, kernel B5 on
    any other (which raises unless it is CUDA float32)."""
    if args[0].device.type == "cpu":
        return tc_lw_sweeps_plain(*args)
    return adding_fused.tc_lw_sweeps_fused(*args)


# ---- the solvers ----

@hooks.hooked("ecrad.regions")
def _regions(config: RadiationConfig, cloud):
    """Region fractions and scalings, overlap matrices and cloud cover."""
    reg_fracs, od_scaling = calc_region_properties(
        config.nregions, config.i_cloud_pdf_shape == PdfShape.GAMMA,
        cloud.fraction, cloud.fractional_std, config.cloud_fraction_threshold)
    u, v, tcc = calc_overlap_matrices(
        reg_fracs, cloud.overlap_param, config.cloud_inhom_decorr_scaling,
        config.cloud_fraction_threshold, config.use_beta_overlap)
    return reg_fracs, od_scaling, u, v, tcc


def _gfirst_matrix(m):
    """(ncol, nlev+1, nreg, nreg) -> contiguous (nlev+1, nreg, nreg, ncol)."""
    return m.permute(1, 2, 3, 0).contiguous()


def solver_tripleclouds_sw(config: RadiationConfig, band_from_g, cloud,
                           cos_sza, od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                           incoming_sw, albedo_diffuse, albedo_direct):
    """od/ssa/g (ncol, nlev, ng); cloud properties (ncol, nlev, nbands).
    Returns (total SwFluxes, clear SwFluxes, cloud_cover (ncol,))."""
    mu0 = torch.clamp(cos_sza, min=1e-10)
    reg_fracs, od_scaling, _, v, tcc = _regions(config, cloud)
    b = hooks.upload("tripleclouds", band_from_g, od.device)
    bandx = lambda x: _gf(x)[:, b, :]
    cloudy = cloud.fraction > 0.0
    od_r, ssa_r, g_r = _region_props_sw_g(
        _gf(od), _gf(ssa), _gf(g), bandx(od_cloud), bandx(ssa_cloud),
        bandx(g_cloud), od_scaling.permute(1, 2, 0), cloudy.T[:, None, :])
    if config.do_sw_delta_scaling_with_gases:
        od_r, ssa_r, g_r = delta_eddington(od_r, ssa_r, g_r)
    mu0_b = mu0[None, None, None, :]
    optics = (x.contiguous() for x in ts.sw_reftrans(
        mu0_b, od_r, ssa_r, *ts.sw_gammas(mu0_b, ssa_r, g_r)))
    bound = (albedo_diffuse.T.contiguous(), albedo_direct.T.contiguous(),
             mu0.contiguous())
    total = tc_sw_sweeps(*optics, _gfirst_matrix(v), (~cloudy).T.contiguous(),
                         *bound, incoming_sw.T.contiguous(),
                         reg_fracs[:, 0, :].T.contiguous())

    # clear sky: the ICA adding on gas and aerosols
    od_g, ssa_g = _gf(od), _gf(ssa)
    mu0_c = mu0[None, :]
    clear = adding_sw(*ts.sw_reftrans(mu0_c, od_g, ssa_g,
                                      *ts.sw_gammas(mu0_c, ssa_g, _gf(g))),
                      incoming_sw.T.contiguous(), *bound)
    # night columns: the reference leaves cloud_cover_sw at its -1
    tcc = torch.where(cos_sza > 0.0, tcc, torch.full_like(tcc, -1.0))
    return (daylight(cos_sza, SwFluxes(*total)),
            daylight(cos_sza, SwFluxes(*clear)), tcc)


def solver_tripleclouds_lw(config: RadiationConfig, band_from_g, cloud, od,
                           ssa, g, od_cloud, ssa_cloud, g_cloud, planck_hl,
                           emission, albedo):
    """od/ssa/g (ncol, nlev, ng); planck_hl (ncol, nlev+1, ng); emission
    and albedo (ncol, ng). Returns (total LwFluxes, clear LwFluxes,
    cloud_cover (ncol,), extras)."""
    nreg = config.nregions
    aer_scat, cld_scat = (config.do_lw_aerosol_scattering,
                          config.do_lw_cloud_scattering)
    reg_fracs, od_scaling, u, v, tcc = _regions(config, cloud)
    b = hooks.upload("tripleclouds", band_from_g, od.device)
    od_g, ssa_g, g_g = _gf(od), _gf(ssa), _gf(g)
    planck_g = _gf(planck_hl)
    planck_top, planck_bot = planck_g[:-1], planck_g[1:]
    odc, ssac, gc = (_gf(x)[:, b, :] for x in (od_cloud, ssa_cloud, g_cloud))
    sc_g = od_scaling.permute(1, 2, 0)                 # (nlev, nreg, ncol)
    cloudy = cloud.fraction > 0.0
    cmask = cloudy.T[:, None, :]
    zero = torch.zeros((), dtype=od.dtype, device=od.device)

    layers = []                 # (ref, trans, src_up, src_dn) per region
    for r in range(nreg):
        if r == 0:
            od_t, ssa_t, g_t = od_g, ssa_g, g_g
        else:
            odc_r = odc * sc_g[:, r][:, None, :]
            od_t = od_g + odc_r
            if cld_scat:
                scat = (ssa_g * od_g + ssac * odc_r if aer_scat
                        else ssac * odc_r)
                ssa_t = torch.where(od_t > 0,
                                    scat / torch.clamp(od_t, min=1e-30), zero)
                g_num = (g_g * ssa_g * od_g + gc * ssac * odc_r if aer_scat
                         else gc * ssac * odc_r)
                g_t = torch.where(scat > 0,
                                  g_num / torch.clamp(scat, min=1e-30), zero)
            else:
                ssa_t = g_t = torch.zeros_like(od_t)
            od_t = torch.where(cmask, od_t, od_g)
            ssa_t = torch.where(cmask, ssa_t, zero)
            g_t = torch.where(cmask, g_t, zero)
        scattering = aer_scat if r == 0 else cld_scat
        if scattering:
            layers.append(ts.lw_reftrans(od_t, *ts.lw_gammas(ssa_t, g_t),
                                         planck_top, planck_bot))
        else:
            t, su, sd = ts.lw_no_scattering_transmittance(od_t, planck_top,
                                                          planck_bot)
            layers.append((torch.zeros_like(t), t, su, sd))
    ref_c, trans_c, su_c, sd_c = (x.contiguous() for x in layers[0])
    ref, trans, sup, sdn = (torch.stack(x, 1) for x in zip(*layers))

    # sources scale by the region fraction in cloudy layers; the cloudy
    # regions of clear layers are empty
    fr = reg_fracs.permute(1, 2, 0)[:, :, None, :]   # (nlev, nreg, 1, ncol)
    not_clear = cloudy.T[:, None, None, :]
    sup = torch.where(not_clear, fr * sup, sup)
    sdn = torch.where(not_clear, fr * sdn, sdn)
    keep = not_clear | (torch.arange(nreg, device=od.device) == 0)[
        None, :, None, None]
    ref, trans, sup, sdn = (torch.where(keep, x, zero).contiguous()
                            for x in (ref, trans, sup, sdn))
    um = _gfirst_matrix(u)
    emis_g, alb_g = emission.T.contiguous(), albedo.T.contiguous()
    up, dn = tc_lw_sweeps(ref, trans, sup, sdn, _gfirst_matrix(v),
                          um[:-1].contiguous(), (~cloudy).T.contiguous(),
                          emis_g, alb_g, reg_fracs[:, -1, :].T.contiguous())
    extras = {}
    if config.do_lw_derivatives:
        # the region form (radiation_tripleclouds_lw.F90:519-528)
        extras["lw_derivatives"] = lw_derivatives_region(trans, um,
                                                         up[-1].T)
    # clear sky: scattering follows do_lw_aerosol_scattering
    # (ecrad_tpu/solvers/tripleclouds.py:566-574)
    if aer_scat:
        up_c, dn_c = adding_lw(ref_c, trans_c, su_c, sd_c, emis_g, alb_g)
    else:
        up_c, dn_c = lw_no_scattering_fluxes(trans_c, su_c, sd_c, emis_g,
                                             alb_g)
    return (LwFluxes(up=up, dn=dn), LwFluxes(up=up_c, dn=dn_c), tcc,
            extras)
