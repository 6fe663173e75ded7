"""McICA (Monte Carlo Independent Column Approximation) solvers.

Port of ecrad_tpu/solvers/mcica.py:38-197 (radiation_mcica_sw.F90:39-346,
radiation_mcica_lw.F90:39-361): a clear-sky pass, the stochastic cloud
generator's per-g optical-depth scalings, a total-sky pass on the
combined properties, and the cloud-cover-weighted blend of the two. The
LW generator uses the per-column seed offset +997
(radiation_mcica_lw.F90:203); night columns report cloud_cover_sw = -1.

On CUDA tensors the layer optics run in kernel B4 (ops/mcica_optics.py;
SW always, LW when do_lw_cloud_scattering and do_lw_aerosol_scattering
are both off), the sweeps in kernels B3 (SW adding, LW no-scattering)
and B3' (LW adding with scattering: the total sky with cloud
scattering, and the clear sky whenever do_lw_aerosol_scattering is set).
"""
from __future__ import annotations

import torch

from ..config import RadiationConfig
from ..ops.mcica_optics import lw_clear_total_noscat, sw_clear_total_reftrans
from ..optics.combine import combine_cloud_gas_lw
from ..utils import hooks
from . import two_stream as ts
from .adding import adding_lw, adding_sw, lw_no_scattering_fluxes
from .cloud_generator import cloud_generator
from .cloudless import LwFluxes, SwFluxes, _gf
from .lw_derivatives import lw_derivatives_ica
from .pdf_sampler import PdfSampler


@hooks.hooked("ecrad.cloud_generator")
def _generate(config, pdf_sampler, ng, iseed, cloud, cheb):
    return cloud_generator(
        ng, iseed, config.i_overlap_scheme, config.cloud_fraction_threshold,
        cloud.fraction, cloud.overlap_param,
        config.cloud_inhom_decorr_scaling, cloud.fractional_std,
        pdf_sampler, is_beta_overlap=config.use_beta_overlap, cheb=cheb)


def _blend(tcc, threshold, total, clear):
    """tcc * total + (1 - tcc) * clear where the column has cloud."""
    has_cloud = (tcc >= threshold)[None, None, :]
    w = tcc[None, None, :]
    return torch.where(has_cloud, w * total + (1 - w) * clear, clear)


def solver_mcica_sw(config: RadiationConfig, pdf_sampler: PdfSampler,
                    band_from_g, iseed, cos_sza, cloud, od, ssa, g,
                    od_cloud, ssa_cloud, g_cloud, incoming_sw,
                    albedo_diffuse, albedo_direct, cheb=None):
    """Returns (total SwFluxes, clear SwFluxes, cloud_cover (ncol,))."""
    ng = od.shape[-1]
    od_scaling, tcc = _generate(config, pdf_sampler, ng, iseed, cloud,
                                cheb)
    frac_mask = cloud.fraction >= config.cloud_fraction_threshold
    optics = sw_clear_total_reftrans(
        od.contiguous(), ssa.contiguous(), g.contiguous(), od_cloud,
        ssa_cloud, g_cloud, band_from_g, od_scaling, frac_mask, cos_sza,
        config.do_sw_delta_scaling_with_gases)
    mu0 = torch.clamp(cos_sza, min=1e-10).contiguous()
    bound = (incoming_sw.T.contiguous(), albedo_diffuse.T.contiguous(),
             albedo_direct.T.contiguous(), mu0)
    clear = adding_sw(*optics[:5], *bound)
    cloudy = adding_sw(*optics[5:], *bound)

    thr = config.cloud_fraction_threshold
    day = (cos_sza > 0.0)[None, None, :]
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    total = SwFluxes(*(torch.where(day, _blend(tcc, thr, x, c), zero)
                       for x, c in zip(cloudy, clear)))
    clear = SwFluxes(*(torch.where(day, c, zero) for c in clear))
    # night columns: the reference leaves cloud_cover_sw at its -1 init
    tcc = torch.where(cos_sza > 0.0, tcc, torch.full_like(tcc, -1.0))
    return total, clear, tcc


def solver_mcica_lw(config: RadiationConfig, pdf_sampler: PdfSampler,
                    band_from_g, iseed, cloud, od, ssa, g, od_cloud,
                    ssa_cloud, g_cloud, planck_hl, emission, albedo,
                    cheb=None):
    """Returns (total LwFluxes, clear LwFluxes, cloud_cover (ncol,),
    extras)."""
    ng = od.shape[-1]
    planck_g = _gf(planck_hl)
    planck_top, planck_bot = planck_g[:-1], planck_g[1:]
    emis_g, alb_g = emission.T.contiguous(), albedo.T.contiguous()
    # as in the JAX package (mcica.py:104), the clear sky scatters
    # whenever do_lw_aerosol_scattering is set, aerosols or not
    do_clear_scat = config.do_lw_aerosol_scattering
    thr = config.cloud_fraction_threshold

    od_scaling, tcc = _generate(config, pdf_sampler, ng, iseed + 997,
                                cloud, cheb)
    frac_mask = cloud.fraction >= thr
    if not do_clear_scat and not config.do_lw_cloud_scattering:
        t_c, su_c, sd_c, t, su, sd = lw_clear_total_noscat(
            od.contiguous(), od_cloud, band_from_g, od_scaling, frac_mask,
            planck_hl.contiguous())
        up_c, dn_c = lw_no_scattering_fluxes(t_c, su_c, sd_c, emis_g, alb_g)
        up, dn = lw_no_scattering_fluxes(t, su, sd, emis_g, alb_g)
    else:
        if do_clear_scat:
            r_c, t_c, su_c, sd_c = ts.lw_reftrans(
                _gf(od), *ts.lw_gammas(_gf(ssa), _gf(g)), planck_top,
                planck_bot)
            up_c, dn_c = adding_lw(r_c, t_c, su_c, sd_c, emis_g, alb_g)
        else:
            t_c, su_c, sd_c = ts.lw_no_scattering_transmittance(
                _gf(od), planck_top, planck_bot)
            r_c = torch.zeros_like(t_c)
            up_c, dn_c = lw_no_scattering_fluxes(t_c, su_c, sd_c, emis_g,
                                                 alb_g)
        od_t, ssa_t, g_t = combine_cloud_gas_lw(
            od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
            config.do_lw_cloud_scattering, od_scaling=od_scaling,
            cloud_mask=frac_mask[..., None])
        mask_g = frac_mask.T.contiguous()[:, None, :]
        if config.do_lw_cloud_scattering:
            r, t, su, sd = ts.lw_reftrans(
                _gf(od_t), *ts.lw_gammas(_gf(ssa_t), _gf(g_t)), planck_top,
                planck_bot)
            # clear layers reuse the clear-sky properties (R = 0 where
            # the clear path does not scatter)
            r, t, su, sd = (torch.where(mask_g, x, c) for x, c in
                            zip((r, t, su, sd), (r_c, t_c, su_c, sd_c)))
            up, dn = adding_lw(r, t, su, sd, emis_g, alb_g)
        else:
            t, su, sd = ts.lw_no_scattering_transmittance(
                _gf(od_t), planck_top, planck_bot)
            t, su, sd = (torch.where(mask_g, x, c) for x, c in
                         zip((t, su, sd), (t_c, su_c, sd_c)))
            up, dn = lw_no_scattering_fluxes(t, su, sd, emis_g, alb_g)

    extras = {}
    if config.do_lw_derivatives:
        deriv_cloudy = lw_derivatives_ica(t, up[-1].T)
        deriv_clear = lw_derivatives_ica(t_c, up_c[-1].T)
        w = tcc[:, None]
        blendable = (tcc < 1.0 - thr)[:, None]
        deriv = torch.where(
            (tcc >= thr)[:, None],
            torch.where(blendable, w * deriv_cloudy + (1 - w) * deriv_clear,
                        deriv_cloudy),
            deriv_clear)
        extras["lw_derivatives"] = deriv
    return (LwFluxes(up=_blend(tcc, thr, up, up_c),
                     dn=_blend(tcc, thr, dn, dn_c)),
            LwFluxes(up=up_c, dn=dn_c), tcc, extras)
