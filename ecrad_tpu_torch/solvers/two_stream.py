"""Two-stream coefficients and layer reflectance/transmittance.

Port of ecrad_tpu/solvers/two_stream.py
(radiation/radiation_two_stream.F90): LW Fu et al. (1997) gammas, SW
Zdunkowski PIFM gammas, Meador & Weaver (1980) reflectance and
transmittance with linear-in-tau Planck sources, the LW
no-scattering transmittance, the surface scheme's isothermal LW and
physical-coordinate SW variants, and the scattered-diffuse fraction of
the direct beam. Elementwise over any broadcastable shapes.
`torch.exp` is the exact libm exponential on every device; the TPU's
software exp (ecrad_tpu/utils/fastmath.py) is not needed here.
"""
from __future__ import annotations

import torch

from ..utils import hooks

LW_DIFFUSIVITY = 1.66
SW_DIFFUSIVITY = 2.0
KMIN = 1.0e-4  # single-precision value (radiation_two_stream.F90:46)


@hooks.hooked("ecrad.layer_optics")
def lw_gammas(ssa, g):
    """Fu et al. (1997) Eq 2.9/2.10."""
    factor = (LW_DIFFUSIVITY * 0.5) * ssa
    gamma1 = LW_DIFFUSIVITY - factor * (1.0 + g)
    gamma2 = factor * (1.0 - g)
    return gamma1, gamma2


@hooks.hooked("ecrad.layer_optics")
def sw_gammas(mu0, ssa, g):
    """Zdunkowski PIFM (practical improved flux method)."""
    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    return gamma1, gamma2, gamma3


def _k_exponent(gamma1, gamma2):
    return torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2),
                                  min=KMIN))


@hooks.hooked("ecrad.layer_optics")
def lw_reftrans(od, gamma1, gamma2, planck_top, planck_bot):
    """LW Meador-Weaver reflectance/transmittance and linear-in-tau
    sources, with the od <= 1e-3 series branch
    (radiation_two_stream.F90:173-257). Returns (ref, trans, src_up,
    src_dn)."""
    k = _k_exponent(gamma1, gamma2)
    expo = torch.exp(-k * od)
    expo2 = expo * expo
    rt_factor = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_full = gamma2 * (1.0 - expo2) * rt_factor
    trans_full = 2.0 * k * expo * rt_factor
    coeff = (planck_bot - planck_top) / torch.clamp(
        od * (gamma1 + gamma2), min=1e-30)
    up_top = coeff + planck_top
    up_bot = coeff + planck_bot
    dn_top = -coeff + planck_top
    dn_bot = -coeff + planck_bot
    src_up_full = up_top - ref_full * dn_top - trans_full * up_bot
    src_dn_full = dn_bot - ref_full * up_bot - trans_full * dn_top
    ref_thin = gamma2 * od
    trans_thin = (1.0 - k * od) / (1.0 + od * (gamma1 - k))
    src_thin = ((1.0 - ref_thin - trans_thin)
                * 0.5 * (planck_top + planck_bot))
    thin = od <= 1.0e-3
    return (torch.where(thin, ref_thin, ref_full),
            torch.where(thin, trans_thin, trans_full),
            torch.where(thin, src_thin, src_up_full),
            torch.where(thin, src_thin, src_dn_full))


@hooks.hooked("ecrad.layer_optics")
def lw_no_scattering_transmittance(od, planck_top, planck_bot):
    """No-scattering LW: trans = exp(-1.66 od) and linear-in-tau sources
    (radiation_two_stream.F90:337-409). Returns (trans, src_up, src_dn).
    """
    coeff0 = LW_DIFFUSIVITY * od
    trans_full = torch.exp(-coeff0)
    coeff = (planck_bot - planck_top) / torch.clamp(coeff0, min=1e-30)
    src_up_full = (coeff + planck_top) - trans_full * (coeff + planck_bot)
    src_dn_full = (-coeff + planck_bot) - trans_full * (-coeff + planck_top)
    trans_thin = 1.0 - coeff0
    src_thin = coeff0 * 0.5 * (planck_top + planck_bot)
    thin = od <= 1.0e-3
    return (torch.where(thin, trans_thin, trans_full),
            torch.where(thin, src_thin, src_up_full),
            torch.where(thin, src_thin, src_dn_full))


#: |k mu0 - 1| below which float32 SW terms are recomputed in float64
RESONANCE_WINDOW = 0.03


@hooks.hooked("ecrad.layer_optics")
def sw_reftrans(mu0, od, ssa, gamma1, gamma2, gamma3):
    """SW Meador-Weaver and direct-beam terms (classic variant,
    radiation_two_stream.F90:461-560); mu0 broadcasts against od.
    Returns (ref_diff, trans_diff, ref_dir, trans_dir_diff,
    trans_dir_dir).

    The direct-beam terms have a removable singularity at k mu0 = 1, and
    their float32 evaluation cancels next to it: its error grows as
    1 / |k mu0 - 1|, to 16 % of trans_dir_diff at k mu0 = 1 - 5e-5 in a
    layer with aerosols (0.35 W/m2 of clear-sky TOA upwelling SW on the
    GPU; BASELINE.md: "irreducible without computing that stage in
    f64"). So float32 cells within RESONANCE_WINDOW of it are recomputed
    in float64 from the same inputs and rounded; outside the window the
    float32 error is no larger than elsewhere (~5e-6 absolute)."""
    out = _sw_reftrans(mu0, od, ssa, gamma1, gamma2, gamma3)
    if od.dtype != torch.float32:
        return out
    near = torch.abs(_k_exponent(gamma1, gamma2) * mu0 - 1.0) \
        < RESONANCE_WINDOW
    idx = hooks.sync("resonance", near.expand(out[0].shape).nonzero,
                     as_tuple=True)
    if idx[0].numel():
        exact = _sw_reftrans(*(x.expand(out[0].shape)[idx].double() for x in
                               (mu0, od, ssa, gamma1, gamma2, gamma3)))
        for o, e in zip(out, exact):
            o[idx] = e.float()
    return out


def _sw_reftrans(mu0, od, ssa, gamma1, gamma2, gamma3):
    od_over_mu0 = torch.clamp(od / mu0, min=0.0)
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = _k_exponent(gamma1, gamma2)
    k_mu0 = k * mu0
    # avoid the k mu0 == 1 resonance (float32-sized nudge)
    k_mu0 = torch.where(torch.abs(k_mu0 - 1.0) < 1e-6,
                        torch.full_like(k_mu0, 1.0 - 1e-6), k_mu0)
    k_gamma3 = k * gamma3
    k_gamma4 = k * gamma4
    e0 = torch.exp(-od_over_mu0)
    expo = torch.exp(-k * od)
    expo2 = expo * expo
    k2e = 2.0 * k * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_diff = gamma2 * (1.0 - expo2) * rt
    trans_diff = k2e * rt
    rt_dir = mu0 * ssa * rt / (1.0 - k_mu0 * k_mu0)
    ref_dir = rt_dir * ((1.0 - k_mu0) * (alpha2 + k_gamma3)
                        - (1.0 + k_mu0) * (alpha2 - k_gamma3) * expo2
                        - k2e * (gamma3 - alpha2 * mu0) * e0)
    trans_dir_diff = rt_dir * (
        k2e * (gamma4 + alpha1 * mu0)
        - e0 * ((1.0 + k_mu0) * (alpha1 + k_gamma4)
                - (1.0 - k_mu0) * (alpha1 - k_gamma4) * expo2))
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, e0


def lw_reftrans_isothermal(od, gamma1, gamma2, planck):
    """Isothermal-layer LW Meador-Weaver reflectance and transmittance
    (radiation_two_stream.F90:263-327), for a canopy whose temperature
    is constant with height. Returns (reflectance, transmittance,
    source), the source the layer's own emission, the same up and
    down."""
    k = _k_exponent(gamma1, gamma2)
    expo = torch.exp(-k * od)
    expo2 = expo * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref = gamma2 * (1.0 - expo2) * rt
    trans = 2.0 * k * expo * rt
    return ref, trans, planck * (1.0 - ref - trans)


def sw_reftrans_z(mu0, depth, gamma0, gamma1, gamma2, gamma3, gamma4):
    """SW Meador-Weaver in physical (z) coordinates
    (radiation_two_stream.F90:648-774): the gammas are rates per metre
    (an urban canyon's include its wall exchange, so gamma3 and gamma4
    come scaled, not from an ssa), gamma0 the direct beam's attenuation
    rate. Returns (ref_diff, trans_diff, ref_dir, trans_dir_diff,
    trans_dir_dir). As in the JAX package, without sw_reftrans's float64
    resonance window: only the float32-sized nudge of k mu0 off 1."""
    od_over_mu0 = torch.clamp(gamma0 * depth, min=0.0)
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = _k_exponent(gamma1, gamma2)
    k_mu0 = k * mu0
    k_mu0 = torch.where(torch.abs(k_mu0 - 1.0) < 1e-6,
                        torch.full_like(k_mu0, 1.0 - 1e-6), k_mu0)
    k_gamma3 = k * gamma3
    k_gamma4 = k * gamma4
    e0 = torch.exp(-od_over_mu0)
    expo = torch.exp(-k * depth)
    expo2 = expo * expo
    k2e = 2.0 * k * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref_diff = gamma2 * (1.0 - expo2) * rt
    trans_diff = k2e * rt
    rt_dir = mu0 * rt / (1.0 - k_mu0 * k_mu0)
    ref_dir = rt_dir * ((1.0 - k_mu0) * (alpha2 + k_gamma3)
                        - (1.0 + k_mu0) * (alpha2 - k_gamma3) * expo2
                        - k2e * (gamma3 - alpha2 * mu0) * e0)
    trans_dir_diff = rt_dir * (
        k2e * (gamma4 + alpha1 * mu0)
        - e0 * ((1.0 + k_mu0) * (alpha1 + k_gamma4)
                - (1.0 - k_mu0) * (alpha1 - k_gamma4) * expo2))
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, e0


def sw_frac_scattered_diffuse(od, gamma1, gamma2):
    """Fraction of beam extinction that scatters into the diffuse streams
    (radiation_two_stream.F90:781-839): 1 where the layer is too thin for
    the ratio (1 - exp(-2 od) <= 1e-12)."""
    k = _k_exponent(gamma1, gamma2)
    expo = torch.exp(-k * od)
    expo2 = expo * expo
    rt = 1.0 / (k + gamma1 + (k - gamma1) * expo2)
    ref = gamma2 * (1.0 - expo2) * rt
    trans = 2.0 * k * expo * rt
    one_minus = 1.0 - ref - trans
    denom = 1.0 - torch.exp(-SW_DIFFUSIVITY * od)
    return torch.where(denom > 1e-12,
                       torch.clamp(one_minus / torch.clamp(denom, min=1e-12),
                                   0.0, 1.0), 1.0)
