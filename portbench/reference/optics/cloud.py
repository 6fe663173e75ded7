"""Cloud optical properties: liquid and ice models, band-space assembly.

Port of ecrad_tpu/optics/cloud.py:46-353 (radiation_cloud_optics.F90:
200-491 and the liquid/ice optics modules): SOCRATES, Slingo SW and
Lindner-Li LW liquid; Fu (with do_fu_lw_ice_optics_bug), Baran,
Baran2016, Baran2017 and Yi ice; the three delta-Eddington forms.
Vectorised over (ncol, nlev) with bands innermost. In-cloud water paths
use dp / (g cloud_fraction), or dp / g when both solvers are Homogeneous.

The coefficients are float32 whatever the compute precision, as in the
JAX package (its `cloud_optics` takes float32 coefficient columns), and
live on the device from setup on (`coefficient_tensors`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import IceModel, LiquidModel, RadiationConfig, Solver
from ..constants import ACCEL_DUE_TO_GRAVITY
from ..io.netcdf import NetcdfFile

MAX_ASYMMETRY = 1.0 - 1.2e-7
FU_MAX_EFFECTIVE_RADIUS = 100.0e-6
YI_NSINGLE = 23


@dataclass
class CloudOpticsTables:
    """LUT coefficients as read, numpy (nband, ncoeff)."""
    liq_coeff_lw: np.ndarray
    liq_coeff_sw: np.ndarray
    ice_coeff_lw: np.ndarray
    ice_coeff_sw: np.ndarray
    ice_coeff_gen: Optional[np.ndarray] = None


def setup_cloud_optics(config: RadiationConfig) -> CloudOpticsTables:
    """Load the droplet and ice scattering LUTs
    (radiation_cloud_optics_data.F90:48-108)."""
    with NetcdfFile(config.liq_optics_file) as f:
        liq_lw, liq_sw = f.read("coeff_lw"), f.read("coeff_sw")
    with NetcdfFile(config.ice_optics_file) as f:
        ice_lw, ice_sw = f.read("coeff_lw"), f.read("coeff_sw")
        gen = f.read("coeff_gen") if f.exists("coeff_gen") else None
    return CloudOpticsTables(liq_coeff_lw=liq_lw, liq_coeff_sw=liq_sw,
                             ice_coeff_lw=ice_lw, ice_coeff_sw=ice_sw,
                             ice_coeff_gen=gen)


def coefficient_tensors(tables: CloudOpticsTables, device
                        ) -> Dict[str, torch.Tensor]:
    """The four coefficient arrays as float32 tensors on `device`."""
    return {k: torch.as_tensor(getattr(tables, k), dtype=torch.float32,
                               device=device)
            for k in ("liq_coeff_lw", "liq_coeff_sw", "ice_coeff_lw",
                      "ice_coeff_sw")}


# ---- delta-Eddington (radiation_delta_eddington.h) ----

def delta_eddington(od, ssa, g):
    """Intensive form."""
    f = g * g
    od_new = od * (1.0 - ssa * f)
    ssa_new = ssa * (1.0 - f) / (1.0 - ssa * f)
    g_new = g / (1.0 + g)
    return od_new, ssa_new, g_new


def delta_eddington_scat_od(od, scat_od, g):
    """Extensive form on (od, scat_od, g)."""
    f = g * g
    return od - scat_od * f, scat_od * (1.0 - f), g / (1.0 + g)


def delta_eddington_extensive(od, scat_od, scat_od_g):
    g = torch.where(scat_od > 0.0,
                    scat_od_g / torch.clamp(scat_od, min=1e-30),
                    torch.zeros((), dtype=od.dtype, device=od.device))
    f = g * g
    scat_new = scat_od * (1.0 - f)
    return od - scat_od * f, scat_new, scat_new * g / (1.0 + g)


# ---- per-model optics: wp, re, qi (ncol, nlev) broadcast against the
# (nb,) coefficient columns; coeff (nb, ncoeff) float32 ----

def _cols(coeff):
    """1-based Fortran coefficient column i -> (nb,) tensor."""
    return lambda i: coeff[:, i - 1]


def liq_socrates(coeff, lwp, re):
    """SOCRATES Pade fits in re (radiation_liquid_optics_socrates.F90)."""
    c, lwp, re = _cols(coeff), lwp[..., None], re[..., None]
    od = lwp * (c(1) + re * (c(2) + re * c(3))) / (
        1.0 + re * (c(4) + re * (c(5) + re * c(6))))
    scat_od = od * (1.0 - (c(7) + re * (c(8) + re * c(9)))
                    / (1.0 + re * (c(10) + re * c(11))))
    g = (c(12) + re * (c(13) + re * c(14))) / (
        1.0 + re * (c(15) + re * c(16)))
    return od, scat_od, g


def liq_slingo_sw(coeff, lwp, re):
    c = _cols(coeff)
    lwp_gm2 = lwp[..., None] * 1000.0
    re_um = torch.clamp(re[..., None] * 1.0e6, 4.2, 16.6)
    inv = 1.0 / re_um
    od = lwp_gm2 * (c(1) + inv * c(2))
    scat_od = od * (1.0 - c(3) - re_um * c(4))
    g = c(5) + re_um * c(6)
    return od, scat_od, g


def liq_lindner_li_lw(coeff, lwp, re):
    c = _cols(coeff)
    lwp_gm2 = lwp[..., None] * 1000.0
    re_um = torch.clamp(re[..., None] * 1.0e6, 2.0, 40.0)
    inv = 1.0 / re_um
    od = lwp_gm2 * (c(1) + re_um * c(2)
                    + inv * (c(3) + inv * (c(4) + inv * c(5))))
    scat_od = od * (1.0 - (c(6) + inv * c(7)
                           + re_um * (c(8) + re_um * c(9))))
    g = c(10) + inv * c(11) + re_um * (c(12) + re_um * c(13))
    return od, scat_od, g


def _fu_de_um(re):
    return torch.clamp(re[..., None], max=FU_MAX_EFFECTIVE_RADIUS) * (
        1.0e6 / 0.64952)


def ice_fu_sw(coeff, iwp, re):
    c = _cols(coeff)
    de_um = _fu_de_um(re)
    inv = 1.0 / de_um
    iwp_gm2 = iwp[..., None] * 1000.0
    od = iwp_gm2 * (c(1) + c(2) * inv)
    scat_od = od * (1.0 - (c(3) + de_um * (c(4) + de_um * (
        c(5) + de_um * c(6)))))
    g = torch.clamp(c(7) + de_um * (c(8) + de_um * (c(9) + de_um * c(10))),
                    max=MAX_ASYMMETRY)
    return od, scat_od, g


def ice_fu_lw(coeff, iwp, re):
    c = _cols(coeff)
    de_um = _fu_de_um(re)
    inv = 1.0 / de_um
    iwp_gm2 = iwp[..., None] * 1000.0
    od = iwp_gm2 * (c(1) + inv * (c(2) + inv * c(3)))
    scat_od = od - iwp_gm2 * inv * (c(4) + de_um * (
        c(5) + de_um * (c(6) + de_um * c(7))))
    g = torch.clamp(c(8) + de_um * (c(9) + de_um * (c(10)
                                                    + de_um * c(11))),
                    max=MAX_ASYMMETRY)
    return od, scat_od, g


def ice_baran(coeff, iwp, qi):
    c, iwp, qi = _cols(coeff), iwp[..., None], qi[..., None]
    od = iwp * (c(1) + c(2) / (1.0 + qi * c(3)))
    scat_od = od * (c(4) + c(5) / (1.0 + qi * c(6)))
    g = c(7) + c(8) / (1.0 + qi * c(9))
    return od, scat_od, g


def ice_baran2016(coeff, iwp, qi, temperature):
    c, iwp, t = _cols(coeff), iwp[..., None], temperature[..., None]
    qi_t = torch.clamp(qi[..., None], max=1.0e-3) * t
    t2 = t * t
    qi_over_t4 = 1.0 / (t2 * t2)
    od = iwp * c(1) * qi_over_t4
    scat_od = od * (c(2) + c(3) * qi_t)
    g = c(4) + c(5) * qi_t
    return od, scat_od, g


def ice_baran2017(coeff_gen, coeff, iwp, qi, temperature):
    c, iwp, qi = _cols(coeff), iwp[..., None], qi[..., None]
    t = temperature[..., None]
    gen = [float(x) for x in coeff_gen]
    qi_mod = qi * torch.exp(gen[0] * (t - gen[1]))
    qi_mod_od, qi_mod_ssa, qi_mod_g = (qi_mod ** gen[2], qi_mod ** gen[3],
                                       qi_mod ** gen[4])
    od = iwp * (c(1) + c(2) / (1.0 + qi_mod_od * c(3)))
    scat_od = od * (c(4) + c(5) / (1.0 + qi_mod_ssa * c(6)))
    g = c(7) + c(8) / (1.0 + qi_mod_g * c(9))
    return od, scat_od, g


def ice_yi(coeff, iwp, re):
    """Yi et al. LUT in effective diameter, 23 size bins
    (radiation_ice_optics_yi.F90)."""
    de_um = torch.clamp(re[..., None] * 2.0e6, 10.0, 119.99)
    iwp_gm2 = iwp[..., None] * 1000.0
    pos = de_um * 0.2 - 1.0
    idx = torch.floor(pos)                 # 1-based Fortran column
    w2 = pos - idx
    w1 = 1.0 - w2
    tab_t = coeff.T                        # (69, nb)
    idx = idx[..., 0].long()

    def sample(base_off):
        i0 = torch.clamp(idx + base_off - 1, 0, tab_t.shape[0] - 2)
        return w1 * tab_t[i0] + w2 * tab_t[i0 + 1]

    od = 0.001 * iwp_gm2 * sample(0)
    scat_od = od * sample(YI_NSINGLE)
    g = sample(2 * YI_NSINGLE)
    return od, scat_od, g


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def cloud_optics(config: RadiationConfig, tables: CloudOpticsTables,
                 coeffs: Dict[str, torch.Tensor], pressure_hl,
                 temperature_hl, cloud) -> Tuple:
    """Per-band cloud optical properties (ecrad_tpu/optics/cloud.py:238).
    `coeffs` are coefficient_tensors(tables) on the inputs' device.

    Returns (od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw), each
    (ncol, nlev, nbands). Without LW cloud scattering ssa_lw/g_lw are
    zero and od_lw is the absorption optical depth."""
    frac = cloud.fraction
    is_homogeneous = (config.i_solver_sw == Solver.HOMOGENEOUS
                      and config.i_solver_lw == Solver.HOMOGENEOUS)
    dp = pressure_hl[:, 1:] - pressure_hl[:, :-1]
    denom = ACCEL_DUE_TO_GRAVITY * (
        torch.ones_like(frac) if is_homogeneous
        else torch.clamp(frac, min=1e-12))
    factor = dp / denom
    incloud = frac > 0.0
    lwp = _where0(incloud, factor * cloud.q_liq)
    iwp = _where0(incloud, factor * cloud.q_ice)

    # ---- liquid ----
    if config.i_liq_model == LiquidModel.SOCRATES:
        liq_lw = liq_socrates(coeffs["liq_coeff_lw"], lwp, cloud.re_liq)
        liq_sw = liq_socrates(coeffs["liq_coeff_sw"], lwp, cloud.re_liq)
    elif config.i_liq_model == LiquidModel.SLINGO:
        liq_lw = liq_lindner_li_lw(coeffs["liq_coeff_lw"], lwp,
                                   cloud.re_liq)
        liq_sw = liq_slingo_sw(coeffs["liq_coeff_sw"], lwp, cloud.re_liq)
    else:
        raise NotImplementedError(config.i_liq_model)
    has_liq = (lwp > 0.0)[..., None]
    liq_lw = [_where0(has_liq, x) for x in liq_lw]
    liq_sw = [_where0(has_liq, x) for x in liq_sw]
    if not config.do_sw_delta_scaling_with_gases:
        liq_sw = delta_eddington_scat_od(*liq_sw)

    # ---- ice ----
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    lw, sw = coeffs["ice_coeff_lw"], coeffs["ice_coeff_sw"]
    if config.i_ice_model == IceModel.FU:
        ice_lw = list(ice_fu_lw(lw, iwp, cloud.re_ice))
        if config.do_fu_lw_ice_optics_bug:
            ice_lw[1] = ice_lw[0] - ice_lw[1]
        ice_sw = ice_fu_sw(sw, iwp, cloud.re_ice)
    elif config.i_ice_model == IceModel.BARAN:
        ice_lw = ice_baran(lw, iwp, cloud.q_ice)
        ice_sw = ice_baran(sw, iwp, cloud.q_ice)
    elif config.i_ice_model == IceModel.BARAN2016:
        ice_lw = ice_baran2016(lw, iwp, cloud.q_ice, t_fl)
        ice_sw = ice_baran2016(sw, iwp, cloud.q_ice, t_fl)
    elif config.i_ice_model == IceModel.BARAN2017:
        ice_lw = ice_baran2017(tables.ice_coeff_gen, lw, iwp, cloud.q_ice,
                               t_fl)
        ice_sw = ice_baran2017(tables.ice_coeff_gen, sw, iwp, cloud.q_ice,
                               t_fl)
    elif config.i_ice_model == IceModel.YI:
        ice_lw = ice_yi(lw, iwp, cloud.re_ice)
        ice_sw = ice_yi(sw, iwp, cloud.re_ice)
    else:
        raise NotImplementedError(config.i_ice_model)
    has_ice = (iwp > 0.0)[..., None]
    ice_lw = [_where0(has_ice, x) for x in ice_lw]
    ice_sw = [_where0(has_ice, x) for x in ice_sw]
    if not config.do_sw_delta_scaling_with_gases:
        ice_sw = delta_eddington_scat_od(*ice_sw)
    ice_lw = delta_eddington_scat_od(*ice_lw)

    # ---- combine liquid and ice ----
    cloudy = incloud[..., None]

    def mix(liq, ice):
        (od_l, scat_l, g_l), (od_i, scat_i, g_i) = liq, ice
        od = _where0(cloudy, od_l + od_i)
        scat = scat_l + scat_i
        g = _where0(cloudy & (scat > 0.0),
                    (g_l * scat_l + g_i * scat_i)
                    / torch.clamp(scat, min=1e-30))
        ssa = _where0(cloudy & (od > 0.0), scat / torch.clamp(od, min=1e-30))
        return od, ssa, g

    od_sw, ssa_sw, g_sw = mix(liq_sw, ice_sw)
    if config.do_lw_cloud_scattering:
        od_lw, ssa_lw, g_lw = mix(liq_lw, ice_lw)
    else:
        od_lw = _where0(cloudy, liq_lw[0] - liq_lw[1]
                        + ice_lw[0] - ice_lw[1])
        ssa_lw = torch.zeros_like(od_lw)
        g_lw = torch.zeros_like(od_lw)
    return od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw
