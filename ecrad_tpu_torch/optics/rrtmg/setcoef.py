"""Gas column densities and interpolation coefficients for RRTMG-IFS.

Port of ecrad_tpu/optics/rrtmg/setcoef.py:
  - prepare_gases: ifsrrtm/rrtm_prepare_gases.F90 (column densities)
  - setcoef:       ifsrrtm/rrtm_setcoef_140gp.F90 and srtm_setcoef.F90

All fields are (ncol, nlev) with the level axis surface-first (RRTMG
orientation). The integer fields (jp, jt, jt1, indself, indfor, indminor)
and the tropopause mask must equal the JAX package's exactly: one index
off moves an optical depth by a whole table row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...utils import hooks

# Molar masses as hard-coded in rrtm_prepare_gases.F90 (DATA statements)
_AMD = 28.970
_AMW = 18.0154
_AMCO2 = 44.011
_AMO = 47.9982
_AMCH4 = 16.043
_AMN2O = 44.013
_AMC11 = 137.3686
_AMC12 = 120.9140
_AMC22 = 86.4690
_AMCL4 = 153.8230
_AVGDRO = 6.02214e23
_GRAV_CGS = 9.80665e2  # RG * 1e2 (cm s-2)


def chi_rows_at(chi: torch.Tensor, idx0: torch.Tensor) -> torch.Tensor:
    """chi_mls of every gas at a per-cell pressure index: chi (ngas, 59),
    idx0 0-based int (any shape) -> (ngas,) + idx0.shape. A plain
    gather; the JAX package's one-hot product is a TPU workaround."""
    return chi[:, idx0.clamp(0, chi.shape[1] - 1)]


class GasColumns(NamedTuple):
    """Column densities per rrtm_prepare_gases, surface-first."""
    pavel: torch.Tensor      # layer pressure (hPa)
    tavel: torch.Tensor      # layer temperature (K)
    coldry: torch.Tensor     # dry air column density
    wbrodl: torch.Tensor     # broadening gas column
    colh2o_raw: torch.Tensor
    colco2_raw: torch.Tensor
    colo3_raw: torch.Tensor
    coln2o_raw: torch.Tensor
    colch4_raw: torch.Tensor
    colo2_raw: torch.Tensor
    wx_ccl4: torch.Tensor    # cross-section amounts (scaled 1e-20)
    wx_cfc11: torch.Tensor
    wx_cfc12: torch.Tensor
    wx_cfc22: torch.Tensor


class Coeffs(NamedTuple):
    """Everything taumol needs, all (ncol, nlev) surface-first. Field
    names and order are those of the JAX package's Coeffs."""
    tropo: torch.Tensor          # bool: log(pavel) > 4.56
    jp: torch.Tensor             # 1..58 (1-based, as in Fortran)
    jt: torch.Tensor             # 1..4
    jt1: torch.Tensor
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    indself: torch.Tensor        # 1..9
    selffac: torch.Tensor
    selffrac: torch.Tensor
    indfor: torch.Tensor         # 1..3
    forfac: torch.Tensor
    forfrac: torch.Tensor
    indminor: torch.Tensor       # 1..18
    minorfrac: torch.Tensor
    # SW factors: srtm_setcoef.F90 has no LW stability clamp on fp
    fac00_sw: torch.Tensor
    fac01_sw: torch.Tensor
    fac10_sw: torch.Tensor
    fac11_sw: torch.Tensor
    scaleminor: torch.Tensor
    scaleminorn2: torch.Tensor
    colh2o: torch.Tensor         # 1e-20-scaled column amounts
    colco2: torch.Tensor
    colo3: torch.Tensor
    coln2o: torch.Tensor
    colch4: torch.Tensor
    colo2: torch.Tensor
    colbrd: torch.Tensor
    colmol: torch.Tensor
    coldry: torch.Tensor
    rat_h2oco2: torch.Tensor
    rat_h2oco2_1: torch.Tensor
    rat_h2oo3: torch.Tensor
    rat_h2oo3_1: torch.Tensor
    rat_h2on2o: torch.Tensor
    rat_h2on2o_1: torch.Tensor
    rat_h2och4: torch.Tensor
    rat_h2och4_1: torch.Tensor
    rat_n2oco2: torch.Tensor
    rat_n2oco2_1: torch.Tensor
    rat_o3co2: torch.Tensor
    rat_o3co2_1: torch.Tensor
    pavel: torch.Tensor
    wx_ccl4: torch.Tensor
    wx_cfc11: torch.Tensor
    wx_cfc12: torch.Tensor
    wx_cfc22: torch.Tensor

    def flip_levels(self) -> "Coeffs":
        return Coeffs(*[x.flip(1) for x in self])


INT_FIELDS = ("jp", "jt", "jt1", "indself", "indfor", "indminor")


def prepare_gases(pressure_hl, pressure_fl, temperature_fl,
                  q, co2, ch4, n2o, cfc11, cfc12, hcfc22, ccl4, o3,
                  dtype=torch.float32) -> GasColumns:
    """Column densities. Inputs are (ncol, nlev[+1]) TOA first; outputs
    surface-first (rrtm_prepare_gases.F90: PAVEL(JK) = PAP(KLEV-JK+1))."""
    def flip(x):
        return x.flip(1).to(dtype)

    pavel = flip(pressure_fl) / 100.0
    tavel = flip(temperature_fl)
    pz = pressure_hl.flip(1).to(dtype) / 100.0   # PZ(0) = surface

    wkl1 = flip(q) * (_AMD / _AMW)
    wkl2 = flip(co2) * (_AMD / _AMCO2)
    wkl3 = flip(o3) * (_AMD / _AMO)
    wkl4 = flip(n2o) * (_AMD / _AMN2O)
    wkl6 = flip(ch4) * (_AMD / _AMCH4)
    wkl7 = torch.full_like(wkl1, 0.209488)  # O2 hard-coded (reference :132)

    amm = (1.0 - wkl1) * _AMD + wkl1 * _AMW
    dp = pz[:, :-1] - pz[:, 1:]
    coldry = dp * 1.0e3 * _AVGDRO / (_GRAV_CGS * amm * (1.0 + wkl1))

    wx1 = coldry * flip(ccl4) * (_AMD / _AMCL4) * 1.0e-20
    wx2 = coldry * flip(cfc11) * (_AMD / _AMC11) * 1.0e-20
    wx3 = coldry * flip(cfc12) * (_AMD / _AMC12) * 1.0e-20
    wx4 = coldry * flip(hcfc22) * (_AMD / _AMC22) * 1.0e-20

    summol = wkl2 + wkl3 + wkl4 + wkl6 + wkl7
    wbrodl = coldry * (1.0 - summol)

    return GasColumns(
        pavel=pavel, tavel=tavel, coldry=coldry, wbrodl=wbrodl,
        colh2o_raw=coldry * wkl1, colco2_raw=coldry * wkl2,
        colo3_raw=coldry * wkl3, coln2o_raw=coldry * wkl4,
        colch4_raw=coldry * wkl6, colo2_raw=coldry * wkl7,
        wx_ccl4=wx1, wx_cfc11=wx2, wx_cfc12=wx3, wx_cfc22=wx4,
    )


def _floor_int(x):
    return torch.floor(x).to(torch.int32)


def setcoef(gc: GasColumns, preflog: np.ndarray, tref: np.ndarray,
            chi_mls: np.ndarray) -> Coeffs:
    """Interpolation indices and factors (rrtm_setcoef_140gp.F90:86-278).
    preflog/tref: (59,) reference profiles; chi_mls: (7, 59)."""
    dt, dev = gc.pavel.dtype, gc.pavel.device
    preflog = hooks.upload("setcoef", preflog, dev, dt)
    tref = hooks.upload("setcoef", tref, dev, dt)
    chi = hooks.upload("setcoef", chi_mls, dev, dt)

    plog = torch.log(gc.pavel)
    jp = _floor_int(36.0 - 5.0 * (plog + 0.04)).clamp(1, 58)
    jp1 = jp + 1
    fp_raw = 5.0 * (preflog[jp - 1] - plog)
    # Ukkonen fork stability clamp, LW only (rrtm_setcoef_140gp.F90:110)
    fp = fp_raw.clamp(-1.0, 1.0)

    def t_index(jref):
        dtemp = gc.tavel - tref[jref - 1]
        idx = _floor_int(3.0 + dtemp / 15.0).clamp(1, 4)
        frac = dtemp / 15.0 - (idx - 3).to(dt)
        return idx, frac

    jt, ft = t_index(jp)
    jt1, ft1 = t_index(jp1)

    water = gc.colh2o_raw / gc.coldry
    scalefac = gc.pavel * (296.0 / 1013.0) / gc.tavel
    tropo = plog > 4.56

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - gc.tavel) / 36.0
    indfor_t = _floor_int(factor_t).clamp(1, 2)
    forfrac_t = factor_t - indfor_t.to(dt)
    factor_s = (gc.tavel - 188.0) / 36.0
    indfor = torch.where(tropo, indfor_t, torch.full_like(indfor_t, 3))
    forfrac = torch.where(tropo, forfrac_t, factor_s - 1.0)

    selffac = water * forfac
    factor_self = (gc.tavel - 188.0) / 7.2
    indself = (_floor_int(factor_self) - 7).clamp(1, 9)
    selffrac = factor_self - (indself + 7).to(dt)

    scaleminor = gc.pavel / gc.tavel
    scaleminorn2 = scaleminor * (gc.wbrodl / (gc.coldry + gc.colh2o_raw))
    factor_m = (gc.tavel - 180.8) / 7.2
    indminor = _floor_int(factor_m).clamp(1, 18)
    minorfrac = factor_m - indminor.to(dt)

    chi_jp = chi_rows_at(chi, jp - 1)
    chi_jp1 = chi_rows_at(chi, jp1 - 1)

    def rat(i, j, at):
        return at[i - 1] / at[j - 1]

    colh2o = 1.0e-20 * gc.colh2o_raw
    colco2 = 1.0e-20 * gc.colco2_raw
    colo3 = 1.0e-20 * gc.colo3_raw
    coln2o = 1.0e-20 * gc.coln2o_raw
    colch4 = 1.0e-20 * gc.colch4_raw
    colo2 = 1.0e-20 * gc.colo2_raw
    colbrd = 1.0e-20 * gc.wbrodl
    zerofloor = 1.0e-32 * gc.coldry
    colco2 = torch.where(colco2 == 0.0, zerofloor, colco2)
    coln2o = torch.where(coln2o == 0.0, zerofloor, coln2o)
    colch4 = torch.where(colch4 == 0.0, zerofloor, colch4)
    colo2 = torch.where(colo2 == 0.0, zerofloor, colo2)
    colmol = 1.0e-20 * gc.coldry + colh2o

    compfp = 1.0 - fp
    compfp_sw = 1.0 - fp_raw
    return Coeffs(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        indself=indself, selffac=colh2o * selffac, selffrac=selffrac,
        indfor=indfor, forfac=colh2o * forfac, forfrac=forfrac,
        indminor=indminor, minorfrac=minorfrac,
        fac00_sw=compfp_sw * (1.0 - ft), fac10_sw=compfp_sw * ft,
        fac01_sw=fp_raw * (1.0 - ft1), fac11_sw=fp_raw * ft1,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colch4=colch4, colo2=colo2, colbrd=colbrd, colmol=colmol,
        coldry=gc.coldry,
        rat_h2oco2=rat(1, 2, chi_jp), rat_h2oco2_1=rat(1, 2, chi_jp1),
        rat_h2oo3=rat(1, 3, chi_jp), rat_h2oo3_1=rat(1, 3, chi_jp1),
        rat_h2on2o=rat(1, 4, chi_jp), rat_h2on2o_1=rat(1, 4, chi_jp1),
        rat_h2och4=rat(1, 6, chi_jp), rat_h2och4_1=rat(1, 6, chi_jp1),
        rat_n2oco2=rat(4, 2, chi_jp), rat_n2oco2_1=rat(4, 2, chi_jp1),
        rat_o3co2=rat(3, 2, chi_jp), rat_o3co2_1=rat(3, 2, chi_jp1),
        pavel=gc.pavel,
        wx_ccl4=gc.wx_ccl4, wx_cfc11=gc.wx_cfc11, wx_cfc12=gc.wx_cfc12,
        wx_cfc22=gc.wx_cfc22,
    )
