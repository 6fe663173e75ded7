"""Longwave gas optical depths, the per-band path: 16 RRTMG-IFS bands, one
`eval_sections` call (kernel B10 on a GPU) per band.

Port of ecrad_tpu/optics/rrtmg/taumol_lw.py:29-649, the path the JAX
package runs on every backend but a TPU, at float64 everywhere, and
wherever ECRAD_FUSED_TAUMOL=0 (ifsrrtm/rrtm_taumol{1..16}.F90): per band,
the major-species k-table interpolation (with the 3-point eta scheme of
the binary species), the self/foreign water continuum, minor gases with
chi-ratio adjustments, CFC/CCl4 cross-sections and the Planck fractions,
every lookup a `Section` whose weights carry the tropopause gating, the
column amounts and the correction factors. Each band's tau and pfrac
sections go to ONE call with their tables stacked side by side along g,
each half zero-padded (`ev2`, taumol_lw.py:278-295); as there, the
padded tables are float32, at float64 too.

The port's all-band path (taumol_lw.py, kernel B1) computes the same
optical depths with the fused kernel's semantics; gas_optics takes this
one when ECRAD_FUSED_TAUMOL is "0".
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...ops.gather_interp import EtaSection, Section, eval_sections
from .setcoef import Coeffs, chi_rows_at
from .taumol_common import eta_index
from .taumol_lw import chi_adjust


def _flat(c: Coeffs) -> Coeffs:
    """Every (ncol, nlev) field as (N,)."""
    return Coeffs(*[x.reshape(-1) for x in c])


def _self_for_sections(c, selfref, forref) -> List[Section]:
    """Water-vapour self (troposphere only) and foreign continuum."""
    sf = c.tropo.to(c.selffac.dtype) * c.selffac
    return [Section(selfref, [c.indself - 1, c.indself],
                    [sf * (1.0 - c.selffrac), sf * c.selffrac]),
            Section(forref, [c.indfor - 1, c.indfor],
                    [c.forfac * (1.0 - c.forfrac), c.forfac * c.forfrac])]


def _major_noeta_section(c, absa, absb, colgas_a, colgas_b) -> Section:
    """Major-species lookup of a band without a binary species; colgas_a/b
    the column amounts below/above the tropopause."""
    tab = np.concatenate([absa, absb], axis=0)
    na = np.asarray(absa).shape[0]
    trop = c.tropo
    r0 = torch.where(trop, (c.jp - 1) * 5 + (c.jt - 1),
                     na + (c.jp - 13) * 5 + (c.jt - 1))
    r1 = torch.where(trop, c.jp * 5 + (c.jt1 - 1),
                     na + (c.jp - 12) * 5 + (c.jt1 - 1))
    w = torch.where(trop, colgas_a, colgas_b)
    return Section(tab, [r0, r0 + 1, r1, r1 + 1],
                   [w * c.fac00, w * c.fac10, w * c.fac01, w * c.fac11])


def _eta_weights_tropo(specparm, fs):
    """3-point eta weights at offsets (-1, 0, 1, 2)
    (rrtm_taumol3.F90:141-198); p**4 as (p*p)*(p*p)."""
    p_lo = fs - 1.0
    p2 = p_lo * p_lo
    p4_lo = p2 * p2
    p_hi = -fs
    p2 = p_hi * p_hi
    p4_hi = p2 * p2
    lo = specparm < 0.125
    hi = specparm > 0.875
    zero = torch.zeros_like(fs)
    wm1 = torch.where(hi, p_hi + p4_hi, zero)
    w0 = torch.where(lo, p4_lo,
                     torch.where(hi, 1.0 - p_hi - 2.0 * p4_hi, 1.0 - fs))
    w1 = torch.where(lo, 1.0 - p_lo - 2.0 * p4_lo,
                     torch.where(hi, p4_hi, fs))
    w2 = torch.where(lo, p_lo + p4_lo, zero)
    return wm1, w0, w1, w2


def _major_eta_sections(c, absa, absb, col1, col2, rat_a, rat_a1,
                        rat_b=None, rat_b1=None, col1_b=None, col2_b=None,
                        has_b=True) -> List[EtaSection]:
    """The binary-species major term: one EtaSection for the troposphere
    (absa, 9 eta rows) and with has_b one for the stratosphere (absb, 5),
    each with the jt and jt1 families."""
    trop = c.tropo
    tropf = trop.to(col1.dtype)
    speccomb = col1 + rat_a * col2
    specparm, js, fs = eta_index(col1, speccomb, 8.0)
    speccomb1 = col1 + rat_a1 * col2
    specparm1, js1, fs1 = eta_index(col1, speccomb1, 8.0)
    offs = (-1, 0, 1, 2)
    ng = np.asarray(absa).shape[-1]
    secs = [EtaSection(
        np.asarray(absa).reshape(-1, 9, ng),
        grids=[torch.where(trop, (c.jp - 1) * 5 + (c.jt - 1), 0),
               torch.where(trop, c.jp * 5 + (c.jt1 - 1), 0)],
        grid_terms=[[(0, tropf * speccomb * c.fac00),
                     (1, tropf * speccomb * c.fac10)],
                    [(0, tropf * speccomb1 * c.fac01),
                     (1, tropf * speccomb1 * c.fac11)]],
        etas=[js, js1],
        eta_terms=[list(zip(offs, _eta_weights_tropo(specparm, fs))),
                   list(zip(offs, _eta_weights_tropo(specparm1, fs1)))])]
    if not has_b:
        return secs
    c1b = col1 if col1_b is None else col1_b
    c2b = col2 if col2_b is None else col2_b
    stratf = 1.0 - tropf
    speccomb_b = c1b + rat_b * c2b
    _, jsb, fsb = eta_index(c1b, speccomb_b, 4.0)
    speccomb1_b = c1b + rat_b1 * c2b
    _, jsb1, fsb1 = eta_index(c1b, speccomb1_b, 4.0)
    secs.append(EtaSection(
        np.asarray(absb).reshape(-1, 5, ng),
        grids=[torch.where(trop, 0, (c.jp - 13) * 5 + (c.jt - 1)),
               torch.where(trop, 0, (c.jp - 12) * 5 + (c.jt1 - 1))],
        grid_terms=[[(0, stratf * speccomb_b * c.fac00),
                     (1, stratf * speccomb_b * c.fac10)],
                    [(0, stratf * speccomb1_b * c.fac01),
                     (1, stratf * speccomb1_b * c.fac11)]],
        etas=[jsb, jsb1],
        eta_terms=[[(0, 1.0 - fsb), (1, fsb)],
                   [(0, 1.0 - fsb1), (1, fsb1)]]))
    return secs


def _minor_eta_section(ktab, jm, fm, indminor, minorfrac, scale):
    """Minor gas with eta dependence; ktab (neta, 19, ng)."""
    return EtaSection(np.asarray(ktab), grids=[jm],
                      grid_terms=[[(0, scale * (1.0 - fm)), (1, scale * fm)]],
                      etas=[indminor - 1],
                      eta_terms=[[(0, 1.0 - minorfrac), (1, minorfrac)]])


def _minor_noeta_section(ktab, indminor, minorfrac, scale):
    """Minor gas without eta; ktab (19, ng)."""
    return Section(np.asarray(ktab), [indminor - 1, indminor],
                   [scale * (1.0 - minorfrac), scale * minorfrac])


def _const_section(vec, weight):
    """weight[cell] * vec[g] as a one-row lookup."""
    return Section(np.asarray(vec)[None, :],
                   [torch.zeros_like(weight, dtype=torch.int32)], [weight])


def _switch_section(vec_a, vec_b, tropo, dtype):
    """Per cell one of two constant g rows (fracrefa below the
    tropopause, fracrefb above)."""
    return Section(np.stack([np.asarray(vec_a), np.asarray(vec_b)]),
                   [torch.where(tropo, 0, 1).to(torch.int32)],
                   [torch.ones(tropo.shape, dtype=dtype,
                               device=tropo.device)])


def _pfrac_eta_sections(c, fracrefa, fracrefb, col1, rat_a, col2_a, mult_a,
                        col1_b=None, rat_b=None, col2_b=None, mult_b=4.0):
    """Eta-interpolated Planck-fraction sections; fracrefa (ng, neta_a),
    fracrefb (ng, neta_b), (ng,) constant, or None (no stratospheric
    term)."""
    tropf = c.tropo.to(col1.dtype)
    _, jpl, fpl = eta_index(col1, col1 + rat_a * col2_a, mult_a)
    secs = [Section(np.asarray(fracrefa).T, [jpl, jpl + 1],
                    [tropf * (1.0 - fpl), tropf * fpl])]
    stratf = 1.0 - tropf
    if fracrefb is None:
        return secs
    fb = np.asarray(fracrefb)
    if fb.ndim == 1:
        secs.append(_const_section(fb, stratf))
    else:
        _, jplb, fplb = eta_index(col1_b, col1_b + rat_b * col2_b, mult_b)
        secs.append(Section(fb.T, [jplb, jplb + 1],
                            [stratf * (1.0 - fplb), stratf * fplb]))
    return secs


def _gated(sec: Section, gate) -> Section:
    """A Section with every weight times gate."""
    return Section(sec.table, sec.rows, [w * gate for w in sec.weights])


def _g_scale(ng, first_g, factors, tropf, stratf, dtype):
    """Per-g stratospheric factors (1-based g from first_g): factor where
    stratospheric, 1 where tropospheric; (ng, N)."""
    scale = np.ones(ng, np.float32)
    scale[first_g - 1:first_g - 1 + len(factors)] = factors
    scale = torch.as_tensor(scale, dtype=dtype, device=tropf.device)
    return scale[:, None] * stratf[None, :] + tropf[None, :]


def taumol_lw_sections(c2: Coeffs, t: dict, toa_first: bool = False):
    """All 16 LW bands: (tau, pfrac), each (ncol, nlev, 140), levels
    surface-first, or TOA-first with toa_first, from surface-first
    coefficients and the numpy tables `t`."""
    if toa_first:
        tau, pfrac = taumol_lw_sections(c2, t)
        return tau.flip(1), pfrac.flip(1)
    ncol, nlev = c2.tropo.shape
    n = ncol * nlev
    c = _flat(c2)
    dtype = c.colh2o.dtype
    chiv = chi_rows_at(torch.as_tensor(t["chi_mls"], dtype=dtype,
                                       device=c.colh2o.device), c.jp)
    trop = c.tropo
    tropf = trop.to(dtype)
    stratf = 1.0 - tropf
    ones = torch.ones_like(tropf)
    taus, fracs = [], []

    def chi_at(gas_1b, jp_1b):
        return float(np.asarray(t["chi_mls"])[gas_1b - 1, jp_1b - 1])

    def ev2(tau_secs, pfrac_secs):
        """A band's tau and pfrac in one call: their tables side by side
        along g, each zero-padded on the other half (float32)."""
        ngb = np.asarray(tau_secs[0].table).shape[-1]

        def pad(sec, left):
            tab = np.asarray(sec.table, np.float32)
            z = np.zeros_like(tab)
            return sec._replace(table=np.concatenate(
                [tab, z] if left else [z, tab], axis=-1))

        out = eval_sections([pad(s, True) for s in tau_secs]
                            + [pad(s, False) for s in pfrac_secs], n)
        return out[:ngb], out[ngb:]

    def eta_major(band, col1, col2, rat_a, rat_a1, rat_b=None, rat_b1=None,
                  col1_b=None, col2_b=None, has_b=False):
        return _major_eta_sections(
            c, t[f"lw{band}_absa"], t[f"lw{band}_absb"] if has_b else None,
            col1, col2, rat_a, rat_a1, rat_b, rat_b1, col1_b=col1_b,
            col2_b=col2_b, has_b=has_b)

    def minor_eta_index(col1, refm, col2, mult):
        _, jm, fm = eta_index(col1, col1 + refm * col2, mult)
        return jm, fm

    # band 1: h2o, minor N2
    secs = [_major_noeta_section(c, t["lw1_absa"], t["lw1_absb"], c.colh2o,
                                 c.colh2o)]
    secs += _self_for_sections(c, t["lw1_selfref"], t["lw1_forref"])
    scalen2 = c.colbrd * c.scaleminorn2
    secs.append(_minor_noeta_section(t["lw1_kao_mn2"], c.indminor,
                                     c.minorfrac, tropf * scalen2))
    secs.append(_minor_noeta_section(t["lw1_kbo_mn2"], c.indminor,
                                     c.minorfrac, stratf * scalen2))
    tau, pf = ev2(secs, [_switch_section(t["lw1_fracrefa"],
                                         t["lw1_fracrefb"], trop, dtype)])
    corradj = torch.where(
        trop, torch.where(c.pavel < 250.0,
                          1.0 - 0.15 * (250.0 - c.pavel) / 154.4, 1.0),
        1.0 - 0.15 * (c.pavel / 95.6))
    taus.append(corradj[None, :] * tau)
    fracs.append(pf)

    # band 2: h2o; corradj2 folded into the tropospheric weights
    corradj2 = 1.0 - 0.05 * (c.pavel - 100.0) / 900.0
    wa = torch.where(trop, corradj2, 1.0)
    sec_major = _major_noeta_section(c, t["lw2_absa"], t["lw2_absb"],
                                     c.colh2o * corradj2, c.colh2o)
    sf = _self_for_sections(c, t["lw2_selfref"], t["lw2_forref"])
    tau, pf = ev2([sec_major, _gated(sf[0], corradj2), _gated(sf[1], wa)],
                  [_switch_section(t["lw2_fracrefa"], t["lw2_fracrefb"],
                                   trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # band 3: h2o+co2, minor n2o
    secs = eta_major(3, c.colh2o, c.colco2, c.rat_h2oco2, c.rat_h2oco2_1,
                     c.rat_h2oco2, c.rat_h2oco2_1, has_b=True)
    secs += _self_for_sections(c, t["lw3_selfref"], t["lw3_forref"])
    jm_a, fm_a = minor_eta_index(c.colh2o, chi_at(1, 3) / chi_at(2, 3),
                                 c.colco2, 8.0)
    jm_b, fm_b = minor_eta_index(c.colh2o, chi_at(1, 13) / chi_at(2, 13),
                                 c.colco2, 4.0)
    adjcoln2o = chi_adjust(c.coln2o, c.coldry, chiv[3], 1.5, 0.5, 0.65)
    secs.append(_minor_eta_section(t["lw3_kao_mn2o"], jm_a, fm_a,
                                   c.indminor, c.minorfrac,
                                   tropf * adjcoln2o))
    secs.append(_minor_eta_section(t["lw3_kbo_mn2o"], jm_b, fm_b,
                                   c.indminor, c.minorfrac,
                                   stratf * adjcoln2o))
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw3_fracrefa"], t["lw3_fracrefb"], c.colh2o,
        chi_at(1, 9) / chi_at(2, 9), c.colco2, 8.0, col1_b=c.colh2o,
        rat_b=chi_at(1, 13) / chi_at(2, 13), col2_b=c.colco2, mult_b=4.0))
    taus.append(tau)
    fracs.append(pf)

    # band 4: h2o+co2 / o3+co2; continuum in the troposphere only
    secs = eta_major(4, c.colh2o, c.colco2, c.rat_h2oco2, c.rat_h2oco2_1,
                     c.rat_o3co2, c.rat_o3co2_1, col1_b=c.colo3,
                     col2_b=c.colco2, has_b=True)
    sf = _self_for_sections(c, t["lw4_selfref"], t["lw4_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    tau4, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw4_fracrefa"], t["lw4_fracrefb"], c.colh2o,
        chi_at(1, 11) / chi_at(2, 11), c.colco2, 8.0, col1_b=c.colo3,
        rat_b=chi_at(3, 13) / chi_at(2, 13), col2_b=c.colco2, mult_b=4.0))
    taus.append(tau4 * _g_scale(tau4.shape[0], 8, (0.92, 0.88, 1.07, 1.1,
                                                   0.99, 0.88, 0.943),
                                tropf, stratf, dtype))
    fracs.append(pf)

    # band 5: h2o+co2 / o3+co2, minor o3, ccl4
    secs = eta_major(5, c.colh2o, c.colco2, c.rat_h2oco2, c.rat_h2oco2_1,
                     c.rat_o3co2, c.rat_o3co2_1, col1_b=c.colo3,
                     col2_b=c.colco2, has_b=True)
    sf = _self_for_sections(c, t["lw5_selfref"], t["lw5_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    jmo3, fmo3 = minor_eta_index(c.colh2o, chi_at(1, 7) / chi_at(2, 7),
                                 c.colco2, 8.0)
    secs.append(_minor_eta_section(t["lw5_kao_mo3"], jmo3, fmo3, c.indminor,
                                   c.minorfrac, tropf * c.colo3))
    secs.append(_const_section(t["lw5_ccl4"], c.wx_ccl4))
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw5_fracrefa"], t["lw5_fracrefb"], c.colh2o,
        chi_at(1, 5) / chi_at(2, 5), c.colco2, 8.0, col1_b=c.colo3,
        rat_b=chi_at(3, 43) / chi_at(2, 43), col2_b=c.colco2, mult_b=4.0))
    taus.append(tau)
    fracs.append(pf)

    # band 6: h2o; minor co2; cfc11, cfc12 (no stratospheric major)
    r0a = (c.jp - 1) * 5 + (c.jt - 1)
    r1a = c.jp * 5 + (c.jt1 - 1)
    wh = tropf * c.colh2o
    secs = [Section(np.asarray(t["lw6_absa"]),
                    [torch.where(trop, r0a, 0), torch.where(trop, r0a + 1, 0),
                     torch.where(trop, r1a, 0), torch.where(trop, r1a + 1, 0)],
                    [wh * c.fac00, wh * c.fac10, wh * c.fac01,
                     wh * c.fac11])]
    sf = _self_for_sections(c, t["lw6_selfref"], t["lw6_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    adjcolco2 = chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.77)
    secs.append(_minor_noeta_section(t["lw6_kao_mco2"], c.indminor,
                                     c.minorfrac, tropf * adjcolco2))
    secs.append(_const_section(t["lw6_cfc11adj"], c.wx_cfc11))
    secs.append(_const_section(t["lw6_cfc12"], c.wx_cfc12))
    tau, pf = ev2(secs, [_const_section(t["lw6_fracrefa"], ones)])
    taus.append(tau)
    fracs.append(pf)

    # band 7: h2o+o3 / o3 (no eta above); minor co2
    secs = eta_major(7, c.colh2o, c.colo3, c.rat_h2oo3, c.rat_h2oo3_1)
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw7_absa"])[:1]), t["lw7_absb"],
        torch.zeros_like(c.colo3), c.colo3))
    secs += _self_for_sections(c, t["lw7_selfref"], t["lw7_forref"])
    secs[3] = _gated(secs[3], tropf)
    jmco2, fmco2 = minor_eta_index(c.colh2o, chi_at(1, 3) / chi_at(3, 3),
                                   c.colo3, 8.0)
    adj_a = chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 3.0, 0.79)
    adj_b = chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.79)
    secs.append(_minor_eta_section(t["lw7_kao_mco2"], jmco2, fmco2,
                                   c.indminor, c.minorfrac, tropf * adj_a))
    secs.append(_minor_noeta_section(t["lw7_kbo_mco2"], c.indminor,
                                     c.minorfrac, stratf * adj_b))
    tau7, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw7_fracrefa"], np.asarray(t["lw7_fracrefb"]), c.colh2o,
        chi_at(1, 3) / chi_at(3, 3), c.colo3, 8.0))
    taus.append(tau7 * _g_scale(tau7.shape[0], 6, (0.92, 0.88, 1.07, 1.1,
                                                   0.99, 0.855),
                                tropf, stratf, dtype))
    fracs.append(pf)

    # band 8: h2o / o3; minors co2, o3, n2o; cfc12, cfc22
    secs = [_major_noeta_section(c, t["lw8_absa"], t["lw8_absb"], c.colh2o,
                                 c.colo3)]
    sf = _self_for_sections(c, t["lw8_selfref"], t["lw8_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    adjco2 = chi_adjust(c.colco2, c.coldry, chiv[1], 3.0, 2.0, 0.65)
    for name, scale in (("lw8_kao_mco2", tropf * adjco2),
                        ("lw8_kbo_mco2", stratf * adjco2),
                        ("lw8_kao_mo3", tropf * c.colo3),
                        ("lw8_kao_mn2o", tropf * c.coln2o),
                        ("lw8_kbo_mn2o", stratf * c.coln2o)):
        secs.append(_minor_noeta_section(t[name], c.indminor, c.minorfrac,
                                         scale))
    secs.append(_const_section(t["lw8_cfc12"], c.wx_cfc12))
    secs.append(_const_section(t["lw8_cfc22adj"], c.wx_cfc22))
    tau, pf = ev2(secs, [_switch_section(t["lw8_fracrefa"],
                                         t["lw8_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # band 9: h2o+ch4 / ch4; minor n2o
    secs = eta_major(9, c.colh2o, c.colch4, c.rat_h2och4, c.rat_h2och4_1)
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw9_absa"])[:1]), t["lw9_absb"],
        torch.zeros_like(c.colch4), c.colch4))
    sf = _self_for_sections(c, t["lw9_selfref"], t["lw9_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    jmn2o, fmn2o = minor_eta_index(c.colh2o, chi_at(1, 3) / chi_at(6, 3),
                                   c.colch4, 8.0)
    adjn2o = chi_adjust(c.coln2o, c.coldry, chiv[3], 1.5, 0.5, 0.65)
    secs.append(_minor_eta_section(t["lw9_kao_mn2o"], jmn2o, fmn2o,
                                   c.indminor, c.minorfrac, tropf * adjn2o))
    secs.append(_minor_noeta_section(t["lw9_kbo_mn2o"], c.indminor,
                                     c.minorfrac, stratf * adjn2o))
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw9_fracrefa"], np.asarray(t["lw9_fracrefb"]), c.colh2o,
        chi_at(1, 9) / chi_at(6, 9), c.colch4, 8.0))
    taus.append(tau)
    fracs.append(pf)

    # band 10: h2o
    secs = [_major_noeta_section(c, t["lw10_absa"], t["lw10_absb"],
                                 c.colh2o, c.colh2o)]
    secs += _self_for_sections(c, t["lw10_selfref"], t["lw10_forref"])
    tau, pf = ev2(secs, [_switch_section(t["lw10_fracrefa"],
                                         t["lw10_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # band 11: h2o; minor o2
    secs = [_major_noeta_section(c, t["lw11_absa"], t["lw11_absb"],
                                 c.colh2o, c.colh2o)]
    secs += _self_for_sections(c, t["lw11_selfref"], t["lw11_forref"])
    scaleo2 = c.colo2 * c.scaleminor
    secs.append(_minor_noeta_section(t["lw11_kao_mo2"], c.indminor,
                                     c.minorfrac, tropf * scaleo2))
    secs.append(_minor_noeta_section(t["lw11_kbo_mo2"], c.indminor,
                                     c.minorfrac, stratf * scaleo2))
    tau, pf = ev2(secs, [_switch_section(t["lw11_fracrefa"],
                                         t["lw11_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # band 12: h2o+co2, troposphere only
    secs = eta_major(12, c.colh2o, c.colco2, c.rat_h2oco2, c.rat_h2oco2_1)
    sf = _self_for_sections(c, t["lw12_selfref"], t["lw12_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw12_fracrefa"], None, c.colh2o,
        chi_at(1, 10) / chi_at(2, 10), c.colco2, 8.0))
    taus.append(tau)
    fracs.append(pf)

    # band 13: h2o+n2o; minor co2; stratospheric minor o3 (the CO term
    # vanishes: the IFS supplies no CO)
    secs = eta_major(13, c.colh2o, c.coln2o, c.rat_h2on2o, c.rat_h2on2o_1)
    sf = _self_for_sections(c, t["lw13_selfref"], t["lw13_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    jmco2, fmco2 = minor_eta_index(c.colh2o, chi_at(1, 1) / chi_at(4, 1),
                                   c.coln2o, 8.0)
    adjco2 = chi_adjust(c.colco2, c.coldry, 3.55e-4, 3.0, 2.0, 0.68)
    secs.append(_minor_eta_section(t["lw13_kao_mco2"], jmco2, fmco2,
                                   c.indminor, c.minorfrac, tropf * adjco2))
    secs.append(_minor_noeta_section(t["lw13_kbo_mo3"], c.indminor,
                                     c.minorfrac, stratf * c.colo3))
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw13_fracrefa"], np.asarray(t["lw13_fracrefb"]), c.colh2o,
        chi_at(1, 5) / chi_at(4, 5), c.coln2o, 8.0))
    taus.append(tau)
    fracs.append(pf)

    # band 14: co2
    secs = [_major_noeta_section(c, t["lw14_absa"], t["lw14_absb"],
                                 c.colco2, c.colco2)]
    sf = _self_for_sections(c, t["lw14_selfref"], t["lw14_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    tau, pf = ev2(secs, [_switch_section(t["lw14_fracrefa"],
                                         t["lw14_fracrefb"], trop, dtype)])
    taus.append(tau)
    fracs.append(pf)

    # band 15: n2o+co2; minor n2, troposphere only
    secs = eta_major(15, c.coln2o, c.colco2, c.rat_n2oco2, c.rat_n2oco2_1)
    sf = _self_for_sections(c, t["lw15_selfref"], t["lw15_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    jmn2, fmn2 = minor_eta_index(c.coln2o, chi_at(4, 1) / chi_at(2, 1),
                                 c.colco2, 8.0)
    secs.append(_minor_eta_section(t["lw15_kao_mn2"], jmn2, fmn2,
                                   c.indminor, c.minorfrac,
                                   tropf * (c.colbrd * c.scaleminor)))
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw15_fracrefa"], None, c.coln2o,
        chi_at(4, 1) / chi_at(2, 1), c.colco2, 8.0))
    taus.append(tau)
    fracs.append(pf)

    # band 16: h2o+ch4 / ch4
    secs = eta_major(16, c.colh2o, c.colch4, c.rat_h2och4, c.rat_h2och4_1)
    secs.append(_major_noeta_section(
        c, np.zeros_like(np.asarray(t["lw16_absa"])[:1]), t["lw16_absb"],
        torch.zeros_like(c.colch4), c.colch4))
    sf = _self_for_sections(c, t["lw16_selfref"], t["lw16_forref"])
    secs += [sf[0], _gated(sf[1], tropf)]
    tau, pf = ev2(secs, _pfrac_eta_sections(
        c, t["lw16_fracrefa"], np.asarray(t["lw16_fracrefb"]), c.colh2o,
        chi_at(1, 6) / chi_at(6, 6), c.colch4, 8.0))
    taus.append(tau)
    fracs.append(pf)

    tau = torch.cat(taus, 0).reshape(140, ncol, nlev).permute(1, 2, 0)
    pfrac = torch.cat(fracs, 0).reshape(140, ncol, nlev).permute(1, 2, 0)
    return tau.contiguous(), pfrac.contiguous()
