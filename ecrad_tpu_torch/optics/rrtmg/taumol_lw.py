"""All-band LW taumol: kernel B1 wrapper and its plain PyTorch version.

Replaces ecrad_tpu/optics/rrtmg/taumol_lw_fused.py: `pack_coeffs`
(:368-397) and `taumol_lw_fused(..., toa_first=True)` (:908-931), whose
Pallas kernel is `_taumol_lw_fused_flat` (:832, body `lw_fused_body`
:512). It computes the 16-band LW optical depth and Planck fraction of
every cell: (jp, jt) k-table interpolation with 3-point (troposphere)
and 2-point (stratosphere) eta interpolation for binary species, the
water-vapour self/foreign continuum, minor gases with chi adjustments,
and CFC/CCl4 cross-sections (ifsrrtm/rrtm_taumol{1..16}.F90).

Semantics are the JAX fused body's, restated as the row gathers of
taumol_common (phase 1: per-band terms; phase 2: gather-sum), so the
kernel csrc/taumol_lw.cu and `taumol_lw_plain` compute the same terms
in the same order. On a CPU tensor `taumol_lw` runs the plain version;
on a CUDA tensor it launches the kernel (float32 only) or raises.

On the H100 the kernel's floor is its 2 x 140 float stores per cell. A
block takes a tile of 32 cells; each of its 4 warps builds the terms of
a fixed list of bands with one lane per cell (a warp-uniform band switch)
and sums that band's outputs into the tile's rows in shared memory, which
the block then writes out whole (csrc/taumol_lw.cu).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ...utils import hooks
from . import fused_tables as ft
from .setcoef import Coeffs, chi_rows_at
from .taumol_common import (DeviceTables, Terms, Term, eta_index,
                            gather_sum)

NG_LW = 140
NG = ft.NG_LW_BAND
G_OFF = ft.G_OFF_LW
#: term slots per band (tau, pfrac); csrc/taumol_lw.cu has the same
K_TAU = [10, 8, 20, 16, 21, 12, 20, 16, 20, 8, 10, 16, 20, 8, 20, 16]
K_PF = [1, 1, 2, 2, 2, 1, 2, 1, 2, 1, 1, 2, 2, 1, 2, 2]

# Order of the packed per-cell fields (taumol_lw_fused.py:351-363)
F_FIELDS = [
    "tropf", "fac00", "fac10", "fac01", "fac11",
    "selffac", "selffrac", "forfac", "forfrac",
    "minorfrac", "scaleminor", "scaleminorn2",
    "colh2o", "colco2", "colo3", "coln2o", "colch4", "colo2",
    "colbrd", "coldry",
    "rat_h2oco2", "rat_h2oco2_1", "rat_h2oo3", "rat_h2oo3_1",
    "rat_h2on2o", "rat_h2on2o_1", "rat_h2och4", "rat_h2och4_1",
    "rat_n2oco2", "rat_n2oco2_1", "rat_o3co2", "rat_o3co2_1",
    "pavel", "wx_ccl4", "wx_cfc11", "wx_cfc12", "wx_cfc22",
    "chi_co2", "chi_n2o",
]
I_FIELDS = ["jp", "jt", "jt1", "indself", "indfor", "indminor"]

#: launches of the CUDA kernel (incremented only where it is launched)
launches = 0


def pack_coeffs(c: Coeffs, chi_mls) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NF, N) float and (NI, N) int32 per-cell inputs from (ncol, nlev)
    coefficients, cells in row-major (column, level) order."""
    dt = c.colh2o.dtype
    chi = hooks.upload("taumol_lw", chi_mls, c.colh2o.device, dt)
    chiv = chi_rows_at(chi, c.jp)       # chi_mls at JP+1 per gas
    vals = dict(c._asdict())
    vals["tropf"] = c.tropo.to(dt)
    vals["chi_co2"], vals["chi_n2o"] = chiv[1], chiv[3]
    fc = torch.stack([vals[n].reshape(-1) for n in F_FIELDS])
    ic = torch.stack([getattr(c, n).reshape(-1).to(torch.int32)
                      for n in I_FIELDS])
    return fc.contiguous(), ic.contiguous()


def chi_adjust(col, coldry, ref, thresh, base, expo):
    """Chi-ratio column adjustment of a minor gas
    (e.g. rrtm_taumol3.F90:115-122), x**expo as exp(expo log x)."""
    rat = 1.0e20 * (col / coldry) / ref
    base_p = torch.clamp(rat - base, min=1e-30)
    adjcol = (base + torch.exp(expo * torch.log(base_p))) * ref * coldry \
        * 1.0e-20
    return torch.where(rat > thresh, adjcol, col)


def _eta3_weights(specparm, fs):
    """First eta row and the three weights of the 3-point scheme
    (rrtm_taumol3.F90:141-198): rows js..js+2 near specparm 0,
    js-1..js+1 near 1, and js..js+1 linear in between."""
    p_lo = fs - 1.0
    p2 = p_lo * p_lo
    p4_lo = p2 * p2
    p_hi = -fs
    p2 = p_hi * p_hi
    p4_hi = p2 * p2
    lo = specparm < 0.125
    hi = specparm > 0.875
    w0 = torch.where(lo, p4_lo, torch.where(hi, p_hi + p4_hi, 1.0 - fs))
    w1 = torch.where(lo, 1.0 - p_lo - 2.0 * p4_lo,
                     torch.where(hi, 1.0 - p_hi - 2.0 * p4_hi, fs))
    w2 = torch.where(lo, p_lo + p4_lo,
                     torch.where(hi, p4_hi, torch.zeros_like(fs)))
    return hi, (w0, w1, w2)


def lw_terms(fc: torch.Tensor, ic: torch.Tensor, flat: ft.FlatTables,
             consts) -> Tuple[List[List[Term]], List[List[Term]]]:
    """Phase 1: per band, the tau terms and the pfrac terms."""
    f = {n: fc[i] for i, n in enumerate(F_FIELDS)}
    jp, jt, jt1, indself, indfor, indminor = (ic[i] for i in range(6))
    kc = {name: float(v) for (name, _, _), v in zip(ft.LW_CONSTS, consts)}
    tb = Terms(flat, f["tropf"])
    tropf = f["tropf"]
    tropo = tropf > 0.0
    f00, f10, f01, f11 = f["fac00"], f["fac10"], f["fac01"], f["fac11"]
    colh2o, colco2, colo3 = f["colh2o"], f["colco2"], f["colo3"]
    coln2o, colch4, colo2 = f["coln2o"], f["colch4"], f["colo2"]
    colbrd, coldry, pavel = f["colbrd"], f["coldry"], f["pavel"]

    grid0 = (jp - 1) * 5 + (jt - 1)
    grid1 = jp * 5 + (jt1 - 1)
    grid0b = (jp - 13) * 5 + (jt - 1)
    grid1b = (jp - 12) * 5 + (jt1 - 1)

    def major_noeta(name, ng, strat, w):
        g0, g1 = (grid0b, grid1b) if strat else (grid0, grid1)
        return [tb.term(name, ng, g0, w * f00),
                tb.term(name, ng, g0 + 1, w * f10),
                tb.term(name, ng, g1, w * f01),
                tb.term(name, ng, g1 + 1, w * f11)]

    def major_eta3(b, col1, col2, rat0, rat1):
        """Tropospheric binary-species lookup, 2 x 2 x 3 terms."""
        name, ng, out = f"absa{b}", NG[b - 1], []
        for g, fa, fb, rat in ((grid0, f00, f10, rat0),
                               (grid1, f01, f11, rat1)):
            sc = col1 + rat * col2
            sp, js, fs = eta_index(col1, sc, 8.0)
            hi, ew = _eta3_weights(sp, fs)
            e0 = torch.where(hi, js - 1, js)
            for gg, gw in ((g, fa), (g + 1, fb)):
                for eo in range(3):
                    e = e0 + eo
                    ok = (gg >= 0) & (gg < 65) & (e >= 0) & (e < 9)
                    out.append(tb.term(name, ng, gg * 9 + e,
                                       sc * gw * ew[eo], ok))
        return out

    def major_eta2(b, col1, col2, rat0, rat1):
        """Stratospheric binary-species lookup, 2 x 2 x 2 terms."""
        name, ng, out = f"absb{b}", NG[b - 1], []
        for g, fa, fb, rat in ((grid0b, f00, f10, rat0),
                               (grid1b, f01, f11, rat1)):
            sc = col1 + rat * col2
            _, js, fs = eta_index(col1, sc, 4.0)
            for gg, gw in ((g, fa), (g + 1, fb)):
                for e, ew in ((js, 1.0 - fs), (js + 1, fs)):
                    ok = (gg >= 0) & (gg < 235) & (e >= 0) & (e < 5)
                    out.append(tb.term(name, ng, gg * 5 + e, sc * gw * ew,
                                       ok))
        return out

    sf = tropf * f["selffac"]
    ff = f["forfac"]

    def self_(b):
        return tb.pair(f"self{b}", NG[b - 1], indself - 1, sf,
                       f["selffrac"])

    def for_(b, w=None):
        return tb.pair(f"for{b}", NG[b - 1], indfor - 1,
                       ff if w is None else ff * w, f["forfrac"])

    def minor(name, b, w):
        return tb.pair(name, NG[b - 1], indminor - 1, w, f["minorfrac"])

    def minor_eta(name, b, r1, col1, refm, col2, mult, w):
        """Minor gas with eta dependence: table (r1, 19, ng)."""
        _, jm, fm = eta_index(col1, col1 + refm * col2, mult)
        mfrac = f["minorfrac"]
        out = []
        for j, bw in ((jm, 1.0 - fm), (jm + 1, fm)):
            ok = (j >= 0) & (j < r1)
            for r, mw in ((indminor - 1, 1.0 - mfrac), (indminor, mfrac)):
                out.append(tb.term(name, NG[b - 1], j * 19 + r,
                                   w * bw * mw, ok))
        return out

    def pf_eta(b, table, col1, refm, col2, mult):
        _, jpl, fpl = eta_index(col1, col1 + refm * col2, mult)
        return tb.pair(f"{table}{b}", NG[b - 1], jpl, torch.ones_like(fpl),
                       fpl)

    def pf_const(b, table):
        return [tb.const(f"{table}{b}", NG[b - 1], torch.ones_like(tropf))]

    adjcoln2o = chi_adjust(coln2o, coldry, f["chi_n2o"], 1.5, 0.5, 0.65)
    adjco2_b6 = chi_adjust(colco2, coldry, f["chi_co2"], 3.0, 2.0, 0.77)
    adjco2_b7a = chi_adjust(colco2, coldry, f["chi_co2"], 3.0, 3.0, 0.79)
    adjco2_b7b = chi_adjust(colco2, coldry, f["chi_co2"], 3.0, 2.0, 0.79)
    adjco2_b8 = chi_adjust(colco2, coldry, f["chi_co2"], 3.0, 2.0, 0.65)
    adjco2_b13 = chi_adjust(colco2, coldry, 3.55e-4, 3.0, 2.0, 0.68)
    scalen2 = colbrd * f["scaleminorn2"]
    scaleo2 = colo2 * f["scaleminor"]
    scalen2_15 = colbrd * f["scaleminor"]
    corradj1 = torch.where(
        tropo,
        torch.where(pavel < 250.0, 1.0 - 0.15 * (250.0 - pavel) / 154.4,
                    torch.ones_like(pavel)),
        1.0 - 0.15 * (pavel / 95.6))
    corradj2 = 1.0 - 0.05 * (pavel - 100.0) / 900.0
    wa2 = torch.where(tropo, corradj2, torch.ones_like(corradj2))
    rat = {n: f[n] for n in F_FIELDS if n.startswith("rat_")}

    def r(name):
        return rat[name], rat[name + "_1"]

    def gated_for(b):
        return for_(b, tropf)

    tau: List[Tuple[list, list]] = []
    pf: List[Tuple[list, list]] = []
    # band 1: h2o, minor N2; everything times corradj1
    t = major_noeta("absa1", 10, False, colh2o) + self_(1) + for_(1) \
        + minor("lw1_kao_mn2", 1, scalen2)
    s = major_noeta("absb1", 10, True, colh2o) + self_(1) + for_(1) \
        + minor("lw1_kbo_mn2", 1, scalen2)
    tau.append(([(bb, w * corradj1) for bb, w in t],
                [(bb, w * corradj1) for bb, w in s]))
    pf.append((pf_const(1, "pfa"), pf_const(1, "pfb")))
    # band 2: h2o; corradj2 on the tropospheric terms
    sf2 = [(bb, w * corradj2) for bb, w in self_(2)]
    tau.append((major_noeta("absa2", 12, False, colh2o * corradj2) + sf2
                + for_(2, wa2),
                major_noeta("absb2", 12, True, colh2o) + sf2
                + for_(2, wa2)))
    pf.append((pf_const(2, "pfa"), pf_const(2, "pfb")))
    # band 3: h2o+co2, minor n2o
    tau.append((
        major_eta3(3, colh2o, colco2, *r("rat_h2oco2")) + self_(3) + for_(3)
        + minor_eta("lw3_kao_mn2o", 3, 9, colh2o, kc["b3_refm_a"], colco2,
                    8.0, adjcoln2o),
        major_eta2(3, colh2o, colco2, *r("rat_h2oco2")) + [tb.zero] * 4
        + self_(3) + for_(3)
        + minor_eta("lw3_kbo_mn2o", 3, 5, colh2o, kc["b3_refm_b"], colco2,
                    4.0, adjcoln2o)))
    pf.append((pf_eta(3, "pfa", colh2o, kc["pf3_a"], colco2, 8.0),
               pf_eta(3, "pfb", colh2o, kc["pf3_b"], colco2, 4.0)))
    # band 4: h2o+co2 / o3+co2 (strat g-factors folded into absb4)
    tau.append((
        major_eta3(4, colh2o, colco2, *r("rat_h2oco2")) + self_(4)
        + gated_for(4),
        major_eta2(4, colo3, colco2, *r("rat_o3co2")) + [tb.zero] * 4
        + self_(4) + gated_for(4)))
    pf.append((pf_eta(4, "pfa", colh2o, kc["pf4_a"], colco2, 8.0),
               pf_eta(4, "pfb", colo3, kc["pf4_b"], colco2, 4.0)))
    # band 5: h2o+co2 / o3+co2, minor o3, ccl4
    ccl4 = [tb.const("lw5_ccl4", 16, f["wx_ccl4"])]
    tau.append((
        major_eta3(5, colh2o, colco2, *r("rat_h2oco2")) + self_(5)
        + gated_for(5)
        + minor_eta("lw5_kao_mo3", 5, 9, colh2o, kc["b5_refm_a"], colco2,
                    8.0, colo3) + ccl4,
        major_eta2(5, colo3, colco2, *r("rat_o3co2")) + [tb.zero] * 4
        + self_(5) + gated_for(5) + [tb.zero] * 4 + ccl4))
    pf.append((pf_eta(5, "pfa", colh2o, kc["pf5_a"], colco2, 8.0),
               pf_eta(5, "pfb", colo3, kc["pf5_b"], colco2, 4.0)))
    # band 6: h2o; minor co2; cfc11, cfc12 (no strat major)
    cfc6 = [tb.const("lw6_cfc11adj", 8, f["wx_cfc11"]),
            tb.const("lw6_cfc12", 8, f["wx_cfc12"])]
    tau.append((
        major_noeta("absa6", 8, False, colh2o) + self_(6) + gated_for(6)
        + minor("lw6_kao_mco2", 6, adjco2_b6) + cfc6,
        [tb.zero] * 4 + self_(6) + gated_for(6) + [tb.zero] * 2 + cfc6))
    pf.append((pf_const(6, "pfa"), pf_const(6, "pfb")))
    # band 7: h2o+o3 / o3; minor co2 (strat g-factors folded in)
    tau.append((
        major_eta3(7, colh2o, colo3, *r("rat_h2oo3")) + self_(7)
        + gated_for(7)
        + minor_eta("lw7_kao_mco2", 7, 9, colh2o, kc["b7_refm_a"], colo3,
                    8.0, adjco2_b7a),
        major_noeta("absb7", 12, True, colo3) + [tb.zero] * 8 + self_(7)
        + gated_for(7) + minor("lw7_kbo_mco2", 7, adjco2_b7b)))
    pf.append((pf_eta(7, "pfa", colh2o, kc["pf7_a"], colo3, 8.0),
               pf_const(7, "pfb")))
    # band 8: h2o / o3; minors co2, o3, n2o; cfc12, cfc22
    cfc8 = [tb.const("lw8_cfc12", 8, f["wx_cfc12"]),
            tb.const("lw8_cfc22adj", 8, f["wx_cfc22"])]
    tau.append((
        major_noeta("absa8", 8, False, colh2o) + self_(8) + gated_for(8)
        + minor("lw8_kao_mco2", 8, adjco2_b8)
        + minor("lw8_kao_mo3", 8, colo3)
        + minor("lw8_kao_mn2o", 8, coln2o) + cfc8,
        major_noeta("absb8", 8, True, colo3) + self_(8) + gated_for(8)
        + minor("lw8_kbo_mco2", 8, adjco2_b8) + [tb.zero] * 2
        + minor("lw8_kbo_mn2o", 8, coln2o) + cfc8))
    pf.append((pf_const(8, "pfa"), pf_const(8, "pfb")))
    # band 9: h2o+ch4 / ch4; minor n2o
    tau.append((
        major_eta3(9, colh2o, colch4, *r("rat_h2och4")) + self_(9)
        + gated_for(9)
        + minor_eta("lw9_kao_mn2o", 9, 9, colh2o, kc["b9_refm_a"], colch4,
                    8.0, adjcoln2o),
        major_noeta("absb9", 12, True, colch4) + [tb.zero] * 8 + self_(9)
        + gated_for(9) + minor("lw9_kbo_mn2o", 9, adjcoln2o)))
    pf.append((pf_eta(9, "pfa", colh2o, kc["pf9_a"], colch4, 8.0),
               pf_const(9, "pfb")))
    # band 10: h2o
    tau.append((major_noeta("absa10", 6, False, colh2o) + self_(10)
                + for_(10),
                major_noeta("absb10", 6, True, colh2o) + self_(10)
                + for_(10)))
    pf.append((pf_const(10, "pfa"), pf_const(10, "pfb")))
    # band 11: h2o; minor o2
    tau.append((major_noeta("absa11", 8, False, colh2o) + self_(11)
                + for_(11) + minor("lw11_kao_mo2", 11, scaleo2),
                major_noeta("absb11", 8, True, colh2o) + self_(11)
                + for_(11) + minor("lw11_kbo_mo2", 11, scaleo2)))
    pf.append((pf_const(11, "pfa"), pf_const(11, "pfb")))
    # band 12: h2o+co2, troposphere only
    tau.append((major_eta3(12, colh2o, colco2, *r("rat_h2oco2"))
                + self_(12) + gated_for(12),
                [tb.zero] * 12 + self_(12) + gated_for(12)))
    pf.append((pf_eta(12, "pfa", colh2o, kc["pf12_a"], colco2, 8.0),
               []))
    # band 13: h2o+n2o; minor co2; strat minor o3
    tau.append((
        major_eta3(13, colh2o, coln2o, *r("rat_h2on2o")) + self_(13)
        + gated_for(13)
        + minor_eta("lw13_kao_mco2", 13, 9, colh2o, kc["b13_refm_a"],
                    coln2o, 8.0, adjco2_b13),
        [tb.zero] * 12 + self_(13) + gated_for(13)
        + minor("lw13_kbo_mo3", 13, colo3)))
    pf.append((pf_eta(13, "pfa", colh2o, kc["pf13_a"], coln2o, 8.0),
               pf_const(13, "pfb")))
    # band 14: co2
    tau.append((major_noeta("absa14", 2, False, colco2) + self_(14)
                + gated_for(14),
                major_noeta("absb14", 2, True, colco2) + self_(14)
                + gated_for(14)))
    pf.append((pf_const(14, "pfa"), pf_const(14, "pfb")))
    # band 15: n2o+co2; minor n2, troposphere only
    tau.append((
        major_eta3(15, coln2o, colco2, *r("rat_n2oco2")) + self_(15)
        + gated_for(15)
        + minor_eta("lw15_kao_mn2", 15, 9, coln2o, kc["b15_refm_a"],
                    colco2, 8.0, scalen2_15),
        [tb.zero] * 12 + self_(15) + gated_for(15)))
    pf.append((pf_eta(15, "pfa", coln2o, kc["pf15_a"], colco2, 8.0),
               []))
    # band 16: h2o+ch4 / ch4
    tau.append((major_eta3(16, colh2o, colch4, *r("rat_h2och4"))
                + self_(16) + gated_for(16),
                major_noeta("absb16", 2, True, colch4) + [tb.zero] * 8
                + self_(16) + gated_for(16)))
    pf.append((pf_eta(16, "pfa", colh2o, kc["pf16_a"], colch4, 8.0),
               pf_const(16, "pfb")))

    tau_terms = [tb.merge(tropo, t, s, K_TAU[i])
                 for i, (t, s) in enumerate(tau)]
    pf_terms = [tb.merge(tropo, t, s, K_PF[i])
                for i, (t, s) in enumerate(pf)]
    return tau_terms, pf_terms


def taumol_lw_plain(fc: torch.Tensor, ic: torch.Tensor,
                    tables: DeviceTables
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1: (tau, pfrac), each (N, 140)."""
    n = fc.shape[1]
    tau_terms, pf_terms = lw_terms(fc, ic, tables.flat,
                                   tables.flat.consts)
    tau = torch.cat([gather_sum(tables.tab, tau_terms[b], NG[b], n)
                     for b in range(16)], 1)
    pfrac = torch.cat([gather_sum(tables.tab, pf_terms[b], NG[b], n)
                       for b in range(16)], 1)
    return tau, pfrac


def taumol_lw_kernel(fc: torch.Tensor, ic: torch.Tensor,
                     tables: DeviceTables
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (csrc/taumol_lw.cu) on CUDA float32 tensors."""
    global launches
    from ...ops import _cuda
    n = fc.shape[1]
    _cuda.check(fc, torch.float32, (len(F_FIELDS), n), "fc")
    _cuda.check(ic, torch.int32, (len(I_FIELDS), n), "ic")
    _cuda.check(tables.tab, torch.float32, None, "tab")
    _cuda.check(tables.meta, torch.int32, (2, len(tables.flat.names)),
                "meta")
    _cuda.check(tables.consts, torch.float32, (len(ft.LW_CONSTS),),
                "consts")
    tau = torch.empty((n, NG_LW), dtype=torch.float32, device=fc.device)
    pfrac = torch.empty_like(tau)
    _cuda.launch("taumol_lw", fc, ic, tables.tab, tables.meta,
                 tables.consts, n, tau, pfrac)
    launches += 1
    return tau, pfrac


def taumol_lw(fc, ic, tables: DeviceTables):
    """(tau, pfrac), each (N, 140): the plain version on a CPU tensor,
    kernel B1 on any other (which raises unless it is CUDA float32)."""
    if fc.device.type == "cpu":
        return taumol_lw_plain(fc, ic, tables)
    return taumol_lw_kernel(fc, ic, tables)


def taumol_lw_cells(c2: Coeffs, chi_mls, tables: DeviceTables):
    """The JAX taumol_lw_fused(c2, t, toa_first=True): (tau, pfrac) as
    TOA-first (ncol, nlev, 140) from surface-first coefficients."""
    ncol, nlev = c2.tropo.shape
    fc, ic = pack_coeffs(c2.flip_levels(), chi_mls)
    tau, pfrac = taumol_lw(fc, ic, tables)
    return tau.reshape(ncol, nlev, NG_LW), pfrac.reshape(ncol, nlev, NG_LW)
