"""Shortwave gas and Rayleigh optical depths, the per-band path: 14
RRTMG-IFS bands, one `eval_sections` call (kernel B10 on a GPU) per band
with gas absorption, plus one for band 24's Rayleigh term.

Port of ecrad_tpu/optics/rrtmg/taumol_sw.py:28-368
(ifsrrtm/srtm_taumol{16..29}.F90), the path the JAX package runs on every
backend but a TPU, at float64 everywhere, and wherever
ECRAD_FUSED_TAUMOL=0: per band, the major-species lookups (a 2-point eta
interpolation shared by both temperature families for the binary
species), the self/foreign continuum, constant cross-sections, and the
Rayleigh optical depth (a constant or per-g coefficient times colmol;
band 24's eta-interpolated). Band 26 is pure Rayleigh.

The solar source (SFLUXZEN at the LAYSOLFR layer, taumol_sw.py:52-84 and
the per-band calls) is the same function on both paths and is computed
by taumol_sw.solar_source. The port's all-band path (taumol_sw.py,
kernel B2) computes the same optical depths with the fused kernel's
semantics; gas_optics takes this one when ECRAD_FUSED_TAUMOL is "0".
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.gather_interp import EtaSection, Section, eval_sections
from .setcoef import Coeffs
from .taumol_common import eta_index
from .taumol_sw import solar_source

O2ADJ = 1.6


def taumol_sw_sections(c2: Coeffs, tables, toa_first: bool = False):
    """All 14 SW bands: (taug, taur) each (ncol, nlev, 112), levels
    surface-first, or TOA-first with toa_first, and sfluxzen (ncol, 112),
    from surface-first coefficients and the GasTables (their numpy
    tables `t` for the sections)."""
    t = tables.t
    dtype, dev = c2.colh2o.dtype, c2.colh2o.device
    ncol, nlev = c2.colh2o.shape
    n = ncol * nlev
    fl = lambda x: x.reshape(-1)                     # noqa: E731
    trop = fl(c2.tropo)
    tropf = trop.to(dtype)
    stratf = 1.0 - tropf
    jp, jt, jt1 = fl(c2.jp), fl(c2.jt), fl(c2.jt1)
    f00, f10 = fl(c2.fac00_sw), fl(c2.fac10_sw)
    f01, f11 = fl(c2.fac01_sw), fl(c2.fac11_sw)
    colmol = fl(c2.colmol)

    def self_for(band, gate_for_strat):
        """Self (troposphere) and foreign continuum; the foreign term
        above the tropopause too unless gate_for_strat is False."""
        sf = tropf * fl(c2.selffac)
        ff = fl(c2.forfac) * (1.0 if gate_for_strat else tropf)
        indself, selffrac = fl(c2.indself), fl(c2.selffrac)
        indfor, forfrac = fl(c2.indfor), fl(c2.forfrac)
        return [Section(np.asarray(t[f"sw{band}_selfref"]),
                        [indself - 1, indself],
                        [sf * (1.0 - selffrac), sf * selffrac]),
                Section(np.asarray(t[f"sw{band}_forref"]),
                        [indfor - 1, indfor],
                        [ff * (1.0 - forfrac), ff * forfrac])]

    def eta_section(absa, col1, col2, strrat, strat):
        """The binary-species lookup as an EtaSection (9 eta rows below
        the tropopause, 5 above); also its (js, fs)."""
        _, js, fs = eta_index(fl(col1), fl(col1 + strrat * col2),
                              4.0 if strat else 8.0)
        sc = fl(col1 + strrat * col2) * (stratf if strat else tropf)
        if strat:
            grids = [torch.where(trop, 0, (jp - 13) * 5 + (jt - 1)),
                     torch.where(trop, 0, (jp - 12) * 5 + (jt1 - 1))]
        else:
            grids = [torch.where(trop, (jp - 1) * 5 + (jt - 1), 0),
                     torch.where(trop, jp * 5 + (jt1 - 1), 0)]
        ng = np.asarray(absa).shape[-1]
        ew = [(0, 1.0 - fs), (1, fs)]
        return EtaSection(np.asarray(absa).reshape(-1, 5 if strat else 9,
                                                   ng),
                          grids=grids,
                          grid_terms=[[(0, sc * f00), (1, sc * f10)],
                                      [(0, sc * f01), (1, sc * f11)]],
                          etas=[js, js], eta_terms=[ew, ew]), js, fs

    def noeta(absx, col, strat):
        w = fl(col) * (stratf if strat else tropf)
        if strat:
            r0 = torch.where(trop, 0, (jp - 13) * 5 + (jt - 1))
            r1 = torch.where(trop, 0, (jp - 12) * 5 + (jt1 - 1))
        else:
            r0 = torch.where(trop, (jp - 1) * 5 + (jt - 1), 0)
            r1 = torch.where(trop, jp * 5 + (jt1 - 1), 0)
        return Section(np.asarray(absx), [r0, r0 + 1, r1, r1 + 1],
                       [w * f00, w * f10, w * f01, w * f11])

    def const(vec, weight):
        return Section(np.asarray(vec, np.float32)[None, :],
                       [torch.zeros_like(weight, dtype=torch.int32)],
                       [weight])

    def ng_of(band):
        return np.asarray(t[f"sw{band}_absa"]).shape[1]

    def rayl_const(band):
        """taur of a scalar Rayleigh coefficient: (ng, N)."""
        r = float(t[f"sw{band}_rayl"])
        return (colmol * r)[None, :].expand(ng_of(band), n)

    def rayl_per_g(band):
        rc = torch.as_tensor(np.asarray(t[f"sw{band}_rayl"]), dtype=dtype,
                             device=dev)
        return rc[:, None] * colmol[None, :]

    def scalar(band, name="strrat"):
        return float(t[f"sw{band}_{name}"])

    a = lambda b: t[f"sw{b}_absa"]                   # noqa: E731
    b_ = lambda b: t[f"sw{b}_absb"]                  # noqa: E731
    h2o, co2, o3 = c2.colh2o, c2.colco2, c2.colo3
    ch4, o2 = c2.colch4, c2.colo2
    taug, taur = {}, {}

    # band 16: h2o+ch4 / ch4
    secs = [eta_section(a(16), h2o, ch4, scalar(16, "strrat1"), False)[0],
            noeta(b_(16), ch4, True)] + self_for(16, False)
    taug[16], taur[16] = eval_sections(secs, n), rayl_const(16)
    # band 17: h2o+co2 / h2o+co2
    secs = [eta_section(a(17), h2o, co2, scalar(17), False)[0],
            eta_section(b_(17), h2o, co2, scalar(17), True)[0]] \
        + self_for(17, True)
    taug[17], taur[17] = eval_sections(secs, n), rayl_const(17)
    # bands 18, 19 (no eta above) and 21
    for band, col2, strat_eta in ((18, ch4, False), (19, co2, False),
                                  (21, co2, True)):
        secs = [eta_section(a(band), h2o, col2, scalar(band), False)[0]]
        if strat_eta:
            secs += [eta_section(b_(band), h2o, col2, scalar(band),
                                 True)[0]] + self_for(band, True)
        else:
            secs += [noeta(b_(band), col2, True)] + self_for(band, False)
        taug[band], taur[band] = eval_sections(secs, n), rayl_const(band)
    # band 20: h2o, ch4 cross-section
    secs = [noeta(a(20), h2o, False), noeta(b_(20), h2o, True)] \
        + self_for(20, True) + [const(t["sw20_absch4"], fl(ch4))]
    taug[20], taur[20] = eval_sections(secs, n), rayl_const(20)
    # band 22: h2o+o2 / o2, o2 continuum
    secs = [eta_section(a(22), h2o, O2ADJ * o2, scalar(22), False)[0],
            noeta(b_(22), O2ADJ * o2, True)] + self_for(22, False)
    secs.append(const(np.ones(ng_of(22)), fl(4.35e-4 * o2 / (350.0 * 2.0))))
    taug[22], taur[22] = eval_sections(secs, n), rayl_const(22)
    # band 23: h2o, per-g Rayleigh
    secs = [noeta(a(23), scalar(23, "givfac") * h2o, False)] \
        + self_for(23, False)
    taug[23], taur[23] = eval_sections(secs, n), rayl_per_g(23)
    # band 24: h2o+o2 / o2, o3 cross-sections, eta-interpolated Rayleigh
    sec_a, js, fs = eta_section(a(24), h2o, o2, scalar(24), False)
    secs = [sec_a, noeta(b_(24), o2, True)] + self_for(24, False) + [
        const(t["sw24_abso3a"], tropf * fl(o3)),
        const(t["sw24_abso3b"], stratf * fl(o3))]
    taug[24] = eval_sections(secs, n)
    wmol = tropf * colmol
    taur[24] = eval_sections([
        Section(np.asarray(t["sw24_rayla"], np.float32).T, [js, js + 1],
                [wmol * (1.0 - fs), wmol * fs]),
        const(t["sw24_raylb"], stratf * colmol)], n)
    # band 25: h2o, o3 cross-sections, per-g Rayleigh
    secs = [noeta(a(25), h2o, False),
            const(t["sw25_abso3a"], tropf * fl(o3)),
            const(t["sw25_abso3b"], stratf * fl(o3))]
    taug[25], taur[25] = eval_sections(secs, n), rayl_per_g(25)
    # band 26: pure Rayleigh
    taug[26] = torch.zeros((len(np.asarray(t["sw26_sfluxref"])), n),
                           dtype=dtype, device=dev)
    taur[26] = rayl_per_g(26)
    # band 27: o3
    taug[27] = eval_sections([noeta(a(27), o3, False),
                              noeta(b_(27), o3, True)], n)
    taur[27] = rayl_per_g(27)
    # band 28: o3+o2
    taug[28] = eval_sections(
        [eta_section(a(28), o3, o2, scalar(28), False)[0],
         eta_section(b_(28), o3, o2, scalar(28), True)[0]], n)
    taur[28] = rayl_const(28)
    # band 29: h2o / co2, cross-sections
    secs = [noeta(a(29), h2o, False), noeta(b_(29), co2, True)] \
        + self_for(29, False) + [const(t["sw29_absco2"], tropf * fl(co2)),
                                 const(t["sw29_absh2o"], stratf * fl(h2o))]
    taug[29], taur[29] = eval_sections(secs, n), rayl_const(29)

    bands = range(16, 30)
    out = [torch.cat([d[b] for b in bands], 0).reshape(112, ncol, nlev)
           .permute(1, 2, 0) for d in (taug, taur)]
    if toa_first:
        out = [x.flip(1) for x in out]
    return out[0].contiguous(), out[1].contiguous(), solar_source(c2, tables)
