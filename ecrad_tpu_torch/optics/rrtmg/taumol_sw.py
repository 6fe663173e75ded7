"""All-band SW taumol: kernel B2 wrapper, its plain version, and the
solar source.

Replaces ecrad_tpu/optics/rrtmg/taumol_sw_fused.py: `pack_coeffs_sw`
(:194-207) and `taumol_sw_fused(..., toa_first=True)` (:412-494), whose
Pallas kernel is `_taumol_sw_fused_flat` (:344, body `sw_fused_body`
:225). It computes the 14-band SW gas optical depth `taug` and Rayleigh
optical depth `taur` of every cell: 2-point eta interpolation shared by
both temperature families, the continuum, constant cross-sections, and
the eta-interpolated band-24 Rayleigh term (srtm_taumol{16..29}.F90).

Like taumol_lw, the plain version restates the fused body as the row
gathers of taumol_common, term for term with csrc/taumol_sw.cu. The
solar source (SFLUXZEN at the LAYSOLFR layer) is a per-column selection
across levels and stays in PyTorch on every device; it indexes the
SURFACE-first coefficients (taumol_sw_fused.py:420-426, :439-493).

On the H100 the kernel's floor is its 2 x 112 float stores per cell; it
runs well above it, on B1's design (csrc/taumol_sw.cu: band-uniform
warps over 32-cell tiles, rows staged and written whole). Diagnostic
builds on the card split its time into about equal parts: building the
terms and writing the rows, the issue of the slot loop, and the table
gathers from L1/L2; none is bound by device-memory bytes.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import fused_tables as ft
from .setcoef import Coeffs
from .taumol_common import (DeviceTables, Terms, Term, eta_index,
                            gather_sum)

NG_SW = 112
NG = ft.NG_SW_BAND
G_OFF = ft.G_OFF_SW
O2ADJ = 1.6
#: term slots per band (taug, taur); csrc/taumol_sw.cu has the same
K_TAUG = [12, 12, 12, 12, 9, 12, 13, 8, 13, 5, 0, 4, 8, 9]
K_TAUR = [1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1]

F_FIELDS = [
    "tropf", "fac00", "fac10", "fac01", "fac11",
    "selffac", "selffrac", "forfac", "forfrac",
    "colh2o", "colco2", "colo3", "colch4", "colo2", "colmol",
]
I_FIELDS = ["jp", "jt", "jt1", "indself", "indfor"]

#: launches of the CUDA kernel (incremented only where it is launched)
launches = 0


def pack_coeffs(c: Coeffs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NF, N) float and (NI, N) int32 per-cell inputs (SW factors)."""
    vals = dict(c._asdict())
    vals["tropf"] = c.tropo.to(c.colh2o.dtype)
    for k in ("fac00", "fac10", "fac01", "fac11"):
        vals[k] = vals[k + "_sw"]
    fc = torch.stack([vals[n].reshape(-1) for n in F_FIELDS])
    ic = torch.stack([getattr(c, n).reshape(-1).to(torch.int32)
                      for n in I_FIELDS])
    return fc.contiguous(), ic.contiguous()


def _eta_cols(f, b):
    """(col1, col2) of the binary species of an eta band."""
    if b in (16, 18):
        return f["colh2o"], f["colch4"]
    if b in (17, 19, 21):
        return f["colh2o"], f["colco2"]
    if b == 22:
        return f["colh2o"], O2ADJ * f["colo2"]
    if b == 24:
        return f["colh2o"], f["colo2"]
    return f["colo3"], f["colo2"]          # band 28


def sw_terms(fc: torch.Tensor, ic: torch.Tensor, flat: ft.FlatTables,
             consts) -> Tuple[List[List[Term]], List[List[Term]]]:
    """Phase 1: per band, the taug terms and the taur terms."""
    f = {n: fc[i] for i, n in enumerate(F_FIELDS)}
    jp, jt, jt1, indself, indfor = (ic[i] for i in range(5))
    strrat = {b: float(consts[b - 16]) for b in ft.SW_BANDS}
    givfac = float(consts[len(ft.SW_BANDS)])
    tb = Terms(flat, f["tropf"])
    tropf = f["tropf"]
    tropo = tropf > 0.0
    facs = (f["fac00"], f["fac10"], f["fac01"], f["fac11"])
    colh2o, colco2, colo3 = f["colh2o"], f["colco2"], f["colo3"]
    colch4, colo2, colmol = f["colch4"], f["colo2"], f["colmol"]

    grid0 = (jp - 1) * 5 + (jt - 1)
    grid1 = jp * 5 + (jt1 - 1)
    grid0b = (jp - 13) * 5 + (jt - 1)
    grid1b = (jp - 12) * 5 + (jt1 - 1)

    def corners(strat):
        g0, g1 = (grid0b, grid1b) if strat else (grid0, grid1)
        return zip((g0, g0 + 1, g1, g1 + 1), facs)

    def noeta(b, strat, w):
        name = f"absb{b}" if strat else f"absa{b}"
        return [tb.term(name, NG[b - 16], g, w * gw)
                for g, gw in corners(strat)]

    def eta(b, strat):
        """Binary-species lookup, 4 grid corners x 2 eta rows."""
        col1, col2 = _eta_cols(f, b)
        sc = col1 + strrat[b] * col2
        _, js, fs = eta_index(col1, sc, 4.0 if strat else 8.0)
        name = f"absb{b}" if strat else f"absa{b}"
        ngrid, neta = (235, 5) if strat else (65, 9)
        out = []
        for g, gw in corners(strat):
            for e, ew in ((js, 1.0 - fs), (js + 1, fs)):
                ok = (g >= 0) & (g < ngrid) & (e >= 0) & (e < neta)
                out.append(tb.term(name, NG[b - 16], g * neta + e,
                                   sc * gw * ew, ok))
        return out

    sf = tropf * f["selffac"]

    def self_for(b):
        ff = f["forfac"] if b in ft.FOR_UNGATED_SW else f["forfac"] * tropf
        return (tb.pair(f"self{b}", NG[b - 16], indself - 1, sf,
                        f["selffrac"])
                + tb.pair(f"for{b}", NG[b - 16], indfor - 1, ff,
                          f["forfrac"]))

    def const(name, b, w):
        return [tb.const(name, NG[b - 16], w)]

    z4 = [tb.zero] * 4
    o2cont = 4.35e-4 * colo2 / (350.0 * 2.0)
    taug = [
        (eta(16, False) + self_for(16),
         noeta(16, True, colch4) + z4 + self_for(16)),
        (eta(17, False) + self_for(17), eta(17, True) + self_for(17)),
        (eta(18, False) + self_for(18),
         noeta(18, True, colch4) + z4 + self_for(18)),
        (eta(19, False) + self_for(19),
         noeta(19, True, colco2) + z4 + self_for(19)),
        (noeta(20, False, colh2o) + self_for(20)
         + const("sw20_absch4", 20, colch4),
         noeta(20, True, colh2o) + self_for(20)
         + const("sw20_absch4", 20, colch4)),
        (eta(21, False) + self_for(21), eta(21, True) + self_for(21)),
        (eta(22, False) + self_for(22) + const("sw22_ones", 22, o2cont),
         noeta(22, True, O2ADJ * colo2) + z4 + self_for(22)
         + const("sw22_ones", 22, o2cont)),
        (noeta(23, False, givfac * colh2o) + self_for(23),
         z4 + self_for(23)),
        (eta(24, False) + self_for(24) + const("sw24_abso3a", 24, colo3),
         noeta(24, True, colo2) + z4 + self_for(24)
         + const("sw24_abso3b", 24, colo3)),
        (noeta(25, False, colh2o) + const("sw25_abso3a", 25, colo3),
         z4 + const("sw25_abso3b", 25, colo3)),
        ([], []),
        (noeta(27, False, colo3), noeta(27, True, colo3)),
        (eta(28, False), eta(28, True)),
        (noeta(29, False, colh2o) + self_for(29)
         + const("sw29_absco2", 29, colco2),
         noeta(29, True, colco2) + self_for(29)
         + const("sw29_absh2o", 29, colh2o)),
    ]
    taur = []
    for b in ft.SW_BANDS:
        if b == 24:
            col1, col2 = _eta_cols(f, 24)
            _, js, fs = eta_index(col1, col1 + strrat[24] * col2, 8.0)
            taur.append((tb.pair("rayl24", 8, js, colmol, fs),
                         const("sw24_raylb", 24, colmol)))
        else:
            r = const(f"rayl{b}", b, colmol)
            taur.append((r, r))
    return ([tb.merge(tropo, t, s, k) for (t, s), k in zip(taug, K_TAUG)],
            [tb.merge(tropo, t, s, k) for (t, s), k in zip(taur, K_TAUR)])


def taumol_sw_plain(fc: torch.Tensor, ic: torch.Tensor,
                    tables: DeviceTables
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B2: (taug, taur), each (N, 112)."""
    n = fc.shape[1]
    g_terms, r_terms = sw_terms(fc, ic, tables.flat, tables.flat.consts)
    taug = torch.cat([gather_sum(tables.tab, g_terms[i], NG[i], n)
                      for i in range(14)], 1)
    taur = torch.cat([gather_sum(tables.tab, r_terms[i], NG[i], n)
                      for i in range(14)], 1)
    return taug, taur


def taumol_sw_kernel(fc: torch.Tensor, ic: torch.Tensor,
                     tables: DeviceTables
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 (csrc/taumol_sw.cu) on CUDA float32 tensors, or its
    double form on CUDA float64 ones (the fields, tables and constants in
    one dtype)."""
    global launches
    from ...ops import _cuda
    n = fc.shape[1]
    dt = _cuda.scalar(fc, "fc")
    _cuda.check(fc, dt, (len(F_FIELDS), n), "fc")
    _cuda.check(ic, torch.int32, (len(I_FIELDS), n), "ic")
    _cuda.check(tables.tab, dt, None, "tab")
    _cuda.check(tables.meta, torch.int32, (2, len(tables.flat.names)),
                "meta")
    _cuda.check(tables.consts, dt, (len(ft.SW_CONSTS),), "consts")
    taug = torch.empty((n, NG_SW), dtype=dt, device=fc.device)
    taur = torch.empty_like(taug)
    _cuda.launch("taumol_sw", fc, ic, tables.tab, tables.meta,
                 tables.consts, n, taug, taur, dtype=dt)
    launches += 1
    return taug, taur


def taumol_sw(fc, ic, tables: DeviceTables):
    """(taug, taur), each (N, 112): the plain version on a CPU tensor,
    kernel B2 on any other (CUDA float32 or float64; any other dtype
    raises)."""
    if fc.device.type == "cpu":
        return taumol_sw_plain(fc, ic, tables)
    return taumol_sw_kernel(fc, ic, tables)


# ---- solar source (taumol_sw.py:28-84, taumol_sw_fused.py:439-494) ----

def _first_true(mask, default_idx):
    idx = mask.to(torch.int8).argmax(1)
    return torch.where(mask.any(1), idx, default_idx)


def _laysolfr_strat(c: Coeffs, layreffr: int):
    """First strat layer where jp crosses layreffr; default: top layer
    (srtm_taumol16.F90)."""
    jp_prev = torch.cat([c.jp[:, :1], c.jp[:, :-1]], 1)
    crossing = (jp_prev < layreffr) & (c.jp >= layreffr) & ~c.tropo
    return _first_true(crossing, torch.full_like(c.jp[:, 0], c.jp.shape[1]
                                                 - 1).to(torch.int64))


def _laysolfr_tropo(c: Coeffs, layreffr: int):
    """min(lay + 1, laytrop) at the tropo layer where jp crosses
    layreffr; default laytrop."""
    laytrop = c.tropo.sum(1) - 1
    jp_next = torch.cat([c.jp[:, 1:], c.jp[:, -1:]], 1)
    crossing = (c.jp < layreffr) & (jp_next >= layreffr) & c.tropo
    lay = _first_true(crossing, laytrop)
    return torch.where(crossing.any(1), torch.minimum(lay + 1, laytrop),
                       laytrop)


def _at_layer(x, lay):
    return torch.gather(x, 1, lay[:, None].to(torch.int64))[:, 0]


def _sflux_eta(tab, js, fs):
    """tab (neta, ng) interpolated at (js, fs) per column."""
    t0 = tab[js.clamp(0, tab.shape[0] - 1)]
    t1 = tab[(js + 1).clamp(0, tab.shape[0] - 1)]
    return t0 + fs[:, None] * (t1 - t0)


def solar_source(c2: Coeffs, tables) -> torch.Tensor:
    """SFLUXZEN per g, (ncol, 112), from surface-first coefficients and
    the GasTables' solar source rows."""
    t, rows = tables.t, tables.sfluxref
    ncol = c2.colh2o.shape[0]

    def one_d(b, scale=1.0):
        return (scale * rows[b]).expand(ncol, -1)

    def eta_at(b, col1, col2, mult, laysolfr):
        rat = float(t[f"sw{b}_strrat"])
        _, js, fs = eta_index(col1, col1 + rat * col2, mult)
        lay = laysolfr(c2, int(t[f"sw{b}_layreffr"]))
        return _sflux_eta(rows[b], _at_layer(js, lay), _at_layer(fs, lay))

    out = [one_d(16),
           eta_at(17, c2.colh2o, c2.colco2, 4.0, _laysolfr_strat),
           eta_at(18, c2.colh2o, c2.colch4, 8.0, _laysolfr_tropo),
           eta_at(19, c2.colh2o, c2.colco2, 8.0, _laysolfr_tropo),
           one_d(20),
           eta_at(21, c2.colh2o, c2.colco2, 8.0, _laysolfr_tropo),
           eta_at(22, c2.colh2o, O2ADJ * c2.colo2, 8.0, _laysolfr_tropo),
           one_d(23),
           eta_at(24, c2.colh2o, c2.colo2, 8.0, _laysolfr_tropo),
           one_d(25), one_d(26),
           one_d(27, float(t["sw27_scalekur"])),
           eta_at(28, c2.colo3, c2.colo2, 4.0, _laysolfr_strat),
           one_d(29)]
    return torch.cat(out, 1)


def taumol_sw_cells(c2: Coeffs, tables):
    """The JAX taumol_sw_fused(c2, t, toa_first=True): (taug, taur) as
    TOA-first (ncol, nlev, 112) and sfluxzen (ncol, 112), from
    surface-first coefficients and the GasTables."""
    ncol, nlev = c2.tropo.shape
    fc, ic = pack_coeffs(c2.flip_levels())
    taug, taur = taumol_sw(fc, ic, tables.sw)
    return (taug.reshape(ncol, nlev, NG_SW),
            taur.reshape(ncol, nlev, NG_SW), solar_source(c2, tables))
