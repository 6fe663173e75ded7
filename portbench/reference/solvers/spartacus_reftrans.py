"""SPARTACUS per-layer reflectance/transmittance, plain level loops.

Copied from the plain halves of ecrad_tpu_torch/ops/spartacus_reftrans.py
(sw_reftrans_levels_plain, lw_reftrans_levels_plain and what they call;
ecrad_tpu/ops/spartacus_reftrans.py:115-248, :416-548). For every (level,
g, column) cell: the region-coupled two-stream generator Gamma, its
matrix exponential by Pade-5, thin-layer extraction and masked
adding-doubling (matrix.py), the LW particular-solution sources, the
clipping, the 1D Meador-Weaver fallback where the cell takes no 3D
treatment (`use3d` false), and the zeroing of the cloudy regions of clear
layers. The output is the packed history the adding sweeps
(spartacus_adding.py) read: SW [R | T | RD | TD | TDD], LW [R | T | SU |
SD], (nlev, rows, ng, ncol), each matrix nreg x nreg rows in row-major
order. The caps on od / mu0 and on the optical depths keep the doubling
counts bounded and change no flux at float32 resolution.
"""
from __future__ import annotations

import torch

from . import two_stream as ts
from .matrix import (add_eye_g, expm_reftrans_lw_g, expm_reftrans_sw_g,
                     mv_gu, solve_vec_g)

# Cap on od/mu0 in the direct block of the SW Gamma: exp(-60) is zero at
# float32 flux resolution, and an uncapped diagonal (mu0 is clamped at
# 1e-10) would drive the doubling count to its bound
MAX_OD_OVER_MU0_3D = 60.0
LW_DIFFUSIVITY = 1.66


def _diag_g(x, nreg):
    """(nreg, *batch) -> diagonal (nreg, nreg, *batch)."""
    out = x.new_zeros((nreg,) + x.shape)
    for i in range(nreg):
        out[i, i] = x[i]
    return out


def _zero_offdiag_clear(M, is_clear):
    """Zero all but the (0, 0) entry where is_clear (broadcast batch)."""
    keep = torch.zeros(M.shape[:2], dtype=torch.bool, device=M.device)
    keep[0, 0] = True
    keep = keep.view(M.shape[:2] + (1,) * (M.dim() - 2))
    return torch.where(keep | ~is_clear, M, torch.zeros((), dtype=M.dtype,
                                                        device=M.device))


def _zero_cloudy_vec(x, is_clear):
    keep = (torch.arange(x.shape[0], device=x.device) == 0).view(
        (-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep | ~is_clear, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _gamma(n, batch, like):
    """An n x n list-of-lists of zero (batch) entries and its adder."""
    zero = like.new_zeros(batch)
    rows = [[zero] * n for _ in range(n)]

    def add(i, j, val):
        rows[i][j] = rows[i][j] + val
    return rows, add


def _stack(rows, r0, r1, c0, c1):
    return torch.stack([torch.stack(rows[i][c0:c1]) for i in range(r0, r1)])


# ---- SW ----

def sw_gamma_expm(nreg, mu0, od, ssa, gg, trd, trf, use3d):
    """Region-coupled SW (R, T, RD, TD, TDD), each (nreg, nreg, *batch).
    od/ssa/gg (nreg, *batch), region 0's od capped at max_gas_od_3d;
    trd/trf (nreg, nreg, ...) broadcasting against *batch; mu0 likewise;
    use3d (*batch): Gamma is zeroed where false."""
    one_over_mu0 = 1.0 / mu0
    gamma1, gamma2, gamma3 = ts.sw_gammas(mu0, ssa, gg)
    n3 = 3 * nreg
    rows, add = _gamma(n3, od.shape[1:], od)
    for r in range(nreg):
        add(r, r, od[r] * gamma1[r])
        add(nreg + r, r, od[r] * gamma2[r])
        add(r, 2 * nreg + r, -od[r] * ssa[r] * gamma3[r])
        add(nreg + r, 2 * nreg + r, od[r] * ssa[r] * (1.0 - gamma3[r]))
        add(2 * nreg + r, 2 * nreg + r,
            -torch.clamp(od[r] * one_over_mu0, max=MAX_OD_OVER_MU0_3D))
    pairs = [(r, r + 1) for r in range(nreg - 1)] + (
        [(0, 2)] if nreg == 3 else [])
    for a, b in pairs:
        add(a, a, trf[a, b])
        add(b, b, trf[b, a])
        add(b, a, -trf[a, b])
        add(a, b, -trf[b, a])
        add(2 * nreg + a, 2 * nreg + a, -trd[a, b])
        add(2 * nreg + b, 2 * nreg + b, -trd[b, a])
        add(2 * nreg + b, 2 * nreg + a, trd[a, b])
        add(2 * nreg + a, 2 * nreg + b, trd[b, a])
    for i in range(nreg):
        for j in range(nreg):
            rows[nreg + i][nreg + j] = -rows[i][j]
            rows[i][nreg + j] = -rows[nreg + i][j]
    n2 = 2 * nreg
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    G = [torch.where(use3d, x, zero) for x in (
        _stack(rows, 0, n2, 0, n2), _stack(rows, 0, n2, n2, n3),
        _stack(rows, n2, n3, n2, n3))]
    R, T, Rdir, Tdir, Tdd, _ = expm_reftrans_sw_g(*G)
    clip = lambda x, hi: torch.minimum(torch.clamp(x, min=0.0), hi)
    one = torch.ones((), dtype=od.dtype, device=od.device)
    return (clip(R, one), clip(T, one), clip(Rdir, mu0), clip(Tdir, mu0),
            clip(Tdd, one))


def _sw_level(max_gas_od_3d, od, ssa, gg, trd, trf, mu0, use3d, clear):
    """One level: od/ssa/gg (nreg, ng, ncol); trd/trf (nreg, nreg, ncol);
    mu0 (ncol,); use3d (ng, ncol); clear (ncol,). Returns the
    (5 nreg^2, ng, ncol) rows."""
    nreg = od.shape[0]
    mu0 = mu0[None]
    g1, g2, g3 = ts.sw_gammas(mu0, ssa, gg)
    out5 = [_diag_g(x, nreg) for x in ts.sw_reftrans(mu0, od, ssa, g1, g2,
                                                     g3)]
    if bool(use3d.any()):
        od_capped = torch.cat([torch.clamp(od[:1], max=max_gas_od_3d),
                               od[1:]])
        f3 = sw_gamma_expm(nreg, mu0, od_capped, ssa, gg, trd[:, :, None],
                           trf[:, :, None], use3d)
        out5 = [torch.where(use3d, a, b) for a, b in zip(f3, out5)]
    out5 = [_zero_offdiag_clear(M, clear) for M in out5]
    return torch.cat([M.reshape((nreg * nreg,) + M.shape[2:])
                      for M in out5])


def sw_reftrans_levels(max_gas_od_3d, od, ssa, g, trd, trf, mu0, use3d,
                       clear):
    """od/ssa/g (nlev, nreg, ng, ncol), region 0's od uncapped; trd/trf
    (nlev, nreg, nreg, ncol) direct and diffuse transfer rates; mu0
    (ncol,); use3d (nlev, ng, ncol) bool; clear (nlev, ncol) bool.
    Returns (nlev, 5 nreg^2, ng, ncol), filled a level at a time."""
    nlev, nreg, ng, ncol = od.shape
    out = od.new_empty((nlev, 5 * nreg * nreg, ng, ncol))
    for l in range(nlev):
        out[l] = _sw_level(max_gas_od_3d, od[l], ssa[l], g[l], trd[l],
                           trf[l], mu0, use3d[l], clear[l])
    return out


# ---- LW ----

def lw_gamma_expm(nreg, od, ssa, gg, tr, se, pt, pb, fr, use3d):
    """LW 3D (R, T, SU, SD): od/ssa/gg (nreg, *batch), region 0's od
    capped; tr (nreg, nreg, ...) and fr (nreg, ...) broadcasting;
    se/pt/pb (*batch)."""
    gamma1, gamma2 = ts.lw_gammas(ssa, gg)
    rows, add = _gamma(2 * nreg, od.shape[1:], od)
    for r in range(nreg):
        add(r, r, od[r] * gamma1[r])
        add(nreg + r, r, od[r] * gamma2[r])
    for r in range(nreg - 1):
        add(r, r, tr[r, r + 1])
        add(r + 1, r, -tr[r, r + 1])
        if r > 0:
            add(r + 1, r + 1, tr[r + 1, r])
            add(r, r + 1, -tr[r + 1, r])
        else:
            add(r + 1, r + 1, se * tr[r + 1, r])
            add(r, r + 1, -se * tr[r + 1, r])
    if nreg == 3:
        add(0, 0, tr[0, 2])
        add(2, 0, -tr[0, 2])
        add(2, 2, se * tr[2, 0])
        add(0, 2, -se * tr[2, 0])
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    Atl = torch.where(use3d, _stack(rows, 0, nreg, 0, nreg), zero)
    Bbl = torch.where(use3d, _stack(rows, nreg, 2 * nreg, 0, nreg), zero)
    emis = torch.where(use3d, od * (1.0 - ssa) * fr * LW_DIFFUSIVITY, zero)
    # the particular solution in the sum/difference basis
    v = emis * (pb - pt)[None]
    w = emis * pt[None]
    Ereg = add_eye_g(Atl + Bbl, 1e-12)
    Freg = add_eye_g(Atl - Bbl, 1e-12)
    u = solve_vec_g(Freg, v)
    fw = solve_vec_g(Freg, w)
    eu = solve_vec_g(Ereg, u)
    sol0_up = fw + eu
    sol0_dn = fw - eu
    ref3, trans3, _ = expm_reftrans_lw_g(Atl, Bbl)
    pu_b = sol0_up + u
    sup3 = sol0_up - mv_gu(ref3, sol0_dn) - mv_gu(trans3, pu_b)
    sdn3 = sol0_dn + u - mv_gu(trans3, sol0_dn) - mv_gu(ref3, pu_b)
    return ref3, trans3, sup3, sdn3


def _lw_level(max_gas_od_3d, cloud_scattering, od, ssa, gg, tr, se, pt,
              pb, fr, use3d, clear):
    """One level: od/ssa/gg (nreg, ng, ncol); tr (nreg, nreg, ncol);
    se/pt/pb (ng, ncol); fr (nreg, ncol); use3d (ng, ncol); clear (ncol,).
    Returns the (2 nreg (nreg+1), ng, ncol) rows."""
    nreg = od.shape[0]
    fr = fr[:, None]
    gamma1, gamma2 = ts.lw_gammas(ssa, gg)
    pt_b = pt[None] * torch.ones_like(od)
    pb_b = pb[None] * torch.ones_like(od)
    if cloud_scattering:
        rmw, tmw, sumw, sdmw = ts.lw_reftrans(od, gamma1, gamma2, pt_b,
                                              pb_b)
    else:
        tmw, sumw, sdmw = ts.lw_no_scattering_transmittance(od, pt_b, pb_b)
        rmw = torch.zeros_like(tmw)
    out = [_diag_g(rmw, nreg), _diag_g(tmw, nreg), sumw * fr, sdmw * fr]
    if bool(use3d.any()):
        od_capped = torch.cat([torch.clamp(od[:1], max=max_gas_od_3d),
                               od[1:]])
        f3 = lw_gamma_expm(nreg, od_capped, ssa, gg, tr[:, :, None], se, pt,
                           pb, fr, use3d)
        out = [torch.where(use3d, a, b) for a, b in zip(f3, out)]
    ref, trans = (_zero_offdiag_clear(M, clear) for M in out[:2])
    sup, sdn = (_zero_cloudy_vec(x, clear) for x in out[2:])
    flat = lambda M: M.reshape((nreg * nreg,) + M.shape[2:])
    return torch.cat([flat(ref), flat(trans), sup, sdn])


def lw_reftrans_levels(max_gas_od_3d, cloud_scattering, od, ssa, g, tr, se,
                       pt, pb, fr, use3d, clear):
    """od/ssa/g (nlev, nreg, ng, ncol), region 0's od uncapped; tr (nlev,
    nreg, nreg, ncol); se (side emissivity), pt/pb (Planck at the layer's
    top and bottom) (nlev, ng, ncol); fr (nlev, nreg, ncol) region
    fractions; use3d (nlev, ng, ncol) bool; clear (nlev, ncol) bool;
    cloud_scattering: the 1D fallback with scattering. Returns (nlev,
    2 nreg (nreg+1), ng, ncol), filled a level at a time."""
    nlev, nreg, ng, ncol = od.shape
    out = od.new_empty((nlev, 2 * nreg * (nreg + 1), ng, ncol))
    for l in range(nlev):
        out[l] = _lw_level(max_gas_od_3d, cloud_scattering, od[l], ssa[l],
                           g[l], tr[l], se[l], pt[l], pb[l], fr[l], use3d[l],
                           clear[l])
    return out
