"""Kernels B6 and B7: SPARTACUS per-layer reflectance/transmittance
(csrc/spartacus_reftrans.cu), with their plain versions.

Replaces ecrad_tpu/ops/spartacus_reftrans.py::sw_reftrans_levels (:272,
pallas_call :350) and ::lw_reftrans_levels (:600, pallas_call :676).
For every (level, g, column) cell: the region-coupled two-stream
generator Gamma, its matrix exponential by Pade-5, a thin-layer
extraction and masked adding-doubling (solvers/matrix.py
expm_reftrans_sw_g / expm_reftrans_lw_g), the LW particular-solution
sources, the clipping, the 1D Meador-Weaver fallback where the cell
takes no 3D treatment (`use3d` false), and the zeroing of the cloudy
regions of clear layers. The output is the packed history the adding
sweeps (ops/spartacus_adding.py) read: SW [R | T | RD | TD | TDD], LW
[R | T | SU | SD], (nlev, rows, ng, ncol), each matrix nreg x nreg rows
in row-major order.

`sw_reftrans_levels` / `lw_reftrans_levels` run the plain versions (one
level at a time, as the JAX package's CPU scan does) on CPU tensors and
the kernels on CUDA tensors; a float64 or non-contiguous CUDA tensor, or
a failed build or launch, raises. B6 and B7 are two launches each on the
current stream: a 3D pass that finds the 3D cells and stages their rows
in a compact buffer, then a pass over every cell that writes the
fallback cells and copies the staged ones, so that each sector of the
output is written whole and once. With `counts` (an int8 (nlev, ng,
ncol) tensor) both record each cell's doubling count, -1 where the cell
took the fallback.

The plain versions mirror ecrad_tpu/ops/spartacus_reftrans.py:115-248
(SW) and :416-548 (LW) expression for expression. The SW Meador-Weaver
fallback is the port's two_stream.sw_reftrans, whose float32 cells within
RESONANCE_WINDOW of k mu0 = 1 are computed in float64 (the kernel does
the same per cell).
"""
from __future__ import annotations

import math

import torch

from ..solvers import two_stream as ts
from ..solvers.matrix import (_THETA_DBL, add_eye_g, expm_reftrans_lw_g,
                              expm_reftrans_sw_g, mv_gu, solve_vec_g)
from ..utils import hooks
from . import _cuda

# the two-stream forms without their own `ecrad.layer_optics` scope: the
# plain versions call them once a level, inside the scope that
# sw_reftrans_levels / lw_reftrans_levels open around the whole pass
_sw_gammas, _sw_reftrans, _lw_gammas, _lw_reftrans, _lw_noscat = (
    f.__wrapped__ for f in (ts.sw_gammas, ts.sw_reftrans, ts.lw_gammas,
                            ts.lw_reftrans, ts.lw_no_scattering_transmittance))

# Cap on od/mu0 in the direct block of the SW Gamma: exp(-60) is zero at
# float32 flux resolution, and an uncapped diagonal (mu0 is clamped at
# 1e-10) would drive the doubling count to its bound
# (ecrad_tpu/ops/spartacus_reftrans.py:43-48)
MAX_OD_OVER_MU0_3D = 60.0
LW_DIFFUSIVITY = 1.66

#: launches of each CUDA kernel (incremented only where it is launched;
#: B6's and B7's wrappers launch their two passes and count one)
launches = {"spartacus_sw_reftrans": 0, "spartacus_lw_reftrans": 0}
# B6 and B7 index their cells by int32, and stage the rows of up to a
# quarter of them (the SPARTACUS path's 3D share is 0.14); a 3D cell past
# that share is written in place by the 3D pass, slower but the same
# values
_MAX_CELLS = 2**31 - 1
_STAGED_SHARE = 4


def sw_fixed_squarings(cfg) -> int:
    """The most doubling steps an SW cell can need, from the capped Gamma
    1-norm (od <= max_cloud_od, transfer rates <= max_3d_transfer_rate,
    od/mu0 <= MAX_OD_OVER_MU0_3D; ecrad_tpu/ops/spartacus_reftrans.py:
    92-99). The TPU kernel ran this many masked steps in every cell;
    here each cell runs its own count, which the caps keep below it."""
    mc, mt = float(cfg.max_cloud_od), float(cfg.max_3d_transfer_rate)
    bound = max(2.0 * mc + 4.0 * mt, MAX_OD_OVER_MU0_3D + mc + 2.0 * mt)
    return max(0, math.ceil(math.log2(bound / _THETA_DBL)))


def lw_fixed_squarings(cfg) -> int:
    """The LW counterpart of sw_fixed_squarings (:102-108)."""
    mc, mt = float(cfg.max_cloud_od), float(cfg.max_3d_transfer_rate)
    bound = (LW_DIFFUSIVITY + 0.83) * mc + 2.0 * 1.4107 * mt
    return max(0, math.ceil(math.log2(bound / _THETA_DBL)))


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


def _record(counts, l, expo, use3d):
    if counts is not None:
        counts[l] = torch.where(use3d, expo, -1).to(torch.int8)


# ---- SW ----

def sw_gamma_expm(nreg, mu0, od, ssa, gg, trd, trf, use3d):
    """Region-coupled SW (R, T, RD, TD, TDD), each (nreg, nreg, *batch),
    and the doubling counts (ecrad_tpu/ops/spartacus_reftrans.py:115-198).
    od/ssa/gg (nreg, *batch), region 0's od capped at max_gas_od_3d;
    trd/trf (nreg, nreg, ...) broadcasting against *batch; mu0 likewise;
    use3d (*batch): Gamma is zeroed where false."""
    one_over_mu0 = 1.0 / mu0
    gamma1, gamma2, gamma3 = _sw_gammas(mu0, ssa, gg)
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
    R, T, Rdir, Tdir, Tdd, expo = expm_reftrans_sw_g(*G)
    clip = lambda x, hi: torch.minimum(torch.clamp(x, min=0.0), hi)
    one = torch.ones((), dtype=od.dtype, device=od.device)
    return (clip(R, one), clip(T, one), clip(Rdir, mu0), clip(Tdir, mu0),
            clip(Tdd, one)), expo


def _sw_level(max_gas_od_3d, od, ssa, gg, trd, trf, mu0, use3d, clear):
    """One level of the SW pipeline (ecrad_tpu/ops/spartacus_reftrans.py
    _sw_compute :225-250): od/ssa/gg (nreg, ng, ncol); trd/trf (nreg,
    nreg, ncol); mu0 (ncol,); use3d (ng, ncol); clear (ncol,). Returns
    the (5 nreg^2, ng, ncol) rows and the doubling counts (or None)."""
    nreg = od.shape[0]
    mu0 = mu0[None]
    g1, g2, g3 = _sw_gammas(mu0, ssa, gg)
    out5 = [_diag_g(x, nreg) for x in _sw_reftrans(mu0, od, ssa, g1, g2,
                                                       g3)]
    expo = None
    if bool(use3d.any()):
        od_capped = torch.cat([torch.clamp(od[:1], max=max_gas_od_3d),
                               od[1:]])
        f3, expo = sw_gamma_expm(nreg, mu0, od_capped, ssa, gg,
                                 trd[:, :, None], trf[:, :, None], use3d)
        out5 = [torch.where(use3d, a, b) for a, b in zip(f3, out5)]
    out5 = [_zero_offdiag_clear(M, clear) for M in out5]
    return torch.cat([M.reshape((nreg * nreg,) + M.shape[2:])
                      for M in out5]), expo


def sw_reftrans_levels_plain(max_gas_od_3d, od, ssa, g, trd, trf, mu0,
                             use3d, clear, counts=None):
    """Kernel B6's plain version: od/ssa/g (nlev, nreg, ng, ncol), region
    0's od uncapped; trd/trf (nlev, nreg, nreg, ncol) direct and diffuse
    transfer rates; mu0 (ncol,); use3d (nlev, ng, ncol) bool; clear
    (nlev, ncol) bool. Returns (nlev, 5 nreg^2, ng, ncol)."""
    out = []
    for l in range(od.shape[0]):
        rows, expo = _sw_level(max_gas_od_3d, od[l], ssa[l], g[l], trd[l],
                               trf[l], mu0, use3d[l], clear[l])
        out.append(rows)
        _record(counts, l, expo if expo is not None else
                torch.full_like(use3d[l], -1, dtype=torch.int32), use3d[l])
    return torch.stack(out)


def sw_reftrans_levels_fused(max_gas_od_3d, od, ssa, g, trd, trf, mu0,
                             use3d, clear, counts=None):
    """Kernel B6, same arguments and result as the plain version."""
    nlev, nreg, ng, ncol = od.shape
    if nreg not in (2, 3):
        raise ValueError(f"SPARTACUS takes 2 or 3 regions, not {nreg}")
    for name, x in (("od", od), ("ssa", ssa), ("g", g)):
        _cuda.check(x, torch.float32, (nlev, nreg, ng, ncol), name)
    for name, x in (("trd", trd), ("trf", trf)):
        _cuda.check(x, torch.float32, (nlev, nreg, nreg, ncol), name)
    _cuda.check(mu0, torch.float32, (ncol,), "mu0")
    _cuda.check(use3d, torch.bool, (nlev, ng, ncol), "use3d")
    _cuda.check(clear, torch.bool, (nlev, ncol), "clear")
    if counts is not None:
        _cuda.check(counts, torch.int8, (nlev, ng, ncol), "counts")
    cells = nlev * ng * ncol
    if cells > _MAX_CELLS:
        raise ValueError(f"{cells} cells: kernel B6 indexes its cells by "
                         f"int32 (at most {_MAX_CELLS})")
    dev = od.device
    rows = 5 * nreg * nreg
    out = torch.empty((nlev, rows, ng, ncol), dtype=torch.float32,
                      device=dev)
    # the 3D pass stages its cells' rows in `packed` and their slots in
    # slot_of (the count of staged cells stays on the device); the second
    # pass writes every cell of `out`
    cap = -(-cells // _STAGED_SHARE)
    packed = torch.empty((rows, cap), dtype=torch.float32, device=dev)
    slot_of = torch.empty(cells, dtype=torch.int32, device=dev)
    n3d = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launch("spartacus_sw_reftrans_3d", od, ssa, g, trd, trf, mu0,
                 use3d, clear, out, counts, packed, slot_of, n3d, nreg, nlev,
                 ng, ncol, cap, max_gas_od_3d)
    _cuda.launch("spartacus_sw_reftrans_fallback", od, ssa, g, mu0, use3d,
                 clear, packed, slot_of, out, counts, nreg, nlev, ng, ncol,
                 cap)
    launches["spartacus_sw_reftrans"] += 1
    return out


@hooks.hooked("ecrad.layer_optics")
def sw_reftrans_levels(*args, **kw):
    """SW reftrans histories: the plain version on CPU tensors, kernel B6
    on any other (which raises unless it is CUDA float32)."""
    if args[1].device.type == "cpu":
        return sw_reftrans_levels_plain(*args, **kw)
    return sw_reftrans_levels_fused(*args, **kw)


# ---- LW ----

def lw_gamma_expm(nreg, od, ssa, gg, tr, se, pt, pb, fr, use3d):
    """LW 3D (R, T, SU, SD) (ecrad_tpu/ops/spartacus_reftrans.py:416-495)
    and the doubling counts: od/ssa/gg (nreg, *batch), region 0's od
    capped; tr (nreg, nreg, ...) and fr (nreg, ...) broadcasting; se/pt/pb
    (*batch)."""
    gamma1, gamma2 = _lw_gammas(ssa, gg)
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
    ref3, trans3, expo = expm_reftrans_lw_g(Atl, Bbl)
    pu_b = sol0_up + u
    sup3 = sol0_up - mv_gu(ref3, sol0_dn) - mv_gu(trans3, pu_b)
    sdn3 = sol0_dn + u - mv_gu(trans3, sol0_dn) - mv_gu(ref3, pu_b)
    return (ref3, trans3, sup3, sdn3), expo


def _lw_level(max_gas_od_3d, cloud_scattering, od, ssa, gg, tr, se, pt,
              pb, fr, use3d, clear):
    """One level of the LW pipeline (ecrad_tpu/ops/spartacus_reftrans.py
    _lw_compute :498-548): od/ssa/gg (nreg, ng, ncol); tr (nreg, nreg,
    ncol); se/pt/pb (ng, ncol); fr (nreg, ncol); use3d (ng, ncol); clear
    (ncol,). Returns the (2 nreg (nreg+1), ng, ncol) rows and the doubling
    counts (or None)."""
    nreg = od.shape[0]
    fr = fr[:, None]
    gamma1, gamma2 = _lw_gammas(ssa, gg)
    pt_b = pt[None] * torch.ones_like(od)
    pb_b = pb[None] * torch.ones_like(od)
    if cloud_scattering:
        rmw, tmw, sumw, sdmw = _lw_reftrans(od, gamma1, gamma2, pt_b, pb_b)
    else:
        tmw, sumw, sdmw = _lw_noscat(od, pt_b, pb_b)
        rmw = torch.zeros_like(tmw)
    out = [_diag_g(rmw, nreg), _diag_g(tmw, nreg), sumw * fr, sdmw * fr]
    expo = None
    if bool(use3d.any()):
        od_capped = torch.cat([torch.clamp(od[:1], max=max_gas_od_3d),
                               od[1:]])
        f3, expo = lw_gamma_expm(nreg, od_capped, ssa, gg, tr[:, :, None],
                                 se, pt, pb, fr, use3d)
        out = [torch.where(use3d, a, b) for a, b in zip(f3, out)]
    ref, trans = (_zero_offdiag_clear(M, clear) for M in out[:2])
    sup, sdn = (_zero_cloudy_vec(x, clear) for x in out[2:])
    flat = lambda M: M.reshape((nreg * nreg,) + M.shape[2:])
    return torch.cat([flat(ref), flat(trans), sup, sdn]), expo


def lw_reftrans_levels_plain(max_gas_od_3d, cloud_scattering, od, ssa, g,
                             tr, se, pt, pb, fr, use3d, clear, counts=None):
    """Kernel B7's plain version: od/ssa/g (nlev, nreg, ng, ncol), region
    0's od uncapped; tr (nlev, nreg, nreg, ncol); se (side emissivity),
    pt/pb (Planck at the layer's top and bottom) (nlev, ng, ncol); fr
    (nlev, nreg, ncol) region fractions; use3d (nlev, ng, ncol) bool;
    clear (nlev, ncol) bool; cloud_scattering: the 1D fallback with
    scattering (do_lw_cloud_scattering). Returns (nlev, 2 nreg (nreg+1),
    ng, ncol)."""
    out = []
    for l in range(od.shape[0]):
        rows, expo = _lw_level(max_gas_od_3d, cloud_scattering, od[l],
                               ssa[l], g[l], tr[l], se[l], pt[l], pb[l],
                               fr[l], use3d[l], clear[l])
        out.append(rows)
        _record(counts, l, expo if expo is not None else
                torch.full_like(use3d[l], -1, dtype=torch.int32), use3d[l])
    return torch.stack(out)


def lw_reftrans_levels_fused(max_gas_od_3d, cloud_scattering, od, ssa, g,
                             tr, se, pt, pb, fr, use3d, clear, counts=None):
    """Kernel B7, same arguments and result as the plain version."""
    nlev, nreg, ng, ncol = od.shape
    if nreg not in (2, 3):
        raise ValueError(f"SPARTACUS takes 2 or 3 regions, not {nreg}")
    for name, x in (("od", od), ("ssa", ssa), ("g", g)):
        _cuda.check(x, torch.float32, (nlev, nreg, ng, ncol), name)
    _cuda.check(tr, torch.float32, (nlev, nreg, nreg, ncol), "tr")
    for name, x in (("se", se), ("pt", pt), ("pb", pb)):
        _cuda.check(x, torch.float32, (nlev, ng, ncol), name)
    _cuda.check(fr, torch.float32, (nlev, nreg, ncol), "fr")
    _cuda.check(use3d, torch.bool, (nlev, ng, ncol), "use3d")
    _cuda.check(clear, torch.bool, (nlev, ncol), "clear")
    if counts is not None:
        _cuda.check(counts, torch.int8, (nlev, ng, ncol), "counts")
    cells = nlev * ng * ncol
    if cells > _MAX_CELLS:
        raise ValueError(f"{cells} cells: kernel B7 indexes its cells by "
                         f"int32 (at most {_MAX_CELLS})")
    dev = od.device
    rows = 2 * nreg * (nreg + 1)
    out = torch.empty((nlev, rows, ng, ncol), dtype=torch.float32,
                      device=dev)
    # as B6: the 3D pass stages its cells' rows, each cell's in a row,
    # the second pass writes every cell of `out`
    cap = -(-cells // _STAGED_SHARE)
    packed = torch.empty((cap, rows), dtype=torch.float32, device=dev)
    slot_of = torch.empty(cells, dtype=torch.int32, device=dev)
    n3d = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launch("spartacus_lw_reftrans_3d", od, ssa, g, tr, se, pt, pb, fr,
                 use3d, clear, out, counts, packed, slot_of, n3d, nreg, nlev,
                 ng, ncol, cap, max_gas_od_3d)
    _cuda.launch("spartacus_lw_reftrans_fallback", od, ssa, g, pt, pb, fr,
                 use3d, clear, packed, slot_of, out, counts, nreg, nlev, ng,
                 ncol, cap, int(bool(cloud_scattering)))
    launches["spartacus_lw_reftrans"] += 1
    return out


@hooks.hooked("ecrad.layer_optics")
def lw_reftrans_levels(*args, **kw):
    """LW reftrans histories: the plain version on CPU tensors, kernel B7
    on any other (which raises unless it is CUDA float32)."""
    if args[2].device.type == "cpu":
        return lw_reftrans_levels_plain(*args, **kw)
    return lw_reftrans_levels_fused(*args, **kw)
