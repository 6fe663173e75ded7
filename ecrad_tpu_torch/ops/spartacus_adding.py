"""Kernels B8 and B9: the SPARTACUS adding sweeps
(csrc/spartacus_adding.cu), with their plain versions.

Replaces ecrad_tpu/ops/spartacus_adding.py::sw_adding_sweeps (:366,
pallas_calls :399 up and :441 down) and ::lw_adding_sweeps (:583,
:614 and :655). SW: the upward accumulation of the total albedos (matrix
form, with the entrapment treatment Zero, Edge-only, Explicit,
Non-fractal or Maximum and the horizontal migration distances), then the
downward flux pass; LW: the upward albedo and source accumulation
(matrix or diagonal form), then the downward pass. Both read the packed
reftrans histories of ops/spartacus_reftrans.py and per-column rows
(`pack_cols`, `lw_pack_cols`: the JAX package's row layouts, with every
matrix padded to 3 x 3, so that two and three regions share them).

`sw_adding_sweeps` / `lw_adding_sweeps` run the plain level loops on CPU
tensors and the kernels on CUDA tensors of float32 or float64, each call
in one dtype (a float64 call launches the double forms,
csrc/spartacus_adding.cu *_f64) and contiguous; any other dtype (half
precision included), operands of mixed dtypes or a strided tensor
raise. The plain steps are the JAX package's kernel-form steps
(:115-327, :487-564), for any number of regions (2 or 3), in the same
order of operations (solvers/matrix.py `mm_gu`, `solve_g`).
"""
from __future__ import annotations

import torch

from ..config import Entrapment
from ..solvers.matrix import (add_eye_g, fast_expm_exchange_2_g,
                              fast_expm_exchange_3_g, mm_gu, mv_gu, solve_g,
                              solve_vec_g)
from ..utils import hooks
from . import _cuda
from .spartacus_reftrans import _diag_g, _zero_cloudy_vec, _zero_offdiag_clear

# per-column SW rows (ecrad_tpu/ops/spartacus_adding.py:39-57)
_UM = 0           # 9 rows: u_matrix at the interface above the layer
_VM = 9           # 9 rows: v_matrix at the interface above the layer
_VMN = 18         # 9 rows: v_matrix at the interface below the layer
_CF = 27          # cloud fraction (row 28: the layer depth)
_XLD = 29         # x_layer_diffuse
_XLDIR = 30       # x_layer_direct
_EDGE = 31        # 3 rows: edge length of the layer above
_INVEFF = 34      # inv effective size of the layer above
_OVP = 35         # overlap param at the interface above
_RF = 36          # 3 rows: region fractions
_RFP = 39         # 3 rows: region fractions of the layer above
_CLEAR = 42
_CLEARP = 43      # layer above clear
_CLEARN = 44      # layer below clear
_NOTTOP = 45      # (row 46: tan of the solar zenith angle)
NCOLROWS = 47
# per-column LW rows
_LUM, _LVM, _LVMN, _LCLEAR, _LCLEARP, _LCLEARN = 0, 9, 18, 27, 28, 29
LW_NCOLROWS = 30

#: launches of each CUDA kernel (incremented only where it is launched)
launches = {"spartacus_sw_adding": 0, "spartacus_lw_adding": 0}


def _mats(h, k0, n):
    """Packed rows k0 .. k0 + n^2 of (rows, ...) -> (n, n, ...)."""
    return h[k0:k0 + n * n].reshape((n, n) + h.shape[1:])


def _mat(c, base, n):
    """A 3 x 3-padded per-column matrix of the row list c -> (n, n, 1, L)."""
    return torch.stack([torch.stack([c[base + 3 * i + j] for j in range(n)])
                        for i in range(n)])


def _diag(M):
    return torch.stack([M[i, i] for i in range(M.shape[0])])


def _diag_mat(v):
    return _diag_g(v, v.shape[0])


def _flat(M):
    return M.reshape((M.shape[0] * M.shape[1],) + M.shape[2:])


def _rows(cols, n):
    return [cols[i:i + 1] for i in range(n)]


# ---- SW ----

def _step_migrations_k(nreg, cf, R, T, RD, TDD, TD, alb, albdir, x_diffuse,
                       x_direct, xld, xldir):
    """Horizontal migration distances (radiation_spartacus_sw.F90
    step_migrations; ecrad_tpu/ops/spartacus_adding.py:115-155)."""
    xl_diff, xl_dir = xld[None], xldir[None]
    Rd, Td, RDd, TDDd, TDd, Ad, ADd = (_diag(M) for M in (
        R, T, RD, TDD, TD, alb, albdir))
    ms = Td / torch.clamp(1.0 - Rd * Ad, min=1e-12)
    x_enh = torch.clamp(1.0 - Rd * Ad, min=1e-12) ** (-1.5)
    top_alb_dir = torch.clamp(RDd + ms * (TDd * Ad + TDDd * ADd), min=1e-8)
    x_dir_new = torch.clamp(xl_dir + (
        (TDd * Ad * x_enh + TDDd * ADd * (x_enh - 1.0))
        * (x_diffuse + xl_diff)
        + TDDd * ADd * (x_direct + xl_dir)) * Td / top_alb_dir, min=0.0)
    top_alb = torch.clamp(Rd + ms * Td * Ad, min=1e-8)
    x_diff_new = xl_diff + x_enh * Ad * Td * Td * (
        x_diffuse + xl_diff) / top_alb
    # region 0 active when not overcast, the cloudy regions when cloudy
    act = torch.cat([cf < 1.0] + [cf > 0.0] * (nreg - 1))[:, None]
    zero = torch.zeros((), dtype=cf.dtype, device=cf.device)
    return (torch.where(act, x_diff_new, zero),
            torch.where(act, x_dir_new, zero))


def _explicit_entrapment_k(cfg, nreg, alb_below, x_migration, vm, um, c):
    """Explicit / Non-fractal entrapment term of the total albedo
    (radiation_spartacus_sw.F90:1160-1330;
    ecrad_tpu/ops/spartacus_adding.py:158-207, and for 2 regions
    ecrad_tpu/solvers/spartacus_sw.py:547-604)."""
    entrap_total = 0.0
    inv_eff = torch.clamp(c[_INVEFF], max=1.0 / cfg.min_cloud_effective_size)
    not_top = c[_NOTTOP] > 0.5
    overlap_lev = c[_OVP]
    zero = torch.zeros((), dtype=vm.dtype, device=vm.device)
    for jreg2 in range(nreg):
        f_this = c[_RF + jreg2]
        f_prev = c[_RFP + jreg2]
        scaling = 1.0 - (1.0 - cfg.overhang_factor) * overlap_lev \
            * torch.minimum(f_this, f_prev) \
            / torch.clamp(f_this, min=cfg.cloud_fraction_threshold)
        scaling = torch.where(not_top, scaling, zero)
        rates = [(scaling * c[_EDGE + jreg]
                  / torch.clamp(um[jreg, jreg2], min=1e-5),
                  scaling * c[_EDGE + jreg]
                  / torch.clamp(um[jreg + 1, jreg2], min=1e-5))
                 for jreg in range(nreg - 1)]
        x2 = x_migration[jreg2]
        if cfg.i_3d_sw_entrapment == Entrapment.EXPLICIT:
            fractal = 1.0 / torch.sqrt(torch.clamp(2.5 * x2 * inv_eff,
                                                   min=1.0))
        else:
            fractal = 1.0
        a = rates[0][0] * x2 * fractal
        b = rates[0][1] * x2 * fractal
        if nreg == 3:
            cc = rates[1][0] * x2 * fractal
            d = rates[1][1] * x2 * fractal
            max_entr = torch.maximum(a, b + cc)
        else:
            max_entr = torch.maximum(a, b)
        scale = torch.where(max_entr > cfg.max_cloud_od,
                            cfg.max_cloud_od
                            / torch.clamp(max_entr, min=1e-12),
                            torch.ones((), dtype=a.dtype, device=a.device))
        if nreg == 3:
            Pg = fast_expm_exchange_3_g(a * scale, b * scale, cc * scale,
                                        d * scale)
        else:
            Pg = fast_expm_exchange_2_g(a * scale, b * scale)
        albdiag = alb_below[jreg2, jreg2]
        entrap_total = entrap_total + Pg * vm[jreg2][None] * albdiag[None,
                                                                     None]
    return entrap_total


def _migrations(cfg, n, carry, hist, cols):
    """(x_diffuse, x_direct), (n, ng, ncol): the carry's horizontal
    migration distances after this layer's step (Explicit and Non-fractal
    entrapment; the carry's as they are under the other treatments)."""
    n2 = n * n
    x_diff, x_dir = carry[2 * n2:2 * n2 + n], carry[2 * n2 + n:]
    if cfg.i_3d_sw_entrapment not in (Entrapment.EXPLICIT,
                                      Entrapment.EXPLICIT_NON_FRACTAL):
        return x_diff, x_dir
    c = _rows(cols, NCOLROWS)
    R, T, RD, TD, TDD = (_mats(hist, k * n2, n) for k in range(5))
    return _step_migrations_k(n, c[_CF], R, T, RD, TDD, TD,
                              _mats(carry, 0, n), _mats(carry, n2, n),
                              x_diff, x_dir, c[_XLD], c[_XLDIR])


def sw_up_step(cfg, nreg, carry, hist, cols):
    """One level of the upward SW sweep. carry (2 n^2 + 2 n, ng, ncol)
    [alb | albdir | x_diff | x_dir], n = nreg; hist (5 n^2, ng, ncol)
    [R | T | RD | TD | TDD]; cols (NCOLROWS, ncol). Returns (new carry,
    the carry's [alb | albdir] at entry: the albedos below this layer)."""
    n, n2 = nreg, nreg * nreg
    entrap = cfg.i_3d_sw_entrapment
    c = _rows(cols, NCOLROWS)
    alb, albdir = _mats(carry, 0, n), _mats(carry, n2, n)
    R, T, RD, TD, TDD = (_mats(hist, k * n2, n) for k in range(5))
    um, vm = _mat(c, _UM, n), _mat(c, _VM, n)
    vm_t = vm.transpose(0, 1)
    is_clear = c[_CLEAR] > 0.5
    both_clear = is_clear & (c[_CLEARP] > 0.5)
    explicit = entrap in (Entrapment.EXPLICIT,
                          Entrapment.EXPLICIT_NON_FRACTAL)
    x_diff, x_dir = _migrations(cfg, n, carry, hist, cols)

    denom = add_eye_g(-mm_gu(alb, R), 1.0)
    rhs = torch.cat([mm_gu(alb, T), mm_gu(albdir, TDD) + mm_gu(alb, TD)], 1)
    X = mm_gu(T, solve_g(denom, rhs))
    alb_below = _zero_offdiag_clear(R + X[:, :n], is_clear)
    albdir_below = _zero_offdiag_clear(RD + X[:, n:], is_clear)

    if entrap == Entrapment.MAXIMUM:
        mixed = mm_gu(mm_gu(um, alb_below), vm)
        mixed_dir = mm_gu(mm_gu(um, albdir_below), vm)
    elif entrap == Entrapment.ZERO:
        col_sum = alb_below[0]
        col_sum_d = albdir_below[0]
        for i in range(1, n):
            col_sum = col_sum + alb_below[i]
            col_sum_d = col_sum_d + albdir_below[i]
        mixed = _diag_mat(mv_gu(vm_t, col_sum))
        mixed_dir = _diag_mat(mv_gu(vm_t, col_sum_d))
    else:
        mixed = mm_gu(mm_gu(um, alb_below - _diag_mat(_diag(alb_below))),
                      vm)
        mixed_dir = mm_gu(mm_gu(um, albdir_below
                                - _diag_mat(_diag(albdir_below))), vm)
        if entrap == Entrapment.EDGE_ONLY or not cfg.do_3d_effects:
            mixed = mixed + _diag_mat(mv_gu(vm_t, _diag(alb_below)))
            mixed_dir = mixed_dir + _diag_mat(mv_gu(vm_t,
                                                    _diag(albdir_below)))
        else:
            mixed = mixed + _explicit_entrapment_k(cfg, n, alb_below,
                                                   x_diff, vm, um, c)
            mixed_dir = mixed_dir + _explicit_entrapment_k(
                cfg, n, albdir_below, x_dir, vm, um, c)
    alb_keep = torch.where(both_clear, alb_below, mixed)
    albdir_keep = torch.where(both_clear, albdir_below, mixed_dir)
    if explicit:
        x_diff = torch.where(both_clear, x_diff, mv_gu(vm_t, x_diff))
        x_dir = torch.where(both_clear, x_dir, mv_gu(vm_t, x_dir))
    return (torch.cat([_flat(alb_keep), _flat(albdir_keep), x_diff, x_dir]),
            carry[:2 * n2])


def sw_dn_step(nreg, carry, hist, ys_up, cols):
    """One level of the downward SW sweep: carry (2 n, ng, ncol) [flux_dn
    | direct]; ys_up (2 n^2, ng, ncol) [alb_below | albdir_below]. Returns
    (new carry, (3 n, ng, ncol) [fup | fdn | ddn] at the top of this
    layer)."""
    n, n2 = nreg, nreg * nreg
    c = _rows(cols, NCOLROWS)
    flux_dn, direct_dn = carry[:n], carry[n:]
    R, T = _mats(hist, 0, n), _mats(hist, n2, n)
    TD, TDD = _mats(hist, 3 * n2, n), _mats(hist, 4 * n2, n)
    alb_b, albdir_b = _mats(ys_up, 0, n), _mats(ys_up, n2, n)
    vm_next = _mat(c, _VMN, n)
    is_clear = c[_CLEAR] > 0.5
    both_clear = is_clear & (c[_CLEARN] > 0.5)
    source_dn = mv_gu(TD, direct_dn)
    direct_above = mv_gu(TDD, direct_dn)
    denom = add_eye_g(-mm_gu(R, alb_b), 1.0)
    total_source = mv_gu(albdir_b, direct_above)
    rhs = mv_gu(T, flux_dn) + mv_gu(R, total_source) + source_dn
    fdn_above = solve_vec_g(denom, rhs)
    fup_above = mv_gu(alb_b, fdn_above) + total_source
    fdn_above, fup_above, direct_above = (
        _zero_cloudy_vec(x, is_clear)
        for x in (fdn_above, fup_above, direct_above))
    fdn_out = torch.where(both_clear, fdn_above, mv_gu(vm_next, fdn_above))
    ddn_out = torch.where(both_clear, direct_above,
                          mv_gu(vm_next, direct_above))
    return (torch.cat([fdn_out, ddn_out]),
            torch.cat([fup_above, fdn_above, direct_above]))


def pack_cols(um, vm, cf, dz, xld, xldir, edge_prev, inv_eff, ovp, rf,
              rf_prev, clear, clear_prev, clear_next, tan_sza):
    """(nlev, NCOLROWS, ncol) per-column SW rows. um/vm (nlev+1, nreg,
    nreg, ncol); cf/dz/xld/xldir/inv_eff/ovp (nlev, ncol); edge_prev (nlev,
    3, ncol); rf/rf_prev (nlev, nreg, ncol); clear* (nlev, ncol) bool;
    tan_sza (ncol,)."""
    nlev, ncol = cf.shape
    nreg = um.shape[1]

    def rows9(m):
        out = m.new_zeros((m.shape[0], 3, 3, ncol))
        out[:, :nreg, :nreg] = m
        return out.reshape(m.shape[0], 9, ncol)

    def rows3(x):
        out = x.new_zeros((nlev, 3, ncol))
        out[:, :x.shape[1]] = x
        return out

    row = lambda x: x.to(cf.dtype).expand(nlev, ncol)[:, None]
    not_top = (torch.arange(nlev, device=cf.device) > 0)[:, None]
    return torch.cat([rows9(um[:nlev]), rows9(vm[:nlev]), rows9(vm[1:]),
                      row(cf), row(dz), row(xld), row(xldir),
                      rows3(edge_prev), row(inv_eff), row(ovp), rows3(rf),
                      rows3(rf_prev), row(clear), row(clear_prev),
                      row(clear_next), row(not_top),
                      row(tan_sza[None])], 1).contiguous()


def sw_adding_sweeps_plain(cfg, hist, cols, init_up, direct0,
                           dump=False):
    """Kernel B8's plain version. hist (nlev, 5 n^2, ng, ncol); cols
    (nlev, NCOLROWS, ncol); init_up (2 n^2, ng, ncol) [alb | albdir] at
    the surface; direct0 (n, ng, ncol) the direct flux entering the top.
    Returns (alb_top, albdir_top (n, n, ng, ncol), (nlev, 3 n, ng, ncol)
    [fup | fdn | ddn] at the top of each layer). With `dump`, a fourth
    item: the entrapment internals (x_direct, x_diffuse, direct_dn,
    flux_dn), each (nlev, n, ng, ncol): the migration distances at the top
    of each layer after its step and before the overlap conversion, and
    the direct and diffuse downward fluxes entering its top
    (radiation_spartacus_sw.F90:1007-1020, :1486-1497;
    ecrad_tpu/solvers/spartacus_sw.py:409-413, :433-436). B8 writes none
    of these; the g-points are independent, so one g-point's slice of the
    operands gives that g-point's values."""
    nlev = hist.shape[0]
    n = direct0.shape[0]
    carry = torch.cat([init_up, init_up.new_zeros((2 * n,)
                                                  + init_up.shape[1:])])
    ys = [None] * nlev
    x_dump = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        if dump:
            x_dump[l] = _migrations(cfg, n, carry, hist[l], cols[l])
        carry, ys[l] = sw_up_step(cfg, n, carry, hist[l], cols[l])
    dcarry = torch.cat([torch.zeros_like(direct0), direct0])
    out, dn_dump = [], []
    for l in range(nlev):
        dn_dump.append(dcarry)
        dcarry, o = sw_dn_step(n, dcarry, hist[l], ys[l], cols[l])
        out.append(o)
    result = (_mats(carry, 0, n), _mats(carry, n * n, n), torch.stack(out))
    if not dump:
        return result
    x_diff, x_dir = (torch.stack(x) for x in zip(*x_dump))
    dn = torch.stack(dn_dump)
    return result + ((x_dir, x_diff, dn[:, n:], dn[:, :n]),)


def sw_adding_sweeps_fused(cfg, hist, cols, init_up, direct0):
    """Kernel B8, same arguments and result as the plain version, on
    CUDA operands of one dtype, float32 or float64 (the result in it)."""
    nlev, nrows, ng, ncol = hist.shape
    n = direct0.shape[0]
    if n not in (2, 3) or nrows != 5 * n * n:
        raise ValueError(f"SPARTACUS takes 2 or 3 regions (hist rows "
                         f"{nrows}, {n} regions)")
    dt = _cuda.scalar(hist, "hist")
    _cuda.check(hist, dt, (nlev, 5 * n * n, ng, ncol), "hist")
    _cuda.check(cols, dt, (nlev, NCOLROWS, ncol), "cols")
    _cuda.check(init_up, dt, (2 * n * n, ng, ncol), "init_up")
    _cuda.check(direct0, dt, (n, ng, ncol), "direct0")
    dev = hist.device
    scratch = torch.empty((nlev, 2 * n * n, ng, ncol), dtype=dt, device=dev)
    top = torch.empty((2, n, n, ng, ncol), dtype=dt, device=dev)
    out = torch.empty((nlev, 3 * n, ng, ncol), dtype=dt, device=dev)
    _cuda.launch("spartacus_sw_adding", hist, cols, init_up, direct0, n,
                 nlev, ng, ncol, int(cfg.i_3d_sw_entrapment),
                 int(bool(cfg.do_3d_effects)), cfg.max_cloud_od,
                 1.0 / cfg.min_cloud_effective_size,
                 1.0 - cfg.overhang_factor, cfg.cloud_fraction_threshold,
                 scratch, top[0], top[1], out, dtype=dt)
    launches["spartacus_sw_adding"] += 1
    return top[0], top[1], out


@hooks.hooked("ecrad.sweeps")
def sw_adding_sweeps(cfg, hist, *args):
    """The SW adding sweeps: the plain loops on CPU tensors, kernel B8 on
    any other (which raises unless its operands are CUDA float32 or CUDA
    float64, all of one dtype, and contiguous)."""
    if hist.device.type == "cpu":
        return sw_adding_sweeps_plain(cfg, hist, *args)
    return sw_adding_sweeps_fused(cfg, hist, *args)


# ---- LW ----

def lw_up_step(cfg, use_matrix, nreg, carry, hist, cols):
    """One level of the upward LW sweep: carry (n^2 + n, ng, ncol) [alb |
    src]; hist (2 n (n + 1), ng, ncol) [R | T | SU | SD]; cols
    (LW_NCOLROWS, ncol). Returns (new carry, the carry at entry)."""
    n, n2 = nreg, nreg * nreg
    c = _rows(cols, LW_NCOLROWS)
    alb, src = _mats(carry, 0, n), carry[n2:]
    R, T = _mats(hist, 0, n), _mats(hist, n2, n)
    SU, SD = hist[2 * n2:2 * n2 + n], hist[2 * n2 + n:]
    um, vm = _mat(c, _LUM, n), _mat(c, _LVM, n)
    is_clear = c[_LCLEAR] > 0.5
    both_clear = is_clear & (c[_LCLEARP] > 0.5)
    if use_matrix:
        denom = add_eye_g(-mm_gu(alb, R), 1.0)
        alb_below = R + mm_gu(T, solve_g(denom, mm_gu(alb, T)))
        src_below = SU + mv_gu(T, solve_vec_g(denom, src + mv_gu(alb, SD)))
    else:
        Rd, Td, Ad = _diag(R), _diag(T), _diag(alb)
        inv = 1.0 / (1.0 - Ad * Rd)
        alb_below = _diag_mat(Rd + Td * Td * Ad * inv)
        src_below = SU + Td * (src + Ad * SD) * inv
    alb_below = _zero_offdiag_clear(alb_below, is_clear)
    src_below = _zero_cloudy_vec(src_below, is_clear)
    src_mixed = mv_gu(um, src_below)
    if cfg.do_3d_lw_multilayer_effects:
        alb_mixed = mm_gu(mm_gu(um, alb_below), vm)
    else:
        alb_mixed = _diag_mat(mv_gu(vm.transpose(0, 1), _diag(alb_below)))
    return (torch.cat([_flat(torch.where(both_clear, alb_below, alb_mixed)),
                       torch.where(both_clear, src_below, src_mixed)]),
            carry)


def lw_dn_step(use_matrix, nreg, carry, hist, ys_up, cols):
    """One level of the downward LW sweep: carry (n, ng, ncol) flux_dn;
    ys_up (n^2 + n, ng, ncol) [alb_below | src_below]. Returns (new carry,
    (2 n, ng, ncol) [fup | fdn] at the top of this layer, fdn after the
    overlap into the layer below)."""
    n, n2 = nreg, nreg * nreg
    c = _rows(cols, LW_NCOLROWS)
    R, T = _mats(hist, 0, n), _mats(hist, n2, n)
    SD = hist[2 * n2 + n:]
    alb_b, src_b = _mats(ys_up, 0, n), ys_up[n2:]
    vm_next = _mat(c, _LVMN, n)
    is_clear = c[_LCLEAR] > 0.5
    both_clear = is_clear & (c[_LCLEARN] > 0.5)
    if use_matrix:
        denom = add_eye_g(-mm_gu(R, alb_b), 1.0)
        rhs = mv_gu(T, carry) + mv_gu(R, src_b) + SD
        fdn_above = solve_vec_g(denom, rhs)
        fup_above = mv_gu(alb_b, fdn_above) + src_b
    else:
        Rd, Td, Ad = _diag(R), _diag(T), _diag(alb_b)
        fdn_above = (Td * carry + Rd * src_b + SD) / (1.0 - Rd * Ad)
        fup_above = src_b + Ad * fdn_above
    fdn_above = _zero_cloudy_vec(fdn_above, is_clear)
    fup_above = _zero_cloudy_vec(fup_above, is_clear)
    fdn_out = torch.where(both_clear, fdn_above, mv_gu(vm_next, fdn_above))
    return fdn_out, torch.cat([fup_above, fdn_out])


def lw_pack_cols(um, vm, clear, clear_prev, clear_next):
    """(nlev, LW_NCOLROWS, ncol) per-column LW rows; um/vm (nlev+1, nreg,
    nreg, ncol), clear* (nlev, ncol) bool."""
    nlev, ncol = clear.shape
    nreg = um.shape[1]

    def rows9(m):
        out = m.new_zeros((m.shape[0], 3, 3, ncol))
        out[:, :nreg, :nreg] = m
        return out.reshape(m.shape[0], 9, ncol)

    row = lambda x: x.to(um.dtype)[:, None]
    return torch.cat([rows9(um[:nlev]), rows9(vm[:nlev]), rows9(vm[1:]),
                      row(clear), row(clear_prev), row(clear_next)],
                     1).contiguous()


def lw_adding_sweeps_plain(cfg, use_matrix, hist, cols, init_up):
    """Kernel B9's plain version. hist (nlev, 2 n (n+1), ng, ncol); cols
    (nlev, LW_NCOLROWS, ncol); init_up (n^2 + n, ng, ncol) [alb | src] at
    the surface. Returns (src_top (n, ng, ncol), (nlev, 2 n, ng, ncol)
    [fup | fdn])."""
    nlev = hist.shape[0]
    n = {6: 2, 12: 3}[init_up.shape[0]]
    carry = init_up
    ys = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        carry, ys[l] = lw_up_step(cfg, use_matrix, n, carry, hist[l],
                                  cols[l])
    fdn = init_up.new_zeros((n,) + init_up.shape[1:])
    out = []
    for l in range(nlev):
        fdn, o = lw_dn_step(use_matrix, n, fdn, hist[l], ys[l], cols[l])
        out.append(o)
    return carry[n * n:], torch.stack(out)


def lw_adding_sweeps_fused(cfg, use_matrix, hist, cols, init_up):
    """Kernel B9, same arguments and result as the plain version, on
    CUDA operands of one dtype, float32 or float64 (the result in it)."""
    nlev, nrows, ng, ncol = hist.shape
    n = {12: 2, 24: 3}.get(nrows)
    if n is None:
        raise ValueError(f"SPARTACUS takes 2 or 3 regions (hist rows "
                         f"{nrows})")
    dt = _cuda.scalar(hist, "hist")
    _cuda.check(hist, dt, (nlev, nrows, ng, ncol), "hist")
    _cuda.check(cols, dt, (nlev, LW_NCOLROWS, ncol), "cols")
    _cuda.check(init_up, dt, (n * n + n, ng, ncol), "init_up")
    dev = hist.device
    # the carry entering each level going up: the albedo matrix and the
    # source with multilayer effects; without them every carry an up step
    # makes is diagonal (lw_up_step), so its diagonal and the source
    multilayer = bool(cfg.do_3d_lw_multilayer_effects)
    rows = n * n + n if multilayer else 2 * n
    scratch = torch.empty((nlev, rows, ng, ncol), dtype=dt, device=dev)
    src_top = torch.empty((n, ng, ncol), dtype=dt, device=dev)
    out = torch.empty((nlev, 2 * n, ng, ncol), dtype=dt, device=dev)
    _cuda.launch("spartacus_lw_adding", hist, cols, init_up, n, nlev, ng,
                 ncol, int(bool(use_matrix)), int(multilayer), scratch,
                 src_top, out, dtype=dt)
    launches["spartacus_lw_adding"] += 1
    return src_top, out


@hooks.hooked("ecrad.sweeps")
def lw_adding_sweeps(cfg, use_matrix, hist, *args):
    """The LW adding sweeps: the plain loops on CPU tensors, kernel B9 on
    any other (which raises unless its operands are CUDA float32 or CUDA
    float64, all of one dtype, and contiguous)."""
    if hist.device.type == "cpu":
        return lw_adding_sweeps_plain(cfg, use_matrix, hist, *args)
    return lw_adding_sweeps_fused(cfg, use_matrix, hist, *args)
