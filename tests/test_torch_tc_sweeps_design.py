"""PyTorch port: what kernel B5's design (ecrad_tpu_torch/csrc/tc_sweeps.cu,
the Tripleclouds region sweeps) relies on, checked on the CPU against
its plain versions (solvers/tripleclouds.py tc_sw_sweeps_plain,
tc_lw_sweeps_plain).

- In a clear layer the plain versions compute the cloudy regions
  (r >= 1) and then zero them, so those regions' operands cannot reach
  the output: set to NaN, the plain versions give the same bits.
- The kernel loads none of them, and keeps (writes to the scratch and
  reads back) no history for them, except the LW source below a clear
  layer that sits on a cloudy one or on the surface. Restated in PyTorch
  with the kernel's operation order, NaN in every value it does not load
  or keep, its sweeps give the plain versions' bits, for 2 and 3
  regions, at 1, 2, 7 and 40 levels, on all-clear, all-cloudy and
  alternating clear patterns (and a random one).
- The block's shared memory (its threads' clear bits and copy rings and
  its overlap-matrix ring, the .cu constants) leaves room for 9 blocks on
  an SM of the H100 at 137 levels and 3 regions, and fits at 300.
"""
import os
import re

import pytest
import torch

from ecrad_tpu_torch.solvers import tripleclouds as tc

NG, NCOL = 5, 13
PATTERNS = ("all_clear", "all_cloudy", "alternating", "random")


def _cu():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ecrad_tpu_torch", "csrc",
        "tc_sweeps.cu")
    with open(path) as f:
        return f.read()


def _const(src, name):
    return int(re.search(r"\b%s = (\d+)" % name, src).group(1))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _clear(pattern, nlev, seed):
    if pattern == "all_clear":
        return torch.ones(nlev, NCOL, dtype=torch.bool)
    if pattern == "all_cloudy":
        return torch.zeros(nlev, NCOL, dtype=torch.bool)
    if pattern == "alternating":
        lev, col = torch.meshgrid(torch.arange(nlev), torch.arange(NCOL),
                                  indexing="ij")
        return (lev + col) % 2 == 0
    gen = torch.Generator().manual_seed(seed + 1)
    return torch.rand(nlev, NCOL, generator=gen) < 0.6


def _args(kind, nreg, nlev, pattern, seed=0):
    """Random region optics (the ranges of tests/test_torch_kernels_gpu.py's
    B5 cases), overlap matrices and the clear pattern, as the sweeps take
    them."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(  # noqa
        *s, generator=gen)
    lay = (nlev, nreg, NG, NCOL)
    clear = _clear(pattern, nlev, seed)
    v, u = r(nlev + 1, nreg, nreg, NCOL), r(nlev, nreg, nreg, NCOL)
    frac = r(nreg, NCOL, lo=0.05, hi=0.6)
    if kind == "sw":
        return (r(*lay, hi=0.4), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=0.3),
                r(*lay, hi=0.4), r(*lay, lo=0.2, hi=0.9), v, clear,
                r(NG, NCOL, hi=0.8), r(NG, NCOL, hi=0.8), r(NCOL, lo=0.05),
                r(NG, NCOL, hi=1300.0), frac)
    return (r(*lay, hi=0.3), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=20.0),
            r(*lay, hi=20.0), v, u, clear, r(NG, NCOL, hi=400.0),
            r(NG, NCOL, hi=0.2), frac)


def _unloaded(x, clear):
    """Layer operand x (nlev, nreg, ng, ncol) with NaN in the cloudy
    regions of the clear layers."""
    nan = torch.full((), float("nan"))
    keep = torch.ones(x.shape[:2] + (1, x.shape[3]), dtype=torch.bool)
    keep[:, 1:] = ~clear[:, None, None, :]
    return torch.where(keep, x, nan)


def _mix(m, x, transpose=False):
    n = len(x)
    out = []
    for i in range(n):
        s = (m[0, i] if transpose else m[i, 0]) * x[0]
        for j in range(1, n):
            s = s + (m[j, i] if transpose else m[i, j]) * x[j]
        out.append(s)
    return out


def _rsum(x):
    s = x[0]
    for y in x[1:]:
        s = s + y
    return s


def sw_skipping(ref, trans, ref_dir, tdd, tdir, v_mat, clear, alb_diff,
                alb_dir, mu0, incoming, frac_top):
    """tc_sw_kernel restated: the cloudy regions of a clear layer neither
    loaded nor kept (NaN), their results the plain version's zeros."""
    nlev, nreg = ref.shape[:2]
    nan, zero = torch.full((), float("nan")), torch.zeros(())
    ops = [_unloaded(x, clear) for x in (ref, trans, ref_dir, tdd, tdir)]
    bottom = clear[-1]
    adir = mu0 * alb_dir
    alb = [alb_diff] + [torch.where(bottom, zero, alb_diff)] * (nreg - 1)
    albdir = [adir] + [torch.where(bottom, zero, adir)] * (nreg - 1)
    kept = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        cl = clear[l]
        kept[l] = ([alb[0]] + [torch.where(cl, nan, a) for a in alb[1:]],
                   [albdir[0]] + [torch.where(cl, nan, a)
                                  for a in albdir[1:]])
        ab, adb = [], []
        for r in range(nreg):
            rr, t, rd, td, tl = (x[l, r] for x in ops)
            inv = 1.0 / (1.0 - alb[r] * rr)
            a_new = rr + t * t * alb[r] * inv
            d_new = rd + (tl * albdir[r] + td * alb[r]) * t * inv
            if r > 0:
                a_new = torch.where(cl, zero, a_new)
                d_new = torch.where(cl, zero, d_new)
            ab.append(a_new)
            adb.append(d_new)
        both = cl & (clear[l - 1] if l > 0 else True)
        alb = [torch.where(both, x, y)
               for x, y in zip(ab, _mix(v_mat[l], ab, True))]
        albdir = [torch.where(both, x, y)
                  for x, y in zip(adb, _mix(v_mat[l], adb, True))]
    direct = [incoming * frac_top[r] for r in range(nreg)]
    fdn = [torch.zeros_like(incoming)] * nreg
    up = [_rsum([d * a for d, a in zip(direct, albdir)])]
    dn_diff, dn_dir = [torch.zeros_like(incoming)], [_rsum(direct) * mu0]
    for l in range(nlev):
        cl = clear[l]
        a_k, adr_k = kept[l]
        fnew, dnew, fup = [], [], []
        for r in range(nreg):
            rr, t, td, tl = (x[l, r] for x in (ops[0], ops[1], ops[3],
                                                ops[4]))
            a, adr = a_k[r], adr_k[r]
            inv = 1.0 / (1.0 - rr * a)
            f = (t * fdn[r] + direct[r] * (tl * adr * rr + td)) * inv
            d = tl * direct[r]
            u = d * adr + f * a
            if r > 0:
                f, d, u = (torch.where(cl, zero, x) for x in (f, d, u))
            fnew.append(f)
            dnew.append(d)
            fup.append(u)
        up.append(_rsum(fup))
        both = cl & (clear[l + 1] if l + 1 < nlev else True)
        fdn = [torch.where(both, x, y)
               for x, y in zip(fnew, _mix(v_mat[l + 1], fnew))]
        direct = [torch.where(both, x, y)
                  for x, y in zip(dnew, _mix(v_mat[l + 1], dnew))]
        dn_diff.append(_rsum(fdn))
        dn_dir.append(_rsum(direct) * mu0)
    return torch.stack(up), torch.stack(dn_diff), torch.stack(dn_dir)


def lw_skipping(ref, trans, src_up, src_dn, v_mat, u_mat, clear, emission,
                albedo, frac_bot):
    """tc_lw_kernel restated: the cloudy regions of a clear layer neither
    loaded nor kept, except their source below a clear layer on a cloudy
    one or on the surface; the results the plain version's zeros."""
    nlev, nreg = ref.shape[:2]
    nan, zero = torch.full((), float("nan")), torch.zeros(())
    ops = [_unloaded(x, clear) for x in (ref, trans, src_up, src_dn)]
    keep_src = ~clear.clone()
    keep_src[-1] = True
    keep_src[:-1] |= ~clear[1:]
    alb = [albedo] * nreg
    src = [frac_bot[r] * emission for r in range(nreg)]
    kept = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        cl = clear[l]
        kept[l] = ([alb[0]] + [torch.where(cl, nan, a) for a in alb[1:]],
                   [src[0]] + [torch.where(keep_src[l], s, nan)
                               for s in src[1:]])
        ab, sb = [], []
        for r in range(nreg):
            rr, t, su, sd = (x[l, r] for x in ops)
            inv = 1.0 / (1.0 - alb[r] * rr)
            a_new = rr + t * t * alb[r] * inv
            s_new = su + t * (src[r] + alb[r] * sd) * inv
            if r > 0:
                a_new = torch.where(cl, zero, a_new)
                s_new = torch.where(cl, zero, s_new)
            ab.append(a_new)
            sb.append(s_new)
        both = cl & (clear[l - 1] if l > 0 else True)
        alb = [torch.where(both, x, y)
               for x, y in zip(ab, _mix(v_mat[l], ab, True))]
        src = [torch.where(both, x, y)
               for x, y in zip(sb, _mix(u_mat[l], sb))]
    fdn = [torch.zeros_like(emission)] * nreg
    up, dn = [_rsum(src)], [torch.zeros_like(emission)]
    for l in range(nlev):
        cl = clear[l]
        a_k, s_k = kept[l]
        fnew, fup = [], []
        for r in range(nreg):
            rr, t, sd = (x[l, r] for x in (ops[0], ops[1], ops[3]))
            s = s_k[r] if r == 0 else torch.where(keep_src[l], s_k[r], zero)
            a = a_k[r]
            inv = 1.0 / (1.0 - rr * a)
            f = (t * fdn[r] + rr * s + sd) * inv
            u = s + f * a
            if r > 0:
                f = torch.where(cl, zero, f)
                u = torch.where(cl, s + 0.0, u)
            fnew.append(f)
            fup.append(u)
        up.append(_rsum(fup))
        both = cl & (clear[l + 1] if l + 1 < nlev else True)
        fdn = [torch.where(both, x, y)
               for x, y in zip(fnew, _mix(v_mat[l + 1], fnew))]
        dn.append(_rsum(fdn))
    return torch.stack(up), torch.stack(dn)


PLAIN = {"sw": tc.tc_sw_sweeps_plain, "lw": tc.tc_lw_sweeps_plain}
SKIPPING = {"sw": sw_skipping, "lw": lw_skipping}
# the layer operands of each kind's arguments
N_LAYER_OPS = {"sw": 5, "lw": 4}


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("nreg", [3, 2])
@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_plain_ignores_cloudy_regions_of_clear_layers(kind, nreg, pattern):
    args = _args(kind, nreg, 7, pattern)
    clear = args[6]
    nan_args = tuple(_unloaded(x, clear) if k < N_LAYER_OPS[kind] else x
                     for k, x in enumerate(args))
    for got, ref in zip(PLAIN[kind](*nan_args), PLAIN[kind](*args)):
        assert bool(torch.isfinite(ref).all())
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("nlev", [1, 2, 7, 40])
@pytest.mark.parametrize("nreg", [3, 2])
@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_skipping_sweeps_are_bit_identical_to_plain(kind, nreg, nlev,
                                                    pattern):
    args = _args(kind, nreg, nlev, pattern, seed=nlev)
    got = SKIPPING[kind](*args)
    ref = PLAIN[kind](*args)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(r).all())
        assert torch.equal(_bits(g), _bits(r))


def test_shared_memory_budget():
    s = _cu()
    threads, ring = _const(s, "TC_THREADS"), _const(s, "TC_RING")
    slots = {"sw": _const(s, "SW_SLOTS"), "lw": _const(s, "LW_SLOTS")}
    mats = {"sw": _const(s, "SW_MATS"), "lw": _const(s, "LW_MATS")}
    # ring slots a level and region: SW 5 operands up, 4 and 2 history
    # values down; LW 4 up, 3 and 2 down. Matrices a level: SW V, LW V and
    # U going up
    assert slots == {"sw": max(5, 4 + 2), "lw": max(4, 3 + 2)}
    assert mats == {"sw": 1, "lw": 2}
    # a block is 32 columns x whole warps, one warp a g-point
    assert threads % 32 == 0 and ring >= 2

    def per_block(nlev, kind, nreg):
        # tc_smem_floats: a clear-bit word per 32 levels and the copy ring
        # a thread, the matrix ring (32 columns) a block
        return (((nlev + 31) // 32 + ring * slots[kind] * nreg) * threads
                + ring * mats[kind] * nreg * nreg * 32) * 4
    for kind in ("sw", "lw"):
        assert 9 * (per_block(137, kind, 3) + 1024) <= 228 * 1024
        assert per_block(300, kind, 3) + 1024 <= 228 * 1024
    assert re.search(r"return \(\(nlev \+ 31\) / 32 \+ TC_RING \* "
                     r"slots_per_reg \* nreg\) \* TC_THREADS\s+"
                     r"\+ TC_RING \* mats \* nreg \* nreg \* 32;", s)
