"""PyTorch port: what kernels B3 and B3''s adding design
(ecrad_tpu_torch/csrc/level_sweep.cu, sw_adding and lw_adding) relies on,
checked on the CPU against the plain versions (solvers/adding.py).

- The kernels keep, per level, only the albedo and the source below it
  for the descent. SW then recomputes the unscaled direct flux in the
  descent from tdir, as its first sweep did, and LW re-reads the downward
  source. Restated in PyTorch with the kernels' operation order, both
  give adding_sw_plain / adding_lw_plain bit for bit, at 1, 2, 7 and 137
  levels.
- The on-chip windows are written twice (SW_ONCHIP_LEVELS and
  LW_ONCHIP_LEVELS in the .cu file and in ops/adding_fused.py) and they
  agree; at 137 levels a block (one warp, 2 floats per level and the copy
  ring) leaves room for 5 blocks on an SM of the H100 (228 KB of shared
  memory, 1 KB reserved per block), and every sweep's operands fit a ring
  group.
"""
import os
import re

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.ops import adding_fused
from ecrad_tpu_torch.solvers import adding


def _cu():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ecrad_tpu_torch", "csrc",
        "level_sweep.cu")
    with open(path) as f:
        return f.read()


def _const(src, name):
    return int(re.search(r"\b%s = (\d+)" % name, src).group(1))


def sw_kept(ref, trans, ref_dir, tdif, tdir, inc, alb_diff, alb_dir,
            cos_sza):
    """sw_adding's sweeps: the direct flux kept per level until the ascent
    replaces it by the source; the descent recomputes it from tdir."""
    nlev = ref.shape[0]
    cs = cos_sza[None, :]
    kept_src, kept_alb = [None] * nlev, [None] * nlev
    fdir, dn_dir = inc, []
    for l in range(nlev):
        kept_src[l] = fdir
        dn_dir.append(fdir * cs)
        fdir = tdir[l] * fdir
    dn_dir.append(fdir * cs)
    alb, src = alb_diff, alb_dir * fdir * cs
    for l in range(nlev - 1, -1, -1):
        r, t, fdt = ref[l], trans[l], kept_src[l]
        kept_src[l], kept_alb[l] = src, alb
        inv_denom = 1.0 / (1.0 - alb * r)
        alb_new = r + t * t * alb * inv_denom
        src = ref_dir[l] * fdt + t * (src + alb * tdif[l] * fdt) * inv_denom
        alb = alb_new
    fd, up, dn = torch.zeros_like(inc), [alb * 0.0 + src], []
    dn.append(fd)
    fdir = inc
    for l in range(nlev):
        r, a_below, s_below = ref[l], kept_alb[l], kept_src[l]
        fdt = fdir
        fdir = tdir[l] * fdir
        inv_denom = 1.0 / (1.0 - a_below * r)
        fd = (trans[l] * fd + r * s_below + tdif[l] * fdt) * inv_denom
        dn.append(fd)
        up.append(a_below * fd + s_below)
    return torch.stack(up), torch.stack(dn), torch.stack(dn_dir)


def lw_kept(ref, trans, src_up, src_dn, emission, alb_surf):
    """lw_adding's sweeps: (albedo, source) below each level kept, the
    downward source re-read in the descent."""
    nlev = ref.shape[0]
    kept_alb, kept_src = [None] * nlev, [None] * nlev
    alb, src = alb_surf, emission
    for l in range(nlev - 1, -1, -1):
        r, t = ref[l], trans[l]
        kept_alb[l], kept_src[l] = alb, src
        inv_denom = 1.0 / (1.0 - alb * r)
        alb_new = r + t * t * alb * inv_denom
        src = src_up[l] + t * (src + alb * src_dn[l]) * inv_denom
        alb = alb_new
    fd, up, dn = torch.zeros_like(emission), [alb * 0.0 + src], []
    dn.append(fd)
    for l in range(nlev):
        r, a_below, s_below = ref[l], kept_alb[l], kept_src[l]
        inv_denom = 1.0 / (1.0 - a_below * r)
        fd = (trans[l] * fd + r * s_below + src_dn[l]) * inv_denom
        dn.append(fd)
        up.append(a_below * fd + s_below)
    return torch.stack(up), torch.stack(dn)


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _args(kind, nlev, ng, ncol, dtype, seed):
    rng = np.random.RandomState(seed)
    r = lambda *s, lo=0.0, hi=1.0: torch.as_tensor(      # noqa: E731
        (lo + (hi - lo) * rng.rand(*s)).astype(dtype))
    if kind == "sw":
        return (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
                r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, hi=0.4),
                r(nlev, ng, ncol, lo=0.2, hi=0.9), r(ng, ncol, hi=1300.0),
                r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05))
    return (r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, lo=0.2, hi=0.7),
            r(nlev, ng, ncol, hi=50.0), r(nlev, ng, ncol, hi=50.0),
            r(ng, ncol, hi=400.0), r(ng, ncol, hi=0.2))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nlev", [1, 2, 7, 137])
@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_kept_sweeps_are_bit_identical_to_plain(kind, nlev, dtype):
    args = _args(kind, nlev, 15, 13, dtype, nlev)
    got = (sw_kept if kind == "sw" else lw_kept)(*args)
    ref = (adding.adding_sw_plain if kind == "sw"
           else adding.adding_lw_plain)(*args)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert torch.equal(_bits(g), _bits(r))


def test_onchip_windows_and_shared_memory_budget():
    s = _cu()
    windows = (_const(s, "SW_ONCHIP_LEVELS"), _const(s, "LW_ONCHIP_LEVELS"))
    assert windows == (adding_fused.SW_ONCHIP_LEVELS,
                       adding_fused.LW_ONCHIP_LEVELS)
    assert min(windows) >= 137
    kept, threads = _const(s, "KEPT"), _const(s, "ADD_THREADS")
    group, groups = _const(s, "RING_GROUP"), _const(s, "RING_GROUPS")
    per_block = (kept * 137 + group * groups) * threads * 4
    assert 5 * (per_block + 1024) <= 228 * 1024
    # a block at the largest window still fits an SM's 227 KB
    assert (kept * max(windows) + group * groups) * threads * 4 \
        <= 227 * 1024
    # each sweep's operands fit a group: 1 (direct beam), 4 (ascent, SW
    # descent), 3 (LW descent)
    assert all(group // ops >= 1 for ops in (1, 3, 4))
    # the wrappers' scratch holds the levels above the window
    for onchip in windows:
        assert tuple(adding_fused._spill(onchip + 7, 3, 5, onchip,
                                         "cpu").shape) == (kept, 7, 3, 5)
        assert adding_fused._spill(137, 3, 5, onchip, "cpu").numel() == 0


def test_double_windows_and_shared_memory_budget():
    """The double forms' windows (csrc/level_sweep.cu F64_SW_ONCHIP_LEVELS,
    F64_LW_ONCHIP_LEVELS) as ops/adding_fused.py has them: SW keeps every
    level of 137 on chip, 2 blocks per SM of 228 KB; LW keeps 96, the top
    41 of 137 in the scratch, 3 blocks per SM; a block at the largest
    window still fits an SM's 227 KB (8-byte values, the ring in doubles
    too)."""
    s = _cu()
    windows = (_const(s, "F64_SW_ONCHIP_LEVELS"),
               _const(s, "F64_LW_ONCHIP_LEVELS"))
    assert windows == adding_fused.F64_ONCHIP_LEVELS == (256, 96)
    kept, threads = _const(s, "KEPT"), _const(s, "ADD_THREADS")
    ring = _const(s, "RING_GROUP") * _const(s, "RING_GROUPS")

    def block(nlev, onchip):
        return (kept * min(nlev, onchip) + ring) * threads * 8

    assert 2 * (block(137, windows[0]) + 1024) <= 228 * 1024
    assert 3 * (block(137, windows[1]) + 1024) <= 228 * 1024
    assert block(windows[0], windows[0]) <= 227 * 1024
    # the wrappers' float64 scratch holds the levels above the window
    spill = adding_fused._spill(137, 3, 5, windows[1], "cpu", torch.float64)
    assert spill.dtype == torch.float64
    assert tuple(spill.shape) == (kept, 137 - windows[1], 3, 5)
    assert adding_fused._spill(137, 3, 5, windows[0], "cpu",
                               torch.float64).numel() == 0
