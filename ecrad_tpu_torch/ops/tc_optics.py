"""Kernel B11: Tripleclouds' SW layer optics in one pass
(csrc/tc_optics.cu), beside their plain PyTorch version.

For every (column, level, g) they compute the clear sky's layer optics
from the gas (sw_gammas, then sw_reftrans) and each region's: region 0
the gas, delta-Eddington scaled where the configuration scales the
gases; each cloudy region the gas mixed with the cloud's band
properties, expanded to g and scaled by the region's od_scaling, where
the layer is cloudy, else the gas (ecrad_tpu/solvers/tripleclouds.py:
156-225). Inputs come in the legacy layout (ncol, nlev, ng|nb|nreg);
the outputs leave g-first, as the sweeps read them: the region family
(ref, trans, ref_dir, trans_dir_diff, trans_dir_dir), each (nlev, nreg,
ng, ncol), and the clear family, each (nlev, ng, ncol).

`tc_sw_optics_plain` is the composition the solver ran before the
kernel: the region mix, delta_eddington, two_stream.sw_gammas and
two_stream.sw_reftrans, whose float32 resonance window finds its cells
with a host sync. `tc_sw_optics_fused` launches the kernel, which takes
CUDA float32 operands only (it evaluates that window in double itself,
with no sync) and returns two fresh buffers, (5, nlev, nreg, ng, ncol)
and (5, nlev, ng, ncol), as views of their first axis.
"""
from __future__ import annotations

import torch

from ..optics.cloud import delta_eddington
from ..solvers import two_stream as ts
from ..solvers.cloudless import _gf
from . import _cuda

#: launches of the CUDA kernel (incremented only where it is launched)
launches = {"tc_sw_optics": 0}


def tc_sw_optics_plain(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                       band_from_g, od_scaling, cloudy, mu0, delta_all):
    """od/ssa/g (ncol, nlev, ng); *_cloud (ncol, nlev, nb); band_from_g
    (ng,); od_scaling (ncol, nlev, nreg); cloudy (ncol, nlev) bool; mu0
    (ncol,) the clamped cosine of the solar zenith angle. Returns (region,
    clear): 5 (nlev, nreg, ng, ncol) and 5 (nlev, ng, ncol) tensors."""
    od_g, ssa_g, g_g = _gf(od), _gf(ssa), _gf(g)
    odc, ssac, gc = (_gf(x)[:, band_from_g, :]
                     for x in (od_cloud, ssa_cloud, g_cloud))
    sc = od_scaling.permute(1, 2, 0)                 # (nlev, nreg, ncol)
    cmask = cloudy.T[:, None, :]
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    outs = [[od_g], [ssa_g], [g_g]]
    for r in range(1, sc.shape[1]):
        odc_r = odc * sc[:, r][:, None, :]
        od_t = od_g + odc_r
        scat = ssa_g * od_g + ssac * odc_r
        ssa_t = torch.where(od_t > 0, scat / torch.clamp(od_t, min=1e-30),
                            zero)
        g_t = torch.where(scat > 0,
                          (g_g * ssa_g * od_g + gc * ssac * odc_r)
                          / torch.clamp(scat, min=1e-30), zero)
        for out, x, base in zip(outs, (od_t, ssa_t, g_t), (od_g, ssa_g, g_g)):
            out.append(torch.where(cmask, x, base))
    od_r, ssa_r, g_r = (torch.stack(o, 1) for o in outs)
    if delta_all:
        od_r, ssa_r, g_r = delta_eddington(od_r, ssa_r, g_r)
    mu0_r = mu0[None, None, None, :]
    region = ts.sw_reftrans(mu0_r, od_r, ssa_r,
                            *ts.sw_gammas(mu0_r, ssa_r, g_r))
    mu0_c = mu0[None, :]
    clear = ts.sw_reftrans(mu0_c, od_g, ssa_g,
                           *ts.sw_gammas(mu0_c, ssa_g, g_g))
    return region, clear


def tc_sw_optics_fused(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                       band_from_g, od_scaling, cloudy, mu0, delta_all):
    """Kernel B11 on CUDA float32 operands and an int32 band_from_g
    (SpecTensors.band_sw32); arguments and results as
    tc_sw_optics_plain."""
    ncol, nlev, ng = od.shape
    nb = od_cloud.shape[-1]
    nreg = od_scaling.shape[-1]
    f32 = torch.float32
    for name, x in (("od", od), ("ssa", ssa), ("g", g)):
        _cuda.check(x, f32, (ncol, nlev, ng), name)
    for name, x in (("od_cloud", od_cloud), ("ssa_cloud", ssa_cloud),
                    ("g_cloud", g_cloud)):
        _cuda.check(x, f32, (ncol, nlev, nb), name)
    _cuda.check(od_scaling, f32, (ncol, nlev, nreg), "od_scaling")
    _cuda.check(cloudy, torch.bool, (ncol, nlev), "cloudy")
    _cuda.check(mu0, f32, (ncol,), "mu0")
    _cuda.check(band_from_g, torch.int32, (ng,), "band_from_g")
    region = torch.empty((5, nlev, nreg, ng, ncol), dtype=f32,
                         device=od.device)
    clear = torch.empty((5, nlev, ng, ncol), dtype=f32, device=od.device)
    _cuda.launch("tc_sw_optics", od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                 od_scaling, cloudy, mu0, band_from_g, ncol, nlev, ng, nb,
                 nreg, int(bool(delta_all)), region, clear, dtype=f32)
    launches["tc_sw_optics"] += 1
    return tuple(region), tuple(clear)
