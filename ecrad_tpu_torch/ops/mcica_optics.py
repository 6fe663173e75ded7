"""Kernel B4: the McICA clear- and total-sky layer optics in one pass
(csrc/mcica_optics.cu), beside their plain PyTorch versions.

Replaces ecrad_tpu/ops/mcica_optics.py::sw_clear_total_reftrans (:74,
pallas_call :175 and :181) and ::lw_clear_total_noscat (:196,
pallas_call :269). For every (column, level, g) they expand the cloud's
band properties to g, scale the cloud optical depth by the subcolumn's
od_scaling, combine cloud and gas, and compute the clear-sky and the
total-sky layer properties (SW: optional delta-Eddington, then the
Meador-Weaver reflectances and transmittances; LW without scattering:
transmittance and the two sources), the total family taking the clear
values where the layer is not cloudy. Inputs come in the legacy layout
(ncol, nlev, ng|nb); every output leaves g-first, (nlev, ng, ncol), as
the adding sweeps read it.

The plain versions are the JAX package's `use_pallas=False` branches
(:88-99, :211-224). `sw_clear_total_reftrans` and
`lw_clear_total_noscat` run them on CPU tensors and the kernels on any
other (which raises unless it is CUDA float32).

The kernels read each input once and write each output once. On the
TPU the band->g expansion was a one-hot MXU product and the clear chain
was recomputed in a second kernel to stay under the VMEM limit; here the
expansion is a direct index band_from_g[g] and one thread computes both
families of its cell. The (column, g) -> (g, column) transpose goes
through a shared-memory tile per level, so loads along g and stores
along columns are both coalesced.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..optics.cloud import delta_eddington
from ..optics.combine import combine_cloud_gas_sw
from ..solvers import two_stream as ts
from ..utils import hooks
from . import _cuda

#: launches of each CUDA kernel (incremented only where it is launched)
launches = {"mcica_sw_optics": 0, "mcica_lw_optics": 0}


def _gf(x):
    """(ncol, nlev, ng) -> contiguous (nlev, ng, ncol)."""
    return x.permute(1, 2, 0).contiguous()


def _sw_chain(mu0, od, ssa, g, delta_all):
    if delta_all:
        od, ssa, g = delta_eddington(od, ssa, g)
    return ts.sw_reftrans(mu0, od, ssa, *ts.sw_gammas(mu0, ssa, g))


def sw_clear_total_reftrans_plain(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                                  band_from_g, od_scaling, frac_mask, mu0,
                                  delta_all):
    """od/ssa/g/od_scaling (ncol, nlev, ng); *_cloud (ncol, nlev, nb);
    frac_mask (ncol, nlev) bool; mu0 (ncol,) the cosine of the solar
    zenith angle. Returns 10 g-first (nlev, ng, ncol) tensors:
    (r_c, t_c, rd_c, tdd_c, tdir_c, r, t, rd, tdd, tdir)."""
    mu = torch.clamp(mu0, min=1e-10)[None, :]
    clear = _sw_chain(mu, _gf(od), _gf(ssa), _gf(g), delta_all)
    od_t, ssa_t, g_t = combine_cloud_gas_sw(
        od, ssa, g, od_cloud, ssa_cloud, g_cloud, band_from_g,
        od_scaling=od_scaling, cloud_mask=frac_mask[..., None])
    tot = _sw_chain(mu, _gf(od_t), _gf(ssa_t), _gf(g_t), delta_all)
    mg = frac_mask.T.contiguous()[:, None, :]
    return clear + tuple(torch.where(mg, x, c) for x, c in zip(tot, clear))


def lw_clear_total_noscat_plain(od, od_cloud, band_from_g, od_scaling,
                                frac_mask, planck_hl):
    """od/od_scaling (ncol, nlev, ng); od_cloud (ncol, nlev, nb)
    absorption only; planck_hl (ncol, nlev+1, ng); frac_mask (ncol, nlev)
    bool. Returns 6 g-first (nlev, ng, ncol): (t_c, su_c, sd_c, t, su,
    sd)."""
    pt, pb = _gf(planck_hl[:, :-1, :]), _gf(planck_hl[:, 1:, :])
    clear = ts.lw_no_scattering_transmittance(_gf(od), pt, pb)
    b = hooks.upload("mcica_optics", band_from_g, od.device)
    od_t = torch.where(frac_mask[..., None],
                       od + od_cloud[:, :, b] * od_scaling, od)
    tot = ts.lw_no_scattering_transmittance(_gf(od_t), pt, pb)
    mg = frac_mask.T.contiguous()[:, None, :]
    return clear + tuple(torch.where(mg, x, c) for x, c in zip(tot, clear))


@functools.lru_cache(maxsize=16)
def _band_index(band_bytes: bytes, device: str) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(band_bytes, np.int32).copy(),
                           device=device)


def _bands(band_from_g, device):
    return _band_index(np.asarray(band_from_g, np.int32).tobytes(),
                       str(device))


def mcica_sw_optics_fused(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                          band_from_g, od_scaling, frac_mask, mu0,
                          delta_all):
    """Kernel B4 (SW); arguments and results as
    sw_clear_total_reftrans_plain."""
    ncol, nlev, ng = od.shape
    nb = od_cloud.shape[-1]
    f32 = torch.float32
    for name, x in (("od", od), ("ssa", ssa), ("g", g),
                    ("od_scaling", od_scaling)):
        _cuda.check(x, f32, (ncol, nlev, ng), name)
    for name, x in (("od_cloud", od_cloud), ("ssa_cloud", ssa_cloud),
                    ("g_cloud", g_cloud)):
        _cuda.check(x, f32, (ncol, nlev, nb), name)
    _cuda.check(frac_mask, torch.bool, (ncol, nlev), "frac_mask")
    _cuda.check(mu0, f32, (ncol,), "mu0")
    if len(band_from_g) != ng:
        raise ValueError(f"band_from_g has {len(band_from_g)} entries for "
                         f"{ng} g-points")
    out = torch.empty((10, nlev, ng, ncol), dtype=f32, device=od.device)
    _cuda.launch("mcica_sw_optics", od, ssa, g, od_scaling, od_cloud,
                 ssa_cloud, g_cloud, frac_mask, mu0,
                 _bands(band_from_g, od.device), ncol, nlev, ng, nb,
                 int(bool(delta_all)), out)
    launches["mcica_sw_optics"] += 1
    return tuple(out)


def mcica_lw_optics_fused(od, od_cloud, band_from_g, od_scaling, frac_mask,
                          planck_hl):
    """Kernel B4 (LW, no scattering); arguments and results as
    lw_clear_total_noscat_plain."""
    ncol, nlev, ng = od.shape
    nb = od_cloud.shape[-1]
    f32 = torch.float32
    _cuda.check(od, f32, (ncol, nlev, ng), "od")
    _cuda.check(od_scaling, f32, (ncol, nlev, ng), "od_scaling")
    _cuda.check(od_cloud, f32, (ncol, nlev, nb), "od_cloud")
    _cuda.check(frac_mask, torch.bool, (ncol, nlev), "frac_mask")
    _cuda.check(planck_hl, f32, (ncol, nlev + 1, ng), "planck_hl")
    if len(band_from_g) != ng:
        raise ValueError(f"band_from_g has {len(band_from_g)} entries for "
                         f"{ng} g-points")
    out = torch.empty((6, nlev, ng, ncol), dtype=f32, device=od.device)
    _cuda.launch("mcica_lw_optics", od, od_scaling, od_cloud, frac_mask,
                 planck_hl, _bands(band_from_g, od.device), ncol, nlev, ng,
                 nb, out)
    launches["mcica_lw_optics"] += 1
    return tuple(out)


@hooks.hooked("ecrad.layer_optics")
def sw_clear_total_reftrans(*args):
    """The plain version on CPU tensors, kernel B4 on any other."""
    if args[0].device.type == "cpu":
        return sw_clear_total_reftrans_plain(*args)
    return mcica_sw_optics_fused(*args)


@hooks.hooked("ecrad.layer_optics")
def lw_clear_total_noscat(*args):
    """The plain version on CPU tensors, kernel B4 on any other."""
    if args[0].device.type == "cpu":
        return lw_clear_total_noscat_plain(*args)
    return mcica_lw_optics_fused(*args)
