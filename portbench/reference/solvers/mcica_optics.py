"""The McICA clear- and total-sky layer optics in one pass: the plain
PyTorch versions of kernel B4, copied from ecrad_tpu_torch/ops/
mcica_optics.py. For every (column, level, g) they expand the cloud's
band properties to g, scale the cloud optical depth by the subcolumn's
od_scaling, combine cloud and gas, and compute the clear-sky and the
total-sky layer properties, the total family taking the clear values
where the layer is not cloudy. Outputs are g-first, (nlev, ng, ncol).
"""
from __future__ import annotations

import torch

from ..optics.cloud import delta_eddington
from ..optics.combine import combine_cloud_gas_sw
from . import two_stream as ts

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
    b = torch.as_tensor(band_from_g, device=od.device)
    od_t = torch.where(frac_mask[..., None],
                       od + od_cloud[:, :, b] * od_scaling, od)
    tot = ts.lw_no_scattering_transmittance(_gf(od_t), pt, pb)
    mg = frac_mask.T.contiguous()[:, None, :]
    return clear + tuple(torch.where(mg, x, c) for x, c in zip(tot, clear))


sw_clear_total_reftrans = sw_clear_total_reftrans_plain
lw_clear_total_noscat = lw_clear_total_noscat_plain
