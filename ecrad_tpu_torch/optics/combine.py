"""Combine band-resolved cloud optical properties with per-g gas ones.

Port of ecrad_tpu/optics/combine.py:16-70 (radiation_mcica_sw.F90:
220-274). Cloud arrays are (ncol, nlev, nbands), gas arrays (ncol, nlev,
ng); band_from_g maps each g-point to its band. od_scaling, when given,
scales the cloud optical depth per (ncol, nlev, ng) (the McICA subcolumn
scaling); cloud_mask (broadcasting against od) keeps the gas values where
it is false.
"""
from __future__ import annotations

import torch

from ..utils import hooks


def _mix(od, ssa, g, odc, ssac, gc, cloud_mask):
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    od_total = od + odc
    scat_gas = ssa * od
    scat_cld = ssac * odc
    scat_od = scat_gas + scat_cld
    ssa_total = torch.where(od_total > 0.0,
                            scat_od / torch.clamp(od_total, min=1e-30), zero)
    g_total = torch.where(scat_od > 0.0,
                          (g * scat_gas + gc * scat_cld)
                          / torch.clamp(scat_od, min=1e-30), zero)
    if cloud_mask is not None:
        od_total = torch.where(cloud_mask, od_total, od)
        ssa_total = torch.where(cloud_mask, ssa_total, ssa)
        g_total = torch.where(cloud_mask, g_total, g)
    return od_total, ssa_total, g_total


def combine_cloud_gas_sw(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                         band_from_g, od_scaling=None, cloud_mask=None):
    """Returns (od_total, ssa_total, g_total), (ncol, nlev, ng)."""
    b = hooks.upload("combine", band_from_g, od.device)
    odc = od_cloud[:, :, b]
    if od_scaling is not None:
        odc = odc * od_scaling
    return _mix(od, ssa, g, odc, ssa_cloud[:, :, b], g_cloud[:, :, b],
                cloud_mask)


def combine_cloud_gas_lw(od, ssa, g, od_cloud, ssa_cloud, g_cloud,
                         band_from_g, do_lw_cloud_scattering,
                         od_scaling=None, cloud_mask=None):
    """With cloud scattering the SW mix; without, the cloud od is already
    absorption-only and ssa/g are zero (radiation_mcica_lw.F90)."""
    if do_lw_cloud_scattering:
        return combine_cloud_gas_sw(od, ssa, g, od_cloud, ssa_cloud,
                                    g_cloud, band_from_g, od_scaling,
                                    cloud_mask)
    odc = od_cloud[:, :, hooks.upload("combine", band_from_g, od.device)]
    if od_scaling is not None:
        odc = odc * od_scaling
    od_total = od + odc
    if cloud_mask is not None:
        od_total = torch.where(cloud_mask, od_total, od)
    return od_total, torch.zeros_like(od_total), torch.zeros_like(od_total)
