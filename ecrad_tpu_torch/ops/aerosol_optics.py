"""Kernel B12: the aerosol optics merged into the per-g gas optics in one
pass (csrc/aerosol_optics.cu), float32 and float64.

For every (column, level) it computes the humidity bin (the saturation
where the thermodynamics carry none) and the layer mass, sums the setup's
LUT rows over the types in order, delta-Eddington scales the band sums,
and merges them into the per-g optical depth, single-scattering albedo and
asymmetry factor of both spectra (optics/aerosol.py
add_aerosol_optics_plain, which the CPU takes). `aerosol_optics_fused`
takes add_aerosol_optics_plain's arguments, CUDA tensors of one float
dtype and the int32 band maps (SpecTensors.band_sw32, band_lw32), and
returns fresh (ncol, nlev, ng) outputs; where the LW does not scatter it
adds the absorption alone and hands ssa_lw and g_lw back unchanged, as the
plain version does.
"""
from __future__ import annotations

import torch

from ..constants import GAS_INDEX
from . import _cuda

#: launches of the CUDA kernel (incremented only where it is launched)
launches = {"aerosol_optics": 0}


def aerosol_optics_fused(config, tabs, band_from_g_sw, band_from_g_lw,
                         thermodynamics, gas, aerosol, od_lw, ssa_lw, g_lw,
                         od_sw, ssa_sw, g_sw):
    """Kernel B12; arguments and results as
    optics/aerosol.py add_aerosol_optics_plain (the LUT path: aerosol
    given as mixing ratios)."""
    dt = _cuda.scalar(od_sw, "od_sw")
    _cuda.check(od_sw, dt, None, "od_sw")
    if od_sw.dim() != 3 or od_lw.dim() != 3:
        raise ValueError("the per-g arrays are (ncol, nlev, ng) tensors")
    ncol, nlev, ng_sw = od_sw.shape
    ng_lw = od_lw.shape[-1]
    lw_scat = bool(config.do_lw_aerosol_scattering)
    tab_sw = tabs["sw"]
    tab_lw = tabs["lw"] if lw_scat else tabs["lw_absorption"]
    ntab, nrh, nb_sw = tab_sw.shape[0], tab_sw.shape[1], \
        tab_sw.shape[2] // 3
    nb_lw = tab_lw.shape[2] // (3 if lw_scat else 1)
    mixing_ratio, mmr = gas.mixing_ratio, aerosol.mixing_ratio
    sat = thermodynamics.h2o_sat_liq
    if mixing_ratio.dim() != 3 or mmr.dim() != 3:
        raise ValueError("the mixing ratios are (ncol, nlev, n) tensors")
    half = (ncol, nlev + 1)
    for name, x, shape in (
            ("ssa_sw", ssa_sw, od_sw.shape), ("g_sw", g_sw, od_sw.shape),
            ("od_lw", od_lw, (ncol, nlev, ng_lw)),
            ("ssa_lw", ssa_lw, od_lw.shape), ("g_lw", g_lw, od_lw.shape),
            ("pressure_hl", thermodynamics.pressure_hl, half),
            ("temperature_hl", thermodynamics.temperature_hl, half),
            ("h2o_sat_liq", sat, (ncol, nlev)),
            ("gas mixing_ratio", mixing_ratio,
             (ncol, nlev, mixing_ratio.shape[2])),
            ("aerosol mixing_ratio", mmr, (ncol, nlev, mmr.shape[2])),
            ("rh_lower", tabs["rh_lower"], (nrh,)),
            ("tabs sw", tab_sw, None), ("tabs lw", tab_lw,
                                        (ntab, nrh, tab_lw.shape[2]))):
        if x is not None:
            _cuda.check(x, dt, shape, name)
    _cuda.check(band_from_g_sw, torch.int32, (ng_sw,), "band_from_g_sw")
    _cuda.check(band_from_g_lw, torch.int32, (ng_lw,), "band_from_g_lw")
    out_sw = [torch.empty_like(od_sw) for _ in range(3)]
    out_lw = [torch.empty_like(od_lw) if lw_scat or i == 0 else None
              for i in range(3)]
    _cuda.launch("aerosol_optics", mixing_ratio, thermodynamics.pressure_hl,
                 thermodynamics.temperature_hl, sat, mmr, tabs["rh_lower"],
                 tab_sw, tab_lw, band_from_g_sw, band_from_g_lw, od_sw,
                 ssa_sw, g_sw, od_lw, ssa_lw, g_lw, *out_sw, *out_lw, ncol,
                 nlev, mixing_ratio.shape[2], GAS_INDEX["h2o"], mmr.shape[2],
                 ntab, nrh, nb_sw, nb_lw, ng_sw, ng_lw,
                 int(not config.do_sw_delta_scaling_with_gases),
                 int(lw_scat), dtype=dt)
    launches["aerosol_optics"] += 1
    if not lw_scat:
        out_lw[1:] = [ssa_lw, g_lw]
    return (*out_lw, *out_sw)
