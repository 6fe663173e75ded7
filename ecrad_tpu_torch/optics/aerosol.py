"""Aerosol optical properties merged into the per-g gas arrays.

Port of ecrad_tpu/optics/aerosol.py:26-229 (radiation_aerosol_optics.F90:
75-344): each configured aerosol type maps to a hydrophobic (positive
index) or hydrophilic (negative index, looked up by relative-humidity bin)
entry of the LUT, or to nothing (0). Band properties are summed over the
types, delta-Eddington scaled (extensive form) and merged into the per-g
optical depth, single-scattering albedo and asymmetry factor; the LW
either scatters or keeps only the absorption (the co-albedo form).

The JAX package sums over the types with one masked matrix product per
humidity bin (an MXU form). Here each cell gathers its humidity bin's row
of every type and the types are summed in order, as elementwise products:
no matrix product, so TF32 cannot reach these sums whatever a caller set
(a bf16 product here was a 1.2 W/m2 clear-sky SW error on the TPU). On
the card kernel B12 (csrc/aerosol_optics.cu) does the whole LUT path in
one launch, in the plain version's operation order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..config import RadiationConfig
from ..constants import ACCEL_DUE_TO_GRAVITY, GAS_INDEX
from ..io.netcdf import NetcdfFile
from ..ops import aerosol_optics
from .cloud import delta_eddington_extensive


@dataclass
class AerosolOpticsTables:
    """Per-configured-type LUT rows gathered at setup, numpy (ntype, nrh,
    nbands); a hydrophobic type's one row is repeated over the humidity
    bins, an inactive type (map entry 0) has zero extinction."""
    mass_ext_sw: np.ndarray
    ssa_sw: np.ndarray
    g_sw: np.ndarray
    mass_ext_lw: np.ndarray
    ssa_lw: np.ndarray
    g_lw: np.ndarray
    rh_lower: np.ndarray      # (nrh,) lower bound of each humidity bin
    is_active: np.ndarray     # (ntype,) bool


def setup_aerosol_optics(config: RadiationConfig) -> AerosolOpticsTables:
    """Read the aerosol LUT named by the config and gather the rows of
    its type map (radiation_aerosol_optics_data.F90)."""
    with NetcdfFile(config.aerosol_optics_file) as f:
        phob = {k: f.read(f"{v}_hydrophobic") for k, v in _VARIABLES.items()}
        phil = {k: f.read(f"{v}_hydrophilic") for k, v in _VARIABLES.items()}
        rh_lower = f.read("relative_humidity1")
    nrh = phil["mass_ext_sw"].shape[1]
    type_map = config.i_aerosol_type_map[:config.n_aerosol_types]
    active = np.array([i != 0 for i in type_map], bool)

    def gather(name):
        rows = []
        for i in type_map:
            if i > 0:
                rows.append(np.repeat(phob[name][i - 1][None, :], nrh, 0))
            elif i < 0:
                rows.append(phil[name][-i - 1])
            else:
                rows.append(np.zeros_like(phil[name][0]))
        return np.stack(rows)

    tabs = {k: gather(k) for k in _VARIABLES}
    tabs["mass_ext_sw"][~active] = 0.0
    tabs["mass_ext_lw"][~active] = 0.0
    return AerosolOpticsTables(**tabs, rh_lower=rh_lower, is_active=active)


#: table field -> the LUT's variable name without its _hydrophobic or
#: _hydrophilic suffix
_VARIABLES = {"mass_ext_sw": "mass_ext_sw", "ssa_sw": "ssa_sw",
              "g_sw": "asymmetry_sw", "mass_ext_lw": "mass_ext_lw",
              "ssa_lw": "ssa_lw", "g_lw": "asymmetry_lw"}


def aerosol_tensors(tables: AerosolOpticsTables, dtype, device
                    ) -> Dict[str, torch.Tensor]:
    """The per-type rows the runtime sums, at the compute dtype on the
    device, each (ntype, nrh, 3 nb): [extinction | scattering |
    scattering x g] for SW and LW, and the LW absorption
    extinction x (1 - ssa) (ntype, nrh, nb). Every factor is cast to
    `dtype` before it is multiplied, as the JAX package does."""
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    out = {"rh_lower": t(tables.rh_lower)}
    for s in ("sw", "lw"):
        me = t(getattr(tables, f"mass_ext_{s}"))
        scat = me * t(getattr(tables, f"ssa_{s}"))
        out[s] = torch.cat([me, scat, scat * t(getattr(tables, f"g_{s}"))],
                           -1)
    out["lw_absorption"] = (t(tables.mass_ext_lw)
                            * (1.0 - t(tables.ssa_lw)))
    return out


def _type_sum(tab, irh, mass):
    """sum_t mass[..., t] tab[t, irh] -> (ncol, nlev, tab.shape[-1]): one
    row gather per type, the types added in order."""
    out = None
    for t in range(tab.shape[0]):
        term = mass[..., t, None] * tab[t][irh]
        out = term if out is None else out + term
    return out


def add_aerosol_optics(config: RadiationConfig, tabs: Dict[str, torch.Tensor],
                       band_from_g_sw, band_from_g_lw, thermodynamics, gas,
                       aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw):
    """Merge the aerosols into the per-g properties, each (ncol, nlev, ng)
    (radiation_aerosol_optics.F90:75-344). `tabs` is aerosol_tensors of
    the setup, the band maps int tensors on the device (int32 on the
    card: SpecTensors.band_sw32, band_lw32). Returns (od_lw, ssa_lw, g_lw,
    od_sw, ssa_sw, g_sw). On the CPU, and for optics given per band, the
    plain version; on the card the LUT path is kernel B12
    (ops/aerosol_optics.py), which raises on what it does not take."""
    if aerosol.od_sw is None and od_sw.device.type != "cpu":
        return aerosol_optics.aerosol_optics_fused(
            config, tabs, band_from_g_sw, band_from_g_lw, thermodynamics,
            gas, aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw)
    return add_aerosol_optics_plain(
        config, tabs, band_from_g_sw, band_from_g_lw, thermodynamics, gas,
        aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw)


def add_aerosol_optics_plain(config: RadiationConfig,
                             tabs: Dict[str, torch.Tensor], band_from_g_sw,
                             band_from_g_lw, thermodynamics, gas, aerosol,
                             od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw):
    """add_aerosol_optics in PyTorch operations, on any device: the
    saturation, humidity bin and layer mass, the type sums (_type_sum),
    delta-Eddington and the merge into the per-g arrays, as kernel B12
    computes them."""
    dev = od_sw.device
    b_sw, b_lw = band_from_g_sw, band_from_g_lw
    if aerosol.od_sw is not None:
        return _add_direct(aerosol, b_sw, b_lw, od_lw, ssa_lw, g_lw, od_sw,
                           ssa_sw)
    zero = torch.zeros((), dtype=od_sw.dtype, device=dev)
    if thermodynamics.h2o_sat_liq is None:
        thermodynamics = thermodynamics.calc_saturation_wrt_liquid()
    rh = gas.mixing_ratio[:, :, GAS_INDEX["h2o"]] / torch.clamp(
        thermodynamics.h2o_sat_liq, min=1e-12)
    irh = (rh[..., None] > tabs["rh_lower"][1:]).sum(-1)
    phl = thermodynamics.pressure_hl
    factor = (phl[:, 1:] - phl[:, :-1]) / ACCEL_DUE_TO_GRAVITY
    mmr = aerosol.mixing_ratio
    # as many types as the map configures: the reference zero-fills the
    # absent ones
    ntab = tabs["sw"].shape[0]
    if mmr.shape[-1] < ntab:
        mmr = torch.cat([mmr, mmr.new_zeros(mmr.shape[:-1]
                                            + (ntab - mmr.shape[-1],))], -1)
    mass = factor[..., None] * mmr[..., :ntab]

    nb = tabs["sw"].shape[-1] // 3
    sums = _type_sum(tabs["sw"], irh, mass)
    od_a, scat_a, scatg_a = sums[..., :nb], sums[..., nb:2 * nb], \
        sums[..., 2 * nb:]
    if not config.do_sw_delta_scaling_with_gases:
        od_a, scat_a, scatg_a = delta_eddington_extensive(od_a, scat_a,
                                                          scatg_a)
    has_aer = od_a[:, :, :1] > 0.0
    od_g, scat_g, scatg_g = od_a[:, :, b_sw], scat_a[:, :, b_sw], \
        scatg_a[:, :, b_sw]
    local_od = od_sw + od_g
    local_scat = ssa_sw * od_sw + scat_g
    g_new = torch.where(local_scat > 0.0,
                        scatg_g / torch.clamp(local_scat, min=1e-30), zero)
    ssa_new = torch.where(local_od > 0.0,
                          local_scat / torch.clamp(local_od, min=1e-30), zero)
    od_sw_out = torch.where(has_aer, local_od, od_sw)
    ssa_sw_out = torch.where(has_aer, ssa_new, ssa_sw)
    g_sw_out = torch.where(has_aer, g_new, g_sw)

    if config.do_lw_aerosol_scattering:
        nb = tabs["lw"].shape[-1] // 3
        sums = _type_sum(tabs["lw"], irh, mass)
        od_a, scat_a, scatg_a = delta_eddington_extensive(
            sums[..., :nb], sums[..., nb:2 * nb], sums[..., 2 * nb:])
        od_g, scat_g, scatg_g = od_a[:, :, b_lw], scat_a[:, :, b_lw], \
            scatg_a[:, :, b_lw]
        has = od_g > 0.0
        g_new = torch.where(scat_g > 0.0,
                            scatg_g / torch.clamp(scat_g, min=1e-30), zero)
        local_od = od_lw + od_g
        ssa_new = scat_g / torch.clamp(local_od, min=1e-30)
        od_lw_out = torch.where(has, local_od, od_lw)
        ssa_lw_out = torch.where(has, ssa_new, ssa_lw)
        g_lw_out = torch.where(has, g_new, g_lw)
    else:
        # absorption only: the co-albedo form (:236-243)
        od_a = _type_sum(tabs["lw_absorption"], irh, mass)
        od_lw_out = od_lw + od_a[:, :, b_lw]
        ssa_lw_out, g_lw_out = ssa_lw, g_lw
    return od_lw_out, ssa_lw_out, g_lw_out, od_sw_out, ssa_sw_out, g_sw_out


def _add_direct(aerosol, b_sw, b_lw, od_lw, ssa_lw, g_lw, od_sw, ssa_sw):
    """Per-band optical properties given directly
    (radiation_aerosol_optics.F90:350+; ecrad_tpu/optics/aerosol.py:
    208-229)."""
    zero = torch.zeros((), dtype=od_sw.dtype, device=od_sw.device)
    od_aer = aerosol.od_sw[:, :, b_sw]
    scat_aer = (aerosol.ssa_sw * aerosol.od_sw)[:, :, b_sw]
    scatg_aer = (aerosol.g_sw * aerosol.ssa_sw * aerosol.od_sw)[:, :, b_sw]
    local_od = od_sw + od_aer
    local_scat = ssa_sw * od_sw + scat_aer
    g_new = torch.where(local_scat > 0.0,
                        scatg_aer / torch.clamp(local_scat, min=1e-30), zero)
    ssa_new = torch.where(local_od > 0.0,
                          local_scat / torch.clamp(local_od, min=1e-30), zero)
    od_lw_new = od_lw
    if aerosol.od_lw is not None:
        abs_lw = (aerosol.od_lw * (1.0 - aerosol.ssa_lw)
                  if aerosol.ssa_lw is not None else aerosol.od_lw)
        od_lw_new = od_lw + abs_lw[:, :, b_lw]
    return od_lw_new, ssa_lw, g_lw, local_od, ssa_new, g_new
