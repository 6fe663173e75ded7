"""RRTMG-IFS gas optics: optical depth, Planck and solar source per g.

Port of ecrad_tpu/optics/rrtmg/gas_optics.py:72-207
(radiation_ifs_rrtm.F90: gas_optics :189, planck_function_atmos :570,
planck_function_surf :704): column densities, setcoef, the LW and SW
taumol (kernels B1 and B2 on a GPU), Planck sources from the TOTPLNK
table, the solar source normalised to the total solar irradiance, and
TOA-first outputs of shape (ncol, nlev, ng). The environment variable
ECRAD_FUSED_TAUMOL, read at call time with the JAX package's meaning
(ecrad_tpu/optics/rrtmg/taumol_lw.py:246-252), picks the taumol path:
"0" the per-band path (taumol_lw_sections, taumol_sw_sections: kernel
B10 on a GPU), anything else the all-band kernels B1 and B2. For
SPARTACUS the g-points of a spectral region are reordered by optical depth
(radiation_ifs_rrtm.F90:49-66; ecrad_tpu/optics/rrtmg/gas_optics.py:
28-47, 153-203): every per-g output comes in the reordered order, and
every band map downstream is `band_from_reordered_g_*`.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...constants import GAS_INDEX
from ...utils import hooks
from . import fused_tables
from .setcoef import prepare_gases, setcoef
from .taumol_common import DeviceTables, device_tables
from .taumol_lw import taumol_lw_cells
from .taumol_lw_sections import taumol_lw_sections
from .taumol_sw import taumol_sw_cells
from .taumol_sw_sections import taumol_sw_sections

FLUXFAC = np.pi * 1.0e4  # radiance -> flux (radiation_ifs_rrtm)

# Band bounds (cm-1), radiation_ifs_rrtm.F90:103-112
WAVENUM1_LW = np.array([10, 350, 500, 630, 700, 820, 980, 1080, 1180, 1390,
                        1480, 1800, 2080, 2250, 2380, 2600], dtype=float)
WAVENUM2_LW = np.array([350, 500, 630, 700, 820, 980, 1080, 1180, 1390,
                        1480, 1800, 2080, 2250, 2380, 2600, 3250],
                       dtype=float)
WAVENUM1_SW = np.array([2600, 3250, 4000, 4650, 5150, 6150, 7700, 8050,
                        12850, 16000, 22650, 29000, 38000, 820], dtype=float)
WAVENUM2_SW = np.array([3250, 4000, 4650, 5150, 6150, 7700, 8050, 12850,
                        16000, 22650, 29000, 38000, 50000, 2600],
                       dtype=float)


# SPARTACUS g-point reorderings by increasing optical depth
# (radiation_ifs_rrtm.F90:49-66), 0-based; a copy of
# ecrad_tpu/optics/rrtmg/gas_optics.py:30-47
RRTM_GPOINT_REORDERING_LW = np.array([
    89, 90, 139, 77, 137, 69, 131, 97, 91, 70, 78, 71, 53, 72, 123, 54, 79,
    98, 92, 55, 80, 132, 124, 81, 73, 56, 99, 82, 57, 23, 125, 100, 24, 74,
    93, 58, 25, 83, 126, 75, 26, 11, 101, 133, 59, 27, 76, 140, 12, 84, 102,
    94, 28, 127, 85, 13, 39, 60, 86, 103, 87, 109, 14, 29, 115, 40, 95, 15,
    61, 88, 41, 110, 104, 1, 116, 42, 30, 134, 128, 138, 96, 62, 16, 43,
    117, 63, 111, 44, 2, 64, 31, 65, 105, 17, 45, 66, 118, 32, 3, 33, 67,
    18, 129, 135, 46, 112, 34, 106, 68, 35, 4, 119, 36, 47, 107, 19, 37, 38,
    113, 48, 130, 5, 120, 49, 108, 20, 50, 51, 114, 21, 121, 52, 136, 122,
    6, 22, 7, 8, 9, 10]) - 1
RRTM_GPOINT_REORDERING_SW = np.array([
    35, 45, 19, 27, 36, 57, 20, 46, 58, 21, 28, 67, 55, 68, 37, 1, 69, 22,
    29, 59, 78, 101, 79, 77, 70, 76, 47, 75, 30, 81, 60, 102, 80, 82, 23, 2,
    83, 84, 85, 86, 103, 61, 31, 87, 56, 38, 71, 48, 88, 3, 62, 89, 24, 7,
    49, 32, 104, 72, 90, 63, 39, 4, 8, 50, 91, 64, 40, 33, 25, 51, 95, 96,
    73, 65, 9, 41, 97, 92, 105, 52, 5, 98, 10, 42, 99, 100, 66, 11, 74, 34,
    53, 26, 6, 106, 12, 43, 13, 54, 93, 44, 107, 94, 14, 108, 15, 16, 109,
    17, 18, 110, 111, 112]) - 1


class GasOpticsSpec(NamedTuple):
    """Static spectral mapping. g_from_reordered_g_* is the identity
    unless the region's solver is SPARTACUS."""
    band_from_g_lw: np.ndarray        # (140,) 0-based LW band per g
    band_from_g_sw: np.ndarray        # (112,) 0-based SW band per g
    g_from_reordered_g_lw: np.ndarray
    g_from_reordered_g_sw: np.ndarray
    band_from_reordered_g_lw: np.ndarray
    band_from_reordered_g_sw: np.ndarray


def make_spec(tables: dict, reorder_lw: bool = False,
              reorder_sw: bool = False) -> GasOpticsSpec:
    """The spectral mapping, with the SPARTACUS g-point order in a region
    where reorder_* is set (ecrad_tpu/optics/rrtmg/gas_optics.py:72-86)."""
    return spec_from_arrays(
        np.asarray(tables["lw_band_from_g"]).astype(int) - 1,
        np.asarray(tables["sw_band_from_g"]).astype(int) - 1,
        RRTM_GPOINT_REORDERING_LW if reorder_lw else None,
        RRTM_GPOINT_REORDERING_SW if reorder_sw else None)


def spec_from_arrays(band_lw, band_sw, g_lw=None, g_sw=None
                     ) -> GasOpticsSpec:
    """GasOpticsSpec from the band maps and the g orders (None: the
    identity)."""
    band_lw = np.asarray(band_lw).astype(int)
    band_sw = np.asarray(band_sw).astype(int)
    g_lw = np.arange(len(band_lw)) if g_lw is None else np.asarray(g_lw)
    g_sw = np.arange(len(band_sw)) if g_sw is None else np.asarray(g_sw)
    return GasOpticsSpec(band_from_g_lw=band_lw, band_from_g_sw=band_sw,
                         g_from_reordered_g_lw=g_lw,
                         g_from_reordered_g_sw=g_sw,
                         band_from_reordered_g_lw=band_lw[g_lw],
                         band_from_reordered_g_sw=band_sw[g_sw])


class GasTables(NamedTuple):
    """Everything gas optics reads, on one device in one dtype."""
    t: dict                      # the npz tables (numpy)
    lw: DeviceTables             # flat tables of kernel B1
    sw: DeviceTables             # flat tables of kernel B2
    totplnk: torch.Tensor        # (181, 16)
    delwave: torch.Tensor        # (16,)


def gas_tables(t: dict, dtype, device) -> GasTables:
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                     device=device)
    return GasTables(
        t=t,
        lw=device_tables(fused_tables.build_lw(t), dtype, device),
        sw=device_tables(fused_tables.build_sw(t), dtype, device),
        totplnk=as_t(t["totplnk"]), delwave=as_t(t["delwave"]))


def planck_store(temperature, totplnk, delwave):
    """Band-integrated Planck flux, (...,) -> (..., 16)
    (radiation_ifs_rrtm.F90:570-699, TOTPLNK interpolation)."""
    t = temperature
    inside = (t < 339.0) & (t >= 160.0)
    hot = t >= 339.0
    ind = torch.where(inside, torch.floor(t - 159.0).to(torch.int64),
                      torch.where(hot, 180, 1))
    frac = torch.where(inside, t - torch.floor(t),
                       torch.where(hot, t - 339.0, torch.zeros_like(t)))
    tp0 = totplnk[ind - 1]
    tp1 = totplnk[ind]
    return FLUXFAC * delwave * (tp0 + frac[..., None] * (tp1 - tp0))


class GasOptics(NamedTuple):
    """Per-g optical properties, (ncol, nlev, ng), TOA-first levels."""
    od_lw: torch.Tensor
    od_sw: torch.Tensor
    ssa_sw: torch.Tensor
    planck_hl: torch.Tensor      # (ncol, nlev+1, 140)
    lw_emission: torch.Tensor    # (ncol, 140)
    incoming_sw: torch.Tensor    # (ncol, 112)


def gas_optics(pressure_hl, temperature_hl, gas_mmr, skin_temperature,
               cos_sza, solar_irradiance, spec: GasOpticsSpec,
               tables: GasTables, lw_albedo: Optional[torch.Tensor] = None,
               min_gas_od_lw: float = 1.0e-15,
               min_gas_od_sw: float = 0.0,
               spectral_solar_scaling: Optional[torch.Tensor] = None
               ) -> GasOptics:
    """pressure_hl/temperature_hl (ncol, nlev+1) TOA first; gas_mmr
    (ncol, nlev, NUM_GASES); lw_albedo (ncol, 140), in the spec's g order,
    for the surface emission (1 - albedo) x Planck; spectral_solar_scaling
    (14,) a factor per SW band on the solar source before its
    normalisation (ecrad_tpu/optics/rrtmg/gas_optics.py:195-196). All in
    the tables' dtype."""
    t = tables.t
    nlev = pressure_hl.shape[1] - 1
    dev = pressure_hl.device
    p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])

    def g(name):
        return gas_mmr[:, :, GAS_INDEX[name]]

    def reorder(x, order):
        """x (..., ng) in the spec's g order (no copy for the identity)."""
        if np.array_equal(order, np.arange(len(order))):
            return x
        return x[..., hooks.upload("gas_optics", order, dev)]

    gc = prepare_gases(pressure_hl, p_fl, t_fl,
                       g("h2o"), g("co2"), g("ch4"), g("n2o"),
                       g("cfc11"), g("cfc12"), g("hcfc22"), g("ccl4"),
                       g("o3"), dtype=pressure_hl.dtype)
    c = setcoef(gc, t["preflog"], t["tref"], t["chi_mls"])
    per_band = os.environ.get("ECRAD_FUSED_TAUMOL", "1") == "0"

    # ---- LW ----
    od_lw, pfrac = (taumol_lw_sections(c, t, toa_first=True) if per_band
                    else taumol_lw_cells(c, t["chi_mls"], tables.lw))
    od_lw = reorder(torch.clamp(od_lw, min=min_gas_od_lw),
                    spec.g_from_reordered_g_lw)
    pfrac = reorder(pfrac, spec.g_from_reordered_g_lw)
    band_lw = hooks.upload("gas_optics", spec.band_from_reordered_g_lw,
                           dev)
    # half level i uses the Planck fraction of TOA-first layer
    # min(i, nlev-1): layers [0, 0, 1, ..., nlev-1]
    lay_idx = hooks.upload("gas_optics",
                           np.concatenate([[0], np.arange(nlev)]), dev)
    planck_bands = planck_store(temperature_hl, tables.totplnk,
                                tables.delwave)         # (ncol, nlev+1, 16)
    planck_hl = planck_bands[:, :, band_lw] * pfrac[:, lay_idx, :]
    planck_surf = (planck_store(skin_temperature, tables.totplnk,
                                tables.delwave)[:, band_lw]
                   * pfrac[:, -1, :])
    lw_emission = (planck_surf if lw_albedo is None
                   else planck_surf * (1.0 - lw_albedo))

    # ---- SW ----
    taug, taur, sflux = (taumol_sw_sections(c, t, toa_first=True)
                         if per_band else taumol_sw_cells(c, t, tables.sw))
    od_sw = taug + taur
    ssa_sw = torch.clamp(taur / torch.clamp(od_sw, min=1e-30), 0.0, 1.0)
    od_sw = torch.clamp(od_sw, min=min_gas_od_sw)
    if spectral_solar_scaling is not None:
        # sflux is in the original g order on both taumol paths: the
        # un-reordered band map, before the reordering below
        sflux = sflux * spectral_solar_scaling.to(sflux)[
            hooks.upload("gas_optics", spec.band_from_g_sw, dev)]
    # normalise to the solar irradiance (radiation_ifs_rrtm.F90:519-526)
    total = sflux.sum(-1)
    scale = torch.where(cos_sza > 0.0,
                        solar_irradiance / torch.clamp(total, min=1e-10),
                        torch.ones_like(total))
    g_sw = spec.g_from_reordered_g_sw
    return GasOptics(od_lw=od_lw, od_sw=reorder(od_sw, g_sw),
                     ssa_sw=reorder(ssa_sw, g_sw), planck_hl=planck_hl,
                     lw_emission=lw_emission,
                     incoming_sw=reorder(scale[:, None] * sflux, g_sw))
