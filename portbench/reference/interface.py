"""The plain reference of one radiation call, McICA, Tripleclouds or
SPARTACUS.

Copied from ecrad_tpu_torch/interface.py and trimmed to these three
paths: gas optics (in the SPARTACUS g order where that solver runs), the
aerosol stage, the cloud stage (default fractional_std, overlap
parameter from a 2 km decorrelation length, cropping, cloud optics), the
solvers and the flux assembly (broadband profiles, surface band and
g-point fluxes). Every stage is plain PyTorch; nothing of the
port is imported, and every table is worked out again from the files the
benchmark wrote.

The fluxes are computed in `dtype` (float64 for the benchmark's
comparison). McICA's cloud generator alone runs in the configuration's
own dtype (`gen_dtype`), in which its draws and its cumulative cloud
cover are defined, so that the reference's subcolumns are the
configuration's; its optical-depth scalings then enter the float64
passes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import RadiationConfig, Solver
from .optics.aerosol import (add_aerosol_optics, aerosol_tensors,
                             setup_aerosol_optics)
from .optics.cloud import (CloudOpticsTables, cloud_optics,
                           coefficient_tensors, setup_cloud_optics)
from .optics.rrtmg.gas_optics import (WAVENUM1_LW, WAVENUM1_SW, WAVENUM2_LW,
                                      WAVENUM2_SW, GasOpticsSpec, GasTables,
                                      gas_optics, gas_tables, make_spec)
from .optics.rrtmg.tables import DEFAULT_PATH, load_tables
from .optics.spectral_mapping import expand_to_g, interval_mapping
from .solvers.mcica import solver_mcica_lw, solver_mcica_sw
from .solvers.pdf_sampler import PdfSampler, setup_pdf_sampler
from .solvers.spartacus_lw import solver_spartacus_lw
from .solvers.spartacus_sw import solver_spartacus_sw
from .solvers.tripleclouds import (solver_tripleclouds_lw,
                                   solver_tripleclouds_sw)
from .types import Aerosol, Cloud, Flux, GasConcs, SingleLevel, Thermodynamics

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the cloud's inverse effective sizes (m-1), (ncol, nlev): SPARTACUS's
#: 3D terms read them
EFFECTIVE_SIZE_KEYS = ("inv_cloud_effective_size", "inv_inhom_effective_size")


@dataclass
class Setup:
    config: RadiationConfig
    spec: GasOpticsSpec
    sw_albedo_map: Optional[np.ndarray]
    sw_albedo_weights: Optional[np.ndarray]
    lw_emiss_map: Optional[np.ndarray]
    lw_emiss_weights: Optional[np.ndarray]
    device: torch.device
    dtype: torch.dtype
    gen_dtype: torch.dtype
    gas: GasTables
    cloud_optics: CloudOpticsTables
    cloud_coeffs: dict
    pdf_sampler: Optional[PdfSampler]
    pdf_cheb: Optional[torch.Tensor]
    aerosol_coeffs: Optional[dict]


def setup(config: RadiationConfig, device, dtype=torch.float64,
          tables_path: str = DEFAULT_PATH) -> Setup:
    """Tables, spectral mappings and lookup tables for `config`, read
    from the files and worked out again here."""
    tables = load_tables(tables_path)
    sw_map, sw_weights = interval_mapping(
        config.sw_albedo_wavelength_bound, config.i_sw_albedo_index,
        WAVENUM1_SW, WAVENUM2_SW, config.do_nearest_spectral_sw_albedo)
    lw_map, lw_weights = interval_mapping(
        config.lw_emiss_wavelength_bound, config.i_lw_emiss_index,
        WAVENUM1_LW, WAVENUM2_LW, config.do_nearest_spectral_lw_emiss)
    mcica = Solver.MCICA in (config.i_solver_sw, config.i_solver_lw)
    pdf = setup_pdf_sampler(config) if mcica else None
    cloud = setup_cloud_optics(config)
    aerosol = setup_aerosol_optics(config) if config.use_aerosols else None
    # SPARTACUS orders the g-points of its regions by optical depth
    spec = make_spec(tables,
                     reorder_lw=config.i_solver_lw == Solver.SPARTACUS,
                     reorder_sw=config.i_solver_sw == Solver.SPARTACUS)
    return Setup(
        config=config, spec=spec, sw_albedo_map=sw_map,
        sw_albedo_weights=sw_weights, lw_emiss_map=lw_map,
        lw_emiss_weights=lw_weights, device=torch.device(device),
        dtype=dtype, gen_dtype=DTYPES[config.dtype],
        gas=gas_tables(tables, dtype, device), cloud_optics=cloud,
        cloud_coeffs=coefficient_tensors(cloud, device), pdf_sampler=pdf,
        pdf_cheb=(None if pdf is None
                  else torch.as_tensor(pdf.cheb, device=device)),
        aerosol_coeffs=(None if aerosol is None
                        else aerosol_tensors(aerosol, dtype, device)))


def columns_to_inputs(cols: dict, device):
    """(single_level, thermodynamics, gas, cloud, aerosol) of the
    reference from the benchmark's numpy columns, at their own precision
    (the caller casts); the cloud's inverse effective sizes where the
    columns hold them."""
    t = lambda k: torch.as_tensor(cols[k], device=device)
    single = SingleLevel(
        cos_sza=t("cos_sza"), skin_temperature=t("skin_temperature"),
        sw_albedo=t("sw_albedo"), lw_emissivity=t("lw_emissivity"),
        solar_irradiance=float(cols["solar_irradiance"]),
        iseed=torch.as_tensor(cols["iseed"], dtype=torch.int64,
                              device=device))
    thermo = Thermodynamics(pressure_hl=t("pressure_hl"),
                            temperature_hl=t("temperature_hl"))
    cloud = Cloud(q_liq=t("q_liq"), q_ice=t("q_ice"), re_liq=t("re_liq"),
                  re_ice=t("re_ice"), fraction=t("fraction"),
                  fractional_std=t("fractional_std"),
                  **{k: t(k) for k in EFFECTIVE_SIZE_KEYS if k in cols})
    aerosol = (Aerosol(mixing_ratio=t("aerosol_mmr"))
               if "aerosol_mmr" in cols else None)
    return single, thermo, GasConcs(mixing_ratio=t("mixing_ratio")), \
        cloud, aerosol


def get_albedos(setup: Setup, single_level: SingleLevel):
    """Per-g surface albedos (radiation_single_level.F90:204-330):
    (sw_albedo_diffuse, sw_albedo_direct, lw_albedo), each (ncol, ng)."""
    sw = expand_to_g(single_level.sw_albedo, setup.sw_albedo_map,
                     setup.sw_albedo_weights,
                     setup.spec.band_from_reordered_g_sw)
    emissivity = expand_to_g(single_level.lw_emissivity, setup.lw_emiss_map,
                             setup.lw_emiss_weights,
                             setup.spec.band_from_reordered_g_lw)
    return sw, sw, 1.0 - emissivity


def _indexed_sum(x, group_of, ngroups, dim):
    """x summed over its axis `dim` in groups, member k going to group
    group_of[k]."""
    group_of = np.asarray(group_of)
    members = [np.flatnonzero(group_of == b) for b in range(ngroups)]
    n = x.shape[dim]
    width = max(len(m) for m in members)
    idx = np.full((ngroups, width), n)
    for b, m in enumerate(members):
        idx[b, :len(m)] = m
    idx = torch.as_tensor(idx, device=x.device)
    pad = list(x.shape)
    pad[dim] = 1
    padded = torch.cat([x, x.new_zeros(pad)], dim)
    return padded.index_select(dim, idx.flatten()).unflatten(
        dim, (ngroups, width)).sum(dim + 1)


def _band_sum(flux_g, band_from_g, nbands):
    """(ncol, ng) -> (ncol, nbands)."""
    return _indexed_sum(flux_g, band_from_g, nbands, 1)


def _gsum(x):
    """g-first (nlev+1, ng, ncol) -> (ncol, nlev+1)."""
    return x.sum(1).T


def _surf_g(x):
    """g-first (nlev+1, ng, ncol) -> surface (ncol, ng)."""
    return x[-1].T


def _cloud_stage(setup, thermodynamics, cloud, cast):
    """Default overlap parameter, crop, cloud optics
    (ecrad_tpu_torch/interface.py _cloud_stage). Returns (cloud, six
    band-resolved optical properties)."""
    cfg = setup.config
    cloud = cloud.replace(**{f: cast(getattr(cloud, f)) for f in (
        "q_liq", "q_ice", "re_liq", "re_ice", "fraction",
        "fractional_std") + EFFECTIVE_SIZE_KEYS})
    cloud = cloud.set_overlap_param(thermodynamics, 2000.0)
    cloud = cloud.crop_cloud_fraction(cfg.cloud_fraction_threshold,
                                      cfg.cloud_mixing_ratio_threshold)
    return cloud, cloud_optics(cfg, setup.cloud_optics, setup.cloud_coeffs,
                               thermodynamics.pressure_hl,
                               thermodynamics.temperature_hl, cloud)


def radiation(setup: Setup, single_level: SingleLevel,
              thermodynamics: Thermodynamics, gas: GasConcs, cloud: Cloud,
              aerosol: Optional[Aerosol] = None) -> Flux:
    """Radiative fluxes of TOA-first columns, in setup.dtype."""
    cfg = setup.config
    phl = thermodynamics.pressure_hl
    if not bool((phl[:, 1:] > phl[:, :-1]).all()):
        raise ValueError("the reference takes TOA-first columns")

    def caster(dtype):
        return lambda x: None if x is None else x.to(setup.device, dtype)
    cast = caster(setup.dtype)
    single_level = single_level.replace(
        cos_sza=cast(single_level.cos_sza),
        skin_temperature=cast(single_level.skin_temperature),
        sw_albedo=cast(single_level.sw_albedo),
        lw_emissivity=cast(single_level.lw_emissivity),
        iseed=single_level.iseed.to(setup.device))
    thermo_in = thermodynamics
    thermodynamics = Thermodynamics(
        pressure_hl=cast(thermo_in.pressure_hl),
        temperature_hl=cast(thermo_in.temperature_hl))
    gas = gas.replace(mixing_ratio=cast(gas.mixing_ratio))
    sw_alb_diff, sw_alb_dir, lw_albedo = get_albedos(setup, single_level)
    go = gas_optics(
        thermodynamics.pressure_hl, thermodynamics.temperature_hl,
        gas.mixing_ratio, single_level.skin_temperature,
        single_level.cos_sza, single_level.solar_irradiance, setup.spec,
        setup.gas, lw_albedo=lw_albedo, min_gas_od_lw=cfg.min_gas_od_lw,
        min_gas_od_sw=cfg.min_gas_od_sw)

    zeros_lw = torch.zeros_like(go.od_lw)
    od_lw, ssa_lw, g_lw = go.od_lw, zeros_lw, zeros_lw
    od_sw, ssa_sw, g_sw = go.od_sw, go.ssa_sw, torch.zeros_like(go.od_sw)
    if cfg.use_aerosols and aerosol is not None:
        aerosol = aerosol.replace(mixing_ratio=cast(aerosol.mixing_ratio))
        od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw = add_aerosol_optics(
            cfg, setup.aerosol_coeffs, setup.spec.band_from_reordered_g_sw,
            setup.spec.band_from_reordered_g_lw, thermodynamics, gas,
            aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw)

    cloud_in = cloud
    cloud, props = _cloud_stage(setup, thermodynamics, cloud_in, cast)
    gen_cloud = None
    if setup.pdf_sampler is not None:
        gen = caster(setup.gen_dtype)
        gen_thermo = Thermodynamics(
            pressure_hl=gen(thermo_in.pressure_hl),
            temperature_hl=gen(thermo_in.temperature_hl))
        gen_cloud = cloud_in.replace(**{f: gen(getattr(cloud_in, f)) for f in (
            "q_liq", "q_ice", "fraction", "fractional_std")})
        gen_cloud = gen_cloud.set_overlap_param(gen_thermo, 2000.0)
        gen_cloud = gen_cloud.crop_cloud_fraction(
            cfg.cloud_fraction_threshold, cfg.cloud_mixing_ratio_threshold)

    iseed = single_level.iseed
    band_lw = setup.spec.band_from_reordered_g_lw
    band_sw = setup.spec.band_from_reordered_g_sw
    extras = {}
    if cfg.i_solver_lw == Solver.MCICA:
        lw, lw_clear, tcc, more = solver_mcica_lw(
            cfg, setup.pdf_sampler, band_lw, iseed, cloud, gen_cloud,
            od_lw, ssa_lw, g_lw, *props[:3], go.planck_hl, go.lw_emission,
            lw_albedo, cheb=setup.pdf_cheb)
    elif cfg.i_solver_lw == Solver.SPARTACUS:
        lw, lw_clear, tcc, more = solver_spartacus_lw(
            cfg, band_lw, thermodynamics, cloud, od_lw, ssa_lw, g_lw,
            *props[:3], go.planck_hl, go.lw_emission, lw_albedo)
    else:
        lw, lw_clear, tcc, more = solver_tripleclouds_lw(
            cfg, band_lw, cloud, od_lw, ssa_lw, g_lw, *props[:3],
            go.planck_hl, go.lw_emission, lw_albedo)
    extras.update(cloud_cover_lw=tcc, **more)

    sw_props = (od_sw, ssa_sw, g_sw, *props[3:], go.incoming_sw)
    if cfg.i_solver_sw == Solver.MCICA:
        sw, sw_clear, tcc = solver_mcica_sw(
            cfg, setup.pdf_sampler, band_sw, iseed, single_level.cos_sza,
            cloud, gen_cloud, *sw_props, sw_alb_diff, sw_alb_dir,
            cheb=setup.pdf_cheb)
    elif cfg.i_solver_sw == Solver.SPARTACUS:
        sw, sw_clear, tcc = solver_spartacus_sw(
            cfg, band_sw, single_level.cos_sza, thermodynamics, cloud,
            *sw_props, sw_alb_diff, sw_alb_dir)
    else:
        sw, sw_clear, tcc = solver_tripleclouds_sw(
            cfg, band_sw, cloud, single_level.cos_sza, *sw_props,
            sw_alb_diff, sw_alb_dir)
    extras["cloud_cover_sw"] = tcc
    return Flux(**_lw_fields(band_lw, lw, lw_clear),
                **_sw_fields(band_sw, sw, sw_clear), **extras)


def _lw_fields(band_lw, lw, lw_clear) -> dict:
    surf_g = _surf_g(lw.dn)
    return dict(lw_up=_gsum(lw.up), lw_dn=_gsum(lw.dn), lw_dn_surf_g=surf_g,
                lw_dn_surf_band=_band_sum(surf_g, band_lw, 16),
                lw_up_clear=_gsum(lw_clear.up), lw_dn_clear=_gsum(lw_clear.dn),
                lw_dn_surf_clear_band=_band_sum(_surf_g(lw_clear.dn),
                                                band_lw, 16))


def _sw_fields(band_sw, sw, sw_clear) -> dict:
    def fields(s):
        surf_dif, surf_dir = _surf_g(s.dn_diffuse), _surf_g(s.dn_direct)
        return {"up": _gsum(s.up), "dn": _gsum(s.dn_diffuse + s.dn_direct),
                "direct": _gsum(s.dn_direct), "surf_dif": surf_dif,
                "surf_dir": surf_dir,
                "surf_band": _band_sum(surf_dif + surf_dir, band_sw, 14),
                "direct_band": _band_sum(surf_dir, band_sw, 14)}

    tot, clr = fields(sw), fields(sw_clear)
    return dict(sw_up=tot["up"], sw_dn=tot["dn"], sw_dn_direct=tot["direct"],
                sw_dn_diffuse_surf_g=tot["surf_dif"],
                sw_dn_direct_surf_g=tot["surf_dir"],
                sw_up_clear=clr["up"], sw_dn_clear=clr["dn"],
                sw_dn_direct_clear=clr["direct"],
                sw_dn_surf_band=tot["surf_band"],
                sw_dn_direct_surf_band=tot["direct_band"],
                sw_dn_surf_clear_band=clr["surf_band"],
                sw_dn_direct_surf_clear_band=clr["direct_band"])
