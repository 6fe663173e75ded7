"""Top level: setup_radiation and the radiation() entry point.

Port of ecrad_tpu/interface.py (radiation/radiation_interface.F90) for
the Cloudless, McICA, Homogeneous, Tripleclouds and SPARTACUS solvers and
both gas models: setup loads the tables and spectral mappings (the
monochromatic model has neither: one band, one g-point), for a cloudy
solver the cloud-optics LUTs, for McICA the cloud-PDF sampler and with
use_aerosols the aerosol LUT, onto one device (the GPU unless the caller
asks for another); radiation() runs gas optics (with the spectral solar
scaling), the aerosol stage, the cloud stage (default fractional_std,
overlap parameter from a 2 km decorrelation length, cropping, cloud
optics), the solvers and the flux assembly: broadband profiles, surface
band and g-point fluxes, the canopy-top fluxes, and the band or g-point
profiles of do_save_spectral_flux. Inputs whose pressure increases
upwards are flipped, run TOA first, and their flux profiles flipped
back. On CUDA tensors the path
runs kernels B1 (LW taumol), B2 (SW taumol) or with
ECRAD_FUSED_TAUMOL=0 B10 (per-band taumol), B3/B3' (adding sweeps), B4
(McICA layer optics), B5 (Tripleclouds region sweeps) and B6-B9
(SPARTACUS layer reflectance/transmittance and adding sweeps); on CPU
tensors their plain versions. With a SPARTACUS solver the g-points of
its spectral region are reordered by optical depth, and every band map
is the reordered one (`spec.band_from_reordered_g_*`); the g-point
profiles come back in the original order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import GasModel, RadiationConfig, Solver, check_supported
from .optics.aerosol import (AerosolOpticsTables, add_aerosol_optics,
                             aerosol_tensors, setup_aerosol_optics)
from .optics.cloud import (CloudOpticsTables, cloud_optics,
                           coefficient_tensors, setup_cloud_optics)
from .optics.monochromatic import cloud_optics_mono, gas_optics_mono
from .optics.rrtmg.gas_optics import (
    WAVENUM1_LW, WAVENUM1_SW, WAVENUM2_LW, WAVENUM2_SW, GasOpticsSpec,
    GasTables, gas_optics, gas_tables, make_spec)
from .optics.rrtmg.tables import load_tables
from .optics.spectral_mapping import (expand_to_g, interval_mapping,
                                      single_g_mapping)
from .solvers.cloudless import solver_cloudless_lw, solver_cloudless_sw
from .solvers.dispatch import solve_lw, solve_sw
from .solvers.lw_derivatives import lw_derivatives_ica
from .solvers.pdf_sampler import PdfSampler, setup_pdf_sampler
from .types import (AEROSOL_FIELDS, LEVEL_FLUX_FIELDS, Aerosol, Cloud,
                    Flux, GasConcs, SingleLevel, Thermodynamics)
from .utils import hooks

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class RadiationSetup:
    """Static data for one configuration on one device."""
    config: RadiationConfig
    tables: dict                       # RRTMG coefficient tables (numpy)
    spec: GasOpticsSpec
    # albedo/emissivity interval mappings (one of map/weights is None)
    sw_albedo_map: Optional[np.ndarray]
    sw_albedo_weights: Optional[np.ndarray]
    lw_emiss_map: Optional[np.ndarray]
    lw_emiss_weights: Optional[np.ndarray]
    device: torch.device
    dtype: torch.dtype
    gas: Optional[GasTables]           # tables on the device (RRTMG only)
    cloud_optics: Optional[CloudOpticsTables] = None   # numpy, as read
    pdf_sampler: Optional[PdfSampler] = None
    cloud_coeffs: Optional[dict] = None   # cloud_optics on the device
    pdf_cheb: Optional[torch.Tensor] = None   # pdf_sampler.cheb, device
    aerosol_optics: Optional[AerosolOpticsTables] = None   # numpy, as read
    aerosol_coeffs: Optional[dict] = None     # aerosol_tensors, device


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" (the default of every
    entry point) needs a CUDA GPU and raises without one: the CPU, where
    the kernels' plain versions run, has to be asked for (device="cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port runs on the GPU by default; "
            "pass device='cpu' to run the kernels' plain versions on the "
            "CPU")
    return device


def setup_radiation(config: RadiationConfig,
                    device="cuda") -> RadiationSetup:
    """Load the tables and precompute the spectral mappings
    (radiation_interface.F90:37-134); for a cloudy solver also the cloud
    optics LUTs, for McICA the cloud-PDF sampler and with use_aerosols
    the aerosol LUT (NetCDF files named by the config); the monochromatic
    model reads no table and no optics LUT. Runs on the GPU unless
    `device` says otherwise; raises ValueError for a configuration no
    solver takes."""
    device = resolve_device(device)
    config = config.consolidated()
    check_supported(config)
    solvers = (config.i_solver_sw, config.i_solver_lw)
    pdf = (setup_pdf_sampler(config) if Solver.MCICA in solvers else None)
    if config.i_gas_model == GasModel.MONOCHROMATIC:
        spec, one = single_g_mapping()
        return make_setup(config, {}, spec, one, None, one, None, device,
                          pdf_sampler=pdf)
    tables = load_tables()
    sw_map, sw_weights = interval_mapping(
        config.sw_albedo_wavelength_bound, config.i_sw_albedo_index,
        WAVENUM1_SW, WAVENUM2_SW, config.do_nearest_spectral_sw_albedo)
    lw_map, lw_weights = interval_mapping(
        config.lw_emiss_wavelength_bound, config.i_lw_emiss_index,
        WAVENUM1_LW, WAVENUM2_LW, config.do_nearest_spectral_lw_emiss)
    cloud = (setup_cloud_optics(config)
             if any(s != Solver.CLOUDLESS for s in solvers) else None)
    aerosol = setup_aerosol_optics(config) if config.use_aerosols else None
    # SPARTACUS orders the g-points of its regions by optical depth
    # (ecrad_tpu/interface.py:70-73)
    spec = make_spec(tables, reorder_lw=config.i_solver_lw == Solver.SPARTACUS,
                     reorder_sw=config.i_solver_sw == Solver.SPARTACUS)
    return make_setup(config, tables, spec, sw_map, sw_weights, lw_map,
                      lw_weights, device, cloud, pdf, aerosol)


def make_setup(config, tables, spec, sw_map, sw_weights, lw_map,
               lw_weights, device, cloud_optics=None, pdf_sampler=None,
               aerosol_optics=None) -> RadiationSetup:
    device = resolve_device(device)
    dtype = DTYPES[config.dtype]
    return RadiationSetup(
        config=config, tables=tables, spec=spec,
        sw_albedo_map=sw_map, sw_albedo_weights=sw_weights,
        lw_emiss_map=lw_map, lw_emiss_weights=lw_weights,
        device=device, dtype=dtype,
        gas=gas_tables(tables, dtype, device) if tables else None,
        cloud_optics=cloud_optics, pdf_sampler=pdf_sampler,
        cloud_coeffs=(None if cloud_optics is None
                      else coefficient_tensors(cloud_optics, device)),
        pdf_cheb=(None if pdf_sampler is None or pdf_sampler.cheb is None
                  else torch.as_tensor(pdf_sampler.cheb, device=device)),
        aerosol_optics=aerosol_optics,
        aerosol_coeffs=(None if aerosol_optics is None
                        else aerosol_tensors(aerosol_optics, dtype, device)))


def get_albedos(setup: RadiationSetup, single_level: SingleLevel):
    """Per-g surface albedos (radiation_single_level.F90:204-330):
    (sw_albedo_diffuse, sw_albedo_direct, lw_albedo), each (ncol, ng).
    With use_canopy_full_spectrum_* an albedo or emissivity given per g
    (in the spec's g order) passes through unchanged (:240-248)."""
    cfg = setup.config
    band_sw = setup.spec.band_from_reordered_g_sw
    band_lw = setup.spec.band_from_reordered_g_lw

    def sw(values):
        if cfg.use_canopy_full_spectrum_sw and \
                values.shape[-1] == len(band_sw):
            return values
        return expand_to_g(values, setup.sw_albedo_map,
                           setup.sw_albedo_weights, band_sw)
    sw_diffuse = sw(single_level.sw_albedo)
    sw_direct = (sw_diffuse if single_level.sw_albedo_direct is None
                 else sw(single_level.sw_albedo_direct))
    emissivity = single_level.lw_emissivity
    if not (cfg.use_canopy_full_spectrum_lw
            and emissivity.shape[-1] == len(band_lw)):
        emissivity = expand_to_g(emissivity, setup.lw_emiss_map,
                                 setup.lw_emiss_weights, band_lw)
    return sw_diffuse, sw_direct, 1.0 - emissivity


def _indexed_sum(x, group_of, ngroups, dim):
    """x summed over its axis `dim` in groups, member k going to group
    group_of[k]: that axis becomes ngroups long. Each group's members are
    gathered into a row padded with zeros to the widest group, then
    summed; groups of one member each are a plain gather. No atomics (an
    index_add_ on the GPU adds in a different order on every run), so a
    run repeats bit for bit; no matmul, so TF32 never rounds a flux."""
    group_of = np.asarray(group_of)
    members = [np.flatnonzero(group_of == b) for b in range(ngroups)]
    n = x.shape[dim]
    width = max(len(m) for m in members)
    idx = np.full((ngroups, width), n)
    for b, m in enumerate(members):
        idx[b, :len(m)] = m
    idx = hooks.upload("interface", idx, x.device)
    if all(len(m) == 1 for m in members):
        return x.index_select(dim, idx[:, 0])
    pad = list(x.shape)
    pad[dim] = 1
    padded = torch.cat([x, x.new_zeros(pad)], dim)
    return padded.index_select(dim, idx.flatten()).unflatten(
        dim, (ngroups, width)).sum(dim + 1)


def _band_sum(flux_g, band_from_g, nbands):
    """(ncol, ng) -> (ncol, nbands)."""
    return _indexed_sum(flux_g, band_from_g, nbands, 1)


def _canopy_sum(flux_g, band_from_g, imap, weights):
    """Surface per-g flux (ncol, ng) -> canopy intervals (ncol, nint)
    (radiation_flux.F90:377-450): the nearest interval's sum, or the band
    sums weighted by the intervals' overlap (nint, nbands), an explicit
    multiply-add (no TF32)."""
    if imap is not None:
        imap = np.asarray(imap)
        return _band_sum(flux_g, imap[band_from_g], int(imap.max()) + 1)
    bands = _band_sum(flux_g, band_from_g, int(np.max(band_from_g)) + 1)
    w = hooks.upload("interface", weights, flux_g.device, flux_g.dtype)
    return (bands[:, None, :] * w[None]).sum(-1)


def _profiles(x, spec_map, nspec):
    """g-first (nlev+1, ng, ncol) -> (ncol, nlev+1, nspec), summed by
    spec_map (a band map, or g_from_reordered_g: a permutation back to
    the original g order)."""
    return _indexed_sum(x, spec_map, nspec, 1).permute(2, 0, 1)


def _spectral_map(setup, region, nbands):
    """(map, length) of the do_save_spectral_flux profiles of a region:
    per g in the original order with do_save_gpoint_flux, else per band
    (one band for the monochromatic model)."""
    spec = setup.spec
    if setup.config.do_save_gpoint_flux:
        g = getattr(spec, f"g_from_reordered_g_{region}")
        return g, len(g)
    band = getattr(spec, f"band_from_reordered_g_{region}")
    return band, nbands if len(band) > 1 else 1


def _gsum(x):
    """g-first (nlev+1, ng, ncol) -> (ncol, nlev+1): the g-points added
    in halves (the first half to the second, an odd last one carried),
    an order set by ng alone. Each column's sum is the same bits in any
    batch and on any device, so columns split over devices or processes
    give the fluxes of the whole batch bit for bit; x.sum(1) sums a
    column in an order that depends on the batch width (on the CPU, 4
    columns against 8)."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        s = x[:, :half] + x[:, half:2 * half]
        x = torch.cat([s, x[:, 2 * half:]], 1) if x.shape[1] % 2 else s
    return x[:, 0].T


def _surf_g(x):
    """g-first (nlev+1, ng, ncol) -> surface (ncol, ng)."""
    return x[-1].T


def _flip_fields(obj, names):
    return obj.replace(**{n: getattr(obj, n).flip(1) for n in names
                          if getattr(obj, n) is not None})


def radiation(setup: RadiationSetup, single_level: SingleLevel,
              thermodynamics: Thermodynamics, gas: GasConcs,
              cloud: Optional[Cloud] = None,
              aerosol: Optional[Aerosol] = None) -> Flux:
    """Radiative fluxes (radiation_interface.F90:175-473). `cloud` is
    used by the cloudy solvers and ignored by Cloudless; `aerosol` is
    used when use_aerosols is on."""
    with hooks.hook("ecrad.radiation"):
        return _radiation(setup, single_level, thermodynamics, gas, cloud,
                          aerosol)


def _radiation(setup, single_level, thermodynamics, gas, cloud, aerosol):
    phl = thermodynamics.pressure_hl
    if not hooks.sync("orientation", bool, phl[0, 1] < phl[0, 0]):
        return _radiation_oriented(setup, single_level, thermodynamics,
                                   gas, cloud, aerosol)
    thermodynamics = _flip_fields(thermodynamics, (
        "pressure_hl", "temperature_hl", "h2o_sat_liq"))
    gas = _flip_fields(gas, ("mixing_ratio",))
    if cloud is not None:
        cloud = _flip_fields(cloud, (
            "q_liq", "q_ice", "re_liq", "re_ice", "fraction",
            "fractional_std", "overlap_param", "inv_cloud_effective_size",
            "inv_inhom_effective_size"))
    if aerosol is not None:
        aerosol = _flip_fields(aerosol, AEROSOL_FIELDS)
    flux = _radiation_oriented(setup, single_level, thermodynamics, gas,
                               cloud, aerosol)
    return _flip_fields(flux, LEVEL_FLUX_FIELDS)


def _cloud_stage(setup, thermodynamics, cloud, cast):
    """Default fractional_std and overlap parameter, crop, cloud optics
    (ecrad_tpu/interface.py:338-359; the monochromatic model's geometric
    optics). Returns (cloud, six band-resolved optical properties)."""
    cfg = setup.config
    cloud = cloud.replace(**{f: cast(getattr(cloud, f)) for f in (
        "q_liq", "q_ice", "re_liq", "re_ice", "fraction", "fractional_std",
        "overlap_param", "inv_cloud_effective_size",
        "inv_inhom_effective_size")})
    if cloud.fractional_std is None:
        cloud = cloud.replace(fractional_std=torch.zeros_like(
            cloud.fraction))
    if cloud.overlap_param is None:
        cloud = cloud.set_overlap_param(thermodynamics, 2000.0)
    cloud = cloud.crop_cloud_fraction(cfg.cloud_fraction_threshold,
                                      cfg.cloud_mixing_ratio_threshold)
    if cfg.i_gas_model == GasModel.MONOCHROMATIC:
        return cloud, cloud_optics_mono(cfg, thermodynamics, cloud)
    return cloud, cloud_optics(cfg, setup.cloud_optics, setup.cloud_coeffs,
                               thermodynamics.pressure_hl,
                               thermodynamics.temperature_hl, cloud)


def _radiation_oriented(setup: RadiationSetup, single_level: SingleLevel,
                        thermodynamics: Thermodynamics, gas: GasConcs,
                        cloud: Optional[Cloud],
                        aerosol: Optional[Aerosol]) -> Flux:
    cfg = setup.config
    cast = lambda x: None if x is None else x.to(setup.device, setup.dtype)
    single_level = single_level.replace(
        cos_sza=cast(single_level.cos_sza),
        skin_temperature=cast(single_level.skin_temperature),
        sw_albedo=cast(single_level.sw_albedo),
        sw_albedo_direct=cast(single_level.sw_albedo_direct),
        lw_emissivity=cast(single_level.lw_emissivity),
        lw_emission=cast(single_level.lw_emission),
        spectral_solar_scaling=cast(single_level.spectral_solar_scaling),
        iseed=(None if single_level.iseed is None
               else single_level.iseed.to(setup.device)))
    thermodynamics = thermodynamics.replace(
        pressure_hl=cast(thermodynamics.pressure_hl),
        temperature_hl=cast(thermodynamics.temperature_hl),
        h2o_sat_liq=cast(thermodynamics.h2o_sat_liq))
    gas = gas.replace(mixing_ratio=cast(gas.mixing_ratio))
    sw_alb_diff, sw_alb_dir, lw_albedo = get_albedos(setup, single_level)
    with hooks.hook("ecrad.gas_optics"):
        if cfg.i_gas_model == GasModel.MONOCHROMATIC:
            go = gas_optics_mono(cfg, single_level, thermodynamics)
        else:
            go = gas_optics(
                thermodynamics.pressure_hl, thermodynamics.temperature_hl,
                gas.mixing_ratio, single_level.skin_temperature,
                single_level.cos_sza, single_level.solar_irradiance,
                setup.spec, setup.gas, lw_albedo=lw_albedo,
                min_gas_od_lw=cfg.min_gas_od_lw,
                min_gas_od_sw=cfg.min_gas_od_sw,
                spectral_solar_scaling=(single_level.spectral_solar_scaling
                                        if cfg.use_spectral_solar_scaling
                                        else None))

    emission = go.lw_emission
    if single_level.lw_emission is not None:
        # a tiled surface supplies the emission directly
        # (radiation_ifs_rrtm.F90:436-443)
        emission = single_level.lw_emission
        if emission.shape[-1] != go.od_lw.shape[-1]:
            band_g = setup.spec.band_from_reordered_g_lw
            idx = (setup.lw_emiss_map[band_g]
                   if setup.lw_emiss_map is not None else band_g)
            emission = emission[:, hooks.upload("interface", idx,
                                                emission.device)]

    # the aerosol stage: the clear sky includes the aerosols
    zeros_lw = torch.zeros_like(go.od_lw)
    od_lw, ssa_lw, g_lw = go.od_lw, zeros_lw, zeros_lw
    od_sw, ssa_sw, g_sw = go.od_sw, go.ssa_sw, torch.zeros_like(go.od_sw)
    # (the monochromatic setup loads no aerosol LUT)
    if cfg.use_aerosols and aerosol is not None and \
            setup.aerosol_coeffs is not None:
        aerosol = aerosol.replace(**{f: cast(getattr(aerosol, f))
                                     for f in AEROSOL_FIELDS})
        with hooks.hook("ecrad.aerosol"):
            od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw = add_aerosol_optics(
                cfg, setup.aerosol_coeffs,
                setup.spec.band_from_reordered_g_sw,
                setup.spec.band_from_reordered_g_lw, thermodynamics, gas,
                aerosol, od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw)

    cloud_props = None
    if cfg.do_clouds and cloud is not None:
        if (Solver.MCICA in (cfg.i_solver_sw, cfg.i_solver_lw)
                and single_level.iseed is None):
            raise ValueError("the McICA cloud generator needs "
                             "single_level.iseed (one seed per column)")
        with hooks.hook("ecrad.cloud_optics"):
            cloud, cloud_props = _cloud_stage(setup, thermodynamics, cloud,
                                              cast)

    flux = Flux()
    if cfg.do_lw:
        extras = {}
        if cfg.i_solver_lw == Solver.CLOUDLESS or cloud_props is None:
            lw, t_clear = solver_cloudless_lw(
                od_lw, ssa_lw, g_lw, go.planck_hl, emission, lw_albedo,
                do_scattering=(cfg.do_lw_aerosol_scattering
                               and cfg.use_aerosols), want_trans=True)
            lw_clear = lw
            if cfg.do_lw_derivatives:
                # ICA form on the clear transmittance
                # (radiation_cloudless_lw.F90:166-171)
                extras["lw_derivatives"] = lw_derivatives_ica(
                    t_clear, lw.up[-1].T)
        else:
            lw, lw_clear, extras = solve_lw(
                setup, single_level, thermodynamics, cloud, cloud_props,
                od_lw, ssa_lw, g_lw, go.planck_hl, emission, lw_albedo)
        flux = flux.replace(**_lw_fields(setup, lw, lw_clear, cfg.do_clear),
                            **extras)

    if cfg.do_sw:
        extras = {}
        if cfg.i_solver_sw == Solver.CLOUDLESS or cloud_props is None:
            sw = solver_cloudless_sw(od_sw, ssa_sw, g_sw, go.incoming_sw,
                                     single_level.cos_sza, sw_alb_diff,
                                     sw_alb_dir)
            sw_clear = sw
        else:
            sw, sw_clear, extras = solve_sw(
                setup, single_level, thermodynamics, cloud, cloud_props,
                od_sw, ssa_sw, g_sw, go.incoming_sw, sw_alb_diff, sw_alb_dir)
        flux = flux.replace(**_sw_fields(setup, sw, sw_clear), **extras)
    return flux


def _lw_fields(setup, lw, lw_clear, do_clear) -> dict:
    cfg = setup.config
    band_lw = setup.spec.band_from_reordered_g_lw
    up, dn, surf_g = _gsum(lw.up), _gsum(lw.dn), _surf_g(lw.dn)
    out = dict(lw_up=up, lw_dn=dn, lw_dn_surf_g=surf_g,
               lw_dn_surf_band=_band_sum(surf_g, band_lw, 16))
    if do_clear:
        if lw_clear is not lw:
            up, dn = _gsum(lw_clear.up), _gsum(lw_clear.dn)
            out["lw_dn_surf_clear_band"] = _band_sum(_surf_g(lw_clear.dn),
                                                     band_lw, 16)
        else:
            out["lw_dn_surf_clear_band"] = out["lw_dn_surf_band"]
        out.update(lw_up_clear=up, lw_dn_clear=dn)
    if cfg.do_canopy_fluxes_lw:
        out["lw_dn_surf_canopy"] = (
            surf_g if cfg.use_canopy_full_spectrum_lw else _canopy_sum(
                surf_g, band_lw, setup.lw_emiss_map, setup.lw_emiss_weights))
    if cfg.do_save_spectral_flux:
        smap, nspec = _spectral_map(setup, "lw", 16)
        out.update(lw_up_band=_profiles(lw.up, smap, nspec),
                   lw_dn_band=_profiles(lw.dn, smap, nspec))
        if do_clear:
            out.update(
                lw_up_band_clear=(out["lw_up_band"] if lw_clear is lw
                                  else _profiles(lw_clear.up, smap, nspec)),
                lw_dn_band_clear=(out["lw_dn_band"] if lw_clear is lw
                                  else _profiles(lw_clear.dn, smap, nspec)))
    return out


def _sw_fields(setup, sw, sw_clear) -> dict:
    cfg = setup.config
    band_sw = setup.spec.band_from_reordered_g_sw
    if cfg.do_save_spectral_flux:
        smap, nspec = _spectral_map(setup, "sw", 14)

    def fields(s):
        surf_dif, surf_dir = _surf_g(s.dn_diffuse), _surf_g(s.dn_direct)
        dn = s.dn_diffuse + s.dn_direct
        f = {"up": _gsum(s.up), "dn": _gsum(dn),
             "direct": _gsum(s.dn_direct) if cfg.do_sw_direct else None,
             "surf_dif": surf_dif, "surf_dir": surf_dir,
             "surf_band": (_band_sum(surf_dif + surf_dir, band_sw, 14)
                           if cfg.do_surface_sw_spectral_flux else None),
             "direct_band": (_band_sum(surf_dir, band_sw, 14)
                             if cfg.do_surface_sw_spectral_flux else None)}
        if cfg.do_save_spectral_flux:
            f.update(up_band=_profiles(s.up, smap, nspec),
                     dn_band=_profiles(dn, smap, nspec),
                     direct_band_profile=_profiles(s.dn_direct, smap, nspec))
        return f

    tot = fields(sw)
    out = dict(sw_up=tot["up"], sw_dn=tot["dn"],
               sw_dn_diffuse_surf_g=tot["surf_dif"],
               sw_dn_direct_surf_g=tot["surf_dir"],
               sw_dn_direct=tot["direct"])
    clr = None
    if cfg.do_clear:
        clr = tot if sw_clear is sw else fields(sw_clear)
        out.update(sw_up_clear=clr["up"], sw_dn_clear=clr["dn"],
                   sw_dn_direct_clear=clr["direct"])
    if cfg.do_surface_sw_spectral_flux:
        out.update(sw_dn_surf_band=tot["surf_band"],
                   sw_dn_direct_surf_band=tot["direct_band"])
        if clr is not None:
            out.update(sw_dn_surf_clear_band=clr["surf_band"],
                       sw_dn_direct_surf_clear_band=clr["direct_band"])
    if cfg.do_canopy_fluxes_sw:
        canopy = ((lambda x: x) if cfg.use_canopy_full_spectrum_sw else
                  (lambda x: _canopy_sum(x, band_sw, setup.sw_albedo_map,
                                         setup.sw_albedo_weights)))
        out.update(sw_dn_diffuse_surf_canopy=canopy(tot["surf_dif"]),
                   sw_dn_direct_surf_canopy=canopy(tot["surf_dir"]))
    if cfg.do_save_spectral_flux:
        out.update(sw_up_band=tot["up_band"], sw_dn_band=tot["dn_band"],
                   sw_dn_direct_band=tot["direct_band_profile"])
        if clr is not None:
            out.update(sw_up_band_clear=clr["up_band"],
                       sw_dn_band_clear=clr["dn_band"],
                       sw_dn_direct_band_clear=clr["direct_band_profile"])
    return out
