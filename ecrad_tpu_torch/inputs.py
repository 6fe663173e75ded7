"""Seeded generator of realistic clear-sky columns (numpy only).

Used by the tests, the golden script (tools/make_torch_port_golden.py)
and chip_smoke.py, so all three see the same columns for a given
(ncol, nlev, seed). Every column is perturbed per seed:
  - half-level pressure from 1 Pa at the top to a surface pressure near
    101300 Pa, log-spaced aloft and near-linear close to the surface;
  - temperature with a 6.5 K/km troposphere, a tropopause of 195-215 K,
    a stratosphere warming to 270 K at 48 km and a cooling mesosphere;
  - H2O decaying with height to a stratospheric floor, an O3 peak near
    10 hPa, present-day CO2, CH4, N2O, CFC11, CFC12, HCFC22 and CCl4;
  - cos_sza in [-0.2, 1] (day and night columns);
  - 6 SW albedo intervals and 3 LW emissivity intervals.
Arrays are float64, TOA first; mixing ratios are mass mixing ratios in
the gas order of constants.GAS_NAMES.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .constants import GAS_INDEX, GAS_MOLAR_MASS, MOLAR_MASS_DRY_AIR, \
    NUM_GASES

#: present-day volume mixing ratios of the well-mixed gases
VMR = {"co2": 415e-6, "ch4": 1.9e-6, "n2o": 332e-9, "cfc11": 220e-12,
       "cfc12": 500e-12, "hcfc22": 250e-12, "ccl4": 80e-12}

N_SW_ALBEDO = 6
N_LW_EMISS = 3
SOLAR_IRRADIANCE = 1361.0


def make_columns(ncol: int, nlev: int = 137, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """Returns a dict of float64 arrays: pressure_hl, temperature_hl
    (ncol, nlev+1), mixing_ratio (ncol, nlev, NUM_GASES), cos_sza,
    skin_temperature (ncol,), sw_albedo (ncol, 6), lw_emissivity
    (ncol, 3), and the scalar solar_irradiance."""
    rng = np.random.RandomState(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (ncol,))

    p_surf = u(97000.0, 103500.0)[:, None]
    eta = np.linspace(0.0, 1.0, nlev + 1)[None, :]
    w = (1.0 - eta) ** 2
    p_hl = w * p_surf ** eta + (1.0 - w) * p_surf * eta
    p_hl[:, 0] = 1.0

    # temperature against log-pressure height (km, 7 km scale height)
    z = 7.0 * np.log(p_surf / p_hl)
    t_surf = u(270.0, 305.0)[:, None]
    t_trop = u(195.0, 215.0)[:, None]
    z_trop = (t_surf - t_trop) / 6.5
    z_pause = 48.0
    t_strat = t_trop + (270.0 - t_trop) * (z - z_trop) / (z_pause - z_trop)
    t_meso = 270.0 - 2.8 * (z - z_pause)
    t_hl = np.where(z < z_trop, t_surf - 6.5 * z,
                    np.where(z < z_pause, t_strat, t_meso))
    t_hl = np.maximum(t_hl, 180.0)
    skin = t_hl[:, -1] + rng.normal(0.0, 2.0, ncol)

    p_fl = 0.5 * (p_hl[:, :-1] + p_hl[:, 1:])
    p_trop = p_surf * np.exp(-z_trop / 7.0)
    above = p_fl < p_trop
    gas = np.zeros((ncol, nlev, NUM_GASES))
    q_surf = 2e-3 + 16e-3 * (t_surf - 270.0) / 35.0 * u(0.6, 1.0)[:, None]
    gas[:, :, GAS_INDEX["h2o"]] = np.maximum(
        q_surf * (p_fl / p_surf) ** 3, 2.5e-6)
    gas[:, :, GAS_INDEX["o3"]] = (
        u(1.1e-5, 1.6e-5)[:, None]
        * np.exp(-(np.log(p_fl / 1000.0) / 1.3) ** 2) + 3e-8)
    for name, vmr in VMR.items():
        mmr = vmr * GAS_MOLAR_MASS[name] / MOLAR_MASS_DRY_AIR
        prof = np.broadcast_to(mmr * u(0.98, 1.02)[:, None],
                               (ncol, nlev)).copy()
        if name in ("ch4", "n2o"):
            # destroyed in the stratosphere
            prof = np.where(above, prof * (p_fl / p_trop) ** 0.2, prof)
        gas[:, :, GAS_INDEX[name]] = prof

    return {
        "pressure_hl": p_hl,
        "temperature_hl": t_hl,
        "mixing_ratio": gas,
        "cos_sza": u(-0.2, 1.0),
        "skin_temperature": skin,
        "sw_albedo": u(0.05, 0.35, ncol, N_SW_ALBEDO),
        "lw_emissivity": u(0.90, 0.99, ncol, N_LW_EMISS),
        "solar_irradiance": SOLAR_IRRADIANCE,
    }


#: cloud fields on levels, (ncol, nlev)
CLOUD_KEYS = ("fraction", "q_liq", "q_ice", "re_liq", "re_ice",
              "fractional_std")
#: SPARTACUS's inverse effective sizes (m-1), (ncol, nlev), of
#: add_effective_sizes
EFFECTIVE_SIZE_KEYS = ("inv_cloud_effective_size", "inv_inhom_effective_size")
LEVEL_KEYS = ("pressure_hl", "temperature_hl", "mixing_ratio",
              "aerosol_mmr") + CLOUD_KEYS + EFFECTIVE_SIZE_KEYS




def make_clouds(cols: Dict[str, np.ndarray], seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """`cols` (of make_columns) plus cloud fields, drawn from their own
    RandomState so the clear-sky keys stay as make_columns made them.

    Each column holds up to four cloud decks placed in pressure between
    150 and 950 hPa. A deck's fraction rises to a peak and falls again,
    some decks have a second peak (a rise after a descent: a new Exp-Exp
    object), and peaks above 1 are cut to 1, so some layers are overcast;
    15 % of the columns are cloud-free. The in-cloud water content is
    liquid where the layer is warmer than 253 K and ice where it is
    colder; q_liq/q_ice are grid-box means (fraction x in-cloud).
    Adds fraction, q_liq, q_ice (kg/kg), re_liq (5-20 um), re_ice
    (20-80 um), fractional_std (0.75-1.25) and iseed = arange(ncol);
    overlap_param is left for radiation() to derive."""
    ncol, nlev = cols["pressure_hl"].shape[0], cols["pressure_hl"].shape[1] - 1
    rng = np.random.RandomState(seed + 7919)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (ncol,))
    p_fl = 0.5 * (cols["pressure_hl"][:, :-1] + cols["pressure_hl"][:, 1:])
    t_fl = 0.5 * (cols["temperature_hl"][:, :-1]
                  + cols["temperature_hl"][:, 1:])
    frac = np.zeros((ncol, nlev))
    ndeck = rng.randint(1, 5, ncol)
    for d in range(4):
        centre = u(15000.0, 95000.0)[:, None]
        width = u(2000.0, 12000.0)[:, None]
        peak = np.where(ndeck > d, u(0.15, 1.5), 0.0)[:, None]
        shape = np.maximum(0.0, 1.0 - np.abs(p_fl - centre) / width)
        # a second peak on the deck's lower flank in a third of them
        dip = np.where(u(0.0, 1.0) < 0.33, 0.5, 0.0)[:, None]
        shape = shape * (1.0 - dip * np.exp(-((p_fl - centre - 0.5 * width)
                                             / (0.15 * width)) ** 2))
        frac = np.maximum(frac, np.minimum(peak * shape, 1.0))
    frac[u(0.0, 1.0) < 0.15] = 0.0
    frac[frac < 0.01] = 0.0
    incloud = u(0.5, 2.0)[:, None] * np.where(t_fl > 253.0, 2.0e-4, 2.0e-5)
    q = frac * incloud
    liquid = t_fl > 253.0
    out = dict(cols)
    out.update(
        fraction=frac,
        q_liq=np.where(liquid, q, 0.0),
        q_ice=np.where(liquid, 0.0, q),
        re_liq=u(5.0e-6, 20.0e-6, ncol, nlev),
        re_ice=u(20.0e-6, 80.0e-6, ncol, nlev),
        fractional_std=u(0.75, 1.25, ncol, nlev),
        iseed=np.arange(ncol, dtype=np.int32))
    return out


def add_effective_sizes(cols: Dict[str, np.ndarray], separation_surf=2500.0,
                        separation_toa=14000.0, power=3.5,
                        inhom_separation_factor=0.75
                        ) -> Dict[str, np.ndarray]:
    """`cols` (of make_clouds) plus inv_cloud_effective_size and
    inv_inhom_effective_size (ncol, nlev), in m-1, from the cloud fraction
    and the effective cloud separation of ecRad's CY47R1 offline namelist:
    2500 m at the surface, 14000 m at the top of the atmosphere, rising
    with eta to the power 3.5, and inhomogeneities 0.75 times as far apart
    (types.Cloud.param_cloud_effective_separation_eta, computed in float64
    on the CPU). SPARTACUS's 3D terms need them: without them every layer
    takes its 1D fallback."""
    import torch

    from .types import Cloud, Thermodynamics
    t = lambda k: torch.as_tensor(cols[k], dtype=torch.float64)
    cloud = Cloud(q_liq=t("q_liq"), q_ice=t("q_ice"), re_liq=t("re_liq"),
                  re_ice=t("re_ice"), fraction=t("fraction"))
    cloud = cloud.param_cloud_effective_separation_eta(
        Thermodynamics(pressure_hl=t("pressure_hl"),
                       temperature_hl=t("temperature_hl")),
        separation_surf, separation_toa, power, inhom_separation_factor)
    out = dict(cols)
    out.update({k: getattr(cloud, k).numpy() for k in EFFECTIVE_SIZE_KEYS})
    return out


#: aerosol types of make_aerosols (config.TRIPLECLOUDS_AEROSOL_MAP's 12)
N_AEROSOL_TYPES = 12


def make_aerosols(cols: Dict[str, np.ndarray], seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """`cols` plus aerosol_mmr (ncol, nlev, N_AEROSOL_TYPES) in kg/kg,
    drawn from their own RandomState so every other key stays as it was.
    Each type's mixing ratio has a surface value of 1e-9 to 2e-8 and
    decays with height as (p / p_surf)^k, k from 2 to 6 (scale heights of
    about 1 to 3.5 km), within 1e-10 to 1e-7: with the synthetic aerosol
    LUT of write_synthetic_luts that is a mid-visible optical depth of
    order 0.1."""
    p_hl = cols["pressure_hl"]
    ncol, nlev = p_hl.shape[0], p_hl.shape[1] - 1
    rng = np.random.RandomState(seed + 15485863)
    p_fl = 0.5 * (p_hl[:, :-1] + p_hl[:, 1:])
    p_surf = p_hl.max(1)[:, None, None]
    surf = np.exp(rng.uniform(np.log(1e-9), np.log(2e-8),
                              (ncol, 1, N_AEROSOL_TYPES)))
    k = rng.uniform(2.0, 6.0, (ncol, 1, N_AEROSOL_TYPES))
    mmr = np.clip(surf * (p_fl[:, :, None] / p_surf) ** k, 1e-10, 1e-7)
    out = dict(cols)
    out["aerosol_mmr"] = mmr
    return out


#: the facets of each tile code (1 flat, 2 vegetation, 3 urban; as
#: surface.properties.N_TILE_FACETS)
_TILE_FACETS = {1: 1, 2: 1, 3: 3}


def make_surface(ncol: int, representation=(1,), seed: int = 0,
                 nalb: int = N_SW_ALBEDO, nem: int = N_LW_EMISS
                 ) -> Dict[str, np.ndarray]:
    """A tiled surface of `representation` (tile codes: 1 flat, 2
    vegetation, 3 urban; (1,) is ecRad's mls_flat case, (1, 2)
    mls_forest, (1, 2, 3) mls_london1), built as the JAX package's
    tests/test_surface.py:38-61 builds one, each field drawn per column
    from its own RandomState: skin temperatures 283-293 K per facet,
    diffuse and direct albedos 0.05-0.4 in `nalb` intervals,
    emissivities 0.9-1.0 in `nem` intervals, tile fractions from a flat
    Dirichlet, canopies 6-18 m deep at 285-295 K, building fractions
    0.2-0.6 with normalised perimeters 0.05-0.15 (height to width about
    0.5-1), vegetation optical depths 1-5, vegetation albedos 0.1-0.2
    and emissivities 0.96-0.99. A dict of float64 arrays under the
    SurfaceDescription field names (convert.surface_from_numpy makes the
    port's), plus "representation" (a tuple)."""
    rep = tuple(int(r) for r in representation)
    nfacet, ntile = sum(_TILE_FACETS[r] for r in rep), len(rep)
    rng = np.random.RandomState(seed + 32452843)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape)   # noqa: E731
    return {
        "skin_temperature": u(283.0, 293.0, ncol, nfacet),
        "sw_albedo": u(0.05, 0.4, ncol, nfacet, nalb),
        "sw_albedo_direct": u(0.05, 0.4, ncol, nfacet, nalb),
        "lw_emissivity": u(0.9, 1.0, ncol, nfacet, nem),
        "tile_fraction": rng.dirichlet(np.ones(ntile), size=ncol),
        "canopy_depth": u(6.0, 18.0, ncol, ntile),
        "canopy_temperature": u(285.0, 295.0, ncol, ntile),
        "building_fraction": u(0.2, 0.6, ncol, ntile),
        "building_normalized_perimeter": u(0.05, 0.15, ncol, ntile),
        "vegetation_optical_depth": u(1.0, 5.0, ncol, ntile),
        "vegetation_fractional_std": u(0.5, 1.0, ncol, ntile),
        "vegetation_sw_albedo": u(0.1, 0.2, ncol, ntile, nalb),
        "vegetation_lw_emissivity": u(0.96, 0.99, ncol, ntile, nem),
        "representation": rep,
    }


def write_surface(path: str, surface: Dict[str, np.ndarray],
                  building_scale: bool = False) -> None:
    """Add `surface` (of make_surface) to the driver input file `path`
    (one written by io.output.save_inputs), under the names
    surface.read_surface reads: tile_representation (tile), the facet
    fields skin_temperature (column, facet), sw_albedo and
    sw_albedo_direct (column, facet, sw_albedo_band), lw_emissivity
    (column, facet, lw_emiss_band), which replace the single-level ones,
    and the tile fields (column, tile[, band]). An albedo or emissivity
    of one interval is written 2-D (column, facet), as some ecRad
    surface files hold it. With building_scale the file holds
    building_scale = 4 f (1 - f) / perimeter in place of
    building_normalized_perimeter (radsurf_properties.F90:425-429
    converts it back)."""
    from scipy.io import netcdf_file

    from .io.netcdf import write_netcdf
    with netcdf_file(path, "r", mmap=False) as f:
        variables = {k: (v.dimensions, v[...].copy())
                     for k, v in f.variables.items()}
    band = {"sw": ("sw_albedo_band",), "lw": ("lw_emiss_band",)}

    def spectral(x, region):
        return ((), x[..., 0]) if x.shape[-1] == 1 else (band[region], x)

    facet, tile = ("column", "facet"), ("column", "tile")
    for name, region, dims in (
            ("sw_albedo", "sw", facet), ("sw_albedo_direct", "sw", facet),
            ("lw_emissivity", "lw", facet),
            ("vegetation_sw_albedo", "sw", tile),
            ("vegetation_lw_emissivity", "lw", tile)):
        extra, data = spectral(surface[name], region)
        variables[name] = (dims + extra, data)
    for name in ("tile_fraction", "canopy_depth", "canopy_temperature",
                 "building_fraction", "vegetation_optical_depth",
                 "vegetation_fractional_std"):
        variables[name] = (tile, surface[name])
    variables["skin_temperature"] = (facet, surface["skin_temperature"])
    perimeter = surface["building_normalized_perimeter"]
    if building_scale:
        f = surface["building_fraction"]
        variables["building_scale"] = (tile, 4.0 * f * (1.0 - f) / perimeter)
    else:
        variables["building_normalized_perimeter"] = (tile, perimeter)
    variables["tile_representation"] = (
        ("tile",), np.asarray(surface["representation"], np.int32))
    dims = {}
    for vdims, data in variables.values():
        dims.update(zip(vdims, np.shape(data)))
    write_netcdf(path, dims, variables)


def _write_nc(path, variables):
    from scipy.io import netcdf_file
    with netcdf_file(path, "w", version=2) as f:
        for name, (dims, data) in variables.items():
            for dname, n in zip(dims, data.shape):
                if dname not in f.dimensions:
                    f.createDimension(dname, n)
            f.createVariable(name, "d", dims)[...] = np.asarray(data,
                                                                np.float64)


def write_synthetic_luts(directory: str, seed: int = 0,
                         ice: str = "baran") -> dict:
    """Write SYNTHETIC cloud-optics, cloud-PDF and aerosol-optics lookup
    tables into `directory` and return the RadiationConfig overrides that
    name them (directory_name and the *_override_file_name fields), with
    the SOCRATES liquid table, the `ice` model's table (baran for McICA,
    fu for Tripleclouds) and the gamma PDF.

    These are NOT the ecRad data files. They hold coefficient arrays of
    the published functional forms (radiation_liquid_optics_socrates.F90,
    _slingo.F90, radiation_ice_optics_fu.F90, _baran*.F90, _yi.F90) with
    plausible magnitudes, made from `seed`, so that two programs reading
    the same files can be held to each other (parity); fluxes computed
    with them are not ecRad's. Magnitudes: liquid od ~ 1.5e-3 LWP/re, ice
    od ~ 40-80 m2/kg x IWP, SW single-scattering albedo 0.99999 down to
    ~0.95 across the bands, LW 0.2-0.6, asymmetry factor 0.75-0.9.

    Files (classic NetCDF, coeff_lw (16, n), coeff_sw (14, n)):
    synthetic_{socrates,slingo}_liquid.nc, synthetic_{fu,baran,
    baran2016,baran2017,yi}_ice.nc (baran2017 also coeff_gen (5,)), and
    synthetic_mcica_{gamma,lognormal}.nc (fsd (160,) from 0.025 to 4 and
    the quantile table x (1000, 160) on the cdf grid i/999, its end points
    clipped to 1e-4 and 1 - 1e-4), and synthetic_aerosol.nc (see
    _synthetic_aerosol)."""
    import os

    from scipy.special import gammaincinv, ndtri

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed + 104729)
    nb = {"lw": 16, "sw": 14}
    # per-band magnitudes: extinction multiplier, co-albedo, asymmetry
    mult = {s: rng.uniform(0.85, 1.15, n) for s, n in nb.items()}
    coalb = {"sw": np.geomspace(1e-5, 0.05, 14) * rng.uniform(0.8, 1.2, 14),
             "lw": rng.uniform(0.4, 0.8, 16)}
    asym = {s: rng.uniform(0.76, 0.86, n) for s, n in nb.items()}

    def per_band(fill):
        """coeff_lw/coeff_sw (nband, ncoeff) from fill(region, extinction
        multiplier, co-albedo, asymmetry) of one band."""
        return {f"coeff_{s}": (("band_" + s, "n_coeff_" + s), np.array(
            [fill(s, mult[s][b], coalb[s][b], asym[s][b])
             for b in range(n)])) for s, n in nb.items()}

    def socrates(s, m, ca, g):       # re in m
        return [1.5e4 * m, 0, 0, 1e7, 0, 0, ca, ca * 1e4, 0, 0, 0,
                g, 2e3, 0, 0, 0]

    def slingo(s, m, ca, g):         # SW Slingo (6) / LW Lindner-Li (13)
        if s == "sw":
            return [0.02 * m, 1.5 * m, 0.8 * ca, 0.02 * ca, g - 0.02, 0.002]
        return [0.02 * m, 0, 1.5 * m, 0, 0, ca, 0, 0, 0, g - 0.02, 0,
                0.002, 0]

    def fu(s, m, ca, g):             # de in um
        if s == "sw":
            return [0.02 * m, 1.5 * m, ca, ca * 0.005, 0, 0, g, 3e-4, 0, 0]
        return [0.02 * m, 1.5 * m, 0, ca * 1.5 * m, ca * 0.02 * m, 0, 0,
                g, 3e-4, 0, 0]

    def baran(s, m, ca, g):          # iwp in kg/m2, qi in kg/kg
        return [40 * m, 40 * m, 1e4, 1 - 1.2 * ca, 0.2 * ca, 1e4,
                g + 0.03, -0.03, 1e4]

    def baran2016(s, m, ca, g):      # od = iwp c1 / T^4
        return [1.2e11 * m, 1 - ca, -ca, g, 5.0]

    def baran2017(s, m, ca, g):
        return [40 * m, 40 * m, 1e5, 1 - 1.2 * ca, 0.2 * ca, 300,
                g + 0.03, -0.03, 300]

    de = np.arange(10.0, 125.0, 5.0)   # the 23 diameter bins (um)

    def yi(s, m, ca, g):               # extinction, ssa, g per bin
        return np.concatenate([2800.0 * m / de, 1 - ca * (1 + 0.002 * de),
                               np.minimum(g + 0.0005 * de, 0.9)])

    files = {
        "synthetic_socrates_liquid.nc": per_band(socrates),
        "synthetic_slingo_liquid.nc": per_band(slingo),
        "synthetic_fu_ice.nc": per_band(fu),
        "synthetic_baran_ice.nc": per_band(baran),
        "synthetic_baran2016_ice.nc": per_band(baran2016),
        "synthetic_baran2017_ice.nc": per_band(baran2017) | {
            "coeff_gen": (("n_gen",), np.array([0.03, 240.0, 1.0, 0.5,
                                                0.5]))},
        "synthetic_yi_ice.nc": per_band(yi),
    }
    for name, variables in files.items():
        _write_nc(os.path.join(directory, name), variables)

    fsd = np.linspace(0.025, 4.0, 160)
    cdf = np.clip(np.linspace(0.0, 1.0, 1000), 1e-4, 1.0 - 1e-4)
    var = fsd ** 2
    gamma = gammaincinv(1.0 / var[None, :], cdf[:, None]) * var[None, :]
    sigma2 = np.log1p(var)
    lognormal = np.exp(-0.5 * sigma2[None, :]
                       + np.sqrt(sigma2)[None, :] * ndtri(cdf)[:, None])
    for name, x in (("gamma", gamma), ("lognormal", lognormal)):
        _write_nc(os.path.join(directory, f"synthetic_mcica_{name}.nc"),
                  {"fsd": (("n_fsd",), fsd), "x": (("n_cdf", "n_fsd"), x)})
    _write_nc(os.path.join(directory, "synthetic_aerosol.nc"),
              _synthetic_aerosol(np.random.RandomState(seed + 1299709)))
    return {"directory_name": directory, **synthetic_lut_names(ice=ice)}


def _synthetic_aerosol(rng) -> dict:
    """The 13 variables of an aerosol-optics file as
    ecrad_tpu/optics/aerosol.py:44-57 reads them: for 8 hydrophobic types
    (type, band) and 6 hydrophilic ones (type, humidity bin, band),
    mass extinction (m2/kg; 1e2-1e4 in the SW, falling with wavelength,
    1e2-1e3 in the LW), single-scattering albedo (SW 0.8-1.0, LW 0.1-0.6)
    and asymmetry factor (0.5-0.8) for the 14 SW and 16 LW bands; and
    relative_humidity1, the lower bounds of 12 humidity bins. Hydrophilic
    extinction grows with humidity (x1 to ~x4 at 95 %), and so does its
    single-scattering albedo a little."""
    nb = {"sw": 14, "lw": 16}
    nphob, nphil = 8, 6
    rh = np.array([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.85, 0.9,
                   0.95])
    rh_mid = np.append(0.5 * (rh[:-1] + rh[1:]), 0.975)
    growth = 1.0 + 3.0 * rh_mid ** 4            # (nrh,)
    out = {"relative_humidity1": (("n_rh",), rh)}
    for s, n in nb.items():
        for kind, ntype in (("hydrophobic", nphob), ("hydrophilic", nphil)):
            lo, hi = (2.0, 4.0) if s == "sw" else (2.0, 3.0)
            # log10 extinction per type, falling across the SW bands
            base = rng.uniform(lo, hi, (ntype, 1)) - (
                np.linspace(0.0, 1.0, n)[None, :] if s == "sw" else 0.0)
            ext = 10.0 ** np.clip(base + rng.uniform(-0.1, 0.1, (ntype, n)),
                                  lo, hi)
            ssa = (rng.uniform(0.8, 1.0, (ntype, n)) if s == "sw"
                   else rng.uniform(0.1, 0.6, (ntype, n)))
            g = rng.uniform(0.5, 0.8, (ntype, n))
            dims = (f"n_{kind}", f"band_{s}")
            if kind == "hydrophilic":
                ext = ext[:, None, :] * growth[None, :, None]
                ssa = np.minimum(ssa[:, None, :]
                                 + 0.05 * rh_mid[None, :, None], 1.0)
                g = np.repeat(g[:, None, :], len(rh), 1)
                dims = (f"n_{kind}", "n_rh", f"band_{s}")
            out[f"mass_ext_{s}_{kind}"] = (dims, ext)
            out[f"ssa_{s}_{kind}"] = (dims, ssa)
            out[f"asymmetry_{s}_{kind}"] = (dims, g)
    return out


def synthetic_lut_names(liquid: str = "socrates", ice: str = "baran",
                        pdf: str = "gamma") -> dict:
    """The override file names of write_synthetic_luts's tables for one
    liquid model (socrates, slingo), ice model (fu, baran, baran2016,
    baran2017, yi) and PDF shape (gamma, lognormal), and its aerosol
    table."""
    return {"liq_optics_override_file_name":
            f"synthetic_{liquid}_liquid.nc",
            "ice_optics_override_file_name": f"synthetic_{ice}_ice.nc",
            "cloud_pdf_override_file_name": f"synthetic_mcica_{pdf}.nc",
            "aerosol_optics_override_file_name": "synthetic_aerosol.nc"}


def slice_columns(cols: Dict[str, np.ndarray], sl: slice
                  ) -> Dict[str, np.ndarray]:
    """The same dict restricted to the columns `sl`."""
    return {k: (v[sl] if isinstance(v, np.ndarray) else v)
            for k, v in cols.items()}


def reverse_levels(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The same columns with the level axis flipped (surface first)."""
    out = dict(cols)
    for k in LEVEL_KEYS:
        if k in cols:
            out[k] = cols[k][:, ::-1].copy()
    return out
