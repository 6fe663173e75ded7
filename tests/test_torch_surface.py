"""PyTorch port: the tiled surface and canopy scheme (surface/) against the
JAX package, on surfaces of inputs.make_surface (6 columns, built as
tests/test_surface.py:38-61 builds them; the reference's mls_* surface
files are absent):

- facet_region_indices and print_surface_representation for the
  representations (1,) mls_flat, (1, 2) mls_forest, (1, 2, 3)
  mls_london1 and (3,);
- read_surface on files of inputs.write_surface, array by array, also
  with building_scale in place of the perimeter and with one-band (2-D)
  albedos and emissivities; save_surface_fluxes, variable by variable;
- calc_boundary_conditions (every BoundaryConditions and
  SurfaceIntermediate field) and partition_fluxes (on seeded canopy-top
  and broadband fluxes, a pure function of them) on Cloudless setups
  (no LUTs): each representation with broadband and full-spectrum SW and
  LW, with and without the lowest level's extinction in the canopies,
  cos_sza 0, 0.1, 0.5 and 1 among the columns, and a tall street canyon
  (height to width 180) where -log(sqrt(hw^2 + 1) - hw) cancels;
- the JAX package's limit tests (tests/test_surface.py:82-135) on the
  port alone: a flat tile is the simple surface, the vegetation limits,
  the urban bounds.

The JAX runs go to two side-by-side processes, float32 and float64, run
eagerly (tests/test_torch_spectral.start_jax). Bounds: float64 within
1e-10 of each field's largest magnitude; float32 within 1e-5 of it, or
twice the JAX package's own float32 error (its distance from its
float64 value) where that is larger: the vegetation canopy goes through
sw_reftrans, whose float32 cells near k mu0 = 1 the port takes from
float64 (two_stream.RESONANCE_WINDOW) and the JAX package does not.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import columns_to_inputs, surface_from_numpy
from ecrad_tpu_torch.inputs import make_columns, make_surface, write_surface
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.io.netcdf import NetcdfFile
from ecrad_tpu_torch.io.output import save_inputs, save_surface_fluxes
from ecrad_tpu_torch.surface import (SurfaceFlux, calc_boundary_conditions,
                                     partition_fluxes, read_surface)
from ecrad_tpu_torch.surface.properties import (
    ITileFlat, ITileUrban3D, ITileVegetation, facet_region_indices,
    print_surface_representation)
from test_torch_spectral import finish_jax, start_jax

NCOL, SEED = 6, 0
F64_TOL, F32_TOL = 1e-10, 1e-5
COS_SZA = np.array([0.0, 0.1, 0.5, 1.0, 0.3, 0.8])
REPRESENTATIONS = {"flat": (1,), "forest": (1, 2), "london": (1, 2, 3),
                   "urban": (3,)}
# name: (representation, full-spectrum SW, full-spectrum LW, lowest-level
# LW extinction, lowest-level SW extinction, tall canyon)
CASES = {
    "flat_broad": ("flat", False, False, False, False, False),
    "flat_full": ("flat", True, True, False, False, False),
    "forest_broad": ("forest", False, False, False, False, False),
    "forest_full_ext": ("forest", True, True, True, False, False),
    "london_broad": ("london", False, False, False, False, False),
    "london_full": ("london", True, True, False, False, False),
    "london_full_ext": ("london", True, True, True, False, False),
    "london_swfull_lwbroad": ("london", True, False, False, False, False),
    "london_swbroad_lwfull_ext": ("london", False, True, True, False,
                                  False),
    "urban_broad": ("urban", False, False, False, False, False),
    "urban_full_ext_sw": ("urban", True, True, True, True, False),
    "london_tall_canyon": ("london", True, True, True, False, True),
}
FLUX_FIELDS = ("lw_dn_facet", "lw_up_facet", "lw_abs_canopy", "sw_dn_facet",
               "sw_dn_direct_facet", "sw_up_facet", "sw_abs_canopy")


def case_config(name):
    _, sw_full, lw_full, *_ = CASES[name]
    return pconfig.cloudless_slice_config(
        do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True,
        use_canopy_full_spectrum_sw=sw_full,
        use_canopy_full_spectrum_lw=lw_full)


def case_inputs(name):
    """numpy inputs of a case: the surface (make_surface; one emissivity
    interval for a broadband LW canopy), cos_sza, the lowest level's
    extinction properties (or None) and the canopy-top and broadband
    fluxes that partition_fluxes takes."""
    rep, sw_full, lw_full, ext_lw, ext_sw, tall = CASES[name]
    n_sw, n_lw = (112 if sw_full else 6), (140 if lw_full else 1)
    surf = make_surface(NCOL, REPRESENTATIONS[rep], SEED,
                        nem=3 if lw_full else 1)
    if tall:
        # column 2: 300 m deep, perimeter 0.6, half built: h/w = 180
        urban = surf["representation"].index(ITileUrban3D)
        surf["canopy_depth"][2, urban] = 300.0
        surf["building_normalized_perimeter"][2, urban] = 0.6
        surf["building_fraction"][2, urban] = 0.5
    rng = np.random.RandomState(SEED + 11)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)     # noqa: E731
    air = {"ext_lw_air": u(1e-5, 5e-3, NCOL, n_lw) if ext_lw else None,
           "ext_sw_air": u(1e-6, 1e-3, NCOL, n_sw) if ext_sw else None,
           "ssa_sw_air": u(0.3, 1.0, NCOL, n_sw) if ext_sw else None,
           "g_sw_air": u(0.0, 0.3, NCOL, n_sw) if ext_sw else None}
    day = np.maximum(COS_SZA, 0.0)[:, None]
    flux = {"lw_dn_surf_canopy": u(0.0, 800.0 / n_lw, NCOL, n_lw),
            "sw_dn_diffuse_surf_canopy": u(0.0, 400.0 / n_sw, NCOL, n_sw),
            "sw_dn_direct_surf_canopy": day * u(0.0, 1600.0 / n_sw, NCOL,
                                                n_sw)}
    for k, lo, hi in (("lw_dn", 200, 400), ("lw_up", 300, 450),
                      ("sw_dn", 0, 1000), ("sw_up", 0, 300),
                      ("sw_dn_direct", 0, 800)):
        flux[k] = u(lo, hi, NCOL, 3) * (day if k.startswith("sw") else 1.0)
    return surf, COS_SZA, air, flux


def _results(bc, sflux, as_np):
    out = {f"bc/{k}": as_np(getattr(bc, k)) for k in (
        "sw_albedo_diffuse", "sw_albedo_direct", "lw_emissivity",
        "lw_emission")}
    inter = bc.intermediate
    out.update({f"inter/{f.name}": as_np(getattr(inter, f.name))
                for f in dataclasses.fields(inter)
                if getattr(inter, f.name) is not None})
    out.update({f"flux/{k}": as_np(getattr(sflux, k)) for k in FLUX_FIELDS})
    return out


def jax_results(dtype, luts):
    """{"case/kind/field": array} of the JAX package at `dtype`: the
    boundary conditions, the intermediate fields and the partitioned
    fluxes of every case, run eagerly."""
    import jax.numpy as jnp
    from ecrad_tpu.interface import setup_radiation as jsetup_radiation
    from ecrad_tpu.surface import properties as jprops
    from ecrad_tpu.surface.intermediate import (
        calc_boundary_conditions as jcalc, partition_fluxes as jpartition)
    from make_torch_port_golden import jax_config
    dt = getattr(jnp, dtype)
    a = lambda x: None if x is None else jnp.asarray(x, dt)  # noqa: E731
    found, setups = {}, {}
    for name in CASES:
        cfg = case_config(name)
        key = (cfg.use_canopy_full_spectrum_sw,
               cfg.use_canopy_full_spectrum_lw)
        if key not in setups:
            setups[key] = jsetup_radiation(jax_config(cfg, dtype))
        surf, cos_sza, air, flux = case_inputs(name)
        jsurf = jprops.SurfaceDescription(
            **{k: a(v) for k, v in surf.items() if k != "representation"},
            representation=surf["representation"])
        bc = jcalc(setups[key], jsurf, a(cos_sza),
                   **{k: a(v) for k, v in air.items()})
        sflux = jpartition(jsurf, bc.intermediate, types.SimpleNamespace(
            **{k: a(v) for k, v in flux.items()}))
        found.update({f"{name}/{k}": v for k, v in _results(
            bc, sflux, lambda x: np.asarray(x, np.float64)).items()})
    return found


def port_results(name, dtype):
    dt = getattr(torch, dtype)
    cfg = dataclasses.replace(case_config(name), dtype=dtype)
    setup = setup_radiation(cfg, device="cpu")
    surf, cos_sza, air, flux = case_inputs(name)
    t = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
        x, dtype=dt)
    psurf = surface_from_numpy(surf, device="cpu", dtype=dt)
    bc = calc_boundary_conditions(setup, psurf, t(cos_sza),
                                  **{k: t(v) for k, v in air.items()})
    sflux = partition_fluxes(psurf, bc.intermediate, types.SimpleNamespace(
        **{k: t(v) for k, v in flux.items()}))
    res = _results(bc, sflux, lambda x: x.double().numpy())
    out = {}
    for k, v in res.items():
        kind, field = k.split("/")
        out.setdefault(kind, {})[field] = v
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port, jax): {dtype: {case: {kind: {field: array}}}}; the port runs
    while the JAX processes do."""
    procs = start_jax(__name__, "", tmp_path_factory)
    port = {dtype: {name: port_results(name, dtype) for name in CASES}
            for dtype in ("float32", "float64")}
    return port, finish_jax(procs)


@pytest.mark.parametrize("name", list(CASES))
def test_boundary_conditions_and_partition_match_jax(results, name):
    port, jax = results
    bad = {}
    for kind in ("bc", "inter", "flux"):
        j32, j64 = jax["float32"][name][kind], jax["float64"][name][kind]
        p32, p64 = port["float32"][name][kind], port["float64"][name][kind]
        assert set(p32) == set(j32) == set(p64) == set(j64), kind
        for k, ref in j64.items():
            scale = max(np.abs(ref).max(), 1e-300)
            assert p64[k].shape == ref.shape and np.isfinite(p32[k]).all(), k
            e64 = np.abs(p64[k] - ref).max() / scale
            if not e64 <= F64_TOL:
                bad[f"{kind}/{k} f64"] = (e64, F64_TOL)
            own = np.abs(j32[k] - ref).max()
            bound = max(F32_TOL * scale, 2 * own)
            e32 = np.abs(p32[k] - j32[k]).max()
            if not e32 <= bound:
                bad[f"{kind}/{k} f32"] = (e32, bound)
    assert not bad, bad


def test_sun_down_and_tall_canyon_columns_are_finite(results):
    """cos_sza = 0 (column 0) and the tall canyon (column 2) give finite
    fields in both precisions; the canyon's walls see a sky view of
    about 1 / (2 hw), so it is nearly black in the LW."""
    port = results[0]
    for dtype in ("float32", "float64"):
        for name in CASES:
            for kind, fields in port[dtype][name].items():
                for k, v in fields.items():
                    assert np.isfinite(v).all(), (dtype, name, kind, k)
    tall = port["float64"]["london_tall_canyon"]["inter"]
    urban_region = 1
    assert tall["lw_transmittance"][2, urban_region].max() < 0.02


@pytest.mark.parametrize("rep", list(REPRESENTATIONS))
def test_indices_and_representation_text_match_jax(rep):
    from ecrad_tpu.surface import properties as jprops
    reps = REPRESENTATIONS[rep]
    assert facet_region_indices(reps) == jprops.facet_region_indices(reps)
    assert print_surface_representation(reps) \
        == jprops.print_surface_representation(reps)
    with pytest.raises(ValueError, match="not understood"):
        facet_region_indices(reps + (4,))


def _surface_file(path, rep, variant):
    cols = make_columns(NCOL, 8, SEED)
    save_inputs(path, *columns_to_inputs(cols, device="cpu"), None, None)
    one_band = variant == "one_band"
    surf = make_surface(NCOL, REPRESENTATIONS[rep], SEED,
                        nalb=1 if one_band else 6, nem=1 if one_band else 3)
    write_surface(path, surf, building_scale=variant == "building_scale")
    return surf


@pytest.mark.parametrize("variant", ["perimeter", "building_scale",
                                     "one_band"])
@pytest.mark.parametrize("rep", ["forest", "london"])
def test_read_surface_matches_jax(tmp_path, rep, variant):
    from ecrad_tpu.surface import properties as jprops
    path = str(tmp_path / "surface.nc")
    surf = _surface_file(path, rep, variant)
    assert jprops.input_has_tiled_surface(path)
    got = read_surface(path, device="cpu")
    ref = jprops.read_surface(path)
    assert got.representation == ref.representation == surf["representation"]
    assert (got.nfacet, got.nregion, got.ntile, got.nalbedobands,
            got.nemissbands) == (ref.nfacet, ref.nregion, ref.ntile,
                                 ref.nalbedobands, ref.nemissbands)
    for f in dataclasses.fields(got):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "representation":
            continue
        assert (g is None) == (r is None), f.name
        if g is not None:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f.name)
    # the file holds what make_surface made (float32); the perimeter
    # comes back from building_scale to float32 roundoff
    np.testing.assert_allclose(got.building_normalized_perimeter.numpy(),
                               surf["building_normalized_perimeter"],
                               rtol=1e-6)
    with NetcdfFile(path) as f:
        assert f.exists("building_scale") == (variant == "building_scale")
        assert f.read("sw_albedo").ndim == (2 if variant == "one_band"
                                            else 3)


def test_save_surface_fluxes_matches_jax(tmp_path):
    from ecrad_tpu.io.output import save_surface_fluxes as jsave
    from ecrad_tpu.surface import SurfaceFlux as JSurfaceFlux
    rng = np.random.RandomState(SEED)
    values = {k: rng.uniform(0, 500, (NCOL, 3 if "canopy" in k else 5))
              for k in FLUX_FIELDS}
    save_surface_fluxes(str(tmp_path / "port.nc"), SurfaceFlux(
        **{k: torch.as_tensor(v) for k, v in values.items()}))
    jsave(str(tmp_path / "jax.nc"), JSurfaceFlux(**values))
    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "port.nc"), mmap=False) as p, \
            netcdf_file(str(tmp_path / "jax.nc"), mmap=False) as j:
        assert dict(p.dimensions) == dict(j.dimensions)
        assert set(p.variables) == set(j.variables) == {
            "flux_dn_lw_facet", "flux_up_lw_facet", "absorption_lw_canopy",
            "flux_dn_sw_facet", "flux_dn_direct_sw_facet",
            "flux_up_sw_facet", "absorption_sw_canopy"}
        for k, v in j.variables.items():
            w = p.variables[k]
            assert w.dimensions == v.dimensions, k
            assert w.units == v.units and w.long_name == v.long_name, k
            np.testing.assert_array_equal(w[...], v[...], err_msg=k)


# ---- the JAX package's limit tests, on the port alone ----

@pytest.fixture(scope="module")
def setup_full_lw():
    """The JAX test's configuration (its default albedo and emissivity
    intervals) with the Cloudless solvers, which need no LUT."""
    return setup_radiation(pconfig.RadiationConfig(
        i_solver_sw=pconfig.Solver.CLOUDLESS,
        i_solver_lw=pconfig.Solver.CLOUDLESS, use_aerosols=False,
        do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True,
        use_canopy_full_spectrum_lw=True), device="cpu")


def _surface(reps, ncol, seed=0):
    """tests/test_surface.py:38-61's surface: one albedo and emissivity
    interval, 12 m canopies at 290 K, 40 % built, perimeter 0.1,
    vegetation optical depth 3."""
    surf = make_surface(ncol, reps, seed, nalb=1, nem=1)
    ntile = len(reps)
    for k, v in (("canopy_depth", 12.0), ("canopy_temperature", 290.0),
                 ("building_fraction", 0.4),
                 ("building_normalized_perimeter", 0.1),
                 ("vegetation_optical_depth", 3.0)):
        surf[k] = np.full((ncol, ntile), v)
    surf["vegetation_sw_albedo"] = np.full((ncol, ntile, 1), 0.15)
    surf["vegetation_lw_emissivity"] = np.full((ncol, ntile, 1), 0.98)
    del surf["sw_albedo_direct"]
    return surface_from_numpy(surf, device="cpu")


def test_flat_tile_reduces_to_simple(setup_full_lw):
    """A tile fraction of 1 on the flat tile gives the facet's albedo,
    and an emission of its emissivity times sigma T^4."""
    surf = _surface((ITileFlat, ITileVegetation), 3)
    surf = surf.replace(tile_fraction=torch.tensor([[1.0, 0.0]] * 3))
    bc = calc_boundary_conditions(setup_full_lw, surf, torch.full((3,), 0.5))
    np.testing.assert_allclose(bc.sw_albedo_diffuse.numpy(),
                               surf.sw_albedo[:, 0, :].numpy(), rtol=1e-6)
    em = bc.lw_emission.sum(-1).numpy()
    t0 = surf.skin_temperature[:, 0].double().numpy()
    expected = surf.lw_emissivity[:, 0, 0].numpy() * 5.670374419e-8 * t0 ** 4
    np.testing.assert_allclose(em, expected, rtol=0.01)


def test_vegetation_limits(setup_full_lw):
    """A transparent canopy shows the ground's albedo; a thick one hides
    the ground, its albedo set by the canopy's scattering alone."""
    surf = _surface((ITileVegetation,), 2)
    mu0 = torch.full((2,), 0.6)
    thin = surf.replace(vegetation_optical_depth=torch.full((2, 1), 1e-6))
    bc = calc_boundary_conditions(setup_full_lw, thin, mu0)
    np.testing.assert_allclose(bc.sw_albedo_diffuse.numpy(),
                               surf.sw_albedo[:, 0, :].numpy(), atol=1e-4)
    thick = surf.replace(vegetation_optical_depth=torch.full((2, 1), 50.0))
    alb = calc_boundary_conditions(setup_full_lw, thick,
                                   mu0).sw_albedo_diffuse.numpy()
    assert np.all(alb < surf.sw_albedo[:, 0, :].numpy() + 0.05)
    assert np.all(alb >= 0.0) and np.all(alb <= 1.0)


def test_urban_bc_bounds(setup_full_lw):
    """An urban tile's effective albedos and emissivity are finite and in
    [0, 1], and the canyon traps radiation: the effective albedo is below
    the facets' mean albedo."""
    surf = _surface((ITileUrban3D,), 3, seed=1)
    bc = calc_boundary_conditions(setup_full_lw, surf,
                                  torch.tensor([0.1, 0.5, 0.9]))
    for arr in (bc.sw_albedo_diffuse, bc.sw_albedo_direct, bc.lw_emissivity):
        a = arr.numpy()
        assert np.isfinite(a).all() and (a >= 0.0).all() and (a <= 1.0).all()
    assert bc.sw_albedo_diffuse.mean() < surf.sw_albedo.mean() + 1e-6


def test_broadband_lw_refuses_several_emissivity_bands():
    setup = setup_radiation(pconfig.cloudless_slice_config(), device="cpu")
    surf = surface_from_numpy(make_surface(2, (1, 2), 0, nem=3),
                              device="cpu")
    with pytest.raises(ValueError, match="one emissivity band"):
        calc_boundary_conditions(setup, surf, torch.full((2,), 0.5))


def test_read_surface_defaults_to_the_gpu(tmp_path):
    path = str(tmp_path / "surface.nc")
    _surface_file(path, "flat", "perimeter")
    if torch.cuda.is_available():
        assert read_surface(path).skin_temperature.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            read_surface(path)
