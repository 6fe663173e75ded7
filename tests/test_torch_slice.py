"""PyTorch port: the whole Cloudless slice, its setup, configuration and
state conversion, against the JAX package at float32.

Bound for every flux field: the JAX package's cross-program bound
(__graft_entry__.py: |diff| <= 1e-5 of max(|field|, 1 W/m2)), unless
JAX's own float32 error is larger. In this slice the thin, purely
scattering SW layers aloft make float32 two-stream terms ill-conditioned
(tests/test_torch_adding.py), so a per-g surface SW field can move by
2e-5 of its range between two correct float32 programs while each sits
6e-5 from the exact value. The exact value is the port at float64, which
tests/test_torch_f64.py holds to the JAX package at float64. So:
    |port - jax| <= max(1e-5 * max(|exact|, 1), 2 |jax - exact|).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from ecrad_tpu import config as jconfig
from ecrad_tpu import interface as jinterface
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import (columns_to_inputs, inputs_from_numpy,
                                     setup_from_numpy)
from ecrad_tpu_torch.inputs import (make_columns, reverse_levels,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.types import LEVEL_FLUX_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 20, 0


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fluxes():
    """{orientation: (port f32, JAX f32, port f64)} as numpy dicts."""
    cols = make_columns(NCOL, NLEV, SEED)
    sets = {"toa_first": cols, "surface_first": reverse_levels(cols)}
    jax32 = _golden_tool().jax_fluxes("float32", *sets.values(),
                                      fields=None)
    out = {}
    for (orient, c), j in zip(sets.items(), jax32):
        port = {}
        for dtype in ("float32", "float64"):
            setup = setup_radiation(
                pconfig.cloudless_slice_config(dtype=dtype), device="cpu")
            flux = radiation(setup, *columns_to_inputs(
                c, device="cpu", dtype=getattr(torch, dtype)))
            port[dtype] = {k: v.numpy() for k, v in flux.fields()}
        out[orient] = (port["float32"], j, port["float64"])
    return out


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
def test_slice_f32_matches_jax(fluxes, orient):
    port, jax32, exact = fluxes[orient]
    assert set(port) == set(jax32)
    bad = {}
    for k, a in port.items():
        b, e = jax32[k], exact[k]
        assert a.dtype == np.float32 and a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        bound = max(1e-5 * max(np.abs(e).max(), 1.0),
                    2 * np.abs(b - e).max())
        if np.abs(a - b).max() > bound:
            bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad


def test_reversed_orientation_is_the_flipped_run(fluxes):
    """Flipping the inputs and the level fluxes is exact in the port."""
    fwd, rev = fluxes["toa_first"][0], fluxes["surface_first"][0]
    for k, v in fwd.items():
        w = rev[k][:, ::-1] if k in LEVEL_FLUX_FIELDS else rev[k]
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_level_flux_fields_are_the_jax_packages():
    assert set(LEVEL_FLUX_FIELDS) <= set(jinterface._LEVEL_FLUX_FIELDS)
    assert set(jinterface._LEVEL_FLUX_FIELDS) - set(LEVEL_FLUX_FIELDS) \
        <= {n for n in jinterface._LEVEL_FLUX_FIELDS
            if n.endswith(("_band", "_band_clear")) or "derivatives" in n}


# ---- setup and conversion ----

def _jax_setup(**kw):
    return jinterface.setup_radiation(jconfig.RadiationConfig(
        i_solver_sw=jconfig.Solver.CLOUDLESS,
        i_solver_lw=jconfig.Solver.CLOUDLESS,
        **{**pconfig.SLICE_OPTIONS, **kw}))


def _assert_setups_equal(a, b):
    assert a.config == b.config and a.dtype == b.dtype
    assert set(a.tables) == set(b.tables)
    for k in a.tables:
        np.testing.assert_array_equal(a.tables[k], b.tables[k], err_msg=k)
    for x, y in zip(a.spec, b.spec):
        np.testing.assert_array_equal(x, y)
    for name in ("sw_albedo_map", "sw_albedo_weights", "lw_emiss_map",
                 "lw_emiss_weights"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    for tabs in ("lw", "sw"):
        x, y = getattr(a.gas, tabs), getattr(b.gas, tabs)
        for f in ("tab", "meta", "consts"):
            assert torch.equal(getattr(x, f), getattr(y, f)), (tabs, f)
    assert torch.equal(a.gas.totplnk, b.gas.totplnk)
    assert torch.equal(a.gas.delwave, b.gas.delwave)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_setup_from_numpy_equals_setup_radiation(dtype):
    js = _jax_setup(dtype=dtype)
    cfg = pconfig.cloudless_slice_config(dtype=dtype)
    got = setup_from_numpy(cfg, js.tables, js.spec, js.sw_albedo_map,
                           js.sw_albedo_weights, js.lw_emiss_map,
                           js.lw_emiss_weights, device="cpu")
    _assert_setups_equal(got, setup_radiation(cfg, device="cpu"))


@pytest.mark.parametrize("nearest", [True, False])
def test_interval_mappings_match_jax(nearest):
    """Both albedo mapping modes (index map and overlap weights)."""
    kw = dict(do_nearest_spectral_sw_albedo=nearest,
              do_nearest_spectral_lw_emiss=nearest)
    js = _jax_setup(**kw)
    ps = setup_radiation(pconfig.cloudless_slice_config(**kw), device="cpu")
    for name in ("sw_albedo_map", "sw_albedo_weights", "lw_emiss_map",
                 "lw_emiss_weights"):
        x, y = getattr(ps, name), getattr(js, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_allclose(x, y, rtol=1e-12, err_msg=name)


def test_inputs_from_numpy_round_trip():
    cols = make_columns(3, 7, 1)
    sl, th, gas, cloud, aer = inputs_from_numpy(
        {"cos_sza": cols["cos_sza"], "skin_temperature":
         cols["skin_temperature"], "sw_albedo": cols["sw_albedo"],
         "lw_emissivity": cols["lw_emissivity"], "solar_irradiance": 1361.0,
         "iseed": np.arange(3, dtype=np.int32), "unknown": 1},
        {"pressure_hl": cols["pressure_hl"],
         "temperature_hl": cols["temperature_hl"]},
        {"mixing_ratio": cols["mixing_ratio"]}, None,
        {"mixing_ratio": np.zeros((3, 7, 2))}, device="cpu",
        dtype=torch.float64)
    assert sl.solar_irradiance == 1361.0 and sl.iseed.dtype == torch.int32
    assert th.pressure_hl.dtype == torch.float64 and cloud is None
    np.testing.assert_array_equal(gas.mixing_ratio.numpy(),
                                  cols["mixing_ratio"])
    assert aer.mixing_ratio.shape == (3, 7, 2)


# ---- configuration ----

# the settings the port refused (NotImplementedError) until it ported
# them, with the flux fields each adds on the Cloudless slice's columns
# (do_save_gpoint_flux alone adds none: it acts with do_save_spectral_flux)
ONCE_REFUSED = [
    (dict(i_solver_sw=pconfig.Solver.SPARTACUS,
          do_print_entrapment_data=True), ()),
    (dict(i_solver_lw=pconfig.Solver.SPARTACUS,
          do_print_entrapment_data=True), ()),
    (dict(do_save_gpoint_flux=True), ()),
    (dict(do_canopy_fluxes_lw=True), ("lw_dn_surf_canopy",)),
    (dict(use_canopy_full_spectrum_lw=True), ()),
    (dict(do_save_spectral_flux=True), (
        "lw_up_band", "lw_dn_band", "sw_up_band", "sw_dn_band",
        "sw_dn_direct_band", "lw_up_band_clear", "sw_dn_band_clear")),
    (dict(do_canopy_fluxes_sw=True), ("sw_dn_diffuse_surf_canopy",
                                      "sw_dn_direct_surf_canopy")),
    (dict(use_spectral_solar_scaling=True), ()),
    (dict(i_gas_model=pconfig.GasModel.MONOCHROMATIC), ()),
]
REFUSED_CONFIGS = {
    f"case{i}": (lambda luts, o=o: pconfig.cloudless_slice_config(**luts,
                                                                  **o))
    for i, (o, _) in enumerate(ONCE_REFUSED)}


def refused_columns(name=None):
    # 12 levels: the shape of the other modules' JAX runs, whose compiled
    # operations these share
    cols = make_columns(NCOL, 12, SEED)
    cols["spectral_solar_scaling"] = np.linspace(1.3, 0.7, 14)
    return {"toa_first": cols}


def jax_results(dtype, luts):
    import test_torch_spectral as spectral
    return spectral.jax_fluxes(dtype, luts, REFUSED_CONFIGS,
                               refused_columns)


@pytest.fixture(scope="module")
def once_refused(tmp_path_factory):
    """{case: (port f32, JAX f32, port f64)}: each setting of
    ONCE_REFUSED on the Cloudless slice configuration (with the synthetic
    LUTs SPARTACUS's setup reads) and columns with a solar scaling."""
    import test_torch_spectral as spectral
    luts = write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")
    procs = spectral.start_jax(__name__, luts["directory_name"],
                               tmp_path_factory, dtypes=("float32",))
    cols = refused_columns()["toa_first"]
    port = {name: [spectral.port_run(make(luts), cols, dtype)
                   for dtype in ("float32", "float64")]
            for name, make in REFUSED_CONFIGS.items()}
    jax = spectral.finish_jax(procs)["float32"]
    return {name: (p32, jax[name]["toa_first"], p64)
            for name, (p32, p64) in port.items()}


@pytest.mark.parametrize("overrides, fields", ONCE_REFUSED)
def test_unported_settings_raise(once_refused, overrides, fields):
    """Every setting the port refused until it ported it runs, adds its
    fields, and matches the JAX package under the slice's float32 bound
    (the module docstring)."""
    case = f"case{[o for o, _ in ONCE_REFUSED].index(overrides)}"
    port, jax32, exact = once_refused[case]
    assert set(port) == set(jax32) and set(fields) <= set(port)
    bad = {}
    for k, a in port.items():
        b, e = jax32[k], exact[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        bound = max(1e-5 * max(np.abs(e).max(), 1.0),
                    2 * np.abs(b - e).max())
        if np.abs(a - b).max() > bound:
            bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad


NAMELIST = """
&radiation
  do_sw = true, do_lw = .true., do_clear = T,
  sw_solver_name = "Cloudless", lw_solver_name = 'Cloudless',
  gas_model_name = "RRTMG-IFS", use_aerosols = false,
  do_nearest_spectral_sw_albedo = false,
  sw_albedo_wavelength_bound(1:5) = 0.25e-6, 0.44e-6, 0.69e-6, 1.19e-6,
      2.38e-6,
  i_sw_albedo_index(1:6) = 1, 2, 3, 4, 5, 6,
  lw_emiss_wavelength_bound = 8.0e-6, 13.0e-6,
  i_lw_emiss_index = 1, 2, 1,  ! nearest interval
  min_gas_od_lw = 1.0d-15, directory_name = "data",
/
"""


def test_namelist_reads_as_in_the_jax_package():
    a = pconfig.load_config_from_namelist(NAMELIST)
    b = jconfig.load_config_from_namelist(NAMELIST)
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.i_solver_sw == pconfig.Solver.CLOUDLESS
    assert a.i_sw_albedo_index == (1, 2, 3, 4, 5, 6)
    setup_radiation(a, device="cpu")   # the slice accepts its namelist


# ---- flux assembly switches (port only; the field sets follow
# ecrad_tpu/interface.py _radiation_oriented) ----

@pytest.mark.parametrize("overrides, absent", [
    (dict(do_clear=False), {"lw_up_clear", "lw_dn_clear", "sw_up_clear",
                            "sw_dn_clear", "sw_dn_direct_clear",
                            "lw_dn_surf_clear_band", "sw_dn_surf_clear_band",
                            "sw_dn_direct_surf_clear_band"}),
    (dict(do_sw_direct=False), {"sw_dn_direct", "sw_dn_direct_clear"}),
    (dict(do_surface_sw_spectral_flux=False),
     {"sw_dn_surf_band", "sw_dn_direct_surf_band", "sw_dn_surf_clear_band",
      "sw_dn_direct_surf_clear_band"}),
    (dict(do_lw=False), {"lw_up", "lw_dn", "lw_up_clear", "lw_dn_clear",
                         "lw_dn_surf_band", "lw_dn_surf_clear_band",
                         "lw_dn_surf_g"}),
    (dict(do_sw=False), {"sw_up", "sw_dn", "sw_dn_direct", "sw_up_clear",
                         "sw_dn_clear", "sw_dn_direct_clear",
                         "sw_dn_surf_band", "sw_dn_direct_surf_band",
                         "sw_dn_surf_clear_band",
                         "sw_dn_direct_surf_clear_band",
                         "sw_dn_diffuse_surf_g", "sw_dn_direct_surf_g"}),
])
def test_output_switches_drop_their_fields(fluxes, overrides, absent):
    full = fluxes["toa_first"][0]
    flux = radiation(setup_radiation(pconfig.cloudless_slice_config(
        **overrides), device="cpu"), *columns_to_inputs(
            make_columns(NCOL, NLEV, SEED), device="cpu"))
    got = dict(flux.fields())
    assert set(got) == set(full) - absent
    for k, v in got.items():      # the rest is unchanged
        np.testing.assert_array_equal(v.numpy(), full[k], err_msg=k)


def test_supplied_surface_emission_overrides_planck():
    """A tiled surface's lw_emission replaces Planck(Tskin) x (1 -
    albedo): given per g it is used as is, given per emissivity interval
    it is mapped to g like the emissivity."""
    cols = make_columns(NCOL, NLEV, SEED)
    setup = setup_radiation(pconfig.cloudless_slice_config(), device="cpu")
    sl, th, gas = columns_to_inputs(cols, device="cpu")
    base = radiation(setup, sl, th, gas)
    per_interval = torch.tensor([[100.0, 20.0, 5.0]]).repeat(NCOL, 1)
    per_g = per_interval[:, setup.lw_emiss_map[setup.spec.band_from_g_lw]]
    a = radiation(setup, sl.replace(lw_emission=per_interval), th, gas)
    b = radiation(setup, sl.replace(lw_emission=per_g), th, gas)
    for k, v in a.fields():
        np.testing.assert_array_equal(v.numpy(), getattr(b, k).numpy(),
                                      err_msg=k)
    # only LW upward fluxes change; at the surface they are emission +
    # albedo x downward flux, per g
    assert not torch.equal(a.lw_up, base.lw_up)
    torch.testing.assert_close(a.lw_dn, base.lw_dn, rtol=0, atol=0)
    torch.testing.assert_close(a.sw_up, base.sw_up, rtol=0, atol=0)
    albedo = 1.0 - sl.lw_emissivity[
        :, setup.lw_emiss_map[setup.spec.band_from_g_lw]]
    torch.testing.assert_close(
        a.lw_up[:, -1], (per_g + albedo * a.lw_dn_surf_g).sum(1),
        rtol=1e-6, atol=0)
