"""PyTorch port: the monochromatic gas and cloud model (one band, one
g-point, no table) against the JAX package, for every solver the JAX
package runs it with, on small cloudy columns (add_effective_sizes(
make_clouds(make_columns(6, 12, 0)))) and, for McICA's cloud-PDF sampler,
the SYNTHETIC LUT files of inputs.write_synthetic_luts; and the analytic
checks of tests/test_solvers_all.py:77-140 (the reference's
driver/test_solver.F90): a transparent atmosphere over a black surface,
and one overcast scattering layer.

Configurations, each with the band profiles and canopy fluxes on (one
band): Cloudless with Planck at 10 um; Homogeneous without LW cloud
scattering; McICA, Tripleclouds and SPARTACUS (3D effects, Explicit
entrapment) with it. Bounds: those of tests/test_torch_spectral.py.
"""
import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.constants import STEFAN_BOLTZMANN
from ecrad_tpu_torch.convert import setup_from_numpy
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_clouds,
                                    make_columns, write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.types import (Cloud, GasConcs, SingleLevel,
                                   Thermodynamics)

import test_torch_spectral as spectral

NCOL, NLEV, SEED = 6, 12, 0
S = pconfig.Solver
MONO = dict(i_gas_model=pconfig.GasModel.MONOCHROMATIC,
            mono_lw_total_od=2.0, mono_sw_total_od=0.5, use_aerosols=False,
            do_save_spectral_flux=True, do_canopy_fluxes_sw=True,
            do_canopy_fluxes_lw=True)
CONFIGS = {
    "cloudless": lambda luts: pconfig.cloudless_slice_config(
        **MONO, mono_lw_wavelength=10e-6),
    "homogeneous": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **MONO, i_solver_sw=S.HOMOGENEOUS,
        i_solver_lw=S.HOMOGENEOUS),
    "mcica": lambda luts: pconfig.mcica_slice_config(**luts, **MONO),
    "tripleclouds": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **MONO, do_lw_cloud_scattering=True),
    "spartacus": lambda luts: pconfig.spartacus_slice_config(
        **luts, **MONO, do_lw_cloud_scattering=True),
}


def columns(name=None):
    return {"toa_first": add_effective_sizes(make_clouds(
        make_columns(NCOL, NLEV, SEED), SEED))}


def jax_results(dtype, luts):
    return spectral.jax_fluxes(dtype, luts, CONFIGS, columns)


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")


@pytest.fixture(scope="module")
def fluxes(luts, tmp_path_factory):
    """(port, jax), each {dtype: {config: {field: array}}}."""
    procs = spectral.start_jax(__name__, luts["directory_name"],
                               tmp_path_factory)
    cols = columns()["toa_first"]
    port = {dtype: {name: spectral.port_run(make(luts), cols, dtype)
                    for name, make in CONFIGS.items()}
            for dtype in ("float32", "float64")}
    jax = spectral.finish_jax(procs)
    return port, {d: {n: v["toa_first"] for n, v in jax[d].items()}
                  for d in jax}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_f64_matches_jax(fluxes, config):
    got, ref = fluxes[0]["float64"][config], fluxes[1]["float64"][config]
    assert set(got) == set(ref)
    assert got["lw_up_band"].shape == (NCOL, NLEV + 1, 1)
    assert got["lw_dn_surf_g"].shape == (NCOL, 1)
    bad = {}
    for k, a in got.items():
        assert a.shape == ref[k].shape, k
        err = np.abs(a - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-300)
        if err > spectral.F64_TOL:
            bad[k] = err
    assert not bad, bad


@pytest.mark.parametrize("config", list(CONFIGS))
def test_f32_matches_jax(fluxes, config):
    got = fluxes[0]["float32"][config]
    j32, j64 = fluxes[1]["float32"][config], fluxes[1]["float64"][config]
    assert set(got) == set(j32)
    bad = {}
    for k, a in got.items():
        assert a.shape == j32[k].shape and np.isfinite(a).all(), k
        err = float(np.abs(a - j32[k]).max())
        b = spectral.f32_bound(k, j32[k], j64[k], mcica=config == "mcica")
        if err > b:
            bad[k] = (err, b)
    assert not bad, bad


def test_clouds_and_gases_change_the_fluxes(fluxes):
    """The cloudy solvers see the clouds; the optical depths absorb."""
    f = fluxes[0]["float64"]
    for name in ("homogeneous", "mcica", "tripleclouds", "spartacus"):
        assert np.abs(f[name]["sw_up"] - f[name]["sw_up_clear"]).max() > 1.0
    assert (f["cloudless"]["lw_up"][:, 0]
            < f["cloudless"]["lw_up"][:, -1]).all()


def _mono_setup(**kw):
    return setup_radiation(pconfig.RadiationConfig(
        i_gas_model=pconfig.GasModel.MONOCHROMATIC,
        i_solver_sw=S.HOMOGENEOUS, i_solver_lw=S.HOMOGENEOUS,
        do_lw_cloud_scattering=False, **kw), device="cpu")


def test_transparent_atmosphere():
    """No gas, no cloud (tests/test_solvers_all.py:77-114): the surface
    receives S0 mu0 and reflects its albedo's share; a black surface at
    288 K sends sigma T^4 up through every level."""
    ncol = 8
    mu0 = np.linspace(0.1, 1.0, ncol)
    sl = SingleLevel(cos_sza=torch.as_tensor(mu0, dtype=torch.float32),
                     skin_temperature=torch.full((ncol,), 288.0),
                     sw_albedo=torch.full((ncol, 1), 0.2),
                     lw_emissivity=torch.full((ncol, 1), 1.0),
                     solar_irradiance=1361.0,
                     iseed=torch.arange(ncol, dtype=torch.int32))
    th = Thermodynamics(
        pressure_hl=torch.tensor([[1.0, 1e5]]).repeat(ncol, 1),
        temperature_hl=torch.full((ncol, 2), 288.0))
    flux = radiation(_mono_setup(mono_sw_total_od=0.0, mono_lw_total_od=0.0),
                     sl, th, GasConcs.create(ncol, 1),
                     Cloud.create_zero(ncol, 1))
    np.testing.assert_allclose(flux.sw_dn[:, -1].numpy(), 1361.0 * mu0,
                               rtol=1e-4)
    np.testing.assert_allclose(flux.sw_up[:, -1].numpy(),
                               0.2 * 1361.0 * mu0, rtol=1e-4)
    np.testing.assert_allclose(flux.lw_up.numpy(),
                               STEFAN_BOLTZMANN * 288.0 ** 4, rtol=1e-4)


def test_overcast_scattering_layer():
    """One overcast liquid layer in the second column
    (tests/test_solvers_all.py:117-140): it reflects much more."""
    ncol, nlev = 2, 3
    sl = SingleLevel(cos_sza=torch.full((ncol,), 0.7),
                     skin_temperature=torch.full((ncol,), 288.0),
                     sw_albedo=torch.full((ncol, 1), 0.05),
                     lw_emissivity=torch.full((ncol, 1), 1.0),
                     solar_irradiance=1361.0,
                     iseed=torch.arange(ncol, dtype=torch.int32))
    th = Thermodynamics(
        pressure_hl=torch.tensor([[1.0, 3e4, 7e4, 1e5]]).repeat(ncol, 1),
        temperature_hl=torch.full((ncol, 4), 275.0))
    cloud = Cloud.create_zero(ncol, nlev)
    fraction, q_liq = cloud.fraction.clone(), cloud.q_liq.clone()
    fraction[1, 1], q_liq[1, 1] = 1.0, 2e-4
    cloud = cloud.replace(fraction=fraction, q_liq=q_liq,
                          fractional_std=torch.zeros((ncol, nlev)),
                          overlap_param=torch.full((ncol, nlev - 1), 0.9))
    flux = radiation(_mono_setup(), sl, th, GasConcs.create(ncol, nlev),
                     cloud)
    up = flux.sw_up[:, 0].numpy()
    assert up[1] > up[0] + 10.0


def test_setup_from_numpy_takes_a_monochromatic_setup(luts):
    """A JAX monochromatic setup (no tables, the one-g spec and interval
    maps) crosses over and equals the port's own."""
    from ecrad_tpu.interface import setup_radiation as jax_setup
    golden = spectral.golden_tool()
    cfg = CONFIGS["mcica"](luts)
    js = jax_setup(golden.jax_config(cfg, "float32"))
    got = setup_from_numpy(cfg, js.tables, js.spec, js.sw_albedo_map,
                           js.sw_albedo_weights, js.lw_emiss_map,
                           js.lw_emiss_weights, device="cpu",
                           pdf_sampler=js.pdf_sampler)
    ref = setup_radiation(cfg, device="cpu")
    assert got.tables == {} and got.gas is None and ref.gas is None
    for name in ref.spec._fields:
        np.testing.assert_array_equal(getattr(got.spec, name),
                                      getattr(ref.spec, name), err_msg=name)
    for name in ("sw_albedo_map", "sw_albedo_weights", "lw_emiss_map",
                 "lw_emiss_weights"):
        x, y = getattr(got, name), getattr(ref, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    cols = columns()["toa_first"]
    from ecrad_tpu_torch.convert import columns_to_inputs
    a, b = (radiation(s, *columns_to_inputs(cols, device="cpu"))
            for s in (got, ref))
    for (k, x), (_, y) in zip(a.fields(), b.fields()):
        assert torch.equal(x, y), k


def test_monochromatic_setup_reads_no_table(monkeypatch, luts):
    from ecrad_tpu_torch import interface
    monkeypatch.setattr(interface, "load_tables", None)
    monkeypatch.setattr(interface, "setup_cloud_optics", None)
    setup = setup_radiation(CONFIGS["tripleclouds"](luts), device="cpu")
    assert setup.cloud_optics is None and setup.aerosol_optics is None
