"""PyTorch port: the offline driver (`python -m ecrad_tpu_torch.driver`)
and its NetCDF input and output against the JAX package's driver.

One 6 x 20 input file (make_clouds on make_columns, written by the port's
save_inputs) goes through the JAX driver (`python -m ecrad_tpu.driver ...
--no-jit`, one process per configuration, side by side) and through the
port's driver on the CPU, for a Cloudless and a McICA namelist (the
SYNTHETIC LUTs of write_synthetic_luts), the port with the all-band gas
optics and with ECRAD_FUSED_TAUMOL=0 (the per-band path). The output
files are compared variable by variable at the float32 parity bounds of
tests/test_torch_slice.py and test_torch_mcica_slice.py:
  - clear-sky (and every Cloudless) field:
    |port - jax| <= max(1e-5 max(|exact|, 1), 2 |jax - exact|), the exact
    value the port's driver at float64;
  - McICA total-sky fields: the JAX package's float32 contract for a
    deterministic solver, 0.02 W/m2 (LW) and 0.30 W/m2 (SW), both
    drawing the same subcolumns; cloud covers 2e-6.
Besides: column blocks, height-increasing input, istartcol/iendcol, the
bounds checks, the input round trip, the aerosol layout (a fault of the
JAX package pinned here, ROADMAP.md Queue C), HDF5 output and the refusal
of a tiled surface.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.io import input_reader as jreader
from ecrad_tpu.io import output as joutput
from ecrad_tpu.types import Aerosol as JAerosol
from ecrad_tpu.utils import checks as jchecks
from ecrad_tpu_torch import driver
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    reverse_levels, write_synthetic_luts)
from ecrad_tpu_torch.io import input_reader, output
from ecrad_tpu_torch.io.netcdf import NetcdfFile, write_netcdf
from ecrad_tpu_torch.types import Aerosol
from ecrad_tpu_torch.utils import checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 20, 0
NAMELIST = """&radiation
 sw_solver_name = "{solver}",
 lw_solver_name = "{solver}",
 overlap_scheme_name = "Exp-Exp",
 use_aerosols = false,
 do_nearest_spectral_sw_albedo = false,
 sw_albedo_wavelength_bound(1:5) = 0.25e-6, 0.44e-6, 0.69e-6, 1.19e-6, 2.38e-6,
 i_sw_albedo_index(1:6) = 1, 2, 3, 4, 5, 6,
 do_nearest_spectral_lw_emiss = true,
 lw_emiss_wavelength_bound(1:2) = 8.0e-6, 13.0e-6,
 i_lw_emiss_index(1:3) = 1, 2, 1,
{radiation}/
&radiation_driver
 iverbose = 0,
 do_parallel = false,
{driver}/
"""
SOLVERS = {"cloudless": "Cloudless", "mcica": "McICA"}


def _namelist(path, config, luts, radiation="", driver_opts=""):
    """Write a namelist for `config` (the port's slice options, the
    synthetic LUT files) plus extra &radiation / &radiation_driver
    lines; returns its path."""
    lines = "".join(f' {k} = "{v}",\n' if isinstance(v, str)
                    else f" {k} = {v},\n" for k, v in luts.items())
    with open(path, "w") as f:
        f.write(NAMELIST.format(solver=SOLVERS[config],
                                radiation=lines + radiation,
                                driver=driver_opts))
    return str(path)


def _read_all(path):
    with NetcdfFile(path) as f:
        return {v: f.read(v) for v in f.variables()}


def _rewrite(src, dst, changes):
    """Copy NetCDF file src to dst with variables added or replaced:
    changes maps a name to (dimension names, array)."""
    from scipy.io import netcdf_file
    with netcdf_file(src, "r", mmap=False) as f:
        dims = dict(f.dimensions)
        nc_vars = {k: (v.dimensions, v[...].copy())
                   for k, v in f.variables.items()}
    nc_vars.update(changes)
    for vdims, data in changes.values():
        for dname, n in zip(vdims, np.shape(data)):
            dims.setdefault(dname, n)
    write_netcdf(dst, dims, nc_vars)
    return dst


def _run(*args):
    assert driver.main([*map(str, args), "--device", "cpu"]) == 0
    return _read_all(args[2])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The input file, namelists, the JAX driver's outputs and the port's
    float64 outputs."""
    d = tmp_path_factory.mktemp("driver")
    luts = write_synthetic_luts(str(d / "luts"), SEED)
    cols = make_clouds(make_columns(NCOL, NLEV, SEED), SEED)
    inp = str(d / "in.nc")
    output.save_inputs(inp, *columns_to_inputs(cols, device="cpu"), None)
    nam = {c: _namelist(d / f"{c}.nam", c, luts) for c in SOLVERS}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.pop("ECRAD_FUSED_TAUMOL", None)
    procs = {c: subprocess.Popen(
        [sys.executable, "-m", "ecrad_tpu.driver", nam[c], inp,
         str(d / f"jax_{c}.nc"), "--no-jit"], cwd=str(d), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in SOLVERS}
    exact = {c: _run(_namelist(d / f"{c}64.nam", c, luts,
                               radiation=' dtype = "float64",\n'),
                     inp, d / f"port64_{c}.nc") for c in SOLVERS}
    jax = {}
    for c, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, out[-2000:] + err[-4000:]
        jax[c] = _read_all(d / f"jax_{c}.nc")
    return dict(dir=d, luts=luts, cols=cols, input=inp, nam=nam, jax=jax,
                exact=exact)


def _bound(var, jax, exact, total_sky):
    if var == "pressure_hl":
        return 0.0
    if var.startswith("cloud_cover"):
        return 2e-6
    if total_sky and "clear" not in var:
        return 0.02 if "_lw" in var else 0.30
    return max(1e-5 * max(np.abs(exact).max(), 1.0),
               2 * np.abs(jax - exact).max())


@pytest.mark.parametrize("taumol", ["all_band", "per_band"])
@pytest.mark.parametrize("config", list(SOLVERS))
def test_driver_matches_jax_driver(case, config, taumol, monkeypatch):
    if taumol == "per_band":
        monkeypatch.setenv("ECRAD_FUSED_TAUMOL", "0")
    else:
        monkeypatch.delenv("ECRAD_FUSED_TAUMOL", raising=False)
    port = _run(case["nam"][config], case["input"],
                case["dir"] / f"port_{config}_{taumol}.nc")
    jax, exact = case["jax"][config], case["exact"][config]
    assert set(port) == set(jax)
    if config == "mcica":
        assert {"cloud_cover_sw", "cloud_cover_lw"} <= set(port)
    bad = {}
    for k, a in port.items():
        b = jax[k]
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        bound = _bound(k, b, exact[k], config == "mcica")
        if np.abs(a - b).max() > bound:
            bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad


def _same_program(got, want):
    """Two runs of the same float32 program on other batch sizes: the
    CPU's vectorised reductions may sum a column in another order, so
    within 1e-6 of each field's largest value (a few float32 ulps)."""
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert np.abs(got[k] - v).max() <= 1e-6 * max(np.abs(v).max(), 1.0), k


@pytest.mark.parametrize("config", list(SOLVERS))
def test_column_blocks_match_the_unblocked_run(case, config):
    """column_block_size 4 on 6 columns: a full block and a padded one."""
    d = case["dir"]
    nam = _namelist(d / f"{config}_blocks.nam", config, case["luts"],
                    driver_opts=" column_block_size = 4,\n")
    _same_program(_run(nam, case["input"], d / f"blocks_{config}.nc"),
                  _run(case["nam"][config], case["input"],
                       d / f"whole_{config}.nc"))


def test_chunk_columns_pads_with_the_last_column_and_crops():
    """Blocks of 4 over 6 columns: the second block is columns 4, 5, 5, 5;
    values without the column axis go to every block as they are; every
    output is concatenated and cropped to 6 columns."""
    from ecrad_tpu_torch.parallel.scaling import chunk_columns
    from ecrad_tpu_torch.types import Flux, Thermodynamics
    seen = []

    def run(th, scale, table):
        seen.append((th.pressure_hl[:, 0].tolist(), scale, table.shape))
        return Flux(lw_up=th.pressure_hl * scale,
                    cloud_cover_sw=th.pressure_hl[:, 0])

    p = torch.arange(6.0)[:, None] + torch.zeros(6, 3)
    out = chunk_columns(run, 4)(Thermodynamics(p, p), 2.0,
                                torch.ones(5, 2))
    assert seen == [([0.0, 1.0, 2.0, 3.0], 2.0, (5, 2)),
                    ([4.0, 5.0, 5.0, 5.0], 2.0, (5, 2))]
    torch.testing.assert_close(out.lw_up, 2.0 * p, rtol=0, atol=0)
    torch.testing.assert_close(out.cloud_cover_sw, torch.arange(6.0),
                               rtol=0, atol=0)
    assert out.sw_up is None


def test_height_increasing_input_gives_the_flipped_output(case):
    """A surface-first file is flipped on reading and its fluxes flipped
    back: the same values as the TOA-first file's, level order reversed."""
    d = case["dir"]
    rev = str(d / "in_reversed.nc")
    output.save_inputs(rev, *columns_to_inputs(reverse_levels(case["cols"]),
                                               device="cpu"), None)
    *_, is_reversed = input_reader.read_input(rev, return_orientation=True,
                                              device="cpu")
    assert is_reversed
    flipped = _run(case["nam"]["mcica"], rev, d / "out_reversed.nc")
    forward = _run(case["nam"]["mcica"], case["input"], d / "out_fwd.nc")
    for k, v in forward.items():
        want = v[:, ::-1] if v.ndim == 2 and v.shape[1] == NLEV + 1 else v
        np.testing.assert_array_equal(flipped[k], want, err_msg=k)


def test_istartcol_iendcol_crop_the_columns(case):
    d = case["dir"]
    nam = _namelist(d / "crop.nam", "mcica", case["luts"],
                    driver_opts=" istartcol = 2,\n iendcol = 5,\n")
    cropped = _run(nam, case["input"], d / "crop.nc")
    whole = _run(case["nam"]["mcica"], case["input"], d / "whole.nc")
    _same_program(cropped, {k: v[1:5] for k, v in whole.items()})


def test_input_checks_and_clamp_match_jax(case):
    """Out-of-range inputs: the same findings, word for word, and the
    same clamped values as the JAX package's, through both readers."""
    d = case["dir"]
    with NetcdfFile(case["input"]) as f:
        skin, alb = f.read("skin_temperature"), f.read("sw_albedo")
        frac, q_ice = f.read("cloud_fraction"), f.read("q_ice")
    skin[2], alb[0, 1], frac[3, 4], q_ice[1, 1] = 450.0, -0.2, 1.5, np.nan
    bad = _rewrite(case["input"], str(d / "in_bad.nc"), {
        "skin_temperature": (("column",), skin),
        "sw_albedo": (("column", "sw_albedo_band"), alb),
        "cloud_fraction": (("column", "level"), frac),
        "q_ice": (("column", "level"), q_ice)})
    port = input_reader.read_input(bad, device="cpu")
    jax = jreader.read_input(bad)
    found = checks.validate_inputs(*port)
    assert found == jchecks.validate_inputs(*jax)
    assert len(found) == 4 and any("non-finite" in m for m in found)
    for p, j in zip(checks.clamp_inputs(*port), jchecks.clamp_inputs(*jax)):
        for name in ("skin_temperature", "sw_albedo", "fraction",
                     "mixing_ratio", "temperature_hl"):
            if hasattr(p, name):
                np.testing.assert_array_equal(
                    getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                    err_msg=name)
    flux = dict(lw_up=torch.full((2, 3), 950.0), sw_dn=torch.zeros(2, 3))
    jflux = {k: jnp.asarray(v.numpy()) for k, v in flux.items()}
    assert checks.validate_fluxes(type("F", (), flux)) \
        == jchecks.validate_fluxes(type("F", (), jflux)) != []


def test_save_inputs_read_input_round_trip(case):
    """save_inputs then read_input gives back the inputs (float32), and
    the JAX reader reads the port's file the same way."""
    sl, th, gas, cloud = columns_to_inputs(case["cols"], device="cpu")
    port = input_reader.read_input(case["input"], device="cpu")
    jax = jreader.read_input(case["input"])
    for orig, got, ref in zip((sl, th, gas, cloud), port, jax):
        for name, value in vars(orig).items():
            if not isinstance(value, torch.Tensor) or name == "iseed":
                continue
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          value.numpy(), err_msg=name)
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
    np.testing.assert_array_equal(port[0].iseed.numpy(),
                                  np.arange(1, NCOL + 1))


def test_aerosol_round_trip_is_transposed_in_both_packages(case):
    """A fault of the JAX package, ported as it is (ROADMAP.md Queue C):
    save_inputs writes aerosol_mmr as (column, level, type), read_input
    takes (column, type, level), so 4 columns x 10 levels x 3 types come
    back as (4, 3, 10)."""
    d = case["dir"]
    cols = make_columns(4, 10, SEED)
    mmr = np.random.RandomState(0).rand(4, 10, 3).astype(np.float32) * 1e-9
    sl, th, gas = columns_to_inputs(cols, device="cpu")
    path = str(d / "aerosol_port.nc")
    output.save_inputs(path, sl, th, gas, None,
                       Aerosol(mixing_ratio=torch.as_tensor(mmr)))
    got = input_reader.read_input(path, device="cpu")[4].mixing_ratio
    assert tuple(got.shape) == (4, 3, 10)
    np.testing.assert_array_equal(got.numpy(), mmr.transpose(0, 2, 1))
    jpath = str(d / "aerosol_jax.nc")
    jsl, jth, jgas, jcloud, _ = jreader.read_input(case["input"])
    joutput.save_inputs(jpath, jsl, jth, jgas, jcloud,
                        JAerosol(mixing_ratio=jnp.asarray(
                            np.random.RandomState(0).rand(NCOL, NLEV, 3)
                            .astype(np.float32) * 1e-9)))
    assert jreader.read_input(jpath)[4].mixing_ratio.shape == (NCOL, 3, NLEV)


def test_aerosol_input_in_the_readers_layout(case):
    """aerosol_mmr stored (column, type, level) reads as (column, level,
    type) in both packages, flipped with the levels of a height-increasing
    file."""
    d = case["dir"]
    mmr = np.random.RandomState(1).rand(NCOL, 3, NLEV).astype(np.float32)
    for name, cols in (("fwd", case["cols"]),
                       ("rev", reverse_levels(case["cols"]))):
        path = str(d / f"aer_{name}.nc")
        output.save_inputs(path, *columns_to_inputs(cols, device="cpu"),
                           None)
        stored = mmr if name == "fwd" else mmr[:, :, ::-1]
        _rewrite(path, path, {"aerosol_mmr": (
            ("column", "aerosol_type", "level"), stored)})
        got = input_reader.read_input(path, device="cpu")[4].mixing_ratio
        np.testing.assert_array_equal(got.numpy(), mmr.transpose(0, 2, 1))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jreader.read_input(path)[4].mixing_ratio))


def test_driver_overrides_match_the_jax_reader(case):
    """The &radiation_driver overrides and scalings as the JAX reader
    applies them."""
    from ecrad_tpu import config as jconfig
    from ecrad_tpu_torch import config as pconfig
    nam = _namelist(case["dir"] / "overrides.nam", "mcica", case["luts"],
                    driver_opts=(
                        " cos_sza_override = 0.5,\n q_liquid_scaling = 2.0,"
                        "\n co2_scaling = 1.5,\n cloud_fraction_override ="
                        " 0.7,\n fractional_std = 0.9,\n"
                        " overlap_decorr_length = 1500.0,\n"
                        " sw_albedo_override = 0.2,\n"
                        " solar_irradiance_override = 1361.0,\n"))
    port = input_reader.read_input(
        case["input"], pconfig.load_driver_config_from_namelist(nam),
        device="cpu")
    jax = jreader.read_input(case["input"],
                             jconfig.load_driver_config_from_namelist(nam))
    assert port[0].solar_irradiance == jax[0].solar_irradiance == 1361.0
    for p, j in zip(port, jax):
        for name, value in vars(p).items():
            if isinstance(value, torch.Tensor):
                np.testing.assert_allclose(value.numpy(),
                                           np.asarray(getattr(j, name)),
                                           rtol=1e-6, err_msg=name)


def test_hdf5_output_and_its_refusal_without_h5py(case, monkeypatch):
    d = case["dir"]
    flux = case["jax"]["cloudless"]
    dims = {"column": NCOL, "half_level": NLEV + 1}
    write_netcdf(str(d / "out.h5"), dims,
                 {"flux_up_lw": (("column", "half_level"),
                                 flux["flux_up_lw"])}, hdf5=True)
    with NetcdfFile(str(d / "out.h5")) as f:
        np.testing.assert_array_equal(f.read("flux_up_lw"),
                                      flux["flux_up_lw"])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="do_write_hdf5"):
        write_netcdf(str(d / "out2.h5"), dims, {}, hdf5=True)


def test_tiled_surface_input_is_refused(case):
    d = case["dir"]
    path = _rewrite(case["input"], str(d / "tiled.nc"), {
        "tile_representation": (("tile",), np.array([1], np.int32)),
        "tile_fraction": (("column", "tile"), np.ones((NCOL, 1)))})
    with pytest.raises(NotImplementedError, match="slice 8"):
        driver.main([case["nam"]["cloudless"], path, str(d / "t.nc"),
                     "--device", "cpu"])


def test_driver_saves_inputs_and_radiative_properties(case, monkeypatch):
    """do_save_inputs and do_save_radiative_properties write inputs.nc
    (read back as the input) and radiative_properties.nc (per-g optical
    properties whose solar source sums to the irradiance in daylight)."""
    d = case["dir"] / "saves"
    d.mkdir()
    monkeypatch.chdir(d)
    nam = _namelist(d / "saves.nam", "cloudless", case["luts"],
                    radiation=" do_save_radiative_properties = true,\n",
                    driver_opts=" do_save_inputs = true,\n")
    _run(nam, case["input"], d / "out.nc")
    again, orig = _read_all("inputs.nc"), _read_all(case["input"])
    assert set(again) == set(orig)
    for k, v in orig.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    props = _read_all("radiative_properties.nc")
    assert props["od_lw"].shape == (NCOL, NLEV, 140)
    assert props["planck_hl"].shape == (NCOL, NLEV + 1, 140)
    assert props["ssa_sw"].shape == (NCOL, NLEV, 112)
    assert (props["od_sw"] >= 0).all() and (props["ssa_sw"] <= 1).all()
    day = orig["cos_solar_zenith_angle"] > 0
    np.testing.assert_allclose(props["incoming_sw"][day].sum(1), 1366.0,
                               rtol=1e-5)


def test_spectral_outputs_and_entrapment_dump_reach_the_files(case):
    """SPARTACUS (with the CY47R1 effective cloud separation) with the
    band profiles, the canopy fluxes and the entrapment dump: the
    driver's file holds, under the same variable names, what the JAX
    package's save_fluxes writes of radiation()'s fluxes on the file's
    inputs, and its <output>.fort.101/.fort.102 are what the JAX
    driver's writer makes of radiation()'s entrapment arrays, byte for
    byte."""
    from ecrad_tpu.driver import _dump_entrapment_data as jax_dump
    from ecrad_tpu.io.output import save_fluxes as jax_save_fluxes
    from ecrad_tpu.types import Flux as JaxFlux
    from ecrad_tpu_torch.config import (load_config_from_namelist,
                                        load_driver_config_from_namelist)
    from ecrad_tpu_torch.interface import radiation, setup_radiation
    d = case["dir"] / "spectral"
    d.mkdir()
    nam = str(d / "spartacus.nam")
    luts = "".join(f' {k} = "{v}",\n' if isinstance(v, str)
                   else f" {k} = {v},\n" for k, v in case["luts"].items())
    with open(nam, "w") as f:
        f.write(NAMELIST.format(
            solver="SPARTACUS", radiation=luts + (
                " do_save_spectral_flux = true,\n"
                " do_canopy_fluxes_sw = true, do_canopy_fluxes_lw = true,\n"
                " do_print_entrapment_data = true,\n"),
            driver=(" cloud_separation_scale_surface = 2500.0,\n"
                    " cloud_separation_scale_toa = 14000.0,\n"
                    " cloud_separation_scale_power = 3.5,\n"
                    " cloud_inhom_separation_factor = 0.75,\n")))
    got = _run(nam, case["input"], d / "out.nc")
    dc = load_driver_config_from_namelist(nam)
    sl, th, gas, cloud, aer = input_reader.read_input(case["input"], dc,
                                                      device="cpu")
    cloud = cloud.param_cloud_effective_separation_eta(th, 2500.0, 14000.0,
                                                       3.5, 0.75)
    flux = radiation(setup_radiation(load_config_from_namelist(nam),
                                     device="cpu"), sl, th, gas, cloud, aer)
    jax_save_fluxes(str(d / "ref.nc"), JaxFlux(**{
        k: v.numpy() for k, v in flux.fields()}), th)
    want = _read_all(str(d / "ref.nc"))
    assert set(got) == set(want)
    assert {"spectral_flux_up_sw", "spectral_flux_dn_lw_clear",
            "canopy_flux_dn_direct_sw_surf", "canopy_flux_dn_lw_surf"} \
        <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jax_dump(str(d / "ref.nc"), [x.numpy() for x in flux.entrapment_data])
    for ext in (".fort.101", ".fort.102"):
        assert (d / ("out.nc" + ext)).read_bytes() == \
            (d / ("ref.nc" + ext)).read_bytes(), ext
