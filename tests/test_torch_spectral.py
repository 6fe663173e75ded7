"""PyTorch port: the band and g-point flux profiles (do_save_spectral_flux,
do_save_gpoint_flux), the spectral solar scaling and the canopy-top
fluxes (do_canopy_fluxes_*, use_canopy_full_spectrum_*) against the JAX
package, on small columns (add_effective_sizes(make_aerosols(make_clouds(
make_columns(6, 12, 0))))) and the SYNTHETIC LUT files of
inputs.write_synthetic_luts, with a spectral solar scaling of 0.8-1.2 by
band on every configuration:

- cloudless: band profiles, canopy fluxes by nearest interval in both
  spectral regions; also with the levels reversed;
- mcica: g-point profiles; canopy fluxes by overlap weights (SW) and
  nearest interval (LW), the slice options' albedo and emissivity maps;
- homogeneous: band profiles, full-spectrum canopy fluxes, the albedo and
  emissivity given per g-point (get_albedos passes them through);
- tripleclouds: g-point profiles, canopy fluxes.
SPARTACUS, whose g-points are reordered, is held in
tests/test_torch_spartacus.py. The JAX runs go to two processes side by
side, float32 and float64 (jax_enable_x64 is process-global), each
running its configurations' operations one by one (eager) and without
most compiler optimisations, so that the compiled operations serve every
configuration and compile quickly.

Bounds: at float64 every field within 1e-9 of its largest magnitude. At
float32 within 1e-5 of that, or, where the JAX package's own float32
error on these columns is larger (the thin scattering layers of
tests/test_torch_slice.py, the resonance window of the Tripleclouds
path), twice that error; McICA's total sky has no float64 truth for the
float32 subcolumns (float64 draws other random numbers), so its
total-sky fields are held to the deterministic solvers' float32
contract (tests/test_torch_mcica_slice.py): 0.02 W/m2 LW, 0.30 SW, and
its cloud covers and LW derivatives to 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
                                    reverse_levels, synthetic_lut_names,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.types import LEVEL_FLUX_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 12, 0
F64_TOL, F32_TOL = 1e-9, 1e-5
CONTRACT = {"lw": 0.02, "sw": 0.30}
S = pconfig.Solver
SPECTRAL = dict(do_save_spectral_flux=True, use_spectral_solar_scaling=True,
                do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True)
CONFIGS = {
    "cloudless": lambda luts: pconfig.cloudless_slice_config(
        **SPECTRAL, do_nearest_spectral_sw_albedo=True),
    "mcica": lambda luts: pconfig.mcica_slice_config(
        **luts, **SPECTRAL, do_save_gpoint_flux=True),
    "homogeneous": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **SPECTRAL, i_solver_sw=S.HOMOGENEOUS,
        i_solver_lw=S.HOMOGENEOUS, use_canopy_full_spectrum_sw=True,
        use_canopy_full_spectrum_lw=True),
    "tripleclouds": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **SPECTRAL, do_save_gpoint_flux=True),
}
PROFILES = ("lw_up_band", "lw_dn_band", "sw_up_band", "sw_dn_band",
            "sw_dn_direct_band")


def columns(name="cloudless"):
    """{orientation: numpy columns}: reversed levels for cloudless; per-g
    albedos and emissivities for homogeneous."""
    cols = add_effective_sizes(make_aerosols(make_clouds(
        make_columns(NCOL, NLEV, SEED), SEED), SEED))
    cols["spectral_solar_scaling"] = np.linspace(0.8, 1.2, 14)
    if name == "homogeneous":
        rng = np.random.RandomState(SEED)
        cols["sw_albedo"] = rng.uniform(0.05, 0.5, (NCOL, 112))
        cols["lw_emissivity"] = rng.uniform(0.9, 1.0, (NCOL, 140))
    if name == "cloudless":
        return {"toa_first": cols, "surface_first": reverse_levels(cols)}
    return {"toa_first": cols}


def lut_overrides(directory):
    return {"directory_name": directory, **synthetic_lut_names(ice="fu")}


JOB = r"""
import importlib, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
repo, module, dtype, luts, out, cache = sys.argv[1:7]
if dtype == "float64":
    jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
# the operations compile in a third less time; the results are the same
# functions' values
jax.config.update("jax_disable_most_optimizations", True)
# every compiled operation is kept for the other modules' processes
jax.config.update("jax_compilation_cache_dir", cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
for p in (repo, os.path.join(repo, "tests"), os.path.join(repo, "tools")):
    sys.path.insert(0, p)
import numpy as np
mod = importlib.import_module(module)
np.savez(out, **mod.jax_results(dtype, luts))
"""


def jax_results(dtype, luts):
    """This module's JAX results at `dtype`, {"config/orientation/field":
    array}: every configuration's fluxes, run eagerly, and the scaled
    solar source of the gas optics alone in the identity and in
    SPARTACUS's g order (under "gas_optics/<reorder>")."""
    import jax.numpy as jnp
    from ecrad_tpu.optics.rrtmg import gas_optics as jgo
    found = jax_fluxes(dtype, luts)
    cols = columns()["toa_first"]
    a = lambda k: jnp.asarray(cols[k], dtype)  # noqa: E731
    for reorder in (False, True):
        go = jgo.gas_optics(
            a("pressure_hl"), a("temperature_hl"), a("mixing_ratio"),
            a("skin_temperature"), a("cos_sza"), cols["solar_irradiance"],
            jgo.make_spec(reorder_lw=reorder, reorder_sw=reorder),
            spectral_solar_scaling=a("spectral_solar_scaling"),
            dtype=getattr(jnp, dtype))
        found[f"gas_optics/{reorder}/incoming_sw"] = np.asarray(
            go.incoming_sw)
    return found


def golden_tool():
    """tools/make_torch_port_golden.py, the JAX package's runner."""
    if os.path.join(REPO, "tools") not in sys.path:
        sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_torch_port_golden
    return make_torch_port_golden


def jax_fluxes(dtype, luts, configs=None, make_columns_of=None,
               overrides=None):
    """{"config/orientation/field": array} of the JAX package's fluxes for
    each configuration of `configs` (default this module's CONFIGS) on
    the column sets of `make_columns_of` (default this module's
    columns), its operations run one by one; `overrides` (default this
    module's lut_overrides) names the LUT files in directory `luts`."""
    golden = golden_tool()
    found = {}
    for name, make in (configs or CONFIGS).items():
        sets = (make_columns_of or columns)(name)
        res = golden.jax_fluxes(dtype, *sets.values(), fields=None,
                                config=make((overrides or lut_overrides)(
                                    luts)), jit=False)
        for orient, flux in zip(sets, res):
            found.update({f"{name}/{orient}/{k}": v for k, v in flux.items()})
    return found


def start_jax(module, luts, tmp_path_factory,
              dtypes=("float32", "float64")):
    """One process per dtype running `module`.jax_results(dtype, luts),
    side by side; finish_jax collects them. The processes of every module
    share one compilation cache in the test run's temporary root (the
    modules run their operations on columns of one shape)."""
    tmp = str(tmp_path_factory.mktemp("jax"))
    cache = str(tmp_path_factory.getbasetemp().parent
                / "jax-compilation-cache")
    # one thread each: the operations are small, and the test workers
    # already hold the cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    procs = {}
    for dtype in dtypes:
        out = os.path.join(tmp, f"{module}_{dtype}.npz")
        procs[dtype] = (out, subprocess.Popen(
            [sys.executable, "-c", JOB, REPO, module, dtype, luts, out,
             cache],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def finish_jax(procs):
    """{dtype: {config: {orientation: {field: array}}}}."""
    res = {}
    for dtype, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
        res[dtype] = {}
        with np.load(out) as z:
            for k in z.files:
                name, orient, field = k.split("/")
                res[dtype].setdefault(name, {}).setdefault(
                    orient, {})[field] = z[k]
    return res


def port_run(cfg, cols, dtype):
    """The port's fields at `dtype` on the CPU, numpy float64."""
    setup = setup_radiation(dataclasses.replace(cfg, dtype=dtype),
                            device="cpu")
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu",
                                               dtype=getattr(torch, dtype)))
    return {k: v.double().numpy() for k, v in flux.fields()}


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")


@pytest.fixture(scope="module")
def fluxes(luts, tmp_path_factory):
    """(port, jax), each {dtype: {config: {orientation: {field}}}}; the
    port runs while the JAX processes do."""
    procs = start_jax(__name__, luts["directory_name"], tmp_path_factory)
    port = {dtype: {name: {orient: port_run(make(luts), cols, dtype)
                           for orient, cols in columns(name).items()}
                    for name, make in CONFIGS.items()}
            for dtype in ("float32", "float64")}
    return port, finish_jax(procs)


def f32_bound(field, j32, j64, mcica=False):
    """The float32 bound of the module docstring for one field (flux and
    RADIATION_SCHEME names alike)."""
    own = F32_TOL * max(np.abs(j64).max(), 1.0)
    if not mcica or "clear" in field:
        return max(own, 2 * np.abs(j32 - j64).max())
    if field.startswith(("cloud_cover", "lw_derivative", "emis_out")):
        return own
    return max(own, CONTRACT["lw" if "lw" in field else "sw"])


CASES = [(n, o) for n in CONFIGS for o in columns(n)]


@pytest.mark.parametrize("config, orient", CASES)
def test_f64_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got, ref = port["float64"][config][orient], jax["float64"][config][orient]
    assert set(got) == set(ref)
    assert {"lw_dn_surf_canopy", "sw_dn_direct_surf_canopy",
            *PROFILES} <= set(got)
    bad = {k: float(np.abs(a - ref[k]).max() / max(np.abs(ref[k]).max(),
                                                    1e-300))
           for k, a in got.items()}
    assert all(a.shape == ref[k].shape for k, a in got.items())
    assert max(bad.values()) <= F64_TOL, {k: e for k, e in bad.items()
                                          if e > F64_TOL}


@pytest.mark.parametrize("config, orient", CASES)
def test_f32_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got = port["float32"][config][orient]
    j32, j64 = (jax[d][config][orient] for d in ("float32", "float64"))
    assert set(got) == set(j32)
    bad = {}
    for k, a in got.items():
        assert a.shape == j32[k].shape and np.isfinite(a).all(), k
        err = float(np.abs(a - j32[k]).max())
        b = f32_bound(k, j32[k], j64[k], mcica=config == "mcica")
        if err > b:
            bad[k] = (err, b)
    assert not bad, bad


@pytest.mark.parametrize("config", list(CONFIGS))
def test_profiles_sum_to_the_broadband_fluxes(fluxes, config):
    """Band or g-point profiles, total and clear sky, summed over their
    last axis: the broadband profiles, to 1e-5 of each field's largest
    value (float32); g-point profiles hold every g-point once."""
    got = fluxes[0]["float32"][config]["toa_first"]
    gpoint = CONFIGS[config]({}).do_save_gpoint_flux
    for k in PROFILES + tuple(p + "_clear" for p in PROFILES):
        broad = got[k.replace("_band", "")]
        assert got[k].shape[-1] == ({"lw": 140, "sw": 112} if gpoint else
                                    {"lw": 16, "sw": 14})[k[:2]], k
        assert np.abs(got[k].sum(-1) - broad).max() \
            <= F32_TOL * np.abs(broad).max(), k


def test_reversed_orientation_is_the_flipped_run(fluxes):
    """The band profiles of a height-increasing input come back flipped,
    equal to the TOA-first run's."""
    fwd = fluxes[0]["float32"]["cloudless"]["toa_first"]
    rev = fluxes[0]["float32"]["cloudless"]["surface_first"]
    for k, v in fwd.items():
        w = rev[k][:, ::-1] if k in LEVEL_FLUX_FIELDS else rev[k]
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_canopy_forms(fluxes):
    """Nearest interval: one value per interval; overlap weights: the SW
    albedo intervals; full spectrum: the per-g surface fluxes."""
    got = {n: fluxes[0]["float64"][n]["toa_first"] for n in CONFIGS}
    assert got["cloudless"]["sw_dn_direct_surf_canopy"].shape == (NCOL, 6)
    assert got["cloudless"]["lw_dn_surf_canopy"].shape == (NCOL, 2)
    assert got["mcica"]["sw_dn_diffuse_surf_canopy"].shape == (NCOL, 6)
    for k in ("lw_dn_surf_canopy", "sw_dn_direct_surf_canopy"):
        # every g-point lands in one interval: the sums agree
        surf = got["cloudless"][k.replace("canopy", "g")]
        np.testing.assert_allclose(got["cloudless"][k].sum(-1),
                                   surf.sum(-1), rtol=1e-12)
    for k in ("lw_dn_surf_canopy", "sw_dn_diffuse_surf_canopy",
              "sw_dn_direct_surf_canopy"):
        np.testing.assert_array_equal(got["homogeneous"][k],
                                      got["homogeneous"][
                                          k.replace("canopy", "g")])


# ---- the spectral solar scaling in the gas optics ----

def _gas_optics_cases():
    return [(path, reorder, dtype) for path in ("fused", "per_band")
            for reorder in (False, True) for dtype in ("float32", "float64")]


@pytest.mark.parametrize("path, reorder, dtype", _gas_optics_cases())
def test_solar_scaling_matches_jax(fluxes, monkeypatch, path, reorder,
                                   dtype):
    """The scaled and normalised solar source on the all-band (B2) and the
    per-band (B10, ECRAD_FUSED_TAUMOL=0) gas optics, in the identity and
    the SPARTACUS g order, against the JAX package's; the scaling moves
    it; a scaling of ones leaves it bit for bit."""
    from ecrad_tpu_torch.optics.rrtmg import gas_optics as pgo
    from ecrad_tpu_torch.optics.rrtmg.tables import load_tables
    monkeypatch.setenv("ECRAD_FUSED_TAUMOL", "0" if path == "per_band"
                       else "1")
    cols = columns()["toa_first"]
    tdt = getattr(torch, dtype)
    t = load_tables()
    a = lambda k: torch.as_tensor(cols[k], dtype=tdt)  # noqa: E731
    spec = pgo.make_spec(t, reorder_lw=reorder, reorder_sw=reorder)
    tables = pgo.gas_tables(t, tdt, "cpu")

    def incoming(scaling):
        return pgo.gas_optics(
            a("pressure_hl"), a("temperature_hl"), a("mixing_ratio"),
            a("skin_temperature"), a("cos_sza"), cols["solar_irradiance"],
            pgo.spec_tensors(spec, "cpu"), tables,
            spectral_solar_scaling=scaling).incoming_sw
    got = incoming(a("spectral_solar_scaling")).double().numpy()
    ref = fluxes[1][dtype]["gas_optics"][str(reorder)]["incoming_sw"]
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= (1e-12 if dtype == "float64" else 2e-6), rel
    plain = incoming(None)
    assert torch.equal(incoming(torch.ones(14, dtype=tdt)), plain)
    assert np.abs(plain.double().numpy() - got).max() > 1e-3 * np.abs(
        got).max()
