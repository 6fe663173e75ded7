"""PyTorch port: the whole McICA radiation() against the JAX package at
float32, on small columns (make_clouds on 6 x 24 levels) and the
SYNTHETIC LUT files of inputs.write_synthetic_luts (parity on the same
tables, not ecRad's). Configurations: bench.py's McICA line
(mcica_slice_config: Exp-Exp, LW cloud scattering), McICA without LW
scattering on Exp-Ran with the LW derivatives (the path of B4's LW
kernel), and the Cloudless path with the LW derivatives. Both level
orientations.

Bounds at float32:
- clear-sky fields: the Cloudless slice's bound (tests/test_torch_slice.py)
  |port - jax| <= max(1e-5 * max(|exact|, 1), 2 |jax - exact|), the exact
  value being the port at float64 (held to JAX at float64 to 1e-9 by
  tests/test_torch_mcica_f64.py);
- total-sky fields: float64 draws other random numbers (64 bits per
  value), so there is no exact total sky for the float32 subcolumns. Both
  programs draw the same subcolumns (identical masks,
  tests/test_torch_cloud_generator.py) and run the same float32
  recurrences on them, so they are held to the JAX package's own float32
  contract for a deterministic solver against float64 truth
  (tests/test_f64_validation.py): 0.02 W/m2 for LW fields, 0.30 W/m2 for
  SW ones; cloud covers to 2e-6 (tests/test_torch_cloud_cover.py); the LW
  derivatives (dimensionless, 0-1) to 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecrad_tpu import interface as jinterface
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import columns_to_inputs, setup_from_numpy
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    reverse_levels, synthetic_lut_names,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.types import LEVEL_FLUX_FIELDS

from test_torch_slice import _golden_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 24, 0
CONFIGS = {
    "mcica": lambda luts: pconfig.mcica_slice_config(**luts),
    "mcica_noscat": lambda luts: pconfig.mcica_slice_config(
        **luts, do_lw_cloud_scattering=False, do_lw_aerosol_scattering=False,
        i_overlap_scheme=pconfig.Overlap.EXPONENTIAL_RANDOM,
        do_lw_derivatives=True),
    "cloudless_derivatives": lambda luts: pconfig.cloudless_slice_config(
        do_lw_derivatives=True),
}
CONTRACT = {"lw": 0.02, "sw": 0.30}


def columns():
    cols = make_clouds(make_columns(NCOL, NLEV, SEED), SEED)
    return {"toa_first": cols, "surface_first": reverse_levels(cols)}


JOB = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
repo, dtype, name, luts, out = sys.argv[1:6]
if dtype == "float64":
    jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
for p in (repo, os.path.join(repo, "tests"), os.path.join(repo, "tools")):
    sys.path.insert(0, p)
import numpy as np
import make_torch_port_golden as golden
from test_torch_mcica_slice import CONFIGS, columns, lut_overrides
cfg = CONFIGS[name](lut_overrides(luts))
sets = columns()
res = golden.jax_fluxes(dtype, *sets.values(), fields=None, config=cfg)
found = {f"{o}/{k}": v for o, flux in zip(sets, res) for k, v in flux.items()}
if name == "mcica":
    found.update({f"masks/{k}": v for k, v in golden.jax_subcolumn_masks(
        sets["toa_first"], cfg, dtype).items()})
np.savez(out, **found)
"""


def lut_overrides(directory):
    return {"directory_name": directory, **synthetic_lut_names()}


def jax_runs(dtype, luts, tmp):
    """The JAX package's fluxes for every configuration of CONFIGS at
    `dtype` on columns() (both orientations), each configuration in its
    own process and all side by side (their compiles dominate); McICA's
    also with its subcolumn masks. {config: {"orient/field": array}}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {name: (subprocess.Popen(
        [sys.executable, "-c", JOB, REPO, dtype, name,
         luts["directory_name"], os.path.join(tmp, f"{name}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in CONFIGS}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
        with np.load(os.path.join(tmp, f"{name}.npz")) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED)


@pytest.fixture(scope="module")
def fluxes(luts, tmp_path_factory):
    """{config: {orientation: (port f32, JAX f32, port f64)}}."""
    jax32 = jax_runs("float32", luts, str(tmp_path_factory.mktemp("jax")))
    out = {}
    for name, make in CONFIGS.items():
        cfg = make(luts)
        out[name] = {}
        for orient, cols in columns().items():
            port = {}
            for dtype in ("float32", "float64"):
                setup = setup_radiation(dataclasses.replace(cfg,
                                                            dtype=dtype),
                                        device="cpu")
                flux = radiation(setup, *columns_to_inputs(
                    cols, device="cpu", dtype=getattr(torch, dtype)))
                port[dtype] = {k: v.numpy() for k, v in flux.fields()}
            j = {k.split("/")[1]: v for k, v in jax32[name].items()
                 if k.startswith(orient + "/")}
            out[name][orient] = (port["float32"], j, port["float64"])
    out["masks"] = {k.split("/")[1]: v for k, v in jax32["mcica"].items()
                    if k.startswith("masks/")}
    return out


def _bound(name, jax32, exact):
    if name.startswith("cloud_cover"):
        return 2e-6
    if name == "lw_derivatives":
        return 1e-5
    if "clear" in name:
        return max(1e-5 * max(np.abs(exact).max(), 1.0),
                   2 * np.abs(jax32 - exact).max())
    return CONTRACT[name[:2]]


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_mcica_f32_matches_jax(fluxes, config, orient):
    port, jax32, exact = fluxes[config][orient]
    assert set(port) == set(jax32)
    if config.startswith("mcica"):
        assert {"cloud_cover_sw", "cloud_cover_lw"} <= set(port)
    if config != "mcica":
        assert "lw_derivatives" in port
    bad = {}
    for k, a in port.items():
        b = jax32[k]
        assert a.dtype == np.float32 and a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        bound = _bound(k, b, exact[k])
        if np.abs(a - b).max() > bound:
            bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad


def test_mcica_f32_subcolumns_are_jaxs(fluxes, luts, tmp_path_factory):
    """The port's float32 cloud generators give the JAX package's
    cloudy subcolumns on the cloud of the McICA path (the masks come
    with the JAX run of the fluxes fixture)."""
    from ecrad_tpu_torch.interface import _cloud_stage
    from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator
    setup = setup_radiation(CONFIGS["mcica"](luts), device="cpu")
    cfg = setup.config
    sl, th, _, cloud = columns_to_inputs(columns()["toa_first"],
                                         device="cpu")
    cloud, _ = _cloud_stage(setup, th, cloud, lambda x: x)
    for key, ng, offset in (("mask_sw", 112, 0), ("mask_lw", 140, 997)):
        od_scaling, _ = cloud_generator(
            ng, sl.iseed + offset, cfg.i_overlap_scheme,
            cfg.cloud_fraction_threshold, cloud.fraction,
            cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
            cloud.fractional_std, setup.pdf_sampler, table=setup.pdf_table)
        np.testing.assert_array_equal((od_scaling > 0).numpy(),
                                      fluxes["masks"][key], err_msg=key)


def test_clouds_change_the_fluxes(fluxes):
    """The synthetic clouds act as clouds: they reflect sunlight and
    trap LW at the top of the atmosphere; night columns report cloud
    cover -1 in the SW."""
    port = fluxes["mcica"]["toa_first"][0]
    cols = columns()["toa_first"]
    cover = port["cloud_cover_lw"]
    cloudy = cover > 0.3
    assert cloudy.sum() >= 2
    assert (port["lw_up"][cloudy, 0] < port["lw_up_clear"][cloudy, 0]).all()
    day = cols["cos_sza"] > 0.05
    assert (port["sw_up"][cloudy & day, 0]
            > port["sw_up_clear"][cloudy & day, 0]).all()
    np.testing.assert_array_equal(port["cloud_cover_sw"][cols["cos_sza"]
                                                         <= 0], -1.0)
    assert ((cover >= 0) & (cover <= 1)).all()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_reversed_orientation_is_the_flipped_run(fluxes, config):
    fwd = fluxes[config]["toa_first"][0]
    rev = fluxes[config]["surface_first"][0]
    for k, v in fwd.items():
        w = rev[k][:, ::-1] if k in LEVEL_FLUX_FIELDS else rev[k]
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_setup_from_numpy_equals_setup_radiation(luts):
    """A JAX McICA RadiationSetup's content crosses over: cloud-optics
    coefficients and the PDF sampler (table, Chebyshev fit) included."""
    cfg = pconfig.mcica_slice_config(**luts)
    js = jinterface.setup_radiation(_golden_tool().jax_config(cfg,
                                                              "float32"))
    got = setup_from_numpy(cfg, js.tables, js.spec, js.sw_albedo_map,
                           js.sw_albedo_weights, js.lw_emiss_map,
                           js.lw_emiss_weights, device="cpu",
                           cloud_optics=js.cloud_optics,
                           pdf_sampler=js.pdf_sampler)
    ref = setup_radiation(cfg, device="cpu")
    for f in ("liq_coeff_lw", "liq_coeff_sw", "ice_coeff_lw", "ice_coeff_sw",
              "ice_coeff_gen"):
        x, y = getattr(got.cloud_optics, f), getattr(ref.cloud_optics, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for k in got.cloud_coeffs:
        assert torch.equal(got.cloud_coeffs[k], ref.cloud_coeffs[k]), k
    for f in ("val", "cheb"):
        np.testing.assert_array_equal(getattr(got.pdf_sampler, f),
                                      getattr(ref.pdf_sampler, f))
    for f in ("fsd1", "inv_fsd_interval", "z0", "z1"):
        assert getattr(got.pdf_sampler, f) == getattr(ref.pdf_sampler, f), f
    assert torch.equal(got.pdf_table, ref.pdf_table)


# SPARTACUS in one region beside McICA, with its entrapment dump, which the
# port refused until it ported it
BESIDE_MCICA = {
    region: (lambda luts, region=region: pconfig.mcica_slice_config(
        **luts, **{f"i_solver_{region}": pconfig.Solver.SPARTACUS},
        do_print_entrapment_data=True))
    for region in ("sw", "lw")}


def beside_columns(name=None):
    """12 levels: the shape of the other modules' JAX runs, whose compiled
    operations these share."""
    return {"toa_first": make_clouds(make_columns(NCOL, 12, SEED), SEED)}


def jax_results(dtype, luts):
    import test_torch_spectral as spectral
    return spectral.jax_fluxes(dtype, luts, BESIDE_MCICA, beside_columns,
                               lut_overrides)


@pytest.fixture(scope="module")
def beside_mcica(luts, tmp_path_factory):
    """{region: (port f32, JAX f32, port f64)} of BESIDE_MCICA."""
    import test_torch_spectral as spectral
    procs = spectral.start_jax(__name__, luts["directory_name"],
                               tmp_path_factory, dtypes=("float32",))
    cols = beside_columns()["toa_first"]
    port = {}
    for region, make in BESIDE_MCICA.items():
        port[region] = []
        for dtype in ("float32", "float64"):
            flux = radiation(setup_radiation(dataclasses.replace(
                make(luts), dtype=dtype), device="cpu"), *columns_to_inputs(
                    cols, device="cpu", dtype=getattr(torch, dtype)))
            got = {k: v.double().numpy() for k, v in flux.fields()}
            if flux.entrapment_data is not None:
                got["entrapment_data"] = torch.stack(
                    flux.entrapment_data).double().numpy()
            port[region].append(got)
    jax = spectral.finish_jax(procs)["float32"]
    return {r: (p32, jax[r]["toa_first"], p64)
            for r, (p32, p64) in port.items()}


@pytest.mark.parametrize("solver, slice_no", [(pconfig.Solver.SPARTACUS,
                                               "8")])
@pytest.mark.parametrize("region", ["sw", "lw"])
def test_other_cloudy_solvers_raise(beside_mcica, solver, slice_no, region):
    """SPARTACUS runs beside McICA in the other region with its
    entrapment dump, which the port refused until it ported it (ROADMAP
    Queue A, item 8 of the port's plan then): every field within the
    module docstring's float32 bounds of the JAX package's (McICA's
    total-sky contract for the total sky), and the dump, SW only, within
    1e-4 of its largest value."""
    port, jax32, exact = beside_mcica[region]
    assert set(port) == set(jax32)
    assert ("entrapment_data" in port) == (region == "sw")
    bad = {}
    for k, a in port.items():
        b, e = jax32[k], exact[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        bound = (1e-4 * np.abs(b).max() if k == "entrapment_data"
                 else _bound(k, b, e))
        if np.abs(a - b).max() > bound:
            bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad


@pytest.mark.parametrize("solver", [pconfig.Solver.HOMOGENEOUS,
                                    pconfig.Solver.TRIPLECLOUDS])
@pytest.mark.parametrize("region", ["sw", "lw"])
def test_homogeneous_and_tripleclouds_beside_mcica(luts, solver, region):
    """Either region may run Homogeneous or Tripleclouds beside McICA in
    the other."""
    cfg = pconfig.mcica_slice_config(**luts, **{f"i_solver_{region}":
                                                solver})
    flux = radiation(setup_radiation(cfg, device="cpu"), *columns_to_inputs(
        columns()["toa_first"], device="cpu"))
    for k, v in flux.fields():
        assert bool(torch.isfinite(v).all()), k
    assert {"cloud_cover_sw", "cloud_cover_lw"} <= set(dict(flux.fields()))


def test_mcica_needs_a_seed_per_column(luts):
    setup = setup_radiation(pconfig.mcica_slice_config(**luts), device="cpu")
    sl, th, gas, cloud = columns_to_inputs(columns()["toa_first"],
                                           device="cpu")
    with pytest.raises(ValueError, match="iseed"):
        radiation(setup, sl.replace(iseed=None), th, gas, cloud)
