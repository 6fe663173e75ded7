"""PyTorch port: the whole Tripleclouds radiation() against the JAX
package, on small columns (make_aerosols(make_clouds(...)) on 6 x 24
levels) and the SYNTHETIC LUT files of inputs.write_synthetic_luts
(parity on the same tables, not ecRad's), both level orientations.

Configurations: the Tripleclouds path (tripleclouds_slice_config: 3
regions, gamma PDF, Exp-Ran, 12 aerosol types, LW aerosol scattering,
LW derivatives) and its two-region variant (lognormal PDF, beta
overlap, LW cloud scattering, no aerosol scattering, no aerosols).

Bounds: at float32 the Cloudless slice's rule for every field
(tests/test_torch_slice.py): |port - jax| <= max(1e-5 max(|exact|, 1),
2 |jax - exact|), the exact value being the port at float64; at float64
1e-9 of each field's range (tests/test_torch_f64.py). Tripleclouds draws
no random numbers, so both precisions compare. `jax_enable_x64` is
process-global: the JAX runs go to subprocesses, all side by side
(`jax_runs`, which tests/test_torch_homogeneous.py shares).
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
from ecrad_tpu_torch.inputs import (make_aerosols, make_clouds, make_columns,
                                    reverse_levels, synthetic_lut_names,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.types import LEVEL_FLUX_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 24, 0
F64_TOL = 1e-9
CONFIGS = {
    "tripleclouds": lambda luts: pconfig.tripleclouds_slice_config(**luts),
    "tripleclouds_2reg": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, nregions=2, i_cloud_pdf_shape=pconfig.PdfShape.LOGNORMAL,
        use_beta_overlap=True, do_lw_cloud_scattering=True,
        do_lw_aerosol_scattering=False, use_aerosols=False),
}


def columns():
    cols = make_aerosols(make_clouds(make_columns(NCOL, NLEV, SEED), SEED),
                         SEED)
    return {"toa_first": cols, "surface_first": reverse_levels(cols)}


def lut_overrides(directory):
    return {"directory_name": directory, **synthetic_lut_names(ice="fu")}


JOB = r"""
import importlib, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
repo, module, dtype, name, luts, out = sys.argv[1:7]
if dtype == "float64":
    jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
for p in (repo, os.path.join(repo, "tests"), os.path.join(repo, "tools")):
    sys.path.insert(0, p)
import numpy as np
import make_torch_port_golden as golden
mod = importlib.import_module(module)
cfg = mod.CONFIGS[name](mod.lut_overrides(luts))
sets = mod.columns()
res = golden.jax_fluxes(dtype, *sets.values(), fields=None, config=cfg)
np.savez(out, **{f"{o}/{k}": v for o, flux in zip(sets, res)
                 for k, v in flux.items()})
"""


def jax_runs(module, luts, tmp):
    """The JAX package's fluxes for every configuration of `module`'s
    CONFIGS on its columns() (both orientations, one jit each) at float32
    and float64, each (configuration, precision) in its own process, all
    side by side. {(config, dtype): {orientation: {field: array}}}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    mod = sys.modules[module]
    procs = {}
    for name in mod.CONFIGS:
        for dtype in ("float32", "float64"):
            out = os.path.join(tmp, f"{name}_{dtype}.npz")
            procs[name, dtype] = (out, subprocess.Popen(
                [sys.executable, "-c", JOB, REPO, module, dtype, name,
                 luts["directory_name"], out], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = {}
    for key, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
        with np.load(out) as z:
            res[key] = {}
            for k in z.files:
                orient, field = k.split("/")
                res[key].setdefault(orient, {})[field] = z[k]
    return res


def port_runs(configs, luts, cols_sets):
    """{(config, dtype): {orientation: {field: array}}} of the port on the
    CPU."""
    out = {}
    for name, make in configs.items():
        for dtype in ("float32", "float64"):
            setup = setup_radiation(dataclasses.replace(make(luts),
                                                        dtype=dtype),
                                    device="cpu")
            out[name, dtype] = {
                orient: {k: v.numpy() for k, v in radiation(
                    setup, *columns_to_inputs(
                        cols, device="cpu",
                        dtype=getattr(torch, dtype))).fields()}
                for orient, cols in cols_sets.items()}
    return out


def check_f32(port, jax32, exact):
    """The float32 rule of the module docstring; returns the fields
    outside it."""
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
    return bad


def check_f64(port, jax64):
    assert set(port) == set(jax64)
    rel = lambda a, b: float(np.abs(a - b).max()
                             / max(np.abs(b).max(), 1e-300))
    return {k: rel(v, jax64[k]) for k, v in port.items()
            if not (v.dtype == np.float64 and rel(v, jax64[k]) <= F64_TOL)}


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")


@pytest.fixture(scope="module")
def fluxes(luts, tmp_path_factory):
    """(port, jax) {(config, dtype): {orientation: {field: array}}}."""
    return (port_runs(CONFIGS, luts, columns()),
            jax_runs(__name__, luts, str(tmp_path_factory.mktemp("jax"))))


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tripleclouds_f32_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got = port[config, "float32"][orient]
    assert {"cloud_cover_sw", "cloud_cover_lw", "lw_derivatives"} <= set(got)
    bad = check_f32(got, jax[config, "float32"][orient],
                    port[config, "float64"][orient])
    assert not bad, bad


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tripleclouds_f64_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    bad = check_f64(port[config, "float64"][orient],
                    jax[config, "float64"][orient])
    assert not bad, bad


@pytest.mark.parametrize("config", list(CONFIGS))
def test_reversed_orientation_is_the_flipped_run(fluxes, config):
    fwd = fluxes[0][config, "float32"]["toa_first"]
    rev = fluxes[0][config, "float32"]["surface_first"]
    for k, v in fwd.items():
        w = rev[k][:, ::-1] if k in LEVEL_FLUX_FIELDS else rev[k]
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_clouds_and_aerosols_change_the_fluxes(fluxes, luts):
    """The clouds reflect sunlight and trap LW at the top of the
    atmosphere; the aerosols dim the direct beam at the surface of the
    clear sky; night columns report cloud cover -1 in the SW."""
    port = fluxes[0]["tripleclouds", "float32"]["toa_first"]
    cols = columns()["toa_first"]
    cloudy = port["cloud_cover_lw"] > 0.3
    day = cols["cos_sza"] > 0.05
    assert cloudy.sum() >= 2
    assert (port["lw_up"][cloudy, 0] < port["lw_up_clear"][cloudy, 0]).all()
    assert (port["sw_up"][cloudy & day, 0]
            > port["sw_up_clear"][cloudy & day, 0]).all()
    np.testing.assert_array_equal(port["cloud_cover_sw"][~(cols["cos_sza"]
                                                           > 0)], -1.0)
    clean = radiation(setup_radiation(dataclasses.replace(
        CONFIGS["tripleclouds"](luts), use_aerosols=False), device="cpu"),
        *columns_to_inputs(cols, device="cpu"))
    assert (port["sw_dn_direct_clear"][day, -1]
            < clean.sw_dn_direct_clear.numpy()[day, -1]).all()


def test_derivatives_are_one_at_the_surface(fluxes):
    d = fluxes[0]["tripleclouds", "float32"]["toa_first"]["lw_derivatives"]
    np.testing.assert_array_equal(d[:, -1], 1.0)
    assert ((d >= 0) & (d <= 1 + 1e-5)).all()
