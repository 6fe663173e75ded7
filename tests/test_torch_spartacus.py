"""PyTorch port: the whole SPARTACUS radiation() against the JAX package,
on small columns (add_effective_sizes(make_aerosols(make_clouds(...))) on
6 x 20 levels, the effective sizes of ecRad's CY47R1 namelist) and the
SYNTHETIC LUT files of inputs.write_synthetic_luts (parity on the same
tables, not ecRad's), with g-point reordering on, both level orientations
for the slice configuration.

Configurations: the SPARTACUS path (spartacus_slice_config: 3 regions,
Explicit entrapment, 3D effects, 12 aerosol types, LW derivatives) with
the entrapment internals dumped (do_print_entrapment_data); its
Maximum-entrapment variant (the CY47R1 matrix's spartacus_maxentr) with
the g-point profiles (in the original g order); two regions with
lognormal PDF, Zero entrapment, LW cloud scattering and no aerosols, with
the band profiles and the canopy fluxes; and 3D effects off.

Bounds: at float64 1e-9 of each field's range (its largest magnitude
where that is larger). At float32, every field within its bound of the
JAX package's float64 value, and of its float32 value within the bound
plus the JAX package's own float32 error on these columns (the rule the
Tripleclouds path follows, because the port computes the SW
Meador-Weaver resonance window in float64): bench.py:140-145's
SPARTACUS_F64_BOUNDS for the broadband fluxes (W/m2), the same per
spectral region for band and g-point surface fluxes, profiles and canopy
fluxes, 1e-5 for the cloud covers and 1e-4 for the LW derivatives. The
entrapment internals: at float64 1e-9 of each array's largest value, at
float32 1e-4 of it against the JAX package's float64 (the migration
distances accumulate over the column). The JAX runs go to
subprocesses, four side by side (`jax_enable_x64` is process-global).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import columns_to_inputs, setup_from_numpy
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
                                    reverse_levels, synthetic_lut_names,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.solvers import spartacus_lw, spartacus_sw
from ecrad_tpu_torch.types import LEVEL_FLUX_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCOL, NLEV, SEED = 6, 20, 0
F64_TOL = 1e-9
E = pconfig.Entrapment
CONFIGS = {
    "spartacus": lambda luts: pconfig.spartacus_slice_config(
        **luts, do_print_entrapment_data=True),
    "spartacus_maxentr": lambda luts: pconfig.spartacus_slice_config(
        **luts, i_3d_sw_entrapment=E.MAXIMUM, do_save_spectral_flux=True,
        do_save_gpoint_flux=True),
    "spartacus_2reg": lambda luts: pconfig.spartacus_slice_config(
        **luts, nregions=2, i_cloud_pdf_shape=pconfig.PdfShape.LOGNORMAL,
        i_3d_sw_entrapment=E.ZERO, do_lw_cloud_scattering=True,
        do_lw_aerosol_scattering=False, use_aerosols=False,
        do_save_spectral_flux=True, do_canopy_fluxes_sw=True,
        do_canopy_fluxes_lw=True),
    "spartacus_1d": lambda luts: pconfig.spartacus_slice_config(
        **luts, do_3d_effects=False),
}
# (configuration, precision) runs; reversed orientation for the slice
JOBS = [(name, dtype) for name in CONFIGS for dtype in ("float32",
                                                        "float64")
        if not (name == "spartacus_1d" and dtype == "float32")]
# bench.py SPARTACUS_F64_BOUNDS, and the rules of the module docstring
F64_BOUNDS = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.20, "sw_dn": 0.20,
              "sw_dn_direct": 0.01, "lw_up_clear": 0.01,
              "lw_dn_clear": 0.01, "sw_up_clear": 0.20, "sw_dn_clear": 0.20}


def bound(field):
    if field in F64_BOUNDS:
        return F64_BOUNDS[field]
    if field.startswith("cloud_cover"):
        return 1e-5
    if field == "lw_derivatives":
        return 1e-4
    if field.startswith(("sw_dn_direct", "lw")):
        return 0.01
    return 0.20


def columns():
    cols = add_effective_sizes(make_aerosols(make_clouds(
        make_columns(NCOL, NLEV, SEED), SEED), SEED))
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


def jax_runs(luts, tmp, at_once=4):
    """{(config, dtype): {orientation: {field: array}}} of the JAX
    package, each run in its own process, `at_once` side by side (each
    holds about 1.3 GB)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = {}
    for i in range(0, len(JOBS), at_once):
        procs = {}
        for name, dtype in JOBS[i:i + at_once]:
            out = os.path.join(tmp, f"{name}_{dtype}.npz")
            procs[name, dtype] = (out, subprocess.Popen(
                [sys.executable, "-c", JOB, REPO, __name__, dtype, name,
                 luts["directory_name"], out], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for key, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
            with np.load(out) as z:
                res[key] = {}
                for k in z.files:
                    orient, field = k.split("/")
                    res[key].setdefault(orient, {})[field] = z[k]
    return res


class ThreeD:
    """Records, from the solvers' reftrans calls, the share of (level, g,
    column) cells with the 3D treatment and their doubling counts."""

    def __init__(self, monkeypatch):
        self.cells, self.counts = {}, {}
        for mod, name in ((spartacus_sw, "sw_reftrans_levels"),
                          (spartacus_lw, "lw_reftrans_levels")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name),
                                                      name[:2]))

    def _wrap(self, fn, region):
        def wrapped(*args, **kw):
            use3d = args[7] if region == "sw" else args[10]
            counts = torch.empty(use3d.shape, dtype=torch.int8)
            out = fn(*args, counts=counts, **kw)
            self.cells[region] = (int(use3d.sum()), use3d.numel())
            self.counts[region] = np.bincount(
                counts.numpy().ravel().astype(int) + 1)
            return out
        return wrapped


def port_runs(luts, cols_sets, monkeypatch):
    out = {}
    three_d = None
    for name, dtype in JOBS:
        setup = setup_radiation(dataclasses.replace(
            CONFIGS[name](luts), dtype=dtype), device="cpu")
        out[name, dtype] = {}
        for orient, cols in cols_sets.items():
            if (name, dtype, orient) == ("spartacus", "float32",
                                         "toa_first"):
                three_d = ThreeD(monkeypatch)
            elif name != "spartacus" and orient != "toa_first":
                continue
            flux = radiation(setup, *columns_to_inputs(
                cols, device="cpu", dtype=getattr(torch, dtype)))
            out[name, dtype][orient] = {k: v.numpy()
                                        for k, v in flux.fields()}
            if flux.entrapment_data is not None:
                out[name, dtype][orient]["entrapment_data"] = torch.stack(
                    flux.entrapment_data).numpy()
            if three_d is not None:
                monkeypatch.undo()
                out["3d"], three_d = three_d, None
    return out


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")


@pytest.fixture(scope="module")
def fluxes(luts, tmp_path_factory):
    """(port, jax) {(config, dtype): {orientation: {field: array}}}."""
    mp = pytest.MonkeyPatch()
    try:
        port = port_runs(luts, columns(), mp)
    finally:
        mp.undo()
    return port, jax_runs(luts, str(tmp_path_factory.mktemp("jax")))


def _cases():
    return [(name, orient) for name, dtype in JOBS if dtype == "float32"
            for orient in (("toa_first", "surface_first")
                           if name == "spartacus" else ("toa_first",))]


@pytest.mark.parametrize("config, orient", _cases())
def test_spartacus_f32_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got = port[config, "float32"][orient]
    j32 = jax[config, "float32"][orient]
    j64 = jax[config, "float64"][orient]
    assert set(got) == set(j32)
    assert {"cloud_cover_sw", "cloud_cover_lw", "lw_derivatives"} <= set(got)
    bad = {}
    for k, a in got.items():
        if k == "entrapment_data":
            continue
        assert a.dtype == np.float32 and a.shape == j32[k].shape, k
        assert np.isfinite(a).all(), k
        slack = float(np.abs(j32[k] - j64[k]).max())
        e32 = float(np.abs(a - j32[k]).max())
        e64 = float(np.abs(a - j64[k]).max())
        if e64 > bound(k) or e32 > bound(k) + slack:
            bad[k] = (e32, e64, slack, bound(k))
    assert not bad, bad


@pytest.mark.parametrize("config, orient", [
    (n, o) for n, d in JOBS if d == "float64"
    for o in (("toa_first", "surface_first") if n == "spartacus"
              else ("toa_first",))])
def test_spartacus_f64_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got, ref = port[config, "float64"][orient], jax[config, "float64"][orient]
    assert set(got) == set(ref)
    bad = {}
    for k, a in got.items():
        b = ref[k]
        if k == "entrapment_data":
            continue
        scale = max(np.ptp(b), np.abs(b).max(), 1e-300)
        err = float(np.abs(a - b).max() / scale)
        if not (a.dtype == np.float64 and err <= F64_TOL):
            bad[k] = err
    assert not bad, bad


def test_reversed_orientation_is_the_flipped_run(fluxes):
    fwd = fluxes[0]["spartacus", "float32"]["toa_first"]
    rev = fluxes[0]["spartacus", "float32"]["surface_first"]
    for k, v in fwd.items():
        w = rev[k][:, ::-1] if k in LEVEL_FLUX_FIELDS else rev[k]
        np.testing.assert_array_equal(v, w, err_msg=k)


def test_3d_share_is_positive(fluxes, capsys):
    """The effective sizes give 3D cells in both spectral regions, and
    their doubling counts are spread; 3D effects change the fluxes."""
    three_d = fluxes[0]["3d"]
    with capsys.disabled():
        for region in ("sw", "lw"):
            n3, n = three_d.cells[region]
            print(f"\n{region}: 3D share {n3 / n:.4f} of {n} (level, g, "
                  f"column) cells; doubling counts (-1 = fallback, 0, 1, "
                  f"...): {three_d.counts[region].tolist()}")
    for region in ("sw", "lw"):
        n3, n = three_d.cells[region]
        assert n3 > 0.05 * n, region
        assert len(three_d.counts[region]) >= 4, region
    port = fluxes[0]
    a = port["spartacus", "float64"]["toa_first"]
    b = port["spartacus_1d", "float64"]["toa_first"]
    assert np.abs(a["sw_up"] - b["sw_up"]).max() > 0.1
    assert np.abs(a["lw_up"] - b["lw_up"]).max() > 0.01


def test_derivatives_are_one_at_the_surface(fluxes):
    d = fluxes[0]["spartacus", "float32"]["toa_first"]["lw_derivatives"]
    np.testing.assert_array_equal(d[:, -1], 1.0)
    assert ((d >= 0) & (d <= 1 + 1e-5)).all()


# ---- the pieces SPARTACUS brought: reordering, effective sizes ----

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reordered_gas_optics_match_jax(dtype):
    """The port's gas optics with the SPARTACUS g order against the JAX
    package's (make_spec(reorder_lw=True, reorder_sw=True))."""
    import jax
    import jax.numpy as jnp
    from ecrad_tpu.optics.rrtmg import gas_optics as jgo
    from ecrad_tpu_torch.optics.rrtmg import gas_optics as pgo
    from ecrad_tpu_torch.optics.rrtmg.tables import load_tables
    cols = make_columns(3, 12, 1)
    lw_albedo = np.random.RandomState(2).uniform(0, 0.1, (3, 140))
    names = ("pressure_hl", "temperature_hl", "mixing_ratio",
             "skin_temperature", "cos_sza")
    with jax.enable_x64(dtype == "float64"):
        ref = jgo.gas_optics(*(jnp.asarray(cols[k], dtype) for k in names),
                             cols["solar_irradiance"],
                             jgo.make_spec(reorder_lw=True, reorder_sw=True),
                             lw_albedo=jnp.asarray(lw_albedo, dtype),
                             dtype=getattr(jnp, dtype))
        ref = [np.asarray(x) for x in ref]
    t = load_tables()
    tdt = getattr(torch, dtype)
    spec = pgo.make_spec(t, reorder_lw=True, reorder_sw=True)
    got = pgo.gas_optics(*(torch.as_tensor(cols[k], dtype=tdt)
                           for k in names), cols["solar_irradiance"],
                         pgo.spec_tensors(spec, "cpu"),
                         pgo.gas_tables(t, tdt, "cpu"),
                         lw_albedo=torch.as_tensor(lw_albedo, dtype=tdt))
    np.testing.assert_array_equal(spec.g_from_reordered_g_lw,
                                  jgo.RRTM_GPOINT_REORDERING_LW)
    np.testing.assert_array_equal(spec.g_from_reordered_g_sw,
                                  jgo.RRTM_GPOINT_REORDERING_SW)
    for name, a, b in zip(got._fields, got, ref):
        a = a.numpy()
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert rel <= (1e-12 if dtype == "float64" else 2e-5), (name, rel)


def test_setup_from_numpy_takes_a_reordered_spec(luts):
    from ecrad_tpu.interface import setup_radiation as jax_setup
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_torch_port_golden as golden
    cfg = pconfig.spartacus_slice_config(**luts)
    js = jax_setup(golden.jax_config(cfg, "float32"))
    got = setup_from_numpy(cfg, js.tables, js.spec, js.sw_albedo_map,
                           js.sw_albedo_weights, js.lw_emiss_map,
                           js.lw_emiss_weights, device="cpu",
                           cloud_optics=js.cloud_optics,
                           aerosol_optics=js.aerosol_optics)
    ref = setup_radiation(cfg, device="cpu")
    for name in ref.spec._fields:
        np.testing.assert_array_equal(getattr(got.spec, name),
                                      getattr(js.spec, name), err_msg=name)
        np.testing.assert_array_equal(getattr(ref.spec, name),
                                      getattr(js.spec, name), err_msg=name)
    assert not np.array_equal(ref.spec.band_from_reordered_g_sw,
                              ref.spec.band_from_g_sw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_effective_sizes_match_jax(dtype):
    import jax
    import jax.numpy as jnp
    from ecrad_tpu.types import Cloud as JCloud
    from ecrad_tpu.types import Thermodynamics as JThermo
    from ecrad_tpu_torch.types import Cloud, Thermodynamics
    cols = make_clouds(make_columns(5, 30, 3), 3)
    keys = ("q_liq", "q_ice", "re_liq", "re_ice", "fraction")
    with jax.enable_x64(dtype == "float64"):
        jc = JCloud(**{k: jnp.asarray(cols[k], dtype) for k in keys})
        jt = JThermo(pressure_hl=jnp.asarray(cols["pressure_hl"], dtype),
                     temperature_hl=jnp.asarray(cols["temperature_hl"],
                                                dtype))
        a = jc.param_cloud_effective_separation_eta(jt, 2500.0, 14000.0,
                                                    3.5, 0.75)
        b = jc.create_inv_cloud_effective_size_eta(jt, 1e-3, 5e-4, 2e-4,
                                                   0.8, 0.45)
        ref = [np.asarray(x) for x in (a.inv_cloud_effective_size,
                                       a.inv_inhom_effective_size,
                                       b.inv_cloud_effective_size)]
    tdt = getattr(torch, dtype)
    pc = Cloud(**{k: torch.as_tensor(cols[k], dtype=tdt) for k in keys})
    pt = Thermodynamics(*(torch.as_tensor(cols[k], dtype=tdt)
                          for k in ("pressure_hl", "temperature_hl")))
    a = pc.param_cloud_effective_separation_eta(pt, 2500.0, 14000.0, 3.5,
                                                0.75)
    b = pc.create_inv_cloud_effective_size_eta(pt, 1e-3, 5e-4, 2e-4, 0.8,
                                               0.45)
    got = [x.numpy() for x in (a.inv_cloud_effective_size,
                               a.inv_inhom_effective_size,
                               b.inv_cloud_effective_size)]
    for x, y in zip(got, ref):
        assert x.dtype == np.dtype(dtype)
        np.testing.assert_allclose(x, y, rtol=1e-12 if dtype == "float64"
                                   else 2e-6)
    if dtype == "float64":
        added = add_effective_sizes(cols)
        np.testing.assert_array_equal(added["inv_cloud_effective_size"],
                                      got[0])
        np.testing.assert_array_equal(added["inv_inhom_effective_size"],
                                      got[1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_entrapment_data_matches_jax(fluxes, dtype):
    """(x_direct, x_diffuse, direct_dn, flux_dn) at the first g-point,
    (nlev, 3, ncol) each, against the JAX package's."""
    port, jax = fluxes
    got = port["spartacus", dtype]["toa_first"]["entrapment_data"]
    ref = jax["spartacus", "float64"]["toa_first"]["entrapment_data"]
    assert got.shape == ref.shape == (4, NLEV, 3, NCOL)
    tol = F64_TOL if dtype == "float64" else 1e-4
    for a, b, name in zip(got, ref, ("x_direct", "x_diffuse", "direct_dn",
                                     "flux_dn")):
        assert np.abs(b).max() > 0 and np.isfinite(a).all(), name
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (name, err)


def test_entrapment_dump_files_are_the_jax_drivers(fluxes, tmp_path):
    """The port's fort.101/fort.102 text is byte for byte what the JAX
    driver writes from the same arrays."""
    from ecrad_tpu.driver import _dump_entrapment_data as jax_dump
    from ecrad_tpu_torch.driver import _dump_entrapment_data as port_dump
    data = fluxes[0]["spartacus", "float32"]["toa_first"]["entrapment_data"]
    port_dump(str(tmp_path / "port.nc"), tuple(torch.as_tensor(data)))
    jax_dump(str(tmp_path / "jax.nc"), tuple(data))
    for ext in (".fort.101", ".fort.102"):
        got = (tmp_path / ("port.nc" + ext)).read_bytes()
        assert got == (tmp_path / ("jax.nc" + ext)).read_bytes(), ext
        assert len(got.splitlines()) == NLEV * NCOL


@pytest.mark.parametrize("overrides, error, match", [
    (dict(do_print_entrapment_data=True), None, None),
    (dict(nregions=4), ValueError, "2 or 3 regions"),
])
def test_unported_spartacus_settings_raise(luts, fluxes, overrides, error,
                                           match):
    """Four regions raise. The entrapment dump, refused before it was
    ported, runs: it leaves every flux field as it is without it, and its
    arrays are the JAX package's (test_entrapment_data_matches_jax)."""
    cfg = pconfig.spartacus_slice_config(**luts, **overrides)
    if error is not None:
        with pytest.raises(error, match=match):
            setup_radiation(cfg, device="cpu")
        return
    plain = radiation(setup_radiation(
        dataclasses.replace(cfg, do_print_entrapment_data=False),
        device="cpu"), *columns_to_inputs(columns()["toa_first"],
                                          device="cpu"))
    assert plain.entrapment_data is None
    got = fluxes[0]["spartacus", "float32"]["toa_first"]
    assert set(got) - {"entrapment_data"} == {k for k, _ in plain.fields()}
    for k, v in plain.fields():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
