"""PyTorch port: cloud optics (every liquid x ice model), the cloud/gas
combine and the delta-Eddington forms against the JAX package, at
float32, on the synthetic LUT files of inputs.write_synthetic_luts (both
packages read the same files with their own setup_cloud_optics).

Bound: 1e-5 of each output's range. The two programs evaluate the same
float32 expressions on the same float32 coefficients; what separates
them is libm's last bit (pow, exp, division order inside XLA's fusions),
a few ulps, far inside 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ecrad_tpu import config as jconfig
from ecrad_tpu.io.netcdf import NetcdfFile as JaxNetcdfFile
from ecrad_tpu.optics import cloud as jcloud
from ecrad_tpu.optics import combine as jcombine
from ecrad_tpu.types import Cloud as JaxCloud
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.io.netcdf import NetcdfFile
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    synthetic_lut_names, write_synthetic_luts)
from ecrad_tpu_torch.optics import cloud as pcloud
from ecrad_tpu_torch.optics import combine as pcombine
from ecrad_tpu_torch.types import Cloud

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return str(tmp_path_factory.mktemp("luts"))


@pytest.fixture(scope="module")
def lut_dir(luts):
    write_synthetic_luts(luts, 0)
    return luts


@pytest.fixture(scope="module")
def columns():
    return make_clouds(make_columns(5, 30, 1), 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


LIQUID = {"socrates": pconfig.LiquidModel.SOCRATES,
          "slingo": pconfig.LiquidModel.SLINGO}
ICE = {"fu": pconfig.IceModel.FU, "baran": pconfig.IceModel.BARAN,
       "baran2016": pconfig.IceModel.BARAN2016,
       "baran2017": pconfig.IceModel.BARAN2017, "yi": pconfig.IceModel.YI}


def _configs(lut_dir, liq, ice, **kw):
    cfg = pconfig.mcica_slice_config(
        directory_name=lut_dir, i_liq_model=LIQUID[liq], i_ice_model=ICE[ice],
        **synthetic_lut_names(liq, ice), **kw).consolidated()
    return cfg, _golden_tool().jax_config(cfg, "float32").consolidated()


def _compare(lut_dir, columns, liq, ice, **kw):
    cfg, jcfg = _configs(lut_dir, liq, ice, **kw)
    tables = pcloud.setup_cloud_optics(cfg)
    jtables = jcloud.setup_cloud_optics(jcfg)
    for f in ("liq_coeff_lw", "liq_coeff_sw", "ice_coeff_lw",
              "ice_coeff_sw", "ice_coeff_gen"):
        a, b = getattr(tables, f), getattr(jtables, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    c = columns
    keys = ("q_liq", "q_ice", "re_liq", "re_ice", "fraction")
    t32 = lambda k: torch.as_tensor(c[k], dtype=torch.float32)
    got = pcloud.cloud_optics(
        cfg, tables, pcloud.coefficient_tensors(tables, "cpu"),
        t32("pressure_hl"), t32("temperature_hl"),
        Cloud(**{k: t32(k) for k in keys}))
    j32 = lambda k: jnp.asarray(c[k], jnp.float32)
    ref = jcloud.cloud_optics(jcfg, jtables, j32("pressure_hl"),
                              j32("temperature_hl"),
                              JaxCloud(**{k: j32(k) for k in keys}))
    names = ("od_lw", "ssa_lw", "g_lw", "od_sw", "ssa_sw", "g_sw")
    for name, a, b in zip(names, got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert np.isfinite(a.numpy()).all(), name
        assert _rel(a.numpy(), b) <= TOL, (name, _rel(a.numpy(), b))
    return {n: a.numpy() for n, a in zip(names, got)}


@pytest.mark.parametrize("ice", list(ICE))
@pytest.mark.parametrize("liq", list(LIQUID))
def test_cloud_optics_matches_jax(lut_dir, columns, liq, ice):
    out = _compare(lut_dir, columns, liq, ice)
    cloudy = columns["fraction"] > 0
    # the synthetic tables give clouds of plausible optics; the SW ones
    # leave delta-Eddington scaled, g -> g / (1 + g) (0.75-0.9 -> ~0.45)
    assert (out["od_sw"][cloudy] > 0).all()
    assert (out["od_sw"][~cloudy] == 0).all()
    assert ((out["g_sw"][cloudy] > 0.4) & (out["g_sw"][cloudy] < 0.5)).all()
    assert (out["ssa_sw"][cloudy] > 0.7).all()
    assert (out["ssa_lw"][cloudy] < 0.7).all()


@pytest.mark.parametrize("kw", [
    dict(do_lw_cloud_scattering=False),
    dict(do_fu_lw_ice_optics_bug=True),
    dict(do_sw_delta_scaling_with_gases=True),
    dict(i_solver_sw=pconfig.Solver.HOMOGENEOUS,
         i_solver_lw=pconfig.Solver.HOMOGENEOUS),
], ids=["no_lw_scattering", "fu_lw_bug", "delta_with_gases", "homogeneous"])
def test_cloud_optics_switches_match_jax(lut_dir, columns, kw):
    _compare(lut_dir, columns, "slingo", "fu", **kw)


def test_netcdf_reader_matches_jax(lut_dir):
    path = os.path.join(lut_dir, "synthetic_baran2017_ice.nc")
    with NetcdfFile(path) as f, JaxNetcdfFile(path) as g:
        assert sorted(f.variables()) == sorted(g.variables())
        assert f.exists("COEFF_GEN") and not f.exists("nothing")
        for name in f.variables():
            np.testing.assert_array_equal(f.read(name), g.read(name))
        with pytest.raises(KeyError):
            f.read("nothing")


# ---- combine and delta-Eddington on random inputs ----

def _rand_optics(seed, ncol=4, nlev=9, ng=112, nb=14):
    rng = np.random.RandomState(seed)
    f32 = lambda x: x.astype(np.float32)
    return dict(
        od=f32(rng.gamma(0.5, 1.0, (ncol, nlev, ng))),
        ssa=f32(rng.uniform(0.0, 1.0, (ncol, nlev, ng))),
        g=f32(rng.uniform(0.0, 0.9, (ncol, nlev, ng))),
        od_cloud=f32(rng.gamma(0.5, 2.0, (ncol, nlev, nb))),
        ssa_cloud=f32(rng.uniform(0.3, 1.0, (ncol, nlev, nb))),
        g_cloud=f32(rng.uniform(0.5, 0.9, (ncol, nlev, nb))),
        od_scaling=f32(rng.gamma(1.0, 1.0, (ncol, nlev, ng))),
        mask=rng.rand(ncol, nlev, 1) > 0.4,
        band_from_g=np.sort(rng.randint(0, nb, ng)))


@pytest.mark.parametrize("region", ["sw", "lw_scat", "lw_noscat"])
@pytest.mark.parametrize("scaled", [False, True])
def test_combine_matches_jax(region, scaled):
    x = _rand_optics(4)
    args = [x[k] for k in ("od", "ssa", "g", "od_cloud", "ssa_cloud",
                           "g_cloud")] + [x["band_from_g"]]
    kw = dict(od_scaling=x["od_scaling"], cloud_mask=x["mask"]) \
        if scaled else {}
    if region == "sw":
        pfn, jfn, extra = (pcombine.combine_cloud_gas_sw,
                           jcombine.combine_cloud_gas_sw, [])
    else:
        pfn, jfn = pcombine.combine_cloud_gas_lw, jcombine.combine_cloud_gas_lw
        extra = [region == "lw_scat"]
    got = pfn(*map(torch.as_tensor, args), *extra,
              **{k: torch.as_tensor(v) for k, v in kw.items()})
    ref = jfn(*map(jnp.asarray, args[:-1]), args[-1], *extra,
              **{k: jnp.asarray(v) for k, v in kw.items()})
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) <= TOL


def test_delta_eddington_forms_match_jax():
    x = _rand_optics(5)
    od, ssa, g = x["od"], x["ssa"], x["g"]
    t, j = torch.as_tensor, jnp.asarray
    for pfn, jfn, args in (
            (pcloud.delta_eddington, jcloud.delta_eddington, (od, ssa, g)),
            (pcloud.delta_eddington_scat_od, jcloud.delta_eddington_scat_od,
             (od, ssa * od, g)),
            (pcloud.delta_eddington_extensive,
             jcloud.delta_eddington_extensive, (od, ssa * od, g * ssa * od))):
        for a, b in zip(pfn(*map(t, args)), jfn(*map(j, args))):
            assert _rel(a.numpy(), b) <= TOL, pfn.__name__
