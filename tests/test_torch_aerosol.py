"""PyTorch port: the aerosol stage against the JAX package, on the CPU.

optics/aerosol.py's setup (the LUT rows gathered per configured type) and
add_aerosol_optics on the synthetic aerosol table of
inputs.write_synthetic_luts and the aerosols of inputs.make_aerosols:
both LW branches (scattering, and the absorption-only co-albedo form),
SW with and without delta scaling of the aerosol alone, fewer and more
types supplied than configured, and the direct per-band bypass. Bounds:
float64 1e-12 of each field's range; float32 1e-5 of it (the JAX package
sums over the types in a matrix product, the port in order).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.optics import aerosol as jaerosol
from ecrad_tpu.types import Aerosol as JAerosol
from ecrad_tpu.types import GasConcs as JGasConcs
from ecrad_tpu.types import Thermodynamics as JThermodynamics
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.convert import setup_from_numpy
from ecrad_tpu_torch.inputs import (make_aerosols, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.optics import aerosol as paerosol
from ecrad_tpu_torch.types import Aerosol, GasConcs, Thermodynamics

from test_torch_slice import _golden_tool

NCOL, NLEV = 5, 16
CASES = {
    "lw_scattering": {},
    "lw_absorption": dict(do_lw_aerosol_scattering=False),
    "sw_delta_with_gases": dict(do_sw_delta_scaling_with_gases=True),
    "ten_types_supplied": dict(ntypes=10),
    "fourteen_types_supplied": dict(ntypes=14),
    "direct": dict(direct=True),
}


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), 0)


def _config(luts, **kw):
    return pconfig.cloudless_slice_config(
        **luts, use_aerosols=True,
        n_aerosol_types=len(pconfig.TRIPLECLOUDS_AEROSOL_MAP),
        i_aerosol_type_map=pconfig.TRIPLECLOUDS_AEROSOL_MAP, **kw)


def _inputs(ntypes=12, direct=False):
    rng = np.random.RandomState(3)
    cols = make_aerosols(make_columns(NCOL, NLEV, 2), 2)
    mmr = cols["aerosol_mmr"]
    if ntypes > mmr.shape[-1]:
        mmr = np.concatenate([mmr, mmr[..., :ntypes - mmr.shape[-1]]], -1)
    x = dict(pressure_hl=cols["pressure_hl"],
             temperature_hl=cols["temperature_hl"],
             mixing_ratio=cols["mixing_ratio"], aerosol_mmr=mmr[..., :ntypes],
             od_lw=rng.uniform(0, 3, (NCOL, NLEV, 140)),
             ssa_lw=rng.uniform(0, 0.3, (NCOL, NLEV, 140)),
             g_lw=rng.uniform(0, 0.5, (NCOL, NLEV, 140)),
             od_sw=rng.uniform(0, 3, (NCOL, NLEV, 112)),
             ssa_sw=rng.uniform(0.2, 1, (NCOL, NLEV, 112)),
             g_sw=np.zeros((NCOL, NLEV, 112)))
    x["od_sw"][0, :4] = 0.0               # layers without gas extinction
    if direct:
        x["direct"] = dict(od_sw=rng.uniform(0, 0.2, (NCOL, NLEV, 14)),
                           ssa_sw=rng.uniform(0.8, 1, (NCOL, NLEV, 14)),
                           g_sw=rng.uniform(0.5, 0.8, (NCOL, NLEV, 14)),
                           od_lw=rng.uniform(0, 0.05, (NCOL, NLEV, 16)),
                           ssa_lw=rng.uniform(0.1, 0.6, (NCOL, NLEV, 16)))
    return x


def _jax(cfg, x, dtype):
    """The JAX package's add_aerosol_optics on x at dtype (its setup
    from the same file, its band maps the port's)."""
    jcfg = _golden_tool().jax_config(cfg, dtype).consolidated()
    spec = setup_radiation(cfg, device="cpu").spec
    setup = SimpleNamespace(
        config=jcfg, aerosol_optics=jaerosol.setup_aerosol_optics(jcfg),
        spec=SimpleNamespace(band_from_reordered_g_sw=spec.band_from_g_sw,
                             band_from_reordered_g_lw=spec.band_from_g_lw))
    with jax.enable_x64(dtype == "float64"):
        j = lambda k: jnp.asarray(x[k], dtype)
        aer = JAerosol(mixing_ratio=j("aerosol_mmr"),
                       **{k: jnp.asarray(v, dtype)
                          for k, v in x.get("direct", {}).items()})
        out = jaerosol.add_aerosol_optics(
            setup, JThermodynamics(pressure_hl=j("pressure_hl"),
                                   temperature_hl=j("temperature_hl")),
            JGasConcs(mixing_ratio=j("mixing_ratio")), aer,
            *(j(k) for k in ("od_lw", "ssa_lw", "g_lw", "od_sw", "ssa_sw",
                             "g_sw")))
        return [np.asarray(v) for v in out]


def _port(cfg, x, dtype):
    setup = setup_radiation(dataclasses.replace(cfg, dtype=dtype),
                            device="cpu")
    t = lambda v: torch.as_tensor(v, dtype=getattr(torch, dtype))
    aer = Aerosol(mixing_ratio=t(x["aerosol_mmr"]),
                  **{k: t(v) for k, v in x.get("direct", {}).items()})
    out = paerosol.add_aerosol_optics(
        setup.config, setup.aerosol_coeffs,
        torch.as_tensor(setup.spec.band_from_g_sw),
        torch.as_tensor(setup.spec.band_from_g_lw),
        Thermodynamics(pressure_hl=t(x["pressure_hl"]),
                       temperature_hl=t(x["temperature_hl"])),
        GasConcs(mixing_ratio=t(x["mixing_ratio"])), aer,
        *(t(x[k]) for k in ("od_lw", "ssa_lw", "g_lw", "od_sw", "ssa_sw",
                            "g_sw")))
    return [v.numpy() for v in out]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_add_aerosol_optics_matches_jax(luts, case, dtype):
    kw = dict(CASES[case])
    x = _inputs(kw.pop("ntypes", 12), kw.pop("direct", False))
    cfg = _config(luts, **kw)
    ref = _jax(cfg, x, dtype)
    got = _port(cfg, x, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    names = ("od_lw", "ssa_lw", "g_lw", "od_sw", "ssa_sw", "g_sw")
    bad = {}
    for name, a, b in zip(names, got, ref):
        assert a.dtype == np.dtype(dtype) and a.shape == b.shape, name
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        if rel > tol:
            bad[name] = rel
    assert not bad, bad


def test_aerosols_add_optical_depth(luts):
    """The aerosols add extinction to every g-point of the cells that
    hold them, of order 0.1 in the mid-visible summed over a column, and
    scatter in the SW more than in the LW."""
    x = _inputs()
    cfg = _config(luts)
    od_lw, ssa_lw, _, od_sw, ssa_sw, g_sw = _port(cfg, x, "float64")
    d_sw = od_sw - x["od_sw"]
    assert (d_sw > 0).all() and (od_lw - x["od_lw"] > 0).all()
    col = d_sw.sum(1)                       # (ncol, ng)
    assert 0.01 < np.median(col) < 1.0
    assert (g_sw > 0).all() and (g_sw < 1).all()
    # the aerosol alone in those layers: its delta-scaled albedo
    assert ((ssa_sw[0, :4] > 0.5) & (ssa_sw[0, :4] < 1)).all()


def test_saturation_matches_jax():
    cols = make_columns(NCOL, NLEV, 1)
    j = JThermodynamics(pressure_hl=jnp.asarray(cols["pressure_hl"]),
                        temperature_hl=jnp.asarray(cols["temperature_hl"])
                        ).calc_saturation_wrt_liquid().h2o_sat_liq
    f32 = lambda k: torch.as_tensor(cols[k], dtype=torch.float32)
    p = Thermodynamics(pressure_hl=f32("pressure_hl"),
                       temperature_hl=f32("temperature_hl")
                       ).calc_saturation_wrt_liquid().h2o_sat_liq
    assert p.shape == (NCOL, NLEV)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-6)


def test_setup_carries_the_jax_aerosol_tables(luts):
    """The aerosol setup reads the table as the JAX package does, and a
    JAX setup's tables cross over through setup_from_numpy."""
    cfg = _config(luts)
    js = _golden_tool().jax_config(cfg, "float32").consolidated()
    jtab = jaerosol.setup_aerosol_optics(js)
    ours = setup_radiation(cfg, device="cpu")
    got = setup_from_numpy(cfg, ours.tables, ours.spec, ours.sw_albedo_map,
                           ours.sw_albedo_weights, ours.lw_emiss_map,
                           ours.lw_emiss_weights, device="cpu",
                           aerosol_optics=jtab)
    for f in dataclasses.fields(paerosol.AerosolOpticsTables):
        np.testing.assert_array_equal(getattr(ours.aerosol_optics, f.name),
                                      getattr(jtab, f.name), err_msg=f.name)
    for k, v in ours.aerosol_coeffs.items():
        assert torch.equal(v, got.aerosol_coeffs[k]), k
    assert list(jtab.is_active) == [i != 0 for i in
                                    pconfig.TRIPLECLOUDS_AEROSOL_MAP]
