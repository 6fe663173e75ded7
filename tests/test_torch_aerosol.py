"""PyTorch port: the aerosol stage against the JAX package, on the CPU.

optics/aerosol.py's setup (the LUT rows gathered per configured type) and
add_aerosol_optics on the synthetic aerosol table of
inputs.write_synthetic_luts and the aerosols of inputs.make_aerosols, on
the cases of aerosol_cases.py (each branch kernel B12 takes on the card:
both LW branches, SW delta scaling of the aerosol alone or with the
gases, fewer and more types supplied than configured, rows without
aerosol, the saturation given or computed, humidities on the bins' edges,
one level; and the direct per-band bypass). On CPU tensors
add_aerosol_optics is its plain version and launches nothing. Bounds:
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
from ecrad_tpu_torch.constants import GAS_INDEX
from ecrad_tpu_torch.convert import setup_from_numpy
from ecrad_tpu_torch.inputs import make_columns, write_synthetic_luts
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.ops import _cuda
from ecrad_tpu_torch.ops import aerosol_optics
from ecrad_tpu_torch.optics import aerosol as paerosol
from ecrad_tpu_torch.types import Thermodynamics

import aerosol_cases as cases
from test_torch_slice import _golden_tool

NCOL, NLEV = cases.NCOL, cases.NLEV


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), 0)


def _case(luts, case):
    """(configuration, numpy inputs) of cases.CASES[case]."""
    overrides, kw = cases.split(case)
    return (cases.config(luts, **overrides),
            cases.inputs(**kw, rh_lower=cases.rh_edges(luts)))


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
        sat = j("h2o_sat_liq") if "h2o_sat_liq" in x else None
        out = jaerosol.add_aerosol_optics(
            setup, JThermodynamics(pressure_hl=j("pressure_hl"),
                                   temperature_hl=j("temperature_hl"),
                                   h2o_sat_liq=sat),
            JGasConcs(mixing_ratio=j("mixing_ratio")), aer,
            *(j(k) for k in cases.FIELDS))
        return [np.asarray(v) for v in out]


def _port(cfg, x, dtype):
    _, args = cases.port_args(cfg, x, dtype, "cpu")
    return [v.numpy() for v in paerosol.add_aerosol_optics(*args)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(cases.CASES))
def test_add_aerosol_optics_matches_jax(luts, case, dtype):
    cfg, x = _case(luts, case)
    ref = _jax(cfg, x, dtype)
    got = _port(cfg, x, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    bad = {}
    for name, a, b in zip(cases.FIELDS, got, ref):
        assert a.dtype == np.dtype(dtype) and a.shape == b.shape, name
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        if rel > tol:
            bad[name] = rel
    assert not bad, bad


@pytest.mark.parametrize("case", ["rows_without_aerosol",
                                  "humidity_bin_edges"])
def test_the_cases_reach_their_branches(luts, case):
    """rows_without_aerosol leaves its clean rows' SW and LW properties
    as they came (has_aer false); humidity_bin_edges puts cells in every
    humidity bin, a value on each edge staying below it."""
    cfg, x = _case(luts, case)
    od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw = _port(cfg, x, "float64")
    if case == "rows_without_aerosol":
        for got, name in zip((od_lw, ssa_lw, g_lw, od_sw, ssa_sw, g_sw),
                             cases.FIELDS):
            np.testing.assert_array_equal(got[0, :3], x[name][0, :3])
            np.testing.assert_array_equal(got[-1, -1], x[name][-1, -1])
        assert (od_sw[1] != x["od_sw"][1]).all()
    else:
        rh = x["mixing_ratio"][:, :, GAS_INDEX["h2o"]].ravel()
        edges = cases.rh_edges(luts)
        irh = (rh[:, None] > edges[1:]).sum(-1)
        assert set(irh) == set(range(len(edges)))
        on_edge = np.isin(rh, edges)
        assert on_edge.sum() >= len(edges)
        # a value on edge k > 0 stays in bin k - 1
        np.testing.assert_array_equal(irh[on_edge], np.maximum(
            np.searchsorted(edges, rh[on_edge]) - 1, 0))


def test_on_cpu_tensors_nothing_is_launched(luts, monkeypatch):
    """add_aerosol_optics on CPU tensors takes the plain version: kernel
    B12 is not launched and its count does not move; the kernel's wrapper
    itself refuses CPU tensors."""
    def refuse(*args, **kw):
        raise AssertionError("launched")
    monkeypatch.setattr(_cuda, "launch", refuse)
    n0 = aerosol_optics.launches["aerosol_optics"]
    cfg, x = _case(luts, "lw_scattering")
    _, args = cases.port_args(cfg, x, "float32", "cpu", int32=True)
    got = paerosol.add_aerosol_optics(*args)
    want = paerosol.add_aerosol_optics_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert aerosol_optics.launches["aerosol_optics"] == n0
    with pytest.raises(ValueError, match="CUDA"):
        aerosol_optics.aerosol_optics_fused(*args)


def test_aerosols_add_optical_depth(luts):
    """The aerosols add extinction to every g-point of the cells that
    hold them, of order 0.1 in the mid-visible summed over a column, and
    scatter in the SW more than in the LW."""
    cfg, x = _case(luts, "lw_scattering")
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
    cfg = cases.config(luts)
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
