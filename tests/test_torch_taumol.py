"""PyTorch port: the plain versions of kernels B1 (LW taumol) and B2 (SW
taumol, with the solar source), and the per-band path (taumol_lw_sections,
taumol_sw_sections: kernel B10's plain version), against the JAX package.

Both sides get the same coefficients (the JAX setcoef of seeded columns),
so the comparison isolates taumol. Bounds are the JAX package's own for
its fused body against the per-band path (tests/test_taumol_fused.py):
rel <= 1e-5 where tau > 1e-6 (float32 reassociation), pfrac atol 1e-6.
The per-band path is held to the JAX per-band path at the same bounds at
float32 and to 1e-10 at float64 (relative where |tau| > 1e-6, absolute
below), and to the port's own fused plain versions at the float32 bounds.
The kernels themselves run only on a GPU (tests/test_torch_kernels_gpu.py).
"""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.constants import GAS_INDEX
from ecrad_tpu.optics.rrtmg import setcoef as jsc
from ecrad_tpu.optics.rrtmg.taumol_lw import taumol_lw as jax_taumol_lw
from ecrad_tpu.optics.rrtmg.taumol_lw_fused import taumol_lw_fused
from ecrad_tpu.optics.rrtmg.taumol_sw import taumol_sw as jax_taumol_sw
from ecrad_tpu.optics.rrtmg.taumol_sw_fused import taumol_sw_fused
from ecrad_tpu_torch.inputs import make_columns
from ecrad_tpu_torch.optics.rrtmg import fused_tables, taumol_lw, taumol_sw
from ecrad_tpu_torch.optics.rrtmg.gas_optics import gas_tables
from ecrad_tpu_torch.optics.rrtmg.setcoef import Coeffs
from ecrad_tpu_torch.optics.rrtmg.tables import load_tables
from ecrad_tpu_torch.optics.rrtmg.taumol_lw_sections import \
    taumol_lw_sections
from ecrad_tpu_torch.optics.rrtmg.taumol_sw_sections import \
    taumol_sw_sections

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")


@functools.lru_cache(maxsize=None)
def _jax_fn(name):
    """One jitted JAX taumol per variant, shared by every seed (same
    shapes, so each compiles once)."""
    t = load_tables()
    fns = {
        "lw_fused": lambda c: taumol_lw_fused(c, t, use_pallas=False,
                                              toa_first=True),
        "lw_bands": lambda c: jax_taumol_lw(c, t, toa_first=True),
        "sw_fused": lambda c: taumol_sw_fused(c, t, use_pallas=False,
                                              toa_first=True),
        "sw_bands": lambda c: jax_taumol_sw(c, t, toa_first=True),
    }
    return jax.jit(fns[name])


def _coeffs(seed, dtype):
    """(JAX Coeffs, the same as torch Coeffs, the port's GasTables on the
    CPU at dtype), surface-first; at float64 call it under
    jax.enable_x64."""
    cols = make_columns(6, 18, seed)
    t = load_tables()
    phl, thl = cols["pressure_hl"], cols["temperature_hl"]
    cast = lambda x: jnp.asarray(np.asarray(x, dtype))      # noqa: E731
    gc = jsc.prepare_gases(
        cast(phl), cast(0.5 * (phl[:, :-1] + phl[:, 1:])),
        cast(0.5 * (thl[:, :-1] + thl[:, 1:])),
        *(cast(cols["mixing_ratio"][:, :, GAS_INDEX[g]]) for g in GASES),
        dtype=dtype)
    jc = jsc.setcoef(gc, t["preflog"], t["tref"], t["chi_mls"])
    pc = Coeffs(**{k: torch.as_tensor(np.array(getattr(jc, k)))
                   for k in Coeffs._fields})
    return jc, pc, gas_tables(t, torch.float64 if dtype == np.float64
                              else torch.float32, "cpu")


@pytest.fixture(scope="module", params=[0, 1])
def coeffs(request):
    return _coeffs(request.param, np.float32)


def _check_tau(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    mask = np.abs(b) > 1e-6
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-30))[mask]
    assert rel.max() <= 1e-5, (what, rel.max())
    # where tau is tiny the difference stays tiny too
    assert np.abs(a - b)[~mask].max(initial=0.0) <= 1e-10, what


def test_b1_plain_matches_jax_fused_body(coeffs):
    jc, pc, gt = coeffs
    tau, pfrac = taumol_lw.taumol_lw_cells(pc, gt.chi_mls, gt.lw)
    jtau, jpf = _jax_fn("lw_fused")(jc)
    _check_tau(tau.numpy(), jtau, "tau")
    np.testing.assert_allclose(pfrac.numpy(), np.asarray(jpf), rtol=0,
                               atol=1e-6)


def test_b1_plain_matches_jax_per_band(coeffs):
    jc, pc, gt = coeffs
    tau, pfrac = taumol_lw.taumol_lw_cells(pc, gt.chi_mls, gt.lw)
    jtau, jpf = _jax_fn("lw_bands")(jc)
    _check_tau(tau.numpy(), jtau, "tau")
    np.testing.assert_allclose(pfrac.numpy(), np.asarray(jpf), rtol=0,
                               atol=1e-6)


def test_b2_plain_and_solar_source_match_jax_fused_body(coeffs):
    jc, pc, gt = coeffs
    taug, taur, sflux = taumol_sw.taumol_sw_cells(pc, gt)
    jg, jr, js = _jax_fn("sw_fused")(jc)
    _check_tau(taug.numpy(), jg, "taug")
    _check_tau(taur.numpy(), jr, "taur")
    js = np.asarray(js)
    rel = np.abs(sflux.numpy() - js).max() / np.abs(js).max()
    assert rel <= 1e-6, rel


def test_b2_plain_matches_jax_per_band(coeffs):
    jc, pc, gt = coeffs
    taug, taur, sflux = taumol_sw.taumol_sw_cells(pc, gt)
    jg, jr, js = _jax_fn("sw_bands")(jc)
    _check_tau(taug.numpy(), jg, "taug")
    _check_tau(taur.numpy(), jr, "taur")
    js = np.asarray(js)
    rel = np.abs(sflux.numpy() - js).max() / np.abs(js).max()
    assert rel <= 1e-6, rel


def test_lw_per_band_matches_jax_per_band_and_fused(coeffs):
    jc, pc, gt = coeffs
    tau, pfrac = taumol_lw_sections(pc, gt.t, toa_first=True)
    assert tau.dtype == torch.float32 and tau.shape == (6, 18, 140)
    jtau, jpf = _jax_fn("lw_bands")(jc)
    _check_tau(tau.numpy(), jtau, "tau")
    np.testing.assert_allclose(pfrac.numpy(), np.asarray(jpf), rtol=0,
                               atol=1e-6)
    ftau, fpf = taumol_lw.taumol_lw_cells(pc, gt.chi_mls, gt.lw)
    _check_tau(tau.numpy(), ftau.numpy(), "tau vs fused")
    np.testing.assert_allclose(pfrac.numpy(), fpf.numpy(), rtol=0,
                               atol=1e-6)


def test_sw_per_band_matches_jax_per_band_and_fused(coeffs):
    jc, pc, gt = coeffs
    taug, taur, sflux = taumol_sw_sections(pc, gt, toa_first=True)
    assert taug.shape == taur.shape == (6, 18, 112)
    jg, jr, js = _jax_fn("sw_bands")(jc)
    _check_tau(taug.numpy(), jg, "taug")
    _check_tau(taur.numpy(), jr, "taur")
    js = np.asarray(js)
    assert np.abs(sflux.numpy() - js).max() / np.abs(js).max() <= 1e-6
    fg, fr, _ = taumol_sw.taumol_sw_cells(pc, gt)
    _check_tau(taug.numpy(), fg.numpy(), "taug vs fused")
    _check_tau(taur.numpy(), fr.numpy(), "taur vs fused")


def test_per_band_matches_jax_per_band_at_float64():
    with jax.enable_x64(True):
        jc, pc, gt = _coeffs(0, np.float64)
        t = gt.t
        jlw = [np.asarray(x) for x in jax_taumol_lw(jc, t, toa_first=True)]
        jsw = [np.asarray(x) for x in jax_taumol_sw(jc, t, toa_first=True)]
    got = [x.numpy() for x in taumol_lw_sections(pc, t, toa_first=True)
           + taumol_sw_sections(pc, gt, toa_first=True)]
    for name, a, b in zip(("tau", "pfrac", "taug", "taur", "sflux"), got,
                          jlw + jsw):
        assert a.dtype == b.dtype == np.float64, name
        big = np.abs(b) > 1e-6
        rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-30))[big]
        assert rel.max(initial=0.0) <= 1e-10, (name, rel.max())
        assert np.abs(a - b)[~big].max(initial=0.0) <= 1e-10, name


def test_gas_optics_honours_ecrad_fused_taumol(monkeypatch):
    """ECRAD_FUSED_TAUMOL=0 takes the per-band path (read at call time);
    the two paths agree at the fused-vs-per-band bounds."""
    from ecrad_tpu_torch import config as pconfig
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.interface import get_albedos, setup_radiation
    from ecrad_tpu_torch.optics.rrtmg import gas_optics as pgo
    setup = setup_radiation(pconfig.cloudless_slice_config(), device="cpu")
    sl, th, gas = columns_to_inputs(make_columns(4, 18, 2), device="cpu")
    calls = []
    for mod in ("taumol_lw_sections", "taumol_sw_sections"):
        fn = getattr(pgo, mod)
        monkeypatch.setattr(pgo, mod, lambda *a, _fn=fn, **k: (
            calls.append(_fn), _fn(*a, **k))[1])

    def run():
        return pgo.gas_optics(
            th.pressure_hl, th.temperature_hl, gas.mixing_ratio,
            sl.skin_temperature, sl.cos_sza, sl.solar_irradiance,
            setup.maps, setup.gas, lw_albedo=get_albedos(setup, sl)[2])
    fused = run()
    assert not calls
    monkeypatch.setenv("ECRAD_FUSED_TAUMOL", "0")
    per_band = run()
    assert len(calls) == 2
    _check_tau(per_band.od_lw.numpy(), fused.od_lw.numpy(), "od_lw")
    _check_tau(per_band.od_sw.numpy(), fused.od_sw.numpy(), "od_sw")
    np.testing.assert_allclose(per_band.planck_hl.numpy(),
                               fused.planck_hl.numpy(), rtol=1e-5)


@pytest.mark.parametrize("kernel, pack, region", [
    (taumol_lw.taumol_lw_kernel,
     lambda c, gt: taumol_lw.pack_coeffs(c, gt.chi_mls), "lw"),
    (taumol_sw.taumol_sw_kernel, lambda c, gt: taumol_sw.pack_coeffs(c),
     "sw")])
def test_kernel_wrappers_refuse_cpu_tensors(coeffs, kernel, pack, region):
    """The kernel wrappers take CUDA float32 tensors only and check that
    before they build or launch anything."""
    _, pc, gt = coeffs
    fc, ic = pack(pc, gt)
    tables = getattr(gt, region)
    before = taumol_lw.launches + taumol_sw.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(fc, ic, tables)
    assert taumol_lw.launches + taumol_sw.launches == before


def test_pack_coeffs_layout(coeffs):
    """Cells are row-major (column, level) in both packers, TOA first
    after flip_levels, with the fields in the kernels' order."""
    _, pc, gt = coeffs
    c = pc.flip_levels()
    fc, ic = taumol_lw.pack_coeffs(c, gt.chi_mls)
    n = c.jp.numel()
    assert fc.shape == (len(taumol_lw.F_FIELDS), n) and fc.is_contiguous()
    assert ic.shape == (len(taumol_lw.I_FIELDS), n) and ic.dtype == torch.int32
    np.testing.assert_array_equal(
        fc[taumol_lw.F_FIELDS.index("colh2o")].numpy(),
        c.colh2o.reshape(-1).numpy())
    fs, is_ = taumol_sw.pack_coeffs(c)
    np.testing.assert_array_equal(
        fs[taumol_sw.F_FIELDS.index("fac01")].numpy(),
        c.fac01_sw.reshape(-1).numpy())
    np.testing.assert_array_equal(is_[0].numpy(),
                                  c.jp.reshape(-1).numpy())


# ---- the CUDA sources agree with the plain versions' layout ----

def _cu(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ecrad_tpu_torch", "csrc", name)
    with open(path) as f:
        return f.read()


def _enum(src, name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def _int_array(src, name):
    body = re.search(r"%s\[\w*\] = \{([^}]*)\}" % name, src).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]


@pytest.mark.parametrize("mod, src, names, consts", [
    (taumol_lw, "taumol_lw.cu", fused_tables.lw_table_names(),
     [c[0] for c in fused_tables.LW_CONSTS]),
    (taumol_sw, "taumol_sw.cu", fused_tables.sw_table_names(), None)])
def test_cuda_sources_match_the_plain_layout(mod, src, names, consts):
    """Field order, table ids, band widths and term slots are written
    twice, in the plain module and in its .cu file; they must agree."""
    s = _cu(src)
    assert _enum(s, "F") == [f.upper() for f in mod.F_FIELDS] + ["NF"]
    assert _enum(s, "I") == [f.upper() for f in mod.I_FIELDS] + ["NI"]
    named = _enum(s, "Named")
    first = int(re.search(r"enum Named \{\s*\w+ = (\d+)", s).group(1))
    assert [n.lower() for n in named[:-1]] == names[first:]
    assert first + len(named) - 1 == len(names)
    assert _int_array(s, "c_ng") == mod.NG
    assert _int_array(s, "c_goff") == mod.G_OFF
    # both kernels walk bands, not g-points: their warps' band lists take
    # every band once (tests/test_torch_taumol_design.py)
    assert "c_band" not in s
    body = re.search(r"c_warp_bands(?:\[\w+\])+ = \{(.*?)\};", s,
                     re.S).group(1)
    bands = [int(x) for x in re.findall(r"\d+", body)]
    band0 = 1 if mod is taumol_lw else 16
    assert sorted(b for b in bands if b) == list(range(band0,
                                                       band0 + len(mod.NG)))
    if consts is not None:
        assert [c.lower() for c in _enum(s, "C")[:-1]] == consts
    k1, k2 = (mod.K_TAU, mod.K_PF) if mod is taumol_lw \
        else (mod.K_TAUG, mod.K_TAUR)
    a1, a2 = ("c_ktau", "c_kpf") if mod is taumol_lw \
        else ("c_ktaug", "c_ktaur")
    assert _int_array(s, a1) == [0] + list(np.cumsum(k1))
    assert _int_array(s, a2) == [0] + list(np.cumsum(k2))
