"""PyTorch port: the host-model coupling (coupling.py, the IFS
RADIATION_SCHEME adapter) against the JAX package.

- The pinned values of tests/test_coupling.py: the SW band weights of
  the UV and PAR ranges, the Martin et al. (1994) droplet radius, the Sun
  and Rikus (1999, rev. Sun 2001) ice radius and the two decorrelation
  length schemes, each against the same independent float64
  transcription of the IFS routine.
- radiation_scheme, unpack_host_outputs and uv_par_fluxes against the
  JAX package's on host arrays made of make_clouds(make_columns(6, 12, 0))
  (water vapour and ozone from the columns, rain and snow, latitudes from
  pole to pole, land and sea), with the SYNTHETIC LUT files of
  inputs.write_synthetic_luts: McICA (the SW albedo by overlap weights,
  so each band goes to its largest-weight interval) and Tripleclouds
  with the SW albedo by nearest interval and the LW derivatives. What
  radiation_scheme hands radiation() (every field of the packed single
  level, thermodynamics, gases, cloud and aerosol: the effective radii,
  the overlap parameters) against what the JAX package's hands its
  radiation(); unpack_host_outputs of the port's fluxes against the JAX
  package's unpack_host_outputs of the same fluxes. radiation() itself
  is held to the JAX package's by the solvers' parity tests
  (tests/test_torch_mcica_slice.py, tests/test_torch_tripleclouds.py),
  and its spectral outputs by tests/test_torch_spectral.py; the JAX
  package's own tests of radiation_scheme read the reference files,
  which are absent. Bounds: float64 within 1e-9 of each field's largest
  magnitude, float32 within 1e-5 of it (floor 1).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.coupling import (cloud_overlap_decorr_len,
                                      get_sw_weights, ice_effective_radius,
                                      liquid_effective_radius,
                                      radiation_scheme, unpack_host_outputs,
                                      uv_par_fluxes)
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.optics.rrtmg.gas_optics import WAVENUM1_SW, WAVENUM2_SW

import test_torch_spectral as spectral

NCOL, NLEV, SEED = 6, 12, 0
CONFIGS = {
    "mcica": lambda luts: pconfig.mcica_slice_config(
        **luts, do_surface_sw_spectral_flux=True),
    "tripleclouds": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, use_aerosols=False, do_surface_sw_spectral_flux=True,
        do_nearest_spectral_sw_albedo=True),
}


def host_arrays():
    """RADIATION_SCHEME's arguments as numpy arrays."""
    from ecrad_tpu_torch.constants import GAS_INDEX
    c = make_clouds(make_columns(NCOL, NLEV, SEED), SEED)
    return dict(
        pressure_hl=c["pressure_hl"], temperature_hl=c["temperature_hl"],
        cos_sza=c["cos_sza"], skin_temperature=c["skin_temperature"],
        sw_albedo=c["sw_albedo"], lw_emissivity=c["lw_emissivity"],
        q=c["mixing_ratio"][:, :, GAS_INDEX["h2o"]],
        o3_mmr=c["mixing_ratio"][:, :, GAS_INDEX["o3"]],
        q_liq=c["q_liq"], q_ice=c["q_ice"], cloud_frac=c["fraction"],
        q_rain=0.1 * c["q_liq"], q_snow=0.2 * c["q_ice"],
        sin_latitude=np.linspace(-0.99, 0.99, NCOL),
        land_frac=np.tile([0.0, 1.0], NCOL // 2),
        solar_irradiance=float(c["solar_irradiance"]))


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")


def _captured(module, monkeypatch):
    """Replace module.radiation by a recorder of its arguments; returns
    the list they go to."""
    calls = []
    monkeypatch.setattr(module, "radiation",
                        lambda *args: calls.append(args) or None)
    return calls


def _fields(obj):
    """{name: numpy float64} of a dataclass's array fields (a GasConcs'
    mixing ratios, whatever the package)."""
    import dataclasses as dc
    return {f.name: np.asarray(getattr(obj, f.name), np.float64)
            for f in dc.fields(obj)
            if hasattr(getattr(obj, f.name), "shape")}


@pytest.fixture(scope="module")
def results(luts):
    """{(config, dtype): (port, jax)}, each {"inputs": {field}, "host":
    {field}}: what radiation_scheme hands radiation(), and
    unpack_host_outputs of the port's fluxes."""
    import jax
    import jax.numpy as jnp
    from ecrad_tpu import coupling as jcoupling
    from ecrad_tpu.interface import setup_radiation as jax_setup
    from ecrad_tpu.types import Flux as JaxFlux
    from ecrad_tpu_torch import coupling as pcoupling
    golden = spectral.golden_tool()
    host = host_arrays()
    out = {}
    for name, make in CONFIGS.items():
        for dtype in ("float32", "float64"):
            cfg = dataclasses.replace(make(luts), dtype=dtype)
            with jax.enable_x64(dtype == "float64"), \
                    pytest.MonkeyPatch.context() as mp:
                pcalls = _captured(pcoupling, mp)
                jcalls = _captured(jcoupling, mp)
                setup = setup_radiation(cfg, device="cpu")
                radiation_scheme(setup, **host)
                jsetup = jax_setup(golden.jax_config(cfg, dtype))
                jcoupling.radiation_scheme(jsetup, **{
                    k: (jnp.asarray(v, dtype) if isinstance(v, np.ndarray)
                        else v) for k, v in host.items()})
                mp.undo()
                flux = pcoupling.radiation(setup, *pcalls[0][1:])
                unpack = dict(cos_sza=host["cos_sza"],
                              skin_temperature=host["skin_temperature"],
                              lw_emissivity=host["lw_emissivity"])
                got = unpack_host_outputs(setup, flux, **unpack)
                ref = jcoupling.unpack_host_outputs(
                    jsetup, JaxFlux(**{k: jnp.asarray(v.numpy())
                                       for k, v in flux.fields()}),
                    **{k: jnp.asarray(v, dtype) for k, v in unpack.items()})
            packed = [{f"{type(o).__name__}.{k}": v
                       for o in c[1:] for k, v in _fields(o).items()}
                      for c in (pcalls[0], jcalls[0])]
            hosts = [{k: np.asarray(getattr(o, k), np.float64)
                      for k in o._fields if getattr(o, k) is not None}
                     for o in (got, ref)]
            out[name, dtype] = tuple({"inputs": p, "host": h}
                                     for p, h in zip(packed, hosts))
    return out


CASES = [(n, w) for n in CONFIGS for w in ("inputs", "host")]


@pytest.mark.parametrize("config, what", CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matches_jax(results, config, what, dtype):
    got, ref = (r[what] for r in results[config, dtype])
    assert set(got) == set(ref)
    if what == "host":
        assert {"sw_diffuse_band", "sw_direct_band", "flux_uv",
                "flux_par"} <= set(got)
    else:
        assert {"Cloud.re_liq", "Cloud.re_ice", "Cloud.overlap_param",
                "GasConcs.mixing_ratio"} <= set(got)
    tol = spectral.F64_TOL if dtype == "float64" else spectral.F32_TOL
    bad = {}
    for k, a in got.items():
        assert a.shape == ref[k].shape and np.isfinite(a).all(), k
        err = np.abs(a - ref[k]).max() / max(np.abs(ref[k]).max(), 1.0)
        if err > tol:
            bad[k] = err
    assert not bad, bad


def test_host_outputs_are_consistent(luts):
    """Net fluxes are dn - up; the albedo-band split sums to the surface
    SW; DNI times mu0 is the direct flux; 0 < UV < PAR < surface SW by
    day; the LW derivative is 1 at the surface; a scalar latitude gives
    the per-column result of that latitude everywhere; a solar scaling of
    ones changes nothing."""
    setup = setup_radiation(dataclasses.replace(
        CONFIGS["tripleclouds"](luts), dtype="float64"), device="cpu")
    h = host_arrays()
    flux = radiation_scheme(setup, **h)
    out = unpack_host_outputs(setup, flux, cos_sza=h["cos_sza"],
                              skin_temperature=h["skin_temperature"],
                              lw_emissivity=h["lw_emissivity"])
    port = {k: v.numpy() for k, v in flux.fields()}
    host = {k: getattr(out, k).numpy() for k in out._fields
            if getattr(out, k) is not None}
    np.testing.assert_array_equal(host["flux_sw"],
                                  port["sw_dn"] - port["sw_up"])
    np.testing.assert_allclose(
        (host["sw_diffuse_band"] + host["sw_direct_band"]).sum(-1),
        port["sw_dn"][:, -1], rtol=1e-12)
    h = host_arrays()
    day = h["cos_sza"] > 0.05
    assert day.sum() >= 2
    np.testing.assert_allclose((host["flux_dir_into_sun"] * h["cos_sza"])[day],
                               host["flux_dir"][day], rtol=1e-12)
    assert ((0 < host["flux_uv"][day]) & (host["flux_uv"][day]
                                         < host["flux_par"][day])).all()
    assert (host["flux_par"][day] < port["sw_dn"][day, -1]).all()
    np.testing.assert_allclose(host["lw_derivative"][:, -1], 1.0)
    uv, par, par_clear = uv_par_fluxes(flux)
    assert (par_clear[torch.as_tensor(day)] >= par[torch.as_tensor(day)]
            - 1e-6).all()
    same = dict(h, sin_latitude=np.full(NCOL, 0.5))
    a = radiation_scheme(setup, **same)
    b = radiation_scheme(setup, **dict(h, sin_latitude=0.5))
    c = radiation_scheme(setup, **dict(h, spectral_solar_scaling=np.ones(
        14)))
    for k, v in a.fields():
        np.testing.assert_allclose(getattr(b, k).numpy(), v.numpy(),
                                   rtol=1e-12, err_msg=k)
    for k, v in c.fields():
        assert torch.equal(v, getattr(flux, k)), k


# ---- the pinned values of tests/test_coupling.py ----

def test_get_sw_weights_par_band():
    bands, weights = get_sw_weights(0.4e-6, 0.7e-6)
    assert len(bands) >= 2
    assert (weights > 0).all() and (weights <= 1.0).all()
    for b, w in zip(bands, weights):
        if WAVENUM1_SW[b] >= 0.01 / 0.7e-6 and \
                WAVENUM2_SW[b] <= 0.01 / 0.4e-6:
            assert w == pytest.approx(1.0)
    from ecrad_tpu.coupling import get_sw_weights as jax_weights
    for rng in ((0.2e-6, 0.4415e-6), (0.4e-6, 0.7e-6)):
        for x, y in zip(get_sw_weights(*rng), jax_weights(*rng)):
            np.testing.assert_array_equal(x, y)


def test_get_sw_weights_outside_range():
    with pytest.raises(ValueError):
        get_sw_weights(100e-6, 200e-6)


def test_liquid_effective_radius_pinned():
    """ifs/liquid_effective_radius.F90 case 2 (:127-198), transcribed."""
    p = np.array([[85000.0], [70000.0], [85000.0], [85000.0]])
    t = np.array([[280.0], [265.0], [280.0], [280.0]])
    cf = np.array([[0.8], [0.5], [0.8], [0.0005]])  # last: inactive
    ql = np.array([[2e-4], [5e-5], [2e-4], [2e-4]])
    qr = np.array([[0.0], [0.0], [5e-5], [0.0]])
    land = np.array([0.0, 1.0, 0.0, 0.0])           # sea, land, sea, sea
    T = torch.as_tensor
    got = liquid_effective_radius(T(p), T(t), T(cf), T(ql), T(qr),
                                  T(land)[:, None]).numpy()

    def expect(p, t, cf, ql, qr, is_land):
        ccn = 900.0 if is_land else 50.0
        disp = 0.69 if is_land else 0.77
        ntot = (-2.10e-4 * ccn * ccn + 0.568 * ccn - 27.9 if is_land
                else -1.15e-3 * ccn * ccn + 0.963 * ccn + 5.30)
        ratio = (0.222 / disp) ** 0.333
        rho = 1000.0 * p / (287.058 * t)
        lwc, rwc = rho * ql / cf, rho * qr / cf
        wood = 1.0
        if rwc > 0 and lwc > 1e-12:
            rr = rwc / lwc
            wood = (1.0 + rr) ** 0.666 / (1.0 + 0.2 * ratio * rr)
        re3 = 3.0 * (lwc + rwc) / (4.0 * np.pi * ntot * disp)
        return np.clip(wood * 100.0 * np.exp(0.333 * np.log(re3)), 4.0,
                       30.0) * 1e-6

    assert got[0, 0] == pytest.approx(
        expect(85000.0, 280.0, 0.8, 2e-4, 0.0, False), rel=1e-5)
    assert got[1, 0] == pytest.approx(
        expect(70000.0, 265.0, 0.5, 5e-5, 0.0, True), rel=1e-5)
    assert got[2, 0] == pytest.approx(
        expect(85000.0, 280.0, 0.8, 2e-4, 5e-5, False), rel=1e-5)
    assert got[3, 0] == pytest.approx(4.0e-6, rel=1e-6)
    assert got[2, 0] != got[0, 0]


def test_ice_effective_radius_pinned():
    """ifs/ice_effective_radius.F90 case 1 (:100-157), transcribed."""
    p = np.array([[40000.0, 25000.0, 40000.0]])
    t = np.array([[230.0, 210.0, 230.0]])
    cf = np.array([[0.6, 0.3, 0.0]])               # last: inactive
    qi = np.array([[1e-5, 2e-6, 1e-5]])
    qs = np.array([[0.0, 1e-6, 0.0]])
    T = torch.as_tensor
    got = ice_effective_radius(T(p), T(t), T(cf), T(qi), T(qs)).numpy()

    def expect(p, t, cf, qi, qs):
        rho = 1000.0 * p / (287.058 * t)
        iwc = rho * (qi + qs) / cf
        diam = (1.2351 + 0.0105 * (t - 273.16)) * (
            45.8966 * iwc ** 0.2214 + 0.7957 * iwc ** 0.2535 * (t - 83.15))
        return np.clip(diam, 20.0, 155.0) * 0.64952 * 1e-6

    assert got[0, 0] == pytest.approx(
        expect(40000.0, 230.0, 0.6, 1e-5, 0.0), rel=1e-5)
    assert got[0, 1] == pytest.approx(
        expect(25000.0, 210.0, 0.3, 2e-6, 1e-6), rel=1e-5)
    assert got[0, 2] == pytest.approx(80.0 * 0.64952e-6, rel=1e-6)


def test_cloud_overlap_decorr_len_pinned():
    """ifs/cloud_overlap_decorr_len.F90 (:96-107), both schemes."""
    lat_deg = np.array([0.0, 30.0, 60.0, -45.0])
    sinlat = torch.as_tensor(np.sin(np.deg2rad(lat_deg)))
    np.testing.assert_allclose(cloud_overlap_decorr_len(sinlat).numpy(),
                               2.899 - 0.02759 * np.abs(lat_deg), rtol=1e-5)
    coslat = np.cos(np.deg2rad(lat_deg))
    np.testing.assert_allclose(
        cloud_overlap_decorr_len(sinlat, scheme=2).numpy(),
        0.75 + 2.149 * coslat * coslat, rtol=1e-5)
