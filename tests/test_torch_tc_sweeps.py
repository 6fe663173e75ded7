"""PyTorch port: the Tripleclouds pieces against the JAX package, on the
CPU at small sizes.

- Kernel B5's plain versions (solvers/tripleclouds.py tc_sw_sweeps_plain,
  tc_lw_sweeps_plain) against the JAX package's Pallas sweeps
  (ecrad_tpu/ops/adding_fused.py tc_sw_sweeps, tc_lw_sweeps) run in
  interpret mode, its own CPU form (tests/test_adding_fused.py), on
  random layer optics, overlap matrices and clear-layer patterns: 3
  regions (the Pallas form has no other). Bound: 2e-6 of each profile's
  largest value, the JAX package's bound for its fused sweeps against its
  scan (tests/test_adding_fused.py:35-39).
- The port's SW and LW Tripleclouds solvers (plain sweeps) against the
  JAX solvers on their lax.scan bodies (ECRAD_ADDING=scan), 2 and 3
  regions, on the same random band and g-point optics, at float32 (bound
  2e-6 of each profile's largest value) and float64 (1e-12).
- calc_region_properties (2 and 3 regions, gamma and lognormal) and
  calc_overlap_matrices (alpha and beta overlap) at float64 (1e-13) and
  float32 (rel 2e-6).
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.ops import adding_fused as jfused
from ecrad_tpu.solvers import tripleclouds as jtc
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.solvers import tripleclouds as ptc

from test_torch_slice import _golden_tool

NLEV, NG, NCOL, NB = 9, 7, 11, 4
F32_REL = 2e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _clouds(rng, nlev=NLEV, ncol=NCOL):
    """Cloud fractions with clear layers, overcast layers and values under
    the threshold, fractional std and overlap parameters."""
    frac = rng.uniform(0.0, 1.0, (ncol, nlev))
    frac[rng.uniform(size=(ncol, nlev)) < 0.35] = 0.0
    frac[rng.uniform(size=(ncol, nlev)) < 0.1] = 1.0
    frac[0, :3] = [5e-7, 0.0, 2e-6]
    frac[-1] = 0.0                            # one cloud-free column
    return dict(fraction=frac, fractional_std=rng.uniform(0.2, 3.0,
                                                          (ncol, nlev)),
                overlap_param=rng.uniform(0.0, 1.0, (ncol, nlev - 1)))


# ---- region properties and overlap matrices ----

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nreg, gamma, beta", [
    (3, True, False), (3, False, True), (2, True, True), (2, False, False)])
def test_regions_and_overlap_match_jax(dtype, nreg, gamma, beta):
    c = _clouds(np.random.RandomState(1))
    tol = 1e-13 if dtype == "float64" else F32_REL
    with jax.enable_x64(dtype == "float64"):
        j = {k: jnp.asarray(v, dtype) for k, v in c.items()}
        jf, js = jtc.calc_region_properties(nreg, gamma, j["fraction"],
                                            j["fractional_std"], 1e-6)
        ju, jv, jcc = jtc.calc_overlap_matrices(jf, j["overlap_param"], 0.5,
                                                1e-6, beta)
        ref = [np.asarray(x) for x in (jf, js, ju, jv, jcc)]
    p = {k: torch.as_tensor(v, dtype=getattr(torch, dtype))
         for k, v in c.items()}
    pf, ps = ptc.calc_region_properties(nreg, gamma, p["fraction"],
                                        p["fractional_std"], 1e-6)
    got = (pf, ps) + ptc.calc_overlap_matrices(pf, p["overlap_param"], 0.5,
                                               1e-6, beta)
    for name, x, y in zip(("fracs", "scaling", "u", "v", "cover"), got, ref):
        assert x.dtype == getattr(torch, dtype) and x.shape == y.shape, name
        assert _rel(x.numpy(), y) <= tol, (name, _rel(x.numpy(), y))


def test_region_split_and_cover_are_physical():
    c = _clouds(np.random.RandomState(2))
    frac = torch.as_tensor(c["fraction"])
    f, s = ptc.calc_region_properties(3, True, frac,
                                      torch.as_tensor(c["fractional_std"]),
                                      1e-6)
    torch.testing.assert_close(f.sum(-1), torch.ones_like(frac))
    cloudy = frac >= 1e-6
    # the two cloudy regions keep the mean optical depth
    torch.testing.assert_close((f[..., 1] * s[..., 1] + f[..., 2] * s[..., 2]
                                )[cloudy], frac[cloudy])
    _, _, cover = ptc.calc_overlap_matrices(
        f, torch.as_tensor(c["overlap_param"]), 0.5, 1e-6)
    assert bool(((cover >= frac.max(1).values - 1e-12)
                 & (cover <= 1 + 1e-12)).all())
    assert float(cover[-1]) == 0.0


# ---- the region sweeps (B5's plain versions) against the Pallas form ----

def _sweep_inputs(seed, nreg=3, nlev=NLEV, ng=NG, ncol=NCOL):
    rng = np.random.RandomState(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    lay = (nlev, nreg, ng, ncol)
    clear = rng.uniform(size=(nlev, ncol)) < 0.4
    clear[:, 0] = True                          # a clear column
    clear[nlev // 2:, 1] = True
    return dict(
        sw=(u(0, 0.4, *lay), u(0.3, 0.6, *lay), u(0, 0.3, *lay),
            u(0, 0.4, *lay), u(0.2, 0.9, *lay)),
        lw=(u(0, 0.3, *lay), u(0.3, 0.6, *lay), u(0, 20, *lay),
            u(0, 20, *lay)),
        v=u(0, 1, nlev + 1, nreg, nreg, ncol),
        u=u(0, 1, nlev, nreg, nreg, ncol), clear=clear,
        alb_diff=u(0, 0.8, ng, ncol), alb_dir=u(0, 0.8, ng, ncol),
        mu0=u(0.05, 1, ncol), incoming=u(0, 1300, ng, ncol),
        frac=u(0.05, 0.6, nreg, ncol), emission=u(0, 400, ng, ncol),
        albedo=u(0, 0.2, ng, ncol))


def _clear_rows(clear):
    """(nlev, ncol) clear flags -> the Pallas sweeps' (nlev, 3, ncol)
    rows [clear | clear above | clear below], outside the atmosphere
    clear."""
    one = np.ones_like(clear[:1])
    return np.stack([clear, np.concatenate([one, clear[:-1]]),
                     np.concatenate([clear[1:], one])], 1).astype(np.float32)


def _jax_sw_profiles(a):
    """The JAX package's Pallas SW sweeps (interpret mode) and its
    solver's profile assembly (ecrad_tpu/solvers/tripleclouds.py:
    259-347)."""
    nlev, nreg = a["sw"][0].shape[:2]
    clear_rows = _clear_rows(a["clear"])
    alb = np.broadcast_to(a["alb_diff"], (nreg,) + a["alb_diff"].shape)
    albdir = np.broadcast_to(a["mu0"][None] * a["alb_dir"], alb.shape)
    keep = (~a["clear"][-1])[None, None] | (np.arange(nreg) == 0)[:, None,
                                                                    None]
    init_dir = a["incoming"][None] * a["frac"][:, None, :]
    _, albdir_top, _, dn = jfused.tc_sw_sweeps(
        *a["sw"], a["v"].reshape(nlev + 1, nreg * nreg, -1), clear_rows,
        np.concatenate([np.where(keep, alb, 0), np.where(keep, albdir, 0)]),
        init_dir, interpret=True)
    dn = np.asarray(dn)
    top = lambda x: np.asarray(x)[None]
    return (np.concatenate([top((init_dir * np.asarray(albdir_top)).sum(0)),
                            dn[:, 0:3].sum(1)]),
            np.concatenate([np.zeros_like(top(init_dir[0])),
                            dn[:, 3:6].sum(1)]),
            np.concatenate([top(init_dir.sum(0)), dn[:, 6:9].sum(1)])
            * a["mu0"])


def _jax_lw_profiles(a):
    nlev, nreg = a["lw"][0].shape[:2]
    clear_rows = _clear_rows(a["clear"])
    alb = np.broadcast_to(a["albedo"], (nreg,) + a["albedo"].shape)
    src = a["frac"][:, None, :] * a["emission"][None]
    src_top, _, dn = jfused.tc_lw_sweeps(
        *a["lw"], a["v"].reshape(nlev + 1, nreg * nreg, -1),
        a["u"].reshape(nlev, nreg * nreg, -1), clear_rows,
        np.concatenate([alb, src]), interpret=True)
    dn = np.asarray(dn)
    return (np.concatenate([np.asarray(src_top).sum(0)[None],
                            dn[:, 0:3].sum(1)]),
            np.concatenate([np.zeros_like(a["albedo"])[None],
                            dn[:, 3:6].sum(1)]))


@pytest.fixture(scope="module", params=[11, 12])
def sweep_case(request):
    a = _sweep_inputs(request.param)
    return a, _jax_sw_profiles(a), _jax_lw_profiles(a)


def _port_sweeps(a):
    t = {k: (tuple(torch.as_tensor(x) for x in v) if isinstance(v, tuple)
             else torch.as_tensor(v)) for k, v in a.items()}
    sw = ptc.tc_sw_sweeps(*t["sw"], t["v"], t["clear"], t["alb_diff"],
                          t["alb_dir"], t["mu0"], t["incoming"], t["frac"])
    lw = ptc.tc_lw_sweeps(*t["lw"], t["v"], t["u"], t["clear"],
                          t["emission"], t["albedo"], t["frac"])
    return sw, lw


@pytest.mark.parametrize("region", ["sw", "lw"])
def test_plain_sweeps_match_the_pallas_sweeps(sweep_case, region):
    a, jsw, jlw = sweep_case
    sw, lw = _port_sweeps(a)
    got, ref = (sw, jsw) if region == "sw" else (lw, jlw)
    for name, x, y in zip(("up", "dn", "dn_direct"), got, ref):
        assert x.dtype == torch.float32 and x.shape == y.shape, name
        assert _rel(x.numpy(), y) <= F32_REL, (name, _rel(x.numpy(), y))


def test_plain_sweeps_skip_mixing_in_clear_columns(sweep_case):
    """A column clear at every level never mixes: its fluxes are the
    clear region's alone, whatever its overlap matrices."""
    a = sweep_case[0]
    b = dict(a, v=np.zeros_like(a["v"]), u=np.zeros_like(a["u"]))
    (sw, lw), (sw0, lw0) = _port_sweeps(a), _port_sweeps(b)
    for x, y in zip(sw + lw, sw0 + lw0):
        torch.testing.assert_close(x[..., 0], y[..., 0], rtol=0, atol=0)


# ---- the solvers against the JAX solvers' scan bodies ----

def _solver_inputs(seed, ncol=NCOL, nlev=NLEV, ng=NG, nb=NB):
    rng = np.random.RandomState(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    c = _clouds(rng, nlev, ncol)
    band = np.sort(rng.randint(0, nb, ng))
    band[0], band[-1] = 0, nb - 1
    return c, band, dict(
        od=u(0, 2, ncol, nlev, ng), ssa=u(0, 0.99, ncol, nlev, ng),
        g=u(0, 0.8, ncol, nlev, ng), odc=u(0, 8, ncol, nlev, nb),
        ssac=u(0.3, 0.999, ncol, nlev, nb), gc=u(0.5, 0.9, ncol, nlev, nb),
        cos_sza=u(-0.2, 1, ncol), incoming=u(0, 300, ncol, ng),
        alb_diff=u(0, 0.8, ncol, ng), alb_dir=u(0, 0.8, ncol, ng),
        planck=u(1, 30, ncol, nlev + 1, ng), emission=u(1, 30, ncol, ng),
        albedo=u(0, 0.2, ncol, ng))


SOLVER_CASES = {
    "3reg": dict(nregions=3),
    "3reg_lognormal_beta_scat": dict(
        nregions=3, i_cloud_pdf_shape=pconfig.PdfShape.LOGNORMAL,
        use_beta_overlap=True, do_lw_cloud_scattering=True,
        do_sw_delta_scaling_with_gases=True),
    "2reg_lwscat_noaer": dict(nregions=2, do_lw_cloud_scattering=True,
                              do_lw_aerosol_scattering=False),
}


def _solve_jax(cfg, c, band, x, dtype):
    jcfg = _golden_tool().jax_config(cfg, dtype)
    setup = SimpleNamespace(config=jcfg, spec=SimpleNamespace(
        band_from_reordered_g_sw=band, band_from_reordered_g_lw=band))
    j = lambda v: jnp.asarray(v, dtype)
    cloud = SimpleNamespace(**{k: j(v) for k, v in c.items()})
    sl = SimpleNamespace(cos_sza=j(x["cos_sza"]))
    prev = os.environ.get("ECRAD_ADDING")
    os.environ["ECRAD_ADDING"] = "scan"
    try:
        sw, sw_c, tcc_sw = jtc.solver_tripleclouds_sw(
            setup, sl, cloud, *(j(x[k]) for k in ("od", "ssa", "g", "odc",
                                                  "ssac", "gc", "incoming",
                                                  "alb_diff", "alb_dir")))
        lw, lw_c, tcc_lw, extras = jtc.solver_tripleclouds_lw(
            setup, sl, cloud, *(j(x[k]) for k in ("od", "ssa", "g", "odc",
                                                  "ssac", "gc", "planck",
                                                  "emission", "albedo")))
    finally:
        if prev is None:
            os.environ.pop("ECRAD_ADDING", None)
        else:
            os.environ["ECRAD_ADDING"] = prev
    out = [*sw, *sw_c, tcc_sw, *lw, *lw_c, tcc_lw, extras["lw_derivatives"]]
    return [np.asarray(v) for v in out]


def _solve_port(cfg, c, band, x, dtype):
    t = lambda v: torch.as_tensor(v, dtype=getattr(torch, dtype))
    cloud = SimpleNamespace(**{k: t(v) for k, v in c.items()})
    band = torch.as_tensor(band)
    sw, sw_c, tcc_sw = ptc.solver_tripleclouds_sw(
        cfg, band, cloud, t(x["cos_sza"]),
        *(t(x[k]) for k in ("od", "ssa", "g", "odc", "ssac", "gc",
                            "incoming", "alb_diff", "alb_dir")))
    lw, lw_c, tcc_lw, extras = ptc.solver_tripleclouds_lw(
        cfg, band, cloud, *(t(x[k]) for k in ("od", "ssa", "g", "odc",
                                              "ssac", "gc", "planck",
                                              "emission", "albedo")))
    out = [*sw, *sw_c, tcc_sw, *lw, *lw_c, tcc_lw, extras["lw_derivatives"]]
    return [v.numpy() for v in out]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solvers_match_the_jax_scan(case, dtype):
    cfg = pconfig.tripleclouds_slice_config(do_lw_derivatives=True,
                                            **SOLVER_CASES[case])
    c, band, x = _solver_inputs(5)
    with jax.enable_x64(dtype == "float64"):
        ref = _solve_jax(cfg, c, band, x, dtype)
    got = _solve_port(cfg, c, band, x, dtype)
    tol = 1e-12 if dtype == "float64" else F32_REL
    names = ("sw_up", "sw_dn_diffuse", "sw_dn_direct", "sw_up_clear",
             "sw_dn_diffuse_clear", "sw_dn_direct_clear", "cloud_cover_sw",
             "lw_up", "lw_dn", "lw_up_clear", "lw_dn_clear",
             "cloud_cover_lw", "lw_derivatives")
    bad = {}
    for name, a, b in zip(names, got, ref):
        assert a.dtype == np.dtype(dtype) and a.shape == b.shape, name
        if _rel(a, b) > tol:
            bad[name] = _rel(a, b)
    assert not bad, bad
