"""PyTorch port: kernels B6 and B7's plain versions
(ecrad_tpu_torch/ops/spartacus_reftrans.py sw_reftrans_levels_plain,
lw_reftrans_levels_plain) against the JAX package's CPU path
(ecrad_tpu/ops/spartacus_reftrans.py sw_reftrans_levels /
lw_reftrans_levels with use_pallas=False, its lax.scan over levels).

Inputs as tools/check_kernel_equivalence.py:143-163 builds them
(RandomState(7), 7 levels, 16 g-points, 133 columns, mu0 at the 1e-10
clamp in every 17th column, a level with no 3D cell, clear layers), for
3 and 2 regions. Bounds:
- float64: 1e-10 of each output's largest value;
- float32: 2e-5 of each output's largest value (the JAX package's
  kernel-vs-fallback bound, check_kernel_equivalence.py:209,221). Where
  an output misses it, the float64 escape of :186-196 applies: the port
  must be no farther from the float64 truth than twice the JAX fallback
  is (the truth tests/goldens/ke_spartacus_f64.npz for 3 regions, the
  JAX package at float64 for 2). That is the expected case for RD/TD
  near the SW resonance, where the port computes in float64.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.config import RadiationConfig
from ecrad_tpu.ops import spartacus_reftrans as jrt
from ecrad_tpu_torch.ops import spartacus_reftrans as prt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NLEV, NG, NCOL = 7, 16, 133
TOL = {"float64": 1e-10, "float32": 2e-5}


def case(nreg, seed=7):
    """check_kernel_equivalence.py's inputs, drawn in its order."""
    rng = np.random.RandomState(seed)
    r = lambda *s, lo=0.0, hi=1.0: (lo + (hi - lo) * rng.rand(*s)).astype(
        np.float32)
    c = dict(od=r(NLEV, nreg, NG, NCOL, hi=6.0),
             ssa=r(NLEV, nreg, NG, NCOL, lo=0.05, hi=0.999),
             g=r(NLEV, nreg, NG, NCOL, hi=0.8),
             trd=r(NLEV, nreg, nreg, 1, NCOL, hi=0.5),
             trf=r(NLEV, nreg, nreg, 1, NCOL, hi=0.5))
    mu0 = (0.05 + 0.95 * rng.rand(NCOL)).astype(np.float32)
    mu0[::17] = 1e-10
    c["mu0"] = mu0
    c["use3d"] = rng.rand(NLEV, NG, NCOL) > 0.4
    c["use3d"][0] = False
    c["clear"] = rng.rand(NLEV, NCOL) > 0.7
    c["se"] = r(NLEV, NG, NCOL, lo=0.5, hi=1.0)
    c["pt"] = r(NLEV, NG, NCOL, hi=40.0)
    c["pb"] = r(NLEV, NG, NCOL, hi=40.0)
    c["fr"] = r(NLEV, nreg, 1, NCOL)
    return c


SW_KEYS = ("od", "ssa", "g", "trd", "trf", "mu0", "use3d", "clear")
LW_KEYS = ("od", "ssa", "g", "trd", "se", "pt", "pb", "fr", "use3d", "clear")
SW_NAMES = ("sw_R", "sw_T", "sw_RD", "sw_TD", "sw_TDD")
LW_NAMES = ("lw_R", "lw_T", "lw_SU", "lw_SD")


def _jax(kind, nreg, c, dtype, scattering=True):
    cfg = RadiationConfig(do_lw_cloud_scattering=scattering)
    fn = jrt.sw_reftrans_levels if kind == "sw" else jrt.lw_reftrans_levels
    keys = SW_KEYS if kind == "sw" else LW_KEYS
    with jax.enable_x64(dtype == "float64"):
        args = [jnp.asarray(c[k]) if c[k].dtype == bool
                else jnp.asarray(c[k], dtype) for k in keys]
        return [np.asarray(x) for x in fn(cfg, nreg, *args, False)]


def _port(kind, nreg, c, dtype, scattering=True):
    t = lambda k: torch.as_tensor(c[k] if c[k].dtype == bool
                                  else c[k].astype(dtype))
    n2 = nreg * nreg
    if kind == "sw":
        args = [t(k) for k in SW_KEYS]
        args[3], args[4] = args[3][:, :, :, 0], args[4][:, :, :, 0]
        h = prt.sw_reftrans_levels(8.0, *args).numpy()
        return [h[:, k * n2:(k + 1) * n2].reshape(NLEV, nreg, nreg, NG, NCOL)
                for k in range(5)]
    args = [t(k) for k in LW_KEYS]
    args[3], args[7] = args[3][:, :, :, 0], args[7][:, :, 0]
    h = prt.lw_reftrans_levels(8.0, scattering, *args).numpy()
    return [h[:, :n2].reshape(NLEV, nreg, nreg, NG, NCOL),
            h[:, n2:2 * n2].reshape(NLEV, nreg, nreg, NG, NCOL),
            h[:, 2 * n2:2 * n2 + nreg], h[:, 2 * n2 + nreg:]]


@pytest.fixture(scope="module", params=[3, 2])
def runs(request):
    nreg = request.param
    c = case(nreg)
    out = {"nreg": nreg, "case": c}
    for kind in ("sw", "lw"):
        for dtype in ("float32", "float64"):
            out[kind, dtype] = (_jax(kind, nreg, c, dtype),
                                _port(kind, nreg, c, dtype))
    return out


def _truth(runs, kind):
    if runs["nreg"] == 3:
        with np.load(os.path.join(REPO, "tests", "goldens",
                                  "ke_spartacus_f64.npz")) as z:
            return [z[n] for n in (SW_NAMES if kind == "sw" else LW_NAMES)]
    return runs[kind, "float64"][0]


def _scale(b):
    return max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_reftrans_f64_matches_jax(runs, kind):
    ref, got = runs[kind, "float64"]
    for name, a, b in zip(SW_NAMES if kind == "sw" else LW_NAMES, got, ref):
        assert a.dtype == np.float64 and a.shape == b.shape, name
        err = np.abs(a - b).max() / _scale(b)
        assert err <= TOL["float64"], (name, err)


@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_reftrans_f32_matches_jax(runs, kind):
    ref, got = runs[kind, "float32"]
    truth = _truth(runs, kind)
    bad = {}
    for name, a, b, t in zip(SW_NAMES if kind == "sw" else LW_NAMES, got,
                             ref, truth):
        assert a.dtype == np.float32 and a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        scale = _scale(b)
        err = np.abs(a - b).max() / scale
        if err <= TOL["float32"]:
            continue
        port_err = np.abs(a - t).max() / scale
        jax_err = np.abs(b - t).max() / scale
        if port_err > max(TOL["float32"], 2.0 * jax_err):
            bad[name] = (err, port_err, jax_err)
    assert not bad, bad


def test_golden_truth_is_this_case():
    """ke_spartacus_f64.npz was made from exactly these inputs: the JAX
    package's float64 run of them reproduces it."""
    c = case(3)
    got = _jax("sw", 3, c, "float64")[0]
    with np.load(os.path.join(REPO, "tests", "goldens",
                              "ke_spartacus_f64.npz")) as z:
        ref = z["sw_R"]
    assert np.abs(got - ref).max() <= 1e-10


def test_lw_no_scattering_fallback_matches_jax():
    c = case(3)
    ref = _jax("lw", 3, c, "float32", scattering=False)
    got = _port("lw", 3, c, "float32", scattering=False)
    for name, a, b in zip(LW_NAMES, got, ref):
        assert np.abs(a - b).max() / _scale(b) <= TOL["float32"], name


def test_counts_and_masks(runs):
    """The doubling counts: -1 exactly where use3d is off (the no-3D
    level included), the compare-chain count elsewhere; clear layers
    keep only their clear region; sub-horizon columns stay finite."""
    c = runs["case"]
    nreg = runs["nreg"]
    t = lambda k: torch.as_tensor(c[k])
    counts = torch.empty((NLEV, NG, NCOL), dtype=torch.int8)
    h = prt.sw_reftrans_levels(8.0, t("od"), t("ssa"), t("g"),
                               t("trd")[..., 0, :], t("trf")[..., 0, :],
                               t("mu0"), t("use3d"), t("clear"),
                               counts=counts)
    n = counts.numpy()
    assert ((n < 0) == ~c["use3d"]).all()
    assert n.max() >= 4 and (n[c["use3d"]] >= 0).all()
    # the caps keep every cell within the TPU kernel's static count
    cfg = RadiationConfig()
    assert n.max() <= prt.sw_fixed_squarings(cfg) == jrt.sw_fixed_squarings(
        cfg)
    assert prt.lw_fixed_squarings(cfg) == jrt.lw_fixed_squarings(cfg)
    assert np.isfinite(h.numpy()).all()
    rows = h.numpy().reshape(NLEV, 5, nreg, nreg, NG, NCOL)
    cl = np.broadcast_to(c["clear"][:, None, None, None, None, :],
                         rows.shape).copy()
    cl[:, :, 0, 0] = False
    assert (rows[cl] == 0).all()
