"""PyTorch port: two-stream layer optics and the plain versions of kernels
B3 and B3' (the adding level sweeps) against the JAX package.

B3 is held to the JAX package's own bound for its fused sweeps against
the scan (tests/test_adding_fused.py): |diff| / max|ref| <= 2e-6. The JAX
side runs both as the lax.scan sweeps and as its Pallas kernels in
interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.ops import adding_fused as jax_fused
from ecrad_tpu.solvers import adding as jax_adding
from ecrad_tpu.solvers import two_stream as jts
from ecrad_tpu_torch.ops import adding_fused
from ecrad_tpu_torch.solvers import adding, two_stream as pts


def _rand(rng, *shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)


def _cmp(got, ref, tol):
    for x, y in zip(got, ref):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        rel = np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)
        assert rel <= tol, rel


def _sw_args(seed, nlev=17, ng=12, ncol=67):
    rng = np.random.RandomState(seed)
    return (_rand(rng, nlev, ng, ncol, hi=0.4),
            _rand(rng, nlev, ng, ncol, lo=0.3, hi=0.6),
            _rand(rng, nlev, ng, ncol, hi=0.3),
            _rand(rng, nlev, ng, ncol, hi=0.4),
            _rand(rng, nlev, ng, ncol, lo=0.2, hi=0.9),
            _rand(rng, ng, ncol, hi=1300.0),
            _rand(rng, ng, ncol, hi=0.8),
            _rand(rng, ng, ncol, hi=0.8),
            _rand(rng, ncol, lo=0.05))


def _lw_args(seed, nlev=17, ng=12, ncol=67):
    rng = np.random.RandomState(seed)
    return (_rand(rng, nlev, ng, ncol, lo=0.2, hi=0.99),
            _rand(rng, nlev, ng, ncol, hi=50.0),
            _rand(rng, nlev, ng, ncol, hi=50.0),
            _rand(rng, ng, ncol, hi=400.0),
            _rand(rng, ng, ncol, hi=0.2))


@pytest.mark.parametrize("seed", [3, 4])
def test_b3_sw_plain_matches_jax_scan(seed):
    args = _sw_args(seed)
    got = adding.adding_sw(*map(torch.as_tensor, args))
    ref = jax_adding._adding_sw_sequential(
        *map(jnp.asarray, args[:-1]), jnp.asarray(args[-1])[None, :],
        gfirst=True)
    _cmp([g.numpy() for g in got], ref, 2e-6)


def test_b3_sw_plain_matches_jax_interpret_kernel():
    args = _sw_args(5)
    got = adding.adding_sw_plain(*map(torch.as_tensor, args))
    ref = jax_fused.adding_sw_fused(
        *map(jnp.asarray, args[:-1]), jnp.asarray(args[-1])[None, :],
        interpret=True)
    _cmp([g.numpy() for g in got], ref, 2e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_b3_lw_plain_matches_jax_scan(seed):
    args = _lw_args(seed)
    got = adding.lw_no_scattering_fluxes(*map(torch.as_tensor, args))
    ref = jax_adding.lw_no_scattering_fluxes(*map(jnp.asarray, args),
                                             gfirst=True)
    _cmp([g.numpy() for g in got], ref, 2e-6)


def test_b3_lw_plain_matches_jax_interpret_kernel():
    trans, su, sd, emis, alb = _lw_args(6)
    got = adding.lw_no_scattering_fluxes_plain(
        *map(torch.as_tensor, (trans, su, sd, emis, alb)))
    j = lambda x: jnp.asarray(x)
    fd = jax_fused.affine_fused(j(trans), j(sd), jnp.zeros_like(j(emis)),
                                interpret=True)
    fu = jax_fused.affine_fused(j(trans), j(su), j(emis) + j(alb) * fd[-1],
                                reverse=True, interpret=True)
    _cmp([g.numpy() for g in got], (fu, fd), 2e-6)


def _lw_adding_args(seed, nlev=17, ng=12, ncol=67):
    """R, T, Su, Sd (nlev, ng, ncol), emission and albedo (ng, ncol), in
    the ranges LW layers with scattering clouds give them."""
    rng = np.random.RandomState(seed)
    return (_rand(rng, nlev, ng, ncol, hi=0.3),
            _rand(rng, nlev, ng, ncol, lo=0.2, hi=0.7),
            _rand(rng, nlev, ng, ncol, hi=50.0),
            _rand(rng, nlev, ng, ncol, hi=50.0),
            _rand(rng, ng, ncol, hi=400.0),
            _rand(rng, ng, ncol, hi=0.2))


@pytest.mark.parametrize("mode", ["scan", "interpret"])
@pytest.mark.parametrize("seed", [3, 4])
def test_b3prime_lw_adding_plain_matches_jax(monkeypatch, mode, seed):
    """adding_lw_plain against the JAX package's adding_lw(gfirst=True),
    as its lax.scan sweeps (ECRAD_ADDING=scan) and as its Pallas
    level-sweep kernel in interpret mode."""
    args = _lw_adding_args(seed)
    got = adding.adding_lw(*map(torch.as_tensor, args))
    monkeypatch.setenv("ECRAD_ADDING", mode)
    ref = jax_adding.adding_lw(*map(jnp.asarray, args), gfirst=True)
    _cmp([g.numpy() for g in got], ref, 2e-6)


@pytest.mark.parametrize("fn, args", [
    (adding_fused.adding_sw_fused, _sw_args(7, 3, 2, 5)),
    (adding_fused.lw_noscat_fused, _lw_args(7, 3, 2, 5)),
    (adding_fused.adding_lw_fused, _lw_adding_args(7, 3, 2, 5))])
def test_b3_kernel_wrappers_refuse_cpu_tensors(fn, args):
    before = dict(adding_fused.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*map(torch.as_tensor, args))
    assert adding_fused.launches == before


# ---- two-stream layer optics, float32 ----
#
# The Meador-Weaver terms and the linear-in-tau sources difference nearly
# equal numbers in thin layers, so float32 results carry errors far above
# roundoff there, in either framework: a last-bit difference of exp or
# sqrt grows to ~1e-4 of an output's range. The exact value is the port
# at float64 (tests/test_torch_f64.py holds it to the JAX package at
# float64). A difference from JAX beyond `tol` of the range must then be
# explained by JAX's own float32 error:
#     |port - jax| <= max(tol * range, 2 |jax - exact|).


def _layers(seed, shape=(9, 16, 11)):
    """Layer optics over the range the slice gives them: od from 1e-5
    (thin Rayleigh layers aloft) to 30, ssa in [0, 1], g in [0, 0.9],
    Planck sources in [10, 120] W/m2."""
    rng = np.random.RandomState(seed)
    od = np.exp(rng.uniform(np.log(1e-5), np.log(30.0), shape))
    return {"od": od.astype(np.float32), "ssa": _rand(rng, *shape),
            "g": _rand(rng, *shape, hi=0.9),
            "mu0": _rand(rng, 1, shape[-1], lo=1e-3, hi=1.0),
            "planck_top": _rand(rng, *shape, lo=10.0, hi=120.0),
            "planck_bot": _rand(rng, *shape, lo=10.0, hi=120.0)}


def two_stream_cases(x, ts, cast):
    """The two-stream functions of module `ts` on the inputs `x`, cast by
    `cast`; the same code drives the port and the JAX package."""
    a = {k: cast(v) for k, v in x.items()}
    sw_g = ts.sw_gammas(a["mu0"], a["ssa"], a["g"])
    lw_g = ts.lw_gammas(a["ssa"], a["g"])
    return {
        "sw_gammas": sw_g,
        "sw_reftrans": ts.sw_reftrans(a["mu0"], a["od"], a["ssa"], *sw_g),
        "lw_gammas": lw_g,
        "lw_reftrans": ts.lw_reftrans(a["od"], *lw_g, a["planck_top"],
                                      a["planck_bot"]),
        "lw_no_scattering_transmittance":
            ts.lw_no_scattering_transmittance(a["od"], a["planck_top"],
                                              a["planck_bot"]),
    }


@pytest.mark.parametrize("name, tol", [
    ("sw_gammas", 1e-6), ("sw_reftrans", 2e-6), ("lw_gammas", 1e-6),
    ("lw_reftrans", 2e-6), ("lw_no_scattering_transmittance", 2e-6)])
def test_two_stream_matches_jax_f32(name, tol):
    x = _layers(0)
    got = two_stream_cases(x, pts, torch.as_tensor)[name]
    ref = two_stream_cases(x, jts, jnp.asarray)[name]
    exact = two_stream_cases(
        x, pts, lambda v: torch.as_tensor(v, dtype=torch.float64))[name]
    for g, r, e in zip(got, ref, exact):
        g, r, e = g.numpy(), np.asarray(r), e.numpy()
        assert g.dtype == r.dtype == np.float32
        bound = max(tol * np.abs(e).max(), 2 * np.abs(r - e).max())
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max())


def test_sw_reftrans_is_float64_accurate_near_the_resonance():
    """float32 layers within RESONANCE_WINDOW of k mu0 = 1 take the
    direct-beam terms from float64: on cells spread over the SW
    parameter space, with a tenth of them within 1e-3 of the resonance,
    every float32 term stays within 2e-5 of float64 (the plain float32
    form is off by more than 1e-3 there), and the cells outside the
    window are the float32 form's own. Cells within 1e-5 of the
    resonance are left out of the comparison: within 1e-6 the reference
    nudges k mu0 to 1 - 1e-6, and which side of that a cell falls on
    depends on the rounding of its inputs."""
    rng = np.random.RandomState(7)
    n = 20000
    mu0 = rng.uniform(0.05, 1.0, n)
    ssa = rng.uniform(0.0, 1.0, n)
    g = rng.uniform(0.0, 0.9, n)
    od = 10.0 ** rng.uniform(-5, 1.5, n)
    # move a tenth of the cells next to the resonance: mu0 = (1 + d) / k
    g1, g2, _ = pts.sw_gammas(torch.as_tensor(mu0), torch.as_tensor(ssa),
                              torch.as_tensor(g))
    k = torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=pts.KMIN)).numpy()
    near = slice(0, n // 10)
    mu0[near] = np.clip((1.0 + rng.uniform(-1e-3, 1e-3, n // 10))
                        / k[near], 1e-3, 1.0)
    args = lambda dt: [torch.as_tensor(x, dtype=dt) for x in (mu0, od, ssa,
                                                               g)]

    def run(dt, fn):
        m, o, s, gg = args(dt)
        return fn(m, o, s, *pts.sw_gammas(m, s, gg))
    exact = run(torch.float64, pts.sw_reftrans)
    got = run(torch.float32, pts.sw_reftrans)
    plain = run(torch.float32, pts._sw_reftrans)
    m, _, s, gg = args(torch.float32)
    g1, g2, _ = pts.sw_gammas(m, s, gg)
    outside = (torch.abs(torch.sqrt(torch.clamp(
        (g1 - g2) * (g1 + g2), min=pts.KMIN)) * m - 1.0)
        >= pts.RESONANCE_WINDOW)
    away = torch.as_tensor(np.abs(k * mu0 - 1.0) >= 1e-5)
    for a, b, e in zip(got, plain, exact):
        assert a.dtype == torch.float32
        assert float((a.double() - e)[away].abs().max()) <= 2e-5
        assert torch.equal(a[outside], b[outside])
    assert float((plain[3].double() - exact[3])[away].abs().max()) > 1e-3


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 1e-5)])
def test_sw_frac_scattered_diffuse_matches_jax(dtype, tol):
    """On the layers of _layers with od 0 (the thin-layer branch, 1),
    1e-6 and 40 on every g-point of three columns, of the largest value
    (the fraction lies in [0, 1]). The ratio (1 - ref - trans) /
    (1 - exp(-2 od)) divides a difference of numbers near 1 by a
    denominator ~2 od: the two programs' exps differ by an ulp, so each
    cell also has 4 ulps of 1 over its denominator (at od 1e-6 in
    float32 that is 0.24: neither program's value is accurate there)."""
    x = _layers(1)
    od = x["od"].astype(np.float64)
    od[..., :3] = np.array([0.0, 1e-6, 40.0])
    mu0 = np.broadcast_to(x["mu0"], od.shape)
    args = [np.array(v, dtype) for v in (od, mu0, x["ssa"], x["g"])]
    with jax.enable_x64(dtype == "float64"):
        j = [jnp.asarray(v) for v in args]
        ref = np.asarray(jts.sw_frac_scattered_diffuse(
            j[0], *jts.sw_gammas(*j[1:])[:2]))
    t = [torch.as_tensor(v) for v in args]
    got = pts.sw_frac_scattered_diffuse(t[0],
                                        *pts.sw_gammas(*t[1:])[:2]).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    assert (got[..., 0] == 1.0).all() and (got[..., 1:] < 1.0).any()
    diff = np.abs(got.astype(np.float64) - ref)
    top = np.abs(ref).max()
    assert (diff[..., 0] == 0.0).all()
    ulps = 4 * np.finfo(dtype).eps / -np.expm1(-2.0 * od[..., 1:])
    assert (diff[..., 1:] <= tol * top + ulps).all(), (
        diff[..., 1:] - ulps).max()
    thick = od >= 0.1
    assert diff[thick].max() <= tol * top, diff[thick].max()
