"""PyTorch port: SPARTACUS's small-matrix algebra (ecrad_tpu_torch/solvers/
matrix.py) against the JAX package's (ecrad_tpu/solvers/matrix.py), on
the CPU, for 2 and 3 regions, at float64 (bound 1e-12 of each output's
largest value) and float32 (2e-5, the JAX package's kernel-vs-fallback
bound for these pipelines, tools/check_kernel_equivalence.py:209).

The inputs are built like SPARTACUS layer generators (diagonally dominant
blocks of od x gamma plus lateral exchange), with optical depths from
0.01 to 40 so that the doubling counts span 0 to 6, and the exchange
matrices' rates like those of the explicit entrapment. The doubling
count must be identical, also on norms at and next to theta 2^k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.solvers import matrix as jm
from ecrad_tpu_torch.solvers import matrix as pm

BATCH = (5, 37)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tol(dtype):
    return 1e-12 if dtype == "float64" else 2e-5


def _lw_blocks(rng, n):
    """Atl, Bbl (n, n, *BATCH) of an LW generator: od gamma1 + lateral
    exchange on the diagonal and -exchange off it, od gamma2 diagonal."""
    od = np.exp(rng.uniform(np.log(0.01), np.log(40.0), (n,) + BATCH))
    ssa = rng.uniform(0.0, 0.9, (n,) + BATCH)
    g1 = 1.66 - 0.83 * ssa * 1.8
    g2 = 0.83 * ssa * 0.2
    A = np.zeros((n, n) + BATCH)
    B = np.zeros((n, n) + BATCH)
    for r in range(n):
        A[r, r] = od[r] * g1[r]
        B[r, r] = od[r] * g2[r]
    for r in range(n - 1):
        t1, t2 = rng.uniform(0, 3, (2,) + BATCH)
        A[r, r] += t1
        A[r + 1, r] -= t1
        A[r + 1, r + 1] += t2
        A[r, r + 1] -= t2
    return A, B


def _sw_blocks(rng, n):
    """M (2n, 2n), C (2n, n), D (n, n) of an SW generator."""
    A, B = _lw_blocks(rng, n)
    M = np.concatenate([np.concatenate([A, -B], 1),
                        np.concatenate([B, -A], 1)], 0)
    od = np.exp(rng.uniform(np.log(0.01), np.log(20.0), (n,) + BATCH))
    C = np.zeros((2 * n, n) + BATCH)
    D = np.zeros((n, n) + BATCH)
    for r in range(n):
        C[r, r] = -od[r] * 0.3
        C[n + r, r] = od[r] * 0.5
        D[r, r] = -np.minimum(od[r] / rng.uniform(0.05, 1.0, BATCH), 60.0)
    for r in range(n - 1):
        t = rng.uniform(0, 2, BATCH)
        D[r, r] -= t
        D[r + 1, r] += t
    return M, C, D


def _both(fn_j, fn_p, args, dtype):
    """(jax outputs, port outputs) of the same numpy arguments."""
    with jax.enable_x64(dtype == "float64"):
        ref = fn_j(*(jnp.asarray(a, dtype) for a in args))
        ref = [np.asarray(x) for x in (ref if isinstance(ref, (tuple, list))
                                       else [ref])]
    got = fn_p(*(torch.as_tensor(np.asarray(a, dtype)) for a in args))
    got = [x.numpy() for x in (got if isinstance(got, (tuple, list))
                               else [got])]
    return ref, got


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 3, 6])
def test_mm_and_solve_match_jax(n, dtype):
    rng = np.random.RandomState(n)
    a = rng.uniform(-1, 1, (n, n) + BATCH) + 3 * np.eye(n)[..., None, None]
    b = rng.uniform(-1, 1, (n, n + 2) + BATCH)
    ref, got = _both(lambda x, y: (jm.mm_gu(x, y[:, :n]), jm.solve_g(x, y),
                                   jm.mv_gu(x, y[:, 0]), jm.norm1_g(y)),
                     lambda x, y: (pm.mm_gu(x, y[:, :n]), pm.solve_g(x, y),
                                   pm.mv_gu(x, y[:, 0]), pm.norm1_g(y)),
                     (a, b), dtype)
    for name, x, y in zip(("mm", "solve", "mv", "norm1"), got, ref):
        assert x.shape == y.shape and x.dtype == np.dtype(dtype), name
        assert _rel(x, y) <= (1e-14 if dtype == "float64" else 1e-6), (
            name, _rel(x, y))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 3])
def test_expm_reftrans_lw_matches_jax(n, dtype):
    A, B = _lw_blocks(np.random.RandomState(10 + n), n)
    ref, got = _both(jm.expm_reftrans_lw_g, pm.expm_reftrans_lw_g, (A, B),
                     dtype)
    counts = got[2]
    assert counts.min() <= 1 and counts.max() >= 4, np.bincount(
        counts.ravel())
    for name, x, y in zip(("R", "T"), got, ref):
        assert _rel(x, y) <= _tol(dtype), (name, _rel(x, y))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 3])
def test_expm_reftrans_sw_matches_jax(n, dtype):
    M, C, D = _sw_blocks(np.random.RandomState(20 + n), n)
    ref, got = _both(jm.expm_reftrans_sw_g, pm.expm_reftrans_sw_g,
                     (M, C, D), dtype)
    assert got[5].max() >= 4
    for name, x, y in zip(("R", "T", "Rdir", "Tdir", "Tdd"), got, ref):
        assert _rel(x, y) <= _tol(dtype), (name, _rel(x, y))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fast_expm_exchange_match_jax(dtype):
    rng = np.random.RandomState(3)
    abcd = rng.uniform(0.0, 16.0, (4,) + BATCH)
    abcd[:, 0, :4] = 0.0                     # no exchange at all
    abcd[1, 1, :4] = 1e-14                   # eigenvalue denominators ~ 0
    for fj, fp, k in ((jm.fast_expm_exchange_2_g, pm.fast_expm_exchange_2_g,
                       2),
                      (jm.fast_expm_exchange_3_g, pm.fast_expm_exchange_3_g,
                       4)):
        ref, got = _both(fj, fp, tuple(abcd[:k]), dtype)
        assert got[0].shape == (k // 2 + 1, k // 2 + 1) + BATCH
        assert _rel(got[0], ref[0]) <= (1e-12 if dtype == "float64"
                                        else 1e-5), (k, _rel(got[0], ref[0]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_squaring_count_is_identical_on_borderline_norms(dtype):
    """theta 2^k itself counts k (not k + 1), the next float up k + 1."""
    theta = np.asarray(pm._THETA_DBL, dtype)
    edges = theta * (2.0 ** np.arange(pm._MAX_DOUBLINGS + 2)).astype(dtype)
    norms = np.concatenate([edges, np.nextafter(edges, np.inf),
                            np.nextafter(edges, -np.inf),
                            np.random.RandomState(0).uniform(0, 9000, 200)
                            .astype(dtype), np.zeros(1, dtype)])
    with jax.enable_x64(dtype == "float64"):
        je, js = jm._squaring_count(jnp.asarray(norms), jm._THETA_DBL,
                                    jm._MAX_DOUBLINGS)
        je, js = np.asarray(je), np.asarray(js)
    pe, ps = pm._squaring_count(torch.as_tensor(norms), pm._THETA_DBL,
                                pm._MAX_DOUBLINGS)
    np.testing.assert_array_equal(pe.numpy(), je)
    np.testing.assert_array_equal(ps.numpy(), js)
    k = len(edges)
    np.testing.assert_array_equal(pe.numpy()[:k - 2], np.arange(k - 2))
    np.testing.assert_array_equal(pe.numpy()[k:2 * k - 2],
                                  np.arange(1, k - 1))
    np.testing.assert_array_equal(ps.numpy(), 2.0 ** -pe.numpy())


# ---- the general exponentials and products (ecrad_tpu/solvers/matrix.py
# :60-124, :207-268, :469-634): Pade-7 scaled to theta3; expm also against
# scipy's at float64 ----

def _expm_case(case):
    """(16, 9, 9) uniform in [-1, 1], or (4, 6, 6) x 20 shifted by -25 I
    (norms that need several squarings, the exponential bounded): the
    cases of tests/test_matrix.py."""
    if case == "random":
        return np.random.RandomState(0).uniform(-1.0, 1.0, (16, 9, 9))
    A = np.random.RandomState(1).uniform(-1.0, 1.0, (4, 6, 6)) * 20.0
    return A - np.eye(6) * 25.0


def _counts(norm1, dtype):
    """(port, JAX) Pade-7 squaring counts of the same norms."""
    with jax.enable_x64(dtype == "float64"):
        je = np.asarray(jm._squaring_count(jnp.asarray(norm1))[0])
    return pm._squaring_count(torch.as_tensor(norm1), pm._THETA3,
                              pm._MAX_SQUARINGS)[0].numpy(), je


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["random", "large_norm"])
def test_expm_matches_jax_and_scipy(case, dtype):
    from scipy.linalg import expm as scipy_expm
    A = _expm_case(case)
    ref, got = _both(jm.expm, pm.expm, (A,), dtype)
    assert got[0].shape == A.shape and got[0].dtype == np.dtype(dtype)
    assert _rel(got[0], ref[0]) <= _tol(dtype), _rel(got[0], ref[0])
    pe, je = _counts(np.abs(A.astype(dtype)).sum(-2).max(-1), dtype)
    np.testing.assert_array_equal(pe, je)
    assert pe.max() >= (4 if case == "large_norm" else 1), pe
    if dtype == "float64":
        want = np.stack([scipy_expm(a) for a in A])
        assert _rel(got[0], want) <= _tol(dtype), _rel(got[0], want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mm_g_and_mv_g_match_jax(dtype):
    rng = np.random.RandomState(4)
    a = rng.uniform(-1, 1, (6, 4) + BATCH)
    b = rng.uniform(-1, 1, (4, 3) + BATCH)
    ref, got = _both(lambda x, y: (jm.mm_g(x, y), jm.mv_g(x, y[:, 0])),
                     lambda x, y: (pm.mm_g(x, y), pm.mv_g(x, y[:, 0])),
                     (a, b), dtype)
    for name, x, y in zip(("mm_g", "mv_g"), got, ref):
        assert x.shape == y.shape and x.dtype == np.dtype(dtype), name
        assert _rel(x, y) <= _tol(dtype), (name, _rel(x, y))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fixed", [None, 0, 3])
@pytest.mark.parametrize("m", [3, 6])
def test_expm_g_matches_jax(m, fixed, dtype):
    """expm_g on SPARTACUS-like generators: the 3 x 3 direct block and
    the 6 x 6 LW generator [[A, -B], [B, -A]]; fixed_squarings 0 and 3
    truncate the cells that need more (counts reach 4 and beyond)."""
    if m == 3:
        A = _sw_blocks(np.random.RandomState(30), 3)[2]
    else:
        At, Bt = _lw_blocks(np.random.RandomState(31), 3)
        A = np.concatenate([np.concatenate([At, -Bt], 1),
                            np.concatenate([Bt, -At], 1)], 0)
    A = A.astype(dtype)
    ref, got = _both(lambda x: jm.expm_g(x, fixed_squarings=fixed),
                     lambda x: pm.expm_g(x, fixed_squarings=fixed),
                     (A,), dtype)
    assert got[0].shape == A.shape and got[0].dtype == np.dtype(dtype)
    assert _rel(got[0], ref[0]) <= _tol(dtype), _rel(got[0], ref[0])
    pe, je = _counts(np.asarray(pm.norm1_g(torch.as_tensor(A))), dtype)
    np.testing.assert_array_equal(pe, je)
    assert pe.max() >= 4, np.bincount(pe.ravel())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fixed", [None, 0, 3])
def test_expm_sw_g_matches_jax(fixed, dtype):
    M, C, D = (x.astype(dtype)
               for x in _sw_blocks(np.random.RandomState(32), 3))
    ref, got = _both(lambda *a: jm.expm_sw_g(*a, fixed_squarings=fixed),
                     lambda *a: pm.expm_sw_g(*a, fixed_squarings=fixed),
                     (M, C, D), dtype)
    for name, x, y, src in zip(("Em", "Ec", "Ed"), got, ref, (M, C, D)):
        assert x.shape == src.shape and x.dtype == np.dtype(dtype), name
        assert _rel(x, y) <= _tol(dtype), (name, _rel(x, y))
    pe, je = _counts(np.asarray(pm._norm1_sw(*(torch.as_tensor(x)
                                                for x in (M, C, D)))), dtype)
    np.testing.assert_array_equal(pe, je)
    assert pe.max() >= 4, np.bincount(pe.ravel())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fast_expm_exchange_batch_leading_match_jax(dtype):
    rng = np.random.RandomState(5)
    abcd = rng.uniform(0.0, 16.0, (4,) + BATCH)
    abcd[:, 0, :4] = 0.0
    for fj, fp, k in ((jm.fast_expm_exchange_2, pm.fast_expm_exchange_2, 2),
                      (jm.fast_expm_exchange_3, pm.fast_expm_exchange_3, 4)):
        ref, got = _both(fj, fp, tuple(abcd[:k]), dtype)
        assert got[0].shape == BATCH + (k // 2 + 1, k // 2 + 1)
        assert _rel(got[0], ref[0]) <= (1e-12 if dtype == "float64"
                                        else 1e-5), (k, _rel(got[0], ref[0]))
