"""Batched small-matrix algebra for SPARTACUS, the g-minor forms.

Copied from ecrad_tpu_torch/solvers/matrix.py (radiation_matrix.F90),
the parts the SPARTACUS path uses: products and unpivoted solves on
(m, n, *batch) tensors, the small matrix dimensions leading, every sum
in the unrolled order of the original (`mm_gu`, `solve_g`); the
reflectance and transmittance of the SW and LW layer generators by
Pade-5, thin-layer extraction and masked adding-doubling
(`expm_reftrans_sw_g`, `expm_reftrans_lw_g`); and the analytic
exponentials of the entrapment exchange matrices. No torch.matmul, so
TF32 never applies.
"""
from __future__ import annotations

import torch

# Pade-5 coefficients and the adding-doubling scaling threshold
# (ecrad_tpu/solvers/matrix.py:24-35)
_THETA_DBL = 1.8
_MAX_DOUBLINGS = 12
_C5 = (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0)


def _squaring_count(norm1, theta, max_count):
    """(count, scale): count = #{k < max_count : norm1 > theta 2^k}, from
    compares against exact powers of two only, and scale = 2^-count."""
    expo = torch.zeros(norm1.shape, dtype=torch.int32, device=norm1.device)
    scale = torch.ones_like(norm1)
    for k in range(max_count):
        gt = norm1 > theta * float(2.0 ** k)
        expo = expo + gt.to(torch.int32)
        scale = torch.where(gt, scale * 0.5, scale)
    return expo, scale


def _steps(expo):
    """The doubling steps to run: the batch's largest count (each cell
    stops at its own)."""
    return int(expo.max()) if expo.numel() else 0


def add_eye_g(M, c):
    """M + c I on (m, m, *batch)."""
    out = M.clone()
    out.diagonal(0, 0, 1).add_(c)
    return out


def mm_gu(a, b):
    """(m, k, *batch) @ (k, n, *batch) -> (m, n, *batch), the k terms
    added left to right."""
    s = a[:, 0, None] * b[None, 0]
    for kk in range(1, a.shape[1]):
        s = s + a[:, kk, None] * b[None, kk]
    return s


def mv_gu(a, x):
    """(m, k, *batch) @ (k, *batch) -> (m, *batch), left to right."""
    s = a[:, 0] * x[None, 0]
    for kk in range(1, a.shape[1]):
        s = s + a[:, kk] * x[None, kk]
    return s


def norm1_g(A):
    """Max column abs-sum of (m, n, *batch), each column summed in row
    order."""
    s = A[0].abs()
    for i in range(1, A.shape[0]):
        s = s + A[i].abs()
    return s.amax(0)


def solve_g(A, B):
    """Solve A X = B, A (m, m, *batch), B (m, n, *batch): Gaussian
    elimination without pivoting (the diagonally dominant SPARTACUS
    matrices allow it)."""
    m = A.shape[0]
    a = [A[i] for i in range(m)]
    b = [B[i] for i in range(m)]
    for col in range(m):
        inv = 1.0 / a[col][col]
        a[col] = a[col] * inv[None]
        b[col] = b[col] * inv[None]
        for row in range(col + 1, m):
            f = a[row][col][None]
            a[row] = a[row] - f * a[col]
            b[row] = b[row] - f * b[col]
    for col in range(m - 1, -1, -1):
        for row in range(col):
            b[row] = b[row] - a[row][col][None] * b[col]
    return torch.stack(b)


def solve_vec_g(A, x):
    """Solve A y = x, A (m, m, *batch), x (m, *batch)."""
    return solve_g(A, x[:, None])[:, 0]


def _block(rows):
    return torch.cat([torch.cat(r, 1) for r in rows], 0)


def _pade5_solve(V, U):
    return add_eye_g(solve_g(V - U, 2.0 * U), 1.0)


def _norm1_sw(M, C, D):
    """1-norm of [[M, C], [0, D]]: the larger of M's column sums and of
    the right block's, C's rows then D's summed in order."""
    s = C[0].abs()
    for i in range(1, C.shape[0]):
        s = s + C[i].abs()
    for i in range(D.shape[0]):
        s = s + D[i].abs()
    return torch.maximum(norm1_g(M), s.amax(0))


def _bprod(a, b):
    """Product of two block-upper-triangular matrices given as their
    (M, C, D) blocks."""
    return (mm_gu(a[0], b[0]), mm_gu(a[0], b[1]) + mm_gu(a[1], b[2]),
            mm_gu(a[2], b[2]))


def _pade5_sw(As):
    """Blockwise Pade-5 (Em, Ec, Ed) of the scaled [[M, C], [0, D]]: the
    direct block is solved first, then one elimination of the diffuse
    block serves both right-hand-side families."""
    m2 = As[0].shape[0]
    A2 = _bprod(As, As)
    A4 = _bprod(A2, A2)

    def pade_sum(c4, c2, c0):
        return (add_eye_g(c4 * A4[0] + c2 * A2[0], c0),
                c4 * A4[1] + c2 * A2[1],
                add_eye_g(c4 * A4[2] + c2 * A2[2], c0))

    V = pade_sum(_C5[5], _C5[3], _C5[1])
    U = _bprod(As, V)
    V = pade_sum(_C5[4], _C5[2], _C5[0])
    Pm, Pc, Pd = V[0] - U[0], V[1] - U[1], V[2] - U[2]
    Xd = solve_g(Pd, 2.0 * U[2])
    Xmc = solve_g(Pm, torch.cat([2.0 * U[0], 2.0 * U[1] - mm_gu(Pc, Xd)],
                                1))
    return add_eye_g(Xmc[:, :m2], 1.0), Xmc[:, m2:], add_eye_g(Xd, 1.0)


def expm_reftrans_lw_g(Atl, Bbl):
    """Reflectance and transmittance (R, T) of the LW layer generator
    [[Atl, -Bbl], [Bbl, -Atl]] (blocks (n, n, *batch)): Pade-5 of the
    generator scaled by 2^-s, one thin-layer extraction, then s masked
    adding-doubling steps W = (I - R R)^-1 T, R <- R + T R W, T <- T W.
    Returns (R, T, s), s the per-cell doubling count (int32)."""
    n = Atl.shape[0]
    s = Atl[0].abs() + Bbl[0].abs()
    for i in range(1, n):
        s = s + Atl[i].abs() + Bbl[i].abs()
    expo, scale = _squaring_count(s.amax(0), _THETA_DBL, _MAX_DOUBLINGS)
    Xs, Ys = Atl * scale, Bbl * scale
    G = _block([[Xs, -Ys], [Ys, -Xs]])
    A2 = mm_gu(G, G)
    A4 = mm_gu(A2, A2)
    V = add_eye_g(_C5[5] * A4 + _C5[3] * A2, _C5[1])
    U = mm_gu(G, V)
    V = add_eye_g(_C5[4] * A4 + _C5[2] * A2, _C5[0])
    E = _pade5_solve(V, U)
    R = -solve_g(E[:n, :n], E[:n, n:])
    T = E[n:, n:] + mm_gu(E[n:, :n], R)
    for k in range(_steps(expo)):
        W = solve_g(add_eye_g(-mm_gu(R, R), 1.0), T)
        Rn = R + mm_gu(mm_gu(T, R), W)
        Tn = mm_gu(T, W)
        do = k < expo
        R, T = torch.where(do, Rn, R), torch.where(do, Tn, T)
    return R, T, expo


def expm_reftrans_sw_g(M, C, D):
    """(R, T, Rdir, Tdir, Tdd) of the SW layer generator [[M, C], [0, D]]:
    M (2n, 2n, *batch) the diffuse block, C (2n, n, *batch) the direct to
    diffuse coupling, D (n, n, *batch) the direct block. Blockwise Pade-5
    of the scaled generator, thin-layer extraction, then masked
    adding-doubling steps:
        S = (I - R R)^-1, d = S (Tdir + R Rdir Tdd)
        Rdir <- Rdir + T (Rdir Tdd + R d), Tdir <- T d + Tdir Tdd
        R <- R + T R (S T), T <- T (S T), Tdd <- Tdd Tdd.
    Returns the five and the per-cell doubling count (int32)."""
    n = D.shape[0]
    expo, scale = _squaring_count(_norm1_sw(M, C, D), _THETA_DBL,
                                  _MAX_DOUBLINGS)
    Em, Ec, Tdd = _pade5_sw((M * scale, C * scale, D * scale))
    RRd = -solve_g(Em[:n, :n], torch.cat([Em[:n, n:], Ec[:n]], 1))
    R, Rdir = RRd[:, :n], RRd[:, n:]
    T = Em[n:, n:] + mm_gu(Em[n:, :n], R)
    Tdir = Ec[n:] + mm_gu(Em[n:, :n], Rdir)
    for k in range(_steps(expo)):
        RdTdd = mm_gu(Rdir, Tdd)
        WD = solve_g(add_eye_g(-mm_gu(R, R), 1.0),
                     torch.cat([T, Tdir + mm_gu(R, RdTdd)], 1))
        W, d_i = WD[:, :n], WD[:, n:]
        new = (R + mm_gu(mm_gu(T, R), W), mm_gu(T, W),
               Rdir + mm_gu(T, RdTdd + mm_gu(R, d_i)),
               mm_gu(T, d_i) + mm_gu(Tdir, Tdd), mm_gu(Tdd, Tdd))
        do = k < expo
        R, T, Rdir, Tdir, Tdd = (torch.where(do, a, b) for a, b in
                                 zip(new, (R, T, Rdir, Tdir, Tdd)))
    return R, T, Rdir, Tdir, Tdd, expo


def fast_expm_exchange_2_g(a, b):
    """exp of [[-a, b], [a, -b]] as (2, 2, *batch)
    (radiation_matrix.F90:1344-1380)."""
    factor = (1.0 - torch.exp(-(a + b))) / torch.clamp(a + b, min=1e-12)
    return torch.stack([torch.stack([1.0 - factor * a, factor * b]),
                        torch.stack([factor * a, 1.0 - factor * b])])


def fast_expm_exchange_3_g(a, b, c, d):
    """exp of [[-a, b, 0], [a, -b-c, d], [0, c, -d]] as (3, 3, *batch), by
    the analytic eigendecomposition of radiation_matrix.F90:1386-1509."""
    eps = 1e-12
    y2 = 0.5 * (a + b + c + d)
    y3 = torch.sqrt(torch.clamp(y2 * y2 - (a * c + a * d + b * d), min=0.0))
    lam1 = -y2 + y3
    lam2 = -y2 - y3

    def safe_div(num, den):
        sign_eps = torch.where(den >= 0, torch.full_like(den, eps),
                               torch.full_like(den, -eps))
        return num / torch.where(den.abs() < eps, sign_eps, den)

    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    v11 = safe_div(torch.clamp(b, min=eps), a + lam1)
    v12 = safe_div(b, a + lam2)
    v13 = b / torch.clamp(a, min=eps)
    v31 = safe_div(c, d + lam1)
    v32 = safe_div(c, d + lam2)
    v33 = torch.clamp(c, min=eps) / torch.clamp(d, min=eps)
    d1, d2 = torch.exp(lam1), torch.exp(lam2)
    L21 = v12 / v11
    L31 = v13 / v11
    U22 = one - L21 * one
    U23 = v32 - L21 * v31
    L32 = (one - L31 * one) / U22
    U33 = v33 - L31 * v31 - L32 * U23

    def col(r1, r2, r3):
        y2c = r2 - L21 * r1
        y3c = r3 - L31 * r1 - L32 * y2c
        x3 = y3c / U33
        x2 = (y2c - U23 * x3) / U22
        x1 = (r1 - one * x2 - v31 * x3) / v11
        return x1, x2, x3

    X = [col(d1, zero, zero), col(zero, d2, zero), col(zero, zero, one)]
    V = [[v11, v12, v13], [one, one, one], [v31, v32, v33]]
    return torch.stack([torch.stack([
        V[i][0] * X[0][j] + V[i][1] * X[1][j] + V[i][2] * X[2][j]
        for j in range(3)]) for i in range(3)])
