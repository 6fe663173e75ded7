// Kernels B6 and B7: SPARTACUS per-layer reflectance/transmittance.
//
// Replace the TPU kernels ecrad_tpu/ops/spartacus_reftrans.py::
// sw_reftrans_levels (:272, pallas_call :350) and ::lw_reftrans_levels
// (:600, pallas_call :676). For each (level, g, column) cell: the 1D
// Meador-Weaver terms of every region; where the cell takes the 3D
// treatment (use3d), the region-coupled two-stream generator Gamma, its
// exponential by Pade-5 of the generator scaled by 2^-s, one thin-layer
// extraction and s adding-doubling steps (solvers/matrix.py
// expm_reftrans_sw_g / expm_reftrans_lw_g), the clipping (SW) or the
// particular-solution sources (LW); then the cloudy regions of clear
// layers zeroed. The output is the packed history the adding sweeps read
// (SW [R | T | RD | TD | TDD], LW [R | T | SU | SD]).
//
// On the TPU the grid ran a static worst-case doubling count on tiles of
// 16 g x 128 columns, and a tile without a 3D cell skipped the pipeline.
// Here one thread owns one cell: its matrices live in registers (the SW
// pipeline for 3 regions, which holds several 6 x 6 and 6 x 3 blocks at
// once, takes all 255 a thread may have, without spilling), NREG is a
// template parameter, the doubling loop runs the cell's own count s (the
// plain version masks to the batch maximum, which gives the same values),
// and a cell without the 3D treatment computes only its Meador-Weaver
// terms.
//
// What bounds it: device-memory bandwidth at the least-time measure (the
// 45 | 24 output rows per cell against about 7,000 | 2,500 operations per
// 3D cell of 3 regions and ~180 per fallback cell; 14 % of cells are 3D
// on the SPARTACUS path). The operand layout (nlev, rows, ng, ncol) keeps
// every global access coalesced across the 32 neighbouring columns of a
// warp.
//
// B6 (SW) runs as two launches on one stream, so that the fallback cells,
// most of the output, are not held to the 3D pipeline's 255 registers
// (8 warps per SM) nor share a warp with a 3D cell, and so that every
// 32-byte sector of the output is written whole. A sector is 8 columns
// of one (level, row, g); at the SPARTACUS path's 3D share (0.14) most
// sectors hold both kinds of cell, and a sector written in two parts by
// two launches is read back from device memory to be merged, once for
// each part. Pass 1, a persistent grid sized by the occupancy
// of the 3D pipeline, finds the 3D cells itself (each warp queues the 3D
// cells of its groups of 32 with a ballot and computes them 32 at a
// time, every lane busy) and stages each cell's rows in a compact buffer
// of up to a quarter of the cells, coalesced, recording its slot; a cell
// past that share is written in place. Pass 2, compiled apart with at
// most 64 registers, streams over every cell: it computes a fallback
// cell's rows and copies a staged 3D cell's, so each warp writes its 32
// columns of every row at once. Every output element is written once,
// by one of the two passes; no value depends on the slots' order.
//
// B7 (LW) takes the same split, for the same reasons: its 3D pipeline
// (about 2,200 operations per cell and 240 per doubling step, 14 % of the
// SPARTACUS path's cells) needs some 200 registers, and a warp of 32
// columns of one (level, g) holds a 3D cell all but always, so in one
// pass nearly every warp ran the pipeline with most lanes idle and the
// fallback cells (~120 operations each, most of the output) ran at its
// occupancy. Pass 1 runs at the occupancy its registers allow (at most
// 168, 12 warps per SM), where waiting on memory holds it more than its
// operations or bytes do: it reads the 3D flags of 16 groups in one wait
// and computes the cells in the order it lists them, so that a round's
// operands lie in few lines (rounds sorted by doubling count scattered
// them and ran slower), and stages each cell's rows in one 96-byte run,
// so that pass 2 reads them whole. Pass 2 is bound by device memory:
// with no LW cloud scattering it reads one optical depth per region of a
// fallback cell and writes 2 NREG (NREG + 1) rows, every 32-byte sector
// whole. Cells are fewer than 2^31, so a cell's level and column come
// from 32-bit divisions.
//
// Semantics: ops/spartacus_reftrans.py sw_reftrans_levels_plain and
// lw_reftrans_levels_plain, expression for expression (built with
// -fmad=false, exact expf/sqrtf): products add their terms left to right
// as solvers/matrix.py mm_gu does, the elimination is solve_g's, and the
// doubling count comes from the same compare chain (not a log2, which
// flips the count on borderline norms). SW fallback cells within
// RESONANCE_WINDOW (0.03) of k mu0 = 1 take the Meador-Weaver terms in
// double, as two_stream.sw_reftrans does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace ecrad {
namespace spartacus {

constexpr int THREADS = 128;
// B6's pass over every cell: 128 threads, at least 6 blocks per SM (80
// registers, 24 warps; at 64 registers it spilled and ran slower)
constexpr int LEAN_THREADS = 128, LEAN_MIN_BLOCKS = 6;
// B7's 3D pass: at least 3 blocks of THREADS per SM, so at most 168
// registers. Measured on the H100 at 3 regions: 236 registers unbounded,
// B7 6.2005 ms; 3 blocks, no spills, 5.4151 ms; 4 blocks, 88 B spilled,
// 5.5751 ms (PERF.md, PR 7).
constexpr int LW_3D_MIN_BLOCKS = 3;
constexpr float THETA_DBL = 1.8f;
constexpr int MAX_DOUBLINGS = 12;
constexpr float MAX_OD_OVER_MU0_3D = 60.0f;
constexpr float LW_DIFFUSIVITY = 1.66f;
constexpr float RESONANCE_WINDOW = 0.03f;
// Pade-5 coefficients
constexpr float C0 = 30240.0f, C1 = 15120.0f, C2 = 3360.0f, C3 = 420.0f,
                C4 = 30.0f, C5 = 1.0f;

// o = a b, each o[i][j] summed over k left to right
template <int M, int K, int N>
__device__ __forceinline__ void mm(const float (&a)[M][K],
                                   const float (&b)[K][N], float (&o)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + a[i][k] * b[k][j];
      o[i][j] = s;
    }
}

template <int M, int K>
__device__ __forceinline__ void mv(const float (&a)[M][K], const float (&x)[K],
                                   float (&o)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = a[i][0] * x[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s = s + a[i][k] * x[k];
    o[i] = s;
  }
}

// solve a x = b in place (b <- x), unpivoted elimination in the order of
// solvers/matrix.py solve_g; a is overwritten
template <int M, int N>
__device__ __forceinline__ void solve(float (&a)[M][M], float (&b)[M][N]) {
#pragma unroll
  for (int col = 0; col < M; ++col) {
    const float inv = 1.0f / a[col][col];
#pragma unroll
    for (int j = col + 1; j < M; ++j) a[col][j] = a[col][j] * inv;
#pragma unroll
    for (int j = 0; j < N; ++j) b[col][j] = b[col][j] * inv;
#pragma unroll
    for (int row = col + 1; row < M; ++row) {
      const float f = a[row][col];
#pragma unroll
      for (int j = col + 1; j < M; ++j) a[row][j] = a[row][j] - f * a[col][j];
#pragma unroll
      for (int j = 0; j < N; ++j) b[row][j] = b[row][j] - f * b[col][j];
    }
  }
#pragma unroll
  for (int col = M - 1; col >= 0; --col)
#pragma unroll
    for (int row = 0; row < col; ++row) {
      const float f = a[row][col];
#pragma unroll
      for (int j = 0; j < N; ++j) b[row][j] = b[row][j] - f * b[col][j];
    }
}

// the doubling count and 2^-count (solvers/matrix.py _squaring_count)
__device__ __forceinline__ int doubling_count(float norm1, float* scale) {
  int expo = 0;
  float s = 1.0f;
#pragma unroll
  for (int k = 0; k < MAX_DOUBLINGS; ++k) {
    if (norm1 > THETA_DBL * (float)(1 << k)) {
      ++expo;
      s = s * 0.5f;
    }
  }
  *scale = s;
  return expo;
}

// d = I - r r (solvers/matrix.py add_eye_g(-mm_gu(r, r), 1))
template <int N>
__device__ __forceinline__ void one_minus_sq(const float (&r)[N][N],
                                             float (&d)[N][N]) {
  mm<N, N, N>(r, r, d);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[i][j] = -d[i][j];
    d[i][i] = d[i][i] + 1.0f;
  }
}

// ---- SW ----

struct Mw {
  float r, t, rd, td, tdd;
};

// two_stream.py _sw_reftrans at precision T, rounded to float
template <typename T>
__device__ __forceinline__ Mw sw_mw(T mu0, T od, T ssa, T gamma1, T gamma2,
                                    T gamma3) {
  const T one = T(1.0);
  const T od_over_mu0 = fmax(od / mu0, T(0.0));
  const T gamma4 = one - gamma3;
  const T alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const T alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const T k = sqrt(fmax((gamma1 - gamma2) * (gamma1 + gamma2), T(1.0e-4)));
  T k_mu0 = k * mu0;
  if (fabs(k_mu0 - one) < T(1.0e-6)) k_mu0 = T(1.0 - 1e-6);
  const T k_gamma3 = k * gamma3;
  const T k_gamma4 = k * gamma4;
  const T e0 = exp(-od_over_mu0);
  const T expo = exp(-k * od);
  const T expo2 = expo * expo;
  const T k2e = T(2.0) * k * expo;
  const T rt = one / (k + gamma1 + (k - gamma1) * expo2);
  Mw o;
  o.r = (float)(gamma2 * (one - expo2) * rt);
  o.t = (float)(k2e * rt);
  const T rt_dir = mu0 * ssa * rt / (one - k_mu0 * k_mu0);
  o.rd = (float)(rt_dir * ((one - k_mu0) * (alpha2 + k_gamma3)
                           - (one + k_mu0) * (alpha2 - k_gamma3) * expo2
                           - k2e * (gamma3 - alpha2 * mu0) * e0));
  o.td = (float)(rt_dir * (k2e * (gamma4 + alpha1 * mu0)
                           - e0 * ((one + k_mu0) * (alpha1 + k_gamma4)
                                   - (one - k_mu0) * (alpha1 - k_gamma4)
                                   * expo2)));
  o.tdd = (float)e0;
  return o;
}

__device__ __forceinline__ void sw_gammas(float mu0, float ssa, float g,
                                          float* g1, float* g2, float* g3) {
  const float factor = 0.75f * g;
  *g1 = 2.0f - ssa * (1.25f + factor);
  *g2 = ssa * (0.75f - factor);
  *g3 = 0.5f - mu0 * factor;
}

__device__ __forceinline__ Mw sw_fallback(float mu0, float od, float ssa,
                                          float g) {
  float g1, g2, g3;
  sw_gammas(mu0, ssa, g, &g1, &g2, &g3);
  const float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), 1.0e-4f));
  if (fabsf(k * mu0 - 1.0f) < RESONANCE_WINDOW)
    return sw_mw<double>(mu0, od, ssa, g1, g2, g3);
  return sw_mw<float>(mu0, od, ssa, g1, g2, g3);
}

// block product of [[a0, a1], [0, a2]] and [[b0, b1], [0, b2]]
template <int N>
__device__ __forceinline__ void bprod(
    const float (&a0)[2 * N][2 * N], const float (&a1)[2 * N][N],
    const float (&a2)[N][N], const float (&b0)[2 * N][2 * N],
    const float (&b1)[2 * N][N], const float (&b2)[N][N],
    float (&o0)[2 * N][2 * N], float (&o1)[2 * N][N], float (&o2)[N][N]) {
  mm<2 * N, 2 * N, 2 * N>(a0, b0, o0);
  float t[2 * N][N];
  mm<2 * N, 2 * N, N>(a0, b1, o1);
  mm<2 * N, N, N>(a1, b2, t);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o1[i][j] = o1[i][j] + t[i][j];
  mm<N, N, N>(a2, b2, o2);
}

// p = c4 A4 + c2 A2 (+ c0 on the diagonal blocks' diagonals)
template <int R, int C>
__device__ __forceinline__ void pade_sum(const float (&a4)[R][C],
                                         const float (&a2)[R][C], float c4,
                                         float c2, float c0, bool eye,
                                         float (&p)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      p[i][j] = c4 * a4[i][j] + c2 * a2[i][j];
      if (eye && i == j) p[i][j] = p[i][j] + c0;
    }
}

// (R, T, Rdir, Tdir, Tdd) of [[M, C], [0, D]] (solvers/matrix.py
// expm_reftrans_sw_g); returns the doubling count
template <int N>
__device__ int expm_reftrans_sw(const float (&M)[2 * N][2 * N],
                                const float (&C)[2 * N][N],
                                const float (&D)[N][N], float (&R)[N][N],
                                float (&T)[N][N], float (&Rdir)[N][N],
                                float (&Tdir)[N][N], float (&Tdd)[N][N]) {
  constexpr int N2 = 2 * N;
  float norm1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N2; ++j) {
    float s = fabsf(M[0][j]);
#pragma unroll
    for (int i = 1; i < N2; ++i) s = s + fabsf(M[i][j]);
    norm1 = j == 0 ? s : fmaxf(norm1, s);
  }
  float right = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = fabsf(C[0][j]);
#pragma unroll
    for (int i = 1; i < N2; ++i) s = s + fabsf(C[i][j]);
#pragma unroll
    for (int i = 0; i < N; ++i) s = s + fabsf(D[i][j]);
    right = j == 0 ? s : fmaxf(right, s);
  }
  norm1 = fmaxf(norm1, right);
  float scale;
  const int expo = doubling_count(norm1, &scale);

  float As0[N2][N2], As1[N2][N], As2[N][N];
#pragma unroll
  for (int i = 0; i < N2; ++i) {
#pragma unroll
    for (int j = 0; j < N2; ++j) As0[i][j] = M[i][j] * scale;
#pragma unroll
    for (int j = 0; j < N; ++j) As1[i][j] = C[i][j] * scale;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) As2[i][j] = D[i][j] * scale;

  float A20[N2][N2], A21[N2][N], A22[N][N];
  float A40[N2][N2], A41[N2][N], A42[N][N];
  bprod<N>(As0, As1, As2, As0, As1, As2, A20, A21, A22);
  bprod<N>(A20, A21, A22, A20, A21, A22, A40, A41, A42);
  float V0[N2][N2], V1[N2][N], V2[N][N];
  pade_sum<N2, N2>(A40, A20, C5, C3, C1, true, V0);
  pade_sum<N2, N>(A41, A21, C5, C3, C1, false, V1);
  pade_sum<N, N>(A42, A22, C5, C3, C1, true, V2);
  float U0[N2][N2], U1[N2][N], U2[N][N];
  bprod<N>(As0, As1, As2, V0, V1, V2, U0, U1, U2);
  pade_sum<N2, N2>(A40, A20, C4, C2, C0, true, V0);
  pade_sum<N2, N>(A41, A21, C4, C2, C0, false, V1);
  pade_sum<N, N>(A42, A22, C4, C2, C0, true, V2);
  // P = V - U; Xd = Pd^-1 2 Ud; [Xm | Xc] = Pm^-1 [2 Um | 2 Uc - Pc Xd]
  float Pd[N][N], Xd[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Pd[i][j] = V2[i][j] - U2[i][j];
      Xd[i][j] = 2.0f * U2[i][j];
    }
  solve<N, N>(Pd, Xd);
  float Pc[N2][N], PcXd[N2][N];
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Pc[i][j] = V1[i][j] - U1[i][j];
  mm<N2, N, N>(Pc, Xd, PcXd);
  float Pm[N2][N2], X[N2][N2 + N];
#pragma unroll
  for (int i = 0; i < N2; ++i) {
#pragma unroll
    for (int j = 0; j < N2; ++j) {
      Pm[i][j] = V0[i][j] - U0[i][j];
      X[i][j] = 2.0f * U0[i][j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) X[i][N2 + j] = 2.0f * U1[i][j] - PcXd[i][j];
  }
  solve<N2, N2 + N>(Pm, X);
  // Em = Xm + I, Ec = Xc, Tdd = Xd + I
#pragma unroll
  for (int i = 0; i < N2; ++i) X[i][i] = X[i][i] + 1.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Tdd[i][j] = Xd[i][j] + (i == j ? 1.0f : 0.0f);
  // thin-layer extraction: [R | Rdir] = -Em[:n,:n]^-1 [Em[:n,n:] | Ec[:n]]
  float A[N][N], RR[N][2 * N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[i][j] = X[i][j];
      RR[i][j] = X[i][N + j];
      RR[i][N + j] = X[i][N2 + j];
    }
  solve<N, 2 * N>(A, RR);
  float E21[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      R[i][j] = -RR[i][j];
      Rdir[i][j] = -RR[i][N + j];
      E21[i][j] = X[N + i][j];
    }
  float t1[N][N], t2[N][N];
  mm<N, N, N>(E21, R, t1);
  mm<N, N, N>(E21, Rdir, t2);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T[i][j] = X[N + i][N + j] + t1[i][j];
      Tdir[i][j] = X[N + i][N2 + j] + t2[i][j];
    }

  // adding-doubling steps
  for (int k = 0; k < expo; ++k) {
    float RdTdd[N][N], RRdTdd[N][N], den[N][N], WD[N][2 * N];
    mm<N, N, N>(Rdir, Tdd, RdTdd);
    mm<N, N, N>(R, RdTdd, RRdTdd);
    one_minus_sq<N>(R, den);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        WD[i][j] = T[i][j];
        WD[i][N + j] = Tdir[i][j] + RRdTdd[i][j];
      }
    solve<N, 2 * N>(den, WD);
    float W[N][N], di[N][N], TR[N][N], a[N][N], b[N][N], c[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        W[i][j] = WD[i][j];
        di[i][j] = WD[i][N + j];
      }
    // R <- R + (T R) W
    mm<N, N, N>(T, R, TR);
    mm<N, N, N>(TR, W, a);
    // Rdir <- Rdir + T (Rdir Tdd + R d)
    mm<N, N, N>(R, di, b);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) b[i][j] = RdTdd[i][j] + b[i][j];
    mm<N, N, N>(T, b, c);
    // Tdir <- T d + Tdir Tdd
    float Td[N][N], TdTdd[N][N], Tn[N][N], Tddn[N][N];
    mm<N, N, N>(T, di, Td);
    mm<N, N, N>(Tdir, Tdd, TdTdd);
    mm<N, N, N>(T, W, Tn);
    mm<N, N, N>(Tdd, Tdd, Tddn);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        R[i][j] = R[i][j] + a[i][j];
        Rdir[i][j] = Rdir[i][j] + c[i][j];
        Tdir[i][j] = Td[i][j] + TdTdd[i][j];
        T[i][j] = Tn[i][j];
        Tdd[i][j] = Tddn[i][j];
      }
  }
  return expo;
}

// B6's 3D pass: one cell's rows. Gamma, its Pade-5 exponential and the
// doubling, then the clipping; o[q] is [R | T | RD | TD | TDD][q]. Returns
// the doubling count.
template <int N>
__device__ __forceinline__ int sw_3d_cell(
    const float* __restrict__ od_in, const float* __restrict__ ssa_in,
    const float* __restrict__ g_in, const float* __restrict__ trd_in,
    const float* __restrict__ trf_in, float mu0, int l, size_t i, size_t c,
    size_t m, int ncol, float max_gas_od_3d, float (&o)[5][N][N]) {
  constexpr int NN = N * N;
  float od[N], ssa[N], gg[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const size_t j = ((size_t)l * N + r) * m + i;
    od[r] = od_in[j];
    ssa[r] = ssa_in[j];
    gg[r] = g_in[j];
  }
  // Gamma = [[M, C], [0, D]], assembled in the order of the plain
  // version (ops/spartacus_reftrans.py sw_gamma_expm)
  constexpr int N3 = 3 * N;
  float G[N3][N3];
#pragma unroll
  for (int a = 0; a < N3; ++a)
#pragma unroll
    for (int b = 0; b < N3; ++b) G[a][b] = 0.0f;
  const float one_over_mu0 = 1.0f / mu0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float odr = r == 0 ? fminf(od[0], max_gas_od_3d) : od[r];
    float g1, g2, g3;
    sw_gammas(mu0, ssa[r], gg[r], &g1, &g2, &g3);
    G[r][r] = G[r][r] + odr * g1;
    G[N + r][r] = G[N + r][r] + odr * g2;
    G[r][2 * N + r] = G[r][2 * N + r] + -odr * ssa[r] * g3;
    G[N + r][2 * N + r] =
        G[N + r][2 * N + r] + odr * ssa[r] * (1.0f - g3);
    G[2 * N + r][2 * N + r] = G[2 * N + r][2 * N + r]
        + -fminf(odr * one_over_mu0, MAX_OD_OVER_MU0_3D);
  }
  const size_t tc = (size_t)l * NN * ncol + c;
  auto trd = [&](int a, int b) {
    return trd_in[tc + (size_t)(a * N + b) * ncol];
  };
  auto trf = [&](int a, int b) {
    return trf_in[tc + (size_t)(a * N + b) * ncol];
  };
  constexpr int NPAIRS = N == 3 ? 3 : 1;
  const int pa[3] = {0, 1, 0}, pb[3] = {1, 2, 2};
#pragma unroll
  for (int p = 0; p < NPAIRS; ++p) {
    const int a = pa[p], b = pb[p];
    G[a][a] = G[a][a] + trf(a, b);
    G[b][b] = G[b][b] + trf(b, a);
    G[b][a] = G[b][a] + -trf(a, b);
    G[a][b] = G[a][b] + -trf(b, a);
    G[2 * N + a][2 * N + a] = G[2 * N + a][2 * N + a] + -trd(a, b);
    G[2 * N + b][2 * N + b] = G[2 * N + b][2 * N + b] + -trd(b, a);
    G[2 * N + b][2 * N + a] = G[2 * N + b][2 * N + a] + trd(a, b);
    G[2 * N + a][2 * N + b] = G[2 * N + a][2 * N + b] + trd(b, a);
  }
  float M[2 * N][2 * N], Cm[2 * N][N], D[N][N];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) {
      G[N + a][N + b] = -G[a][b];
      G[a][N + b] = -G[N + a][b];
    }
#pragma unroll
  for (int a = 0; a < 2 * N; ++a) {
#pragma unroll
    for (int b = 0; b < 2 * N; ++b) M[a][b] = G[a][b];
#pragma unroll
    for (int b = 0; b < N; ++b) Cm[a][b] = G[a][2 * N + b];
  }
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) D[a][b] = G[2 * N + a][2 * N + b];
  const int count =
      expm_reftrans_sw<N>(M, Cm, D, o[0], o[1], o[2], o[3], o[4]);
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) {
      o[0][a][b] = fminf(fmaxf(o[0][a][b], 0.0f), 1.0f);
      o[1][a][b] = fminf(fmaxf(o[1][a][b], 0.0f), 1.0f);
      o[2][a][b] = fminf(fmaxf(o[2][a][b], 0.0f), mu0);
      o[3][a][b] = fminf(fmaxf(o[3][a][b], 0.0f), mu0);
      o[4][a][b] = fminf(fmaxf(o[4][a][b], 0.0f), 1.0f);
    }
  return count;
}

// pass 1 of B6, over the 3D cells only: a persistent grid whose warps
// stride over groups of 32 cells, append each group's 3D cells to a queue
// of their own (a ballot, in shared memory) and, each time it holds 32,
// compute them with every lane busy. A round's 32 results go to 32
// adjacent slots of `packed` (rows (5 NREG^2, cap), one atomicAdd per
// round on *n3d, which starts at 0), and slot_of[cell] records the slot;
// past cap slots a cell is written to `out` in place and its slot is -1.
// Each cell's rows depend on that cell alone, so the order of the slots
// changes no value.
template <int NREG>
__global__ void __launch_bounds__(THREADS)
sw_3d_kernel(const float* __restrict__ od_in,
             const float* __restrict__ ssa_in,
             const float* __restrict__ g_in,
             const float* __restrict__ trd_in,
             const float* __restrict__ trf_in,
             const float* __restrict__ mu0_in,
             const uint8_t* __restrict__ use3d_in,
             const uint8_t* __restrict__ clear_in, int nlev, int ng,
             int ncol, int cap, float max_gas_od_3d, float* __restrict__ out,
             int8_t* __restrict__ counts, float* __restrict__ packed,
             int* __restrict__ slot_of, int* __restrict__ n3d) {
  constexpr int N = NREG, NN = NREG * NREG, WARPS = THREADS / 32;
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ int queues[WARPS][64];
  const int lane = threadIdx.x % 32;
  int* q = queues[threadIdx.x / 32];
  const size_t m = (size_t)ng * ncol, n = (size_t)nlev * m;
  const size_t groups = (n + 31) / 32, stride = (size_t)gridDim.x * WARPS;
  int qn = 0;  // the queue's length, the same in every lane
  for (size_t grp = (size_t)blockIdx.x * WARPS + threadIdx.x / 32;;
       grp += stride) {
    const bool more = grp < groups;
    if (more) {
      const size_t idx = grp * 32 + lane;
      const bool is3d = idx < n && use3d_in[idx] != 0;
      const unsigned vote = __ballot_sync(ALL, is3d);
      if (is3d) q[qn + __popc(vote & ((1u << lane) - 1u))] = (int)idx;
      qn += __popc(vote);
    }
    // a full round, or the last cells of this warp's groups
    if (qn >= 32 || (!more && qn > 0)) {
      const int take = min(qn, 32);
      __syncwarp();
      const int cell = lane < take ? q[lane] : -1;
      __syncwarp();
      if (lane < qn - take) q[lane] = q[take + lane];
      __syncwarp();
      qn -= take;
      int base = 0;
      if (lane == 0) base = atomicAdd(n3d, take);
      base = __shfl_sync(ALL, base, 0);
      if (cell >= 0) {
        const size_t idx = (size_t)cell;
        const int l = (int)(idx / m);
        const size_t i = idx % m, c = i % ncol;
        const float mu0 = mu0_in[c];
        float o[5][N][N];
        const int count = sw_3d_cell<N>(od_in, ssa_in, g_in, trd_in, trf_in,
                                        mu0, l, i, c, m, ncol, max_gas_od_3d,
                                        o);
        const bool clear = clear_in[(size_t)l * ncol + c] != 0;
        const int slot = base + lane;
        const bool staged = slot < cap;
        float* dst = staged ? packed + slot : out + (size_t)l * 5 * NN * m + i;
        const size_t step = staged ? (size_t)cap : m;
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int a = 0; a < N; ++a)
#pragma unroll
            for (int b = 0; b < N; ++b)
              dst[(size_t)(k * NN + a * N + b) * step] =
                  (clear && (a > 0 || b > 0)) ? 0.0f : o[k][a][b];
        slot_of[idx] = staged ? slot : -1;
        if (counts) counts[idx] = (int8_t)count;
      }
    }
    if (!more) break;
  }
}

// pass 2 of B6, over every cell, so that every 32-byte sector of the
// output is written whole, by one warp, once: a fallback cell gets its
// Meador-Weaver rows, the off-diagonals zero, and count -1; a 3D cell the
// rows pass 1 staged in its slot (nothing where pass 1 wrote it in place).
// Both kinds go through the same 5 NREG^2 stores, each a full row of the
// warp's 32 columns. Compiled apart from pass 1, so it keeps few registers
// and many warps for what is a streaming write.
template <int NREG>
__global__ void __launch_bounds__(LEAN_THREADS, LEAN_MIN_BLOCKS)
sw_fallback_kernel(const float* __restrict__ od_in,
                   const float* __restrict__ ssa_in,
                   const float* __restrict__ g_in,
                   const float* __restrict__ mu0_in,
                   const uint8_t* __restrict__ use3d_in,
                   const uint8_t* __restrict__ clear_in,
                   const float* __restrict__ packed,
                   const int* __restrict__ slot_of, int nlev, int ng,
                   int ncol, int cap, float* __restrict__ out,
                   int8_t* __restrict__ counts) {
  constexpr int N = NREG, NN = NREG * NREG;
  const size_t m = (size_t)ng * ncol;
  const size_t idx = (size_t)blockIdx.x * LEAN_THREADS + threadIdx.x;
  if (idx >= (size_t)nlev * m) return;
  const int l = (int)(idx / m);
  const size_t i = idx % m;
  const size_t c = i % ncol;
  const bool is3d = use3d_in[idx] != 0;
  const int slot = is3d ? slot_of[idx] : 0;
  // a 3D cell past the staged share was written by pass 1
  if (slot < 0) return;
  float w[5][N];
  if (!is3d) {
    const float mu0 = mu0_in[c];
    const bool clear = clear_in[(size_t)l * ncol + c] != 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const size_t j = ((size_t)l * N + r) * m + i;
      const Mw v = sw_fallback(mu0, od_in[j], ssa_in[j], g_in[j]);
      const bool z = clear && r > 0;
      w[0][r] = z ? 0.0f : v.r;
      w[1][r] = z ? 0.0f : v.t;
      w[2][r] = z ? 0.0f : v.rd;
      w[3][r] = z ? 0.0f : v.td;
      w[4][r] = z ? 0.0f : v.tdd;
    }
    if (counts) counts[idx] = -1;
  }
  const float* p = packed + slot;
  float* o = out + (size_t)l * 5 * NN * m + i;
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = q * NN + a * N + b;
        o[(size_t)k * m] = is3d ? p[(size_t)k * cap]
                                : (a == b ? w[q][a] : 0.0f);
      }
}

// ---- LW ----

// B7's operands, passed by value to both of its passes: od/ssa/g (nlev,
// NREG, ng, ncol), tr (nlev, NREG, NREG, ncol), se/pt/pb (nlev, ng,
// ncol), fr (nlev, NREG, ncol), use3d (nlev, ng, ncol), clear (nlev, ncol)
struct LwArgs {
  const float *od, *ssa, *g, *tr, *se, *pt, *pb, *fr;
  const uint8_t *use3d, *clear;
  int nlev, ng, ncol;
};

// a cell's level l, its index i among the level's m = ng ncol cells and
// its column c; B7 has fewer than 2^31 cells, so the divisions are 32-bit
struct CellAt {
  int l;
  size_t i, c;
};
__device__ __forceinline__ CellAt cell_at(size_t idx, const LwArgs& p) {
  const unsigned m = (unsigned)p.ng * (unsigned)p.ncol, x = (unsigned)idx;
  const unsigned l = x / m, i = x - l * m;
  return {(int)l, (size_t)i, (size_t)(i % (unsigned)p.ncol)};
}

// (R, T) of [[A, -B], [B, -A]] (solvers/matrix.py expm_reftrans_lw_g);
// returns the doubling count. Both Pade sums are formed before U = G V,
// the second in A4's place, so that A2 dies early; each value is the
// plain version's expression.
template <int N>
__device__ int expm_reftrans_lw(const float (&A)[N][N], const float (&B)[N][N],
                                float (&R)[N][N], float (&T)[N][N]) {
  constexpr int N2 = 2 * N;
  float norm1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = fabsf(A[0][j]) + fabsf(B[0][j]);
#pragma unroll
    for (int i = 1; i < N; ++i) s = s + fabsf(A[i][j]) + fabsf(B[i][j]);
    norm1 = j == 0 ? s : fmaxf(norm1, s);
  }
  float scale;
  const int expo = doubling_count(norm1, &scale);
  float G[N2][N2];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = A[i][j] * scale, y = B[i][j] * scale;
      G[i][j] = x;
      G[i][N + j] = -y;
      G[N + i][j] = y;
      G[N + i][N + j] = -x;
    }
  float A2[N2][N2], A4[N2][N2], V[N2][N2], U[N2][N2];
  mm<N2, N2, N2>(G, G, A2);
  mm<N2, N2, N2>(A2, A2, A4);
  pade_sum<N2, N2>(A4, A2, C5, C3, C1, true, V);
  pade_sum<N2, N2>(A4, A2, C4, C2, C0, true, A4);
  mm<N2, N2, N2>(G, V, U);
  float E[N2][N2];
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < N2; ++j) {
      A4[i][j] = A4[i][j] - U[i][j];
      E[i][j] = 2.0f * U[i][j];
    }
  solve<N2, N2>(A4, E);
#pragma unroll
  for (int i = 0; i < N2; ++i) E[i][i] = E[i][i] + 1.0f;
  float a[N][N], rr[N][N], e21[N][N], t1[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = E[i][j];
      rr[i][j] = E[i][N + j];
      e21[i][j] = E[N + i][j];
    }
  solve<N, N>(a, rr);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) R[i][j] = -rr[i][j];
  mm<N, N, N>(e21, R, t1);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) T[i][j] = E[N + i][N + j] + t1[i][j];
  for (int k = 0; k < expo; ++k) {
    float den[N][N], W[N][N], TR[N][N], dR[N][N], Tn[N][N];
    one_minus_sq<N>(R, den);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) W[i][j] = T[i][j];
    solve<N, N>(den, W);
    mm<N, N, N>(T, R, TR);
    mm<N, N, N>(TR, W, dR);
    mm<N, N, N>(T, W, Tn);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        R[i][j] = R[i][j] + dR[i][j];
        T[i][j] = Tn[i][j];
      }
  }
  return expo;
}

// B7's 3D pass: one cell's (R, T, SU, SD). The generator's blocks A and B
// (ops/spartacus_reftrans.py lw_gamma_expm, region 0's od capped), the
// particular solution in the sum/difference basis, the Pade-5
// exponential and the doubling, then the sources. Returns the doubling
// count.
template <int N>
__device__ __forceinline__ int lw_3d_cell(const LwArgs& p,
                                          float max_gas_od_3d, int l,
                                          size_t idx, size_t i, size_t c,
                                          size_t m, float (&R)[N][N],
                                          float (&T)[N][N], float (&su)[N],
                                          float (&sd)[N]) {
  constexpr int NN = N * N;
  const float pt = p.pt[idx], pb = p.pb[idx];
  float od[N], ssa[N], g1[N], g2[N], fr[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const size_t j = ((size_t)l * N + r) * m + i;
    od[r] = p.od[j];
    ssa[r] = p.ssa[j];
    // two_stream.py lw_gammas
    const float factor = (LW_DIFFUSIVITY * 0.5f) * ssa[r];
    const float gv = p.g[j];
    g1[r] = LW_DIFFUSIVITY - factor * (1.0f + gv);
    g2[r] = factor * (1.0f - gv);
    fr[r] = p.fr[((size_t)l * N + r) * p.ncol + c];
  }
  const float se = p.se[idx];
  const size_t tc = (size_t)l * NN * p.ncol + c;
  auto tr = [&](int a, int b) {
    return p.tr[tc + (size_t)(a * N + b) * p.ncol];
  };
  float A[N][N], B[N][N], odc[N];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) A[a][b] = B[a][b] = 0.0f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    odc[r] = r == 0 ? fminf(od[0], max_gas_od_3d) : od[r];
    A[r][r] = A[r][r] + odc[r] * g1[r];
    B[r][r] = B[r][r] + odc[r] * g2[r];
  }
#pragma unroll
  for (int r = 0; r < N - 1; ++r) {
    A[r][r] = A[r][r] + tr(r, r + 1);
    A[r + 1][r] = A[r + 1][r] + -tr(r, r + 1);
    if (r > 0) {
      A[r + 1][r + 1] = A[r + 1][r + 1] + tr(r + 1, r);
      A[r][r + 1] = A[r][r + 1] + -tr(r + 1, r);
    } else {
      A[r + 1][r + 1] = A[r + 1][r + 1] + se * tr(r + 1, r);
      A[r][r + 1] = A[r][r + 1] + -se * tr(r + 1, r);
    }
  }
  if (N == 3) {
    A[0][0] = A[0][0] + tr(0, 2);
    A[N - 1][0] = A[N - 1][0] + -tr(0, 2);
    A[N - 1][N - 1] = A[N - 1][N - 1] + se * tr(2, 0);
    A[0][N - 1] = A[0][N - 1] + -se * tr(2, 0);
  }
  // the particular solution in the sum/difference basis
  float F[N][N], E[N][N], vw[N][2], u[N][1];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float emis = odc[r] * (1.0f - ssa[r]) * fr[r] * LW_DIFFUSIVITY;
    vw[r][0] = emis * (pb - pt);
    vw[r][1] = emis * pt;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      E[r][b] = A[r][b] + B[r][b];
      F[r][b] = A[r][b] - B[r][b];
    }
    E[r][r] = E[r][r] + 1e-12f;
    F[r][r] = F[r][r] + 1e-12f;
  }
  solve<N, 2>(F, vw);
#pragma unroll
  for (int r = 0; r < N; ++r) u[r][0] = vw[r][0];
  solve<N, 1>(E, u);
  float up[N], dn[N], pu_b[N], uu[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uu[r] = vw[r][0];
    up[r] = vw[r][1] + u[r][0];
    dn[r] = vw[r][1] - u[r][0];
    pu_b[r] = up[r] + uu[r];
  }
  const int count = expm_reftrans_lw<N>(A, B, R, T);
  float a1[N], a2[N], b1[N], b2[N];
  mv<N, N>(R, dn, a1);
  mv<N, N>(T, pu_b, a2);
  mv<N, N>(T, dn, b1);
  mv<N, N>(R, pu_b, b2);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    su[r] = up[r] - a1[r] - a2[r];
    sd[r] = dn[r] + uu[r] - b1[r] - b2[r];
  }
  return count;
}

// pass 1 of B7, over the 3D cells only: a persistent grid whose warps
// stride over groups of 32 cells. A warp reads `use3d` for BATCH of its
// groups at once (one wait on memory, not one per group), lists their 3D
// cells in order, and computes the list 32 cells a round, every lane
// busy. A round's rows go to 32 adjacent slots of `packed`, each slot one
// cell's 2 NREG (NREG + 1) rows in a row (cap slots), and slot_of[cell]
// records the slot; past cap slots a cell is written to `out` in place
// and its slot is -1. Each cell's rows depend on that cell alone, so the
// order of the slots changes no value.
template <int NREG>
__global__ void __launch_bounds__(THREADS, LW_3D_MIN_BLOCKS)
lw_3d_kernel(LwArgs p, int cap, float max_gas_od_3d,
             float* __restrict__ out, int8_t* __restrict__ counts,
             float* __restrict__ packed, int* __restrict__ slot_of,
             int* __restrict__ n3d) {
  constexpr int N = NREG, NN = NREG * NREG, NR = 2 * N * (N + 1),
                WARPS = THREADS / 32, BATCH = 16;
  constexpr unsigned ALL = 0xffffffffu;
  static_assert(NR % 4 == 0, "a slot is whole float4s");
  // a warp's listed cells: fewer than a round, then a batch's
  __shared__ int listed[WARPS][(BATCH + 1) * 32];
  const int lane = threadIdx.x % 32;
  int* list = listed[threadIdx.x / 32];
  const size_t m = (size_t)p.ng * p.ncol, n = (size_t)p.nlev * m;
  const size_t groups = (n + 31) / 32, stride = (size_t)gridDim.x * WARPS;
  size_t grp = (size_t)blockIdx.x * WARPS + threadIdx.x / 32;
  // the cells not computed yet are list[head .. nlist), in every lane
  int head = 0, nlist = 0;
  for (;;) {
    if (nlist - head < 32 && grp < groups) {
      // what is left to the front, then the 3D cells of the next BATCH
      // groups, their flags read at once
      const int rest = nlist - head;
      const int v = lane < rest ? list[head + lane] : 0;
      bool f[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const size_t idx = (grp + (size_t)b * stride) * 32 + lane;
        f[b] = idx < n && p.use3d[idx] != 0;
      }
      __syncwarp();
      if (lane < rest) list[lane] = v;
      head = 0;
      nlist = rest;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const unsigned vote = __ballot_sync(ALL, f[b]);
        if (f[b])
          list[nlist + __popc(vote & ((1u << lane) - 1u))] =
              (int)((grp + (size_t)b * stride) * 32 + lane);
        nlist += __popc(vote);
      }
      __syncwarp();
      grp += (size_t)BATCH * stride;
      continue;
    }
    if (head == nlist) break;
    const int take = min(32, nlist - head);
    const int cell = lane < take ? list[head + lane] : -1;
    head += take;
    int base = 0;
    if (lane == 0) base = atomicAdd(n3d, take);
    base = __shfl_sync(ALL, base, 0);
    if (cell >= 0) {
      const size_t idx = (size_t)cell;
      const CellAt at = cell_at(idx, p);
      float R[N][N], T[N][N], su[N], sd[N];
      const int count = lw_3d_cell<N>(p, max_gas_od_3d, at.l, idx, at.i,
                                      at.c, m, R, T, su, sd);
      const bool clear = p.clear[(size_t)at.l * p.ncol + at.c] != 0;
      float v[NR];
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b) {
          const bool z = clear && (a > 0 || b > 0);
          v[a * N + b] = z ? 0.0f : R[a][b];
          v[NN + a * N + b] = z ? 0.0f : T[a][b];
        }
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const bool z = clear && r > 0;
        v[2 * NN + r] = z ? 0.0f : su[r];
        v[2 * NN + N + r] = z ? 0.0f : sd[r];
      }
      const int slot = base + lane;
      if (slot < cap) {
        float4* d = reinterpret_cast<float4*>(packed + (size_t)slot * NR);
#pragma unroll
        for (int h = 0; h < NR / 4; ++h)
          d[h] = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                             v[4 * h + 3]);
        slot_of[idx] = slot;
      } else {
        float* o = out + (size_t)at.l * NR * m + at.i;
#pragma unroll
        for (int h = 0; h < NR; ++h) o[(size_t)h * m] = v[h];
        slot_of[idx] = -1;
      }
      if (counts) counts[idx] = (int8_t)count;
    }
  }
}

// pass 2 of B7, over every cell, as B6's: a fallback cell gets its
// Meador-Weaver rows (two_stream.py lw_reftrans with cloud scattering,
// lw_no_scattering_transmittance without), the off-diagonals zero, the
// cloudy regions of clear layers zero, and count -1; a 3D cell the rows
// pass 1 staged in its slot, read whole (nothing where pass 1 wrote it in
// place). Every row goes out in one store for all of a warp's lanes, so
// each 32-byte sector is written whole, once.
template <int NREG>
__global__ void __launch_bounds__(LEAN_THREADS, LEAN_MIN_BLOCKS)
lw_fallback_kernel(LwArgs p, int cloud_scattering,
                   const float* __restrict__ packed,
                   const int* __restrict__ slot_of, int cap,
                   float* __restrict__ out, int8_t* __restrict__ counts) {
  constexpr int N = NREG, NN = NREG * NREG, NR = 2 * N * (N + 1);
  const size_t m = (size_t)p.ng * p.ncol;
  const size_t idx = (size_t)blockIdx.x * LEAN_THREADS + threadIdx.x;
  if (idx >= (size_t)p.nlev * m) return;
  const CellAt at = cell_at(idx, p);
  const int l = at.l;
  const size_t i = at.i, c = at.c;
  const bool is3d = p.use3d[idx] != 0;
  const int slot = is3d ? slot_of[idx] : 0;
  // a 3D cell past the staged share was written by pass 1
  if (slot < 0) return;
  // [R | T | SU | SD] of each region: the diagonals and the sources
  float w[4][N];
  if (!is3d) {
    const float pt = p.pt[idx], pb = p.pb[idx];
    const bool clear = p.clear[(size_t)l * p.ncol + c] != 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const size_t j = ((size_t)l * N + r) * m + i;
      const float od = p.od[j];
      float rr, tt, u, d;
      if (cloud_scattering) {
        // two_stream.py lw_gammas and lw_reftrans
        const float factor = (LW_DIFFUSIVITY * 0.5f) * p.ssa[j];
        const float gv = p.g[j];
        const float g1 = LW_DIFFUSIVITY - factor * (1.0f + gv);
        const float g2 = factor * (1.0f - gv);
        const float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), 1.0e-4f));
        const float expo = expf(-k * od);
        const float expo2 = expo * expo;
        const float rt = 1.0f / (k + g1 + (k - g1) * expo2);
        if (od <= 1.0e-3f) {
          rr = g2 * od;
          tt = (1.0f - k * od) / (1.0f + od * (g1 - k));
          u = d = (1.0f - rr - tt) * 0.5f * (pt + pb);
        } else {
          rr = g2 * (1.0f - expo2) * rt;
          tt = 2.0f * k * expo * rt;
          const float coeff = (pb - pt) / fmaxf(od * (g1 + g2), 1.0e-30f);
          u = (coeff + pt) - rr * (-coeff + pt) - tt * (coeff + pb);
          d = (-coeff + pb) - rr * (coeff + pb) - tt * (-coeff + pt);
        }
      } else {
        // two_stream.py lw_no_scattering_transmittance
        const float coeff0 = LW_DIFFUSIVITY * od;
        const float trans = expf(-coeff0);
        const float coeff = (pb - pt) / fmaxf(coeff0, 1.0e-30f);
        rr = 0.0f;
        if (od <= 1.0e-3f) {
          tt = 1.0f - coeff0;
          u = d = coeff0 * 0.5f * (pt + pb);
        } else {
          tt = trans;
          u = (coeff + pt) - trans * (coeff + pb);
          d = (-coeff + pb) - trans * (-coeff + pt);
        }
      }
      const float fr = p.fr[((size_t)l * N + r) * p.ncol + c];
      const bool z = clear && r > 0;
      w[0][r] = z ? 0.0f : rr;
      w[1][r] = z ? 0.0f : tt;
      w[2][r] = z ? 0.0f : u * fr;
      w[3][r] = z ? 0.0f : d * fr;
    }
    if (counts) counts[idx] = -1;
  }
  float v[NR];
  if (is3d) {
    // the slot's rows, in a row
    const float4* q =
        reinterpret_cast<const float4*>(packed + (size_t)slot * NR);
#pragma unroll
    for (int h = 0; h < NR / 4; ++h) {
      const float4 t = q[h];
      v[4 * h] = t.x;
      v[4 * h + 1] = t.y;
      v[4 * h + 2] = t.z;
      v[4 * h + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b)
          v[h * NN + a * N + b] = a == b ? w[h][a] : 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[2 * NN + r] = w[2][r];
      v[2 * NN + N + r] = w[3][r];
    }
  }
  float* o = out + (size_t)l * NR * m + i;
#pragma unroll
  for (int h = 0; h < NR; ++h) o[(size_t)h * m] = v[h];
}

// a 3D pass's persistent grid: as many blocks of `kernel` as are
// resident on the card at once, and no more than its warps' groups of 32
// cells could fill
template <class Kernel>
cudaError_t grid_3d(Kernel kernel, size_t cells, unsigned* blocks) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t most = (size_t)(per_sm > 0 ? per_sm : 1) * sms;
  const size_t need = (cells + THREADS - 1) / THREADS;
  *blocks = (unsigned)(need < most ? need : most);
  return e;
}
}  // namespace spartacus
}  // namespace ecrad

// B6, pass 1, over the 3D cells of the nlev x ng x ncol cells: `packed`
// holds (5 nreg^2, cap) floats, slot_of one int per cell, and *n3d must
// be 0 on entry
extern "C" int spartacus_sw_reftrans_3d(
    const float* od, const float* ssa, const float* g, const float* trd,
    const float* trf, const float* mu0, const uint8_t* use3d,
    const uint8_t* clear, float* out, int8_t* counts, float* packed,
    int* slot_of, int* n3d, int nreg, int nlev, int ng, int ncol, int cap,
    float max_gas_od_3d, void* stream) {
  namespace sp = ecrad::spartacus;
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = 0;
  cudaError_t e;
  if (nreg == 3) {
    if ((e = sp::grid_3d(sp::sw_3d_kernel<3>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sp::sw_3d_kernel<3><<<blocks, sp::THREADS, 0, s>>>(
        od, ssa, g, trd, trf, mu0, use3d, clear, nlev, ng, ncol, cap,
        max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else if (nreg == 2) {
    if ((e = sp::grid_3d(sp::sw_3d_kernel<2>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sp::sw_3d_kernel<2><<<blocks, sp::THREADS, 0, s>>>(
        od, ssa, g, trd, trf, mu0, use3d, clear, nlev, ng, ncol, cap,
        max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B6, pass 2, over every cell, after pass 1 on the same stream
extern "C" int spartacus_sw_reftrans_fallback(
    const float* od, const float* ssa, const float* g, const float* mu0,
    const uint8_t* use3d, const uint8_t* clear, const float* packed,
    const int* slot_of, float* out, int8_t* counts, int nreg, int nlev,
    int ng, int ncol, int cap, void* stream) {
  namespace sp = ecrad::spartacus;
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + sp::LEAN_THREADS - 1)
                                     / sp::LEAN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    sp::sw_fallback_kernel<3><<<blocks, sp::LEAN_THREADS, 0, s>>>(
        od, ssa, g, mu0, use3d, clear, packed, slot_of, nlev, ng, ncol, cap,
        out, counts);
  } else if (nreg == 2) {
    sp::sw_fallback_kernel<2><<<blocks, sp::LEAN_THREADS, 0, s>>>(
        od, ssa, g, mu0, use3d, clear, packed, slot_of, nlev, ng, ncol, cap,
        out, counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B6's compiled resources and occupancy (kernel_info.cuh): pass 0 is the
// lean pass (2), pass 1 the 3D pass (1)
extern "C" int spartacus_sw_reftrans_info(int pass, int nreg, int* info) {
  namespace sp = ecrad::spartacus;
  if (pass == 0 && nreg == 3)
    return ecrad::kernel_info(sp::sw_fallback_kernel<3>, sp::LEAN_THREADS,
                              0, info);
  if (pass == 0 && nreg == 2)
    return ecrad::kernel_info(sp::sw_fallback_kernel<2>, sp::LEAN_THREADS,
                              0, info);
  if (pass == 1 && nreg == 3)
    return ecrad::kernel_info(sp::sw_3d_kernel<3>, sp::THREADS, 0, info);
  if (pass == 1 && nreg == 2)
    return ecrad::kernel_info(sp::sw_3d_kernel<2>, sp::THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}

// B7, pass 1, over the 3D cells: `packed` holds cap slots of 2 nreg (nreg
// + 1) floats, slot_of one int per cell, and *n3d must be 0 on entry
extern "C" int spartacus_lw_reftrans_3d(
    const float* od, const float* ssa, const float* g, const float* tr,
    const float* se, const float* pt, const float* pb, const float* fr,
    const uint8_t* use3d, const uint8_t* clear, float* out, int8_t* counts,
    float* packed, int* slot_of, int* n3d, int nreg, int nlev, int ng,
    int ncol, int cap, float max_gas_od_3d, void* stream) {
  namespace sp = ecrad::spartacus;
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const sp::LwArgs p{od, ssa, g, tr, se, pt, pb, fr, use3d, clear,
                     nlev, ng, ncol};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = 0;
  cudaError_t e;
  if (nreg == 3) {
    if ((e = sp::grid_3d(sp::lw_3d_kernel<3>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sp::lw_3d_kernel<3><<<blocks, sp::THREADS, 0, s>>>(
        p, cap, max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else if (nreg == 2) {
    if ((e = sp::grid_3d(sp::lw_3d_kernel<2>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sp::lw_3d_kernel<2><<<blocks, sp::THREADS, 0, s>>>(
        p, cap, max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B7, pass 2, over every cell, after pass 1 on the same stream
extern "C" int spartacus_lw_reftrans_fallback(
    const float* od, const float* ssa, const float* g, const float* pt,
    const float* pb, const float* fr, const uint8_t* use3d,
    const uint8_t* clear, const float* packed, const int* slot_of,
    float* out, int8_t* counts, int nreg, int nlev, int ng, int ncol,
    int cap, int cloud_scattering, void* stream) {
  namespace sp = ecrad::spartacus;
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const sp::LwArgs p{od, ssa, g, nullptr, nullptr, pt, pb, fr, use3d,
                     clear, nlev, ng, ncol};
  const unsigned blocks = (unsigned)((n + sp::LEAN_THREADS - 1)
                                     / sp::LEAN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    sp::lw_fallback_kernel<3><<<blocks, sp::LEAN_THREADS, 0, s>>>(
        p, cloud_scattering, packed, slot_of, cap, out, counts);
  } else if (nreg == 2) {
    sp::lw_fallback_kernel<2><<<blocks, sp::LEAN_THREADS, 0, s>>>(
        p, cloud_scattering, packed, slot_of, cap, out, counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B7's compiled resources and occupancy (kernel_info.cuh): pass 0 is the
// pass over every cell (2), pass 1 the 3D pass (1)
extern "C" int spartacus_lw_reftrans_info(int pass, int nreg, int* info) {
  namespace sp = ecrad::spartacus;
  if (pass == 0 && nreg == 3)
    return ecrad::kernel_info(sp::lw_fallback_kernel<3>, sp::LEAN_THREADS,
                              0, info);
  if (pass == 0 && nreg == 2)
    return ecrad::kernel_info(sp::lw_fallback_kernel<2>, sp::LEAN_THREADS,
                              0, info);
  if (pass == 1 && nreg == 3)
    return ecrad::kernel_info(sp::lw_3d_kernel<3>, sp::THREADS, 0, info);
  if (pass == 1 && nreg == 2)
    return ecrad::kernel_info(sp::lw_3d_kernel<2>, sp::THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}
