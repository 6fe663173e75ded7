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
// Every kernel is a template on its scalar type T: the float forms are
// the float32 path's, the double forms (entry points *_f64) the float64
// path's, the same expressions with each constant spelt at T's precision
// (ECRAD_LIT). A double form takes each SW fallback cell in double
// throughout, so the float form's resonance window has nothing to do
// there. Doubles take twice the registers; of the bounds timed at 2048 x
// 137 on the float64 path's operands the fastest are: for the 3D
// pipelines, which spill in double whatever the bound (the SW one's 6 x 6
// blocks alone fill 255 registers), the registers they can take (B7's
// its own bound, F64_LW_3D_MIN_BLOCKS); for the passes over every cell
// the float forms' 6 blocks per SM.
// The warp queues hold cell indices, the same in either form, and the
// staged share stays a quarter of the cells (twice the bytes in double).
//
// Semantics: ops/spartacus_reftrans.py sw_reftrans_levels_plain and
// lw_reftrans_levels_plain, expression for expression (built with
// -fmad=false, exact expf/sqrtf): products add their terms left to right
// as solvers/matrix.py mm_gu does, the elimination is solve_g's, and the
// doubling count comes from the same compare chain (not a log2, which
// flips the count on borderline norms). SW fallback cells of the float
// form within RESONANCE_WINDOW (0.03) of k mu0 = 1 take the Meador-Weaver
// terms in double, as two_stream.sw_reftrans does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "scalar.cuh"

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
// The double forms' bounds, timed on an H100 at 2048 x 137, 3 regions,
// on the float64 path's operands (tools/spartacus_f64_designs.py,
// PERF.md). The passes over every cell keep LEAN_MIN_BLOCKS: B6's 6.234
// ms at 6 blocks (80 registers, 8 B spilled), 6.297 at 4 (122), 6.76 at 3
// and 2 (148); B7's at 64 registers and 8 blocks whatever the bound.
// B7's 3D pass takes F64_LW_3D_MIN_BLOCKS: 2.383 ms at 1 block (255
// registers, 88 B spilled, 2 blocks resident), the same code at 2, 2.941
// at 3 (168 registers, 520 B spilled). B6's 3D pass spills 1.4 KB a
// thread at any bound (9.2 ms).
constexpr int F64_LW_3D_MIN_BLOCKS = 1;
constexpr int MAX_DOUBLINGS = 12;
constexpr float RESONANCE_WINDOW = 0.03f;


// the constants of the plain versions at precision T: the doubling
// threshold theta (solvers/matrix.py _THETA_DBL), the cap on od / mu0 in
// the SW Gamma's direct block, the LW diffusivity and the Pade-5
// coefficients c0 .. c5
template <typename T>
struct Consts {
  static __device__ __forceinline__ T theta() { return ECRAD_LIT(1.8); }
  static __device__ __forceinline__ T max_od_over_mu0() {
    return ECRAD_LIT(60.0);
  }
  static __device__ __forceinline__ T diffusivity() {
    return ECRAD_LIT(1.66);
  }
  static __device__ __forceinline__ T c0() { return ECRAD_LIT(30240.0); }
  static __device__ __forceinline__ T c1() { return ECRAD_LIT(15120.0); }
  static __device__ __forceinline__ T c2() { return ECRAD_LIT(3360.0); }
  static __device__ __forceinline__ T c3() { return ECRAD_LIT(420.0); }
  static __device__ __forceinline__ T c4() { return ECRAD_LIT(30.0); }
  static __device__ __forceinline__ T c5() { return ECRAD_LIT(1.0); }
};

// o = a b, each o[i][j] summed over k left to right
template <int M, int K, int N, typename T>
__device__ __forceinline__ void mm(const T (&a)[M][K], const T (&b)[K][N],
                                   T (&o)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + a[i][k] * b[k][j];
      o[i][j] = s;
    }
}

template <int M, int K, typename T>
__device__ __forceinline__ void mv(const T (&a)[M][K], const T (&x)[K],
                                   T (&o)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T s = a[i][0] * x[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s = s + a[i][k] * x[k];
    o[i] = s;
  }
}

// solve a x = b in place (b <- x), unpivoted elimination in the order of
// solvers/matrix.py solve_g; a is overwritten
template <int M, int N, typename T>
__device__ __forceinline__ void solve(T (&a)[M][M], T (&b)[M][N]) {
#pragma unroll
  for (int col = 0; col < M; ++col) {
    const T inv = T(1) / a[col][col];
#pragma unroll
    for (int j = col + 1; j < M; ++j) a[col][j] = a[col][j] * inv;
#pragma unroll
    for (int j = 0; j < N; ++j) b[col][j] = b[col][j] * inv;
#pragma unroll
    for (int row = col + 1; row < M; ++row) {
      const T f = a[row][col];
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
      const T f = a[row][col];
#pragma unroll
      for (int j = 0; j < N; ++j) b[row][j] = b[row][j] - f * b[col][j];
    }
}

// the doubling count and 2^-count (solvers/matrix.py _squaring_count)
template <typename T>
__device__ __forceinline__ int doubling_count(T norm1, T* scale) {
  int expo = 0;
  T s = T(1);
#pragma unroll
  for (int k = 0; k < MAX_DOUBLINGS; ++k) {
    if (norm1 > Consts<T>::theta() * (T)(1 << k)) {
      ++expo;
      s = s * ECRAD_LIT(0.5);
    }
  }
  *scale = s;
  return expo;
}

// d = I - r r (solvers/matrix.py add_eye_g(-mm_gu(r, r), 1))
template <int N, typename T>
__device__ __forceinline__ void one_minus_sq(const T (&r)[N][N],
                                             T (&d)[N][N]) {
  mm<N, N, N>(r, r, d);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[i][j] = -d[i][j];
    d[i][i] = d[i][i] + T(1);
  }
}

// ---- SW ----

template <typename O>
struct Mw {
  O r, t, rd, td, tdd;
};

// two_stream.py _sw_reftrans at precision T, rounded to O
template <typename T, typename O>
__device__ __forceinline__ Mw<O> sw_mw(T mu0, T od, T ssa, T gamma1,
                                       T gamma2, T gamma3) {
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
  Mw<O> o;
  o.r = (O)(gamma2 * (one - expo2) * rt);
  o.t = (O)(k2e * rt);
  const T rt_dir = mu0 * ssa * rt / (one - k_mu0 * k_mu0);
  o.rd = (O)(rt_dir * ((one - k_mu0) * (alpha2 + k_gamma3)
                       - (one + k_mu0) * (alpha2 - k_gamma3) * expo2
                       - k2e * (gamma3 - alpha2 * mu0) * e0));
  o.td = (O)(rt_dir * (k2e * (gamma4 + alpha1 * mu0)
                       - e0 * ((one + k_mu0) * (alpha1 + k_gamma4)
                               - (one - k_mu0) * (alpha1 - k_gamma4)
                               * expo2)));
  o.tdd = (O)e0;
  return o;
}

template <typename T>
__device__ __forceinline__ void sw_gammas(T mu0, T ssa, T g, T* g1, T* g2,
                                          T* g3) {
  const T factor = ECRAD_LIT(0.75) * g;
  *g1 = ECRAD_LIT(2.0) - ssa * (ECRAD_LIT(1.25) + factor);
  *g2 = ssa * (ECRAD_LIT(0.75) - factor);
  *g3 = ECRAD_LIT(0.5) - mu0 * factor;
}

// the Meador-Weaver terms of a fallback cell: in the float form, in
// double within RESONANCE_WINDOW of k mu0 = 1; in the double form, in
// double everywhere
template <typename T>
__device__ __forceinline__ Mw<T> sw_fallback(T mu0, T od, T ssa, T g) {
  T g1, g2, g3;
  sw_gammas(mu0, ssa, g, &g1, &g2, &g3);
  if constexpr (sizeof(T) == 4) {
    const float k = sqrtf(fmaxf((g1 - g2) * (g1 + g2), 1.0e-4f));
    if (fabsf(k * mu0 - 1.0f) < RESONANCE_WINDOW)
      return sw_mw<double, float>(mu0, od, ssa, g1, g2, g3);
  }
  return sw_mw<T, T>(mu0, od, ssa, g1, g2, g3);
}

// block product of [[a0, a1], [0, a2]] and [[b0, b1], [0, b2]]
template <int N, typename T>
__device__ __forceinline__ void bprod(
    const T (&a0)[2 * N][2 * N], const T (&a1)[2 * N][N],
    const T (&a2)[N][N], const T (&b0)[2 * N][2 * N],
    const T (&b1)[2 * N][N], const T (&b2)[N][N], T (&o0)[2 * N][2 * N],
    T (&o1)[2 * N][N], T (&o2)[N][N]) {
  mm<2 * N, 2 * N, 2 * N>(a0, b0, o0);
  T t[2 * N][N];
  mm<2 * N, 2 * N, N>(a0, b1, o1);
  mm<2 * N, N, N>(a1, b2, t);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o1[i][j] = o1[i][j] + t[i][j];
  mm<N, N, N>(a2, b2, o2);
}

// p = c4 A4 + c2 A2 (+ c0 on the diagonal blocks' diagonals)
template <int R, int C, typename T>
__device__ __forceinline__ void pade_sum(const T (&a4)[R][C],
                                         const T (&a2)[R][C], T c4, T c2,
                                         T c0, bool eye, T (&p)[R][C]) {
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
template <int N, typename T>
__device__ int expm_reftrans_sw(const T (&M)[2 * N][2 * N],
                                const T (&C)[2 * N][N], const T (&D)[N][N],
                                T (&R)[N][N], T (&Tr)[N][N], T (&Rdir)[N][N],
                                T (&Tdir)[N][N], T (&Tdd)[N][N]) {
  constexpr int N2 = 2 * N;
  using Kt = Consts<T>;
  T norm1 = T(0);
#pragma unroll
  for (int j = 0; j < N2; ++j) {
    T s = fabs(M[0][j]);
#pragma unroll
    for (int i = 1; i < N2; ++i) s = s + fabs(M[i][j]);
    norm1 = j == 0 ? s : fmax(norm1, s);
  }
  T right = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = fabs(C[0][j]);
#pragma unroll
    for (int i = 1; i < N2; ++i) s = s + fabs(C[i][j]);
#pragma unroll
    for (int i = 0; i < N; ++i) s = s + fabs(D[i][j]);
    right = j == 0 ? s : fmax(right, s);
  }
  norm1 = fmax(norm1, right);
  T scale;
  const int expo = doubling_count(norm1, &scale);

  T As0[N2][N2], As1[N2][N], As2[N][N];
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

  T A20[N2][N2], A21[N2][N], A22[N][N];
  T A40[N2][N2], A41[N2][N], A42[N][N];
  bprod<N>(As0, As1, As2, As0, As1, As2, A20, A21, A22);
  bprod<N>(A20, A21, A22, A20, A21, A22, A40, A41, A42);
  T V0[N2][N2], V1[N2][N], V2[N][N];
  pade_sum<N2, N2>(A40, A20, Kt::c5(), Kt::c3(), Kt::c1(), true, V0);
  pade_sum<N2, N>(A41, A21, Kt::c5(), Kt::c3(), Kt::c1(), false, V1);
  pade_sum<N, N>(A42, A22, Kt::c5(), Kt::c3(), Kt::c1(), true, V2);
  T U0[N2][N2], U1[N2][N], U2[N][N];
  bprod<N>(As0, As1, As2, V0, V1, V2, U0, U1, U2);
  pade_sum<N2, N2>(A40, A20, Kt::c4(), Kt::c2(), Kt::c0(), true, V0);
  pade_sum<N2, N>(A41, A21, Kt::c4(), Kt::c2(), Kt::c0(), false, V1);
  pade_sum<N, N>(A42, A22, Kt::c4(), Kt::c2(), Kt::c0(), true, V2);
  // P = V - U; Xd = Pd^-1 2 Ud; [Xm | Xc] = Pm^-1 [2 Um | 2 Uc - Pc Xd]
  T Pd[N][N], Xd[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Pd[i][j] = V2[i][j] - U2[i][j];
      Xd[i][j] = ECRAD_LIT(2.0) * U2[i][j];
    }
  solve<N, N>(Pd, Xd);
  T Pc[N2][N], PcXd[N2][N];
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Pc[i][j] = V1[i][j] - U1[i][j];
  mm<N2, N, N>(Pc, Xd, PcXd);
  T Pm[N2][N2], X[N2][N2 + N];
#pragma unroll
  for (int i = 0; i < N2; ++i) {
#pragma unroll
    for (int j = 0; j < N2; ++j) {
      Pm[i][j] = V0[i][j] - U0[i][j];
      X[i][j] = ECRAD_LIT(2.0) * U0[i][j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      X[i][N2 + j] = ECRAD_LIT(2.0) * U1[i][j] - PcXd[i][j];
  }
  solve<N2, N2 + N>(Pm, X);
  // Em = Xm + I, Ec = Xc, Tdd = Xd + I
#pragma unroll
  for (int i = 0; i < N2; ++i) X[i][i] = X[i][i] + T(1);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Tdd[i][j] = Xd[i][j] + (i == j ? T(1) : T(0));
  // thin-layer extraction: [R | Rdir] = -Em[:n,:n]^-1 [Em[:n,n:] | Ec[:n]]
  T A[N][N], RR[N][2 * N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[i][j] = X[i][j];
      RR[i][j] = X[i][N + j];
      RR[i][N + j] = X[i][N2 + j];
    }
  solve<N, 2 * N>(A, RR);
  T E21[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      R[i][j] = -RR[i][j];
      Rdir[i][j] = -RR[i][N + j];
      E21[i][j] = X[N + i][j];
    }
  T t1[N][N], t2[N][N];
  mm<N, N, N>(E21, R, t1);
  mm<N, N, N>(E21, Rdir, t2);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Tr[i][j] = X[N + i][N + j] + t1[i][j];
      Tdir[i][j] = X[N + i][N2 + j] + t2[i][j];
    }

  // adding-doubling steps
  for (int k = 0; k < expo; ++k) {
    T RdTdd[N][N], RRdTdd[N][N], den[N][N], WD[N][2 * N];
    mm<N, N, N>(Rdir, Tdd, RdTdd);
    mm<N, N, N>(R, RdTdd, RRdTdd);
    one_minus_sq<N>(R, den);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        WD[i][j] = Tr[i][j];
        WD[i][N + j] = Tdir[i][j] + RRdTdd[i][j];
      }
    solve<N, 2 * N>(den, WD);
    T W[N][N], di[N][N], TR[N][N], a[N][N], b[N][N], c[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        W[i][j] = WD[i][j];
        di[i][j] = WD[i][N + j];
      }
    // R <- R + (T R) W
    mm<N, N, N>(Tr, R, TR);
    mm<N, N, N>(TR, W, a);
    // Rdir <- Rdir + T (Rdir Tdd + R d)
    mm<N, N, N>(R, di, b);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) b[i][j] = RdTdd[i][j] + b[i][j];
    mm<N, N, N>(Tr, b, c);
    // Tdir <- T d + Tdir Tdd
    T Td[N][N], TdTdd[N][N], Tn[N][N], Tddn[N][N];
    mm<N, N, N>(Tr, di, Td);
    mm<N, N, N>(Tdir, Tdd, TdTdd);
    mm<N, N, N>(Tr, W, Tn);
    mm<N, N, N>(Tdd, Tdd, Tddn);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        R[i][j] = R[i][j] + a[i][j];
        Rdir[i][j] = Rdir[i][j] + c[i][j];
        Tdir[i][j] = Td[i][j] + TdTdd[i][j];
        Tr[i][j] = Tn[i][j];
        Tdd[i][j] = Tddn[i][j];
      }
  }
  return expo;
}

// B6's 3D pass: one cell's rows. Gamma, its Pade-5 exponential and the
// doubling, then the clipping; o[q] is [R | T | RD | TD | TDD][q]. Returns
// the doubling count.
template <int N, typename T>
__device__ __forceinline__ int sw_3d_cell(
    const T* __restrict__ od_in, const T* __restrict__ ssa_in,
    const T* __restrict__ g_in, const T* __restrict__ trd_in,
    const T* __restrict__ trf_in, T mu0, int l, size_t i, size_t c,
    size_t m, int ncol, T max_gas_od_3d, T (&o)[5][N][N]) {
  constexpr int NN = N * N;
  T od[N], ssa[N], gg[N];
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
  T G[N3][N3];
#pragma unroll
  for (int a = 0; a < N3; ++a)
#pragma unroll
    for (int b = 0; b < N3; ++b) G[a][b] = T(0);
  const T one_over_mu0 = T(1) / mu0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const T odr = r == 0 ? fmin(od[0], max_gas_od_3d) : od[r];
    T g1, g2, g3;
    sw_gammas(mu0, ssa[r], gg[r], &g1, &g2, &g3);
    G[r][r] = G[r][r] + odr * g1;
    G[N + r][r] = G[N + r][r] + odr * g2;
    G[r][2 * N + r] = G[r][2 * N + r] + -odr * ssa[r] * g3;
    G[N + r][2 * N + r] = G[N + r][2 * N + r] + odr * ssa[r] * (T(1) - g3);
    G[2 * N + r][2 * N + r] = G[2 * N + r][2 * N + r]
        + -fmin(odr * one_over_mu0, Consts<T>::max_od_over_mu0());
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
  T M[2 * N][2 * N], Cm[2 * N][N], D[N][N];
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
      o[0][a][b] = fmin(fmax(o[0][a][b], T(0)), T(1));
      o[1][a][b] = fmin(fmax(o[1][a][b], T(0)), T(1));
      o[2][a][b] = fmin(fmax(o[2][a][b], T(0)), mu0);
      o[3][a][b] = fmin(fmax(o[3][a][b], T(0)), mu0);
      o[4][a][b] = fmin(fmax(o[4][a][b], T(0)), T(1));
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
template <int NREG, typename T>
__global__ void __launch_bounds__(THREADS)
sw_3d_kernel(const T* __restrict__ od_in, const T* __restrict__ ssa_in,
             const T* __restrict__ g_in, const T* __restrict__ trd_in,
             const T* __restrict__ trf_in, const T* __restrict__ mu0_in,
             const uint8_t* __restrict__ use3d_in,
             const uint8_t* __restrict__ clear_in, int nlev, int ng,
             int ncol, int cap, T max_gas_od_3d, T* __restrict__ out,
             int8_t* __restrict__ counts, T* __restrict__ packed,
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
        const T mu0 = mu0_in[c];
        T o[5][N][N];
        const int count = sw_3d_cell<N>(od_in, ssa_in, g_in, trd_in, trf_in,
                                        mu0, l, i, c, m, ncol, max_gas_od_3d,
                                        o);
        const bool clear = clear_in[(size_t)l * ncol + c] != 0;
        const int slot = base + lane;
        const bool staged = slot < cap;
        T* dst = staged ? packed + slot : out + (size_t)l * 5 * NN * m + i;
        const size_t step = staged ? (size_t)cap : m;
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int a = 0; a < N; ++a)
#pragma unroll
            for (int b = 0; b < N; ++b)
              dst[(size_t)(k * NN + a * N + b) * step] =
                  (clear && (a > 0 || b > 0)) ? T(0) : o[k][a][b];
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
template <int NREG, typename T>
__global__ void __launch_bounds__(LEAN_THREADS, LEAN_MIN_BLOCKS)
sw_fallback_kernel(const T* __restrict__ od_in, const T* __restrict__ ssa_in,
                   const T* __restrict__ g_in, const T* __restrict__ mu0_in,
                   const uint8_t* __restrict__ use3d_in,
                   const uint8_t* __restrict__ clear_in,
                   const T* __restrict__ packed,
                   const int* __restrict__ slot_of, int nlev, int ng,
                   int ncol, int cap, T* __restrict__ out,
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
  T w[5][N];
  if (!is3d) {
    const T mu0 = mu0_in[c];
    const bool clear = clear_in[(size_t)l * ncol + c] != 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const size_t j = ((size_t)l * N + r) * m + i;
      const Mw<T> v = sw_fallback(mu0, od_in[j], ssa_in[j], g_in[j]);
      const bool z = clear && r > 0;
      w[0][r] = z ? T(0) : v.r;
      w[1][r] = z ? T(0) : v.t;
      w[2][r] = z ? T(0) : v.rd;
      w[3][r] = z ? T(0) : v.td;
      w[4][r] = z ? T(0) : v.tdd;
    }
    if (counts) counts[idx] = -1;
  }
  const T* p = packed + slot;
  T* o = out + (size_t)l * 5 * NN * m + i;
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = q * NN + a * N + b;
        o[(size_t)k * m] = is3d ? p[(size_t)k * cap]
                                : (a == b ? w[q][a] : T(0));
      }
}

// ---- LW ----

// B7's operands, passed by value to both of its passes: od/ssa/g (nlev,
// NREG, ng, ncol), tr (nlev, NREG, NREG, ncol), se/pt/pb (nlev, ng,
// ncol), fr (nlev, NREG, ncol), use3d (nlev, ng, ncol), clear (nlev, ncol)
template <typename T>
struct LwArgs {
  const T *od, *ssa, *g, *tr, *se, *pt, *pb, *fr;
  const uint8_t *use3d, *clear;
  int nlev, ng, ncol;
};

// a cell's level l, its index i among the level's m = ng ncol cells and
// its column c; B7 has fewer than 2^31 cells, so the divisions are 32-bit
struct CellAt {
  int l;
  size_t i, c;
};
template <typename T>
__device__ __forceinline__ CellAt cell_at(size_t idx, const LwArgs<T>& p) {
  const unsigned m = (unsigned)p.ng * (unsigned)p.ncol, x = (unsigned)idx;
  const unsigned l = x / m, i = x - l * m;
  return {(int)l, (size_t)i, (size_t)(i % (unsigned)p.ncol)};
}

// (R, T) of [[A, -B], [B, -A]] (solvers/matrix.py expm_reftrans_lw_g);
// returns the doubling count. Both Pade sums are formed before U = G V,
// the second in A4's place, so that A2 dies early; each value is the
// plain version's expression.
template <int N, typename T>
__device__ int expm_reftrans_lw(const T (&A)[N][N], const T (&B)[N][N],
                                T (&R)[N][N], T (&Tr)[N][N]) {
  constexpr int N2 = 2 * N;
  using Kt = Consts<T>;
  T norm1 = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = fabs(A[0][j]) + fabs(B[0][j]);
#pragma unroll
    for (int i = 1; i < N; ++i) s = s + fabs(A[i][j]) + fabs(B[i][j]);
    norm1 = j == 0 ? s : fmax(norm1, s);
  }
  T scale;
  const int expo = doubling_count(norm1, &scale);
  T G[N2][N2];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T x = A[i][j] * scale, y = B[i][j] * scale;
      G[i][j] = x;
      G[i][N + j] = -y;
      G[N + i][j] = y;
      G[N + i][N + j] = -x;
    }
  T A2[N2][N2], A4[N2][N2], V[N2][N2], U[N2][N2];
  mm<N2, N2, N2>(G, G, A2);
  mm<N2, N2, N2>(A2, A2, A4);
  pade_sum<N2, N2>(A4, A2, Kt::c5(), Kt::c3(), Kt::c1(), true, V);
  pade_sum<N2, N2>(A4, A2, Kt::c4(), Kt::c2(), Kt::c0(), true, A4);
  mm<N2, N2, N2>(G, V, U);
  T E[N2][N2];
#pragma unroll
  for (int i = 0; i < N2; ++i)
#pragma unroll
    for (int j = 0; j < N2; ++j) {
      A4[i][j] = A4[i][j] - U[i][j];
      E[i][j] = ECRAD_LIT(2.0) * U[i][j];
    }
  solve<N2, N2>(A4, E);
#pragma unroll
  for (int i = 0; i < N2; ++i) E[i][i] = E[i][i] + T(1);
  T a[N][N], rr[N][N], e21[N][N], t1[N][N];
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
    for (int j = 0; j < N; ++j) Tr[i][j] = E[N + i][N + j] + t1[i][j];
  for (int k = 0; k < expo; ++k) {
    T den[N][N], W[N][N], TR[N][N], dR[N][N], Tn[N][N];
    one_minus_sq<N>(R, den);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) W[i][j] = Tr[i][j];
    solve<N, N>(den, W);
    mm<N, N, N>(Tr, R, TR);
    mm<N, N, N>(TR, W, dR);
    mm<N, N, N>(Tr, W, Tn);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        R[i][j] = R[i][j] + dR[i][j];
        Tr[i][j] = Tn[i][j];
      }
  }
  return expo;
}

// B7's 3D pass: one cell's (R, T, SU, SD). The generator's blocks A and B
// (ops/spartacus_reftrans.py lw_gamma_expm, region 0's od capped), the
// particular solution in the sum/difference basis, the Pade-5
// exponential and the doubling, then the sources. Returns the doubling
// count.
template <int N, typename T>
__device__ __forceinline__ int lw_3d_cell(const LwArgs<T>& p,
                                          T max_gas_od_3d, int l,
                                          size_t idx, size_t i, size_t c,
                                          size_t m, T (&R)[N][N],
                                          T (&Tr)[N][N], T (&su)[N],
                                          T (&sd)[N]) {
  constexpr int NN = N * N;
  const T diffusivity = Consts<T>::diffusivity();
  const T pt = p.pt[idx], pb = p.pb[idx];
  T od[N], ssa[N], g1[N], g2[N], fr[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const size_t j = ((size_t)l * N + r) * m + i;
    od[r] = p.od[j];
    ssa[r] = p.ssa[j];
    // two_stream.py lw_gammas
    const T factor = (diffusivity * ECRAD_LIT(0.5)) * ssa[r];
    const T gv = p.g[j];
    g1[r] = diffusivity - factor * (T(1) + gv);
    g2[r] = factor * (T(1) - gv);
    fr[r] = p.fr[((size_t)l * N + r) * p.ncol + c];
  }
  const T se = p.se[idx];
  const size_t tc = (size_t)l * NN * p.ncol + c;
  auto tr = [&](int a, int b) {
    return p.tr[tc + (size_t)(a * N + b) * p.ncol];
  };
  T A[N][N], B[N][N], odc[N];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b) A[a][b] = B[a][b] = T(0);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    odc[r] = r == 0 ? fmin(od[0], max_gas_od_3d) : od[r];
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
  T F[N][N], E[N][N], vw[N][2], u[N][1];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const T emis = odc[r] * (T(1) - ssa[r]) * fr[r] * diffusivity;
    vw[r][0] = emis * (pb - pt);
    vw[r][1] = emis * pt;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      E[r][b] = A[r][b] + B[r][b];
      F[r][b] = A[r][b] - B[r][b];
    }
    E[r][r] = E[r][r] + ECRAD_LIT(1e-12);
    F[r][r] = F[r][r] + ECRAD_LIT(1e-12);
  }
  solve<N, 2>(F, vw);
#pragma unroll
  for (int r = 0; r < N; ++r) u[r][0] = vw[r][0];
  solve<N, 1>(E, u);
  T up[N], dn[N], pu_b[N], uu[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uu[r] = vw[r][0];
    up[r] = vw[r][1] + u[r][0];
    dn[r] = vw[r][1] - u[r][0];
    pu_b[r] = up[r] + uu[r];
  }
  const int count = expm_reftrans_lw<N>(A, B, R, Tr);
  T a1[N], a2[N], b1[N], b2[N];
  mv<N, N>(R, dn, a1);
  mv<N, N>(Tr, pu_b, a2);
  mv<N, N>(Tr, dn, b1);
  mv<N, N>(R, pu_b, b2);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    su[r] = up[r] - a1[r] - a2[r];
    sd[r] = dn[r] + uu[r] - b1[r] - b2[r];
  }
  return count;
}

// 16-byte runs of a slot of B7's staging: four floats or two doubles
template <typename T>
struct Run16;
template <>
struct Run16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void put(float* d, int h,
                                             const float* v) {
    reinterpret_cast<float4*>(d)[h] =
        make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  }
  static __device__ __forceinline__ void get(const float* s, int h,
                                             float* v) {
    const float4 t = reinterpret_cast<const float4*>(s)[h];
    v[4 * h] = t.x;
    v[4 * h + 1] = t.y;
    v[4 * h + 2] = t.z;
    v[4 * h + 3] = t.w;
  }
};
template <>
struct Run16<double> {
  static constexpr int n = 2;
  static __device__ __forceinline__ void put(double* d, int h,
                                             const double* v) {
    reinterpret_cast<double2*>(d)[h] = make_double2(v[2 * h], v[2 * h + 1]);
  }
  static __device__ __forceinline__ void get(const double* s, int h,
                                             double* v) {
    const double2 t = reinterpret_cast<const double2*>(s)[h];
    v[2 * h] = t.x;
    v[2 * h + 1] = t.y;
  }
};

// pass 1 of B7, over the 3D cells only: a persistent grid whose warps
// stride over groups of 32 cells. A warp reads `use3d` for BATCH of its
// groups at once (one wait on memory, not one per group), lists their 3D
// cells in order, and computes the list 32 cells a round, every lane
// busy. A round's rows go to 32 adjacent slots of `packed`, each slot one
// cell's 2 NREG (NREG + 1) rows in a row (cap slots), and slot_of[cell]
// records the slot; past cap slots a cell is written to `out` in place
// and its slot is -1. Each cell's rows depend on that cell alone, so the
// order of the slots changes no value.
template <int NREG, typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? LW_3D_MIN_BLOCKS
                                                  : F64_LW_3D_MIN_BLOCKS)
lw_3d_kernel(LwArgs<T> p, int cap, T max_gas_od_3d, T* __restrict__ out,
             int8_t* __restrict__ counts, T* __restrict__ packed,
             int* __restrict__ slot_of, int* __restrict__ n3d) {
  constexpr int N = NREG, NN = NREG * NREG, NR = 2 * N * (N + 1),
                WARPS = THREADS / 32, BATCH = 16, RUN = Run16<T>::n;
  constexpr unsigned ALL = 0xffffffffu;
  static_assert(NR % RUN == 0, "a slot is whole 16-byte runs");
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
      T R[N][N], Tr[N][N], su[N], sd[N];
      const int count = lw_3d_cell<N>(p, max_gas_od_3d, at.l, idx, at.i,
                                      at.c, m, R, Tr, su, sd);
      const bool clear = p.clear[(size_t)at.l * p.ncol + at.c] != 0;
      T v[NR];
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b) {
          const bool z = clear && (a > 0 || b > 0);
          v[a * N + b] = z ? T(0) : R[a][b];
          v[NN + a * N + b] = z ? T(0) : Tr[a][b];
        }
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const bool z = clear && r > 0;
        v[2 * NN + r] = z ? T(0) : su[r];
        v[2 * NN + N + r] = z ? T(0) : sd[r];
      }
      const int slot = base + lane;
      if (slot < cap) {
        T* d = packed + (size_t)slot * NR;
#pragma unroll
        for (int h = 0; h < NR / RUN; ++h) Run16<T>::put(d, h, v);
        slot_of[idx] = slot;
      } else {
        T* o = out + (size_t)at.l * NR * m + at.i;
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
template <int NREG, typename T>
__global__ void __launch_bounds__(LEAN_THREADS, LEAN_MIN_BLOCKS)
lw_fallback_kernel(LwArgs<T> p, int cloud_scattering,
                   const T* __restrict__ packed,
                   const int* __restrict__ slot_of, int cap,
                   T* __restrict__ out, int8_t* __restrict__ counts) {
  constexpr int N = NREG, NN = NREG * NREG, NR = 2 * N * (N + 1),
                RUN = Run16<T>::n;
  const T diffusivity = Consts<T>::diffusivity();
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
  T w[4][N];
  if (!is3d) {
    const T pt = p.pt[idx], pb = p.pb[idx];
    const bool clear = p.clear[(size_t)l * p.ncol + c] != 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const size_t j = ((size_t)l * N + r) * m + i;
      const T od = p.od[j];
      T rr, tt, u, d;
      if (cloud_scattering) {
        // two_stream.py lw_gammas and lw_reftrans
        const T factor = (diffusivity * ECRAD_LIT(0.5)) * p.ssa[j];
        const T gv = p.g[j];
        const T g1 = diffusivity - factor * (T(1) + gv);
        const T g2 = factor * (T(1) - gv);
        const T k = sqrt(fmax((g1 - g2) * (g1 + g2), ECRAD_LIT(1.0e-4)));
        const T expo = exp(-k * od);
        const T expo2 = expo * expo;
        const T rt = T(1) / (k + g1 + (k - g1) * expo2);
        if (od <= ECRAD_LIT(1.0e-3)) {
          rr = g2 * od;
          tt = (T(1) - k * od) / (T(1) + od * (g1 - k));
          u = d = (T(1) - rr - tt) * ECRAD_LIT(0.5) * (pt + pb);
        } else {
          rr = g2 * (T(1) - expo2) * rt;
          tt = ECRAD_LIT(2.0) * k * expo * rt;
          const T coeff =
              (pb - pt) / fmax(od * (g1 + g2), ECRAD_LIT(1.0e-30));
          u = (coeff + pt) - rr * (-coeff + pt) - tt * (coeff + pb);
          d = (-coeff + pb) - rr * (coeff + pb) - tt * (-coeff + pt);
        }
      } else {
        // two_stream.py lw_no_scattering_transmittance
        const T coeff0 = diffusivity * od;
        const T trans = exp(-coeff0);
        const T coeff = (pb - pt) / fmax(coeff0, ECRAD_LIT(1.0e-30));
        rr = T(0);
        if (od <= ECRAD_LIT(1.0e-3)) {
          tt = T(1) - coeff0;
          u = d = coeff0 * ECRAD_LIT(0.5) * (pt + pb);
        } else {
          tt = trans;
          u = (coeff + pt) - trans * (coeff + pb);
          d = (-coeff + pb) - trans * (-coeff + pt);
        }
      }
      const T fr = p.fr[((size_t)l * N + r) * p.ncol + c];
      const bool z = clear && r > 0;
      w[0][r] = z ? T(0) : rr;
      w[1][r] = z ? T(0) : tt;
      w[2][r] = z ? T(0) : u * fr;
      w[3][r] = z ? T(0) : d * fr;
    }
    if (counts) counts[idx] = -1;
  }
  T v[NR];
  if (is3d) {
    // the slot's rows, in a row
    const T* q = packed + (size_t)slot * NR;
#pragma unroll
    for (int h = 0; h < NR / RUN; ++h) Run16<T>::get(q, h, v);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b)
          v[h * NN + a * N + b] = a == b ? w[h][a] : T(0);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[2 * NN + r] = w[2][r];
      v[2 * NN + N + r] = w[3][r];
    }
  }
  T* o = out + (size_t)l * NR * m + i;
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

template <typename T>
int sw_3d_launch(const T* od, const T* ssa, const T* g, const T* trd,
                 const T* trf, const T* mu0, const uint8_t* use3d,
                 const uint8_t* clear, T* out, int8_t* counts, T* packed,
                 int* slot_of, int* n3d, int nreg, int nlev, int ng,
                 int ncol, int cap, T max_gas_od_3d, void* stream) {
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = 0;
  cudaError_t e;
  if (nreg == 3) {
    if ((e = grid_3d(sw_3d_kernel<3, T>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sw_3d_kernel<3, T><<<blocks, THREADS, 0, s>>>(
        od, ssa, g, trd, trf, mu0, use3d, clear, nlev, ng, ncol, cap,
        max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else if (nreg == 2) {
    if ((e = grid_3d(sw_3d_kernel<2, T>, n, &blocks)) != cudaSuccess)
      return (int)e;
    sw_3d_kernel<2, T><<<blocks, THREADS, 0, s>>>(
        od, ssa, g, trd, trf, mu0, use3d, clear, nlev, ng, ncol, cap,
        max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int sw_fallback_launch(const T* od, const T* ssa, const T* g, const T* mu0,
                       const uint8_t* use3d, const uint8_t* clear,
                       const T* packed, const int* slot_of, T* out,
                       int8_t* counts, int nreg, int nlev, int ng, int ncol,
                       int cap, void* stream) {
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + LEAN_THREADS - 1) / LEAN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    sw_fallback_kernel<3, T><<<blocks, LEAN_THREADS, 0, s>>>(
        od, ssa, g, mu0, use3d, clear, packed, slot_of, nlev, ng, ncol, cap,
        out, counts);
  } else if (nreg == 2) {
    sw_fallback_kernel<2, T><<<blocks, LEAN_THREADS, 0, s>>>(
        od, ssa, g, mu0, use3d, clear, packed, slot_of, nlev, ng, ncol, cap,
        out, counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int sw_info(int pass, int nreg, int* info) {
  if (pass == 0 && nreg == 3)
    return kernel_info(sw_fallback_kernel<3, T>, LEAN_THREADS, 0, info);
  if (pass == 0 && nreg == 2)
    return kernel_info(sw_fallback_kernel<2, T>, LEAN_THREADS, 0, info);
  if (pass == 1 && nreg == 3)
    return kernel_info(sw_3d_kernel<3, T>, THREADS, 0, info);
  if (pass == 1 && nreg == 2)
    return kernel_info(sw_3d_kernel<2, T>, THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int lw_3d_launch(const T* od, const T* ssa, const T* g, const T* tr,
                 const T* se, const T* pt, const T* pb, const T* fr,
                 const uint8_t* use3d, const uint8_t* clear, T* out,
                 int8_t* counts, T* packed, int* slot_of, int* n3d, int nreg,
                 int nlev, int ng, int ncol, int cap, T max_gas_od_3d,
                 void* stream) {
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const LwArgs<T> p{od, ssa, g, tr, se, pt, pb, fr, use3d, clear,
                    nlev, ng, ncol};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = 0;
  cudaError_t e;
  if (nreg == 3) {
    if ((e = grid_3d(lw_3d_kernel<3, T>, n, &blocks)) != cudaSuccess)
      return (int)e;
    lw_3d_kernel<3, T><<<blocks, THREADS, 0, s>>>(
        p, cap, max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else if (nreg == 2) {
    if ((e = grid_3d(lw_3d_kernel<2, T>, n, &blocks)) != cudaSuccess)
      return (int)e;
    lw_3d_kernel<2, T><<<blocks, THREADS, 0, s>>>(
        p, cap, max_gas_od_3d, out, counts, packed, slot_of, n3d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int lw_fallback_launch(const T* od, const T* ssa, const T* g, const T* pt,
                       const T* pb, const T* fr, const uint8_t* use3d,
                       const uint8_t* clear, const T* packed,
                       const int* slot_of, T* out, int8_t* counts, int nreg,
                       int nlev, int ng, int ncol, int cap,
                       int cloud_scattering, void* stream) {
  const size_t n = (size_t)nlev * ng * ncol;
  if (n == 0) return (int)cudaGetLastError();
  if (n > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const LwArgs<T> p{od, ssa, g, nullptr, nullptr, pt, pb, fr, use3d,
                    clear, nlev, ng, ncol};
  const unsigned blocks = (unsigned)((n + LEAN_THREADS - 1) / LEAN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    lw_fallback_kernel<3, T><<<blocks, LEAN_THREADS, 0, s>>>(
        p, cloud_scattering, packed, slot_of, cap, out, counts);
  } else if (nreg == 2) {
    lw_fallback_kernel<2, T><<<blocks, LEAN_THREADS, 0, s>>>(
        p, cloud_scattering, packed, slot_of, cap, out, counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int lw_info(int pass, int nreg, int* info) {
  if (pass == 0 && nreg == 3)
    return kernel_info(lw_fallback_kernel<3, T>, LEAN_THREADS, 0, info);
  if (pass == 0 && nreg == 2)
    return kernel_info(lw_fallback_kernel<2, T>, LEAN_THREADS, 0, info);
  if (pass == 1 && nreg == 3)
    return kernel_info(lw_3d_kernel<3, T>, THREADS, 0, info);
  if (pass == 1 && nreg == 2)
    return kernel_info(lw_3d_kernel<2, T>, THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}
}  // namespace spartacus
}  // namespace ecrad

// B6, pass 1, over the 3D cells of the nlev x ng x ncol cells: `packed`
// holds (5 nreg^2, cap) values, slot_of one int per cell, and *n3d must
// be 0 on entry
extern "C" int spartacus_sw_reftrans_3d(
    const float* od, const float* ssa, const float* g, const float* trd,
    const float* trf, const float* mu0, const uint8_t* use3d,
    const uint8_t* clear, float* out, int8_t* counts, float* packed,
    int* slot_of, int* n3d, int nreg, int nlev, int ng, int ncol, int cap,
    float max_gas_od_3d, void* stream) {
  return ecrad::spartacus::sw_3d_launch<float>(
      od, ssa, g, trd, trf, mu0, use3d, clear, out, counts, packed, slot_of,
      n3d, nreg, nlev, ng, ncol, cap, max_gas_od_3d, stream);
}

extern "C" int spartacus_sw_reftrans_3d_f64(
    const double* od, const double* ssa, const double* g, const double* trd,
    const double* trf, const double* mu0, const uint8_t* use3d,
    const uint8_t* clear, double* out, int8_t* counts, double* packed,
    int* slot_of, int* n3d, int nreg, int nlev, int ng, int ncol, int cap,
    double max_gas_od_3d, void* stream) {
  return ecrad::spartacus::sw_3d_launch<double>(
      od, ssa, g, trd, trf, mu0, use3d, clear, out, counts, packed, slot_of,
      n3d, nreg, nlev, ng, ncol, cap, max_gas_od_3d, stream);
}

// B6, pass 2, over every cell, after pass 1 on the same stream
extern "C" int spartacus_sw_reftrans_fallback(
    const float* od, const float* ssa, const float* g, const float* mu0,
    const uint8_t* use3d, const uint8_t* clear, const float* packed,
    const int* slot_of, float* out, int8_t* counts, int nreg, int nlev,
    int ng, int ncol, int cap, void* stream) {
  return ecrad::spartacus::sw_fallback_launch<float>(
      od, ssa, g, mu0, use3d, clear, packed, slot_of, out, counts, nreg,
      nlev, ng, ncol, cap, stream);
}

extern "C" int spartacus_sw_reftrans_fallback_f64(
    const double* od, const double* ssa, const double* g, const double* mu0,
    const uint8_t* use3d, const uint8_t* clear, const double* packed,
    const int* slot_of, double* out, int8_t* counts, int nreg, int nlev,
    int ng, int ncol, int cap, void* stream) {
  return ecrad::spartacus::sw_fallback_launch<double>(
      od, ssa, g, mu0, use3d, clear, packed, slot_of, out, counts, nreg,
      nlev, ng, ncol, cap, stream);
}

// B6's compiled resources and occupancy (kernel_info.cuh): pass 0 is the
// lean pass (2), pass 1 the 3D pass (1)
extern "C" int spartacus_sw_reftrans_info(int pass, int nreg, int* info) {
  return ecrad::spartacus::sw_info<float>(pass, nreg, info);
}

extern "C" int spartacus_sw_reftrans_info_f64(int pass, int nreg,
                                              int* info) {
  return ecrad::spartacus::sw_info<double>(pass, nreg, info);
}

// B7, pass 1, over the 3D cells: `packed` holds cap slots of 2 nreg (nreg
// + 1) values, slot_of one int per cell, and *n3d must be 0 on entry
extern "C" int spartacus_lw_reftrans_3d(
    const float* od, const float* ssa, const float* g, const float* tr,
    const float* se, const float* pt, const float* pb, const float* fr,
    const uint8_t* use3d, const uint8_t* clear, float* out, int8_t* counts,
    float* packed, int* slot_of, int* n3d, int nreg, int nlev, int ng,
    int ncol, int cap, float max_gas_od_3d, void* stream) {
  return ecrad::spartacus::lw_3d_launch<float>(
      od, ssa, g, tr, se, pt, pb, fr, use3d, clear, out, counts, packed,
      slot_of, n3d, nreg, nlev, ng, ncol, cap, max_gas_od_3d, stream);
}

extern "C" int spartacus_lw_reftrans_3d_f64(
    const double* od, const double* ssa, const double* g, const double* tr,
    const double* se, const double* pt, const double* pb, const double* fr,
    const uint8_t* use3d, const uint8_t* clear, double* out, int8_t* counts,
    double* packed, int* slot_of, int* n3d, int nreg, int nlev, int ng,
    int ncol, int cap, double max_gas_od_3d, void* stream) {
  return ecrad::spartacus::lw_3d_launch<double>(
      od, ssa, g, tr, se, pt, pb, fr, use3d, clear, out, counts, packed,
      slot_of, n3d, nreg, nlev, ng, ncol, cap, max_gas_od_3d, stream);
}

// B7, pass 2, over every cell, after pass 1 on the same stream
extern "C" int spartacus_lw_reftrans_fallback(
    const float* od, const float* ssa, const float* g, const float* pt,
    const float* pb, const float* fr, const uint8_t* use3d,
    const uint8_t* clear, const float* packed, const int* slot_of,
    float* out, int8_t* counts, int nreg, int nlev, int ng, int ncol,
    int cap, int cloud_scattering, void* stream) {
  return ecrad::spartacus::lw_fallback_launch<float>(
      od, ssa, g, pt, pb, fr, use3d, clear, packed, slot_of, out, counts,
      nreg, nlev, ng, ncol, cap, cloud_scattering, stream);
}

extern "C" int spartacus_lw_reftrans_fallback_f64(
    const double* od, const double* ssa, const double* g, const double* pt,
    const double* pb, const double* fr, const uint8_t* use3d,
    const uint8_t* clear, const double* packed, const int* slot_of,
    double* out, int8_t* counts, int nreg, int nlev, int ng, int ncol,
    int cap, int cloud_scattering, void* stream) {
  return ecrad::spartacus::lw_fallback_launch<double>(
      od, ssa, g, pt, pb, fr, use3d, clear, packed, slot_of, out, counts,
      nreg, nlev, ng, ncol, cap, cloud_scattering, stream);
}

// B7's compiled resources and occupancy (kernel_info.cuh): pass 0 is the
// pass over every cell (2), pass 1 the 3D pass (1)
extern "C" int spartacus_lw_reftrans_info(int pass, int nreg, int* info) {
  return ecrad::spartacus::lw_info<float>(pass, nreg, info);
}

extern "C" int spartacus_lw_reftrans_info_f64(int pass, int nreg,
                                              int* info) {
  return ecrad::spartacus::lw_info<double>(pass, nreg, info);
}
