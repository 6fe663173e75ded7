// Kernels B8 and B9: the SPARTACUS adding sweeps.
//
// Replace the TPU kernels ecrad_tpu/ops/spartacus_adding.py::
// sw_adding_sweeps (:366; pallas_calls :399 up, :441 down) and
// ::lw_adding_sweeps (:583; :614 up, :655 down). There each sweep was a
// pallas_call over (column tiles, levels) with the carry resident in VMEM
// and the upward history written to HBM between the two. Here one thread
// owns one (g, column) pair for both sweeps, in one launch: it keeps the
// carry in registers (SW 2 NREG^2 + 2 NREG floats: the total albedos and
// the migration distances; LW NREG^2 + NREG), writes the albedos below
// each layer to wrapper-allocated scratch on the way up and reads them
// back on the way down, and writes only what the solvers read (SW the
// albedos at the top and [fup | fdn | ddn] per level and region; LW the
// source at the top and [fup | fdn]). NREG (2 or 3) is a template
// parameter, so the two-region setting runs here too; the entrapment
// treatment, do_3d_effects and the LW matrix switch are uniform runtime
// switches, the LW multilayer switch a template parameter of B9.
//
// What it must move: each level's history rows (SW 5 NREG^2, LW 2 NREG
// (NREG+1)) are read twice (up and down), the scratch written and read
// once, the fluxes written once; at 3 regions B8 moves 126 floats per
// (level, g, column), 15.8 GB at 2048 x 137 and 112 g-points (the
// least-time measure counts each input once and so sees less than half
// of that: the scratch round trip and the second read of the history are
// the design's, since a thread's 137 x 18 albedos do not fit on chip).
//
// What bounds B8 (SW) on the H100 is its arithmetic, not that traffic:
// with Explicit entrapment a (level, g, column) whose layer or the one
// below is cloudy costs ~3,000 operations (two entrapment mixings, each
// three 3 x 3 exchange exponentials, ~150 IEEE divisions in all), a
// clear one a few hundred, and the branch is a column's. With the history
// read in 128-byte runs the kernel streams its bytes at the card's rate
// under the cheap treatments (Maximum, Zero, Edge-only), so the layout
// serves the arithmetic: a warp computes 8 g-points of 4 columns, whose
// lanes share the clear-sky branch, and copies 32 columns of one g.
//
// The design: a block is G_TILE g-points x C_TILE columns. Each level,
// every thread copies history rows (and on the way down scratch
// albedos) with 4-byte cp.async into a shared-memory stage, a warp one
// 128-byte run of a row, and the block copies the level's per-column
// rows once for all its g-points; a ring of STAGES stages keeps the next
// level in flight while this one is computed. Two block barriers per
// level: the copies have landed; the results (the albedos below the
// layer going up, the fluxes going down), put in the stage by the
// computing threads, have been written out in 128-byte runs by the
// copying ones. The carry stays in registers. Copies of 4 bytes take
// every ng x ncol (the 16-byte forms need 16-byte aligned rows).
//
// B9 (LW) is bound by its bytes: its arithmetic is light (~420 operations
// per (level, g, column) at 3 regions), and in the first design, one
// thread per (g, column) loading each value when used, it moved 75 floats
// per (level, g, column) at 76 % of the card's rate. It now moves fewer:
// without multilayer effects every carry an up step makes is diagonal
// (the mixing keeps only the diagonal, and a layer clear on both sides
// zeroes the rest), so the scratch holds the diagonal albedos and the
// sources (2 NREG floats, not NREG^2 + NREG; 63 floats per (level, g,
// column) at 3 regions), and the downward sweep puts literal zeros off
// the diagonal, feeding the same products. The carry below the bottom
// layer is the caller's and may be full: the downward sweep reads it from
// init_up. With multilayer effects the scratch holds the whole matrix
// (ML, a template parameter). And it moves them at a higher rate: each
// thread copies its own (g, column)'s history and scratch rows with
// cp.async into a ring of LW_STAGES levels, two levels ahead, a warp 32
// columns of one g-point in 128-byte runs, and reads them back itself;
// the block copies a level's per-column rows once for its LW_G_TILE
// g-points. One block barrier per level (the per-column rows are
// shared); results go straight out, coalesced.
//
// Both kernels are templates on their scalar type T: the float forms are
// the float32 path's, the double forms (spartacus_sw_adding_f64,
// spartacus_lw_adding_f64) the float64 path's, the same expressions with
// each constant at T's precision (ECRAD_LIT) and copies of 8 bytes. A
// double stage takes twice a float one's shared memory: B8's two float
// stages at 3 regions (113 KB, 2 blocks per SM) come to 227 KB in
// double, one block of 8 warps at most, and B9's three ML stages (55 KB,
// 4 blocks) to 110 KB, 2 blocks. So each double form has a block and a
// ring of its own (SwDesign<double>, LwDesign<double>, the F64_*
// constants), the fastest of the candidates timed on an H100 at 2048 x
// 137 on the float64 path's operands (PERF.md): B8 takes 16 columns a
// block, so that a copying warp still reads 128-byte runs (16 doubles of
// 2 g-points) and two blocks of 8 g-points fit an SM; B9 keeps its block
// and takes a shorter ring.
//
// Semantics: ops/spartacus_adding.py sw_up_step / sw_dn_step /
// lw_up_step / lw_dn_step, expression for expression (built with
// -fmad=false; products and mixings add left to right as mm_gu, the
// elimination is solve_g's).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "scalar.cuh"

namespace ecrad {
namespace spadd {

// per-column SW rows (ops/spartacus_adding.py)
constexpr int UM = 0, VM = 9, VMN = 18, CF = 27, XLD = 29, XLDIR = 30,
              EDGE = 31, INVEFF = 34, OVP = 35, RF = 36, RFP = 39, CLEAR = 42,
              CLEARP = 43, CLEARN = 44, NOTTOP = 45, NCOLROWS = 47;

// B8's block: G_TILE g-points x C_TILE columns, a ring of STAGES levels,
// at least SW_MIN_BLOCKS blocks per SM (128 registers, 16 warps). For the
// arithmetic a warp is 8 g-points of 4 columns (thread t takes g t % 8
// and column t / 8), so that its lanes share the branch on a column's
// clear flags; for the copies a warp is 32 columns of one g-point (thread
// t takes g t / 32 and column t % 32), so that every global row is read
// and written in 128-byte runs.
constexpr int G_TILE = 8, C_TILE = 32, STAGES = 2, SW_MIN_BLOCKS = 2;
// The double form's: 8 g-points x 16 columns, 2 stages, 2 blocks (8
// warps) per SM, so up to 255 registers (250, no spills): a copying warp
// is 16 columns of 2 g-points, 128-byte runs of doubles. Timed on an H100
// at 2048 x 137, 3 regions, Explicit entrapment, on the float64 path's
// operands (tools/spartacus_f64_designs.py, PERF.md): 29.93 ms; 16 x 8 at
// 2 blocks (64-byte runs, 2 columns a computing warp) 32.28 ms; 4 x 16 at
// 3 blocks of 2 warps 41.08 ms.
constexpr int F64_G_TILE = 8, F64_C_TILE = 16, F64_STAGES = 2,
              F64_SW_MIN_BLOCKS = 2;
// the per-column rows staged per level: going up rows [0, 18) (UM, VM)
// and [27, 46) (CF .. NOTTOP), in that order; going down VMN's 9 rows,
// CLEAR and CLEARN
constexpr int UP_COLROWS = 37, DN_COLROWS = 11, DN_CLEAR = 9,
              DN_CLEARN = 10;
// the staged index of per-column row k going up, and the inverse
__host__ __device__ constexpr int up_row(int k) {
  return k < VMN ? k : k - 9;
}
__device__ __forceinline__ int up_src(int r) { return r < VMN ? r : r + 9; }
__device__ __forceinline__ int dn_src(int r) {
  return r < 9 ? VMN + r : (r == DN_CLEAR ? CLEAR : CLEARN);
}

// B8's block and ring in each form
template <typename T>
struct SwDesign;
template <>
struct SwDesign<float> {
  static constexpr int g_tile = G_TILE, c_tile = C_TILE, stages = STAGES,
                       min_blocks = SW_MIN_BLOCKS;
};
template <>
struct SwDesign<double> {
  static constexpr int g_tile = F64_G_TILE, c_tile = F64_C_TILE,
                       stages = F64_STAGES, min_blocks = F64_SW_MIN_BLOCKS;
};

// the slot of cell (g, c) of the block in one staged row: columns of
// GT g-points, g swizzled by the column, so that the arithmetic's reads
// (GT g x 32 / GT columns a warp) and the copies' writes (CT columns x
// 32 / CT g) each fall in distinct banks
template <int GT, int CT>
__device__ __forceinline__ int slot(int g, int c) {
  return c * GT + (g ^ (((c / (32 / GT)) * (32 / CT)) & (GT - 1)));
}

// one stage of B8, in values: the cells' rows (up: R T RD TD TDD; down:
// R T TD TDD and the two albedos below) at [k][slot], then the block's
// per-column rows at [row][column]. After a level's arithmetic each
// thread puts its results (up: the albedos below the layer; down: the
// fluxes) in its own slots of the first rows, and the block writes them
// out with the copies' mapping, in 128-byte runs.
template <typename T, int N>
struct SwStage {
  using D = SwDesign<T>;
  static constexpr int THREADS = D::g_tile * D::c_tile;
  static constexpr int NN = N * N, UP_H = 5 * NN, DN_H = 6 * NN;
  static constexpr int UP = UP_H * THREADS + UP_COLROWS * D::c_tile;
  static constexpr int DN = DN_H * THREADS + DN_COLROWS * D::c_tile;
  static constexpr int FLOATS = UP > DN ? UP : DN;
  static constexpr size_t BYTES = (size_t)D::stages * FLOATS * sizeof(T);
};
template <typename T>
constexpr bool sw_design_ok() {
  using D = SwDesign<T>;
  return D::g_tile <= 32 && D::c_tile <= 32
         && (D::g_tile * D::c_tile) % 32 == 0
         && (D::g_tile & (D::g_tile - 1)) == 0
         && (D::c_tile & (D::c_tile - 1)) == 0 && D::stages >= 2;
}
static_assert(sw_design_ok<float>() && sw_design_ok<double>(),
              "slot() takes powers of two, a whole number of warps");
static_assert(SwStage<float, 3>::BYTES <= 227 * 1024,
              "B8 stages exceed 227 KB");
static_assert(F64_SW_MIN_BLOCKS * (SwStage<double, 3>::BYTES + 1024)
                  <= 228 * 1024,
              "B8's double stages keep F64_SW_MIN_BLOCKS blocks on an SM");

// a block's dynamic shared memory as T: extern arrays of one name must
// share a type, so each scalar type has its own
template <typename T>
__device__ __forceinline__ T* stage_smem();
template <>
__device__ __forceinline__ float* stage_smem<float>() {
  extern __shared__ __align__(16) float stage_mem[];
  return stage_mem;
}
template <>
__device__ __forceinline__ double* stage_smem<double>() {
  extern __shared__ __align__(16) double stage_mem_f64[];
  return stage_mem_f64;
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}
// per-column LW rows
constexpr int LUM = 0, LVM = 9, LVMN = 18, LCLEAR = 27, LCLEARP = 28,
              LCLEARN = 29, LW_NCOLROWS = 30;
// config.Entrapment
constexpr int ZERO = 0, EDGE_ONLY = 1, EXPLICIT = 2, NON_FRACTAL = 3,
              MAXIMUM = 4;

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

// o[i] = sum_k a[k][i] x[k] (the transpose), left to right
template <int N, typename T>
__device__ __forceinline__ void mvt(const T (&a)[N][N], const T (&x)[N],
                                    T (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = a[0][i] * x[0];
#pragma unroll
    for (int k = 1; k < N; ++k) s = s + a[k][i] * x[k];
    o[i] = s;
  }
}

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

// d = I - a b
template <int N, typename T>
__device__ __forceinline__ void one_minus(const T (&a)[N][N],
                                          const T (&b)[N][N], T (&d)[N][N]) {
  mm<N, N, N>(a, b, d);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[i][j] = -d[i][j];
    d[i][i] = d[i][i] + T(1);
  }
}

// a 3 x 3-padded per-column matrix at row `base` of one level's rows
template <int N, typename T>
__device__ __forceinline__ void col_mat(const T* __restrict__ rows,
                                        size_t ncol, int base,
                                        T (&o)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      o[i][j] = rows[(size_t)(base + 3 * i + j) * ncol];
}

template <int N, typename T>
__device__ __forceinline__ void zero_offdiag(T (&a)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (i > 0 || j > 0) a[i][j] = T(0);
}

// exp of [[-a, b], [a, -b]] (solvers/matrix.py fast_expm_exchange_2_g)
template <typename T>
__device__ __forceinline__ void exchange2(T a, T b, T (&p)[2][2]) {
  const T factor = (T(1) - exp(-(a + b))) / fmax(a + b, ECRAD_LIT(1e-12));
  p[0][0] = T(1) - factor * a;
  p[0][1] = factor * b;
  p[1][0] = factor * a;
  p[1][1] = T(1) - factor * b;
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  const T eps = ECRAD_LIT(1e-12);
  return num / (fabs(den) < eps ? (den >= T(0) ? eps : -eps) : den);
}

// exp of [[-a, b, 0], [a, -b-c, d], [0, c, -d]]
// (solvers/matrix.py fast_expm_exchange_3_g)
template <typename T>
__device__ __forceinline__ void exchange3(T a, T b, T c, T d,
                                          T (&p)[3][3]) {
  const T eps = ECRAD_LIT(1e-12), one = T(1), zero = T(0);
  const T y2 = ECRAD_LIT(0.5) * (a + b + c + d);
  const T y3 = sqrt(fmax(y2 * y2 - (a * c + a * d + b * d), T(0)));
  const T lam1 = -y2 + y3, lam2 = -y2 - y3;
  const T v11 = safe_div(fmax(b, eps), a + lam1);
  const T v12 = safe_div(b, a + lam2);
  const T v13 = b / fmax(a, eps);
  const T v31 = safe_div(c, d + lam1);
  const T v32 = safe_div(c, d + lam2);
  const T v33 = fmax(c, eps) / fmax(d, eps);
  const T d1 = exp(lam1), d2 = exp(lam2);
  const T L21 = v12 / v11, L31 = v13 / v11;
  const T U22 = one - L21 * one;
  const T U23 = v32 - L21 * v31;
  const T L32 = (one - L31 * one) / U22;
  const T U33 = v33 - L31 * v31 - L32 * U23;
  T X[3][3];
  const T rhs[3][3] = {{d1, zero, zero}, {zero, d2, zero},
                       {zero, zero, one}};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const T r1 = rhs[q][0], r2 = rhs[q][1], r3 = rhs[q][2];
    const T y2c = r2 - L21 * r1;
    const T y3c = r3 - L31 * r1 - L32 * y2c;
    const T x3 = y3c / U33;
    const T x2 = (y2c - U23 * x3) / U22;
    X[q][0] = (r1 - one * x2 - v31 * x3) / v11;
    X[q][1] = x2;
    X[q][2] = x3;
  }
  const T V[3][3] = {{v11, v12, v13}, {one, one, one}, {v31, v32, v33}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[i][j] = V[i][0] * X[0][j] + V[i][1] * X[1][j] + V[i][2] * X[2][j];
}

template <typename T>
struct SwParams {
  int entrap, do_3d;
  T max_cloud_od, inv_min_size, one_minus_overhang, frac_threshold;
};

// the explicit / non-fractal entrapment term, added to `mixed`
// (ops/spartacus_adding.py _explicit_entrapment_k); c is the thread's
// column of a level's staged per-column rows (stride CT)
template <int N, int CT, typename T>
__device__ __forceinline__ void explicit_entrapment(
    const SwParams<T>& p, const T* __restrict__ c, const T (&alb_below)[N][N],
    const T (&x)[N], const T (&um)[N][N], const T (&vm)[N][N],
    T (&mixed)[N][N]) {
  auto row = [&](int k) { return c[up_row(k) * CT]; };
  const T inv_eff = fmin(row(INVEFF), p.inv_min_size);
  const bool not_top = row(NOTTOP) > ECRAD_LIT(0.5);
  const T overlap = row(OVP);
  T total[N][N];
#pragma unroll
  for (int j2 = 0; j2 < N; ++j2) {
    const T f_this = row(RF + j2), f_prev = row(RFP + j2);
    T scaling = T(1) - p.one_minus_overhang * overlap
        * fmin(f_this, f_prev) / fmax(f_this, p.frac_threshold);
    if (!not_top) scaling = T(0);
    T fwd[N - 1], bwd[N - 1];
#pragma unroll
    for (int j = 0; j < N - 1; ++j) {
      fwd[j] = scaling * row(EDGE + j) / fmax(um[j][j2], ECRAD_LIT(1e-5));
      bwd[j] = scaling * row(EDGE + j) / fmax(um[j + 1][j2], ECRAD_LIT(1e-5));
    }
    const T x2 = x[j2];
    const T fractal = p.entrap == EXPLICIT
        ? T(1) / sqrt(fmax(ECRAD_LIT(2.5) * x2 * inv_eff, T(1))) : T(1);
    const T a = fwd[0] * x2 * fractal, b = bwd[0] * x2 * fractal;
    T P[N][N];
    if constexpr (N == 3) {
      const T cc = fwd[1] * x2 * fractal, d = bwd[1] * x2 * fractal;
      const T max_entr = fmax(a, b + cc);
      const T s = max_entr > p.max_cloud_od
          ? p.max_cloud_od / fmax(max_entr, ECRAD_LIT(1e-12)) : T(1);
      exchange3(a * s, b * s, cc * s, d * s, P);
    } else {
      const T max_entr = fmax(a, b);
      const T s = max_entr > p.max_cloud_od
          ? p.max_cloud_od / fmax(max_entr, ECRAD_LIT(1e-12)) : T(1);
      exchange2(a * s, b * s, P);
    }
    const T ad = alb_below[j2][j2];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T v = P[i][j] * vm[j2][j] * ad;
        total[i][j] = j2 == 0 ? v : total[i][j] + v;
      }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mixed[i][j] = mixed[i][j] + total[i][j];
}

// mixing of a below-interface albedo into the layer above
template <int N, int CT, typename T>
__device__ __forceinline__ void sw_mix(const SwParams<T>& p,
                                       const T* __restrict__ c,
                                       const T (&ab)[N][N], const T (&x)[N],
                                       const T (&um)[N][N],
                                       const T (&vm)[N][N],
                                       T (&mixed)[N][N]) {
  if (p.entrap == MAXIMUM) {
    T t[N][N];
    mm<N, N, N>(um, ab, t);
    mm<N, N, N>(t, vm, mixed);
    return;
  }
  if (p.entrap == ZERO) {
    T cs[N], d[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      cs[j] = ab[0][j];
#pragma unroll
      for (int i = 1; i < N; ++i) cs[j] = cs[j] + ab[i][j];
    }
    mvt<N>(vm, cs, d);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) mixed[i][j] = i == j ? d[i] : T(0);
    return;
  }
  T off[N][N], t[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) off[i][j] = i == j ? T(0) : ab[i][j];
  mm<N, N, N>(um, off, t);
  mm<N, N, N>(t, vm, mixed);
  if (p.entrap == EDGE_ONLY || !p.do_3d) {
    T dg[N], d[N];
#pragma unroll
    for (int i = 0; i < N; ++i) dg[i] = ab[i][i];
    mvt<N>(vm, dg, d);
#pragma unroll
    for (int i = 0; i < N; ++i) mixed[i][i] = mixed[i][i] + d[i];
  } else {
    explicit_entrapment<N, CT>(p, c, ab, x, um, vm, mixed);
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(SwStage<T, N>::THREADS,
                                  SwDesign<T>::min_blocks)
sw_adding_kernel(const T* __restrict__ hist, const T* __restrict__ cols,
                 const T* __restrict__ init_up,
                 const T* __restrict__ direct0, int nlev, int ng, int ncol,
                 SwParams<T> p, T* __restrict__ scratch,
                 T* __restrict__ alb_top, T* __restrict__ albdir_top,
                 T* __restrict__ out) {
  using L = SwStage<T, N>;
  constexpr int NN = N * N, NH = 5 * NN;
  constexpr int GT = L::D::g_tile, CT = L::D::c_tile, THR = L::THREADS,
                NST = L::D::stages;
  T* const stage_mem = stage_smem<T>();
  // blocks walk the g-tiles of one column strip before the next strip,
  // so a strip's per-column rows are read from L2 by all but the first
  const int ntiles = (ng + GT - 1) / GT;
  const int g0 = (int)(blockIdx.x % ntiles) * GT;
  const int c0 = (int)(blockIdx.x / ntiles) * CT;
  const int width = min(CT, ncol - c0);
  const size_t m = (size_t)ng * ncol, nc = (size_t)ncol;
  const int tid = threadIdx.x;
  // the arithmetic's cell: g0 + ag, column c0 + ac
  const int ag = tid % GT, ac = tid / GT;
  const bool active = g0 + ag < ng && ac < width;
  const size_t i = active ? (size_t)(g0 + ag) * nc + c0 + ac : 0;
  const int own = slot<GT, CT>(ag, ac);
  // the copies' cell
  const int qg = tid / CT, qc = tid % CT;
  const bool qvalid = g0 + qg < ng && qc < width;
  const size_t qi = qvalid ? (size_t)(g0 + qg) * nc + c0 + qc : 0;
  const int qslot = slot<GT, CT>(qg, qc);
  auto stage = [&](int s) { return stage_mem + (size_t)s * L::FLOATS; };
  // the per-column rows of level l that a sweep reads, to staged row r
  auto copy_cols = [&](int l, T* sc, bool up) {
    const T* cl = cols + (size_t)l * NCOLROWS * nc + c0;
    const int nrows = up ? UP_COLROWS : DN_COLROWS;
    for (int q = tid; q < nrows * CT; q += THR) {
      const int r = q / CT, cc = q % CT;
      const int src = up ? up_src(r) : dn_src(r);
      if (cc < width) copy_async(sc + q, cl + (size_t)src * nc + cc);
    }
  };
  // level l's operands of the upward sweep into stage s
  auto fetch_up = [&](int l, int s) {
    T* st = stage(s);
    if (qvalid) {
      const T* h = hist + (size_t)l * NH * m + qi;
#pragma unroll
      for (int k = 0; k < NH; ++k)
        copy_async(st + k * THR + qslot, h + (size_t)k * m);
    }
    copy_cols(l, st + L::UP_H * THR, true);
    __pipeline_commit();
  };
  // and of the downward sweep: R, T, TD, TDD and the albedos below
  auto fetch_dn = [&](int l, int s) {
    T* st = stage(s);
    if (qvalid) {
      const T* h = hist + (size_t)l * NH * m + qi;
#pragma unroll
      for (int k = 0; k < 4 * NN; ++k)
        copy_async(st + k * THR + qslot,
                   h + (size_t)(k < 2 * NN ? k : k + NN) * m);
      const T* sr = scratch + (size_t)l * 2 * NN * m + qi;
#pragma unroll
      for (int k = 0; k < 2 * NN; ++k)
        copy_async(st + (4 * NN + k) * THR + qslot, sr + (size_t)k * m);
    }
    copy_cols(l, st + L::DN_H * THR, false);
    __pipeline_commit();
  };
  // the results in rows 0 .. nrows - 1 of stage s to dst's rows, by the
  // copies' mapping (so each scratch value is copied back in the downward
  // sweep by the thread that stored it)
  auto flush = [&](int s, T* dst, int nrows) {
    const T* st = stage(s);
    if (qvalid)
      for (int k = 0; k < nrows; ++k)
        dst[(size_t)k * m + qi] = st[k * THR + qslot];
  };
  const bool explicit_x = p.entrap == EXPLICIT || p.entrap == NON_FRACTAL;

  T alb[N][N], albdir[N][N], xd[N], xr[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      alb[a][b] = active ? init_up[(size_t)(a * N + b) * m + i] : T(0);
      albdir[a][b] = active ? init_up[(size_t)(NN + a * N + b) * m + i]
                            : T(0);
    }
    xd[a] = xr[a] = T(0);
  }

  // ---- upward: the total albedos below each layer ----
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nlev) fetch_up(nlev - 1 - j, j);
    else __pipeline_commit();
  }
  for (int j = 0; j < nlev; ++j) {
    // this level's copies have landed, every thread's included, and the
    // level before is complete; its results leave its stage before the
    // stage is refilled
    __pipeline_wait_prior(NST - 2);
    __syncthreads();
    if (j > 0) {
      flush((j - 1) % NST, scratch + (size_t)(nlev - j) * 2 * NN * m,
            2 * NN);
      __syncthreads();
    }
    const int jn = j + NST - 1;
    if (jn < nlev) fetch_up(nlev - 1 - jn, jn % NST);
    else __pipeline_commit();
    if (!active) continue;
    T* st = stage(j % NST);
    auto H = [&](int k) -> T& { return st[k * THR + own]; };
    const T* c = st + L::UP_H * THR + ac;
    auto row = [&](int k) { return c[up_row(k) * CT]; };
    T R[N][N], Tr[N][N], RD[N][N], TD[N][N], TDD[N][N];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = a * N + b;
        R[a][b] = H(k);
        Tr[a][b] = H(NN + k);
        RD[a][b] = H(2 * NN + k);
        TD[a][b] = H(3 * NN + k);
        TDD[a][b] = H(4 * NN + k);
      }
    // the albedos below this layer (the carry at entry) for the downward
    // sweep, in this thread's slots of the rows just read
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        H(a * N + b) = alb[a][b];
        H(NN + a * N + b) = albdir[a][b];
      }
    T um[N][N], vm[N][N];
    col_mat<N>(c, CT, up_row(UM), um);
    col_mat<N>(c, CT, up_row(VM), vm);
    const bool is_clear = row(CLEAR) > ECRAD_LIT(0.5);
    const bool both_clear = is_clear && row(CLEARP) > ECRAD_LIT(0.5);
    if (explicit_x) {
      // horizontal migration distances (_step_migrations_k)
      const T cf = row(CF), xl_diff = row(XLD), xl_dir = row(XLDIR);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const T Rd = R[r][r], Td = Tr[r][r], RDd = RD[r][r],
                TDDd = TDD[r][r], TDd = TD[r][r], Ad = alb[r][r],
                ADd = albdir[r][r];
        const T ms = Td / fmax(T(1) - Rd * Ad, ECRAD_LIT(1e-12));
        const T x_enh =
            pow(fmax(T(1) - Rd * Ad, ECRAD_LIT(1e-12)), ECRAD_LIT(-1.5));
        const T top_alb_dir =
            fmax(RDd + ms * (TDd * Ad + TDDd * ADd), ECRAD_LIT(1e-8));
        const T x_dir_new = fmax(xl_dir + ((TDd * Ad * x_enh
            + TDDd * ADd * (x_enh - T(1))) * (xd[r] + xl_diff)
            + TDDd * ADd * (xr[r] + xl_dir)) * Td / top_alb_dir, T(0));
        const T top_alb = fmax(Rd + ms * Td * Ad, ECRAD_LIT(1e-8));
        const T x_diff_new = xl_diff + x_enh * Ad * Td * Td
            * (xd[r] + xl_diff) / top_alb;
        const bool act = r == 0 ? cf < T(1) : cf > T(0);
        xd[r] = act ? x_diff_new : T(0);
        xr[r] = act ? x_dir_new : T(0);
      }
    }
    // [alb_below | albdir_below] = [R | RD] + T (I - alb R)^-1
    //                              [alb T | albdir TDD + alb TD]
    T den[N][N], rhs[N][2 * N], t1[N][N], t2[N][N], t3[N][N];
    one_minus<N>(alb, R, den);
    mm<N, N, N>(alb, Tr, t1);
    mm<N, N, N>(albdir, TDD, t2);
    mm<N, N, N>(alb, TD, t3);
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        rhs[a][b] = t1[a][b];
        rhs[a][N + b] = t2[a][b] + t3[a][b];
      }
    solve<N, 2 * N>(den, rhs);
    T X[N][2 * N], ab[N][N], adb[N][N];
    mm<N, N, 2 * N>(Tr, rhs, X);
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        ab[a][b] = R[a][b] + X[a][b];
        adb[a][b] = RD[a][b] + X[a][N + b];
      }
    if (is_clear) {
      zero_offdiag<N>(ab);
      zero_offdiag<N>(adb);
    }
    if (both_clear) {
#pragma unroll
      for (int a = 0; a < N; ++a)
#pragma unroll
        for (int b = 0; b < N; ++b) {
          alb[a][b] = ab[a][b];
          albdir[a][b] = adb[a][b];
        }
    } else {
      sw_mix<N, CT>(p, c, ab, xd, um, vm, alb);
      sw_mix<N, CT>(p, c, adb, xr, um, vm, albdir);
      if (explicit_x) {
        T y[N];
        mvt<N>(vm, xd, y);
#pragma unroll
        for (int r = 0; r < N; ++r) xd[r] = y[r];
        mvt<N>(vm, xr, y);
#pragma unroll
        for (int r = 0; r < N; ++r) xr[r] = y[r];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        alb_top[(size_t)(a * N + b) * m + i] = alb[a][b];
        albdir_top[(size_t)(a * N + b) * m + i] = albdir[a][b];
      }
  }
  __syncthreads();
  if (nlev > 0) flush((nlev - 1) % NST, scratch, 2 * NN);
  // no thread reads a stage any more
  __syncthreads();

  // ---- downward: the fluxes at the top of each layer ----
  T fdn[N], dir[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    fdn[r] = T(0);
    dir[r] = active ? direct0[(size_t)r * m + i] : T(0);
  }
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nlev) fetch_dn(j, j);
    else __pipeline_commit();
  }
  for (int l = 0; l < nlev; ++l) {
    __pipeline_wait_prior(NST - 2);
    __syncthreads();
    if (l > 0) {
      flush((l - 1) % NST, out + (size_t)(l - 1) * 3 * N * m, 3 * N);
      __syncthreads();
    }
    const int ln = l + NST - 1;
    if (ln < nlev) fetch_dn(ln, ln % NST);
    else __pipeline_commit();
    if (!active) continue;
    T* st = stage(l % NST);
    auto H = [&](int k) -> T& { return st[k * THR + own]; };
    const T* c = st + L::DN_H * THR + ac;
    T R[N][N], Tr[N][N], TD[N][N], TDD[N][N], ab[N][N], adb[N][N];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = a * N + b;
        R[a][b] = H(k);
        Tr[a][b] = H(NN + k);
        TD[a][b] = H(2 * NN + k);
        TDD[a][b] = H(3 * NN + k);
        ab[a][b] = H(4 * NN + k);
        adb[a][b] = H(5 * NN + k);
      }
    const bool is_clear = c[DN_CLEAR * CT] > ECRAD_LIT(0.5);
    const bool both_clear = is_clear && c[DN_CLEARN * CT] > ECRAD_LIT(0.5);
    T src[N], dab[N], tot[N], v1[N], v2[N], den[N][N], rhs[N][1];
    mv<N, N>(TD, dir, src);
    mv<N, N>(TDD, dir, dab);
    one_minus<N>(R, ab, den);
    mv<N, N>(adb, dab, tot);
    mv<N, N>(Tr, fdn, v1);
    mv<N, N>(R, tot, v2);
#pragma unroll
    for (int r = 0; r < N; ++r) rhs[r][0] = v1[r] + v2[r] + src[r];
    solve<N, 1>(den, rhs);
    T fa[N], fu[N];
#pragma unroll
    for (int r = 0; r < N; ++r) fa[r] = rhs[r][0];
    mv<N, N>(ab, fa, fu);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      fu[r] = fu[r] + tot[r];
      if (is_clear && r > 0) fa[r] = fu[r] = dab[r] = T(0);
    }
    // [fup | fdn | ddn] in this thread's slots of the first 3 N rows
#pragma unroll
    for (int r = 0; r < N; ++r) {
      H(r) = fu[r];
      H(N + r) = fa[r];
      H(2 * N + r) = dab[r];
    }
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        fdn[r] = fa[r];
        dir[r] = dab[r];
      }
    } else {
      T vn[N][N];
      col_mat<N>(c, CT, 0, vn);
      mv<N, N>(vn, fa, fdn);
      mv<N, N>(vn, dab, dir);
    }
  }
  __syncthreads();
  if (nlev > 0)
    flush((nlev - 1) % NST, out + (size_t)(nlev - 1) * 3 * N * m, 3 * N);
}

// B9's block: LW_G_TILE g-points x C_TILE columns, a ring of LW_STAGES
// levels, at least LW_MIN_BLOCKS blocks per SM (128 registers, 16
// warps). A warp is 32 columns of one g-point, for the copies and the
// arithmetic alike: each thread copies the history and scratch rows of
// its own (g, column) and reads them back itself.
constexpr int LW_G_TILE = 4, LW_STAGES = 3, LW_MIN_BLOCKS = 4;
// The double form's: the same block, a ring of 2 levels, 3 blocks (12
// warps) per SM, so up to 168 registers (144, no spills). Timed on an
// H100 at 2048 x 137, 3 regions, without multilayer effects, on the
// float64 path's operands (tools/spartacus_f64_designs.py, PERF.md): 7.151
// ms; 3 stages at 2 blocks 7.190; 2 g-points x 32 columns at 2 stages and
// 5 blocks 7.260, at 3 stages and 3 blocks 7.364.
constexpr int F64_LW_G_TILE = 4, F64_LW_STAGES = 2, F64_LW_MIN_BLOCKS = 3;

// B9's block and ring in each form
template <typename T>
struct LwDesign;
template <>
struct LwDesign<float> {
  static constexpr int g_tile = LW_G_TILE, stages = LW_STAGES,
                       min_blocks = LW_MIN_BLOCKS;
};
template <>
struct LwDesign<double> {
  static constexpr int g_tile = F64_LW_G_TILE, stages = F64_LW_STAGES,
                       min_blocks = F64_LW_MIN_BLOCKS;
};

// one stage of B9, in values: the thread's rows at [k][thread] (up: R T
// SU SD; down: R T SD and the scratch below the layer), then the block's
// per-column rows at [row][column] (up: um, vm, clear, clear above; down:
// vm below, clear, clear below). The scratch holds the carry entering
// each level going up: with ML (multilayer effects) the albedo matrix and
// the source (NREG^2 + NREG values), without it the albedo's diagonal and
// the source (2 NREG): every carry an up step makes is then diagonal.
template <typename T, int N, bool ML>
struct LwStage {
  using D = LwDesign<T>;
  static constexpr int THREADS = D::g_tile * C_TILE;
  static constexpr int NN = N * N, NS = ML ? NN + N : 2 * N;
  static constexpr int UP_H = 2 * NN + 2 * N, DN_H = 2 * NN + N + NS;
  static constexpr int UP_C = 2 * NN + 2, DN_C = NN + 2;
  static constexpr int UP = UP_H * THREADS + UP_C * C_TILE;
  static constexpr int DN = DN_H * THREADS + DN_C * C_TILE;
  static constexpr int FLOATS = UP > DN ? UP : DN;
  static constexpr size_t BYTES = (size_t)D::stages * FLOATS * sizeof(T);
};
static_assert(LW_MIN_BLOCKS * (LwStage<float, 3, true>::BYTES + 1024)
                  <= 228 * 1024,
              "B9's stages keep LW_MIN_BLOCKS blocks on an SM");
static_assert(F64_LW_MIN_BLOCKS * (LwStage<double, 3, true>::BYTES + 1024)
                  <= 228 * 1024 && F64_LW_STAGES >= 2,
              "B9's double stages keep F64_LW_MIN_BLOCKS blocks on an SM");

// the per-column row (of LW_NCOLROWS) staged in row r of a level
template <int N>
__device__ __forceinline__ int lw_col_src(int r, bool up) {
  constexpr int NN = N * N;
  if (up) {
    if (r < NN) return LUM + 3 * (r / N) + r % N;
    if (r < 2 * NN) return LVM + 3 * ((r - NN) / N) + (r - NN) % N;
    return r == 2 * NN ? LCLEAR : LCLEARP;
  }
  if (r < NN) return LVMN + 3 * (r / N) + r % N;
  return r == NN ? LCLEAR : LCLEARN;
}

// a staged per-column matrix: rows base .. base + N^2 - 1 at stride C_TILE
template <int N, typename T>
__device__ __forceinline__ void staged_mat(const T* __restrict__ c, int base,
                                           T (&o)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o[i][j] = c[(base + i * N + j) * C_TILE];
}

template <int N, bool ML, typename T>
__global__ void __launch_bounds__(LwStage<T, N, ML>::THREADS,
                                  LwDesign<T>::min_blocks)
lw_adding_kernel(const T* __restrict__ hist, const T* __restrict__ cols,
                 const T* __restrict__ init_up, int nlev, int ng, int ncol,
                 int use_matrix, T* __restrict__ scratch,
                 T* __restrict__ src_top, T* __restrict__ out) {
  using L = LwStage<T, N, ML>;
  constexpr int NN = N * N, NH = 2 * N * (N + 1), NS = L::NS;
  constexpr int GT = L::D::g_tile, THR = L::THREADS, NST = L::D::stages;
  T* const stage_mem = stage_smem<T>();
  const int ntiles = (ng + GT - 1) / GT;
  const int g0 = (int)(blockIdx.x % ntiles) * GT;
  const int c0 = (int)(blockIdx.x / ntiles) * C_TILE;
  const int width = min(C_TILE, ncol - c0);
  const size_t m = (size_t)ng * ncol, nc = (size_t)ncol;
  const int tid = threadIdx.x, tc = tid % C_TILE;
  const bool active = g0 + tid / C_TILE < ng && tc < width;
  const size_t i = active ? (size_t)(g0 + tid / C_TILE) * nc + c0 + tc : 0;
  auto stage = [&](int s) { return stage_mem + (size_t)s * L::FLOATS; };
  auto copy_cols = [&](int l, T* sc, bool up) {
    const T* cl = cols + (size_t)l * LW_NCOLROWS * nc + c0;
    const int nrows = up ? L::UP_C : L::DN_C;
    for (int q = tid; q < nrows * C_TILE; q += THR) {
      const int r = q / C_TILE, cc = q % C_TILE;
      if (cc < width)
        copy_async(sc + q, cl + (size_t)lw_col_src<N>(r, up) * nc + cc);
    }
  };
  // level l's operands of the upward sweep into stage s: R T SU SD
  auto fetch_up = [&](int l, int s) {
    T* st = stage(s);
    if (active) {
      const T* h = hist + (size_t)l * NH * m + i;
#pragma unroll
      for (int k = 0; k < NH; ++k)
        copy_async(st + k * THR + tid, h + (size_t)k * m);
    }
    copy_cols(l, st + L::UP_H * THR, true);
    __pipeline_commit();
  };
  // and of the downward sweep: R T SD, then the scratch below the layer
  auto fetch_dn = [&](int l, int s) {
    T* st = stage(s);
    if (active) {
      const T* h = hist + (size_t)l * NH * m + i;
#pragma unroll
      for (int k = 0; k < 2 * NN + N; ++k)
        copy_async(st + k * THR + tid,
                   h + (size_t)(k < 2 * NN ? k : k + N) * m);
      const T* sr = scratch + (size_t)l * NS * m + i;
#pragma unroll
      for (int k = 0; k < NS; ++k)
        copy_async(st + (2 * NN + N + k) * THR + tid, sr + (size_t)k * m);
    }
    copy_cols(l, st + L::DN_H * THR, false);
    __pipeline_commit();
  };

  T alb[N][N], src[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b)
      alb[a][b] = active ? init_up[(size_t)(a * N + b) * m + i] : T(0);
    src[a] = active ? init_up[(size_t)(NN + a) * m + i] : T(0);
  }

  // ---- upward: albedos and sources below each layer ----
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nlev) fetch_up(nlev - 1 - j, j);
    else __pipeline_commit();
  }
  for (int j = 0; j < nlev; ++j) {
    // this level's copies have landed, and every thread is done with the
    // stage the next copies go to
    __pipeline_wait_prior(NST - 2);
    __syncthreads();
    const int jn = j + NST - 1;
    if (jn < nlev) fetch_up(nlev - 1 - jn, jn % NST);
    else __pipeline_commit();
    if (!active) continue;
    const int l = nlev - 1 - j;
    const T* st = stage(j % NST);
    auto H = [&](int k) { return st[k * THR + tid]; };
    const T* c = st + L::UP_H * THR + tc;
    // the carry at entry, for the downward sweep
    T* S = scratch + (size_t)l * NS * m + i;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if constexpr (ML) {
#pragma unroll
        for (int b = 0; b < N; ++b) S[(size_t)(a * N + b) * m] = alb[a][b];
        S[(size_t)(NN + a) * m] = src[a];
      } else {
        S[(size_t)a * m] = alb[a][a];
        S[(size_t)(N + a) * m] = src[a];
      }
    }
    T R[N][N], Tr[N][N], SU[N], SD[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        R[a][b] = H(a * N + b);
        Tr[a][b] = H(NN + a * N + b);
      }
      SU[a] = H(2 * NN + a);
      SD[a] = H(2 * NN + N + a);
    }
    const bool is_clear = c[2 * NN * C_TILE] > ECRAD_LIT(0.5);
    const bool both_clear =
        is_clear && c[(2 * NN + 1) * C_TILE] > ECRAD_LIT(0.5);
    T ab[N][N], sb[N];
    if (use_matrix) {
      // one elimination of I - alb R for [alb T | src + alb SD]
      T den[N][N], rhs[N][N + 1], at[N][N], asd[N], X[N][N];
      one_minus<N>(alb, R, den);
      mm<N, N, N>(alb, Tr, at);
      mv<N, N>(alb, SD, asd);
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) rhs[a][b] = at[a][b];
        rhs[a][N] = src[a] + asd[a];
      }
      solve<N, N + 1>(den, rhs);
      T Y[N][N], y[N], ty[N];
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) Y[a][b] = rhs[a][b];
        y[a] = rhs[a][N];
      }
      mm<N, N, N>(Tr, Y, X);
      mv<N, N>(Tr, y, ty);
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) ab[a][b] = R[a][b] + X[a][b];
        sb[a] = SU[a] + ty[a];
      }
    } else {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const T Rd = R[a][a], Td = Tr[a][a], Ad = alb[a][a];
        const T inv = T(1) / (T(1) - Ad * Rd);
#pragma unroll
        for (int b = 0; b < N; ++b) ab[a][b] = T(0);
        ab[a][a] = Rd + Td * Td * Ad * inv;
        sb[a] = SU[a] + Td * (src[a] + Ad * SD[a]) * inv;
      }
    }
    if (is_clear) {
      zero_offdiag<N>(ab);
#pragma unroll
      for (int a = 1; a < N; ++a) sb[a] = T(0);
    }
    if (both_clear) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) alb[a][b] = ab[a][b];
        src[a] = sb[a];
      }
    } else {
      T um[N][N], vm[N][N];
      staged_mat<N>(c, 0, um);
      staged_mat<N>(c, NN, vm);
      mv<N, N>(um, sb, src);
      if constexpr (ML) {
        T t[N][N];
        mm<N, N, N>(um, ab, t);
        mm<N, N, N>(t, vm, alb);
      } else {
        T dg[N], d[N];
#pragma unroll
        for (int a = 0; a < N; ++a) dg[a] = ab[a][a];
        mvt<N>(vm, dg, d);
#pragma unroll
        for (int a = 0; a < N; ++a)
#pragma unroll
          for (int b = 0; b < N; ++b) alb[a][b] = a == b ? d[a] : T(0);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int a = 0; a < N; ++a) src_top[(size_t)a * m + i] = src[a];
  }
  // every copy has landed and no thread reads a stage any more; each
  // thread reads back only the scratch it wrote
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- downward ----
  T fdn[N];
#pragma unroll
  for (int r = 0; r < N; ++r) fdn[r] = T(0);
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < nlev) fetch_dn(j, j);
    else __pipeline_commit();
  }
  for (int l = 0; l < nlev; ++l) {
    __pipeline_wait_prior(NST - 2);
    __syncthreads();
    const int ln = l + NST - 1;
    if (ln < nlev) fetch_dn(ln, ln % NST);
    else __pipeline_commit();
    if (!active) continue;
    const T* st = stage(l % NST);
    auto H = [&](int k) { return st[k * THR + tid]; };
    const T* c = st + L::DN_H * THR + tc;
    T R[N][N], Tr[N][N], SD[N], ab[N][N], sb[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        R[a][b] = H(a * N + b);
        Tr[a][b] = H(NN + a * N + b);
      }
      SD[a] = H(2 * NN + a);
    }
    // the albedo below the layer: the scratch's, or without ML its
    // diagonal with the off-diagonals the literal zeros the up step made;
    // below the bottom layer the caller's init_up, which may be full
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        if constexpr (ML)
          ab[a][b] = H(2 * NN + N + a * N + b);
        else
          ab[a][b] = l == nlev - 1 ? init_up[(size_t)(a * N + b) * m + i]
                                   : (a == b ? H(2 * NN + N + a) : T(0));
      }
      sb[a] = H(2 * NN + N + NS - N + a);
    }
    const bool is_clear = c[NN * C_TILE] > ECRAD_LIT(0.5);
    const bool both_clear = is_clear && c[(NN + 1) * C_TILE] > ECRAD_LIT(0.5);
    T fa[N], fu[N];
    if (use_matrix) {
      T den[N][N], v1[N], v2[N], rhs[N][1];
      one_minus<N>(R, ab, den);
      mv<N, N>(Tr, fdn, v1);
      mv<N, N>(R, sb, v2);
#pragma unroll
      for (int a = 0; a < N; ++a) rhs[a][0] = v1[a] + v2[a] + SD[a];
      solve<N, 1>(den, rhs);
#pragma unroll
      for (int a = 0; a < N; ++a) fa[a] = rhs[a][0];
      mv<N, N>(ab, fa, fu);
#pragma unroll
      for (int a = 0; a < N; ++a) fu[a] = fu[a] + sb[a];
    } else {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const T Rd = R[a][a], Td = Tr[a][a], Ad = ab[a][a];
        fa[a] = (Td * fdn[a] + Rd * sb[a] + SD[a]) / (T(1) - Rd * Ad);
        fu[a] = sb[a] + Ad * fa[a];
      }
    }
    if (is_clear) {
#pragma unroll
      for (int a = 1; a < N; ++a) fa[a] = fu[a] = T(0);
    }
    if (both_clear) {
#pragma unroll
      for (int a = 0; a < N; ++a) fdn[a] = fa[a];
    } else {
      T vn[N][N];
      staged_mat<N>(c, 0, vn);
      mv<N, N>(vn, fa, fdn);
    }
    const size_t o = (size_t)l * 2 * N * m + i;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      out[o + (size_t)a * m] = fu[a];
      out[o + (size_t)(N + a) * m] = fdn[a];
    }
  }
}

// B8's dynamic shared memory above 48 KB, and the carveout that gives
// shared memory the most of the SM's 256 KB (the kernel's reads land in
// shared memory, so it needs little L1)
template <int N, typename T>
cudaError_t configure_sw() {
  cudaError_t e = cudaFuncSetAttribute(
      sw_adding_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SwStage<T, N>::BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sw_adding_kernel<N, T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// and B9's
template <int N, bool ML, typename T>
cudaError_t configure_lw() {
  cudaError_t e = cudaFuncSetAttribute(
      lw_adding_kernel<N, ML, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)LwStage<T, N, ML>::BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(lw_adding_kernel<N, ML, T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, typename T>
cudaError_t launch_sw(const T* hist, const T* cols, const T* init_up,
                      const T* direct0, int nlev, int ng, int ncol,
                      const SwParams<T>& p, T* scratch, T* alb_top,
                      T* albdir_top, T* out, cudaStream_t s) {
  using D = SwDesign<T>;
  cudaError_t e = configure_sw<N, T>();
  if (e != cudaSuccess) return e;
  // one block per (g-tile, column strip), the g-tiles of a strip adjacent
  const unsigned blocks = (unsigned)((ng + D::g_tile - 1) / D::g_tile)
      * (unsigned)((ncol + D::c_tile - 1) / D::c_tile);
  sw_adding_kernel<N, T><<<blocks, SwStage<T, N>::THREADS,
                           SwStage<T, N>::BYTES, s>>>(
      hist, cols, init_up, direct0, nlev, ng, ncol, p, scratch, alb_top,
      albdir_top, out);
  return cudaGetLastError();
}

template <typename T>
int sw_adding(const T* hist, const T* cols, const T* init_up,
              const T* direct0, int nreg, int nlev, int ng, int ncol,
              int entrap, int do_3d, T max_cloud_od, T inv_min_size,
              T one_minus_overhang, T frac_threshold, T* scratch, T* alb_top,
              T* albdir_top, T* out, void* stream) {
  if ((size_t)ng * ncol == 0) return (int)cudaGetLastError();
  const SwParams<T> p{entrap, do_3d, max_cloud_od, inv_min_size,
                      one_minus_overhang, frac_threshold};
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3)
    return (int)launch_sw<3>(hist, cols, init_up, direct0, nlev, ng, ncol, p,
                             scratch, alb_top, albdir_top, out, s);
  if (nreg == 2)
    return (int)launch_sw<2>(hist, cols, init_up, direct0, nlev, ng, ncol, p,
                             scratch, alb_top, albdir_top, out, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int sw_info(int nreg, int* info) {
  cudaError_t e;
  if (nreg == 3) {
    if ((e = configure_sw<3, T>()) != cudaSuccess) return (int)e;
    return kernel_info(sw_adding_kernel<3, T>, SwStage<T, 3>::THREADS,
                       SwStage<T, 3>::BYTES, info);
  }
  if (nreg == 2) {
    if ((e = configure_sw<2, T>()) != cudaSuccess) return (int)e;
    return kernel_info(sw_adding_kernel<2, T>, SwStage<T, 2>::THREADS,
                       SwStage<T, 2>::BYTES, info);
  }
  return (int)cudaErrorInvalidValue;
}

template <int N, bool ML, typename T>
cudaError_t launch_lw(const T* hist, const T* cols, const T* init_up,
                      int nlev, int ng, int ncol, int use_matrix, T* scratch,
                      T* src_top, T* out, cudaStream_t s) {
  using D = LwDesign<T>;
  cudaError_t e = configure_lw<N, ML, T>();
  if (e != cudaSuccess) return e;
  // one block per (g-tile, column strip), the g-tiles of a strip adjacent
  const unsigned blocks = (unsigned)((ng + D::g_tile - 1) / D::g_tile)
      * (unsigned)((ncol + C_TILE - 1) / C_TILE);
  lw_adding_kernel<N, ML, T><<<blocks, LwStage<T, N, ML>::THREADS,
                               LwStage<T, N, ML>::BYTES, s>>>(
      hist, cols, init_up, nlev, ng, ncol, use_matrix, scratch, src_top,
      out);
  return cudaGetLastError();
}

template <typename T>
int lw_adding(const T* hist, const T* cols, const T* init_up, int nreg,
              int nlev, int ng, int ncol, int use_matrix, int multilayer,
              T* scratch, T* src_top, T* out, void* stream) {
  if ((size_t)ng * ncol == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto launch) {
    return (int)launch(hist, cols, init_up, nlev, ng, ncol, use_matrix,
                       scratch, src_top, out, s);
  };
  if (nreg == 3)
    return multilayer ? go(launch_lw<3, true, T>)
                      : go(launch_lw<3, false, T>);
  if (nreg == 2)
    return multilayer ? go(launch_lw<2, true, T>)
                      : go(launch_lw<2, false, T>);
  return (int)cudaErrorInvalidValue;
}

template <int N, bool ML, typename T>
int lw_info(int* info) {
  cudaError_t e = configure_lw<N, ML, T>();
  if (e != cudaSuccess) return (int)e;
  return kernel_info(lw_adding_kernel<N, ML, T>, LwStage<T, N, ML>::THREADS,
                     LwStage<T, N, ML>::BYTES, info);
}

template <typename T>
int lw_info(int multilayer, int nreg, int* info) {
  if (nreg == 3) return multilayer ? lw_info<3, true, T>(info)
                                   : lw_info<3, false, T>(info);
  if (nreg == 2) return multilayer ? lw_info<2, true, T>(info)
                                   : lw_info<2, false, T>(info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace spadd
}  // namespace ecrad

extern "C" int spartacus_sw_adding(const float* hist, const float* cols,
                                   const float* init_up,
                                   const float* direct0, int nreg, int nlev,
                                   int ng, int ncol, int entrap, int do_3d,
                                   float max_cloud_od, float inv_min_size,
                                   float one_minus_overhang,
                                   float frac_threshold, float* scratch,
                                   float* alb_top, float* albdir_top,
                                   float* out, void* stream) {
  return ecrad::spadd::sw_adding<float>(
      hist, cols, init_up, direct0, nreg, nlev, ng, ncol, entrap, do_3d,
      max_cloud_od, inv_min_size, one_minus_overhang, frac_threshold,
      scratch, alb_top, albdir_top, out, stream);
}

extern "C" int spartacus_sw_adding_f64(
    const double* hist, const double* cols, const double* init_up,
    const double* direct0, int nreg, int nlev, int ng, int ncol, int entrap,
    int do_3d, double max_cloud_od, double inv_min_size,
    double one_minus_overhang, double frac_threshold, double* scratch,
    double* alb_top, double* albdir_top, double* out, void* stream) {
  return ecrad::spadd::sw_adding<double>(
      hist, cols, init_up, direct0, nreg, nlev, ng, ncol, entrap, do_3d,
      max_cloud_od, inv_min_size, one_minus_overhang, frac_threshold,
      scratch, alb_top, albdir_top, out, stream);
}

// B8's compiled resources and the occupancy its launch gets (see
// kernel_info.cuh), for nreg regions
extern "C" int spartacus_sw_adding_info(int nreg, int* info) {
  return ecrad::spadd::sw_info<float>(nreg, info);
}

extern "C" int spartacus_sw_adding_info_f64(int nreg, int* info) {
  return ecrad::spadd::sw_info<double>(nreg, info);
}

// B9; scratch is (nlev, nreg^2 + nreg, ng, ncol) values with multilayer,
// (nlev, 2 nreg, ng, ncol) without
extern "C" int spartacus_lw_adding(const float* hist, const float* cols,
                                   const float* init_up, int nreg, int nlev,
                                   int ng, int ncol, int use_matrix,
                                   int multilayer, float* scratch,
                                   float* src_top, float* out, void* stream) {
  return ecrad::spadd::lw_adding<float>(hist, cols, init_up, nreg, nlev, ng,
                                        ncol, use_matrix, multilayer,
                                        scratch, src_top, out, stream);
}

extern "C" int spartacus_lw_adding_f64(const double* hist,
                                       const double* cols,
                                       const double* init_up, int nreg,
                                       int nlev, int ng, int ncol,
                                       int use_matrix, int multilayer,
                                       double* scratch, double* src_top,
                                       double* out, void* stream) {
  return ecrad::spadd::lw_adding<double>(hist, cols, init_up, nreg, nlev, ng,
                                         ncol, use_matrix, multilayer,
                                         scratch, src_top, out, stream);
}

// B9's compiled resources and the occupancy its launch gets
extern "C" int spartacus_lw_adding_info(int multilayer, int nreg,
                                        int* info) {
  return ecrad::spadd::lw_info<float>(multilayer, nreg, info);
}

extern "C" int spartacus_lw_adding_info_f64(int multilayer, int nreg,
                                            int* info) {
  return ecrad::spadd::lw_info<double>(multilayer, nreg, info);
}
