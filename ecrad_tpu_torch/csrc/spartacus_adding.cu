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
// Semantics: ops/spartacus_adding.py sw_up_step / sw_dn_step /
// lw_up_step / lw_dn_step, expression for expression (built with
// -fmad=false; products and mixings add left to right as mm_gu, the
// elimination is solve_g's).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

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
constexpr int G_TILE = 8, C_TILE = 32, SW_THREADS = G_TILE * C_TILE,
              STAGES = 2, SW_MIN_BLOCKS = 2;
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
// the slot of cell (g, c) of the block in one staged row: columns of
// G_TILE g-points, g swizzled by the column, so that the arithmetic's
// reads (G_TILE g x 32 / G_TILE columns a warp) and the copies' writes
// (C_TILE columns x 32 / C_TILE g) each fall in 32 distinct banks
__device__ __forceinline__ int slot(int g, int c) {
  return c * G_TILE
      + (g ^ (((c / (32 / G_TILE)) * (32 / C_TILE)) & (G_TILE - 1)));
}

// one stage of B8, in floats: the cells' rows (up: R T RD TD TDD; down:
// R T TD TDD and the two albedos below) at [k][slot], then the block's
// per-column rows at [row][column]. After a level's arithmetic each
// thread puts its results (up: the albedos below the layer; down: the
// fluxes) in its own slots of the first rows, and the block writes them
// out with the copies' mapping, in 128-byte runs.
template <int N>
struct SwStage {
  static constexpr int NN = N * N, UP_H = 5 * NN, DN_H = 6 * NN;
  static constexpr int UP = UP_H * SW_THREADS + UP_COLROWS * C_TILE;
  static constexpr int DN = DN_H * SW_THREADS + DN_COLROWS * C_TILE;
  static constexpr int FLOATS = UP > DN ? UP : DN;
  static constexpr size_t BYTES = (size_t)STAGES * FLOATS * sizeof(float);
};
static_assert(G_TILE <= 32 && C_TILE <= 32 && SW_THREADS % 32 == 0
                  && (G_TILE & (G_TILE - 1)) == 0
                  && (C_TILE & (C_TILE - 1)) == 0,
              "slot() takes powers of two, a whole number of warps");
static_assert(SwStage<3>::BYTES <= 227 * 1024, "B8 stages exceed 227 KB");

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}
// per-column LW rows
constexpr int LUM = 0, LVM = 9, LVMN = 18, LCLEAR = 27, LCLEARP = 28,
              LCLEARN = 29, LW_NCOLROWS = 30;
// config.Entrapment
constexpr int ZERO = 0, EDGE_ONLY = 1, EXPLICIT = 2, NON_FRACTAL = 3,
              MAXIMUM = 4;

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

// o[i] = sum_k a[k][i] x[k] (the transpose), left to right
template <int N>
__device__ __forceinline__ void mvt(const float (&a)[N][N],
                                    const float (&x)[N], float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = a[0][i] * x[0];
#pragma unroll
    for (int k = 1; k < N; ++k) s = s + a[k][i] * x[k];
    o[i] = s;
  }
}

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

// d = I - a b
template <int N>
__device__ __forceinline__ void one_minus(const float (&a)[N][N],
                                          const float (&b)[N][N],
                                          float (&d)[N][N]) {
  mm<N, N, N>(a, b, d);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) d[i][j] = -d[i][j];
    d[i][i] = d[i][i] + 1.0f;
  }
}

// a 3 x 3-padded per-column matrix at row `base` of one level's rows
template <int N>
__device__ __forceinline__ void col_mat(const float* __restrict__ rows,
                                        size_t ncol, int base,
                                        float (&o)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      o[i][j] = rows[(size_t)(base + 3 * i + j) * ncol];
}

template <int N>
__device__ __forceinline__ void zero_offdiag(float (&a)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (i > 0 || j > 0) a[i][j] = 0.0f;
}

// exp of [[-a, b], [a, -b]] (solvers/matrix.py fast_expm_exchange_2_g)
__device__ __forceinline__ void exchange2(float a, float b, float (&p)[2][2]) {
  const float factor = (1.0f - expf(-(a + b))) / fmaxf(a + b, 1e-12f);
  p[0][0] = 1.0f - factor * a;
  p[0][1] = factor * b;
  p[1][0] = factor * a;
  p[1][1] = 1.0f - factor * b;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  const float eps = 1e-12f;
  return num / (fabsf(den) < eps ? (den >= 0.0f ? eps : -eps) : den);
}

// exp of [[-a, b, 0], [a, -b-c, d], [0, c, -d]]
// (solvers/matrix.py fast_expm_exchange_3_g)
__device__ __forceinline__ void exchange3(float a, float b, float c, float d,
                                          float (&p)[3][3]) {
  const float eps = 1e-12f, one = 1.0f, zero = 0.0f;
  const float y2 = 0.5f * (a + b + c + d);
  const float y3 = sqrtf(fmaxf(y2 * y2 - (a * c + a * d + b * d), 0.0f));
  const float lam1 = -y2 + y3, lam2 = -y2 - y3;
  const float v11 = safe_div(fmaxf(b, eps), a + lam1);
  const float v12 = safe_div(b, a + lam2);
  const float v13 = b / fmaxf(a, eps);
  const float v31 = safe_div(c, d + lam1);
  const float v32 = safe_div(c, d + lam2);
  const float v33 = fmaxf(c, eps) / fmaxf(d, eps);
  const float d1 = expf(lam1), d2 = expf(lam2);
  const float L21 = v12 / v11, L31 = v13 / v11;
  const float U22 = one - L21 * one;
  const float U23 = v32 - L21 * v31;
  const float L32 = (one - L31 * one) / U22;
  const float U33 = v33 - L31 * v31 - L32 * U23;
  float X[3][3];
  const float rhs[3][3] = {{d1, zero, zero}, {zero, d2, zero},
                           {zero, zero, one}};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float r1 = rhs[q][0], r2 = rhs[q][1], r3 = rhs[q][2];
    const float y2c = r2 - L21 * r1;
    const float y3c = r3 - L31 * r1 - L32 * y2c;
    const float x3 = y3c / U33;
    const float x2 = (y2c - U23 * x3) / U22;
    X[q][0] = (r1 - one * x2 - v31 * x3) / v11;
    X[q][1] = x2;
    X[q][2] = x3;
  }
  const float V[3][3] = {{v11, v12, v13}, {one, one, one}, {v31, v32, v33}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[i][j] = V[i][0] * X[0][j] + V[i][1] * X[1][j] + V[i][2] * X[2][j];
}

struct SwParams {
  int entrap, do_3d;
  float max_cloud_od, inv_min_size, one_minus_overhang, frac_threshold;
};

// the explicit / non-fractal entrapment term, added to `mixed`
// (ops/spartacus_adding.py _explicit_entrapment_k); c is the thread's
// column of a level's staged per-column rows (stride C_TILE)
template <int N>
__device__ __forceinline__ void explicit_entrapment(
    const SwParams& p, const float* __restrict__ c,
    const float (&alb_below)[N][N], const float (&x)[N],
    const float (&um)[N][N], const float (&vm)[N][N], float (&mixed)[N][N]) {
  auto row = [&](int k) { return c[up_row(k) * C_TILE]; };
  const float inv_eff = fminf(row(INVEFF), p.inv_min_size);
  const bool not_top = row(NOTTOP) > 0.5f;
  const float overlap = row(OVP);
  float total[N][N];
#pragma unroll
  for (int j2 = 0; j2 < N; ++j2) {
    const float f_this = row(RF + j2), f_prev = row(RFP + j2);
    float scaling = 1.0f - p.one_minus_overhang * overlap
        * fminf(f_this, f_prev) / fmaxf(f_this, p.frac_threshold);
    if (!not_top) scaling = 0.0f;
    float fwd[N - 1], bwd[N - 1];
#pragma unroll
    for (int j = 0; j < N - 1; ++j) {
      fwd[j] = scaling * row(EDGE + j) / fmaxf(um[j][j2], 1e-5f);
      bwd[j] = scaling * row(EDGE + j) / fmaxf(um[j + 1][j2], 1e-5f);
    }
    const float x2 = x[j2];
    const float fractal = p.entrap == EXPLICIT
        ? 1.0f / sqrtf(fmaxf(2.5f * x2 * inv_eff, 1.0f)) : 1.0f;
    const float a = fwd[0] * x2 * fractal, b = bwd[0] * x2 * fractal;
    float P[N][N];
    if constexpr (N == 3) {
      const float cc = fwd[1] * x2 * fractal, d = bwd[1] * x2 * fractal;
      const float max_entr = fmaxf(a, b + cc);
      const float s = max_entr > p.max_cloud_od
          ? p.max_cloud_od / fmaxf(max_entr, 1e-12f) : 1.0f;
      exchange3(a * s, b * s, cc * s, d * s, P);
    } else {
      const float max_entr = fmaxf(a, b);
      const float s = max_entr > p.max_cloud_od
          ? p.max_cloud_od / fmaxf(max_entr, 1e-12f) : 1.0f;
      exchange2(a * s, b * s, P);
    }
    const float ad = alb_below[j2][j2];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = P[i][j] * vm[j2][j] * ad;
        total[i][j] = j2 == 0 ? v : total[i][j] + v;
      }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mixed[i][j] = mixed[i][j] + total[i][j];
}

// mixing of a below-interface albedo into the layer above
template <int N>
__device__ __forceinline__ void sw_mix(const SwParams& p,
                                       const float* __restrict__ c,
                                       const float (&ab)[N][N],
                                       const float (&x)[N],
                                       const float (&um)[N][N],
                                       const float (&vm)[N][N],
                                       float (&mixed)[N][N]) {
  if (p.entrap == MAXIMUM) {
    float t[N][N];
    mm<N, N, N>(um, ab, t);
    mm<N, N, N>(t, vm, mixed);
    return;
  }
  if (p.entrap == ZERO) {
    float cs[N], d[N];
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
      for (int j = 0; j < N; ++j) mixed[i][j] = i == j ? d[i] : 0.0f;
    return;
  }
  float off[N][N], t[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) off[i][j] = i == j ? 0.0f : ab[i][j];
  mm<N, N, N>(um, off, t);
  mm<N, N, N>(t, vm, mixed);
  if (p.entrap == EDGE_ONLY || !p.do_3d) {
    float dg[N], d[N];
#pragma unroll
    for (int i = 0; i < N; ++i) dg[i] = ab[i][i];
    mvt<N>(vm, dg, d);
#pragma unroll
    for (int i = 0; i < N; ++i) mixed[i][i] = mixed[i][i] + d[i];
  } else {
    explicit_entrapment<N>(p, c, ab, x, um, vm, mixed);
  }
}

template <int N>
__global__ void __launch_bounds__(SW_THREADS, SW_MIN_BLOCKS)
sw_adding_kernel(const float* __restrict__ hist,
                 const float* __restrict__ cols,
                 const float* __restrict__ init_up,
                 const float* __restrict__ direct0, int nlev, int ng,
                 int ncol, SwParams p, float* __restrict__ scratch,
                 float* __restrict__ alb_top, float* __restrict__ albdir_top,
                 float* __restrict__ out) {
  using L = SwStage<N>;
  constexpr int NN = N * N, NH = 5 * NN;
  extern __shared__ __align__(16) float stage_mem[];
  // blocks walk the g-tiles of one column strip before the next strip,
  // so a strip's per-column rows are read from L2 by all but the first
  const int ntiles = (ng + G_TILE - 1) / G_TILE;
  const int g0 = (int)(blockIdx.x % ntiles) * G_TILE;
  const int c0 = (int)(blockIdx.x / ntiles) * C_TILE;
  const int width = min(C_TILE, ncol - c0);
  const size_t m = (size_t)ng * ncol, nc = (size_t)ncol;
  const int tid = threadIdx.x;
  // the arithmetic's cell: g0 + ag, column c0 + ac
  const int ag = tid % G_TILE, ac = tid / G_TILE;
  const bool active = g0 + ag < ng && ac < width;
  const size_t i = active ? (size_t)(g0 + ag) * nc + c0 + ac : 0;
  const int own = slot(ag, ac);
  // the copies' cell
  const int qg = tid / C_TILE, qc = tid % C_TILE;
  const bool qvalid = g0 + qg < ng && qc < width;
  const size_t qi = qvalid ? (size_t)(g0 + qg) * nc + c0 + qc : 0;
  const int qslot = slot(qg, qc);
  auto stage = [&](int s) { return stage_mem + (size_t)s * L::FLOATS; };
  // the per-column rows of level l that a sweep reads, to staged row r
  auto copy_cols = [&](int l, float* sc, bool up) {
    const float* cl = cols + (size_t)l * NCOLROWS * nc + c0;
    const int nrows = up ? UP_COLROWS : DN_COLROWS;
    for (int q = tid; q < nrows * C_TILE; q += SW_THREADS) {
      const int r = q / C_TILE, cc = q % C_TILE;
      const int src = up ? up_src(r) : dn_src(r);
      if (cc < width) copy_async(sc + q, cl + (size_t)src * nc + cc);
    }
  };
  // level l's operands of the upward sweep into stage s
  auto fetch_up = [&](int l, int s) {
    float* st = stage(s);
    if (qvalid) {
      const float* h = hist + (size_t)l * NH * m + qi;
#pragma unroll
      for (int k = 0; k < NH; ++k)
        copy_async(st + k * SW_THREADS + qslot, h + (size_t)k * m);
    }
    copy_cols(l, st + L::UP_H * SW_THREADS, true);
    __pipeline_commit();
  };
  // and of the downward sweep: R, T, TD, TDD and the albedos below
  auto fetch_dn = [&](int l, int s) {
    float* st = stage(s);
    if (qvalid) {
      const float* h = hist + (size_t)l * NH * m + qi;
#pragma unroll
      for (int k = 0; k < 4 * NN; ++k)
        copy_async(st + k * SW_THREADS + qslot,
                   h + (size_t)(k < 2 * NN ? k : k + NN) * m);
      const float* sr = scratch + (size_t)l * 2 * NN * m + qi;
#pragma unroll
      for (int k = 0; k < 2 * NN; ++k)
        copy_async(st + (4 * NN + k) * SW_THREADS + qslot,
                   sr + (size_t)k * m);
    }
    copy_cols(l, st + L::DN_H * SW_THREADS, false);
    __pipeline_commit();
  };
  // the results in rows 0 .. nrows - 1 of stage s to dst's rows, by the
  // copies' mapping (so each scratch value is copied back in the downward
  // sweep by the thread that stored it)
  auto flush = [&](int s, float* dst, int nrows) {
    const float* st = stage(s);
    if (qvalid)
      for (int k = 0; k < nrows; ++k)
        dst[(size_t)k * m + qi] = st[k * SW_THREADS + qslot];
  };
  const bool explicit_x = p.entrap == EXPLICIT || p.entrap == NON_FRACTAL;

  float alb[N][N], albdir[N][N], xd[N], xr[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      alb[a][b] = active ? init_up[(size_t)(a * N + b) * m + i] : 0.0f;
      albdir[a][b] = active ? init_up[(size_t)(NN + a * N + b) * m + i]
                            : 0.0f;
    }
    xd[a] = xr[a] = 0.0f;
  }

  // ---- upward: the total albedos below each layer ----
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nlev) fetch_up(nlev - 1 - j, j);
    else __pipeline_commit();
  }
  for (int j = 0; j < nlev; ++j) {
    // this level's copies have landed, every thread's included, and the
    // level before is complete; its results leave its stage before the
    // stage is refilled
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    if (j > 0) {
      flush((j - 1) % STAGES, scratch + (size_t)(nlev - j) * 2 * NN * m,
            2 * NN);
      __syncthreads();
    }
    const int jn = j + STAGES - 1;
    if (jn < nlev) fetch_up(nlev - 1 - jn, jn % STAGES);
    else __pipeline_commit();
    if (!active) continue;
    float* st = stage(j % STAGES);
    auto H = [&](int k) -> float& { return st[k * SW_THREADS + own]; };
    const float* c = st + L::UP_H * SW_THREADS + ac;
    auto row = [&](int k) { return c[up_row(k) * C_TILE]; };
    float R[N][N], T[N][N], RD[N][N], TD[N][N], TDD[N][N];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = a * N + b;
        R[a][b] = H(k);
        T[a][b] = H(NN + k);
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
    float um[N][N], vm[N][N];
    col_mat<N>(c, C_TILE, up_row(UM), um);
    col_mat<N>(c, C_TILE, up_row(VM), vm);
    const bool is_clear = row(CLEAR) > 0.5f;
    const bool both_clear = is_clear && row(CLEARP) > 0.5f;
    if (explicit_x) {
      // horizontal migration distances (_step_migrations_k)
      const float cf = row(CF), xl_diff = row(XLD), xl_dir = row(XLDIR);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float Rd = R[r][r], Td = T[r][r], RDd = RD[r][r],
                    TDDd = TDD[r][r], TDd = TD[r][r], Ad = alb[r][r],
                    ADd = albdir[r][r];
        const float ms = Td / fmaxf(1.0f - Rd * Ad, 1e-12f);
        const float x_enh = powf(fmaxf(1.0f - Rd * Ad, 1e-12f), -1.5f);
        const float top_alb_dir = fmaxf(RDd + ms * (TDd * Ad + TDDd * ADd),
                                        1e-8f);
        const float x_dir_new = fmaxf(xl_dir + ((TDd * Ad * x_enh
            + TDDd * ADd * (x_enh - 1.0f)) * (xd[r] + xl_diff)
            + TDDd * ADd * (xr[r] + xl_dir)) * Td / top_alb_dir, 0.0f);
        const float top_alb = fmaxf(Rd + ms * Td * Ad, 1e-8f);
        const float x_diff_new = xl_diff + x_enh * Ad * Td * Td
            * (xd[r] + xl_diff) / top_alb;
        const bool act = r == 0 ? cf < 1.0f : cf > 0.0f;
        xd[r] = act ? x_diff_new : 0.0f;
        xr[r] = act ? x_dir_new : 0.0f;
      }
    }
    // [alb_below | albdir_below] = [R | RD] + T (I - alb R)^-1
    //                              [alb T | albdir TDD + alb TD]
    float den[N][N], rhs[N][2 * N], t1[N][N], t2[N][N], t3[N][N];
    one_minus<N>(alb, R, den);
    mm<N, N, N>(alb, T, t1);
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
    float X[N][2 * N], ab[N][N], adb[N][N];
    mm<N, N, 2 * N>(T, rhs, X);
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
      sw_mix<N>(p, c, ab, xd, um, vm, alb);
      sw_mix<N>(p, c, adb, xr, um, vm, albdir);
      if (explicit_x) {
        float y[N];
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
  if (nlev > 0) flush((nlev - 1) % STAGES, scratch, 2 * NN);
  // no thread reads a stage any more
  __syncthreads();

  // ---- downward: the fluxes at the top of each layer ----
  float fdn[N], dir[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    fdn[r] = 0.0f;
    dir[r] = active ? direct0[(size_t)r * m + i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nlev) fetch_dn(j, j);
    else __pipeline_commit();
  }
  for (int l = 0; l < nlev; ++l) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    if (l > 0) {
      flush((l - 1) % STAGES, out + (size_t)(l - 1) * 3 * N * m, 3 * N);
      __syncthreads();
    }
    const int ln = l + STAGES - 1;
    if (ln < nlev) fetch_dn(ln, ln % STAGES);
    else __pipeline_commit();
    if (!active) continue;
    float* st = stage(l % STAGES);
    auto H = [&](int k) -> float& { return st[k * SW_THREADS + own]; };
    const float* c = st + L::DN_H * SW_THREADS + ac;
    float R[N][N], T[N][N], TD[N][N], TDD[N][N], ab[N][N], adb[N][N];
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const int k = a * N + b;
        R[a][b] = H(k);
        T[a][b] = H(NN + k);
        TD[a][b] = H(2 * NN + k);
        TDD[a][b] = H(3 * NN + k);
        ab[a][b] = H(4 * NN + k);
        adb[a][b] = H(5 * NN + k);
      }
    const bool is_clear = c[DN_CLEAR * C_TILE] > 0.5f;
    const bool both_clear = is_clear && c[DN_CLEARN * C_TILE] > 0.5f;
    float src[N], dab[N], tot[N], v1[N], v2[N], den[N][N], rhs[N][1];
    mv<N, N>(TD, dir, src);
    mv<N, N>(TDD, dir, dab);
    one_minus<N>(R, ab, den);
    mv<N, N>(adb, dab, tot);
    mv<N, N>(T, fdn, v1);
    mv<N, N>(R, tot, v2);
#pragma unroll
    for (int r = 0; r < N; ++r) rhs[r][0] = v1[r] + v2[r] + src[r];
    solve<N, 1>(den, rhs);
    float fa[N], fu[N];
#pragma unroll
    for (int r = 0; r < N; ++r) fa[r] = rhs[r][0];
    mv<N, N>(ab, fa, fu);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      fu[r] = fu[r] + tot[r];
      if (is_clear && r > 0) fa[r] = fu[r] = dab[r] = 0.0f;
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
      float vn[N][N];
      col_mat<N>(c, C_TILE, 0, vn);
      mv<N, N>(vn, fa, fdn);
      mv<N, N>(vn, dab, dir);
    }
  }
  __syncthreads();
  if (nlev > 0)
    flush((nlev - 1) % STAGES, out + (size_t)(nlev - 1) * 3 * N * m, 3 * N);
}

// B9's block: LW_G_TILE g-points x C_TILE columns, a ring of LW_STAGES
// levels, at least LW_MIN_BLOCKS blocks per SM (128 registers, 16
// warps). A warp is 32 columns of one g-point, for the copies and the
// arithmetic alike: each thread copies the history and scratch rows of
// its own (g, column) and reads them back itself.
constexpr int LW_G_TILE = 4, LW_THREADS = LW_G_TILE * C_TILE,
              LW_STAGES = 3, LW_MIN_BLOCKS = 4;

// one stage of B9, in floats: the thread's rows at [k][thread] (up: R T
// SU SD; down: R T SD and the scratch below the layer), then the block's
// per-column rows at [row][column] (up: um, vm, clear, clear above; down:
// vm below, clear, clear below). The scratch holds the carry entering
// each level going up: with ML (multilayer effects) the albedo matrix and
// the source (NREG^2 + NREG floats), without it the albedo's diagonal and
// the source (2 NREG): every carry an up step makes is then diagonal.
template <int N, bool ML>
struct LwStage {
  static constexpr int NN = N * N, NS = ML ? NN + N : 2 * N;
  static constexpr int UP_H = 2 * NN + 2 * N, DN_H = 2 * NN + N + NS;
  static constexpr int UP_C = 2 * NN + 2, DN_C = NN + 2;
  static constexpr int UP = UP_H * LW_THREADS + UP_C * C_TILE;
  static constexpr int DN = DN_H * LW_THREADS + DN_C * C_TILE;
  static constexpr int FLOATS = UP > DN ? UP : DN;
  static constexpr size_t BYTES = (size_t)LW_STAGES * FLOATS * sizeof(float);
};
static_assert(LW_MIN_BLOCKS * (LwStage<3, true>::BYTES + 1024)
                  <= 228 * 1024,
              "B9's stages keep LW_MIN_BLOCKS blocks on an SM");

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
template <int N>
__device__ __forceinline__ void staged_mat(const float* __restrict__ c,
                                           int base, float (&o)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o[i][j] = c[(base + i * N + j) * C_TILE];
}

template <int N, bool ML>
__global__ void __launch_bounds__(LW_THREADS, LW_MIN_BLOCKS)
lw_adding_kernel(const float* __restrict__ hist,
                 const float* __restrict__ cols,
                 const float* __restrict__ init_up, int nlev, int ng,
                 int ncol, int use_matrix, float* __restrict__ scratch,
                 float* __restrict__ src_top, float* __restrict__ out) {
  using L = LwStage<N, ML>;
  constexpr int NN = N * N, NH = 2 * N * (N + 1), NS = L::NS;
  extern __shared__ __align__(16) float stage_mem[];
  const int ntiles = (ng + LW_G_TILE - 1) / LW_G_TILE;
  const int g0 = (int)(blockIdx.x % ntiles) * LW_G_TILE;
  const int c0 = (int)(blockIdx.x / ntiles) * C_TILE;
  const int width = min(C_TILE, ncol - c0);
  const size_t m = (size_t)ng * ncol, nc = (size_t)ncol;
  const int tid = threadIdx.x, tc = tid % C_TILE;
  const bool active = g0 + tid / C_TILE < ng && tc < width;
  const size_t i = active ? (size_t)(g0 + tid / C_TILE) * nc + c0 + tc : 0;
  auto stage = [&](int s) { return stage_mem + (size_t)s * L::FLOATS; };
  auto copy_cols = [&](int l, float* sc, bool up) {
    const float* cl = cols + (size_t)l * LW_NCOLROWS * nc + c0;
    const int nrows = up ? L::UP_C : L::DN_C;
    for (int q = tid; q < nrows * C_TILE; q += LW_THREADS) {
      const int r = q / C_TILE, cc = q % C_TILE;
      if (cc < width)
        copy_async(sc + q, cl + (size_t)lw_col_src<N>(r, up) * nc + cc);
    }
  };
  // level l's operands of the upward sweep into stage s: R T SU SD
  auto fetch_up = [&](int l, int s) {
    float* st = stage(s);
    if (active) {
      const float* h = hist + (size_t)l * NH * m + i;
#pragma unroll
      for (int k = 0; k < NH; ++k)
        copy_async(st + k * LW_THREADS + tid, h + (size_t)k * m);
    }
    copy_cols(l, st + L::UP_H * LW_THREADS, true);
    __pipeline_commit();
  };
  // and of the downward sweep: R T SD, then the scratch below the layer
  auto fetch_dn = [&](int l, int s) {
    float* st = stage(s);
    if (active) {
      const float* h = hist + (size_t)l * NH * m + i;
#pragma unroll
      for (int k = 0; k < 2 * NN + N; ++k)
        copy_async(st + k * LW_THREADS + tid,
                   h + (size_t)(k < 2 * NN ? k : k + N) * m);
      const float* sr = scratch + (size_t)l * NS * m + i;
#pragma unroll
      for (int k = 0; k < NS; ++k)
        copy_async(st + (2 * NN + N + k) * LW_THREADS + tid,
                   sr + (size_t)k * m);
    }
    copy_cols(l, st + L::DN_H * LW_THREADS, false);
    __pipeline_commit();
  };

  float alb[N][N], src[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = 0; b < N; ++b)
      alb[a][b] = active ? init_up[(size_t)(a * N + b) * m + i] : 0.0f;
    src[a] = active ? init_up[(size_t)(NN + a) * m + i] : 0.0f;
  }

  // ---- upward: albedos and sources below each layer ----
#pragma unroll
  for (int j = 0; j < LW_STAGES - 1; ++j) {
    if (j < nlev) fetch_up(nlev - 1 - j, j);
    else __pipeline_commit();
  }
  for (int j = 0; j < nlev; ++j) {
    // this level's copies have landed, and every thread is done with the
    // stage the next copies go to
    __pipeline_wait_prior(LW_STAGES - 2);
    __syncthreads();
    const int jn = j + LW_STAGES - 1;
    if (jn < nlev) fetch_up(nlev - 1 - jn, jn % LW_STAGES);
    else __pipeline_commit();
    if (!active) continue;
    const int l = nlev - 1 - j;
    const float* st = stage(j % LW_STAGES);
    auto H = [&](int k) { return st[k * LW_THREADS + tid]; };
    const float* c = st + L::UP_H * LW_THREADS + tc;
    // the carry at entry, for the downward sweep
    float* S = scratch + (size_t)l * NS * m + i;
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
    float R[N][N], T[N][N], SU[N], SD[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        R[a][b] = H(a * N + b);
        T[a][b] = H(NN + a * N + b);
      }
      SU[a] = H(2 * NN + a);
      SD[a] = H(2 * NN + N + a);
    }
    const bool is_clear = c[2 * NN * C_TILE] > 0.5f;
    const bool both_clear = is_clear && c[(2 * NN + 1) * C_TILE] > 0.5f;
    float ab[N][N], sb[N];
    if (use_matrix) {
      // one elimination of I - alb R for [alb T | src + alb SD]
      float den[N][N], rhs[N][N + 1], at[N][N], asd[N], X[N][N];
      one_minus<N>(alb, R, den);
      mm<N, N, N>(alb, T, at);
      mv<N, N>(alb, SD, asd);
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) rhs[a][b] = at[a][b];
        rhs[a][N] = src[a] + asd[a];
      }
      solve<N, N + 1>(den, rhs);
      float Y[N][N], y[N], ty[N];
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) Y[a][b] = rhs[a][b];
        y[a] = rhs[a][N];
      }
      mm<N, N, N>(T, Y, X);
      mv<N, N>(T, y, ty);
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) ab[a][b] = R[a][b] + X[a][b];
        sb[a] = SU[a] + ty[a];
      }
    } else {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const float Rd = R[a][a], Td = T[a][a], Ad = alb[a][a];
        const float inv = 1.0f / (1.0f - Ad * Rd);
#pragma unroll
        for (int b = 0; b < N; ++b) ab[a][b] = 0.0f;
        ab[a][a] = Rd + Td * Td * Ad * inv;
        sb[a] = SU[a] + Td * (src[a] + Ad * SD[a]) * inv;
      }
    }
    if (is_clear) {
      zero_offdiag<N>(ab);
#pragma unroll
      for (int a = 1; a < N; ++a) sb[a] = 0.0f;
    }
    if (both_clear) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
#pragma unroll
        for (int b = 0; b < N; ++b) alb[a][b] = ab[a][b];
        src[a] = sb[a];
      }
    } else {
      float um[N][N], vm[N][N];
      staged_mat<N>(c, 0, um);
      staged_mat<N>(c, NN, vm);
      mv<N, N>(um, sb, src);
      if constexpr (ML) {
        float t[N][N];
        mm<N, N, N>(um, ab, t);
        mm<N, N, N>(t, vm, alb);
      } else {
        float dg[N], d[N];
#pragma unroll
        for (int a = 0; a < N; ++a) dg[a] = ab[a][a];
        mvt<N>(vm, dg, d);
#pragma unroll
        for (int a = 0; a < N; ++a)
#pragma unroll
          for (int b = 0; b < N; ++b) alb[a][b] = a == b ? d[a] : 0.0f;
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
  float fdn[N];
#pragma unroll
  for (int r = 0; r < N; ++r) fdn[r] = 0.0f;
#pragma unroll
  for (int j = 0; j < LW_STAGES - 1; ++j) {
    if (j < nlev) fetch_dn(j, j);
    else __pipeline_commit();
  }
  for (int l = 0; l < nlev; ++l) {
    __pipeline_wait_prior(LW_STAGES - 2);
    __syncthreads();
    const int ln = l + LW_STAGES - 1;
    if (ln < nlev) fetch_dn(ln, ln % LW_STAGES);
    else __pipeline_commit();
    if (!active) continue;
    const float* st = stage(l % LW_STAGES);
    auto H = [&](int k) { return st[k * LW_THREADS + tid]; };
    const float* c = st + L::DN_H * LW_THREADS + tc;
    float R[N][N], T[N][N], SD[N], ab[N][N], sb[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = 0; b < N; ++b) {
        R[a][b] = H(a * N + b);
        T[a][b] = H(NN + a * N + b);
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
                                   : (a == b ? H(2 * NN + N + a) : 0.0f);
      }
      sb[a] = H(2 * NN + N + NS - N + a);
    }
    const bool is_clear = c[NN * C_TILE] > 0.5f;
    const bool both_clear = is_clear && c[(NN + 1) * C_TILE] > 0.5f;
    float fa[N], fu[N];
    if (use_matrix) {
      float den[N][N], v1[N], v2[N], rhs[N][1];
      one_minus<N>(R, ab, den);
      mv<N, N>(T, fdn, v1);
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
        const float Rd = R[a][a], Td = T[a][a], Ad = ab[a][a];
        fa[a] = (Td * fdn[a] + Rd * sb[a] + SD[a]) / (1.0f - Rd * Ad);
        fu[a] = sb[a] + Ad * fa[a];
      }
    }
    if (is_clear) {
#pragma unroll
      for (int a = 1; a < N; ++a) fa[a] = fu[a] = 0.0f;
    }
    if (both_clear) {
#pragma unroll
      for (int a = 0; a < N; ++a) fdn[a] = fa[a];
    } else {
      float vn[N][N];
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
template <int N>
cudaError_t configure_sw() {
  cudaError_t e = cudaFuncSetAttribute(
      sw_adding_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SwStage<N>::BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sw_adding_kernel<N>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// and B9's
template <int N, bool ML>
cudaError_t configure_lw() {
  cudaError_t e = cudaFuncSetAttribute(
      lw_adding_kernel<N, ML>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)LwStage<N, ML>::BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(lw_adding_kernel<N, ML>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, bool ML>
cudaError_t launch_lw(const float* hist, const float* cols,
                      const float* init_up, int nlev, int ng, int ncol,
                      int use_matrix, float* scratch, float* src_top,
                      float* out, cudaStream_t s) {
  cudaError_t e = configure_lw<N, ML>();
  if (e != cudaSuccess) return e;
  // one block per (g-tile, column strip), the g-tiles of a strip adjacent
  const unsigned blocks = (unsigned)((ng + LW_G_TILE - 1) / LW_G_TILE)
      * (unsigned)((ncol + C_TILE - 1) / C_TILE);
  lw_adding_kernel<N, ML><<<blocks, LW_THREADS, LwStage<N, ML>::BYTES, s>>>(
      hist, cols, init_up, nlev, ng, ncol, use_matrix, scratch, src_top,
      out);
  return cudaGetLastError();
}

template <int N, bool ML>
int lw_info(int* info) {
  cudaError_t e = configure_lw<N, ML>();
  if (e != cudaSuccess) return (int)e;
  return kernel_info(lw_adding_kernel<N, ML>, LW_THREADS,
                     LwStage<N, ML>::BYTES, info);
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
  namespace sa = ecrad::spadd;
  if ((size_t)ng * ncol == 0) return (int)cudaGetLastError();
  const sa::SwParams p{entrap, do_3d, max_cloud_od, inv_min_size,
                       one_minus_overhang, frac_threshold};
  cudaStream_t s = (cudaStream_t)stream;
  // one block per (g-tile, column strip), the g-tiles of a strip adjacent
  const unsigned blocks = (unsigned)((ng + sa::G_TILE - 1) / sa::G_TILE)
      * (unsigned)((ncol + sa::C_TILE - 1) / sa::C_TILE);
  cudaError_t e;
  if (nreg == 3) {
    if ((e = sa::configure_sw<3>()) != cudaSuccess) return (int)e;
    sa::sw_adding_kernel<3><<<blocks, sa::SW_THREADS, sa::SwStage<3>::BYTES,
                              s>>>(hist, cols, init_up, direct0, nlev, ng,
                                   ncol, p, scratch, alb_top, albdir_top,
                                   out);
  } else if (nreg == 2) {
    if ((e = sa::configure_sw<2>()) != cudaSuccess) return (int)e;
    sa::sw_adding_kernel<2><<<blocks, sa::SW_THREADS, sa::SwStage<2>::BYTES,
                              s>>>(hist, cols, init_up, direct0, nlev, ng,
                                   ncol, p, scratch, alb_top, albdir_top,
                                   out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B8's compiled resources and the occupancy its launch gets (see
// kernel_info.cuh), for nreg regions
extern "C" int spartacus_sw_adding_info(int nreg, int* info) {
  namespace sa = ecrad::spadd;
  cudaError_t e;
  if (nreg == 3) {
    if ((e = sa::configure_sw<3>()) != cudaSuccess) return (int)e;
    return ecrad::kernel_info(sa::sw_adding_kernel<3>, sa::SW_THREADS,
                              sa::SwStage<3>::BYTES, info);
  }
  if (nreg == 2) {
    if ((e = sa::configure_sw<2>()) != cudaSuccess) return (int)e;
    return ecrad::kernel_info(sa::sw_adding_kernel<2>, sa::SW_THREADS,
                              sa::SwStage<2>::BYTES, info);
  }
  return (int)cudaErrorInvalidValue;
}

// B9; scratch is (nlev, nreg^2 + nreg, ng, ncol) floats with multilayer,
// (nlev, 2 nreg, ng, ncol) without
extern "C" int spartacus_lw_adding(const float* hist, const float* cols,
                                   const float* init_up, int nreg, int nlev,
                                   int ng, int ncol, int use_matrix,
                                   int multilayer, float* scratch,
                                   float* src_top, float* out, void* stream) {
  namespace sa = ecrad::spadd;
  if ((size_t)ng * ncol == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto launch) {
    return (int)launch(hist, cols, init_up, nlev, ng, ncol, use_matrix,
                       scratch, src_top, out, s);
  };
  if (nreg == 3)
    return multilayer ? go(sa::launch_lw<3, true>)
                      : go(sa::launch_lw<3, false>);
  if (nreg == 2)
    return multilayer ? go(sa::launch_lw<2, true>)
                      : go(sa::launch_lw<2, false>);
  return (int)cudaErrorInvalidValue;
}

// B9's compiled resources and the occupancy its launch gets
extern "C" int spartacus_lw_adding_info(int multilayer, int nreg,
                                        int* info) {
  namespace sa = ecrad::spadd;
  if (nreg == 3) return multilayer ? sa::lw_info<3, true>(info)
                                   : sa::lw_info<3, false>(info);
  if (nreg == 2) return multilayer ? sa::lw_info<2, true>(info)
                                   : sa::lw_info<2, false>(info);
  return (int)cudaErrorInvalidValue;
}
