// Kernel B2: all-band RRTMG-IFS shortwave taumol (gas and Rayleigh optical
// depth of 112 g-points for every cell).
//
// Replaces the TPU kernel ecrad_tpu/optics/rrtmg/taumol_sw_fused.py::
// _taumol_sw_fused_flat (:344; pallas_call :400; body sw_fused_body :225),
// which summed the 2-point eta and grid one-hots and multiplied them
// against concatenated bf16-split tables on the MXU. Here the float32
// tables (0.4 MB, L2-resident) are gathered row by row.
//
// What bounds it: per cell it writes 2 x 112 floats (0.9 KB), which set
// the device-memory floor (251 MB at 2048 x 137 cells), and gathers
// ~1,166 table values (144 term slots, a row of ng_b values each), mostly
// from L1 and L2. It runs at about 4x that floor, bound by neither: on
// the card (diagnostic builds, PERF.md) building the terms and writing
// the rows, the issue of the slot loop and the table gathers take about
// a third of its time each.
//
// Design (B1's): a block is a tile of 32 consecutive cells and 4 warps;
// each warp takes a fixed list of bands (c_warp_bands, split by work)
// and, per band,
//   1. builds the band's terms with lane = cell, so the band's switch is
//      warp-uniform; the 20 fields come from the tile's copy in shared
//      memory (each field one 128-byte load per tile), and the terms go to
//      the warp's own slots, (row offset, weight) as a float2 per (slot,
//      lane): 15 slots x 32 cells at most, 3.8 KB a warp;
//   2. sums the band's (cell, g) outputs with lanes on consecutive g of a
//      cell, ng_b outputs a lane at once (one shared load and one gather
//      per slot and output, in slot order), into the tile's rows in shared
//      memory.
// Only __syncwarp orders the phases; at the end the block writes the
// tile's 32 rows of taug and of taur, each one contiguous run, 16 bytes a
// thread. 47 KB of shared memory a block: 4 blocks (16 warps) per SM. The
// solar source stays in PyTorch (it selects one layer per column).
//
// The kernel is a template on the scalar type. Its double form
// (taumol_sw_f64) is the float64 path's: the tables, the fields, the terms'
// weights and the sums in double. Its tile's rows and term slots double in
// bytes: 93 KB a block, two blocks (8 warps) per SM.
//
// Semantics: optics/rrtmg/taumol_sw.py (`sw_terms`), term for term.
#include "kernel_info.cuh"
#include "taumol_common.cuh"

namespace ecrad {
namespace sw {

enum F {
  TROPF, FAC00, FAC10, FAC01, FAC11, SELFFAC, SELFFRAC, FORFAC, FORFRAC,
  COLH2O, COLCO2, COLO3, COLCH4, COLO2, COLMOL, NF
};
enum I { JP, JT, JT1, INDSELF, INDFOR, NI };

// table ids: band tables at 14 * kind + band - 16 (fused_tables.SW_KINDS),
// then the named tables (fused_tables.SW_NAMED, same order)
__device__ __forceinline__ int ABSA(int b) { return b - 16; }
__device__ __forceinline__ int ABSB(int b) { return 14 + b - 16; }
__device__ __forceinline__ int SELF(int b) { return 28 + b - 16; }
__device__ __forceinline__ int FOR(int b) { return 42 + b - 16; }
__device__ __forceinline__ int RAYL(int b) { return 56 + b - 16; }
enum Named {
  SW20_ABSCH4 = 70, SW22_ONES, SW24_ABSO3A, SW24_ABSO3B, SW25_ABSO3A,
  SW25_ABSO3B, SW29_ABSCO2, SW29_ABSH2O, SW24_RAYLB, NTAB
};
// body constants: strrat of band b at b - 16, then givfac23
constexpr int GIVFAC23 = 14, NC = 15;
template <typename T>
__device__ __forceinline__ T o2adj() {
  return ECRAD_LIT(1.6);
}

constexpr int NG = 112;
__constant__ int c_ng[14] = {6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12};
__constant__ int c_goff[15] = {0, 6, 18, 26, 34, 44, 54, 56, 66, 74, 80,
                               86, 94, 100, 112};
// term slots per band (taumol_sw.py K_TAUG / K_TAUR) as prefix sums
__constant__ int c_ktaug[15] = {0, 12, 24, 36, 48, 57, 69, 82, 90, 103,
                                108, 108, 112, 120, 129};
__constant__ int c_ktaur[15] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13,
                                14, 15};
// B2's block: one tile of TILE_SW cells (a warp's lanes in phase 1),
// NWARP_SW warps. Warp w takes the bands of row w of c_warp_bands, in
// order (0 ends a row): the 14 bands split by work, ng_b (K_TAUG_b +
// K_TAUR_b) per cell, 286, 294, 292 and 294 of 1166
// (tests/test_torch_taumol_design.py checks the split).
constexpr int TILE_SW = TILE_CELLS, NWARP_SW = 4;
constexpr int THREADS_SW = TILE_SW * NWARP_SW;
constexpr int BANDS_PER_WARP_SW = 5;
__constant__ signed char c_warp_bands[NWARP_SW][BANDS_PER_WARP_SW] = {
    {17, 21, 0, 0, 0}, {24, 29, 28, 0, 0}, {18, 19, 16, 26, 0},
    {20, 23, 27, 25, 22}};
// the most term slots of one band (band 24: 13 taug + 2 taur)
constexpr int K_BAND_MAX_SW = 15;
// blocks per SM the launch asks for (the shared-memory carveout is set
// for them, the rest of the SM's 256 KB is L1 for the tables); the double
// form's block takes 93 KB, so two
constexpr int BLOCKS_PER_SM_SW = 4, F64_BLOCKS_PER_SM_SW = 2;
template <typename T>
constexpr int blocks_per_sm_sw() {
  return sizeof(T) == 4 ? BLOCKS_PER_SM_SW : F64_BLOCKS_PER_SM_SW;
}

// one cell's inputs, staged in shared memory, and the derived quantities
// every band shares
template <typename T>
struct Cell {
  const T* fcp;        // the staged fields + lane: field k at
  const int* icp;      // fcp[k * TILE_SW]
  bool tropo;
  int grid0, grid1, grid0b, grid1b;
  const T* kc;

  __device__ __forceinline__ T F(int k) const { return fcp[k * TILE_SW]; }
  __device__ __forceinline__ int I(int k) const { return icp[k * TILE_SW]; }

  __device__ void eta_cols(int b, T& col1, T& col2) const {
    col1 = F(COLH2O);
    if (b == 16 || b == 18) col2 = F(COLCH4);
    else if (b == 17 || b == 19 || b == 21) col2 = F(COLCO2);
    else if (b == 22) col2 = o2adj<T>() * F(COLO2);
    else if (b == 24) col2 = F(COLO2);
    else { col1 = F(COLO3); col2 = F(COLO2); }    // band 28
  }
  __device__ int corner(int j, bool strat) const {
    int g0 = strat ? grid0b : grid0, g1 = strat ? grid1b : grid1;
    return j == 0 ? g0 : j == 1 ? g0 + 1 : j == 2 ? g1 : g1 + 1;
  }
  __device__ T fac(int j) const { return F(FAC00 + j); }

  __device__ void noeta(WarpTerms<T>& t, int b, bool strat, T w) const {
    int tab = strat ? ABSB(b) : ABSA(b);
    for (int j = 0; j < 4; ++j)
      t.put(tab, c_ng[b - 16], corner(j, strat), w * fac(j));
  }
  // binary-species lookup, 4 grid corners x 2 eta rows
  __device__ void eta(WarpTerms<T>& t, int b, bool strat) const {
    T col1, col2;
    eta_cols(b, col1, col2);
    T sc = col1 + kc[b - 16] * col2;
    T sp, fs;
    int js;
    eta_index(col1, sc, strat ? ECRAD_LIT(4.0) : ECRAD_LIT(8.0), sp, js, fs);
    int tab = strat ? ABSB(b) : ABSA(b);
    int ngrid = strat ? 235 : 65, neta = strat ? 5 : 9;
    for (int j = 0; j < 4; ++j) {
      int g = corner(j, strat);
      T gw = fac(j);
      for (int eo = 0; eo < 2; ++eo) {
        int e = js + eo;
        bool ok = g >= 0 && g < ngrid && e >= 0 && e < neta;
        t.put(tab, c_ng[b - 16], g * neta + e,
              sc * gw * (eo ? fs : ECRAD_LIT(1.0) - fs), ok);
      }
    }
  }
  __device__ void self_for(WarpTerms<T>& t, int b) const {
    bool ungated = b == 17 || b == 20 || b == 21;
    t.pair(SELF(b), c_ng[b - 16], I(INDSELF) - 1, F(TROPF) * F(SELFFAC),
           F(SELFFRAC));
    t.pair(FOR(b), c_ng[b - 16], I(INDFOR) - 1,
           ungated ? F(FORFAC) : F(FORFAC) * F(TROPF), F(FORFRAC));
  }
  __device__ void cst(WarpTerms<T>& t, int tab, int b, T w) const {
    t.put(tab, c_ng[b - 16], 0, w);
  }
};

// Phase 1 for band b (16..29): taug terms into `tg`, taur terms into `tr_`.
template <typename T>
__device__ void band_terms(const Cell<T>& c, int b, WarpTerms<T>& tg,
                           WarpTerms<T>& tr_) {
  const bool tr = c.tropo;
  switch (b) {
    case 16: case 18: case 19:
      if (tr) {
        c.eta(tg, b, false);
      } else {
        c.noeta(tg, b, true, b == 19 ? c.F(COLCO2) : c.F(COLCH4));
        tg.zeros(4);
      }
      c.self_for(tg, b);
      break;
    case 17: case 21:
      c.eta(tg, b, !tr);
      c.self_for(tg, b);
      break;
    case 20:
      c.noeta(tg, 20, !tr, c.F(COLH2O));
      c.self_for(tg, 20);
      c.cst(tg, SW20_ABSCH4, 20, c.F(COLCH4));
      break;
    case 22:
      if (tr) {
        c.eta(tg, 22, false);
      } else {
        c.noeta(tg, 22, true, o2adj<T>() * c.F(COLO2));
        tg.zeros(4);
      }
      c.self_for(tg, 22);
      c.cst(tg, SW22_ONES, 22,
            ECRAD_LIT(4.35e-4) * c.F(COLO2)
                / (ECRAD_LIT(350.0) * ECRAD_LIT(2.0)));
      break;
    case 23:
      if (tr)
        c.noeta(tg, 23, false, c.kc[GIVFAC23] * c.F(COLH2O));
      else
        tg.zeros(4);
      c.self_for(tg, 23);
      break;
    case 24:
      if (tr) {
        c.eta(tg, 24, false);
      } else {
        c.noeta(tg, 24, true, c.F(COLO2));
        tg.zeros(4);
      }
      c.self_for(tg, 24);
      c.cst(tg, tr ? SW24_ABSO3A : SW24_ABSO3B, 24, c.F(COLO3));
      break;
    case 25:
      if (tr)
        c.noeta(tg, 25, false, c.F(COLH2O));
      else
        tg.zeros(4);
      c.cst(tg, tr ? SW25_ABSO3A : SW25_ABSO3B, 25, c.F(COLO3));
      break;
    case 26:
      break;
    case 27:
      c.noeta(tg, 27, !tr, c.F(COLO3));
      break;
    case 28:
      c.eta(tg, 28, !tr);
      break;
    case 29:
      c.noeta(tg, 29, !tr, tr ? c.F(COLH2O) : c.F(COLCO2));
      c.self_for(tg, 29);
      c.cst(tg, tr ? SW29_ABSCO2 : SW29_ABSH2O, 29,
            tr ? c.F(COLCO2) : c.F(COLH2O));
      break;
  }
  // Rayleigh: per-g coefficient x colmol; band 24 eta-interpolated in the
  // troposphere
  if (b == 24 && tr) {
    T col1, col2, sp, fs;
    int js;
    c.eta_cols(24, col1, col2);
    eta_index(col1, col1 + c.kc[24 - 16] * col2, ECRAD_LIT(8.0), sp, js, fs);
    tr_.pair(RAYL(24), 8, js, c.F(COLMOL), fs);
  } else {
    c.cst(tr_, b == 24 ? SW24_RAYLB : RAYL(b), b, c.F(COLMOL));
  }
}

// Phase 2 of a band of NGB g-points: the lane's outputs are the pairs
// (cell, g) = it * TILE_SW + lane of the tile's TILE_SW x NGB, it < NGB,
// all summed together, so a slot's gathers are independent loads in
// flight at once. Each output is the sum over the slots in order of w_k
// tab[row_k + g], taug over slots 0 .. kt - 1 and taur over kt .. kt + kr
// - 1.
template <typename T, int NGB>
__device__ __forceinline__ void band_outputs(
    const T* __restrict__ tab, const typename TermSlot<T>::type* terms,
    int lane, int g0, int kt, int kr, T (*out)[TILE_SW][NG]) {
  using S = TermSlot<T>;
  int cl[NGB];
  const T* tg[NGB];
#pragma unroll
  for (int it = 0; it < NGB; ++it) {
    const int p = it * TILE_SW + lane;
    cl[it] = p / NGB;
    tg[it] = tab + p % NGB;
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int k0 = part ? kt : 0, k1 = part ? kt + kr : kt;
    T acc[NGB];
#pragma unroll
    for (int it = 0; it < NGB; ++it) acc[it] = ECRAD_LIT(0.0);
    for (int k = k0; k < k1; ++k) {
      const typename S::type* t = terms + k * TILE_SW;
#pragma unroll
      for (int it = 0; it < NGB; ++it) {
        const typename S::type e = t[cl[it]];
        acc[it] += S::w(e) * __ldg(tg[it] + S::off(e));
      }
    }
#pragma unroll
    for (int it = 0; it < NGB; ++it) {
      const int p = it * TILE_SW + lane;
      out[part][cl[it]][g0 + p % NGB] = acc[it];
    }
  }
}

template <typename T>
struct __align__(16) SharedSw {
  T out[2][TILE_SW][NG];              // the tile's taug and taur rows
  typename TermSlot<T>::type terms[NWARP_SW][K_BAND_MAX_SW * TILE_SW];
  T f[NF][TILE_SW];                   // the tile's fields
  int i[NI][TILE_SW];
  int toff[NTAB], tnrows[NTAB];       // table offsets and row counts
  T kc[NC];                           // body constants
};

template <typename T>
__global__ void __launch_bounds__(THREADS_SW, blocks_per_sm_sw<T>())
taumol_sw_kernel(const T* __restrict__ fc, const int* __restrict__ ic,
                 const T* __restrict__ tab, const int* __restrict__ meta,
                 const T* __restrict__ kc, int n,
                 T* __restrict__ taug, T* __restrict__ taur) {
  extern __shared__ __align__(16) unsigned char smem_sw[];
  SharedSw<T>& sh = *reinterpret_cast<SharedSw<T>*>(smem_sw);
  const int warp = threadIdx.x / TILE_SW, lane = threadIdx.x % TILE_SW;
  const int pos0 = blockIdx.x * TILE_SW;
  const bool my_live = pos0 + lane < n;
  // stage the table offsets, the body constants and the tile's fields
  // (warp w loads fields w, w + NWARP_SW, ...: one 128-byte run each, all
  // in flight together)
  for (int q = threadIdx.x; q < 2 * NTAB; q += THREADS_SW)
    (q < NTAB ? sh.toff[q] : sh.tnrows[q - NTAB]) = meta[q];
  if (threadIdx.x < NC) sh.kc[threadIdx.x] = kc[threadIdx.x];
  {
    constexpr int ROUNDS = (NF + NI + NWARP_SW - 1) / NWARP_SW;
    T v[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = warp + r * NWARP_SW;
      v[r] = ECRAD_LIT(0.0);
      if (my_live && k < NF)
        v[r] = fc[(size_t)k * n + pos0 + lane];
      else if (my_live && k < NF + NI)
        v[r] = int_bits(ic[(size_t)(k - NF) * n + pos0 + lane], T());
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = warp + r * NWARP_SW;
      if (k < NF)
        sh.f[k][lane] = v[r];
      else if (k < NF + NI)
        sh.i[k - NF][lane] = bits_int(v[r]);
    }
  }
  __syncthreads();

  typename TermSlot<T>::type* terms = sh.terms[warp];
  Cell<T> c;
  c.fcp = &sh.f[0][lane];
  c.icp = &sh.i[0][lane];
  c.kc = sh.kc;
  {
    const int jp = c.I(JP), jt = c.I(JT), jt1 = c.I(JT1);
    c.tropo = c.F(TROPF) > ECRAD_LIT(0.0);
    c.grid0 = (jp - 1) * 5 + (jt - 1);
    c.grid1 = jp * 5 + (jt1 - 1);
    c.grid0b = (jp - 13) * 5 + (jt - 1);
    c.grid1b = (jp - 12) * 5 + (jt1 - 1);
  }
  for (int j = 0; j < BANDS_PER_WARP_SW; ++j) {
    const int b = c_warp_bands[warp][j];
    if (b == 0) break;
    const int bi = b - 16;
    const int kt = c_ktaug[bi + 1] - c_ktaug[bi];
    const int kr = c_ktaur[bi + 1] - c_ktaur[bi];
    // phase 1: lane = cell, band b's terms (the switch is warp-uniform);
    // a lane past the last cell writes zero terms
    WarpTerms<T> t_g{terms + lane, 0, sh.toff, sh.tnrows};
    WarpTerms<T> t_r{terms + lane, kt, sh.toff, sh.tnrows};
    if (my_live) band_terms(c, b, t_g, t_r);
    t_g.zeros(kt - t_g.k);
    t_r.zeros(kt + kr - t_r.k);
    __syncwarp();
    // phase 2: lanes over the tile's (cell, g) pairs of band b
    const int g0 = c_goff[bi];
    switch (c_ng[bi]) {
#define ECRAD_SW_BAND_OUTPUTS(NGB)                                          \
  case NGB:                                                                 \
    band_outputs<T, NGB>(tab, terms, lane, g0, kt, kr, sh.out);            \
    break;
      ECRAD_SW_BAND_OUTPUTS(2) ECRAD_SW_BAND_OUTPUTS(6)
      ECRAD_SW_BAND_OUTPUTS(8) ECRAD_SW_BAND_OUTPUTS(10)
      ECRAD_SW_BAND_OUTPUTS(12)
#undef ECRAD_SW_BAND_OUTPUTS
    }
    // every lane is done with the slots before the next band's terms
    __syncwarp();
  }
  // the tile's rows out: for each output one run of up to 32 x 112
  // values, 16 bytes a thread
  __syncthreads();
  using V = typename Vec16<T>::type;
  constexpr int PER = 16 / sizeof(T);
  const int live4 = (min(n - pos0, TILE_SW) * NG) / PER;
  const V* out4 = reinterpret_cast<const V*>(sh.out);
  V* taug4 = reinterpret_cast<V*>(taug + (size_t)pos0 * NG);
  V* taur4 = reinterpret_cast<V*>(taur + (size_t)pos0 * NG);
#pragma unroll
  for (int q = threadIdx.x; q < TILE_SW * NG / PER; q += THREADS_SW) {
    if (q < live4) {
      taug4[q] = out4[q];
      taur4[q] = out4[TILE_SW * NG / PER + q];
    }
  }
}

}  // namespace sw
}  // namespace ecrad

// B2's dynamic shared memory, and the carveout, in percent of the SM's
// 228 KB, that holds blocks_per_sm_sw blocks and the 1 KB each reserves
template <typename T>
static cudaError_t sw_attributes() {
  using namespace ecrad::sw;
  const int per_block = (int)sizeof(SharedSw<T>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      taumol_sw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(SharedSw<T>));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      taumol_sw_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (blocks_per_sm_sw<T>() * per_block * 100 + 228 * 1024 - 1)
          / (228 * 1024));
}

template <typename T>
static int taumol_sw_launch(const T* fc, const int* ic, const T* tab,
                            const int* meta, const T* consts, int n, T* taug,
                            T* taur, void* stream) {
  using namespace ecrad;
  if (n > 0) {
    cudaError_t e = sw_attributes<T>();
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + sw::TILE_SW - 1) / sw::TILE_SW;
    sw::taumol_sw_kernel<T><<<blocks, sw::THREADS_SW, sizeof(sw::SharedSw<T>),
                              (cudaStream_t)stream>>>(fc, ic, tab, meta,
                                                      consts, n, taug, taur);
  }
  return (int)cudaGetLastError();
}

// B2's resources and the blocks per SM its launch gets (kernel_info.cuh)
template <typename T>
static int taumol_sw_info_of(int* info) {
  using namespace ecrad;
  cudaError_t e = sw_attributes<T>();
  if (e != cudaSuccess) return (int)e;
  return kernel_info(sw::taumol_sw_kernel<T>, sw::THREADS_SW,
                     sizeof(sw::SharedSw<T>), info);
}

extern "C" int taumol_sw(const float* fc, const int* ic, const float* tab,
                         const int* meta, const float* consts, int n,
                         float* taug, float* taur, void* stream) {
  return taumol_sw_launch<float>(fc, ic, tab, meta, consts, n, taug, taur,
                                 stream);
}

// the double form, the float64 path's: the tables, fields and outputs in
// double
extern "C" int taumol_sw_f64(const double* fc, const int* ic,
                             const double* tab, const int* meta,
                             const double* consts, int n, double* taug,
                             double* taur, void* stream) {
  return taumol_sw_launch<double>(fc, ic, tab, meta, consts, n, taug, taur,
                                  stream);
}

extern "C" int taumol_sw_info(int* info) {
  return taumol_sw_info_of<float>(info);
}
extern "C" int taumol_sw_info_f64(int* info) {
  return taumol_sw_info_of<double>(info);
}
