// Kernel B1: all-band RRTMG-IFS longwave taumol (optical depth and Planck
// fraction of 140 g-points for every cell).
//
// Replaces the TPU kernel ecrad_tpu/optics/rrtmg/taumol_lw_fused.py::
// _taumol_lw_fused_flat (:832; pallas_call :896; body lw_fused_body :512),
// which evaluated the k-table lookups as one-hot MXU matmuls against
// concatenated tables split into bf16 [hi|lo|hi] parts. On the H100 the
// tables (0.6 MB as float32) stay in device memory and live in the 50 MB
// L2, and each lookup is a direct float32 row gather.
//
// What bounds it: per cell it writes 2 x 140 floats (1.1 KB), which set
// the device-memory floor (314 MB at 2048 x 137 cells), and gathers ~2,430
// table values (266 term slots, a row of ng_b values each), mostly from
// L1 and L2. It runs well above that floor, bound by neither bytes nor
// the table gathers but by the issue and latency of its slot loops (a
// warp runs one band's code at a time, so nothing diverges by band).
// Writing a band's outputs straight to the (N, 140) rows, in runs of ng_b
// floats (partial sectors), would cost about as much as the whole kernel,
// hence the rows staged in shared memory.
//
// Design: a block is a tile of 32 consecutive cells and 4 warps; each warp
// takes a fixed list of bands (c_warp_bands, split by work) and, per band,
//   1. builds the band's terms with lane = cell, so the band's switch is
//      warp-uniform; the fields come from the tile's copy in shared memory
//      (each field one 128-byte load per tile), and the terms go to the
//      warp's own slots, (row offset, weight) as a float2 per (slot, lane):
//      23 slots x 32 cells at most, 5.9 KB a warp;
//   2. sums the band's (cell, g) outputs with lanes on consecutive g of a
//      cell, up to 12 outputs a lane at once (one shared load and one
//      gather per slot and output, in slot order), into the tile's rows
//      in shared memory.
// Only __syncwarp orders the phases; at the end the block writes the
// tile's 32 rows of tau and of pfrac, each one contiguous run, 16 bytes a
// thread. 66 KB of shared memory a block: 3 blocks (12 warps) per SM.
//
// The kernel is a template on the scalar type. Its double form
// (taumol_lw_f64) is the float64 path's: the tables, the fields, the terms'
// weights and the sums in double. Its tile's rows and term slots double in
// bytes: 131 KB a block, one block (4 warps) per SM. Its floor is its 2 x
// 140 double stores per cell; it has no exp in its sums, only one in
// chi_adjust per minor gas, so double costs it bytes and latency.
//
// Semantics: optics/rrtmg/taumol_lw.py (`lw_terms`), term for term.
#include "kernel_info.cuh"
#include "taumol_common.cuh"

namespace ecrad {
namespace lw {

enum F {
  TROPF, FAC00, FAC10, FAC01, FAC11, SELFFAC, SELFFRAC, FORFAC, FORFRAC,
  MINORFRAC, SCALEMINOR, SCALEMINORN2, COLH2O, COLCO2, COLO3, COLN2O,
  COLCH4, COLO2, COLBRD, COLDRY, RAT_H2OCO2, RAT_H2OCO2_1, RAT_H2OO3,
  RAT_H2OO3_1, RAT_H2ON2O, RAT_H2ON2O_1, RAT_H2OCH4, RAT_H2OCH4_1,
  RAT_N2OCO2, RAT_N2OCO2_1, RAT_O3CO2, RAT_O3CO2_1, PAVEL, WX_CCL4,
  WX_CFC11, WX_CFC12, WX_CFC22, CHI_CO2, CHI_N2O, NF
};
enum I { JP, JT, JT1, INDSELF, INDFOR, INDMINOR, NI };

// table ids: band tables at 16 * kind + band - 1, then the named tables
// (fused_tables.LW_KINDS and fused_tables.LW_NAMED, same order)
__device__ __forceinline__ int ABSA(int b) { return b - 1; }
__device__ __forceinline__ int ABSB(int b) { return 16 + b - 1; }
__device__ __forceinline__ int SELF(int b) { return 32 + b - 1; }
__device__ __forceinline__ int FOR(int b) { return 48 + b - 1; }
__device__ __forceinline__ int PFA(int b) { return 64 + b - 1; }
__device__ __forceinline__ int PFB(int b) { return 80 + b - 1; }
enum Named {
  LW1_KAO_MN2 = 96, LW1_KBO_MN2, LW3_KAO_MN2O, LW3_KBO_MN2O, LW5_KAO_MO3,
  LW6_KAO_MCO2, LW7_KAO_MCO2, LW7_KBO_MCO2, LW8_KAO_MCO2, LW8_KBO_MCO2,
  LW8_KAO_MO3, LW8_KAO_MN2O, LW8_KBO_MN2O, LW9_KAO_MN2O, LW9_KBO_MN2O,
  LW11_KAO_MO2, LW11_KBO_MO2, LW13_KAO_MCO2, LW13_KBO_MO3, LW15_KAO_MN2,
  LW5_CCL4, LW6_CFC11ADJ, LW6_CFC12, LW8_CFC12, LW8_CFC22ADJ, NTAB
};
// body constants (fused_tables.LW_CONSTS order)
enum C {
  B3_REFM_A, B3_REFM_B, B5_REFM_A, B7_REFM_A, B9_REFM_A, B13_REFM_A,
  B15_REFM_A, PF3_A, PF3_B, PF4_A, PF4_B, PF5_A, PF5_B, PF7_A, PF9_A,
  PF12_A, PF13_A, PF15_A, PF16_A, NC
};

constexpr int NG = 140;
__constant__ int c_ng[16] = {10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4,
                             2, 2, 2};
__constant__ int c_goff[17] = {0, 10, 22, 38, 52, 68, 76, 88, 96, 108, 114,
                               122, 130, 134, 136, 138, 140};
// term slots per band (taumol_lw.py K_TAU / K_PF) as prefix sums
__constant__ int c_ktau[17] = {0, 10, 18, 38, 54, 75, 87, 107, 123, 143,
                               151, 161, 177, 197, 205, 225, 241};
__constant__ int c_kpf[17] = {0, 1, 2, 4, 6, 8, 9, 11, 12, 14, 15, 16, 18,
                              20, 21, 23, 25};
// B1's block: one tile of TILE_LW cells (a warp's lanes in phase 1),
// NWARP_LW warps. Warp w takes the bands of row w of c_warp_bands, in
// order (0 ends a row): the 16 bands split by work, ng_b (K_TAU_b +
// K_PF_b) + 4 (K_TAU_b + K_PF_b) per cell, 880, 896, 862 and 856 of 3494
// (tests/test_torch_taumol_design.py checks the split).
constexpr int TILE_LW = TILE_CELLS, NWARP_LW = 4;
constexpr int THREADS_LW = TILE_LW * NWARP_LW;
constexpr int BANDS_PER_WARP = 5;
__constant__ signed char c_warp_bands[NWARP_LW][BANDS_PER_WARP] = {
    {5, 13, 1, 10, 0}, {3, 8, 2, 16, 0}, {7, 4, 11, 14, 0},
    {9, 12, 6, 15, 0}};
// the most term slots of one band (band 5: 21 tau + 2 pfrac)
constexpr int K_BAND_MAX = 23;
// blocks per SM the launch asks for (the shared-memory carveout is set
// for them, the rest of the SM's 256 KB is L1 for the tables); the double
// form's block takes 131 KB, so one
constexpr int BLOCKS_PER_SM_LW = 3, F64_BLOCKS_PER_SM_LW = 1;
template <typename T>
constexpr int blocks_per_sm_lw() {
  return sizeof(T) == 4 ? BLOCKS_PER_SM_LW : F64_BLOCKS_PER_SM_LW;
}

template <typename T>
__device__ __forceinline__ T chi_adjust(T col, T coldry, T ref, T thresh,
                                        T base, T expo) {
  T rat = ECRAD_LIT(1.0e20) * (col / coldry) / ref;
  T base_p = mmax(rat - base, ECRAD_LIT(1e-30));
  T adjcol = (base + mexp(expo * mlog(base_p))) * ref * coldry
             * ECRAD_LIT(1.0e-20);
  return rat > thresh ? adjcol : col;
}

// one cell's inputs, staged in shared memory, and the derived quantities
// every band shares
template <typename T>
struct Cell {
  const T* fcp;    // the staged fields + lane: field k at fcp[k * TILE_LW]
  const int* icp;
  bool tropo;
  int grid0, grid1, grid0b, grid1b;
  const T* kc;

  __device__ __forceinline__ T F(int k) const {
    return fcp[k * TILE_LW];
  }
  __device__ __forceinline__ int I(int k) const { return icp[k * TILE_LW]; }

  __device__ void major_noeta(WarpTerms<T>& t, int tab, int ng, bool strat,
                              T w) const {
    int g0 = strat ? grid0b : grid0, g1 = strat ? grid1b : grid1;
    t.put(tab, ng, g0, w * F(FAC00));
    t.put(tab, ng, g0 + 1, w * F(FAC10));
    t.put(tab, ng, g1, w * F(FAC01));
    t.put(tab, ng, g1 + 1, w * F(FAC11));
  }

  // tropospheric binary-species lookup, 2 families x 2 corners x 3 etas
  __device__ void major_eta3(WarpTerms<T>& t, int b, T col1, T col2,
                             T rat0, T rat1) const {
    int ng = c_ng[b - 1];
    for (int fam = 0; fam < 2; ++fam) {
      int g = fam ? grid1 : grid0;
      T fa = fam ? F(FAC01) : F(FAC00);
      T fb = fam ? F(FAC11) : F(FAC10);
      T sc = col1 + (fam ? rat1 : rat0) * col2;
      T sp, fs;
      int js;
      eta_index(col1, sc, ECRAD_LIT(8.0), sp, js, fs);
      T p_lo = fs - ECRAD_LIT(1.0);
      T p2 = p_lo * p_lo;
      T p4_lo = p2 * p2;
      T p_hi = -fs;
      p2 = p_hi * p_hi;
      T p4_hi = p2 * p2;
      bool lo = sp < ECRAD_LIT(0.125), hi = sp > ECRAD_LIT(0.875);
      T ew[3];
      ew[0] = lo ? p4_lo : (hi ? p_hi + p4_hi : ECRAD_LIT(1.0) - fs);
      ew[1] = lo ? ECRAD_LIT(1.0) - p_lo - ECRAD_LIT(2.0) * p4_lo
                 : (hi ? ECRAD_LIT(1.0) - p_hi - ECRAD_LIT(2.0) * p4_hi : fs);
      ew[2] = lo ? p_lo + p4_lo : (hi ? p4_hi : ECRAD_LIT(0.0));
      int e0 = hi ? js - 1 : js;
      for (int go = 0; go < 2; ++go) {
        int gg = g + go;
        T gw = go ? fb : fa;
        for (int eo = 0; eo < 3; ++eo) {
          int e = e0 + eo;
          bool ok = gg >= 0 && gg < 65 && e >= 0 && e < 9;
          t.put(ABSA(b), ng, gg * 9 + e, sc * gw * ew[eo], ok);
        }
      }
    }
  }

  // stratospheric binary-species lookup, 2 families x 2 corners x 2 etas
  __device__ void major_eta2(WarpTerms<T>& t, int b, T col1, T col2,
                             T rat0, T rat1) const {
    int ng = c_ng[b - 1];
    for (int fam = 0; fam < 2; ++fam) {
      int g = fam ? grid1b : grid0b;
      T fa = fam ? F(FAC01) : F(FAC00);
      T fb = fam ? F(FAC11) : F(FAC10);
      T sc = col1 + (fam ? rat1 : rat0) * col2;
      T sp, fs;
      int js;
      eta_index(col1, sc, ECRAD_LIT(4.0), sp, js, fs);
      for (int go = 0; go < 2; ++go) {
        int gg = g + go;
        T gw = go ? fb : fa;
        for (int eo = 0; eo < 2; ++eo) {
          int e = js + eo;
          bool ok = gg >= 0 && gg < 235 && e >= 0 && e < 5;
          t.put(ABSB(b), ng, gg * 5 + e,
                sc * gw * (eo ? fs : ECRAD_LIT(1.0) - fs), ok);
        }
      }
    }
  }

  __device__ void self_(WarpTerms<T>& t, int b) const {
    t.pair(SELF(b), c_ng[b - 1], I(INDSELF) - 1, F(TROPF) * F(SELFFAC),
           F(SELFFRAC));
  }
  __device__ void for_(WarpTerms<T>& t, int b) const {
    t.pair(FOR(b), c_ng[b - 1], I(INDFOR) - 1, F(FORFAC), F(FORFRAC));
  }
  __device__ void for_(WarpTerms<T>& t, int b, T w) const {
    t.pair(FOR(b), c_ng[b - 1], I(INDFOR) - 1, F(FORFAC) * w, F(FORFRAC));
  }
  __device__ void gated_for(WarpTerms<T>& t, int b) const {
    for_(t, b, F(TROPF));
  }
  __device__ void minor(WarpTerms<T>& t, int tab, int b, T w) const {
    t.pair(tab, c_ng[b - 1], I(INDMINOR) - 1, w, F(MINORFRAC));
  }
  // minor gas with eta dependence, table (r1, 19, ng)
  __device__ void minor_eta(WarpTerms<T>& t, int tab, int b, int r1,
                            T col1, T refm, T col2, T mult,
                            T w) const {
    T sp, fm;
    int jm;
    eta_index(col1, col1 + refm * col2, mult, sp, jm, fm);
    T mfrac = F(MINORFRAC);
    for (int jo = 0; jo < 2; ++jo) {
      int j = jm + jo;
      bool ok = j >= 0 && j < r1;
      T bw = jo ? fm : ECRAD_LIT(1.0) - fm;
      for (int io = 0; io < 2; ++io) {
        int r = I(INDMINOR) - 1 + io;
        T mw = io ? mfrac : ECRAD_LIT(1.0) - mfrac;
        t.put(tab, c_ng[b - 1], j * 19 + r, w * bw * mw, ok);
      }
    }
  }
  __device__ void pf_eta(WarpTerms<T>& t, int tab, int b, T col1,
                         T refm, T col2, T mult) const {
    T sp, fpl;
    int jpl;
    eta_index(col1, col1 + refm * col2, mult, sp, jpl, fpl);
    t.pair(tab, c_ng[b - 1], jpl, ECRAD_LIT(1.0), fpl);
  }
  __device__ void cst(WarpTerms<T>& t, int tab, int b, T w) const {
    t.put(tab, c_ng[b - 1], 0, w);
  }
};

// Phase 1 for band b (1-based): tau terms into `tau`, pfrac terms into `pf`.
template <typename T>
__device__ void band_terms(const Cell<T>& c, int b, WarpTerms<T>& tau,
                           WarpTerms<T>& pf) {
  const T* kc = c.kc;
  const bool tr = c.tropo;
  const T one = ECRAD_LIT(1.0), four = ECRAD_LIT(4.0), eight = ECRAD_LIT(8.0);
  const T h2o = c.F(COLH2O), co2 = c.F(COLCO2), o3 = c.F(COLO3);
  const T n2o = c.F(COLN2O), ch4 = c.F(COLCH4);
  switch (b) {
    case 1: {  // h2o, minor n2; everything times corradj1
      T pavel = c.F(PAVEL);
      T corradj1 =
          tr ? (pavel < ECRAD_LIT(250.0)
                    ? one - ECRAD_LIT(0.15) * (ECRAD_LIT(250.0) - pavel)
                                / ECRAD_LIT(154.4)
                    : one)
             : one - ECRAD_LIT(0.15) * (pavel / ECRAD_LIT(95.6));
      T scalen2 = c.F(COLBRD) * c.F(SCALEMINORN2);
      c.major_noeta(tau, tr ? ABSA(1) : ABSB(1), 10, !tr, h2o);
      c.self_(tau, 1);
      c.for_(tau, 1);
      c.minor(tau, tr ? LW1_KAO_MN2 : LW1_KBO_MN2, 1, scalen2);
      tau.scale_last(10, corradj1);
      c.cst(pf, tr ? PFA(1) : PFB(1), 1, one);
      break;
    }
    case 2: {  // h2o; corradj2 on the tropospheric terms
      T corradj2 = one - ECRAD_LIT(0.05) * (c.F(PAVEL) - ECRAD_LIT(100.0))
                             / ECRAD_LIT(900.0);
      T wa2 = tr ? corradj2 : one;
      c.major_noeta(tau, tr ? ABSA(2) : ABSB(2), 12, !tr,
                    tr ? h2o * corradj2 : h2o);
      c.self_(tau, 2);
      tau.scale_last(2, corradj2);
      c.for_(tau, 2, wa2);
      c.cst(pf, tr ? PFA(2) : PFB(2), 2, one);
      break;
    }
    case 3: {  // h2o+co2, minor n2o
      T adjcoln2o = chi_adjust(n2o, c.F(COLDRY), c.F(CHI_N2O), ECRAD_LIT(1.5),
                               ECRAD_LIT(0.5), ECRAD_LIT(0.65));
      if (tr) {
        c.major_eta3(tau, 3, h2o, co2, c.F(RAT_H2OCO2), c.F(RAT_H2OCO2_1));
      } else {
        c.major_eta2(tau, 3, h2o, co2, c.F(RAT_H2OCO2), c.F(RAT_H2OCO2_1));
        tau.zeros(4);
      }
      c.self_(tau, 3);
      c.for_(tau, 3);
      if (tr) {
        c.minor_eta(tau, LW3_KAO_MN2O, 3, 9, h2o, kc[B3_REFM_A], co2, eight,
                    adjcoln2o);
        c.pf_eta(pf, PFA(3), 3, h2o, kc[PF3_A], co2, eight);
      } else {
        c.minor_eta(tau, LW3_KBO_MN2O, 3, 5, h2o, kc[B3_REFM_B], co2, four,
                    adjcoln2o);
        c.pf_eta(pf, PFB(3), 3, h2o, kc[PF3_B], co2, four);
      }
      break;
    }
    case 4: {  // h2o+co2 / o3+co2
      if (tr) {
        c.major_eta3(tau, 4, h2o, co2, c.F(RAT_H2OCO2), c.F(RAT_H2OCO2_1));
      } else {
        c.major_eta2(tau, 4, o3, co2, c.F(RAT_O3CO2), c.F(RAT_O3CO2_1));
        tau.zeros(4);
      }
      c.self_(tau, 4);
      c.gated_for(tau, 4);
      if (tr)
        c.pf_eta(pf, PFA(4), 4, h2o, kc[PF4_A], co2, eight);
      else
        c.pf_eta(pf, PFB(4), 4, o3, kc[PF4_B], co2, four);
      break;
    }
    case 5: {  // h2o+co2 / o3+co2, minor o3, ccl4
      if (tr) {
        c.major_eta3(tau, 5, h2o, co2, c.F(RAT_H2OCO2), c.F(RAT_H2OCO2_1));
      } else {
        c.major_eta2(tau, 5, o3, co2, c.F(RAT_O3CO2), c.F(RAT_O3CO2_1));
        tau.zeros(4);
      }
      c.self_(tau, 5);
      c.gated_for(tau, 5);
      if (tr)
        c.minor_eta(tau, LW5_KAO_MO3, 5, 9, h2o, kc[B5_REFM_A], co2, eight,
                    o3);
      else
        tau.zeros(4);
      c.cst(tau, LW5_CCL4, 5, c.F(WX_CCL4));
      if (tr)
        c.pf_eta(pf, PFA(5), 5, h2o, kc[PF5_A], co2, eight);
      else
        c.pf_eta(pf, PFB(5), 5, o3, kc[PF5_B], co2, four);
      break;
    }
    case 6: {  // h2o; minor co2; cfc11, cfc12
      if (tr)
        c.major_noeta(tau, ABSA(6), 8, false, h2o);
      else
        tau.zeros(4);
      c.self_(tau, 6);
      c.gated_for(tau, 6);
      if (tr)
        c.minor(tau, LW6_KAO_MCO2, 6,
                chi_adjust(co2, c.F(COLDRY), c.F(CHI_CO2), ECRAD_LIT(3.0),
                           ECRAD_LIT(2.0), ECRAD_LIT(0.77)));
      else
        tau.zeros(2);
      c.cst(tau, LW6_CFC11ADJ, 6, c.F(WX_CFC11));
      c.cst(tau, LW6_CFC12, 6, c.F(WX_CFC12));
      c.cst(pf, tr ? PFA(6) : PFB(6), 6, one);
      break;
    }
    case 7: {  // h2o+o3 / o3; minor co2
      if (tr) {
        c.major_eta3(tau, 7, h2o, o3, c.F(RAT_H2OO3), c.F(RAT_H2OO3_1));
        c.self_(tau, 7);
        c.gated_for(tau, 7);
        c.minor_eta(tau, LW7_KAO_MCO2, 7, 9, h2o, kc[B7_REFM_A], o3, eight,
                    chi_adjust(co2, c.F(COLDRY), c.F(CHI_CO2), ECRAD_LIT(3.0),
                               ECRAD_LIT(3.0), ECRAD_LIT(0.79)));
        c.pf_eta(pf, PFA(7), 7, h2o, kc[PF7_A], o3, eight);
      } else {
        c.major_noeta(tau, ABSB(7), 12, true, o3);
        tau.zeros(8);
        c.self_(tau, 7);
        c.gated_for(tau, 7);
        c.minor(tau, LW7_KBO_MCO2, 7,
                chi_adjust(co2, c.F(COLDRY), c.F(CHI_CO2), ECRAD_LIT(3.0),
                           ECRAD_LIT(2.0), ECRAD_LIT(0.79)));
        c.cst(pf, PFB(7), 7, one);
      }
      break;
    }
    case 8: {  // h2o / o3; minors co2, o3, n2o; cfc12, cfc22
      T adjco2 = chi_adjust(co2, c.F(COLDRY), c.F(CHI_CO2), ECRAD_LIT(3.0),
                            ECRAD_LIT(2.0), ECRAD_LIT(0.65));
      c.major_noeta(tau, tr ? ABSA(8) : ABSB(8), 8, !tr, tr ? h2o : o3);
      c.self_(tau, 8);
      c.gated_for(tau, 8);
      c.minor(tau, tr ? LW8_KAO_MCO2 : LW8_KBO_MCO2, 8, adjco2);
      if (tr)
        c.minor(tau, LW8_KAO_MO3, 8, o3);
      else
        tau.zeros(2);
      c.minor(tau, tr ? LW8_KAO_MN2O : LW8_KBO_MN2O, 8, n2o);
      c.cst(tau, LW8_CFC12, 8, c.F(WX_CFC12));
      c.cst(tau, LW8_CFC22ADJ, 8, c.F(WX_CFC22));
      c.cst(pf, tr ? PFA(8) : PFB(8), 8, one);
      break;
    }
    case 9: {  // h2o+ch4 / ch4; minor n2o
      T adjn2o = chi_adjust(n2o, c.F(COLDRY), c.F(CHI_N2O), ECRAD_LIT(1.5),
                            ECRAD_LIT(0.5), ECRAD_LIT(0.65));
      if (tr) {
        c.major_eta3(tau, 9, h2o, ch4, c.F(RAT_H2OCH4), c.F(RAT_H2OCH4_1));
        c.self_(tau, 9);
        c.gated_for(tau, 9);
        c.minor_eta(tau, LW9_KAO_MN2O, 9, 9, h2o, kc[B9_REFM_A], ch4, eight,
                    adjn2o);
        c.pf_eta(pf, PFA(9), 9, h2o, kc[PF9_A], ch4, eight);
      } else {
        c.major_noeta(tau, ABSB(9), 12, true, ch4);
        tau.zeros(8);
        c.self_(tau, 9);
        c.gated_for(tau, 9);
        c.minor(tau, LW9_KBO_MN2O, 9, adjn2o);
        c.cst(pf, PFB(9), 9, one);
      }
      break;
    }
    case 10: {  // h2o
      c.major_noeta(tau, tr ? ABSA(10) : ABSB(10), 6, !tr, h2o);
      c.self_(tau, 10);
      c.for_(tau, 10);
      c.cst(pf, tr ? PFA(10) : PFB(10), 10, one);
      break;
    }
    case 11: {  // h2o; minor o2
      c.major_noeta(tau, tr ? ABSA(11) : ABSB(11), 8, !tr, h2o);
      c.self_(tau, 11);
      c.for_(tau, 11);
      c.minor(tau, tr ? LW11_KAO_MO2 : LW11_KBO_MO2, 11,
              c.F(COLO2) * c.F(SCALEMINOR));
      c.cst(pf, tr ? PFA(11) : PFB(11), 11, one);
      break;
    }
    case 12: {  // h2o+co2, troposphere only
      if (tr)
        c.major_eta3(tau, 12, h2o, co2, c.F(RAT_H2OCO2), c.F(RAT_H2OCO2_1));
      else
        tau.zeros(12);
      c.self_(tau, 12);
      c.gated_for(tau, 12);
      if (tr) c.pf_eta(pf, PFA(12), 12, h2o, kc[PF12_A], co2, eight);
      break;
    }
    case 13: {  // h2o+n2o; minor co2; strat minor o3
      if (tr)
        c.major_eta3(tau, 13, h2o, n2o, c.F(RAT_H2ON2O), c.F(RAT_H2ON2O_1));
      else
        tau.zeros(12);
      c.self_(tau, 13);
      c.gated_for(tau, 13);
      if (tr) {
        c.minor_eta(tau, LW13_KAO_MCO2, 13, 9, h2o, kc[B13_REFM_A], n2o,
                    eight,
                    chi_adjust(co2, c.F(COLDRY), ECRAD_LIT(3.55e-4),
                               ECRAD_LIT(3.0), ECRAD_LIT(2.0),
                               ECRAD_LIT(0.68)));
        c.pf_eta(pf, PFA(13), 13, h2o, kc[PF13_A], n2o, eight);
      } else {
        c.minor(tau, LW13_KBO_MO3, 13, o3);
        c.cst(pf, PFB(13), 13, one);
      }
      break;
    }
    case 14: {  // co2
      c.major_noeta(tau, tr ? ABSA(14) : ABSB(14), 2, !tr, co2);
      c.self_(tau, 14);
      c.gated_for(tau, 14);
      c.cst(pf, tr ? PFA(14) : PFB(14), 14, one);
      break;
    }
    case 15: {  // n2o+co2; minor n2, troposphere only
      if (tr)
        c.major_eta3(tau, 15, n2o, co2, c.F(RAT_N2OCO2), c.F(RAT_N2OCO2_1));
      else
        tau.zeros(12);
      c.self_(tau, 15);
      c.gated_for(tau, 15);
      if (tr) {
        c.minor_eta(tau, LW15_KAO_MN2, 15, 9, n2o, kc[B15_REFM_A], co2,
                    eight, c.F(COLBRD) * c.F(SCALEMINOR));
        c.pf_eta(pf, PFA(15), 15, n2o, kc[PF15_A], co2, eight);
      }
      break;
    }
    case 16: {  // h2o+ch4 / ch4
      if (tr) {
        c.major_eta3(tau, 16, h2o, ch4, c.F(RAT_H2OCH4), c.F(RAT_H2OCH4_1));
      } else {
        c.major_noeta(tau, ABSB(16), 2, true, ch4);
        tau.zeros(8);
      }
      c.self_(tau, 16);
      c.gated_for(tau, 16);
      if (tr)
        c.pf_eta(pf, PFA(16), 16, h2o, kc[PF16_A], ch4, eight);
      else
        c.cst(pf, PFB(16), 16, one);
      break;
    }
  }
}

// Phase 2 of a band of NGB g-points: the lane's outputs are the pairs
// (cell, g) = it * TILE_LW + lane of the tile's TILE_LW x NGB, it < NGB.
// Each output is the sum over slots k0 .. k1 - 1, in order, of w_k
// tab[row_k + g]; CHUNK (at most 12) of the lane's sums run together, so a
// slot's gathers are independent loads in flight at once.
template <typename T, int NGB>
__device__ __forceinline__ void band_outputs(
    const T* __restrict__ tab, const typename TermSlot<T>::type* terms,
    int lane, int g0, int kt, int kp, T (*out)[TILE_LW][NG]) {
  using S = TermSlot<T>;
  constexpr int CHUNK = NGB <= 12 ? NGB : NGB / 2;
  static_assert(NGB % CHUNK == 0, "whole chunks");
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int k0 = part ? kt : 0, k1 = part ? kt + kp : kt;
#pragma unroll
    for (int i0 = 0; i0 < NGB; i0 += CHUNK) {
      // per output: its cell, its g, and tab + g (a slot's row offset is
      // then one wide multiply-add away from the value's address)
      int cl[CHUNK], gl[CHUNK];
      const T* tg[CHUNK];
      T acc[CHUNK];
#pragma unroll
      for (int it = 0; it < CHUNK; ++it) {
        const int p = (i0 + it) * TILE_LW + lane;
        cl[it] = p / NGB;
        gl[it] = p % NGB;
        tg[it] = tab + gl[it];
        acc[it] = ECRAD_LIT(0.0);
      }
      for (int k = k0; k < k1; ++k) {
        const typename S::type* t = terms + k * TILE_LW;
#pragma unroll
        for (int it = 0; it < CHUNK; ++it) {
          const typename S::type e = t[cl[it]];
          acc[it] += S::w(e) * __ldg(tg[it] + S::off(e));
        }
      }
#pragma unroll
      for (int it = 0; it < CHUNK; ++it)
        out[part][cl[it]][g0 + gl[it]] = acc[it];
    }
  }
}

template <typename T>
struct __align__(16) SharedLw {
  T out[2][TILE_LW][NG];             // the tile's tau and pfrac rows
  typename TermSlot<T>::type terms[NWARP_LW][K_BAND_MAX * TILE_LW];
  T f[NF][TILE_LW];                  // the tile's fields
  int i[NI][TILE_LW];
  int toff[NTAB], tnrows[NTAB];      // table offsets and row counts
  T kc[NC];                          // body constants
};

template <typename T>
__global__ void __launch_bounds__(THREADS_LW, blocks_per_sm_lw<T>())
taumol_lw_kernel(const T* __restrict__ fc, const int* __restrict__ ic,
                 const T* __restrict__ tab, const int* __restrict__ meta,
                 const T* __restrict__ kc, int n,
                 T* __restrict__ tau, T* __restrict__ pfrac) {
  extern __shared__ __align__(16) unsigned char smem_lw[];
  SharedLw<T>& sh = *reinterpret_cast<SharedLw<T>*>(smem_lw);
  const int warp = threadIdx.x / TILE_LW, lane = threadIdx.x % TILE_LW;
  const int pos0 = blockIdx.x * TILE_LW;
  const bool my_live = pos0 + lane < n;
  // stage the table offsets, the body constants and the tile's fields
  // (warp w loads fields w, w + NWARP_LW, ...: one 128-byte run each, all
  // in flight together)
  for (int q = threadIdx.x; q < 2 * NTAB; q += THREADS_LW)
    (q < NTAB ? sh.toff[q] : sh.tnrows[q - NTAB]) = meta[q];
  if (threadIdx.x < NC) sh.kc[threadIdx.x] = kc[threadIdx.x];
  {
    constexpr int ROUNDS = (NF + NI + NWARP_LW - 1) / NWARP_LW;
    T v[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = warp + r * NWARP_LW;
      v[r] = ECRAD_LIT(0.0);
      if (my_live && k < NF)
        v[r] = fc[(size_t)k * n + pos0 + lane];
      else if (my_live && k < NF + NI)
        v[r] = int_bits(ic[(size_t)(k - NF) * n + pos0 + lane], T());
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = warp + r * NWARP_LW;
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
  for (int j = 0; j < BANDS_PER_WARP; ++j) {
    const int b = c_warp_bands[warp][j];
    if (b == 0) break;
    const int kt = c_ktau[b] - c_ktau[b - 1];
    const int kp = c_kpf[b] - c_kpf[b - 1];
    // phase 1: lane = cell, band b's terms (the switch is warp-uniform);
    // a lane past the last cell writes zero terms, which phase 2 reads
    WarpTerms<T> t_tau{terms + lane, 0, sh.toff, sh.tnrows};
    WarpTerms<T> t_pf{terms + lane, kt, sh.toff, sh.tnrows};
    if (my_live) band_terms(c, b, t_tau, t_pf);
    t_tau.zeros(kt - t_tau.k);
    t_pf.zeros(kt + kp - t_pf.k);
    __syncwarp();
    // phase 2: lanes over the tile's (cell, g) pairs of band b
    const int g0 = c_goff[b - 1];
    switch (c_ng[b - 1]) {
#define ECRAD_BAND_OUTPUTS(NGB)                                             \
  case NGB:                                                                 \
    band_outputs<T, NGB>(tab, terms, lane, g0, kt, kp, sh.out);           \
    break;
      ECRAD_BAND_OUTPUTS(2) ECRAD_BAND_OUTPUTS(4) ECRAD_BAND_OUTPUTS(6)
      ECRAD_BAND_OUTPUTS(8) ECRAD_BAND_OUTPUTS(10) ECRAD_BAND_OUTPUTS(12)
      ECRAD_BAND_OUTPUTS(14) ECRAD_BAND_OUTPUTS(16)
#undef ECRAD_BAND_OUTPUTS
    }
    // every lane is done with the slots before the next band's terms
    __syncwarp();
  }
  // the tile's rows out: for each output one run of up to 32 x 140
  // values, 16 bytes a thread
  __syncthreads();
  using V = typename Vec16<T>::type;
  constexpr int PER = 16 / sizeof(T);
  const int live4 = (min(n - pos0, TILE_LW) * NG) / PER;
  const V* out4 = reinterpret_cast<const V*>(sh.out);
  V* tau4 = reinterpret_cast<V*>(tau + (size_t)pos0 * NG);
  V* pfrac4 = reinterpret_cast<V*>(pfrac + (size_t)pos0 * NG);
#pragma unroll
  for (int q = threadIdx.x; q < TILE_LW * NG / PER; q += THREADS_LW) {
    if (q < live4) {
      tau4[q] = out4[q];
      pfrac4[q] = out4[TILE_LW * NG / PER + q];
    }
  }
}

}  // namespace lw
}  // namespace ecrad

// B1's dynamic shared memory, and the carveout, in percent of the SM's
// 228 KB, that holds blocks_per_sm_lw blocks and the 1 KB each reserves
template <typename T>
static cudaError_t lw_attributes() {
  using namespace ecrad::lw;
  const int per_block = (int)sizeof(SharedLw<T>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      taumol_lw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(SharedLw<T>));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      taumol_lw_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (blocks_per_sm_lw<T>() * per_block * 100 + 228 * 1024 - 1)
          / (228 * 1024));
}

template <typename T>
static int taumol_lw_launch(const T* fc, const int* ic, const T* tab,
                            const int* meta, const T* consts, int n, T* tau,
                            T* pfrac, void* stream) {
  using namespace ecrad;
  if (n > 0) {
    cudaError_t e = lw_attributes<T>();
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + lw::TILE_LW - 1) / lw::TILE_LW;
    lw::taumol_lw_kernel<T><<<blocks, lw::THREADS_LW, sizeof(lw::SharedLw<T>),
                              (cudaStream_t)stream>>>(fc, ic, tab, meta,
                                                      consts, n, tau, pfrac);
  }
  return (int)cudaGetLastError();
}

// B1's resources and the blocks per SM its launch gets (kernel_info.cuh)
template <typename T>
static int taumol_lw_info_of(int* info) {
  using namespace ecrad;
  cudaError_t e = lw_attributes<T>();
  if (e != cudaSuccess) return (int)e;
  return kernel_info(lw::taumol_lw_kernel<T>, lw::THREADS_LW,
                     sizeof(lw::SharedLw<T>), info);
}

extern "C" int taumol_lw(const float* fc, const int* ic, const float* tab,
                         const int* meta, const float* consts, int n,
                         float* tau, float* pfrac, void* stream) {
  return taumol_lw_launch<float>(fc, ic, tab, meta, consts, n, tau, pfrac,
                                 stream);
}

// the double form, the float64 path's: the tables, fields and outputs in
// double
extern "C" int taumol_lw_f64(const double* fc, const int* ic,
                             const double* tab, const int* meta,
                             const double* consts, int n, double* tau,
                             double* pfrac, void* stream) {
  return taumol_lw_launch<double>(fc, ic, tab, meta, consts, n, tau, pfrac,
                                  stream);
}

extern "C" int taumol_lw_info(int* info) {
  return taumol_lw_info_of<float>(info);
}
extern "C" int taumol_lw_info_f64(int* info) {
  return taumol_lw_info_of<double>(info);
}
