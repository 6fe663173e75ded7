// Shared device code of the taumol kernels: eta_index and oneminus for
// B1 (taumol_lw.cu) and B2 (taumol_sw.cu), and the warp's term slots of
// their band-uniform design (WarpTerms).
//
// B1 and B2 build one band's TERMS at a time per warp, lane = cell of a
// tile of TILE_CELLS consecutive cells: a flat-table element offset (the
// start of one table row) and a weight w, then sum
//   out[cell, g] = sum_k w_k * tab[row_k + g - g_off(band(g))].
// Term k of a band is the tropospheric term in a tropospheric cell and
// the stratospheric one otherwise; a row outside its table gets weight 0.
// The plain PyTorch versions (optics/rrtmg/taumol_lw.py, taumol_sw.py)
// build the same terms in the same slot order.
#pragma once

#include <cuda_runtime.h>

namespace ecrad {

// cells of a B1/B2 tile: one per lane while a warp builds a band's terms
constexpr int TILE_CELLS = 32;

// 1 - 1e-6 rounded once to float, as a Python float reaches float32
__device__ __forceinline__ float oneminus() {
  return static_cast<float>(1.0 - 1.0e-6);
}

// (specparm, js, fs) of an eta interpolation with `mult` intervals
__device__ __forceinline__ void eta_index(float col1, float speccomb,
                                          float mult, float& sp, int& js,
                                          float& fs) {
  float q = col1 / speccomb;
  sp = q > oneminus() ? oneminus() : q;
  float sm = mult * sp;
  float fl = floorf(sm);
  js = static_cast<int>(fl);
  fs = sm - fl;
}

// Writes one band's terms for one cell into its warp's slots: slot k of
// lane l at t[k * TILE_CELLS] (t = the warp's storage + l), as (table
// element offset of the row, weight) with the offset's bits in .x.
struct WarpTerms {
  float2* t;
  int k;
  const int* toff;     // table id -> element offset
  const int* tnrows;   // table id -> number of rows

  __device__ __forceinline__ void put(int tab, int ng, int row, float wt,
                                      bool ok = true) {
    bool valid = ok && row >= 0 && row < tnrows[tab];
    t[k * TILE_CELLS] = make_float2(
        __int_as_float(toff[tab] + (valid ? row : 0) * ng),
        valid ? wt : 0.0f);
    ++k;
  }
  __device__ __forceinline__ void zeros(int m) {
    for (int i = 0; i < m; ++i) {
      t[k * TILE_CELLS] = make_float2(__int_as_float(0), 0.0f);
      ++k;
    }
  }
  // linear interpolation between rows row0 and row0 + 1
  __device__ __forceinline__ void pair(int tab, int ng, int row0, float wt,
                                       float frac) {
    put(tab, ng, row0, wt * (1.0f - frac));
    put(tab, ng, row0 + 1, wt * frac);
  }
  __device__ __forceinline__ void scale_last(int m, float s) {
    for (int i = k - m; i < k; ++i) t[i * TILE_CELLS].y *= s;
  }
};

}  // namespace ecrad
