// Shared device code of the two taumol kernels (taumol_lw.cu, taumol_sw.cu):
// eta_index and oneminus for both; the tile, Terms and gather_sum for the
// SW kernel, which runs in two phases over a tile of TILE cells per block:
//   1. one thread per (band, cell) writes that band's TERMS for the cell
//      into shared memory: a flat-table element offset `base` (the start
//      of one table row) and a weight `w`;
//   2. the block strides over (cell, g) pairs:
//        out[cell, g] = sum_k w_k * tab[base_k + g - g_off(band(g))],
//      storing coalesced (N, ng) rows.
// (The LW kernel builds the same terms a band at a time per warp, with
// its own slot layout.) Term k of a band is the tropospheric term in a
// tropospheric cell and the stratospheric one otherwise; a row outside
// its table gets weight 0. The plain PyTorch versions
// (optics/rrtmg/taumol_lw.py, taumol_sw.py) build the same terms in the
// same slot order.
#pragma once

#include <cuda_runtime.h>

namespace ecrad {

constexpr int TILE = 16;          // cells per block
constexpr int THREADS = 256;      // 16 bands x 16 cells in phase 1

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

// Writes one band's terms for one cell, in slot order.
struct Terms {
  int* base;
  float* w;
  int k;
  const int* toff;     // table id -> element offset
  const int* tnrows;   // table id -> number of rows

  __device__ __forceinline__ void put(int tab, int ng, int row, float wt,
                                      bool ok = true) {
    bool valid = ok && row >= 0 && row < tnrows[tab];
    base[k] = toff[tab] + (valid ? row : 0) * ng;
    w[k] = valid ? wt : 0.0f;
    ++k;
  }
  __device__ __forceinline__ void zeros(int m) {
    for (int i = 0; i < m; ++i) {
      base[k] = 0;
      w[k] = 0.0f;
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
    for (int i = k - m; i < k; ++i) w[i] *= s;
  }
};

// Phase 2 for one output: sum the terms of band b for (cell cl, g).
__device__ __forceinline__ float gather_sum(const float* __restrict__ tab,
                                            const int* base, const float* w,
                                            int k0, int k1, int gl) {
  float acc = 0.0f;
  for (int k = k0; k < k1; ++k) acc += w[k] * __ldg(tab + base[k] + gl);
  return acc;
}

}  // namespace ecrad
