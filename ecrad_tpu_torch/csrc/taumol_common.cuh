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
//
// Everything here is a template on the kernels' scalar type T: float for
// the float32 path, double for the float64 path's double forms.
#pragma once

#include <cuda_runtime.h>

#include "scalar.cuh"

namespace ecrad {

// cells of a B1/B2 tile: one per lane while a warp builds a band's terms
constexpr int TILE_CELLS = 32;

// 1 - 1e-6 rounded once to T, as a Python float reaches the tensor's dtype
template <typename T>
__device__ __forceinline__ T oneminus() {
  return static_cast<T>(1.0 - 1.0e-6);
}

// (specparm, js, fs) of an eta interpolation with `mult` intervals
template <typename T>
__device__ __forceinline__ void eta_index(T col1, T speccomb, T mult, T& sp,
                                          int& js, T& fs) {
  T q = col1 / speccomb;
  sp = q > oneminus<T>() ? oneminus<T>() : q;
  T sm = mult * sp;
  T fl = mfloor(sm);
  js = static_cast<int>(fl);
  fs = sm - fl;
}

// A term slot: (table element offset of the row, weight). Float: a
// float2 with the offset's bits in .x; double: an int and a double.
template <typename T>
struct TermSlot;
template <>
struct TermSlot<float> {
  using type = float2;
  __device__ __forceinline__ static float2 make(int off, float w) {
    return make_float2(__int_as_float(off), w);
  }
  __device__ __forceinline__ static int off(float2 e) {
    return __float_as_int(e.x);
  }
  __device__ __forceinline__ static float w(float2 e) { return e.y; }
  __device__ __forceinline__ static void scale(float2& e, float s) {
    e.y *= s;
  }
};
struct __align__(16) DoubleTerm {
  int off;
  double w;
};
template <>
struct TermSlot<double> {
  using type = DoubleTerm;
  __device__ __forceinline__ static DoubleTerm make(int off, double w) {
    return DoubleTerm{off, w};
  }
  __device__ __forceinline__ static int off(DoubleTerm e) { return e.off; }
  __device__ __forceinline__ static double w(DoubleTerm e) { return e.w; }
  __device__ __forceinline__ static void scale(DoubleTerm& e, double s) {
    e.w *= s;
  }
};

// An int staged with the fields in a T register: its bits, unchanged
__device__ __forceinline__ float int_bits(int i, float) {
  return __int_as_float(i);
}
__device__ __forceinline__ double int_bits(int i, double) {
  return __longlong_as_double((long long)i);
}
__device__ __forceinline__ int bits_int(float v) { return __float_as_int(v); }
__device__ __forceinline__ int bits_int(double v) {
  return (int)__double_as_longlong(v);
}

// 16 bytes of T: the vector a tile's rows are written out in
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// Writes one band's terms for one cell into its warp's slots: slot k of
// lane l at t[k * TILE_CELLS] (t = the warp's storage + l).
template <typename T>
struct WarpTerms {
  using S = TermSlot<T>;
  typename S::type* t;
  int k;
  const int* toff;     // table id -> element offset
  const int* tnrows;   // table id -> number of rows

  __device__ __forceinline__ void put(int tab, int ng, int row, T wt,
                                      bool ok = true) {
    bool valid = ok && row >= 0 && row < tnrows[tab];
    t[k * TILE_CELLS] = S::make(toff[tab] + (valid ? row : 0) * ng,
                                valid ? wt : ECRAD_LIT(0.0));
    ++k;
  }
  __device__ __forceinline__ void zeros(int m) {
    for (int i = 0; i < m; ++i) {
      t[k * TILE_CELLS] = S::make(0, ECRAD_LIT(0.0));
      ++k;
    }
  }
  // linear interpolation between rows row0 and row0 + 1
  __device__ __forceinline__ void pair(int tab, int ng, int row0, T wt,
                                       T frac) {
    put(tab, ng, row0, wt * (ECRAD_LIT(1.0) - frac));
    put(tab, ng, row0 + 1, wt * frac);
  }
  __device__ __forceinline__ void scale_last(int m, T s) {
    for (int i = k - m; i < k; ++i) S::scale(t[i * TILE_CELLS], s);
  }
};

}  // namespace ecrad
