// Kernel B10: weighted table-row interpolation of the per-band taumol path,
//   out[g, n] = sum over sections, over terms k:  w_k[n] * T_s[row_k[n], g].
//
// Replaces the TPU kernel ecrad_tpu/ops/gather_interp.py::
// _eval_sections_pallas (:191; pallas_call :267; body _pallas_kernel :115),
// which built weighted one-hot matrices in VMEM and contracted them with the
// tables on the MXU (an EtaSection as two one-hots and a two-stage product).
// Here the rows are gathered directly.
//
// What bounds it: the bytes, and the L1 traffic of the table reads. Each
// cell's rows and weights are read once, in place (the wrapper passes a
// table of their device pointers by value beside the int descriptor), and
// its G outputs are written once; the tables of one call (at most 128 KiB
// of live columns on the path) are read through the read-only cache.
//
// Zero columns are skipped. The wrapper finds, once per table content,
// the column range [lo, hi) outside which a table is all zero, widens it
// to whole groups of VEC columns and hands the kernel only those columns,
// compacted (zero past G). The LW bands put their tau and pfrac tables
// side by side along g, each zero on the other half, so about 40 % of the
// path's gathers go. A skipped term would add w * 0: for finite weights,
// which the path's are, the sum equals the plain version's by value (at
// most the sign of an exact zero differs, and -0 == +0). A non-finite
// weight times a zero column is NaN in the plain version and is skipped
// here.
//
// Layout: a block of BLOCK threads takes a tile of consecutive cells (the
// wrapper's plan picks the tile per call from the blocks an SM holds at
// that size and the rounds of blocks the call needs). Phase 1 copies the
// tile's rows and weights into shared memory with cp.async, a warp an
// operand (16 bytes where it is 16-byte aligned, else 4), and builds each
// term's (element offset of its row in the compacted table, weight) for
// every cell, a warp a term: rows clipped to the table (for an EtaSection
// the FLAT row grid*R2 + go*R2 + eta + eo), gw*ew rounded before it
// multiplies the table value. Phase 2 walks the segments of column groups
// (the disjoint unions of the sections' live groups, and the gaps between
// them, whose outputs are 0), a lane per (cell, group) with the group
// fastest: a term is one float4 load of its row, so a warp reads up to 8
// cells' row segments per load. Each (cell, g) sums its terms from 0.0f in
// one lane, in section order and then term order, skipping the sections
// whose live groups do not hold g (no split sum, no tree): built with
// -fmad=false, the kernel equals its plain version by value. The tile's
// outputs are staged (cell, g) in shared memory with an odd row stride,
// where its rows and weights were, and stored as whole rows along N, a
// warp a row.
//
// Semantics: ops/gather_interp.py `eval_sections_plain` (the port of
// _eval_sections_reference :100-112).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace ecrad {
namespace gs {

// ops/gather_interp.py MAX_DESC, MAX_PTR, HDR, SEG, SEC, TERM, VEC,
// BLOCK, SMEM_MAX
constexpr int MAX_DESC = 640;
constexpr int MAX_PTR = 128;
constexpr int HDR = 4;    // nsec, nseg, nterms, nptr
constexpr int SEG = 2;    // a segment of column groups: first, end
constexpr int SEC = 4;    // a section: first group, end group, its terms
constexpr int TERM = 9;   // a term: see phase 1b
constexpr int VEC = 4;    // the columns of a group: a lane's float4
constexpr int BLOCK = 256;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

// The descriptor and the operands' device pointers, passed by value:
// they live in the kernel's parameter space (3,584 of its 4,096 bytes),
// read uniformly across a warp.
struct Params {
  int v[MAX_DESC];
  const void* p[MAX_PTR];
};

__device__ __forceinline__ int clip(int r, int nrow) {
  return r < 0 ? 0 : (r > nrow - 1 ? nrow - 1 : r);
}

// A block's shared memory in bytes: the terms (nterms x tile float2) and
// an area of tile x max(nptr, g | 1) words, first the tile's copied rows
// and weights, then its staged outputs.
inline size_t smem_bytes(int tile, int nterms, int nptr, int g) {
  const int gp = g | 1;
  return static_cast<size_t>(8) * nterms * tile +
         static_cast<size_t>(4) * tile * (nptr > gp ? nptr : gp);
}

__global__ void __launch_bounds__(BLOCK)
    gather_sections_kernel(const __grid_constant__ Params P,
                           const float* __restrict__ tab, int n, int g,
                           int tile, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WARPS = BLOCK / 32;
  const int nsec = P.v[0], nseg = P.v[1], nterms = P.v[2], nptr = P.v[3];
  const int* seg = P.v + HDR;
  const int* sec = seg + SEG * nseg;
  const int* term = sec + SEC * nsec;
  const int gp = g | 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* terms = reinterpret_cast<float2*>(smem);
  int* raw = reinterpret_cast<int*>(terms + nterms * tile);
  float* res = reinterpret_cast<float*>(raw);
  const int cell0 = blockIdx.x * tile, nt = min(tile, n - cell0);

  // phase 1a: the tile's rows and weights, raw[q * tile + c], a warp an
  // operand (16-byte copies where it is 16-byte aligned and the tile
  // whole; tile is a multiple of 4)
  for (int q = warp; q < nptr; q += WARPS) {
    const int* src = static_cast<const int*>(P.p[q]) + cell0;
    int* d = raw + q * tile;
    if (nt == tile && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int j = 4 * lane; j < tile; j += 128)
        __pipeline_memcpy_async(d + j, src + j, 16);
    } else {
      for (int c = lane; c < nt; c += 32)
        __pipeline_memcpy_async(d + c, src + c, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // phase 1b: the terms, a warp a term. A term record: element offset in
  // tab of the section's row 0 less its first column, rows in the table,
  // row stride, row (or grid) operand, weight (or gw) operand, eta operand
  // (-1 for a plain term), ew operand, R2, go*R2 + eo.
  for (int k = warp; k < nterms; k += WARPS) {
    const int* r = term + TERM * k;
    const int off = r[0], nrow = r[1], stride = r[2], eta = r[5];
    const int* rows = raw + r[3] * tile;
    const float* w = reinterpret_cast<const float*>(raw + r[4] * tile);
    float2* t = terms + k * tile;
    if (eta < 0) {
      for (int c = lane; c < nt; c += 32)
        t[c] = make_float2(__int_as_float(off + clip(rows[c], nrow) * stride),
                           w[c]);
    } else {
      const int* etas = raw + eta * tile;
      const float* ew = reinterpret_cast<const float*>(raw + r[6] * tile);
      const int r2 = r[7], st = r[8];
      for (int c = lane; c < nt; c += 32)
        t[c] = make_float2(
            __int_as_float(off +
                           clip(rows[c] * r2 + st + etas[c], nrow) * stride),
            w[c] * ew[c]);
    }
  }
  __syncthreads();
  // phase 2: each (cell, group of VEC columns) of each segment, the group
  // fastest; the outputs go where the rows and weights were
  for (int s = 0; s < nseg; ++s) {
    const int a = seg[SEG * s], width = seg[SEG * s + 1] - a;
    for (int i = threadIdx.x; i < nt * width; i += BLOCK) {
      const int c = i / width, q = a + i % width;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int u = 0; u < nsec; ++u) {
        const int* sr = sec + SEC * u;
        if (q < sr[0] || q >= sr[1]) continue;
#pragma unroll 4
        for (int k = sr[2]; k < sr[3]; ++k) {
          const float2 t = terms[k * tile + c];
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              tab + __float_as_int(t.x) + VEC * q));
          acc.x += t.y * v.x;
          acc.y += t.y * v.y;
          acc.z += t.y * v.z;
          acc.w += t.y * v.w;
        }
      }
      float* o = res + c * gp + VEC * q;
      const int m = g - VEC * q;
      o[0] = acc.x;
      if (m > 1) o[1] = acc.y;
      if (m > 2) o[2] = acc.z;
      if (m > 3) o[3] = acc.w;
    }
  }
  __syncthreads();
  // the tile's outputs as whole rows along N, a warp a row
  const size_t nn = static_cast<size_t>(n);
  for (int gl = warp; gl < g; gl += WARPS)
    for (int c = lane; c < nt; c += 32)
      out[gl * nn + cell0 + c] = res[c * gp + gl];
}

// the shared memory a launch of `tile` cells a block needs, allowed; 0
// if the tile is not a positive multiple of 4 or the block would not fit
size_t prepare(int tile, int nterms, int nptr, int g, cudaError_t& e) {
  const size_t smem = smem_bytes(tile, nterms, nptr, g);
  e = cudaSuccess;
  if (tile < 4 || tile % 4 != 0 || smem > SMEM_MAX) {
    e = cudaErrorInvalidValue;
    return 0;
  }
  e = cudaFuncSetAttribute(gather_sections_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  return smem;
}

}  // namespace gs
}  // namespace ecrad

// desc: host int32 array of ndesc entries, ptrs: host array of nptr
// device addresses (both copied into the launch's parameters); tab the
// sections' compacted float32 tables, out (g, n) float32; tile the cells
// of a block, a multiple of 4.
extern "C" int gather_sections(const int* desc, int ndesc,
                               const unsigned long long* ptrs, int nptr,
                               const float* tab, int n, int g, int tile,
                               float* out, void* stream) {
  using namespace ecrad::gs;
  if (ndesc < HDR || ndesc > MAX_DESC || nptr < 0 || nptr > MAX_PTR ||
      desc[3] != nptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const size_t smem = prepare(tile, desc[2], nptr, g, e);
  if (e != cudaSuccess) return (int)e;
  Params P = {};
  for (int i = 0; i < ndesc; ++i) P.v[i] = desc[i];
  for (int i = 0; i < nptr; ++i)
    P.p[i] = reinterpret_cast<const void*>(static_cast<uintptr_t>(ptrs[i]));
  if (n > 0)
    gather_sections_kernel<<<(n + tile - 1) / tile, BLOCK, smem,
                             (cudaStream_t)stream>>>(P, tab, n, g, tile, out);
  return (int)cudaGetLastError();
}

// B10's resources and the blocks per SM its launch gets (kernel_info.cuh)
// for a call of nterms terms, nptr operands and g outputs a cell
extern "C" int gather_sections_info(int tile, int nterms, int nptr, int g,
                                    int* info) {
  using namespace ecrad;
  cudaError_t e;
  const size_t smem = gs::prepare(tile, nterms, nptr, g, e);
  if (e != cudaSuccess) return (int)e;
  return kernel_info(gs::gather_sections_kernel, gs::BLOCK, smem, info);
}
