// Kernel B10: weighted table-row interpolation of the per-band taumol path,
//   out[g, n] = sum over sections, over terms k:  w_k[n] * T_s[row_k[n], g].
//
// Replaces the TPU kernel ecrad_tpu/ops/gather_interp.py::
// _eval_sections_pallas (:191; pallas_call :267; body _pallas_kernel :115),
// which built weighted one-hot matrices in VMEM and contracted them with the
// tables on the MXU (an EtaSection as two one-hots and a two-stage product).
// Here the rows are gathered directly, as in B1/B2.
//
// What bounds it: the bytes. Each cell's rows and weights are read once
// (coalesced along N) and its G outputs written once (coalesced along N);
// the tables of one call (at most 256 KiB) are read through the read-only
// cache. One thread per cell builds its terms (flat-table offset, weight)
// into shared memory in phase 1 and sums them for each g in phase 2 with
// B1's gather core (taumol_common.cuh gather_sum). An EtaSection's flat row
// grid*R2 + go*R2 + eta + eo and weight gw*ew are formed here from the
// per-family (N,) grids, etas and per-offset weights: the go x eo products
// never go through device memory.
//
// Semantics: ops/gather_interp.py `eval_sections_plain` (the port of
// _eval_sections_reference :100-112): rows clipped to the table (for an
// EtaSection the FLAT row), terms summed in section order, then term order
// (family, grid offset, eta offset), starting from the first term; gw*ew is
// rounded before it multiplies the table value. Built with -fmad=false, the
// kernel equals its plain version bit for bit.
#include "taumol_common.cuh"

namespace ecrad {
namespace gs {

// ops/gather_interp.py MAX_DESC, PLAIN, ETA
constexpr int MAX_DESC = 512;
constexpr int PLAIN = 0;
constexpr int BLOCK = 128;           // threads (cells) per block

// The section descriptor (ops/gather_interp.py pack_sections), passed by
// value: it lives in the kernel's parameter space, read uniformly by every
// thread.
struct Desc {
  int v[MAX_DESC];
};

__device__ __forceinline__ int clip(int r, int nrow) {
  return r < 0 ? 0 : (r > nrow - 1 ? nrow - 1 : r);
}

__global__ void __launch_bounds__(BLOCK)
    gather_sections_kernel(const __grid_constant__ Desc d,
                           const int* __restrict__ rows,
                           const float* __restrict__ w,
                           const float* __restrict__ tab, int n, int g,
                           int stride, float* __restrict__ out) {
  extern __shared__ int smem[];
  int* sbase = smem + threadIdx.x * stride;
  float* sw = reinterpret_cast<float*>(smem + blockDim.x * stride) +
              threadIdx.x * stride;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const size_t nn = static_cast<size_t>(n);

  // phase 1: this cell's terms, in section and term order
  int k = 0;
  int p = 1;
  for (int s = 0; s < d.v[0]; ++s) {
    const int kind = d.v[p], off = d.v[p + 1], nrow = d.v[p + 2];
    if (kind == PLAIN) {
      const int nk = d.v[p + 3], r0 = d.v[p + 4], w0 = d.v[p + 5];
      p += 6;
      for (int j = 0; j < nk; ++j) {
        const int row = clip(__ldg(rows + (r0 + j) * nn + cell), nrow);
        sbase[k] = off + row * g;
        sw[k] = __ldg(w + (w0 + j) * nn + cell);
        ++k;
      }
    } else {
      const int r2 = d.v[p + 3], nfam = d.v[p + 4];
      p += 5;
      for (int f = 0; f < nfam; ++f) {
        const int grow = d.v[p], erow = d.v[p + 1], ngo = d.v[p + 2];
        const int gw0 = d.v[p + 3], neo = d.v[p + 4], ew0 = d.v[p + 5];
        const int* go = &d.v[p + 6];
        const int* eo = go + ngo;
        p += 6 + ngo + neo;
        const int base = __ldg(rows + grow * nn + cell) * r2;
        const int eta = __ldg(rows + erow * nn + cell);
        for (int i = 0; i < ngo; ++i) {
          const float gw = __ldg(w + (gw0 + i) * nn + cell);
          for (int j = 0; j < neo; ++j) {
            const float ew = __ldg(w + (ew0 + j) * nn + cell);
            const int row = clip(base + go[i] * r2 + eta + eo[j], nrow);
            sbase[k] = off + row * g;
            sw[k] = gw * ew;
            ++k;
          }
        }
      }
    }
  }
  // phase 2: one output per g, stored coalesced along N
  for (int gl = 0; gl < g; ++gl)
    out[gl * nn + cell] = gather_sum(tab, sbase, sw, 0, k, gl);
}

}  // namespace gs
}  // namespace ecrad

// desc: host int32 array of ndesc entries (copied into the launch's
// parameters); rows (KR, n) int32, w (KW, n) float32, tab the sections'
// flat float32 tables, out (g, n) float32; nterms the number of terms.
extern "C" int gather_sections(const int* desc, const int* rows,
                               const float* w, const float* tab, int n,
                               int g, int nterms, int ndesc, float* out,
                               void* stream) {
  using namespace ecrad::gs;
  if (ndesc > MAX_DESC || ndesc < 1) return (int)cudaErrorInvalidValue;
  Desc d = {};
  for (int i = 0; i < ndesc; ++i) d.v[i] = desc[i];
  // an odd stride between threads' term lists: no shared-memory bank
  // conflicts in phase 2
  const int stride = nterms | 1;
  const size_t smem = static_cast<size_t>(BLOCK) * stride * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_sections_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    gather_sections_kernel<<<blocks, BLOCK, smem, (cudaStream_t)stream>>>(
        d, rows, w, tab, n, g, stride, out);
  }
  return (int)cudaGetLastError();
}
