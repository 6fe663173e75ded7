// Kernels B3 and B3': the adding level sweeps.
//
// Replaces the TPU kernel ecrad_tpu/ops/adding_fused.py::level_sweep (:38;
// pallas_call :125) in its uses adding_sw_fused (:144, three sweeps),
// affine_fused (:247, the two LW no-scattering sweeps) and, as B3',
// adding_lw_fused (:210, the LW albedo/source ascent and flux descent with
// scattering). On the TPU each
// sweep was a pallas_call whose grid walked the levels in order with the
// carry resident in VMEM. On the H100 one thread owns one (g, column)
// pair and runs its whole recurrence with the carry in registers, so the
// three SW sweeps are one kernel.
//
// What bounds them: device-memory bandwidth and, for the adding sweeps,
// latency. Operands are g-first (nlev, ng, ncol) with columns innermost,
// so the 32 threads of a warp touch 32 neighbouring floats of one level:
// every access is coalesced. The least bytes are each layer operand read
// once and each flux profile written once (SW 5 + 3 profiles, LW 4 + 2);
// LW no-scattering moves exactly those (3 + 2).
//
// The adding sweeps (sw_adding, lw_adding) keep what the ascent leaves for
// the descent on chip: per level the albedo and the source below the
// layer, 2 floats, so no scratch profile goes through device memory. SW
// moves 12 profiles (tdir read, the scaled direct flux written at once,
// the ascent's 4 operands, the descent's R, T, tdif and tdir, which
// recomputes the direct flux exactly as the first sweep does, and 2
// fluxes written), LW 9 (the descent re-reads R, T and the downward
// source). A third float per level on chip would save a profile or two
// but cost a block per SM: with one warp per block each thread's
// recurrence is a latency chain, and the warps and copies in flight set
// the rate. The values of up to SW_ONCHIP_LEVELS / LW_ONCHIP_LEVELS levels
// sit in shared memory (5 blocks per SM at 137 levels, fewer as nlev
// grows); the levels above them go to a device-memory scratch in the same
// kernel (the SPILL instantiation), whose reads of those levels' values
// wait on device memory: SW, with three such reads per level, keeps more
// levels on chip. Each thread copies its own operands with 4-byte
// cp.async into a ring of RING_GROUPS groups of RING_GROUP floats, 3
// groups ahead (SW's ascent 12 levels), and reads them back itself: no
// barrier.
//
// Each kernel is a template on the scalar type: the float forms are the
// float32 path's, the double forms (entry points *_f64) the float64
// path's, the same code at twice the bytes a value, the adding sweeps
// with windows of their own (F64_SW_ONCHIP_LEVELS, F64_LW_ONCHIP_LEVELS).
// The sweeps take no exp and one or two divisions a level, so the double
// forms are bound by bytes and latency as the float ones are.
//
// Semantics: solvers/adding.py adding_sw_plain,
// lw_no_scattering_fluxes_plain and adding_lw_plain, operation for
// operation (built with -fmad=false: bit-identical); 1/denom is recomputed
// in the descent rather than stored (as adding_fused.py does).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace ecrad {

constexpr int SWEEP_THREADS = 256;
// the adding sweeps: one warp per block, KEPT values per level of up to
// SW_ONCHIP_LEVELS / LW_ONCHIP_LEVELS levels in shared memory
// (ops/adding_fused.py has the same numbers), and a ring of RING_GROUPS x
// RING_GROUP values per thread for the operands copied ahead
constexpr int ADD_THREADS = 32;
constexpr int SW_ONCHIP_LEVELS = 256, LW_ONCHIP_LEVELS = 160;
// the double forms' windows (ops/adding_fused.py has the same numbers):
// a double level takes twice a float one's shared memory, so at 137
// levels the whole profile on chip leaves 2 blocks (2 warps) per SM. SW
// keeps it all the same: each level it spills costs three device-memory
// reads, and at 137 levels 2 blocks with none spilled beat 3-5 blocks with
// 41-89 spilled by 1.6-2.4x on an H100. LW, whose spilled level costs two,
// keeps 96 levels at 3 blocks per SM: 9 % faster than all 137 on chip at
// 2, and than 64 or 48 at 4 or 5 (each window timed at 137 levels)
constexpr int F64_SW_ONCHIP_LEVELS = 256, F64_LW_ONCHIP_LEVELS = 96;
constexpr int RING_GROUP = 16, RING_GROUPS = 4;
constexpr int KEPT = 2;

// the on-chip windows of the float and double forms
template <typename T>
struct Window;
template <>
struct Window<float> {
  static constexpr int sw = SW_ONCHIP_LEVELS, lw = LW_ONCHIP_LEVELS;
};
template <>
struct Window<double> {
  static constexpr int sw = F64_SW_ONCHIP_LEVELS, lw = F64_LW_ONCHIP_LEVELS;
};

// the per-level values the ascent leaves for the descent: levels
// [lo, nlev) in shared memory ([field][level - lo][lane]), levels [0, lo)
// (SPILL only) in the device-memory scratch ([field][level] profiles of m
// values)
template <typename T, bool SPILL>
struct Kept {
  T* smem;
  T* spill;
  int lo, keff;
  size_t m, i;
  int lane;
  __device__ __forceinline__ void put(int l, int f, T v) const {
    if (!SPILL || l >= lo)
      smem[(f * keff + (l - lo)) * ADD_THREADS + lane] = v;
    else
      spill[((size_t)f * lo + l) * m + i] = v;
  }
  __device__ __forceinline__ T get(int l, int f) const {
    return !SPILL || l >= lo
               ? smem[(f * keff + (l - lo)) * ADD_THREADS + lane]
               : spill[((size_t)f * lo + l) * m + i];
  }
};

// an adding block's dynamic shared memory as T: extern arrays of one name
// must share a type, so each scalar type has its own
template <typename T>
__device__ __forceinline__ T* kept_smem();
template <>
__device__ __forceinline__ float* kept_smem<float>() {
  extern __shared__ float kept_mem[];
  return kept_mem;
}
template <>
__device__ __forceinline__ double* kept_smem<double>() {
  extern __shared__ double kept_mem_f64[];
  return kept_mem_f64;
}

// values of shared memory an adding block takes for nlev levels: the kept
// values, then the ring
__host__ __device__ inline int kept_values(int nlev, int onchip) {
  return KEPT * (nlev < onchip ? nlev : onchip)
         * ADD_THREADS;
}
template <typename T>
inline size_t adding_smem_bytes(int nlev, int onchip) {
  return (kept_values(nlev, onchip) + RING_GROUPS * RING_GROUP * ADD_THREADS)
         * sizeof(T);
}

// Calls body(j, v) for j = 0 .. count - 1, where v holds the OPS operands
// of level lev(j) (operand k at ops[k][lev(j) m + i]). Each thread copies
// its own operands with cp.async of one value into its slots of a ring of
// RING_GROUPS groups of RING_GROUP values (a group: RING_GROUP / OPS
// levels, one commit), RING_GROUPS - 1 groups ahead, and reads them back
// itself: no barrier. ring = the block's ring + lane, value s of the ring
// at ring[s * ADD_THREADS].
template <typename T, int OPS, class Lev, class Body>
__device__ __forceinline__ void ring_sweep(const T* const (&ops)[OPS],
                                           size_t m, size_t i, int count,
                                           T* ring, Lev lev, Body body) {
  constexpr int LPG = RING_GROUP / OPS;
  const int groups = (count + LPG - 1) / LPG;
  const auto fetch = [&](int q) {
    if (q < groups) {
      T* dst = ring + (q % RING_GROUPS) * RING_GROUP * ADD_THREADS;
#pragma unroll
      for (int a = 0; a < LPG; ++a) {
        const int j = q * LPG + a;
        if (j < count) {
          const size_t o = (size_t)lev(j) * m + i;
#pragma unroll
          for (int k = 0; k < OPS; ++k)
            __pipeline_memcpy_async(dst + (a * OPS + k) * ADD_THREADS,
                                    ops[k] + o, sizeof(T));
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int q = 0; q < RING_GROUPS - 1; ++q) fetch(q);
  for (int q = 0; q < groups; ++q) {
    // group q has landed; the group the next copies go to was read in the
    // previous step
    __pipeline_wait_prior(RING_GROUPS - 2);
    fetch(q + RING_GROUPS - 1);
    const T* got = ring + (q % RING_GROUPS) * RING_GROUP * ADD_THREADS;
#pragma unroll
    for (int a = 0; a < LPG; ++a) {
      const int j = q * LPG + a;
      if (j < count) {
        T v[OPS];
#pragma unroll
        for (int k = 0; k < OPS; ++k) v[k] = got[(a * OPS + k) * ADD_THREADS];
        body(j, v);
      }
    }
  }
  __pipeline_wait_prior(0);
}

template <typename T, bool SPILL>
__global__ void __launch_bounds__(ADD_THREADS)
sw_adding_kernel(const T* __restrict__ ref,
                 const T* __restrict__ trans,
                 const T* __restrict__ ref_dir,
                 const T* __restrict__ tdif,
                 const T* __restrict__ tdir,
                 const T* __restrict__ inc,
                 const T* __restrict__ alb_diff,
                 const T* __restrict__ alb_dir,
                 const T* __restrict__ cos_sza, int nlev, int ng,
                 int ncol, T* __restrict__ spill, T* __restrict__ up,
                 T* __restrict__ dn_diff, T* __restrict__ dn_dir) {
  T* kept_mem = kept_smem<T>();
  const size_t m = (size_t)ng * ncol;            // one level
  const size_t i = (size_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (i >= m) return;
  const int lo = SPILL ? nlev - Window<T>::sw : 0;
  const Kept<T, SPILL> P{kept_mem, spill, lo, nlev - lo, m, i,
                         (int)threadIdx.x};
  T* ring = kept_mem + kept_values(nlev, Window<T>::sw) + threadIdx.x;
  const T cs = cos_sza[i % ncol];
  const auto down = [](int j) { return j; };
  const auto upward = [nlev](int j) { return nlev - 1 - j; };

  // 1) direct beam descent, perpendicular to the sun: the unscaled flux
  //    at each level's top into field 0, the scaled one out
  T fdir = inc[i];
  {
    const T* const ops[1] = {tdir};
    ring_sweep<T, 1>(ops, m, i, nlev, ring, down, [&](int l, const T* v) {
      P.put(l, 0, fdir);
      dn_dir[l * m + i] = fdir * cs;
      fdir = v[0] * fdir;
    });
  }
  dn_dir[nlev * m + i] = fdir * cs;
  // 2) albedo and source ascent; level l leaves the albedo (field 1) and
  //    source (field 0, in place of the direct flux) below it
  T alb = alb_diff[i];
  T src = alb_dir[i] * fdir * cs;
  {
    const T* const ops[4] = {ref, trans, ref_dir, tdif};
    ring_sweep<T, 4>(ops, m, i, nlev, ring, upward,
                     [&](int j, const T* v) {
      const int l = nlev - 1 - j;
      const T r = v[0], t = v[1], fdt = P.get(l, 0);
      P.put(l, 0, src);
      P.put(l, 1, alb);
      const T inv_denom = T(1) / (T(1) - alb * r);
      const T alb_new = r + t * t * alb * inv_denom;
      src = v[2] * fdt + t * (src + alb * v[3] * fdt) * inv_denom;
      alb = alb_new;
    });
  }
  // 3) diffuse descent, the direct flux recomputed as in 1); fluxes up
  //    from the albedo and source below
  T fd = T(0);
  dn_diff[i] = T(0);
  up[i] = alb * T(0) + src;
  fdir = inc[i];
  {
    const T* const ops[4] = {ref, trans, tdif, tdir};
    ring_sweep<T, 4>(ops, m, i, nlev, ring, down, [&](int l, const T* v) {
      const T r = v[0], a_below = P.get(l, 1), s_below = P.get(l, 0);
      const T fdt = fdir;
      fdir = v[3] * fdir;
      const T inv_denom = T(1) / (T(1) - a_below * r);
      fd = (v[1] * fd + r * s_below + v[2] * fdt) * inv_denom;
      const size_t jb = (l + 1) * m + i;
      dn_diff[jb] = fd;
      up[jb] = a_below * fd + s_below;
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
lw_noscat_kernel(const T* __restrict__ trans,
                 const T* __restrict__ src_up,
                 const T* __restrict__ src_dn,
                 const T* __restrict__ emission,
                 const T* __restrict__ albedo, int nlev, int ng, int ncol,
                 T* __restrict__ up, T* __restrict__ dn) {
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T fd = T(0);
  dn[i] = T(0);
  for (int l = 0; l < nlev; ++l) {
    fd = trans[l * m + i] * fd + src_dn[l * m + i];
    dn[(l + 1) * m + i] = fd;
  }
  T fu = emission[i] + albedo[i] * fd;
  up[nlev * m + i] = fu;
  for (int l = nlev - 1; l >= 0; --l) {
    fu = trans[l * m + i] * fu + src_up[l * m + i];
    up[l * m + i] = fu;
  }
}

template <typename T, bool SPILL>
__global__ void __launch_bounds__(ADD_THREADS)
lw_adding_kernel(const T* __restrict__ ref,
                 const T* __restrict__ trans,
                 const T* __restrict__ src_up,
                 const T* __restrict__ src_dn,
                 const T* __restrict__ emission,
                 const T* __restrict__ alb_surf, int nlev, int ng,
                 int ncol, T* __restrict__ spill, T* __restrict__ up,
                 T* __restrict__ dn) {
  T* kept_mem = kept_smem<T>();
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (i >= m) return;
  const int lo = SPILL ? nlev - Window<T>::lw : 0;
  const Kept<T, SPILL> P{kept_mem, spill, lo, nlev - lo, m, i,
                         (int)threadIdx.x};
  T* ring = kept_mem + kept_values(nlev, Window<T>::lw) + threadIdx.x;
  // 1) albedo and source ascent from the surface; level l leaves
  //    (albedo, source) below it
  T alb = alb_surf[i];
  T src = emission[i];
  {
    const T* const ops[4] = {ref, trans, src_up, src_dn};
    ring_sweep<T, 4>(ops, m, i, nlev, ring,
                     [nlev](int j) { return nlev - 1 - j; },
                     [&](int j, const T* v) {
      const int l = nlev - 1 - j;
      const T r = v[0], t = v[1];
      P.put(l, 0, alb);
      P.put(l, 1, src);
      const T inv_denom = T(1) / (T(1) - alb * r);
      const T alb_new = r + t * t * alb * inv_denom;
      src = v[2] + t * (src + alb * v[3]) * inv_denom;
      alb = alb_new;
    });
  }
  // 2) flux descent from a dark TOA; upward flux from albedo/source
  T fd = T(0);
  dn[i] = T(0);
  up[i] = alb * T(0) + src;
  {
    const T* const ops[3] = {ref, trans, src_dn};
    ring_sweep<T, 3>(ops, m, i, nlev, ring, [](int j) { return j; },
                     [&](int l, const T* v) {
      const T r = v[0], a_below = P.get(l, 0), s_below = P.get(l, 1);
      const T inv_denom = T(1) / (T(1) - a_below * r);
      fd = (v[1] * fd + r * s_below + v[2]) * inv_denom;
      const size_t jb = (l + 1) * m + i;
      dn[jb] = fd;
      up[jb] = a_below * fd + s_below;
    });
  }
}

// the adding kernels take the dynamic shared memory of their window, and
// as much of the SM's memory as shared memory as the carveout allows
template <typename T, class Kernel>
cudaError_t adding_attributes(Kernel kernel, int onchip) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)adding_smem_bytes<T>(onchip, onchip));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int sw_adding_launch(const T* ref, const T* trans, const T* ref_dir,
                     const T* tdif, const T* tdir, const T* inc,
                     const T* alb_diff, const T* alb_dir, const T* cos_sza,
                     int nlev, int ng, int ncol, T* spill, T* up, T* dn_diff,
                     T* dn_dir, void* stream) {
  const size_t m = (size_t)ng * ncol;
  constexpr int onchip = Window<T>::sw;
  if (m > 0) {
    const auto kernel = nlev > onchip ? sw_adding_kernel<T, true>
                                      : sw_adding_kernel<T, false>;
    cudaError_t e = adding_attributes<T>(kernel, onchip);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (int)((m + ADD_THREADS - 1) / ADD_THREADS);
    kernel<<<blocks, ADD_THREADS, adding_smem_bytes<T>(nlev, onchip),
             (cudaStream_t)stream>>>(
        ref, trans, ref_dir, tdif, tdir, inc, alb_diff, alb_dir, cos_sza,
        nlev, ng, ncol, spill, up, dn_diff, dn_dir);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int lw_noscat_launch(const T* trans, const T* src_up, const T* src_dn,
                     const T* emission, const T* albedo, int nlev, int ng,
                     int ncol, T* up, T* dn, void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const int blocks = (int)((m + SWEEP_THREADS - 1) / SWEEP_THREADS);
    lw_noscat_kernel<T><<<blocks, SWEEP_THREADS, 0, (cudaStream_t)stream>>>(
        trans, src_up, src_dn, emission, albedo, nlev, ng, ncol, up, dn);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int lw_adding_launch(const T* ref, const T* trans, const T* src_up,
                     const T* src_dn, const T* emission, const T* albedo,
                     int nlev, int ng, int ncol, T* spill, T* up, T* dn,
                     void* stream) {
  const size_t m = (size_t)ng * ncol;
  constexpr int onchip = Window<T>::lw;
  if (m > 0) {
    const auto kernel = nlev > onchip ? lw_adding_kernel<T, true>
                                      : lw_adding_kernel<T, false>;
    cudaError_t e = adding_attributes<T>(kernel, onchip);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (int)((m + ADD_THREADS - 1) / ADD_THREADS);
    kernel<<<blocks, ADD_THREADS, adding_smem_bytes<T>(nlev, onchip),
             (cudaStream_t)stream>>>(
        ref, trans, src_up, src_dn, emission, albedo, nlev, ng, ncol, spill,
        up, dn);
  }
  return (int)cudaGetLastError();
}

template <typename T, class Kernel>
int adding_info(Kernel kernel, int nlev, int onchip, int* info) {
  cudaError_t e = adding_attributes<T>(kernel, onchip);
  if (e != cudaSuccess) return (int)e;
  return kernel_info(kernel, ADD_THREADS, adding_smem_bytes<T>(nlev, onchip),
                     info);
}

template <typename T>
int level_sweep_info_of(int which, int nlev, int* info) {
  constexpr int sw = Window<T>::sw, lw = Window<T>::lw;
  if (which == 0)
    return adding_info<T>(nlev > sw ? sw_adding_kernel<T, true>
                                    : sw_adding_kernel<T, false>,
                          nlev, sw, info);
  if (which == 1)
    return adding_info<T>(nlev > lw ? lw_adding_kernel<T, true>
                                    : lw_adding_kernel<T, false>,
                          nlev, lw, info);
  if (which == 2)
    return kernel_info(lw_noscat_kernel<T>, SWEEP_THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ecrad

extern "C" int sw_adding(const float* ref, const float* trans,
                         const float* ref_dir, const float* tdif,
                         const float* tdir, const float* inc,
                         const float* alb_diff, const float* alb_dir,
                         const float* cos_sza, int nlev, int ng, int ncol,
                         float* spill, float* up, float* dn_diff,
                         float* dn_dir, void* stream) {
  return ecrad::sw_adding_launch<float>(ref, trans, ref_dir, tdif, tdir, inc,
                                        alb_diff, alb_dir, cos_sza, nlev, ng,
                                        ncol, spill, up, dn_diff, dn_dir,
                                        stream);
}

// the double form, the float64 path's
extern "C" int sw_adding_f64(const double* ref, const double* trans,
                             const double* ref_dir, const double* tdif,
                             const double* tdir, const double* inc,
                             const double* alb_diff, const double* alb_dir,
                             const double* cos_sza, int nlev, int ng,
                             int ncol, double* spill, double* up,
                             double* dn_diff, double* dn_dir, void* stream) {
  return ecrad::sw_adding_launch<double>(ref, trans, ref_dir, tdif, tdir,
                                         inc, alb_diff, alb_dir, cos_sza,
                                         nlev, ng, ncol, spill, up, dn_diff,
                                         dn_dir, stream);
}

extern "C" int lw_noscat(const float* trans, const float* src_up,
                         const float* src_dn, const float* emission,
                         const float* albedo, int nlev, int ng, int ncol,
                         float* up, float* dn, void* stream) {
  return ecrad::lw_noscat_launch<float>(trans, src_up, src_dn, emission,
                                        albedo, nlev, ng, ncol, up, dn,
                                        stream);
}

extern "C" int lw_noscat_f64(const double* trans, const double* src_up,
                             const double* src_dn, const double* emission,
                             const double* albedo, int nlev, int ng,
                             int ncol, double* up, double* dn,
                             void* stream) {
  return ecrad::lw_noscat_launch<double>(trans, src_up, src_dn, emission,
                                         albedo, nlev, ng, ncol, up, dn,
                                         stream);
}

extern "C" int lw_adding(const float* ref, const float* trans,
                         const float* src_up, const float* src_dn,
                         const float* emission, const float* albedo, int nlev,
                         int ng, int ncol, float* spill, float* up,
                         float* dn, void* stream) {
  return ecrad::lw_adding_launch<float>(ref, trans, src_up, src_dn,
                                        emission, albedo, nlev, ng, ncol,
                                        spill, up, dn, stream);
}

extern "C" int lw_adding_f64(const double* ref, const double* trans,
                             const double* src_up, const double* src_dn,
                             const double* emission, const double* albedo,
                             int nlev, int ng, int ncol, double* spill,
                             double* up, double* dn, void* stream) {
  return ecrad::lw_adding_launch<double>(ref, trans, src_up, src_dn,
                                         emission, albedo, nlev, ng, ncol,
                                         spill, up, dn, stream);
}

// Resources of kernel `which` (0 sw_adding, 1 lw_adding, 2 lw_noscat) at
// a launch over nlev levels (kernel_info.cuh), of the float and of the
// double form
extern "C" int level_sweep_info(int which, int nlev, int* info) {
  return ecrad::level_sweep_info_of<float>(which, nlev, info);
}
extern "C" int level_sweep_info_f64(int which, int nlev, int* info) {
  return ecrad::level_sweep_info_of<double>(which, nlev, info);
}
