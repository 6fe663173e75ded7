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
// Semantics: solvers/adding.py adding_sw_plain,
// lw_no_scattering_fluxes_plain and adding_lw_plain, operation for
// operation (built with -fmad=false: bit-identical); 1/denom is recomputed
// in the descent rather than stored (as adding_fused.py does).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace ecrad {

constexpr int SWEEP_THREADS = 256;
// the adding sweeps: one warp per block, KEPT floats per level of up to
// SW_ONCHIP_LEVELS / LW_ONCHIP_LEVELS levels in shared memory
// (ops/adding_fused.py has the same numbers), and a ring of RING_GROUPS x
// RING_GROUP floats per thread for the operands copied ahead
constexpr int ADD_THREADS = 32;
constexpr int SW_ONCHIP_LEVELS = 256, LW_ONCHIP_LEVELS = 160;
constexpr int RING_GROUP = 16, RING_GROUPS = 4;
constexpr int KEPT = 2;

// the per-level values the ascent leaves for the descent: levels
// [lo, nlev) in shared memory ([field][level - lo][lane]), levels [0, lo)
// (SPILL only) in the device-memory scratch ([field][level] profiles of m
// floats)
template <bool SPILL>
struct Kept {
  float* smem;
  float* spill;
  int lo, keff;
  size_t m, i;
  int lane;
  __device__ __forceinline__ void put(int l, int f, float v) const {
    if (!SPILL || l >= lo)
      smem[(f * keff + (l - lo)) * ADD_THREADS + lane] = v;
    else
      spill[((size_t)f * lo + l) * m + i] = v;
  }
  __device__ __forceinline__ float get(int l, int f) const {
    return !SPILL || l >= lo
               ? smem[(f * keff + (l - lo)) * ADD_THREADS + lane]
               : spill[((size_t)f * lo + l) * m + i];
  }
};

// floats of shared memory an adding block takes for nlev levels: the kept
// values, then the ring
__host__ __device__ inline int kept_floats(int nlev, int onchip) {
  return KEPT * (nlev < onchip ? nlev : onchip)
         * ADD_THREADS;
}
inline size_t adding_smem_bytes(int nlev, int onchip) {
  return (kept_floats(nlev, onchip) + RING_GROUPS * RING_GROUP * ADD_THREADS)
         * sizeof(float);
}

// Calls body(j, v) for j = 0 .. count - 1, where v holds the OPS operands
// of level lev(j) (operand k at ops[k][lev(j) m + i]). Each thread copies
// its own operands with 4-byte cp.async into its slots of a ring of
// RING_GROUPS groups of RING_GROUP floats (a group: RING_GROUP / OPS
// levels, one commit), RING_GROUPS - 1 groups ahead, and reads them back
// itself: no barrier. ring = the block's ring + lane, float s of the ring
// at ring[s * ADD_THREADS].
template <int OPS, class Lev, class Body>
__device__ __forceinline__ void ring_sweep(const float* const (&ops)[OPS],
                                           size_t m, size_t i, int count,
                                           float* ring, Lev lev, Body body) {
  constexpr int LPG = RING_GROUP / OPS;
  const int groups = (count + LPG - 1) / LPG;
  const auto fetch = [&](int q) {
    if (q < groups) {
      float* dst = ring + (q % RING_GROUPS) * RING_GROUP * ADD_THREADS;
#pragma unroll
      for (int a = 0; a < LPG; ++a) {
        const int j = q * LPG + a;
        if (j < count) {
          const size_t o = (size_t)lev(j) * m + i;
#pragma unroll
          for (int k = 0; k < OPS; ++k)
            __pipeline_memcpy_async(dst + (a * OPS + k) * ADD_THREADS,
                                    ops[k] + o, sizeof(float));
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
    const float* got = ring + (q % RING_GROUPS) * RING_GROUP * ADD_THREADS;
#pragma unroll
    for (int a = 0; a < LPG; ++a) {
      const int j = q * LPG + a;
      if (j < count) {
        float v[OPS];
#pragma unroll
        for (int k = 0; k < OPS; ++k) v[k] = got[(a * OPS + k) * ADD_THREADS];
        body(j, v);
      }
    }
  }
  __pipeline_wait_prior(0);
}

template <bool SPILL>
__global__ void __launch_bounds__(ADD_THREADS)
sw_adding_kernel(const float* __restrict__ ref,
                 const float* __restrict__ trans,
                 const float* __restrict__ ref_dir,
                 const float* __restrict__ tdif,
                 const float* __restrict__ tdir,
                 const float* __restrict__ inc,
                 const float* __restrict__ alb_diff,
                 const float* __restrict__ alb_dir,
                 const float* __restrict__ cos_sza, int nlev, int ng,
                 int ncol, float* __restrict__ spill, float* __restrict__ up,
                 float* __restrict__ dn_diff, float* __restrict__ dn_dir) {
  extern __shared__ float kept_mem[];
  const size_t m = (size_t)ng * ncol;            // one level
  const size_t i = (size_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (i >= m) return;
  const int lo = SPILL ? nlev - SW_ONCHIP_LEVELS : 0;
  const Kept<SPILL> P{kept_mem, spill, lo, nlev - lo, m, i,
                      (int)threadIdx.x};
  float* ring =
      kept_mem + kept_floats(nlev, SW_ONCHIP_LEVELS) + threadIdx.x;
  const float cs = cos_sza[i % ncol];
  const auto down = [](int j) { return j; };
  const auto upward = [nlev](int j) { return nlev - 1 - j; };

  // 1) direct beam descent, perpendicular to the sun: the unscaled flux
  //    at each level's top into field 0, the scaled one out
  float fdir = inc[i];
  {
    const float* const ops[1] = {tdir};
    ring_sweep<1>(ops, m, i, nlev, ring, down, [&](int l, const float* v) {
      P.put(l, 0, fdir);
      dn_dir[l * m + i] = fdir * cs;
      fdir = v[0] * fdir;
    });
  }
  dn_dir[nlev * m + i] = fdir * cs;
  // 2) albedo and source ascent; level l leaves the albedo (field 1) and
  //    source (field 0, in place of the direct flux) below it
  float alb = alb_diff[i];
  float src = alb_dir[i] * fdir * cs;
  {
    const float* const ops[4] = {ref, trans, ref_dir, tdif};
    ring_sweep<4>(ops, m, i, nlev, ring, upward, [&](int j, const float* v) {
      const int l = nlev - 1 - j;
      const float r = v[0], t = v[1], fdt = P.get(l, 0);
      P.put(l, 0, src);
      P.put(l, 1, alb);
      const float inv_denom = 1.0f / (1.0f - alb * r);
      const float alb_new = r + t * t * alb * inv_denom;
      src = v[2] * fdt + t * (src + alb * v[3] * fdt) * inv_denom;
      alb = alb_new;
    });
  }
  // 3) diffuse descent, the direct flux recomputed as in 1); fluxes up
  //    from the albedo and source below
  float fd = 0.0f;
  dn_diff[i] = 0.0f;
  up[i] = alb * 0.0f + src;
  fdir = inc[i];
  {
    const float* const ops[4] = {ref, trans, tdif, tdir};
    ring_sweep<4>(ops, m, i, nlev, ring, down, [&](int l, const float* v) {
      const float r = v[0], a_below = P.get(l, 1), s_below = P.get(l, 0);
      const float fdt = fdir;
      fdir = v[3] * fdir;
      const float inv_denom = 1.0f / (1.0f - a_below * r);
      fd = (v[1] * fd + r * s_below + v[2] * fdt) * inv_denom;
      const size_t jb = (l + 1) * m + i;
      dn_diff[jb] = fd;
      up[jb] = a_below * fd + s_below;
    });
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS)
lw_noscat_kernel(const float* __restrict__ trans,
                 const float* __restrict__ src_up,
                 const float* __restrict__ src_dn,
                 const float* __restrict__ emission,
                 const float* __restrict__ albedo, int nlev, int ng, int ncol,
                 float* __restrict__ up, float* __restrict__ dn) {
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float fd = 0.0f;
  dn[i] = 0.0f;
  for (int l = 0; l < nlev; ++l) {
    fd = trans[l * m + i] * fd + src_dn[l * m + i];
    dn[(l + 1) * m + i] = fd;
  }
  float fu = emission[i] + albedo[i] * fd;
  up[nlev * m + i] = fu;
  for (int l = nlev - 1; l >= 0; --l) {
    fu = trans[l * m + i] * fu + src_up[l * m + i];
    up[l * m + i] = fu;
  }
}

template <bool SPILL>
__global__ void __launch_bounds__(ADD_THREADS)
lw_adding_kernel(const float* __restrict__ ref,
                 const float* __restrict__ trans,
                 const float* __restrict__ src_up,
                 const float* __restrict__ src_dn,
                 const float* __restrict__ emission,
                 const float* __restrict__ alb_surf, int nlev, int ng,
                 int ncol, float* __restrict__ spill, float* __restrict__ up,
                 float* __restrict__ dn) {
  extern __shared__ float kept_mem[];
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (i >= m) return;
  const int lo = SPILL ? nlev - LW_ONCHIP_LEVELS : 0;
  const Kept<SPILL> P{kept_mem, spill, lo, nlev - lo, m, i,
                      (int)threadIdx.x};
  float* ring =
      kept_mem + kept_floats(nlev, LW_ONCHIP_LEVELS) + threadIdx.x;
  // 1) albedo and source ascent from the surface; level l leaves
  //    (albedo, source) below it
  float alb = alb_surf[i];
  float src = emission[i];
  {
    const float* const ops[4] = {ref, trans, src_up, src_dn};
    ring_sweep<4>(ops, m, i, nlev, ring,
                  [nlev](int j) { return nlev - 1 - j; },
                  [&](int j, const float* v) {
      const int l = nlev - 1 - j;
      const float r = v[0], t = v[1];
      P.put(l, 0, alb);
      P.put(l, 1, src);
      const float inv_denom = 1.0f / (1.0f - alb * r);
      const float alb_new = r + t * t * alb * inv_denom;
      src = v[2] + t * (src + alb * v[3]) * inv_denom;
      alb = alb_new;
    });
  }
  // 2) flux descent from a dark TOA; upward flux from albedo/source
  float fd = 0.0f;
  dn[i] = 0.0f;
  up[i] = alb * 0.0f + src;
  {
    const float* const ops[3] = {ref, trans, src_dn};
    ring_sweep<3>(ops, m, i, nlev, ring, [](int j) { return j; },
                  [&](int l, const float* v) {
      const float r = v[0], a_below = P.get(l, 0), s_below = P.get(l, 1);
      const float inv_denom = 1.0f / (1.0f - a_below * r);
      fd = (v[1] * fd + r * s_below + v[2]) * inv_denom;
      const size_t jb = (l + 1) * m + i;
      dn[jb] = fd;
      up[jb] = a_below * fd + s_below;
    });
  }
}

// the adding kernels take up to 55 KB of dynamic shared memory, and as
// much of the SM's memory as shared memory as the carveout allows
template <class Kernel>
cudaError_t adding_attributes(Kernel kernel, int onchip) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)adding_smem_bytes(onchip, onchip));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace ecrad

extern "C" int sw_adding(const float* ref, const float* trans,
                         const float* ref_dir, const float* tdif,
                         const float* tdir, const float* inc,
                         const float* alb_diff, const float* alb_dir,
                         const float* cos_sza, int nlev, int ng, int ncol,
                         float* spill, float* up, float* dn_diff,
                         float* dn_dir, void* stream) {
  using namespace ecrad;
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const auto kernel = nlev > SW_ONCHIP_LEVELS ? sw_adding_kernel<true>
                                                : sw_adding_kernel<false>;
    cudaError_t e = adding_attributes(kernel, SW_ONCHIP_LEVELS);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (int)((m + ADD_THREADS - 1) / ADD_THREADS);
    kernel<<<blocks, ADD_THREADS, adding_smem_bytes(nlev, SW_ONCHIP_LEVELS),
             (cudaStream_t)stream>>>(
        ref, trans, ref_dir, tdif, tdir, inc, alb_diff, alb_dir, cos_sza,
        nlev, ng, ncol, spill, up, dn_diff, dn_dir);
  }
  return (int)cudaGetLastError();
}

extern "C" int lw_noscat(const float* trans, const float* src_up,
                         const float* src_dn, const float* emission,
                         const float* albedo, int nlev, int ng, int ncol,
                         float* up, float* dn, void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const int blocks = (int)((m + ecrad::SWEEP_THREADS - 1)
                             / ecrad::SWEEP_THREADS);
    ecrad::lw_noscat_kernel<<<blocks, ecrad::SWEEP_THREADS, 0,
                              (cudaStream_t)stream>>>(
        trans, src_up, src_dn, emission, albedo, nlev, ng, ncol, up, dn);
  }
  return (int)cudaGetLastError();
}

extern "C" int lw_adding(const float* ref, const float* trans,
                         const float* src_up, const float* src_dn,
                         const float* emission, const float* albedo, int nlev,
                         int ng, int ncol, float* spill, float* up,
                         float* dn, void* stream) {
  using namespace ecrad;
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const auto kernel = nlev > LW_ONCHIP_LEVELS ? lw_adding_kernel<true>
                                                : lw_adding_kernel<false>;
    cudaError_t e = adding_attributes(kernel, LW_ONCHIP_LEVELS);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (int)((m + ADD_THREADS - 1) / ADD_THREADS);
    kernel<<<blocks, ADD_THREADS, adding_smem_bytes(nlev, LW_ONCHIP_LEVELS),
             (cudaStream_t)stream>>>(
        ref, trans, src_up, src_dn, emission, albedo, nlev, ng, ncol, spill,
        up, dn);
  }
  return (int)cudaGetLastError();
}

namespace ecrad {
template <class Kernel>
int adding_info(Kernel kernel, int nlev, int onchip, int* info) {
  cudaError_t e = adding_attributes(kernel, onchip);
  if (e != cudaSuccess) return (int)e;
  return kernel_info(kernel, ADD_THREADS, adding_smem_bytes(nlev, onchip),
                     info);
}
}  // namespace ecrad

// Resources of kernel `which` (0 sw_adding, 1 lw_adding, 2 lw_noscat) at
// a launch over nlev levels (kernel_info.cuh)
extern "C" int level_sweep_info(int which, int nlev, int* info) {
  using namespace ecrad;
  if (which == 0)
    return adding_info(nlev > SW_ONCHIP_LEVELS ? sw_adding_kernel<true>
                                               : sw_adding_kernel<false>,
                       nlev, SW_ONCHIP_LEVELS, info);
  if (which == 1)
    return adding_info(nlev > LW_ONCHIP_LEVELS ? lw_adding_kernel<true>
                                               : lw_adding_kernel<false>,
                       nlev, LW_ONCHIP_LEVELS, info);
  if (which == 2)
    return kernel_info(lw_noscat_kernel, SWEEP_THREADS, 0, info);
  return (int)cudaErrorInvalidValue;
}
