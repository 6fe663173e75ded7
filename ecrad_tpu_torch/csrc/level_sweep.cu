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
// What bounds it: device-memory bandwidth. Operands are g-first
// (nlev, ng, ncol) with columns innermost, so the 32 threads of a warp
// touch 32 neighbouring floats of one level: every access is coalesced.
// SW reads 5 layer operands (the descent re-reads 4 of them) and writes
// 3 flux profiles plus 2 scratch profiles (albedo and source below each
// half level); LW no-scattering reads 3 and writes 2; LW adding reads 4
// (the descent re-reads 3), writes 2 fluxes and 2 scratch profiles.
//
// Semantics: solvers/adding.py adding_sw_plain,
// lw_no_scattering_fluxes_plain and adding_lw_plain, operation for
// operation; 1/denom is recomputed in the descent rather than stored (as
// adding_fused.py does).
#include <cuda_runtime.h>

namespace ecrad {

constexpr int SWEEP_THREADS = 256;

__global__ void __launch_bounds__(SWEEP_THREADS)
sw_adding_kernel(const float* __restrict__ ref, const float* __restrict__ trans,
                 const float* __restrict__ ref_dir,
                 const float* __restrict__ tdif, const float* __restrict__ tdir,
                 const float* __restrict__ inc,
                 const float* __restrict__ alb_diff,
                 const float* __restrict__ alb_dir,
                 const float* __restrict__ cos_sza, int nlev, int ng,
                 int ncol, float* __restrict__ albedo,
                 float* __restrict__ source, float* __restrict__ up,
                 float* __restrict__ dn_diff, float* __restrict__ dn_dir) {
  const size_t m = (size_t)ng * ncol;            // one level
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float cs = cos_sza[i % ncol];

  // 1) direct beam descent, perpendicular to the sun (kept unscaled in
  //    dn_dir until the diffuse descent has used it)
  float fdir = inc[i];
  dn_dir[i] = fdir;
  for (int l = 0; l < nlev; ++l) {
    fdir = tdir[l * m + i] * fdir;
    dn_dir[(l + 1) * m + i] = fdir;
  }
  // 2) albedo and source ascent
  float alb = alb_diff[i];
  float src = alb_dir[i] * fdir * cs;
  albedo[nlev * m + i] = alb;
  source[nlev * m + i] = src;
  for (int l = nlev - 1; l >= 0; --l) {
    const size_t j = l * m + i;
    const float r = ref[j], t = trans[j], fdt = dn_dir[j];
    const float inv_denom = 1.0f / (1.0f - alb * r);
    const float alb_new = r + t * t * alb * inv_denom;
    src = ref_dir[j] * fdt + t * (src + alb * tdif[j] * fdt) * inv_denom;
    alb = alb_new;
    albedo[j] = alb;
    source[j] = src;
  }
  // 3) diffuse descent; fluxes up from albedo/source, direct scaled
  float fd = 0.0f;
  dn_diff[i] = 0.0f;
  up[i] = albedo[i] * 0.0f + source[i];
  for (int l = 0; l < nlev; ++l) {
    const size_t j = l * m + i, jb = (l + 1) * m + i;
    const float r = ref[j], a_below = albedo[jb], s_below = source[jb];
    const float fdt = dn_dir[j];
    const float inv_denom = 1.0f / (1.0f - a_below * r);
    fd = (trans[j] * fd + r * s_below + tdif[j] * fdt) * inv_denom;
    dn_diff[jb] = fd;
    up[jb] = a_below * fd + s_below;
    dn_dir[j] = fdt * cs;
  }
  dn_dir[nlev * m + i] = dn_dir[nlev * m + i] * cs;
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

__global__ void __launch_bounds__(SWEEP_THREADS)
lw_adding_kernel(const float* __restrict__ ref,
                 const float* __restrict__ trans,
                 const float* __restrict__ src_up,
                 const float* __restrict__ src_dn,
                 const float* __restrict__ emission,
                 const float* __restrict__ alb_surf, int nlev, int ng,
                 int ncol, float* __restrict__ albedo,
                 float* __restrict__ source, float* __restrict__ up,
                 float* __restrict__ dn) {
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  // 1) albedo and source ascent from the surface
  float alb = alb_surf[i];
  float src = emission[i];
  albedo[nlev * m + i] = alb;
  source[nlev * m + i] = src;
  for (int l = nlev - 1; l >= 0; --l) {
    const size_t j = l * m + i;
    const float r = ref[j], t = trans[j];
    const float inv_denom = 1.0f / (1.0f - alb * r);
    const float alb_new = r + t * t * alb * inv_denom;
    src = src_up[j] + t * (src + alb * src_dn[j]) * inv_denom;
    alb = alb_new;
    albedo[j] = alb;
    source[j] = src;
  }
  // 2) flux descent from a dark TOA; upward flux from albedo/source
  float fd = 0.0f;
  dn[i] = 0.0f;
  up[i] = albedo[i] * 0.0f + source[i];
  for (int l = 0; l < nlev; ++l) {
    const size_t j = l * m + i, jb = (l + 1) * m + i;
    const float r = ref[j], a_below = albedo[jb], s_below = source[jb];
    const float inv_denom = 1.0f / (1.0f - a_below * r);
    fd = (trans[j] * fd + r * s_below + src_dn[j]) * inv_denom;
    dn[jb] = fd;
    up[jb] = a_below * fd + s_below;
  }
}

}  // namespace ecrad

extern "C" int sw_adding(const float* ref, const float* trans,
                         const float* ref_dir, const float* tdif,
                         const float* tdir, const float* inc,
                         const float* alb_diff, const float* alb_dir,
                         const float* cos_sza, int nlev, int ng, int ncol,
                         float* scratch, float* up, float* dn_diff,
                         float* dn_dir, void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const int blocks = (int)((m + ecrad::SWEEP_THREADS - 1)
                             / ecrad::SWEEP_THREADS);
    ecrad::sw_adding_kernel<<<blocks, ecrad::SWEEP_THREADS, 0,
                              (cudaStream_t)stream>>>(
        ref, trans, ref_dir, tdif, tdir, inc, alb_diff, alb_dir, cos_sza,
        nlev, ng, ncol, scratch, scratch + (size_t)(nlev + 1) * m, up,
        dn_diff, dn_dir);
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
                         int ng, int ncol, float* scratch, float* up,
                         float* dn, void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m > 0) {
    const int blocks = (int)((m + ecrad::SWEEP_THREADS - 1)
                             / ecrad::SWEEP_THREADS);
    ecrad::lw_adding_kernel<<<blocks, ecrad::SWEEP_THREADS, 0,
                              (cudaStream_t)stream>>>(
        ref, trans, src_up, src_dn, emission, albedo, nlev, ng, ncol,
        scratch, scratch + (size_t)(nlev + 1) * m, up, dn);
  }
  return (int)cudaGetLastError();
}
