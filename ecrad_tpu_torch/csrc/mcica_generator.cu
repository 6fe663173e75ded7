// McICA's stochastic cloud generator in one launch a generator call: the
// cumulative cloud cover, each subcolumn's Markov walk down the levels and
// the draw from the cloud water PDF.
//
// Replaces no TPU kernel: the JAX package's generator
// (ecrad_tpu/solvers/cloud_generator.py, cloud_cover.py, pdf_sampler.py)
// is lax.scan and while_loop under vmap, which XLA compiles into its own
// loops. The port's plain version is solvers/cloud_generator.py
// (cloud_generator_plain): the cover, the walk and the sample as tensor
// passes over (ncol, nlev, ng), level loops issued from Python and a host
// sync before each pass of the Exp-Exp merge loop. This kernel computes
// the same function, column by column as ecRad's Fortran does
// (cum_cloud_cover_exp_exp, then generate_column's level loop with the
// PDF draw inside it), from the same uniforms (csrc/threefry.cu).
//
// What bounds it: bytes. Per (column, level, g-point) it reads three
// uniforms (rand_cloud, u1, u2) and writes one optical-depth scaling; the
// per-column inputs are 1/ng of that. For both generator calls of a McICA
// radiation call at 2048 x 137 (112 + 140 g-points) that is 2048 x 137 x
// 252 x 4 values, 1.13 GB in float32 (0.34 ms at 3.35 TB/s) and 2.26 GB
// in float64 (0.68 ms). The arithmetic, about 150 operations a cloudy
// cell (ndtri, two degree-16 Clenshaw sums, two exps), is 0.1-0.2 ms at
// the float32 rate. The design:
// - one block per column; the column's state (fraction, pair and
//   cumulative cover, the Exp-Exp objects, the inhomogeneity overlap and
//   each level's PDF row and weight) lives in dynamic shared memory and
//   is computed once a generator call, the level-parallel parts by the
//   whole block, the recurrences (object labelling, the within-object
//   cover, the ordered merges, the cumulative products) by one thread;
// - one thread per g-point then walks down the levels: the cloud-top
//   trigger, the Markov walk, the inhomogeneity draw and, on a cloudy
//   cell, the PDF sample in registers; it reads each uniform once, the
//   next level's loads issued before the current level's arithmetic, and
//   writes each scaling once, a warp's loads and stores contiguous along
//   g; a column without cloud only writes zeros.
// The arithmetic keeps the plain version's operation order (the library
// builds with -fmad=false): scalar divisors become products with their
// reciprocal as PyTorch's CUDA division by a Python number does, ndtri is
// Cephes' as torch.special.ndtri evaluates it on the card (its
// polynomials contracted to fma, as the run-time compiled kernel is), and
// the cumulative sum and product of the cover accumulate in double and
// round each output, as PyTorch's CPU cumsum and cumprod do. The card's
// plain path scans them in float in another order, so the two covers may
// differ by ulps.
#include <cuda_runtime.h>

#include "kernel_info.cuh"
#include "mcica_generator.cuh"

namespace ecrad {
namespace gen {

inline int threads_for(int ng) {
  return min(MAX_THREADS, max(32, (ng + 31) / 32 * 32));
}

// the dynamic shared memory of a launch at nlev levels, allowed past the
// default 48 KB where it needs more
template <typename T>
cudaError_t smem_for(int nlev, size_t* smem) {
  *smem = Layout(nlev).bytes<T>();
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mcica_generator_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename T>
int launch(const Args<T>& a, void* stream) {
  size_t smem = 0;
  const cudaError_t e = smem_for<T>(a.nlev, &smem);
  if (e != cudaSuccess) return (int)e;
  if (a.ncol > 0)
    mcica_generator_kernel<T><<<a.ncol, threads_for(a.ng), smem,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace gen
}  // namespace ecrad

// frac, fractional_std (ncol, nlev), overlap (ncol, nlev - 1), the
// uniforms rand_top (ncol, ng) and rand_cloud, u1, u2 (ncol, nlev, ng) in
// float (double in the _f64 form); cheb (nfsd, 17) float32, or NULL and
// val (ncdf, nfsd) in the scalar type; scheme a config.Overlap; the
// sampler's and the configuration's numbers as doubles (zsum = z0 + z1,
// zdiff = z1 - z0); outputs od_scaling (ncol, nlev, ng), total_cover
// (ncol,). nlev >= 1, ng >= 1.
template <typename T>
static int generator(const void* frac, const void* overlap, const void* fsd,
                     const void* rand_top, const void* rand_cloud,
                     const void* u1, const void* u2, const void* cheb,
                     const void* val, int ncol, int nlev, int ng, int scheme,
                     int beta, int nfsd, int ncdf, double frac_threshold,
                     double inv_decorr, double fsd1, double inv_fsd_interval,
                     double zsum, double zdiff, void* od_scaling,
                     void* total_cover, void* stream) {
  const ecrad::gen::Args<T> a = {
      (const T*)frac, (const T*)overlap, (const T*)fsd, (const T*)rand_top,
      (const T*)rand_cloud, (const T*)u1, (const T*)u2, (const float*)cheb,
      (const T*)val, ncol, nlev, ng, scheme, beta, nfsd, ncdf,
      frac_threshold, inv_decorr, fsd1, inv_fsd_interval, zsum, zdiff,
      (T*)od_scaling, (T*)total_cover};
  return ecrad::gen::launch(a, stream);
}

extern "C" int mcica_generator(
    const void* frac, const void* overlap, const void* fsd,
    const void* rand_top, const void* rand_cloud, const void* u1,
    const void* u2, const void* cheb, const void* val, int ncol, int nlev,
    int ng, int scheme, int beta, int nfsd, int ncdf, double frac_threshold,
    double inv_decorr, double fsd1, double inv_fsd_interval, double zsum,
    double zdiff, void* od_scaling, void* total_cover, void* stream) {
  return generator<float>(frac, overlap, fsd, rand_top, rand_cloud, u1, u2,
                          cheb, val, ncol, nlev, ng, scheme, beta, nfsd, ncdf,
                          frac_threshold, inv_decorr, fsd1, inv_fsd_interval,
                          zsum, zdiff, od_scaling, total_cover, stream);
}

extern "C" int mcica_generator_f64(
    const void* frac, const void* overlap, const void* fsd,
    const void* rand_top, const void* rand_cloud, const void* u1,
    const void* u2, const void* cheb, const void* val, int ncol, int nlev,
    int ng, int scheme, int beta, int nfsd, int ncdf, double frac_threshold,
    double inv_decorr, double fsd1, double inv_fsd_interval, double zsum,
    double zdiff, void* od_scaling, void* total_cover, void* stream) {
  return generator<double>(frac, overlap, fsd, rand_top, rand_cloud, u1, u2,
                           cheb, val, ncol, nlev, ng, scheme, beta, nfsd,
                           ncdf, frac_threshold, inv_decorr, fsd1,
                           inv_fsd_interval, zsum, zdiff, od_scaling,
                           total_cover, stream);
}

// the kernel's resources and the blocks per SM its launch gets at nlev
// levels and ng g-points (kernel_info.cuh), float32 or float64 (f64 = 1)
template <typename T>
static int generator_info(int nlev, int ng, int* info) {
  size_t smem = 0;
  const cudaError_t e = ecrad::gen::smem_for<T>(nlev, &smem);
  if (e != cudaSuccess) return (int)e;
  return ecrad::kernel_info(ecrad::gen::mcica_generator_kernel<T>,
                            ecrad::gen::threads_for(ng), smem, info);
}

extern "C" int mcica_generator_info(int f64, int nlev, int ng, int* info) {
  return f64 ? generator_info<double>(nlev, ng, info)
             : generator_info<float>(nlev, ng, info);
}
