// Kernel B4: McICA clear- and total-sky layer optics in one pass.
//
// Replaces the TPU kernels ecrad_tpu/ops/mcica_optics.py::
// sw_clear_total_reftrans (:74; pallas_call :175 clear family, :181 total
// family) and ::lw_clear_total_noscat (:196; pallas_call :269). For each
// (column, level, g) cell: expand the cloud band properties to g, scale
// the cloud optical depth by the subcolumn scaling, combine with the gas,
// and compute the clear-sky and the total-sky layer properties; the total
// family takes the clear values where the layer is not cloudy.
//
// On the TPU the band->g expansion was a one-hot MXU product and the clear
// chain was recomputed in a second kernel to stay under the VMEM limit.
// Here the expansion is a direct index band_from_g[g] and one thread
// computes both families of its cell.
//
// What bounds it: device-memory bandwidth. SW reads 4 (ncol, nlev, 112)
// fields and writes 10 (nlev, 112, ncol) ones (about 14 x 4 bytes per
// cell); LW reads 2 fields and two Planck half levels and writes 6. The
// inputs are g-innermost and the outputs column-innermost, so a block
// owns one level, 32 columns and 32 g-points: threads load and compute
// along g, park the results in a shared-memory tile, and store along
// columns, so that both sides are coalesced.
//
// Semantics: ops/mcica_optics.py sw_clear_total_reftrans_plain and
// lw_clear_total_noscat_plain, operation for operation in the order of
// the PyTorch expressions (solvers/two_stream.py, optics/combine.py,
// optics/cloud.py delta_eddington). Built with -fmad=false and the exact
// exp/sqrt, so only libm's last bit separates the two; cells within
// 0.03 of the SW resonance k mu0 = 1 take the Meador-Weaver terms in
// double, as the plain version does (two_stream.RESONANCE_WINDOW), and
// the nudge |k mu0 - 1| < 1e-6 is kept exactly.
//
// The SW kernel is a template on the scalar type: its double form
// (mcica_sw_optics_f64) is the float64 path's, every stage in double as
// the plain version computes it in float64 (no resonance window: double
// is the window's precision). Its transpose tile doubles in bytes, past
// the 48 KB of static shared memory, so the double form takes it as
// dynamic shared memory (84 KB, 2 blocks per SM). In double exp, sqrt
// and division run on the FP64 pipe, at half the float rate and with no
// SFU, yet the double form stays bound by its bytes on an H100 (PERF.md).
// The LW form stays float only: the float64 path takes the LW clear sky
// with aerosol scattering, off this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "scalar.cuh"
#include "sw_two_stream.cuh"

namespace ecrad {

constexpr int TILE = 32;      // columns and g-points per block
constexpr int ROWS = 8;       // blockDim.y

// the SW kernel's transpose tile: static shared memory in the float form
// (42 KB), dynamic in the double one (84 KB, past the static 48 KB)
template <typename T>
struct SwTile;
template <>
struct SwTile<float> {
  __device__ __forceinline__ static float (*get())[TILE][TILE + 1] {
    __shared__ float tile[10][TILE][TILE + 1];
    return tile;
  }
};
template <>
struct SwTile<double> {
  static constexpr size_t bytes = sizeof(double) * 10 * TILE * (TILE + 1);
  __device__ __forceinline__ static double (*get())[TILE][TILE + 1] {
    extern __shared__ __align__(16) unsigned char mcica_tile[];
    return reinterpret_cast<double (*)[TILE][TILE + 1]>(mcica_tile);
  }
};

__device__ __forceinline__ void lw_noscat(float od, float pt, float pb,
                                          float* t, float* su, float* sd) {
  // solvers/two_stream.py lw_no_scattering_transmittance
  const float coeff0 = 1.66f * od;
  const float trans_full = expf(-coeff0);
  const float coeff = (pb - pt) / fmaxf(coeff0, 1.0e-30f);
  if (od <= 1.0e-3f) {
    *t = 1.0f - coeff0;
    *su = *sd = coeff0 * 0.5f * (pt + pb);
  } else {
    *t = trans_full;
    *su = (coeff + pt) - trans_full * (coeff + pb);
    *sd = (-coeff + pb) - trans_full * (-coeff + pt);
  }
}

// grid (ceil(ng/TILE), ceil(ncol/TILE), nlev), block (TILE, ROWS)
template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
mcica_sw_optics_kernel(const T* __restrict__ od,
                       const T* __restrict__ ssa,
                       const T* __restrict__ g,
                       const T* __restrict__ od_scaling,
                       const T* __restrict__ od_cloud,
                       const T* __restrict__ ssa_cloud,
                       const T* __restrict__ g_cloud,
                       const uint8_t* __restrict__ mask,
                       const T* __restrict__ cos_sza,
                       const int* __restrict__ band_from_g, int ncol,
                       int nlev, int ng, int nb, int delta_all,
                       T* __restrict__ out) {
  T (*tile)[TILE][TILE + 1] = SwTile<T>::get();
  const int g0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  const int l = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // load and compute along g: thread (tx, ty) owns g0 + tx of columns
  // c0 + ty, c0 + ty + ROWS, ...
  const int gi = g0 + tx;
  if (gi < ng) {
    const int band = band_from_g[gi];
    for (int cc = ty; cc < TILE; cc += ROWS) {
      const int c = c0 + cc;
      if (c >= ncol) break;
      const size_t cl = (size_t)c * nlev + l;
      const size_t j = cl * ng + gi;
      const T mu0 = mmax(cos_sza[c], ECRAD_LIT(1.0e-10));
      const T od_g = od[j], ssa_g = ssa[j], g_g = g[j];
      const SwOut<T> cl_o = sw_chain(mu0, od_g, ssa_g, g_g, delta_all);
      SwOut<T> to = cl_o;
      if (mask[cl]) {                 // optics/combine.py _mix
        const size_t jb = cl * nb + band;
        const T odc = od_cloud[jb] * od_scaling[j];
        const T od_t = od_g + odc;
        const T scat_gas = ssa_g * od_g;
        const T scat_cld = ssa_cloud[jb] * odc;
        const T scat_od = scat_gas + scat_cld;
        const T ssa_t = od_t > ECRAD_LIT(0.0)
            ? scat_od / mmax(od_t, ECRAD_LIT(1.0e-30)) : ECRAD_LIT(0.0);
        const T g_t = scat_od > ECRAD_LIT(0.0)
            ? (g_g * scat_gas + g_cloud[jb] * scat_cld)
              / mmax(scat_od, ECRAD_LIT(1.0e-30))
            : ECRAD_LIT(0.0);
        to = sw_chain(mu0, od_t, ssa_t, g_t, delta_all);
      }
      const T v[10] = {cl_o.r, cl_o.t, cl_o.rd, cl_o.tdd, cl_o.tdir,
                           to.r, to.t, to.rd, to.tdd, to.tdir};
#pragma unroll
      for (int q = 0; q < 10; ++q) tile[q][cc][tx] = v[q];
    }
  }
  __syncthreads();
  // store along columns: thread (tx, ty) writes column c0 + tx of
  // g-points g0 + ty, g0 + ty + ROWS, ...
  const int c = c0 + tx;
  if (c >= ncol) return;
  const size_t plane = (size_t)nlev * ng * ncol;
  for (int gg = ty; gg < TILE; gg += ROWS) {
    const int go = g0 + gg;
    if (go >= ng) break;
    const size_t o = ((size_t)l * ng + go) * ncol + c;
#pragma unroll
    for (int q = 0; q < 10; ++q) out[q * plane + o] = tile[q][tx][gg];
  }
}

__global__ void __launch_bounds__(TILE * ROWS)
mcica_lw_optics_kernel(const float* __restrict__ od,
                       const float* __restrict__ od_scaling,
                       const float* __restrict__ od_cloud,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ planck_hl,
                       const int* __restrict__ band_from_g, int ncol,
                       int nlev, int ng, int nb, float* __restrict__ out) {
  __shared__ float tile[6][TILE][TILE + 1];
  const int g0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  const int l = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gi = g0 + tx;
  if (gi < ng) {
    const int band = band_from_g[gi];
    for (int cc = ty; cc < TILE; cc += ROWS) {
      const int c = c0 + cc;
      if (c >= ncol) break;
      const size_t cl = (size_t)c * nlev + l;
      const size_t j = cl * ng + gi;
      const size_t jp = ((size_t)c * (nlev + 1) + l) * ng + gi;
      const float pt = planck_hl[jp], pb = planck_hl[jp + ng];
      const float od_g = od[j];
      float v[6];
      lw_noscat(od_g, pt, pb, &v[0], &v[1], &v[2]);
      if (mask[cl]) {
        const float od_t = od_g + od_cloud[cl * nb + band] * od_scaling[j];
        lw_noscat(od_t, pt, pb, &v[3], &v[4], &v[5]);
      } else {
        v[3] = v[0];
        v[4] = v[1];
        v[5] = v[2];
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) tile[q][cc][tx] = v[q];
    }
  }
  __syncthreads();
  const int c = c0 + tx;
  if (c >= ncol) return;
  const size_t plane = (size_t)nlev * ng * ncol;
  for (int gg = ty; gg < TILE; gg += ROWS) {
    const int go = g0 + gg;
    if (go >= ng) break;
    const size_t o = ((size_t)l * ng + go) * ncol + c;
#pragma unroll
    for (int q = 0; q < 6; ++q) out[q * plane + o] = tile[q][tx][gg];
  }
}

}  // namespace ecrad

namespace ecrad {
template <typename T>
int mcica_sw_optics_launch(const T* od, const T* ssa, const T* g,
                           const T* od_scaling, const T* od_cloud,
                           const T* ssa_cloud, const T* g_cloud,
                           const uint8_t* mask, const T* cos_sza,
                           const int* band_from_g, int ncol, int nlev, int ng,
                           int nb, int delta_all, T* out, void* stream) {
  if ((size_t)ncol * nlev * ng > 0) {
    size_t smem = 0;
    if constexpr (sizeof(T) == 8) {
      smem = SwTile<double>::bytes;
      cudaError_t e = cudaFuncSetAttribute(
          mcica_sw_optics_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((ng + TILE - 1) / TILE, (ncol + TILE - 1) / TILE, nlev);
    const dim3 block(TILE, ROWS);
    mcica_sw_optics_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
        od, ssa, g, od_scaling, od_cloud, ssa_cloud, g_cloud, mask, cos_sza,
        band_from_g, ncol, nlev, ng, nb, delta_all, out);
  }
  return (int)cudaGetLastError();
}
}  // namespace ecrad

extern "C" int mcica_sw_optics(const float* od, const float* ssa,
                               const float* g, const float* od_scaling,
                               const float* od_cloud, const float* ssa_cloud,
                               const float* g_cloud, const uint8_t* mask,
                               const float* cos_sza, const int* band_from_g,
                               int ncol, int nlev, int ng, int nb,
                               int delta_all, float* out, void* stream) {
  return ecrad::mcica_sw_optics_launch<float>(
      od, ssa, g, od_scaling, od_cloud, ssa_cloud, g_cloud, mask, cos_sza,
      band_from_g, ncol, nlev, ng, nb, delta_all, out, stream);
}

// the double form, the float64 path's
extern "C" int mcica_sw_optics_f64(const double* od, const double* ssa,
                                   const double* g, const double* od_scaling,
                                   const double* od_cloud,
                                   const double* ssa_cloud,
                                   const double* g_cloud, const uint8_t* mask,
                                   const double* cos_sza,
                                   const int* band_from_g, int ncol, int nlev,
                                   int ng, int nb, int delta_all, double* out,
                                   void* stream) {
  return ecrad::mcica_sw_optics_launch<double>(
      od, ssa, g, od_scaling, od_cloud, ssa_cloud, g_cloud, mask, cos_sza,
      band_from_g, ncol, nlev, ng, nb, delta_all, out, stream);
}

extern "C" int mcica_lw_optics(const float* od, const float* od_scaling,
                               const float* od_cloud, const uint8_t* mask,
                               const float* planck_hl, const int* band_from_g,
                               int ncol, int nlev, int ng, int nb,
                               float* out, void* stream) {
  if ((size_t)ncol * nlev * ng > 0) {
    const dim3 grid((ng + ecrad::TILE - 1) / ecrad::TILE,
                    (ncol + ecrad::TILE - 1) / ecrad::TILE, nlev);
    const dim3 block(ecrad::TILE, ecrad::ROWS);
    ecrad::mcica_lw_optics_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        od, od_scaling, od_cloud, mask, planck_hl, band_from_g, ncol, nlev,
        ng, nb, out);
  }
  return (int)cudaGetLastError();
}

// Resources of B4's kernel `which` (0 the SW form, 1 the LW form, 2 the
// SW double form) at its launch (kernel_info.cuh)
extern "C" int mcica_optics_info(int which, int* info) {
  using namespace ecrad;
  if (which == 0)
    return kernel_info(mcica_sw_optics_kernel<float>, TILE * ROWS, 0, info);
  if (which == 1)
    return kernel_info(mcica_lw_optics_kernel, TILE * ROWS, 0, info);
  if (which == 2) {
    cudaError_t e = cudaFuncSetAttribute(
        mcica_sw_optics_kernel<double>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SwTile<double>::bytes);
    if (e != cudaSuccess) return (int)e;
    return kernel_info(mcica_sw_optics_kernel<double>, TILE * ROWS,
                       SwTile<double>::bytes, info);
  }
  return (int)cudaErrorInvalidValue;
}
