// Kernel B11: Tripleclouds' SW layer optics in one pass.
//
// Replaces no TPU kernel: the JAX package computes these optics with XLA
// elementwise passes (ecrad_tpu/solvers/tripleclouds.py:156-225, the
// region properties, delta-Eddington, sw_gammas and sw_reftrans, and the
// clear sky's sw_reftrans), which the port ran as some 400 PyTorch
// passes over (nlev, nreg, ng, ncol) arrays, each through device memory.
// For each (column, level, g) cell this kernel reads the gas optics once,
// expands the cloud's band properties to g itself (band_from_g[g]), and
// computes, in registers:
//   - the clear sky: sw_gammas and sw_reftrans of the gas optics;
//   - region 0: the same chain, after delta-Eddington scaling where the
//     configuration scales the gases (else the clear sky's values);
//   - each cloudy region r of a cloudy layer: the gas and the cloud
//     scaled by od_scaling[r] mixed (tripleclouds._region_props_sw_g's
//     plain version, in its operation order), then the chain; a layer
//     that is not cloudy takes region 0's values, as the plain version's
//     torch.where(cloudy, mixed, gas) makes them.
// The Meador-Weaver chain is B4's (sw_two_stream.cuh): float cells within
// 0.03 of k mu0 = 1 take its terms in double, so no host sync is needed
// to find them.
//
// What bounds it: device-memory bandwidth. It reads 3 (ncol, nlev, ng)
// gas fields (12 bytes a cell) and writes 5 (nlev, nreg, ng, ncol)
// region fields and 5 (nlev, ng, ncol) clear-sky ones (80 bytes a cell
// with 3 regions). Its layout is B4's: the inputs are g-innermost and the
// outputs column-innermost, so a block owns one level, 32 columns and 32
// g-points; threads load and compute along g, park the 5 results of one
// family (clear sky or a region) in a shared-memory tile, and store them
// along columns, so both sides are coalesced. The families go through
// the tile in turn (21 KB a block): a cloudy region's cells that are not
// cloudy are not recomputed, the tile still holding region 0's values
// there. A warp computes one column at a time, so the cloudy branch is
// uniform across it.
//
// Built with -fmad=false and the exact exp/sqrt, so it matches its plain
// version (ops/tc_optics.py tc_sw_optics_plain) on the card bit for bit
// but for libm's last bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "sw_two_stream.cuh"

namespace ecrad {
namespace {

constexpr int TC_TILE = 32;   // columns and g-points per block
constexpr int TC_ROWS = 8;    // blockDim.y
constexpr int TC_NQ = 5;      // ref, trans, ref_dir, trans_dir_diff, tdir

// grid (ceil(ng/TILE), ceil(ncol/TILE), nlev), block (TILE, ROWS)
__global__ void __launch_bounds__(TC_TILE * TC_ROWS)
tc_sw_optics_kernel(const float* __restrict__ od,
                    const float* __restrict__ ssa,
                    const float* __restrict__ g,
                    const float* __restrict__ od_cloud,
                    const float* __restrict__ ssa_cloud,
                    const float* __restrict__ g_cloud,
                    const float* __restrict__ od_scaling,
                    const uint8_t* __restrict__ cloudy,
                    const float* __restrict__ mu0,
                    const int* __restrict__ band_from_g, int ncol, int nlev,
                    int ng, int nb, int nreg, int delta_all,
                    float* __restrict__ region, float* __restrict__ clear) {
  __shared__ float tile[TC_NQ][TC_TILE][TC_TILE + 1];
  const int g0 = blockIdx.x * TC_TILE, c0 = blockIdx.y * TC_TILE;
  const int l = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gi = g0 + tx;
  const int band = gi < ng ? band_from_g[gi] : 0;
  const int c_out = c0 + tx;
  const size_t plane_r = (size_t)nlev * nreg * ng * ncol;
  const size_t plane_c = (size_t)nlev * ng * ncol;
  // the families in turn: r = -1 the clear sky alone (with delta
  // scaling), r = 0 region 0 (without it, also the clear sky), then the
  // cloudy regions
  const int first = delta_all ? -1 : 0;
  for (int r = first; r < nreg; ++r) {
    // load and compute along g: thread (tx, ty) owns g0 + tx of columns
    // c0 + ty, c0 + ty + ROWS, ...
    if (gi < ng) {
      for (int cc = ty; cc < TC_TILE; cc += TC_ROWS) {
        const int c = c0 + cc;
        if (c >= ncol) break;
        const size_t cl = (size_t)c * nlev + l;
        if (r > 0 && !cloudy[cl]) continue;   // the tile holds region 0's
        const size_t j = cl * ng + gi;
        float od_x = od[j], ssa_x = ssa[j], g_x = g[j];
        if (r > 0) {                // tripleclouds._region_props_sw_g
          const size_t jb = cl * nb + band;
          const float ssac = ssa_cloud[jb];
          const float odc = od_cloud[jb] * od_scaling[cl * nreg + r];
          const float od_t = od_x + odc;
          const float scat = ssa_x * od_x + ssac * odc;
          const float ssa_t =
              od_t > 0.0f ? scat / fmaxf(od_t, 1.0e-30f) : 0.0f;
          const float g_t =
              scat > 0.0f ? (g_x * ssa_x * od_x + g_cloud[jb] * ssac * odc)
                                / fmaxf(scat, 1.0e-30f)
                          : 0.0f;
          od_x = od_t;
          ssa_x = ssa_t;
          g_x = g_t;
        }
        const SwOut<float> o =
            sw_chain(mu0[c], od_x, ssa_x, g_x, r < 0 ? 0 : delta_all);
        tile[0][cc][tx] = o.r;
        tile[1][cc][tx] = o.t;
        tile[2][cc][tx] = o.rd;
        tile[3][cc][tx] = o.tdd;
        tile[4][cc][tx] = o.tdir;
      }
    }
    __syncthreads();
    // store along columns: thread (tx, ty) writes column c0 + tx of
    // g-points g0 + ty, g0 + ty + ROWS, ...
    if (c_out < ncol) {
      for (int gg = ty; gg < TC_TILE; gg += TC_ROWS) {
        const int go = g0 + gg;
        if (go >= ng) break;
        if (r == first) {
          const size_t o = ((size_t)l * ng + go) * ncol + c_out;
#pragma unroll
          for (int q = 0; q < TC_NQ; ++q) clear[q * plane_c + o] =
              tile[q][tx][gg];
        }
        if (r >= 0) {
          const size_t o = (((size_t)l * nreg + r) * ng + go) * ncol + c_out;
#pragma unroll
          for (int q = 0; q < TC_NQ; ++q) region[q * plane_r + o] =
              tile[q][tx][gg];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace ecrad

// od, ssa, g (ncol, nlev, ng); od_cloud, ssa_cloud, g_cloud (ncol, nlev,
// nb); od_scaling (ncol, nlev, nreg); cloudy (ncol, nlev) bool; mu0
// (ncol,); band_from_g (ng,) int32. Writes region (5, nlev, nreg, ng,
// ncol) and clear (5, nlev, ng, ncol).
extern "C" int tc_sw_optics(const float* od, const float* ssa, const float* g,
                            const float* od_cloud, const float* ssa_cloud,
                            const float* g_cloud, const float* od_scaling,
                            const uint8_t* cloudy, const float* mu0,
                            const int* band_from_g, int ncol, int nlev,
                            int ng, int nb, int nreg, int delta_all,
                            float* region, float* clear, void* stream) {
  using namespace ecrad;
  if ((size_t)ncol * nlev * ng > 0) {
    const dim3 grid((ng + TC_TILE - 1) / TC_TILE,
                    (ncol + TC_TILE - 1) / TC_TILE, nlev);
    const dim3 block(TC_TILE, TC_ROWS);
    tc_sw_optics_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        od, ssa, g, od_cloud, ssa_cloud, g_cloud, od_scaling, cloudy, mu0,
        band_from_g, ncol, nlev, ng, nb, nreg, delta_all, region, clear);
  }
  return (int)cudaGetLastError();
}

// B11's resources at its launch (kernel_info.cuh)
extern "C" int tc_sw_optics_info(int* info) {
  using namespace ecrad;
  return kernel_info(tc_sw_optics_kernel, TC_TILE * TC_ROWS, 0, info);
}
