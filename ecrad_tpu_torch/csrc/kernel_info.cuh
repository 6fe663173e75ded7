// A kernel's compiled resources and the occupancy its launch gets, for
// the reports of chip_smoke.py and for B10's choice of block size (the
// *_info entry points, each in its kernel's source: level_sweep_info,
// taumol_lw_info, taumol_sw_info, tc_sweeps_info, spartacus_*_info,
// gather_sections_info and threefry_fields_info). info receives:
// registers per thread, local memory per thread in bytes (spills and
// stack), static and dynamic shared memory per block in bytes, threads per
// block, resident blocks per SM at that launch, and the device's SM count.
#pragma once
#include <cuda_runtime.h>

namespace ecrad {

template <class Kernel>
inline int kernel_info(Kernel kernel, int threads, size_t dynamic_smem,
                       int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    dynamic_smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = (int)dynamic_smem;
  info[4] = threads;
  info[5] = blocks;
  info[6] = sms;
  return 0;
}

}  // namespace ecrad
