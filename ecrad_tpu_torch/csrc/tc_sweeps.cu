// Kernel B5: the Tripleclouds region sweeps.
//
// Replaces the TPU kernels ecrad_tpu/ops/adding_fused.py::tc_sw_sweeps
// (:290) and ::tc_lw_sweeps (:361), each two pallas_calls of level_sweep
// (:125): an upward sweep that wrote the per-region albedo (and LW source)
// history to HBM, and a downward sweep that read it and wrote per-region
// fluxes, with the carry resident in VMEM across a sequential level grid.
// On the H100 one thread owns one (g, column) pair: it keeps the 2 x NREG
// carry in registers, runs the upward sweep into wrapper-allocated scratch
// and the downward sweep from it in the same launch, and writes only the
// region-summed profiles the solver needs (SW: up, diffuse down, direct
// down; LW: up, down), each (nlev+1, ng, ncol): a third of the per-region
// history's bytes. NREG is a template parameter (2 or 3 regions), so the
// two-region namelist setting runs here too.
//
// What bounds it: device-memory bandwidth. Layer operands are
// (nlev, NREG, ng, ncol) with columns innermost and the overlap matrices
// (nlev+1, NREG*NREG, ncol), so the 32 threads of a warp read 32
// neighbouring floats of one row: every access is coalesced. Each sweep
// reads the layer operands once (SW 5, LW 4 of them; the descent reads
// them again), and the scratch carries 2 x NREG profiles up and back.
//
// Semantics: solvers/tripleclouds.py tc_sw_sweeps_plain and
// tc_lw_sweeps_plain, expression for expression (built with -fmad=false):
// the region mixing y[i] = sum_j m[i][j] x[j] is added left to right, and
// the region sums in region order, so the kernel and its plain version
// agree to the last bit.
#include <cuda_runtime.h>

namespace ecrad {

constexpr int TC_THREADS = 256;

// y[i] = sum_j M[i][j] x[j] (M[j][i] with TRANS), M the NREG*NREG rows of
// one interface at column c
template <int NREG, bool TRANS>
__device__ __forceinline__ void mix(const float* __restrict__ m, size_t ncol,
                                    size_t c, const float (&x)[NREG],
                                    float (&y)[NREG]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const int k0 = TRANS ? i : i * NREG;
    float s = m[k0 * ncol + c] * x[0];
#pragma unroll
    for (int j = 1; j < NREG; ++j) {
      const int k = TRANS ? j * NREG + i : i * NREG + j;
      s = s + m[k * ncol + c] * x[j];
    }
    y[i] = s;
  }
}

template <int NREG>
__device__ __forceinline__ float rsum(const float (&x)[NREG]) {
  float s = x[0];
#pragma unroll
  for (int r = 1; r < NREG; ++r) s = s + x[r];
  return s;
}

template <int NREG>
__global__ void __launch_bounds__(TC_THREADS)
tc_sw_kernel(const float* __restrict__ ref, const float* __restrict__ trans,
             const float* __restrict__ ref_dir, const float* __restrict__ tdd,
             const float* __restrict__ tdir, const float* __restrict__ vmat,
             const unsigned char* __restrict__ clear,
             const float* __restrict__ alb_diff,
             const float* __restrict__ alb_dir, const float* __restrict__ mu0,
             const float* __restrict__ incoming,
             const float* __restrict__ frac_top, int nlev, int ng, int ncol,
             float* __restrict__ scratch, float* __restrict__ up,
             float* __restrict__ dn_diff, float* __restrict__ dn_dir) {
  const size_t m = (size_t)ng * ncol;              // one (g, column) plane
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t c = i % ncol;
  const size_t nc = (size_t)ncol;
  const float mu = mu0[c];
  // layer l, region r of a (nlev, NREG, ng, ncol) operand
  auto at = [&](int l, int r) { return ((size_t)l * NREG + r) * m + i; };
  // scratch: (nlev, 2, NREG, ng, ncol), albedo and direct albedo below
  // each layer
  auto sc = [&](int l, int k, int r) {
    return (((size_t)l * 2 + k) * NREG + r) * m + i;
  };

  // ---- upward sweep: albedos, mixed through V^T at interfaces ----
  float alb[NREG], albdir[NREG];
  const bool bottom_clear = clear[(size_t)(nlev - 1) * nc + c] != 0;
  const float ad = alb_diff[i], adir = mu * alb_dir[i];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    alb[r] = (r == 0 || !bottom_clear) ? ad : 0.0f;
    albdir[r] = (r == 0 || !bottom_clear) ? adir : 0.0f;
  }
  for (int l = nlev - 1; l >= 0; --l) {
    float ab[NREG], adb[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      scratch[sc(l, 0, r)] = alb[r];
      scratch[sc(l, 1, r)] = albdir[r];
      const size_t j = at(l, r);
      const float rr = ref[j], t = trans[j];
      const float inv = 1.0f / (1.0f - alb[r] * rr);
      ab[r] = rr + t * t * alb[r] * inv;
      adb[r] = ref_dir[j] + (tdir[j] * albdir[r] + tdd[j] * alb[r]) * t * inv;
    }
    const bool is_clear = clear[(size_t)l * nc + c] != 0;
    if (is_clear) {
#pragma unroll
      for (int r = 1; r < NREG; ++r) ab[r] = adb[r] = 0.0f;
    }
    const bool both_clear = is_clear
        && (l == 0 || clear[(size_t)(l - 1) * nc + c] != 0);
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { alb[r] = ab[r]; albdir[r] = adb[r]; }
    } else {
      const float* v = vmat + (size_t)l * NREG * NREG * nc;
      mix<NREG, true>(v, nc, c, ab, alb);
      mix<NREG, true>(v, nc, c, adb, albdir);
    }
  }

  // ---- downward sweep: diffuse and direct fluxes, mixed through V ----
  float fdn[NREG], direct[NREG], fup[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    direct[r] = incoming[i] * frac_top[(size_t)r * nc + c];
    fdn[r] = 0.0f;
    fup[r] = direct[r] * albdir[r];
  }
  up[i] = rsum<NREG>(fup);
  dn_diff[i] = 0.0f;
  dn_dir[i] = rsum<NREG>(direct) * mu;
  for (int l = 0; l < nlev; ++l) {
    float fnew[NREG], dnew[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      const size_t j = at(l, r);
      const float a = scratch[sc(l, 0, r)], adr = scratch[sc(l, 1, r)];
      const float rr = ref[j], tl = tdir[j];
      const float inv = 1.0f / (1.0f - rr * a);
      fnew[r] = (trans[j] * fdn[r] + direct[r] * (tl * adr * rr + tdd[j]))
          * inv;
      dnew[r] = tl * direct[r];
      if (r > 0 && clear[(size_t)l * nc + c] != 0) fnew[r] = dnew[r] = 0.0f;
      fup[r] = dnew[r] * adr + fnew[r] * a;
    }
    const bool is_clear = clear[(size_t)l * nc + c] != 0;
    const bool both_clear = is_clear
        && (l + 1 == nlev || clear[(size_t)(l + 1) * nc + c] != 0);
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { fdn[r] = fnew[r]; direct[r] = dnew[r]; }
    } else {
      const float* v = vmat + (size_t)(l + 1) * NREG * NREG * nc;
      mix<NREG, false>(v, nc, c, fnew, fdn);
      mix<NREG, false>(v, nc, c, dnew, direct);
    }
    const size_t jb = (size_t)(l + 1) * m + i;
    up[jb] = rsum<NREG>(fup);
    dn_diff[jb] = rsum<NREG>(fdn);
    dn_dir[jb] = rsum<NREG>(direct) * mu;
  }
}

template <int NREG>
__global__ void __launch_bounds__(TC_THREADS)
tc_lw_kernel(const float* __restrict__ ref, const float* __restrict__ trans,
             const float* __restrict__ src_up,
             const float* __restrict__ src_dn, const float* __restrict__ vmat,
             const float* __restrict__ umat,
             const unsigned char* __restrict__ clear,
             const float* __restrict__ emission,
             const float* __restrict__ albedo,
             const float* __restrict__ frac_bot, int nlev, int ng, int ncol,
             float* __restrict__ scratch, float* __restrict__ up,
             float* __restrict__ dn) {
  const size_t m = (size_t)ng * ncol;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t c = i % ncol;
  const size_t nc = (size_t)ncol;
  auto at = [&](int l, int r) { return ((size_t)l * NREG + r) * m + i; };
  auto sc = [&](int l, int k, int r) {
    return (((size_t)l * 2 + k) * NREG + r) * m + i;
  };

  // ---- upward sweep: albedo mixed through V^T, source through U ----
  float alb[NREG], src[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    alb[r] = albedo[i];
    src[r] = frac_bot[(size_t)r * nc + c] * emission[i];
  }
  for (int l = nlev - 1; l >= 0; --l) {
    float ab[NREG], sb[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      scratch[sc(l, 0, r)] = alb[r];
      scratch[sc(l, 1, r)] = src[r];
      const size_t j = at(l, r);
      const float rr = ref[j], t = trans[j];
      const float inv = 1.0f / (1.0f - alb[r] * rr);
      ab[r] = rr + t * t * alb[r] * inv;
      sb[r] = src_up[j] + t * (src[r] + alb[r] * src_dn[j]) * inv;
    }
    const bool is_clear = clear[(size_t)l * nc + c] != 0;
    if (is_clear) {
#pragma unroll
      for (int r = 1; r < NREG; ++r) ab[r] = sb[r] = 0.0f;
    }
    const bool both_clear = is_clear
        && (l == 0 || clear[(size_t)(l - 1) * nc + c] != 0);
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { alb[r] = ab[r]; src[r] = sb[r]; }
    } else {
      mix<NREG, true>(vmat + (size_t)l * NREG * NREG * nc, nc, c, ab, alb);
      mix<NREG, false>(umat + (size_t)l * NREG * NREG * nc, nc, c, sb, src);
    }
  }

  // ---- downward sweep from a dark top, mixed through V ----
  float fdn[NREG], fup[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) fdn[r] = 0.0f;
  up[i] = rsum<NREG>(src);
  dn[i] = 0.0f;
  for (int l = 0; l < nlev; ++l) {
    float fnew[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      const size_t j = at(l, r);
      const float a = scratch[sc(l, 0, r)], s = scratch[sc(l, 1, r)];
      const float rr = ref[j];
      const float inv = 1.0f / (1.0f - rr * a);
      fnew[r] = (trans[j] * fdn[r] + rr * s + src_dn[j]) * inv;
      if (r > 0 && clear[(size_t)l * nc + c] != 0) fnew[r] = 0.0f;
      fup[r] = s + fnew[r] * a;
    }
    const bool is_clear = clear[(size_t)l * nc + c] != 0;
    const bool both_clear = is_clear
        && (l + 1 == nlev || clear[(size_t)(l + 1) * nc + c] != 0);
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) fdn[r] = fnew[r];
    } else {
      mix<NREG, false>(vmat + (size_t)(l + 1) * NREG * NREG * nc, nc, c, fnew,
                       fdn);
    }
    const size_t jb = (size_t)(l + 1) * m + i;
    up[jb] = rsum<NREG>(fup);
    dn[jb] = rsum<NREG>(fdn);
  }
}

inline int blocks_for(size_t m) {
  return (int)((m + TC_THREADS - 1) / TC_THREADS);
}

}  // namespace ecrad

extern "C" int tc_sw_sweeps(const float* ref, const float* trans,
                            const float* ref_dir, const float* tdd,
                            const float* tdir, const float* vmat,
                            const unsigned char* clear, const float* alb_diff,
                            const float* alb_dir, const float* mu0,
                            const float* incoming, const float* frac_top,
                            int nreg, int nlev, int ng, int ncol,
                            float* scratch, float* up, float* dn_diff,
                            float* dn_dir, void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m == 0) return (int)cudaGetLastError();
  const int blocks = ecrad::blocks_for(m);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    ecrad::tc_sw_kernel<3><<<blocks, ecrad::TC_THREADS, 0, s>>>(
        ref, trans, ref_dir, tdd, tdir, vmat, clear, alb_diff, alb_dir, mu0,
        incoming, frac_top, nlev, ng, ncol, scratch, up, dn_diff, dn_dir);
  } else if (nreg == 2) {
    ecrad::tc_sw_kernel<2><<<blocks, ecrad::TC_THREADS, 0, s>>>(
        ref, trans, ref_dir, tdd, tdir, vmat, clear, alb_diff, alb_dir, mu0,
        incoming, frac_top, nlev, ng, ncol, scratch, up, dn_diff, dn_dir);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int tc_lw_sweeps(const float* ref, const float* trans,
                            const float* src_up, const float* src_dn,
                            const float* vmat, const float* umat,
                            const unsigned char* clear, const float* emission,
                            const float* albedo, const float* frac_bot,
                            int nreg, int nlev, int ng, int ncol,
                            float* scratch, float* up, float* dn,
                            void* stream) {
  const size_t m = (size_t)ng * ncol;
  if (m == 0) return (int)cudaGetLastError();
  const int blocks = ecrad::blocks_for(m);
  cudaStream_t s = (cudaStream_t)stream;
  if (nreg == 3) {
    ecrad::tc_lw_kernel<3><<<blocks, ecrad::TC_THREADS, 0, s>>>(
        ref, trans, src_up, src_dn, vmat, umat, clear, emission, albedo,
        frac_bot, nlev, ng, ncol, scratch, up, dn);
  } else if (nreg == 2) {
    ecrad::tc_lw_kernel<2><<<blocks, ecrad::TC_THREADS, 0, s>>>(
        ref, trans, src_up, src_dn, vmat, umat, clear, emission, albedo,
        frac_bot, nlev, ng, ncol, scratch, up, dn);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
