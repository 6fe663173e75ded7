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
// down; LW: up, down), each (nlev+1, ng, ncol). NREG is a template
// parameter (2 or 3 regions), so the two-region namelist setting runs
// here too.
//
// What bounds it: device-memory bandwidth, at ~2.4-2.5 TB/s on the bytes
// the design moves. Layer operands are (nlev, NREG, ng, ncol) with columns
// innermost and the overlap matrices (nlev+1, NREG*NREG, ncol), so the 32
// threads of a warp read 32 neighbouring floats of one row: every access
// is coalesced, and a 32-byte sector holds 8 columns. Each sweep reads
// the layer operands (SW 5 going up and 4 going down, LW 4 and 3), and
// the scratch carries the history, 2 x NREG values a level, up and back.
// Builds without the history traffic or without the matrix loads run
// faster; builds without the divisions or with a deeper copy ring do
// not. The grid runs in rounds of resident blocks, so the blocks per SM
// are the ones that filled the rounds best at the path's size (PERF.md
// has the numbers).
//
// What the design moves: in a clear layer the plain version computes the
// cloudy regions (r >= 1) and then zeroes them, going up (the albedos and
// LW sources) and going down (the fluxes), so their operands are never
// loaded here and their results set to those zeros; a sector whose 8
// columns are clear is never fetched. The history of the cloudy regions
// of a clear layer only multiplies those zeros (+0 for the albedos and
// sources the solver makes, which are >= 0), so it is neither written nor
// read, except the LW source below a clear layer that sits on a cloudy
// one or on the surface, which the upward flux adds. History is written
// in whole sectors (a sector some of whose 8 columns need it is written
// for all 8), so device memory never merges a partly written one.
//
// Layout: a block is 32 columns x 4 g-points, one warp a g-point. Each
// level's operands and history values are copied into the threads' rings
// of TC_RING levels in shared memory, a level ahead: where ncol is a
// multiple of 4, by the warp with 16-byte cp.async (8 lanes a row of its
// 32 columns, a source's NREG region rows at once), else by each thread
// for its own column, 4 bytes at a time. The block's warps share their
// columns, so each level's overlap matrices (where a column of the block
// mixes) are copied once for the block, a quarter of the rows by each
// warp, into a block ring beside them, with one barrier a level. Each
// thread's clear flags are staged once as bits in shared memory, so no
// copy waits on a load of a flag. The history stays in device memory: on
// chip, 2 x NREG floats a level would leave a few warps per SM, and fewer
// blocks per SM ran slower.
//
// Semantics: solvers/tripleclouds.py tc_sw_sweeps_plain and
// tc_lw_sweeps_plain, expression for expression (built with -fmad=false):
// the region mixing y[i] = sum_j m[i][j] x[j] is added left to right, and
// the region sums in region order, so the kernel and its plain version
// agree to the last bit.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace ecrad {

// threads a block (TC_WARPS warps), and the levels of the copy ring (the
// level in use and TC_RING - 1 copied ahead)
constexpr int TC_THREADS = 128, TC_WARPS = TC_THREADS / 32, TC_RING = 2;
// blocks per SM each kernel is compiled for (its register budget): at
// 2048 columns SW's 1,792 blocks run in 1.94 rounds of 7 x 132, LW's
// 2,240 in 2.83 of 6 x 132; other counts ran slower
constexpr int TC_SW_BLOCKS = 7, TC_LW_BLOCKS = 6;
// ring slots a level: per thread SW 5 operands a region going up, 4
// operands and 2 history values going down, LW 4 going up, 3 and 2 going
// down; per block the level's overlap matrices, 32 columns each (SW V,
// LW V and U going up, V going down)
constexpr int SW_SLOTS = 6, LW_SLOTS = 5;
constexpr int SW_MATS = 1, LW_MATS = 2;

// floats of shared memory a block takes: its threads' clear bits (one
// word per 32 levels), their rings, and the block's matrix ring
__host__ __device__ inline int tc_smem_floats(int nlev, int slots_per_reg,
                                              int mats, int nreg) {
  return ((nlev + 31) / 32 + TC_RING * slots_per_reg * nreg) * TC_THREADS
         + TC_RING * mats * nreg * nreg * 32;
}

// A block is 32 columns x TC_WARPS g-points: the thread at lane and warp
// w takes column tile * 32 + lane and g-point gtile * TC_WARPS + w, so
// the warps of a block share their columns' clear flags and overlap
// matrices, which one copy a level stages for all of them.
inline int tc_blocks(int ng, int ncol) {
  return (ncol + 31) / 32 * ((ng + TC_WARPS - 1) / TC_WARPS);
}

// One interface's NREG x NREG overlap matrix at one column.
template <int NREG>
struct Mat {
  float v[NREG * NREG];

  // element k at stage[k * 32] (stage = the block's staged matrix + lane)
  __device__ __forceinline__ void load(const float* stage) {
#pragma unroll
    for (int k = 0; k < NREG * NREG; ++k) v[k] = stage[k * 32];
  }
  // y[i] = sum_j M[i][j] x[j] (M[j][i] with TRANS), left to right
  template <bool TRANS>
  __device__ __forceinline__ void mix(const float (&x)[NREG],
                                      float (&y)[NREG]) const {
#pragma unroll
    for (int i = 0; i < NREG; ++i) {
      float s = v[TRANS ? i : i * NREG] * x[0];
#pragma unroll
      for (int j = 1; j < NREG; ++j)
        s = s + v[TRANS ? j * NREG + i : i * NREG + j] * x[j];
      y[i] = s;
    }
  }
};

template <int NREG>
__device__ __forceinline__ float rsum(const float (&x)[NREG]) {
  float s = x[0];
#pragma unroll
  for (int r = 1; r < NREG; ++r) s = s + x[r];
  return s;
}

// A thread's work and view of the block's shared memory: its column's
// clear flags as bits (level l at bit l % 32 of word l / 32), its copy
// ring (float s of ring level q at ring[(q * slots + s) * TC_THREADS]),
// and the block's matrix ring (matrix row k of ring level q at mats[(q *
// MATS * NREG * NREG + k) * 32]). A thread past the last column or
// g-point takes the last one's place but stores nothing (`live` false):
// every thread of the block meets the barriers.
struct TcThread {
  unsigned* bits;
  float* ring;
  float* mats;
  size_t m, i, c, iw;
  int lane, warp;
  bool live;
  unsigned live_mask;

  __device__ TcThread(unsigned* mem, int nlev, int slots, int ng,
                      int ncol) {
    const int tiles = (ncol + 31) / 32;
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    const int col = blockIdx.x % tiles * 32 + lane;
    const int g = blockIdx.x / tiles * TC_WARPS + warp;
    live = col < ncol && g < ng;
    c = (size_t)min(col, ncol - 1);
    m = (size_t)ng * ncol;
    i = (size_t)min(g, ng - 1) * ncol + c;
    iw = i - c + blockIdx.x % tiles * 32;
    live_mask = __ballot_sync(0xffffffffu, live);
    const int words = (nlev + 31) / 32;
    bits = mem + threadIdx.x;
    ring = reinterpret_cast<float*>(mem) + words * TC_THREADS + threadIdx.x;
    mats = reinterpret_cast<float*>(mem)
           + (words + TC_RING * slots) * TC_THREADS + lane;
  }
  // stage the column's flags: clear (nlev, ncol) bytes
  __device__ void stage(const unsigned char* __restrict__ clear, int nlev,
                        size_t nc) const {
    for (int w = 0; w * 32 < nlev; ++w) {
      unsigned v = 0;
#pragma unroll 8
      for (int b = 0; b < 32; ++b) {
        const int l = w * 32 + b;
        if (l < nlev && clear[(size_t)l * nc + c]) v |= 1u << b;
      }
      bits[w * TC_THREADS] = v;
    }
  }
  __device__ __forceinline__ bool clr(int l) const {
    return (bits[(l >> 5) * TC_THREADS] >> (l & 31)) & 1u;
  }
  // whether `need` holds for any of the 8 lanes whose values share this
  // thread's 32-byte sectors: a sector of history is written whole or not
  // at all (device memory would read a partly written one to merge it)
  __device__ __forceinline__ bool sector_any(bool need) const {
    return (__ballot_sync(0xffffffffu, need) >> (lane & 24)) & 0xffu;
  }
  // Copies a level's rows into its ring group: slot k * NREG + r takes
  // row row0[k] + r of source k (base[k], rows of m floats), region 0 for
  // every live column and regions >= 1 where need[k] holds. With VEC
  // (ncol a multiple of 4, so 4 columns are 16 aligned bytes) the warp
  // copies its 32 columns with 16-byte cp.async, 8 lanes a row and a
  // source's NREG rows at once; otherwise each thread copies its own
  // column, 4 bytes at a time.
  template <bool VEC, int NREG, int NOPS>
  __device__ __forceinline__ void copy_rows(float* dst,
                                            const float* const (&base)[NOPS],
                                            const size_t (&row0)[NOPS],
                                            const bool (&need)[NOPS]) const {
    if (VEC) {
      const int r = lane >> 3, chunk = lane & 7;
      float* wdst = dst - lane + r * TC_THREADS + chunk * 4;
      const size_t off = (size_t)r * m + iw + chunk * 4;
#pragma unroll
      for (int k = 0; k < NOPS; ++k) {
        const unsigned needed = __ballot_sync(0xffffffffu, need[k]);
        const unsigned cols = live_mask & (r == 0 ? ~0u : needed);
        if (r < NREG && ((cols >> (chunk * 4)) & 0xfu))
          __pipeline_memcpy_async(wdst + k * NREG * TC_THREADS,
                                  base[k] + row0[k] * m + off, 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NOPS; ++k)
#pragma unroll
        for (int r = 0; r < NREG; ++r)
          if (r == 0 || need[k])
            __pipeline_memcpy_async(dst + (k * NREG + r) * TC_THREADS,
                                    base[k] + (row0[k] + r) * m + i,
                                    sizeof(float));
    }
  }
  // this warp's share of staging the NREG x NREG matrices of interface q
  // of mat0 (and of mat1 with two), (nlev + 1 or nlev, NREG * NREG,
  // ncol), at the block's columns into a level's matrix group
  template <int NREG, int MATS>
  __device__ __forceinline__ void copy_mats(float* mdst, const float* mat0,
                                            const float* mat1, int q,
                                            size_t nc) const {
    const size_t off = (size_t)q * NREG * NREG * nc + c;
    for (int k = warp; k < MATS * NREG * NREG; k += TC_WARPS) {
      const float* src = k < NREG * NREG ? mat0 + off + k * nc
                                         : mat1 + off + (k - NREG * NREG) * nc;
      __pipeline_memcpy_async(mdst + k * 32, src, sizeof(float));
    }
  }

  // Calls body(j, v, mv) for j = 0 .. count - 1, where v holds what
  // fetch(j, dst, mdst) copied for step j into the thread's ring (SLOTS
  // floats, slot s at v[s * TC_THREADS]) and mv what the block's warps
  // copied into its matrix ring (MATS * NREG * NREG rows of 32 floats,
  // mv = the group + lane). The copies run TC_RING - 1 steps ahead, one
  // commit group a step; a barrier a step makes every warp's copies
  // visible and keeps a group from being refilled before every warp has
  // read it.
  template <int SLOTS, int MFLOATS, class Fetch, class Body>
  __device__ __forceinline__ void sweep(int count, Fetch fetch,
                                        Body body) const {
    const auto issue = [&](int j) {
      if (j < count)
        fetch(j, ring + (j % TC_RING) * SLOTS * TC_THREADS,
              mats + (j % TC_RING) * MFLOATS * 32);
      __pipeline_commit();
    };
#pragma unroll
    for (int j = 0; j < TC_RING - 1; ++j) issue(j);
    for (int j = 0; j < count; ++j) {
      __pipeline_wait_prior(TC_RING - 2);
      __syncthreads();
      issue(j + TC_RING - 1);
      body(j, ring + (j % TC_RING) * SLOTS * TC_THREADS,
           mats + (j % TC_RING) * MFLOATS * 32);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
};

template <int NREG, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_SW_BLOCKS)
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
  extern __shared__ unsigned tc_mem[];
  const TcThread th(tc_mem, nlev, SW_SLOTS * NREG, ng, ncol);
  const size_t m = th.m, i = th.i, c = th.c, nc = (size_t)ncol;
  const bool live = th.live;
  th.stage(clear, nlev, nc);
  const float mu = mu0[c];
  // row of layer l, region r of a (nlev, NREG, ng, ncol) operand
  auto at = [](int l, int r) { return (size_t)l * NREG + r; };
  // scratch: (nlev, 2, NREG, ng, ncol), albedo and direct albedo below
  // each layer
  auto sc = [](int l, int k, int r) {
    return ((size_t)l * 2 + k) * NREG + r;
  };

  // whether the interface at the top of layer l mixes going up, and the
  // one at its bottom going down (unless the layer and its neighbour
  // there are clear)
  auto mixes_up = [&](int l) {
    return !(th.clr(l) && (l == 0 || th.clr(l - 1)));
  };
  auto mixes_down = [&](int l) {
    return !(th.clr(l) && (l + 1 == nlev || th.clr(l + 1)));
  };

  // ---- upward sweep: albedos, mixed through V^T at interfaces ----
  float alb[NREG], albdir[NREG];
  const bool bottom_clear = th.clr(nlev - 1);
  const float ad = alb_diff[i], adir = mu * alb_dir[i];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    alb[r] = (r == 0 || !bottom_clear) ? ad : 0.0f;
    albdir[r] = (r == 0 || !bottom_clear) ? adir : 0.0f;
  }
  // ring slots: operand k of region r at k * NREG + r (ref, trans,
  // ref_dir, tdd, tdir); the matrix ring V
  th.sweep<5 * NREG, NREG * NREG>(nlev, [&](int j, float* dst,
                                            float* mdst) {
    const int l = nlev - 1 - j;
    const bool cl = th.clr(l);
    if (__any_sync(0xffffffffu, mixes_up(l)))
      th.copy_mats<NREG, 1>(mdst, vmat, vmat, l, nc);
    const float* const base[5] = {ref, trans, ref_dir, tdd, tdir};
    const size_t row0[5] = {at(l, 0), at(l, 0), at(l, 0), at(l, 0),
                            at(l, 0)};
    const bool need[5] = {!cl, !cl, !cl, !cl, !cl};
    th.copy_rows<VEC, NREG>(dst, base, row0, need);
  }, [&](int j, const float* v, const float* mv) {
    const int l = nlev - 1 - j;
    const bool is_clear = th.clr(l);
    const bool keep = th.sector_any(!is_clear) && live;
    const bool both_clear = !mixes_up(l);
    Mat<NREG> V;
    if (!both_clear) V.load(mv);
    float ab[NREG], adb[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      if (r == 0 ? live : keep) {
        scratch[sc(l, 0, r) * m + i] = alb[r];
        scratch[sc(l, 1, r) * m + i] = albdir[r];
      }
      if (r > 0 && is_clear) {
        ab[r] = adb[r] = 0.0f;
        continue;
      }
      const float rr = v[r * TC_THREADS], t = v[(NREG + r) * TC_THREADS];
      const float inv = 1.0f / (1.0f - alb[r] * rr);
      ab[r] = rr + t * t * alb[r] * inv;
      adb[r] = v[(2 * NREG + r) * TC_THREADS]
          + (v[(4 * NREG + r) * TC_THREADS] * albdir[r]
             + v[(3 * NREG + r) * TC_THREADS] * alb[r]) * t * inv;
    }
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { alb[r] = ab[r]; albdir[r] = adb[r]; }
    } else {
      V.template mix<true>(ab, alb);
      V.template mix<true>(adb, albdir);
    }
  });

  // ---- downward sweep: diffuse and direct fluxes, mixed through V ----
  float fdn[NREG], direct[NREG], fup[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    direct[r] = incoming[i] * frac_top[(size_t)r * nc + c];
    fdn[r] = 0.0f;
    fup[r] = direct[r] * albdir[r];
  }
  if (live) {
    up[i] = rsum<NREG>(fup);
    dn_diff[i] = 0.0f;
    dn_dir[i] = rsum<NREG>(direct) * mu;
  }
  // ring slots: ref, trans, tdd, tdir, then the albedo and the direct
  // albedo below the layer, each at k * NREG + r; the matrix ring V
  th.sweep<6 * NREG, NREG * NREG>(nlev, [&](int l, float* dst,
                                            float* mdst) {
    const bool cl = th.clr(l);
    if (__any_sync(0xffffffffu, mixes_down(l)))
      th.copy_mats<NREG, 1>(mdst, vmat, vmat, l + 1, nc);
    const float* const base[6] = {ref, trans, tdd, tdir, scratch, scratch};
    const size_t row0[6] = {at(l, 0), at(l, 0), at(l, 0), at(l, 0),
                            sc(l, 0, 0), sc(l, 1, 0)};
    const bool need[6] = {!cl, !cl, !cl, !cl, !cl, !cl};
    th.copy_rows<VEC, NREG>(dst, base, row0, need);
  }, [&](int l, const float* v, const float* mv) {
    const bool is_clear = th.clr(l);
    const bool both_clear = !mixes_down(l);
    Mat<NREG> V;
    if (!both_clear) V.load(mv);
    float fnew[NREG], dnew[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      if (r > 0 && is_clear) {
        // the plain version's zeros, and 0 x albedo + 0 x albedo
        fnew[r] = dnew[r] = fup[r] = 0.0f;
        continue;
      }
      const float rr = v[r * TC_THREADS], tl = v[(3 * NREG + r) * TC_THREADS];
      const float a = v[(4 * NREG + r) * TC_THREADS];
      const float adr = v[(5 * NREG + r) * TC_THREADS];
      const float inv = 1.0f / (1.0f - rr * a);
      fnew[r] = (v[(NREG + r) * TC_THREADS] * fdn[r]
                 + direct[r] * (tl * adr * rr + v[(2 * NREG + r) * TC_THREADS]))
          * inv;
      dnew[r] = tl * direct[r];
      fup[r] = dnew[r] * adr + fnew[r] * a;
    }
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { fdn[r] = fnew[r]; direct[r] = dnew[r]; }
    } else {
      V.template mix<false>(fnew, fdn);
      V.template mix<false>(dnew, direct);
    }
    if (live) {
      const size_t jb = (size_t)(l + 1) * m + i;
      up[jb] = rsum<NREG>(fup);
      dn_diff[jb] = rsum<NREG>(fdn);
      dn_dir[jb] = rsum<NREG>(direct) * mu;
    }
  });
}

template <int NREG, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_LW_BLOCKS)
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
  extern __shared__ unsigned tc_mem[];
  const TcThread th(tc_mem, nlev, LW_SLOTS * NREG, ng, ncol);
  const size_t m = th.m, i = th.i, c = th.c, nc = (size_t)ncol;
  const bool live = th.live;
  th.stage(clear, nlev, nc);
  auto at = [](int l, int r) { return (size_t)l * NREG + r; };
  auto sc = [](int l, int k, int r) {
    return ((size_t)l * 2 + k) * NREG + r;
  };
  // the cloudy regions' source below layer l is read going down unless
  // l is clear and so is the layer below it (whose sources there are 0)
  auto src_kept = [&](int l) {
    return !th.clr(l) || l + 1 == nlev || !th.clr(l + 1);
  };

  // whether the interface at the top of layer l mixes going up, and the
  // one at its bottom going down (unless the layer and its neighbour
  // there are clear)
  auto mixes_up = [&](int l) {
    return !(th.clr(l) && (l == 0 || th.clr(l - 1)));
  };
  auto mixes_down = [&](int l) {
    return !(th.clr(l) && (l + 1 == nlev || th.clr(l + 1)));
  };

  // ---- upward sweep: albedo mixed through V^T, source through U ----
  float alb[NREG], src[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    alb[r] = albedo[i];
    src[r] = frac_bot[(size_t)r * nc + c] * emission[i];
  }
  // ring slots: ref, trans, src_up, src_dn, each at k * NREG + r; the
  // matrix ring V, U
  th.sweep<4 * NREG, 2 * NREG * NREG>(nlev, [&](int j, float* dst,
                                                float* mdst) {
    const int l = nlev - 1 - j;
    const bool cl = th.clr(l);
    if (__any_sync(0xffffffffu, mixes_up(l)))
      th.copy_mats<NREG, 2>(mdst, vmat, umat, l, nc);
    const float* const base[4] = {ref, trans, src_up, src_dn};
    const size_t row0[4] = {at(l, 0), at(l, 0), at(l, 0), at(l, 0)};
    const bool need[4] = {!cl, !cl, !cl, !cl};
    th.copy_rows<VEC, NREG>(dst, base, row0, need);
  }, [&](int j, const float* v, const float* mv) {
    const int l = nlev - 1 - j;
    const bool is_clear = th.clr(l);
    const bool keep_alb = th.sector_any(!is_clear) && live;
    const bool keep_src = th.sector_any(src_kept(l)) && live;
    const bool both_clear = !mixes_up(l);
    Mat<NREG> V, U;
    if (!both_clear) {
      V.load(mv);
      U.load(mv + NREG * NREG * 32);
    }
    float ab[NREG], sb[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      if (r == 0 ? live : keep_alb)
        scratch[sc(l, 0, r) * m + i] = alb[r];
      if (r == 0 ? live : keep_src)
        scratch[sc(l, 1, r) * m + i] = src[r];
      if (r > 0 && is_clear) {
        ab[r] = sb[r] = 0.0f;
        continue;
      }
      const float rr = v[r * TC_THREADS], t = v[(NREG + r) * TC_THREADS];
      const float inv = 1.0f / (1.0f - alb[r] * rr);
      ab[r] = rr + t * t * alb[r] * inv;
      sb[r] = v[(2 * NREG + r) * TC_THREADS]
          + t * (src[r] + alb[r] * v[(3 * NREG + r) * TC_THREADS]) * inv;
    }
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) { alb[r] = ab[r]; src[r] = sb[r]; }
    } else {
      V.template mix<true>(ab, alb);
      U.template mix<false>(sb, src);
    }
  });

  // ---- downward sweep from a dark top, mixed through V ----
  float fdn[NREG], fup[NREG];
#pragma unroll
  for (int r = 0; r < NREG; ++r) fdn[r] = 0.0f;
  if (live) {
    up[i] = rsum<NREG>(src);
    dn[i] = 0.0f;
  }
  // ring slots: ref, trans, src_dn, then the albedo and the source below
  // the layer, each at k * NREG + r; the matrix ring V
  th.sweep<5 * NREG, NREG * NREG>(nlev, [&](int l, float* dst,
                                            float* mdst) {
    const bool cl = th.clr(l);
    if (__any_sync(0xffffffffu, mixes_down(l)))
      th.copy_mats<NREG, 1>(mdst, vmat, vmat, l + 1, nc);
    const float* const base[5] = {ref, trans, src_dn, scratch, scratch};
    const size_t row0[5] = {at(l, 0), at(l, 0), at(l, 0), sc(l, 0, 0),
                            sc(l, 1, 0)};
    const bool need[5] = {!cl, !cl, !cl, !cl, src_kept(l)};
    th.copy_rows<VEC, NREG>(dst, base, row0, need);
  }, [&](int l, const float* v, const float* mv) {
    const bool is_clear = th.clr(l);
    const bool keep_src = src_kept(l);
    const bool both_clear = !mixes_down(l);
    Mat<NREG> V;
    if (!both_clear) V.load(mv);
    float fnew[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      const float s = r == 0 || keep_src ? v[(4 * NREG + r) * TC_THREADS]
                                         : 0.0f;
      if (r > 0 && is_clear) {
        // the plain version's zero flux, and s + 0 x albedo
        fnew[r] = 0.0f;
        fup[r] = s + 0.0f;
        continue;
      }
      const float rr = v[r * TC_THREADS];
      const float a = v[(3 * NREG + r) * TC_THREADS];
      const float inv = 1.0f / (1.0f - rr * a);
      fnew[r] = (v[(NREG + r) * TC_THREADS] * fdn[r] + rr * s
                 + v[(2 * NREG + r) * TC_THREADS]) * inv;
      fup[r] = s + fnew[r] * a;
    }
    if (both_clear) {
#pragma unroll
      for (int r = 0; r < NREG; ++r) fdn[r] = fnew[r];
    } else {
      V.template mix<false>(fnew, fdn);
    }
    if (live) {
      const size_t jb = (size_t)(l + 1) * m + i;
      up[jb] = rsum<NREG>(fup);
      dn[jb] = rsum<NREG>(fdn);
    }
  });
}

// a sweep kernel's dynamic shared memory, and the SM's memory as shared
// memory as far as the carveout allows
template <class Kernel>
cudaError_t tc_attributes(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

inline size_t tc_smem(int nlev, int slots, int mats, int nreg) {
  return (size_t)tc_smem_floats(nlev, slots, mats, nreg) * sizeof(float);
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
  using namespace ecrad;
  const size_t m = (size_t)ng * ncol;
  if (nreg != 2 && nreg != 3) return (int)cudaErrorInvalidValue;
  if (m == 0 || nlev < 1) return (int)cudaGetLastError();
  const bool vec = ncol % 4 == 0;
  const auto kernel = nreg == 3 ? (vec ? tc_sw_kernel<3, true>
                                       : tc_sw_kernel<3, false>)
                                : (vec ? tc_sw_kernel<2, true>
                                       : tc_sw_kernel<2, false>);
  const size_t smem = tc_smem(nlev, SW_SLOTS, SW_MATS, nreg);
  cudaError_t e = tc_attributes(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = tc_blocks(ng, ncol);
  kernel<<<blocks, TC_THREADS, smem, (cudaStream_t)stream>>>(
      ref, trans, ref_dir, tdd, tdir, vmat, clear, alb_diff, alb_dir, mu0,
      incoming, frac_top, nlev, ng, ncol, scratch, up, dn_diff, dn_dir);
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
  using namespace ecrad;
  const size_t m = (size_t)ng * ncol;
  if (nreg != 2 && nreg != 3) return (int)cudaErrorInvalidValue;
  if (m == 0 || nlev < 1) return (int)cudaGetLastError();
  const bool vec = ncol % 4 == 0;
  const auto kernel = nreg == 3 ? (vec ? tc_lw_kernel<3, true>
                                       : tc_lw_kernel<3, false>)
                                : (vec ? tc_lw_kernel<2, true>
                                       : tc_lw_kernel<2, false>);
  const size_t smem = tc_smem(nlev, LW_SLOTS, LW_MATS, nreg);
  cudaError_t e = tc_attributes(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = tc_blocks(ng, ncol);
  kernel<<<blocks, TC_THREADS, smem, (cudaStream_t)stream>>>(
      ref, trans, src_up, src_dn, vmat, umat, clear, emission, albedo,
      frac_bot, nlev, ng, ncol, scratch, up, dn);
  return (int)cudaGetLastError();
}

// Resources of B5's SW (which 0) or LW (which 1) kernel at nreg regions,
// launched over nlev levels with a column count that is a multiple of 4
// (the 16-byte copies; kernel_info.cuh)
extern "C" int tc_sweeps_info(int which, int nreg, int nlev, int* info) {
  using namespace ecrad;
  if ((which != 0 && which != 1) || (nreg != 2 && nreg != 3) || nlev < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = which ? tc_smem(nlev, LW_SLOTS, LW_MATS, nreg)
                            : tc_smem(nlev, SW_SLOTS, SW_MATS, nreg);
  if (which == 0) {
    const auto kernel = nreg == 3 ? tc_sw_kernel<3, true>
                                  : tc_sw_kernel<2, true>;
    cudaError_t e = tc_attributes(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    return kernel_info(kernel, TC_THREADS, smem, info);
  }
  const auto kernel = nreg == 3 ? tc_lw_kernel<3, true>
                                : tc_lw_kernel<2, true>;
  cudaError_t e = tc_attributes(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  return kernel_info(kernel, TC_THREADS, smem, info);
}
