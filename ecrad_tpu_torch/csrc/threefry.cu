// The McICA cloud generator's random fields: jax.random's Threefry-2x32
// key chain and uniform draws, in one launch.
//
// Replaces no TPU kernel: the JAX package draws with jax.random
// (ecrad_tpu/solvers/cloud_generator.py:73-85), which XLA compiles into
// its own fused loop. The port's plain version is utils/threefry.py, which
// computes uint32 arithmetic in int64 tensors, six full-size passes a
// round; this kernel gives the same bits.
//
// For each column c: key = fold_in(PRNGKey(seed), iseed[c]), that is
// threefry(seed_hi, seed_lo; 0, iseed[c] mod 2^32); subkey d of
// split(key, 4) = threefry(key; 0, d); draw d's value n =
// threefry(subkey; 0, n) turned into a uniform in [0, 1): float32 takes
// the 23 high bits of b0 ^ b1, float64 the 52 high bits of (b0 << 32) | b1,
// each as the mantissa of a number in [1, 2), less 1. Draw 0 is rand_top
// (ncol, ng), n < ng; draws 1-3 are rand_cloud, u1 and u2 (ncol, nlev,
// ng), n < nlev * ng (jax's threefry_partitionable counters).
//
// What bounds it: the integer pipe. A uniform costs one hash, 72 32-bit
// integer operations (20 rounds of add, rotate and xor, 5 key injections
// of two adds) and 3 more to make the float, and is written once: about
// 212 M hashes and 0.85 GB of float32 at the McICA call's 2048 x 137
// columns. The design:
// - native uint32 adds and rotations by __funnelshift_l, no masking;
// - the key injection plus its round constant is one 3-input add;
// - the two hashes of a (column, draw) key chain are computed once per
//   block into shared memory, not once per output;
// - each thread hashes VEC consecutive counters (independent chains, for
//   the pipe's latency) and stores them with one 16-byte store (two for
//   float64), so a warp's stores are contiguous along g.
// A block owns SPAN consecutive values of one draw, flattened over
// (column, counter); the columns it spans (one or two at the McICA
// shapes, up to SPAN where a draw has one value a column) get their keys
// from the block's own threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace ecrad {
namespace rng {

constexpr int THREADS = 256;
constexpr int VEC = 4;        // consecutive counters a thread hashes at once
constexpr int GROUPS = 2;     // such groups a thread takes, THREADS*VEC apart
constexpr int SPAN = THREADS * VEC * GROUPS;   // values a block owns

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py threefry2x32)
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.uniform's bits -> [0, 1) (jax/_src/random.py _uniform)
__device__ __forceinline__ float uniform(uint2 b, float) {
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double uniform(uint2 b, double) {
  const uint64_t bits = ((uint64_t)b.x << 20) | (b.y >> 12)
                        | 0x3FF0000000000000ull;
  return __longlong_as_double((long long)bits) - 1.0;
}

__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(double* p, const double (&v)[VEC]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// blocks [0, blocks_top) make draw 0, then blocks_rest blocks each draw
// 1, 2, 3. Every output is contiguous and 16-byte aligned; ncol * nlev *
// ng + SPAN < 2^31 (the wrapper checks).
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
threefry_fields_kernel(const S* __restrict__ iseed, uint32_t seed_hi,
                       uint32_t seed_lo, int ncol, int ng, int nlevg,
                       int blocks_top, int blocks_rest,
                       T* __restrict__ top, T* __restrict__ cloud,
                       T* __restrict__ u1, T* __restrict__ u2) {
  __shared__ uint2 keys[SPAN];
  int b = blockIdx.x, draw = 0, len = ng;
  T* out = top;
  if (b >= blocks_top) {
    b -= blocks_top;
    draw = 1 + b / blocks_rest;
    b -= (draw - 1) * blocks_rest;
    len = nlevg;
    out = draw == 1 ? cloud : draw == 2 ? u1 : u2;
  }
  const int start = b * SPAN;
  const int end = min(start + SPAN, ncol * len);
  const int c0 = start / len;
  const int c1 = (end - 1) / len;
  for (int j = threadIdx.x; j <= c1 - c0; j += THREADS) {
    const uint2 k = threefry(seed_hi, seed_lo, 0u, (uint32_t)iseed[c0 + j]);
    keys[j] = threefry(k.x, k.y, 0u, (uint32_t)draw);
  }
  __syncthreads();
#pragma unroll
  for (int grp = 0; grp < GROUPS; ++grp) {
    const int e = start + (grp * THREADS + (int)threadIdx.x) * VEC;
    if (e >= end) break;
    int c = e / len;
    int n = e - c * len;
    T v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const uint2 k = keys[min(c, c1) - c0];   // past `end`: not stored
      v[i] = uniform(threefry(k.x, k.y, 0u, (uint32_t)n), T());
      if (++n == len) {
        n = 0;
        ++c;
      }
    }
    if (e + VEC <= end) {
      store(out + e, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (e + i < end) out[e + i] = v[i];
    }
  }
}

inline int blocks_for(long long values) {
  return (int)((values + SPAN - 1) / SPAN);
}

template <typename T, typename S>
int launch(const void* iseed, uint32_t seed_hi, uint32_t seed_lo, int ncol,
           int nlev, int ng, void* top, void* cloud, void* u1, void* u2,
           cudaStream_t stream) {
  const int blocks_top = blocks_for((long long)ncol * ng);
  const int blocks_rest = blocks_for((long long)ncol * nlev * ng);
  const int blocks = blocks_top + 3 * blocks_rest;
  if (blocks > 0)
    threefry_fields_kernel<T, S><<<blocks, THREADS, 0, stream>>>(
        (const S*)iseed, seed_hi, seed_lo, ncol, ng, nlev * ng, blocks_top,
        blocks_rest, (T*)top, (T*)cloud, (T*)u1, (T*)u2);
  return (int)cudaGetLastError();
}

}  // namespace rng
}  // namespace ecrad

// iseed (ncol,) int32 (iseed64 = 0) or int64 on the device; the key words
// of PRNGKey(seed_offset); outputs rand_top (ncol, ng) and rand_cloud, u1,
// u2 (ncol, nlev, ng), float32 (f64 = 0) or float64
extern "C" int threefry_fields(const void* iseed, int iseed64,
                               unsigned seed_hi, unsigned seed_lo, int ncol,
                               int nlev, int ng, int f64, void* top,
                               void* cloud, void* u1, void* u2,
                               void* stream) {
  using namespace ecrad::rng;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return iseed64 ? launch<double, int64_t>(iseed, seed_hi, seed_lo, ncol,
                                             nlev, ng, top, cloud, u1, u2, s)
                   : launch<double, int32_t>(iseed, seed_hi, seed_lo, ncol,
                                             nlev, ng, top, cloud, u1, u2, s);
  return iseed64 ? launch<float, int64_t>(iseed, seed_hi, seed_lo, ncol, nlev,
                                          ng, top, cloud, u1, u2, s)
                 : launch<float, int32_t>(iseed, seed_hi, seed_lo, ncol, nlev,
                                          ng, top, cloud, u1, u2, s);
}

// the kernel's resources and the blocks per SM its launch gets
// (kernel_info.cuh), for float64 outputs or float32, int32 seeds
extern "C" int threefry_fields_info(int f64, int* info) {
  using namespace ecrad;
  using namespace ecrad::rng;
  return f64 ? kernel_info(threefry_fields_kernel<double, int32_t>, THREADS, 0,
                           info)
             : kernel_info(threefry_fields_kernel<float, int32_t>, THREADS, 0,
                           info);
}
