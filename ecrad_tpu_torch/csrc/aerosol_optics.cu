// Kernel B12: the aerosol optics merged into the per-g gas optics, both
// spectra in one pass.
//
// Replaces no TPU kernel: the JAX package computes the aerosol optics with
// XLA (ecrad_tpu/optics/aerosol.py add_aerosol_optics: a masked matrix
// product per humidity bin, delta-Eddington and the merge as elementwise
// passes), which the port ran as some 130 PyTorch launches a call
// (optics/aerosol.py add_aerosol_optics_plain), each a pass through device
// memory, most of them over a full (ncol, nlev, ng) array.
//
// For each (column, level) row the kernel computes once: the saturation
// mixing ratio over liquid where the caller gives none
// (Thermodynamics.calc_saturation_wrt_liquid), the relative humidity, its
// bin and the layer mass; for each band the sums over the types of the
// setup's packed LUT rows [extinction | scattering | scattering x g] (the
// LW absorption rows where the LW does not scatter), the types added in
// order, one rounded product and one rounded sum a type, as _type_sum does;
// then delta-Eddington scaling (extensive form) of the SW unless the gases
// are scaled with the aerosol, and of the LW where it scatters. Last it
// merges the band values into the per-g arrays of both spectra through the
// band maps: the SW where band 0 of the row holds aerosol, the LW per g
// where its band does, or the LW absorption alone (the co-albedo form).
//
// What bounds it: device-memory bandwidth. The per-g arrays, (ncol, nlev,
// 112) SW and (ncol, nlev, 140) LW, are read and written once: at 2048 x
// 137 in float32 ~1.7 GB with every input read, ~0.51 ms at 3.35 TB/s
// (~1.0 ms in float64). The per-row work is some 1,100 products and sums
// on tables of 12 types x 12 bins x 90 values (52 KB in float, 104 KB in
// double), which stay in L1 and L2. A block takes AER_ROWS consecutive
// rows (its launch bounds, 6 blocks an SM in float and 4 in double, keep
// enough loads in flight: tools/b12_designs.py times the candidates). Its
// threads compute the rows' humidity bins and masses, then one
// (row, band) each the band values, into shared memory; then they stream
// the rows' per-g runs, which are contiguous, 16 bytes a thread with
// neighbouring threads on neighbouring addresses (one value a thread where
// a run or a pointer is not 16-byte aligned). An input that the merge
// leaves unused is not loaded: the SW asymmetry of a row with aerosol, the
// LW albedo and asymmetry of a run whose g-points' bands all hold aerosol.
// No atomics, no scratch in device memory, no host sync.
//
// Built with -fmad=false and the exact exp and division, so it equals its
// plain version on the card bit for bit. The layer mass is the pressure
// difference times the reciprocal of g: PyTorch's CUDA division of a
// tensor by a Python scalar multiplies by the scalar's reciprocal, so the
// plain version does the same on the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "scalar.cuh"

namespace ecrad {
namespace {

constexpr int AER_ROWS = 32;           // (column, level) rows a block
constexpr int AER_THREADS = 256;       // threads a block
// resident blocks an SM, at least, of the float and the double form: the
// bound on registers a thread that keeps enough loads in flight
constexpr int AER_MIN_BLOCKS = 6;
constexpr int AER_MIN_BLOCKS_F64 = 4;
static_assert(AER_ROWS <= AER_THREADS, "a thread a row in phase 1");

// V values of T loaded or stored at once: 16 bytes where V = 16 / sizeof(T)
template <class T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <class T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* __restrict__ p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <class T, int V>
__device__ __forceinline__ void store(T* __restrict__ p,
                                      const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

// Clausius-Clapeyron saturation mass mixing ratio over liquid water of
// the layer between half levels h and h + 1, in
// Thermodynamics.calc_saturation_wrt_liquid's operation order
template <class T>
__device__ __forceinline__ T saturation(const T* __restrict__ phl,
                                        const T* __restrict__ thl,
                                        size_t h) {
  const T t = ECRAD_LIT(0.5) * (thl[h] + thl[h + 1]);
  const T p = ECRAD_LIT(0.5) * (phl[h] + phl[h + 1]);
  const T e_sat = ECRAD_LIT(6.11e2) *
                  mexp(ECRAD_LIT(17.269) * (t - ECRAD_LIT(273.16)) /
                       (t - ECRAD_LIT(35.86)));
  return mmin(ECRAD_LIT(0.622) * e_sat / mmax(p, ECRAD_LIT(1.0)),
              ECRAD_LIT(1.0));
}

// optics/cloud.py delta_eddington_extensive, in place
template <class T>
__device__ __forceinline__ void delta_eddington_extensive(T& od, T& scat,
                                                          T& scatg) {
  const T g = scat > ECRAD_LIT(0.0)
                  ? scatg / mmax(scat, ECRAD_LIT(1.0e-30))
                  : ECRAD_LIT(0.0);
  const T f = g * g;
  const T scat_new = scat * (ECRAD_LIT(1.0) - f);
  od = od - scat * f;
  scatg = scat_new * g / (ECRAD_LIT(1.0) + g);
  scat = scat_new;
}

// Shared memory of a block: the band values of its rows, SW [row][3][nb_sw]
// (od, scattering, scattering x g, delta-scaled where the SW is) and LW
// [row][3][nb_lw] (od, scattering, the merged asymmetry; od alone in the
// co-albedo form), the rows' layer mass factor, then their humidity bins and
// the two band maps
template <class T>
size_t smem_bytes(int nb_sw, int nb_lw, int ng_sw, int ng_lw) {
  return sizeof(T) * (size_t)AER_ROWS * (3 * nb_sw + 3 * nb_lw + 1) +
         sizeof(int) * ((size_t)AER_ROWS + ng_sw + ng_lw);
}

// grid (ceil(ncol nlev / AER_ROWS)), block (AER_THREADS)
template <class T, int V>
__global__ void __launch_bounds__(AER_THREADS, sizeof(T) == 4
                                                   ? AER_MIN_BLOCKS
                                                   : AER_MIN_BLOCKS_F64)
aerosol_optics_kernel(const T* __restrict__ mixing_ratio,
                      const T* __restrict__ pressure_hl,
                      const T* __restrict__ temperature_hl,
                      const T* __restrict__ h2o_sat_liq,
                      const T* __restrict__ mmr,
                      const T* __restrict__ rh_lower,
                      const T* __restrict__ tab_sw,
                      const T* __restrict__ tab_lw,
                      const int* __restrict__ band_sw,
                      const int* __restrict__ band_lw,
                      const T* __restrict__ od_sw,
                      const T* __restrict__ ssa_sw,
                      const T* __restrict__ g_sw,
                      const T* __restrict__ od_lw,
                      const T* __restrict__ ssa_lw,
                      const T* __restrict__ g_lw,
                      T* __restrict__ od_sw_out, T* __restrict__ ssa_sw_out,
                      T* __restrict__ g_sw_out, T* __restrict__ od_lw_out,
                      T* __restrict__ ssa_lw_out, T* __restrict__ g_lw_out,
                      int ncol, int nlev, int ngas, int ih2o, int nmmr,
                      int ntab, int nrh, int nb_sw, int nb_lw, int ng_sw,
                      int ng_lw, int sw_delta, int lw_scat) {
  extern __shared__ __align__(16) unsigned char aer_smem[];
  T* s_sw = reinterpret_cast<T*>(aer_smem);
  T* s_lw = s_sw + AER_ROWS * 3 * nb_sw;
  T* s_factor = s_lw + AER_ROWS * 3 * nb_lw;
  int* s_irh = reinterpret_cast<int*>(s_factor + AER_ROWS);
  int* s_bsw = s_irh + AER_ROWS;
  int* s_blw = s_bsw + ng_sw;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * AER_ROWS;
  const int nr = min(AER_ROWS, ncol * nlev - r0);

  // 1. the band maps, and each row's humidity bin and mass factor
  for (int i = tid; i < ng_sw; i += AER_THREADS) s_bsw[i] = band_sw[i];
  for (int i = tid; i < ng_lw; i += AER_THREADS) s_blw[i] = band_lw[i];
  if (tid < nr) {
    const int r = tid, row = r0 + tid;
    const int c = row / nlev;
    const size_t h = (size_t)c * (nlev + 1) + (row - c * nlev);
    const T sat = h2o_sat_liq != nullptr
                      ? h2o_sat_liq[row]
                      : saturation(pressure_hl, temperature_hl, h);
    const T rh = mixing_ratio[(size_t)row * ngas + ih2o] /
                 mmax(sat, ECRAD_LIT(1.0e-12));
    int irh = 0;
    for (int k = 1; k < nrh; ++k) irh += rh > rh_lower[k] ? 1 : 0;
    s_irh[r] = irh;
    s_factor[r] = (pressure_hl[h + 1] - pressure_hl[h]) *
                    (ECRAD_LIT(1.0) / ECRAD_LIT(9.80665));
  }
  __syncthreads();

  // 2. the band values, a (row, band) a thread: SW items first, then LW
  const int items_sw = nr * nb_sw;
  const int items = items_sw + nr * nb_lw;
  for (int it = tid; it < items; it += AER_THREADS) {
    const bool sw = it < items_sw;
    const int nb = sw ? nb_sw : nb_lw;
    const int k = sw ? it : it - items_sw;
    const int r = k / nb, b = k - r * nb;
    const T factor = s_factor[r];
    const T* __restrict__ m = mmr + (size_t)(r0 + r) * nmmr;
    T* out = (sw ? s_sw : s_lw) + r * 3 * nb + b;
    if (sw || lw_scat) {
      // the rows [ext | scat | scat g] (ntab, nrh, 3 nb) of bin irh
      const size_t stride = (size_t)nrh * 3 * nb;
      const T* __restrict__ tab =
          (sw ? tab_sw : tab_lw) + (size_t)s_irh[r] * 3 * nb + b;
      T e = ECRAD_LIT(0.0), s = ECRAD_LIT(0.0), sg = ECRAD_LIT(0.0);
      for (int t = 0; t < ntab; ++t) {
        // the types the mixing ratios lack are zero-filled
        const T mass = factor * (t < nmmr ? m[t] : ECRAD_LIT(0.0));
        const T* p = tab + t * stride;
        const T te = mass * p[0], ts = mass * p[nb], tg = mass * p[2 * nb];
        if (t == 0) {
          e = te;
          s = ts;
          sg = tg;
        } else {
          e = e + te;
          s = s + ts;
          sg = sg + tg;
        }
      }
      if (!sw || sw_delta) delta_eddington_extensive(e, s, sg);
      out[0] = e;
      out[nb] = s;
      // the LW keeps the merged asymmetry, which depends on the band alone
      out[2 * nb] = sw ? sg
                       : (s > ECRAD_LIT(0.0)
                              ? sg / mmax(s, ECRAD_LIT(1.0e-30))
                              : ECRAD_LIT(0.0));
    } else {
      // the LW absorption rows (ntab, nrh, nb) of bin irh
      const size_t stride = (size_t)nrh * nb;
      const T* __restrict__ tab = tab_lw + (size_t)s_irh[r] * nb + b;
      T e = ECRAD_LIT(0.0);
      for (int t = 0; t < ntab; ++t) {
        const T te = factor * (t < nmmr ? m[t] : ECRAD_LIT(0.0)) *
                     tab[t * stride];
        e = t == 0 ? te : e + te;
      }
      out[0] = e;
    }
  }
  __syncthreads();

  // 3. the SW merge over the block's contiguous span of (row, g) values;
  // whether a row holds aerosol is decided by band 0 (a run of V values
  // lies within one row)
  const size_t base_sw = (size_t)r0 * ng_sw;
  for (int v = tid; v < nr * ng_sw / V; v += AER_THREADS) {
    const int e = v * V;
    const int r = e / ng_sw, g0 = e - r * ng_sw;
    const size_t i = base_sw + e;
    const T* sa = s_sw + r * 3 * nb_sw;
    const Pack<T, V> od = load<T, V>(od_sw + i);
    const Pack<T, V> ssa = load<T, V>(ssa_sw + i);
    Pack<T, V> o_od, o_ssa, o_g;
    if (sa[0] > ECRAD_LIT(0.0)) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int b = s_bsw[g0 + q];
        const T local_od = od.v[q] + sa[b];
        const T local_scat = ssa.v[q] * od.v[q] + sa[nb_sw + b];
        o_g.v[q] = local_scat > ECRAD_LIT(0.0)
                       ? sa[2 * nb_sw + b] /
                             mmax(local_scat, ECRAD_LIT(1.0e-30))
                       : ECRAD_LIT(0.0);
        o_ssa.v[q] = local_od > ECRAD_LIT(0.0)
                         ? local_scat / mmax(local_od, ECRAD_LIT(1.0e-30))
                         : ECRAD_LIT(0.0);
        o_od.v[q] = local_od;
      }
    } else {
      o_od = od;
      o_ssa = ssa;
      o_g = load<T, V>(g_sw + i);
    }
    store<T, V>(od_sw_out + i, o_od);
    store<T, V>(ssa_sw_out + i, o_ssa);
    store<T, V>(g_sw_out + i, o_g);
  }

  // 4. the LW merge: per g where its band holds aerosol, or the absorption
  // added alone
  const size_t base_lw = (size_t)r0 * ng_lw;
  for (int v = tid; v < nr * ng_lw / V; v += AER_THREADS) {
    const int e = v * V;
    const int r = e / ng_lw, g0 = e - r * ng_lw;
    const size_t i = base_lw + e;
    const T* sa = s_lw + r * 3 * nb_lw;
    const Pack<T, V> od = load<T, V>(od_lw + i);
    Pack<T, V> o_od;
    if (!lw_scat) {
#pragma unroll
      for (int q = 0; q < V; ++q) o_od.v[q] = od.v[q] + sa[s_blw[g0 + q]];
      store<T, V>(od_lw_out + i, o_od);
      continue;
    }
    int band[V];
    bool all = true;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      band[q] = s_blw[g0 + q];
      all = all && sa[band[q]] > ECRAD_LIT(0.0);
    }
    Pack<T, V> ssa = {}, g = {}, o_ssa, o_g;
    if (!all) {
      ssa = load<T, V>(ssa_lw + i);
      g = load<T, V>(g_lw + i);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int b = band[q];
      const T od_a = sa[b];
      if (od_a > ECRAD_LIT(0.0)) {
        const T local_od = od.v[q] + od_a;
        o_od.v[q] = local_od;
        o_ssa.v[q] = sa[nb_lw + b] / mmax(local_od, ECRAD_LIT(1.0e-30));
        o_g.v[q] = sa[2 * nb_lw + b];
      } else {
        o_od.v[q] = od.v[q];
        o_ssa.v[q] = ssa.v[q];
        o_g.v[q] = g.v[q];
      }
    }
    store<T, V>(od_lw_out + i, o_od);
    store<T, V>(ssa_lw_out + i, o_ssa);
    store<T, V>(g_lw_out + i, o_g);
  }
}

template <class T>
bool aligned16(const T* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <class T>
int aerosol_optics_launch(
    const T* mixing_ratio, const T* pressure_hl, const T* temperature_hl,
    const T* h2o_sat_liq, const T* mmr, const T* rh_lower, const T* tab_sw,
    const T* tab_lw, const int* band_sw, const int* band_lw, const T* od_sw,
    const T* ssa_sw, const T* g_sw, const T* od_lw, const T* ssa_lw,
    const T* g_lw, T* od_sw_out, T* ssa_sw_out, T* g_sw_out, T* od_lw_out,
    T* ssa_lw_out, T* g_lw_out, int ncol, int nlev, int ngas, int ih2o,
    int nmmr, int ntab, int nrh, int nb_sw, int nb_lw, int ng_sw, int ng_lw,
    int sw_delta, int lw_scat, void* stream) {
  const long long nrows = (long long)ncol * nlev;
  if (nrows > 0) {
    constexpr int V = 16 / sizeof(T);
    // 16-byte loads and stores where every row's runs and every per-g
    // pointer allow them
    const bool vec = ng_sw % V == 0 && ng_lw % V == 0 &&
                     aligned16(od_sw) && aligned16(ssa_sw) &&
                     aligned16(g_sw) && aligned16(od_lw) &&
                     aligned16(ssa_lw) && aligned16(g_lw) &&
                     aligned16(od_sw_out) && aligned16(ssa_sw_out) &&
                     aligned16(g_sw_out) && aligned16(od_lw_out) &&
                     aligned16(ssa_lw_out) && aligned16(g_lw_out);
    auto kernel =
        vec ? aerosol_optics_kernel<T, V> : aerosol_optics_kernel<T, 1>;
    const size_t smem = smem_bytes<T>(nb_sw, nb_lw, ng_sw, ng_lw);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int grid = (int)((nrows + AER_ROWS - 1) / AER_ROWS);
    kernel<<<grid, AER_THREADS, smem, (cudaStream_t)stream>>>(
        mixing_ratio, pressure_hl, temperature_hl, h2o_sat_liq, mmr,
        rh_lower, tab_sw, tab_lw, band_sw, band_lw, od_sw, ssa_sw, g_sw,
        od_lw, ssa_lw, g_lw, od_sw_out, ssa_sw_out, g_sw_out, od_lw_out,
        ssa_lw_out, g_lw_out, ncol, nlev, ngas, ih2o, nmmr, ntab, nrh, nb_sw,
        nb_lw, ng_sw, ng_lw, sw_delta, lw_scat);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ecrad

// mixing_ratio (ncol, nlev, ngas), its water vapour at ih2o; pressure_hl
// and temperature_hl (ncol, nlev + 1); h2o_sat_liq (ncol, nlev) or NULL
// (computed); mmr (ncol, nlev, nmmr); rh_lower (nrh,); tab_sw (ntab, nrh,
// 3 nb_sw); tab_lw (ntab, nrh, 3 nb_lw) where lw_scat, else the absorption
// rows (ntab, nrh, nb_lw); band_sw (ng_sw,) and band_lw (ng_lw,) int32;
// od/ssa/g_sw (ncol, nlev, ng_sw) and od/ssa/g_lw (ncol, nlev, ng_lw).
// Writes the six *_out arrays of the same shapes; ssa_lw_out and g_lw_out
// are not written (may be NULL) unless lw_scat. sw_delta: delta-Eddington
// scale the SW aerosol (not do_sw_delta_scaling_with_gases).
extern "C" int aerosol_optics(
    const float* mixing_ratio, const float* pressure_hl,
    const float* temperature_hl, const float* h2o_sat_liq, const float* mmr,
    const float* rh_lower, const float* tab_sw, const float* tab_lw,
    const int* band_sw, const int* band_lw, const float* od_sw,
    const float* ssa_sw, const float* g_sw, const float* od_lw,
    const float* ssa_lw, const float* g_lw, float* od_sw_out,
    float* ssa_sw_out, float* g_sw_out, float* od_lw_out, float* ssa_lw_out,
    float* g_lw_out, int ncol, int nlev, int ngas, int ih2o, int nmmr,
    int ntab, int nrh, int nb_sw, int nb_lw, int ng_sw, int ng_lw,
    int sw_delta, int lw_scat, void* stream) {
  return ecrad::aerosol_optics_launch<float>(
      mixing_ratio, pressure_hl, temperature_hl, h2o_sat_liq, mmr, rh_lower,
      tab_sw, tab_lw, band_sw, band_lw, od_sw, ssa_sw, g_sw, od_lw, ssa_lw,
      g_lw, od_sw_out, ssa_sw_out, g_sw_out, od_lw_out, ssa_lw_out, g_lw_out,
      ncol, nlev, ngas, ih2o, nmmr, ntab, nrh, nb_sw, nb_lw, ng_sw, ng_lw,
      sw_delta, lw_scat, stream);
}

// the double form, the float64 path's
extern "C" int aerosol_optics_f64(
    const double* mixing_ratio, const double* pressure_hl,
    const double* temperature_hl, const double* h2o_sat_liq,
    const double* mmr, const double* rh_lower, const double* tab_sw,
    const double* tab_lw, const int* band_sw, const int* band_lw,
    const double* od_sw, const double* ssa_sw, const double* g_sw,
    const double* od_lw, const double* ssa_lw, const double* g_lw,
    double* od_sw_out, double* ssa_sw_out, double* g_sw_out,
    double* od_lw_out, double* ssa_lw_out, double* g_lw_out, int ncol,
    int nlev, int ngas, int ih2o, int nmmr, int ntab, int nrh, int nb_sw,
    int nb_lw, int ng_sw, int ng_lw, int sw_delta, int lw_scat,
    void* stream) {
  return ecrad::aerosol_optics_launch<double>(
      mixing_ratio, pressure_hl, temperature_hl, h2o_sat_liq, mmr, rh_lower,
      tab_sw, tab_lw, band_sw, band_lw, od_sw, ssa_sw, g_sw, od_lw, ssa_lw,
      g_lw, od_sw_out, ssa_sw_out, g_sw_out, od_lw_out, ssa_lw_out, g_lw_out,
      ncol, nlev, ngas, ih2o, nmmr, ntab, nrh, nb_sw, nb_lw, ng_sw, ng_lw,
      sw_delta, lw_scat, stream);
}

// B12's resources at the cells' launch (kernel_info.cuh): f64 0 the float
// form, 1 the double one, 16-byte runs, 14 SW and 16 LW bands, 112 and 140
// g-points
extern "C" int aerosol_optics_info(int f64, int* info) {
  using namespace ecrad;
  if (f64)
    return kernel_info(aerosol_optics_kernel<double, 2>, AER_THREADS,
                       smem_bytes<double>(14, 16, 112, 140), info);
  return kernel_info(aerosol_optics_kernel<float, 4>, AER_THREADS,
                     smem_bytes<float>(14, 16, 112, 140), info);
}
