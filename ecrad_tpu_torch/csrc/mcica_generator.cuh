// McICA's cloud generator: the kernel's device code, one block per column
// (mcica_generator.cu launches it and says what bounds it). Plain C++
// apart from CUDA's qualifiers and built-ins, so that a host build with
// those defined away runs it a block at a time
// (tests/test_torch_mcica_generator.py).
#pragma once

#include <cuda_runtime.h>

#include "scalar.cuh"

namespace ecrad {
namespace gen {

// config.Overlap
constexpr int MAX_RAN = 0;
constexpr int EXP_RAN = 1;
constexpr int EXP_EXP = 2;
// solvers/cloud_cover.py and pdf_sampler.py; each is a Python float that
// the plain version rounds to the tensors' type
constexpr double MAX_CLOUD_FRAC = 1.0 - 1.2e-6;
constexpr double MIN_FRAC = 1.0e-6;
constexpr double CDF_MIN = 1.0e-4;
constexpr double CDF_MAX = 1.0 - 1.0e-4;
constexpr int CHEB = 17;        // pdf_sampler.CHEB_DEGREE + 1
constexpr int MAX_THREADS = 256;

// Cephes' ndtri coefficients as torch.special.ndtri holds them (ATen's
// Math.cuh ndtri_string), each rounded to the scalar type
#define NDTRI_P0                                                         \
  -5.99633501014107895267E1, 9.80010754185999661536E1,                   \
      -5.66762857469070293439E1, 1.39312609387279679503E1,               \
      -1.23916583867381258016E0
#define NDTRI_Q0                                                         \
  1.00000000000000000000E0, 1.95448858338141759834E0,                    \
      4.67627912898881538453E0, 8.63602421390890590575E1,                \
      -2.25462687854119370527E2, 2.00260212380060660359E2,               \
      -8.20372256168333339912E1, 1.59056225126211695515E1,               \
      -1.18331621121330003142E0
#define NDTRI_P1                                                         \
  4.05544892305962419923E0, 3.15251094599893866154E1,                    \
      5.71628192246421288162E1, 4.40805073893200834700E1,                \
      1.46849561928858024014E1, 2.18663306850790267539E0,                \
      -1.40256079171354495875E-1, -3.50424626827848203418E-2,            \
      -8.57456785154685413611E-4
#define NDTRI_Q1                                                         \
  1.00000000000000000000E0, 1.57799883256466749731E1,                    \
      4.53907635128879210584E1, 4.13172038254672030440E1,                \
      1.50425385692907503408E1, 2.50464946208309415979E0,                \
      -1.42182922854787788574E-1, -3.80806407691578277194E-2,            \
      -9.33259480895457427372E-4
#define NDTRI_P2                                                         \
  3.23774891776946035970E0, 6.91522889068984211695E0,                    \
      3.93881025292474443415E0, 1.33303460815807542389E0,                \
      2.01485389549179081538E-1, 1.23716634817820021358E-2,              \
      3.01581553508235416007E-4, 2.65806974686737550832E-6,              \
      6.23974539184983293730E-9
#define NDTRI_Q2                                                         \
  1.00000000000000000000E0, 6.02427039364742014255E0,                    \
      3.67983563856160859403E0, 1.37702099489081330271E0,                \
      2.16236993594496635890E-1, 1.34204006088543189037E-2,              \
      3.28014464682127739104E-4, 2.89247864745380683936E-6,              \
      6.79019408009981274425E-9

template <typename T>
struct Ndtri {
  T p0[5], q0[9], p1[9], q1[9], p2[9], q2[9];
};
__constant__ Ndtri<float> NDTRI_F = {{NDTRI_P0}, {NDTRI_Q0}, {NDTRI_P1},
                                     {NDTRI_Q1}, {NDTRI_P2}, {NDTRI_Q2}};
__constant__ Ndtri<double> NDTRI_D = {{NDTRI_P0}, {NDTRI_Q0}, {NDTRI_P1},
                                      {NDTRI_Q1}, {NDTRI_P2}, {NDTRI_Q2}};

__device__ __forceinline__ const Ndtri<float>& ndtri_table(float) {
  return NDTRI_F;
}
__device__ __forceinline__ const Ndtri<double>& ndtri_table(double) {
  return NDTRI_D;
}

__device__ __forceinline__ float mfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mfma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float mpow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double mpow(double x, double e) {
  return pow(x, e);
}
__device__ __forceinline__ float mmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double mmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return mmin(mmax(x, lo), hi);
}

template <typename T, int N>
__device__ __forceinline__ T polevl(T x, const T (&a)[N]) {
  T r = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) r = mfma(r, x, a[i]);
  return r;
}

// torch.special.ndtri (Cephes) on y in (0, 1)
template <typename T>
__device__ T ndtri(T y0) {
  const Ndtri<T>& k = ndtri_table(T());
  const T one = 1;
  const T e2 = (T)0.13533528323661269189;   // exp(-2)
  bool code = true;
  T y = y0;
  if (y > one - e2) {
    y = one - y;
    code = false;
  }
  if (y > e2) {
    y = y - (T)0.5;
    const T y2 = y * y;
    const T x = mfma(y, y2 * polevl(y2, k.p0) / polevl(y2, k.q0), y);
    return x * (T)2.50662827463100050242;
  }
  const T x = msqrt((T)-2.0 * mlog(y));
  const T x0 = x - mlog(x) / x;
  const T z = one / x;
  const T x1 = x < (T)8.0 ? z * polevl(z, k.p1) / polevl(z, k.q1)
                          : z * polevl(z, k.p2) / polevl(z, k.q2);
  const T r = x0 - x1;
  return code ? -r : r;
}

// Shonk et al. beta -> Hogan-Illingworth alpha (cloud_cover.beta2alpha)
template <typename T>
__device__ __forceinline__ T beta2alpha(T beta, T f1, T f2) {
  const T one = 1;
  const T fd = mabs(f1 - f2);
  const T a = beta + (one - beta) * fd /
                         (fd + one / mmax(beta, (T)1e-12) - one);
  return beta < one ? a : one;
}

// x ** e as torch.pow(tensor, e) computes it for a Python number e (its
// special exponents, else pow)
template <typename T>
__device__ __forceinline__ T pow_scalar(T x, double e) {
  if (e == 0.0) return (T)1;
  if (e == 1.0) return x;
  if (e == 2.0) return x * x;
  if (e == 3.0) return x * x * x;
  if (e == 0.5) return msqrt(x);
  if (e == -0.5) return (T)1 / msqrt(x);
  if (e == -1.0) return (T)1 / x;
  if (e == -2.0) return (T)1 / (x * x);
  return mpow(x, (T)e);
}

template <typename T>
struct Args {
  const T* frac;          // (ncol, nlev)
  const T* overlap;       // (ncol, nlev - 1)
  const T* fsd;           // (ncol, nlev)
  const T* rand_top;      // (ncol, ng)
  const T* rand_cloud;    // (ncol, nlev, ng), as u1 and u2
  const T* u1;
  const T* u2;
  const float* cheb;      // (nfsd, CHEB) or NULL: the bilinear table
  const T* val;           // (ncdf, nfsd), read when cheb is NULL
  int ncol, nlev, ng, scheme, beta, nfsd, ncdf;
  double frac_threshold, inv_decorr, fsd1, inv_fsd_interval, zsum, zdiff;
  T* od_scaling;          // (ncol, nlev, ng)
  T* total_cover;         // (ncol,)
};

// the column's state in dynamic shared memory: nlev = L, objects NO
struct Layout {
  int L, NO;
  __host__ __device__ static int objects(int L) { return (L + 1) / 2 + 1; }
  __host__ __device__ explicit Layout(int nlev)
      : L(nlev), NO(objects(nlev)) {}
  // T arrays: frac, pcc, cum, work, ainh, wsmp (L each); cc_obj, a_obj
  // (NO each) and the total cover; then int arrays: zc, ismp, flags (L
  // each); top, base, imax, nxt, act (NO each); 4 ints of column scalars
  template <typename T>
  __host__ __device__ size_t bytes() const {
    return sizeof(T) * (6 * (size_t)L + 2 * NO + 1) +
           sizeof(int) * (3 * (size_t)L + 5 * NO + 4);
  }
};

// flags per level
constexpr int CLOUDY = 1;   // frac > MIN_FRAC (the Exp-Exp cover's test)
constexpr int TOP = 2;      // the top level of an Exp-Exp object

// One column's Exp-Exp cumulative cover (cloud_cover.cum_cloud_cover_exp_exp)
// by one thread; pcc holds the pair cover and work the pair overlap alpha
// on entry. Returns whether the column holds an object; leaves cum final
// (zero without an object) and work as the cumulative log overlap.
template <typename T>
__device__ bool cover_exp_exp(int L, int NO, const T* frac, const T* pcc,
                              T* cum, T* work, T* cc_obj, T* a_obj, int* zc,
                              int* flags, int* top, int* base, int* imax,
                              int* nxt, int* act) {
  const T one = 1, zero = 0;
  const T min_frac = (T)MIN_FRAC, max_cf = (T)MAX_CLOUD_FRAC;
  // label the objects: a new one at cloud onset, or where the fraction
  // rises again after a descent within a run
  bool in_obj = false, desc = false;
  int id = -1;
  for (int l = 0; l < L; ++l) {
    const T f = frac[l], fp = l > 0 ? frac[l - 1] : zero;
    const bool c = f > min_frac;
    const bool was = l > 0 && fp > min_frac;
    const bool new_obj = c && (!was || !in_obj || (desc && f > fp));
    if (new_obj) ++id;
    desc = new_obj ? false : ((c && in_obj && f < fp) ? true : desc);
    in_obj = c;
    flags[l] = (c ? CLOUDY : 0) | (new_obj ? TOP : 0);
    if (c) {
      if (new_obj) top[id] = l;
      base[id] = l;
      if (!desc) imax[id] = l;      // the last ascending level
    }
  }
  const int nobj = id + 1;
  if (nobj == 0) {
    for (int l = 0; l < L; ++l) cum[l] = zero;
    return false;
  }
  // within-object cumulative cover: the Exp-Ran recurrence restarting at
  // each object top
  T cum_prev = zero;
  for (int l = 0; l < L; ++l) {
    const T f_prev = l > 0 ? frac[l - 1] : zero;
    const T pcc_prev = l > 0 ? pcc[l - 1] : zero;
    const T rec = f_prev >= max_cf
                      ? one
                      : one - (one - cum_prev) * (one - pcc_prev) /
                                  mmax(one - f_prev, (T)1e-12);
    cum_prev = (flags[l] & TOP) ? frac[l]
                                : ((flags[l] & CLOUDY) ? rec : zero);
    cum[l] = cum_prev;
  }
  // the cumulative log overlap and count of zero overlaps over levels
  // [0, l): alpha[l] couples levels l and l + 1
  double acc = 0.0;
  int nz = 0;
  for (int l = 0; l + 1 < L; ++l) {
    const T a = work[l];
    const T lg = mlog(mmax(a, (T)1e-35));
    work[l] = (T)acc;
    zc[l] = nz;
    acc += (double)lg;
    nz += a <= zero;
  }
  work[L - 1] = (T)acc;
  zc[L - 1] = nz;
  // each object's cover and its overlap with the next: the product of
  // alpha over [imax(j), imax(j + 1))
  const int big = L + 10;
  for (int j = 0; j < nobj; ++j) {
    cc_obj[j] = cum[base[j]];
    const int inext = j + 1 < nobj ? imax[j + 1] : big;
    const int a = min(max(imax[j], 0), L - 1);
    const int b = min(max(inext, 0), L - 1);
    const T lp = work[b] - work[a];
    a_obj[j] = inext <= imax[j] ? one : (zc[b] - zc[a] > 0 ? zero : mexp(lp));
    nxt[j] = j + 1;
    act[j] = 1;
  }
  // ordered merging: the pair of neighbours that overlap most first; the
  // candidates are the active slots with index < n_active - 1, the first
  // of equal overlaps taken (the plain version's argmax)
  for (int n_active = nobj; n_active > 1; --n_active) {
    int j = -1;
    T best = zero;
    for (int s = 0; s < n_active - 1; ++s)
      if (act[s] && (j < 0 || a_obj[s] > best)) {
        j = s;
        best = a_obj[s];
      }
    const int k = min(nxt[j], NO - 1);
    const int base_j = base[j], top_k = top[k], base_k = base[k];
    const T cc_j = cc_obj[j], cc_k = cc_obj[k], a = a_obj[j];
    const T cc_base_j = cum[min(max(base_j, 0), L - 1)];
    const T cc_pair = a * mmax(cc_j, cc_k) +
                      (one - a) * (cc_j + cc_k - cc_j * cc_k);
    const T scaling =
        clamp((cc_pair - cc_j) / mmax(cc_k, min_frac), zero, one);
    for (int l = base_j + 1; l < top_k; ++l) cum[l] = cc_base_j;
    for (int l = top_k; l <= base_k; ++l) cum[l] = cc_base_j + cum[l] * scaling;
    cc_obj[j] = cc_pair;
    base[j] = base_k;
    a_obj[j] = a_obj[k];
    nxt[j] = nxt[k];
    act[k] = 0;
  }
  // fill below the final base
  const int final_base = base[0];
  const T cc_final = cum[min(max(final_base, 0), L - 1)];
  for (int l = 0; l < L; ++l)
    cum[l] = mmin(l > final_base ? cc_final : cum[l], one);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
mcica_generator_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a.nlev);
  const int L = lay.L, NO = lay.NO;
  T* frac = reinterpret_cast<T*>(smem);
  T* pcc = frac + L;
  T* cum = pcc + L;
  T* work = cum + L;
  T* ainh = work + L;
  T* wsmp = ainh + L;
  T* cc_obj = wsmp + L;
  T* a_obj = cc_obj + NO;
  T* s_tcc = a_obj + NO;
  int* zc = reinterpret_cast<int*>(s_tcc + 1);
  int* ismp = zc + L;
  int* flags = ismp + L;
  int* top = flags + L;
  int* base = top + NO;
  int* imax = base + NO;
  int* nxt = imax + NO;
  int* act = nxt + NO;
  int* s_col = act + NO;   // ibegin, iend, has_cloud

  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int ng = a.ng, scheme = a.scheme;
  const bool fast = a.cheb != nullptr;
  const T one = 1, zero = 0;
  const T* fr = a.frac + (size_t)c * L;
  const T* ov = a.overlap + (size_t)c * (L - 1);
  const T* fs = a.fsd + (size_t)c * L;

  // the fraction and each level's PDF row and weight (fsd is constant
  // over g): pdf_sampler.sample_pdf_fast, or sample_pdf's fsd axis
  const T fsd1 = (T)a.fsd1, inv_fsd = (T)a.inv_fsd_interval;
  for (int l = tid; l < L; l += nt) {
    frac[l] = fr[l];
    if (fast) {
      const T w = (fs[l] - fsd1) * inv_fsd;
      const int i = min(max((int)mfloor(w), 0), a.nfsd - 2);
      ismp[l] = i;
      wsmp[l] = clamp(w - (T)i, zero, one);
    } else {
      const T w = (fs[l] - fsd1) * inv_fsd + one;
      const int i = min(max((int)mfloor(w), 1), a.nfsd - 1);
      ismp[l] = i;
      wsmp[l] = clamp(w - (T)i, zero, one);
    }
  }
  __syncthreads();
  // the pair cover, and in work the pair overlap (Exp-Exp) or the
  // cumulative cover's ratio (cloud_cover._cum_from_pair); the overlap
  // of the inhomogeneity draws
  const T max_cf = (T)MAX_CLOUD_FRAC;
  for (int l = tid; l + 1 < L; l += nt) {
    const T f1 = frac[l], f2 = frac[l + 1], op = ov[l];
    T p;
    if (scheme == MAX_RAN) {
      p = mmax(f1, f2);
    } else {
      const T alpha = a.beta ? beta2alpha(op, f1, f2) : op;
      p = alpha * mmax(f1, f2) + (one - alpha) * (f1 + f2 - f1 * f2);
      if (scheme == EXP_EXP) work[l] = alpha;
    }
    pcc[l] = p;
    if (scheme != EXP_EXP)
      work[l] = f1 >= max_cf ? zero : (one - p) / mmax(one - f1, (T)1e-12);
    ainh[l] = op > zero ? pow_scalar(op, a.inv_decorr) : op;
  }
  __syncthreads();
  if (tid == 0) {
    bool has_obj = true;
    if (scheme == EXP_EXP) {
      has_obj = cover_exp_exp(L, NO, frac, pcc, cum, work, cc_obj, a_obj, zc,
                              flags, top, base, imax, nxt, act);
    } else {
      // cum(1) = frac(1); cum(l+1) = 1 - (1-cum(l))(1-pcc(l))/(1-frac(l))
      // as 1 - start * cumprod(ratio)
      const T start = one - frac[0];
      cum[0] = one - start;
      double prod = 1.0;
      for (int l = 0; l + 1 < L; ++l) {
        prod *= (double)work[l];
        cum[l + 1] = one - start * (T)prod;
      }
    }
    // the walk's cloudy range: frac > 0
    int ib = -1, ie = L - 1;
    for (int l = 0; l < L; ++l)
      if (frac[l] > zero) {
        if (ib < 0) ib = l;
        ie = l;
      }
    const T tcc = cum[L - 1];
    const bool has = tcc >= (T)a.frac_threshold;
    s_col[0] = ib < 0 ? 0 : ib;
    s_col[1] = ie;
    s_col[2] = has;
    s_col[3] = has_obj;
    *s_tcc = has ? tcc : zero;
    a.total_cover[c] = has ? tcc : zero;
  }
  __syncthreads();
  // the Exp-Exp pair cover the walk takes: at least the cumulative
  // cover's growth
  if (scheme == EXP_EXP) {
    const bool has_obj = s_col[3];
    for (int l = tid; l + 1 < L; l += nt)
      pcc[l] = has_obj ? mmax(pcc[l], frac[l] + cum[l + 1] - cum[l]) : zero;
    __syncthreads();
  }

  const size_t col0 = (size_t)c * L * ng;
  T* out = a.od_scaling + col0;
  if (!s_col[2]) {
    for (int i = tid; i < L * ng; i += nt) out[i] = zero;
    return;
  }
  const int ibegin = s_col[0], iend = s_col[1];
  const T tcc = *s_tcc;
  const bool exp_exp = scheme == EXP_EXP;
  const T zsum = (T)a.zsum, zinv = one / (T)a.zdiff;
  const T cdf_min = (T)CDF_MIN, cdf_max = (T)CDF_MAX;
  for (int g = tid; g < ng; g += nt) {
    // the cloud top: the first level of the cloudy range whose cumulative
    // cover reaches rand_top * total cover, else the range's last
    const T trig = a.rand_top[(size_t)c * ng + g] * tcc;
    int itr = iend;
    for (int l = ibegin; l <= iend; ++l)
      if (cum[l] >= trig) {
        itr = l;
        break;
      }
    const T* rc = a.rand_cloud + col0 + g;
    const T* p1 = a.u1 + col0 + g;
    const T* p2 = a.u2 + col0 + g;
    T u_n = __ldg(rc), v1_n = __ldg(p1), v2_n = __ldg(p2);
    bool cloudy = false;
    T r = zero;
    for (int l = 0; l < L; ++l) {
      const T u = u_n, v1 = v1_n, v2 = v2_n;
      if (l + 1 < L) {
        const size_t o = (size_t)(l + 1) * ng;
        u_n = __ldg(rc + o);
        v1_n = __ldg(p1 + o);
        v2_n = __ldg(p2 + o);
      }
      // the Markov walk (cloud_generator._level_walk)
      const T f = frac[l];
      const T fp = l > 0 ? frac[l - 1] : zero;
      const T cp = l > 0 ? cum[l - 1] : zero;
      const T pp = l > 0 ? pcc[l - 1] : zero;
      const T over = l > 0 ? cum[l] - cum[l - 1] : zero;
      const bool stay = u * fp < f + fp - pp;
      const bool birth = u * (cp - fp) < pp - over - fp;
      const bool below = l > itr && l <= iend;
      const bool cl = itr == l || (below && (cloudy ? stay : birth));
      // the vertically correlated inhomogeneity draw
      bool keep = v2 < (l > 0 ? ainh[l - 1] : zero);
      if (exp_exp)
        keep = keep && below;
      else
        keep = keep && l > 0 && cl && cloudy;
      r = keep ? r : v1;
      cloudy = cl;
      T s = zero;
      if (cl) {
        const int i = ismp[l];
        const T w = wsmp[l];
        if (fast) {
          // Chebyshev series of ln x in z = ndtri(cdf), the rows of fsd
          // either side, blended (pdf_sampler.sample_pdf_fast)
          const T z = ndtri(clamp(r, cdf_min, cdf_max));
          const T t = clamp(((T)2.0 * z - zsum) * zinv, -one, one);
          const float* c0 = a.cheb + i * CHEB;
          const float* c1 = c0 + CHEB;
          T b1 = zero, b2 = zero, d1 = zero, d2 = zero;
#pragma unroll
          for (int k = CHEB - 1; k > 0; --k) {
            const T t2 = (T)2.0 * t;
            const T nb = (T)__ldg(c0 + k) + t2 * b1 - b2;
            const T nd = (T)__ldg(c1 + k) + t2 * d1 - d2;
            b2 = b1;
            b1 = nb;
            d2 = d1;
            d1 = nd;
          }
          const T s0 = (T)__ldg(c0) + t * b1 - b2;
          const T s1 = (T)__ldg(c1) + t * d1 - d2;
          s = (one - w) * mexp(s0) + w * mexp(s1);
        } else {
          // bilinear in (cdf, fsd) (pdf_sampler.sample_pdf)
          const int ncdf = a.ncdf, nfsd = a.nfsd;
          T wc = r * (T)(ncdf - 1) + one;
          const int ic = min(max((int)mfloor(wc), 1), ncdf - 1);
          wc = clamp(wc - (T)ic, zero, one);
          const T* v = a.val + (size_t)(ic - 1) * nfsd + (i - 1);
          s = (one - wc) * (one - w) * __ldg(v) +
              (one - wc) * w * __ldg(v + 1) +
              wc * (one - w) * __ldg(v + nfsd) + wc * w * __ldg(v + nfsd + 1);
        }
      }
      out[(size_t)l * ng + g] = s;
    }
  }
}

}  // namespace gen
}  // namespace ecrad
