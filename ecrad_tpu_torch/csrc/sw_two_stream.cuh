// The SW two-stream chain of one (column, level, g) cell, shared by
// kernels B4 (mcica_optics.cu) and B11 (tc_optics.cu): optional
// delta-Eddington scaling, the Zdunkowski PIFM gammas and the
// Meador-Weaver reflectances and transmittances, in the operation order
// of optics/cloud.py delta_eddington and solvers/two_stream.py
// sw_gammas and _sw_reftrans. A float form takes the Meador-Weaver terms
// in double within RESONANCE_WINDOW (0.03) of k mu0 = 1, as
// two_stream.sw_reftrans does, and keeps the nudge |k mu0 - 1| < 1e-6
// exactly; a double form computes in double throughout.
#pragma once
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace ecrad {

template <typename O>
struct SwOut {
  O r, t, rd, tdd, tdir;
};

// solvers/two_stream.py _sw_reftrans at precision T, rounded to O
template <typename O, typename T>
__device__ __forceinline__ SwOut<O> reftrans(T mu0, T od, T ssa, T gamma1,
                                             T gamma2, T gamma3) {
  const T one = T(1.0);
  const T od_over_mu0 = fmax(od / mu0, T(0.0));
  const T gamma4 = one - gamma3;
  const T alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const T alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const T k = sqrt(fmax((gamma1 - gamma2) * (gamma1 + gamma2), T(1.0e-4)));
  T k_mu0 = k * mu0;
  if (fabs(k_mu0 - one) < T(1.0e-6)) k_mu0 = T(1.0 - 1e-6);
  const T k_gamma3 = k * gamma3;
  const T k_gamma4 = k * gamma4;
  const T e0 = exp(-od_over_mu0);
  const T expo = exp(-k * od);
  const T expo2 = expo * expo;
  const T k2e = T(2.0) * k * expo;
  const T rt = one / (k + gamma1 + (k - gamma1) * expo2);
  SwOut<O> o;
  o.r = (O)(gamma2 * (one - expo2) * rt);
  o.t = (O)(k2e * rt);
  const T rt_dir = mu0 * ssa * rt / (one - k_mu0 * k_mu0);
  o.rd = (O)(rt_dir * ((one - k_mu0) * (alpha2 + k_gamma3)
                       - (one + k_mu0) * (alpha2 - k_gamma3) * expo2
                       - k2e * (gamma3 - alpha2 * mu0) * e0));
  o.tdd = (O)(rt_dir * (k2e * (gamma4 + alpha1 * mu0)
                        - e0 * ((one + k_mu0) * (alpha1 + k_gamma4)
                                - (one - k_mu0) * (alpha1 - k_gamma4)
                                * expo2)));
  o.tdir = (O)e0;
  return o;
}

template <typename T>
__device__ __forceinline__ SwOut<T> sw_chain(T mu0, T od, T ssa, T g,
                                             int delta_all) {
  if (delta_all) {                    // optics/cloud.py delta_eddington
    const T f = g * g;
    const T od_new = od * (ECRAD_LIT(1.0) - ssa * f);
    const T ssa_new = ssa * (ECRAD_LIT(1.0) - f) / (ECRAD_LIT(1.0) - ssa * f);
    g = g / (ECRAD_LIT(1.0) + g);
    od = od_new;
    ssa = ssa_new;
  }
  // solvers/two_stream.py sw_gammas, then sw_reftrans: in float, or in
  // double within RESONANCE_WINDOW of k mu0 = 1, where float cancels; the
  // double form in double throughout
  const T factor = ECRAD_LIT(0.75) * g;
  const T gamma1 = ECRAD_LIT(2.0) - ssa * (ECRAD_LIT(1.25) + factor);
  const T gamma2 = ssa * (ECRAD_LIT(0.75) - factor);
  const T gamma3 = ECRAD_LIT(0.5) - mu0 * factor;
  if constexpr (sizeof(T) == 4) {
    const float k =
        sqrtf(fmaxf((gamma1 - gamma2) * (gamma1 + gamma2), 1.0e-4f));
    if (fabsf(k * mu0 - 1.0f) < 0.03f) {
      return reftrans<float, double>(mu0, od, ssa, gamma1, gamma2, gamma3);
    }
    return reftrans<float, float>(mu0, od, ssa, gamma1, gamma2, gamma3);
  } else {
    return reftrans<double, double>(mu0, od, ssa, gamma1, gamma2, gamma3);
  }
}

}  // namespace ecrad
