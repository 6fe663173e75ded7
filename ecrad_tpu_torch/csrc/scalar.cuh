// Scalar helpers of the kernels that are templates on their scalar type
// T: float for the float32 path, double for the float64 path.
#pragma once

#include <cuda_runtime.h>

// The constant x of type T: spelt as a float literal in a float form, as
// the float kernels always spelt it, and as a double literal in a double
// form, as the plain versions' Python scalars are. x needs a decimal point
// or an exponent (x##f must be a float literal).
#define ECRAD_LIT(x) (sizeof(T) == 4 ? (T)(x##f) : (T)(x))

namespace ecrad {

// libm's float functions in a float form and its double ones in a double
// form (exact, no fast-math)
__device__ __forceinline__ float mexp(float x) { return expf(x); }
__device__ __forceinline__ double mexp(double x) { return exp(x); }
__device__ __forceinline__ float mlog(float x) { return logf(x); }
__device__ __forceinline__ double mlog(double x) { return log(x); }
__device__ __forceinline__ float mfloor(float x) { return floorf(x); }
__device__ __forceinline__ double mfloor(double x) { return floor(x); }
__device__ __forceinline__ float mmax(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double mmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float mmin(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double mmin(double a, double b) {
  return fmin(a, b);
}

}  // namespace ecrad
