// Device copies of the SDCA coordinate updates in core/objectives.py.
//
// Each function repeats the plain PyTorch version's operations in the
// same order, one IEEE operation at a time.  Constants are written as
// double literals cast to float, the rounding PyTorch applies to a
// Python float.  Built with -fmad=false (the sparse kernel) they are
// bitwise equal to the plain version on the same card; logf/log1pf are
// the CUDA math library's full-precision functions (no fast math).
#pragma once

#define OBJ_RIDGE 0
#define OBJ_HINGE 1
#define OBJ_LOGISTIC 2

#define BISECT_ITERS 40

__device__ __forceinline__ float ridge_delta(float m, float a, float y,
                                             float q) {
  return (y - m - a) / (1.0f + q);
}

__device__ __forceinline__ float hinge_delta(float m, float a, float y,
                                             float q) {
  q = fmaxf(q, (float)1e-12);
  float b = a * y + (1.0f - y * m) / q;
  b = fminf(fmaxf(b, 0.0f), 1.0f);
  return y * b - a;
}

// g'(d) = y log(b/(1-b)) + m + q d at b = mid, d = (b - b0) y.  The one
// expression of both forms of the bisection (the serial loop below and
// the dense kernel's tree walk), so the compiler contracts it alike.
__device__ __forceinline__ float logistic_gprime(float mid, float b0,
                                                 float m, float y, float q) {
  const float d = (mid - b0) * y;
  return y * (logf(mid) - log1pf(-mid)) + m + q * d;
}

// Guarded bisection on g'(d), b = (a+d) y.
__device__ __forceinline__ float logistic_delta(float m, float a, float y,
                                                float q) {
  const float b0 = a * y;
  float lo = (float)1e-6;
  float hi = (float)(1.0 - 1e-6);
#pragma unroll 1
  for (int it = 0; it < BISECT_ITERS; ++it) {
    const float mid = 0.5f * (lo + hi);
    const float gp = logistic_gprime(mid, b0, m, y, q);
    if (gp * y < 0.0f) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float b = 0.5f * (lo + hi);
  return (b - b0) * y;
}

template <int OBJ>
__device__ __forceinline__ float obj_delta(float m, float a, float y,
                                           float q) {
  if constexpr (OBJ == OBJ_RIDGE) {
    return ridge_delta(m, a, y, q);
  } else if constexpr (OBJ == OBJ_HINGE) {
    return hinge_delta(m, a, y, q);
  } else {
    return logistic_delta(m, a, y, q);
  }
}
