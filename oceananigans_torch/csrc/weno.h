// WENO-Z reconstruction of any order of weno_tables.h, for the CUDA kernels
// of oceananigans_torch: the counterpart of advection.WENO._onesided and of
// the upwind selects of the Pallas kernels (_sel2/_sel3 in
// oceananigans_tpu/ops/pallas_vi.py, _recon in ops/pallas_tracer.py).
//
// Taps: s[m] holds the reconstructed field at offset m - B from the target
// (m = 0 .. 2B-1), the Python taps {n: shift(a, n + o)} for n = -B..B-1.
// The left-biased value reads them as they are, the right-biased one
// through the reflection n -> -1-n. The WENO-Z ratio tau/(beta+eps) is
// capped at 1e12 in float32 and 1e60 in float64, as the Python package
// caps it, and every division is exact IEEE division (no fast math).

#pragma once

#include "weno_tables.h"

namespace ot_weno {

template <typename T>
struct RatioCap;
template <>
struct RatioCap<float> {
  static constexpr float value = 1e12f;
};
template <>
struct RatioCap<double> {
  static constexpr double value = 1e60;
};

template <int K, bool kRight, typename T>
__device__ __forceinline__ T tap(const T* s, int n) {
  constexpr int B = WenoTable<K>::B;
  return kRight ? s[B - 1 - n] : s[n + B];
}

// The B smoothness indicators of the taps s, added to beta (kAdd) or
// written over it.
template <int K, bool kRight, bool kAdd, typename T>
__device__ __forceinline__ void betas(const T* s, T* beta) {
  using W = WenoTable<K>;
  constexpr int B = W::B;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    T v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = tap<K, kRight>(s, W::lo(r) + j);
    T b = T(0);
    if constexpr (W::form == BetaForm::kSquares) {
#pragma unroll
      for (int t = 0; t < W::terms; ++t) {
        T x = T(W::l(r, t, 0)) * v[0];
#pragma unroll
        for (int j = 1; j < B; ++j) {
          if (W::l(r, t, j) != 0.0) x = x + T(W::l(r, t, j)) * v[j];
        }
        b = (t == 0) ? T(W::w(t)) * (x * x) : b + T(W::w(t)) * (x * x);
      }
    } else {
#pragma unroll
      for (int m = 0; m < B; ++m) {
        T x = T(W::p(r, m, m)) * v[m];
#pragma unroll
        for (int n = m + 1; n < B; ++n) {
          if (W::p(r, m, n) != 0.0) x = x + T(W::p(r, m, n)) * v[n];
        }
        b = (m == 0) ? v[m] * x : b + v[m] * x;
      }
    }
    beta[r] = kAdd ? beta[r] + b : b;
  }
}

// The WENO-Z combination of the sub-stencil polynomials of the taps s with
// the indicators beta: alpha_r = gamma_r (1 + min(tau/(beta_r+eps), cap)^2).
template <int K, bool kRight, typename T>
__device__ __forceinline__ T combine(const T* s, const T* beta, T eps) {
  using W = WenoTable<K>;
  constexpr int B = W::B;
  const T tau = fabs(beta[0] - beta[B - 1]);
  T asum = T(0);
  T out = T(0);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const T ratio = fmin(tau / (beta[r] + eps), RatioCap<T>::value);
    const T alpha = T(W::gamma(r)) * (T(1) + ratio * ratio);
    T poly = T(W::q(r, 0)) * tap<K, kRight>(s, W::lo(r));
#pragma unroll
    for (int j = 1; j < B; ++j) {
      poly = poly + T(W::q(r, j)) * tap<K, kRight>(s, W::lo(r) + j);
    }
    asum = (r == 0) ? alpha : asum + alpha;
    out = (r == 0) ? alpha * poly : out + alpha * poly;
  }
  return out / asum;
}

// One biased reconstruction of the taps s. kSmooth = 0: the indicators of s
// itself; 1 or 2: the summed indicators of the smoothness taps s1 (and s2)
// (the reference's FunctionStencil/VelocityStencil).
template <int K, bool kRight, int kSmooth, typename T>
__device__ __forceinline__ T side(const T* s, const T* s1, const T* s2,
                                  T eps) {
  T beta[WenoTable<K>::B];
  if constexpr (kSmooth == 0) {
    betas<K, kRight, false>(s, beta);
  } else {
    betas<K, kRight, false>(s1, beta);
    if constexpr (kSmooth == 2) betas<K, kRight, true>(s2, beta);
  }
  return combine<K, kRight>(s, beta, eps);
}

// Upwind select where the value is multiplied by U afterwards: left-biased
// for U > 0, else right-biased (where U == 0 the Python package averages
// the two, and U times either is zero).
template <int K, int kSmooth, typename T>
__device__ __forceinline__ T upwind(const T* s, const T* s1, const T* s2,
                                    T U, T eps) {
  if (U > T(0)) return side<K, false, kSmooth>(s, s1, s2, eps);
  return side<K, true, kSmooth>(s, s1, s2, eps);
}

// The exact select of the Python package, for a value that is not
// multiplied by U (the Bernoulli self difference): U == 0 gives the mean of
// the two biased values.
template <int K, int kSmooth, typename T>
__device__ __forceinline__ T upwind_mean(const T* s, const T* s1,
                                         const T* s2, T U, T eps) {
  if (U > T(0)) return side<K, false, kSmooth>(s, s1, s2, eps);
  if (U < T(0)) return side<K, true, kSmooth>(s, s1, s2, eps);
  return T(0.5) * (side<K, false, kSmooth>(s, s1, s2, eps)
                   + side<K, true, kSmooth>(s, s1, s2, eps));
}

// Products and sums that the compiler may not contract into FMAs.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// The smoothness indicators in the Python package's order of operations,
// each product and sum rounded on its own, as its whole-array expressions
// round them: advection._weno3_betas/_weno5_betas (kSquares), the
// Balsara-Shu forms of advection._weno7_betas, whose sub-stencils 2 and 3
// are sub-stencils 1 and 0's forms over the reversed taps, and for orders 9
// and 11 WENO._betas_of: the sum over m of M_mm v_m v_m, then of
// 2 M_mn v_m v_n for n > m, term by term.
template <int K, bool kRight, typename T>
__device__ __forceinline__ void betas_in_order(const T* s, T* beta) {
  using W = WenoTable<K>;
  constexpr int B = W::B;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    T b = T(0);
    if constexpr (W::form == BetaForm::kSquares) {
      T v[B];
#pragma unroll
      for (int j = 0; j < B; ++j) v[j] = tap<K, kRight>(s, W::lo(r) + j);
#pragma unroll
      for (int t = 0; t < W::terms; ++t) {
        T x = mul_rn(T(W::l(r, t, 0)), v[0]);
#pragma unroll
        for (int j = 1; j < B; ++j) {
          if (W::l(r, t, j) != 0.0) x = add_rn(x, mul_rn(T(W::l(r, t, j)), v[j]));
        }
        const T term = mul_rn(T(W::w(t)), mul_rn(x, x));
        b = (t == 0) ? term : add_rn(b, term);
      }
    } else if constexpr (K == 7) {
      const bool reversed = r >= 2;
      const int form = reversed ? B - 1 - r : r;
      T v[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        v[j] = tap<K, kRight>(s, W::lo(r) + (reversed ? B - 1 - j : j));
      }
#pragma unroll
      for (int m = 0; m < B; ++m) {
        T x = mul_rn(T(W::p(form, m, m)), v[m]);
#pragma unroll
        for (int n = m + 1; n < B; ++n) {
          x = add_rn(x, mul_rn(T(W::p(form, m, n)), v[n]));
        }
        b = (m == 0) ? mul_rn(v[m], x) : add_rn(b, mul_rn(v[m], x));
      }
    } else {
      T v[B];
#pragma unroll
      for (int j = 0; j < B; ++j) v[j] = tap<K, kRight>(s, W::lo(r) + j);
#pragma unroll
      for (int m = 0; m < B; ++m) {
#pragma unroll
        for (int n = m; n < B; ++n) {
          if (n == m || W::p(r, m, n) != 0.0) {
            const T term = mul_rn(mul_rn(T(W::p(r, m, n)), v[m]), v[n]);
            b = (m == 0 && n == 0) ? term : add_rn(b, term);
          }
        }
      }
    }
    beta[r] = b;
  }
}

// One biased reconstruction in the Python package's order of operations
// (WENO._onesided and _z_alphas), each product and sum rounded on its own.
template <int K, bool kRight, typename T>
__device__ __forceinline__ T side_in_order(const T* s, T eps) {
  using W = WenoTable<K>;
  constexpr int B = W::B;
  T beta[B];
  betas_in_order<K, kRight>(s, beta);
  const T tau = fabs(add_rn(beta[0], -beta[B - 1]));
  T asum = T(0);
  T out = T(0);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const T ratio = fmin(tau / add_rn(beta[r], eps), RatioCap<T>::value);
    const T alpha = mul_rn(T(W::gamma(r)), add_rn(T(1), mul_rn(ratio, ratio)));
    T poly = mul_rn(T(W::q(r, 0)), tap<K, kRight>(s, W::lo(r)));
#pragma unroll
    for (int j = 1; j < B; ++j) {
      poly = add_rn(poly, mul_rn(T(W::q(r, j)), tap<K, kRight>(s, W::lo(r) + j)));
    }
    asum = (r == 0) ? alpha : add_rn(asum, alpha);
    out = (r == 0) ? mul_rn(alpha, poly) : add_rn(out, mul_rn(alpha, poly));
  }
  return out / asum;
}

// j wrapped into [0, n) for -n <= j < 2n.
__device__ __forceinline__ int wrap(int j, int n) {
  j = j < 0 ? j + n : j;
  return j >= n ? j - n : j;
}

}  // namespace ot_weno
