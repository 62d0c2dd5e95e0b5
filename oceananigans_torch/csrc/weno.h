// WENO-Z reconstruction of any order of weno_tables.h, for the CUDA kernels
// of oceananigans_torch: the counterpart of advection.WENO._onesided. The
// smoothness indicators in contracted form (betas) serve the x-marching
// tiles of vi_tile.h, which form their weights with reciprocals; the
// indicators and the one-sided value in the Python package's order of
// operations (betas_in_order, side_in_order) serve them and the generic
// momentum kernel.
//
// Taps: s[m] holds the reconstructed field at offset m - B from the target
// (m = 0 .. 2B-1), the Python taps {n: shift(a, n + o)} for n = -B..B-1.
// The left-biased value reads them as they are, the right-biased one
// through the reflection n -> -1-n. The WENO-Z ratio tau/(beta+eps) is
// capped at 1e12 in float32 and 1e60 in float64, as the Python package
// caps it; side_in_order divides exactly (IEEE division, no fast math).

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
