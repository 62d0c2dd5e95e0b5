// Coefficient tables of the linear reconstructions, written out as literals
// (the build needs nothing but this file): Centered of even orders 2..12
// and UpwindBiased of odd orders 1..11.
//
// Face i sits between cells i-1 and i; "offset n" means cell i+n.
//   CenteredTable<K>: B = K/2; the face value is sum_j c(j) a[i + j - B]
//     for j = 0 .. 2B-1 (offsets -B .. B-1).
//   UpwindTable<K>: B = (K+1)/2; the left-biased face value is
//     sum_j c(j) a[i + j - B] for j = 0 .. K-1 (offsets -B .. B-2); the
//     right-biased one mirrors it about the face, offset n -> -1-n:
//     sum_j c(j) a[i + B - 1 - j].
// The Python package's ops/reconstruction_coefficients.
// face_reconstruction_coefficients(K, "centered" / "left") is the
// reference: tests/test_torch_schemes.py reads this file and holds every
// literal to the JAX package's tables.

#pragma once

namespace ot_linear {

template <int K>
struct CenteredTable;

template <int K>
struct UpwindTable;

template <>
struct CenteredTable<2> {
  static constexpr int B = 1;
  static constexpr int taps = 2;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[2] = {0.5, 0.5};
    return c[j];
  }
};

template <>
struct CenteredTable<4> {
  static constexpr int B = 2;
  static constexpr int taps = 4;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[4] = {-0.08333333333333333, 0.5833333333333334,
                             0.5833333333333334, -0.08333333333333333};
    return c[j];
  }
};

template <>
struct CenteredTable<6> {
  static constexpr int B = 3;
  static constexpr int taps = 6;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[6] = {0.016666666666666666, -0.13333333333333333,
                             0.6166666666666667, 0.6166666666666667,
                             -0.13333333333333333, 0.016666666666666666};
    return c[j];
  }
};

template <>
struct CenteredTable<8> {
  static constexpr int B = 4;
  static constexpr int taps = 8;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[8] = {-0.0035714285714285713, 0.034523809523809526,
                             -0.16547619047619047, 0.6345238095238095,
                             0.6345238095238095, -0.16547619047619047,
                             0.034523809523809526, -0.0035714285714285713};
    return c[j];
  }
};

template <>
struct CenteredTable<10> {
  static constexpr int B = 5;
  static constexpr int taps = 10;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[10] = {0.0007936507936507937, -0.009126984126984128,
                              0.0503968253968254, -0.1876984126984127,
                              0.6456349206349207, 0.6456349206349207,
                              -0.1876984126984127, 0.0503968253968254,
                              -0.009126984126984128, 0.0007936507936507937};
    return c[j];
  }
};

template <>
struct CenteredTable<12> {
  static constexpr int B = 6;
  static constexpr int taps = 12;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[12] = {-0.00018037518037518038, 0.002417027417027417,
                              -0.01544011544011544, 0.06392496392496393,
                              -0.20393217893217894, 0.6532106782106782,
                              0.6532106782106782, -0.20393217893217894,
                              0.06392496392496393, -0.01544011544011544,
                              0.002417027417027417, -0.00018037518037518038};
    return c[j];
  }
};

template <>
struct UpwindTable<1> {
  static constexpr int B = 1;
  static constexpr int taps = 1;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[1] = {1.0};
    return c[j];
  }
};

template <>
struct UpwindTable<3> {
  static constexpr int B = 2;
  static constexpr int taps = 3;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[3] = {-0.16666666666666666, 0.8333333333333334,
                             0.3333333333333333};
    return c[j];
  }
};

template <>
struct UpwindTable<5> {
  static constexpr int B = 3;
  static constexpr int taps = 5;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[5] = {0.03333333333333333, -0.21666666666666667,
                             0.7833333333333333, 0.45,
                             -0.05};
    return c[j];
  }
};

template <>
struct UpwindTable<7> {
  static constexpr int B = 4;
  static constexpr int taps = 7;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[7] = {-0.007142857142857143, 0.05952380952380952,
                             -0.24047619047619048, 0.7595238095238095,
                             0.5095238095238095, -0.09047619047619047,
                             0.009523809523809525};
    return c[j];
  }
};

template <>
struct UpwindTable<9> {
  static constexpr int B = 5;
  static constexpr int taps = 9;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[9] = {0.0015873015873015873, -0.01626984126984127,
                             0.07896825396825397, -0.25436507936507935,
                             0.7456349206349207, 0.5456349206349206,
                             -0.12103174603174603, 0.021825396825396824,
                             -0.001984126984126984};
    return c[j];
  }
};

template <>
struct UpwindTable<11> {
  static constexpr int B = 6;
  static constexpr int taps = 11;
  __host__ __device__ static constexpr double c(int j) {
    constexpr double c[11] = {-0.00036075036075036075, 0.004401154401154401,
                              -0.02536075036075036, 0.0936868686868687,
                              -0.26345598845598844, 0.7365440115440115,
                              0.5698773448773449, -0.1444083694083694,
                              0.034163059163059166, -0.00551948051948052,
                              0.0004329004329004329};
    return c[j];
  }
};

}  // namespace ot_linear
