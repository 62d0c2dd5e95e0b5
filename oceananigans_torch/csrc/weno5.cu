// WENO-5 momentum advection fused with the quasi-AB2 update.
//
// Replaces the TPU kernel of oceananigans_tpu/ops/pallas_weno.py:
//   weno5_ab2_update (_weno_ab2_pipelined_kernel) -> weno5_step
// This is the port's first design, kept until its own redesign: the
// momentum tendency alone is the x-marching tile of weno5_tile.cu, the
// science step and the tracer tendencies those of weno5_science_tile.cu,
// and the tile of weno5_tile.h is the pattern for this kernel too.
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// Output x-rows are [3, nx-3), as on the TPU. y and z neighbours at offsets
// -3..+3 wrap modulo the full extent: on a halo-free periodic axis the wrap
// is the periodic boundary itself, on an axis with a halo of 3 or more it
// lands only in halo rows that the caller's next fill overwrites.
//
// Numerics: the WENO-Z weights use exact IEEE division (the TPU kernel's
// approximate reciprocal plus a Newton step is a device of its vector unit
// and is not carried over), with the ratio tau/(beta+eps) capped at 1e12 in
// float32 and 1e60 in float64 as the XLA path caps it. The face value is
// left-biased where the advecting velocity U > 0 and right-biased
// otherwise; the XLA path averages the two where U == 0, and both give a
// zero flux there because the face value is multiplied by U. The plain
// PyTorch version (ops/cuda_weno.py) multiplies by face areas and divides
// by volumes where this kernel multiplies by 1/spacing, and rounds in
// another order, so the two agree to rounding, not bit for bit.
//
// What bounds it on the H100: arithmetic more than memory. One face value
// costs ~135 operations for both sides (one side ~86); a momentum point
// needs 9 face fluxes. At 256^3 in float32 that is 14 GFLOP of one-sided
// faces, 0.21 ms at the 67 TFLOP/s FFMA peak, against 0.25 ms for the 12
// fields the kernel moves. Design: one thread per output point with z on
// the fastest thread index, so every load and store of a warp is one
// contiguous run; neighbour reads go through the read-only cache, and
// each face flux is computed twice, once for each cell it bounds, with
// both WENO sides.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T> struct RatioCap;
template <> struct RatioCap<float> { static constexpr float value = 1e12f; };
template <> struct RatioCap<double> { static constexpr double value = 1e60; };

struct Layout {
  int nx, ny, nz;
  int64_t sx;  // x stride = ny * nz
};

template <typename T>
struct Coefs {
  T idx, idy, idz, eps;
};

// WENO-Z combination of three sub-stencil values with their smoothness
// indicators; gammas (1, 6, 3)/10.
template <typename T>
__device__ __forceinline__ T weno_z(T b0, T b1, T b2, T q0, T q1, T q2,
                                    T eps) {
  const T cap = RatioCap<T>::value;
  const T tau = fabs(b0 - b2);
  const T r0 = fmin(tau / (b0 + eps), cap);
  const T r1 = fmin(tau / (b1 + eps), cap);
  const T r2 = fmin(tau / (b2 + eps), cap);
  const T a0 = T(0.1) * (T(1) + r0 * r0);
  const T a1 = T(0.6) * (T(1) + r1 * r1);
  const T a2 = T(0.3) * (T(1) + r2 * r2);
  return (a0 * q0 + a1 * q1 + a2 * q2) / (a0 + a1 + a2);
}

// Upwind-selected WENO-5 face value from the six taps s[0..5] at offsets
// -3..2 from the target face; the counterpart of _weno_face. Under the
// reflection n -> -1-n the right-biased sub-stencils reuse two of the
// left-biased polynomials and the curvature terms pair up across sides.
template <typename T>
__device__ __forceinline__ T weno5_face(const T* s, T U, T eps) {
  const T sm3 = s[0], sm2 = s[1], sm1 = s[2], s0 = s[3], s1 = s[4],
          s2 = s[5];
  const T c1 = T(13.0 / 12.0), c2 = T(0.25);
  const T q0L = T(2.0 / 6) * sm3 + T(-7.0 / 6) * sm2 + T(11.0 / 6) * sm1;
  const T q1L = T(-1.0 / 6) * sm2 + T(5.0 / 6) * sm1 + T(2.0 / 6) * s0;
  const T q2L = T(2.0 / 6) * sm1 + T(5.0 / 6) * s0 + T(-1.0 / 6) * s1;
  const T q0R = T(11.0 / 6) * s0 + T(-7.0 / 6) * s1 + T(2.0 / 6) * s2;
  T t;
  t = sm3 - T(2) * sm2 + sm1; const T d3 = t * t;
  t = sm2 - T(2) * sm1 + s0;  const T d2 = t * t;
  t = sm1 - T(2) * s0 + s1;   const T d1 = t * t;
  t = s0 - T(2) * s1 + s2;    const T d0 = t * t;
  t = sm3 - T(4) * sm2 + T(3) * sm1; const T b0L = c1 * d3 + c2 * (t * t);
  t = sm2 - s0;                      const T b1L = c1 * d2 + c2 * (t * t);
  t = T(3) * sm1 - T(4) * s0 + s1;   const T b2L = c1 * d1 + c2 * (t * t);
  t = s2 - T(4) * s1 + T(3) * s0;    const T b0R = c1 * d0 + c2 * (t * t);
  t = s1 - sm1;                      const T b1R = c1 * d1 + c2 * (t * t);
  t = T(3) * s0 - T(4) * sm1 + sm2;  const T b2R = c1 * d2 + c2 * (t * t);
  const T left = weno_z(b0L, b1L, b2L, q0L, q1L, q2L, eps);
  const T right = weno_z(b0R, b1R, b2R, q0R, q2L, q1L, eps);
  return U > T(0) ? left : right;
}

// F(+1/2) - F(-1/2) along one axis through a point: q[0..6] are the
// advected field at offsets -3..3 along the axis, U0 and U1 the advecting
// velocities at the lower and upper flux points. The lower flux point's
// taps are q[0..5], the upper one's q[1..6].
template <typename T>
__device__ __forceinline__ T flux_difference(const T* q, T U0, T U1, T eps) {
  const T f0 = U0 * weno5_face(q, U0, eps);
  const T f1 = U1 * weno5_face(q + 1, U1, eps);
  return f1 - f0;
}

// Neighbour offsets of one point: x-row offsets (always in range on output
// rows), wrapped y-row and z offsets for -3..3.
struct Stencil {
  int64_t X[7];
  int64_t Y[7];
  int Z[7];
  __device__ __forceinline__ int64_t at(int a, int b, int c) const {
    return X[a + 3] + Y[b + 3] + Z[c + 3];
  }
};

__device__ __forceinline__ int wrap(int j, int n) {
  j %= n;
  return j < 0 ? j + n : j;
}

__device__ __forceinline__ Stencil stencil_of(const Layout& L, int64_t i,
                                              int j, int k) {
  Stencil s;
#pragma unroll
  for (int d = -3; d <= 3; ++d) {
    s.X[d + 3] = (i + d) * L.sx;
    s.Y[d + 3] = (int64_t)wrap(j + d, L.ny) * L.nz;
    s.Z[d + 3] = wrap(k + d, L.nz);
  }
  return s;
}

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ p, int64_t off) {
  return __ldg(p + off);
}

// The seven values of p along `axis` through the point (offsets -3..3).
template <typename T>
__device__ __forceinline__ void line(const T* __restrict__ p,
                                     const Stencil& S, int axis, T* q) {
#pragma unroll
  for (int d = -3; d <= 3; ++d) {
    const int64_t off = axis == 0 ? S.at(d, 0, 0)
                        : axis == 1 ? S.at(0, d, 0) : S.at(0, 0, d);
    q[d + 3] = ld(p, off);
  }
}

// -(δx F / Δx + δy F / Δy + δz F / Δz) for the advected field p with the
// given advecting velocities at the six flux points (lower, upper per axis).
template <typename T>
__device__ __forceinline__ T advect(const T* __restrict__ p, const Stencil& S,
                                    const T (&U)[6], const Coefs<T>& c) {
  T q[7];
  line(p, S, 0, q);
  T g = -flux_difference(q, U[0], U[1], c.eps) * c.idx;
  line(p, S, 1, q);
  g = g - flux_difference(q, U[2], U[3], c.eps) * c.idy;
  line(p, S, 2, q);
  return g - flux_difference(q, U[4], U[5], c.eps) * c.idz;
}

// WENO-5 momentum tendency -∇·(𝐯 ⊗ 𝐯) at one point; the counterpart of
// _weno5_body. Each advecting velocity is the average of the two values
// that straddle the flux point.
template <typename T>
__device__ __forceinline__ void weno5_momentum(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const Stencil& S, const Coefs<T>& c, T& gu, T& gv, T& gw) {
  const T h = T(0.5);
  {  // Gu at (f,c,c): x-flux at centers i-1, i; y-, z-flux at faces
    const T U[6] = {
        h * (ld(u, S.at(-1, 0, 0)) + ld(u, S.at(0, 0, 0))),
        h * (ld(u, S.at(0, 0, 0)) + ld(u, S.at(1, 0, 0))),
        h * (ld(v, S.at(-1, 0, 0)) + ld(v, S.at(0, 0, 0))),
        h * (ld(v, S.at(-1, 1, 0)) + ld(v, S.at(0, 1, 0))),
        h * (ld(w, S.at(-1, 0, 0)) + ld(w, S.at(0, 0, 0))),
        h * (ld(w, S.at(-1, 0, 1)) + ld(w, S.at(0, 0, 1)))};
    gu = advect(u, S, U, c);
  }
  {  // Gv at (c,f,c): y-flux at centers j-1, j
    const T U[6] = {
        h * (ld(u, S.at(0, -1, 0)) + ld(u, S.at(0, 0, 0))),
        h * (ld(u, S.at(1, -1, 0)) + ld(u, S.at(1, 0, 0))),
        h * (ld(v, S.at(0, -1, 0)) + ld(v, S.at(0, 0, 0))),
        h * (ld(v, S.at(0, 0, 0)) + ld(v, S.at(0, 1, 0))),
        h * (ld(w, S.at(0, -1, 0)) + ld(w, S.at(0, 0, 0))),
        h * (ld(w, S.at(0, -1, 1)) + ld(w, S.at(0, 0, 1)))};
    gv = advect(v, S, U, c);
  }
  {  // Gw at (c,c,f): z-flux at centers k-1, k
    const T U[6] = {
        h * (ld(u, S.at(0, 0, -1)) + ld(u, S.at(0, 0, 0))),
        h * (ld(u, S.at(1, 0, -1)) + ld(u, S.at(1, 0, 0))),
        h * (ld(v, S.at(0, 0, -1)) + ld(v, S.at(0, 0, 0))),
        h * (ld(v, S.at(0, 1, -1)) + ld(v, S.at(0, 1, 0))),
        h * (ld(w, S.at(0, 0, -1)) + ld(w, S.at(0, 0, 0))),
        h * (ld(w, S.at(0, 0, 0)) + ld(w, S.at(0, 0, 1)))};
    gw = advect(w, S, U, c);
  }
}

__device__ __forceinline__ void decompose(int64_t p, const Layout& L,
                                          int64_t& i, int& j, int& k) {
  k = (int)(p % L.nz);
  const int64_t t = p / L.nz;
  j = (int)(t % L.ny);
  i = t / L.ny;
}

// Kernel 6: the tendencies and q' = q + ca*G + cb*G_prev for u, v, w on
// rows [3, nx-3). Each G is written over G_prev in place (a thread reads
// G_prev only at its own point); q' goes to a new buffer because
// neighbouring threads read q. The x-halo rows of q' are copies of q's, and
// G's keep G_prev's values.
template <typename T>
__global__ void __launch_bounds__(kThreads) weno5_step(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw,
    T* __restrict__ un, T* __restrict__ vn, T* __restrict__ wn, Layout L,
    Coefs<T> c, T ca, T cb) {
  const int64_t total = (int64_t)L.nx * L.sx;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    int64_t i;
    int j, k;
    decompose(p, L, i, j, k);
    if (i < 3 || i >= L.nx - 3) {
      un[p] = u[p];
      vn[p] = v[p];
      wn[p] = w[p];
      continue;
    }
    const Stencil S = stencil_of(L, i, j, k);
    T a, b, d;
    weno5_momentum(u, v, w, S, c, a, b, d);
    un[p] = u[p] + ca * a + cb * gu[p];
    vn[p] = v[p] + ca * b + cb * gv[p];
    wn[p] = w[p] + ca * d + cb * gw[p];
    gu[p] = a;
    gv[p] = b;
    gw[p] = d;
  }
}

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return (int)(b < 2147483647 ? b : 2147483647);
}

template <typename T>
int launch_step(const void* u, const void* v, const void* w, void* gu,
                void* gv, void* gw, void* un, void* vn, void* wn, int nx,
                int ny, int nz, double idx, double idy, double idz,
                double eps, double ca, double cb, void* stream) {
  const int64_t total = (int64_t)nx * ny * nz;
  if (total == 0) return 0;
  weno5_step<T><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw,
      (T*)un, (T*)vn, (T*)wn, Layout{nx, ny, nz, (int64_t)ny * nz},
      Coefs<T>{(T)idx, (T)idy, (T)idz, (T)eps}, (T)ca, (T)cb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ot_weno5_ab2_f32(const void* u, const void* v, const void* w, void* gu,
                     void* gv, void* gw, void* un, void* vn, void* wn, int nx,
                     int ny, int nz, double idx, double idy, double idz,
                     double eps, double ca, double cb, void* stream) {
  return launch_step<float>(u, v, w, gu, gv, gw, un, vn, wn, nx, ny, nz, idx,
                            idy, idz, eps, ca, cb, stream);
}

int ot_weno5_ab2_f64(const void* u, const void* v, const void* w, void* gu,
                     void* gv, void* gw, void* un, void* vn, void* wn, int nx,
                     int ny, int nz, double idx, double idy, double idz,
                     double eps, double ca, double cb, void* stream) {
  return launch_step<double>(u, v, w, gu, gv, gw, un, vn, wn, nx, ny, nz,
                             idx, idy, idz, eps, ca, cb, stream);
}

}  // extern "C"
