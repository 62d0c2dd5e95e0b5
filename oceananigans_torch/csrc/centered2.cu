// Centered-2 momentum tendency, alone, fused with the quasi-AB2 update, and
// fused with the physics and tracers of the science step.
//
// Replaces the TPU kernels oceananigans_tpu/ops/pallas_kernels.py:
//   centered2_momentum_tendency (_kernel, body _centered2_body)  -> c2_tendency
//   centered2_ab2_update        (_ab2_kernel, same body)          -> c2_ab2
//   centered2_science_ab2_update (_science_kernel)                -> c2_science
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// Output x-rows are [1, nx-1), as on the TPU. y and z neighbours wrap
// modulo the full extent: on a halo-free periodic axis the wrap is the
// periodic boundary itself, on a haloed axis it lands only in halo rows
// that the caller's next fill overwrites.
//
// What bounds it on the H100: memory. Per point the tendency does ~100
// flops on 3 loaded values and 3 stored ones (c2_tendency), or 6 loaded
// and 6 stored (c2_ab2): at 256^3 in float32 c2_ab2 moves 12 fields x
// 67.6 MB = 0.81 GB, a floor of ~0.24 ms at 3.35 TB/s.
// c2_science adds f-plane Coriolis, the buoyancy of a BuoyancyTracer and
// the Centered-2 advection of T tracers, and updates all 3 + T fields: at
// 256^3 with T = 2 it moves 4 (3 + T) = 20 fields, 1.35 GB, a floor of
// ~0.40 ms; its ~140 flops per point stay far under the float32 peak.
// Design: one thread per output point with z on the fastest thread index,
// so every load and store of a warp is one contiguous run. The 18
// neighbour reads per point come back through L1/L2, which hold the few
// x-planes a block touches; nothing is staged in shared memory yet
// (tiling is later work).
//
// The plain PyTorch version (ops/cuda_kernels.py) evaluates the same
// fluxes with the whole-array operators of advection.py, in another order
// and without FMA contraction, so the two agree to a few ulps of the
// largest tendency, not bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// must equal MAX_TRACERS in ops/cuda_kernels.py
constexpr int kMaxTracers = 8;

struct Idx {
  int64_t sx;  // x stride = ny * nz
  int nz;
  __device__ __forceinline__ int64_t operator()(int64_t i, int j, int k) const {
    return i * sx + (int64_t)j * nz + k;
  }
};

__device__ __forceinline__ int wrap_m(int j, int n) { return j == 0 ? n - 1 : j - 1; }
__device__ __forceinline__ int wrap_p(int j, int n) { return j == n - 1 ? 0 : j + 1; }

// Centered-2 -div(u (x) u) for Gu, Gv, Gw at interior x-row i (1 <= i <= nx-2);
// the counterpart of _centered2_body.
template <typename T>
__device__ __forceinline__ void centered2_point(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    int64_t i, int j, int k, int ny, int nz, const Idx& at,
    T inv_dx, T inv_dy, T inv_dz, T& gu, T& gv, T& gw) {
  const T h = T(0.5), q = T(0.25);
  const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
  const int km = wrap_m(k, nz), kp = wrap_p(k, nz);

  // ---- Gu at (f, c, c)
  {
    T s = u[at(i, j, k)] + u[at(i + 1, j, k)];
    const T fxx_r = q * (s * s);
    s = u[at(i - 1, j, k)] + u[at(i, j, k)];
    const T fxx_l = q * (s * s);
    T g = (-(fxx_r - fxx_l)) * inv_dx;
    // Fxy at (f, f, c) on y-faces j and j+1
    const T fxy_j = (h * (v[at(i - 1, j, k)] + v[at(i, j, k)])) * h
                    * (u[at(i, jm, k)] + u[at(i, j, k)]);
    const T fxy_p = (h * (v[at(i - 1, jp, k)] + v[at(i, jp, k)])) * h
                    * (u[at(i, j, k)] + u[at(i, jp, k)]);
    g = g - (fxy_p - fxy_j) * inv_dy;
    // Fxz at (f, c, f) on z-faces k and k+1
    const T fxz_k = (h * (w[at(i - 1, j, k)] + w[at(i, j, k)])) * h
                    * (u[at(i, j, km)] + u[at(i, j, k)]);
    const T fxz_p = (h * (w[at(i - 1, j, kp)] + w[at(i, j, kp)])) * h
                    * (u[at(i, j, k)] + u[at(i, j, kp)]);
    gu = g - (fxz_p - fxz_k) * inv_dz;
  }
  // ---- Gv at (c, f, c)
  {
    T s = v[at(i, j, k)] + v[at(i, jp, k)];
    const T fyy_r = q * (s * s);
    s = v[at(i, jm, k)] + v[at(i, j, k)];
    const T fyy_l = q * (s * s);
    T g = (-(fyy_r - fyy_l)) * inv_dy;
    // Fyx at (f, f, c) on x-faces i and i+1
    const T fyx_i = (h * (u[at(i, jm, k)] + u[at(i, j, k)]))
                    * (h * (v[at(i - 1, j, k)] + v[at(i, j, k)]));
    const T fyx_p = (h * (u[at(i + 1, jm, k)] + u[at(i + 1, j, k)]))
                    * (h * (v[at(i, j, k)] + v[at(i + 1, j, k)]));
    g = g - (fyx_p - fyx_i) * inv_dx;
    // Fyz at (c, f, f) on z-faces k and k+1
    const T fyz_k = (h * (w[at(i, jm, k)] + w[at(i, j, k)])) * h
                    * (v[at(i, j, km)] + v[at(i, j, k)]);
    const T fyz_p = (h * (w[at(i, jm, kp)] + w[at(i, j, kp)])) * h
                    * (v[at(i, j, k)] + v[at(i, j, kp)]);
    gv = g - (fyz_p - fyz_k) * inv_dz;
  }
  // ---- Gw at (c, c, f)
  {
    T s = w[at(i, j, k)] + w[at(i, j, kp)];
    const T fzz_r = q * (s * s);
    s = w[at(i, j, km)] + w[at(i, j, k)];
    const T fzz_l = q * (s * s);
    T g = (-(fzz_r - fzz_l)) * inv_dz;
    // Fzx at (f, c, f) on x-faces i and i+1
    const T fzx_i = (h * (u[at(i, j, km)] + u[at(i, j, k)]))
                    * (h * (w[at(i - 1, j, k)] + w[at(i, j, k)]));
    const T fzx_p = (h * (u[at(i + 1, j, km)] + u[at(i + 1, j, k)]))
                    * (h * (w[at(i, j, k)] + w[at(i + 1, j, k)]));
    g = g - (fzx_p - fzx_i) * inv_dx;
    // Fzy at (c, f, f) on y-faces j and j+1
    const T fzy_j = (h * (v[at(i, j, km)] + v[at(i, j, k)]))
                    * (h * (w[at(i, jm, k)] + w[at(i, j, k)]));
    const T fzy_p = (h * (v[at(i, jp, km)] + v[at(i, jp, k)]))
                    * (h * (w[at(i, j, k)] + w[at(i, jp, k)]));
    gw = g - (fzy_p - fzy_j) * inv_dy;
  }
}

// Kernel 2: G = tendency on rows [1, nx-1); G's x-halo rows are zeroed, as
// the JAX wrapper embeds its result in zeros.
template <typename T>
__global__ void c2_tendency_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw,
    int nx, int ny, int nz, T inv_dx, T inv_dy, T inv_dz) {
  const Idx at{(int64_t)ny * nz, nz};
  const int64_t total = (int64_t)nx * ny * nz;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(p % nz);
    const int64_t t = p / nz;
    const int j = (int)(t % ny);
    const int64_t i = t / ny;
    if (i == 0 || i == nx - 1) {
      gu[p] = T(0);
      gv[p] = T(0);
      gw[p] = T(0);
      continue;
    }
    T a, b, c;
    centered2_point(u, v, w, i, j, k, ny, nz, at, inv_dx, inv_dy, inv_dz,
                    a, b, c);
    gu[p] = a;
    gv[p] = b;
    gw[p] = c;
  }
}

// Kernel 1: G = tendency and u' = u + a*G + b*G_prev on rows [1, nx-1).
// G is written over G_prev in place (each thread reads G_prev at its own
// point only, then overwrites it); u' goes to a new buffer because
// neighbouring threads read u. The x-halo rows of u' are copies of u's, and
// G's x-halo rows keep G_prev's values.
template <typename T>
__global__ void c2_ab2_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw,
    T* __restrict__ un, T* __restrict__ vn, T* __restrict__ wn,
    int nx, int ny, int nz, T inv_dx, T inv_dy, T inv_dz, T ca, T cb) {
  const Idx at{(int64_t)ny * nz, nz};
  const int64_t total = (int64_t)nx * ny * nz;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(p % nz);
    const int64_t t = p / nz;
    const int j = (int)(t % ny);
    const int64_t i = t / ny;
    if (i == 0 || i == nx - 1) {
      un[p] = u[p];
      vn[p] = v[p];
      wn[p] = w[p];
      continue;
    }
    T a, b, c;
    centered2_point(u, v, w, i, j, k, ny, nz, at, inv_dx, inv_dy, inv_dz,
                    a, b, c);
    un[p] = u[p] + ca * a + cb * gu[p];
    vn[p] = v[p] + ca * b + cb * gv[p];
    wn[p] = w[p] + ca * c + cb * gw[p];
    gu[p] = a;
    gv[p] = b;
    gw[p] = c;
  }
}

// Tracer pointers, passed by value: the tracers, their previous
// tendencies (overwritten with the new ones) and the updated tracers.
template <typename T>
struct Tracers {
  const T* c[kMaxTracers];
  T* g[kMaxTracers];
  T* cn[kMaxTracers];
  int n;
};

// -div(u c) with Centered-2 face values at (i, j, k), advected by the
// face velocities themselves (the counterpart of _science_kernel's tracer
// loop): x-faces i and i+1, y-faces j and j+1, z-faces k and k+1.
template <typename T>
__device__ __forceinline__ T centered2_tracer(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ c, int64_t i, int j, int k, int ny, int nz,
    const Idx& at, T inv_dx, T inv_dy, T inv_dz) {
  const T h = T(0.5);
  const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
  const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
  const T cc = c[at(i, j, k)];
  const T fx_i = u[at(i, j, k)] * (h * (c[at(i - 1, j, k)] + cc));
  const T fx_p = u[at(i + 1, j, k)] * (h * (cc + c[at(i + 1, j, k)]));
  T g = (-(fx_p - fx_i)) * inv_dx;
  const T fy_j = v[at(i, j, k)] * (h * (c[at(i, jm, k)] + cc));
  const T fy_p = v[at(i, jp, k)] * (h * (cc + c[at(i, jp, k)]));
  g = g - (fy_p - fy_j) * inv_dy;
  const T fz_k = w[at(i, j, k)] * (h * (c[at(i, j, km)] + cc));
  const T fz_p = w[at(i, j, kp)] * (h * (cc + c[at(i, j, kp)]));
  return g - (fz_p - fz_k) * inv_dz;
}

// Kernel 5: the science step on rows [1, nx-1). Gu, Gv, Gw get kernel 1's
// tendency plus f-plane Coriolis (f != 0: Gu += f ℑxᶠ(ℑyᶜ v),
// Gv -= f ℑyᶠ(ℑxᶜ u)) and, for b_idx >= 0, the buoyancy ℑzᶠ(b) of tracer
// b_idx in Gw; each tracer gets its advection; and every field is updated
// to q' = q + ca*G + cb*G_prev. Each G is written over G_prev in place (a
// thread reads G_prev only at its own point); q' goes to a new buffer
// because neighbouring threads read q. The x-halo rows of q' are copies of
// q's, and G's keep G_prev's values.
template <typename T>
__global__ void __launch_bounds__(kThreads) c2_science_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw,
    T* __restrict__ un, T* __restrict__ vn, T* __restrict__ wn,
    Tracers<T> tr, int nx, int ny, int nz, T inv_dx, T inv_dy, T inv_dz,
    T ca, T cb, T f, int b_idx) {
  const Idx at{(int64_t)ny * nz, nz};
  const int64_t total = (int64_t)nx * ny * nz;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(p % nz);
    const int64_t t = p / nz;
    const int j = (int)(t % ny);
    const int64_t i = t / ny;
    if (i == 0 || i == nx - 1) {
      un[p] = u[p];
      vn[p] = v[p];
      wn[p] = w[p];
      for (int s = 0; s < tr.n; ++s) tr.cn[s][p] = tr.c[s][p];
      continue;
    }
    T a, b, d;
    centered2_point(u, v, w, i, j, k, ny, nz, at, inv_dx, inv_dy, inv_dz,
                    a, b, d);
    const T h = T(0.5);
    if (f != T(0)) {
      const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
      const T vv0 = h * (v[at(i - 1, j, k)] + v[at(i - 1, jp, k)]);
      const T vv1 = h * (v[at(i, j, k)] + v[at(i, jp, k)]);
      a = a + f * h * (vv0 + vv1);
      const T uu0 = h * (u[at(i, jm, k)] + u[at(i + 1, jm, k)]);
      const T uu1 = h * (u[at(i, j, k)] + u[at(i + 1, j, k)]);
      b = b - f * h * (uu0 + uu1);
    }
    if (b_idx >= 0) {
      const T* bf = tr.c[b_idx];
      d = d + h * (bf[at(i, j, wrap_m(k, nz))] + bf[p]);
    }
    un[p] = u[p] + ca * a + cb * gu[p];
    vn[p] = v[p] + ca * b + cb * gv[p];
    wn[p] = w[p] + ca * d + cb * gw[p];
    gu[p] = a;
    gv[p] = b;
    gw[p] = d;
#pragma unroll 1
    for (int s = 0; s < tr.n; ++s) {
      const T g = centered2_tracer(u, v, w, tr.c[s], i, j, k, ny, nz, at,
                                   inv_dx, inv_dy, inv_dz);
      tr.cn[s][p] = tr.c[s][p] + ca * g + cb * tr.g[s][p];
      tr.g[s][p] = g;
    }
  }
}

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return (int)(b < 2147483647 ? b : 2147483647);
}

template <typename T>
int launch_tendency(const void* u, const void* v, const void* w, void* gu,
                    void* gv, void* gw, int nx, int ny, int nz, double idx,
                    double idy, double idz, void* stream) {
  const int64_t total = (int64_t)nx * ny * nz;
  if (total == 0) return 0;
  c2_tendency_kernel<T><<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, nx, ny,
      nz, (T)idx, (T)idy, (T)idz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ab2(const void* u, const void* v, const void* w, void* gu,
               void* gv, void* gw, void* un, void* vn, void* wn, int nx,
               int ny, int nz, double idx, double idy, double idz, double ca,
               double cb, void* stream) {
  const int64_t total = (int64_t)nx * ny * nz;
  if (total == 0) return 0;
  c2_ab2_kernel<T><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, (T*)un,
      (T*)vn, (T*)wn, nx, ny, nz, (T)idx, (T)idy, (T)idz, (T)ca, (T)cb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_science(const void* u, const void* v, const void* w, void* gu,
                   void* gv, void* gw, void* un, void* vn, void* wn,
                   const void* const* c, void* const* g, void* const* cn,
                   int n, int nx, int ny, int nz, double idx, double idy,
                   double idz, double ca, double cb, double f, int b_idx,
                   void* stream) {
  const int64_t total = (int64_t)nx * ny * nz;
  if (n < 0 || n > kMaxTracers || b_idx >= n) {
    return (int)cudaErrorInvalidValue;
  }
  if (total == 0) return 0;
  Tracers<T> tr{};
  tr.n = n;
  for (int s = 0; s < n; ++s) {
    tr.c[s] = (const T*)c[s];
    tr.g[s] = (T*)g[s];
    tr.cn[s] = (T*)cn[s];
  }
  c2_science_kernel<T><<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, (T*)un,
      (T*)vn, (T*)wn, tr, nx, ny, nz, (T)idx, (T)idy, (T)idz, (T)ca, (T)cb,
      (T)f, b_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define OT_C2_SCIENCE_ENTRY(SUFFIX, T)                                       \
  int ot_c2_science_ab2_##SUFFIX(                                            \
      const void* u, const void* v, const void* w, void* gu, void* gv,       \
      void* gw, void* un, void* vn, void* wn, const void* const* c,          \
      void* const* g, void* const* cn, int n, int nx, int ny, int nz,        \
      double idx, double idy, double idz, double ca, double cb, double f,    \
      int b_idx, void* stream) {                                             \
    return launch_science<T>(u, v, w, gu, gv, gw, un, vn, wn, c, g, cn, n,   \
                             nx, ny, nz, idx, idy, idz, ca, cb, f, b_idx,    \
                             stream);                                        \
  }

OT_C2_SCIENCE_ENTRY(f32, float)
OT_C2_SCIENCE_ENTRY(f64, double)

#undef OT_C2_SCIENCE_ENTRY

int ot_c2_tendency_f32(const void* u, const void* v, const void* w, void* gu,
                       void* gv, void* gw, int nx, int ny, int nz, double idx,
                       double idy, double idz, void* stream) {
  return launch_tendency<float>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy,
                                idz, stream);
}

int ot_c2_tendency_f64(const void* u, const void* v, const void* w, void* gu,
                       void* gv, void* gw, int nx, int ny, int nz, double idx,
                       double idy, double idz, void* stream) {
  return launch_tendency<double>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy,
                                 idz, stream);
}

int ot_c2_ab2_f32(const void* u, const void* v, const void* w, void* gu,
                  void* gv, void* gw, void* un, void* vn, void* wn, int nx,
                  int ny, int nz, double idx, double idy, double idz,
                  double ca, double cb, void* stream) {
  return launch_ab2<float>(u, v, w, gu, gv, gw, un, vn, wn, nx, ny, nz, idx,
                           idy, idz, ca, cb, stream);
}

int ot_c2_ab2_f64(const void* u, const void* v, const void* w, void* gu,
                  void* gv, void* gw, void* un, void* vn, void* wn, int nx,
                  int ny, int nz, double idx, double idy, double idz,
                  double ca, double cb, void* stream) {
  return launch_ab2<double>(u, v, w, gu, gv, gw, un, vn, wn, nx, ny, nz, idx,
                            idy, idz, ca, cb, stream);
}

const char* ot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
