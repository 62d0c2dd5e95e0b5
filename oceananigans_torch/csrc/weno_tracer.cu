// WENO tracer advection of any odd order from 3 to 11: -div(u c) of up to
// kMaxTracers tracers in one pass.
//
// Replaces the TPU kernel of oceananigans_tpu/ops/pallas_tracer.py:
//   weno_tracer_tendencies (_tracer_core, _kernel; the (x, y, z) and the
//   transposed (z, y, x) layouts) -> weno_tracers<T, K>
// The TPU's two layouts exist for its 128 lanes; here one kernel works on
// the (x, y, z) arrays with z contiguous.
//
// Fields are halo-extended (nx, ny, nz) arrays. Every point is computed,
// with neighbours wrapped modulo the full extent on every axis, as the plain
// version's whole-array operators (torch.roll) do: on a halo-free periodic
// axis the wrap is the periodic boundary itself, on an axis with a halo of B
// or more the interior reads only filled rows. The face areas Ax, Ay, Az and
// the volume V are y-profiles m[4][ny] (regular rectilinear grids: constant;
// the lat-lon grid's metrics vary in y only).
//
// Numerics: the flux through a face is (A U) times the upwind WENO-Z value
// (left-biased for U > 0, right-biased otherwise; where U == 0 the plain
// version averages the two, and U times either is zero), and
// -((Fx1 - Fx0) + (Fy1 - Fy0) + (Fz1 - Fz0)) / V, in the plain version's
// order. Rounding differs by FMA contraction only.
//
// What bounds it on the H100: operations. A WENO-7 face value (one side)
// costs ~160 operations; a point does six faces per tracer, 2 tracers at
// hydro_vi's 372 x 172 x 68 in float32 are ~0.1 ms at the 67 TFLOP/s peak
// against ~0.04 ms for the 7 fields it moves. Design: one thread per point,
// z on the fastest thread index so a warp's loads are contiguous runs;
// neighbours through L1; each face value computed for the one side the
// velocity's sign selects; each face computed twice, once for each cell it
// bounds. Shared-memory tiles and flux reuse are later work.

#include <cuda_runtime.h>

#include "weno.h"

namespace {

using ot_weno::upwind;
using ot_weno::wrap;

constexpr int kThreads = 256;
// must equal MAX_TRACERS in ops/cuda_kernels.py
constexpr int kMaxTracers = 8;

struct Layout {
  int nx, ny, nz, sx;  // sx = ny * nz; nx * sx < 2^31
};

template <typename T>
struct Tracers {
  const T* c[kMaxTracers];
  T* g[kMaxTracers];
  int n;
};

// The face value at the lower face of a 2B+1 line (taps line[0..2B-1]) and
// at the upper face (taps line[1..2B]), each times its transport A U.
template <int K, typename T>
__device__ __forceinline__ T flux_difference(const T* line, T U0, T U1, T A0,
                                             T A1, T eps) {
  const T f0 = (A0 * U0) * upwind<K, 0>(line, line, line, U0, eps);
  const T f1 = (A1 * U1) * upwind<K, 0>(line + 1, line, line, U1, eps);
  return f1 - f0;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    weno_tracers(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ w, Tracers<T> tr, Layout L,
                 const T* __restrict__ m, T eps) {
  constexpr int B = (K + 1) / 2;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < L.nx * L.sx) {
    const int k = p % L.nz;
    const int t = p / L.nz;
    const int j = t % L.ny;
    const int i = t / L.ny;
    const int col = p - k;  // (i, j, 0)
    const int jrow = j * L.nz;
    const int jp = wrap(j + 1, L.ny);
    // advecting velocities at the lower and upper faces of each axis
    const T U0 = __ldg(u + p);
    const T U1 = __ldg(u + wrap(i + 1, L.nx) * L.sx + jrow + k);
    const T V0 = __ldg(v + p);
    const T V1 = __ldg(v + i * L.sx + jp * L.nz + k);
    const T W0 = __ldg(w + p);
    const T W1 = __ldg(w + col + wrap(k + 1, L.nz));
    const T ax = __ldg(m + j);
    const T ay0 = __ldg(m + L.ny + j);
    const T ay1 = __ldg(m + L.ny + jp);
    const T az = __ldg(m + 2 * L.ny + j);
    const T vol = __ldg(m + 3 * L.ny + j);
#pragma unroll 1
    for (int q = 0; q < tr.n; ++q) {
      const T* __restrict__ c = tr.c[q];
      T line[2 * B + 1];
#pragma unroll
      for (int d = -B; d <= B; ++d) {
        line[d + B] = __ldg(c + wrap(i + d, L.nx) * L.sx + jrow + k);
      }
      const T dx = flux_difference<K>(line, U0, U1, ax, ax, eps);
#pragma unroll
      for (int d = -B; d <= B; ++d) {
        line[d + B] = __ldg(c + i * L.sx + wrap(j + d, L.ny) * L.nz + k);
      }
      const T dy = flux_difference<K>(line, V0, V1, ay0, ay1, eps);
#pragma unroll
      for (int d = -B; d <= B; ++d) {
        line[d + B] = __ldg(c + col + wrap(k + d, L.nz));
      }
      const T dz = flux_difference<K>(line, W0, W1, az, az, eps);
      tr.g[q][p] = -(((dx + dy) + dz) / vol);
    }
  }
}

int blocks_for(int total) { return (total + kThreads - 1) / kThreads; }

template <typename T, int K>
int launch_order(const void* u, const void* v, const void* w,
                 const Tracers<T>& tr, const Layout& L, const void* m,
                 double eps, void* stream) {
  const int total = L.nx * L.sx;
  weno_tracers<T, K><<<blocks_for(total), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, tr, L, (const T*)m, (T)eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* const* c,
           void* const* g, int n, int nx, int ny, int nz, const void* m,
           int order, double eps, void* stream) {
  if (n < 1 || n > kMaxTracers) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nx * ny * nz;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  Tracers<T> tr{};
  tr.n = n;
  for (int q = 0; q < n; ++q) {
    tr.c[q] = (const T*)c[q];
    tr.g[q] = (T*)g[q];
  }
  const Layout L{nx, ny, nz, ny * nz};
  switch (order) {
    case 3: return launch_order<T, 3>(u, v, w, tr, L, m, eps, stream);
    case 5: return launch_order<T, 5>(u, v, w, tr, L, m, eps, stream);
    case 7: return launch_order<T, 7>(u, v, w, tr, L, m, eps, stream);
    case 9: return launch_order<T, 9>(u, v, w, tr, L, m, eps, stream);
    case 11: return launch_order<T, 11>(u, v, w, tr, L, m, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ot_weno_tracers_f32(const void* u, const void* v, const void* w,
                        const void* const* c, void* const* g, int n, int nx,
                        int ny, int nz, const void* m, int order, double eps,
                        void* stream) {
  return launch<float>(u, v, w, c, g, n, nx, ny, nz, m, order, eps, stream);
}

int ot_weno_tracers_f64(const void* u, const void* v, const void* w,
                        const void* const* c, void* const* g, int n, int nx,
                        int ny, int nz, const void* m, int order, double eps,
                        void* stream) {
  return launch<double>(u, v, w, c, g, n, nx, ny, nz, m, order, eps, stream);
}

}  // extern "C"
