// One stage of the conservative shallow-water RK3 step in one pass.
//
// Replaces the TPU kernel oceananigans_tpu/ops/pallas_sw.py:
//   sw_rk3_stage (_sw_kernel, body _sw_body) -> sw_stage
//
// Fields are the halo-extended (nx, ny) planes of (nx, ny, 1) arrays with a
// Flat z axis, C-contiguous, y fastest. Output x-rows are the interior
// [x0, nx - x0), with x0 the x halo (>= 2: the stencil reaches rows i-2 to
// i+1). y neighbours (offsets -2..+1) wrap modulo the full extent: on a
// halo-free periodic axis the wrap is the periodic boundary itself, on an
// axis with a halo of 2 or more it lands only in halo rows that the
// caller's next fill overwrites.
//
// Per point, with h_fc = (h + h[i-1])/2, h_cf = (h + h[j-1])/2 and the
// velocities u = U/h_fc, v = V/h_cf (U = uh, V = vh):
//   G_U = -(δx(ℑx u ℑx U)/Δx + δy(ℑx v ℑy U)/Δy) - g h_fc δx h/Δx
//   G_V = -(δx(ℑy u ℑx V)/Δx + δy(ℑy v ℑy V)/Δy) - g h_cf δy h/Δy
//   G_h = -(δx U/Δx + δy V/Δy)
// and q' = q + ca*G + cb*G_prev for q = U, V, h. The divisions are exact
// IEEE divisions (no fast math), as in the plain PyTorch version
// (ops/cuda_sw.py), which evaluates the same fluxes with the model's
// whole-array operators in another order; the two agree to rounding.
//
// What bounds it on the H100: memory. Per point it reads U, V, h and the
// three G_prev and writes three q' and three G, 12 values, for ~90 flops
// and 10 divisions: at 8192^2 in float32 that is 12 x 269 MB = 3.23 GB, a
// floor of ~0.96 ms per stage at 3.35 TB/s. Design: one thread per output
// point, a block on 256 consecutive y of one x-row, so every load and store
// of a warp is one contiguous run; the neighbour rows (i-2..i+1) come back
// through L1/L2, which hold the few rows a wave of blocks touches. Each
// thread recomputes the velocities it needs (5 of u, 5 of v); sharing
// them through shared memory is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ p, int64_t off) {
  return __ldg(p + off);
}

// Row offsets of x-rows i-2..i+1 and wrapped y indices j-2..j+1.
struct Stencil {
  int64_t r[4];  // (i-2, i-1, i, i+1) * ny
  int c[4];      // j-2, j-1, j, j+1 (wrapped)
  __device__ __forceinline__ int64_t at(int di, int dj) const {
    return r[di + 2] + c[dj + 2];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) sw_stage(
    const T* __restrict__ U, const T* __restrict__ V, const T* __restrict__ H,
    T* __restrict__ gU, T* __restrict__ gV, T* __restrict__ gH,
    T* __restrict__ Un, T* __restrict__ Vn, T* __restrict__ Hn, int nx,
    int ny, int x0, T idx, T idy, T grav, T ca, T cb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ny) return;
  for (int64_t i = blockIdx.y; i < nx; i += gridDim.y) {
    const int64_t p = i * ny + j;
    if (i < x0 || i >= nx - x0) {
      Un[p] = U[p];
      Vn[p] = V[p];
      Hn[p] = H[p];
      continue;
    }
    Stencil S;
#pragma unroll
    for (int d = -2; d <= 1; ++d) {
      S.r[d + 2] = (i + d) * ny;
      int jj = j + d;
      jj = jj < 0 ? jj + ny : (jj >= ny ? jj - ny : jj);
      S.c[d + 2] = jj;
    }
    const T c = T(0.5);
    auto h = [&](int di, int dj) { return ld(H, S.at(di, dj)); };
    auto Uv = [&](int di, int dj) { return ld(U, S.at(di, dj)); };
    auto Vv = [&](int di, int dj) { return ld(V, S.at(di, dj)); };
    // the velocities at (i+di, j+dj), as the TPU body forms them
    auto u = [&](int di, int dj) {
      return Uv(di, dj) / (c * (h(di, dj) + h(di - 1, dj)));
    };
    auto v = [&](int di, int dj) {
      return Vv(di, dj) / (c * (h(di, dj) + h(di, dj - 1)));
    };

    const T h00 = h(0, 0), hm0 = h(-1, 0), h0m = h(0, -1);
    const T U00 = Uv(0, 0), V00 = Vv(0, 0);
    const T u00 = u(0, 0), up0 = u(1, 0), v00 = v(0, 0), v0p = v(0, 1);
    const T vm0 = v(-1, 0), u0m = u(0, -1);

    // x-momentum
    const T fxx_p = c * (up0 + u00) * (c * (Uv(1, 0) + U00));
    const T fxx_0 = c * (u00 + u(-1, 0)) * (c * (U00 + Uv(-1, 0)));
    const T fxy_0 = c * (v00 + vm0) * (c * (U00 + Uv(0, -1)));
    const T fxy_p = c * (v0p + v(-1, 1)) * (c * (Uv(0, 1) + U00));
    const T h_fc = c * (h00 + hm0);
    const T gu = -((fxx_p - fxx_0) * idx + (fxy_p - fxy_0) * idy)
                 - grav * h_fc * (h00 - hm0) * idx;
    // y-momentum
    const T fyx_0 = c * (u00 + u0m) * (c * (V00 + Vv(-1, 0)));
    const T fyx_p = c * (up0 + u(1, -1)) * (c * (Vv(1, 0) + V00));
    const T fyy_0 = c * (v0p + v00) * (c * (Vv(0, 1) + V00));
    const T fyy_m = c * (v00 + v(0, -1)) * (c * (V00 + Vv(0, -1)));
    const T h_cf = c * (h00 + h0m);
    const T gv = -((fyx_p - fyx_0) * idx + (fyy_0 - fyy_m) * idy)
                 - grav * h_cf * (h00 - h0m) * idy;
    // mass
    const T gh = -((Uv(1, 0) - U00) * idx + (Vv(0, 1) - V00) * idy);

    Un[p] = U00 + ca * gu + cb * gU[p];
    Vn[p] = V00 + ca * gv + cb * gV[p];
    Hn[p] = h00 + ca * gh + cb * gH[p];
    gU[p] = gu;
    gV[p] = gv;
    gH[p] = gh;
  }
}

template <typename T>
int launch_stage(const void* U, const void* V, const void* H, void* gU,
                 void* gV, void* gH, void* Un, void* Vn, void* Hn, int nx,
                 int ny, int x0, double idx, double idy, double grav,
                 double ca, double cb, void* stream) {
  if (x0 < 2 || ny < 2 || nx < 2 * x0) return (int)cudaErrorInvalidValue;
  const dim3 grid((ny + kThreads - 1) / kThreads,
                  nx < kMaxGridY ? nx : kMaxGridY);
  sw_stage<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, (const T*)V, (const T*)H, (T*)gU, (T*)gV, (T*)gH, (T*)Un,
      (T*)Vn, (T*)Hn, nx, ny, x0, (T)idx, (T)idy, (T)grav, (T)ca, (T)cb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define OT_SW_ENTRY(SUFFIX, T)                                               \
  int ot_sw_rk3_stage_##SUFFIX(const void* U, const void* V, const void* H,  \
                               void* gU, void* gV, void* gH, void* Un,       \
                               void* Vn, void* Hn, int nx, int ny, int x0,   \
                               double idx, double idy, double grav,          \
                               double ca, double cb, void* stream) {         \
    return launch_stage<T>(U, V, H, gU, gV, gH, Un, Vn, Hn, nx, ny, x0, idx, \
                           idy, grav, ca, cb, stream);                       \
  }

OT_SW_ENTRY(f32, float)
OT_SW_ENTRY(f64, double)

#undef OT_SW_ENTRY

}  // extern "C"
