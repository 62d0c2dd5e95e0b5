// One stage of the conservative shallow-water RK3 step in one pass, as an
// x-marching strip.
//
// Replaces the TPU kernel oceananigans_tpu/ops/pallas_sw.py:
//   sw_rk3_stage (_sw_kernel, body _sw_body) -> sw_strip
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
// and q' = q + ca*G + cb*G_prev for q = U, V, h. Each G is written over
// G_prev in place (a thread reads G_prev only at its own point) and G's
// x-halo rows keep G_prev's values; q' goes to a new buffer whose x-halo
// rows are copies of q's. The divisions are exact IEEE divisions (no fast
// math), as in the plain PyTorch version (ops/cuda_sw.py), which evaluates
// the same fluxes with the model's whole-array operators in another order;
// the two agree to rounding.
//
// What bounds it on the H100: memory. Per point it must read U, V, h and
// the three G_prev and write three q' and three G, 12 values, for ~90
// operations and 2 divisions: at 8192^2 in float32 that is 12 x 269 MB =
// 3.23 GB, a floor of ~0.96 ms per stage at 3.35 TB/s. The first kernel
// (one thread a point) read each input row four times through L2, once for
// each output row whose stencil reaches it, and recomputed 10 velocities a
// point, and ran at 44% of the memory rate.
//
// Design: a block of 256 threads owns a strip of kStrip = 512 consecutive
// output y (two a thread, kThreads apart, so every warp's load and store is
// one contiguous run) and a segment of output x-rows, which it marches
// upward. Row i+2 of U, V and h, over the strip and its wrapped y-halo
// [j0-2, j0+kStrip+1), is copied by cp.async into a ring of 4 shared-memory
// rows while row i is computed, so each input value is read from device
// memory once a segment (3 halo columns a strip and 3 priming rows a
// segment beyond). The velocities u(i+1, .) and v(i, .) are computed once
// each into rings of u rows (i-1..i+1) and v rows (i-1, i), with the same
// expressions as the first kernel, so 2 divisions a point instead of 10.
// G_prev is read, and G and q' are written, at the block's own points only.
// The launch plan (segment length and count) comes from the wrapper
// (ops/cuda_sw.py: stage_plan), sized for ~3 waves of resident blocks with
// segments of at least 64 rows.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPts = 2;                         // output y a thread
constexpr int kStrip = kThreads * kPts;         // output y a block
constexpr int kCols = kStrip + 3;               // strip and y-halo [-2, +1]
constexpr int kRow = kCols + 1;                 // a shared row, padded
constexpr int kCopies = (kCols + kThreads - 1) / kThreads;
constexpr int kSlots = 4;                       // rows i-1 .. i+2
static_assert((kSlots & (kSlots - 1)) == 0, "rings are indexed by a mask");

// float32 takes four blocks an SM (at most 64 registers a thread), float64
// two
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;

// the data ring of U, V, h, the u ring and the v ring
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(3 * kSlots + kSlots + 2) * kRow * sizeof(T);
}

__device__ __forceinline__ int wrap(int j, int n) {
  j %= n;
  return j < 0 ? j + n : j;
}

// Kernel 10: the stage on output x-rows [x0 + seg*seg_len, ...) of the
// segment blockIdx.y and output y [j0, j0 + kStrip) of the strip
// blockIdx.x. Shared row s holds column j0 - 2 + s.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) sw_strip(
    const T* __restrict__ U, const T* __restrict__ V, const T* __restrict__ H,
    T* __restrict__ gU, T* __restrict__ gV, T* __restrict__ gH,
    T* __restrict__ Un, T* __restrict__ Vn, T* __restrict__ Hn, int nx,
    int ny, int x0, int seg_len, T idx, T idy, T grav, T ca, T cb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* data = reinterpret_cast<T*>(smem_raw);  // [3][kSlots][kRow]: U, V, h
  T* uring = data + 3 * kSlots * kRow;       // [kSlots][kRow]
  T* vring = uring + kSlots * kRow;          // [2][kRow]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kStrip;
  const int seg = blockIdx.y, nseg = gridDim.y;
  const int ia = x0 + seg * seg_len;
  const int ib = min(ia + seg_len, nx - x0);
  auto Ud = [&](int r) { return data + (r & (kSlots - 1)) * kRow; };
  auto Vd = [&](int r) {
    return data + (kSlots + (r & (kSlots - 1))) * kRow;
  };
  auto hd = [&](int r) {
    return data + (2 * kSlots + (r & (kSlots - 1))) * kRow;
  };
  auto ur = [&](int r) { return uring + (r & (kSlots - 1)) * kRow; };
  auto vr = [&](int r) { return vring + (r & 1) * kRow; };

  // the first and last segments copy the x-halo rows of q into q'
  for (int k = 0; k < kPts && (seg == 0 || seg == nseg - 1); ++k) {
    const int j = j0 + tid + k * kThreads;
    if (j >= ny) break;
    for (int r = 0; r < x0; ++r) {
      if (seg == 0) {
        const int64_t p = (int64_t)r * ny + j;
        Un[p] = U[p];
        Vn[p] = V[p];
        Hn[p] = H[p];
      }
      if (seg == nseg - 1) {
        const int64_t p = (int64_t)(nx - 1 - r) * ny + j;
        Un[p] = U[p];
        Vn[p] = V[p];
        Hn[p] = H[p];
      }
    }
  }

  // the wrapped columns of the shared elements this thread copies
  int col[kCopies];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    col[k] = wrap(j0 - 2 + tid + k * kThreads, ny);
  }
  auto load_row = [&](int r) {
    const int64_t base = (int64_t)r * ny;
    T* dst[3] = {Ud(r), Vd(r), hd(r)};
    const T* src[3] = {U, V, H};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int e = tid + k * kThreads;
        if (e < kCols) {
          __pipeline_memcpy_async(dst[f] + e, src[f] + base + col[k],
                                  sizeof(T));
        }
      }
    }
    __pipeline_commit();
  };
  // u(r, .) at shared columns [1, kStrip + 1] (an output's j-1 and j),
  // v(r, .) at [1, kStrip + 2] (its j-1, j and j+1)
  const T c = T(0.5);
  auto velocity_u = [&](int r) {
    const T* Ur = Ud(r);
    const T* h0 = hd(r);
    const T* hm = hd(r - 1);
    T* dst = ur(r);
    for (int s = tid + 1; s <= kStrip + 1; s += kThreads) {
      dst[s] = Ur[s] / (c * (h0[s] + hm[s]));
    }
  };
  auto velocity_v = [&](int r) {
    const T* Vr = Vd(r);
    const T* h0 = hd(r);
    T* dst = vr(r);
    for (int s = tid + 1; s <= kStrip + 2; s += kThreads) {
      dst[s] = Vr[s] / (c * (h0[s] + h0[s - 1]));
    }
  };

  if (ia >= ib) return;
  // prime: rows ia-2 .. ia+1, then u(ia-1), u(ia) and v(ia-1)
  for (int r = ia - 2; r <= ia + 1; ++r) load_row(r);
  __pipeline_wait_prior(0);
  __syncthreads();
  velocity_u(ia - 1);
  velocity_u(ia);
  velocity_v(ia - 1);

  for (int i = ia; i < ib; ++i) {
    __pipeline_wait_prior(0);  // row i+1 has landed
    __syncthreads();           // and step i-1 is done with its slots
    if (i + 1 < ib) load_row(i + 2);
    const int64_t rb = (int64_t)i * ny;
    T gu0[kPts], gv0[kPts], gh0[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int j = j0 + tid + k * kThreads;
      if (j < ny) {
        gu0[k] = gU[rb + j];
        gv0[k] = gV[rb + j];
        gh0[k] = gH[rb + j];
      }
    }
    velocity_u(i + 1);
    velocity_v(i);
    __syncthreads();
    const T *Um = Ud(i - 1), *U0 = Ud(i), *Up = Ud(i + 1);
    const T *Vm = Vd(i - 1), *V0 = Vd(i), *Vp = Vd(i + 1);
    const T *hm = hd(i - 1), *h0 = hd(i);
    const T *um = ur(i - 1), *u0 = ur(i), *up = ur(i + 1);
    const T *vm = vr(i - 1), *v0 = vr(i);
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int j = j0 + tid + k * kThreads;
      if (j >= ny) break;
      const int s = tid + k * kThreads + 2;
      const T h00 = h0[s], hm0 = hm[s], h0m = h0[s - 1];
      const T U00 = U0[s], V00 = V0[s];
      const T u00 = u0[s], up0 = up[s], v00 = v0[s], v0p = v0[s + 1];
      const T vm0 = vm[s], u0m = u0[s - 1];

      // x-momentum
      const T fxx_p = c * (up0 + u00) * (c * (Up[s] + U00));
      const T fxx_0 = c * (u00 + um[s]) * (c * (U00 + Um[s]));
      const T fxy_0 = c * (v00 + vm0) * (c * (U00 + U0[s - 1]));
      const T fxy_p = c * (v0p + vm[s + 1]) * (c * (U0[s + 1] + U00));
      const T h_fc = c * (h00 + hm0);
      const T gu = -((fxx_p - fxx_0) * idx + (fxy_p - fxy_0) * idy)
                   - grav * h_fc * (h00 - hm0) * idx;
      // y-momentum
      const T fyx_0 = c * (u00 + u0m) * (c * (V00 + Vm[s]));
      const T fyx_p = c * (up0 + up[s - 1]) * (c * (Vp[s] + V00));
      const T fyy_0 = c * (v0p + v00) * (c * (V0[s + 1] + V00));
      const T fyy_m = c * (v00 + v0[s - 1]) * (c * (V00 + V0[s - 1]));
      const T h_cf = c * (h00 + h0m);
      const T gv = -((fyx_p - fyx_0) * idx + (fyy_0 - fyy_m) * idy)
                   - grav * h_cf * (h00 - h0m) * idy;
      // mass
      const T gh = -((Up[s] - U00) * idx + (V0[s + 1] - V00) * idy);

      const int64_t p = rb + j;
      Un[p] = U00 + ca * gu + cb * gu0[k];
      Vn[p] = V00 + ca * gv + cb * gv0[k];
      Hn[p] = h00 + ca * gh + cb * gh0[k];
      gU[p] = gu;
      gV[p] = gv;
      gH[p] = gh;
    }
  }
}

// The plan (strip, seg_len, nseg) must be ops/cuda_sw.py's: strips of
// kStrip output y, nseg segments of seg_len output x-rows that cover the
// nx - 2 x0 of them, the last one not empty.
template <typename T>
int launch_stage(const void* U, const void* V, const void* H, void* gU,
                 void* gV, void* gH, void* Un, void* Vn, void* Hn, int nx,
                 int ny, int x0, int strip, int seg_len, int nseg,
                 double idx, double idy, double grav, double ca, double cb,
                 void* stream) {
  const int rows = nx - 2 * x0;
  if (x0 < 2 || ny < 2 || rows < 1 || strip != kStrip || seg_len < 1 ||
      nseg < 1 || nseg > 65535 || (int64_t)(nseg - 1) * seg_len >= rows ||
      (int64_t)nseg * seg_len < rows) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      sw_strip<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ny + kStrip - 1) / kStrip, nseg);
  sw_strip<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)U, (const T*)V, (const T*)H, (T*)gU, (T*)gV, (T*)gH, (T*)Un,
      (T*)Vn, (T*)Hn, nx, ny, x0, seg_len, (T)idx, (T)idy, (T)grav, (T)ca,
      (T)cb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define OT_SW_ENTRY(SUFFIX, T)                                               \
  int ot_sw_rk3_stage_##SUFFIX(const void* U, const void* V, const void* H,  \
                               void* gU, void* gV, void* gH, void* Un,       \
                               void* Vn, void* Hn, int nx, int ny, int x0,   \
                               int strip, int seg_len, int nseg, double idx, \
                               double idy, double grav, double ca,           \
                               double cb, void* stream) {                    \
    return launch_stage<T>(U, V, H, gU, gV, gH, Un, Vn, Hn, nx, ny, x0,      \
                           strip, seg_len, nseg, idx, idy, grav, ca, cb,     \
                           stream);                                          \
  }

OT_SW_ENTRY(f32, float)
OT_SW_ENTRY(f64, double)

#undef OT_SW_ENTRY

}  // extern "C"
