// WENO-5 momentum tendency -∇·(𝐯 ⊗ 𝐯) as an x-marching tile that computes
// each face flux once.
//
// Replaces the TPU kernel oceananigans_tpu/ops/pallas_weno.py:
//   weno5_momentum_tendency (_kernel) -> weno5_tile
// (the momentum AB2 step, the science AB2 step and the tracer tendencies
// are the tiles of weno5_science_tile.cu).
//
// Output x-rows are [3, nx-3), the other x-rows are zeroed, as the JAX
// wrapper embeds its result in zeros.
//
// What bounds it on the H100: arithmetic. Each point needs nine face
// fluxes (three components along three axes), each one WENO-Z side of ~86
// operations: 849 operations a point, 14.2 GFLOP at 256^3 in float32,
// 0.21 ms at the 67 TFLOP/s FFMA peak, against 0.12 ms for the six fields
// it must move.
//
// Design: the momentum march of weno5_tile.h (a 16 x 32 panel through a
// ring of 8 shared-memory planes of u, v and w; for each component 17 x 32
// y faces and 16 x 33 z faces a plane into shared memory, the x faces
// carried in registers; one WENO side a face), its segments sized for two
// waves of the card. 64 registers and 93 KB of shared memory in float32:
// two blocks an SM. The plain PyTorch version (ops/cuda_weno.py)
// multiplies by face areas and divides by volumes where this kernel
// multiplies by 1/spacing, so the two agree to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "weno5_tile.h"

namespace {

using namespace ot_tile;

// Kernel 7: (Gu, Gv, Gw) on x-rows [3, nx-3) of the panel over the
// x-segment blockIdx.z of seg_len rows; the first and last segments zero
// the x-halo rows of their columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) weno5_tile(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw, int nx,
    int ny, int nz, int seg_len, Coefs<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Panel P = panel_of(ny, nz);
  halo_rows(P, nx, blockIdx.z, gridDim.z,
            [&](int64_t p) { gu[p] = gv[p] = gw[p] = T(0); });
  momentum_march(u, v, w, nx, blockIdx.z, seg_len, P, c, smem_raw,
                 [&](int i, const T (&g)[3]) {
                   const int64_t p = i * P.sx + P.col;
                   gu[p] = g[0];
                   gv[p] = g[1];
                   gw[p] = g[2];
                 });
}

template <typename T>
int launch(const void* u, const void* v, const void* w, void* gu, void* gv,
           void* gw, int nx, int ny, int nz, double idx, double idy,
           double idz, double eps, void* stream) {
  if ((int64_t)nx * ny * nz == 0) return 0;
  const int rows = nx - 2 * kH;  // output x-rows
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = momentum_smem_bytes<T>();
  const int py = (ny + TY - 1) / TY, pz = (nz + TZ - 1) / TZ;
  int seg_len = 0, nseg = 0;
  const cudaError_t err = plan_segments((const void*)weno5_tile<T>, bytes,
                                        rows, (int64_t)py * pz, &seg_len,
                                        &nseg);
  if (err != cudaSuccess) return (int)err;
  if (py > 65535 || nseg > 65535) return (int)cudaErrorInvalidValue;
  weno5_tile<T><<<dim3(pz, py, (unsigned)nseg), kThreads, bytes,
                  (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, nx, ny,
      nz, seg_len, Coefs<T>{(T)idx, (T)idy, (T)idz, (T)eps});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ot_weno5_tendency_f32(const void* u, const void* v, const void* w,
                          void* gu, void* gv, void* gw, int nx, int ny,
                          int nz, double idx, double idy, double idz,
                          double eps, void* stream) {
  return launch<float>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy, idz, eps,
                       stream);
}

int ot_weno5_tendency_f64(const void* u, const void* v, const void* w,
                          void* gu, void* gv, void* gw, int nx, int ny,
                          int nz, double idx, double idy, double idz,
                          double eps, void* stream) {
  return launch<double>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy, idz, eps,
                        stream);
}

}  // extern "C"
