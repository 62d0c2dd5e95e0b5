// WENO-5 momentum tendency -∇·(𝐯 ⊗ 𝐯) as an x-marching tile that computes
// each face flux once.
//
// Replaces the TPU kernel oceananigans_tpu/ops/pallas_weno.py:
//   weno5_momentum_tendency (_kernel) -> weno5_tile
// (the fused AB2, science and tracer kernels of that file stay in
// weno5.cu).
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// Output x-rows are [3, nx-3), the other x-rows are zeroed, as the JAX
// wrapper embeds its result in zeros. y and z neighbours at offsets -3..+3
// wrap modulo the full extent: on a halo-free periodic axis the wrap is
// the periodic boundary itself, on an axis with a halo of 3 or more it
// lands only in halo rows that the caller's next fill overwrites.
//
// What bounds it on the H100: arithmetic. Each point needs nine face
// fluxes (three components along three axes), each one WENO-Z side of ~86
// operations: 849 operations a point, 14.2 GFLOP at 256^3 in float32,
// 0.21 ms at the 67 TFLOP/s FFMA peak, against 0.12 ms for the six fields
// it must move.
//
// Design. A block of 512 threads owns a panel of 16 (y) x 32 (z) output
// columns, a warp along z, and marches along x, the one axis with halo
// rows, over one segment of x-rows (segments give enough blocks for two
// waves; each re-reads its 6 halo planes). Each x-plane of u, v and w
// enters a ring of 8 shared-memory tiles of 22 x 38 points (the panel and
// a 3-point halo in y and z) once, by 4- or 8-byte cp.async copies whose
// y and z indices are wrapped through per-block offset tables; plane i+4
// is copied while plane i is computed. At plane i:
// - the y- and z-face fluxes of the panel (17 x 32 and 16 x 33 faces for
//   each component) are computed once each into shared memory, then
//   differenced: only the faces on the panel's upper edges are extra;
// - each thread computes the three x-face fluxes above its column and
//   carries them in registers to the next plane, where they are the
//   fluxes below it.
// A face reads its six taps from the ring, picks them by the sign of the
// advecting velocity U (mirrored for U <= 0, as advection._onesided with
// reflect=True does; the right-biased side at U == 0, where U times
// either side is 0) and evaluates one WENO-Z combination: the same code on
// every lane, with no branch on the data. The ratio tau/(beta+eps) is
// capped at 1e12 in float32 and 1e60 in float64, and the weights are
// formed with reciprocals and products rather than IEEE division, whose
// slow path (behind its FCHK test) zero rows take. 63 registers and 93 KB
// of shared memory in float32: two blocks an SM. The plain PyTorch
// version (ops/cuda_weno.py) multiplies by face areas and divides by
// volumes where this kernel multiplies by 1/spacing, so the two agree to
// rounding, not bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TY = 16, TZ = 32, kThreads = TY * TZ;
constexpr int kH = 3;                       // stencil reach
constexpr int kTR = TY + 2 * kH;            // tile rows (y)
constexpr int kTC = TZ + 2 * kH;            // tile columns (z)
constexpr int kPlane = kTR * kTC;           // points of one field's tile
constexpr int kRing = 8;                    // planes i-3 .. i+4
constexpr int kFy = (TY + 1) * TZ;          // y faces of one component
constexpr int kFz = TY * (TZ + 1);          // z faces of one component
constexpr int kFaces = 3 * (kFy + kFz);     // y and z faces of a plane
constexpr int kMinSeg = 32;                 // fewest x-rows of a segment
static_assert((kRing & (kRing - 1)) == 0, "the ring is indexed by a mask");

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(kRing * 3 * kPlane + 3 * kFy + 3 * kFz) * sizeof(T) +
         kTR * sizeof(int64_t) + kTC * sizeof(int);
}

template <typename T> struct RatioCap;
template <> struct RatioCap<float> { static constexpr float value = 1e12f; };
template <> struct RatioCap<double> { static constexpr double value = 1e60; };

// 1/x: in float32 the approximate reciprocal and one Newton step (within
// an ulp), in float64 the correctly rounded one
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * (2.f - x * r);
}
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

template <typename T>
struct Coefs {
  T idx, idy, idz, eps;
};

// One WENO-5 face value from its six taps s[0..5] at offsets -3..2 from
// the face: left-biased from s[0..4] for U > 0, else right-biased, which
// is the left-biased formula on the mirrored taps s[5..1].
template <typename T>
__device__ __forceinline__ T weno5_value(const T (&s)[6], T U, T eps) {
  const bool left = U > T(0);
  const T sm3 = left ? s[0] : s[5];
  const T sm2 = left ? s[1] : s[4];
  const T sm1 = left ? s[2] : s[3];
  const T s0 = left ? s[3] : s[2];
  const T s1 = left ? s[4] : s[1];
  const T c1 = T(13.0 / 12.0), c2 = T(0.25);
  const T q0 = T(2.0 / 6) * sm3 + T(-7.0 / 6) * sm2 + T(11.0 / 6) * sm1;
  const T q1 = T(-1.0 / 6) * sm2 + T(5.0 / 6) * sm1 + T(2.0 / 6) * s0;
  const T q2 = T(2.0 / 6) * sm1 + T(5.0 / 6) * s0 + T(-1.0 / 6) * s1;
  T t;
  t = sm3 - T(2) * sm2 + sm1; const T d3 = t * t;
  t = sm2 - T(2) * sm1 + s0;  const T d2 = t * t;
  t = sm1 - T(2) * s0 + s1;   const T d1 = t * t;
  t = sm3 - T(4) * sm2 + T(3) * sm1; const T b0 = c1 * d3 + c2 * (t * t);
  t = sm2 - s0;                      const T b1 = c1 * d2 + c2 * (t * t);
  t = T(3) * sm1 - T(4) * s0 + s1;   const T b2 = c1 * d1 + c2 * (t * t);
  // WENO-Z weights, gammas (1, 6, 3)/10
  const T cap = RatioCap<T>::value;
  const T tau = fabs(b0 - b2);
  const T r0 = fmin(tau * rcp(b0 + eps), cap);
  const T r1 = fmin(tau * rcp(b1 + eps), cap);
  const T r2 = fmin(tau * rcp(b2 + eps), cap);
  const T a0 = T(0.1) * (T(1) + r0 * r0);
  const T a1 = T(0.6) * (T(1) + r1 * r1);
  const T a2 = T(0.3) * (T(1) + r2 * r2);
  return (a0 * q0 + a1 * q1 + a2 * q2) * rcp(a0 + a1 + a2);
}

__device__ __forceinline__ int wrap(int j, int n) {
  j %= n;
  return j < 0 ? j + n : j;
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Kernel 7: (Gu, Gv, Gw) on x-rows [3, nx-3) of the panel (blockIdx.x:
// z, blockIdx.y: y) over the x-segment blockIdx.z of seg_len rows; the
// first and last segments zero the x-halo rows of their columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) weno5_tile(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw, int nx,
    int ny, int nz, int seg_len, Coefs<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kRing][3][kTR][kTC]
  T* Fy = ring + kRing * 3 * kPlane;            // [3][TY + 1][TZ]
  T* Fz = Fy + 3 * kFy;                         // [3][TY][TZ + 1]
  int64_t* rowoff = reinterpret_cast<int64_t*>(Fz + 3 * kFz);
  int* coloff = reinterpret_cast<int*>(rowoff + kTR);

  const int tid = threadIdx.x;
  const int jy = tid / TZ, kz = tid % TZ;
  const int j0 = blockIdx.y * TY, k0 = blockIdx.x * TZ;
  const int j = j0 + jy, k = k0 + kz;
  const bool mine = j < ny && k < nz;
  const int64_t sx = (int64_t)ny * nz;
  const int64_t col = (int64_t)j * nz + k;
  T* const out[3] = {gu, gv, gw};

  if (mine) {
    for (int r = 0; r < kH; ++r) {
      for (int q = 0; q < 3; ++q) {
        if (blockIdx.z == 0) out[q][r * sx + col] = T(0);
        if (blockIdx.z == gridDim.z - 1) {
          out[q][(nx - 1 - r) * sx + col] = T(0);
        }
      }
    }
  }
  const int i0 = kH + blockIdx.z * seg_len;
  const int i1 = min(i0 + seg_len, nx - kH);
  if (i0 >= i1) return;

  if (tid < kTR) {
    rowoff[tid] = (int64_t)wrap(j0 - kH + tid, ny) * nz;
  } else if (tid < kTR + kTC) {
    coloff[tid - kTR] = wrap(k0 - kH + tid - kTR, nz);
  }
  __syncthreads();

  auto slot = [&](int p) { return ring + (p & (kRing - 1)) * 3 * kPlane; };
  auto load_plane = [&](int p) {
    T* dst = slot(p);
    const int64_t base = (int64_t)p * sx;
    for (int e = tid; e < 3 * kPlane; e += kThreads) {
      const int f = e / kPlane, rc = e - f * kPlane;
      const int r = rc / kTC, cc = rc - r * kTC;
      const T* src = f == 0 ? u : (f == 1 ? v : w);
      copy_async(dst + e, src + base + rowoff[r] + coloff[cc]);
    }
  };
  // this thread's column in the tile
  const int pos = (jy + kH) * kTC + kz + kH;
  // the x-face flux of component q at face plane fp (between fp-1 and fp)
  // in this thread's column: taps q at planes fp-3 .. fp+2, advected by
  // the average of u across the face's own staggering
  auto xflux = [&](int fp, int q) {
    const T* here = slot(fp);
    const T a = q == 0 ? slot(fp - 1)[pos] : here[pos - (q == 1 ? kTC : 1)];
    const T U = T(0.5) * (a + here[pos]);
    T s[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) s[d] = slot(fp - kH + d)[q * kPlane + pos];
    return U * weno5_value(s, U, c.eps);
  };

  for (int p = i0 - kH; p <= i0 + kH; ++p) load_plane(p);
  commit();
  wait_all();
  __syncthreads();
  T fx[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) fx[q] = xflux(i0, q);

  for (int i = i0; i < i1; ++i) {
    if (i > i0) {
      wait_all();        // plane i+3 has landed
      __syncthreads();   // and step i-1 is done with its slot and faces
    }
    if (i + kH + 1 <= i1 + kH - 1) load_plane(i + kH + 1);
    commit();
    const T* cur = slot(i);
    const T* prev = slot(i - 1);
    // y faces (between rows j-1 and j, advected by v) and z faces
    // (between columns k-1 and k, advected by w) of plane i
    for (int e = tid; e < kFaces; e += kThreads) {
      int q, p, stride, vf;
      T* dst;
      if (e < 3 * kFy) {
        q = e / kFy;
        const int r = e - q * kFy, rf = r / TZ, cz = r - rf * TZ;
        p = (rf + kH) * kTC + cz + kH;
        stride = kTC;
        vf = 1;
        dst = Fy + e;
      } else {
        const int e2 = e - 3 * kFy;
        q = e2 / kFz;
        const int r = e2 - q * kFz, ry = r / (TZ + 1), cf = r - ry * (TZ + 1);
        p = (ry + kH) * kTC + cf + kH;
        stride = 1;
        vf = 2;
        dst = Fz + e2;
      }
      const T* vel = cur + vf * kPlane;
      const T a = q == 0 ? prev[vf * kPlane + p]
                         : vel[p - (q == 1 ? kTC : 1)];
      const T U = T(0.5) * (a + vel[p]);
      const T* tap = cur + q * kPlane + p;
      T s[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) s[d] = tap[(d - kH) * stride];
      *dst = U * weno5_value(s, U, c.eps);
    }
    T fxu[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) fxu[q] = xflux(i + 1, q);
    __syncthreads();
    if (mine) {
      const int py = jy * TZ + kz, pz = jy * (TZ + 1) + kz;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const T* fy = Fy + q * kFy + py;
        const T* fz = Fz + q * kFz + pz;
        T g = -(fxu[q] - fx[q]) * c.idx;
        g = g - (fy[TZ] - fy[0]) * c.idy;
        g = g - (fz[1] - fz[0]) * c.idz;
        out[q][i * sx + col] = g;
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) fx[q] = fxu[q];
  }
  wait_all();
}

template <typename T>
int launch(const void* u, const void* v, const void* w, void* gu, void* gv,
           void* gw, int nx, int ny, int nz, double idx, double idy,
           double idz, double eps, void* stream) {
  if ((int64_t)nx * ny * nz == 0) return 0;
  const int rows = nx - 2 * kH;  // output x-rows
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      weno5_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, weno5_tile<T>, kThreads, bytes)) != cudaSuccess) {
    return (int)err;
  }
  const int py = (ny + TY - 1) / TY, pz = (nz + TZ - 1) / TZ;
  const int64_t panels = (int64_t)py * pz;
  // x segments: enough blocks for two waves of the card, each of at least
  // kMinSeg rows, since a segment re-reads its 6 halo planes
  const int64_t waves = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  int64_t nseg = (waves + panels - 1) / panels;
  nseg = nseg < rows / kMinSeg ? nseg : rows / kMinSeg;
  nseg = nseg > 1 ? nseg : 1;
  const int seg_len = (int)((rows + nseg - 1) / nseg);
  nseg = (rows + seg_len - 1) / seg_len;
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
