// The x-marching WENO-5 tile shared by the momentum tendency
// (weno5_tile.cu), the science AB2 step and the tracer tendencies
// (weno5_science_tile.cu).
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// A block of 512 threads owns a panel of 16 (y) x 32 (z) output columns, a
// warp along z, and marches along x, the one axis with halo rows, over one
// segment of the output x-rows [3, nx-3). Each x-plane of the fields it
// advects enters a ring of 8 shared-memory tiles of 22 x 38 points (the
// panel and a 3-point halo in y and z) once, by 4- or 8-byte cp.async
// copies whose y and z indices are wrapped through per-block offset tables
// (on a halo-free periodic axis the wrap is the periodic boundary itself,
// on an axis with a halo of 3 or more it lands only in halo rows that the
// caller's next fill overwrites); plane i+4 is copied while plane i is
// computed. At plane i the y- and z-face fluxes of the panel are computed
// once each into shared memory and differenced, and each thread computes
// the x-face flux above its column and carries it in registers to the next
// plane, where it is the flux below it.
//
// A face reads its six taps, picks them by the sign of the advecting
// velocity U (mirrored for U <= 0, as advection._onesided with
// reflect=True does; the right-biased side at U == 0, where U times either
// side is 0) and evaluates one WENO-Z combination: the same code on every
// lane, with no branch on the data. The ratio tau/(beta+eps) is capped at
// 1e12 in float32 and 1e60 in float64, and the weights are formed with
// reciprocals and products rather than IEEE division, whose slow path
// (behind its FCHK test) zero rows take.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ot_tile {

constexpr int TY = 16, TZ = 32, kThreads = TY * TZ;
constexpr int kH = 3;                       // stencil reach
constexpr int kTR = TY + 2 * kH;            // tile rows (y)
constexpr int kTC = TZ + 2 * kH;            // tile columns (z)
constexpr int kPlane = kTR * kTC;           // points of one field's tile
constexpr int kRing = 8;                    // planes i-3 .. i+4
constexpr int kFy = (TY + 1) * TZ;          // y faces of one field
constexpr int kFz = TY * (TZ + 1);          // z faces of one field
constexpr int kMinSeg = 32;                 // fewest x-rows of a segment
static_assert((kRing & (kRing - 1)) == 0, "the ring is indexed by a mask");

// the wrapped y-row and z-column offset tables that follow the block's
// field data in shared memory
constexpr size_t kOffsetBytes = kTR * sizeof(int64_t) + kTC * sizeof(int);

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

// The block's panel (blockIdx.x: z, blockIdx.y: y) and this thread's
// column in it. Threads whose column lies beyond (ny, nz) load and compute
// like the others (their indices wrap) but write nothing.
struct Panel {
  int jy, kz;      // the column in the panel
  int j0, k0;      // the panel's first row and column
  bool mine;       // the column is a point of the field
  int64_t sx;      // x stride
  int64_t col;     // the column's offset in an x-plane (when mine)
  int pos;         // the column in a ring tile
  int ny, nz;
};

__device__ __forceinline__ Panel panel_of(int ny, int nz) {
  Panel P;
  const int tid = threadIdx.x;
  P.jy = tid / TZ;
  P.kz = tid % TZ;
  P.j0 = blockIdx.y * TY;
  P.k0 = blockIdx.x * TZ;
  const int j = P.j0 + P.jy, k = P.k0 + P.kz;
  P.mine = j < ny && k < nz;
  P.sx = (int64_t)ny * nz;
  P.col = (int64_t)j * nz + k;
  P.pos = (P.jy + kH) * kTC + P.kz + kH;
  P.ny = ny;
  P.nz = nz;
  return P;
}

// Call f(p) for the offset p of each x-halo row of this thread's column
// that the block's x-segment seg of nseg bounds (rows 0..2 for the first,
// nx-3..nx-1 for the last), where the column is a point.
template <typename F>
__device__ __forceinline__ void halo_rows(const Panel& P, int nx, int seg,
                                          int nseg, F f) {
  if (!P.mine) return;
  for (int r = 0; r < kH; ++r) {
    if (seg == 0) f(r * P.sx + P.col);
    if (seg == nseg - 1) f((nx - 1 - r) * P.sx + P.col);
  }
}

// Fill the wrapped offset tables of the panel's tile rows and columns and
// synchronise the block.
__device__ __forceinline__ void fill_offsets(const Panel& P, int64_t* rowoff,
                                             int* coloff) {
  const int tid = threadIdx.x;
  if (tid < kTR) {
    rowoff[tid] = (int64_t)wrap(P.j0 - kH + tid, P.ny) * P.nz;
  } else if (tid < kTR + kTC) {
    coloff[tid - kTR] = wrap(P.k0 - kH + tid - kTR, P.nz);
  }
  __syncthreads();
}

// a[f] by selects, which keep an array of registers (or of kernel
// parameters) out of local memory
template <int kN, typename P>
__device__ __forceinline__ P pick(const P (&a)[kN], int f) {
  P p = a[0];
#pragma unroll
  for (int q = 1; q < kN; ++q) p = f == q ? a[q] : p;
  return p;
}

// Copy x-plane p of the first n fields of src into consecutive ring tiles
// at dst.
template <int kN, typename T>
__device__ __forceinline__ void load_tiles(T* dst, const T* const (&src)[kN],
                                           int n, int p, const Panel& P,
                                           const int64_t* rowoff,
                                           const int* coloff) {
  const int64_t base = (int64_t)p * P.sx;
  for (int e = threadIdx.x; e < n * kPlane; e += kThreads) {
    const int f = e / kPlane, rc = e - f * kPlane;
    const int r = rc / kTC, cc = rc - r * kTC;
    copy_async(dst + e, pick(src, f) + base + rowoff[r] + coloff[cc]);
  }
}

// ---------------------------------------------------------------------------
// Momentum: -∇·(𝐯 ⊗ 𝐯) with the advecting velocities averaged across each
// face's own staggering. Nine face fluxes a point, ~849 operations.
// ---------------------------------------------------------------------------

template <typename T>
constexpr size_t momentum_smem_bytes() {
  return (size_t)(kRing * 3 * kPlane + 3 * kFy + 3 * kFz) * sizeof(T) +
         kOffsetBytes;
}

// The ring tile of x-plane p: fields u, v, w at 0, kPlane, 2 kPlane.
template <typename T>
__device__ __forceinline__ T* momentum_slot(T* ring, int p) {
  return ring + (p & (kRing - 1)) * 3 * kPlane;
}

// March the panel over x-segment seg of seg_len output rows, [i0, i1): at
// each row i, for the threads whose column is a point, call epilogue(i, g)
// with g = (Gu, Gv, Gw) at (i, column); the ring (momentum_slot of the
// block's shared memory) still holds planes i-3 .. i+3 then.
template <typename T, typename Epilogue>
__device__ __forceinline__ void momentum_march(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ w, int nx, int seg, int seg_len, const Panel& P,
    const Coefs<T>& c, unsigned char* smem_raw, Epilogue epilogue) {
  const int i0 = kH + seg * seg_len;
  const int i1 = min(i0 + seg_len, nx - kH);
  if (i0 >= i1) return;
  T* ring = reinterpret_cast<T*>(smem_raw);    // [kRing][3][kTR][kTC]
  T* Fy = ring + kRing * 3 * kPlane;            // [3][TY + 1][TZ]
  T* Fz = Fy + 3 * kFy;                         // [3][TY][TZ + 1]
  int64_t* rowoff = reinterpret_cast<int64_t*>(Fz + 3 * kFz);
  int* coloff = reinterpret_cast<int*>(rowoff + kTR);
  const int tid = threadIdx.x;
  const T* const fields[3] = {u, v, w};

  fill_offsets(P, rowoff, coloff);
  const int pos = P.pos;
  // the x-face flux of component q at face plane fp (between fp-1 and fp)
  // in this thread's column: taps q at planes fp-3 .. fp+2, advected by
  // the average of u across the face's own staggering
  auto xflux = [&](int fp, int q) {
    const T* here = momentum_slot(ring, fp);
    const T a = q == 0 ? momentum_slot(ring, fp - 1)[pos]
                       : here[pos - (q == 1 ? kTC : 1)];
    const T U = T(0.5) * (a + here[pos]);
    T s[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      s[d] = momentum_slot(ring, fp - kH + d)[q * kPlane + pos];
    }
    return U * weno5_value(s, U, c.eps);
  };

  for (int p = i0 - kH; p <= i0 + kH; ++p) {
    load_tiles(momentum_slot(ring, p), fields, 3, p, P, rowoff, coloff);
  }
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
    if (i + kH + 1 <= i1 + kH - 1) {
      load_tiles(momentum_slot(ring, i + kH + 1), fields, 3, i + kH + 1, P,
                 rowoff, coloff);
    }
    commit();
    const T* cur = momentum_slot(ring, i);
    const T* prev = momentum_slot(ring, i - 1);
    // y faces (between rows j-1 and j, advected by v) and z faces
    // (between columns k-1 and k, advected by w) of plane i
    for (int e = tid; e < 3 * (kFy + kFz); e += kThreads) {
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
    if (P.mine) {
      const int py = P.jy * TZ + P.kz, pz = P.jy * (TZ + 1) + P.kz;
      T g[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const T* fy = Fy + q * kFy + py;
        const T* fz = Fz + q * kFz + pz;
        T gq = -(fxu[q] - fx[q]) * c.idx;
        gq = gq - (fy[TZ] - fy[0]) * c.idy;
        gq = gq - (fz[1] - fz[0]) * c.idz;
        g[q] = gq;
      }
      epilogue(i, g);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) fx[q] = fxu[q];
  }
  wait_all();
}

// ---------------------------------------------------------------------------
// Tracers: -∇·(𝐯c), advected by the unaveraged face velocities (x-face i
// by u[i], y-face j by v[j], z-face k by w[k]). Three face fluxes a point
// and tracer, ~273 operations. A block takes kTG tracers: their rings hold
// the taps; of the velocities only the panel's faces are needed, v and w
// of plane i and u of plane i+1, copied one step ahead into a double
// buffer.
// ---------------------------------------------------------------------------

constexpr int kTG = 2;                      // tracers a block
constexpr int kVel = kFy + kFz + TY * TZ;   // v, w and u faces of one step

template <typename T>
constexpr size_t tracer_smem_bytes() {
  return (size_t)(kRing * kTG * kPlane + 2 * kVel + kTG * (kFy + kFz)) *
             sizeof(T) +
         kOffsetBytes;
}

// The ring tile of x-plane p: tracer t at t kPlane.
template <typename T>
__device__ __forceinline__ T* tracer_slot(T* ring, int p) {
  return ring + (p & (kRing - 1)) * kTG * kPlane;
}

// March the panel over x-segment seg of seg_len output rows, [i0, i1),
// for the n <= kTG tracers cs: at each row i, for the threads whose column
// is a point, call epilogue(t, i, g, c) for each tracer t with its
// tendency g and its value c at (i, column).
template <typename T, typename Epilogue>
__device__ __forceinline__ void tracer_march(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ w, const T* const (&cs)[kTG], int n, int nx,
    int seg, int seg_len, const Panel& P, const Coefs<T>& c,
    unsigned char* smem_raw, Epilogue epilogue) {
  const int i0 = kH + seg * seg_len;
  const int i1 = min(i0 + seg_len, nx - kH);
  if (i0 >= i1) return;
  T* ring = reinterpret_cast<T*>(smem_raw);    // [kRing][kTG][kTR][kTC]
  T* vel = ring + kRing * kTG * kPlane;         // [2][kVel]: v, w, u
  T* Fy = vel + 2 * kVel;                       // [kTG][TY + 1][TZ]
  T* Fz = Fy + kTG * kFy;                       // [kTG][TY][TZ + 1]
  int64_t* rowoff = reinterpret_cast<int64_t*>(Fz + kTG * kFz);
  int* coloff = reinterpret_cast<int*>(rowoff + kTR);
  const int tid = threadIdx.x;

  fill_offsets(P, rowoff, coloff);
  const int pos = P.pos;
  // the velocities of step i: v and w at the panel's y and z faces of
  // plane i (laid out as Fy and Fz), u at its columns of plane i+1
  auto load_velocities = [&](int i) {
    T* dst = vel + ((i - i0) & 1) * kVel;
    for (int e = tid; e < kVel; e += kThreads) {
      const T* src;
      int r, cc;
      if (e < kFy) {
        src = v + (int64_t)i * P.sx;
        r = e / TZ;
        cc = e - r * TZ;
      } else if (e < kFy + kFz) {
        src = w + (int64_t)i * P.sx;
        r = (e - kFy) / (TZ + 1);
        cc = e - kFy - r * (TZ + 1);
      } else {
        src = u + (int64_t)(i + 1) * P.sx;
        r = (e - kFy - kFz) / TZ;
        cc = e - kFy - kFz - r * TZ;
      }
      copy_async(dst + e, src + rowoff[r + kH] + coloff[cc + kH]);
    }
  };
  // the x-face flux of tracer t at face plane fp in this thread's column:
  // taps at planes fp-3 .. fp+2, advected by u[fp]
  auto xflux = [&](int fp, int t, T U) {
    T s[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      s[d] = tracer_slot(ring, fp - kH + d)[t * kPlane + pos];
    }
    return U * weno5_value(s, U, c.eps);
  };

  for (int p = i0 - kH; p <= i0 + kH; ++p) {
    load_tiles(tracer_slot(ring, p), cs, n, p, P, rowoff, coloff);
  }
  load_velocities(i0);
  commit();
  const T u0 = u[(int64_t)i0 * P.sx + rowoff[P.jy + kH] + coloff[P.kz + kH]];
  wait_all();
  __syncthreads();
  T fx[kTG];
#pragma unroll
  for (int t = 0; t < kTG; ++t) fx[t] = t < n ? xflux(i0, t, u0) : T(0);

  for (int i = i0; i < i1; ++i) {
    if (i > i0) {
      wait_all();        // plane i+3 and the velocities of step i landed
      __syncthreads();   // and step i-1 is done with its slots and faces
    }
    if (i + kH + 1 <= i1 + kH - 1) {
      load_tiles(tracer_slot(ring, i + kH + 1), cs, n, i + kH + 1, P, rowoff,
                 coloff);
    }
    if (i + 1 < i1) load_velocities(i + 1);
    commit();
    const T* cur = tracer_slot(ring, i);
    const T* vi = vel + ((i - i0) & 1) * kVel;
    for (int e = tid; e < n * (kFy + kFz); e += kThreads) {
      int t, p, stride;
      T U;
      T* dst;
      if (e < n * kFy) {
        t = e / kFy;
        const int r = e - t * kFy, rf = r / TZ, cz = r - rf * TZ;
        p = (rf + kH) * kTC + cz + kH;
        stride = kTC;
        U = vi[r];
        dst = Fy + e;
      } else {
        const int e2 = e - n * kFy;
        t = e2 / kFz;
        const int r = e2 - t * kFz, ry = r / (TZ + 1), cf = r - ry * (TZ + 1);
        p = (ry + kH) * kTC + cf + kH;
        stride = 1;
        U = vi[kFy + r];
        dst = Fz + e2;
      }
      const T* tap = cur + t * kPlane + p;
      T s[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) s[d] = tap[(d - kH) * stride];
      *dst = U * weno5_value(s, U, c.eps);
    }
    const T U1 = vi[kFy + kFz + P.jy * TZ + P.kz];
    T fxu[kTG];
#pragma unroll
    for (int t = 0; t < kTG; ++t) fxu[t] = t < n ? xflux(i + 1, t, U1) : T(0);
    __syncthreads();
    if (P.mine) {
      const int py = P.jy * TZ + P.kz, pz = P.jy * (TZ + 1) + P.kz;
#pragma unroll
      for (int t = 0; t < kTG; ++t) {
        if (t < n) {
          const T* fy = Fy + t * kFy + py;
          const T* fz = Fz + t * kFz + pz;
          T g = -(fxu[t] - fx[t]) * c.idx;
          g = g - (fy[TZ] - fy[0]) * c.idy;
          g = g - (fz[1] - fz[0]) * c.idz;
          epilogue(t, i, g, cur[t * kPlane + pos]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTG; ++t) fx[t] = fxu[t];
  }
  wait_all();
}

// ---------------------------------------------------------------------------
// Launch geometry
// ---------------------------------------------------------------------------

// Let `kernel` use `bytes` of dynamic shared memory and size its x
// segments: enough blocks (panels x roles x segments) for two waves of the
// card, each segment of at least kMinSeg of the `rows` output x-rows, since
// a segment re-reads its 6 halo planes. Writes the segment length and
// count.
inline cudaError_t plan_segments(const void* kernel, size_t bytes, int rows,
                                 int64_t blocks_per_segment, int* seg_len,
                                 int* nseg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, bytes)) != cudaSuccess) {
    return err;
  }
  const int64_t waves = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  int64_t n = (waves + blocks_per_segment - 1) / blocks_per_segment;
  n = n < rows / kMinSeg ? n : rows / kMinSeg;
  n = n > 1 ? n : 1;
  *seg_len = (int)((rows + n - 1) / n);
  *nseg = (rows + *seg_len - 1) / *seg_len;
  return cudaSuccess;
}

}  // namespace ot_tile
