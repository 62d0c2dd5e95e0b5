// The x-marching tile of the generic momentum advection (Gu, Gv, Gw) =
// -div(v (x) v), with Centered of orders 2..12, UpwindBiased of orders
// 1..11 or WENO-Z of orders 3..11, one scheme on all three axes or a
// FluxFormAdvection of them.
//
// Replaces the TPU kernel of oceananigans_tpu/ops/pallas_generic.py:
//   fused_momentum_tendency (the Pallas kernel that evaluates the whole-array
//   div_vu/div_vv/div_vw on x-windowed slabs) -> generic_march
// The TPU kernel traces the Python advection code into its body; here each
// reconstruction is a type built from the literal tables of linear_tables.h
// (Centered, UpwindBiased) and weno_tables.h (WENO, through vi_tile.h's
// left_side).
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// Output x-rows [h, nx-h) hold the tendencies and the x-halo rows zeros, as
// the TPU wrapper embeds its output (h, the x halo, is at least the largest
// reach B). Every y and z point is computed, with neighbours wrapped modulo
// the full extent, as the plain version's whole-array operators
// (torch.roll) do.
//
// Numerics, for a component c and an axis a: the field of c is
// reconstructed at the flux point (a face of the cell, or the centre
// between two faces along c's own axis) from its taps at offsets -b..b-1
// (b the axis scheme's reach); the advecting velocity there is the average
// of (A_a vel_a) over the two points next to it along c (along a itself
// where a == c), as advection.div_vu/vv/vw interpolate it, and the flux is
// that velocity times the value. G_c = -(((Dx + Dy) + Dz) * (1/V)), D_a the
// upper minus the lower flux.
//
// The march (march.h). A block of (py + 1) x (pz + 1) threads owns a py x
// pz panel of output columns and marches over a segment of the output
// x-rows; the last row and column of threads compute the faces on the
// panel's far side. Each x-plane of u, v and w over the panel and a B-wide
// wrapped y/z halo enters a ring of shared-memory tiles once, ahead of the
// three planes (i-1, i, i+1) that step i reads: each thread stores its own
// column's values from its x-queues (below), and the rest of the tile, the
// halo, comes by cp.async kAhead planes ahead, through a table of its
// offsets made once a block.
// At step i each thread computes the three y-face fluxes below its column
// (Gu's and Gw's at the y-face j, Gv's at the centre j-1) and the three
// z-face fluxes left of it once, into shared memory, and the three x-face
// fluxes above its column (Gu's at the centre i, Gv's and Gw's at the face
// i+1) from register queues of u, v and w along x (planes i+1-B .. i+B,
// the head read a step ahead), carried to the next step as the fluxes
// below. So each face flux is computed once. One barrier a step: step i
// writes its faces, waits for its own copies up to plane i+2 and meets the
// others; a thread past it may run into step i+1 while others still read
// step i's faces, so the face arrays alternate by step, and the plane step
// i+1 copies goes to the slot of plane i-2, which no thread reads any more.
//
// One side, no branch. A biased reconstruction picks its taps by the sign
// of the advecting velocity U (mirrored for U <= 0: the right-biased
// stencil is the left-biased one on reflected taps) and evaluates one side
// on every lane; every value is multiplied by U, so at U == 0 either side
// gives the plain version's 0. WENO weights are formed with reciprocals
// (vi_tile.h's left_side: the ratio capped as the plain version caps it,
// the indicators of orders 7 and up in the plain version's order of
// evaluation, for float32 agreement), not IEEE division, whose slow path
// zero rows took. So the kernel agrees with the plain version to rounding,
// not bit for bit.
//
// Templates. With one scheme on all axes the tile is a template on that
// scheme (Fixed<R>): its registers and shared memory are its own. A
// FluxFormAdvection of different schemes takes the tile templated on the
// largest reach B (ByReach<B>), which sizes the ring, the halo and the
// queues; each axis's reconstruction is picked by its code once a step,
// among the schemes of reach B or less, outside the tap loops, and the
// three faces of an axis go through one loop. Each kind or WENO order is
// compiled in its own translation unit (generic_tile_*.cu), the entry
// points are in generic_momentum.cu.
//
// What bounds it on the H100: operations for WENO (a WENO-5 point does
// ~849 operations with one side a face, against 24 bytes moved in float32),
// bytes for the linear schemes.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "linear_tables.h"
#include "march.h"
#include "vi_tile.h"

namespace ot_generic {

using namespace ot_march;

// scheme codes, as ops/cuda_generic.py encodes them: kind * 16 + order
constexpr int kCentered = 0;
constexpr int kUpwind = 1;
constexpr int kWeno = 2;

__host__ __device__ constexpr int code(int kind, int order) {
  return kind * 16 + order;
}

__host__ __device__ constexpr int reach(int code) {
  return (code % 16 + 1) / 2;
}

constexpr int kAhead = 3;           // planes in flight while step i computes
constexpr int kSlots = kAhead + 3;  // ring planes i-1 .. i+1+kAhead, which
                                    // also keeps plane i+1+kAhead off the
                                    // planes a slower thread still reads

// The left-biased value of a reconstruction from its taps t[0..2B-1] at
// offsets -B..B-1 from the flux point (a symmetric scheme's taps are never
// mirrored).
template <int K>
struct Centered {
  using C = ot_linear::CenteredTable<K>;
  static constexpr int B = C::B, kCode = code(kCentered, K);
  static constexpr bool kSymmetric = true, kHeavy = B >= 5;
  template <typename T>
  __device__ __forceinline__ static T left(const T* t, T) {
    T out = T(C::c(0)) * t[0];
#pragma unroll
    for (int j = 1; j < C::taps; ++j) out = out + T(C::c(j)) * t[j];
    return out;
  }
};

template <int K>
struct Upwind {
  using C = ot_linear::UpwindTable<K>;
  static constexpr int B = C::B, kCode = code(kUpwind, K);
  static constexpr bool kSymmetric = false, kHeavy = B >= 5;
  template <typename T>
  __device__ __forceinline__ static T left(const T* t, T) {
    // offsets -B .. B-2
    T out = T(C::c(0)) * t[0];
#pragma unroll
    for (int j = 1; j < C::taps; ++j) out = out + T(C::c(j)) * t[j];
    return out;
  }
};

template <int K>
struct Weno {
  static constexpr int B = (K + 1) / 2, kCode = code(kWeno, K);
  static constexpr bool kSymmetric = false, kHeavy = K >= 7;
  template <typename T>
  __device__ __forceinline__ static T left(const T* t, T eps) {
    return left_side<K, 0, (K >= 7)>(t, t, t, eps);
  }
};

// U times the value of R at the flux point whose taps start (offset -b) at
// p, stride apart in shared memory.
template <class R, typename T>
__device__ __forceinline__ T face(const T* p, int stride, T U, T eps) {
  constexpr int N = 2 * R::B;
  T t[N];
  taps<N>(p, stride, R::kSymmetric || U > T(0), t);
  return U * R::left(t, eps);
}

// U times the value of R at the flux point whose taps are the middle 2b of
// one of the register queues q0, q1, q2 (c picks it).
template <class R, int NQ, typename T>
__device__ __forceinline__ T face_q(const T (&q0)[NQ], const T (&q1)[NQ],
                                    const T (&q2)[NQ], int c, T U, T eps) {
  constexpr int N = 2 * R::B, o = NQ / 2 - R::B;
  const bool left = R::kSymmetric || U > T(0);
  T t[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int a = o + m, b = o + N - 1 - m;
    const T s = c == 0 ? q0[a] : (c == 1 ? q1[a] : q2[a]);
    const T r = c == 0 ? q0[b] : (c == 1 ? q1[b] : q2[b]);
    t[m] = left ? s : r;
  }
  return U * R::left(t, eps);
}

// One scheme on all three axes: the host picks this instantiation by the
// code, so the code is not read; the three components are unrolled.
template <class R>
struct Fixed {
  static constexpr int B = R::B;
  static constexpr bool kHeavy = R::kHeavy;
  template <class F>
  __device__ __forceinline__ static void with(int, F f) {
    f(R{});
  }
  template <class F>
  __device__ __forceinline__ static void each(F f) {
    f(0);
    f(1);
    f(2);
  }
};

template <class R, int kB, class F>
__device__ __forceinline__ bool try_scheme(int c, F& f) {
  if constexpr (R::B <= kB) {
    if (c == R::kCode) {
      f(R{});
      return true;
    }
  }
  return false;
}

// Every scheme of reach kB or less, picked by its code; the three
// components go through one loop.
template <int kB>
struct ByReach {
  static constexpr int B = kB;
  static constexpr bool kHeavy = kB >= 4;
  template <class F>
  __device__ __forceinline__ static void with(int c, F f) {
    try_scheme<Centered<2>, kB>(c, f) || try_scheme<Centered<4>, kB>(c, f) ||
        try_scheme<Centered<6>, kB>(c, f) ||
        try_scheme<Centered<8>, kB>(c, f) ||
        try_scheme<Centered<10>, kB>(c, f) ||
        try_scheme<Centered<12>, kB>(c, f) ||
        try_scheme<Upwind<1>, kB>(c, f) || try_scheme<Upwind<3>, kB>(c, f) ||
        try_scheme<Upwind<5>, kB>(c, f) || try_scheme<Upwind<7>, kB>(c, f) ||
        try_scheme<Upwind<9>, kB>(c, f) || try_scheme<Upwind<11>, kB>(c, f) ||
        try_scheme<Weno<3>, kB>(c, f) || try_scheme<Weno<5>, kB>(c, f) ||
        try_scheme<Weno<7>, kB>(c, f) || try_scheme<Weno<9>, kB>(c, f) ||
        try_scheme<Weno<11>, kB>(c, f);
  }
  template <class F>
  __device__ __forceinline__ static void each(F f) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) f(c);
  }
};

// float32 takes three blocks an SM (at most 80 registers a thread), two
// (at most 128) for WENO of order 7 and up, the linear schemes of reach 5
// and 6 (whose x-queues hold 30 and 36 values) and mixed schemes of reach
// 4 and up; float64 one
template <typename T, class Sel>
constexpr int kBlocksPerSm = sizeof(T) == 4 ? (Sel::kHeavy ? 2 : 3) : 1;

// The values of a field's tile that no thread owns: B rows above the
// threads' (py + 1) rows, B - 1 below, and B columns left of their (pz + 1)
// columns and B - 1 right, beside their rows.
__host__ __device__ inline int halo_size(int B, int py, int pz) {
  return (2 * B - 1) * (pz + 2 * B + py + 1);
}

// The dynamic shared memory of a block for a py x pz panel and the largest
// reach B: the row offset table, the ring of u, v and w tiles, the face
// arrays (three y and three z, by the step's parity), the column offset
// table and the halo's offsets and tile indices.
template <typename T>
__host__ __device__ size_t tile_bytes(int B, int py, int pz) {
  const int tr = py + 2 * B, tc = pz + 2 * B, nt = (py + 1) * (pz + 1);
  return (size_t)tr * sizeof(int64_t) +
         (size_t)(kSlots * 3 * tr * tc + 12 * nt) * sizeof(T) +
         (size_t)(tc + 6 * halo_size(B, py, pz)) * sizeof(int);
}

template <typename T>
struct Axes {
  int code[3];
  T area[3];  // Ax, Ay, Az
  T eps[3];   // the WENO epsilon of each axis's scheme (unused otherwise)
  T inv_vol;  // 1 / V, rounded to T
};

template <typename T, class Sel>
__global__ void __launch_bounds__(kMaxThreads, (kBlocksPerSm<T, Sel>))
    generic_march(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, T* __restrict__ gu,
                  T* __restrict__ gv, T* __restrict__ gw, int nx, int ny,
                  int nz, int h, Axes<T> S, int py, int pz, int seg_len) {
  constexpr int B = Sel::B, NQ = 2 * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Panel P = panel_of(nx, ny, nz, py, pz, B, B, 1);
  const int tr = P.tr, tc = P.tc, tt = tr * tc, ss = 3 * tt;
  const int nt = (py + 1) * (pz + 1), up = pz + 1;  // thread row stride
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem_raw);
  T* ring = reinterpret_cast<T*>(rowoff + tr);  // [kSlots][u, v, w][tr][tc]
  T* faces = ring + kSlots * ss;  // [2][y, z][3][nt], by the step's parity
  int* coloff = reinterpret_cast<int*>(faces + 12 * nt);
  const int nh1 = halo_size(B, py, pz), nh = 3 * nh1;
  int* hsrc = coloff + tc;                      // [nh]: offset in a plane
  int* hdst = hsrc + nh;                        // [nh]: index in a slot
  P.rowoff = rowoff;
  P.coloff = coloff;
  fill_offsets(P, rowoff, coloff);
  __syncthreads();
  for (int e = threadIdx.x; e < nh; e += blockDim.x) {
    const int f = e / nh1;
    int r = e - f * nh1, row, col;
    if (r < (2 * B - 1) * tc) {  // the rows above and below the threads'
      row = r / tc;
      col = r - row * tc;
      row = row < B ? row : row + py + 1;
    } else {                     // the columns beside them
      r -= (2 * B - 1) * tc;
      row = r / (2 * B - 1);
      col = r - row * (2 * B - 1);
      row += B;
      col = col < B ? col : col + pz + 1;
    }
    hsrc[e] = (int)(rowoff[row] + coloff[col]);
    hdst[e] = f * tt + row * tc + col;
  }
  __syncthreads();

  const Segment S0 = segment_of(blockIdx.z, seg_len, nx - 2 * h);
  const int a = S0.a + h, b = S0.b + h;  // output rows [a, b)
  if (P.mine) {
    for (int r = 0; r < h; ++r) {
      if (blockIdx.z == 0) {
        const int64_t p = (int64_t)r * P.sx + P.col;
        gu[p] = T(0);
        gv[p] = T(0);
        gw[p] = T(0);
      }
      if (blockIdx.z == gridDim.z - 1) {
        const int64_t p = (int64_t)(nx - 1 - r) * P.sx + P.col;
        gu[p] = T(0);
        gv[p] = T(0);
        gw[p] = T(0);
      }
    }
  }
  // ring slot of plane p (planes a-2 .. b)
  auto slot = [&](int p) { return ring + ((p - a + 2) % kSlots) * ss; };
  auto load_halo = [&](int p) {
    T* d = slot(p);
    const int64_t base = (int64_t)p * P.sx;
    const T* const src[3] = {u + base, v + base, w + base};
    for (int e = threadIdx.x; e < nh; e += blockDim.x) {
      copy_async(d + hdst[e],
                 pick(src, (e >= nh1) + (e >= 2 * nh1)) + hsrc[e]);
    }
  };
  const int tid = threadIdx.x;
  const int x = (P.jy + B) * tc + P.kz + B;  // this thread's column in a tile
  const bool ycol = P.kz < pz, zrow = P.jy < py, xcol = ycol && zrow;
  const T half = T(0.5);
  const T Ax = S.area[0], Ay = S.area[1], Az = S.area[2];

  // the x-line queues of this column, planes i+1-B .. i+B at step i: the
  // planes a-B .. a+B-2 now, the head of step a-1 read ahead
  T qu[NQ] = {}, qv[NQ] = {}, qw[NQ] = {};
  // this column's offset in x-plane p (a-B <= p <= nx: the last read
  // ahead, unused, wraps)
  const int64_t colofs = rowoff[P.jy + B] + coloff[P.kz + B];
  auto at = [&](int p) { return (int64_t)(p < nx ? p : p - nx) * P.sx + colofs; };
#pragma unroll
  for (int m = 0; m + 1 < NQ; ++m) {
    const int64_t o = at(a - B + m);
    qu[m + 1] = __ldg(u + o);
    qv[m + 1] = __ldg(v + o);
    qw[m + 1] = __ldg(w + o);
  }
  int64_t o = at(a + B - 1);
  T nu = __ldg(u + o), nv = __ldg(v + o), nw = __ldg(w + o);
  auto store_own = [&](int p, T su, T sv, T sw) {
    T* d = slot(p) + x;
    d[0] = su;
    d[tt] = sv;
    d[2 * tt] = sw;
  };

  // step a-1 computes only the x-face fluxes below plane a; it stores the
  // own values of plane a+1, and step i those of plane i+2
  for (int p = a - 1; p <= a; ++p) {
    o = at(p);
    store_own(p, __ldg(u + o), __ldg(v + o), __ldg(w + o));
    load_halo(p);
  }
  commit();
#pragma unroll
  for (int d = 1; d < kAhead; ++d) {
    if (a + d <= b) load_halo(a + d);
    commit();
  }
  wait_pending<kAhead - 1>();  // planes a-1 and a have landed
  __syncthreads();
  T fx[3] = {T(0), T(0), T(0)};
  for (int i = a - 1; i < b; ++i) {
    // planes i-1, i and i+1 are visible
    if (i + 1 + kAhead <= b) load_halo(i + 1 + kAhead);
    commit();
    push(qu, nu);
    push(qv, nv);
    push(qw, nw);
    o = at(i + 1 + B);
    nu = __ldg(u + o);
    nv = __ldg(v + o);
    nw = __ldg(w + o);
    // plane i+2 is queue index B+1 (the head read ahead when B == 1); its
    // slot held plane i+2-kSlots, which no thread reads any more
    if (i + 2 <= b) {
      if constexpr (B >= 2) {
        store_own(i + 2, qu[B + 1], qv[B + 1], qw[B + 1]);
      } else {
        store_own(i + 2, nu, nv, nw);
      }
    }
    const T* Ti = slot(i);
    const T* Tm = slot(i - 1);
    const T* Tp = slot(i + 1);
    T* Fy = faces + (i & 1) * 6 * nt;  // [3][nt]: y faces
    T* Fz = Fy + 3 * nt;               // [3][nt]: z faces
    if (i >= a && ycol) {
      // the y faces of plane i: Gu's at face j, advected by ℑx(Ay v); Gv's
      // at the centre j-1, by ℑy(Ay v); Gw's at face j, by ℑz(Ay v)
      const T* V = Ti + tt;
      const T vi = Ay * V[x];
      const T Uy[3] = {half * (vi + Ay * (Tm + tt)[x]),
                       half * (vi + Ay * V[x - tc]),
                       half * (vi + Ay * V[x - 1])};
      Sel::with(S.code[1], [&](auto r) {
        using R = decltype(r);
        Sel::each([&](int c) {
          Fy[c * nt + tid] = face<R>(Ti + c * tt + x - R::B * tc, tc,
                                     pick(Uy, c), S.eps[1]);
        });
      });
    }
    if (i >= a && zrow) {
      // the z faces of plane i: Gu's at face k, advected by ℑx(Az w); Gv's
      // at face k, by ℑy(Az w); Gw's at the centre k-1, by ℑz(Az w)
      const T* W = Ti + 2 * tt;
      const T wi = Az * W[x];
      const T Uz[3] = {half * (wi + Az * (Tm + 2 * tt)[x]),
                       half * (wi + Az * W[x - tc]),
                       half * (wi + Az * W[x - 1])};
      Sel::with(S.code[2], [&](auto r) {
        using R = decltype(r);
        Sel::each([&](int c) {
          Fz[c * nt + tid] = face<R>(Ti + c * tt + x - R::B, 1, pick(Uz, c),
                                     S.eps[2]);
        });
      });
    }
    // the x faces above this column: Gu's at the centre i, advected by
    // ℑx(Ax u); Gv's and Gw's at the face i+1, by ℑy(Ax u) and ℑz(Ax u)
    T fxu[3] = {T(0), T(0), T(0)};
    if (xcol) {
      const T ui = Ax * Tp[x];
      const T Ux[3] = {half * (Ax * qu[B] + Ax * qu[B - 1]),
                       half * (ui + Ax * Tp[x - tc]),
                       half * (ui + Ax * Tp[x - 1])};
      Sel::with(S.code[0], [&](auto r) {
        using R = decltype(r);
        Sel::each([&](int c) {
          const T f = face_q<R>(qu, qv, qw, c, pick(Ux, c), S.eps[0]);
#pragma unroll
          for (int q = 0; q < 3; ++q) fxu[q] = q == c ? f : fxu[q];
        });
      });
    }
    wait_pending<kAhead - 1>();  // planes up to i+2 have landed
    __syncthreads();
    if (i >= a && P.mine) {
      const int64_t p = (int64_t)i * P.sx + P.col;
      T* const G[3] = {gu, gv, gw};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* fy = Fy + c * nt + tid;
        const T* fz = Fz + c * nt + tid;
        const T dx = fxu[c] - fx[c];
        const T dy = fy[up] - fy[0];
        const T dz = fz[1] - fz[0];
        G[c][p] = -(((dx + dy) + dz) * S.inv_vol);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) fx[c] = fxu[c];
  }
  wait_all();
}

// Arguments of one launch, as the C entry points take them.
struct GenericArgs {
  const void *u, *v, *w;
  void *gu, *gv, *gw;
  int nx, ny, nz, h;
  int code[3];
  double area[3], vol, eps[3];
  int py, pz, seg_len, nseg;
  void* stream;
};

// Launch the tile of selector Sel. The plan (py, pz, seg_len, nseg) is
// ops/cuda_generic.py: momentum_plan's (ops/march.py: march_plan's for the
// nx - 2h output rows); the kernel refuses one that misses an x-row, an x
// halo short of the reach and a block beyond the shared memory.
template <typename T, class Sel>
int generic_launch(const GenericArgs& A) {
  if (A.h < Sel::B || 2 * A.h >= A.nx ||
      !plan_ok(A.nx - 2 * A.h, A.ny, A.nz, A.py, A.pz, 1, 1, A.seg_len,
               A.nseg, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = tile_bytes<T>(Sel::B, A.py, A.pz);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Axes<T> S{};
  for (int q = 0; q < 3; ++q) {
    S.code[q] = A.code[q];
    S.area[q] = (T)A.area[q];
    S.eps[q] = (T)A.eps[q];
  }
  S.inv_vol = T(1) / (T)A.vol;
  auto kernel = generic_march<T, Sel>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((A.nz + A.pz - 1) / A.pz, (A.ny + A.py - 1) / A.py,
                  (unsigned)A.nseg);
  kernel<<<grid, (A.py + 1) * (A.pz + 1), bytes, (cudaStream_t)A.stream>>>(
      (const T*)A.u, (const T*)A.v, (const T*)A.w, (T*)A.gu, (T*)A.gv,
      (T*)A.gw, A.nx, A.ny, A.nz, A.h, S, A.py, A.pz, A.seg_len);
  return (int)cudaGetLastError();
}

}  // namespace ot_generic

// The instantiations of one translation unit (generic_tile_*.cu), and the
// declarations of generic_momentum.cu.
#define OT_GENERIC_SEL(Sel)                                                \
  template int ot_generic::generic_launch<float, Sel>(                     \
      const ot_generic::GenericArgs&);                                     \
  template int ot_generic::generic_launch<double, Sel>(                    \
      const ot_generic::GenericArgs&);
#define OT_GENERIC_EXTERN(Sel)                                             \
  extern template int ot_generic::generic_launch<float, Sel>(              \
      const ot_generic::GenericArgs&);                                     \
  extern template int ot_generic::generic_launch<double, Sel>(             \
      const ot_generic::GenericArgs&);
