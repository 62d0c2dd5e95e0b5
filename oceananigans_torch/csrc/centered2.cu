// Centered-2 momentum tendency, alone, fused with the quasi-AB2 update, and
// fused with the physics and tracers of the science step.
//
// Replaces the TPU kernels oceananigans_tpu/ops/pallas_kernels.py:
//   centered2_momentum_tendency (_kernel, body _centered2_body)  -> c2_tile
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
// flops on 3 loaded values and 3 stored ones (c2_tendency: 6 fields of
// 67.6 MB at 256^3 in float32, a floor of ~0.12 ms at 3.35 TB/s), or 6
// loaded and 6 stored (c2_ab2): 12 fields, 0.81 GB, a floor of ~0.24 ms.
// c2_science adds f-plane Coriolis, the buoyancy of a BuoyancyTracer and
// the Centered-2 advection of T tracers, and updates all 3 + T fields: at
// 256^3 with T = 2 it moves 4 (3 + T) = 20 fields, 1.35 GB, a floor of
// ~0.40 ms; its ~140 flops per point stay far under the float32 peak.
//
// Design. Kernels 1 and 5 take one thread per output point with z on the
// fastest thread index, so every load and store of a warp is one
// contiguous run; their 18 neighbour reads per point come back through
// L1/L2, and they reach more than half of their bound. Kernel 2, whose
// outputs are half of its bytes, is an x-marching tile (c2_tile, below):
// each input plane enters shared memory once a block, each face flux is
// computed once a point, and no index is divided. The first kernel 2 (one
// thread a point, a 64-bit division and modulo a point, every face flux
// twice) ran at 46% of its bound.
//
// The plain PyTorch version (ops/cuda_kernels.py) evaluates the same
// fluxes with the whole-array operators of advection.py, in another order
// and without FMA contraction, so the two agree to a few ulps of the
// largest tendency, not bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "march.h"

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

// ---------------------------------------------------------------------------
// Kernel 2 as an x-marching tile (march.h). A block of (py + 1) x (pz + 1)
// threads owns a py x pz panel of output columns, one thread a column, and
// marches over a segment of the output x-rows; the last row and column of
// threads compute the faces on the panel's far side. The panel's threads
// come first, row by row, so that with pz = 32 a warp is one row of the
// panel and its loads and stores of a plane are one 128-byte run.
//
// Each x-plane of u, v and w over the panel and a 1-wide wrapped y/z halo
// enters a ring of shared-memory tiles once: every thread reads its own
// column's three values kAhead planes ahead into registers (one coalesced
// load each) and stores them into the tile two steps before they are read;
// the halo row and column (pz + py + 3 values a field) come by cp.async,
// as far ahead, through a table of their offsets made once a block. At step
// i each thread computes:
// - the fluxes that cross x: Fuu at the centre i (u's own, at (c,c,c)),
//   Fuv at (f,f,c) and Fuw at (f,c,f) on the face plane i+1, kept in
//   registers for the next step, where they are the fluxes below; Fuv and
//   Fuw also go to shared memory (by the parity of their plane), where Gu
//   of plane i+1 reads them across y and z;
// - the fluxes of plane i that stay in it: Fvv at the y-centre j-1, Fww at
//   the z-centre k-1 and Fvw at (c,f,f), into shared memory.
// So each face flux is computed once a point (Fuv serves Gu and Gv, Fuw Gu
// and Gw, Fvw Gv and Gw), with the expressions of centered2_point, and no
// index is divided in the march.
// ---------------------------------------------------------------------------

constexpr int kAhead = 1;   // planes loaded ahead of the one being stored
constexpr int kSlots = 4;   // ring planes i .. i+2+kAhead, a power of two
static_assert(kSlots >= kAhead + 3 && (kSlots & (kSlots - 1)) == 0,
              "the ring holds planes i .. i+2+kAhead and is indexed by a "
              "mask");

// float32 takes four blocks an SM (at most 64 registers a thread), float64
// two
template <typename T>
constexpr int kTileMinBlocks = sizeof(T) == 4 ? 4 : 2;

// The dynamic shared memory of a block for a py x pz panel: the row offset
// table, the ring, the seven face arrays (Fuv and Fuw by parity, Fvv, Fww,
// Fvw), the column offset table and the halo's offsets and tile indices.
template <typename T>
__host__ __device__ size_t tile_bytes(int py, int pz) {
  const int tr = py + 2, tc = pz + 2, nt = (py + 1) * (pz + 1);
  const int nh = 3 * (tc + py + 1);
  return (size_t)tr * sizeof(int64_t) +
         (size_t)(kSlots * 3 * tr * tc + 7 * nt) * sizeof(T) +
         (size_t)(tc + 2 * nh) * sizeof(int);
}

// Kernel 2: (Gu, Gv, Gw) on the output x-rows [1, nx-1), by segments of
// seg_len rows (blockIdx.z), and zeros on the x-halo rows 0 and nx-1, as
// the JAX wrapper embeds its result in zeros.
template <typename T>
__global__ void __launch_bounds__(ot_march::kMaxThreads, kTileMinBlocks<T>)
    c2_tile(const T* __restrict__ u, const T* __restrict__ v,
            const T* __restrict__ w, T* __restrict__ gu, T* __restrict__ gv,
            T* __restrict__ gw, int nx, int ny, int nz, T inv_dx, T inv_dy,
            T inv_dz, int py, int pz, int seg_len) {
  using namespace ot_march;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Panel P = panel_of(nx, ny, nz, py, pz, 1, 1, 1);
  // this thread's column: the panel's threads first, then the far row,
  // then the far column
  {
    const int t = threadIdx.x, np = py * pz;
    if (t < np) {
      P.jy = t / pz;
      P.kz = t - P.jy * pz;
    } else if (t <= np + pz) {
      P.jy = py;
      P.kz = t - np;
    } else {
      P.jy = t - np - pz - 1;
      P.kz = pz;
    }
    const int j = P.j0 + P.jy, k = P.k0 + P.kz;
    P.mine = P.jy < py && P.kz < pz && j < ny && k < nz;
    P.col = (int64_t)j * nz + k;
  }
  const int tr = P.tr, tc = P.tc, tt = tr * tc;
  const int nt = (py + 1) * (pz + 1), up = pz + 1;  // face row stride
  const int nh1 = tc + py + 1, nh = 3 * nh1;  // halo values a field, all
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem_raw);
  T* ring = reinterpret_cast<T*>(rowoff + tr);  // [kSlots][u, v, w][tr][tc]
  T* fuv = ring + kSlots * 3 * tt;              // [2][nt]
  T* fuw = fuv + 2 * nt;                        // [2][nt]
  T* fvv = fuw + 2 * nt;                        // [nt]
  T* fww = fvv + nt;                            // [nt]
  T* fvw = fww + nt;                            // [nt]
  int* coloff = reinterpret_cast<int*>(fvw + nt);
  int* hsrc = coloff + tc;                      // [nh]: offset in a plane
  int* hdst = hsrc + nh;                        // [nh]: index in a slot
  P.rowoff = rowoff;
  P.coloff = coloff;
  fill_offsets(P, rowoff, coloff);
  __syncthreads();
  // the halo: tile row 0 (all tc columns) and tile column 0 (rows 1 ..
  // py+1) of u, v and w
  for (int e = threadIdx.x; e < nh; e += blockDim.x) {
    const int f = e / nh1, r = e - f * nh1;
    const int row = r < tc ? 0 : r - tc + 1, col = r < tc ? r : 0;
    hsrc[e] = (int)(rowoff[row] + coloff[col]);
    hdst[e] = f * tt + row * tc + col;
  }
  __syncthreads();

  const Segment S = segment_of(blockIdx.z, seg_len, nx - 2);
  const int a = S.a + 1, b = S.b + 1;  // output rows [a, b)
  if (P.mine && blockIdx.z == 0) {
    gu[P.col] = T(0);
    gv[P.col] = T(0);
    gw[P.col] = T(0);
  }
  if (P.mine && blockIdx.z == gridDim.z - 1) {
    const int64_t p = (int64_t)(nx - 1) * P.sx + P.col;
    gu[p] = T(0);
    gv[p] = T(0);
    gw[p] = T(0);
  }
  const int x = (P.jy + 1) * tc + P.kz + 1;    // this thread's column in a tile
  const int pos = P.jy * up + P.kz;            // and in the face arrays
  const int64_t own = rowoff[P.jy + 1] + coloff[P.kz + 1];
  auto slot = [&](int p) { return ring + (p & (kSlots - 1)) * 3 * tt; };
  auto load_halo = [&](int p) {
    T* d = slot(p);
    const int64_t base = (int64_t)p * P.sx;
    const T* const src[3] = {u + base, v + base, w + base};
    for (int e = threadIdx.x; e < nh; e += blockDim.x) {
      copy_async(d + hdst[e], pick(src, (e >= nh1) + (e >= 2 * nh1)) + hsrc[e]);
    }
  };
  auto store_own = [&](int p, T qu, T qv, T qw) {
    T* d = slot(p) + x;
    d[0] = qu;
    d[tt] = qv;
    d[2 * tt] = qw;
  };
  const T h = T(0.5), q = T(0.25);

  // planes a-1 and a now; the own values of planes a+1 .. a+kAhead into the
  // register queues, their halos in flight (a group each)
  for (int p = a - 1; p <= a; ++p) {
    const int64_t o = (int64_t)p * P.sx + own;
    store_own(p, __ldg(u + o), __ldg(v + o), __ldg(w + o));
    load_halo(p);
  }
  commit();
  T qu[kAhead], qv[kAhead], qw[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    const int p = a + 1 + d;
    if (p <= b) {
      const int64_t o = (int64_t)p * P.sx + own;
      qu[d] = __ldg(u + o);
      qv[d] = __ldg(v + o);
      qw[d] = __ldg(w + o);
      load_halo(p);
    }
    commit();
  }
  wait_pending<kAhead>();  // the halos of planes a-1 and a have landed
  __syncthreads();

  // step a-1 computes only the x-crossing fluxes below plane a
  T fuu_lo = T(0), fuv_lo = T(0), fuw_lo = T(0);
  for (int i = a - 1; i < b; ++i) {
    // planes i and i+1 are in the ring
    const T* U0 = slot(i);
    const T* V0 = U0 + tt;
    const T* W0 = U0 + 2 * tt;
    const T* U1 = slot(i + 1);
    const T* V1 = U1 + tt;
    const T* W1 = U1 + 2 * tt;
    T s = U0[x] + U1[x];
    const T fuu = q * (s * s);
    const T fuv_up = (h * (V0[x] + V1[x])) * (h * (U1[x - tc] + U1[x]));
    const T fuw_up = (h * (W0[x] + W1[x])) * (h * (U1[x - 1] + U1[x]));
    fuv[((i + 1) & 1) * nt + pos] = fuv_up;
    fuw[((i + 1) & 1) * nt + pos] = fuw_up;
    if (i >= a) {
      s = V0[x - tc] + V0[x];
      fvv[pos] = q * (s * s);
      s = W0[x - 1] + W0[x];
      fww[pos] = q * (s * s);
      fvw[pos] = (h * (W0[x - tc] + W0[x])) * (h * (V0[x - 1] + V0[x]));
    }
    __syncthreads();
    if (i >= a && P.mine) {
      const T* fuv_i = fuv + (i & 1) * nt + pos;
      const T* fuw_i = fuw + (i & 1) * nt + pos;
      T g = (-(fuu - fuu_lo)) * inv_dx;
      g = g - (fuv_i[up] - fuv_i[0]) * inv_dy;
      const T Gu = g - (fuw_i[1] - fuw_i[0]) * inv_dz;
      g = (-(fvv[pos + up] - fvv[pos])) * inv_dy;
      g = g - (fuv_up - fuv_lo) * inv_dx;
      const T Gv = g - (fvw[pos + 1] - fvw[pos]) * inv_dz;
      g = (-(fww[pos + 1] - fww[pos])) * inv_dz;
      g = g - (fuw_up - fuw_lo) * inv_dx;
      const T Gw = g - (fvw[pos + up] - fvw[pos]) * inv_dy;
      const int64_t p = (int64_t)i * P.sx + P.col;
      gu[p] = Gu;
      gv[p] = Gv;
      gw[p] = Gw;
    }
    fuu_lo = fuu;
    fuv_lo = fuv_up;
    fuw_lo = fuw_up;
    // plane i+2 into the ring (step i+1 reads planes i+1 and i+2; plane i
    // is read by no thread any more), plane i+2+kAhead into the queues
    if (i + 2 <= b) store_own(i + 2, qu[0], qv[0], qw[0]);
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) {
      qu[d] = qu[d + 1];
      qv[d] = qv[d + 1];
      qw[d] = qw[d + 1];
    }
    const int p = i + 2 + kAhead;
    if (p <= b) {
      const int64_t o = (int64_t)p * P.sx + own;
      qu[kAhead - 1] = __ldg(u + o);
      qv[kAhead - 1] = __ldg(v + o);
      qw[kAhead - 1] = __ldg(w + o);
      load_halo(p);
    }
    commit();
    wait_pending<kAhead>();  // the halo of plane i+2 has landed
    __syncthreads();         // plane i+2 is in the ring; faces are free
  }
  wait_all();
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

// The plan (py, pz, seg_len, nseg) is ops/cuda_kernels.py: tendency_plan's
// (ops/march.py: march_plan's for the nx - 2 output rows); the kernel
// refuses one that misses an x-row.
template <typename T>
int launch_tendency(const void* u, const void* v, const void* w, void* gu,
                    void* gv, void* gw, int nx, int ny, int nz, double idx,
                    double idy, double idz, int py, int pz, int seg_len,
                    int nseg, void* stream) {
  if (!ot_march::plan_ok(nx - 2, ny, nz, py, pz, 1, 1, seg_len, nseg, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = tile_bytes<T>(py, pz);
  if (bytes > ot_march::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = c2_tile<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + pz - 1) / pz, (ny + py - 1) / py, (unsigned)nseg);
  kernel<<<grid, (py + 1) * (pz + 1), bytes, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, nx, ny,
      nz, (T)idx, (T)idy, (T)idz, py, pz, seg_len);
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
                       double idy, double idz, int py, int pz, int seg_len,
                       int nseg, void* stream) {
  return launch_tendency<float>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy,
                                idz, py, pz, seg_len, nseg, stream);
}

int ot_c2_tendency_f64(const void* u, const void* v, const void* w, void* gu,
                       void* gv, void* gw, int nx, int ny, int nz, double idx,
                       double idy, double idz, int py, int pz, int seg_len,
                       int nseg, void* stream) {
  return launch_tendency<double>(u, v, w, gu, gv, gw, nx, ny, nz, idx, idy,
                                 idz, py, pz, seg_len, nseg, stream);
}

// The dynamic shared memory of one block of kernel 2 for a py x pz panel,
// in float32 (itemsize 4) or float64. For reports and checks.
long long ot_c2_tile_smem_bytes(int py, int pz, int itemsize) {
  return (long long)(itemsize == 4 ? tile_bytes<float>(py, pz)
                                   : tile_bytes<double>(py, pz));
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
