// The machinery of the x-marching tiles: a block owns a panel of (y, z)
// output columns and marches along x over one segment of x-rows, copying
// each x-plane of its fields over the panel and a wrapped y/z halo into
// shared memory once, by cp.async, through per-block tables of wrapped
// offsets (no division in the march). Used by the vector-invariant and
// WENO tracer tiles (vi_tile.h), the Centered-2 tendency tile
// (centered2.cu) and the generic momentum tile (generic_tile.h).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "weno5_tile.h"

namespace ot_march {

using ot_tile::commit;
using ot_tile::copy_async;
using ot_tile::pick;
using ot_tile::rcp;
using ot_tile::wait_all;
using ot_tile::wrap;

constexpr int kMaxThreads = 256;
// the largest dynamic shared memory of a block on the H100
constexpr size_t kMaxSmem = 232448;

// cp.async.wait_group N: all but the N most recent groups have landed
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The taps s[0..N-1] as they are (left) or reflected (n -> N-1-n).
template <int N, typename T>
__device__ __forceinline__ void mirror(const T (&s)[N], bool left,
                                       T (&t)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) t[m] = left ? s[m] : s[N - 1 - m];
}

// N taps from shared memory at p, p + stride, ..., or reflected.
template <int N, typename T>
__device__ __forceinline__ void taps(const T* p, int stride, bool left,
                                     T (&t)[N]) {
  const T* q = left ? p : p + (N - 1) * stride;
  const int s = left ? stride : -stride;
#pragma unroll
  for (int m = 0; m < N; ++m) t[m] = q[m * s];
}

// Shift a register queue down by one and append x.
template <int N, typename T>
__device__ __forceinline__ void push(T (&q)[N], T x) {
#pragma unroll
  for (int m = 0; m + 1 < N; ++m) q[m] = q[m + 1];
  q[N - 1] = x;
}

// The block's panel, its tiles' wrapped offsets and this thread's column.
// Ring tiles cover rows j0-hy .. j0+py+hy-1 and columns k0-hz ..
// k0+pz+hz-1. The block has (py + ey) x (pz + ez) threads: the ey rows
// and ez columns beyond the panel compute the faces on its far side (one
// face a thread) and own no point; threads whose column lies beyond (ny,
// nz) load and compute like the others (their indices wrap) but write
// nothing.
struct Panel {
  int py, pz, hy, hz, tr, tc;  // panel, halo, tile rows and columns
  int j0, k0;                  // the panel's first row and column
  int jy, kz;                  // this thread's column in the panel
  bool mine;                   // the column is a point of the field
  int nx, ny, nz;
  int64_t sx;                  // x stride
  int64_t col;                 // the column's offset in an x-plane
  const int64_t* rowoff;       // [tr]: wrapped row * nz
  const int* coloff;           // [tc]: wrapped column
};

__device__ __forceinline__ Panel panel_of(int nx, int ny, int nz, int py,
                                          int pz, int hy, int hz, int ez) {
  Panel P;
  P.py = py;
  P.pz = pz;
  P.hy = hy;
  P.hz = hz;
  P.tr = py + 2 * hy;
  P.tc = pz + 2 * hz;
  P.jy = threadIdx.x / (pz + ez);
  P.kz = threadIdx.x - P.jy * (pz + ez);
  P.j0 = blockIdx.y * py;
  P.k0 = blockIdx.x * pz;
  const int j = P.j0 + P.jy, k = P.k0 + P.kz;
  P.mine = P.jy < py && P.kz < pz && j < ny && k < nz;
  P.nx = nx;
  P.ny = ny;
  P.nz = nz;
  P.sx = (int64_t)ny * nz;
  P.col = (int64_t)j * nz + k;
  return P;
}

// Fill the panel's wrapped offset tables (not synchronised).
__device__ __forceinline__ void fill_offsets(const Panel& P, int64_t* rowoff,
                                             int* coloff) {
  for (int e = threadIdx.x; e < P.tr + P.tc; e += blockDim.x) {
    if (e < P.tr) {
      rowoff[e] = (int64_t)wrap(P.j0 - P.hy + e, P.ny) * P.nz;
    } else {
      coloff[e - P.tr] = wrap(P.k0 - P.hz + e - P.tr, P.nz);
    }
  }
}

// off[e]: the offset in an x-plane of element e of the tile of rows r0 ..
// r0+nr-1 and columns c0 .. c0+nc-1, laid out [nr][nc], taken once a
// block (not synchronised; the plan keeps ny * nz below 2^31).
__device__ __forceinline__ void fill_tile_offsets(int* off, const Panel& P,
                                                  int r0, int nr, int c0,
                                                  int nc) {
  for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
    const int r = e / nc, c = e - r * nc;
    off[e] = (int)(P.rowoff[r0 + r] + P.coloff[c0 + c]);
  }
}

// Copy the n elements of a tile whose offsets are off from the x-plane at
// src (a field's plane) into dst.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          const int* off, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    copy_async(dst + e, src + off[e]);
  }
}

// The value at (x-plane p, this thread's column + row dr) of f.
template <typename T>
__device__ __forceinline__ T own(const T* __restrict__ f, const Panel& P,
                                 int p, int dr) {
  return __ldg(f + wrap(p, P.nx) * P.sx + P.rowoff[P.jy + P.hy + dr] +
               P.coloff[P.kz + P.hz]);
}

// The x-rows [a, b) of segment seg of the plan.
struct Segment {
  int a, b;
};

__device__ __forceinline__ Segment segment_of(int seg, int seg_len, int nx) {
  const int a = seg * seg_len;
  return Segment{a, min(a + seg_len, nx)};
}

// Whether (py, pz, seg_len, nseg) is a plan of ops/march.py:
// march_plan's form for an (nx, ny, nz) field: panels whose blocks, with
// ey more rows and ez more columns of threads, have at most kMaxThreads
// threads, nseg segments of seg_len x-rows that cover the nx rows, the
// last one not empty.
inline bool plan_ok(int nx, int ny, int nz, int py, int pz, int ey, int ez,
                    int seg_len, int nseg, int roles) {
  if (nx < 1 || ny < 1 || nz < 1 || py < 1 || pz < 1 ||
      (py + ey) * (pz + ez) > kMaxThreads || seg_len < 1 || nseg < 1) {
    return false;
  }
  if ((int64_t)(nseg - 1) * seg_len >= nx || (int64_t)nseg * seg_len < nx ||
      (int64_t)ny * nz >= (1LL << 31)) {
    return false;
  }
  return (ny + py - 1) / py <= 65535 && (int64_t)nseg * roles <= 65535;
}

}  // namespace ot_march
