// Fused middle stage of the eigenbasis-matmul Poisson solve.
//
// Replaces the TPU kernel oceananigans_tpu/ops/pallas_poisson.py:
//   fused_middle_solve (_kernel) -> poisson_middle_tf32x3 (float32),
//                                   poisson_middle_simt (float64)
//
// Per x-plane M (Ny x Nz) of the x-transformed right-hand side:
//   S  = Ey M                       forward y
//   O  = (S Ez^T) / (lamx_i + lyz)  forward z, then the eigenvalue scale
//   S  = O Ez                       inverse z
//   O  = Ey^T S                     inverse y
// with lyz[b, c] = lamy[b] + lamz[c] summed in double and rounded to the
// field type, and the mode whose eigenvalue sum is exactly 0 (the mean)
// zeroed. The 3-D table of 1/lambda is never stored: each factor is made
// where the forward-z product is stored.
//
// What bounds it on the H100: arithmetic. Four dense products a plane,
// 4 Nx Ny Nz (Ny + Nz) = 34.4 GFLOP at 256^3, and 0.27 GB of plane
// traffic. The JAX kernel runs at Precision.HIGHEST, a multi-pass product
// that keeps float32 accuracy; one TF32 pass keeps about three digits.
//
// Float32 design: the 3xTF32 split on the tensor cores. Each operand value
// x is split into hi = TF32(x) (round to nearest) and lo = TF32(x - hi),
// and each product is formed as lo*hi + hi*lo + hi*hi by wgmma
// (m64n64k8 TF32, both operands from shared memory): 3 x 34.4 GFLOP
// against 495 TFLOP/s is 0.21 ms, under the 0.51 ms of the same products
// in float32 FFMA. The tensor cores' own float32 sums do not round to
// nearest, and carried over all 256 k they cost 1.1e-5 of the largest
// value, so each 32-deep k-slice is summed from zero there and added to
// float32 registers by rounding adds (2.5e-6).
// Staging: one block of four warpgroups (512 threads, 2 x 2 of 64 x 64
// outputs) computes 128 x 128 output tiles; the 32-deep k-slices of all
// the tiles of a product stream through a ring of two raw tiles filled by
// cp.async in the operands' own layouts (16-byte copies where a tile lies
// inside an operand whose rows are 16-byte aligned, zero-filling 4-byte
// copies elsewhere: ragged edges, rows whose length is not a multiple of
// 4). wgmma takes TF32 operands only K-major, so each slice is split, and
// the M/N-contiguous ones (X in the forward-y product, Ey^T in the
// inverse-y one, Ez in the inverse-z one, S in the inverse-y one)
// transposed, into canonical hi and lo tiles without swizzle, in one of
// two buffers while the tensor cores work on the slice before from the
// other. 200 KB of shared memory: one block an SM, so the 256 planes of a
// 256^3 solve take two turns of 132 SMs (a 94% full second turn). A plane
// is 256 KB in float32, more than a block's shared memory, so the
// intermediate planes pass through L2 (a caller-allocated scratch field
// and `out`) between products. What holds it back on the card: the loop
// around the tensor cores (the copies, the split, two barriers and a wait
// for the tensor cores each slice) takes most of its time; the tensor
// cores alone would take 0.21 ms.
//
// Float64 design: a plain shared-memory-tiled FFMA GEMM (64 x 64 output
// tiles, 16-deep k-slices, a 4 x 4 register tile a thread); no timed path
// runs it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Element (r, c) of a strided matrix view sits at p[r * s0 + c * s1].
template <typename T>
struct View {
  const T* p;
  int64_t s0, s1;
};

// ---------------------------------------------------------------------------
// float64: shared-memory-tiled FFMA GEMM
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// C (M x N, row-major) = A (M x K) * B (K x N), optionally scaled by
// 1 / (lamx_i + (lamy[m] + lamz[n])) as it is stored. Every thread of the
// block calls it with the same arguments.
template <typename T, bool kScale>
__device__ void block_gemm(View<T> A, View<T> B, T* C, int M, int N, int K,
                           T lamx_i, const double* lamy, const double* lamz,
                           T (*As)[BM + 1], T (*Bs)[BN + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      T acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
      for (int k0 = 0; k0 < K; k0 += BK) {
        // consecutive threads walk the contiguous index of each operand
        for (int e = tid; e < BM * BK; e += kThreads) {
          const int mm = A.s1 == 1 ? e / BK : e % BM;
          const int kk = A.s1 == 1 ? e % BK : e / BM;
          const int gm = m0 + mm, gk = k0 + kk;
          As[kk][mm] = (gm < M && gk < K) ? A.p[gm * A.s0 + gk * A.s1] : T(0);
        }
        for (int e = tid; e < BK * BN; e += kThreads) {
          const int nn = B.s1 == 1 ? e % BN : e / BK;
          const int kk = B.s1 == 1 ? e / BN : e % BK;
          const int gk = k0 + kk, gn = n0 + nn;
          Bs[kk][nn] = (gk < K && gn < N) ? B.p[gk * B.s0 + gn * B.s1] : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          T a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + ty + 16 * r, n = n0 + tx + 16 * c;
          if (m < M && n < N) {
            T val = acc[r][c];
            if (kScale) {
              const T ls = lamx_i + (T)(lamy[m] + lamz[n]);
              val = val * (ls == T(0) ? T(0) : T(1) / ls);
            }
            C[(int64_t)m * N + n] = val;
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) poisson_middle_simt(
    const T* x, T* out, T* scratch, const T* Ey, const T* Ez, const T* lamx,
    const double* lamy, const double* lamz, int Nx, int Ny, int Nz) {
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN + 1];
  const int64_t plane = (int64_t)Ny * Nz;
  for (int i = blockIdx.x; i < Nx; i += gridDim.x) {
    const T* X = x + i * plane;
    T* S = scratch + i * plane;
    T* O = out + i * plane;
    // forward y: S = Ey X
    block_gemm<T, false>({Ey, Ny, 1}, {X, Nz, 1}, S, Ny, Nz, Ny, T(0),
                         lamy, lamz, As, Bs);
    __syncthreads();
    // forward z and scale: O = (S Ez^T) / lambda, Ez^T(k, n) = Ez[n, k]
    block_gemm<T, true>({S, Nz, 1}, {Ez, 1, Nz}, O, Ny, Nz, Nz, lamx[i],
                        lamy, lamz, As, Bs);
    __syncthreads();
    // inverse z: S = O Ez
    block_gemm<T, false>({O, Nz, 1}, {Ez, Nz, 1}, S, Ny, Nz, Nz, T(0),
                         lamy, lamz, As, Bs);
    __syncthreads();
    // inverse y: O = Ey^T S, Ey^T(m, k) = Ey[k, m]
    block_gemm<T, false>({Ey, 1, Ny}, {S, Nz, 1}, O, Ny, Nz, Ny, T(0),
                         lamy, lamz, As, Bs);
    __syncthreads();
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

// A block of kWgM x kWgN warpgroups, each computing 64 x 64 outputs with
// wgmma.m64n64k8, computes BM x BN output tiles. The BK-deep k-slices of
// all the tiles of a product stream through a ring of kStages raw tiles
// (cp.async, the operands' own layouts); each slice is split into the hi
// and lo TF32 tiles of both operands, K-major in wgmma's canonical layout
// without swizzle, in one of two buffers, while the tensor cores work on
// the previous slice from the other. The tensor cores' partial sums are
// flushed into the float32 accumulators once a slice.
constexpr int kWgM = 2, kWgN = 2;
constexpr int BM = 64 * kWgM, BN = 64 * kWgN, BK = 32, kStages = 2;
constexpr int kThreads = 128 * kWgM * kWgN, kBlocksPerSM = 1;
constexpr int kAcc = 32;  // accumulator registers a thread (m64n64)
// row lengths of a raw tile: K-contiguous (BM or BN rows of BK) and
// M/N-contiguous (BK rows of BM or BN), padded against bank conflicts
constexpr int kRowK = BK + 4;
__host__ __device__ constexpr int row_mn(int rows) { return rows + 8; }
constexpr int raw_floats(int rows) {
  return rows * kRowK > BK * row_mn(rows) ? rows * kRowK
                                          : BK * row_mn(rows);
}
constexpr int kRawA = raw_floats(BM), kRawB = raw_floats(BN);
constexpr int kRaw = kRawA + kRawB;  // one raw stage
constexpr int kCanonA = BM * BK, kCanonB = BN * BK;
constexpr int kCanon = 2 * (kCanonA + kCanonB);  // A hi, A lo, B hi, B lo
// [canonical buffer 0][canonical buffer 1][raw ring], 1024-byte aligned
constexpr int kSmemBytes =
    (2 * kCanon + kStages * kRaw) * (int)sizeof(float) + 1024;
static_assert((kCanonA * 4) % 1024 == 0 && (kCanonB * 4) % 1024 == 0,
              "canonical tiles stay 1024-byte aligned");
static_assert(kRowK % 4 == 0 && kRawA % 4 == 0 && kRaw % 4 == 0,
              "16-byte copies need 16-byte aligned rows");
static_assert(kRowK % 32 == 4 && row_mn(BM) % 32 == 8 &&
                  row_mn(BN) % 32 == 8,
              "raw rows read without bank conflicts");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Copy the run p[0..3] of a row into dst[0..3], zero-filling the elements
// at and beyond `valid`: one 16-byte copy where all four are in range and
// the source is 16-byte aligned, else four 4-byte copies.
__device__ __forceinline__ void copy4(float* dst, const float* p, int valid) {
  if (valid >= 4 && ((uintptr_t)p & 15) == 0) {
    copy16(dst, p);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int bytes = e < valid ? 4 : 0;
    // a zero-byte copy reads nothing; its source stays a valid address
    const float* src = e < valid ? p + e : p;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + e)),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// One operand in device memory. kT = false: element (r, c) of the logical
// matrix at p[r * ld + c] (its second index contiguous); kT = true: at
// p[c * ld + r] (its first index contiguous).
struct Mat {
  const float* p;
  int64_t ld;
};

// This thread's share of staging and splitting the kRows x BK block of
// an operand (rows r, columns k) held with layout kT: the 16-byte runs it
// copies into the raw tile (kRows * BK / 4 runs, kRuns a thread) and the
// runs of 4 k of one row it splits into the canonical tiles.
template <bool kT, int kRows>
struct Share {
  static constexpr int kRuns = kRows * BK / 4 / kThreads;
  static_assert(kRows * BK / 4 % kThreads == 0, "whole runs a thread");
  int src[kRuns];  // offset of the run in the operand, from (r0, c0)
  int raw[kRuns];  // its offset in the raw tile
  int row[kRuns], col[kRuns];  // its first (r, k) in the block
  int from[kRuns];             // the split run's offset in the raw tile
  int to[kRuns];               // and in the canonical tiles

  __device__ __forceinline__ Share(int64_t ld) {
#pragma unroll
    for (int it = 0; it < kRuns; ++it) {
      const int q = threadIdx.x + it * kThreads;
      if (!kT) {  // runs along k
        row[it] = q / (BK / 4);
        col[it] = q % (BK / 4) * 4;
        raw[it] = row[it] * kRowK + col[it];
        src[it] = (int)(row[it] * ld + col[it]);
      } else {  // runs along the rows
        col[it] = q / (kRows / 4);
        row[it] = q % (kRows / 4) * 4;
        raw[it] = col[it] * row_mn(kRows) + row[it];
        src[it] = (int)(col[it] * ld + row[it]);
      }
      // the split: consecutive threads take consecutive rows, whose runs
      // are 16 contiguous bytes apart in the canonical tile
      const int r = q % kRows, k = q / kRows * 4;
      from[it] = kT ? k * row_mn(kRows) + r : r * kRowK + k;
      to[it] = (k >> 2) * (kRows * 4) + 4 * r;
    }
  }

  // Copy the block at (r0, c0) of the R x C operand m into dst; kFull:
  // the block lies inside the operand and every run is 16-byte aligned.
  template <bool kFull>
  __device__ __forceinline__ void stage(float* dst, Mat m, int r0, int c0,
                                        int R, int C) const {
    const float* base = m.p + (kT ? c0 * m.ld + r0 : r0 * m.ld + c0);
#pragma unroll
    for (int it = 0; it < kRuns; ++it) {
      if (kFull) {
        copy16(dst + raw[it], base + src[it]);
      } else {
        const int gr = r0 + row[it], gc = c0 + col[it];
        const int valid = kT ? (gc < C ? min(max(R - gr, 0), 4) : 0)
                             : (gr < R ? min(max(C - gc, 0), 4) : 0);
        copy4(dst + raw[it], valid ? base + src[it] : m.p, valid);
      }
    }
  }

  // hi = TF32(x), lo = TF32(x - hi) of the raw tile into the canonical
  // tiles
  __device__ __forceinline__ void split(const float* raw_tile, float* hi,
                                        float* lo) const {
#pragma unroll
    for (int it = 0; it < kRuns; ++it) {
      float4 x;
      if (!kT) {
        x = *reinterpret_cast<const float4*>(raw_tile + from[it]);
      } else {
        const float* c = raw_tile + from[it];
        x = make_float4(c[0], c[row_mn(kRows)], c[2 * row_mn(kRows)],
                        c[3 * row_mn(kRows)]);
      }
      const float4 h = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z),
                                   to_tf32(x.w));
      const float4 l = make_float4(to_tf32(x.x - h.x), to_tf32(x.y - h.y),
                                   to_tf32(x.z - h.z), to_tf32(x.w - h.w));
      *reinterpret_cast<float4*>(hi + to[it]) = h;
      *reinterpret_cast<float4*>(lo + to[it]) = l;
    }
  }
};

// Shared-memory matrix descriptor of a canonical K-major tile without
// swizzle: start address, leading byte offset (between core matrices of
// 8 rows x 16 bytes along k), stride byte offset (between core matrices
// along the rows: 128), each in units of 16 bytes.
__device__ __forceinline__ uint64_t descriptor(const float* p,
                                               uint32_t lead_bytes) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d = A B (accumulate = 0) or d += A B for the warpgroup's 64 x 8 A and
// 8 x 64 B
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t a,
                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait(float (&d)[kAcc]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // the accumulators are read only after the wait
#pragma unroll
  for (int e = 0; e < kAcc; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// C (M x N, row-major) = A (M x K) * B (K x N) in 3xTF32, optionally scaled
// by 1 / (lamx_i + (float)(lamy[m] + lamz[n])) (0 where that sum is 0) as
// it is stored. kAT / kBT: the operands' layouts (see Mat). Every thread of
// the block calls it with the same arguments.
template <bool kAT, bool kBT, bool kScale>
__device__ void block_gemm(Mat A, Mat B, float* C, int M, int N, int K,
                           float lamx_i, const double* lamy,
                           const double* lamz, float* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wgm = warp / 4 / kWgN, wgn = warp / 4 % kWgN;  // warpgroup
  const int wrow = wgm * 64 + (warp % 4) * 16;  // this warp's 16 rows
  const int nk = (K + BK - 1) / BK, tiles_n = (N + BN - 1) / BN;
  const int total = (M + BM - 1) / BM * tiles_n * nk;
  // B enters as its transpose Bt (N x K, Bt(n, k) = B(k, n)), whose layout
  // flag is the opposite of B's
  const Share<kAT, BM> sa(A.ld);
  const Share<!kBT, BN> sb(B.ld);
  const bool full = M % BM == 0 && N % BN == 0 && K % BK == 0 &&
                    A.ld % 4 == 0 && B.ld % 4 == 0 &&
                    ((uintptr_t)A.p & 15) == 0 && ((uintptr_t)B.p & 15) == 0;
  auto canon = [&](int buf, int part) {  // 0 A hi, 1 A lo, 2 B hi, 3 B lo
    return smem + buf * kCanon +
           (part < 2 ? part * kCanonA : 2 * kCanonA + (part - 2) * kCanonB);
  };
  auto raw = [&](int s) { return smem + 2 * kCanon + s * kRaw; };
  auto issue = [&](int idx) {
    if (idx < total) {
      const int tile = idx / nk, s = idx % kStages, k0 = idx % nk * BK;
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      if (full) {
        sa.template stage<true>(raw(s), A, m0, k0, M, K);
        sb.template stage<true>(raw(s) + kRawA, B, n0, k0, N, K);
      } else {
        sa.template stage<false>(raw(s), A, m0, k0, M, K);
        sb.template stage<false>(raw(s) + kRawA, B, n0, k0, N, K);
      }
    }
    commit();
  };
  auto split = [&](int idx) {
    const int s = idx % kStages, buf = idx & 1;
    sa.split(raw(s), canon(buf, 0), canon(buf, 1));
    sb.split(raw(s) + kRawA, canon(buf, 2), canon(buf, 3));
    // the split tiles, written by the threads, are read by wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // slices 0 .. kStages - 1 in flight, slice 0 split
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  wait_groups<kStages - 2>();  // this thread's copies of slice 0
  __syncthreads();             // and every thread's have landed
  split(0);
  __syncthreads();
  issue(kStages - 1);
  float acc[kAcc], d[kAcc];
  for (int idx = 0; idx < total; ++idx) {
    const int kt = idx % nk, buf = idx & 1;
    if (kt == 0) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    }
    // the products of slice idx on the tensor cores ...
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      const int ao = (ks >> 2) * (BM * 4) + wgm * 64 * 4;
      const int bo = (ks >> 2) * (BN * 4) + wgn * 64 * 4;
      const uint64_t ah = descriptor(canon(buf, 0) + ao, BM * 16);
      const uint64_t al = descriptor(canon(buf, 1) + ao, BM * 16);
      const uint64_t bh = descriptor(canon(buf, 2) + bo, BN * 16);
      const uint64_t bl = descriptor(canon(buf, 3) + bo, BN * 16);
      wgmma(d, al, bh, ks != 0);
      wgmma(d, ah, bl, 1);
      wgmma(d, ah, bh, 1);
    }
    wgmma_commit();
    // ... while slice idx + 1 is split into the other buffer
    if (idx + 1 < total) {
      wait_groups<kStages - 2>();  // this thread's copies of slice idx + 1
      __syncthreads();             // and every thread's have landed
      split(idx + 1);
    }
    // the tensor cores add in float32 without rounding to nearest, an error
    // that grows with the number of terms (1.1e-5 of the largest value when
    // all 256 k of a 256^3 product are summed there): each slice is summed
    // from zero there and added to the accumulators by rounding FADDs
    wgmma_wait(d);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] += d[e];
    if (kt == nk - 1) {
      // accumulator 4j + e of this thread sits at row g (+8 for e >= 2),
      // column 8j + 2t (+1 for odd e) of its warp's 16 x 64 block
      const int tile = idx / nk;
      const int m0 = tile / tiles_n * BM,
                n0 = tile % tiles_n * BN + wgn * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wrow + g + (e >= 2 ? 8 : 0);
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) {
            float val = acc[4 * j + e];
            if (kScale) {
              const float ls = lamx_i + (float)(lamy[m] + lamz[n]);
              val = val * (ls == 0.f ? 0.f : 1.f / ls);
            }
            C[(int64_t)m * N + n] = val;
          }
        }
      }
    }
    // slice idx + 1 is split for every thread, the buffer of slice idx and
    // the raw stage of slice idx + 1 are free
    __syncthreads();
    issue(idx + kStages);
  }
  wait_groups<0>();
  __syncthreads();  // every thread is done with the ring
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) poisson_middle_tf32x3(
    const float* x, float* out, float* scratch, const float* Ey,
    const float* Ez, const float* lamx, const double* lamy,
    const double* lamz, int Nx, int Ny, int Nz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the canonical tiles start on a 1024-byte boundary
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int64_t plane = (int64_t)Ny * Nz;
  for (int i = blockIdx.x; i < Nx; i += gridDim.x) {
    const float* X = x + i * plane;
    float* S = scratch + i * plane;
    float* O = out + i * plane;
    // forward y: S = Ey X
    block_gemm<false, false, false>({Ey, Ny}, {X, Nz}, S, Ny, Nz, Ny, 0.f,
                                    lamy, lamz, smem);
    // forward z and scale: O = (S Ez^T) / lambda; Ez^T(k, n) = Ez[n, k]
    block_gemm<false, true, true>({S, Nz}, {Ez, Nz}, O, Ny, Nz, Nz, lamx[i],
                                  lamy, lamz, smem);
    // inverse z: S = O Ez
    block_gemm<false, false, false>({O, Nz}, {Ez, Nz}, S, Ny, Nz, Nz, 0.f,
                                    lamy, lamz, smem);
    // inverse y: O = Ey^T S; Ey^T(m, k) = Ey[k, m]
    block_gemm<true, false, false>({Ey, Ny}, {S, Nz}, O, Ny, Nz, Ny, 0.f,
                                   lamy, lamz, smem);
  }
}

}  // namespace tc

int launch_f32(const void* x, void* out, void* scratch, const void* Ey,
               const void* Ez, const void* lamx, const void* lamy,
               const void* lamz, int Nx, int Ny, int Nz, void* stream) {
  if ((int64_t)Nx * Ny * Nz == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      tc::poisson_middle_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  tc::poisson_middle_tf32x3<<<Nx, tc::kThreads, tc::kSmemBytes,
                              (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (float*)scratch, (const float*)Ey,
      (const float*)Ez, (const float*)lamx, (const double*)lamy,
      (const double*)lamz, Nx, Ny, Nz);
  return (int)cudaGetLastError();
}

int launch_f64(const void* x, void* out, void* scratch, const void* Ey,
               const void* Ez, const void* lamx, const void* lamy,
               const void* lamz, int Nx, int Ny, int Nz, void* stream) {
  if ((int64_t)Nx * Ny * Nz == 0) return 0;
  simt::poisson_middle_simt<double>
      <<<Nx, simt::kThreads, 0, (cudaStream_t)stream>>>(
          (const double*)x, (double*)out, (double*)scratch,
          (const double*)Ey, (const double*)Ez, (const double*)lamx,
          (const double*)lamy, (const double*)lamz, Nx, Ny, Nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ot_poisson_middle_f32(const void* x, void* out, void* scratch,
                          const void* Ey, const void* Ez, const void* lamx,
                          const void* lamy, const void* lamz, int Nx, int Ny,
                          int Nz, void* stream) {
  return launch_f32(x, out, scratch, Ey, Ez, lamx, lamy, lamz, Nx, Ny, Nz,
                    stream);
}

int ot_poisson_middle_f64(const void* x, void* out, void* scratch,
                          const void* Ey, const void* Ez, const void* lamx,
                          const void* lamy, const void* lamz, int Nx, int Ny,
                          int Nz, void* stream) {
  return launch_f64(x, out, scratch, Ey, Ez, lamx, lamy, lamz, Nx, Ny, Nz,
                    stream);
}

}  // extern "C"
