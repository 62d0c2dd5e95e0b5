// The WENO-5 science step (momentum, f-plane Coriolis, buoyancy, tracers
// and the quasi-AB2 update in one pass), the WENO-5 momentum AB2 step (the
// same without Coriolis, buoyancy and tracers) and the WENO-5 tracer
// tendencies, as x-marching tiles that compute each face flux once.
//
// Replaces the TPU kernels of oceananigans_tpu/ops/pallas_weno.py:
//   weno5_science_ab2_update (_weno_science_kernel) -> weno5_science_tile
//   weno5_ab2_update (_weno_ab2_pipelined_kernel)
//                                  -> weno5_science_tile<T, false>
//   weno5_tracer_tendencies  (_tracer_kernel)       -> weno5_tracer_tile
//
// Output x-rows are [3, nx-3). weno5_tracer_tile zeroes the other x-rows of
// its outputs, as the JAX wrapper embeds its result in zeros;
// weno5_science_tile writes each G over G_prev in place (a thread reads
// G_prev only at its own point) and leaves G's x-halo rows as they were,
// and writes q' = q + ca*G + cb*G_prev to a new buffer whose x-halo rows are
// copies of q's.
//
// What bounds them on the H100. The science step at 256^3 with two
// tracers moves 20 fields (u, v, w and the tracers read, G_prev read, G
// and q' written): 0.41 ms at 3.35 TB/s; its arithmetic, 849 operations a
// point of momentum and 273 a point of each tracer with one WENO side a
// face, 0.36 ms at the 67 TFLOP/s FFMA peak. The momentum AB2 step moves
// 12 fields, 0.25 ms, against 0.22 ms of arithmetic. The tracer
// tendencies move 3 + 2T fields, 0.14 ms at T = 2, against 0.14 ms of
// arithmetic. All sit near the line; the old one-thread-a-point kernels
// were held far from it by arithmetic: every face twice, both WENO sides,
// IEEE division.
//
// Design: the marches of weno5_tile.h, with each block in one role.
// - A momentum block is weno5_tile's march (u, v, w in the ring) with an
//   epilogue that adds f-plane Coriolis (v at planes i-1, i and rows j,
//   j+1; u at planes i, i+1 and rows j-1, j: all in the ring), the
//   buoyancy ℑzᶠ(b) (b at columns k-1, k, read from device memory) and
//   the AB2 update of u, v, w.
// - A tracer block marches kTG = 2 tracers: their rings hold the taps,
//   and of the velocities only the panel's faces (v and w of plane i, u
//   of plane i+1) are copied, one step ahead, into a double buffer, since
//   a tracer is advected by the unaveraged face velocities. In the science
//   step its epilogue is the tracers' AB2 update.
// A launch of the science step holds one momentum block and ceil(T / 2)
// tracer blocks for each panel and x-segment (blockIdx.z = segment x
// roles + role, so the roles of one panel run side by side and share u, v
// and w in L2). The momentum AB2 step is the instantiation without
// physics (kScience = false): momentum blocks only, with no Coriolis or
// buoyancy code and no tracer role. The tracer tendencies launch tracer
// blocks only.
//
// Why roles rather than one block that carries all 3 + T rings: a ring of
// 8 planes of 22 x 38 points is 26.75 KB a field in float32, so 3 + T rings
// are 134 KB at T = 2 (one block an SM) and do not fit a block's 227 KB
// beyond T = 4. Split by role, a block needs at most the momentum march's
// 93 KB (a tracer block 75 KB) at every T from 0 to 8, two blocks an SM
// in float32, and each field's ring is still filled once a segment. The
// price is that each tracer block copies the panel's face velocities
// again (one field's worth of bytes for each pair of tracers) and the
// momentum block reads b's two columns from device memory.
//
// The plain PyTorch versions (ops/cuda_weno.py) multiply by face areas and
// divide by volumes where these kernels multiply by 1/spacing, so the two
// agree to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "weno5_tile.h"

namespace {

using namespace ot_tile;

// must equal MAX_TRACERS in ops/cuda_kernels.py
constexpr int kMaxTracers = 8;

// float32 takes two blocks an SM (at most 64 registers a thread), float64
// one (its momentum ring is 187 KB)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

// Tracer pointers, passed by value.
template <typename T>
struct Tracers {
  const T* c[kMaxTracers];  // tracers
  T* g[kMaxTracers];        // tendencies (over the previous ones in the step)
  T* cn[kMaxTracers];       // updated tracers (the step only)
  int n;
};

// The pointers of the tracers [t0, t0 + kTG) of a tracer block, the last
// repeated past tr.n, and how many of them are real.
template <typename T>
struct Group {
  const T* c[kTG];
  T* g[kTG];
  T* cn[kTG];
  int n;
};

template <typename T>
__device__ __forceinline__ Group<T> group_of(const Tracers<T>& tr, int t0) {
  Group<T> G;
  G.n = min(kTG, tr.n - t0);
#pragma unroll
  for (int t = 0; t < kTG; ++t) {
    const int q = min(t0 + t, tr.n - 1);
    G.c[t] = pick(tr.c, q);
    G.g[t] = pick(tr.g, q);
    G.cn[t] = pick(tr.cn, q);
  }
  return G;
}

// Kernel 9: the tendencies of the tracer block's tracers on x-rows
// [3, nx-3) of its panel over its x-segment (blockIdx.z = segment x groups
// + group); the first and last segments zero the x-halo rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) weno5_tracer_tile(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    Tracers<T> tr, int nx, int ny, int nz, int seg_len, int groups,
    Coefs<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Panel P = panel_of(ny, nz);
  const int seg = blockIdx.z / groups, nseg = gridDim.z / groups;
  const Group<T> G = group_of(tr, (blockIdx.z % groups) * kTG);
  halo_rows(P, nx, seg, nseg, [&](int64_t p) {
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      if (t < G.n) G.g[t][p] = T(0);
    }
  });
  tracer_march(u, v, w, G.c, G.n, nx, seg, seg_len, P, c, smem_raw,
               [&](int t, int i, T g, T) { G.g[t][i * P.sx + P.col] = g; });
}

// Kernels 8 and 6: role 0 (blockIdx.z % roles) is the momentum block,
// role r > 0 the tracer block of tracers [2(r-1), 2r); each updates its
// fields on x-rows [3, nx-3) of its panel over its x-segment, and the first
// and last segments copy the x-halo rows of q into q'. With kScience,
// momentum takes f-plane Coriolis (f != 0) and the buoyancy of tracer
// b_idx (>= 0); without (kernel 6), roles is 1 and f, b_idx and tr are
// not read.
template <typename T, bool kScience>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) weno5_science_tile(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
    T* __restrict__ gu, T* __restrict__ gv, T* __restrict__ gw,
    T* __restrict__ un, T* __restrict__ vn, T* __restrict__ wn,
    Tracers<T> tr, int nx, int ny, int nz, int seg_len, int roles,
    Coefs<T> c, T ca, T cb, T f, int b_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Panel P = panel_of(ny, nz);
  const int seg = blockIdx.z / roles, role = blockIdx.z % roles;
  const int nseg = gridDim.z / roles;

  if (!kScience || role == 0) {
    halo_rows(P, nx, seg, nseg, [&](int64_t p) {
      un[p] = u[p];
      vn[p] = v[p];
      wn[p] = w[p];
    });
    const T* bf = kScience && b_idx >= 0 ? pick(tr.c, b_idx) : nullptr;
    // the offset of column k-1 (wrapped) from column k
    const int k = P.k0 + P.kz;
    const int64_t dkm = k == 0 ? nz - 1 : -1;
    T* ring = reinterpret_cast<T*>(smem_raw);
    momentum_march(u, v, w, nx, seg, seg_len, P, c, smem_raw,
                   [&](int i, const T (&g)[3]) {
      const T h = T(0.5);
      const int pos = P.pos;
      const T* cur = momentum_slot(ring, i);
      T a = g[0], b = g[1], d = g[2];
      if (kScience && f != T(0)) {
        // f-plane: Gu += f ℑxᶠ(ℑyᶜ v), Gv -= f ℑyᶠ(ℑxᶜ u)
        const T* prev = momentum_slot(ring, i - 1) + kPlane;  // v
        const T* vc = cur + kPlane;
        const T vv0 = h * (prev[pos] + prev[pos + kTC]);
        const T vv1 = h * (vc[pos] + vc[pos + kTC]);
        a = a + f * h * (vv0 + vv1);
        const T* next = momentum_slot(ring, i + 1);           // u
        const T uu0 = h * (cur[pos - kTC] + next[pos - kTC]);
        const T uu1 = h * (cur[pos] + next[pos]);
        b = b - f * h * (uu0 + uu1);
      }
      const int64_t p = i * P.sx + P.col;
      if (bf != nullptr) {  // buoyancy: Gw += ℑzᶠ(b)
        d = d + h * (__ldg(bf + p + dkm) + __ldg(bf + p));
      }
      const T gu0 = gu[p], gv0 = gv[p], gw0 = gw[p];
      un[p] = cur[pos] + ca * a + cb * gu0;
      vn[p] = cur[kPlane + pos] + ca * b + cb * gv0;
      wn[p] = cur[2 * kPlane + pos] + ca * d + cb * gw0;
      gu[p] = a;
      gv[p] = b;
      gw[p] = d;
    });
    return;
  }

  const Group<T> G = group_of(tr, (role - 1) * kTG);
  halo_rows(P, nx, seg, nseg, [&](int64_t p) {
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      if (t < G.n) G.cn[t][p] = G.c[t][p];
    }
  });
  tracer_march(u, v, w, G.c, G.n, nx, seg, seg_len, P, c, smem_raw,
               [&](int t, int i, T g, T q) {
                 const int64_t p = i * P.sx + P.col;
                 const T gp = G.g[t][p];
                 G.cn[t][p] = q + ca * g + cb * gp;
                 G.g[t][p] = g;
               });
}

template <typename T>
Tracers<T> tracers_of(const void* const* c, void* const* g, void* const* cn,
                      int n) {
  Tracers<T> tr{};
  tr.n = n;
  for (int t = 0; t < n; ++t) {
    tr.c[t] = (const T*)c[t];
    tr.g[t] = (T*)g[t];
    tr.cn[t] = cn ? (T*)cn[t] : nullptr;
  }
  return tr;
}

template <typename T>
Coefs<T> coefs_of(double idx, double idy, double idz, double eps) {
  return Coefs<T>{(T)idx, (T)idy, (T)idz, (T)eps};
}

template <typename T>
int launch_tracers(const void* u, const void* v, const void* w,
                   const void* const* c, void* const* g, int n, int nx,
                   int ny, int nz, double idx, double idy, double idz,
                   double eps, void* stream) {
  if (n < 1 || n > kMaxTracers) return (int)cudaErrorInvalidValue;
  if ((int64_t)nx * ny * nz == 0) return 0;
  const int rows = nx - 2 * kH;  // output x-rows
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = tracer_smem_bytes<T>();
  const int py = (ny + TY - 1) / TY, pz = (nz + TZ - 1) / TZ;
  const int groups = (n + kTG - 1) / kTG;
  int seg_len = 0, nseg = 0;
  const cudaError_t err = plan_segments(
      (const void*)weno5_tracer_tile<T>, bytes, rows,
      (int64_t)py * pz * groups, &seg_len, &nseg);
  if (err != cudaSuccess) return (int)err;
  if (py > 65535 || (int64_t)nseg * groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  weno5_tracer_tile<T><<<dim3(pz, py, (unsigned)(nseg * groups)), kThreads,
                         bytes, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, tracers_of<T>(c, g, nullptr, n),
      nx, ny, nz, seg_len, groups, coefs_of<T>(idx, idy, idz, eps));
  return (int)cudaGetLastError();
}

// kScience = false launches the momentum AB2 step: n = 0, f = 0 and
// b_idx = -1, momentum blocks only.
template <typename T, bool kScience>
int launch_science(const void* u, const void* v, const void* w, void* gu,
                   void* gv, void* gw, void* un, void* vn, void* wn,
                   const void* const* c, void* const* g, void* const* cn,
                   int n, int nx, int ny, int nz, double idx, double idy,
                   double idz, double eps, double ca, double cb, double f,
                   int b_idx, void* stream) {
  if (n < 0 || n > kMaxTracers || b_idx >= n ||
      (!kScience && (n != 0 || f != 0.0 || b_idx >= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)nx * ny * nz == 0) return 0;
  const int rows = nx - 2 * kH;  // output x-rows
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t mb = momentum_smem_bytes<T>(), tb = tracer_smem_bytes<T>();
  const size_t bytes = mb > tb ? mb : tb;
  const int py = (ny + TY - 1) / TY, pz = (nz + TZ - 1) / TZ;
  const int roles = 1 + (n + kTG - 1) / kTG;
  int seg_len = 0, nseg = 0;
  const cudaError_t err = plan_segments(
      (const void*)weno5_science_tile<T, kScience>, bytes, rows,
      (int64_t)py * pz * roles, &seg_len, &nseg);
  if (err != cudaSuccess) return (int)err;
  if (py > 65535 || (int64_t)nseg * roles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  weno5_science_tile<T, kScience><<<dim3(pz, py, (unsigned)(nseg * roles)),
                                    kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw,
      (T*)un, (T*)vn, (T*)wn, tracers_of<T>(c, g, cn, n), nx, ny, nz,
      seg_len, roles, coefs_of<T>(idx, idy, idz, eps), (T)ca, (T)cb, (T)f,
      b_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define OT_WENO5_SCIENCE_ENTRIES(SUFFIX, T)                                  \
  int ot_weno5_tracers_##SUFFIX(const void* u, const void* v, const void* w, \
                                const void* const* c, void* const* g, int n, \
                                int nx, int ny, int nz, double idx,          \
                                double idy, double idz, double eps,          \
                                void* stream) {                              \
    return launch_tracers<T>(u, v, w, c, g, n, nx, ny, nz, idx, idy, idz,    \
                             eps, stream);                                   \
  }                                                                          \
  int ot_weno5_science_ab2_##SUFFIX(                                         \
      const void* u, const void* v, const void* w, void* gu, void* gv,       \
      void* gw, void* un, void* vn, void* wn, const void* const* c,          \
      void* const* g, void* const* cn, int n, int nx, int ny, int nz,        \
      double idx, double idy, double idz, double eps, double ca, double cb,  \
      double f, int b_idx, void* stream) {                                   \
    return launch_science<T, true>(u, v, w, gu, gv, gw, un, vn, wn, c, g,    \
                                   cn, n, nx, ny, nz, idx, idy, idz, eps, ca, \
                                   cb, f, b_idx, stream);                    \
  }                                                                          \
  int ot_weno5_ab2_##SUFFIX(const void* u, const void* v, const void* w,     \
                            void* gu, void* gv, void* gw, void* un,          \
                            void* vn, void* wn, int nx, int ny, int nz,      \
                            double idx, double idy, double idz, double eps,  \
                            double ca, double cb, void* stream) {            \
    return launch_science<T, false>(u, v, w, gu, gv, gw, un, vn, wn,         \
                                    nullptr, nullptr, nullptr, 0, nx, ny,    \
                                    nz, idx, idy, idz, eps, ca, cb, 0.0, -1, \
                                    stream);                                 \
  }

OT_WENO5_SCIENCE_ENTRIES(f32, float)
OT_WENO5_SCIENCE_ENTRIES(f64, double)

#undef OT_WENO5_SCIENCE_ENTRIES

}  // extern "C"
