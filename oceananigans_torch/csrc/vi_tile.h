// The x-marching tiles of the WENO vector-invariant momentum tendency and of
// the WENO tracer tendencies, templates on the WENO orders.
//
// Replaces the TPU kernels
//   oceananigans_tpu/ops/pallas_vi.py: vi_momentum_tendency (_kernel) and
//     vi_momentum_tendency_zyx (_kernel_zyx)                -> vi_march
//   oceananigans_tpu/ops/pallas_tracer.py: weno_tracer_tendencies
//     (_tracer_core, _kernel; both layouts)                  -> weno_tracer_march
// The TPU's transposed layouts exist for its 128 lanes; here each kernel
// works on the (x, y, z) arrays, C-contiguous, z fastest.
//
// Fields are halo-extended (nx, ny, nz) arrays. Every point is computed,
// with neighbours wrapped modulo the full extent on every axis, as the plain
// versions' whole-array operators (torch.roll) do: on a halo-free periodic
// axis the wrap is the periodic boundary itself, on an axis with a halo of
// the stencil's reach or more the interior reads only filled rows. Metrics
// are y-profiles (regular rectilinear grids: constant; a lat-lon grid's vary
// in y only).
//
// The march. A block owns a panel of py (y) x pz (z) output columns, one
// thread a column, and marches along x over one segment of the x-rows
// [0, nx); one more column of threads (and for the tracers one more row)
// computes the faces on the panel's far side, so that every thread
// computes one face of each kind, at most 256 threads. The panel shape and
// the segments are the launch plan of ops/march.py: march_plan,
// which fits pz to nz (68 columns: three panels of 23); the kernels refuse
// a plan that misses an x-row. Each x-plane of the fields a block reads
// enters a ring of shared-memory tiles (the panel and its y- and z-halo)
// once, by 4- or 8-byte cp.async copies through a per-block table of each
// tile element's wrapped offset in a plane, one plane ahead of the plane
// being computed. Quantities
// that a reconstruction reads across y or z (ζ, the δ-quantities, the face
// fluxes) are computed once per point of the panel and its halo into
// shared memory; those it reads along x are computed once per point at the
// head of the march, one plane a step, and carried in register queues.
//
// One side, no branch. A reconstruction picks its taps by the sign of the
// advecting velocity U (mirrored for U <= 0, as the plain versions' right-
// biased stencil is the left-biased one on reflected taps) and evaluates one
// WENO-Z side on every lane. Where the reconstruction is multiplied by U
// (every flux) U == 0 makes either side 0. The Bernoulli self difference is
// not multiplied by its velocity, and the plain version takes the mean of
// both sides there: a lane with u == 0 evaluates the other side too.
//
// Reciprocals, not IEEE division. The WENO-Z ratio tau/(beta + eps) and the
// normalisation are products with reciprocals (float32: the approximate
// reciprocal and one Newton step, within an ulp; float64: the correctly
// rounded one), the ratio capped at 1e12 (float32) or 1e60 (float64) as
// the plain versions cap it; the divisions by areas, spacings and volumes
// are products with reciprocals of the metric profiles, taken once a block.
// IEEE division's slow path (behind its FCHK test) is what zero rows took.
// The plain versions divide, so the two agree to rounding.
//
// What bounds them on the H100: operations. At hydro_vi's (372, 172, 68)
// in float32 a vector-invariant point of WENOVectorInvariant() does ~1,500
// operations with one WENO side a reconstruction, 0.077 ms at the 67
// TFLOP/s FFMA peak, against 0.026 ms for the 5 fields it moves; a WENO-7
// tracer point ~490 operations a tracer, 0.050 ms for two, against 0.036
// ms for 7 fields (chip_smoke.py: VI_POINT_OPS, TRACER7_POINT_OPS). The
// first kernels, one thread a point, sat at 5-7% of that bound: every face
// twice, both WENO sides where a warp held both signs, IEEE division, ζ
// recomputed 4 BV times a point.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "march.h"
#include "weno.h"

namespace ot_march {

using ot_weno::WenoTable;

// must equal MAX_TRACERS in ops/cuda_kernels.py
constexpr int kMaxTracers = 8;
// tracers a tracer block marches (blocks by pairs of tracers)
constexpr int kTG = 2;

// float32 takes three blocks an SM (at most 80 registers a thread: the
// pairs up to (9, 5) and (7, 7) and every tracer order do not spill; (9,
// 9), (11, 5) and (11, 11) spill up to 200 bytes), float64 one; the
// vector-invariant kernel of runtime orders (KR = 0), whose queues hold
// the widest reach, two in float32
template <typename T, int KR = 1>
constexpr int kMinBlocks = sizeof(T) == 4 ? (KR == 0 ? 2 : 3) : 1;

// A WENO order as a type, for the dispatch of a runtime order.
template <int K>
struct Order {
  static constexpr int value = K;
};

// f(Order<KR>) for a compile-time order KR, else f(Order<order>) for the
// runtime order (3, 5, 7, 9 or 11) at this call site.
template <int KR, typename F>
__device__ __forceinline__ auto at_order(int order, F&& f) {
  if constexpr (KR != 0) {
    return f(Order<KR>{});
  } else {
    switch (order) {
      case 3: return f(Order<3>{});
      case 5: return f(Order<5>{});
      case 7: return f(Order<7>{});
      case 9: return f(Order<9>{});
      default: return f(Order<11>{});
    }
  }
}

// kInOrder: the smoothness indicators in the plain version's order, each
// product and sum rounded on its own (weno.h: betas_in_order), else the
// contracted forms (weno.h: betas). The high orders' generated forms sum
// terms with coefficients in the thousands, and in float32 two orders of
// evaluation can put a tendency ~1e-5 of its largest value apart. Each
// reconstruction takes the ordered forms from the lowest order at which,
// on random fields with exact zero rows, the contracted ones came within a
// factor of a few of that bound: the vector-invariant δ-quantities and
// vertical flux from order 7, ζ from order 11 (its order 9, the default,
// keeps the cheaper contracted forms), the tracers from order 7 (WENO-7's
// contracted forms came 1.5e-5 of the largest value from the plain
// version on a lat-lon layout, chip_smoke.py phase 3).
template <int K, bool kInOrder, typename T>
__device__ __forceinline__ void left_betas(const T* t, T* beta) {
  if constexpr (kInOrder) {
    ot_weno::betas_in_order<K, false>(t, beta);
  } else {
    ot_weno::betas<K, false, false>(t, beta);
  }
}

// The left-biased WENO-Z value of the taps t[0..2B-1] (offsets -B..B-1 from
// the target), with the smoothness of t (kSmooth = 0) or the summed
// smoothness of t1 (and t2) (kSmooth = 1, 2: the reference's
// FunctionStencil and VelocityStencil), its weights formed with
// reciprocals.
template <int K, int kSmooth, bool kInOrder, typename T>
__device__ __forceinline__ T left_side(const T* t, const T* t1, const T* t2,
                                       T eps) {
  using W = WenoTable<K>;
  constexpr int B = W::B;
  T beta[B];
  if constexpr (kSmooth == 0) {
    left_betas<K, kInOrder>(t, beta);
  } else {
    left_betas<K, kInOrder>(t1, beta);
    if constexpr (kSmooth == 2) {
      T b2[B];
      left_betas<K, kInOrder>(t2, b2);
#pragma unroll
      for (int r = 0; r < B; ++r) beta[r] = ot_weno::add_rn(beta[r], b2[r]);
    }
  }
  const T cap = ot_weno::RatioCap<T>::value;
  const T tau = fabs(beta[0] - beta[B - 1]);
  T asum = T(0), out = T(0);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const T ratio = fmin(tau * rcp(beta[r] + eps), cap);
    const T alpha = T(W::gamma(r)) * (T(1) + ratio * ratio);
    T poly = T(W::q(r, 0)) * t[W::lo(r) + B];
#pragma unroll
    for (int j = 1; j < B; ++j) {
      poly = poly + T(W::q(r, j)) * t[W::lo(r) + j + B];
    }
    asum = (r == 0) ? alpha : asum + alpha;
    out = (r == 0) ? alpha * poly : out + alpha * poly;
  }
  return out * rcp(asum);
}

// One side of the order-K reconstruction from the middle K + 1 entries of
// register queues of N >= K + 1 entries, picked by `left`.
template <int K, int kSmooth, bool kInOrder, int N, typename T>
__device__ __forceinline__ T queue_side(const T (&s)[N], const T (&s1)[N],
                                        const T (&s2)[N], bool left, T eps) {
  constexpr int M = K + 1, o = (N - M) / 2;
  static_assert(N >= M && (N - M) % 2 == 0, "queue narrower than order");
  T t[M], t1[M], t2[M];
  if constexpr (o == 0) {
    mirror(s, left, t);
    if constexpr (kSmooth >= 1) mirror(s1, left, t1);
    if constexpr (kSmooth == 2) mirror(s2, left, t2);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = o + (left ? m : M - 1 - m);
      t[m] = s[q];
      if constexpr (kSmooth >= 1) t1[m] = s1[q];
      if constexpr (kSmooth == 2) t2[m] = s2[q];
    }
  }
  return left_side<K, kSmooth, kInOrder>(t, t1, t2, eps);
}

// ---------------------------------------------------------------------------
// The vector-invariant momentum tendency (Gu, Gv) of VectorInvariant.
// u_tendency / v_tendency (models/hydrostatic.py) with WENO schemes: the
// WENO-KV ζ flux (smoothness of ℑy(u) and ℑx(v), or of ζ), the Bernoulli
// head (the self difference δx(u²/2) upwinded on u, the cross difference
// Centered(2)), the divergence flux with OnlySelfUpwinding and Centered(2)
// cross terms, and the flux-form vertical advection; the last three
// WENO-KR with one epsilon, or, with KR = 0, each of its own runtime
// order (3 to 11) and epsilon, the queues, the ring and the planar
// quantities sized for the widest (11), and each role's reconstruction
// dispatched at its call site.
//
// Two roles, a block each for every panel and segment (blockIdx.z = 2 seg
// + role), which share u, v and w through L2:
// - the Gu block (py x (pz + 1) threads, as the Gv block) reconstructs ζ
//   along y: at plane i it computes ζ (and its two smoothness fields) once
//   per point of the panel and its y-halo into shared memory; it reconstructs δx(u²/2), δx(Ax u) and the divergence
//   D = δx(Ax u) + δy(Ay v) along x from register queues, to which each
//   step adds one plane at the head of the march (i + BR - 1);
// - the Gv block reconstructs ζ along x from register queues of ζ and its
//   smoothness fields (head i + BV); δy(v²/2), δy(Ay v), δx(Ax u) and D at
//   plane i go once per point of the panel and its y-halo into shared
//   memory.
// Each block computes the z-face fluxes of its component once per face.
// So ζ and D are computed once per point by each role (twice in all, with
// the y-halo), against 4 BV times per point before: one block carrying
// both reconstructions would need ζ's three fields in shared memory over
// 2 BV planes and the panel's y-halo (over 227 KB in float64 at BV = 6),
// or Gv lagging BV planes behind Gu with a second ring.
// ---------------------------------------------------------------------------

// the metric profiles, in the order of METRICS in ops/cuda_vi.py, then the
// reciprocals of the five that divide
enum Metric {
  kDyVF, kDxUF, kDxVF, kDyUC, kAzFF, kAzCC, kAxFCC, kAyCFC, kVFCC, kVCFC,
  kRDxUF, kRDyVF, kRAzFF, kRVFCC, kRVCFC, kMetrics
};

template <int KV, int KR, bool kVel>
struct ViShape {
  static constexpr int KS = KR == 0 ? 11 : KR;  // the widest rest order
  static constexpr int BV = (KV + 1) / 2, BR = (KS + 1) / 2;
  static constexpr int R = BV > BR ? BV : BR;   // y-halo of the ring
  static constexpr int NZ = kVel ? 3 : 1;       // ζ and its smoothness
  static constexpr bool kZetaOrdered = KV >= 11;
  // ring slot: u, v [tr][tc]; w rows j-1 .. j+py-1, columns k .. k+pz
  __host__ __device__ static int slot(int py, int pz) {
    return 2 * (py + 2 * R) * (pz + 2 * BR) + (py + 1) * (pz + 1);
  }
  // the planar quantities: Gu's ζ fields over py + 2BV - 1 rows, Gv's
  // five δ-quantities over py + 2BR - 1 rows
  __host__ __device__ static int planar(int py, int pz) {
    const int a = NZ * (py + 2 * BV - 1), b = 5 * (py + 2 * BR - 1);
    return (a > b ? a : b) * pz;
  }
  template <typename T>
  __host__ __device__ static size_t bytes(int py, int pz) {
    const int tr = py + 2 * R, tc = pz + 2 * BR;
    return (size_t)tr * sizeof(int64_t) +
           (size_t)(3 * slot(py, pz) + planar(py, pz) + py * (pz + 1) +
                    kMetrics * tr) * sizeof(T) +
           (size_t)(tc + tr * tc + (py + 1) * (pz + 1)) * sizeof(int);
  }
};

// The epsilons of the four schemes, and the orders of the kinetic energy
// gradient, divergence and vertical schemes: the launch's where KR = 0; a
// pair's (one epsilon, the orders KR) otherwise.
template <typename T>
struct ViRoles {
  T eps_v, eps_k, eps_d, eps_z;
  int ord_k, ord_d, ord_z;
};

template <typename T>
struct ViCtx {
  const T* __restrict__ u;
  const T* __restrict__ v;
  const T* __restrict__ w;
  T* ring;      // [3][slot]
  T* planar;
  T* faces;     // [py][pz + 1]: z-face fluxes of row jy, faces k0 .. k0+pz
  const T* met; // [kMetrics][tr]
  const int* toff;  // [tr][tc]: the ring tiles' offsets in a plane
  const int* woff;  // [py + 1][pz + 1]: w's
  int slot;
  T eps;             // a pair's one epsilon
  ViRoles<T> roles;  // the roles of the instantiation of runtime orders
};

template <int KR, typename T>
__device__ __forceinline__ ViRoles<T> roles_of(const ViCtx<T>& C) {
  if constexpr (KR == 0) {
    return C.roles;
  } else {
    return ViRoles<T>{C.eps, C.eps, C.eps, C.eps, KR, KR, KR};
  }
}

// Gu at (f,c,c): +ζ v̂ − ∂x K − [w ∂z u], over x-rows [S.a, S.b).
template <typename T, int KV, int KR, bool kVel>
__device__ __forceinline__ void vi_gu(const ViCtx<T>& C, const Panel& P,
                                      Segment S, T* __restrict__ gu) {
  using Sh = ViShape<KV, KR, kVel>;
  constexpr int BV = Sh::BV, BR = Sh::BR, R = Sh::R;
  constexpr int kSm = kVel ? 2 : 0;
  constexpr bool kZetaOrdered = Sh::kZetaOrdered;
  const ViRoles<T> R_ = roles_of<KR>(C);
  const T h = T(0.5);
  const int tr = P.tr, tc = P.tc, py = P.py, pz = P.pz;
  const int tt = tr * tc;
  const T* met = C.met;
  auto M = [&](int name, int r) { return met[name * tr + r]; };
  // ring slot of plane p (planes a-1 .. b)
  auto slot = [&](int p) { return C.ring + ((p - S.a + 3) % 3) * C.slot; };
  auto load_plane = [&](int p) {
    T* d = slot(p);
    const int64_t base = wrap(p, P.nx) * P.sx;
    load_tile(d, C.u + base, C.toff, tt);
    load_tile(d + tt, C.v + base, C.toff, tt);
    load_tile(d + 2 * tt, C.w + base, C.woff, (py + 1) * (pz + 1));
  };
  const int nq = py + 2 * BV - 1;   // ζ rows j0-BV+1 .. j0+py+BV-1
  T* Z = C.planar;
  T* Z1 = Z + nq * pz;
  T* Z2 = Z1 + nq * pz;
  const int r0 = P.jy + R, c0 = P.kz + BR;  // ring row and column of mine

  // the x-line queues of this column at planes i-BR .. i+BR-1: δx(u²/2),
  // ℑx(u), δx(Ax u), D and δy(Ay v), at (c,c,c)
  constexpr int N = 2 * BR;
  T qK[N] = {}, qS[N] = {}, qX[N] = {}, qD[N] = {}, qY[N] = {};
  const T ax = M(kAxFCC, r0), ay0 = M(kAyCFC, r0), ay1 = M(kAyCFC, r0 + 1);
  T u_lo = own(C.u, P, S.a - BR, 0);  // u at the queue head's plane
  // add plane p's values from u(p+1), v(p) and v(p) one row up
  auto head = [&](T u_hi, T v0, T v1) {
    push(qK, (h * u_hi) * u_hi - (h * u_lo) * u_lo);
    push(qS, h * (u_hi + u_lo));
    const T dx = ax * u_hi - ax * u_lo;
    const T dy = ay1 * v1 - ay0 * v0;
    push(qX, dx);
    push(qY, dy);
    push(qD, dx + dy);
    u_lo = u_hi;
  };
#pragma unroll
  for (int m = 0; m + 1 < N; ++m) {
    const int p = S.a - BR + m;
    head(own(C.u, P, p + 1, 0), own(C.v, P, p, 0), own(C.v, P, p, 1));
  }
  // the head of step a, loaded a step ahead from then on
  T nu = own(C.u, P, S.a + BR, 0), nv0 = own(C.v, P, S.a + BR - 1, 0),
    nv1 = own(C.v, P, S.a + BR - 1, 1);

  load_plane(S.a - 1);
  load_plane(S.a);
  commit();
  for (int i = S.a; i < S.b; ++i) {
    wait_all();       // plane i has landed
    __syncthreads();  // and step i-1 is done with its slot and tiles
    if (i + 1 < S.b) load_plane(i + 1);
    commit();
    head(nu, nv0, nv1);
    nu = own(C.u, P, i + BR + 1, 0);
    nv0 = own(C.v, P, i + BR, 0);
    nv1 = own(C.v, P, i + BR, 1);
    const T* U = slot(i);
    const T* V = U + tt;
    const T* Wt = U + 2 * tt;
    const T* Vm = slot(i - 1) + tt;
    const T* Wm = slot(i - 1) + 2 * tt;
    // ζ (and ℑy(u), ℑx(v)) at plane i, rows j0-BV+1 .. j0+py+BV-1, each
    // thread of the panel a column
    for (int q = P.jy; P.kz < pz && q < nq; q += py) {
      const int f = P.kz, e = q * pz + f;
      const int rr = q + R - BV + 1, x = rr * tc + f + BR;
      const T dyv = M(kDyVF, rr);
      const T vi0 = V[x], vim = Vm[x], uu = U[x], ud = U[x - tc];
      Z[e] = ((dyv * vi0 - dyv * vim) -
              (M(kDxUF, rr) * uu - M(kDxUF, rr - 1) * ud)) * M(kRAzFF, rr);
      if constexpr (kVel) {
        Z1[e] = h * (uu + ud);
        Z2[e] = h * (vi0 + vim);
      }
    }
    // the z-face flux below this thread's column (the last column of
    // threads: the panel's top faces): ℑx(Az w) times u reconstructed
    // along z
    {
      const int q = P.jy, f = P.kz, rr = q + R;
      const T az = M(kAzCC, rr);
      const int xw = (q + 1) * (pz + 1) + f;
      const T Wf = h * (az * Wt[xw] + az * Wm[xw]);
      C.faces[q * (pz + 1) + f] = Wf * at_order<KR>(R_.ord_z, [&](auto o) {
        constexpr int K = decltype(o)::value, B = (K + 1) / 2;
        T t[2 * B];
        taps<2 * B>(U + rr * tc + f + (BR - B), 1, Wf > T(0), t);
        return left_side<K, 0, (K >= 7)>(t, t, t, R_.eps_z);
      });
    }
    __syncthreads();
    if (P.mine) {
      const int x = r0 * tc + c0;
      const T u0 = U[x];
      // v̂ = ℑxℑy(Δx v)/Δx, ζ reconstructed to y-centers
      const T dxv0 = M(kDxVF, r0), dxv1 = M(kDxVF, r0 + 1);
      const T t0 = h * (dxv1 * V[x + tc] + dxv0 * V[x]);
      const T tm = h * (dxv1 * Vm[x + tc] + dxv0 * Vm[x]);
      const T vhat = (h * (t0 + tm)) * M(kRDxUF, r0);
      const bool lv = vhat > T(0);
      T zt[2 * BV], z1[2 * BV], z2[2 * BV];
      const int zq = P.jy * pz + P.kz;
      taps<2 * BV>(Z + zq, pz, lv, zt);
      if constexpr (kVel) {
        taps<2 * BV>(Z1 + zq, pz, lv, z1);
        taps<2 * BV>(Z2 + zq, pz, lv, z2);
      }
      const T zterm =
          vhat * left_side<KV, kSm, kZetaOrdered>(zt, z1, z2, R_.eps_v);
      // the Bernoulli head: δx(u²/2) upwinded on u (u == 0: the mean of
      // both sides) and the Centered(2) δx(v²/2) at y-centers
      const T duR = at_order<KR>(R_.ord_k, [&](auto o) {
        constexpr int K = decltype(o)::value;
        T d = queue_side<K, 1, (K >= 7)>(qK, qS, qS, u0 > T(0), R_.eps_k);
        if (u0 == T(0)) {
          d = h * (queue_side<K, 1, (K >= 7)>(qK, qS, qS, true, R_.eps_k) +
                   d);
        }
        return d;
      });
      const T v0 = V[x], vm0 = Vm[x], vp0 = V[x + tc], vpm = Vm[x + tc];
      const T dv2j = (h * v0) * v0 - (h * vm0) * vm0;
      const T dv2p = (h * vp0) * vp0 - (h * vpm) * vpm;
      const T bern = (duR + (h * dv2j + h * dv2p)) * M(kRDxUF, r0);
      // the divergence flux and the vertical flux
      const T dR = at_order<KR>(R_.ord_d, [&](auto o) {
        constexpr int K = decltype(o)::value;
        return queue_side<K, 1, (K >= 7)>(qX, qD, qD, u0 > T(0), R_.eps_d);
      });
      const T phi = u0 * ((h * qY[BR - 1] + h * qY[BR]) + dR);
      const T* F = C.faces + P.jy * (pz + 1) + P.kz;
      const T vert = (phi + (F[1] - F[0])) * M(kRVFCC, r0);
      gu[i * P.sx + P.col] = (zterm - bern) - vert;
    }
  }
  wait_all();
}

// Gv at (c,f,c): −ζ û − ∂y K − [w ∂z v], over x-rows [S.a, S.b).
template <typename T, int KV, int KR, bool kVel>
__device__ __forceinline__ void vi_gv(const ViCtx<T>& C, const Panel& P,
                                      Segment S, T* __restrict__ gv) {
  using Sh = ViShape<KV, KR, kVel>;
  constexpr int BV = Sh::BV, BR = Sh::BR, R = Sh::R;
  constexpr int kSm = kVel ? 2 : 0;
  constexpr bool kZetaOrdered = Sh::kZetaOrdered;
  const ViRoles<T> R_ = roles_of<KR>(C);
  const T h = T(0.5);
  const int tr = P.tr, tc = P.tc, py = P.py, pz = P.pz;
  const int tt = tr * tc;
  const T* met = C.met;
  auto M = [&](int name, int r) { return met[name * tr + r]; };
  // ring slot of plane p (planes a .. b+1)
  auto slot = [&](int p) { return C.ring + ((p - S.a) % 3) * C.slot; };
  auto load_plane = [&](int p) {
    T* d = slot(p);
    const int64_t base = wrap(p, P.nx) * P.sx;
    load_tile(d, C.u + base, C.toff, tt);
    load_tile(d + tt, C.v + base, C.toff, tt);
    load_tile(d + 2 * tt, C.w + base, C.woff, (py + 1) * (pz + 1));
  };
  const int nq = py + 2 * BR - 1;   // rows j0-BR .. j0+py+BR-2
  T* KE = C.planar;                 // δy(v²/2) at (c,c,c)
  T* SM = KE + nq * pz;             // ℑy(v)
  T* DY = SM + nq * pz;             // δy(Ay v)
  T* DX = DY + nq * pz;             // δx(Ax u)
  T* DD = DX + nq * pz;             // D = δx(Ax u) + δy(Ay v)
  const int r0 = P.jy + R, c0 = P.kz + BR;

  // the x-line queues of this column at planes i-BV+1 .. i+BV: ζ, ℑy(u)
  // and ℑx(v) at (f,f,c)
  constexpr int N = 2 * BV;
  T qZ[N] = {}, q1[N] = {}, q2[N] = {};
  const T dyv = M(kDyVF, r0), dxu0 = M(kDxUF, r0), dxum = M(kDxUF, r0 - 1);
  const T raz = M(kRAzFF, r0);
  T v_lo = own(C.v, P, S.a - BV, 0);  // v at the plane below the head
  // add plane p's values from u(p), u(p) one row down and v(p)
  auto head = [&](T uj, T ujm, T v_hi) {
    push(qZ, ((dyv * v_hi - dyv * v_lo) - (dxu0 * uj - dxum * ujm)) * raz);
    if constexpr (kVel) {
      push(q1, h * (uj + ujm));
      push(q2, h * (v_hi + v_lo));
    }
    v_lo = v_hi;
  };
#pragma unroll
  for (int m = 0; m + 1 < N; ++m) {
    const int p = S.a - BV + 1 + m;
    head(own(C.u, P, p, 0), own(C.u, P, p, -1), own(C.v, P, p, 0));
  }
  T nu = own(C.u, P, S.a + BV, 0), num = own(C.u, P, S.a + BV, -1),
    nv = own(C.v, P, S.a + BV, 0);

  load_plane(S.a);
  load_plane(S.a + 1);
  commit();
  for (int i = S.a; i < S.b; ++i) {
    wait_all();       // plane i+1 has landed
    __syncthreads();  // and step i-1 is done with its slot and tiles
    if (i + 2 <= S.b) load_plane(i + 2);
    commit();
    head(nu, num, nv);
    nu = own(C.u, P, i + BV + 1, 0);
    num = own(C.u, P, i + BV + 1, -1);
    nv = own(C.v, P, i + BV + 1, 0);
    const T* U0 = slot(i);
    const T* V0 = U0 + tt;
    const T* W0 = U0 + 2 * tt;
    const T* U1 = slot(i + 1);
    // the δ-quantities at plane i, rows j0-BR .. j0+py+BR-2, each thread
    // of the panel a column
    for (int q = P.jy; P.kz < pz && q < nq; q += py) {
      const int f = P.kz, e = q * pz + f;
      const int rr = q + R - BR, x = rr * tc + f + BR;
      const T v0 = V0[x], v1 = V0[x + tc];
      KE[e] = (h * v1) * v1 - (h * v0) * v0;
      SM[e] = h * (v1 + v0);
      const T dy = M(kAyCFC, rr + 1) * v1 - M(kAyCFC, rr) * v0;
      const T axr = M(kAxFCC, rr);
      const T dx = axr * U1[x] - axr * U0[x];
      DY[e] = dy;
      DX[e] = dx;
      DD[e] = dx + dy;
    }
    // the z-face flux below this thread's column: ℑy(Az w) times v
    // reconstructed along z
    {
      const int q = P.jy, f = P.kz, rr = q + R;
      const int xw = (q + 1) * (pz + 1) + f;
      const T Wf = h * (M(kAzCC, rr) * W0[xw] +
                        M(kAzCC, rr - 1) * W0[xw - (pz + 1)]);
      C.faces[q * (pz + 1) + f] = Wf * at_order<KR>(R_.ord_z, [&](auto o) {
        constexpr int K = decltype(o)::value, B = (K + 1) / 2;
        T t[2 * B];
        taps<2 * B>(V0 + rr * tc + f + (BR - B), 1, Wf > T(0), t);
        return left_side<K, 0, (K >= 7)>(t, t, t, R_.eps_z);
      });
    }
    __syncthreads();
    if (P.mine) {
      const int x = r0 * tc + c0;
      const T u0 = U0[x], v0 = V0[x];
      // û = ℑyℑx(Δy u)/Δy, ζ reconstructed to x-centers
      const T dyu0 = M(kDyUC, r0), dyum = M(kDyUC, r0 - 1);
      const T tj = h * (dyu0 * U1[x] + dyu0 * u0);
      const T tjm = h * (dyum * U1[x - tc] + dyum * U0[x - tc]);
      const T uhat = (h * (tj + tjm)) * M(kRDyVF, r0);
      const T zterm =
          -(uhat * queue_side<KV, kSm, kZetaOrdered>(qZ, q1, q2,
                                                      uhat > T(0), R_.eps_v));
      // the Bernoulli head: δy(v²/2) upwinded on v (v == 0: the mean of
      // both sides) and the Centered(2) δy(u²/2) at x-centers; an order-K
      // reconstruction reads the planar rows j-B .. j+B-1
      const int pq = P.jy * pz + P.kz;
      const T dvR = at_order<KR>(R_.ord_k, [&](auto o) {
        constexpr int K = decltype(o)::value, B = (K + 1) / 2;
        const int at = pq + (BR - B) * pz;
        T t[2 * B], t1[2 * B];
        taps<2 * B>(KE + at, pz, v0 > T(0), t);
        taps<2 * B>(SM + at, pz, v0 > T(0), t1);
        T d = left_side<K, 1, (K >= 7)>(t, t1, t1, R_.eps_k);
        if (v0 == T(0)) {
          taps<2 * B>(KE + at, pz, true, t);
          taps<2 * B>(SM + at, pz, true, t1);
          d = h * (left_side<K, 1, (K >= 7)>(t, t1, t1, R_.eps_k) + d);
        }
        return d;
      });
      const T um0 = U0[x - tc], up0 = U1[x], upm = U1[x - tc];
      const T du2i = (h * u0) * u0 - (h * um0) * um0;
      const T du2p = (h * up0) * up0 - (h * upm) * upm;
      const T bern = (dvR + (h * du2i + h * du2p)) * M(kRDyVF, r0);
      // the divergence flux and the vertical flux
      const T dR = at_order<KR>(R_.ord_d, [&](auto o) {
        constexpr int K = decltype(o)::value, B = (K + 1) / 2;
        const int at = pq + (BR - B) * pz;
        T t[2 * B], t1[2 * B];
        taps<2 * B>(DY + at, pz, v0 > T(0), t);
        taps<2 * B>(DD + at, pz, v0 > T(0), t1);
        return left_side<K, 1, (K >= 7)>(t, t1, t1, R_.eps_d);
      });
      const T duS = h * DX[pq + (BR - 1) * pz] + h * DX[pq + BR * pz];
      const T phi = v0 * (duS + dR);
      const T* F = C.faces + P.jy * (pz + 1) + P.kz;
      const T vert = (phi + (F[1] - F[0])) * M(kRVCFC, r0);
      gv[i * P.sx + P.col] = (zterm - bern) - vert;
    }
  }
  wait_all();
}

template <typename T, int KV, int KR, bool kVel>
__global__ void __launch_bounds__(kMaxThreads, (kMinBlocks<T, KR>))
    vi_march(const T* __restrict__ u, const T* __restrict__ v,
             const T* __restrict__ w, T* __restrict__ gu,
             T* __restrict__ gv, int nx, int ny, int nz,
             const T* __restrict__ m, int py, int pz, int seg_len, T eps,
             ViRoles<T> roles) {
  using Sh = ViShape<KV, KR, kVel>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Panel P = panel_of(nx, ny, nz, py, pz, Sh::R, Sh::BR, 1);
  const Segment S = segment_of(blockIdx.z >> 1, seg_len, nx);
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem_raw);
  ViCtx<T> C;
  C.u = u;
  C.v = v;
  C.w = w;
  C.slot = Sh::slot(py, pz);
  C.ring = reinterpret_cast<T*>(rowoff + P.tr);
  C.planar = C.ring + 3 * C.slot;
  C.faces = C.planar + Sh::planar(py, pz);
  T* met = C.faces + py * (pz + 1);
  C.met = met;
  C.eps = eps;
  if constexpr (KR == 0) C.roles = roles;
  int* coloff = reinterpret_cast<int*>(met + kMetrics * P.tr);
  int* toff = coloff + P.tc;
  int* woff = toff + P.tr * P.tc;
  C.toff = toff;
  C.woff = woff;
  P.rowoff = rowoff;
  P.coloff = coloff;
  fill_offsets(P, rowoff, coloff);
  __syncthreads();
  fill_tile_offsets(toff, P, 0, P.tr, 0, P.tc);
  fill_tile_offsets(woff, P, Sh::R - 1, py + 1, Sh::BR, pz + 1);
  // the metric profiles over the tile rows, and the reciprocals of the
  // five that divide
  for (int e = threadIdx.x; e < kMetrics * P.tr; e += blockDim.x) {
    const int name = e / P.tr, r = e - name * P.tr;
    const int j = wrap(P.j0 - P.hy + r, ny);
    if (name < kRDxUF) {
      met[e] = m[name * ny + j];
    } else {
      const int from = name == kRDxUF   ? kDxUF
                       : name == kRDyVF ? kDyVF
                       : name == kRAzFF ? kAzFF
                       : name == kRVFCC ? kVFCC
                                        : kVCFC;
      met[e] = rcp(m[from * ny + j]);
    }
  }
  __syncthreads();
  if ((blockIdx.z & 1) == 0) {
    vi_gu<T, KV, KR, kVel>(C, P, S, gu);
  } else {
    vi_gv<T, KV, KR, kVel>(C, P, S, gv);
  }
}

// Arguments of one launch, as the C entry points take them.
struct ViArgs {
  const void *u, *v, *w;
  void *gu, *gv;
  int nx, ny, nz;
  const void* m;
  int ke_order, div_order, vert_order, velocity;
  int py, pz, seg_len, nseg;
  double eps_v, eps_k, eps_d, eps_z;
  void* stream;
};

template <typename T, int KV, int KR, bool kVel>
int vi_launch(const ViArgs& A) {
  using Sh = ViShape<KV, KR, kVel>;
  const size_t bytes = Sh::template bytes<T>(A.py, A.pz);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = vi_march<T, KV, KR, kVel>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((A.nz + A.pz - 1) / A.pz, (A.ny + A.py - 1) / A.py,
                  (unsigned)(2 * A.nseg));
  const ViRoles<T> roles{(T)A.eps_v,    (T)A.eps_k,   (T)A.eps_d,
                         (T)A.eps_z,    A.ke_order,   A.div_order,
                         A.vert_order};
  kernel<<<grid, A.py * (A.pz + 1), bytes, (cudaStream_t)A.stream>>>(
      (const T*)A.u, (const T*)A.v, (const T*)A.w, (T*)A.gu, (T*)A.gv, A.nx,
      A.ny, A.nz, (const T*)A.m, A.py, A.pz, A.seg_len, (T)A.eps_v, roles);
  return (int)cudaGetLastError();
}

template <typename T, int KV, int KR>
int vi_stencil(const ViArgs& A) {
  return A.velocity ? vi_launch<T, KV, KR, true>(A)
                    : vi_launch<T, KV, KR, false>(A);
}

// The vorticity order KV, either vorticity stencil: one epsilon and the
// other three schemes all at order 5 or all at KV (the two
// WENOVectorInvariant families) take their pair's instantiation; any
// other orders (each of 3, 5, 7, 9, 11) or epsilons the one of runtime
// orders.
template <typename T, int KV>
int vi_order(const ViArgs& A) {
  if (!plan_ok(A.nx, A.ny, A.nz, A.py, A.pz, 0, 1, A.seg_len, A.nseg, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int orders[3] = {A.ke_order, A.div_order, A.vert_order};
  bool all5 = true, allKV = true;
  for (int o : orders) {
    if (o < 3 || o > 11 || o % 2 == 0) return (int)cudaErrorInvalidValue;
    all5 = all5 && o == 5;
    allKV = allKV && o == KV;
  }
  const bool one_eps =
      A.eps_k == A.eps_v && A.eps_d == A.eps_v && A.eps_z == A.eps_v;
  if (one_eps && all5) return vi_stencil<T, KV, 5>(A);
  if constexpr (KV != 5) {
    if (one_eps && allKV) return vi_stencil<T, KV, KV>(A);
  }
  return vi_stencil<T, KV, 0>(A);
}

// ---------------------------------------------------------------------------
// Tracers: -∇·(𝐯c) of each tracer with WENO-K fluxes (A U) c_face, advected
// by the unaveraged face velocities (x-face i by u[i], y-face j by v[j],
// z-face k by w[k]), divided by the cell volume. A block of (py + 1) x
// (pz + 1) threads marches kTG tracers (blockIdx.z = groups seg + group). Its ring holds, for plane i,
// the tracers' tiles (the panel and a B-halo in y and z), v at the panel's
// y-faces and w at its z-faces, in two slots (plane i and plane i+1, copied
// one step ahead). The y- and z-face fluxes of plane i go once per face into
// shared memory; the x-face flux above a column is reconstructed from a
// register queue of the column's tracer values at planes i+1-B .. i+B (the
// head, c(i+B), read a step ahead) and carried to the next plane, where it
// is the flux below. 1/V is taken once a block per y-profile row.
// ---------------------------------------------------------------------------

template <typename T>
struct Tracers {
  const T* c[kMaxTracers];
  T* g[kMaxTracers];
  int n;
};

template <int K>
struct TracerShape {
  static constexpr int B = (K + 1) / 2;
  // ring slot: kTG tracer tiles [tr][tc], v at y-faces [py+1][pz], w at
  // z-faces [py][pz+1]
  __host__ __device__ static int slot(int py, int pz) {
    return kTG * (py + 2 * B) * (pz + 2 * B) + (py + 1) * pz + py * (pz + 1);
  }
  template <typename T>
  __host__ __device__ static size_t bytes(int py, int pz) {
    const int tr = py + 2 * B, tc = pz + 2 * B;
    const int faces = (py + 1) * pz + py * (pz + 1);
    return (size_t)tr * sizeof(int64_t) +
           (size_t)(2 * slot(py, pz) + kTG * faces + 4 * tr) * sizeof(T) +
           (size_t)(tc + tr * tc + faces) * sizeof(int);
  }
};

// the tracer metric profiles, in the order of METRICS in
// ops/cuda_tracer.py, with 1/V in place of V
enum TracerMetric { kAx, kAy, kAz, kRV };

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<T>)
    weno_tracer_march(const T* __restrict__ u, const T* __restrict__ v,
                      const T* __restrict__ w, Tracers<T> trc, int nx,
                      int ny, int nz, const T* __restrict__ m, int py,
                      int pz, int seg_len, int groups, T eps) {
  using Sh = TracerShape<K>;
  constexpr int B = Sh::B, N = 2 * B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kOrdered = K >= 7;
  Panel P = panel_of(nx, ny, nz, py, pz, B, B, 1);
  const int group = blockIdx.z % groups;
  const Segment S = segment_of(blockIdx.z / groups, seg_len, nx);
  const int t0 = group * kTG;
  const int nt = min(kTG, trc.n - t0);
  const int tr = P.tr, tc = P.tc, tt = tr * tc;
  const int nfy = (py + 1) * pz, nfz = py * (pz + 1);
  const int ss = Sh::slot(py, pz);
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem_raw);
  T* ring = reinterpret_cast<T*>(rowoff + tr);  // [2][slot]
  T* Fy = ring + 2 * ss;                         // [kTG][py+1][pz]
  T* Fz = Fy + kTG * nfy;                        // [kTG][py][pz+1]
  T* met = Fz + kTG * nfz;                       // [4][tr]
  int* coloff = reinterpret_cast<int*>(met + 4 * tr);
  int* toff = coloff + tc;   // [tr][tc]: the tracer tiles' offsets
  int* voff = toff + tt;     // [py + 1][pz]: v's at the y faces
  int* woff = voff + nfy;    // [py][pz + 1]: w's at the z faces
  P.rowoff = rowoff;
  P.coloff = coloff;
  fill_offsets(P, rowoff, coloff);
  __syncthreads();
  fill_tile_offsets(toff, P, 0, tr, 0, tc);
  fill_tile_offsets(voff, P, B, py + 1, B, pz);
  fill_tile_offsets(woff, P, B, py, B, pz + 1);
  for (int e = threadIdx.x; e < 4 * tr; e += blockDim.x) {
    const int name = e / tr, r = e - name * tr;
    const T x = m[name * ny + wrap(P.j0 - B + r, ny)];
    met[e] = name == kRV ? rcp(x) : x;
  }
  const T* cs[kTG];
  T* gs[kTG];
#pragma unroll
  for (int t = 0; t < kTG; ++t) {
    const int f = t < nt ? t0 + t : t0;
    cs[t] = pick(trc.c, f);
    gs[t] = pick(trc.g, f);
  }
  __syncthreads();
  auto slot = [&](int p) { return ring + ((p - S.a) & 1) * ss; };
  auto load_plane = [&](int p) {
    T* d = slot(p);
    const int64_t base = wrap(p, nx) * P.sx;
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      if (t < nt) load_tile(d + t * tt, cs[t] + base, toff, tt);
    }
    load_tile(d + kTG * tt, v + base, voff, nfy);
    load_tile(d + kTG * tt + nfy, w + base, woff, nfz);
  };
  const int r0 = P.jy + B;
  const T ax = met[kAx * tr + r0];

  // the column's x-line queues, planes a-B .. a+B-1 at first, and the
  // x-face flux below plane a
  T qc[kTG][N], fx[kTG];
  const T ua = own(u, P, S.a, 0);
#pragma unroll
  for (int t = 0; t < kTG; ++t) {
#pragma unroll
    for (int m2 = 0; m2 < N; ++m2) {
      qc[t][m2] = t < nt ? own(cs[t], P, S.a - B + m2, 0) : T(0);
    }
    fx[t] = (ax * ua) *
            queue_side<K, 0, kOrdered>(qc[t], qc[t], qc[t], ua > T(0), eps);
  }
  // the heads of step a: c(a+B) and u(a+1), read a step ahead from then on
  T nc[kTG];
#pragma unroll
  for (int t = 0; t < kTG; ++t) {
    nc[t] = t < nt ? own(cs[t], P, S.a + B, 0) : T(0);
  }
  T nu = own(u, P, S.a + 1, 0);

  load_plane(S.a);
  commit();
  for (int i = S.a; i < S.b; ++i) {
    wait_all();       // plane i has landed
    __syncthreads();  // and step i-1 is done with its slot and faces
    if (i + 1 < S.b) load_plane(i + 1);
    commit();
    const T U1 = nu;
#pragma unroll
    for (int t = 0; t < kTG; ++t) push(qc[t], nc[t]);
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      nc[t] = t < nt ? own(cs[t], P, i + 1 + B, 0) : T(0);
    }
    nu = own(u, P, i + 2, 0);
    const T* cur = slot(i);
    const T* Vf = cur + kTG * tt;
    const T* Wf = Vf + nfy;
    // the y face below this thread's column (between rows j-1 and j;
    // the last row of threads: the panel's top faces) and the z face below
    // it (between columns k-1 and k; the last column: the far faces) of
    // plane i, for each tracer
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      if (t >= nt) continue;
      const T* c = cur + t * tt;
      const int q = P.jy, f = P.kz;
      if (f < pz) {
        const T Uf = Vf[q * pz + f];
        T s[N];
        taps<N>(c + q * tc + f + B, tc, Uf > T(0), s);  // rows j-B .. j+B-1
        const T A = met[kAy * tr + q + B];
        Fy[t * nfy + q * pz + f] =
            (A * Uf) * left_side<K, 0, kOrdered>(s, s, s, eps);
      }
      if (q < py) {
        const T Uf = Wf[q * (pz + 1) + f];
        T s[N];
        taps<N>(c + (q + B) * tc + f, 1, Uf > T(0), s);  // columns k-B ..
        const T A = met[kAz * tr + q + B];
        Fz[t * nfz + q * (pz + 1) + f] =
            (A * Uf) * left_side<K, 0, kOrdered>(s, s, s, eps);
      }
    }
    // the x-face flux above this column: c(i+1-B .. i+B), advected by
    // u(i+1)
    T fxu[kTG];
#pragma unroll
    for (int t = 0; t < kTG; ++t) {
      fxu[t] = t < nt ? (ax * U1) * queue_side<K, 0, kOrdered>(
                                       qc[t], qc[t], qc[t], U1 > T(0), eps)
                      : T(0);
    }
    __syncthreads();
    if (P.mine) {
      const T rv = met[kRV * tr + r0];
      const int py0 = P.jy * pz + P.kz, pz0 = P.jy * (pz + 1) + P.kz;
#pragma unroll
      for (int t = 0; t < kTG; ++t) {
        if (t < nt) {
          const T* fy = Fy + t * nfy + py0;
          const T* fz = Fz + t * nfz + pz0;
          const T dx = fxu[t] - fx[t];
          const T dy = fy[pz] - fy[0];
          const T dz = fz[1] - fz[0];
          gs[t][i * P.sx + P.col] = -(((dx + dy) + dz) * rv);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTG; ++t) fx[t] = fxu[t];
  }
  wait_all();
}

// Arguments of one launch, as the C entry points take them.
struct TracerArgs {
  const void *u, *v, *w;
  const void* const* c;
  void* const* g;
  int n, nx, ny, nz;
  const void* m;
  int py, pz, seg_len, nseg;
  double eps;
  void* stream;
};

template <typename T, int K>
int tracer_order(const TracerArgs& A) {
  using Sh = TracerShape<K>;
  const int groups = (A.n + kTG - 1) / kTG;
  if (A.n < 1 || A.n > kMaxTracers ||
      !plan_ok(A.nx, A.ny, A.nz, A.py, A.pz, 1, 1, A.seg_len, A.nseg,
               groups)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = Sh::template bytes<T>(A.py, A.pz);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Tracers<T> trc{};
  trc.n = A.n;
  for (int q = 0; q < A.n; ++q) {
    trc.c[q] = (const T*)A.c[q];
    trc.g[q] = (T*)A.g[q];
  }
  auto kernel = weno_tracer_march<T, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((A.nz + A.pz - 1) / A.pz, (A.ny + A.py - 1) / A.py,
                  (unsigned)(groups * A.nseg));
  kernel<<<grid, (A.py + 1) * (A.pz + 1), bytes, (cudaStream_t)A.stream>>>(
      (const T*)A.u, (const T*)A.v, (const T*)A.w, trc, A.nx, A.ny, A.nz,
      (const T*)A.m, A.py, A.pz, A.seg_len, groups, (T)A.eps);
  return (int)cudaGetLastError();
}

}  // namespace ot_march

// One translation unit per order (vi_tile_k<K>.cu) instantiates these, so
// that the build compiles the orders in parallel; vi_tile.cu holds the C
// entry points.
#define OT_MARCH_ORDER(K)                                                  \
  template int ot_march::vi_order<float, K>(const ot_march::ViArgs&);      \
  template int ot_march::vi_order<double, K>(const ot_march::ViArgs&);     \
  template int ot_march::tracer_order<float, K>(                           \
      const ot_march::TracerArgs&);                                        \
  template int ot_march::tracer_order<double, K>(                          \
      const ot_march::TracerArgs&);
