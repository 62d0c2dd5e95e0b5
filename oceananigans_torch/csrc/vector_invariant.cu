// The WENO vector-invariant momentum tendency (Gu, Gv) of the hydrostatic
// model in one pass.
//
// Replaces the TPU kernels of oceananigans_tpu/ops/pallas_vi.py:
//   vi_momentum_tendency     (_kernel, the (x, y, z) layout)     -> vi_tendency
//   vi_momentum_tendency_zyx (_kernel_zyx, the (z, y, x) layout) -> vi_tendency
// Both compute the same terms; the transposed layout exists for the TPU's
// 128 lanes, and here one kernel works on the (x, y, z) arrays with z
// contiguous. The terms are those of VectorInvariant.u_tendency and
// v_tendency (models/hydrostatic.py) with WENO schemes: the WENO-KV ζ flux
// (smoothness of ℑy(u) and ℑx(v), or of ζ itself), the Bernoulli head (the
// self difference δx(u²/2) upwinded on u, the cross difference Centered(2)),
// the divergence flux with OnlySelfUpwinding and Centered(2) cross terms,
// and the flux-form vertical advection; the last three WENO-5.
//
// Fields are halo-extended (nx, ny, nz) arrays. Every point is computed,
// with neighbours wrapped modulo the full extent on every axis, as the plain
// version's whole-array operators (torch.roll) do. A point reads x and y
// offsets -R..R with R = max(BV, 3) (ζ's reconstruction to centers reads ζ
// at -BV+1..BV, and ζ one more row; the δ-quantities reach 3) and z offsets
// -3..3. The ten metric combinations are y-profiles m[10][ny], in the order
// of METRICS in ops/cuda_vi.py.
//
// Numerics: the plain version's operations in its order, FMA contraction
// aside; exact IEEE division; the WENO-Z ratio capped (weno.h). Upwind
// selects: where the reconstruction is multiplied by its advecting velocity
// (the ζ flux, the divergence flux, the vertical flux) the sign picks one
// side; the Bernoulli self difference is not multiplied by u, so there
// u == 0 gives the mean of both sides, as in the plain version.
//
// What bounds it on the H100: operations. With WENO-9 vorticity a point
// computes two ζ reconstructions with two smoothness fields (~1,400
// operations) and eight WENO-5 ones (~700), against 5 fields moved; at
// hydro_vi's 372 x 172 x 68 in float32 that is ~0.14 ms of operations
// against ~0.03 ms of bytes. Design: one thread per point, z on the fastest
// thread index; neighbours through L1; ζ and the smoothness fields
// recomputed per point from u and v; one side of each reconstruction
// computed where the velocity's sign selects it.

#include <cuda_runtime.h>

#include "weno.h"

namespace {

using ot_weno::upwind;
using ot_weno::upwind_mean;
using ot_weno::wrap;

constexpr int kThreads = 128;
// the kinetic-energy-gradient, divergence and vertical schemes: WENO-5
constexpr int KR = 5;
constexpr int BR = (KR + 1) / 2;

// the metric profiles, in the order of METRICS in ops/cuda_vi.py
enum Metric {
  kDyVF, kDxUF, kDxVF, kDyUC, kAzFF, kAzCC, kAxFCC, kAyCFC, kVFCC, kVCFC
};

struct Layout {
  int nx, ny, nz, sx;  // sx = ny * nz; nx * sx < 2^31
};

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ p, int off) {
  return __ldg(p + off);
}

template <typename T, int KV, bool kVel>
__global__ void __launch_bounds__(kThreads)
    vi_tendency(const T* __restrict__ u, const T* __restrict__ v,
                const T* __restrict__ w, T* __restrict__ gu,
                T* __restrict__ gv, Layout L, const T* __restrict__ m,
                T eps) {
  constexpr int BV = (KV + 1) / 2;
  constexpr int kSmooth = kVel ? 2 : 0;
  const T h = T(0.5);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= L.nx * L.sx) return;
  const int k = p % L.nz;
  const int t = p / L.nz;
  const int j = t % L.ny;
  const int i = t / L.ny;
  // wrapped row offsets and metric values
  auto X = [&](int d) { return wrap(i + d, L.nx) * L.sx; };
  auto Y = [&](int d) { return wrap(j + d, L.ny) * L.nz; };
  auto Z = [&](int d) { return wrap(k + d, L.nz); };
  auto M = [&](int name, int d) {
    return __ldg(m + name * L.ny + wrap(j + d, L.ny));
  };
  const int x0 = i * L.sx, y0 = j * L.nz;
  const int xm = X(-1), xp = X(1), ym = Y(-1), yp = Y(1), zp = Z(1);
  const T u0 = ld(u, p);
  const T v0 = ld(v, p);

  // ======================================================================
  // Gu at (f,c,c): +ζ v̂ − ∂x K − [w ∂z u]
  // ======================================================================
  T Gu;
  {
    // ζ term: v̂ = ℑxℑy(Δx v)/Δx; ζ reconstructed to y-centers (o = 1),
    // taps ζ(i, j+1-BV .. j+BV)
    const T t0 = h * (M(kDxVF, 1) * ld(v, x0 + yp + k)
                      + M(kDxVF, 0) * v0);
    const T tm = h * (M(kDxVF, 1) * ld(v, xm + yp + k)
                      + M(kDxVF, 0) * ld(v, xm + y0 + k));
    const T vhat = (h * (t0 + tm)) / M(kDxUF, 0);
    T zt[2 * BV], s1[2 * BV], s2[2 * BV];
    {
      T uc[2 * BV + 1];  // u(i, j-BV .. j+BV)
#pragma unroll
      for (int d = 0; d <= 2 * BV; ++d) uc[d] = ld(u, x0 + Y(d - BV) + k);
#pragma unroll
      for (int mm = 0; mm < 2 * BV; ++mm) {
        const int dj = mm + 1 - BV;
        const int yr = Y(dj);
        const T vi0 = ld(v, x0 + yr + k);
        const T vim = ld(v, xm + yr + k);
        const T dyv = M(kDyVF, dj);
        zt[mm] = ((dyv * vi0 - dyv * vim)
                  - (M(kDxUF, dj) * uc[mm + 1] - M(kDxUF, dj - 1) * uc[mm]))
                 / M(kAzFF, dj);
        s1[mm] = h * (uc[mm + 1] + uc[mm]);
        s2[mm] = h * (vi0 + vim);
      }
    }
    const T zterm = vhat * upwind<KV, kSmooth>(zt, s1, s2, vhat, eps);

    // Bernoulli head: δx(u²/2) upwinded on u (u == 0: the mean) + the
    // Centered(2) δx(v²/2) at y-centers
    T ul[2 * BR + 1];  // u(i-BR .. i+BR, j)
#pragma unroll
    for (int d = 0; d <= 2 * BR; ++d) ul[d] = ld(u, X(d - BR) + y0 + k);
    T bern;
    {
      T q[2 * BR], sm[2 * BR];
#pragma unroll
      for (int mm = 0; mm < 2 * BR; ++mm) {
        q[mm] = (h * ul[mm + 1]) * ul[mm + 1] - (h * ul[mm]) * ul[mm];
        sm[mm] = h * (ul[mm + 1] + ul[mm]);
      }
      const T duR = upwind_mean<KR, 1>(q, sm, sm, u0, eps);
      const T vp0 = ld(v, x0 + yp + k), vpm = ld(v, xm + yp + k);
      const T vm0 = ld(v, xm + y0 + k);
      const T dv2j = (h * v0) * v0 - (h * vm0) * vm0;
      const T dv2p = (h * vp0) * vp0 - (h * vpm) * vpm;
      const T dvS = h * dv2j + h * dv2p;
      bern = (duR + dvS) / M(kDxUF, 0);
    }

    // divergence flux (OnlySelfUpwinding) and the vertical flux
    T vert;
    {
      const T ax = M(kAxFCC, 0);
      const T ay0 = M(kAyCFC, 0), ay1 = M(kAyCFC, 1);
      T q[2 * BR], dyV[2 * BR], sd[2 * BR];
#pragma unroll
      for (int mm = 0; mm < 2 * BR; ++mm) {
        const int xr = X(mm - BR);
        q[mm] = ax * ul[mm + 1] - ax * ul[mm];
        dyV[mm] = ay1 * ld(v, xr + yp + k) - ay0 * ld(v, xr + y0 + k);
        sd[mm] = q[mm] + dyV[mm];
      }
      const T duR = upwind<KR, 1>(q, sd, sd, u0, eps);
      const T dvS = h * dyV[BR - 1] + h * dyV[BR];
      const T phi = u0 * (dvS + duR);
      const T az = M(kAzCC, 0);
      const int zk = x0 + y0;
      const T W0 = h * (az * ld(w, zk + k) + az * ld(w, xm + y0 + k));
      const T W1 = h * (az * ld(w, zk + zp) + az * ld(w, xm + y0 + zp));
      T uz[2 * BR + 1];  // u(i, j, k-BR .. k+BR)
#pragma unroll
      for (int d = 0; d <= 2 * BR; ++d) uz[d] = ld(u, zk + Z(d - BR));
      const T F0 = W0 * upwind<KR, 0>(uz, uz, uz, W0, eps);
      const T F1 = W1 * upwind<KR, 0>(uz + 1, uz, uz, W1, eps);
      vert = (phi + (F1 - F0)) / M(kVFCC, 0);
    }
    Gu = (zterm - bern) - vert;
  }
  gu[p] = Gu;

  // ======================================================================
  // Gv at (c,f,c): −ζ û − ∂y K − [w ∂z v]
  // ======================================================================
  T Gv;
  {
    // ζ term: û = ℑyℑx(Δy u)/Δy; ζ reconstructed to x-centers (o = 1),
    // taps ζ(i+1-BV .. i+BV, j)
    const T dyu0 = M(kDyUC, 0), dyum = M(kDyUC, -1);
    const T tj = h * (dyu0 * ld(u, xp + y0 + k) + dyu0 * u0);
    const T tjm = h * (dyum * ld(u, xp + ym + k) + dyum * ld(u, x0 + ym + k));
    const T uhat = (h * (tj + tjm)) / M(kDyVF, 0);
    T zt[2 * BV], s1[2 * BV], s2[2 * BV];
    {
      T vr[2 * BV + 1];  // v(i-BV .. i+BV, j)
#pragma unroll
      for (int d = 0; d <= 2 * BV; ++d) vr[d] = ld(v, X(d - BV) + y0 + k);
      const T dyv = M(kDyVF, 0), dxu0 = M(kDxUF, 0), dxum = M(kDxUF, -1);
      const T az = M(kAzFF, 0);
#pragma unroll
      for (int mm = 0; mm < 2 * BV; ++mm) {
        const int xr = X(mm + 1 - BV);
        const T uj = ld(u, xr + y0 + k);
        const T ujm = ld(u, xr + ym + k);
        zt[mm] = ((dyv * vr[mm + 1] - dyv * vr[mm])
                  - (dxu0 * uj - dxum * ujm)) / az;
        s1[mm] = h * (uj + ujm);
        s2[mm] = h * (vr[mm + 1] + vr[mm]);
      }
    }
    const T zterm = -(uhat * upwind<KV, kSmooth>(zt, s1, s2, uhat, eps));

    // Bernoulli head: δy(v²/2) upwinded on v (v == 0: the mean) + the
    // Centered(2) δy(u²/2) at x-centers
    T vc[2 * BR + 1];  // v(i, j-BR .. j+BR)
#pragma unroll
    for (int d = 0; d <= 2 * BR; ++d) vc[d] = ld(v, x0 + Y(d - BR) + k);
    T bern;
    {
      T q[2 * BR], sm[2 * BR];
#pragma unroll
      for (int mm = 0; mm < 2 * BR; ++mm) {
        q[mm] = (h * vc[mm + 1]) * vc[mm + 1] - (h * vc[mm]) * vc[mm];
        sm[mm] = h * (vc[mm + 1] + vc[mm]);
      }
      const T dvR = upwind_mean<KR, 1>(q, sm, sm, v0, eps);
      const T up0 = ld(u, xp + y0 + k), upm = ld(u, xp + ym + k);
      const T um0 = ld(u, x0 + ym + k);
      const T du2i = (h * u0) * u0 - (h * um0) * um0;
      const T du2p = (h * up0) * up0 - (h * upm) * upm;
      const T duS = h * du2i + h * du2p;
      bern = (dvR + duS) / M(kDyVF, 0);
    }

    // divergence flux (OnlySelfUpwinding) and the vertical flux
    T vert;
    {
      T q[2 * BR], dxU[2 * BR], sd[2 * BR];
#pragma unroll
      for (int mm = 0; mm < 2 * BR; ++mm) {
        const int dj = mm - BR;
        const int yr = Y(dj);
        const T ay0 = M(kAyCFC, dj), ay1 = M(kAyCFC, dj + 1);
        const T ax = M(kAxFCC, dj);
        q[mm] = ay1 * vc[mm + 1] - ay0 * vc[mm];
        dxU[mm] = ax * ld(u, xp + yr + k) - ax * ld(u, x0 + yr + k);
        sd[mm] = dxU[mm] + q[mm];
      }
      const T dvR = upwind<KR, 1>(q, sd, sd, v0, eps);
      const T duS = h * dxU[BR - 1] + h * dxU[BR];
      const T phi = v0 * (duS + dvR);
      const T az0 = M(kAzCC, 0), azm = M(kAzCC, -1);
      const int zk = x0 + y0;
      const T W0 = h * (az0 * ld(w, zk + k) + azm * ld(w, x0 + ym + k));
      const T W1 = h * (az0 * ld(w, zk + zp) + azm * ld(w, x0 + ym + zp));
      T vz[2 * BR + 1];  // v(i, j, k-BR .. k+BR)
#pragma unroll
      for (int d = 0; d <= 2 * BR; ++d) vz[d] = ld(v, zk + Z(d - BR));
      const T F0 = W0 * upwind<KR, 0>(vz, vz, vz, W0, eps);
      const T F1 = W1 * upwind<KR, 0>(vz + 1, vz, vz, W1, eps);
      vert = (phi + (F1 - F0)) / M(kVCFC, 0);
    }
    Gv = (zterm - bern) - vert;
  }
  gv[p] = Gv;
}

template <typename T, int KV, bool kVel>
int launch_kernel(const void* u, const void* v, const void* w, void* gu,
                  void* gv, const Layout& L, const void* m, double eps,
                  void* stream) {
  const int total = L.nx * L.sx;
  vi_tendency<T, KV, kVel>
      <<<(total + kThreads - 1) / kThreads, kThreads, 0,
         (cudaStream_t)stream>>>((const T*)u, (const T*)v, (const T*)w,
                                 (T*)gu, (T*)gv, L, (const T*)m, (T)eps);
  return (int)cudaGetLastError();
}

template <typename T, int KV>
int launch_order(const void* u, const void* v, const void* w, void* gu,
                 void* gv, const Layout& L, const void* m, int velocity,
                 double eps, void* stream) {
  if (velocity) {
    return launch_kernel<T, KV, true>(u, v, w, gu, gv, L, m, eps, stream);
  }
  return launch_kernel<T, KV, false>(u, v, w, gu, gv, L, m, eps, stream);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, void* gu, void* gv,
           int nx, int ny, int nz, const void* m, int order, int velocity,
           double eps, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const Layout L{nx, ny, nz, ny * nz};
  // the vorticity orders of VORTICITY_ORDERS in ops/cuda_vi.py
  switch (order) {
    case 5:
      return launch_order<T, 5>(u, v, w, gu, gv, L, m, velocity, eps, stream);
    case 9:
      return launch_order<T, 9>(u, v, w, gu, gv, L, m, velocity, eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ot_vi_tendency_f32(const void* u, const void* v, const void* w, void* gu,
                       void* gv, int nx, int ny, int nz, const void* m,
                       int order, int velocity, double eps, void* stream) {
  return launch<float>(u, v, w, gu, gv, nx, ny, nz, m, order, velocity, eps,
                       stream);
}

int ot_vi_tendency_f64(const void* u, const void* v, const void* w, void* gu,
                       void* gv, int nx, int ny, int nz, const void* m,
                       int order, int velocity, double eps, void* stream) {
  return launch<double>(u, v, w, gu, gv, nx, ny, nz, m, order, velocity, eps,
                        stream);
}

}  // extern "C"
