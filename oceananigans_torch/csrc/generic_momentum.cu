// Momentum advection (Gu, Gv, Gw) = -div(v (x) v) with any scheme of the
// Python package's advection.py on a regular grid: Centered of orders 2..12,
// UpwindBiased of orders 1..11 and WENO-Z of orders 3..11, one scheme per
// axis (a FluxFormAdvection, or the same scheme on all three).
//
// Replaces the TPU kernel of oceananigans_tpu/ops/pallas_generic.py:
//   fused_momentum_tendency (the Pallas kernel that evaluates the whole-array
//   div_vu/div_vv/div_vw on x-windowed slabs) -> momentum_tendency<T>
// The TPU kernel traces the Python advection code into its body; here each
// reconstruction is a template instantiated from the literal tables of
// linear_tables.h (Centered, UpwindBiased) and weno_tables.h (WENO, through
// weno.h), and a scheme code per axis picks one at run time.
//
// Fields are halo-extended (nx, ny, nz) arrays, C-contiguous, z fastest.
// Output x-rows [h, nx-h) hold the tendencies and the x-halo rows zeros, as
// the TPU wrapper embeds its output. Every y and z point is computed, with
// neighbours wrapped modulo the full extent, as the plain version's
// whole-array operators (torch.roll) do, so the two agree on every point.
//
// Numerics, for a component c and an axis a: the field of c at offsets
// -B..B along a (B the axis scheme's reach) gives the reconstructions at
// the lower and the upper flux point of the cell; the advecting velocity
// there is the average of (A_a vel_a) over the two points next to it along
// c (along a itself where a == c), as advection.div_vu/vv/vw interpolate
// it. Each flux is that velocity times the face value: Centered is
// symmetric; UpwindBiased and WENO take the left-biased value where the
// velocity is > 0 and the right-biased one otherwise (the plain version
// averages the two where it is exactly 0, and the flux is 0 either way).
// G_c = -(((Dx + Dy) + Dz) * (1/V)) with D_a the upper minus the lower
// flux.
//
// Every operation is the plain version's, in its order, each product and
// sum rounded on its own (mul_rn/add_rn: no FMA contraction), and the
// division by the scalar V a product with its reciprocal, as PyTorch's CUDA
// division by a host scalar computes it; the WENO values come from
// weno.h's side_in_order. So the kernel rounds as the plain version does on
// the card. This matters for the high WENO orders in float32: their
// generated smoothness indicators sum terms with coefficients in the
// thousands, and a plain float32 WENO(11) tendency is ~1e-5 of its largest
// value away from its float64 one; two float32 evaluations in different
// orders differ by as much, the bound this kernel is held to.
//
// What bounds it on the H100: operations for the high orders (a WENO-5
// point does ~850 operations against 24 bytes moved in float32), bytes
// for the low-order linear schemes. Design: the simplest kernel that is
// right. One thread per output point and component (blockIdx.y is the
// component), z on the fastest thread index so a warp's loads are
// contiguous runs; neighbours through the read-only cache; each face value
// computed for the one side the velocity's sign selects, and each face
// computed twice, once for each cell it bounds. The three axes run in a
// loop that is not unrolled, so one thread holds one axis's reconstruction
// at a time and the registers are set by the largest scheme (WENO-11), not
// by three of them. Templates per (kind, order) with shared-memory tiles
// are later work.

#include <cuda_runtime.h>

#include "linear_tables.h"
#include "weno.h"

namespace {

using ot_weno::add_rn;
using ot_weno::mul_rn;
using ot_weno::wrap;

constexpr int kThreads = 256;

// scheme codes, as ops/cuda_generic.py encodes them: kind * 16 + order
constexpr int kCentered = 0;
constexpr int kUpwind = 1;
constexpr int kWeno = 2;

__host__ __device__ constexpr int code(int kind, int order) {
  return kind * 16 + order;
}

struct Layout {
  int nx, ny, nz, h;  // h: the x halo; nx * ny * nz < 2^31
};

template <typename T>
struct Axes {
  int code[3];
  T area[3];  // Ax, Ay, Az
  T eps[3];   // the WENO epsilon of each axis's scheme (unused otherwise)
  T inv_vol;  // 1 / V, rounded to T
};

// The face value of the taps s (the field at offsets -B.. from the flux
// point, s[m] at offset m - B) for an advecting velocity U.
template <int K>
struct CenteredR {
  using C = ot_linear::CenteredTable<K>;
  static constexpr int B = C::B;
  template <typename T>
  __device__ __forceinline__ static T value(const T* s, T, T) {
    T out = mul_rn(T(C::c(0)), s[0]);
#pragma unroll
    for (int j = 1; j < C::taps; ++j) {
      out = add_rn(out, mul_rn(T(C::c(j)), s[j]));
    }
    return out;
  }
};

template <int K>
struct UpwindR {
  using C = ot_linear::UpwindTable<K>;
  static constexpr int B = C::B;
  template <typename T>
  __device__ __forceinline__ static T value(const T* s, T U, T) {
    if (U > T(0)) {
      // offsets -B .. B-2, ascending
      T out = mul_rn(T(C::c(0)), s[0]);
#pragma unroll
      for (int j = 1; j < C::taps; ++j) {
        out = add_rn(out, mul_rn(T(C::c(j)), s[j]));
      }
      return out;
    }
    // the mirror: coefficient j at offset B-1-j, in ascending offsets
    T out = mul_rn(T(C::c(C::taps - 1)), s[2 * B - C::taps]);
#pragma unroll
    for (int j = C::taps - 2; j >= 0; --j) {
      out = add_rn(out, mul_rn(T(C::c(j)), s[2 * B - 1 - j]));
    }
    return out;
  }
};

template <int K>
struct WenoR {
  static constexpr int B = ot_weno::WenoTable<K>::B;
  template <typename T>
  __device__ __forceinline__ static T value(const T* s, T U, T eps) {
    if (U > T(0)) return ot_weno::side_in_order<K, false>(s, eps);
    return ot_weno::side_in_order<K, true>(s, eps);
  }
};

// The upper minus the lower flux of one axis: the line of field f through
// point p along the axis (index ia of na, stride sa) at offsets -B..B.
template <class R, typename T>
__device__ __forceinline__ T flux_difference(const T* __restrict__ f, int p,
                                             int ia, int na, int sa, T Ulo,
                                             T Uhi, T eps) {
  constexpr int B = R::B;
  const int base = p - ia * sa;
  T line[2 * B + 1];
#pragma unroll
  for (int d = -B; d <= B; ++d) {
    line[d + B] = __ldg(f + base + wrap(ia + d, na) * sa);
  }
  const T lo = mul_rn(Ulo, R::value(line, Ulo, eps));
  const T hi = mul_rn(Uhi, R::value(line + 1, Uhi, eps));
  return add_rn(hi, -lo);
}

#define OT_SCHEME_CASES(X)                                                 \
  X(kCentered, 2, CenteredR<2>) X(kCentered, 4, CenteredR<4>)              \
  X(kCentered, 6, CenteredR<6>) X(kCentered, 8, CenteredR<8>)              \
  X(kCentered, 10, CenteredR<10>) X(kCentered, 12, CenteredR<12>)          \
  X(kUpwind, 1, UpwindR<1>) X(kUpwind, 3, UpwindR<3>)                      \
  X(kUpwind, 5, UpwindR<5>) X(kUpwind, 7, UpwindR<7>)                      \
  X(kUpwind, 9, UpwindR<9>) X(kUpwind, 11, UpwindR<11>)                    \
  X(kWeno, 3, WenoR<3>) X(kWeno, 5, WenoR<5>) X(kWeno, 7, WenoR<7>)        \
  X(kWeno, 9, WenoR<9>) X(kWeno, 11, WenoR<11>)

template <typename T>
__device__ T axis_term(int scheme, const T* __restrict__ f, int p, int ia,
                       int na, int sa, T Ulo, T Uhi, T eps) {
  switch (scheme) {
#define OT_CASE(kind, order, R) \
  case code(kind, order):       \
    return flux_difference<R>(f, p, ia, na, sa, Ulo, Uhi, eps);
    OT_SCHEME_CASES(OT_CASE)
#undef OT_CASE
    default:
      return T(0);  // unreachable: the host checks every code
  }
}

template <typename X>
__device__ __forceinline__ X pick(int a, X x, X y, X z) {
  return a == 0 ? x : (a == 1 ? y : z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    momentum_tendency(const T* __restrict__ u, const T* __restrict__ v,
                      const T* __restrict__ w, T* __restrict__ gu,
                      T* __restrict__ gv, T* __restrict__ gw, Layout L,
                      Axes<T> S) {
  const int c = blockIdx.y;  // the component: 0 u, 1 v, 2 w
  const int sx = L.ny * L.nz;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= L.nx * sx) return;
  T* __restrict__ g = pick(c, gu, gv, gw);
  const int k = p % L.nz;
  const int t = p / L.nz;
  const int j = t % L.ny;
  const int i = t / L.ny;
  if (i < L.h || i >= L.nx - L.h) {
    g[p] = T(0);
    return;
  }
  const T* __restrict__ f = pick(c, u, v, w);
  // the point one cell back along the component's own axis
  const int ic = pick(c, i, j, k);
  const int nc = pick(c, L.nx, L.ny, L.nz);
  const int sc = pick(c, sx, L.nz, 1);
  const int back = (wrap(ic - 1, nc) - ic) * sc;
  T acc = T(0);
#pragma unroll 1
  for (int a = 0; a < 3; ++a) {
    const T* __restrict__ vel = pick(a, u, v, w);
    const T A = pick(a, S.area[0], S.area[1], S.area[2]);
    const int ia = pick(a, i, j, k);
    const int na = pick(a, L.nx, L.ny, L.nz);
    const int sa = pick(a, sx, L.nz, 1);
    const int fwd = (wrap(ia + 1, na) - ia) * sa;
    T Ulo, Uhi;
    if (a == c) {
      // ℑ to the centres a-1 and a of (A vel), vel at faces a-1, a, a+1
      const T q0 = mul_rn(A, __ldg(vel + p + back));
      const T q1 = mul_rn(A, __ldg(vel + p));
      const T q2 = mul_rn(A, __ldg(vel + p + fwd));
      Ulo = mul_rn(T(0.5), add_rn(q1, q0));
      Uhi = mul_rn(T(0.5), add_rn(q2, q1));
    } else {
      // ℑ along c of (A vel) at the faces a and a+1
      Ulo = mul_rn(T(0.5), add_rn(mul_rn(A, __ldg(vel + p)),
                                  mul_rn(A, __ldg(vel + p + back))));
      Uhi = mul_rn(T(0.5), add_rn(mul_rn(A, __ldg(vel + p + fwd)),
                                  mul_rn(A, __ldg(vel + p + fwd + back))));
    }
    acc = add_rn(acc, axis_term<T>(pick(a, S.code[0], S.code[1], S.code[2]),
                                   f, p, ia, na, sa, Ulo, Uhi,
                                   pick(a, S.eps[0], S.eps[1], S.eps[2])));
  }
  g[p] = -mul_rn(acc, S.inv_vol);
}

__host__ bool valid_code(int scheme) {
  switch (scheme) {
#define OT_CASE(kind, order, R) case code(kind, order):
    OT_SCHEME_CASES(OT_CASE)
#undef OT_CASE
    return true;
    default:
      return false;
  }
}

template <typename T>
int launch(const void* u, const void* v, const void* w, void* gu, void* gv,
           void* gw, int nx, int ny, int nz, int h, int cx, int cy, int cz,
           double ax, double ay, double az, double vol, double ex, double ey,
           double ez, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total >= (1LL << 31) || h < 1 || 2 * h > nx) {
    return (int)cudaErrorInvalidValue;
  }
  if (!valid_code(cx) || !valid_code(cy) || !valid_code(cz)) {
    return (int)cudaErrorInvalidValue;
  }
  if (total == 0) return 0;
  const Layout L{nx, ny, nz, h};
  Axes<T> S{};
  S.code[0] = cx;
  S.code[1] = cy;
  S.code[2] = cz;
  S.area[0] = (T)ax;
  S.area[1] = (T)ay;
  S.area[2] = (T)az;
  S.eps[0] = (T)ex;
  S.eps[1] = (T)ey;
  S.eps[2] = (T)ez;
  S.inv_vol = T(1) / (T)vol;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads), 3);
  momentum_tendency<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)v, (const T*)w, (T*)gu, (T*)gv, (T*)gw, L, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ot_generic_momentum_f32(const void* u, const void* v, const void* w,
                            void* gu, void* gv, void* gw, int nx, int ny,
                            int nz, int h, int cx, int cy, int cz, double ax,
                            double ay, double az, double vol, double ex,
                            double ey, double ez, void* stream) {
  return launch<float>(u, v, w, gu, gv, gw, nx, ny, nz, h, cx, cy, cz, ax,
                       ay, az, vol, ex, ey, ez, stream);
}

int ot_generic_momentum_f64(const void* u, const void* v, const void* w,
                            void* gu, void* gv, void* gw, int nx, int ny,
                            int nz, int h, int cx, int cy, int cz, double ax,
                            double ay, double az, double vol, double ex,
                            double ey, double ez, void* stream) {
  return launch<double>(u, v, w, gu, gv, gw, nx, ny, nz, h, cx, cy, cz, ax,
                        ay, az, vol, ex, ey, ez, stream);
}

}  // extern "C"
