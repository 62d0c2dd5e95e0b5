// The C entry points of the x-marching vector-invariant and WENO tracer
// tiles (vi_tile.h); each order is compiled in its own translation unit,
// vi_tile_k<K>.cu.

#include "vi_tile.h"

namespace ot_march {

#define OT_MARCH_EXTERN(K)                                          \
  extern template int vi_order<float, K>(const ViArgs&);           \
  extern template int vi_order<double, K>(const ViArgs&);          \
  extern template int tracer_order<float, K>(const TracerArgs&);   \
  extern template int tracer_order<double, K>(const TracerArgs&);
OT_MARCH_EXTERN(3)
OT_MARCH_EXTERN(5)
OT_MARCH_EXTERN(7)
OT_MARCH_EXTERN(9)
OT_MARCH_EXTERN(11)
#undef OT_MARCH_EXTERN

namespace {

template <typename T>
int vi(const ViArgs& A, int order) {
  switch (order) {
    case 3: return vi_order<T, 3>(A);
    case 5: return vi_order<T, 5>(A);
    case 7: return vi_order<T, 7>(A);
    case 9: return vi_order<T, 9>(A);
    case 11: return vi_order<T, 11>(A);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int tracers(const TracerArgs& A, int order) {
  switch (order) {
    case 3: return tracer_order<T, 3>(A);
    case 5: return tracer_order<T, 5>(A);
    case 7: return tracer_order<T, 7>(A);
    case 9: return tracer_order<T, 9>(A);
    case 11: return tracer_order<T, 11>(A);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int KV, int KR>
long long vi_bytes(int velocity, int py, int pz) {
  return (long long)(velocity ? ViShape<KV, KR, true>::template bytes<T>(py, pz)
                              : ViShape<KV, KR, false>::template bytes<T>(py, pz));
}

// rest_order 0: the instantiation of runtime orders
template <typename T, int K>
long long vi_bytes_of(int rest_order, int velocity, int py, int pz) {
  if (rest_order == 5) return vi_bytes<T, K, 5>(velocity, py, pz);
  if (rest_order == K) return vi_bytes<T, K, K>(velocity, py, pz);
  if (rest_order == 0) return vi_bytes<T, K, 0>(velocity, py, pz);
  return -1;
}

template <typename T, int K>
long long march_bytes(int vi, int rest_order, int velocity, int py, int pz) {
  return vi ? vi_bytes_of<T, K>(rest_order, velocity, py, pz)
            : (long long)TracerShape<K>::template bytes<T>(py, pz);
}

template <typename T>
long long smem_bytes(int vi, int order, int rest_order, int velocity, int py,
                     int pz) {
  switch (order) {
    case 3: return march_bytes<T, 3>(vi, rest_order, velocity, py, pz);
    case 5: return march_bytes<T, 5>(vi, rest_order, velocity, py, pz);
    case 7: return march_bytes<T, 7>(vi, rest_order, velocity, py, pz);
    case 9: return march_bytes<T, 9>(vi, rest_order, velocity, py, pz);
    case 11: return march_bytes<T, 11>(vi, rest_order, velocity, py, pz);
    default: return -1;
  }
}

}  // namespace
}  // namespace ot_march

extern "C" {

// The plan (py, pz, seg_len, nseg) is ops/march.py: march_plan's;
// the kernels refuse one that misses an x-row. The orders and epsilons are
// those of the vorticity, kinetic energy gradient, divergence and vertical
// schemes.
#define OT_VI_ENTRY(SUFFIX, T)                                              \
  int ot_vi_march_##SUFFIX(                                                 \
      const void* u, const void* v, const void* w, void* gu, void* gv,      \
      int nx, int ny, int nz, const void* m, int vorticity_order,           \
      int ke_order, int div_order, int vert_order, int velocity, int py,    \
      int pz, int seg_len, int nseg, double eps_v, double eps_k,            \
      double eps_d, double eps_z, void* stream) {                           \
    const ot_march::ViArgs A{u,        v,         w,          gu,          \
                             gv,       nx,        ny,         nz,          \
                             m,        ke_order,  div_order,  vert_order,  \
                             velocity, py,        pz,         seg_len,     \
                             nseg,     eps_v,     eps_k,      eps_d,       \
                             eps_z,    stream};                             \
    return ot_march::vi<T>(A, vorticity_order);                             \
  }                                                                         \
  int ot_weno_tracer_march_##SUFFIX(                                        \
      const void* u, const void* v, const void* w, const void* const* c,    \
      void* const* g, int n, int nx, int ny, int nz, const void* m,         \
      int order, int py, int pz, int seg_len, int nseg, double eps,         \
      void* stream) {                                                       \
    const ot_march::TracerArgs A{u,  v,  w,  c,       g,    n,   nx,       \
                                 ny, nz, m,  py,      pz,   seg_len,       \
                                 nseg, eps, stream};                        \
    return ot_march::tracers<T>(A, order);                                  \
  }

OT_VI_ENTRY(f32, float)
OT_VI_ENTRY(f64, double)

#undef OT_VI_ENTRY

// The dynamic shared memory of one block of the vector-invariant kernel
// (vi != 0; vorticity order `order`, the rest `rest_order`, 0 for the
// instantiation of runtime orders) or of the tracer kernel (order `order`)
// for a panel of py x pz, in float32 (itemsize 4) or float64; -1 for an
// order that is not instantiated. For reports (tools/kernel_times.py).
long long ot_march_smem_bytes(int vi, int order, int rest_order,
                              int velocity, int py, int pz, int itemsize) {
  return itemsize == 4
             ? ot_march::smem_bytes<float>(vi, order, rest_order, velocity,
                                           py, pz)
             : ot_march::smem_bytes<double>(vi, order, rest_order, velocity,
                                            py, pz);
}

}  // extern "C"
