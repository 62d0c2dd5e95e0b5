// The C entry points of the generic momentum tile (generic_tile.h): one
// launch of generic_march for (Gu, Gv, Gw) = -div(v (x) v) with a scheme
// per axis. One scheme on all three axes takes its own instantiation
// (Fixed<R>, compiled with its kind or WENO order in generic_tile_*.cu); a
// FluxFormAdvection of different schemes takes the one of its largest reach
// (ByReach<B>). A code that is not a scheme raises cudaErrorInvalidValue;
// nothing falls back to another kernel.

#include "generic_tile.h"

namespace ot_generic {

OT_GENERIC_EXTERN(Fixed<Centered<2>>)
OT_GENERIC_EXTERN(Fixed<Centered<4>>)
OT_GENERIC_EXTERN(Fixed<Centered<6>>)
OT_GENERIC_EXTERN(Fixed<Centered<8>>)
OT_GENERIC_EXTERN(Fixed<Centered<10>>)
OT_GENERIC_EXTERN(Fixed<Centered<12>>)
OT_GENERIC_EXTERN(Fixed<Upwind<1>>)
OT_GENERIC_EXTERN(Fixed<Upwind<3>>)
OT_GENERIC_EXTERN(Fixed<Upwind<5>>)
OT_GENERIC_EXTERN(Fixed<Upwind<7>>)
OT_GENERIC_EXTERN(Fixed<Upwind<9>>)
OT_GENERIC_EXTERN(Fixed<Upwind<11>>)
OT_GENERIC_EXTERN(Fixed<Weno<3>>)
OT_GENERIC_EXTERN(Fixed<Weno<5>>)
OT_GENERIC_EXTERN(Fixed<Weno<7>>)
OT_GENERIC_EXTERN(Fixed<Weno<9>>)
OT_GENERIC_EXTERN(Fixed<Weno<11>>)
OT_GENERIC_EXTERN(ByReach<1>)
OT_GENERIC_EXTERN(ByReach<2>)
OT_GENERIC_EXTERN(ByReach<3>)
OT_GENERIC_EXTERN(ByReach<4>)
OT_GENERIC_EXTERN(ByReach<5>)
OT_GENERIC_EXTERN(ByReach<6>)

namespace {

template <typename T>
int fixed(const GenericArgs& A) {
  switch (A.code[0]) {
#define OT_CASE(R) \
  case R::kCode:   \
    return generic_launch<T, Fixed<R>>(A);
    OT_CASE(Centered<2>) OT_CASE(Centered<4>) OT_CASE(Centered<6>)
    OT_CASE(Centered<8>) OT_CASE(Centered<10>) OT_CASE(Centered<12>)
    OT_CASE(Upwind<1>) OT_CASE(Upwind<3>) OT_CASE(Upwind<5>)
    OT_CASE(Upwind<7>) OT_CASE(Upwind<9>) OT_CASE(Upwind<11>)
    OT_CASE(Weno<3>) OT_CASE(Weno<5>) OT_CASE(Weno<7>) OT_CASE(Weno<9>)
    OT_CASE(Weno<11>)
#undef OT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool valid_code(int c) {
  const int kind = c / 16, order = c % 16;
  switch (kind) {
    case kCentered: return order % 2 == 0 && order >= 2 && order <= 12;
    case kUpwind: return order % 2 == 1 && order >= 1 && order <= 11;
    case kWeno: return order % 2 == 1 && order >= 3 && order <= 11;
    default: return false;
  }
}

template <typename T>
int launch(const GenericArgs& A) {
  for (int q = 0; q < 3; ++q) {
    if (!valid_code(A.code[q])) return (int)cudaErrorInvalidValue;
  }
  if (A.code[0] == A.code[1] && A.code[1] == A.code[2]) return fixed<T>(A);
  int B = reach(A.code[0]);
  B = reach(A.code[1]) > B ? reach(A.code[1]) : B;
  B = reach(A.code[2]) > B ? reach(A.code[2]) : B;
  switch (B) {
    case 1: return generic_launch<T, ByReach<1>>(A);
    case 2: return generic_launch<T, ByReach<2>>(A);
    case 3: return generic_launch<T, ByReach<3>>(A);
    case 4: return generic_launch<T, ByReach<4>>(A);
    case 5: return generic_launch<T, ByReach<5>>(A);
    case 6: return generic_launch<T, ByReach<6>>(A);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ot_generic

extern "C" {

// The plan (py, pz, seg_len, nseg) is ops/cuda_generic.py: momentum_plan's.
#define OT_GENERIC_ENTRY(SUFFIX, T)                                        \
  int ot_generic_momentum_##SUFFIX(                                        \
      const void* u, const void* v, const void* w, void* gu, void* gv,     \
      void* gw, int nx, int ny, int nz, int h, int cx, int cy, int cz,     \
      double ax, double ay, double az, double vol, double ex, double ey,   \
      double ez, int py, int pz, int seg_len, int nseg, void* stream) {    \
    const ot_generic::GenericArgs A{u,  v,  w,  gu, gv, gw,               \
                                    nx, ny, nz, h,  {cx, cy, cz},         \
                                    {ax, ay, az},   vol,                  \
                                    {ex, ey, ez},   py, pz, seg_len,      \
                                    nseg, stream};                        \
    return ot_generic::launch<T>(A);                                       \
  }

OT_GENERIC_ENTRY(f32, float)
OT_GENERIC_ENTRY(f64, double)

#undef OT_GENERIC_ENTRY

// The dynamic shared memory of one block of the generic momentum tile of
// largest reach B for a py x pz panel, in float32 (itemsize 4) or float64.
// For reports and checks.
long long ot_generic_smem_bytes(int B, int py, int pz, int itemsize) {
  return (long long)(itemsize == 4
                         ? ot_generic::tile_bytes<float>(B, py, pz)
                         : ot_generic::tile_bytes<double>(B, py, pz));
}

}  // extern "C"
