// The order-3 instantiations of the x-marching tiles of vi_tile.h: the
// vector-invariant kernel with WENO(3) vorticity, the other schemes
// all WENO(5), all WENO(3) or each of its own runtime order, either vorticity
// stencil, and the WENO(3) tracer kernel, in float32 and float64.

#include "vi_tile.h"

OT_MARCH_ORDER(3)
