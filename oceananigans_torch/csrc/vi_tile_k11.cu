// The order-11 instantiations of the x-marching tiles of vi_tile.h: the
// vector-invariant kernel with WENO(11) vorticity, the other schemes
// all WENO(5), all WENO(11) or each of its own runtime order, either vorticity
// stencil, and the WENO(11) tracer kernel, in float32 and float64.

#include "vi_tile.h"

OT_MARCH_ORDER(11)
