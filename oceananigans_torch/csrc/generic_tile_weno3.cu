// The WENO(3) instantiation of the generic momentum tile (generic_tile.h),
// and the mixed schemes of reach 2 (FluxFormAdvection), in float32 and
// float64.

#include "generic_tile.h"

namespace ot_generic {
OT_GENERIC_SEL(Fixed<Weno<3>>)
OT_GENERIC_SEL(ByReach<2>)
}  // namespace ot_generic
