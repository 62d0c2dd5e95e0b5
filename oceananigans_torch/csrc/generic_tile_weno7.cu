// The WENO(7) instantiation of the generic momentum tile (generic_tile.h),
// and the mixed schemes of reach 4 (FluxFormAdvection), in float32 and
// float64.

#include "generic_tile.h"

namespace ot_generic {
OT_GENERIC_SEL(Fixed<Weno<7>>)
OT_GENERIC_SEL(ByReach<4>)
}  // namespace ot_generic
