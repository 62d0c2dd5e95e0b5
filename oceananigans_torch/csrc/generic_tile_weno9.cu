// The WENO(9) instantiation of the generic momentum tile (generic_tile.h),
// and the mixed schemes of reach 5 (FluxFormAdvection), in float32 and
// float64.

#include "generic_tile.h"

namespace ot_generic {
OT_GENERIC_SEL(Fixed<Weno<9>>)
OT_GENERIC_SEL(ByReach<5>)
}  // namespace ot_generic
