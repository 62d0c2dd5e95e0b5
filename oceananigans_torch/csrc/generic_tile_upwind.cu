// The UpwindBiased(1..11) instantiations of the generic momentum tile
// (generic_tile.h), in float32 and float64.

#include "generic_tile.h"

namespace ot_generic {
OT_GENERIC_SEL(Fixed<Upwind<1>>)
OT_GENERIC_SEL(Fixed<Upwind<3>>)
OT_GENERIC_SEL(Fixed<Upwind<5>>)
OT_GENERIC_SEL(Fixed<Upwind<7>>)
OT_GENERIC_SEL(Fixed<Upwind<9>>)
OT_GENERIC_SEL(Fixed<Upwind<11>>)
}  // namespace ot_generic
