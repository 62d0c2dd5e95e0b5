// The Centered(2..12) instantiations of the generic momentum tile
// (generic_tile.h), and the mixed schemes of reach 1, in float32 and
// float64.

#include "generic_tile.h"

namespace ot_generic {
OT_GENERIC_SEL(Fixed<Centered<2>>)
OT_GENERIC_SEL(Fixed<Centered<4>>)
OT_GENERIC_SEL(Fixed<Centered<6>>)
OT_GENERIC_SEL(Fixed<Centered<8>>)
OT_GENERIC_SEL(Fixed<Centered<10>>)
OT_GENERIC_SEL(Fixed<Centered<12>>)
OT_GENERIC_SEL(ByReach<1>)
}  // namespace ot_generic
