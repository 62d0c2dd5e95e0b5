"""Immersed boundaries: not ported yet.

Counterpart of ``oceananigans_tpu/immersed.py``, whose grid wrapper,
boundary objects and immersed Poisson solver come with ROADMAP Queue 1
item 13. Each name here raises ``NotImplementedError`` saying so. The cubed
sphere's hydrostatic model takes a grid-fitted bottom already, given as a
callable or an array of bottom heights (``models/cubed_sphere.py``).
"""

from __future__ import annotations

_ITEM13 = "ROADMAP Queue 1 item 13 (immersed boundaries) brings it"


def _not_ported(name):
    def factory(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet; {_ITEM13}")
    factory.__name__ = factory.__qualname__ = name
    factory.__doc__ = f"``{name}``: not ported yet ({_ITEM13})."
    return factory


ImmersedBoundaryGrid = _not_ported("ImmersedBoundaryGrid")
GridFittedBottom = _not_ported("GridFittedBottom")
GridFittedBoundary = _not_ported("GridFittedBoundary")
PartialCellBottom = _not_ported("PartialCellBottom")
ImmersedBoundaryCondition = _not_ported("ImmersedBoundaryCondition")

__all__ = ["GridFittedBottom", "GridFittedBoundary",
           "ImmersedBoundaryCondition", "ImmersedBoundaryGrid",
           "PartialCellBottom"]
