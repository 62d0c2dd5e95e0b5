"""Fields as plain halo-extended tensors, plus location conventions.

Counterpart of ``oceananigans_tpu/fields.py``. A field is a tensor shaped
``grid.shape`` on the grid's device; its staggered location travels in
function arguments (``loc`` tuples), not in the tensor.

    u : (Face,   Center, Center)     w : (Center, Center, Face)
    v : (Center, Face,   Center)     p : (Center, Center, Center)
"""

from __future__ import annotations

import torch

from oceananigans_torch.grids.base import AXIS_NAMES, Center, Face

LOC_U = (Face, Center, Center)
LOC_V = (Center, Face, Center)
LOC_W = (Center, Center, Face)
LOC_C = (Center, Center, Center)


def new_field(grid, dtype=None):
    """A zeroed halo-extended tensor on ``grid``'s device."""
    return torch.zeros(grid.shape, dtype=dtype or grid.dtype,
                       device=grid.device)


def location_coords(grid, loc):
    """Broadcast-ready (x, y, z) coordinate tensors at a staggered location."""
    return tuple(getattr(grid, f"{name}F" if loc[axis] == Face
                         else f"{name}C")
                 for axis, name in enumerate(AXIS_NAMES))


def set_field(grid, value, loc=LOC_C, dtype=None):
    """A field from a number, an interior- or full-shaped array, or a
    callable ``f(x, y, z)`` of broadcast-ready coordinate tensors evaluated
    at the staggered nodes. Halos are left unfilled."""
    a = new_field(grid, dtype)
    if callable(value):
        x, y, z = location_coords(grid, loc)
        vals = torch.as_tensor(value(x, y, z), dtype=a.dtype,
                               device=a.device)
        return vals.expand(a.shape).clone()
    value = torch.as_tensor(value, dtype=a.dtype, device=a.device)
    if value.ndim == 0:
        return a.fill_(value)
    if tuple(value.shape) == tuple(grid.shape):
        return value.clone()
    a[grid.interior_slices] = value.expand(grid.N)
    return a


def interior(grid, a):
    """Interior view (no halos)."""
    return grid.interior(a)


def field_sum(grid, a, loc=LOC_C):
    """Sum of the interior values."""
    return torch.sum(interior(grid, a))


def field_integral(grid, a, loc=LOC_C):
    """Volume integral over the interior of a field at ``loc``."""
    V = grid.V(*loc).expand(grid.shape)
    return torch.sum(interior(grid, a) * interior(grid, V))


__all__ = ["LOC_C", "LOC_U", "LOC_V", "LOC_W", "field_integral",
           "field_sum", "interior", "location_coords", "new_field",
           "set_field"]
