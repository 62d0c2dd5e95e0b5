"""Fields as plain halo-extended tensors, plus location conventions.

Counterpart of ``oceananigans_tpu/fields.py``. A field is a tensor shaped
``grid.shape`` on the grid's device; its staggered location travels in
function arguments (``loc`` tuples), not in the tensor.

    u : (Face,   Center, Center)     w : (Center, Center, Face)
    v : (Center, Face,   Center)     tracers, p, b : (Center, Center, Center)

Lazy analytic fields (``FunctionField``, ``ConstantField``, ``ZeroField``)
are callables of the coordinates, accepted wherever a field-valued argument
is (initial conditions, closure coefficients); ``BackgroundField`` is a
callable of the coordinates and time.
"""

from __future__ import annotations

import numpy as np
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
    """Broadcast-ready (x, y, z) coordinate tensors at a staggered location:
    (λ, φ, z) on the spherical grids, whose λ and φ are (nx, ny, 1) on an
    orthogonal grid."""
    return tuple(getattr(grid, f"{name}F" if loc[axis] == Face
                         else f"{name}C")
                 for axis, name in enumerate(AXIS_NAMES))


def set_field(grid, value, loc=LOC_C, dtype=None):
    """A field from a number, an interior- or full-shaped array (or one that
    broadcasts against the interior), or a callable ``f(x, y, z)`` of
    broadcast-ready coordinate tensors evaluated at the staggered nodes.
    Halos are left unfilled."""
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


def interior_xy(grid, a):
    """Interior view of a reduced ``(nx, ny, 1)`` field (the free
    surface)."""
    sx, sy, _ = grid.interior_slices
    return a[..., sx, sy, :]


def with_interior(grid, a, values):
    """A copy of ``a`` with its interior set to ``values``."""
    out = a.clone()
    out[grid.interior_slices] = torch.as_tensor(values, dtype=a.dtype,
                                                device=a.device)
    return out


# ---------------------------------------------------------------------------
# Reductions over the interior
# ---------------------------------------------------------------------------

def _interior_volumes(grid, loc):
    return interior(grid, grid.V(*loc).expand(grid.shape))


def field_sum(grid, a, loc=LOC_C):
    """Sum of the interior values."""
    return torch.sum(interior(grid, a))


def field_max(grid, a):
    return torch.max(interior(grid, a))


def field_min(grid, a):
    return torch.min(interior(grid, a))


def field_abs_max(grid, a):
    return torch.max(torch.abs(interior(grid, a)))


def field_mean(grid, a, loc=LOC_C):
    """Volume-weighted mean over the interior of a field at ``loc``."""
    Vi = _interior_volumes(grid, loc)
    return torch.sum(interior(grid, a) * Vi) / torch.sum(Vi)


def field_integral(grid, a, loc=LOC_C):
    """Volume integral over the interior of a field at ``loc``."""
    return torch.sum(interior(grid, a) * _interior_volumes(grid, loc))


# ---------------------------------------------------------------------------
# Conservative regridding along one axis and point interpolation
# ---------------------------------------------------------------------------

def _overlap_matrix(src_edges, dst_edges):
    """(Nd, Ns) weight matrix: row k holds each source cell's fractional
    overlap with destination cell k (conservative first-order remap)."""
    Nd = len(dst_edges) - 1
    W = np.zeros((Nd, len(src_edges) - 1))
    for k in range(Nd):
        lo, hi = dst_edges[k], dst_edges[k + 1]
        ov = (np.minimum(hi, src_edges[1:])
              - np.maximum(lo, src_edges[:-1])).clip(min=0.0)
        W[k] = ov / max(hi - lo, 1e-30)
    return W


def _axis_edges(grid, axis):
    """The N + 1 interior faces of ``axis``, in its own coordinate (metres
    or degrees); an axis of an orthogonal grid's 2-D nodes has none."""
    f = getattr(grid, f"{AXIS_NAMES[axis]}F")
    if f.shape[axis] != f.numel():
        raise ValueError(f"regrid along {AXIS_NAMES[axis]} needs 1-D "
                         f"coordinates; {type(grid).__name__} has 2-D ones")
    f = f.reshape(-1).cpu().double()
    H, N = grid.H[axis], grid.N[axis]
    # the right wall face of the last interior cell, one regular spacing
    # past the last left face where no halo slot holds it
    right = f[H + N] if H + N < f.numel() else (
        f[H + N - 1] + (grid.Lx, grid.Ly, grid.Lz)[axis] / N)
    return np.append(f[H:H + N].numpy(), float(right))


def regrid(src_grid, dst_grid, a, loc=LOC_C, axis=2):
    """Conservative regridding along ONE axis between two grids that share
    the other axes' layout: overlap-weighted cell averages, which conserve
    the integral along that axis exactly."""
    W = _overlap_matrix(_axis_edges(src_grid, axis),
                        _axis_edges(dst_grid, axis))
    ai = interior(src_grid, a)
    sub = {0: "sjk,ds->djk", 1: "isk,ds->idk", 2: "ijs,ds->ijd"}[axis]
    out = torch.einsum(sub, ai, torch.as_tensor(W, dtype=ai.dtype,
                                                device=ai.device))
    res = new_field(dst_grid, a.dtype)
    res[dst_grid.interior_slices] = out
    return res


def regrid_x(src_grid, dst_grid, a, loc=LOC_C):
    return regrid(src_grid, dst_grid, a, loc=loc, axis=0)


def regrid_y(src_grid, dst_grid, a, loc=LOC_C):
    return regrid(src_grid, dst_grid, a, loc=loc, axis=1)


def regrid_z(src_grid, dst_grid, a, loc=LOC_C):
    """Conservative vertical regridding (∫ a dz per column is kept)."""
    return regrid(src_grid, dst_grid, a, loc=loc, axis=2)


def _fractional_index(xs, x):
    """Continuous index of ``x`` in the sorted 1-D coordinates ``xs`` (halo
    included)."""
    i = torch.clamp(torch.searchsorted(xs, x, right=True) - 1, 0,
                    xs.numel() - 2)
    x0, x1 = xs[i], xs[i + 1]
    frac = (x - x0) / torch.where(x1 == x0, torch.ones_like(x1), x1 - x0)
    return i, torch.clamp(frac, 0.0, 1.0)


def interpolate(grid, a, loc, x, y, z):
    """Trilinear interpolation of field ``a`` (location ``loc``) at the
    point(s) ``(x, y, z)`` (numbers or 1-D tensors of equal length)."""
    idxs, fracs = [], []
    for carr, q in zip(location_coords(grid, loc), (x, y, z)):
        c1 = carr.reshape(-1)
        q = torch.as_tensor(q, dtype=c1.dtype, device=c1.device)
        if c1.numel() == 1:
            idxs.append(torch.zeros(q.shape, dtype=torch.long,
                                    device=c1.device))
            fracs.append(torch.zeros(q.shape, dtype=a.dtype,
                                     device=c1.device))
        else:
            i, f = _fractional_index(c1, q.contiguous())
            idxs.append(i)
            fracs.append(f.to(a.dtype))
    ix, iy, iz = idxs
    fx, fy, fz = fracs

    def g(dx_, dy_, dz_):
        return a[torch.clamp(ix + dx_, max=a.shape[0] - 1),
                 torch.clamp(iy + dy_, max=a.shape[1] - 1),
                 torch.clamp(iz + dz_, max=a.shape[2] - 1)]

    return ((1 - fx) * (1 - fy) * (1 - fz) * g(0, 0, 0)
            + fx * (1 - fy) * (1 - fz) * g(1, 0, 0)
            + (1 - fx) * fy * (1 - fz) * g(0, 1, 0)
            + fx * fy * (1 - fz) * g(1, 1, 0)
            + (1 - fx) * (1 - fy) * fz * g(0, 0, 1)
            + fx * (1 - fy) * fz * g(1, 0, 1)
            + (1 - fx) * fy * fz * g(0, 1, 1)
            + fx * fy * fz * g(1, 1, 1))


# ---------------------------------------------------------------------------
# Lazy analytic fields: callables of the grid coordinates
# ---------------------------------------------------------------------------

def FunctionField(fn):
    """A lazy field defined by ``fn(x, y, z)``."""
    return fn


def ConstantField(value):
    """A lazy field with a uniform value."""
    def fn(*coords):
        return value + 0.0 * coords[0]
    return fn


def ZeroField():
    return ConstantField(0.0)


# ---------------------------------------------------------------------------
# Field constructors at the standard locations
# ---------------------------------------------------------------------------

def Field(grid, value=0.0, loc=LOC_C, dtype=None):
    """A halo-extended tensor at ``loc`` initialised from ``value`` (a
    number, an interior- or full-shaped array, or ``f(x, y, z)``)."""
    return set_field(grid, value, loc=loc, dtype=dtype)


def CenterField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_C, dtype=dtype)


def XFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_U, dtype=dtype)


def YFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_V, dtype=dtype)


def ZFaceField(grid, value=0.0, dtype=None):
    return set_field(grid, value, loc=LOC_W, dtype=dtype)


class BackgroundField:
    """A background field ``func(x, y, z, t[, parameters])``, evaluated by
    the nonhydrostatic model's ``background_fields=`` at each step's clock
    time; ``t`` defaults to 0, so an instance also serves as a static
    ``set_field`` initializer."""

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def __call__(self, x, y, z, t=0.0):
        if self.parameters is None:
            return self.func(x, y, z, t)
        return self.func(x, y, z, t, self.parameters)

    def __repr__(self):
        return (f"BackgroundField({self.func!r}, "
                f"parameters={self.parameters!r})")


__all__ = ["BackgroundField", "CenterField", "ConstantField", "Field",
           "FunctionField", "LOC_C", "LOC_U", "LOC_V", "LOC_W", "XFaceField",
           "YFaceField", "ZFaceField", "ZeroField", "field_abs_max",
           "field_integral", "field_max", "field_mean", "field_min",
           "field_sum", "interior", "interior_xy", "interpolate",
           "location_coords", "new_field", "regrid", "regrid_x", "regrid_y",
           "regrid_z", "set_field", "with_interior"]
