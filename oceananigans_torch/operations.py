"""Field operations and derived diagnostics.

Counterpart of ``oceananigans_tpu/operations.py`` (reference
``src/AbstractOperations/``). The reference builds lazy expression trees
that a ``compute!`` pass materialises; here they are plain functions on
tensors over ``ops/operators.py``, evaluated where they are called.
Locations are explicit arguments (the reference's ``@at``); the metric
reductions weight with the grid's Δx, Δy and Δz.

Axes count from the end, as the operators do: ``X``, ``Y`` and ``Z`` are
the last three axes of a field, so a leading axis (an ensemble's members)
passes through. A ``dims`` given as 0, 1 or 2 names x, y or z, as in the
JAX package.
"""

from __future__ import annotations

import torch

from oceananigans_torch.fields import LOC_C, interior
from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops.operators import (
    X, Y, Z, ddx_c, ddx_f, ddy_c, ddy_f, ddz_c, ddz_f, divergence_ccc, ix_c,
    ix_f, iy_c, iy_f, iz_c, iz_f, kinetic_energy_cc, laplacian_ccc,
    vorticity_z_ff,
)

__all__ = [
    "dx", "dy", "dz", "at",
    "Average", "Integral", "CumulativeIntegral", "ConditionalAverage",
    "Reduction", "Accumulation", "KernelFunctionOperation",
    "vertical_vorticity", "kinetic_energy", "divergence", "laplacian",
    "speed",
]


# ---------------------------------------------------------------------------
# Derivatives with explicit locations (reference ∂x/∂y/∂z operators)
# ---------------------------------------------------------------------------

def dx(grid, a, loc=LOC_C):
    """∂a/∂x; the result moves to the complementary x-staggering."""
    return (ddx_f(grid, a, loc[1]) if loc[0] == Center
            else ddx_c(grid, a, loc[1]))


def dy(grid, a, loc=LOC_C):
    return (ddy_f(grid, a, loc[0]) if loc[1] == Center
            else ddy_c(grid, a, loc[0]))


def dz(grid, a, loc=LOC_C):
    return ddz_f(grid, a) if loc[2] == Center else ddz_c(grid, a)


_INTERPS = {(Center, Face): (ix_f, iy_f, iz_f),
            (Face, Center): (ix_c, iy_c, iz_c)}


def at(grid, a, from_loc, to_loc):
    """Interpolate ``a`` from one staggered location to another (the
    reference's ``@at``)."""
    for axis in range(3):
        key = (from_loc[axis], to_loc[axis])
        if key in _INTERPS:
            a = _INTERPS[key][axis](a)
    return a


# ---------------------------------------------------------------------------
# Metric reductions (reference metric_field_reductions.jl)
# ---------------------------------------------------------------------------

def _weights(grid, loc, dims):
    w = torch.ones((), dtype=grid.dtype, device=grid.device)
    if X in dims:
        w = w * grid.dx(loc[0], loc[1])
    if Y in dims:
        w = w * grid.dy(loc[1], loc[0])
    if Z in dims:
        w = w * grid.dz(loc[2])
    return torch.broadcast_to(w, grid.shape)


def _norm_dims(dims):
    """``dims`` as a tuple of axes counted from the end (0, 1 and 2 name
    x, y and z)."""
    if dims is None:
        return (X, Y, Z)
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(d - 3 if d >= 0 else d for d in dims)


def Average(grid, a, dims=None, loc=LOC_C, condition=None):
    """Metric-weighted mean over ``dims`` of the interior; ``condition``
    (a boolean field) masks the points it is False at."""
    dims = _norm_dims(dims)
    w = interior(grid, _weights(grid, loc, dims))
    ai = interior(grid, a)
    if condition is not None:
        w = torch.where(interior(grid, condition).bool(), w, 0.0)
    num = torch.sum(ai * w, dim=dims, keepdim=True)
    den = torch.sum(w + torch.zeros_like(ai), dim=dims, keepdim=True)
    return num / den


def Integral(grid, a, dims=None, loc=LOC_C):
    dims = _norm_dims(dims)
    w = interior(grid, _weights(grid, loc, dims))
    return torch.sum(interior(grid, a) * w, dim=dims, keepdim=True)


def CumulativeIntegral(grid, a, dim=Z, loc=LOC_C):
    (dim,) = _norm_dims(dim)
    w = interior(grid, _weights(grid, loc, (dim,)))
    return torch.cumsum(interior(grid, a) * w, dim=dim)


def ConditionalAverage(grid, a, condition, dims=None, loc=LOC_C):
    """Masked average (the reference's ``ConditionalOperation`` and a
    reduction)."""
    return Average(grid, a, dims=dims, loc=loc, condition=condition)


def Reduction(op, grid, a, dims=None):
    """Reduce the interior of ``a`` with ``op`` over ``dims``; ``op`` takes
    ``dim=`` and ``keepdim=`` (``torch.sum``, ``torch.amax``,
    ``torch.mean``). The metric-weighted reductions are :func:`Average`
    and :func:`Integral`."""
    return op(interior(grid, a), dim=_norm_dims(dims), keepdim=True)


def Accumulation(op, grid, a, dims=Z):
    """Accumulate the interior of ``a`` with a cumulative ``op`` along one
    axis; ``op`` takes ``dim=`` (``torch.cumsum``; of an op that returns
    values and indices, as ``torch.cummax`` does, the values). The
    metric-weighted form is :func:`CumulativeIntegral`."""
    (dim,) = _norm_dims(dims)
    out = op(interior(grid, a), dim=dim)
    return out if isinstance(out, torch.Tensor) else out.values


def KernelFunctionOperation(func, grid, *args, **kwargs):
    """Evaluate ``func(grid, *args, **kwargs)``: the reference's
    ``KernelFunctionOperation`` without the lazy wrapper."""
    return func(grid, *args, **kwargs)


# ---------------------------------------------------------------------------
# Derived fields (the reference's stock KernelFunctionOperations)
# ---------------------------------------------------------------------------

def vertical_vorticity(grid, u, v):
    """ζ at (Face, Face, Center)."""
    return vorticity_z_ff(grid, u, v)


def kinetic_energy(grid, u, v, w=None):
    """½|u|² at centers."""
    return kinetic_energy_cc(grid, u, v, w)


def speed(grid, u, v, w=None):
    return torch.sqrt(2.0 * kinetic_energy_cc(grid, u, v, w))


def divergence(grid, u, v, w):
    return divergence_ccc(grid, u, v, w)


def laplacian(grid, c):
    return laplacian_ccc(grid, c)
