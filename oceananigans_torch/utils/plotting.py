"""Matplotlib field plots (the reference's Makie extension).

Counterpart of ``oceananigans_tpu/utils/plotting.py`` (reference
``ext/OceananigansMakieExt.jl``: heatmap and line recipes for fields with
their dimensionality deduced and grid-aware axis labels). A field is an
array on a grid, so the helpers take ``(grid, field)``: a tensor is copied
to the host first. They deduce the varying dimensions, take the coordinates
of the field's staggered location and label the axes per grid family
(metres on a rectilinear grid, degrees on a lat-lon one, also under an
``ImmersedBoundaryGrid``, whose solid cells are NaN so they render blank).
matplotlib is imported where a plot is drawn, so the package imports
without it.

    from oceananigans_torch.utils.plotting import fieldplot, heatmap

    heatmap(grid, state.tracers["b"])      # a 2-D field, labeled axes
    fieldplot(grid, state.tracers["T"])    # a line in 1-D, a heatmap in 2-D
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.fields import LOC_C

__all__ = ["fieldplot", "heatmap", "lineplot", "deduce_dimensionality"]


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)


def _underlying(grid):
    from oceananigans_torch.immersed import ImmersedBoundaryGrid
    return grid.underlying_grid if isinstance(grid, ImmersedBoundaryGrid) \
        else grid


def _axis_labels(grid):
    from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
    if isinstance(_underlying(grid), LatitudeLongitudeGrid):
        return ("Longitude (deg)", "Latitude (deg)", "z (m)")
    return ("x (m)", "y (m)", "z (m)")


def _interior(grid, a):
    """Interior values as a float64 host array, with an immersed grid's
    solid cells as NaN."""
    from oceananigans_torch.immersed import ImmersedBoundaryGrid
    vals = np.array(grid.interior(_host(a)), dtype=float)
    if isinstance(grid, ImmersedBoundaryGrid):
        solid = np.broadcast_to(_host(grid.interior(grid.solid_c)),
                                vals.shape)
        vals = np.where(solid, np.nan, vals)
    return vals


def deduce_dimensionality(grid, a):
    """(d1, d2, D): the first and last varying dimension of the field's
    interior and how many vary (reference ``deduce_dimensionality``)."""
    shape = grid.interior(_host(a)).shape[-3:]
    varying = [i for i, n in enumerate(shape) if n > 1]
    d1 = varying[0] if varying else 0
    d2 = varying[-1] if varying else 0
    return d1, d2, len(varying)


def _coords(grid, axis, loc):
    return _host(_underlying(grid).nodes_1d(axis, loc[axis]))


def lineplot(grid, a, loc=LOC_C, ax=None, **kwargs):
    """A 1-D field as a line along its varying dimension (a profile has
    the value on x and z on y)."""
    import matplotlib.pyplot as plt
    d1, _, D = deduce_dimensionality(grid, a)
    if D > 1:
        raise ValueError(f"lineplot needs a 1-D field, got D={D}")
    vals = _interior(grid, a).reshape(-1)
    x = _coords(grid, d1, loc)[:vals.size]
    if ax is None:
        _, ax = plt.subplots()
    labels = _axis_labels(grid)
    if d1 == 2:
        line, = ax.plot(vals, x, **kwargs)
        ax.set_ylabel(labels[2])
    else:
        line, = ax.plot(x, vals, **kwargs)
        ax.set_xlabel(labels[d1])
    return line


def heatmap(grid, a, loc=LOC_C, ax=None, colorbar=True, **kwargs):
    """A 2-D field as a pcolormesh with grid-aware axis labels (reference
    Makie ``heatmap(::Field)``); returns the QuadMesh."""
    import matplotlib.pyplot as plt
    d1, d2, D = deduce_dimensionality(grid, a)
    if D != 2:
        raise ValueError(f"heatmap needs a 2-D field, got D={D}")
    vals = np.squeeze(_interior(grid, a))
    x1 = _coords(grid, d1, loc)[:vals.shape[0]]
    x2 = _coords(grid, d2, loc)[:vals.shape[1]]
    if ax is None:
        _, ax = plt.subplots()
    mesh = ax.pcolormesh(x1, x2, vals.T, **kwargs)
    labels = _axis_labels(grid)
    ax.set_xlabel(labels[d1])
    ax.set_ylabel(labels[d2])
    if colorbar:
        ax.figure.colorbar(mesh, ax=ax)
    return mesh


def fieldplot(grid, a, loc=LOC_C, ax=None, **kwargs):
    """A line for a 1-D field, a heatmap for a 2-D one (reference
    ``_create_plot``)."""
    _, _, D = deduce_dimensionality(grid, a)
    if D <= 1:
        return lineplot(grid, a, loc=loc, ax=ax, **kwargs)
    if D == 2:
        return heatmap(grid, a, loc=loc, ax=ax, **kwargs)
    raise ValueError(
        "3-D field: slice it first (e.g. a[:, :, k]) or reduce it; "
        "volume rendering has no matplotlib analog")
