"""Boundary conditions and halo fills.

Counterpart of ``oceananigans_tpu/boundary_conditions.py`` for the cases
the nonhydrostatic slice needs: periodic axes, the no-flux mirror for
center-located data on Bounded axes, and the impenetrable wall
(``OpenBC(None)``) for wall-normal faces. Value, gradient, open-with-value,
radiation, polar and zipper conditions come with later slices.

Unlike the JAX package, ``fill_halo_regions`` writes the halo rings of its
argument in place and returns it: halos are derived data, and a fill that
copied the whole field would double the fill's memory traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from oceananigans_torch.grids.base import (
    AXIS_NAMES, Bounded, Center, Face, Flat, Periodic,
)

PERIODIC = "periodic"
FLUX = "flux"
OPEN = "open"


@dataclasses.dataclass
class BoundaryCondition:
    """A classification plus a condition (``None`` = homogeneous)."""
    classification: str
    condition: Any = None


def PeriodicBC():
    return BoundaryCondition(PERIODIC)


def FluxBC(q=None):
    return BoundaryCondition(FLUX, q)


def OpenBC(v=None):
    """Wall-normal boundary; only the impenetrable ``OpenBC(None)`` is
    ported."""
    return BoundaryCondition(OPEN, v)


@dataclasses.dataclass
class FieldBoundaryConditions:
    """west/east/south/north/bottom/top bundle."""
    west: Optional[BoundaryCondition] = None
    east: Optional[BoundaryCondition] = None
    south: Optional[BoundaryCondition] = None
    north: Optional[BoundaryCondition] = None
    bottom: Optional[BoundaryCondition] = None
    top: Optional[BoundaryCondition] = None

    def sides(self, axis: int):
        return ((self.west, self.east), (self.south, self.north),
                (self.bottom, self.top))[axis]


def default_bc(topo: str, loc: str, side: str) -> Optional[BoundaryCondition]:
    """Periodic axes -> periodic; Bounded + Center -> no-flux; Bounded +
    Face (wall-normal) -> impenetrable; Flat -> nothing."""
    if topo == Flat:
        return None
    if topo == Periodic:
        return PeriodicBC()
    if topo != Bounded:
        raise NotImplementedError(f"topology {topo!r} is not ported yet")
    if loc == Face:
        return OpenBC(None)
    return FluxBC(None)


def _check_ported(bc, topo, loc, name):
    ok = (bc.condition is None
          and ((topo == Periodic and bc.classification == PERIODIC)
               or (topo == Bounded and loc == Face
                   and bc.classification == OPEN)
               or (topo == Bounded and bc.classification == FLUX)))
    if not ok:
        raise NotImplementedError(
            f"{name} boundary condition {bc} on a {topo} axis at {loc!r} is "
            "not ported yet (value, gradient, open and valued flux "
            "conditions come with ROADMAP Queue 1 item 3)")


def regularize_field_boundary_conditions(bcs, grid, loc):
    """Fill unspecified sides of ``bcs`` with topology/location defaults."""
    if bcs is None:
        bcs = FieldBoundaryConditions()
    names = (("west", "east"), ("south", "north"), ("bottom", "top"))
    out = {}
    for axis in range(3):
        topo = grid.axis_topo(axis)
        for name in names[axis]:
            bc = getattr(bcs, name)
            if bc is None:
                bc = default_bc(topo, loc[axis], name)
            elif topo == Periodic and bc.classification != PERIODIC:
                raise ValueError(
                    f"non-periodic BC on periodic axis {AXIS_NAMES[axis]}")
            if bc is not None:
                _check_ported(bc, topo, loc[axis], name)
            out[name] = bc
    return FieldBoundaryConditions(**out)


def _fill_axis(a, grid, axis, loc_ax, left_bc, right_bc):
    """Fill both halo rings of one axis of ``a`` in place."""
    H, N = grid.H[axis], grid.N[axis]
    if H == 0:
        return a

    def rows(start, n=1):
        return a.narrow(axis, start, n)

    if grid.axis_topo(axis) == Periodic:
        rows(0, H).copy_(rows(N, H))
        rows(N + H, H).copy_(rows(H, H))
        return a
    for side, bc in (("left", left_bc), ("right", right_bc)):
        if bc is None:
            continue
        if loc_ax == Face and bc.classification == OPEN:
            # impenetrable wall: zero the wall face itself (left wall face
            # at H, right wall face at H + N, the first halo slot), then
            # mirror antisymmetrically about it
            wall = H if side == "left" else N + H
            rows(wall).zero_()
            for h in range(1, H + 1):
                g = wall - h if side == "left" else wall + h
                m = wall + h if side == "left" else wall - h
                if 0 <= g < N + 2 * H:
                    rows(g).copy_(0.0 - rows(m))
            continue
        # no-flux mirror for center-located data
        for h in range(H):
            g, m = ((H - 1 - h, H + h) if side == "left"
                    else (N + H + h, N + H - 1 - h))
            rows(g).copy_(rows(m))
    return a


def fill_halo_regions(a, grid, bcs=None, loc=(Center, Center, Center),
                      axes=(0, 1, 2)):
    """Fill the halo rings of ``a`` in place, axes in x -> y -> z order so
    edge and corner halos are consistent, and return ``a``. ``axes``
    restricts the fill to some axes (the pre-projection fill needs only
    the normal component's own axis)."""
    if bcs is None:
        bcs = regularize_field_boundary_conditions(None, grid, loc)
    for axis in axes:
        lbc, rbc = bcs.sides(axis)
        _fill_axis(a, grid, axis, loc[axis], lbc, rbc)
    return a


def apply_flux_bcs(G, grid, bcs, loc=(Center, Center, Center)):
    """Add boundary fluxes to a tendency. Only homogeneous (no-flux)
    conditions are ported, so this returns ``G`` unchanged; regularization
    has already refused any flux condition with a value."""
    return G


__all__ = ["BoundaryCondition", "FieldBoundaryConditions", "FluxBC",
           "OpenBC", "PeriodicBC", "apply_flux_bcs", "default_bc",
           "fill_halo_regions", "regularize_field_boundary_conditions"]
