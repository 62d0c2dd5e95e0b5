"""Boundary conditions, halo fills and boundary fluxes into tendencies.

Counterpart of ``oceananigans_tpu/boundary_conditions.py``: periodic axes;
flux (no-flux mirror fills, valued fluxes into tendencies), value and
gradient conditions on center-located data; the wall value or an open
condition (impenetrable, valued, flat extrapolation or perturbation
advection) on wall-normal faces. A condition's value is a number, an array
that broadcasts against the boundary slab (the halo-extended transverse
extents), a callable ``f(c1, c2, t)`` of the two transverse coordinates and
time (with ``field_dependencies``: ``f(c1, c2, t, *slabs)`` of the named
fields' boundary-adjacent slabs, where the model supplies its fields), or
an object with ``times`` and ``data`` (boundary slabs interpolated to the
clock time). On a lat-lon grid whose y faces reach a pole, center-located
fields take the polar condition there: a value at the zonal mean of the
polemost interior row, recomputed at each fill. On a tripolar grid the
north y halo is the zipper fold (``grids/orthogonal.py:
fill_zipper_north``). A communication condition, which a ``Connected``
axis takes by default, leaves its halo to the distributed exchange
(``parallel/halo_exchange.py``): the fill here does not touch it. The cubed
sphere fills its panel halos with its own exchanges
(``grids/cubed_sphere_grid.py``).

Unlike the JAX package, ``fill_halo_regions`` and ``apply_flux_bcs`` write
their argument in place and return it: halos are derived data, and a fill
that copied the whole field would double the fill's memory traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from oceananigans_torch.grids.base import (
    AXIS_NAMES, Bounded, Center, Connected, Face, Flat, Periodic,
)

# ---------------------------------------------------------------------------
# Classifications
# ---------------------------------------------------------------------------
PERIODIC = "periodic"
FLUX = "flux"
VALUE = "value"          # Dirichlet
GRADIENT = "gradient"    # Neumann
OPEN = "open"            # wall-normal / open boundary
COMMUNICATION = "communication"  # filled by a distributed halo exchange
ZIPPER = "zipper"        # tripolar north fold
POLAR = "polar"          # lat-lon pole row: a value at the zonal mean


@dataclasses.dataclass
class BoundaryCondition:
    """A classification plus a condition (``None`` = homogeneous), the
    matching scheme of an open boundary, and the fields whose
    boundary-adjacent slabs a callable condition takes after ``t``."""
    classification: str
    condition: Any = None
    matching_scheme: Any = None
    field_dependencies: tuple = ()

    def __repr__(self):
        return f"BoundaryCondition({self.classification}, {self.condition})"


def PeriodicBC():
    return BoundaryCondition(PERIODIC)


def FluxBC(q=None, field_dependencies=()):
    if isinstance(field_dependencies, str):
        field_dependencies = (field_dependencies,)
    return BoundaryCondition(FLUX, q,
                             field_dependencies=tuple(field_dependencies))


def ValueBC(v):
    return BoundaryCondition(VALUE, v)


def GradientBC(g):
    return BoundaryCondition(GRADIENT, g)


def OpenBC(v=None, matching_scheme=None):
    """Open (wall-normal) boundary. ``matching_scheme``: None imposes the
    wall value (impenetrable when ``v`` is None); "flat_extrapolation" is
    the zero-gradient outflow; a :class:`PerturbationAdvection` is the
    radiation scheme."""
    return BoundaryCondition(OPEN, v, matching_scheme)


def FlatExtrapolationOpenBC():
    return OpenBC(matching_scheme="flat_extrapolation")


@dataclasses.dataclass(frozen=True)
class PerturbationAdvection:
    """Radiation matching scheme: the wall-normal velocity is a prescribed
    mean plus a perturbation advected out of the domain by the mean flow
    (backward Euler), relaxed toward the mean with ``inflow_timescale`` on
    inflow and ``outflow_timescale`` on outflow. On the right boundary
    uⁿ⁺¹ = (uⁿ + Ũ uᵢ₋₁ⁿ⁺¹ + ū τ̃) / (1 + τ̃ + Ũ), Ũ = clamp(ū Δt/Δx, 0, 1),
    τ̃ = Δt/τ."""
    inflow_timescale: float = 300.0
    outflow_timescale: float = float("inf")


def PerturbationAdvectionOpenBC(v=None, inflow_timescale=300.0,
                                outflow_timescale=float("inf")):
    return OpenBC(v, PerturbationAdvection(float(inflow_timescale),
                                           float(outflow_timescale)))


def CommunicationBC():
    return BoundaryCondition(COMMUNICATION)


@dataclasses.dataclass
class FieldBoundaryConditions:
    """west/east/south/north/bottom/top bundle; ``immersed`` holds the
    condition on an immersed boundary (a plain condition for every side, or
    an ``ImmersedBoundaryCondition``), which the models apply on an
    ``ImmersedBoundaryGrid``."""
    west: Optional[BoundaryCondition] = None
    east: Optional[BoundaryCondition] = None
    south: Optional[BoundaryCondition] = None
    north: Optional[BoundaryCondition] = None
    bottom: Optional[BoundaryCondition] = None
    top: Optional[BoundaryCondition] = None
    immersed: Optional[BoundaryCondition] = None

    def sides(self, axis: int):
        return ((self.west, self.east), (self.south, self.north),
                (self.bottom, self.top))[axis]


def default_bc(topo: str, loc: str, side: str) -> Optional[BoundaryCondition]:
    """Periodic axes -> periodic; Bounded + Center -> no-flux; Bounded +
    Face (wall-normal) -> impenetrable; Connected -> communication; Flat ->
    nothing."""
    if topo == Flat:
        return None
    if topo == Periodic:
        return PeriodicBC()
    if topo == Connected:
        return CommunicationBC()
    if topo != Bounded:
        raise ValueError(f"unknown topology {topo!r}")
    if loc == Face:
        return OpenBC(None)
    return FluxBC(None)


def _pole_sides(grid):
    """(south, north): whether the y faces of a lat-lon grid reach the
    south and the north pole."""
    phiF = getattr(grid, "phiF", None)
    if phiF is None or grid.N[1] <= 1:
        return (False, False)
    phi = phiF.reshape(-1).cpu()
    H, N = grid.H[1], grid.N[1]
    return (abs(float(phi[H]) + 90.0) < 1e-6,
            abs(float(phi[H + N]) - 90.0) < 1e-6)


def regularize_field_boundary_conditions(bcs, grid, loc):
    """Fill unspecified sides of ``bcs`` with topology/location defaults
    (the polar condition on the pole sides of a center-located field on a
    lat-lon grid that reaches a pole), and carry array conditions onto the
    grid's device and dtype."""
    if bcs is None:
        bcs = FieldBoundaryConditions()
    poles = dict(zip(("south", "north"), _pole_sides(grid)))
    cc_loc = loc[0] == Center and loc[1] == Center
    names = (("west", "east"), ("south", "north"), ("bottom", "top"))
    out = {}
    for axis in range(3):
        topo = grid.axis_topo(axis)
        for name in names[axis]:
            bc = getattr(bcs, name)
            if bc is None:
                bc = (BoundaryCondition(POLAR)
                      if cc_loc and poles.get(name)
                      else default_bc(topo, loc[axis], name))
            elif topo == Periodic and bc.classification != PERIODIC:
                raise ValueError(
                    f"non-periodic BC on periodic axis {AXIS_NAMES[axis]}")
            if bc is not None:
                bc = _on_grid(bc, grid)
            out[name] = bc
    out["immersed"] = bcs.immersed
    return FieldBoundaryConditions(**out)


@dataclasses.dataclass(frozen=True)
class _TimeSeries:
    """A time series condition carried onto the grid: ``times`` a float64
    host tensor, ``data`` (T, n1, n2) float64 on the grid's device."""
    times: torch.Tensor
    data: torch.Tensor


def _on_grid(bc, grid):
    """``bc`` with an array condition as a tensor on the grid's device and
    in its dtype, and a time series' slabs on the device in float64, each
    carried across once (numbers and callables pass through)."""
    cond = bc.condition
    if isinstance(cond, (np.ndarray, torch.Tensor)):
        cond = torch.as_tensor(cond, dtype=grid.dtype, device=grid.device)
    elif hasattr(cond, "times") and hasattr(cond, "data"):
        cond = _TimeSeries(
            torch.as_tensor(np.asarray(cond.times), dtype=torch.float64),
            torch.as_tensor(np.asarray(cond.data), dtype=torch.float64,
                            device=grid.device))
    else:
        return bc
    return dataclasses.replace(bc, condition=cond)


# ---------------------------------------------------------------------------
# Condition values
# ---------------------------------------------------------------------------

def _axslice(axis, sl):
    out = [slice(None)] * 3
    out[axis] = sl
    return tuple(out)


def _transverse_coords(grid, axis, loc):
    """Broadcast-ready coordinate tensors of the two transverse axes, for
    evaluating continuous boundary functions."""
    return tuple(getattr(grid, f"{name}F" if loc[ax] == Face
                         else f"{name}C")
                 for ax, name in enumerate(AXIS_NAMES) if ax != axis)


def _time_series_value(cond, grid, axis, time):
    """A time series' boundary slabs ``data`` (T, n1, n2), interior extents
    of the two transverse axes, interpolated linearly to ``time`` (clamped to
    ``times``) in float64 and embedded in the halo-extended slab;
    ``cond`` is the :class:`_TimeSeries` regularization made of it."""
    f64 = torch.float64
    times, data = cond.times, cond.data
    t = torch.clamp(torch.as_tensor(0.0 if time is None else time,
                                    dtype=f64), times[0], times[-1])
    i = int(torch.searchsorted(times, t.reshape(1), right=True)[0]) - 1
    i = min(max(i, 0), times.shape[0] - 2)
    f = (t - times[i]) / torch.clamp(times[i + 1] - times[i], min=1e-30)
    val = (1.0 - f) * data[i] + f * data[i + 1]
    t1, t2 = [ax for ax in range(3) if ax != axis]
    shape = [1, 1, 1]
    shape[t1], shape[t2] = grid.shape[t1], grid.shape[t2]
    full = torch.zeros(shape, dtype=f64, device=grid.device)
    sl = [slice(None)] * 3
    sl[t1], sl[t2] = grid.interior_slices[t1], grid.interior_slices[t2]
    full[tuple(sl)] = val.reshape(full[tuple(sl)].shape)
    return full


def _bc_value(bc, grid, axis, loc, time, fields=None, idx=None):
    """The value of ``bc``'s condition: None, a number, or a tensor that
    broadcasts against the boundary slab."""
    cond = bc.condition
    if cond is None:
        return None
    if hasattr(cond, "times") and hasattr(cond, "data"):
        return _time_series_value(cond, grid, axis, time)
    if callable(cond):
        c1, c2 = _transverse_coords(grid, axis, loc)
        t = 0.0 if time is None else time
        deps = bc.field_dependencies
        if deps:
            if fields is None or idx is None:
                raise ValueError(
                    "field-dependent boundary conditions are supported "
                    "only where the model supplies its fields (flux BCs "
                    "applied to tendencies)")
            slabs = [fields[n][_axslice(axis, slice(idx, idx + 1))]
                     for n in deps]
            return cond(c1, c2, t, *slabs)
        return cond(c1, c2, t)
    return cond


def has_valued_flux(bcs) -> bool:
    """True when a side of the bundle ``bcs`` is a flux condition with a
    value."""
    return any(bc is not None and bc.classification == FLUX
               and bc.condition is not None
               for axis in range(3) for bc in bcs.sides(axis))


def top_flux_values(bcs, grid, time):
    """The values of the top flux conditions of u, v and b in the mapping
    ``bcs`` of field names to bundles (the surface stress and buoyancy
    flux), for closures that take them."""
    out = {}
    for name, loc in (("u", (Face, Center, Center)),
                      ("v", (Center, Face, Center)),
                      ("b", (Center, Center, Center))):
        bc = bcs[name].top if name in bcs else None
        if bc is None or bc.classification != FLUX or bc.condition is None:
            continue
        out[name] = _bc_value(bc, grid, 2, loc, time)
    return out


# ---------------------------------------------------------------------------
# Halo filling
# ---------------------------------------------------------------------------

def _fill_axis(a, grid, axis, loc_ax, left_bc, right_bc, left_val=None,
               right_val=None, dt=None):
    """Fill both halo rings of one axis of ``a`` in place."""
    H, N = grid.H[axis], grid.N[axis]
    if H == 0:
        return a

    def rows(start, n=1):
        return a.narrow(axis, start, n)

    topo = grid.axis_topo(axis)
    if topo == Periodic:
        rows(0, H).copy_(rows(N, H))
        rows(N + H, H).copy_(rows(H, H))
        return a
    if topo == Connected:
        return a    # filled by the distributed halo exchange

    # distances between mirrored point pairs, for gradient conditions
    name = AXIS_NAMES[axis]
    coord = getattr(grid, f"{name}F" if loc_ax == Face
                    else f"{name}C").reshape(-1)

    for side, bc, val in (("left", left_bc, left_val),
                          ("right", right_bc, right_val)):
        if bc is None or bc.classification == COMMUNICATION:
            continue
        kind = bc.classification
        if kind == POLAR:
            # a value at the zonal mean of the polemost interior row,
            # recomputed from the field: the ghosts mirror about it
            Hx, Nx = grid.H[0], grid.N[0]
            pole = rows(H if side == "left" else N + H - 1)
            if a.shape[0] == Nx + 2 * Hx:
                pole = pole[Hx:Hx + Nx]
            val = torch.mean(pole, dim=0, keepdim=True)
        if loc_ax == Face and kind in (OPEN, VALUE):
            wall = H if side == "left" else N + H
            ms = bc.matching_scheme
            if isinstance(ms, PerturbationAdvection):
                # radiation: implicit perturbation-advection update of the
                # wall-face value itself; ghosts copy the new wall value.
                # A no-op while Δt is unknown (the first fill).
                adj = wall + 1 if side == "left" else wall - 1

                def scalar(x):
                    # a number becomes a 0-d host tensor, which combines
                    # with device tensors without a copy to the device
                    return torch.as_tensor(0.0 if x is None else x,
                                           dtype=a.dtype)

                ubar = scalar(val)
                dtv = scalar(dt)
                dxw = torch.abs(coord[wall] - coord[adj])
                cr = dtv / dxw * ubar
                outflowing = (ubar >= 0) if side == "right" else (ubar <= 0)
                tau = torch.where(
                    outflowing, torch.full_like(ubar, ms.outflow_timescale),
                    torch.full_like(ubar, ms.inflow_timescale))
                tt = dtv / tau
                if side == "right":
                    Ut = torch.clamp(cr, 0.0, 1.0)
                else:
                    Ut = -torch.clamp(cr, -1.0, 0.0)
                new = ((rows(wall) + Ut * rows(adj) + ubar * tt)
                       / (1.0 + tt + Ut))
                for h in range(0, H + 1):
                    g = wall - h if side == "left" else wall + h
                    if 0 <= g < N + 2 * H:
                        rows(g).copy_(new.expand(rows(g).shape))
                continue
            if ms == "flat_extrapolation":
                # zero-gradient outflow: wall face and ghosts copy the
                # nearest interior face value
                src = wall + 1 if side == "left" else wall - 1
                edge = rows(src).clone()
                for h in range(0, H + 1):
                    g = wall - h if side == "left" else wall + h
                    if 0 <= g < N + 2 * H:
                        rows(g).copy_(edge)
                continue
            # impose the wall-face value itself (left wall face at H, right
            # wall face at H + N, the first halo slot), then mirror
            # antisymmetrically about it
            wv = 0.0 if val is None else val
            if torch.is_tensor(wv):
                rows(wall).copy_(wv.expand(rows(wall).shape))
            else:
                rows(wall).fill_(wv)
            for h in range(1, H + 1):
                g = wall - h if side == "left" else wall + h
                m = wall + h if side == "left" else wall - h
                if 0 <= g < N + 2 * H:
                    rows(g).copy_(2.0 * wv - rows(m))
            continue

        for h in range(H):
            g, m = ((H - 1 - h, H + h) if side == "left"
                    else (N + H + h, N + H - 1 - h))
            if kind in (VALUE, POLAR):
                ghost = 2.0 * val - rows(m)
            elif kind == GRADIENT:
                d = coord[m] - coord[g]
                sign = -1.0 if side == "left" else 1.0
                ghost = rows(m) + sign * val * d
            else:  # FLUX (no-flux mirror), OPEN on centers
                ghost = rows(m)
            rows(g).copy_(ghost.expand(rows(g).shape))
    return a


def fill_halo_regions(a, grid, bcs=None, loc=(Center, Center, Center), time=None,
                      dt=None, axes=(0, 1, 2)):
    """Fill the halo rings of ``a`` in place, axes in x -> y -> z order so
    edge and corner halos are consistent, and return ``a``. ``time`` is the
    clock time at which conditions are evaluated and ``dt`` the last step
    (for the perturbation-advection scheme); ``axes`` restricts the fill to
    some axes (the pre-projection fill needs only the normal component's
    own axis)."""
    if bcs is None:
        bcs = regularize_field_boundary_conditions(None, grid, loc)
    zipper = getattr(grid, "zipper", False)
    for axis in axes:
        lbc, rbc = bcs.sides(axis)
        # flux halos are no-flux mirror fills: the condition's value enters
        # the tendency (apply_flux_bcs), never the halo
        lval = (_bc_value(lbc, grid, axis, loc, time)
                if lbc and lbc.classification != FLUX else None)
        rval = (_bc_value(rbc, grid, axis, loc, time)
                if rbc and rbc.classification != FLUX else None)
        if zipper and axis == 1 and a.shape[1] == grid.shape[1]:
            # the tripolar north fold: the south side takes its condition,
            # the north halo the fold, with horizontal velocity components
            # flipping sign
            from oceananigans_torch.grids.orthogonal import (
                fill_zipper_north, fold_sign,
            )
            _fill_axis(a, grid, axis, loc[axis], lbc, None, lval, None)
            fill_zipper_north(a, grid, loc, fold_sign(loc))
            continue
        _fill_axis(a, grid, axis, loc[axis], lbc, rbc, lval, rval, dt=dt)
    return a


# ---------------------------------------------------------------------------
# Flux boundary conditions -> tendencies
# ---------------------------------------------------------------------------

def apply_flux_bcs(G, grid, bcs, loc=(Center, Center, Center), time=None,
                   fields=None):
    """Add boundary fluxes to the tendency ``G`` in place and return it.

    Fluxes are oriented along the positive axis: a left-side flux ``q``
    adds ``+q/Δ`` to the boundary-adjacent interior cell, a right-side flux
    adds ``-q/Δ``."""
    spacings = (grid.dx(loc[0], Center), grid.dy(loc[1], Center),
                grid.dz(loc[2]))
    for axis in range(3):
        if grid.axis_topo(axis) == Flat:
            continue
        lbc, rbc = bcs.sides(axis)
        H, N = grid.H[axis], grid.N[axis]
        d = spacings[axis]
        for bc, idx, sign in ((lbc, H, +1.0), (rbc, H + N - 1, -1.0)):
            if bc is None or bc.classification != FLUX or bc.condition is None:
                continue
            q = _bc_value(bc, grid, axis, loc, time, fields=fields, idx=idx)
            sl = _axslice(axis, slice(idx, idx + 1))
            G[sl] += sign * q / d[sl]
    return G


# The reference's long-form constructor names
FluxBoundaryCondition = FluxBC
ValueBoundaryCondition = ValueBC
GradientBoundaryCondition = GradientBC
OpenBoundaryCondition = OpenBC


__all__ = ["BoundaryCondition", "CommunicationBC", "FieldBoundaryConditions",
           "FlatExtrapolationOpenBC", "FluxBC", "FluxBoundaryCondition",
           "GradientBC", "GradientBoundaryCondition", "OpenBC",
           "OpenBoundaryCondition", "PerturbationAdvection",
           "PerturbationAdvectionOpenBC", "PeriodicBC", "ValueBC",
           "ValueBoundaryCondition", "apply_flux_bcs", "default_bc",
           "fill_halo_regions", "has_valued_flux",
           "regularize_field_boundary_conditions", "top_flux_values"]
