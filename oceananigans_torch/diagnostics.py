"""Runtime diagnostics: CFL numbers, state checking, seawater density and
boundary-adjacent means.

Counterpart of ``oceananigans_tpu/diagnostics.py`` (reference
``src/Diagnostics/``: ``cfl.jl:9-33``, ``state_checker.jl``;
``src/Models/seawater_density.jl``, ``src/Models/boundary_mean.jl``).
"""

from __future__ import annotations

import torch

from oceananigans_torch.advection import cell_advection_timescale
from oceananigans_torch.fields import interior
from oceananigans_torch.grids.base import Center, Face

__all__ = ["AdvectiveCFL", "DiffusiveCFL", "CFL", "StateChecker",
           "seawater_density", "BoundaryAdjacentMean",
           "boundary_adjacent_mean"]


def seawater_density(model, state, temperature=None, salinity=None,
                     geopotential_height=None):
    """In-situ (or potential) seawater density ρ = ρ₀ (1 − b/g) at (c,c,c)
    from the model's SeawaterBuoyancy equation of state.
    ``geopotential_height``: defaults to the cell-center z (in-situ
    density); pass a constant (e.g. ``0``) for a potential density
    referenced to that height. A linear equation of state carries no
    reference density: it gives the Boussinesq anomaly −b/g (per unit
    ρ₀)."""
    from oceananigans_torch.buoyancy import SeawaterBuoyancy

    buoyancy = model.buoyancy
    if hasattr(buoyancy, "formulation"):   # BuoyancyForce wrapper
        buoyancy = buoyancy.formulation
    if not isinstance(buoyancy, SeawaterBuoyancy):
        raise ValueError("seawater_density requires a model with "
                         f"SeawaterBuoyancy, got {buoyancy!r}")
    T = temperature if temperature is not None else (
        state.tracers["T"] if buoyancy.constant_temperature is None
        else buoyancy.constant_temperature)
    S = salinity if salinity is not None else (
        state.tracers["S"] if buoyancy.constant_salinity is None
        else buoyancy.constant_salinity)
    Z = geopotential_height if geopotential_height is not None \
        else model.grid.zC
    eos = buoyancy.eos
    g = buoyancy.g
    if hasattr(eos, "rho0"):
        rho0 = eos.rho0
        try:
            b = eos.buoyancy(g, T, S, z=Z)
        except TypeError:
            b = eos.buoyancy(g, T, S)
        return rho0 * (1.0 - b / g)
    b = eos.buoyancy(g, T, S)
    return -b / g


class AdvectiveCFL:
    """CFL = Δt · max(|u|/Δx + |v|/Δy + |w|/Δz)."""

    def __init__(self, dt):
        self.dt = dt

    def __call__(self, model, state):
        dt = self.dt(state) if callable(self.dt) else self.dt
        tau = cell_advection_timescale(model.grid, state.u, state.v,
                                       state.w)
        return dt / tau


CFL = AdvectiveCFL


class DiffusiveCFL:
    """CFL_κ = Δt · max(ν, κ) / min(Δ)²; 0 for a model without a closure
    (the port's models take none yet)."""

    def __init__(self, dt):
        self.dt = dt

    def __call__(self, model, state):
        dt = self.dt(state) if callable(self.dt) else self.dt
        closure = getattr(model, "closure", None)
        nu_max = 0.0
        for c in ([closure] if not isinstance(closure, (tuple, list))
                  else closure):
            if c is None:
                continue
            nu = getattr(c, "nu", 0.0)
            kappa = getattr(c, "kappa", 0.0)
            if isinstance(kappa, dict):
                kappa = max(kappa.values(), default=0.0)
            nu_max = max(nu_max, float(nu), float(kappa))
        dmin = min(float(model.grid.min_spacing(ax)) for ax in range(3)
                   if model.grid.N[ax] > 1)
        return dt * nu_max / dmin ** 2


class StateChecker:
    """Per-field (min, max, mean) of the interior; call from a progress
    callback."""

    def __call__(self, model, state):
        out = {}
        for name, arr in state.fields().items():
            if getattr(arr, "ndim", 0) != 3:
                continue
            ai = interior(model.grid, arr) if arr.shape[2] > 1 else arr
            out[name] = (float(ai.min()), float(ai.max()),
                         float(ai.mean()))
        return out

    def report(self, model, state):
        rows = self.__call__(model, state)
        lines = [f"{name}: min={mn:+.6e} max={mx:+.6e} mean={me:+.6e}"
                 for name, (mn, mx, me) in rows.items()]
        return "\n".join(lines)


class BoundaryAdjacentMean:
    """Area-weighted mean of a field over the interior plane next to one
    boundary side: call with (grid, field) and read ``.value``, or call
    :func:`boundary_adjacent_mean` directly."""

    def __init__(self, grid, side):
        self.side = side
        self.value = 0.0

    def __call__(self, grid, field, loc=None):
        self.value = boundary_adjacent_mean(grid, field, self.side,
                                            loc=loc)
        return self.value


def boundary_adjacent_mean(grid, field, side, loc=None):
    """Σ(q A_n)/Σ(A_n) over the first interior plane next to ``side``
    ("west"/"east"/"south"/"north"/"bottom"/"top"), with A_n the
    boundary-normal face area."""
    axis = {"west": 0, "east": 0, "south": 1, "north": 1,
            "bottom": 2, "top": 2}[side]
    first = side in ("west", "south", "bottom")
    sl = list(grid.interior_slices)
    H, N = grid.H[axis], grid.N[axis]
    sl[axis] = slice(H, H + 1) if first else slice(H + N - 1, H + N)
    if axis == 0:
        A = grid.Ax(Face, Center, Center)
    elif axis == 1:
        A = grid.Ay(Center, Face, Center)
    else:
        A = grid.Az(Center, Center)
    A = torch.broadcast_to(A, grid.shape)[tuple(sl)]
    q = field[tuple(sl)]
    return torch.sum(q * A) / torch.sum(A)
