"""ShallowWaterModel: the rotating shallow-water equations.

Counterpart of ``oceananigans_tpu/models/shallow_water.py`` on a grid with
a Flat z axis (a regular ``RectilinearGrid``, a ``LatitudeLongitudeGrid``
or an ``OrthogonalSphericalShellGrid``), in both formulations.

Conservative form, with transports (uh, vh), u = uh/h and bathymetry height
b(x, y) (the free surface is η = h + b):

    ∂t(uh) = −∇·(𝐮 uh) + f vh − g h ∂x(h + b)
    ∂t(vh) = −∇·(𝐮 vh) − f uh − g h ∂y(h + b)
    ∂t h   = −∇·(uh, vh)

Vector-invariant form, with velocities (u, v) stored in the same slots:
∂t u = ζ v̂ − ∂x(K + g(h + b)) − f × 𝐮. Tracers c are advected by the
velocities: ∂t c = −∇·(𝐮 c).

Time stepping is the low-storage RK3 of the reference. The state is a
dataclass of tensors; ``step`` returns a new state but reuses its
argument's storage: halo fills write the halo rows in place and the fused
stage kernel writes the new tendencies over the previous ones.

Fused kernel: with ``fused_kernels="auto"`` the stage kernel
(``ops/cuda_sw.py``) runs exactly when the model's device is a CUDA device
and :func:`~oceananigans_torch.ops.cuda_sw.sw_fused_available` holds; with
``fused_kernels=True`` on the CPU the same code path runs its plain
version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from oceananigans_torch.advection import (
    SCHEMES, Centered, _face_value, _scheme_for, cell_advection_timescale,
    div_Uc, required_halo,
)
from oceananigans_torch.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions, regularize_field_boundary_conditions,
)
from oceananigans_torch.buoyancy import g_Earth
from oceananigans_torch.fields import LOC_C, LOC_U, LOC_V, new_field, set_field
from oceananigans_torch.forcings import materialize_forcing
from oceananigans_torch.grids.base import Center, Face, Flat, Periodic
from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
from oceananigans_torch.grids.orthogonal import OrthogonalSphericalShellGrid
from oceananigans_torch.grids.rectilinear import RectilinearGrid
from oceananigans_torch.models.hydrostatic import VectorInvariant
from oceananigans_torch.ops.cuda_sw import sw_fused_available, sw_rk3_stage
from oceananigans_torch.ops.operators import (
    X, Y, dx_c, dx_f, dy_c, dy_f, ix_c, ix_f, iy_c, iy_f, kinetic_energy_cc,
    vorticity_z_ff,
)
from oceananigans_torch.timesteppers import Clock, RK3_STAGES, tick

ConservativeFormulation = "conservative"
VectorInvariantFormulation = "vector_invariant"


@dataclasses.dataclass
class ShallowWaterState:
    """Conservative: (uh, vh, h); vector-invariant: (u, v, h) in the same
    slots. ``Guh``/``Gvh``/``Gh`` and ``Gtracers`` hold the last stage's
    tendencies, which the next RK3 stage reads."""
    uh: torch.Tensor
    vh: torch.Tensor
    h: torch.Tensor
    clock: Clock
    Guh: torch.Tensor
    Gvh: torch.Tensor
    Gh: torch.Tensor
    tracers: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    Gtracers: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def fields(self):
        return {"uh": self.uh, "vh": self.vh, "h": self.h, **self.tracers}


_replace = dataclasses.replace


def _momentum_flux_div_u(grid, scheme, u, v, Q):
    """∇·(𝐮 Q) for a conserved quantity Q at x-faces (Q = uh)."""
    sx, sy = _scheme_for(scheme, X), _scheme_for(scheme, Y)
    Uadv = ix_c(grid.Ax(Face, Center, Center) * u)
    fxx = Uadv * _face_value(sx, Uadv, Q, X, 1)
    Vadv = ix_f(grid.Ay(Center, Face, Center) * v)
    fxy = Vadv * _face_value(sy, Vadv, Q, Y, 0)
    return (dx_f(fxx) + dy_c(fxy)) / grid.V(Face, Center, Center)


def _momentum_flux_div_v(grid, scheme, u, v, Q):
    """∇·(𝐮 Q) for a conserved quantity Q at y-faces (Q = vh)."""
    sx, sy = _scheme_for(scheme, X), _scheme_for(scheme, Y)
    Uadv = iy_f(grid.Ax(Face, Center, Center) * u)
    fyx = Uadv * _face_value(sx, Uadv, Q, X, 0)
    Vadv = iy_c(grid.Ay(Center, Face, Center) * v)
    fyy = Vadv * _face_value(sy, Vadv, Q, Y, 1)
    return (dx_c(fyx) + dy_f(fyy)) / grid.V(Center, Face, Center)


def _velocities(h, uh, vh):
    """The velocities u = uh/ℑx h, v = vh/ℑy h of the conservative form."""
    return uh / ix_f(h), vh / iy_f(h)


def conservative_tendencies(grid, g, advection, uh, vh, h, bathymetry=0.0):
    """(Guh, Gvh, Gh) of the conservative form without Coriolis: the
    momentum flux divergence, the g h ∂(h + b) gradient and the mass
    divergence. The stage kernel's plain version is this function."""
    u, v = _velocities(h, uh, vh)
    eta = h + bathymetry
    Guh = -_momentum_flux_div_u(grid, advection, u, v, uh)
    Gvh = -_momentum_flux_div_v(grid, advection, u, v, vh)
    Guh = Guh - g * ix_f(h) * dx_f(eta) / grid.dx(Face, Center)
    Gvh = Gvh - g * iy_f(h) * dy_f(eta) / grid.dy(Face, Center)
    return Guh, Gvh, _mass_tendency(grid, uh, vh)


def _mass_tendency(grid, U, V):
    """∂t h = −∇·(U, V)."""
    return -(dx_c(grid.dy(Center, Face) * U)
             + dy_c(grid.dx(Center, Face) * V)) / grid.Az(Center, Center)


class ShallowWaterModel(torch.nn.Module):
    """Configuration and step functions; mirrors the JAX constructor's
    keywords. ``coriolis`` is any object with ``x_f_cross_U`` and
    ``y_f_cross_U``, as the JAX model takes it."""

    def __init__(self, grid, gravitational_acceleration=g_Earth,
                 momentum_advection=None, tracer_advection=None,
                 coriolis=None, bathymetry=None, tracers=(),
                 formulation=ConservativeFormulation,
                 forcing=None, boundary_conditions=None,
                 fused_kernels="auto", device=None):
        super().__init__()
        #: the constructor's arguments but the grid, for a rebuild on
        #: another grid (``parallel.sharded_step_fn``)
        self._init_kwargs = dict(
            gravitational_acceleration=gravitational_acceleration,
            momentum_advection=momentum_advection,
            tracer_advection=tracer_advection, coriolis=coriolis,
            bathymetry=bathymetry, tracers=tracers, formulation=formulation,
            forcing=forcing, boundary_conditions=boundary_conditions,
            fused_kernels=fused_kernels)
        if not isinstance(grid, (RectilinearGrid, LatitudeLongitudeGrid,
                                 OrthogonalSphericalShellGrid)):
            raise NotImplementedError(
                f"ShallowWaterModel does not take a {type(grid).__name__}; "
                "a ConformalCubedSphereGrid takes "
                "CubedSphereShallowWaterModel")
        if grid.topology[2] != Flat:
            raise ValueError("ShallowWaterModel needs a Flat z topology "
                             "(2-D grid)")
        if formulation not in (ConservativeFormulation,
                               VectorInvariantFormulation):
            raise ValueError(f"unknown formulation {formulation!r}")
        if momentum_advection is None:
            momentum_advection = Centered(2)
        if tracer_advection is None:
            tracer_advection = Centered(2)
        if isinstance(momentum_advection, VectorInvariant):
            if formulation != VectorInvariantFormulation:
                raise ValueError("VectorInvariant momentum advection needs "
                                 "the vector-invariant formulation")
        elif not isinstance(momentum_advection, SCHEMES):
            raise ValueError(f"unknown advection {momentum_advection!r}")
        if not isinstance(tracer_advection, SCHEMES):
            raise ValueError(f"unknown advection {tracer_advection!r}")
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        momentum = momentum_advection
        if (formulation == VectorInvariantFormulation
                and not isinstance(momentum, VectorInvariant)):
            momentum = VectorInvariant()
        needed = max(required_halo(momentum),
                     required_halo(tracer_advection) if tracers else 1)
        for axis in (X, Y):
            H, N = grid.H[axis], grid.N[axis]
            if N <= 1 or (grid.axis_topo(axis) == Periodic and H == 0):
                continue
            if H < min(needed, N):
                raise ValueError(
                    f"grid halo {grid.H} too small for advection requiring "
                    f"{needed}; build the grid with halo={needed} (or "
                    "halo=0 on periodic axes)")

        self.grid = grid
        self.g = float(gravitational_acceleration)
        self.momentum_advection = momentum_advection
        self.tracer_advection = tracer_advection
        self.coriolis = coriolis
        self.formulation = formulation
        self.tracer_names = tracers
        # bathymetry height b(x, y) at centers: a number, a tensor, or a
        # callable f(x, y) of coordinate tensors
        if bathymetry is None:
            self.bathymetry = 0.0
        elif callable(bathymetry):
            b = torch.as_tensor(bathymetry(grid.xC, grid.yC),
                                dtype=grid.dtype, device=grid.device)
            self.register_buffer(
                "bathymetry",
                b.expand(grid.shape[0], grid.shape[1], 1).clone())
        elif torch.is_tensor(bathymetry):
            self.register_buffer("bathymetry", bathymetry.to(
                dtype=grid.dtype, device=grid.device))
        else:
            self.bathymetry = float(bathymetry)
        boundary_conditions = dict(boundary_conditions or {})
        self.locations = {"uh": LOC_U, "vh": LOC_V, "h": LOC_C,
                          **{t: LOC_C for t in tracers}}
        self.bcs = {name: regularize_field_boundary_conditions(
            boundary_conditions.get(name), grid, loc)
            for name, loc in self.locations.items()}
        self.forcings = {name: materialize_forcing(
            dict(forcing or {}).get(name), name, loc)
            for name, loc in self.locations.items()}
        self._fused_kernels = fused_kernels
        if device is not None:
            self.to(device)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    #: the mesh context of a rank's LOCAL model in a sharded step
    #: (``parallel/shard_step.py``): its halo fills exchange strips with the
    #: neighbouring ranks, and only the ranks on a domain edge fill that
    #: edge's Bounded halos; ``dist_topo`` is the global grid's topology
    dist_halo = None
    dist_topo = None

    def set_dist_halo(self, ctx, topo):
        """Route this (local) model's halo fills through the exchange of
        ``ctx``, a ``DistHalo``, with the global topology ``topo``."""
        self.dist_halo = ctx
        self.dist_topo = tuple(topo)

    @property
    def fused_rk3(self) -> bool:
        """Each RK3 stage runs as one kernel (``sw_rk3_stage``); "auto"
        means: on a CUDA device."""
        if not sw_fused_available(self.grid, self):
            return False
        if self._fused_kernels == "auto":
            return self.device.type == "cuda"
        return bool(self._fused_kernels)

    # ------------------------------------------------------------------
    def initial_state(self, time=0.0, **field_values):
        """A state from initial fields (numbers, arrays or callables
        ``f(x, y, z)`` of coordinate tensors): ``uh``/``vh`` in the
        conservative formulation, ``u``/``v`` in the vector-invariant one,
        ``h`` (default 1) and the tracers."""
        g = self.grid
        conservative = self.formulation == ConservativeFormulation
        vel = ("uh", "vh") if conservative else ("u", "v")
        allowed = set(vel) | {"h"} | set(self.tracer_names)
        unknown = set(field_values) - allowed
        if unknown:
            raise ValueError(
                f"unknown initial_state fields {sorted(unknown)}; "
                f"this formulation takes {sorted(allowed)}")

        def mk(name, loc, default=0.0):
            return set_field(g, field_values.get(name, default), loc=loc)

        state = ShallowWaterState(
            uh=mk(vel[0], LOC_U), vh=mk(vel[1], LOC_V),
            h=mk("h", LOC_C, default=1.0),
            clock=Clock.start(time, g.dtype),
            Guh=new_field(g), Gvh=new_field(g), Gh=new_field(g),
            tracers={t: mk(t, LOC_C) for t in self.tracer_names},
            Gtracers={t: new_field(g) for t in self.tracer_names})
        return self.fill_state_halos(state)

    def fill_state_halos(self, state):
        """Fill every field's halos in place at the clock time (the
        transports also with the last Δt, which the radiation condition
        reads)."""
        t, dtl = state.clock.time, state.clock.last_dt
        fill = fill_halo_regions
        if self.dist_halo is not None:
            from oceananigans_torch.parallel.shard_step import (
                dist_fill_halos,
            )

            def fill(a, grid, bcs, loc, time, dt=None):
                return dist_fill_halos(a, grid, bcs, loc, time, dt,
                                       self.dist_halo, self.dist_topo)
        for name, field in state.fields().items():
            fill(field, self.grid, self.bcs[name], self.locations[name], t,
                 dt=dtl if name in ("uh", "vh") else None)
        return state

    # ------------------------------------------------------------------
    def _transport_and_velocity(self, state):
        """(U, V, u, v): transports at faces and velocities, for either
        formulation."""
        if self.formulation == ConservativeFormulation:
            u, v = _velocities(state.h, state.uh, state.vh)
            return state.uh, state.vh, u, v
        u, v = state.uh, state.vh
        return u * ix_f(state.h), v * iy_f(state.h), u, v

    def compute_tendencies(self, state):
        """``(Guh, Gvh, Gh, {name: Gc})``."""
        g = self.grid
        h = state.h
        zero = torch.zeros_like(h)
        if self.formulation == ConservativeFormulation:
            Guh, Gvh, Gh = conservative_tendencies(
                g, self.g, self.momentum_advection, state.uh, state.vh, h,
                self.bathymetry)
            # f × (uh, vh), on the transports for momentum conservation
            cu, cv = state.uh, state.vh
            if self.tracer_names:
                u, v = _velocities(h, state.uh, state.vh)
        else:
            U, V, u, v = self._transport_and_velocity(state)
            vi = self.momentum_advection if isinstance(
                self.momentum_advection, VectorInvariant) \
                else VectorInvariant()
            zeta = vorticity_z_ff(g, u, v)
            phi = kinetic_energy_cc(g, u, v) + self.g * (h + self.bathymetry)
            Guh = vi._zeta_v(g, zeta, u, v) - dx_f(phi) / g.dx(Face, Center)
            Gvh = -vi._zeta_u(g, zeta, u, v) - dy_f(phi) / g.dy(Face, Center)
            Gh = _mass_tendency(g, U, V)
            cu, cv = u, v
        if self.coriolis is not None:
            Guh = Guh - self.coriolis.x_f_cross_U(g, cu, cv, zero)
            Gvh = Gvh - self.coriolis.y_f_cross_U(g, cu, cv, zero)
        time, fields = state.clock.time, state.fields()
        f = self.forcings
        Guh = Guh if f["uh"] is None else Guh + f["uh"](g, time, fields)
        Gvh = Gvh if f["vh"] is None else Gvh + f["vh"](g, time, fields)
        Gh = Gh if f["h"] is None else Gh + f["h"](g, time, fields)
        Guh = apply_flux_bcs(Guh, g, self.bcs["uh"], LOC_U, time, fields)
        Gvh = apply_flux_bcs(Gvh, g, self.bcs["vh"], LOC_V, time, fields)
        Gtracers = {}
        for name in self.tracer_names:
            Gc = -div_Uc(g, self.tracer_advection, u, v, zero,
                         state.tracers[name])
            Gtracers[name] = Gc if f[name] is None else Gc + f[name](
                g, time, fields)
        return Guh, Gvh, Gh, Gtracers

    # ------------------------------------------------------------------
    def step(self, state, dt, assume_filled=False):
        """One RK3 step (the reference's only shallow-water stepper).
        ``assume_filled=True`` skips the first stage's halo fill: every step
        ends with one, so a loop fills once before its first step and
        passes ``assume_filled=True``."""
        dt = torch.tensor(dt, dtype=state.h.dtype)
        if self.fused_rk3:
            for stage, (gamma, zeta) in enumerate(RK3_STAGES):
                if stage > 0 or not assume_filled:
                    state = self.fill_state_halos(state)
                uh, vh, h, Guh, Gvh, Gh = sw_rk3_stage(
                    self.grid, state.uh, state.vh, state.h,
                    state.Guh, state.Gvh, state.Gh,
                    (dt * gamma).item(), (dt * zeta).item(), self.g)
                state = _replace(state, uh=uh, vh=vh, h=h,
                                 Guh=Guh, Gvh=Gvh, Gh=Gh)
            state = _replace(state, clock=tick(state.clock, dt))
            return self.fill_state_halos(state)
        dtf = dt.item()
        G_prev = (state.Guh, state.Gvh, state.Gh, state.Gtracers)
        for stage, (gamma, zeta) in enumerate(RK3_STAGES):
            if stage > 0 or not assume_filled:
                state = self.fill_state_halos(state)
            Guh, Gvh, Gh, Gt = self.compute_tendencies(state)
            state = _replace(
                state,
                uh=state.uh + dtf * (gamma * Guh + zeta * G_prev[0]),
                vh=state.vh + dtf * (gamma * Gvh + zeta * G_prev[1]),
                h=state.h + dtf * (gamma * Gh + zeta * G_prev[2]),
                tracers={n: state.tracers[n]
                         + dtf * (gamma * Gt[n] + zeta * G_prev[3][n])
                         for n in self.tracer_names})
            G_prev = (Guh, Gvh, Gh, Gt)
        state = _replace(state, Guh=G_prev[0], Gvh=G_prev[1], Gh=G_prev[2],
                         Gtracers=G_prev[3], clock=tick(state.clock, dt))
        return self.fill_state_halos(state)

    def cfl_timescale(self, state):
        """min over the interior of (|u|/Δx + |v|/Δy)⁻¹."""
        _, _, u, v = self._transport_and_velocity(state)
        return cell_advection_timescale(self.grid, u, v, torch.zeros_like(u))

    def extra_repr(self):
        return (f"g={self.g:g}, formulation={self.formulation!r}, "
                f"momentum_advection={self.momentum_advection!r}, "
                f"tracers={self.tracer_names}, coriolis={self.coriolis!r}")


__all__ = ["ConservativeFormulation", "ShallowWaterModel",
           "ShallowWaterState", "VectorInvariantFormulation",
           "conservative_tendencies"]
