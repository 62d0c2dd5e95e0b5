"""NonhydrostaticModel: incompressible Boussinesq dynamics with a pressure
projection.

Counterpart of ``oceananigans_tpu/models/nonhydrostatic.py`` on a
``RectilinearGrid``, regular or stretched, or an ``ImmersedBoundaryGrid``
over one: Centered, UpwindBiased, WENO or FluxFormAdvection advection of
momentum and tracers (bound to a stretched grid's coefficient tables),
Coriolis, buoyancy, the closures of ``closures.py`` and
``closures_ocean.py`` (their explicit flux divergences added to the
tendencies, their vertically implicit part solved after the update),
forcings (``forcings.py``), background fields, Stokes drift,
biogeochemistry and Lagrangian particles, valued and open boundary
conditions, immersed boundary conditions, quasi-AB2 or RK3 time stepping.
The terms follow the JAX model's order: momentum advection (with
background fields, plain: the total flow's advection of the total
velocity less the background's self-advection), Stokes drift, Coriolis,
buoyancy, the closure, the forcings, the boundary fluxes; each tracer's
advection (by its advective forcings' velocities too), the closure, the
biogeochemical transition and drift, the forcing and the boundary fluxes;
then the biogeochemistry's ``update_tendencies``. Particles step at the
end of the step. The pressure solver is the FFT
solver on a regular grid, the Fourier-tridiagonal solver on a stretched z
and preconditioned CG on an immersed grid (``solvers/pressure_solver.py``).
On an immersed grid the velocities are masked before every halo fill, the
projection's gradient is zeroed on solid faces, and no kernel runs (their
gates take no immersed grid). The model is an ``nn.Module`` whose grid and
pressure solver are submodules, so ``model.to(device)`` moves every
constant they hold.

The state is a dataclass of tensors, with the tracers and their previous
tendencies in dicts keyed by name in the model's tracer order. ``step``
returns a new state but reuses its argument's storage: halo fills write the
halo rows of the fields in place, and the fused AB2 kernels write the new
tendencies over the previous ones, as the JAX kernels alias them. A caller
that needs the old state afterwards keeps a copy.

Fused kernels: with ``fused_kernels="auto"`` they run exactly when the
model's device is a CUDA device, where the wrappers launch the
hand-written kernels; with ``fused_kernels=True`` on the CPU the same code
paths run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Dict, Optional

import torch

from oceananigans_torch import closures as closures_mod
from oceananigans_torch.advection import (
    SCHEMES, WENO, Centered, bind_grid, cell_advection_timescale, div_Uc,
    div_vu, div_vv, div_vw, required_halo,
)
from oceananigans_torch.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions, has_valued_flux,
    regularize_field_boundary_conditions, top_flux_values,
)
from oceananigans_torch.buoyancy import (
    BuoyancyTracer, regularize_buoyancy,
)
from oceananigans_torch.coriolis import FPlane
from oceananigans_torch.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, BackgroundField, location_coords, new_field,
    set_field,
)
from oceananigans_torch.forcings import materialize_forcings
from oceananigans_torch.grids.base import Center, Periodic
from oceananigans_torch.grids.rectilinear import RectilinearGrid
from oceananigans_torch.immersed import (
    ImmersedBoundaryGrid, immersed_flux_divergence, mask_immersed_field,
    regularize_immersed_bc, scalar_diffusivity_of,
)
from oceananigans_torch.ops.cuda_kernels import (
    MAX_TRACERS, centered2_ab2_update, centered2_momentum_tendency,
    centered2_science_ab2_update, fused_available, pressure_correction,
)
from oceananigans_torch.ops.cuda_tracer import (
    tracer_fusion_available, tracer_metric_profiles, weno_tracer_tendencies,
)
from oceananigans_torch.ops.cuda_weno import (
    weno5_ab2_update, weno5_available, weno5_momentum_tendency,
    weno5_science_ab2_update, weno5_tracer_tendencies,
)
from oceananigans_torch.ops.operators import (
    ddx_f, ddy_f, ddz_f, divergence_ccc,
)
from oceananigans_torch.particles import ParticleState
from oceananigans_torch.solvers.pressure_solver import make_pressure_solver
from oceananigans_torch.timesteppers import (
    Clock, RK3_STAGES, ab2_coefficients, tick,
)

TIMESTEPPERS = ("QuasiAdamsBashforth2", "RungeKutta3")


@dataclasses.dataclass
class NonhydrostaticState:
    """Prognostic and diagnostic fields. ``Gu``/``Gv``/``Gw`` and
    ``Gtracers`` hold the previous tendencies that quasi-AB2 needs."""
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    pressure: torch.Tensor
    clock: Clock
    Gu: torch.Tensor
    Gv: torch.Tensor
    Gw: torch.Tensor
    tracers: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    Gtracers: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    particles: Optional[ParticleState] = None

    @property
    def velocities(self):
        return {"u": self.u, "v": self.v, "w": self.w}

    def fields(self):
        return {"u": self.u, "v": self.v, "w": self.w, **self.tracers}


_replace = dataclasses.replace


class NonhydrostaticModel(torch.nn.Module):
    """Configuration and step functions; mirrors the JAX constructor's
    keywords."""

    def __init__(self, grid, advection=None, tracers=(), buoyancy=None,
                 coriolis=None, closure=None, forcing=None,
                 boundary_conditions=None, background_fields=None,
                 particles=None, stokes_drift=None, biogeochemistry=None,
                 fused_kernels="auto", timestepper="RungeKutta3",
                 device=None):
        super().__init__()
        #: the constructor's arguments but the grid, for a rebuild on
        #: another grid (``parallel.sharded_step_fn``)
        self._init_kwargs = dict(
            advection=advection, tracers=tracers, buoyancy=buoyancy,
            coriolis=coriolis, closure=closure, forcing=forcing,
            boundary_conditions=boundary_conditions,
            background_fields=background_fields, particles=particles,
            stokes_drift=stokes_drift, biogeochemistry=biogeochemistry,
            fused_kernels=fused_kernels, timestepper=timestepper)
        base = (grid.underlying_grid
                if isinstance(grid, ImmersedBoundaryGrid) else grid)
        if not isinstance(base, RectilinearGrid):
            # the JAX model's pressure solvers take no spherical grid
            raise ValueError(f"NonhydrostaticModel needs a RectilinearGrid "
                             f"(or an ImmersedBoundaryGrid over one), not a "
                             f"{type(base).__name__}")
        if advection is None:
            advection = Centered(2)
        if not isinstance(advection, SCHEMES):
            raise ValueError(f"unknown advection {advection!r}")
        buoyancy = regularize_buoyancy(buoyancy)
        if timestepper not in TIMESTEPPERS:
            raise ValueError(f"unknown timestepper {timestepper!r}")
        closures_mod.check_closure(closure, "NonhydrostaticModel")
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        # the required tracers in the JAX model's order (a biogeochemistry
        # and a buoyancy formulation must name theirs, a closure may)
        for required in (biogeochemistry, buoyancy):
            if required is not None:
                tracers += tuple(t for t in required.required_tracers
                                 if t not in tracers)
        for cl in closures_mod._as_tuple(closure):
            tracers += tuple(t for t in getattr(cl, "required_tracers", ())
                             if t not in tracers)
        needed = max(required_halo(advection),
                     closures_mod.closure_required_halo(closure))
        for axis in range(3):
            H, N = grid.H[axis], grid.N[axis]
            if N <= 1 or (grid.axis_topo(axis) == Periodic and H == 0):
                continue
            if H < min(needed, N):
                raise ValueError(
                    f"grid halo {grid.H} too small for advection/closure "
                    f"requiring {needed}; build the grid with halo={needed} "
                    "(or halo=0 on periodic axes)")

        self.grid = grid
        # the per-point tables of a stretched grid (the scheme itself on a
        # regular one)
        self.advection = bind_grid(advection, grid)
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        self.timestepper = timestepper
        self.particles = particles
        self.stokes_drift = stokes_drift
        self.biogeochemistry = biogeochemistry
        boundary_conditions = dict(boundary_conditions or {})
        self.locations = {"u": LOC_U, "v": LOC_V, "w": LOC_W,
                          **{t: LOC_C for t in tracers}}
        self.bcs = {name: regularize_field_boundary_conditions(
            boundary_conditions.get(name), grid, loc)
            for name, loc in self.locations.items()}
        self.pressure_bcs = regularize_field_boundary_conditions(
            None, grid, LOC_C)
        self.forcings, self.advective_forcings = materialize_forcings(
            forcing, self.locations, tracers)
        #: background fields by name: ``(value, time_dependent)``, where a
        #: ``BackgroundField`` or a callable of four or more arguments is
        #: ``f(x, y, z, t)``, evaluated at each step's clock time, and
        #: anything else (a 3-argument callable, a number, an array) a
        #: static ``set_field`` value
        self.background_fields = {
            name: (fn, _time_dependent(fn))
            for name, fn in dict(background_fields or {}).items()}
        self._static_backgrounds = {}
        # the immersed boundary conditions, and the scalar diffusivity
        # their Value and Gradient fluxes use
        self.immersed_bcs = {}
        if isinstance(grid, ImmersedBoundaryGrid):
            for name, loc in self.locations.items():
                rib = regularize_immersed_bc(self.bcs[name].immersed, loc)
                if rib is not None:
                    self.immersed_bcs[name] = rib
        self._ib_kappa = {
            name: scalar_diffusivity_of(
                closure, None if name in ("u", "v", "w") else name)
            for name in self.immersed_bcs}
        self.pressure_solver = make_pressure_solver(grid)
        self._fused_kernels = fused_kernels
        #: fused pressure-correction kernel; opt-in, as in the JAX package
        self.fused_correction = False
        #: hooks ``(grid, state, {name: G}) -> {name: G}`` applied to the
        #: tendencies at the end of :meth:`compute_tendencies` (wired by
        #: ``Simulation`` for ``TendencyCallsite`` callbacks); while one is
        #: set, no fused AB2 kernel runs
        self.tendency_callbacks = ()
        # the metric profiles of the any-order WENO tracer kernel, where
        # its gate's layout part holds (see fused_tracer)
        self.register_buffer(
            "_tracer_metrics",
            tracer_metric_profiles(grid)
            if type(advection) is WENO and advection.order != 5
            and tracer_fusion_available(grid, self.advection) else None,
            persistent=False)
        if device is not None:
            self.to(device)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    #: the mesh context of a rank's LOCAL model in a ``DistributedStep``
    #: (``parallel/shard_step.py``): its halo fills exchange strips with the
    #: neighbouring ranks, and no fused AB2 kernel runs, as in the JAX
    #: package; ``dist_topo`` is the global grid's topology
    dist_halo = None
    dist_topo = None

    def set_dist_halo(self, ctx, topo):
        """Route this (local) model's halo fills through the exchange of
        ``ctx``, a ``DistHalo``, with the global topology ``topo``."""
        self.dist_halo = ctx
        self.dist_topo = tuple(topo)

    # ------------------------------------------------------------------
    # Dispatch gates, the JAX model's. The tendency kernels run whatever
    # the closure, the boundary fluxes, the forcings, the Stokes drift and
    # the biogeochemistry (their terms are added to the kernels' output),
    # but not under background fields; the fused AB2 kernels take none of
    # these (``_fused_common``).
    # ------------------------------------------------------------------
    @property
    def fused_kernels(self):
        """The kernel family that runs: ``"centered2"``, ``"weno5"`` or
        False (always False under background fields, whose momentum
        advection runs plain); "auto" means: on a CUDA device."""
        if self.background_fields:
            return False
        if fused_available(self.grid, self.advection):
            tag = "centered2"
        elif weno5_available(self.grid, self.advection):
            tag = "weno5"
        else:
            return False
        return tag if self._kernels_on() else False

    def _kernels_on(self) -> bool:
        if self._fused_kernels == "auto":
            return self.device.type == "cuda"
        return bool(self._fused_kernels)

    @property
    def fused_tracer(self) -> bool:
        """The any-order WENO tracer kernel (``weno_tracer_tendencies``)
        computes every tracer's advection: WENO of an order other than 5
        (the WENO-5 kernels take that one), as the JAX model's
        ``fused_tracer``, without the TPU's tiling rules; refused under
        background fields."""
        return (self._tracer_metrics is not None and self._kernels_on()
                and not self.background_fields)

    @property
    def _fused_common(self) -> bool:
        """What every fused AB2 kernel needs: AB2 stepping, no closure, no
        Stokes drift, no background field, no forcing, no advective
        forcing, no biogeochemistry, no flux condition with a value on u,
        v, w or a tracer, no immersed boundary condition and no tendency
        callback, and no distributed context."""
        return (self.timestepper == "QuasiAdamsBashforth2"
                and self.dist_halo is None
                and self.closure is None
                and self.stokes_drift is None
                and not self.background_fields
                and all(f is None for f in self.forcings.values())
                and not self.advective_forcings
                and self.biogeochemistry is None
                and not any(has_valued_flux(b) for b in self.bcs.values())
                and not self.immersed_bcs
                and not self.tendency_callbacks)

    @property
    def _pure_advection(self) -> bool:
        return (self._fused_common
                and self.coriolis is None and self.buoyancy is None
                and not self.tracer_names)

    @property
    def fused_ab2(self) -> bool:
        """The Centered-2 tendency and the AB2 update run as one kernel."""
        return self._pure_advection and self.fused_kernels == "centered2"

    @property
    def fused_ab2_weno(self) -> bool:
        """The WENO-5 tendency and the AB2 update run as one kernel."""
        return self._pure_advection and self.fused_kernels == "weno5"

    @property
    def _science_fusable(self) -> bool:
        """The physics a science kernel takes: AB2, f-plane Coriolis or
        none, a BuoyancyTracer with gravity along -z or no buoyancy, and at
        most MAX_TRACERS tracers (in place of the JAX model's VMEM budget,
        ``science_kernel_fits``)."""
        buoyancy_ok = self.buoyancy is None or (
            isinstance(self.buoyancy.formulation, BuoyancyTracer)
            and self.buoyancy.gravity_unit_vector == (0.0, 0.0, -1.0))
        return (self._fused_common
                and (self.coriolis is None
                     or type(self.coriolis) is FPlane)
                and buoyancy_ok
                and len(self.tracer_names) <= MAX_TRACERS)

    @property
    def fused_ab2_science(self) -> bool:
        """The Centered-2 science step (``centered2_science_ab2_update``)
        as one kernel."""
        return (self.fused_kernels == "centered2" and not self.fused_ab2
                and self._science_fusable)

    @property
    def fused_ab2_weno_science(self) -> bool:
        """The WENO-5 science step (``weno5_science_ab2_update``) as one
        kernel."""
        return (self.fused_kernels == "weno5" and not self.fused_ab2_weno
                and self._science_fusable)

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------
    def initial_state(self, time=0.0, **field_values):
        """A state from initial velocities and tracers (numbers, arrays or
        callables ``f(x, y, z)`` of coordinate tensors), projected onto the
        divergence-free subspace."""
        g = self.grid
        unknown = set(field_values) - set(self.locations)
        if unknown:
            raise ValueError(f"unknown initial_state fields {sorted(unknown)}"
                             f"; this model takes {sorted(self.locations)}")

        def mk(name):
            if name in field_values:
                return set_field(g, field_values[name],
                                 loc=self.locations[name])
            return new_field(g)

        state = NonhydrostaticState(
            u=mk("u"), v=mk("v"), w=mk("w"), pressure=new_field(g),
            clock=Clock.start(time, g.dtype),
            Gu=new_field(g), Gv=new_field(g), Gw=new_field(g),
            tracers={t: mk(t) for t in self.tracer_names},
            Gtracers={t: new_field(g) for t in self.tracer_names},
            particles=(self.particles.state_on(g)
                       if self.particles is not None else None))
        state = self.fill_state_halos(state)
        state = self._pressure_correct(state, 1.0)
        return self.fill_state_halos(state)

    # ------------------------------------------------------------------
    # Halo fills (in place)
    # ------------------------------------------------------------------
    def _fill_field(self, a, bcs, loc, t, dt=None):
        """Fill ``a``'s halos in place: through the distributed exchange
        under a ``dist_halo``, else the ordinary fill."""
        if self.dist_halo is not None:
            from oceananigans_torch.parallel.shard_step import (
                dist_fill_halos,
            )
            return dist_fill_halos(a, self.grid, bcs, loc, t, dt,
                                   self.dist_halo, self.dist_topo)
        return fill_halo_regions(a, self.grid, bcs, loc, t, dt=dt)

    def fill_state_halos(self, state):
        """Fill every field's halos in place at the clock time (the
        velocities also with the last Δt, which the radiation condition
        reads); on an immersed grid the velocities are masked first."""
        if isinstance(self.grid, ImmersedBoundaryGrid):
            g = self.grid
            state = _replace(state, u=mask_immersed_field(g, state.u, LOC_U),
                             v=mask_immersed_field(g, state.v, LOC_V),
                             w=mask_immersed_field(g, state.w, LOC_W))
        t, dtl = state.clock.time, state.clock.last_dt
        for name, field in state.fields().items():
            self._fill_field(field, self.bcs[name], self.locations[name], t,
                             dt=dtl if name in ("u", "v", "w") else None)
        return state

    def _fill_before_projection(self, state):
        """Fill only the halos the projection reads: the divergence shifts
        each velocity component along its own axis only, so u in x, v in y
        and w in z (halo-free periodic axes wrap exactly). An immersed grid
        takes the full fill, with its masking, and so does a distributed
        local model."""
        if (isinstance(self.grid, ImmersedBoundaryGrid)
                or self.dist_halo is not None):
            return self.fill_state_halos(state)
        t, dtl = state.clock.time, state.clock.last_dt
        for axis, name in enumerate(("u", "v", "w")):
            if self.grid.H[axis] == 0:
                continue
            fill_halo_regions(getattr(state, name), self.grid, self.bcs[name],
                              self.locations[name], t, dt=dtl, axes=(axis,))
        return state

    # ------------------------------------------------------------------
    # Tendencies and projection
    # ------------------------------------------------------------------
    def compute_diffusivities(self, state):
        """The closure's coefficients of this step, one entry a closure."""
        return closures_mod.compute_diffusivities(
            self.closure, self.grid, state.u, state.v, state.w,
            state.tracers, self.buoyancy,
            top_fluxes=lambda: top_flux_values(self.bcs, self.grid,
                                               state.clock.time))

    def background(self, time):
        """The background fields at ``time`` (the clock's 0-d tensor), by
        name, each a tensor of the grid's shape; the static ones are made
        once and kept."""
        g = self.grid
        out = {}
        for name, (fn, timed) in self.background_fields.items():
            loc = self.locations[name]
            if timed:
                x, y, z = location_coords(g, loc)
                out[name] = torch.as_tensor(
                    fn(x, y, z, time), dtype=g.dtype,
                    device=g.device).expand(g.shape)
                continue
            key = (name, g.device, g.dtype)
            if key not in self._static_backgrounds:
                self._static_backgrounds[key] = set_field(g, fn, loc=loc)
            out[name] = self._static_backgrounds[key]
        return out

    def compute_tendencies(self, state, diffusivities=None):
        """``(Gu, Gv, Gw, {name: Gc})``: advection, Stokes drift, Coriolis,
        buoyancy, the closure's explicit stress divergence and the forcing
        of the momentum; advection (with any advective forcings'
        velocities), the closure's explicit flux divergence, the
        biogeochemical transition and drift and the forcing of each tracer;
        the boundary fluxes; the biogeochemistry's ``update_tendencies``;
        then the ``tendency_callbacks`` in order. ``diffusivities`` are
        computed here when not given."""
        g = self.grid
        u, v, w = state.u, state.v, state.w
        tracers = state.tracers
        time = state.clock.time
        fields = state.fields()
        if diffusivities is None:
            diffusivities = self.compute_diffusivities(state)
        kernels = self.fused_kernels
        bg = self.background(time) if self.background_fields else {}
        if bg:
            # advect the total fields by the total flow, less the
            # background's self-advection (assumed balanced)
            ub = bg.get("u", torch.zeros_like(u))
            vb = bg.get("v", torch.zeros_like(v))
            wb = bg.get("w", torch.zeros_like(w))
            ut, vt, wt = u + ub, v + vb, w + wb
            Gu = -(div_vu(g, self.advection, ut, vt, wt)
                   - div_vu(g, self.advection, ub, vb, wb))
            Gv = -(div_vv(g, self.advection, ut, vt, wt)
                   - div_vv(g, self.advection, ub, vb, wb))
            Gw = -(div_vw(g, self.advection, ut, vt, wt)
                   - div_vw(g, self.advection, ub, vb, wb))
        else:
            ut, vt, wt = u, v, w
            if kernels == "centered2":
                Gu, Gv, Gw = centered2_momentum_tendency(g, u, v, w)
            elif kernels == "weno5":
                Gu, Gv, Gw = weno5_momentum_tendency(
                    g, u, v, w, epsilon=self.advection.epsilon)
            else:
                Gu = -div_vu(g, self.advection, u, v, w)
                Gv = -div_vv(g, self.advection, u, v, w)
                Gw = -div_vw(g, self.advection, u, v, w)
        if self.stokes_drift is not None:
            Gu = Gu + self.stokes_drift.x_tendency(g, u, v, w, time)
            Gv = Gv + self.stokes_drift.y_tendency(g, u, v, w, time)
            Gw = Gw + self.stokes_drift.z_tendency(g, u, v, w, time)
        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(g, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(g, u, v, w)
            Gw = Gw - self.coriolis.z_f_cross_U(g, u, v, w)
        if self.buoyancy is not None:
            bx = self.buoyancy.x_contribution(g, tracers)
            by = self.buoyancy.y_contribution(g, tracers)
            bz = self.buoyancy.z_contribution(g, tracers)
            Gu = Gu if bx is None else Gu + bx
            Gv = Gv if by is None else Gv + by
            Gw = Gw if bz is None else Gw + bz
        if self.closure is not None:
            du, dv, dw = closures_mod.momentum_flux_divergences(
                self.closure, g, u, v, w, tracers, diffusivities,
                include_implicit=False)
            Gu, Gv, Gw = Gu + du, Gv + dv, Gw + dw
        f = self.forcings
        Gu = Gu if f["u"] is None else Gu + f["u"](g, time, fields)
        Gv = Gv if f["v"] is None else Gv + f["v"](g, time, fields)
        Gw = Gw if f["w"] is None else Gw + f["w"](g, time, fields)
        Gu = apply_flux_bcs(Gu, g, self.bcs["u"], LOC_U, time, fields)
        Gv = apply_flux_bcs(Gv, g, self.bcs["v"], LOC_V, time, fields)
        Gw = apply_flux_bcs(Gw, g, self.bcs["w"], LOC_W, time, fields)
        for name, vel, loc in (("u", u, LOC_U), ("v", v, LOC_V),
                               ("w", w, LOC_W)):
            ib = self.immersed_bcs.get(name)
            if ib is None:
                continue
            term = immersed_flux_divergence(g, ib, loc, vel,
                                            self._ib_kappa[name], time)
            if name == "u":
                Gu = Gu + term
            elif name == "v":
                Gv = Gv + term
            else:
                Gw = Gw + term

        # one kernel for every tracer without an advective forcing or a
        # background, on the total flow as in the JAX model (whose gates,
        # like these, select no kernel under background fields)
        kernel_tracers = {n: tracers[n] for n in self.tracer_names
                          if n not in self.advective_forcings
                          and n not in bg}
        fused = {}
        if kernels == "weno5":
            fused = weno5_tracer_tendencies(g, ut, vt, wt, kernel_tracers,
                                            epsilon=self.advection.epsilon)
        elif self.fused_tracer:
            fused = weno_tracer_tendencies(g, self.advection, ut, vt, wt,
                                           kernel_tracers,
                                           metrics=self._tracer_metrics)
        bgc = self.biogeochemistry
        Gtracers = {}
        for name in self.tracer_names:
            c = tracers[name]
            Gc = fused.get(name)
            if Gc is None:
                uta, vta, wta = ut, vt, wt
                for af in self.advective_forcings.get(name, ()):
                    ua, va, wa = af.velocities(g)
                    uta, vta, wta = uta + ua, vta + va, wta + wa
                if name in bg:
                    # the total tracer by the total flow, less the
                    # background tracer by the background flow
                    cb = bg[name]
                    Gc = -(div_Uc(g, self.advection, uta, vta, wta, c + cb)
                           - div_Uc(g, self.advection, ub, vb, wb, cb))
                else:
                    Gc = -div_Uc(g, self.advection, uta, vta, wta, c)
            if self.closure is not None:
                Gc = Gc + closures_mod.tracer_flux_divergence(
                    self.closure, g, name, c, tracers, diffusivities,
                    include_implicit=False)
            if bgc is not None:
                reaction = bgc.transition(g, name, time, fields)
                if reaction is not None:
                    Gc = Gc + reaction
                drift = bgc.drift_velocity(name)
                if drift is not None:
                    wu, wv, ww = (torch.zeros_like(c) + d for d in drift)
                    Gc = Gc - div_Uc(g, self.advection, wu, wv, ww, c)
            if f[name] is not None:
                Gc = Gc + f[name](g, time, fields)
            Gc = apply_flux_bcs(Gc, g, self.bcs[name], LOC_C, time, fields)
            ib = self.immersed_bcs.get(name)
            if ib is not None:
                Gc = Gc + immersed_flux_divergence(
                    g, ib, LOC_C, c, self._ib_kappa[name], time)
            Gtracers[name] = Gc
        if bgc is not None:
            Gtracers = bgc.update_tendencies(g, Gtracers, time, fields)
        for hook in self.tendency_callbacks:
            G = hook(g, state, {"u": Gu, "v": Gv, "w": Gw, **Gtracers})
            Gu, Gv, Gw = G["u"], G["v"], G["w"]
            Gtracers = {n: G[n] for n in Gtracers}
        return Gu, Gv, Gw, Gtracers

    def _pressure_correct(self, state, dt):
        """Project the velocities: solve ∇²p = ∇·u / Δt and subtract Δt∇p.
        ``dt`` is a Python float."""
        g = self.grid
        div = divergence_ccc(g, state.u, state.v, state.w)
        phi = self.pressure_solver.solve(g.interior(div) / dt)
        p = torch.zeros_like(div)   # batched where the state is (vmap)
        p[g.interior_slices] = phi
        self._fill_field(p, self.pressure_bcs, LOC_C, None)
        if self.fused_correction:
            u, v, w = pressure_correction(g, p, state.u, state.v, state.w,
                                          dt)
        else:
            gx, gy, gz = ddx_f(g, p, Center), ddy_f(g, p, Center), ddz_f(g, p)
            if isinstance(g, ImmersedBoundaryGrid):
                # the masked operator has no flux through solid faces; the
                # correction leaves them too, or div(u − Δt∇p) = 0 breaks
                gx = torch.where(g.solid_u, 0.0, gx)
                gy = torch.where(g.solid_v, 0.0, gy)
                gz = torch.where(g.solid_w, 0.0, gz)
            u = state.u - dt * gx
            v = state.v - dt * gy
            w = state.w - dt * gz
        return _replace(state, u=u, v=v, w=w, pressure=p)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def step(self, state, dt, assume_filled=False):
        """One full time step. ``assume_filled=True`` skips the leading
        halo fill: every step ends with one, so a loop fills once before
        its first step and passes ``assume_filled=True``."""
        dt = torch.tensor(dt, dtype=state.u.dtype)
        if self.timestepper == "RungeKutta3":
            state = self.rk3_step(state, dt, assume_filled=assume_filled)
        else:
            state = self.ab2_step(state, dt, assume_filled=assume_filled)
        return self._step_particles(state, dt)

    def _step_particles(self, state, dt):
        """The particles advected by the step's final velocities (and their
        tracked fields interpolated), as at the end of the JAX step."""
        if self.particles is None or state.particles is None:
            return state
        return _replace(state, particles=self.particles.step(
            self.grid, state.particles, state.u, state.v, state.w,
            state.fields(), dt))

    def _implicit_diffusion(self, state, diffusivities, dt):
        """The closure's vertically implicit diffusion of u, v and the
        tracers over ``dt`` (a 0-d tensor), where it has one."""
        if not closures_mod.closure_is_vertically_implicit(self.closure):
            return state
        u, v, tracers = closures_mod.implicit_vertical_diffusion_step(
            self.grid, self.closure, diffusivities, dt,
            u=state.u, v=state.v, tracers=state.tracers)
        return _replace(state, u=u, v=v, tracers=tracers)

    def rk3_step(self, state, dt, assume_filled=False):
        """3-stage Wray RK3 with a projection at every stage; boundary
        conditions are evaluated at each stage's time. ``dt`` is a 0-d CPU
        tensor in the state's dtype."""
        Gu_prev, Gv_prev, Gw_prev = state.Gu, state.Gv, state.Gw
        Gt_prev = state.Gtracers
        dtf = dt.item()
        t0 = state.clock.time
        stage_frac = 0.0
        for stage, (gamma, zeta) in enumerate(RK3_STAGES):
            state = _replace(state, clock=dataclasses.replace(
                state.clock, time=t0 + stage_frac * dt))
            if stage > 0 or not assume_filled:
                state = self.fill_state_halos(state)
            diffusivities = self.compute_diffusivities(state)
            Gu, Gv, Gw, Gt = self.compute_tendencies(state, diffusivities)
            stage_frac += gamma + zeta
            stage_dt = dt * (gamma + zeta)
            state = _replace(
                state,
                u=state.u + dtf * (gamma * Gu + zeta * Gu_prev),
                v=state.v + dtf * (gamma * Gv + zeta * Gv_prev),
                w=state.w + dtf * (gamma * Gw + zeta * Gw_prev),
                tracers={n: state.tracers[n]
                         + dtf * (gamma * Gt[n] + zeta * Gt_prev[n])
                         for n in self.tracer_names})
            state = self._implicit_diffusion(state, diffusivities, stage_dt)
            state = self._fill_before_projection(state)
            state = self._pressure_correct(state, stage_dt.item())
            Gu_prev, Gv_prev, Gw_prev, Gt_prev = Gu, Gv, Gw, Gt
        clock = tick(dataclasses.replace(state.clock, time=t0), dt)
        state = _replace(state, Gu=Gu_prev, Gv=Gv_prev, Gw=Gw_prev,
                         Gtracers=Gt_prev, clock=clock)
        return self.fill_state_halos(state)

    def ab2_update(self, state, dt, chi=0.1, diffusivities=None):
        """The tendencies and the quasi-AB2 update of every prognostic
        field, through the one fused kernel that applies or through
        :meth:`compute_tendencies` (with ``diffusivities`` when given); the
        first part of :meth:`ab2_step`."""
        c_now, c_prev = ab2_coefficients(state.clock.iteration, chi)
        a, b = (dt * c_now).item(), (dt * c_prev).item()
        g = self.grid
        if self.fused_ab2:
            u, v, w, Gu, Gv, Gw = centered2_ab2_update(
                g, state.u, state.v, state.w, state.Gu, state.Gv, state.Gw,
                a, b)
            return _replace(state, u=u, v=v, w=w, Gu=Gu, Gv=Gv, Gw=Gw)
        if self.fused_ab2_weno:
            u, v, w, Gu, Gv, Gw = weno5_ab2_update(
                g, state.u, state.v, state.w, state.Gu, state.Gv, state.Gw,
                a, b, epsilon=self.advection.epsilon)
            return _replace(state, u=u, v=v, w=w, Gu=Gu, Gv=Gv, Gw=Gw)
        if self.fused_ab2_science or self.fused_ab2_weno_science:
            kernel = (centered2_science_ab2_update if self.fused_ab2_science
                      else functools.partial(weno5_science_ab2_update,
                                             epsilon=self.advection.epsilon))
            u, v, w, tracers, Gu, Gv, Gw, Gt = kernel(
                g, state.u, state.v, state.w, state.tracers,
                state.Gu, state.Gv, state.Gw, state.Gtracers, a, b,
                f=self.coriolis.f if self.coriolis is not None else 0.0,
                buoyancy_tracer="b" if self.buoyancy is not None else None)
            return _replace(state, u=u, v=v, w=w, tracers=tracers,
                            Gu=Gu, Gv=Gv, Gw=Gw, Gtracers=Gt)
        Gu, Gv, Gw, Gt = self.compute_tendencies(state, diffusivities)
        dtf = dt.item()
        return _replace(
            state,
            u=state.u + dtf * (c_now * Gu + c_prev * state.Gu),
            v=state.v + dtf * (c_now * Gv + c_prev * state.Gv),
            w=state.w + dtf * (c_now * Gw + c_prev * state.Gw),
            tracers={n: state.tracers[n]
                     + dtf * (c_now * Gt[n] + c_prev * state.Gtracers[n])
                     for n in self.tracer_names},
            Gu=Gu, Gv=Gv, Gw=Gw, Gtracers=Gt)

    def ab2_step(self, state, dt, chi=0.1, assume_filled=False):
        """Quasi-AB2 with an Euler first step, then the closure's implicit
        vertical diffusion. ``dt`` is a 0-d CPU tensor in the state's
        dtype."""
        if not assume_filled:
            state = self.fill_state_halos(state)
        diffusivities = (self.compute_diffusivities(state)
                         if self.closure is not None else None)
        state = self.ab2_update(state, dt, chi, diffusivities)
        state = self._implicit_diffusion(state, diffusivities, dt)
        state = self._fill_before_projection(state)
        state = self._pressure_correct(state, dt.item())
        state = _replace(state, clock=tick(state.clock, dt))
        return self.fill_state_halos(state)

    # ------------------------------------------------------------------
    # Time scales (TimeStepWizard)
    # ------------------------------------------------------------------
    def cfl_timescale(self, state):
        """min over the interior of (|u|/Δx + |v|/Δy + |w|/Δz)⁻¹."""
        return cell_advection_timescale(self.grid, state.u, state.v, state.w)

    def diffusion_timescale(self, state):
        """Δmin²/ν_max of the closure (Δmin⁴ for biharmonic ones), +inf
        without one; for ``TimeStepWizard(diffusive_cfl=)``."""
        return closures_mod.cell_diffusion_timescale(
            self.closure, self.grid, self.compute_diffusivities(state))

    def extra_repr(self):
        return (f"advection={self.advection!r}, "
                f"tracers={self.tracer_names}, coriolis={self.coriolis!r}, "
                f"closure={self.closure!r}, "
                f"buoyancy={self.buoyancy!r}, "
                f"timestepper={self.timestepper!r}")


def _time_dependent(fn) -> bool:
    """A background field that is a function of time: a
    ``BackgroundField``, or a callable of four or more arguments."""
    if isinstance(fn, BackgroundField):
        return True
    if not callable(fn):
        return False
    try:
        return len(inspect.signature(fn).parameters) >= 4
    except (TypeError, ValueError):
        return False


__all__ = ["NonhydrostaticModel", "NonhydrostaticState"]
