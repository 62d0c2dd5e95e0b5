"""Where the time of a step goes, on one CUDA device.

Run from the root of the repository:

    python3 -m oceananigans_torch.profile_step [--config NAME] [--trace-dir DIR]

It runs one of ``bench.py``'s configurations, chosen by ``--config``. The
nonhydrostatic ones are 256³, float32, (Bounded, Periodic, Periodic),
Δt = 1e-4, with ``bench.py``'s initial velocities and tracers, stepped by
quasi-AB2:

- ``default``: Centered(2), halo (1, 0, 0);
- ``science``: Centered(2), FPlane(f=1e-4), BuoyancyTracer, tracers
  ("b", "c"), halo (1, 0, 0);
- ``weno``: WENO(5), tracers ("T", "S"), halo (3, 0, 0);
- ``weno_mom``: WENO(5), halo (3, 0, 0).

The shallow-water ones are ``bench.py``'s ``sw8192`` and ``sw16384``:
N², float32, (Periodic, Periodic, Flat), halo (8, 0, 0), extent 1e6 m,
g = 9.81, Δt = 1 s, the initial ``h`` and ``uh`` of ``bench.py``, stepped
by RK3 (three stage kernels and the halo fills per step). That Δt is above
RK3's stability limit for the grid-scale gravity waves (ω·Δt = 2.3 at
8192², 4.6 at 16384², against √3), so rounding noise grows by about 1.7
(8192²) or 15 (16384²) a step and the fields overflow after ~30 or ~8
steps; every shallow-water measurement therefore starts again from the
initial state after 2 warm-up steps and runs 20 (8192²) or 4 (16384²)
steps.

The hydrostatic one is ``bench.py``'s ``hydro_vi``: 360 × 160 × 60,
extent (4e7, 2e7, 4e3) m, (Periodic, Bounded, Bounded), halo (6, 6, 4),
float32, ``WENOVectorInvariant()`` momentum advection, ``WENO(7)`` tracers
T and S, ``SplitExplicitFreeSurface(substeps=30)``, Δt = 60 s, the initial
u, T and S of ``bench.py``, stepped by quasi-AB2 (the VI kernel and the
tracer kernel once a step, 21 barotropic substeps, the fills), 20 steps
per run after 5 warm-up steps.

Two configurations of the physics slice are built by
:func:`langmuir_model` and :func:`hydro_catke_model`:

- ``langmuir``: ``examples/langmuir_turbulence.py`` at 256³ over its
  128 × 128 × 64 m box, float32, (Periodic, Periodic, Bounded), halo
  (3, 3, 3), WENO(5), BuoyancyTracer b, the example's wave as a
  ``UniformStokesDrift``, ``AnisotropicMinimumDissipation``, the u and b
  surface fluxes and the b bottom gradient, a tracer P with
  ``SimpleBiogeochemistry`` (growth (1/day)·exp(z/16 m), sinking 1e-4
  m/s), and 2²⁰ ``LagrangianParticles`` tracking b; quasi-AB2, Δt = 0.5 s
  (kernels 7 and 9 once a step);
- ``hydro_catke``: ``hydro_vi`` on the 1° near-global sphere
  (:func:`hydro_latlon_model`) with ``CATKEVerticalDiffusivity()`` and a
  zonal wind stress, Δt = 60 s (kernels 11 and 12/13 once a step, the
  Thomas solves plain).

For these two the script prints the alternated step times of both paths
and the profiler's kernel time and idle share of each.

Four configurations take the implicit free surface, ``split_rk3``, the
bound-preserving limiters and z-star (:data:`OPTION_CONFIGS`):

- ``hydro_implicit``: ``hydro_vi`` with ``ImplicitFreeSurface()`` (the
  "fft" method: DCT in y, FFT in x through cuFFT), kernels 11 and 12/13
  once a step (:func:`hydro_implicit_model`);
- ``hydro_split_rk3``: ``hydro_vi``'s grid and momentum stepped by
  ``split_rk3`` with a passive tracer c under ``WENO(7, bounds=(0, 1))``,
  kernel 12/13 once a stage and no tracer kernel (the gates refuse the
  limiter; :func:`hydro_split_rk3_model`);
- ``hydro_zstar``: phase 19's 1° ocean over ``bench.py``'s continents with
  ``ZStar()`` and a passive c = 1, no kernel (:func:`hydro_zstar_model`);
- ``cs_global_implicit``: ``cs_global`` at C48×16 with the cube's implicit
  free surface (CG across the panels, RK3; no kernel;
  :func:`cs_global_implicit_model`).

For these it prints the step times (alternated with the plain path where
there is a kernel path), and each path's kernel time, launches a step and
idle share, with the last CG solve's iterations and host syncs.

It runs the kernel path (``fused_kernels="auto"``) and the plain path
(``fused_kernels=False``) and prints, for each path:

1. step times by CUDA events in alternated runs (plain, kernel, kernel,
   plain), repeated three times (100 steps per run for the 256³
   configurations, the steps above for the shallow-water ones), then the
   card's SM clock, power draw and temperature as those runs leave it;
2. the host's time to enqueue one step;
3. device time per phase: CUDA events between the phases of
   :func:`phased_ab2_step` (:data:`PHASES`) or :func:`phased_sw_step`
   (:data:`SW_PHASES`) or :func:`phased_hydro_step`
   (:data:`HYDRO_PHASES`), which repeat ``model.step`` phase by phase and
   are checked equal to it on the same state first;
4. device kernel time per step from ``torch.profiler`` over 10 steps, the
   wall time of those steps by CUDA events, and the device's idle share
   (1 - kernel time / wall time), with the largest kernels; ``--trace-dir``
   also writes each path's Chrome trace there;
5. for the 256³ configurations, single-run step times of RK3 and of the
   opt-in kernels (fused pressure correction, fused matmul Poisson solver).

It needs a CUDA device and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import subprocess
import time
from pathlib import Path

import torch

PHASES = ("tendency + AB2 update", "fill before projection",
          "divergence + right-hand side", "Poisson solve",
          "pressure embed + fill", "gradient correction", "trailing fill")


def phased_ab2_step(model, state, dt, mark):
    """``model.step(state, dt, assume_filled=True)`` for a quasi-AB2 model,
    with ``mark()`` called after each of the :data:`PHASES`."""
    from oceananigans_torch.boundary_conditions import fill_halo_regions
    from oceananigans_torch.fields import LOC_C, new_field
    from oceananigans_torch.grids.base import Center
    from oceananigans_torch.ops.cuda_kernels import pressure_correction
    from oceananigans_torch.ops.operators import (
        ddx_f, ddy_f, ddz_f, divergence_ccc,
    )
    from oceananigans_torch.timesteppers import tick
    replace = dataclasses.replace

    g = model.grid
    dt = torch.tensor(dt, dtype=state.u.dtype)
    dtf = dt.item()
    state = model.ab2_update(state, dt)
    mark()
    state = model._fill_before_projection(state)
    mark()
    rhs = g.interior(divergence_ccc(g, state.u, state.v, state.w)) / dtf
    mark()
    phi = model.pressure_solver.solve(rhs)
    mark()
    p = new_field(g, phi.dtype)
    p[g.interior_slices] = phi
    fill_halo_regions(p, g, model.pressure_bcs, LOC_C)
    mark()
    if model.fused_correction:
        u, v, w = pressure_correction(g, p, state.u, state.v, state.w, dtf)
    else:
        u = state.u - dtf * ddx_f(g, p, Center)
        v = state.v - dtf * ddy_f(g, p, Center)
        w = state.w - dtf * ddz_f(g, p)
    state = replace(state, u=u, v=v, w=w, pressure=p)
    mark()
    state = replace(state, clock=tick(state.clock, dt))
    state = model.fill_state_halos(state)
    mark()
    return state


SW_PHASES = ("stage 1 fill", "stage 1", "stage 2 fill", "stage 2",
             "stage 3 fill", "stage 3", "trailing fill")


def phased_sw_step(model, state, dt, mark):
    """``model.step(state, dt, assume_filled=True)`` for a shallow-water
    model, with ``mark()`` called after each of the :data:`SW_PHASES` (the
    first stage's fill is skipped, as ``assume_filled`` skips it)."""
    from oceananigans_torch.ops.cuda_sw import sw_rk3_stage
    from oceananigans_torch.timesteppers import RK3_STAGES, tick
    replace = dataclasses.replace

    dt = torch.tensor(dt, dtype=state.h.dtype)
    dtf = dt.item()
    G_prev = (state.Guh, state.Gvh, state.Gh, state.Gtracers)
    for stage, (gamma, zeta) in enumerate(RK3_STAGES):
        if stage > 0:
            state = model.fill_state_halos(state)
        mark()
        if model.fused_rk3:
            uh, vh, h, Guh, Gvh, Gh = sw_rk3_stage(
                model.grid, state.uh, state.vh, state.h, state.Guh,
                state.Gvh, state.Gh, (dt * gamma).item(),
                (dt * zeta).item(), model.g)
            state = replace(state, uh=uh, vh=vh, h=h, Guh=Guh, Gvh=Gvh,
                            Gh=Gh)
        else:
            Guh, Gvh, Gh, Gt = model.compute_tendencies(state)
            state = replace(
                state,
                uh=state.uh + dtf * (gamma * Guh + zeta * G_prev[0]),
                vh=state.vh + dtf * (gamma * Gvh + zeta * G_prev[1]),
                h=state.h + dtf * (gamma * Gh + zeta * G_prev[2]),
                tracers={n: state.tracers[n]
                         + dtf * (gamma * Gt[n] + zeta * G_prev[3][n])
                         for n in model.tracer_names})
            G_prev = (Guh, Gvh, Gh, Gt)
            state = replace(state, Guh=Guh, Gvh=Gvh, Gh=Gh, Gtracers=Gt)
        mark()
    state = replace(state, clock=tick(state.clock, dt))
    state = model.fill_state_halos(state)
    mark()
    return state


HYDRO_PHASES = ("momentum tendency", "tracer tendencies", "AB2 update",
                "barotropic substeps", "fill after the free surface",
                "barotropic correction", "trailing fill", "compute_w")


def phased_hydro_step(model, state, dt, mark):
    """``model.step(state, dt, assume_filled=True)`` for a hydrostatic
    model with the split-explicit free surface and without a closure,
    with ``mark()`` called after each of the :data:`HYDRO_PHASES`."""
    from oceananigans_torch.timesteppers import tick
    replace = dataclasses.replace

    dt = torch.tensor(dt, dtype=state.u.dtype)
    Gu, Gv = model.momentum_tendencies(state)
    mark()
    Gt = model.tracer_tendencies(state)
    mark()
    u, v, tracers, Gu, Gv, Gt, Gu_ab2, Gv_ab2 = model.ab2_update(
        state, dt, tendencies=(Gu, Gv, Gt))
    mark()
    eta_f, U_f, V_f = model._step_free_surface_split(
        replace(state, u=u, v=v), Gu_ab2, Gv_ab2, dt, model.free_surface)
    mark()
    state2 = model.fill_state_halos(
        replace(state, u=u, v=v, tracers=tracers, eta=eta_f, U=U_f, V=V_f))
    mark()
    state2 = model._barotropic_correct(state2, U_f, V_f)
    state2 = replace(state2, Gu=Gu, Gv=Gv, Gtracers=Gt,
                     clock=tick(state2.clock, dt))
    mark()
    state2 = model.fill_state_halos(state2)
    mark()
    state2 = model.compute_w(state2)
    mark()
    return state2


#: ``bench.py``'s hydrostatic configuration, its time step and the steps of
#: one measurement
HYDRO_CONFIG, HYDRO_DT, HYDRO_STEPS = "hydro_vi", 60.0, 20


def hydro_model(fused="auto", dtype=torch.float32, device="cuda",
                size=(360, 160, 60), momentum_advection=None, bottom=None,
                free_surface=None, timestepper="quasi_ab2",
                tracers=("T", "S"), tracer_advection=None):
    """``bench.py``'s ``hydro_vi`` model (at ``size``; with
    ``momentum_advection`` in place of its ``WENOVectorInvariant()`` when
    given; on an ``ImmersedBoundaryGrid`` over ``bottom``, such as
    :func:`ridge_bottom`, when given; with ``free_surface``,
    ``timestepper``, ``tracers`` and ``tracer_advection`` in place of its
    30-substep split-explicit free surface, quasi-AB2, T and S and
    WENO(7) when given)."""
    import oceananigans_torch as ot
    grid = ot.RectilinearGrid(size=size, extent=(4e7, 2e7, 4e3),
                              topology=(ot.Periodic, ot.Bounded, ot.Bounded),
                              halo=(6, 6, 4), dtype=dtype, device=device)
    if bottom is not None:
        grid = ot.ImmersedBoundaryGrid(grid, bottom)
    if momentum_advection is None:
        momentum_advection = ot.WENOVectorInvariant()
    return ot.HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=momentum_advection,
        tracer_advection=tracer_advection or ot.WENO(7), tracers=tracers,
        free_surface=free_surface or ot.SplitExplicitFreeSurface(
            substeps=30),
        timestepper=timestepper, fused_kernels=fused)


def hydro_initial_state(model):
    """``bench.py``'s initial u, T and S of ``hydro_vi``."""
    return model.initial_state(
        u=lambda x, y, z: 0.1 * torch.sin(2 * math.pi * x / 4e7)
        * torch.cos(math.pi * y / 2e7),
        T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
        S=lambda x, y, z: 35.0 + 1e-8 * y)


def hydro_generic_state(model):
    """A ``hydro_vi`` state without the exact zeros of ``bench.py``'s u
    (on the x = 0 faces) and v: the Bernoulli self difference of the
    vector-invariant form takes one biased side where the velocity is
    positive, the other where it is negative and their mean where it is
    zero, so where symmetry leaves a velocity within rounding of zero two
    devices' roundings pick different sides. Comparisons of devices start
    from this state."""
    return model.initial_state(
        u=lambda x, y, z: 0.1 * torch.sin(2 * math.pi * x / 4e7 + 0.5)
        * torch.cos(math.pi * y / 2e7 + 0.2) + 0.01,
        v=lambda x, y, z: 0.05 * torch.cos(2 * math.pi * x / 4e7 + 0.3)
        * torch.sin(math.pi * y / 2e7),
        T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
        S=lambda x, y, z: 35.0 + 1e-8 * y)


def latlon_continents(lam, phi):
    """``bench.py``'s continents(λ, φ) (degrees; λ wrapped to [-180,
    180)): land at +50 m, ocean 4 km deep."""
    lam = (lam + 180.0) % 360.0 - 180.0
    land = (torch.abs(lam + 60.0) < 25.0) & (phi > -55.0) & (phi < 70.0)
    land = land | ((torch.abs(lam - 45.0) < 50.0) & (phi > 0.0)
                   & (phi < 70.0))
    land = land | (torch.abs(phi) > 78.0)
    return torch.where(land, 50.0, -4000.0)


def hydro_latlon_model(fused="auto", dtype=torch.float32, device="cuda",
                       size=(360, 160, 60), momentum_advection=None,
                       longitude=(0.0, 360.0), latitude=(-80.0, 80.0),
                       halo=(6, 6, 4), bathymetry=None, closure=None,
                       boundary_conditions=None, free_surface=None,
                       vertical_coordinate=None, tracers=("T", "S")):
    """``hydro_vi`` on the sphere: a 1° near-global ocean on a
    ``LatitudeLongitudeGrid`` (at ``size``; 4 km deep), spherical Coriolis,
    linear seawater buoyancy, ``WENOVectorInvariant()`` (or
    ``momentum_advection``), WENO(7) T and S (and the other ``tracers``),
    the split-explicit free surface with 30 substeps (or
    ``free_surface``); on an ``ImmersedBoundaryGrid`` with a
    ``GridFittedBottom(bathymetry)`` where ``bathymetry`` (a callable of
    (λ, φ), such as :func:`latlon_continents`) is given; with ``closure``,
    ``boundary_conditions`` and ``vertical_coordinate`` where given."""
    import oceananigans_torch as ot
    grid = ot.LatitudeLongitudeGrid(
        size=size, longitude=longitude, latitude=latitude,
        z=(-4000.0, 0.0), halo=halo, dtype=dtype, device=device)
    if bathymetry is not None:
        grid = ot.ImmersedBoundaryGrid(grid, ot.GridFittedBottom(bathymetry))
    if momentum_advection is None:
        momentum_advection = ot.WENOVectorInvariant()
    return ot.HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=momentum_advection,
        tracer_advection=ot.WENO(7), tracers=tracers,
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState()),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=free_surface or ot.SplitExplicitFreeSurface(
            substeps=30),
        closure=closure, boundary_conditions=boundary_conditions,
        vertical_coordinate=vertical_coordinate, fused_kernels=fused)


def hydro_latlon_initial_state(model, generic=False, **fields):
    """``hydro_vi``'s fields on (λ, φ) [degrees]: u = 0.1 sin λ cos(πφ/160),
    T = 20 + 8e-4 z − 0.05 |φ|, S = 35 + 1e-3 φ, and the other ``fields``
    as given. ``generic``: u shifted and a v added, without the exact
    zeros of that u (as :func:`hydro_generic_state`), for comparisons of
    devices."""
    if generic:
        uv = dict(
            u=lambda lam, phi, z: 0.1 * torch.sin(torch.deg2rad(lam) + 0.5)
            * torch.cos(math.pi * phi / 160.0 + 0.2) + 0.01,
            v=lambda lam, phi, z: 0.05 * torch.cos(torch.deg2rad(lam) + 0.3)
            * torch.sin(math.pi * phi / 160.0))
    else:
        uv = dict(u=lambda lam, phi, z: 0.1 * torch.sin(torch.deg2rad(lam))
                  * torch.cos(math.pi * phi / 160.0))
    return model.initial_state(
        T=lambda lam, phi, z: 20.0 + 8e-4 * z - 0.05 * torch.abs(phi),
        S=lambda lam, phi, z: 35.0 + 1e-3 * phi, **uv, **fields)


def hydro_implicit_model(fused="auto", dtype=torch.float32, device="cuda",
                         size=(360, 160, 60), **free_surface):
    """``hydro_vi`` with ``ImplicitFreeSurface(**free_surface)`` (the "fft"
    method by default) in place of its split-explicit free surface."""
    import oceananigans_torch as ot
    return hydro_model(fused, dtype, device, size,
                       free_surface=ot.ImplicitFreeSurface(**free_surface))


def hydro_split_rk3_model(fused="auto", dtype=torch.float32, device="cuda",
                          size=(360, 160, 60), tracer_advection=None):
    """``hydro_vi``'s grid, momentum and split-explicit free surface (30
    substeps) stepped by ``split_rk3``, no buoyancy, one passive tracer c
    advected by ``tracer_advection`` (``WENO(7, bounds=(0, 1))`` by
    default)."""
    import oceananigans_torch as ot
    return hydro_model(fused, dtype, device, size, timestepper="split_rk3",
                       tracers=("c",),
                       tracer_advection=tracer_advection
                       or ot.WENO(7, bounds=(0.0, 1.0)))


def hydro_split_rk3_initial_state(model):
    """A zonal jet u = 0.1 cos(πy/Ly), v = 0, and c a top-hat band in x (1
    where |x − Lx/2| < Lx/8, 0 elsewhere). The jet is non-divergent, so η
    stays flat to rounding and no column's water changes: on a fixed z a
    changing column would move c off [0, 1] (the reason for z-star)
    whatever the limiter."""
    g = model.grid
    Lx, Ly = g.Lx, g.Ly
    return model.initial_state(
        u=lambda x, y, z: 0.1 * torch.cos(math.pi * y / Ly) + 0 * x + 0 * z,
        c=lambda x, y, z: torch.where(torch.abs(x - 0.5 * Lx) < Lx / 8.0,
                                      1.0, 0.0) + 0 * y + 0 * z)


def hydro_zstar_model(fused="auto", dtype=torch.float32, device="cuda",
                      size=(360, 160, 60), **grid_kw):
    """Phase 19's ``hydro_vi_bathy`` (:func:`hydro_latlon_model` over
    :func:`latlon_continents`) with ``ZStar()`` and a passive tracer c
    beside T and S."""
    import oceananigans_torch as ot
    return hydro_latlon_model(fused, dtype, device, size,
                              bathymetry=latlon_continents,
                              vertical_coordinate=ot.ZStar(),
                              tracers=("T", "S", "c"), **grid_kw)


#: the physics slice's configurations: Δt and the steps of one measurement
LANGMUIR_DT, LANGMUIR_STEPS = 0.5, 20
HYDRO_CATKE_DT, HYDRO_CATKE_STEPS = 60.0, 20
#: ``examples/langmuir_turbulence.py``'s wave (McWilliams et al. 1997),
#: fluxes and stratification
LANGMUIR_AMPLITUDE, LANGMUIR_WAVELENGTH = 0.8, 60.0
LANGMUIR_QU, LANGMUIR_QB, LANGMUIR_N2 = -3.72e-5, 2.307e-8, 1.936e-5


def langmuir_model(grid=None, size=(256, 256, 256), dtype=torch.float32,
                   device="cuda", fused="auto", particles=None):
    """``examples/langmuir_turbulence.py`` at ``size`` over its 128 x 128 x
    64 m box (or on ``grid``): WENO(5), a ``BuoyancyTracer`` b, the
    example's wave as a ``UniformStokesDrift`` (us = Us0 exp(2kz), Us0 =
    a²kω), ``AnisotropicMinimumDissipation``, the u and b surface fluxes
    and the b bottom gradient; a second tracer P under
    ``SimpleBiogeochemistry`` with the growth rate (1/day)·exp(z/16 m) and
    a sinking speed of 1e-4 m/s; ``particles`` (``LagrangianParticles``)
    when given; quasi-AB2."""
    import oceananigans_torch as ot
    if grid is None:
        grid = ot.RectilinearGrid(
            size=size, extent=(128.0, 128.0, 64.0),
            topology=(ot.Periodic, ot.Periodic, ot.Bounded), halo=(3, 3, 3),
            dtype=dtype, device=device)
    k = 2 * math.pi / LANGMUIR_WAVELENGTH
    Us0 = LANGMUIR_AMPLITUDE ** 2 * k * math.sqrt(9.81 * k)
    return ot.NonhydrostaticModel(
        grid=grid, advection=ot.WENO(5), tracers=("b", "P"),
        buoyancy=ot.BuoyancyTracer(),
        stokes_drift=ot.UniformStokesDrift(
            us=lambda z, t: Us0 * torch.exp(2 * k * z),
            dusdz=lambda z, t: 2 * k * Us0 * torch.exp(2 * k * z)),
        closure=ot.AnisotropicMinimumDissipation(),
        biogeochemistry=ot.SimpleBiogeochemistry(
            tracer="P",
            growth_rate=lambda z, t: torch.exp(z / 16.0) / 86400.0,
            sinking_speed=1e-4),
        boundary_conditions={
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(LANGMUIR_QU)),
            "b": ot.FieldBoundaryConditions(
                top=ot.FluxBC(LANGMUIR_QB),
                bottom=ot.GradientBC(LANGMUIR_N2))},
        particles=particles, timestepper="QuasiAdamsBashforth2",
        fused_kernels=fused)


def langmuir_particles(n, seed=0):
    """``n`` particles placed uniformly in the Langmuir box from
    ``numpy.random.default_rng(seed)``, tracking b."""
    import numpy as np

    import oceananigans_torch as ot
    rng = np.random.default_rng(seed)
    return ot.LagrangianParticles(
        x=128.0 * rng.random(n), y=128.0 * rng.random(n),
        z=-64.0 * rng.random(n), tracked_fields={"b": "b"})


def langmuir_initial_state(model, seed=1):
    """The example's b = N² z, u and w of 1e-4 N(0, 1) from
    ``default_rng(seed)``, and P = exp(z/8 m)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    N = model.grid.N
    return model.initial_state(
        b=lambda x, y, z: LANGMUIR_N2 * z,
        u=1e-4 * rng.standard_normal(N), w=1e-4 * rng.standard_normal(N),
        P=lambda x, y, z: torch.exp(z / 8.0) + 0 * x)


def hydro_catke_model(fused="auto", dtype=torch.float32, device="cuda",
                      size=(360, 160, 60), **grid_kw):
    """:func:`hydro_latlon_model` with ``CATKEVerticalDiffusivity()`` (its
    TKE e a third tracer) and a zonal wind stress −1e-4 cos(πφ/160°) on
    u's top, a callable of (λ, φ, t)."""
    import oceananigans_torch as ot
    return hydro_latlon_model(
        fused, dtype, device, size, closure=ot.CATKEVerticalDiffusivity(),
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=ot.FluxBC(lambda lam, phi, t: -1e-4 * torch.cos(
                math.pi * phi / 160.0) + 0 * lam))}, **grid_kw)


def baroclinic_adjustment_model(grid=None, size=(60, 60, 10),
                                dtype=torch.float64, device="cuda",
                                fused="auto"):
    """``examples/baroclinic_adjustment.py`` at ``size`` (or on ``grid``):
    a buoyancy front on a ``LatitudeLongitudeGrid`` over 10°W–10°E,
    30°N–50°N, 1 km deep; ``VectorInvariant()`` momentum, WENO(5) b,
    ``BuoyancyTracer``, spherical Coriolis, ``CATKEVerticalDiffusivity()``,
    the split-explicit free surface with 30 substeps; with a destabilizing
    b surface flux of 1e-8 m² s⁻³ added, which engages CATKE's convective
    and entrainment lengths (the example has none)."""
    import oceananigans_torch as ot
    if grid is None:
        grid = ot.LatitudeLongitudeGrid(
            size=size, longitude=(-10.0, 10.0), latitude=(30.0, 50.0),
            z=(-1000.0, 0.0), dtype=dtype, device=device)
    return ot.HydrostaticFreeSurfaceModel(
        grid=grid, tracers=("b",), buoyancy=ot.BuoyancyTracer(),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        momentum_advection=ot.VectorInvariant(),
        tracer_advection=ot.WENO(5), closure=ot.CATKEVerticalDiffusivity(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30),
        boundary_conditions={"b": ot.FieldBoundaryConditions(
            top=ot.FluxBC(1e-8))},
        fused_kernels=fused)


def baroclinic_adjustment_initial_state(model):
    """The example's front: b = N² z + 0.01 tanh((φ − 40°)/2°) with N² =
    1e-5, e = 1e-6."""
    return model.initial_state(
        b=lambda lam, phi, z: 1e-5 * z + 0.01 * torch.tanh(
            (phi - 40.0) / 2.0), e=1e-6)


def ridge_bottom():
    """A Gaussian ridge in partial cells under ``hydro_vi``: a
    ``PartialCellBottom`` rising from 4 km to 1 km at mid-basin (x = 2e7
    m, e-folding width 2e6 m)."""
    import oceananigans_torch as ot
    return ot.PartialCellBottom(lambda x, y: -4000.0 + 3000.0 * torch.exp(
        -((x - 2e7) / 2e6) ** 2) + 0.0 * y)


#: phase 18's seamount: ``examples/flow_over_seamount.py`` in 3-D, Δt
SEAMOUNT_DT = 0.02


def seamount_model(size=(256, 256, 128), dtype=torch.float32,
                   device="cuda", advection=None):
    """``examples/flow_over_seamount.py`` in 3-D at ``size``: a
    ``NonhydrostaticModel`` on an ``ImmersedBoundaryGrid`` over a (20, 20,
    2) box, (Periodic, Periodic, Bounded), halo 3, with the bottom
    -2 + exp(-(x² + y²)/2); WENO(5) (or ``advection``), ``BuoyancyTracer``,
    quasi-AB2."""
    import oceananigans_torch as ot
    grid = ot.RectilinearGrid(
        size=size, x=(-10.0, 10.0), y=(-10.0, 10.0), z=(-2.0, 0.0),
        topology=(ot.Periodic, ot.Periodic, ot.Bounded), halo=(3, 3, 3),
        dtype=dtype, device=device)
    grid = ot.ImmersedBoundaryGrid(grid, ot.GridFittedBottom(
        lambda x, y: -2.0 + torch.exp(-(x ** 2 + y ** 2) / 2.0)))
    return ot.NonhydrostaticModel(
        grid=grid, advection=advection or ot.WENO(5), tracers=("b",),
        buoyancy=ot.BuoyancyTracer(), timestepper="QuasiAdamsBashforth2")


def seamount_initial_state(model):
    """u = 0.1 and b = z (N² = 1), projected."""
    return model.initial_state(u=0.1, b=lambda x, y, z: z + 0.0 * x)


def volume_drift(model, eta0, eta):
    """|Σ η Az − Σ η₀ Az| over the interior (of every panel on the cubed
    sphere), relative to Σ |η| Az, in float64."""
    from oceananigans_torch.grids.base import Center
    g = getattr(model.grid, "panel_grid", model.grid)
    xy = (..., *g.interior_slices[:2], slice(None))
    Az = torch.broadcast_to(g.Az(Center, Center), eta.shape)[xy].double()
    a, b = eta[xy].double(), eta0[xy].double()
    return float((torch.sum(a * Az) - torch.sum(b * Az)).abs()
                 / torch.sum(a.abs() * Az))


#: the cubed sphere's Williamson 2 (the JAX package's regression setup):
#: radius, rotation rate and gravity; Δt at C192 is the example's C32 Δt of
#: 245 s scaled by 32/192
CS_W2_RADIUS, CS_W2_OMEGA, CS_W2_G = 6.37122e6, 7.292e-5, 9.80616
CS_W2_DT = 40.0
#: ``bench.py``'s cs_global ocean: depth and Δt
CS_GLOBAL_DEPTH, CS_GLOBAL_DT = 3000.0, 300.0


def cs_w2_model(N, dtype=torch.float32, device="cuda"):
    """Williamson 2 (steady geostrophic zonal flow, u₀ = 2πa/12 days) on
    the C``N`` cubed sphere, halo 3: ``(model, state)``."""
    import numpy as np

    from oceananigans_torch.grids.cubed_sphere_grid import (
        ConformalCubedSphereGrid,
    )
    from oceananigans_torch.models.cubed_sphere import (
        CubedSphereShallowWaterModel, panel_vector_components,
    )
    a, omega, g = CS_W2_RADIUS, CS_W2_OMEGA, CS_W2_G
    u0 = 2 * np.pi * a / (12.0 * 86400)
    h0 = 2.94e4 / g
    grid = ConformalCubedSphereGrid((N, 1), z=(-1.0, 0.0), radius=a,
                                    halo=3, dtype=dtype, device=device)
    model = CubedSphereShallowWaterModel(
        grid, gravitational_acceleration=g, rotation_rate=omega)
    u, v = panel_vector_components(
        grid, lambda P: np.cross(np.array([0.0, 0.0, u0 / a]), P * a))

    def h_init(lam, phi, z):
        s = np.sin(np.deg2rad(phi))
        return h0 - (a * omega * u0 + 0.5 * u0 ** 2) * s ** 2 / g + 0 * z

    return model, model.initial_state(u=u, v=v, h=grid.set_tracer(h_init))


def cs_continents(lam, phi):
    """``bench.py``'s cs_global bathymetry: two continents and polar caps
    (land at 50 m) in a 3 km ocean."""
    import numpy as np
    land = (np.abs(lam + 60.0) < 25.0) & (phi > -55.0) & (phi < 70.0)
    land |= (np.abs(lam - 45.0) < 50.0) & (phi > 0.0) & (phi < 70.0)
    land |= np.abs(phi) > 78.0
    return np.where(land, 50.0, -CS_GLOBAL_DEPTH)


def cs_global_model(N, Nz, dtype=torch.float32, device="cuda", **options):
    """``bench.py``'s cs_global configuration (``bench.py:66-116``) at
    C``N`` × ``Nz``: continents, ``SeawaterBuoyancy``, convective
    adjustment (κ 0.1 convective, 1e-5 background), a split-explicit free
    surface, a zonal wind stress and a surface heat flux, RK3; T = 5 + 20
    cos²φ e^(z/800), S = 35. ``options`` (``free_surface``,
    ``timestepper``, ``vertical_coordinate``) replace the model's
    keywords. ``(model, state)``."""
    import numpy as np

    import oceananigans_torch as ot
    grid = ot.ConformalCubedSphereGrid(
        (N, Nz), z=(-CS_GLOBAL_DEPTH, 0.0), radius=6.37122e6, halo=3,
        dtype=dtype, device=device)
    options.setdefault("free_surface",
                       ot.SplitExplicitFreeSurface(substeps=20))
    model = ot.CubedSphereHydrostaticModel(
        grid, bathymetry=cs_continents, buoyancy=ot.SeawaterBuoyancy(),
        closure=ot.ConvectiveAdjustmentVerticalDiffusivity(
            convective_kappa_z=0.1, background_kappa_z=1e-5),
        **options,
        boundary_conditions={
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(
                lambda lam, phi, t: -8e-5
                * torch.sin(torch.deg2rad(3 * phi)))),
            "T": ot.FieldBoundaryConditions(top=ot.FluxBC(
                lambda lam, phi, t: -2e-5
                * torch.cos(torch.deg2rad(2 * phi))))},
        tracers=())
    state = model.initial_state(
        T=lambda lam, phi, z: 5.0 + 20.0
        * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0), S=35.0)
    return model, state


def cs_global_implicit_model(N, Nz, dtype=torch.float32, device="cuda",
                             zstar=False, **cg):
    """:func:`cs_global_model` with the implicit free surface (one CG
    across the panels; ``cg``: its ``maxiter`` and ``reltol``, JAX's 200
    and 1e-9 by default) under RK3, or, with ``zstar``, its own
    split-explicit free surface under ``ZStar()`` and quasi-AB2.
    ``(model, state)``."""
    import oceananigans_torch as ot
    if zstar:
        return cs_global_model(N, Nz, dtype, device,
                               vertical_coordinate=ot.ZStar(),
                               timestepper="QuasiAdamsBashforth2")
    return cs_global_model(N, Nz, dtype, device,
                           free_surface=ot.ImplicitFreeSurface(
                               solver_method="cg", **cg))


#: ``bench.py``'s nonhydrostatic configurations: model keywords and x halo
CONFIGS = ("default", "science", "weno", "weno_mom")
#: ``bench.py``'s shallow-water configurations: N and the steps of one
#: measurement (see the module's docstring)
SW_CONFIGS = {"sw8192": (8192, 20), "sw16384": (16384, 4)}


def config_kwargs(name):
    """The model keywords and the grid halo of configuration ``name``."""
    import oceananigans_torch as ot
    if name == "default":
        return {}, (1, 0, 0)
    if name == "science":
        return dict(coriolis=ot.FPlane(f=1e-4), buoyancy=ot.BuoyancyTracer(),
                    tracers=("b", "c")), (1, 0, 0)
    if name == "weno":
        return dict(advection=ot.WENO(5), tracers=("T", "S")), (3, 0, 0)
    if name == "weno_mom":
        return dict(advection=ot.WENO(5)), (3, 0, 0)
    raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")


def initial_state(model):
    """``bench.py``'s initial velocities and tracers, projected."""
    tracer = (lambda x, y, z: 0.01 * z
              + 0.001 * torch.cos(2 * math.pi * y))
    return model.initial_state(
        u=lambda x, y, z: 0.01 * torch.sin(8 * math.pi * x)
        * torch.cos(6 * math.pi * y) * torch.cos(2 * math.pi * z),
        v=lambda x, y, z: 0.01 * torch.cos(4 * math.pi * x)
        * torch.sin(6 * math.pi * y),
        **{t: tracer for t in model.tracer_names})


def sw_model(N, fused="auto", dtype=torch.float32, device="cuda"):
    """``bench.py``'s shallow-water configuration at N²."""
    import oceananigans_torch as ot
    grid = ot.RectilinearGrid(size=(N, N), x=(0.0, 1e6), y=(0.0, 1e6),
                              topology=(ot.Periodic, ot.Periodic, ot.Flat),
                              halo=(8, 0, 0), dtype=dtype, device=device)
    return ot.ShallowWaterModel(grid=grid, gravitational_acceleration=9.81,
                                fused_kernels=fused)


def sw_initial_state(model):
    """``bench.py``'s initial height and x-transport."""
    return model.initial_state(
        h=lambda x, y, z: 1000.0 + torch.sin(2 * math.pi * x / 1e6)
        * torch.cos(2 * math.pi * y / 1e6),
        uh=lambda x, y, z: 100.0 * torch.cos(2 * math.pi * y / 1e6) + 0 * x)


def _events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _run(model, state, dt, n):
    for _ in range(n):
        state = model.step(state, dt, assume_filled=True)
    return state


def _step_ms(model, state, dt, n):
    """(ms per step by CUDA events over ``n`` steps, the new state)."""
    e0, e1 = _events(2)
    torch.cuda.synchronize()
    e0.record()
    state = _run(model, state, dt, n)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n, state


def _kernel_time_us(prof):
    """Total device time of the CUDA kernels a profile recorded, in µs."""
    rows = []
    for e in prof.key_averages():
        if getattr(e.device_type, "name", "") != "CUDA":
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((t, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def _alternated(models, states, dt, steps, reset=None):
    """Step times of each path by CUDA events in alternated runs (plain,
    kernel, kernel, plain) repeated three times, each from ``reset(path)``
    when it is given; prints them and the card's clocks after them."""
    readings = {k: [] for k in models}
    for _ in range(3):
        for k in ("plain", "kernel", "kernel", "plain"):
            if reset is not None:
                states[k] = reset(k)
            ms, states[k] = _step_ms(models[k], states[k], dt, steps)
            readings[k].append(ms)
    for k, r in readings.items():
        print(f"[step] {k} path ms/step over {steps} steps, "
              f"{len(r)} alternated runs: {r}; mean {sum(r) / len(r)}",
              flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()
    print(f"[clock] after the step runs: sm clock, max sm clock, power, "
          f"temperature: {clocks}", flush=True)


def _states_equal(a, b, fields):
    for q in fields:
        if not torch.equal(getattr(a, q), getattr(b, q)):
            raise RuntimeError(f"phased step differs from step in {q}")
    for group in ("tracers", "Gtracers"):
        for q, t in getattr(a, group).items():
            if not torch.equal(t, getattr(b, group)[q]):
                raise RuntimeError(
                    f"phased step differs from step in {group}/{q}")


def _profile_path(k, model, state, dt, phased, phases, fields, trace_dir,
                  steps=(20, 20, 10), reset=None):
    """Host enqueue time, time per phase and the profiler's kernel time and
    idle share of one path, over ``steps`` steps each, each from
    ``reset()`` when it is given; returns the state it leaves."""
    # 2. host enqueue time
    n = steps[0]
    state = reset() if reset is not None else state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = _run(model, state, dt, n)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[host] {k} path: enqueue {(t1 - t0) * 1e3 / n} ms/step, "
          f"until done {(t2 - t0) * 1e3 / n} ms/step", flush=True)

    # 3. phases, after checking the phased step against model.step (step
    # writes halos and tendencies in place, so each gets a copy)
    state = reset() if reset is not None else state
    ref = model.step(copy.deepcopy(state), dt, assume_filled=True)
    got = phased(model, copy.deepcopy(state), dt, lambda: None)
    _states_equal(ref, got, fields)
    del ref, got
    n = steps[1]
    ev = _events(1 + n * len(phases))
    marks = iter(ev[1:])
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(n):
        state = phased(model, state, dt, lambda: next(marks).record())
    ev[-1].synchronize()
    per = [0.0] * len(phases)
    for i in range(n * len(phases)):
        per[i % len(phases)] += ev[i].elapsed_time(ev[i + 1]) / n
    print(f"[phase] {k} path, ms/step over {n} steps: " + "; ".join(
        f"{name} {t}" for name, t in zip(phases, per))
        + f"; sum {sum(per)}", flush=True)

    # 4. profiler: kernel time and idle share
    from torch.profiler import ProfilerActivity, profile
    n = steps[2]
    state = reset() if reset is not None else state
    e0, e1 = _events(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        state = _run(model, state, dt, n)
        e1.record()
        e1.synchronize()
    wall = e0.elapsed_time(e1) / n
    total_us, rows = _kernel_time_us(prof)
    busy = total_us / 1e3 / n
    print(f"[profile] {k} path, {n} steps: kernel time {busy} ms/step, "
          f"wall {wall} ms/step, idle share {1 - busy / wall}", flush=True)
    for t, count, key in rows[:12]:
        print(f"[profile]   {t / 1e3 / n} ms/step  {count / n}/step  "
              f"{key[:100]}", flush=True)
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"trace_{k}.json"))
    return state


def _shallow_water(name, trace_dir):
    (N, steps), dt = SW_CONFIGS[name], 1.0
    print(f"configuration {name}: ShallowWaterModel at {N}^2, "
          f"Centered(2), halo (8, 0, 0); every measurement starts from the "
          f"initial state after 2 warm-up steps and runs {steps} steps",
          flush=True)
    models = {k: sw_model(N, fused) for k, fused in (("kernel", "auto"),
                                                    ("plain", False))}
    if not models["kernel"].fused_rk3 or models["plain"].fused_rk3:
        raise RuntimeError("the kernel path must take the stage kernel and "
                           "the plain path must not")

    def reset(k):
        m = models[k]
        return _run(m, sw_initial_state(m), dt, 2)

    states = {}
    _alternated(models, states, dt, steps, reset)
    for k, model in models.items():
        states[k] = _profile_path(
            k, model, None, dt, phased_sw_step, SW_PHASES,
            ("uh", "vh", "h", "Guh", "Gvh", "Gh"), trace_dir,
            steps=(steps, steps, min(steps, 10)),
            reset=lambda: reset(k))
        del states[k]
        torch.cuda.empty_cache()


def _hydrostatic(trace_dir):
    dt, steps = HYDRO_DT, HYDRO_STEPS
    models = {k: hydro_model(fused) for k, fused in (("kernel", "auto"),
                                                    ("plain", False))}
    mk = models["kernel"]
    print(f"configuration {HYDRO_CONFIG}: HydrostaticFreeSurfaceModel at "
          f"{mk.grid.N}, halo {mk.grid.H}, WENOVectorInvariant(), WENO(7) "
          f"tracers T and S, {mk.free_surface!r}, dt {dt}; kernel path "
          f"fused_kernels={mk.fused_kernels}, "
          f"fused_tracer={mk.fused_tracer}", flush=True)
    if not (mk.fused_kernels and mk.fused_tracer) or \
            models["plain"].fused_kernels or models["plain"].fused_tracer:
        raise RuntimeError("the kernel path must take both kernels and the "
                           "plain path neither")
    states = {}
    for k, m in models.items():
        s = m.update_state(hydro_initial_state(m))
        states[k] = _run(m, s, dt, 5)
    _alternated(models, states, dt, steps)
    fields = ("u", "v", "w", "eta", "Gu", "Gv", "Geta", "U", "V")
    for k, model in models.items():
        states[k] = _profile_path(k, model, states[k], dt, phased_hydro_step,
                                  HYDRO_PHASES, fields, trace_dir)
        del states[k]
        torch.cuda.empty_cache()


def _physics(name, trace_dir):
    """The ``langmuir`` or ``hydro_catke`` configuration: alternated step
    times of both paths, then each path's kernel time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    if name == "langmuir":
        dt, steps = LANGMUIR_DT, LANGMUIR_STEPS
        models = {k: langmuir_model(
            fused=fused, particles=langmuir_particles(2 ** 20))
            for k, fused in (("kernel", "auto"), ("plain", False))}
        init = langmuir_initial_state
        ok = models["kernel"].fused_kernels == "weno5"
    else:
        dt, steps = HYDRO_CATKE_DT, HYDRO_CATKE_STEPS
        models = {k: hydro_catke_model(fused) for k, fused in (
            ("kernel", "auto"), ("plain", False))}

        def init(m):
            return m.update_state(hydro_latlon_initial_state(m))
        ok = models["kernel"].fused_kernels and models["kernel"].fused_tracer
    if not ok:
        raise RuntimeError(f"{name}: the kernel path must take its kernels")
    print(f"configuration {name}: {models['kernel']!r}, dt {dt}", flush=True)
    states = {k: _run(m, init(m), dt, 2) for k, m in models.items()}
    _alternated(models, states, dt, steps)
    for k, model in models.items():
        e0, e1 = _events(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e0.record()
            states[k] = _run(model, states[k], dt, 5)
            e1.record()
            e1.synchronize()
        wall = e0.elapsed_time(e1) / 5
        busy = _kernel_time_us(prof)[0] / 1e3 / 5
        print(f"[profile] {k} path, 5 steps: kernel time {busy} ms/step, "
              f"wall {wall} ms/step, idle share {1 - busy / wall}",
              flush=True)
        if trace_dir is not None:
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_dir / f"trace_{name}_{k}.json"))


#: the physics slice's configurations
PHYSICS_CONFIGS = ("langmuir", "hydro_catke")
#: the configurations of the implicit free surface, split RK3, the
#: limiters and z-star: Δt and the steps of one measurement
OPTION_CONFIGS = {"hydro_implicit": (HYDRO_DT, 20),
                  "hydro_split_rk3": (HYDRO_DT, 20),
                  "hydro_zstar": (HYDRO_DT, 10),
                  "cs_global_implicit": (CS_GLOBAL_DT, 10)}


def _options(name, trace_dir):
    """One of :data:`OPTION_CONFIGS`: the alternated step times of both
    paths where the configuration has a kernel path (``hydro_implicit``,
    ``hydro_split_rk3``), else three runs of the plain path, then each
    path's kernel time, launches and idle share under ``torch.profiler``
    and, for the implicit solves, the CG iterations and host syncs of the
    last solve."""
    from torch.profiler import ProfilerActivity, profile
    dt, steps = OPTION_CONFIGS[name]
    if name in ("hydro_implicit", "hydro_split_rk3"):
        make, init = ((hydro_implicit_model, hydro_initial_state)
                      if name == "hydro_implicit" else
                      (hydro_split_rk3_model, hydro_split_rk3_initial_state))
        models = {k: make(fused) for k, fused in (("kernel", "auto"),
                                                  ("plain", False))}
        mk = models["kernel"]
        if not (mk.fused_kernels and (mk.fused_tracer
                                      or name == "hydro_split_rk3")):
            raise RuntimeError(f"{name}: the kernel path must take its "
                               "kernels")
        states = {k: _run(m, m.update_state(init(m)), dt, 2)
                  for k, m in models.items()}
    elif name == "hydro_zstar":
        m = hydro_zstar_model()
        models = {"plain": m}
        states = {"plain": _run(m, m.update_state(
            hydro_latlon_initial_state(m, c=1.0)), dt, 2)}
    else:
        m, s = cs_global_implicit_model(48, 16)
        models = {"plain": m}
        states = {"plain": _run(m, s, dt, 2)}
    print(f"configuration {name}: {next(iter(models.values()))!r}, dt {dt}",
          flush=True)
    if len(models) == 2:
        _alternated(models, states, dt, steps)
    else:
        runs = []
        for _ in range(3):
            ms, states["plain"] = _step_ms(models["plain"], states["plain"],
                                           dt, steps)
            runs.append(ms)
        print(f"[step] plain path ms/step over {steps} steps, 3 runs: "
              f"{runs}; mean {sum(runs) / 3}", flush=True)
    for k, model in models.items():
        e0, e1 = _events(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e0.record()
            states[k] = _run(model, states[k], dt, 3)
            e1.record()
            e1.synchronize()
        wall = e0.elapsed_time(e1) / 3
        busy_us, rows = _kernel_time_us(prof)
        busy = busy_us / 1e3 / 3
        info = getattr(model, "free_surface_info", {})
        cg = (f"; last CG solve {int(info['iterations'])} iterations, "
              f"{info['host_syncs']} host syncs" if info else "")
        print(f"[profile] {k} path, 3 steps: kernel time {busy} ms/step, "
              f"{sum(r[1] for r in rows) / 3} launches/step, wall {wall} "
              f"ms/step, idle share {1 - busy / wall}{cg}", flush=True)
        if trace_dir is not None:
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_dir / f"trace_{name}_{k}.json"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config",
                        choices=CONFIGS + tuple(SW_CONFIGS) + (HYDRO_CONFIG,)
                        + PHYSICS_CONFIGS + tuple(OPTION_CONFIGS),
                        default="default")
    parser.add_argument("--trace-dir", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import oceananigans_torch as ot
    from oceananigans_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _build.load()
    if args.config in SW_CONFIGS:
        _shallow_water(args.config, args.trace_dir)
        return
    if args.config == HYDRO_CONFIG:
        _hydrostatic(args.trace_dir)
        return
    if args.config in PHYSICS_CONFIGS:
        _physics(args.config, args.trace_dir)
        return
    if args.config in OPTION_CONFIGS:
        _options(args.config, args.trace_dir)
        return

    N, dt, steps = 256, 1e-4, 100
    kwargs, halo = config_kwargs(args.config)
    print(f"configuration {args.config}: {kwargs or 'Centered(2)'}, halo "
          f"{halo}", flush=True)
    grid = ot.RectilinearGrid(
        size=(N, N, N), extent=(1.0, 1.0, 1.0),
        topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
        dtype=torch.float32, device="cuda")

    def model_of(fused="auto", timestepper="QuasiAdamsBashforth2"):
        return ot.NonhydrostaticModel(grid=grid, timestepper=timestepper,
                                      fused_kernels=fused, **kwargs)

    def init(model):
        state = initial_state(model)
        return _run(model, model.fill_state_halos(state), dt, 5)

    models = {"kernel": model_of("auto"), "plain": model_of(False)}
    states = {k: init(m) for k, m in models.items()}

    # 1. alternated step times
    _alternated(models, states, dt, steps)
    for k, model in models.items():
        states[k] = _profile_path(
            k, model, states[k], dt, phased_ab2_step, PHASES,
            ("u", "v", "w", "pressure", "Gu", "Gv", "Gw"), args.trace_dir)
    del models, states
    torch.cuda.empty_cache()

    # 5. other step times, one run each
    variants = {"RK3 kernel path": model_of("auto", "RungeKutta3"),
                "RK3 plain path": model_of(False, "RungeKutta3")}
    corr = model_of()
    corr.fused_correction = True
    variants["AB2 fused correction"] = corr
    mm = model_of()
    mm.pressure_solver = ot.MatmulPoissonSolver(grid)
    variants["AB2 matmul solver"] = mm
    both = model_of()
    both.fused_correction = True
    both.pressure_solver = ot.MatmulPoissonSolver(grid, fused=True)
    variants["AB2 fused correction + fused matmul solver"] = both
    for name, model in variants.items():
        ms, _ = _step_ms(model, init(model), dt, 20)
        print(f"[variant] {name}: {ms} ms/step over 20 steps", flush=True)


if __name__ == "__main__":
    main()
