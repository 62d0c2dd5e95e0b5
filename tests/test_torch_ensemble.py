"""oceananigans_torch's ``EnsembleModel`` on the models the JAX
``EnsembleModel`` batches, the kernels' custom operators under
``torch.func.vmap``, and the differentiable step; on the CPU in float64.

- The ensemble matrix: 3 members from seeded states, 2–3 steps, each
  member bit for bit its own serial run. The exceptions are named where
  they are checked (:data:`ROUNDED`): a batched FFT rounds otherwise than
  the serial one, so the fields it reaches are held to 1e-14 of their
  largest value.
- The conjugate-gradient and immersed cases (the implicit free surface's
  "cg" and "matrix" methods, an immersed hydrostatic model, an immersed
  nonhydrostatic model) are also held to the JAX ``EnsembleModel`` at
  1e-12; CG at a fixed iteration count (``maxiter=k, reltol=0.0``), as
  the parity tests hold it.
- The kernel-path cases run once more with every wrapper taking its
  custom operator (``ops/library.py``) as on the card; its CPU
  implementation is the plain version, so the operators' batching rules
  run inside whole model steps.
- Each operator under ``vmap`` over 2 members equals two unbatched calls
  bit for bit, the G that the AB2 operators write in place included, and
  a backward through an operator raises.
- ``tests/test_hydrostatic.py::test_step_is_differentiable`` in the port:
  the ``torch.autograd`` gradient equals ``jax.grad``'s.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.ensemble import member_values
from oceananigans_torch.interop import (
    CLOCK, FIELDS, HYDROSTATIC_FIELDS, flatten_state, state_from_numpy,
)
from oceananigans_torch.ops import (
    cuda_generic, cuda_kernels, cuda_poisson, cuda_sw, cuda_tracer, cuda_vi,
    cuda_weno,
)
from oceananigans_tpu.ensemble import EnsembleModel as JEnsemble
from oceananigans_tpu.models import hydrostatic as j_hyd

from test_torch_closure_models import assert_close, jax_arrays

F64 = torch.float64
N_MEMBERS = 3
KERNEL_MODULES = ("cuda_kernels", "cuda_weno", "cuda_sw", "cuda_tracer",
                  "cuda_vi", "cuda_generic", "cuda_poisson")


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


@pytest.fixture
def operator_route(monkeypatch):
    """Every kernel wrapper takes its custom operator, as on the card."""
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"oceananigans_torch.ops.{name}")
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

def rect(pkg, size=(12, 10, 4), topology="PPB", halo=3, **kw):
    T = {"P": pkg.Periodic, "B": pkg.Bounded, "F": pkg.Flat}
    kw.setdefault("x", (0.0, 1.0))
    kw.setdefault("y", (0.0, 1.0))
    kw.setdefault("z", (-1.0, 0.0))
    return pkg.RectilinearGrid(
        size=size, topology=tuple(T[t] for t in topology), halo=halo,
        dtype="float64" if pkg is oj else F64, **kw)


def hydrostatic(pkg, free_surface, grid=None, **kw):
    grid = grid or rect(pkg, topology="PBB", x=(0.0, 1e5), y=(0.0, 5e4),
                        z=(-100.0, 0.0))
    return pkg.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=free_surface, tracers=("T",),
        tracer_advection=pkg.WENO(5),
        buoyancy=pkg.SeawaterBuoyancy(
            equation_of_state=pkg.LinearEquationOfState(),
            constant_salinity=35.0),
        coriolis=pkg.FPlane(f=1e-4), **kw)


def fs_module(pkg):
    return j_hyd if pkg is oj else ot


def seamount(pkg):
    """Phase 18's seamount at (12, 10, 4), WENO(5), immersed CG."""
    xp = jnp if pkg is oj else torch
    g = rect(pkg, x=(-10.0, 10.0), y=(-10.0, 10.0), z=(-2.0, 0.0))
    ib = pkg.ImmersedBoundaryGrid(g, pkg.GridFittedBottom(
        lambda x, y: -2.0 + xp.exp(-(x ** 2 + y ** 2) / 8.0)))
    return pkg.NonhydrostaticModel(
        grid=ib, advection=pkg.WENO(5), tracers=("b",),
        buoyancy=pkg.BuoyancyTracer(), timestepper="QuasiAdamsBashforth2")


def ridge_channel(pkg):
    xp = jnp if pkg is oj else torch
    g = rect(pkg, topology="PBB", x=(0.0, 1e5), y=(0.0, 5e4),
             z=(-100.0, 0.0))
    ib = pkg.ImmersedBoundaryGrid(g, pkg.GridFittedBottom(
        lambda x, y: -100.0 + 40.0 * xp.exp(-(x - 5e4) ** 2 / 4e8) + 0 * y))
    return hydrostatic(pkg, fs_module(pkg).ImplicitFreeSurface(
        solver_method="cg", maxiter=12, reltol=0.0), grid=ib)


def stretched(pkg):
    zf = [-1.0, -0.6, -0.35, -0.15, 0.0]
    g = pkg.RectilinearGrid(
        size=(12, 10, 4), x=(0.0, 1.0), y=(0.0, 1.0),
        z=np.array(zf) if pkg is oj else torch.tensor(zf, dtype=F64),
        topology=(pkg.Periodic, pkg.Periodic, pkg.Bounded), halo=3,
        dtype="float64" if pkg is oj else F64)
    return pkg.NonhydrostaticModel(
        grid=g, advection=pkg.Centered(2), tracers=("b",),
        buoyancy=pkg.BuoyancyTracer(), timestepper="QuasiAdamsBashforth2")


def catke_column(pkg):
    g = pkg.RectilinearGrid(size=(8,), z=(-100.0, 0.0),
                            topology=(pkg.Flat, pkg.Flat, pkg.Bounded),
                            halo=3, dtype=F64)
    return pkg.HydrostaticFreeSurfaceModel(
        grid=g, tracers=("T", "S"), buoyancy=pkg.SeawaterBuoyancy(),
        closure=pkg.CATKEVerticalDiffusivity(), coriolis=pkg.FPlane(f=1e-4),
        boundary_conditions={
            "u": pkg.FieldBoundaryConditions(top=pkg.FluxBC(-1e-4)),
            "T": pkg.FieldBoundaryConditions(top=pkg.FluxBC(2e-5))})


def hydro_vi(pkg):
    """``hydro_vi`` at (12, 10, 4): WENO vector invariant, WENO(7) T and S,
    the split-explicit free surface, quasi-AB2; kernels 11 and 12/13."""
    g = pkg.RectilinearGrid(size=(12, 10, 4), extent=(4e7, 2e7, 4e3),
                            topology=(pkg.Periodic, pkg.Bounded, pkg.Bounded),
                            halo=(6, 6, 4), dtype=F64)
    return pkg.HydrostaticFreeSurfaceModel(
        grid=g, momentum_advection=pkg.WENOVectorInvariant(),
        tracer_advection=pkg.WENO(7), tracers=("T", "S"),
        free_surface=pkg.SplitExplicitFreeSurface(substeps=6),
        timestepper="quasi_ab2", fused_kernels=True)


def kernel_path(pkg, halo, **kw):
    """``bench.py``'s nonhydrostatic layouts at (12, 10, 4): periodic, an
    x halo only, the fused kernels' code paths."""
    return pkg.NonhydrostaticModel(
        grid=rect(pkg, topology="PPP", halo=halo), fused_kernels=True, **kw)


def opt_in(pkg):
    """Phase 6's opt-in path: the fused pressure correction (row 3) and
    the matmul Poisson solver's fused middle stage (row 4)."""
    model = kernel_path(pkg, (1, 0, 0), timestepper="QuasiAdamsBashforth2")
    model.fused_correction = True
    model.pressure_solver = pkg.MatmulPoissonSolver(model.grid, fused=True)
    return model


def shallow_water(pkg):
    g = pkg.RectilinearGrid(size=(12, 10), x=(0.0, 1e6), y=(0.0, 1e6),
                            topology=(pkg.Periodic, pkg.Periodic, pkg.Flat),
                            halo=(3, 3, 0), dtype=F64)
    return pkg.ShallowWaterModel(grid=g, gravitational_acceleration=9.81,
                                 fused_kernels=True)


def cube(kind):
    """A cube model at C8 and its member states."""
    if kind == "shallow_water":
        from oceananigans_torch.profile_step import cs_w2_model
        model, s0 = cs_w2_model(8, F64, "cpu")
        return model, [dataclasses.replace(s0, h=s0.h * (1.0 + 1e-3 * m))
                       for m in range(N_MEMBERS)]
    grid = ot.ConformalCubedSphereGrid((8, 3), z=(-1000.0, 0.0),
                                       radius=6.37122e6, halo=3, dtype=F64)
    kw = {"split_rk3": dict(
        free_surface=ot.SplitExplicitFreeSurface(substeps=8)),
        "implicit_cg": dict(
            free_surface=ot.ImplicitFreeSurface(solver_method="cg")),
        "zstar": dict(vertical_coordinate=ot.ZStar(),
                      timestepper="QuasiAdamsBashforth2")}.get(kind, {})
    model = ot.CubedSphereHydrostaticModel(grid, **kw)
    return model, member_states(model, cube_fields)


def noise(m, shape, seed):
    """Member ``m``'s seeded field: its amplitude grows with m."""
    rng = np.random.default_rng(seed)
    return (1.0 + 0.25 * m) * rng.standard_normal(shape)


def nonhydrostatic_fields(model, m, xp):
    """A Taylor-Green flow of member amplitude over the cells' indices,
    with seeded noise of a tenth of it; seeded tracers."""
    N = tuple(model.grid.N)
    x, y, _ = np.meshgrid(*((np.arange(n) + 0.5) / n for n in N),
                          indexing="ij")
    amp = 1.0 + 0.25 * m
    kw = dict(
        u=amp * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
        + 0.1 * noise(m, N, 1),
        v=-amp * np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y)
        + 0.1 * noise(m, N, 2),
        w=0.1 * noise(m, N, 3))
    for i, n in enumerate(model.tracer_names):
        kw[n] = noise(m, N, 10 + i)
    return kw


def hydrostatic_fields(model, m, xp):
    N = tuple(model.grid.N)
    Lx = 4e7 if N[0] == 12 and model.grid.Lx > 1e6 else 1e5
    amp = 0.1 * (1.0 + 0.25 * m)
    kw = dict(u=0.01 * noise(m, N, 1), v=0.01 * noise(m, N, 2),
              eta=lambda x, y: amp * xp.sin(2 * np.pi * x / Lx) + 0 * y)
    for i, n in enumerate(model.tracer_names):
        if n != "e":
            kw[n] = (15.0 if n == "T" else 35.0) + 0.01 * noise(m, N, 10 + i)
    return kw


def column_fields(model, m, xp):
    N = tuple(model.grid.N)
    return dict(T=lambda x, y, z: 15.0 + (0.01 + 0.002 * m) * z,
                S=35.0 + 0.01 * noise(m, N, 4), u=0.01 * noise(m, N, 5))


def sw_fields(model, m, xp):
    amp = 1.0 + 0.25 * m
    return dict(h=lambda x, y, z: 1000.0 + amp * xp.sin(2 * np.pi * x / 1e6)
                * xp.cos(2 * np.pi * y / 1e6),
                uh=lambda x, y, z: 100.0 * amp * xp.cos(2 * np.pi * y / 1e6)
                + 0 * x)


def cube_fields(model, m, xp):
    amp = 1.0 + 0.25 * m
    return dict(b=lambda lam, phi, z: 1e-5 * z + amp * 1e-4 * np.cos(
        np.deg2rad(lam)) * np.cos(np.deg2rad(phi)))


#: case: (the function that builds a package's model, its member fields,
#: Δt, steps)
CASES = {
    "nonhydrostatic_centered2_ab2": (
        lambda p: kernel_path(p, (1, 0, 0),
                              timestepper="QuasiAdamsBashforth2"),
        nonhydrostatic_fields, 1e-2, 3),
    "nonhydrostatic_science_ab2": (
        lambda p: kernel_path(p, (1, 0, 0), coriolis=p.FPlane(f=1e-4),
                              buoyancy=p.BuoyancyTracer(),
                              tracers=("b", "c"),
                              timestepper="QuasiAdamsBashforth2"),
        nonhydrostatic_fields, 1e-2, 3),
    "nonhydrostatic_weno5_rk3": (
        lambda p: kernel_path(p, (3, 0, 0), advection=p.WENO(5),
                              tracers=("T", "S")),
        nonhydrostatic_fields, 1e-2, 2),
    "nonhydrostatic_weno5_ab2": (
        lambda p: kernel_path(p, (3, 0, 0), advection=p.WENO(5),
                              timestepper="QuasiAdamsBashforth2"),
        nonhydrostatic_fields, 1e-2, 3),
    "nonhydrostatic_opt_in": (opt_in, nonhydrostatic_fields, 1e-2, 3),
    "nonhydrostatic_immersed_cg": (seamount, nonhydrostatic_fields, 0.02, 2),
    "nonhydrostatic_stretched_z": (stretched, nonhydrostatic_fields, 1e-2,
                                   3),
    "hydrostatic_explicit": (
        lambda p: hydrostatic(p, p.ExplicitFreeSurface()),
        hydrostatic_fields, 10.0, 3),
    "hydrostatic_split_explicit": (hydro_vi, hydrostatic_fields, 600.0, 3),
    "hydrostatic_implicit_fft": (
        lambda p: hydrostatic(p, fs_module(p).ImplicitFreeSurface()),
        hydrostatic_fields, 100.0, 3),
    "hydrostatic_implicit_cg": (
        lambda p: hydrostatic(p, fs_module(p).ImplicitFreeSurface(
            solver_method="cg", maxiter=12, reltol=0.0)),
        hydrostatic_fields, 100.0, 3),
    "hydrostatic_implicit_matrix": (
        lambda p: hydrostatic(p, fs_module(p).ImplicitFreeSurface(
            solver_method="matrix", maxiter=12, reltol=0.0)),
        hydrostatic_fields, 100.0, 3),
    "hydrostatic_immersed_implicit": (ridge_channel, hydrostatic_fields,
                                      100.0, 3),
    "catke_column": (catke_column, column_fields, 60.0, 3),
    "shallow_water": (shallow_water, sw_fields, 20.0, 3),
}
#: the cube models the JAX ``EnsembleModel`` steps
CUBE_CASES = {"cube_shallow_water": ("shallow_water", 600.0),
              "cube_explicit_rk3": ("explicit_rk3", 300.0),
              "cube_split_rk3": ("split_rk3", 300.0),
              "cube_implicit_cg": ("implicit_cg", 300.0),
              "cube_zstar_ab2": ("zstar", 300.0)}
#: the cases held to the JAX ``EnsembleModel`` too (they raised in the
#: port's before the conjugate gradient and the immersed solve batched)
JAX_CASES = ("nonhydrostatic_immersed_cg", "hydrostatic_implicit_cg",
             "hydrostatic_implicit_matrix", "hydrostatic_immersed_implicit")
#: the cases whose kernel paths run again through the custom operators
KERNEL_CASES = ("nonhydrostatic_centered2_ab2", "nonhydrostatic_science_ab2",
                "nonhydrostatic_weno5_rk3", "nonhydrostatic_weno5_ab2",
                "nonhydrostatic_opt_in",
                "hydrostatic_split_explicit", "shallow_water")
#: cases whose fields are held to 1e-14 of their largest value, not
#: bitwise, and the batched operation that rounds them otherwise: the
#: pressure solve's FFT over the three axes of a halo-free periodic layout
#: (a batch of members is transformed with other vector lengths than one
#: member; ~1 ulp of the velocities, which the next steps carry into every
#: field)
ROUNDED = {case: "the batched FFT of the pressure solve"
           for case in ("nonhydrostatic_centered2_ab2",
                        "nonhydrostatic_science_ab2",
                        "nonhydrostatic_weno5_rk3",
                        "nonhydrostatic_weno5_ab2")}


def fields_of(state):
    return {k: v for k, v in flatten_state(state).items()
            if k not in CLOCK and torch.is_tensor(v) and v.is_floating_point()}


def assert_member_is_serial(case, member, serial):
    """Bit for bit, or 1e-14 of the largest value for :data:`ROUNDED`."""
    got, ref = fields_of(member), fields_of(serial)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if case in ROUNDED:
            err = (got[k] - r).abs().max().item()
            assert err <= 1e-14 * r.abs().max().item(), (k, ROUNDED[case],
                                                          err)
        else:
            assert torch.equal(got[k], r), k
    assert member.clock.iteration == serial.clock.iteration
    assert member.clock.time == serial.clock.time


def run_ensemble(model, states, dt, steps):
    ens = ot.EnsembleModel(model, n=len(states))
    S = ens.stack(states)
    for _ in range(steps):
        S = ens.step(S, dt)
    return ens, S


def member_states(model, fields, pkg=ot):
    xp = jnp if pkg is oj else torch
    return [model.initial_state(**fields(model, m, xp))
            for m in range(N_MEMBERS)]


def check_case(case):
    build, fields, dt, steps = CASES[case]
    model = build(ot)
    states = member_states(model, fields)
    ens, S = run_ensemble(model, states, dt, steps)
    assert S.clock.iteration == steps
    for m, s in enumerate(states):
        for _ in range(steps):
            s = model.step(s, dt)
        assert_member_is_serial(case, ens.member(S, m), s)
    return model, ens, S


@pytest.mark.parametrize("case", list(CASES))
def test_members_equal_serial_runs(case):
    model, _, _ = check_case(case)
    if case in KERNEL_CASES:
        assert getattr(model, "fused_rk3", None) or model.fused_kernels


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_members_equal_serial_runs_through_operators(case, operator_route):
    """The kernel paths through the custom operators' batching rules, one
    call of the plain version per member."""
    check_case(case)


@pytest.mark.parametrize("case", list(CUBE_CASES))
def test_cube_members_equal_serial_runs(case):
    kind, dt = CUBE_CASES[case]
    model, states = cube(kind)
    ens, S = run_ensemble(model, states, dt, 2)
    for m, s in enumerate(states):
        for _ in range(2):
            s = model.step(s, dt)
        assert_member_is_serial(case, ens.member(S, m), s)


def jax_member_states(jm, tm, fields):
    keys = (HYDROSTATIC_FIELDS if isinstance(tm, ot.HydrostaticFreeSurfaceModel)
            else FIELDS)
    js = member_states(jm, fields, oj)
    ts = [state_from_numpy(tm, jax_arrays(s, keys, tm.tracer_names))
          for s in js]
    return js, ts, keys


@pytest.mark.parametrize("case", JAX_CASES)
def test_cg_and_immersed_ensembles_match_jax(case):
    """The port's ensemble within 1e-12 of the JAX ensemble's largest
    value, member by member (its serial runs:
    :func:`test_members_equal_serial_runs`); the implicit free surface's
    per-member iteration counts are the fixed count, the seamount's CG at
    the solver's defaults."""
    build, fields, dt, steps = CASES[case]
    jm, tm = build(oj), build(ot)
    js, ts, keys = jax_member_states(jm, tm, fields)
    jens = JEnsemble(jm, n=N_MEMBERS)
    JS = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *js)
    ens, S = run_ensemble(tm, ts, dt, steps)
    if isinstance(tm, ot.HydrostaticFreeSurfaceModel):
        its = member_values(tm.free_surface_info["iterations"])
        assert its.tolist() == [12] * N_MEMBERS
    else:
        its = member_values(tm.pressure_solver.iterations)
        assert its.shape == (N_MEMBERS,) and (its > 0).all()
    for _ in range(steps):
        JS = jens.step(JS, dt)
    names = tm.tracer_names
    for m in range(N_MEMBERS):
        member = ens.member(S, m)
        assert_close(tm.grid, member, jax_arrays(jens.member(JS, m), keys,
                                                 names), keys, names)


def test_ensemble_raises_where_jax_raises():
    """A member callable of (member, x, y, z) for the 2-D η: the same
    exception type in both packages."""
    for pkg in (oj, ot):
        ens = (JEnsemble if pkg is oj else ot.EnsembleModel)(
            hydrostatic(pkg, pkg.ExplicitFreeSurface()), n=2)
        with pytest.raises(TypeError):
            ens.initial_states(eta=lambda m, x, y, z: 0 * x)


# ---------------------------------------------------------------------------
# The operators' batching rules
# ---------------------------------------------------------------------------

def seeded(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)) for _ in range(n)]


def grid_of(halo, size=(8, 6, 5), topology="PPP"):
    return rect(ot, size=size, topology=topology, halo=halo)


def c2_grid():
    return grid_of((1, 0, 0))


def weno_grid():
    return grid_of((3, 0, 0))


def march_grid():
    return rect(ot, size=(12, 10, 6), topology="PBB", halo=(6, 6, 4),
                x=(0.0, 4e7), y=(0.0, 2e7), z=(-4e3, 0.0))


def sw_grid():
    return ot.RectilinearGrid(size=(10, 7), x=(0.0, 1e6), y=(0.0, 1e6),
                              topology=(ot.Periodic, ot.Periodic, ot.Flat),
                              halo=(3, 3, 0), dtype=F64)


def middle_operands(m):
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    return ((t(2, 6, 5, 4)[m],), (t(5, 5), t(4, 4), t(6),
                                  torch.from_numpy(rng.random(5)),
                                  torch.from_numpy(rng.random(4))))


def tracers2(ts):
    return dict(zip(("b", "c"), ts))


#: operator: (grid, number of batched fields, number of G⁻ written in
#: place, call(grid, fields, state) -> outputs)
OPERATORS = {
    "c2_ab2": (c2_grid, 3, 3, lambda g, f, s: cuda_kernels
               .centered2_ab2_update_op(g, *f, *s, 0.7, -0.2)[:3]),
    "c2_tendency": (c2_grid, 3, 0, lambda g, f, s: cuda_kernels
                    .centered2_momentum_tendency_op(g, *f)),
    "pressure_correction": (c2_grid, 4, 0, lambda g, f, s: cuda_kernels
                            .pressure_correction_op(g, *f, 0.3)),
    "c2_science_ab2": (c2_grid, 5, 5, lambda g, f, s: cuda_kernels
                       .centered2_science_ab2_update_op(
                           g, *f[:3], tracers2(f[3:]), *s[:3],
                           tracers2(s[3:]), 0.7, -0.2, 1e-4, "b")[:4]),
    "weno5_ab2": (weno_grid, 3, 3, lambda g, f, s: cuda_weno
                  .weno5_ab2_update_op(g, *f, *s, 0.7, -0.2)[:3]),
    "weno5_tendency": (weno_grid, 3, 0, lambda g, f, s: cuda_weno
                       .weno5_momentum_tendency_op(g, *f)),
    "weno5_science_ab2": (weno_grid, 5, 5, lambda g, f, s: cuda_weno
                          .weno5_science_ab2_update_op(
                              g, *f[:3], tracers2(f[3:]), *s[:3],
                              tracers2(s[3:]), 0.7, -0.2, 1e-4, "b")[:4]),
    "weno5_tracers": (weno_grid, 5, 0, lambda g, f, s: cuda_weno
                      .weno5_tracer_tendencies_op(g, *f[:3],
                                                  tracers2(f[3:]))),
    "sw_rk3_stage": (sw_grid, 3, 3, lambda g, f, s: cuda_sw.sw_rk3_stage_op(
        g, *f, *s, 0.7, -0.2, 9.81)[:3]),
    "weno_tracer_march": (march_grid, 5, 0, lambda g, f, s: cuda_tracer
                          .weno_tracer_tendencies_op(g, ot.WENO(7), *f[:3],
                                                     tracers2(f[3:]))),
    "vi_march": (march_grid, 3, 0, lambda g, f, s: cuda_vi
                 .vi_momentum_tendency_op(g, ot.WENOVectorInvariant(),
                                          *f)),
    "generic_momentum": (weno_grid, 3, 0, lambda g, f, s: cuda_generic
                         .fused_momentum_tendency_op(g, ot.WENO(5), *f)),
}


@pytest.mark.parametrize("name", [*OPERATORS, "poisson_middle"])
def test_operator_vmap_equals_unbatched_calls(name):
    """``torch.func.vmap`` over 2 members equals two unbatched calls bit
    for bit: the outputs and the G⁻ written in place."""
    if name == "poisson_middle":
        batched = torch.func.vmap(
            lambda x: cuda_poisson.fused_middle_solve_op(
                x, *middle_operands(0)[1]))(
            torch.stack([middle_operands(m)[0][0] for m in range(2)]))
        for m in range(2):
            (x,), rest = middle_operands(m)
            assert torch.equal(batched[m],
                               cuda_poisson.fused_middle_solve_op(x, *rest))
        return
    make, nf, ns, call = OPERATORS[name]
    g = make()
    members = [(seeded(g.shape, nf, 2 * m + 1), seeded(g.shape, ns, 2 * m + 2))
               for m in range(2)]
    F = [torch.stack(x) for x in zip(*(f for f, _ in members))]
    S = [torch.stack(x) for x in zip(*(s for _, s in members))] if ns else []

    def one(fields, state):
        return call(g, fields, state)

    out = torch.func.vmap(one)(F, S)
    for m, (f, s) in enumerate(members):
        ref = one(f, s)
        got = jax.tree_util.tree_map(lambda t: t[m], out)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            assert torch.equal(a, b)
        for a, b in zip(S, s):
            assert torch.equal(a[m], b)


def test_backward_through_an_operator_raises():
    """No autograd formula: a gradient through a kernel raises, where the
    plain wrapper on the CPU keeps its gradient."""
    g = c2_grid()
    u, v, w = seeded(g.shape, 3, 0)
    u.requires_grad_(True)
    G = cuda_kernels.centered2_momentum_tendency_op(g, u, v, w)
    with pytest.raises(RuntimeError, match="autograd"):
        G[0].sum().backward()
    # an operator that writes G⁻ in place
    out = cuda_kernels.centered2_ab2_update_op(
        g, u, v, w, *seeded(g.shape, 3, 1), 0.7, -0.2)
    with pytest.raises(RuntimeError, match="autograd"):
        torch.autograd.grad(out[0].sum(), u)
    G = cuda_kernels.centered2_momentum_tendency(g, u, v, w)
    G[0].sum().backward()
    assert torch.isfinite(u.grad).all() and u.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# The differentiable step
# ---------------------------------------------------------------------------

def test_step_is_differentiable_as_in_jax():
    """``tests/test_hydrostatic.py::test_step_is_differentiable`` in both
    packages: 5 steps of the explicit free surface from an η of amplitude
    a; d/da Σu² by ``torch.autograd`` within 1e-12 of ``jax.grad`` and
    within 1e-5 of the central difference."""

    def model(pkg):
        g = pkg.RectilinearGrid(size=(16, 1, 4), x=(0, 1e5), y=(0, 1e4),
                                z=(-100, 0),
                                topology=(pkg.Periodic, pkg.Periodic,
                                          pkg.Bounded),
                                halo=3, dtype="float64" if pkg is oj else F64)
        return pkg.HydrostaticFreeSurfaceModel(
            grid=g, free_surface=pkg.ExplicitFreeSurface())

    jm, tm = model(oj), model(ot)

    def loss(m, xp, a):
        s = m.initial_state(
            eta=lambda x, y: a * xp.sin(2 * np.pi * x / 1e5) + 0 * y)
        for _ in range(5):
            s = m.step(s, 10.0)
        return xp.sum(m.grid.interior(s.u) ** 2)

    jg = float(jax.jit(jax.grad(lambda a: loss(jm, jnp, a)))(0.1))
    a = torch.tensor(0.1, dtype=F64, requires_grad=True)
    (tg,) = torch.autograd.grad(loss(tm, torch, a), a)
    assert abs(float(tg) - jg) <= 1e-12 * abs(jg)
    eps = 1e-4
    fd = (loss(tm, torch, torch.tensor(0.1 + eps, dtype=F64))
          - loss(tm, torch, torch.tensor(0.1 - eps, dtype=F64))) / (2 * eps)
    np.testing.assert_allclose(float(tg), float(fd), rtol=1e-5)
