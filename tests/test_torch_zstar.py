"""oceananigans_torch's z-star vertical coordinate against the JAX package,
on the CPU in float64.

- A flat channel and a seamount (``GridFittedBottom`` and
  ``PartialCellBottom``) with the explicit, split-explicit and implicit
  free surfaces: 2 steps, each field within 1e-12 of its largest JAX
  value after every step (``run_both``, the JAX model stepping eagerly).
- The seamount's conservation as the JAX package holds it
  (``tests/test_immersed_hydrostatic.py``): ∫σ c dV to 1e-13 relative and
  a uniform tracer to 1e-12 under the explicit free surface.
- The cube with partial cells (``CubedSphereHydrostaticModel`` with
  ``ZStar`` and ``QuasiAdamsBashforth2``) against the JAX cube and a
  bitwise pickup of its state through ``Checkpointer``; and the cube's
  implicit free surface (one CG across the stacked panels at a fixed
  iteration count) under quasi-AB2 with ``ZStar`` over continents, 2
  steps within 1e-12, with its ``ValueError`` for the other methods. (The
  cube's ``ValueError`` of ``ZStar`` with RK3 is held in
  ``tests/test_torch_cubed_sphere_hydrostatic.py``.) The cube's cases
  share one C8×4 shape, so the eager JAX operations compile once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.fields import LOC_C
from oceananigans_torch.interop import state_from_numpy, state_to_numpy
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFieldBCs,
)
from oceananigans_tpu.boundary_conditions import FluxBC as JFluxBC
from oceananigans_tpu.models import cubed_sphere as jcs
from oceananigans_tpu.models import hydrostatic as jhyd

from test_torch_closure_models import run_both
from test_torch_cubed_sphere_hydrostatic import (
    assert_close as cube_close, b_init, bump, grids, two_continents,
)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def channel(pkg, xp, fs, bottom=None, tracers=("T", "c")):
    g = pkg.RectilinearGrid(
        size=(16, 12, 6), x=(0.0, 4e5), y=(0.0, 3e5), z=(-4000.0, 0.0),
        topology=(pkg.Periodic, pkg.Bounded, pkg.Bounded), halo=(4, 4, 4),
        dtype="float64" if pkg is oj else F64)
    if bottom is not None:
        g = pkg.ImmersedBoundaryGrid(g, getattr(pkg, bottom)(
            lambda x, y: -4000.0 + 3000.0 * xp.exp(
                -((x - 2e5) ** 2 + (y - 1.5e5) ** 2) / 1e10)))
    free_surface = {"explicit": pkg.ExplicitFreeSurface(),
                    "split_explicit": pkg.SplitExplicitFreeSurface(
                        substeps=10),
                    "implicit": pkg.ImplicitFreeSurface(
                        solver_method="cg", maxiter=30, reltol=0.0)}[fs]
    return pkg.HydrostaticFreeSurfaceModel(
        grid=g, free_surface=free_surface, tracers=tracers,
        tracer_advection=pkg.WENO(5),
        vertical_coordinate=pkg.ZStar(),
        buoyancy=pkg.SeawaterBuoyancy(
            equation_of_state=pkg.LinearEquationOfState(),
            constant_salinity=35.0),
        coriolis=pkg.FPlane(f=1e-4))


def seeded_state(jm):
    rng = np.random.default_rng(5)
    N = jm.grid.N
    return jm.initial_state(
        u=0.05 + 0.01 * rng.standard_normal(N),
        v=0.01 * rng.standard_normal(N),
        T=lambda x, y, z: 10.0 + z / 400.0,
        c=1.0 + 0.1 * rng.random(N),
        eta=lambda x, y: 0.2 * jnp.exp(-((x - 1e5) ** 2) / 1e10) + 0 * y)


@pytest.mark.parametrize("fs, bottom", [
    ("explicit", None), ("split_explicit", None), ("implicit", None),
    ("explicit", "GridFittedBottom"), ("split_explicit", "GridFittedBottom"),
    ("split_explicit", "PartialCellBottom")])
def test_zstar_matches_jax(fs, bottom):
    """2 steps of 300 s (the second the first to take the σ-weighted
    tendencies the first kept); those tendencies, u, v,
    η, the transports and the tracers within 1e-12; no kernel is taken
    (the tendencies are on the σ-scaled grid)."""
    jm = channel(oj, jnp, fs, bottom)
    tm = channel(ot, torch, fs, bottom)
    assert not tm.fused_kernels and not tm.fused_tracer
    run_both(jm, tm, seeded_state(jm), 300.0, 2, eager=True)


def test_zstar_seamount_conserves():
    """The explicit free surface over the seamount: ∫σ c dV of a seeded c
    to 1e-13 relative and a uniform c = 1 to 1e-12 over the wet cells
    after 5 steps, as the JAX package holds its seamount."""
    tm = channel(ot, torch, "explicit", "GridFittedBottom",
                 tracers=("T", "c", "one"))
    rng = np.random.default_rng(9)
    s = tm.initial_state(
        u=lambda x, y, z: 0.05 + 0 * x, T=lambda x, y, z: 10.0 + z / 400.0,
        c=torch.from_numpy(1.0 + rng.random(tm.grid.N)), one=1.0,
        eta=lambda x, y: 0.2 * torch.exp(-((x - 1e5) ** 2) / 1e10) + 0 * y)
    g = tm.grid
    wet = ~g.interior(g.solid_c)

    def content(s):
        sigma = tm._sigma(s.eta).expand(g.shape)
        dV = g.V(*LOC_C).expand(g.shape)
        return float(torch.sum(g.interior(sigma * dV * s.tracers["c"])))

    c0 = content(s)
    for _ in range(5):
        s = tm.step(s, 300.0)
    assert abs(content(s) - c0) <= 1e-13 * abs(c0)
    one = g.interior(s.tracers["one"])[wet]
    assert float((one - 1.0).abs().max()) <= 1e-12
    assert float(s.eta.abs().max()) > 0.01


def test_zstar_gates_match_jax():
    """Under z-star neither package takes a kernel, even asked to: the
    JAX model runs its kernels only on its own grid, the port decides at
    construction."""
    kw = dict(momentum_advection=None, tracers=("T",))
    for fused in (True, "auto"):
        tm = ot.HydrostaticFreeSurfaceModel(
            grid=channel(ot, torch, "explicit").grid,
            tracer_advection=ot.WENO(5), fused_kernels=fused,
            vertical_coordinate=ot.ZStar(), **kw)
        assert not tm.fused_kernels and not tm.fused_tracer
        plain = ot.HydrostaticFreeSurfaceModel(
            grid=tm.grid, tracer_advection=ot.WENO(5), fused_kernels=fused,
            **kw)
        assert plain.fused_tracer is (fused is True)


# ---------------------------------------------------------------------------
# The cubed sphere
# ---------------------------------------------------------------------------

def cube_pair(**kw):
    """Both packages' C8×4 z-star models over the partial-cell continents
    of ``tests/test_torch_immersed_cube.py`` (quasi-AB2, the corner
    filter, a split-explicit free surface, b flux conditions)."""
    jg, tg = grids(Nz=4)
    common = dict(timestepper="QuasiAdamsBashforth2", corner_filter=0.005,
                  **kw)
    jm = jcs.CubedSphereHydrostaticModel(
        jg, vertical_coordinate=jhyd.ZStar(),
        bathymetry=oj.PartialCellBottom(two_continents, 0.2),
        free_surface=jhyd.SplitExplicitFreeSurface(substeps=8),
        boundary_conditions={"b": JFieldBCs(top=JFluxBC(1e-8),
                                            bottom=JFluxBC(-1e-8))},
        **common)
    tm = ot.CubedSphereHydrostaticModel(
        tg, vertical_coordinate=ot.ZStar(),
        bathymetry=ot.PartialCellBottom(two_continents, 0.2),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8),
        boundary_conditions={"b": ot.FieldBoundaryConditions(
            top=ot.FluxBC(1e-8), bottom=ot.FluxBC(-1e-8))},
        **common)
    return jm, tm


def test_cube_zstar_partial_cells_match_jax():
    """2 quasi-AB2 steps of the z-star cube over partial cells: u, v, η,
    U, V, the σ-weighted previous tendencies and b within 1e-12 of each
    group's largest JAX value (the JAX model stepping eagerly); the
    σ-weighted content ∫σ b dV and the volume as JAX's, to 1e-12."""
    jm, tm = cube_pair()
    sj = jm.initial_state(eta=bump(jm.grid), b=b_init)
    st = tm.initial_state(eta=bump(tm.grid), b=b_init)
    for _ in range(2):
        sj = jm.step(sj, 600.0)
        st = tm.step(st, 600.0)
    for names in (("u", "v"), ("eta",), ("U", "V"), ("Gu", "Gv"),
                  ("Geta",)):
        cube_close([(getattr(st, n), getattr(sj, n)) for n in names],
                   names)
    cube_close([(st.tracers["b"], sj.tracers["b"])], "b")
    for a, b in ((tm.total_tracer(st, "b"), jm.total_tracer(sj, "b")),
                 (tm.total_volume(st), jm.total_volume(sj))):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))


def test_cube_zstar_pickup_is_bitwise(tmp_path):
    """JAX's ``test_cs_partial_zstar_checkpoint_restart_exact`` on the
    port: z-star over partial cells with the corner filter, 6 steps with
    a ``Checkpointer`` at 4; a second ``Simulation`` picks up at 4 and
    runs to 6, every field bit for bit the uninterrupted run's (the
    σ-weighted tendencies and the persistent transports in the
    checkpoint)."""
    _, tm = cube_pair()
    s0 = tm.initial_state(eta=bump(tm.grid), b=b_init)
    sims = []
    for pickup in (False, True):
        sim = ot.Simulation(tm, state=s0, dt=600.0, stop_iteration=6)
        sim.output_writers["ckpt"] = ot.Checkpointer(
            tmp_path, ot.IterationInterval(4))
        sim.run(pickup=pickup)
        sims.append(sim.state)
    a, b = sims
    assert b.clock.iteration == 6
    for n in ("u", "v", "eta", "U", "V", "Gu", "Gv", "Geta"):
        assert torch.equal(getattr(a, n), getattr(b, n)), n
    assert torch.equal(a.tracers["b"], b.tracers["b"])
    assert torch.equal(a.Gtracers["b"], b.Gtracers["b"])


def test_zstar_state_round_trips():
    """A z-star state through ``interop``'s numpy mapping, bit for bit,
    on the channel and on the cube."""
    tm = channel(ot, torch, "explicit", "GridFittedBottom")
    s = tm.step(tm.initial_state(u=lambda x, y, z: 0.05 + 0 * x,
                                 eta=lambda x, y: 1e-6 * x + 0 * y), 300.0)
    _, cm = cube_pair()
    c = cm.step(cm.initial_state(eta=bump(cm.grid), b=b_init), 600.0)
    for m, st in ((tm, s), (cm, c)):
        arrays = state_to_numpy(st)
        again = state_to_numpy(state_from_numpy(m, arrays))
        for k, a in arrays.items():
            np.testing.assert_array_equal(np.asarray(a),
                                          np.asarray(again[k]), k)


# ---------------------------------------------------------------------------
# The cube's implicit free surface: one CG across the stacked panels
# ---------------------------------------------------------------------------

def cube_implicit_pair():
    """Both packages' C8×4 cubes over the continents under ``ZStar`` and
    quasi-AB2 with the implicit free surface at 20 CG iterations a solve
    (CG agrees with JAX only to rounding, so the count is fixed)."""
    jg, tg = grids(Nz=4)
    kw = dict(timestepper="QuasiAdamsBashforth2", bathymetry=two_continents)
    fs = dict(solver_method="cg", maxiter=20, reltol=0.0)
    return (jcs.CubedSphereHydrostaticModel(
                jg, free_surface=jhyd.ImplicitFreeSurface(**fs),
                vertical_coordinate=jhyd.ZStar(), **kw),
            ot.CubedSphereHydrostaticModel(
                tg, free_surface=ot.ImplicitFreeSurface(**fs),
                vertical_coordinate=ot.ZStar(), **kw))


def test_cube_implicit_matches_jax():
    """The cube's implicit free surface (20 CG iterations a solve, the
    Az-weighted inner product, the exchange inside the operator) under
    quasi-AB2 with ``ZStar`` over the continents, 2 steps of 600 s: every
    group within 1e-12 of its largest JAX value (the JAX model stepping
    eagerly), the volume kept to 1e-12 of the ocean's. (The RK3 stages
    call the same solve; ``chip_smoke.py`` phase 26a holds them on the
    card against the CPU.)"""
    jm, tm = cube_implicit_pair()
    sj = jm.initial_state(eta=bump(jm.grid), b=b_init)
    st = tm.initial_state(eta=bump(tm.grid), b=b_init)
    v0 = float(tm.total_volume(st))
    for _ in range(2):
        sj = jm.step(sj, 600.0)
        st = tm.step(st, 600.0)
    for names in (("u", "v"), ("eta",), ("U", "V")):
        cube_close([(getattr(st, n), getattr(sj, n)) for n in names], names)
    cube_close([(st.tracers["b"], sj.tracers["b"])], "b")
    assert int(tm.free_surface_info["iterations"]) == 20
    assert abs(float(tm.total_volume(st)) - v0) \
        <= 1e-12 * float(tm.ocean_volume())


def test_cube_implicit_refuses_other_methods():
    """JAX's ValueError for any method but "cg" on the cube."""
    jg, tg = grids(Nz=2)
    for method in ("fft", "matrix"):
        with pytest.raises(ValueError, match="solver_method='cg'"):
            ot.CubedSphereHydrostaticModel(
                tg, free_surface=ot.ImplicitFreeSurface(solver_method=method))
        with pytest.raises(ValueError, match="solver_method='cg'"):
            jcs.CubedSphereHydrostaticModel(
                jg, free_surface=jhyd.ImplicitFreeSurface(
                    solver_method=method))
