"""oceananigans_torch's hydrostatic models over bathymetry against the JAX
package, on the CPU in float64.

A seamount in a channel with the explicit and the split-explicit free
surface (wet column depths in the barotropic mode, masked fields and
tendencies), the same with a ``PartialCellBottom`` (scaled heights in
every metric), the 1° ocean with continents of ``chip_smoke.py`` phase 19
at a (24, 16, 8) sector (``WENOVectorInvariant``, WENO(7) tracers,
spherical Coriolis, seawater buoyancy), a bottom drag given as an
``ImmersedBoundaryCondition``: each within 1e-12 of each field's largest
value after 2 steps, the JAX model stepping eagerly (quicker than
compiling these small cases). The cubed sphere's bathymetry objects are
``tests/test_torch_immersed_cube.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj

from test_torch_closure_models import run_both

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


def seamount_channel(pkg, xp, fs, kind="GridFittedBottom", N=(16, 12, 6)):
    g = pkg.RectilinearGrid(
        size=N, x=(0.0, 4e5), y=(0.0, 3e5), z=(-4000.0, 0.0),
        topology=(pkg.Periodic, pkg.Bounded, pkg.Bounded), halo=(4, 4, 4),
        dtype="float64" if pkg is oj else F64)
    bottom = getattr(pkg, kind)(lambda x, y: -4000.0 + 3000.0 * xp.exp(
        -((x - 2e5) ** 2 + (y - 1.5e5) ** 2) / 1e10))
    free_surface = (pkg.ExplicitFreeSurface() if fs == "explicit"
                    else pkg.SplitExplicitFreeSurface(substeps=10))
    return pkg.HydrostaticFreeSurfaceModel(
        grid=pkg.ImmersedBoundaryGrid(g, bottom), free_surface=free_surface,
        tracers=("T",), tracer_advection=pkg.WENO(5),
        buoyancy=pkg.SeawaterBuoyancy(
            equation_of_state=pkg.LinearEquationOfState(),
            constant_salinity=35.0),
        coriolis=pkg.FPlane(f=1e-4))


@pytest.mark.parametrize("fs, kind", [
    ("explicit", "GridFittedBottom"), ("split_explicit", "GridFittedBottom"),
    ("split_explicit", "PartialCellBottom")])
def test_seamount_channel_matches_jax(fs, kind):
    """A seamount in a (Periodic, Bounded) channel: the wet column depths
    at u and v faces equal the JAX model's, 2 steps from a sloshing η and
    a stratified T, T exactly zero in solid cells."""
    jm = seamount_channel(oj, jnp, fs, kind)
    tm = seamount_channel(ot, torch, fs, kind)
    np.testing.assert_array_equal(tm._H_fc.numpy(),
                                  np.asarray(jm._column_depth("fc")))
    np.testing.assert_array_equal(tm._H_cf.numpy(),
                                  np.asarray(jm._column_depth("cf")))
    js = jm.initial_state(
        u=lambda x, y, z: 0.05 + 0 * x, T=lambda x, y, z: 10.0 + z / 400.0,
        eta=lambda x, y: 0.2 * jnp.exp(-((x - 1e5) ** 2) / 1e10) + 0 * y)
    _, ts = run_both(jm, tm, js, 300.0, 2, eager=True)
    assert not ts.tracers["T"][tm.grid.solid_c].any()


def continents(xp, depth=4000.0):
    """``bench.py``'s continents(λ, φ) on λ wrapped to [-180, 180): land
    at +50 m, ocean ``depth`` deep."""
    def bottom(lam, phi):
        lam = (lam + 180.0) % 360.0 - 180.0
        land = (xp.abs(lam + 60.0) < 25.0) & (phi > -55.0) & (phi < 70.0)
        land = land | ((xp.abs(lam - 45.0) < 50.0) & (phi > 0.0)
                       & (phi < 70.0))
        land = land | (xp.abs(phi) > 78.0)
        return xp.where(land, 50.0, -depth)
    return bottom


def test_latlon_continents_sector_matches_jax():
    """phase 19's ocean with continents on the (24, 16, 8) sector of
    ``chip_smoke.py``'s card-against-CPU check (60°W to 60°E, 80°S to
    80°N; 10 barotropic substeps in place of 30): no kernel takes it, 2
    steps of 600 s."""
    def build(pkg, xp):
        g = pkg.LatitudeLongitudeGrid(
            size=(24, 16, 8), longitude=(-60.0, 60.0),
            latitude=(-80.0, 80.0), z=(-4000.0, 0.0), halo=6,
            dtype="float64" if pkg is oj else F64)
        ib = pkg.ImmersedBoundaryGrid(g, pkg.GridFittedBottom(
            continents(xp)))
        return pkg.HydrostaticFreeSurfaceModel(
            grid=ib, momentum_advection=pkg.WENOVectorInvariant(),
            tracer_advection=pkg.WENO(7), tracers=("T", "S"),
            buoyancy=pkg.SeawaterBuoyancy(
                equation_of_state=pkg.LinearEquationOfState()),
            coriolis=pkg.HydrostaticSphericalCoriolis(),
            free_surface=pkg.SplitExplicitFreeSurface(substeps=10))

    jm, tm = build(oj, jnp), build(ot, torch)
    solid = tm.grid.interior(tm.grid.solid_c)
    assert 0 < float(solid.double().mean()) < 1
    js = jm.initial_state(
        u=lambda lam, phi, z: 0.1 * jnp.sin(jnp.deg2rad(lam) + 0.5)
        * jnp.cos(jnp.pi * phi / 160.0 + 0.2) + 0.01,
        T=lambda lam, phi, z: 20.0 + 8e-4 * z - 0.05 * jnp.abs(phi),
        S=lambda lam, phi, z: 35.0 + 1e-3 * phi)
    run_both(jm, tm, js, 600.0, 2, eager=True)


def test_hydrostatic_immersed_drag_matches_jax():
    """``tests/test_immersed_hydrostatic.py``'s bottom drag: a FluxBC on
    u's immersed bottom decelerates exactly the cells above the flat
    immersed bottom, by τ/Δz; 2 steps against the JAX model."""
    def build(pkg):
        base = pkg.RectilinearGrid(
            size=(12, 8, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=(0.0, 1.0),
            topology=(pkg.Periodic, pkg.Periodic, pkg.Bounded),
            dtype="float64" if pkg is oj else F64)
        grid = pkg.ImmersedBoundaryGrid(base, pkg.GridFittedBottom(
            lambda x, y: 0.4 + 0 * x))
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, free_surface=pkg.ExplicitFreeSurface(),
            boundary_conditions={"u": pkg.FieldBoundaryConditions(
                immersed=pkg.ImmersedBoundaryCondition(
                    bottom=pkg.FluxBC(-2e-5)))})

    jm, tm = build(oj), build(ot)
    assert set(tm.immersed_bcs) == {"u"}
    s0 = tm.update_state(tm.initial_state(u=0.05))
    Gu = tm.grid.interior(tm.compute_tendencies(s0)[0]).numpy()
    solid_u = tm.grid.interior(tm.grid.solid_u).numpy()
    adj = (~solid_u) & np.roll(solid_u, 1, 2) & (
        np.arange(solid_u.shape[2]) > 0)
    assert adj.any()
    np.testing.assert_allclose(Gu[adj], -2e-5 / (1.0 / 8), rtol=1e-12)
    np.testing.assert_allclose(Gu[(~solid_u) & ~adj], 0.0, atol=1e-15)
    js = jm.initial_state(u=lambda x, y, z: 0.05 + 0 * x)
    run_both(jm, tm, js, 10.0, 2, eager=True)
