"""Physics checks of oceananigans_torch's HydrostaticFreeSurfaceModel on the
CPU, after ``tests/test_hydrostatic.py`` (the checks that need no unported
feature), and the model's surface: its gates, its state's numpy bridge, the
profiling script's phased step and its options."""

import copy
import math

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.fields import LOC_U, LOC_V, field_integral, set_field
from oceananigans_torch.interop import (
    HYDROSTATIC_FIELDS, state_from_numpy, state_to_numpy, tracer_keys,
)
from oceananigans_torch.ops.operators import divergence_ccc

F64 = torch.float64
G = 10.0


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


def channel_grid(N=64, Nz=4, H=1.0, L=10.0):
    return ot.RectilinearGrid(size=(N, Nz), x=(0.0, L), z=(-H, 0.0),
                              topology=(ot.Periodic, ot.Flat, ot.Bounded),
                              dtype=F64)


def eta_interior(grid, state):
    return state.eta[grid.interior_slices[:2]].clone()


@pytest.mark.parametrize("fs", ["explicit", "split_explicit"])
def test_gravity_wave_period(fs):
    """A standing gravity wave η = A cos(kx) is −η after half a period
    T/2 = π/(k√(gH))."""
    L, H = 10.0, 1.0
    k = 2 * math.pi / L
    period = 2 * math.pi / (k * math.sqrt(G * H))
    grid = channel_grid(N=64, H=H, L=L)
    free_surface = (ot.ExplicitFreeSurface(gravitational_acceleration=G)
                    if fs == "explicit" else ot.SplitExplicitFreeSurface(
                        substeps=40, gravitational_acceleration=G))
    model = ot.HydrostaticFreeSurfaceModel(grid=grid,
                                           free_surface=free_surface,
                                           momentum_advection=None)
    A = 1e-4
    state = model.initial_state(eta=lambda x, y: A * torch.cos(k * x))
    eta0 = eta_interior(grid, state)
    nsteps = 200
    for _ in range(nsteps):
        state = model.step(state, (period / 2) / nsteps)
    torch.testing.assert_close(eta_interior(grid, state), -eta0, rtol=0,
                               atol=0.1 * A)


@pytest.mark.parametrize("fs", ["explicit", "split_explicit"])
def test_volume_conservation(fs):
    grid = ot.RectilinearGrid(size=(32, 32, 4), extent=(10.0, 10.0, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    free_surface = (ot.ExplicitFreeSurface(gravitational_acceleration=G)
                    if fs == "explicit" else ot.SplitExplicitFreeSurface(
                        substeps=20, gravitational_acceleration=G))
    model = ot.HydrostaticFreeSurfaceModel(grid=grid,
                                           free_surface=free_surface)
    state = model.initial_state(eta=lambda x, y: 0.01 * torch.exp(
        -((x - 5) ** 2 + (y - 5) ** 2)))
    vol0 = float(eta_interior(grid, state).sum())
    dt = 0.005 if fs == "explicit" else 0.02
    for _ in range(20):
        state = model.step(state, dt)
    assert abs(float(eta_interior(grid, state).sum()) - vol0) < 1e-12


def test_geostrophic_balance():
    """A geostrophically balanced jet (f v = g ∂x η) stays steady."""
    f, L, A = 1.0, 10.0, 1e-4
    k = 2 * math.pi / L
    grid = ot.RectilinearGrid(size=(32, 32, 4), extent=(L, L, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    model = ot.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=ot.ExplicitFreeSurface(G),
        coriolis=ot.FPlane(f=f), momentum_advection=None)
    init = dict(eta=lambda x, y: A * torch.sin(k * x),
                v=lambda x, y, z: (G / f) * A * k * torch.cos(k * x))
    state = model.initial_state(**init)
    v0 = grid.interior(model.initial_state(**init).v)
    for _ in range(50):
        state = model.step(state, 2e-3)
    assert float((grid.interior(state.v) - v0).abs().max()) < \
        0.05 * float(v0.abs().max())


def test_w_from_continuity_divergence_free():
    """The 3-D divergence vanishes but in the top cell, whose flux
    divergence ∂t η absorbs."""
    grid = ot.RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    model = ot.HydrostaticFreeSurfaceModel(grid=grid)
    state = model.initial_state(
        u=lambda x, y, z: torch.sin(2 * math.pi * x)
        * torch.cos(math.pi * z),
        v=lambda x, y, z: torch.cos(2 * math.pi * y) + 0 * z)
    div = grid.interior(divergence_ccc(grid, state.u, state.v, state.w))
    assert float(div[:, :, :-1].abs().max()) < 1e-12


def test_tracer_conservation():
    grid = ot.RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    model = ot.HydrostaticFreeSurfaceModel(
        grid=grid, tracers=("c",), tracer_advection=ot.WENO(5),
        free_surface=ot.SplitExplicitFreeSurface(substeps=10))
    state = model.initial_state(
        u=lambda x, y, z: 0.1 * torch.sin(2 * math.pi * x),
        c=lambda x, y, z: 1.0 + 0.5 * torch.cos(2 * math.pi * y))
    c0 = float(field_integral(grid, state.tracers["c"]))
    for _ in range(20):
        state = model.step(state, 1e-3)
    c1 = float(field_integral(grid, state.tracers["c"]))
    assert abs(c1 - c0) / abs(c0) < 1e-12


@pytest.mark.parametrize("vi", ["VectorInvariant", "WENOVectorInvariant"])
def test_vector_invariant_uniform_flow(vi):
    """Uniform flow has no vorticity and a uniform kinetic energy: the
    vector-invariant tendency vanishes."""
    grid = ot.RectilinearGrid(size=(16, 16, 4), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              halo=6, dtype=F64)
    scheme = getattr(ot, vi)()
    u = set_field(grid, 0.3, loc=LOC_U)
    v = set_field(grid, -0.2, loc=LOC_V)
    w = torch.zeros_like(u)
    for G_ in (scheme.u_tendency(grid, u, v, w),
               scheme.v_tendency(grid, u, v, w)):
        assert float(grid.interior(G_).abs().max()) < 1e-13


def test_state_round_trip_and_fused_gates():
    """The numpy bridge carries every field of a hydrostatic state; the
    fused gates follow the device ("auto": only on a CUDA device) and the
    kernels' own gates."""
    from oceananigans_torch.profile_step import hydro_model
    m = hydro_model("auto", F64, "cpu", size=(20, 12, 6))
    assert not m.fused_kernels and not m.fused_tracer
    forced = hydro_model(True, F64, "cpu", size=(20, 12, 6))
    assert forced.fused_kernels and forced.fused_tracer
    s = forced.step(forced.initial_state(u=0.1, T=20.0, S=35.0), 60.0)
    arrays = state_to_numpy(s)
    assert set(arrays) >= set(HYDROSTATIC_FIELDS + tracer_keys(("T", "S")))
    back = state_from_numpy(forced, arrays)
    for name in HYDROSTATIC_FIELDS:
        assert torch.equal(getattr(back, name), getattr(s, name)), name
    assert back.clock.iteration == s.clock.iteration == 1
    with pytest.raises(ValueError):
        state_from_numpy(forced, {**arrays, "eta": arrays["u"]})
    # Centered momentum advection: no VI kernel; Centered tracers: none
    grid = forced.grid
    flux_form = ot.HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=ot.WENO(5), tracers=("T",),
        fused_kernels=True)
    assert not flux_form.fused_kernels and not flux_form.fused_tracer


@pytest.mark.parametrize("fused", [True, False])
def test_profiled_phases_repeat_step(fused):
    """``profile_step.phased_hydro_step``, which the profiling script times
    phase by phase, computes exactly what ``model.step`` does, on the
    ``hydro_vi`` configuration at a small size."""
    from oceananigans_torch.profile_step import (
        HYDRO_PHASES, hydro_initial_state, hydro_model, phased_hydro_step,
    )
    m = hydro_model(fused, F64, "cpu", size=(20, 12, 6))
    assert m.fused_kernels == m.fused_tracer == fused
    s = m.step(hydro_initial_state(m), 60.0)
    ref = m.step(copy.deepcopy(s), 60.0, assume_filled=True)
    marks = []
    got = phased_hydro_step(m, copy.deepcopy(s), 60.0,
                            lambda: marks.append(1))
    assert len(marks) == len(HYDRO_PHASES)
    for name in HYDROSTATIC_FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("T", "S"):
        assert torch.equal(got.tracers[name], ref.tracers[name])
    assert got.clock.iteration == ref.clock.iteration == 2


def test_split_explicit_weights_match_jax():
    from oceananigans_tpu.models.hydrostatic import (
        SplitExplicitFreeSurface as JSplit,
    )
    for substeps in (8, 30, 50):
        t, j = ot.SplitExplicitFreeSurface(substeps), JSplit(substeps)
        assert t.weights == j.weights and len(t.weights) > 0
        assert t.fractional_step == j.fractional_step
    assert len(ot.SplitExplicitFreeSurface(30).weights) == 21


def test_unported_options_raise():
    grid = ot.RectilinearGrid(size=(8, 8, 4), extent=(1.0, 1.0, 1.0),
                              dtype=F64)
    from oceananigans_torch.models import hydrostatic as hyd
    # item 15's time stepper is ported: it builds
    assert ot.HydrostaticFreeSurfaceModel(
        grid=grid, timestepper="split_rk3").timestepper == "split_rk3"
    # item 12's keywords and the ocean closures are ported: they build
    for kw in (dict(forcing={"u": 1.0}),
               dict(particles=ot.LagrangianParticles(0.5, 0.5, -0.5)),
               dict(biogeochemistry=ot.SimpleBiogeochemistry()),
               dict(stokes_drift=ot.UniformStokesDrift()),
               dict(auxiliary_fields={"Q": 1.0}),
               dict(closure=ot.CATKEVerticalDiffusivity())):
        ot.HydrostaticFreeSurfaceModel(grid=grid, **kw)
    with pytest.raises(TypeError, match="AbstractClosure"):
        ot.HydrostaticFreeSurfaceModel(grid=grid, closure=object())
    # and so are item 15's free surface, coordinate and data class
    for cls in (hyd.ImplicitFreeSurface, hyd.ZStar,
                hyd.PrescribedVelocityFields):
        assert isinstance(cls(), cls)
    m = ot.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=hyd.ImplicitFreeSurface(),
        vertical_coordinate=hyd.ZStar())
    assert m.zstar and m.free_surface.solver_method == "fft"
    with pytest.raises(ValueError):
        ot.HydrostaticFreeSurfaceModel(grid=grid, timestepper="rk4")
    with pytest.raises(ValueError):
        ot.HydrostaticFreeSurfaceModel(grid=grid).initial_state(w=1.0)
    m = ot.HydrostaticFreeSurfaceModel(grid=grid, tracers="c",
                                       buoyancy=ot.BuoyancyTracer())
    assert m.tracer_names == ("c", "b")
    assert isinstance(m.momentum_advection, ot.VectorInvariant)
    assert isinstance(m.free_surface, ot.SplitExplicitFreeSurface)
    s = m.initial_state(c=1.0)
    assert s.eta.shape == (grid.shape[0], grid.shape[1], 1)
    assert np.isfinite(float(m.cfl_timescale(s)))
