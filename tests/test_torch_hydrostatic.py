"""oceananigans_torch's HydrostaticFreeSurfaceModel against the JAX package,
step for step, on the CPU in float64.

Each case builds its initial state in the JAX package, hands it to the port
as numpy arrays (``interop.state_from_numpy``) and steps both; after every
step u, v, w, η, the barotropic transports and the tracers agree to 1e-12
of the largest value of each field, the horizontal velocities and the
transports as pairs (a field that is zero by symmetry picks up rounding
noise in one package and not the other; both packages evaluate the same
whole-array formulas; the JAX fused kernels run in interpret mode on the
CPU). Fields are compared on their owned ranges: the interior, plus the
right wall face of a Bounded y for v, as ``tests/test_pallas_vi.py`` does
(halo rows carry layout-dependent values until the next fill).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import (
    HYDROSTATIC_FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_tpu import models as jm

RTOL = 1e-12


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


def jax_state_arrays(state, names):
    """A JAX ``HydrostaticState`` as the numpy mapping of ``interop``."""
    out = {k: np.asarray(getattr(state, k)) for k in HYDROSTATIC_FIELDS}
    for n in names:
        out[f"tracers/{n}"] = np.asarray(state.tracers[n])
        out[f"Gtracers/{n}"] = np.asarray(state.Gtracers[n])
    out["time"] = np.asarray(state.clock.time)
    out["iteration"] = np.asarray(state.clock.iteration)
    out["last_dt"] = np.asarray(state.clock.last_dt)
    return out


def owned(grid, name):
    """The owned range of ``name``: interior, plus the right wall face of a
    Bounded y for v; (nx, ny, 1) fields over their whole z extent."""
    S = [slice(h, h + n) for h, n in zip(grid.H, grid.N)]
    if name == "v" and grid.topology[1] == ot.Bounded:
        S[1] = slice(grid.H[1], grid.H[1] + grid.N[1] + 1)
    if name in ("eta", "U", "V"):
        S[2] = slice(None)
    return tuple(S)


def assert_states_close(tg, got, ref, names, rtol=RTOL):
    a = state_to_numpy(got)
    b = jax_state_arrays(ref, names)
    groups = (("u", "v"), ("w",), ("eta",), ("U", "V"),
              *((f"tracers/{n}",) for n in names))
    for group in groups:
        pairs = [(a[key][S], b[key][S]) for key in group
                 for S in [owned(tg, key if "/" not in key else "c")]]
        scale = max(np.abs(y).max() for _, y in pairs)
        if scale == 0:
            assert all(np.abs(x).max() == 0 for x, _ in pairs), group
            continue
        err = max(np.abs(x - y).max() for x, y in pairs) / scale
        assert err < rtol, (group, err)
    assert got.clock.iteration == int(ref.clock.iteration)


def grids(**kw):
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=torch.float64, **kw))


def run_both(jmodels, tmodel, jstate, dt, steps, names):
    """Step the port and each JAX model from the same state and compare
    after every step. A JAX model on its XLA path steps eagerly (quicker
    than compiling these small cases), one that takes the Pallas kernels
    (interpret mode) under ``jax.jit`` (quicker there)."""
    tg = tmodel.grid
    ts = state_from_numpy(tmodel, jax_state_arrays(jstate, names))
    jsteps = [jax.jit(lambda s, m=m: m.step(s, dt)) if m.fused_kernels
              or m.fused_tracer else (lambda s, m=m: m.step(s, dt))
              for m in jmodels]
    jss = [jstate] * len(jmodels)
    for _ in range(steps):
        ts = tmodel.step(ts, dt)
        jss = [f(s) for f, s in zip(jsteps, jss)]
        for js in jss:
            assert_states_close(tg, ts, js, names)
    return ts


def test_weno_vector_invariant_matches_jax_xla_and_fused():
    """``tests/test_pallas_vi.py:139-176``'s configuration: the port's
    kernel code path against the JAX XLA path and the JAX fused path
    (both Pallas kernels, interpret mode)."""
    kw = dict(size=(16, 12, 8), extent=(1e5, 2e5, 1e3),
              topology=(oj.Bounded, oj.Bounded, oj.Bounded), halo=6)
    jg, tg = grids(**kw)

    def jax_model(fused):
        return jm.HydrostaticFreeSurfaceModel(
            grid=jg, momentum_advection=jm.WENOVectorInvariant(),
            tracer_advection=oj.WENO(7), tracers=("T",),
            free_surface=jm.SplitExplicitFreeSurface(substeps=8),
            fused_kernels=fused)

    jx, jf = jax_model(False), jax_model(True)
    assert jf.fused_kernels and jf.fused_tracer
    tmodel = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(7), tracers=("T",),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8),
        fused_kernels=True)
    assert tmodel.fused_kernels and tmodel.fused_tracer
    state = jx.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 1e5),
        v=lambda x, y, z: 0.05 * jnp.cos(np.pi * y / 2e5),
        T=lambda x, y, z: 10.0 + 1e-3 * z)
    run_both([jx, jf], tmodel, state, 30.0, 3, ("T",))


def test_weno_vector_invariant_order7_matches_jax():
    """``WENOVectorInvariant(order=7)`` (all four schemes WENO(7)) with
    WENO(7) tracers: the port's kernel code path (the order-generic VI
    kernel's gate holds) against the JAX model, 3 steps."""
    kw = dict(size=(16, 12, 8), extent=(1e5, 2e5, 1e3),
              topology=(oj.Bounded, oj.Bounded, oj.Bounded), halo=6)
    jg, tg = grids(**kw)
    jmodel = jm.HydrostaticFreeSurfaceModel(
        grid=jg, momentum_advection=jm.WENOVectorInvariant(order=7),
        tracer_advection=oj.WENO(7), tracers=("T",),
        free_surface=jm.SplitExplicitFreeSurface(substeps=8),
        fused_kernels=False)
    tmodel = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=ot.WENOVectorInvariant(order=7),
        tracer_advection=ot.WENO(7), tracers=("T",),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8),
        fused_kernels=True)
    assert tmodel.fused_kernels and tmodel.fused_tracer
    state = jmodel.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 1e5),
        v=lambda x, y, z: 0.05 * jnp.cos(np.pi * y / 2e5),
        T=lambda x, y, z: 10.0 + 1e-3 * z)
    run_both([jmodel], tmodel, state, 30.0, 3, ("T",))


def test_nz_thin_periodic_matches_jax():
    """(Periodic, Bounded, Bounded) with halo (6, 6, 4), the nz-thin grid
    of ``tests/test_pallas_vi.py:336-338`` (where the JAX model takes its
    transposed kernels); the port's kernel code path against the JAX XLA
    path. 30 substeps, as ``hydro_vi`` takes, keep the barotropic substep
    inside its CFL limit (8 would not, at this Δx and Δt)."""
    kw = dict(size=(116, 16, 6), extent=(1e5, 2e5, 1e3),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded),
              halo=(6, 6, 4))
    jg, tg = grids(**kw)
    jx = jm.HydrostaticFreeSurfaceModel(
        grid=jg, momentum_advection=jm.WENOVectorInvariant(),
        tracer_advection=oj.WENO(7), tracers=("T",),
        free_surface=jm.SplitExplicitFreeSurface(substeps=30),
        fused_kernels=False)
    tmodel = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(7), tracers=("T",),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30),
        fused_kernels=True)
    assert tmodel.fused_kernels and tmodel.fused_tracer
    state = jx.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 1e5),
        T=lambda x, y, z: 20.0 + 8e-4 * z)
    run_both([jx], tmodel, state, 60.0, 3, ("T",))


CASES = {
    # the explicit free surface, f-plane Coriolis, the default momentum
    # advection (momentum_advection=None is VectorInvariant()) and a
    # BuoyancyTracer
    "explicit_fplane_buoyancy": (
        dict(free_surface=("ExplicitFreeSurface", 10.0),
             coriolis=("FPlane", 1e-4), buoyancy="BuoyancyTracer"),
        ("b",), 2e-3),
    # the default VectorInvariant(), Centered(2) tracers and the seawater
    # buoyancy of T and S under the split-explicit free surface
    "split_seawater_centered": (
        dict(momentum_advection="VectorInvariant",
             tracer_advection="Centered",
             free_surface=("SplitExplicitFreeSurface", 10.0),
             buoyancy="SeawaterBuoyancy"),
        ("T", "S"), 5e-3),
}


def _build(pkg, mod, grid, spec, names):
    kw = {}
    for key, value in spec.items():
        if key == "free_surface":
            cls, g = value
            kw[key] = getattr(mod, cls)(gravitational_acceleration=g)
        elif key == "coriolis":
            kw[key] = pkg.FPlane(f=value[1])
        elif key == "buoyancy":
            kw[key] = getattr(pkg, value)()
        elif key == "momentum_advection":
            kw[key] = mod.VectorInvariant()
        elif key == "tracer_advection":
            kw[key] = pkg.Centered(2)
    tracers = () if spec.get("buoyancy") == "BuoyancyTracer" else names
    return mod.HydrostaticFreeSurfaceModel(grid=grid, tracers=tracers, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_options_match_jax(case):
    spec, names, dt = CASES[case]
    kw = dict(size=(10, 8, 4), extent=(1.0, 1.0, 1.0),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=3)
    jg, tg = grids(**kw)
    jmodel = _build(oj, jm, jg, spec, names)
    tmodel = _build(ot, ot, tg, spec, names)
    assert tmodel.tracer_names == jmodel.tracer_names == names
    init = dict(u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x)
                * jnp.cos(np.pi * y),
                v=lambda x, y, z: 0.05 * jnp.cos(2 * np.pi * x),
                eta=lambda x, y: 1e-3 * jnp.cos(2 * np.pi * x)
                * jnp.cos(np.pi * y))
    tracer_init = {"b": lambda x, y, z: 1e-2 * z + 1e-3 * jnp.sin(
                       2 * np.pi * x),
                   "T": lambda x, y, z: 20.0 + 2.0 * z + jnp.sin(
                       2 * np.pi * x),
                   "S": lambda x, y, z: 35.0 + 0.1 * jnp.cos(np.pi * y)
                   + 0 * z}
    state = jmodel.initial_state(**init,
                                 **{n: tracer_init[n] for n in names})
    run_both([jmodel], tmodel, state, dt, 3, names)
