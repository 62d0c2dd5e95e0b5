"""oceananigans_torch's HydrostaticFreeSurfaceModel on a
``LatitudeLongitudeGrid`` against the JAX package, step for step, on the
CPU in float64.

Each case builds its initial state in the JAX package on (λ, φ, z), hands
it to the port as numpy arrays and steps both 3 or 4 times; after every
step the fields agree to 1e-12 of the largest value of each on their owned
ranges (``test_torch_hydrostatic.assert_states_close``). The cases: both
conserving vector-invariant forms with spherical Coriolis in the matching
scheme, ``WENOVectorInvariant(5)``, ``hydro_vi_latlon``'s configuration
(WENO(7) T and S with linear seawater buoyancy), a grid from pole to pole
(the polar condition on the tracers and η), and the port's kernel code
paths (``fused_kernels=True``, the kernels' plain versions on the CPU) at
mixed vector-invariant orders. Cases with WENO tracers on stratified T
compare against the eager JAX step (ROADMAP Queue 3, caveat 5); the others
against the jitted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import state_from_numpy
from oceananigans_tpu import coriolis as jcor
from oceananigans_tpu.models import hydrostatic as jhyd
from test_torch_hydrostatic import assert_states_close, jax_state_arrays


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


NEAR_GLOBAL = dict(size=(16, 12, 6), longitude=(0.0, 360.0),
                   latitude=(-80.0, 80.0), z=(-4000.0, 0.0), halo=6)
POLE_TO_POLE = dict(size=(16, 12, 4), longitude=(0.0, 360.0),
                    latitude=(-90.0, 90.0), z=(-1000.0, 0.0), halo=3)


def mixed(pkg, hyd):
    """WENO(9) vorticity, WENO(7) kinetic energy gradient, WENO(5)
    divergence and WENO(3) vertical with an epsilon of its own."""
    return hyd.VectorInvariant(
        vorticity_scheme=pkg.WENO(9), vertical_scheme=pkg.WENO(
            3, epsilon=1e-6), divergence_scheme=pkg.WENO(5),
        kinetic_energy_gradient_scheme=pkg.WENO(7))


#: case: (grid, model keywords of a package, tracers, Δt, steps, eager,
#: fused_kernels of the port)
CASES = {
    "vi_enstrophy": (NEAR_GLOBAL, lambda p, h, c: dict(
        momentum_advection=h.VectorInvariant(), buoyancy=p.BuoyancyTracer(),
        coriolis=c.HydrostaticSphericalCoriolis()), ("b",), 600.0, 4,
        False, "auto"),
    "vi_energy": (NEAR_GLOBAL, lambda p, h, c: dict(
        momentum_advection=h.VectorInvariant(
            vorticity_scheme="energy_conserving"),
        coriolis=c.HydrostaticSphericalCoriolis(scheme="energy_conserving"),
        free_surface=h.ExplicitFreeSurface()), ("T",), 60.0, 4, False,
        "auto"),
    "weno_vi5": (NEAR_GLOBAL, lambda p, h, c: dict(
        momentum_advection=h.WENOVectorInvariant(5),
        coriolis=c.HydrostaticSphericalCoriolis()), ("T",), 600.0, 3,
        False, "auto"),
    "hydro_vi_latlon": (NEAR_GLOBAL, lambda p, h, c: dict(
        momentum_advection=h.WENOVectorInvariant(),
        tracer_advection=p.WENO(7),
        buoyancy=p.SeawaterBuoyancy(
            equation_of_state=p.LinearEquationOfState()),
        coriolis=c.HydrostaticSphericalCoriolis(),
        free_surface=h.SplitExplicitFreeSurface(substeps=30)), ("T", "S"),
        60.0, 3, True, "auto"),
    "pole_to_pole": (POLE_TO_POLE, lambda p, h, c: dict(
        momentum_advection=h.VectorInvariant(),
        coriolis=c.HydrostaticSphericalCoriolis()), ("T",), 600.0, 4, False,
        "auto"),
    "mixed_orders_fused": (NEAR_GLOBAL, lambda p, h, c: dict(
        momentum_advection=mixed(p, h), tracer_advection=p.WENO(5),
        coriolis=c.HydrostaticSphericalCoriolis()), ("T",), 600.0, 3, True,
        True),
}

INITIAL = {
    "u": lambda lam, phi, z: 0.1 * jnp.sin(jnp.deg2rad(lam) + 0.5)
    * jnp.cos(np.pi * phi / 160.0 + 0.2) + 0.01,
    "v": lambda lam, phi, z: 0.05 * jnp.cos(jnp.deg2rad(lam) + 0.3)
    * jnp.sin(np.pi * phi / 160.0),
    "eta": lambda lam, phi: 0.1 * jnp.exp(-((lam - 180.0) / 40.0) ** 2
                                          - (phi / 20.0) ** 2),
    "T": lambda lam, phi, z: 20.0 + 8e-4 * z - 0.05 * jnp.abs(phi),
    "S": lambda lam, phi, z: 35.0 + 1e-3 * phi + 0 * z,
    "b": lambda lam, phi, z: 1e-5 * z + 1e-4 * jnp.exp(-(phi / 20.0) ** 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_latlon_model_matches_jax(case):
    grid_kw, model_kw, tracers, dt, steps, eager, fused = CASES[case]
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **grid_kw)
    tg = ot.LatitudeLongitudeGrid(dtype=torch.float64, **grid_kw)
    jmodel = jhyd.HydrostaticFreeSurfaceModel(
        grid=jg, tracers=tuple(t for t in tracers if t != "b"),
        **model_kw(oj, jhyd, jcor))
    tmodel = ot.HydrostaticFreeSurfaceModel(
        grid=tg, tracers=tuple(t for t in tracers if t != "b"),
        fused_kernels=fused, **model_kw(ot, ot.models.hydrostatic, ot))
    names = tmodel.tracer_names
    assert names == jmodel.tracer_names
    if fused is True:
        assert tmodel.fused_kernels and tmodel.fused_tracer
    state = jmodel.initial_state(
        **{k: INITIAL[k] for k in ("u", "v", "eta", *names)})
    ts = state_from_numpy(tmodel, jax_state_arrays(state, names))
    step = ((lambda s: jmodel.step(s, dt)) if eager
            else jax.jit(lambda s: jmodel.step(s, dt)))
    js = state
    for _ in range(steps):
        ts = tmodel.step(ts, dt)
        js = step(js)
        assert_states_close(tg, ts, js, names)
    assert float(np.abs(ts.u.numpy()).max()) > 0


def test_global_gravity_wave_conserves_volume_as_jax():
    """The JAX package's global lat-lon gravity wave (spherical Coriolis,
    vector-invariant momentum, split-explicit free surface, a Gaussian η
    bump), at half its resolution: 10 steps of 600 s, volume conserved to
    1e-12 of Σ|η|·Az, and the fields at the end as the JAX package's."""
    from oceananigans_torch.profile_step import volume_drift
    kw = dict(size=(30, 20, 4), longitude=(0.0, 360.0),
              latitude=(-60.0, 60.0), z=(-1000.0, 0.0))
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=torch.float64, **kw)

    def build(pkg, hyd, cor, grid):
        return hyd.HydrostaticFreeSurfaceModel(
            grid=grid, tracers=("b",), buoyancy=pkg.BuoyancyTracer(),
            coriolis=cor.HydrostaticSphericalCoriolis(),
            momentum_advection=hyd.VectorInvariant(),
            free_surface=hyd.SplitExplicitFreeSurface(substeps=30))

    jmodel = build(oj, jhyd, jcor, jg)
    tmodel = build(ot, ot.models.hydrostatic, ot, tg)
    js = jmodel.initial_state(
        b=lambda lam, phi, z: 1e-5 * z + 1e-4 * jnp.exp(-(phi / 20.0) ** 2),
        eta=lambda lam, phi: 0.1 * jnp.exp(-((lam - 180) / 30) ** 2
                                           - (phi / 15) ** 2))
    ts = state_from_numpy(tmodel, jax_state_arrays(js, ("b",)))
    eta0 = ts.eta.clone()
    step = jax.jit(lambda s: jmodel.step(s, 600.0))
    for _ in range(10):
        js = step(js)
        ts = tmodel.step(ts, 600.0)
    assert volume_drift(tmodel, eta0, ts.eta) < 1e-12
    assert float(ts.eta[tg.interior_slices[:2]].abs().max()) < 0.1
    assert_states_close(tg, ts, js, ("b",))
