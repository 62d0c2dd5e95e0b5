"""oceananigans_torch's HydrostaticFreeSurfaceModel with each closure of
``closures.py`` and valued boundary conditions, against the JAX package on
the CPU in float64.

A small (Periodic, Bounded, Bounded) basin with a BuoyancyTracer whose top
half is unstable (so the convective adjustment switches on), Centered(2)
tracers, the default VectorInvariant momentum advection and the explicit
free surface; a value and a gradient condition on b and a flux on v's top.
Each closure runs 2 steps from the same state in both packages (the JAX
step eagerly); the fields agree to 1e-12 of the largest value of each, and
the diffusion timescale of the constant-coefficient closures to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import HYDROSTATIC_FIELDS, state_from_numpy
from test_torch_closure_models import grids, jax_arrays, run_both


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


CLOSURES = {
    "scalar": lambda p: p.ScalarDiffusivity(nu=1e2, kappa={"b": 50.0}),
    "vertical_implicit": lambda p: p.VerticalScalarDiffusivity(
        nu=1e-2, kappa=1e-2,
        time_discretization=p.VerticallyImplicitTimeDiscretization),
    "horizontal_biharmonic": lambda p: (
        p.HorizontalScalarBiharmonicDiffusivity(nu=1e6, kappa=1e6)),
    "smagorinsky": lambda p: p.SmagorinskyLilly(),
    "dynamic": lambda p: p.DynamicSmagorinsky(),
    "amd": lambda p: p.AnisotropicMinimumDissipation(),
    "convective": lambda p: p.ConvectiveAdjustmentVerticalDiffusivity(
        convective_kappa_z=0.5, convective_nu_z=0.1,
        background_kappa_z=1e-5, background_nu_z=1e-4),
}


#: the closures whose largest diffusivity is set by their coefficients (the
#: LES closures' is rounding-level in this nearly resting state)
CONSTANT = ("scalar", "vertical_implicit", "horizontal_biharmonic",
            "convective")


@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_hydrostatic_closures_match_jax(name):
    jg, tg = grids(size=(12, 10, 6), extent=(1e5, 1e5, 1e3),
                   topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=3)

    def build(pkg, grid, **kw):
        mod = jnp if pkg is oj else torch
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, tracer_advection=pkg.Centered(2), tracers=("b",),
            buoyancy=pkg.BuoyancyTracer(),
            free_surface=pkg.ExplicitFreeSurface(
                gravitational_acceleration=0.1),
            closure=CLOSURES[name](pkg),
            boundary_conditions={
                "b": pkg.FieldBoundaryConditions(top=pkg.ValueBC(1e-3),
                                                 bottom=pkg.GradientBC(1e-6)),
                "v": pkg.FieldBoundaryConditions(top=pkg.FluxBC(
                    lambda x, y, t: 1e-5 * mod.sin(2 * np.pi * x / 1e5)
                    + 0 * y))},
            **kw)

    jmodel, tmodel = build(oj, jg), build(ot, tg, fused_kernels=True)
    jstate = jmodel.initial_state(
        u=lambda x, y, z: 0.05 * jnp.sin(2 * np.pi * x / 1e5)
        * jnp.cos(np.pi * y / 1e5),
        v=lambda x, y, z: 0.02 * jnp.cos(2 * np.pi * x / 1e5) + 0 * z,
        b=lambda x, y, z: 1e-3 * (1.0 + z / 1e3) ** 2
        + 1e-5 * jnp.sin(2 * np.pi * x / 1e5) + 0 * y)
    if name in CONSTANT:
        ts = state_from_numpy(tmodel, jax_arrays(
            jstate, HYDROSTATIC_FIELDS, ("b",)))
        tau = float(tmodel.diffusion_timescale(ts))
        assert tau == pytest.approx(
            float(jmodel.diffusion_timescale(jstate)), rel=1e-12)
    run_both(jmodel, tmodel, jstate, 20.0, 2, eager=True)
