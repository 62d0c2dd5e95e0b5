"""oceananigans_torch's nonhydrostatic model with each closure of
``closures.py``, open boundaries and valued, gradient, time-dependent and
field-dependent boundary conditions, against the JAX package on the CPU in
float64: the port's kernel code paths (their plain versions on the CPU)
against the eager JAX step, 2 or 3 steps from the same state, to 1e-12 of
the largest value of each field (``test_torch_closure_models.run_both``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from test_torch_closure_models import AB2, grids, run_both


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


def small_nonhydrostatic(closure, timestepper=AB2, advection="Centered",
                         bcs=None, topology=("Periodic", "Periodic",
                                             "Bounded"), halo=2):
    kw = dict(size=(8, 6, 8), extent=(1.0, 1.0, 1.0),
              topology=tuple(getattr(oj, t) for t in topology), halo=halo)
    jg, tg = grids(**kw)

    def build(pkg, grid, **extra):
        return pkg.NonhydrostaticModel(
            grid=grid, advection=getattr(pkg, advection)(),
            buoyancy=pkg.BuoyancyTracer(), closure=closure(pkg),
            boundary_conditions=bcs(pkg) if bcs else None,
            timestepper=timestepper, **extra)

    return build(oj, jg, fused_kernels=False), build(ot, tg,
                                                     fused_kernels=True)


def unstable_state(jmodel):
    return jmodel.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x) * jnp.cos(np.pi * z),
        v=lambda x, y, z: 0.05 * jnp.cos(2 * np.pi * y) + 0 * x,
        b=lambda x, y, z: 0.01 * z ** 2 + 1e-3 * jnp.sin(2 * np.pi * x)
        * jnp.sin(3 * np.pi * z))


CLOSURES = {
    "convective_adjustment": lambda p: (
        p.ConvectiveAdjustmentVerticalDiffusivity(
            convective_kappa_z=1.0, convective_nu_z=0.1,
            background_kappa_z=1e-4, background_nu_z=1e-4)),
    "implicit_scalar": lambda p: p.ScalarDiffusivity(
        nu=1e-3, kappa={"b": 2e-3}, time_discretization=(
            p.VerticallyImplicitTimeDiscretization)),
    "biharmonic": lambda p: p.ScalarBiharmonicDiffusivity(nu=1e-6,
                                                          kappa=1e-6),
    "horizontal_biharmonic": lambda p: (
        p.HorizontalScalarBiharmonicDiffusivity(nu=1e-6, kappa=1e-6)),
    "vertical_biharmonic": lambda p: p.VerticalScalarBiharmonicDiffusivity(
        nu=1e-6, kappa=1e-6),
    "smagorinsky_lilly_coefficient": lambda p: p.Smagorinsky(
        coefficient=p.LillyCoefficient(smagorinsky=0.2,
                                       reduction_factor=0.5)),
    "dynamic_coefficient": lambda p: p.Smagorinsky(
        coefficient=p.DynamicCoefficient(averaging=(0, 1))),
    "tuple": lambda p: (p.HorizontalScalarDiffusivity(nu=1e-3, kappa=1e-3),
                        p.VerticalScalarDiffusivity(nu=1e-4, kappa=1e-4)),
}


@pytest.mark.parametrize("timestepper", [AB2, "RungeKutta3"])
@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_closure_models_match_jax(name, timestepper):
    """Each closure in a small nonhydrostatic model (BuoyancyTracer with an
    unstable top layer, Centered(2)), 2 steps."""
    jmodel, tmodel, = small_nonhydrostatic(CLOSURES[name], timestepper)
    run_both(jmodel, tmodel, unstable_state(jmodel), 1e-2, 2, eager=True)


def test_array_and_callable_coefficients_match_jax():
    """ScalarDiffusivity with an array ν and a callable κ(x, y, z)."""
    nu = 1e-3 * (1.0 + np.random.default_rng(1).random((12, 10, 12)))

    def closure(p):
        mod = jnp if p is oj else torch
        return p.ScalarDiffusivity(
            nu=nu, kappa=lambda x, y, z: 1e-3 * (1.5 + mod.sin(x) + 0 * y
                                                 + 0 * z))

    jmodel, tmodel = small_nonhydrostatic(closure)
    run_both(jmodel, tmodel, unstable_state(jmodel), 1e-2, 2, eager=True)


OPEN = {
    "flat_extrapolation": lambda p: p.FlatExtrapolationOpenBC(),
    "perturbation_advection": lambda p: p.PerturbationAdvectionOpenBC(
        0.1, inflow_timescale=0.05, outflow_timescale=1.0),
}


@pytest.mark.parametrize("east", sorted(OPEN))
def test_open_channel_matches_jax(east):
    """A channel along a Bounded x: inflow through an OpenBC with a value
    on the west, and a flat-extrapolation or radiation condition on the
    east; a ScalarDiffusivity; RK3 (the radiation condition reads the last
    Δt)."""
    def bcs(p):
        return {"u": p.FieldBoundaryConditions(west=p.OpenBC(0.1),
                                               east=OPEN[east](p))}

    jmodel, tmodel = small_nonhydrostatic(
        lambda p: p.ScalarDiffusivity(nu=1e-3, kappa=1e-3), "RungeKutta3",
        bcs=bcs, topology=("Bounded", "Periodic", "Bounded"))
    state = jmodel.initial_state(
        u=lambda x, y, z: 0.1 + 0.01 * jnp.sin(np.pi * z) + 0 * x + 0 * y,
        b=lambda x, y, z: 0.01 * z + 0 * x)
    run_both(jmodel, tmodel, state, 1e-2, 3, eager=True)


def test_value_and_field_dependent_fluxes_match_jax():
    """A moving lid on u's top (ValueBC), a quadratic bottom drag on u that
    depends on u (``field_dependencies``), a time-dependent b flux and a
    gradient condition, under RK3 (stage times). (The JAX model evaluates
    every top flux of u, v and b without fields for its closures, so a
    field-dependent flux goes on the bottom.)"""
    def bcs(p):
        mod = jnp if p is oj else torch
        return {
            "u": p.FieldBoundaryConditions(
                top=p.ValueBC(0.05),
                bottom=p.FluxBC(lambda x, y, t, u: 1e-3 * u * mod.abs(u),
                                field_dependencies="u")),
            "b": p.FieldBoundaryConditions(
                top=p.FluxBC(lambda x, y, t: 1e-4 * mod.cos(2 * np.pi * x)
                             * (1.0 + t) + 0 * y),
                bottom=p.GradientBC(0.02))}

    jmodel, tmodel = small_nonhydrostatic(
        lambda p: p.ScalarDiffusivity(nu=1e-3, kappa=1e-3), "RungeKutta3",
        bcs=bcs)
    assert not tmodel.fused_ab2_science
    run_both(jmodel, tmodel, unstable_state(jmodel), 1e-2, 3, eager=True)
