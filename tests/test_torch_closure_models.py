"""oceananigans_torch's models with closures and valued boundary conditions
against the JAX package, on the CPU in float64.

Each case builds its initial state in the JAX package, hands it to the port
as numpy arrays (``interop.state_from_numpy``) and steps both; the fields
agree to 1e-12 of the largest value of each field on its owned range (the
interior, plus the right wall face of a Bounded axis for the wall-normal
velocity). The port runs its kernel code paths (``fused_kernels=True``:
on the CPU the kernels' plain versions). The JAX step runs eagerly where a
case advects with WENO of order 7 or more on stratified fields, since
jitting it reorders XLA's evaluation by ~1e-12 (ROADMAP Queue 3, caveat 5).
``run_both`` also serves ``test_torch_closure_physics.py`` and
``test_torch_hydrostatic_closures.py``, whose small cases step JAX eagerly
because that is quicker than compiling them. Its JAX steps run the JAX
package's Thomas solve jitted (:func:`jitted_thomas`), which gives the
eager solve's bits.

Also here: the Rayleigh-Bénard golden of ``tests/test_regression.py``
through the port at the golden's 1e-12, and the dispatch gates: with a
closure or a valued flux condition the fused AB2 kernels (TPU kernels 1, 5,
6 and 8) do not run and the tendency kernels (2, 7, 9 and 11) still do.
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
import oceananigans_tpu.closures as jclosures
from oceananigans_torch.interop import (
    FIELDS, HYDROSTATIC_FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_torch.ops import cuda_sw
from oceananigans_tpu.solvers.tridiagonal import (
    tridiagonal_solve as eager_thomas,
)

RTOL = 1e-12
F64 = torch.float64
AB2 = "QuasiAdamsBashforth2"
GOLDEN = Path(__file__).parent / "golden" / "rayleigh_benard.npz"


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


#: the JAX package's batched Thomas solve under ``jax.jit``
JIT_THOMAS = jax.jit(eager_thomas, static_argnames="axis")


@contextlib.contextmanager
def jitted_thomas():
    """The JAX package's vertically implicit closures solve with
    :data:`JIT_THOMAS` while the block runs. Called eagerly, each solve
    traces and compiles its two ``lax.scan`` bodies anew; the bodies
    compile to the same loops either way, so the solve gives the eager
    solve's bits (``test_jitted_thomas_is_eager_thomas``) in a fraction of
    the time. Nothing in the JAX package changes."""
    jclosures.tridiagonal_solve = JIT_THOMAS
    try:
        yield
    finally:
        jclosures.tridiagonal_solve = eager_thomas


def jax_arrays(state, fields, names):
    """A JAX state as the numpy mapping of ``interop``."""
    out = {k: np.asarray(getattr(state, k)) for k in fields}
    for n in names:
        out[f"tracers/{n}"] = np.asarray(state.tracers[n])
        out[f"Gtracers/{n}"] = np.asarray(state.Gtracers[n])
    out["time"] = np.asarray(state.clock.time)
    out["iteration"] = np.asarray(state.clock.iteration)
    out["last_dt"] = np.asarray(state.clock.last_dt)
    return out


def owned(grid, key):
    """The owned range of ``key``: the interior, plus the right wall face of
    a Bounded axis for the velocity normal to it; (nx, ny, 1) fields over
    their whole z extent."""
    S = [slice(h, h + n) for h, n in zip(grid.H, grid.N)]
    axis = {"u": 0, "v": 1, "w": 2}.get(key)
    if axis is not None and grid.topology[axis] == ot.Bounded:
        S[axis] = slice(grid.H[axis], grid.H[axis] + grid.N[axis] + 1)
    if key in ("eta", "U", "V"):
        S[2] = slice(None)
    return tuple(S)


def assert_close(tg, got, ref, fields, names, rtol=RTOL, velocity_scale=0.0):
    """Each field of the port's state within ``rtol`` of its largest JAX
    value (u and v, and U and V, as pairs); the velocities within ``rtol``
    of ``velocity_scale`` where that is larger."""
    a = state_to_numpy(got)
    groups = [g for g in (("u", "v"), ("w",), ("eta",), ("U", "V"),
                          ("pressure",))
              if all(k in fields for k in g)]
    groups += [(f"tracers/{n}",) for n in names]
    for group in groups:
        pairs = [(a[k][owned(tg, k)], ref[k][owned(tg, k)]) for k in group]
        scale = max(np.abs(y).max() for _, y in pairs)
        if group in (("u", "v"), ("w",)):
            scale = max(scale, velocity_scale)
        err = max(np.abs(x - y).max() for x, y in pairs)
        assert err <= rtol * scale, (group, err, scale)
    assert got.clock.iteration == int(ref["iteration"])
    assert float(got.clock.time) == pytest.approx(float(ref["time"]),
                                                  rel=1e-15)


def balance_scale(tg, arrays, dt):
    """Δt·max|∂z p|: the velocity that the projection's pressure gradient
    removes against the buoyancy each step. In a stratified state at rest
    the velocities are its small residual, so their rounding is relative to
    it (one ulp of the FFT solve's pressure is ~2e-12 of the LES's
    max|u|)."""
    p = arrays["pressure"][tg.interior_slices]
    return dt * np.abs(np.diff(p, axis=2)).max() / tg.spacing(2)


def run_both(jmodel, tmodel, jstate, dt, steps, eager=False,
             balanced=False):
    """Step both models from the JAX state and compare after every step;
    ``balanced``: hold the velocities to :func:`balance_scale` where it is
    larger than their own."""
    names = tmodel.tracer_names
    fields = (HYDROSTATIC_FIELDS
              if isinstance(tmodel, ot.HydrostaticFreeSurfaceModel)
              else FIELDS)
    ts = state_from_numpy(tmodel, jax_arrays(jstate, fields, names))
    step = ((lambda s: jmodel.step(s, dt)) if eager
            else jax.jit(lambda s: jmodel.step(s, dt)))
    js = jstate
    for _ in range(steps):
        ts = tmodel.step(ts, dt)
        with jitted_thomas():
            js = step(js)
        ref = jax_arrays(js, fields, names)
        vs = balance_scale(tmodel.grid, ref, dt) if balanced else 0.0
        assert_close(tmodel.grid, ts, ref, fields, names, velocity_scale=vs)
    return tmodel, ts


def grids(**kw):
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


@pytest.mark.parametrize("axis", [-1, 0])
def test_jitted_thomas_is_eager_thomas(axis):
    """:func:`jitted_thomas`'s premise: the jitted Thomas solve gives the
    eager one's bits, on a seeded diagonally dominant system along either
    end axis."""
    rng = np.random.default_rng(5)
    shape = (6, 5, 9)
    a, c = (jnp.asarray(-rng.random(shape)) for _ in range(2))
    b = jnp.asarray(2.5 + rng.random(shape))
    d = jnp.asarray(rng.standard_normal(shape))
    np.testing.assert_array_equal(
        np.asarray(JIT_THOMAS(a, b, c, d, axis=axis)),
        np.asarray(eager_thomas(a, b, c, d, axis=axis)))


# ---------------------------------------------------------------------------
# The Rayleigh-Bénard golden
# ---------------------------------------------------------------------------

def test_rayleigh_benard_golden():
    """``tests/test_regression.py``'s Rayleigh-Bénard setup (WENO(5),
    BuoyancyTracer, ScalarDiffusivity, ValueBC top and bottom on a Flat y,
    RK3) through the port: 10 steps held to the golden at atol 1e-12."""
    grid = ot.RectilinearGrid(size=(24, 24), x=(0.0, 2.0), z=(0.0, 1.0),
                              topology=(ot.Periodic, ot.Flat, ot.Bounded),
                              dtype=F64)
    model = ot.NonhydrostaticModel(
        grid=grid, advection=ot.WENO(5), tracers=("b",),
        buoyancy=ot.BuoyancyTracer(),
        closure=ot.ScalarDiffusivity(nu=1e-2, kappa=1e-2),
        boundary_conditions={"b": ot.FieldBoundaryConditions(
            bottom=ot.ValueBC(1.0), top=ot.ValueBC(0.0))})
    state = model.initial_state(
        b=lambda x, y, z: 1.0 - z + 0.01 * torch.sin(7 * x)
        * torch.sin(5 * z))
    for _ in range(10):
        state = model.step(state, 0.01)
    got = {"u": state.u, "w": state.w, "b": state.tracers["b"]}
    with np.load(GOLDEN) as golden:
        assert sorted(golden.files) == sorted(got)
        for name in golden.files:
            np.testing.assert_allclose(grid.interior(got[name]).numpy(),
                                       golden[name], rtol=0, atol=1e-12,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# The wind-mixing LES (chip_smoke.py phase 12) at 16³
# ---------------------------------------------------------------------------

QT = 200.0 / (1026.0 * 3991.0)


def les_models(timestepper=AB2, closure="SmagorinskyLilly", N=16):
    kw = dict(size=(N, N, N), x=(0.0, 64.0), y=(0.0, 64.0), z=(-32.0, 0.0),
              topology=(oj.Periodic, oj.Periodic, oj.Bounded),
              halo=(3, 3, 3))
    jg, tg = grids(**kw)

    def build(pkg, grid, **extra):
        return pkg.NonhydrostaticModel(
            grid=grid, advection=pkg.WENO(5),
            buoyancy=pkg.SeawaterBuoyancy(
                equation_of_state=pkg.LinearEquationOfState(
                    thermal_expansion=2e-4), constant_salinity=35.0),
            closure=getattr(pkg, closure)(),
            boundary_conditions={
                "T": pkg.FieldBoundaryConditions(top=pkg.FluxBC(QT),
                                                 bottom=pkg.GradientBC(0.01)),
                "u": pkg.FieldBoundaryConditions(top=pkg.FluxBC(6.2e-5))},
            timestepper=timestepper, **extra)

    jmodel = build(oj, jg, fused_kernels=False)
    tmodel = build(ot, tg, fused_kernels=True)
    rng = np.random.default_rng(0)
    jstate = jmodel.initial_state(
        T=lambda x, y, z: 20.0 + 0.01 * z,
        u=1e-4 * rng.standard_normal((N, N, N)))
    return jmodel, tmodel, jstate


@pytest.mark.parametrize("timestepper", [AB2, "RungeKutta3"])
def test_les_matches_jax(timestepper):
    """Phase 12's configuration at 16³: the WENO-5 tendency kernels'
    code path (no fused AB2 kernel: the closure and the flux conditions
    turn those off), SmagorinskyLilly, the T flux and gradient conditions
    and the u stress, 3 steps of Δt = 1 s."""
    jmodel, tmodel, jstate = les_models(timestepper)
    assert tmodel.fused_kernels == "weno5"
    assert not (tmodel.fused_ab2_weno or tmodel.fused_ab2_weno_science)
    _, ts = run_both(jmodel, tmodel, jstate, 1.0, 3, balanced=True)
    # the surface cooling has reached the top cells
    T = tmodel.grid.interior(ts.tracers["T"])
    assert float(T[:, :, -1].mean()) < float(20.0 + 0.01 * -1.0)


@pytest.mark.parametrize("closure", ["DynamicSmagorinsky",
                                     "AnisotropicMinimumDissipation"])
def test_les_closures_match_jax(closure):
    """The other LES closures in phase 12's configuration at 8³."""
    jmodel, tmodel, jstate = les_models(closure=closure, N=8)
    run_both(jmodel, tmodel, jstate, 1.0, 2, balanced=True)


def test_les_plain_path_matches_jax():
    """The plain path (no kernel code path) of phase 12's configuration."""
    jmodel, _, jstate = les_models()
    _, tg = grids(size=(16, 16, 16), x=(0.0, 64.0), y=(0.0, 64.0),
                  z=(-32.0, 0.0),
                  topology=(oj.Periodic, oj.Periodic, oj.Bounded),
                  halo=(3, 3, 3))
    tmodel = ot.NonhydrostaticModel(
        grid=tg, advection=ot.WENO(5),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState(
                thermal_expansion=2e-4), constant_salinity=35.0),
        closure=ot.SmagorinskyLilly(),
        boundary_conditions={
            "T": ot.FieldBoundaryConditions(top=ot.FluxBC(QT),
                                            bottom=ot.GradientBC(0.01)),
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(6.2e-5))},
        timestepper=AB2, fused_kernels=False)
    assert tmodel.fused_kernels is False
    run_both(jmodel, tmodel, jstate, 1.0, 2, balanced=True)


# ---------------------------------------------------------------------------
# hydro_vi with closures and wind stress (chip_smoke.py phase 13)
# ---------------------------------------------------------------------------

def hydro_closure_models(size=(24, 12, 6), substeps=30):
    kw = dict(size=size, extent=(4e7, 2e7, 4e3),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded),
              halo=(6, 6, 4))
    jg, tg = grids(**kw)
    rng = np.random.default_rng(0)
    flux = np.zeros(tuple(tg.shape[:2]) + (1,))
    flux[6:-6, 6:-6, 0] = 1e-5 * rng.standard_normal(size[:2])

    def build(pkg, grid, np_like, **extra):
        def stress(x, y, t):
            return -1e-4 * np_like.cos(np.pi * y / 2e7)
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=pkg.WENOVectorInvariant(),
            tracer_advection=pkg.WENO(7), tracers=("T", "S"),
            free_surface=pkg.SplitExplicitFreeSurface(substeps=substeps),
            closure=(pkg.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                     pkg.VerticalScalarDiffusivity(
                         nu=1e-3, kappa=1e-5,
                         time_discretization=(
                             pkg.VerticallyImplicitTimeDiscretization))),
            boundary_conditions={
                "u": pkg.FieldBoundaryConditions(top=pkg.FluxBC(stress)),
                "T": pkg.FieldBoundaryConditions(top=pkg.FluxBC(flux))},
            **extra)

    jmodel = build(oj, jg, jnp, fused_kernels=False)
    tmodel = build(ot, tg, torch, fused_kernels=True)
    jstate = jmodel.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 4e7)
        * jnp.cos(np.pi * y / 2e7),
        T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
        S=lambda x, y, z: 35.0 + 1e-8 * y)
    return jmodel, tmodel, jstate


def test_hydro_closure_matches_jax():
    """Phase 13's configuration at (24, 12, 6): the vector-invariant and
    WENO(7) tracer kernels' code paths with the horizontal closure, the
    implicit vertical one, the callable wind stress and the array T flux;
    2 steps of Δt = 60 s against the eager JAX step."""
    jmodel, tmodel, jstate = hydro_closure_models()
    assert tmodel.fused_kernels and tmodel.fused_tracer
    run_both(jmodel, tmodel, jstate, 60.0, 2, eager=True)


# ---------------------------------------------------------------------------
# Dispatch gates
# ---------------------------------------------------------------------------

def gate_model(advection, halo, **kw):
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Bounded, ot.Periodic,
                                        ot.Periodic),
                              halo=(halo, 0, 0), dtype=F64)
    return ot.NonhydrostaticModel(grid=grid, advection=advection,
                                  timestepper=AB2, fused_kernels=True, **kw)


SCIENCE = dict(coriolis=ot.FPlane(f=1e-4), buoyancy=ot.BuoyancyTracer())
GATE_CASES = {
    "closure": dict(closure=ot.ScalarDiffusivity(nu=1e-3, kappa=1e-3)),
    "momentum_flux": dict(boundary_conditions={
        "u": ot.FieldBoundaryConditions(east=ot.FluxBC(1e-4))}),
    "w_flux": dict(boundary_conditions={
        "w": ot.FieldBoundaryConditions(west=ot.FluxBC(1e-4))}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("family", ["centered2", "weno5"])
def test_fused_ab2_gates(family, case):
    """With a closure or a valued flux condition, the fused AB2 kernels
    (``fused_ab2``, ``fused_ab2_weno``: TPU kernels 1 and 6) do not run;
    the tendency kernel family (2 or 7) still does."""
    adv, halo = ((ot.Centered(2), 1) if family == "centered2"
                 else (ot.WENO(5), 3))
    plain = gate_model(adv, halo)
    assert plain.fused_kernels == family
    assert plain.fused_ab2 or plain.fused_ab2_weno
    model = gate_model(adv, halo, **GATE_CASES[case])
    assert model.fused_kernels == family
    assert not (model.fused_ab2 or model.fused_ab2_weno
                or model.fused_ab2_science or model.fused_ab2_weno_science)


@pytest.mark.parametrize("case", sorted(GATE_CASES) + ["tracer_flux"])
@pytest.mark.parametrize("family", ["centered2", "weno5"])
def test_fused_science_gates(family, case):
    """The science kernels (TPU kernels 5 and 8) likewise; a valued flux
    on a tracer also turns them off, and the tracer tendency kernel (9)
    keeps running with the WENO-5 family."""
    adv, halo = ((ot.Centered(2), 1) if family == "centered2"
                 else (ot.WENO(5), 3))
    kw = dict(SCIENCE, **GATE_CASES.get(case, {}))
    if case == "tracer_flux":
        kw["boundary_conditions"] = {
            "b": ot.FieldBoundaryConditions(west=ot.FluxBC(1e-5))}
    assert (gate_model(adv, halo, **SCIENCE).fused_ab2_science
            or gate_model(adv, halo, **SCIENCE).fused_ab2_weno_science)
    model = gate_model(adv, halo, **kw)
    assert model.fused_kernels == family
    assert not (model.fused_ab2_science or model.fused_ab2_weno_science)


def test_gates_route_closure_model_through_tendency_kernels(monkeypatch):
    """A WENO-5 model with a closure computes its tendencies with kernels 7
    and 9 (their plain versions on the CPU) and no fused AB2 kernel."""
    from oceananigans_torch.models import nonhydrostatic as nh
    calls = []
    for name in ("weno5_momentum_tendency", "weno5_tracer_tendencies",
                 "weno5_ab2_update", "weno5_science_ab2_update"):
        fn = getattr(nh, name)
        monkeypatch.setattr(nh, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    model = gate_model(ot.WENO(5), 3, tracers=("c",),
                       closure=ot.SmagorinskyLilly(), **SCIENCE)
    state = model.initial_state(u=lambda x, y, z: torch.sin(6 * x) + 0 * y,
                                c=lambda x, y, z: torch.cos(4 * z) + 0 * x)
    model.step(state, 1e-3)
    assert calls == ["weno5_momentum_tendency", "weno5_tracer_tendencies"]


def test_hydrostatic_kernels_ignore_the_closure():
    """The hydrostatic kernel gates (11, 12/13) do not look at the closure
    or the boundary conditions, as in the JAX package."""
    _, tmodel, _ = hydro_closure_models()
    assert tmodel.fused_kernels and tmodel.fused_tracer


def test_shallow_water_stage_kernel_refuses_valued_flux():
    """The shallow-water stage kernel (TPU kernel 10) does not take a
    valued flux condition (``ops/cuda_sw.py``); without one it does."""
    grid = ot.RectilinearGrid(size=(16, 16), extent=(1.0, 1.0),
                              topology=(ot.Bounded, ot.Periodic, ot.Flat),
                              halo=(2, 0, 0), dtype=F64)
    assert cuda_sw.sw_fused_available(grid, ot.ShallowWaterModel(grid=grid))
    model = ot.ShallowWaterModel(
        grid=grid, boundary_conditions={
            "vh": ot.FieldBoundaryConditions(west=ot.FluxBC(1e-3))})
    assert not cuda_sw.sw_fused_available(grid, model)


def test_shallow_water_flux_matches_jax():
    """The plain shallow-water path with a valued flux on vh's west."""
    kw = dict(size=(12, 10), extent=(1.0, 1.0),
              topology=(oj.Bounded, oj.Periodic, oj.Flat), halo=(2, 0, 0))
    jg, tg = grids(**kw)

    def build(pkg, grid):
        return pkg.ShallowWaterModel(
            grid=grid, gravitational_acceleration=1.0,
            boundary_conditions={
                "vh": pkg.FieldBoundaryConditions(west=pkg.FluxBC(1e-3))})

    jmodel, tmodel = build(oj, jg), build(ot, tg)
    jstate = jmodel.initial_state(
        h=lambda x, y, z: 1.0 + 0.1 * jnp.exp(-((x - 0.5) ** 2) / 0.02)
        + 0 * y)
    from oceananigans_torch.interop import SW_FIELDS
    ts = state_from_numpy(tmodel, jax_arrays(jstate, SW_FIELDS, ()))
    js = jstate
    for _ in range(3):
        ts = tmodel.step(ts, 1e-3)
        js = jmodel.step(js, 1e-3)
    a, b = state_to_numpy(ts), jax_arrays(js, SW_FIELDS, ())
    ii = tg.interior_slices
    for k in ("uh", "vh", "h"):
        assert np.abs(a[k][ii] - b[k][ii]).max() <= RTOL * np.abs(
            b[k][ii]).max(), k


def test_unported_closures_raise_with_item():
    """Every closure is ported: the ocean closures (ROADMAP Queue 1 item
    15's first part) build in both models, and an object that is no
    closure raises a ``TypeError``."""
    grid = ot.RectilinearGrid(size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                              dtype=F64)
    for cls in (ot.RiBasedVerticalDiffusivity, ot.CATKEVerticalDiffusivity,
                ot.TKEDissipationVerticalDiffusivity,
                ot.LeithEnstrophyDiffusivity,
                ot.IsopycnalSkewSymmetricDiffusivity):
        ot.NonhydrostaticModel(grid=grid, closure=cls(),
                               buoyancy=ot.BuoyancyTracer())
        ot.HydrostaticFreeSurfaceModel(grid=grid, closure=cls(),
                                       buoyancy=ot.BuoyancyTracer())
    with pytest.raises(TypeError, match="AbstractClosure"):
        ot.NonhydrostaticModel(grid=grid, closure=object())
    with pytest.raises(TypeError, match="AbstractClosure"):
        ot.HydrostaticFreeSurfaceModel(grid=grid, closure=object())
    with pytest.raises(ValueError, match="halo"):
        ot.NonhydrostaticModel(
            grid=ot.RectilinearGrid(size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                                    halo=1, dtype=F64),
            closure=ot.ScalarBiharmonicDiffusivity(nu=1.0))


def test_wizard_diffusive_cfl_matches_jax():
    """``TimeStepWizard(diffusive_cfl=)`` meets the closure's finite
    timescale; the port's Δt after one actuation equals the JAX wizard's."""
    jmodel, tmodel, jstate = les_models(N=8)
    ts = state_from_numpy(tmodel, jax_arrays(jstate, FIELDS, ("T",)))
    tau_t = float(tmodel.diffusion_timescale(ts))
    tau_j = float(jmodel.diffusion_timescale(jstate))
    assert np.isfinite(tau_t)
    assert tau_t == pytest.approx(tau_j, rel=1e-12)
    dts = []
    for pkg, model, state in ((oj, jmodel, jstate), (ot, tmodel, ts)):
        sim = pkg.Simulation(model, state=state, dt=1e-6, stop_iteration=1)
        wizard = pkg.TimeStepWizard(cfl=1e4, diffusive_cfl=0.2,
                                    max_change=1e15, max_dt=1e15)
        wizard(sim)
        dts.append(float(sim.dt))
    assert dts[1] == pytest.approx(dts[0], rel=1e-12)
    assert dts[1] == pytest.approx(0.2 * tau_t, rel=1e-12)


def test_top_flux_values_match_jax():
    """The surface fluxes a closure may take: a number on the LES's u, a
    callable of (x, y, t) and none on v in phase 13's configuration."""
    from oceananigans_torch.boundary_conditions import top_flux_values
    for jmodel, tmodel in (les_models(N=8)[:2],
                           hydro_closure_models()[:2]):
        ref = jmodel._top_flux_values(0.5)
        got = top_flux_values(tmodel.bcs, tmodel.grid,
                              torch.tensor(0.5, dtype=F64))
        assert sorted(got) == sorted(ref) == ["u"]
        np.testing.assert_allclose(torch.as_tensor(got["u"], dtype=F64),
                                   np.asarray(ref["u"]), rtol=1e-15)
