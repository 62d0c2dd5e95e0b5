"""oceananigans_torch Coriolis, buoyancy and the nonhydrostatic model with
tracers, against the JAX package, in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages; model
runs start from the JAX package's projected initial state, carried across
with ``oceananigans_torch.interop``. The port runs its fused code paths
(``fused_kernels=True``: on the CPU, the kernels' plain versions) and is
held to the JAX XLA path at 1e-12 of each field's largest value: both
evaluate the same formulas up to rounding (the fused AB2 update forms
a·G + b·G⁻ where the XLA path forms Δt·(c₁G + c₂G⁻)). The thermal bubble
golden data is held at atol 1e-12, as the JAX package holds it. A
buoyancy formulation and a Coriolis object of neither package, duck-typed
as the JAX models take them, step all three models of both packages alike
and leave the gates deciding alike.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import buoyancy as t_buoy, coriolis as t_cor
from oceananigans_torch.interop import (
    FIELDS, state_from_numpy, state_to_numpy, tracer_keys,
)
from oceananigans_tpu import buoyancy as j_buoy, coriolis as j_cor
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.models import NonhydrostaticModel as JModel

F64 = torch.float64
RTOL = 1e-12
AB2 = "QuasiAdamsBashforth2"
RK3 = "RungeKutta3"
BPP = (oj.Bounded, oj.Periodic, oj.Periodic)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "thermal_bubble.npz"


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


def fields(size=(6, 8, 5), halo=(1, 1, 1), topology=BPP, seed=0):
    """Both grids and halo-filled u, v, w and tracers T, S, b."""
    kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=topology,
              halo=halo)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, loc in (("u", oj.LOC_U), ("v", oj.LOC_V), ("w", oj.LOC_W),
                      ("T", oj.LOC_C), ("S", oj.LOC_C), ("b", oj.LOC_C)):
        a = rng.standard_normal(tg.shape)
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = j_fill(jnp.asarray(a), jg, bcs, loc)
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=loc)
    return jg, tg, j, t


def assert_close(tg, got, ref, rtol=RTOL):
    ii = tg.interior_slices
    got = np.broadcast_to(got.detach().cpu().numpy(), tg.shape)[ii]
    ref = np.broadcast_to(np.asarray(ref), tg.shape)[ii]
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# Coriolis and buoyancy terms
# ---------------------------------------------------------------------------

CORIOLIS = {
    "fplane": lambda m: m.FPlane(f=1e-4),
    "fplane_latitude": lambda m: m.FPlane(latitude=45.0),
    "constant_cartesian": lambda m: m.ConstantCartesianCoriolis(latitude=30),
    "beta_plane": lambda m: m.BetaPlane(f0=1e-4, beta=1e-11),
    "non_traditional": lambda m: m.NonTraditionalBetaPlane(latitude=40.0),
}


@pytest.mark.parametrize("name", sorted(CORIOLIS))
def test_coriolis_matches(name):
    jg, tg, j, t = fields(seed=1)
    jc, tc = CORIOLIS[name](j_cor), CORIOLIS[name](t_cor)
    assert repr(tc) == repr(jc)
    for comp in ("x_f_cross_U", "y_f_cross_U", "z_f_cross_U"):
        got = getattr(tc, comp)(tg, t["u"], t["v"], t["w"])
        ref = getattr(jc, comp)(jg, j["u"], j["v"], j["w"])
        assert_close(tg, got, ref)


BUOYANCY = {
    "tracer": lambda m: m.BuoyancyTracer(),
    "linear": lambda m: m.SeawaterBuoyancy(
        equation_of_state=m.LinearEquationOfState(2e-4, 8e-4)),
    "teos10": lambda m: m.SeawaterBuoyancy(
        equation_of_state=m.TEOS10EquationOfState()),
    "constant_salinity": lambda m: m.SeawaterBuoyancy(constant_salinity=35),
    "tilted": lambda m: m.BuoyancyForce(m.BuoyancyTracer(),
                                        gravity_unit_vector=(0.3, -0.1,
                                                             -0.9)),
}


@pytest.mark.parametrize("name", sorted(BUOYANCY))
def test_buoyancy_matches(name):
    jg, tg, j, t = fields(seed=2)
    jb = j_buoy.regularize_buoyancy(BUOYANCY[name](j_buoy))
    tb = t_buoy.regularize_buoyancy(BUOYANCY[name](t_buoy))
    assert tb.required_tracers == jb.required_tracers
    assert repr(tb) == repr(jb)
    jt = {n: j[n] for n in ("T", "S", "b")}
    tt = {n: t[n] for n in ("T", "S", "b")}
    for comp in ("x_contribution", "y_contribution", "z_contribution"):
        got = getattr(tb, comp)(tg, tt)
        ref = getattr(jb, comp)(jg, jt)
        assert (got is None) == (ref is None), comp
        if got is not None:
            assert_close(tg, got, ref)
    assert_close(tg, t_buoy.buoyancy_frequency(tg, tb, tt),
                 j_buoy.buoyancy_frequency(jg, jb, jt))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

#: the model configurations, as keyword builders for either package
CONFIGS = {
    "weno_mom": lambda m: dict(advection=m.WENO(5)),
    "weno": lambda m: dict(advection=m.WENO(5), tracers=("T", "S")),
    "weno_science": lambda m: dict(
        advection=m.WENO(5), coriolis=m.FPlane(f=1e-2),
        buoyancy=m.BuoyancyTracer(), tracers=("b", "c")),
    "science": lambda m: dict(coriolis=m.FPlane(f=1e-2),
                              buoyancy=m.BuoyancyTracer(),
                              tracers=("b", "c")),
}
#: the port's fused route for each configuration under AB2
ROUTES = {"weno_mom": "fused_ab2_weno", "weno": "fused_ab2_weno_science",
          "weno_science": "fused_ab2_weno_science",
          "science": "fused_ab2_science"}


def model_grid_kwargs(config):
    halo = (1, 0, 0) if config == "science" else (3, 0, 0)
    return dict(size=(8, 8, 16), extent=(1.0, 1.0, 1.0), topology=BPP,
                halo=halo)


def jax_state_to_numpy(s):
    out = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    for group in ("tracers", "Gtracers"):
        for n, a in getattr(s, group).items():
            out[f"{group}/{n}"] = np.asarray(a)
    out.update(time=np.asarray(s.clock.time),
               iteration=int(s.clock.iteration),
               last_dt=np.asarray(s.clock.last_dt))
    return out


def run_jax(config, timestepper, steps, dt=1e-3):
    """The JAX XLA path from its projected initial state; returns the
    numpy arrays of the initial and the final state."""
    jg = oj.RectilinearGrid(dtype="float64", **model_grid_kwargs(config))
    jm = JModel(grid=jg, timestepper=timestepper, fused_kernels=False,
                **CONFIGS[config](oj))
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(jg.N)
            for n in ("u", "v", "w") + tuple(jm.tracer_names)}
    s = jm.initial_state(**init)
    start = jax_state_to_numpy(s)
    for _ in range(steps):
        s = jm.step(s, dt)
    return jm, start, jax_state_to_numpy(s)


def run_port(config, timestepper, arrays, steps, dt=1e-3):
    tg = ot.RectilinearGrid(dtype=F64, **model_grid_kwargs(config))
    tm = ot.NonhydrostaticModel(grid=tg, timestepper=timestepper,
                                fused_kernels=True, **CONFIGS[config](ot))
    s = tm.fill_state_halos(state_from_numpy(tm, arrays))
    for _ in range(steps):
        s = tm.step(s, dt, assume_filled=True)
    return tm, state_to_numpy(s)


@pytest.mark.parametrize("config,timestepper,steps", [
    ("weno_mom", AB2, 4), ("weno", AB2, 4), ("weno_science", AB2, 4),
    ("science", AB2, 4), ("weno", RK3, 2)])
def test_model_matches_xla(config, timestepper, steps):
    """4 AB2 steps through the plain versions of kernels 6, 8 and 5 (the
    Centered-2 science kernel), 2 RK3 steps through those of kernels 7 and
    9, against the JAX XLA path."""
    jm, start, ref = run_jax(config, timestepper, steps)
    tm, got = run_port(config, timestepper, start, steps)
    assert tm.tracer_names == jm.tracer_names
    if timestepper == AB2 and ROUTES[config]:
        assert getattr(tm, ROUTES[config])
    assert tm.fused_kernels == ("centered2" if config == "science"
                                else "weno5")
    names = FIELDS + tracer_keys(tm.tracer_names)
    assert set(got) >= set(names)
    for name in names:
        assert_close(tm.grid, torch.tensor(got[name]), ref[name])
    assert got["iteration"] == ref["iteration"]
    assert float(got["time"]) == float(ref["time"])


def test_thermal_bubble_golden():
    """The port reproduces ``tests/golden/thermal_bubble.npz``: 16³
    Centered-2 BuoyancyTracer bubble, 10 AB2 steps of Δt = 6."""
    grid = ot.RectilinearGrid(size=(16, 16, 16), extent=(100.0, 100.0, 100.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    model = ot.NonhydrostaticModel(grid=grid, advection=ot.Centered(2),
                                   tracers=("b",),
                                   buoyancy=ot.BuoyancyTracer(),
                                   timestepper=AB2)
    state = model.initial_state(
        b=lambda x, y, z: 0.01 * torch.exp(
            -((x - 50) ** 2 + (y - 50) ** 2 + (z + 50) ** 2) / 200.0))
    for _ in range(10):
        state = model.step(state, 6.0)
    got = {"u": state.u, "w": state.w, "b": state.tracers["b"]}
    with np.load(GOLDEN) as golden:
        assert sorted(golden.files) == sorted(got)
        for name in golden.files:
            np.testing.assert_allclose(grid.interior(got[name]).numpy(),
                                       golden[name], rtol=0, atol=1e-12,
                                       err_msg=name)


GATE_CONFIGS = {
    "default": lambda m: {},
    "weno_mom": CONFIGS["weno_mom"],
    "weno": CONFIGS["weno"],
    "weno_science": CONFIGS["weno_science"],
    "science": CONFIGS["science"],
    "weno7": lambda m: dict(advection=m.WENO(7)),
    "weno_beta_plane": lambda m: dict(advection=m.WENO(5),
                                      coriolis=m.BetaPlane(1e-4, 1e-11)),
    "weno_seawater": lambda m: dict(advection=m.WENO(5),
                                    buoyancy=m.SeawaterBuoyancy()),
}


@pytest.mark.parametrize("timestepper", [AB2, RK3])
@pytest.mark.parametrize("config", sorted(GATE_CONFIGS))
def test_gates_match_jax(config, timestepper):
    """At the aligned 16×16×128 layout, where the JAX gates' (8, 128)
    rules hold, the port picks its kernels as the JAX model does."""
    halo = (4, 0, 0) if config == "weno7" else (3, 0, 0)
    kw = dict(size=(16, 16, 128), extent=(1.0, 1.0, 1.0), topology=BPP,
              halo=halo)
    for fused in (True, False):
        jm = JModel(grid=oj.RectilinearGrid(dtype="float64", **kw),
                    timestepper=timestepper, fused_kernels=fused,
                    **GATE_CONFIGS[config](oj))
        tm = ot.NonhydrostaticModel(
            grid=ot.RectilinearGrid(dtype=F64, **kw),
            timestepper=timestepper, fused_kernels=fused,
            **GATE_CONFIGS[config](ot))
        assert tm.tracer_names == jm.tracer_names
        assert tm.fused_kernels == jm.fused_kernels
        for gate in ("fused_ab2", "fused_ab2_weno", "fused_ab2_science",
                     "fused_ab2_weno_science", "fused_tracer"):
            assert getattr(tm, gate) == getattr(jm, gate), gate


@pytest.mark.parametrize("timestepper,steps", [(AB2, 2), (RK3, 1)])
def test_weno7_tracers_take_the_tracer_kernel(timestepper, steps,
                                              monkeypatch):
    """WENO(7) tracers go through the any-order tracer kernel's route
    (``weno_tracer_tendencies``; on the CPU its plain version) as the JAX
    model's ``fused_tracer`` sends them through its Pallas kernel (here in
    interpret mode), and the two runs agree to 1e-12. The JAX model steps
    eagerly: compiling the interpreted kernel under ``jax.jit`` takes
    longer than stepping it (3x for the three RK3 stages)."""
    from oceananigans_torch.models import nonhydrostatic as t_nh
    calls = []
    kernel = t_nh.weno_tracer_tendencies

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(t_nh, "weno_tracer_tendencies", counted)
    kw = dict(size=(8, 8, 16), extent=(1.0, 1.0, 1.0), topology=BPP,
              halo=(4, 4, 4))
    config = dict(timestepper=timestepper, fused_kernels=True)
    jm = JModel(grid=oj.RectilinearGrid(dtype="float64", **kw),
                advection=oj.WENO(7), tracers=("T", "S"), **config)
    tm = ot.NonhydrostaticModel(grid=ot.RectilinearGrid(dtype=F64, **kw),
                                advection=ot.WENO(7), tracers=("T", "S"),
                                **config)
    assert jm.fused_tracer and tm.fused_tracer and not tm.fused_kernels
    rng = np.random.default_rng(4)
    s = jm.initial_state(**{n: rng.standard_normal(jm.grid.N)
                            for n in ("u", "v", "w", "T", "S")})
    st = tm.fill_state_halos(state_from_numpy(tm, jax_state_to_numpy(s)))
    for _ in range(steps):
        s = jm.step(s, 1e-3)
        st = tm.step(st, 1e-3, assume_filled=True)
    assert len(calls) == steps * (3 if timestepper == RK3 else 1)
    ref, got = jax_state_to_numpy(s), state_to_numpy(st)
    for name in FIELDS + tracer_keys(tm.tracer_names):
        assert_close(tm.grid, torch.tensor(got[name]), ref[name])


def test_unported_arguments_raise():
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              topology=BPP, halo=(3, 0, 0), dtype=F64)
    jgrid = oj.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                               topology=BPP, halo=(3, 0, 0), dtype="float64")
    # a buoyancy formulation without its tracers' names raises in both
    # packages' constructors alike; a Coriolis object is called only by the
    # step, so any object builds in both
    errors = []
    for pkg, g in ((oj, jgrid), (ot, grid)):
        with pytest.raises(AttributeError) as err:
            pkg.NonhydrostaticModel(grid=g, buoyancy=object())
        errors.append(str(err.value))
        pkg.NonhydrostaticModel(grid=g, coriolis=object())
    assert errors[0] == errors[1] and "required_tracers" in errors[0]
    with pytest.raises(TypeError):
        ot.NonhydrostaticModel(grid=grid, closure=object())
    # the physics of ROADMAP Queue 1 item 12 is ported: each builds
    for kw in (dict(forcing={"u": 1.0}), dict(background_fields={"u": 1.0}),
               dict(particles=ot.LagrangianParticles(0.5, 0.5, 0.5)),
               dict(stokes_drift=ot.UniformStokesDrift()),
               dict(biogeochemistry=ot.SimpleBiogeochemistry())):
        ot.NonhydrostaticModel(grid=grid, **kw)
    # spherical Coriolis is ported with the lat-lon grid: its terms there
    # match the JAX package's
    kw = dict(size=(8, 6, 3), longitude=(0.0, 360.0), latitude=(-60.0, 60.0),
              z=(-10.0, 0.0), halo=2)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    rng = np.random.default_rng(5)
    uvw = [rng.standard_normal(jg.shape) for _ in range(3)]
    jc, tc = (j_cor.HydrostaticSphericalCoriolis(),
              t_cor.HydrostaticSphericalCoriolis())
    for fn in ("x_f_cross_U", "y_f_cross_U"):
        ref = np.asarray(getattr(jc, fn)(jg, *map(jnp.asarray, uvw)))
        got = getattr(tc, fn)(tg, *map(torch.tensor, uvw)).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(ValueError):         # WENO(5) needs a halo of 3
        ot.NonhydrostaticModel(
            grid=ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                                    topology=BPP, halo=(1, 0, 0), dtype=F64),
            advection=ot.WENO(5))
    m = ot.NonhydrostaticModel(grid=grid, tracers="c",
                               buoyancy=ot.BuoyancyTracer())
    assert m.tracer_names == ("c", "b")


# ---------------------------------------------------------------------------
# Buoyancy formulations and Coriolis objects of neither package, duck-typed
# as the JAX models take them
# ---------------------------------------------------------------------------

def _operators(a):
    """The interpolation operators of the package whose array ``a`` is."""
    from oceananigans_torch.ops import operators as t_ops
    from oceananigans_tpu.ops import operators as j_ops
    return t_ops if isinstance(a, torch.Tensor) else j_ops


class DuckBuoyancy:
    """A nonlinear equation of state in T alone, b = 2e-3 (T − 10) − 5e-5
    (T − 10)², with nothing but ``required_tracers`` and ``buoyancy_ccc``."""

    required_tracers = ("T",)

    def buoyancy_ccc(self, grid, tracers):
        d = tracers["T"] - 10.0
        return 2e-3 * d - 5e-5 * d * d


class DuckCoriolis:
    """A β-plane f = 1e-4 + 1e-10 y with a constant horizontal component
    3e-5 about y, with nothing but the three ``*_f_cross_U`` methods."""

    f0, beta, fy = 1e-4, 1e-10, 3e-5

    def _f(self, grid):
        return self.f0 + self.beta * grid.yC

    def x_f_cross_U(self, grid, u, v, w):
        o = _operators(u)
        return (-o.ix_f(self._f(grid) * o.iy_c(v))
                + self.fy * o.ix_f(o.iz_c(w)))

    def y_f_cross_U(self, grid, u, v, w):
        o = _operators(u)
        return o.iy_f(self._f(grid) * o.ix_c(u))

    def z_f_cross_U(self, grid, u, v, w):
        o = _operators(u)
        return -self.fy * o.iz_f(o.ix_c(u))


def test_duck_typed_physics_steps_as_in_jax():
    """The duck-typed buoyancy and Coriolis objects build and step the
    nonhydrostatic and hydrostatic models (both objects) and the
    shallow-water model (the Coriolis object) in both packages, equal to
    1e-12 of each field's largest value after each of 3 steps in
    float64 (the JAX steps jitted: quicker than eager at these sizes)."""
    from test_torch_closure_models import grids, run_both
    from test_torch_forcings import jax_state_from
    from oceananigans_torch.interop import SW_FIELDS
    from test_torch_closure_models import jax_arrays as arrays_of
    physics = dict(buoyancy=DuckBuoyancy(), coriolis=DuckCoriolis())
    jg, tg = grids(size=(8, 8, 8), extent=(1e4, 1e4, 100.0),
                   topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=1)
    jm, tm = (pkg.NonhydrostaticModel(grid=g, timestepper=AB2, **physics,
                                      **kw)
              for pkg, g, kw in ((oj, jg, dict(fused_kernels=False)),
                                 (ot, tg, dict(fused_kernels=True))))
    assert tm.tracer_names == jm.tracer_names == ("T",)
    init = dict(u=lambda x, y, z: 0.1 * torch.sin(2 * np.pi * x / 1e4)
                * torch.cos(np.pi * z / 100.0),
                v=lambda x, y, z: 0.05 * torch.cos(2 * np.pi * y / 1e4)
                + 0 * x,
                T=lambda x, y, z: 10.0 + 0.05 * z + torch.sin(
                    2 * np.pi * x / 1e4) * torch.cos(np.pi * y / 1e4))
    run_both(jm, tm, jax_state_from(jm, tm.initial_state(**init)), 20.0, 3)

    jg, tg = grids(size=(8, 8, 4), extent=(1e5, 1e5, 400.0),
                   topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=1)
    jm, tm = (pkg.HydrostaticFreeSurfaceModel(
        grid=g, free_surface=pkg.SplitExplicitFreeSurface(substeps=8),
        **physics, **kw)
        for pkg, g, kw in ((oj, jg, dict(fused_kernels=False)),
                           (ot, tg, dict(fused_kernels=True))))
    assert tm.tracer_names == jm.tracer_names == ("T",)
    init = dict(u=lambda x, y, z: 0.1 * torch.sin(2 * np.pi * x / 1e5)
                + 0 * z,
                T=lambda x, y, z: 15.0 + 0.01 * z + 0.1 * torch.cos(
                    2 * np.pi * y / 1e5) + 0 * x,
                eta=lambda x, y: 0.05 * torch.sin(2 * np.pi * x / 1e5)
                + 0 * y)
    run_both(jm, tm, jax_state_from(jm, tm.initial_state(**init)), 300.0,
             3)

    kw = dict(size=(16, 12), extent=(1e6, 1e6),
              topology=(oj.Periodic, oj.Bounded, oj.Flat), halo=(2, 2, 0))
    jg, tg = grids(**kw)
    jm = oj.ShallowWaterModel(grid=jg, coriolis=DuckCoriolis())
    tm = ot.ShallowWaterModel(grid=tg, coriolis=DuckCoriolis(),
                              fused_kernels=True)
    js = jm.initial_state(h=lambda x, y, z: 100.0 + jnp.exp(
        -((x - 5e5) ** 2 + (y - 5e5) ** 2) / 1e10),
        uh=lambda x, y, z: 10.0 * jnp.cos(2 * np.pi * y / 1e6) + 0 * x)
    ts = state_from_numpy(tm, arrays_of(js, SW_FIELDS, ()))
    ii = tg.interior_slices
    step = jax.jit(lambda s: jm.step(s, 100.0))
    for _ in range(3):
        js = step(js)
        ts = tm.step(ts, 100.0)
        ref = arrays_of(js, SW_FIELDS, ())
        for k in ("uh", "vh", "h"):
            r = ref[k][ii]
            got = getattr(ts, k).numpy()[ii]
            assert np.abs(got - r).max() <= RTOL * np.abs(r).max(), k


def test_gates_match_jax_under_duck_typed_physics():
    """Under the duck-typed objects every gate decides as JAX's: the
    nonhydrostatic tendency kernels stay on and the fused AB2 kernels turn
    off (JAX's science kernels take only an ``FPlane`` and a
    ``BuoyancyTracer``), in both families, with the science configuration's
    tracers and without; the hydrostatic kernels as without them; the
    shallow-water stage kernel off."""
    from test_torch_forcings import GATES, gate_pair
    from test_torch_vi_tracer_kernels import latlon_grids
    from oceananigans_torch.ops.cuda_sw import sw_fused_available
    from oceananigans_tpu.ops.pallas_sw import (
        sw_fused_available as j_sw_fused_available,
    )
    physics = {"buoyancy": lambda p: DuckBuoyancy(),
               "coriolis": lambda p: DuckCoriolis()}
    for adv, halo in ((lambda p: p.Centered(2), 1),
                      (lambda p: p.WENO(5), 3)):
        for extra in (dict(coriolis=physics["coriolis"]), physics):
            for tracers in ((), ("c",)):
                jm, tm = gate_pair(adv, halo, tracers=tracers, **extra)
                for gate in GATES:
                    assert getattr(tm, gate) == getattr(jm, gate), gate
                assert tm.fused_kernels in ("centered2", "weno5")
                assert not any(getattr(tm, g) for g in GATES[1:5])
    jg, tg = latlon_grids()
    for fused in (True, False):
        jm, tm = (pkg.HydrostaticFreeSurfaceModel(
            grid=g, momentum_advection=hyd.WENOVectorInvariant(),
            tracer_advection=pkg.WENO(7), tracers=("c",),
            buoyancy=DuckBuoyancy(), coriolis=DuckCoriolis(),
            fused_kernels=fused)
            for pkg, hyd, g in ((oj, oj, jg), (ot, ot, tg)))
        assert tm.fused_kernels == jm.fused_kernels == fused
        assert tm.fused_tracer == jm.fused_tracer == fused
    kw = dict(size=(16, 128), extent=(1.0, 1.0),
              topology=(oj.Periodic, oj.Periodic, oj.Flat), halo=(8, 0, 0))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    for coriolis in (None, DuckCoriolis()):
        jm = oj.ShallowWaterModel(grid=jg, coriolis=coriolis)
        tm = ot.ShallowWaterModel(grid=tg, coriolis=coriolis,
                                  fused_kernels=True)
        assert sw_fused_available(tg, tm) == j_sw_fused_available(jg, jm) \
            == (coriolis is None)


def test_default_device_is_the_gpu():
    """The default device is "cuda"; a grid built without ``device=``
    lands on the card, and on a machine without one its construction
    raises rather than falling back to the CPU."""
    from oceananigans_torch.config import Config
    assert Config().device == "cuda"
    old = ot.config.device
    ot.config.device = Config().device
    try:
        make = lambda: ot.RectilinearGrid(  # noqa: E731
            size=(4, 4, 4), extent=(1.0, 1.0, 1.0))
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
    finally:
        ot.config.device = old


def test_interop_carries_tracers():
    jm, start, _ = run_jax("weno_science", AB2, 0)
    tg = ot.RectilinearGrid(dtype=F64, **model_grid_kwargs("weno_science"))
    tm = ot.NonhydrostaticModel(grid=tg, timestepper=AB2,
                                **CONFIGS["weno_science"](ot))
    s = state_from_numpy(tm, start)
    assert list(s.tracers) == list(tm.tracer_names) == ["b", "c"]
    back = state_to_numpy(s)
    for key in FIELDS + tracer_keys(tm.tracer_names):
        np.testing.assert_array_equal(back[key], start[key])
    with pytest.raises(KeyError):
        state_from_numpy(tm, {k: v for k, v in start.items()
                              if k != "tracers/c"})
