"""oceananigans_torch's forcings, background fields, Stokes drift,
biogeochemistry and auxiliary fields against the JAX package, on the CPU in
float64.

Each case builds both packages' models with the same configuration (each
package's callables written with its own array functions), builds the
initial state in the port and hands it to the JAX model as arrays
(:func:`jax_state_from`, which spares each case the compile of the JAX
model's initial projection), and steps both; the fields agree to 1e-12 of
the largest value of each field after every step
(``test_torch_closure_models.run_both``). The JAX side steps eagerly,
which is quicker than compiling these small cases. Every forcing kind
(a number, a callable of time, ``Forcing`` with parameters and field
dependencies, a discrete ``Forcing``, ``Relaxation`` with a
``GaussianMask`` and a ``LinearTarget``, ``MultipleForcings``,
``AdvectiveForcing`` and a field time series) runs on each of the three
models. Also here: the dispatch gates under the new physics in both
packages alike (no fused AB2 kernel and no shallow-water stage kernel
under a forcing, a Stokes drift, background fields or biogeochemistry; no
kernel at all under background fields; the WENO-5 tracer kernel without
the advectively forced tracers), and short runs of the examples that these
terms unlock, at reduced sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import (
    SW_FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_tpu.biogeochemistry import (
    SimpleBiogeochemistry as JSimpleBGC,
)
from oceananigans_tpu.immersed import (
    ImmersedBoundaryGrid as JIBG, PartialCellBottom as JPartial,
)
from oceananigans_tpu.forcings import (
    AdvectiveForcing as JAdvective, Forcing as JForcing,
    GaussianMask as JMask, LinearTarget as JTarget,
    MultipleForcings as JMultiple, Relaxation as JRelaxation,
)
from oceananigans_tpu.models import ShallowWaterModel as JShallowWater
from oceananigans_tpu.stokes_drift import (
    StokesDrift as JStokes, UniformStokesDrift as JUniformStokes,
)
from test_torch_closure_models import (
    AB2, F64, RTOL, grids, jax_arrays, run_both,
)

RK3 = "RungeKutta3"


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


def jax_state_from(jmodel, tstate):
    """The JAX model's state (nonhydrostatic or hydrostatic) with the
    arrays of the port's state ``tstate``; the particles at the JAX
    model's initial positions, which equal the port's."""
    from oceananigans_tpu.models.hydrostatic import HydrostaticState as JH
    from oceananigans_tpu.models.nonhydrostatic import (
        NonhydrostaticState as JN,
    )
    from oceananigans_tpu.timesteppers import Clock as JClock
    a = state_to_numpy(tstate)

    def j(key):
        return jnp.asarray(a[key])
    names = tuple(tstate.tracers)
    common = dict(
        u=j("u"), v=j("v"), w=j("w"), Gu=j("Gu"), Gv=j("Gv"),
        tracers={n: j(f"tracers/{n}") for n in names},
        Gtracers={n: j(f"Gtracers/{n}") for n in names},
        clock=JClock(time=j("time"), iteration=j("iteration"),
                     last_dt=j("last_dt")),
        particles=(jmodel.particles.initial
                   if jmodel.particles is not None else None))
    if "eta" in a:
        return JH(eta=j("eta"), Geta=j("Geta"), U=j("U"), V=j("V"),
                  **common)
    return JN(pressure=j("pressure"), Gw=j("Gw"), **common)


class Series:
    """A field time series as ``materialize_forcing`` takes it: ``times``
    and interior-shaped ``data``."""

    def __init__(self, shape, seed=3):
        rng = np.random.default_rng(seed)
        self.times = np.array([0.0, 0.015, 0.05])
        self.data = 1e-3 * rng.standard_normal((3, *shape))


def P(pkg):
    """The package's names: (module, array module, Forcing,
    AdvectiveForcing, Relaxation, GaussianMask, LinearTarget,
    MultipleForcings)."""
    if pkg is oj:
        return (oj, jnp, JForcing, JAdvective, JRelaxation, JMask, JTarget,
                JMultiple)
    return (ot, torch, ot.Forcing, ot.AdvectiveForcing, ot.Relaxation,
            ot.GaussianMask, ot.LinearTarget, ot.MultipleForcings)


def every_forcing(pkg, velocities=("u", "v", "w"), tracers=("b", "c"),
                  shape=(8, 8, 8), advective=True):
    """One model's forcings with every kind among them."""
    lib, xp, Forcing, Advective, Relax, Mask, Target, Multiple = P(pkg)
    u, v, w = (velocities + (None,))[:3]
    b, c = tracers

    def wind(x, y, z, t, p):
        return p["a"] * xp.sin(2 * np.pi * x) * xp.exp(z) * xp.cos(t / p["T"])

    def drag(x, y, z, t, vv, bb):
        return -0.1 * vv + 1e-3 * bb

    def damp(grid, loc, time, fields, rate):
        return -rate * fields[c]

    out = {
        u: Multiple(1e-3, lambda x, y, z, t: 1e-3 * xp.cos(3 * x + t)
                    + 0 * y * z),
        v: Forcing(drag, field_dependencies=(v, b)),
        b: Relax(2.0, mask=Mask(-0.5, 0.2), target=Target(0.1, 0.01)),
    }
    if w is not None:
        out[w] = Forcing(wind, parameters={"a": 1e-3, "T": 0.02})
    extra = [Forcing(damp, parameters=0.5, discrete_form=True),
             Series(shape)]
    if advective:
        extra.append(Advective(w=lambda x, y, z: -0.05 * (1.0 + z) + 0 * x))
    out[c] = Multiple(*extra)
    return out


def nonhydrostatic_pair(advection="Centered", size=(8, 8, 8),
                        tracers=("c",), timestepper=AB2, **physics):
    """Both packages' small nonhydrostatic models on (Periodic, Periodic,
    Bounded), halo 3, with a BuoyancyTracer; ``physics(pkg)`` gives the
    extra keywords. (One layout for every case of the file: the eager JAX
    step compiles each operation once per shape.)"""
    halo = 3
    kw = dict(size=size, extent=(1.0, 1.0, 1.0),
              topology=(oj.Periodic, oj.Periodic, oj.Bounded), halo=halo)
    jg, tg = grids(**kw)

    def build(pkg, grid, **extra):
        more = {k: f(pkg) for k, f in physics.items()}
        return pkg.NonhydrostaticModel(
            grid=grid, advection=getattr(pkg, advection)(),
            buoyancy=pkg.BuoyancyTracer(), tracers=tracers,
            timestepper=timestepper, **more, **extra)

    return build(oj, jg, fused_kernels=False), build(ot, tg,
                                                     fused_kernels=True)


def nonhydrostatic_state(jmodel, tmodel, **extra):
    """The JAX model's initial state from the port's."""
    return jax_state_from(jmodel, tmodel.initial_state(
        u=lambda x, y, z: 0.1 * torch.sin(2 * np.pi * x)
        * torch.cos(np.pi * z),
        v=lambda x, y, z: 0.05 * torch.cos(2 * np.pi * y) + 0 * x,
        b=lambda x, y, z: 0.01 * z + 1e-3 * torch.sin(2 * np.pi * x)
        * torch.sin(3 * np.pi * z), **extra))


# ---------------------------------------------------------------------------
# Forcings on each model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timestepper", [AB2, RK3])
def test_nonhydrostatic_forcings_match_jax(timestepper):
    """Every forcing kind on u, v, w, b and c (a number and a callable of
    time summed, field dependencies, parameters, a relaxation with mask and
    target, a discrete forcing, a time series and a sinking advective
    forcing), 2 steps of each stepper (RK3's stage times reach the
    callables and the series)."""
    jm, tm = nonhydrostatic_pair(forcing=every_forcing,
                                 timestepper=timestepper)
    js = nonhydrostatic_state(jm, tm,
                              c=lambda x, y, z: torch.exp(-z ** 2) + 0 * x)
    run_both(jm, tm, js, 1e-2, 2, eager=True)


def hydrostatic_pair(size=(8, 8, 4), tracer_advection="Centered",
                     tracers=("T", "c"), **physics):
    kw = dict(size=size, extent=(1e5, 1e5, 400.0),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=3)
    jg, tg = grids(**kw)

    def build(pkg, grid, **extra):
        more = {k: f(pkg) for k, f in physics.items()}
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, tracers=tracers,
            buoyancy=pkg.SeawaterBuoyancy(constant_salinity=35.0),
            coriolis=pkg.FPlane(f=1e-4),
            tracer_advection=getattr(pkg, tracer_advection)(),
            free_surface=pkg.SplitExplicitFreeSurface(substeps=8),
            **more, **extra)

    return build(oj, jg, fused_kernels=False), build(ot, tg,
                                                     fused_kernels=True)


def hydrostatic_state(jmodel, tmodel):
    """The JAX model's initial state from the port's."""
    return jax_state_from(jmodel, tmodel.initial_state(
        u=lambda x, y, z: 0.1 * torch.sin(2 * np.pi * x / 1e5) + 0 * z,
        T=lambda x, y, z: 15.0 + 0.01 * z + 0.1 * torch.cos(
            2 * np.pi * y / 1e5),
        c=lambda x, y, z: torch.exp(-(z + 200.0) ** 2 / 1e4) + 0 * x))


def hydrostatic_forcing(pkg):
    """Every kind on u, v, T and c, one relaxation reading the auxiliary
    field Q."""
    lib, xp, Forcing, *_ = P(pkg)
    out = every_forcing(pkg, velocities=("u", "v"), tracers=("T", "c"),
                        shape=(8, 8, 4))
    out["T"] = Forcing(lambda x, y, z, t, q: -1e-6 * q + 0 * z,
                       field_dependencies=("Q",))
    return out


def test_hydrostatic_forcings_match_jax():
    """Every forcing kind on u, v, T and c of the hydrostatic model, one of
    them reading an auxiliary field, 2 steps."""
    Q = np.random.default_rng(11).random((14, 14, 10))   # halo-extended
    jm, tm = hydrostatic_pair(forcing=hydrostatic_forcing,
                              auxiliary_fields=lambda p: {"Q": Q})
    run_both(jm, tm, hydrostatic_state(jm, tm), 300.0, 2, eager=True)


def shallow_water_forcing(pkg):
    lib, xp, Forcing, _, Relax, Mask, Target, Multiple = P(pkg)
    return {
        "uh": Multiple(1e-4, lambda x, y, z, t: 1e-4 * xp.sin(x + t)
                       + 0 * y),
        "vh": Forcing(lambda x, y, z, t, h, p: -p * h,
                      field_dependencies="h", parameters=1e-5),
        "h": Forcing(lambda grid, loc, time, fields: 1e-6 * fields["uh"],
                     discrete_form=True),
        "c": Multiple(Relax(0.1, mask=Mask(0.5, 0.2, coordinate="x"),
                            target=Target(0.2, 0.1, coordinate="y")),
                      Series((16, 12, 1))),
    }


def test_shallow_water_forcings_match_jax():
    """Every forcing kind but the advective one (the shallow-water model
    takes none) on uh, vh, h and a tracer, 3 RK3 steps."""
    kw = dict(size=(16, 12), extent=(1.0, 1.0),
              topology=(oj.Periodic, oj.Bounded, oj.Flat), halo=(2, 2, 0))
    jg, tg = grids(**kw)
    jm = JShallowWater(grid=jg, tracers=("c",),
                       forcing=shallow_water_forcing(oj))
    tm = ot.ShallowWaterModel(grid=tg, tracers=("c",),
                              forcing=shallow_water_forcing(ot),
                              fused_kernels=True)
    assert not tm.fused_rk3 and not jm.fused_rk3
    js = jm.initial_state(h=lambda x, y, z: 1.0 + 0.1 * jnp.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02),
        c=lambda x, y, z: jnp.cos(2 * np.pi * x) + 0 * y)
    ts = state_from_numpy(tm, jax_arrays(js, SW_FIELDS, ("c",)))
    for _ in range(3):
        js = jm.step(js, 1e-3)
        ts = tm.step(ts, 1e-3)
        ref = jax_arrays(js, SW_FIELDS, ("c",))
        got = {k: getattr(ts, k).numpy() for k in ("uh", "vh", "h")}
        got["c"] = ts.tracers["c"].numpy()
        ii = tg.interior_slices
        for k in ("uh", "vh", "h", "c"):
            r = ref[k if k != "c" else "tracers/c"][ii]
            assert np.abs(got[k][ii] - r).max() <= RTOL * np.abs(r).max(), k


def test_advective_forcing_on_a_velocity_raises():
    grid = ot.RectilinearGrid(size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                              dtype=F64)
    for cls in (ot.NonhydrostaticModel, ot.HydrostaticFreeSurfaceModel):
        with pytest.raises(ValueError, match="AdvectiveForcing"):
            cls(grid=grid, forcing={"u": ot.AdvectiveForcing(w=1.0)})


# ---------------------------------------------------------------------------
# Background fields, Stokes drift, biogeochemistry
# ---------------------------------------------------------------------------

def backgrounds(pkg):
    """A static shear U(z) and a time-dependent b(z, t) (a
    ``BackgroundField`` with parameters)."""
    xp = jnp if pkg is oj else torch
    BF = (oj.BackgroundField if pkg is oj else ot.BackgroundField)
    return {"u": lambda x, y, z: 0.2 * xp.tanh(4 * (z + 0.5)) + 0 * x,
            "b": BF(lambda x, y, z, t, p: p * z * (1.0 + t) + 0 * x,
                    parameters=0.02)}


@pytest.mark.parametrize("advection", ["Centered", "WENO"])
def test_background_fields_match_jax(advection):
    """Background u and b under Centered(2) and WENO(5) (momentum and the
    background tracer plain, c by the total flow), 2 AB2 steps."""
    jm, tm = nonhydrostatic_pair(advection=advection,
                                 background_fields=backgrounds)
    assert tm.fused_kernels is False and not tm.fused_tracer
    js = nonhydrostatic_state(jm, tm,
                              c=lambda x, y, z: torch.cos(3 * z) + 0 * x)
    run_both(jm, tm, js, 1e-2, 2, eager=True)


def stokes(pkg):
    """A spatial drift with all nine terms."""
    xp = jnp if pkg is oj else torch
    S = JStokes if pkg is oj else ot.StokesDrift

    def term(a, k):
        return lambda x, y, z, t: a * xp.sin(k * x + y) * xp.exp(z) * (
            1.0 + t)
    names = ("dx_vs", "dx_ws", "dy_us", "dy_ws", "dz_us", "dz_vs", "dt_us",
             "dt_vs", "dt_ws")
    return S(**{n: term(1e-2 * (i + 1), i + 1) for i, n in enumerate(names)})


def uniform_stokes(pkg):
    """The Langmuir example's wave, with a wave-field time tendency."""
    xp = jnp if pkg is oj else torch
    S = JUniformStokes if pkg is oj else ot.UniformStokesDrift
    k, Us = 2 * np.pi / 0.6, 0.05
    return S(us=lambda z, t: Us * xp.exp(2 * k * z),
             dusdz=lambda z, t: 2 * k * Us * xp.exp(2 * k * z),
             vs=lambda z, t: 0.3 * Us * xp.exp(2 * k * z),
             dvsdz=lambda z, t: 0.6 * k * Us * xp.exp(2 * k * z),
             dusdt=lambda z, t: 1e-3 * xp.exp(z) * xp.cos(t))


def bgc(pkg):
    xp = jnp if pkg is oj else torch
    B = JSimpleBGC if pkg is oj else ot.SimpleBiogeochemistry
    return B(tracer="P", growth_rate=lambda z, t: 2.0 * xp.exp(z / 0.25),
             sinking_speed=0.05)


PHYSICS = {"stokes_drift": stokes, "uniform_stokes_drift": uniform_stokes,
           "biogeochemistry": bgc}


@pytest.mark.parametrize("name", sorted(PHYSICS))
def test_nonhydrostatic_physics_matches_jax(name):
    """Stokes drift (spatial and uniform) and biogeochemistry (growth and
    sinking of P) under WENO(5) through the kernel code paths, 2 steps."""
    key = "biogeochemistry" if name == "biogeochemistry" else "stokes_drift"
    jm, tm = nonhydrostatic_pair(advection="WENO",
                                 **{key: PHYSICS[name]})
    assert tm.fused_kernels == "weno5" and not tm.fused_ab2_weno_science
    extra = ({"P": lambda x, y, z: torch.exp(-(z + 0.3) ** 2 / 0.02)
              + 0 * x} if key == "biogeochemistry" else {})
    js = nonhydrostatic_state(jm, tm, **extra)
    run_both(jm, tm, js, 1e-2, 2, eager=True)


@pytest.mark.parametrize("name", ["uniform_stokes_drift", "biogeochemistry"])
def test_hydrostatic_physics_matches_jax(name):
    """The hydrostatic model's x and y Stokes terms, and biogeochemistry, 2
    steps."""
    key = "biogeochemistry" if name == "biogeochemistry" else "stokes_drift"

    def scaled(pkg):
        xp = jnp if pkg is oj else torch
        if key == "biogeochemistry":
            B = JSimpleBGC if pkg is oj else ot.SimpleBiogeochemistry
            return B(tracer="c", growth_rate=lambda z, t: 1e-5 * xp.exp(
                z / 100.0), sinking_speed=1e-3)
        S = JUniformStokes if pkg is oj else ot.UniformStokesDrift
        return S(dusdz=lambda z, t: 1e-3 * xp.exp(z / 50.0),
                 dvsdz=lambda z, t: 5e-4 * xp.exp(z / 50.0))

    jm, tm = hydrostatic_pair(**{key: scaled})
    run_both(jm, tm, hydrostatic_state(jm, tm), 300.0, 2, eager=True)


# ---------------------------------------------------------------------------
# Dispatch gates under the new physics, in both packages alike
# ---------------------------------------------------------------------------

GATE_PHYSICS = {
    "forcing": lambda p: dict(forcing={"u": 1e-3}),
    "stokes_drift": lambda p: dict(stokes_drift=uniform_stokes(p)),
    "background_fields": lambda p: dict(
        background_fields={"u": lambda x, y, z: 0.1 + 0 * x}),
    "biogeochemistry": lambda p: dict(biogeochemistry=bgc(p)),
    "advective_forcing": lambda p: dict(
        forcing={"c": (JAdvective if p is oj else ot.AdvectiveForcing)(
            w=-0.1)}),
}
GATES = ("fused_kernels", "fused_ab2", "fused_ab2_weno", "fused_ab2_science",
         "fused_ab2_weno_science", "fused_tracer")


def gate_pair(advection, halo, tracers=(), **kw):
    # y and z halo-free and aligned to the TPU's (8, 128) tiles, where the
    # JAX package's kernel gates hold
    jg, tg = grids(size=(8, 8, 128), extent=(1.0, 1.0, 1.0),
                   halo=(halo, 0, 0),
                   topology=(oj.Bounded, oj.Periodic, oj.Periodic))

    def build(pkg, grid):
        more = {k: f(pkg) for k, f in kw.items()}
        return pkg.NonhydrostaticModel(
            grid=grid, advection=advection(pkg), tracers=tracers,
            timestepper=AB2, fused_kernels=True, **more)
    return build(oj, jg), build(ot, tg)


ADVECTION = {"centered2": (lambda p: p.Centered(2), 1),
             "weno5": (lambda p: p.WENO(5), 3),
             "weno7": (lambda p: p.WENO(7), 4)}


@pytest.mark.parametrize("case", sorted(GATE_PHYSICS))
@pytest.mark.parametrize("family", sorted(ADVECTION))
def test_gates_match_jax_under_new_physics(family, case):
    """Each new term turns off every fused AB2 kernel (TPU kernels 1, 5, 6
    and 8) in both packages; background fields turn off the tendency
    kernels (2, 7, 9) and the any-order tracer kernel (11) too; the others
    leave them on. With tracers (the science configurations) and
    without."""
    adv, halo = ADVECTION[family]
    for tracers in ((), ("c", "P")):
        jm, tm = gate_pair(adv, halo, tracers=tracers)
        assert any(getattr(tm, g) for g in GATES[1:5]) or tracers or (
            family == "weno7")
        physics = lambda p: GATE_PHYSICS[case](p)
        jm, tm = gate_pair(adv, halo, tracers=tracers,
                           **{k: (lambda p, k=k: physics(p)[k])
                              for k in GATE_PHYSICS[case](ot)})
        for gate in GATES:
            assert bool(getattr(tm, gate)) == bool(getattr(jm, gate)), gate
            assert (getattr(tm, gate) or False) == (getattr(jm, gate)
                                                    or False), gate
        # (an advective forcing of a tracer the model lacks applies to
        # nothing, in either package)
        if tracers or case != "advective_forcing":
            assert not any(getattr(tm, g) for g in GATES[1:5])
        bg = case == "background_fields"
        assert bool(tm.fused_kernels) == (family != "weno7" and not bg)
        assert tm.fused_tracer == (family == "weno7" and not bg)


#: the bound-preserving limiters, as advection of either package
BOUNDED = {
    "weno5_bounds": lambda p: p.WENO(5, bounds=(0.0, 1.0)),
    "bound_preserving_weno5": lambda p: (
        ot.advection if p is ot else oj.advection).BoundPreserving(
            p.WENO(5)),
    "bound_preserving_centered2": lambda p: (
        ot.advection if p is ot else oj.advection).BoundPreserving(
            p.Centered(2)),
}


@pytest.mark.parametrize("limiter", sorted(BOUNDED))
def test_gates_match_jax_under_bounded_advection(limiter):
    """A bound-preserving limiter as the advection turns off every kernel
    of the nonhydrostatic model in both packages, with tracers and
    without: the fused AB2 kernels (1, 5, 6, 8), the tendency kernels (2,
    7, 9) and the any-order tracer kernel (11), on the layout where the
    plain schemes take them."""
    for tracers in ((), ("c", "P")):
        jm, tm = gate_pair(BOUNDED[limiter], 3, tracers=tracers)
        for gate in GATES:
            assert bool(getattr(tm, gate)) == bool(getattr(jm, gate)) \
                is False, gate


def test_shallow_water_stage_kernel_refuses_a_forcing():
    """Kernel 10's gate refuses a forcing, as the JAX gate does (on a
    layout both packages' gates take: an x halo of 8, y halo-free and
    aligned to the TPU's tiles)."""
    from oceananigans_torch.ops import cuda_sw
    from oceananigans_tpu.ops import pallas_sw
    kw = dict(size=(16, 128), extent=(1.0, 1.0),
              topology=(oj.Periodic, oj.Periodic, oj.Flat), halo=(8, 0, 0))
    jg, tg = grids(**kw)
    for forcing in (None, {"h": 1e-6}):
        jm = JShallowWater(grid=jg, forcing=forcing)
        tm = ot.ShallowWaterModel(grid=tg, forcing=forcing,
                                  fused_kernels=True)
        assert tm.fused_rk3 == (forcing is None)
        assert (cuda_sw.sw_fused_available(tg, tm)
                == pallas_sw.sw_fused_available(jg, jm)
                == (forcing is None))


def test_tracer_kernel_route(monkeypatch):
    """With an advective forcing on c, the WENO-5 tracer kernel (9) takes
    b and P only, on the model's velocities (the total flow, as in the JAX
    model: without background fields, the resolved one), and c runs plain;
    with background fields no tracer kernel runs, in either package."""
    from oceananigans_torch.models import nonhydrostatic as nh
    seen = []
    real = nh.weno5_tracer_tendencies

    def spy(grid, u, v, w, tracers, epsilon=1e-8):
        seen.append((sorted(tracers), u))
        return real(grid, u, v, w, tracers, epsilon=epsilon)
    monkeypatch.setattr(nh, "weno5_tracer_tendencies", spy)
    weno5 = ADVECTION["weno5"][0]
    for case in ("advective_forcing", "background_fields"):
        jm, tm = gate_pair(weno5, 3, tracers=("c", "P", "b"), **{
            k: (lambda p, k=k: GATE_PHYSICS[case](p)[k])
            for k in GATE_PHYSICS[case](ot)})
        s = tm.initial_state(u=lambda x, y, z: torch.sin(6 * x) + 0 * y)
        seen.clear()
        tm.step(s, 1e-3)
        if case == "advective_forcing":
            assert [names for names, _ in seen] == [["P", "b"]]
            assert seen[0][1] is s.u and jm.fused_kernels == "weno5"
        else:
            assert seen == [] and not jm.fused_kernels


# ---------------------------------------------------------------------------
# The examples these terms unlock, at reduced sizes
# ---------------------------------------------------------------------------

def test_langmuir_example_matches_jax():
    """``examples/langmuir_turbulence.py`` at 8 x 8 x 8 over its own 128 x
    128 x 64 m box: WENO(5), BuoyancyTracer, the example's wave as a
    ``UniformStokesDrift``, AMD, u and b surface fluxes and the b bottom
    gradient; with P growing at (1/day)·exp(z/16 m) and sinking at 1e-4
    m/s (``SimpleBiogeochemistry``): ``chip_smoke.py`` phase 21's
    configuration. 2 AB2 steps of 5 s."""
    N = 8
    kw = dict(size=(N, N, N), extent=(128.0, 128.0, 64.0),
              topology=(oj.Periodic, oj.Periodic, oj.Bounded), halo=3)
    jg, tg = grids(**kw)
    from oceananigans_torch.profile_step import langmuir_model
    tm = langmuir_model(tg, fused=True)

    amplitude, k = 0.8, 2 * np.pi / 60.0
    Us0 = amplitude ** 2 * k * np.sqrt(9.81 * k)
    jm = oj.NonhydrostaticModel(
        grid=jg, advection=oj.WENO(5), tracers=("b", "P"),
        buoyancy=oj.BuoyancyTracer(),
        stokes_drift=JUniformStokes(
            us=lambda z, t: Us0 * jnp.exp(2 * k * z),
            dusdz=lambda z, t: 2 * k * Us0 * jnp.exp(2 * k * z)),
        closure=oj.AnisotropicMinimumDissipation(),
        biogeochemistry=JSimpleBGC(
            tracer="P", growth_rate=lambda z, t: jnp.exp(z / 16.0) / 86400.0,
            sinking_speed=1e-4),
        boundary_conditions={
            "u": oj.FieldBoundaryConditions(top=oj.FluxBC(-3.72e-5)),
            "b": oj.FieldBoundaryConditions(top=oj.FluxBC(2.307e-8),
                                            bottom=oj.GradientBC(1.936e-5))},
        timestepper=AB2, fused_kernels=False)
    from oceananigans_torch.profile_step import langmuir_initial_state
    js = jax_state_from(jm, langmuir_initial_state(tm))
    run_both(jm, tm, js, 5.0, 2, eager=True)


def example_models(name, pkg):
    """The examples that forcings and background fields unlock, at reduced
    sizes, in package ``pkg``: (model, initial fields, Δt)."""
    xp = jnp if pkg is oj else torch
    f64 = {"dtype": "float64"} if pkg is oj else {"dtype": F64}
    hyd = oj.models if pkg is oj else ot
    Forcing = JForcing if pkg is oj else ot.Forcing
    rng = np.random.default_rng(42)
    if name == "kelvin_helmholtz":
        grid = pkg.RectilinearGrid(size=(8, 8), x=(-5.0, 5.0),
                                   z=(-5.0, 5.0), halo=3,
                                   topology=(pkg.Periodic, pkg.Flat,
                                             pkg.Bounded), **f64)
        Ri, h = 0.1, 0.25
        model = pkg.NonhydrostaticModel(
            grid=grid, advection=pkg.UpwindBiased(5),
            background_fields={"u": lambda x, y, z: xp.tanh(z),
                               "b": lambda x, y, z: h * Ri * xp.tanh(z / h)},
            closure=pkg.ScalarDiffusivity(nu=2e-4, kappa=2e-4),
            buoyancy=pkg.BuoyancyTracer(), tracers=("b",))
        init = dict(u=1e-2 * rng.standard_normal((8, 1, 8)),
                    w=1e-2 * rng.standard_normal((8, 1, 8)))
        return model, init, 0.1
    if name == "convecting_plankton":
        grid = pkg.RectilinearGrid(size=(8, 8), x=(0.0, 64.0),
                                   z=(-64.0, 0.0), halo=3,
                                   topology=(pkg.Periodic, pkg.Flat,
                                             pkg.Bounded), **f64)
        model = pkg.NonhydrostaticModel(
            grid=grid, advection=pkg.UpwindBiased(5),
            closure=pkg.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
            coriolis=pkg.FPlane(f=1e-4), tracers=("b", "P"),
            buoyancy=pkg.BuoyancyTracer(),
            forcing={"P": Forcing(
                lambda x, y, z, t, P, p: (p["mu0"] * xp.exp(z / p["lam"])
                                          - p["m"]) * P,
                field_dependencies="P",
                parameters={"mu0": 1 / 86400, "lam": 5.0,
                            "m": 0.1 / 86400})},
            boundary_conditions={"b": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(lambda x, y, t: 1e-8 * xp.exp(
                    -t ** 4 / (24 * 7200.0 ** 4))),
                bottom=pkg.GradientBC(1e-4))})
        zc = -64.0 + (np.arange(8) + 0.5) * 64.0 / 8
        b = np.where(zc < -32.0, 1e-4 * zc, -1e-4 * 32.0)[None, None, :] \
            + 1e-6 * rng.standard_normal((8, 1, 8))
        return model, dict(b=b, P=1.0), 120.0
    if name == "internal_tide":
        under = pkg.RectilinearGrid(size=(8, 4), x=(-1e5, 1e5),
                                    z=(-2000.0, 0.0), halo=(4, 4, 4),
                                    topology=(pkg.Periodic, pkg.Flat,
                                              pkg.Bounded), **f64)
        IBG = JIBG if pkg is oj else ot.ImmersedBoundaryGrid
        PCB = JPartial if pkg is oj else ot.PartialCellBottom
        grid = IBG(under, PCB(lambda x, y: -2000.0 + 250.0 * xp.exp(
            -x ** 2 / (2 * 2e4 ** 2))))
        coriolis = pkg.FPlane(latitude=-45.0)
        omega2 = 2 * np.pi / (12.421 * 3600)
        U = 0.1 * omega2 * 2e4
        A = U * (omega2 ** 2 - coriolis.f ** 2) / omega2
        model = hyd.HydrostaticFreeSurfaceModel(
            grid=grid, coriolis=coriolis, buoyancy=pkg.BuoyancyTracer(),
            tracers=("b",), momentum_advection=pkg.WENO(5),
            tracer_advection=pkg.WENO(5),
            forcing={"u": Forcing(
                lambda x, y, z, t, p: p["A"] * xp.sin(p["omega"] * t),
                parameters={"A": A, "omega": omega2})})
        return model, dict(u=U, b=lambda x, y, z: 1e-4 * z), 300.0
    # the tilted bottom boundary layer on its stretched z, with its
    # background stratification and along-slope current
    from test_torch_stretched import tilted_z
    zf = tilted_z(8)
    grid = pkg.RectilinearGrid(size=(8, 8), x=(0.0, 200.0), z=zf, halo=3,
                               topology=(pkg.Periodic, pkg.Flat,
                                         pkg.Bounded), **f64)
    theta = np.radians(3.0)
    g_hat = (np.sin(theta), 0.0, np.cos(theta))
    cD = (0.4 / np.log(0.5 * (zf(0) + zf(1)) / 0.1)) ** 2

    def drag(comp):
        return lambda x, y, t, u, v: (-cD * xp.sqrt(u ** 2 + (v + 0.1) ** 2)
                                      * (u if comp == "u" else v + 0.1))
    FBC = pkg.FieldBoundaryConditions
    model = pkg.NonhydrostaticModel(
        grid=grid, advection=pkg.WENO(5), tracers=("b",),
        buoyancy=pkg.BuoyancyForce(pkg.BuoyancyTracer(),
                                   gravity_unit_vector=tuple(
                                       -c for c in g_hat)),
        coriolis=pkg.ConstantCartesianCoriolis(f=1e-4, rotation_axis=g_hat),
        closure=pkg.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
        background_fields={
            "b": lambda x, y, z: 1e-5 * (x * g_hat[0] + z * g_hat[2]),
            "v": lambda x, y, z: 0.1 + 0.0 * (x + z)},
        boundary_conditions={
            "u": FBC(bottom=pkg.FluxBC(drag("u"),
                                       field_dependencies=("u", "v"))),
            "v": FBC(bottom=pkg.FluxBC(drag("v"),
                                       field_dependencies=("u", "v"))),
            "b": FBC(bottom=pkg.GradientBC(-1e-5 * np.cos(theta)))})
    return model, dict(u=lambda x, y, z: 1e-3 * xp.sin(2 * np.pi * x / 200.0)
                       + 0 * z), 30.0


@pytest.mark.parametrize("name", ["convecting_plankton", "internal_tide",
                                  "kelvin_helmholtz", "tilted_bottom"])
def test_examples_match_jax(name):
    """``examples/convecting_plankton.py`` (a field-dependent ``Forcing``
    with parameters), ``internal_tide.py`` (the tidal body force on an
    immersed partial-cell hill under the hydrostatic model),
    ``kelvin_helmholtz_instability.py`` and
    ``tilted_bottom_boundary_layer.py`` (background fields; the latter on
    its stretched z with tilted gravity and quadratic drag), each at 8 x 8
    or less, 2 steps."""
    jm, _, dt = example_models(name, oj)
    tm, init, _ = example_models(name, ot)
    js = jax_state_from(jm, tm.initial_state(**init))
    balanced = name in ("convecting_plankton", "tilted_bottom")
    run_both(jm, tm, js, dt, 2, eager=True, balanced=balanced)


def test_hydrostatic_tracer_kernel_route(monkeypatch):
    """The hydrostatic model's WENO tracer kernel (11) takes the tracers
    without an advective forcing, as the JAX model's ``fused_tracer`` list
    does; the advectively forced one runs plain."""
    from oceananigans_torch.models import hydrostatic as hyd
    seen = []
    real = hyd.weno_tracer_tendencies

    def spy(grid, scheme, u, v, w, tracers, metrics=None):
        seen.append(sorted(tracers))
        return real(grid, scheme, u, v, w, tracers, metrics=metrics)
    monkeypatch.setattr(hyd, "weno_tracer_tendencies", spy)
    _, tm = hydrostatic_pair(
        tracer_advection="WENO",
        forcing=lambda p: {"c": (JAdvective if p is oj
                                 else ot.AdvectiveForcing)(w=-1e-3)})
    assert tm.fused_tracer
    tm.step(tm.initial_state(), 300.0)
    assert seen == [["T"]]
