"""oceananigans_torch's ``Simulation`` driver against the JAX package's, on
the CPU in float64.

Both drivers run the same model from the same state (handed across as
numpy arrays through ``oceananigans_torch.interop``) with the same
schedules and callbacks; the tests compare what the callbacks saw (the
iterations, times and Δt at each actuation), the step counts, the stop
reasons and the final states, to 1e-12 of the largest reference value.
Also here: the ``NaNChecker``, a ``TendencyCallsite`` hook on the
nonhydrostatic and hydrostatic models, duck-typed output writers, a pickup
without a checkpointer, the schedules, the diagnostics, and the README
quick start (``tests/test_torch_output.py`` holds the writers and
checkpoints).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import diagnostics as t_diag
from oceananigans_torch.interop import (
    FIELDS, HYDROSTATIC_FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_torch.utils import schedules as t_sched
from oceananigans_tpu import diagnostics as j_diag
from oceananigans_tpu.models import NonhydrostaticModel as JModel
from oceananigans_tpu.models import hydrostatic as j_hyd
from oceananigans_tpu.utils import schedules as j_sched

RTOL = 1e-12
F64 = torch.float64
AB2 = "QuasiAdamsBashforth2"
GRID = dict(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), halo=3,
            topology=(oj.Periodic, oj.Periodic, oj.Bounded))


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


def arrays_of(s, fields):
    out = {name: np.asarray(getattr(s, name)) for name in fields}
    for group in ("tracers", "Gtracers"):
        for n, a in getattr(s, group).items():
            out[f"{group}/{n}"] = np.asarray(a)
    out.update(time=np.asarray(s.clock.time),
               iteration=int(s.clock.iteration),
               last_dt=np.asarray(s.clock.last_dt))
    return out


def assert_states_close(tg, ts, js, names, fields=FIELDS):
    got, ref = state_to_numpy(ts), arrays_of(js, fields)
    ii = tg.interior_slices
    for name in names:
        a, b = np.asarray(got[name])[ii], np.asarray(ref[name])[ii]
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale,
                                   err_msg=name)
    assert ts.clock.iteration == int(js.clock.iteration)
    assert math.isclose(float(ts.clock.time), float(js.clock.time),
                        rel_tol=RTOL)


def nonhydrostatic_pair(advection="WENO", timestepper=AB2, seed=3):
    """The JAX and the port's model (tracer c) and the same projected
    random starting state."""
    jg = oj.RectilinearGrid(dtype="float64", **GRID)
    tg = ot.RectilinearGrid(dtype=F64, **GRID)
    jm = JModel(grid=jg, advection=getattr(oj, advection)(5 if advection
                                                          == "WENO" else 2),
                tracers=("c",), timestepper=timestepper)
    tm = ot.NonhydrostaticModel(grid=tg, advection=getattr(ot, advection)(
        5 if advection == "WENO" else 2), tracers=("c",),
        timestepper=timestepper, fused_kernels=True)
    rng = np.random.default_rng(seed)
    init = {n: rng.standard_normal(GRID["size"]) for n in ("u", "v", "w",
                                                           "c")}
    js = jm.initial_state(**init)
    ts = state_from_numpy(tm, arrays_of(js, FIELDS))
    return jm, tm, js, ts


class Recorder:
    """A callback recording (iteration, time, Δt) at each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, sim):
        self.calls.append((int(sim.state.clock.iteration),
                           float(sim.state.clock.time), sim.dt))


class Writer:
    """A duck-typed output writer: a schedule and ``write(sim)``."""

    def __init__(self, schedule):
        self.schedule = schedule
        self.iterations = []

    def write(self, sim):
        self.iterations.append(int(sim.state.clock.iteration))


def drive(pkg, sched, model, state, callbacks, writers=(), **kw):
    """A Simulation of ``pkg`` with fresh recorders on the given schedules
    (name -> schedule factory taking the schedules module); returns the
    simulation and the recorders."""
    sim = pkg.Simulation(model, state=state, **kw)
    recs = {}
    for name, make in callbacks.items():
        recs[name] = Recorder()
        sim.callbacks[name] = pkg.Callback(recs[name], make(sched))
    for name, make in writers:
        sim.output_writers[name] = Writer(make(sched))
    sim.run()
    return sim, recs


def assert_calls_close(a, b):
    assert len(a) == len(b)
    for (ia, ta, da), (ib, tb, db) in zip(a, b):
        assert ia == ib
        assert math.isclose(ta, tb, rel_tol=RTOL, abs_tol=1e-15)
        assert math.isclose(da, db, rel_tol=RTOL)


# ---------------------------------------------------------------------------
# The run loop
# ---------------------------------------------------------------------------

def test_stop_time_alignment_and_callbacks():
    """stop_time with TimeInterval alignment: Δt shrinks to land on each
    TimeInterval actuation and on the stop time; IterationInterval and
    SpecifiedTimes callbacks and a writer actuate at the same points."""
    jm, tm, js, ts = nonhydrostatic_pair()
    callbacks = {"every3": lambda s: s.IterationInterval(3),
                 "t02": lambda s: s.TimeInterval(0.02),
                 "spec": lambda s: s.SpecifiedTimes(0.011, 0.037),
                 "either": lambda s: s.OrSchedule(s.IterationInterval(7),
                                                  s.TimeInterval(0.025))}
    writers = [("w", lambda s: s.TimeInterval(0.03))]
    jsim, jrec = drive(oj, j_sched, jm, js, callbacks, writers, dt=0.003,
                       stop_time=0.05)
    tsim, trec = drive(ot, t_sched, tm, ts, callbacks, writers, dt=0.003,
                       stop_time=0.05)
    for name in callbacks:
        assert_calls_close(trec[name].calls, jrec[name].calls)
    assert (tsim.output_writers["w"].iterations
            == jsim.output_writers["w"].iterations)
    assert tsim.stop_reason == jsim.stop_reason == "stop_time reached"
    assert ot.iteration(tsim) == oj.iteration(jsim)
    assert_states_close(tm.grid, tsim.state, jsim.state,
                        ("u", "v", "w", "tracers/c"))
    # the alignment cut the last Δt short of 0.003
    assert tsim.state.clock.last_dt < 0.003 - 1e-6


def test_stop_iteration_and_wizard():
    """TimeStepWizard every 4 iterations under stop_iteration: the same Δt
    sequence and final state; RK3, Centered(2) on the kernels' code
    path."""
    jm, tm, js, ts = nonhydrostatic_pair("Centered", "RungeKutta3")
    assert tm.fused_kernels == "centered2"
    callbacks = {"rec": lambda s: s.IterationInterval(1)}
    jsim = oj.Simulation(jm, state=js, dt=1e-3, stop_iteration=22)
    tsim = ot.Simulation(tm, state=ts, dt=1e-3, stop_iteration=22)
    for sim, pkg, sched in ((jsim, oj, j_sched), (tsim, ot, t_sched)):
        pkg.conjure_time_step_wizard(sim, sched.IterationInterval(4),
                                     cfl=0.3, max_change=1.2)
        sim.callbacks["rec"] = pkg.Callback(Recorder(),
                                            callbacks["rec"](sched))
        sim.run()
    assert_calls_close(tsim.callbacks["rec"].func.calls,
                       jsim.callbacks["rec"].func.calls)
    assert ot.iteration(tsim) == 22
    assert tsim.stop_reason == jsim.stop_reason == "stop_iteration reached"
    assert math.isclose(tsim.dt, jsim.dt, rel_tol=RTOL)
    assert tsim.dt != 1e-3
    assert_states_close(tm.grid, tsim.state, jsim.state,
                        ("u", "v", "w", "tracers/c"))


def test_bare_loop_equals_simulation():
    """A constant-Δt Simulation is the bare loop: one fill, then steps
    with assume_filled=True, bit for bit."""
    _, tm, _, ts = nonhydrostatic_pair("Centered")
    arrays = state_to_numpy(ts)
    sim = ot.Simulation(tm, state=ts, dt=1e-3, stop_iteration=12)
    sim.run()
    s = tm.fill_state_halos(state_from_numpy(tm, arrays))
    for _ in range(12):
        s = tm.step(s, 1e-3, assume_filled=True)
    for name in ("u", "v", "w", "pressure"):
        assert torch.equal(getattr(s, name), getattr(sim.state, name))


def test_nan_checker_halts():
    """The default NaNChecker (IterationInterval(100)) stops the run with
    the same error in both packages."""
    jm, tm, js, ts = nonhydrostatic_pair("Centered")
    msgs = []
    for pkg, model, state in ((oj, jm, js), (ot, tm, ts)):
        u = state.u
        state = state.__class__(**{**state.__dict__,
                                   "u": u.at[4, 4, 4].set(jnp.nan)
                                   if pkg is oj else u.clone().index_fill_(
                                       0, torch.tensor([4]), math.nan)})
        sim = pkg.Simulation(model, state=state, dt=1e-3, stop_iteration=5)
        with pytest.raises(RuntimeError, match="NaN found in 'u'") as e:
            sim.run()
        assert not sim.running
        assert sim.stop_reason == "NaN found in field 'u'"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_tendency_callsite_hook():
    """A TendencyCallsite callback is the model's tendency hook: it runs
    inside every step, the fused AB2 science gate stays off while it is
    set, and both packages agree."""
    jm, tm, js, ts = nonhydrostatic_pair("Centered")
    assert tm.fused_ab2_science

    def hook(grid, state, G):
        return {**G, "u": G["u"] + 0.5, "c": G["c"] - 0.1 * state.tracers[
            "c"]}

    sims = []
    for pkg, model, state in ((oj, jm, js), (ot, tm, ts)):
        sim = pkg.Simulation(model, state=state, dt=2e-3, stop_iteration=6)
        pkg.add_callback(sim, hook, callsite=pkg.TendencyCallsite)
        sim.run()
        sims.append(sim)
    assert tm.tendency_callbacks == (hook,)
    assert not tm.fused_ab2_science and tm.fused_kernels == "centered2"
    assert_states_close(tm.grid, sims[1].state, sims[0].state,
                        ("u", "v", "w", "tracers/c"))


def test_hydrostatic_simulation_with_hook():
    kw = dict(size=(10, 8, 4), extent=(1.0, 1.0, 1.0), halo=3,
              topology=(oj.Periodic, oj.Bounded, oj.Bounded))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jm = j_hyd.HydrostaticFreeSurfaceModel(
        grid=jg, tracers=("T",), free_surface=j_hyd.ExplicitFreeSurface(
            gravitational_acceleration=1.0))
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=tg, tracers=("T",), free_surface=ot.ExplicitFreeSurface(
            gravitational_acceleration=1.0))
    js = jm.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x) * jnp.cos(np.pi * y),
        T=lambda x, y, z: 20.0 + 2.0 * z + jnp.sin(2 * np.pi * x))
    ts = state_from_numpy(tm, arrays_of(js, HYDROSTATIC_FIELDS))

    def hook(grid, state, G):
        return {**G, "v": G["v"] + 1e-2, "T": G["T"] * 0.5}

    sims = []
    for pkg, model, state in ((oj, jm, js), (ot, tm, ts)):
        sim = pkg.Simulation(model, state=state, dt=5e-3, stop_time=0.04)
        sim.callbacks["hook"] = pkg.Callback(hook,
                                             callsite=pkg.TendencyCallsite)
        sim.run()
        sims.append(sim)
    assert_states_close(tg, sims[1].state, sims[0].state,
                        ("u", "v", "tracers/T"), HYDROSTATIC_FIELDS)


def test_unported_output_raises():
    """What Simulation refuses, as the JAX package's does: a pickup without
    a Checkpointer among the writers, and a Simulation without Δt."""
    jm, tm, js, ts = nonhydrostatic_pair("Centered")
    for pkg, model, state in ((oj, jm, js), (ot, tm, ts)):
        sim = pkg.Simulation(model, state=state, dt=1e-3, stop_iteration=2)
        sim.output_writers["w"] = Writer(pkg.IterationInterval(1))
        with pytest.raises(ValueError, match="no Checkpointer"):
            sim.run(pickup=True)
    with pytest.raises(ValueError):
        ot.Simulation(tm, state=ts)


# ---------------------------------------------------------------------------
# Schedules and diagnostics
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, time, iteration):
        self.time, self.iteration = time, iteration


@pytest.mark.parametrize("make", [
    lambda s: s.TimeInterval(0.25),
    lambda s: s.IterationInterval(3, offset=1),
    lambda s: s.SpecifiedTimes([0.1, 0.6, 0.35]),
    lambda s: s.AndSchedule(s.IterationInterval(2), s.TimeInterval(0.5)),
    lambda s: s.OrSchedule(s.IterationInterval(5), s.SpecifiedTimes(0.7)),
    lambda s: s.AveragedTimeInterval(0.5, window=0.2)])
def test_schedules_match_jax(make):
    js, ts = make(j_sched), make(t_sched)
    for it in range(12):
        clock = _Clock(0.1 * it, it)
        assert ts.actuates(clock) == js.actuates(clock)
        assert ts.next_actuation_time(clock) == js.next_actuation_time(clock)
        assert (ts.next_actuation_iteration(clock)
                == js.next_actuation_iteration(clock))
        if hasattr(js, "averaging"):
            assert ts.averaging(clock) == js.averaging(clock)


def test_diagnostics_match_jax():
    jm, tm, js, ts = nonhydrostatic_pair()
    for j_obj, t_obj in ((j_diag.AdvectiveCFL(0.01), t_diag.AdvectiveCFL(
            0.01)), (j_diag.DiffusiveCFL(0.01), t_diag.DiffusiveCFL(0.01))):
        assert math.isclose(float(t_obj(tm, ts)), float(j_obj(jm, js)),
                            rel_tol=RTOL)
    assert math.isclose(float(tm.cfl_timescale(ts)),
                        float(jm.cfl_timescale(js)), rel_tol=RTOL)
    assert math.isinf(float(tm.diffusion_timescale(ts)))
    assert math.isinf(float(jm.diffusion_timescale(js)))
    jrows = j_diag.StateChecker()(jm, js)
    trows = t_diag.StateChecker()(tm, ts)
    assert sorted(jrows) == sorted(trows)
    for name in jrows:
        np.testing.assert_allclose(trows[name], jrows[name], rtol=RTOL,
                                   atol=1e-14)
    for side in ("west", "north", "bottom", "top"):
        np.testing.assert_allclose(
            float(t_diag.boundary_adjacent_mean(tm.grid, ts.tracers["c"],
                                                side)),
            float(j_diag.boundary_adjacent_mean(jm.grid, js.tracers["c"],
                                                side)), rtol=RTOL)


def test_seawater_density_matches_jax():
    kw = dict(size=(4, 4, 4), extent=(1.0, 1.0, 100.0), halo=1,
              topology=(oj.Periodic, oj.Periodic, oj.Bounded))
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(1)
    T = 15 + rng.standard_normal(tg.shape)
    S = 35 + rng.standard_normal(tg.shape)
    for eos in ("LinearEquationOfState", "TEOS10EquationOfState"):
        jm = JModel(grid=jg, buoyancy=oj.SeawaterBuoyancy(
            equation_of_state=getattr(oj, eos)()))
        tm = ot.NonhydrostaticModel(grid=tg, buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=getattr(ot, eos)()))
        js = jm.initial_state()
        ts = tm.initial_state()
        js = js.__class__(**{**js.__dict__, "tracers": {
            "T": jnp.asarray(T), "S": jnp.asarray(S)}})
        ts.tracers = {"T": torch.tensor(T), "S": torch.tensor(S)}
        for kw2 in ({}, {"geopotential_height": 0.0}):
            np.testing.assert_allclose(
                t_diag.seawater_density(tm, ts, **kw2).numpy(),
                np.asarray(j_diag.seawater_density(jm, js, **kw2)),
                rtol=RTOL)


# ---------------------------------------------------------------------------
# The README quick start
# ---------------------------------------------------------------------------

def test_readme_quick_start():
    """README.md's quick start on both packages, at 32² instead of its
    128² and without its HDF5Writer (cuts for time;
    ``tests/test_torch_output.py`` holds the writers): WENO(5), RK3, a
    TimeStepWizard every 10 iterations, to t = 10."""
    sims = []
    for pkg, xp in ((oj, jnp), (ot, torch)):
        kw = {} if pkg is oj else {"dtype": F64}
        grid = pkg.RectilinearGrid(size=(32, 32), x=(0, 2 * np.pi),
                                   y=(0, 2 * np.pi),
                                   topology=(pkg.Periodic, pkg.Periodic,
                                             pkg.Flat), halo=4, **kw)
        Model = JModel if pkg is oj else ot.NonhydrostaticModel
        model = Model(grid=grid, advection=pkg.WENO(5))
        state = model.initial_state(
            u=lambda x, y, z: xp.sin(x) * xp.cos(y))
        sim = pkg.Simulation(model, state=state, dt=0.01, stop_time=10.0)
        sim.callbacks["wizard"] = pkg.Callback(pkg.TimeStepWizard(cfl=0.5),
                                               pkg.IterationInterval(10))
        sim.run()
        sims.append(sim)
    jsim, tsim = sims
    assert ot.iteration(tsim) == oj.iteration(jsim)
    assert math.isclose(tsim.dt, jsim.dt, rel_tol=RTOL)
    assert math.isclose(float(tsim.state.clock.time), 10.0, rel_tol=1e-12)
    assert_states_close(tsim.model.grid, tsim.state, jsim.state,
                        ("u", "v"))
