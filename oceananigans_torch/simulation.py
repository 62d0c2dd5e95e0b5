"""Simulation driver: the run loop, callbacks, adaptive Δt, NaN guard.

Counterpart of ``oceananigans_tpu/simulation.py`` (reference
``src/Simulations/``: ``Simulation``, ``run!``, the Δt alignment of
``run.jl:24-57``, ``Callback``, ``TimeStepWizard``, and ``NaNChecker`` of
``src/Models/nan_checker.jl``).

The schedules stay on the host. Between two actuations the driver runs one
window of steps: a halo fill, then n × ``model.step(state, dt,
assume_filled=True)`` (every step ends with a fill, so only the window's
first step needs one); a window of one step, or of a model whose ``step``
takes no ``assume_filled`` (the cubed sphere's shallow water, which fills
before each stage), is ``model.step(state, dt)`` in turn.
The JAX package compiles a window into one ``lax.fori_loop`` dispatch;
here it is a plain host loop that launches each step's kernels in turn.

Output writers are duck-typed, as the JAX loop calls them: an object with a
``schedule`` and a ``write(simulation)`` method (``output.py`` holds the
package's own). Inside the averaging window of a writer on an
``AveragedTimeInterval`` the windows are one step long, and after each the
writer's ``WindowedTimeAverage`` outputs accumulate. ``run(pickup=...)``
restores the state from the first ``Checkpointer`` among the writers.
"""

from __future__ import annotations

import inspect
import math
import os
import time as _time
from typing import Dict

import numpy as np
import torch

from oceananigans_torch.output import (
    Checkpointer, OrbaxCheckpointer, WindowedTimeAverage,
)
from oceananigans_torch.utils.pretty import prettytime
from oceananigans_torch.utils.schedules import (
    AveragedTimeInterval, IterationInterval, time_margin,
)

__all__ = ["Simulation", "Callback", "TimeStepWizard", "NaNChecker",
           "add_callback", "conjure_time_step_wizard", "iteration",
           "TimeStepCallsite", "TendencyCallsite", "UpdateStateCallsite"]

# callback callsites (reference src/Oceananigans.jl:186-188):
#   TimeStepCallsite    after a window of steps (host side)
#   UpdateStateCallsite right after the state update and halo fill, before
#                       the time-step callbacks and writers (host side;
#                       also fired once at initialize)
#   TendencyCallsite    inside the step: the callback is a function
#                       (grid, state, {name: G}) -> {name: G} applied at
#                       the end of the model's compute_tendencies (its
#                       schedule is ignored: it runs every step)
TimeStepCallsite = "time_step"
TendencyCallsite = "tendency"
UpdateStateCallsite = "update_state"


class Callback:
    """func(simulation) on a schedule; ``callsite`` is one of
    ``TimeStepCallsite`` (default), ``UpdateStateCallsite`` or
    ``TendencyCallsite`` (see the constants above)."""

    def __init__(self, func, schedule=None, callsite=TimeStepCallsite):
        self.func = func
        self.schedule = schedule or IterationInterval(1)
        self.callsite = callsite

    def __call__(self, sim):
        return self.func(sim)


class TimeStepWizard:
    """Adaptive Δt targeting an advective CFL (reference
    ``time_step_wizard.jl:5-14``)."""

    def __init__(self, cfl=0.2, diffusive_cfl=np.inf, max_change=1.1,
                 min_change=0.5, max_dt=np.inf, min_dt=0.0):
        self.cfl = cfl
        self.diffusive_cfl = diffusive_cfl
        self.max_change = max_change
        self.min_change = min_change
        self.max_dt = max_dt
        self.min_dt = min_dt

    def __call__(self, sim):
        tau = float(sim.model.cfl_timescale(sim.state))
        new_dt = self.cfl * tau
        if np.isfinite(self.diffusive_cfl):
            tau_d = float(sim.model.diffusion_timescale(sim.state))
            new_dt = min(new_dt, self.diffusive_cfl * tau_d)
        new_dt = min(new_dt, self.max_change * sim.dt)
        new_dt = max(new_dt, self.min_change * sim.dt)
        sim.dt = float(np.clip(new_dt, self.min_dt, self.max_dt))


class NaNChecker:
    """Halts the run when a velocity field goes non-finite (wired as a
    default IterationInterval(100) callback, as the reference's Simulation
    constructor does)."""

    def __init__(self, fields=("u",)):
        self.fields = fields

    def __call__(self, sim):
        state_fields = sim.state.fields()
        names = [n for n in self.fields if n in state_fields]
        if not names:
            # a state without the configured names (e.g. a shallow-water
            # model's (uh, vh, h)): guard the first prognostic field
            names = [next(iter(state_fields))]
        for name in names:
            if not bool(torch.isfinite(state_fields[name]).all()):
                sim.running = False
                sim.stop_reason = f"NaN found in field {name!r}"
                raise RuntimeError(
                    f"time step {int(sim.state.clock.iteration)}: "
                    f"NaN found in {name!r}; aborting simulation")


class Simulation:
    """Drives ``model.step`` with schedules, callbacks and writers::

        sim = Simulation(model, state, dt=0.01, stop_time=10.0)
        sim.callbacks["progress"] = Callback(print_progress,
                                             IterationInterval(10))
        sim.run()

    ``sim.state`` holds the current state. The models' ``step`` reuses its
    argument's storage (halo fills write in place), so a caller that needs
    a state from before ``run`` keeps a copy.
    """

    def __init__(self, model, state=None, dt=None, stop_time=None,
                 stop_iteration=None, wall_time_limit=None):
        if dt is None:
            raise ValueError("Simulation needs dt=")
        self.model = model
        self.state = state if state is not None else model.initial_state()
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit
        self.callbacks: Dict[str, Callback] = {
            "nan_checker": Callback(NaNChecker(), IterationInterval(100)),
        }
        self.output_writers: Dict[str, object] = {}
        self.running = True
        self.stop_reason = None
        self.run_wall_time = 0.0
        self.initialized = False

    # ------------------------------------------------------------------
    def _step_window(self, n, dt):
        """n steps of ``dt`` from the current state: one fill, then steps
        that skip their leading fill (every step ends with one; the fill
        at the window's start covers host-side changes of the state
        between windows, by callbacks or the caller)."""
        model, state = self.model, self.state
        if n == 1 or "assume_filled" not in inspect.signature(
                model.step).parameters:
            # a model whose step always begins with its fill (the cubed
            # sphere's shallow water) steps plainly
            for _ in range(n):
                state = model.step(state, dt)
            return state
        state = model.fill_state_halos(state)
        for _ in range(n):
            state = model.step(state, dt, assume_filled=True)
        return state

    def _all_schedules(self):
        for cb in self.callbacks.values():
            yield cb.schedule
        for w in self.output_writers.values():
            yield w.schedule

    def _aligned_steps(self):
        """(n_steps, dt): how many dt-steps until the next schedule
        actuation / stop time (reference aligned_time_step, run.jl:24-57),
        run as one window. Time-based schedules bound the window by a TIME
        horizon (Δt shrinks to land exactly on it); iteration-based
        schedules bound it by a STEP-count horizon — e.g. the default
        IterationInterval(100) NaN checker allows 100-step windows. On a
        clock coarser than float64, plain steps that land within the
        clock's ``time_margin`` of the time horizon are kept as they are."""
        clock = self.state.clock
        t = float(clock.time)
        margin = time_margin(clock)
        horizon_t = math.inf      # model time until next time actuation
        horizon_n = math.inf      # steps until next iteration actuation
        if self.stop_time is not None:
            horizon_t = min(horizon_t, self.stop_time - t)
        for s in self._all_schedules():
            nt = s.next_actuation_time(clock)
            if nt is not None:
                horizon_t = min(horizon_t, nt - t)
                continue
            ni = s.next_actuation_iteration(clock)
            if ni is not None:
                horizon_n = min(horizon_n, ni - int(clock.iteration))
                continue
            # wall-time / unknown schedules: check every step
            horizon_n = 1
        if math.isfinite(horizon_t) and horizon_t > 0:
            n_t = max(1, int(math.ceil((horizon_t - margin) / self.dt
                                       - 1e-9)))
        else:
            n_t = 1 if horizon_t <= 0 else None
        if not math.isfinite(horizon_n):
            horizon_n = None
        if n_t is None and horizon_n is None:
            return 1, self.dt
        if horizon_n is not None and (n_t is None or horizon_n < n_t):
            # the iteration horizon binds: plain dt, no alignment needed
            return max(1, int(horizon_n)), self.dt
        n = n_t
        if margin and abs(n * self.dt - horizon_t) <= margin:
            return n, self.dt
        dt = min(self.dt, horizon_t / n)
        # align exactly onto the time horizon when within one window
        if n * self.dt > horizon_t - 1e-12:
            dt = horizon_t / n
        if bool(clock.time + dt == clock.time):
            raise RuntimeError(
                f"time step {dt!r} does not advance the clock's time "
                f"{t!r} ({clock.time.dtype}); the run would not progress")
        return n, dt

    # ------------------------------------------------------------------
    def _host_callbacks(self):
        """(update_state, time_step) host-side callbacks, in callsite
        order; TendencyCallsite callbacks run inside the step instead."""
        upd = [cb for cb in self.callbacks.values()
               if getattr(cb, "callsite", TimeStepCallsite)
               == UpdateStateCallsite]
        ts = [cb for cb in self.callbacks.values()
              if getattr(cb, "callsite", TimeStepCallsite)
              not in (UpdateStateCallsite, TendencyCallsite)]
        return upd, ts

    def _wire_tendency_callbacks(self):
        """Hand the TendencyCallsite callbacks to the model as its
        ``tendency_callbacks`` hooks (grid, state, {name: G}) -> {name:
        G}."""
        funcs = tuple(cb.func for cb in self.callbacks.values()
                      if getattr(cb, "callsite", None) == TendencyCallsite)
        if funcs and funcs != getattr(self.model, "tendency_callbacks",
                                      ()):
            self.model.tendency_callbacks = funcs

    def _inside_averaging_window(self):
        return any(isinstance(w.schedule, AveragedTimeInterval)
                   and w.schedule.averaging(self.state.clock)
                   for w in self.output_writers.values())

    def _check_checkpointers(self):
        """Under a model that runs over several ranks (one with a ``dist``
        of world size > 1) every rank's state is its own block, and a plain
        ``Checkpointer`` would save all of them to one file: only the
        sharded ``OrbaxCheckpointer`` is taken there."""
        dist = getattr(self.model, "dist", None)
        if dist is None or dist.world_size == 1:
            return
        for name, w in self.output_writers.items():
            if isinstance(w, Checkpointer) and \
                    not isinstance(w, OrbaxCheckpointer):
                raise ValueError(
                    f"output writer {name!r}: a Checkpointer would save "
                    f"every one of the {dist.world_size} ranks' blocks to "
                    "one file; use OrbaxCheckpointer, which saves a file a "
                    "rank")

    def initialize(self):
        """Actuate everything once at iteration 0 (reference
        run.jl:203-252)."""
        self._check_checkpointers()
        self._wire_tendency_callbacks()
        upd, ts = self._host_callbacks()
        for cb in upd + ts:
            cb.schedule.initialize(self.state.clock)
            if cb.schedule.actuates(self.state.clock):
                cb(self)
        views = self._writer_views()
        for w in self.output_writers.values():
            w.schedule.initialize(self.state.clock)
            target = views(w)
            if target is not None:
                w.write(target)
        self.initialized = True

    def _writer_views(self):
        """``view(writer)``: what ``writer`` writes from. A checkpointer
        takes the simulation itself (the state the step runs on: under a
        ``DistributedModel`` each rank's local block); the other writers
        take the model's ``writer_sim`` view where it has one (the global,
        halo-filled state, on rank 0 only: None elsewhere), built once on
        first use, since it gathers."""
        cache = []

        def view(writer):
            if isinstance(writer, Checkpointer) or \
                    not hasattr(self.model, "writer_sim"):
                return self
            if not cache:
                cache.append(self.model.writer_sim(self))
            return cache[0]
        return view

    def _should_stop(self):
        if self.stop_iteration is not None and (
                int(self.state.clock.iteration) >= self.stop_iteration):
            self.stop_reason = "stop_iteration reached"
            return True
        if self.stop_time is not None and (
                float(self.state.clock.time) >= self.stop_time
                - max(1e-12, time_margin(self.state.clock))):
            self.stop_reason = "stop_time reached"
            return True
        if self.wall_time_limit is not None and (
                self.run_wall_time > self.wall_time_limit):
            self.stop_reason = "wall_time_limit exceeded"
            return True
        return False

    def run(self, pickup=False):
        """The run loop (reference run.jl:92-113); returns the final state.
        ``pickup=True`` first restores the latest checkpoint of the first
        ``Checkpointer`` among the output writers (reference run.jl:66-98);
        ``pickup`` may also be a checkpoint's path."""
        self._check_checkpointers()
        if pickup:
            ckpt = next((w for w in self.output_writers.values()
                         if isinstance(w, Checkpointer)), None)
            if ckpt is None:
                raise ValueError("pickup requested but no Checkpointer "
                                 "among output_writers")
            path = pickup if isinstance(pickup, (str, os.PathLike)) else None
            self.state = ckpt.restore(self.state, path=path)
        if not self.initialized:
            self.initialize()
        while self.running and not self._should_stop():
            t0 = _time.monotonic()
            n, dt = self._aligned_steps()
            if self._inside_averaging_window():
                n = 1   # accumulate after every step inside the window
            if self.stop_iteration is not None:
                n = min(n, self.stop_iteration
                        - int(self.state.clock.iteration))
                n = max(n, 1)
            self.state = self._step_window(n, dt)
            self.run_wall_time += _time.monotonic() - t0

            upd, ts = self._host_callbacks()
            for cb in upd + ts:
                if cb.schedule.actuates(self.state.clock):
                    cb(self)
            views = self._writer_views()
            for w in self.output_writers.values():
                self._accumulate_averages(w, views)
                if w.schedule.actuates(self.state.clock):
                    target = views(w)
                    if target is not None:
                        w.write(target)
        return self.state

    def _accumulate_averages(self, writer, views):
        """Add the current state to ``writer``'s ``WindowedTimeAverage``
        outputs while its ``AveragedTimeInterval`` is averaging (reference
        windowed_time_average.jl)."""
        if not (isinstance(writer.schedule, AveragedTimeInterval)
                and writer.schedule.averaging(self.state.clock)):
            return
        target = views(writer)
        if target is None:
            return
        for out in getattr(writer, "outputs", {}).values():
            if isinstance(out, WindowedTimeAverage):
                out.accumulate(target.model, target.state)

    def __repr__(self):
        return (f"Simulation(t={prettytime(float(self.state.clock.time))}, "
                f"iteration={int(self.state.clock.iteration)}, "
                f"dt={self.dt:g})")


def add_callback(sim, func, schedule=None, name=None,
                 callsite=TimeStepCallsite):
    """Attach a callback (reference ``add_callback!(sim, func; schedule,
    name)``). ``func`` may be a plain function or a :class:`Callback`."""
    cb = func if isinstance(func, Callback) else Callback(func, schedule,
                                                          callsite)
    if name is None:
        name = (getattr(func, "__name__", None)
                or f"callback{len(sim.callbacks)}")
        base, k = name, 1
        while name in sim.callbacks:
            name = f"{base}{k}"
            k += 1
    sim.callbacks[name] = cb
    return name


def conjure_time_step_wizard(sim, schedule=None, **wizard_kwargs):
    """Attach a :class:`TimeStepWizard` on a schedule (reference
    ``conjure_time_step_wizard!(sim, schedule; kwargs...)``, default every
    5 iterations)."""
    schedule = schedule or IterationInterval(5)
    sim.callbacks["time_step_wizard"] = Callback(
        TimeStepWizard(**wizard_kwargs), schedule)


def iteration(sim):
    """Current iteration count (reference ``iteration(sim)``)."""
    return int(sim.state.clock.iteration)
