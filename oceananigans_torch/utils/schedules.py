"""Schedules: when diagnostics/writers/callbacks actuate.

Reference: ``src/Utils/schedules.jl`` — ``TimeInterval``,
``IterationInterval``, ``WallTimeInterval``, ``SpecifiedTimes``,
``AveragedTimeInterval`` (``src/OutputWriters/windowed_time_average.jl:16``).

Counterpart of ``oceananigans_tpu/utils/schedules.py``: host-side objects
that ``Simulation`` consults between its windows of steps; they hold no
tensors.
"""

from __future__ import annotations

import time as _time

import numpy as np

__all__ = ["TimeInterval", "IterationInterval", "WallTimeInterval",
           "SpecifiedTimes", "AveragedTimeInterval", "AndSchedule",
           "OrSchedule"]


class AbstractSchedule:
    def actuates(self, clock) -> bool:
        raise NotImplementedError

    #: time of the next actuation, or None (used for Δt alignment)
    def next_actuation_time(self, clock):
        return None

    #: iteration of the next actuation, or None (used to run the steps
    #: between actuations as one window)
    def next_actuation_iteration(self, clock):
        return None

    def initialize(self, clock):
        pass


class TimeInterval(AbstractSchedule):
    """Actuates every ``interval`` seconds of model time."""

    def __init__(self, interval):
        self.interval = float(interval)
        self.previous_actuation_time = None

    def actuates(self, clock):
        t = float(clock.time)
        n = round(t / self.interval)
        if abs(t - n * self.interval) < 1e-10 * max(1.0, abs(t)):
            if self.previous_actuation_time != n * self.interval:
                self.previous_actuation_time = n * self.interval
                return True
        return False

    def next_actuation_time(self, clock):
        t = float(clock.time)
        n = np.floor(t / self.interval + 1e-12) + 1
        return n * self.interval


class IterationInterval(AbstractSchedule):
    def __init__(self, interval, offset=0):
        self.interval = int(interval)
        self.offset = int(offset)

    def actuates(self, clock):
        return (int(clock.iteration) - self.offset) % self.interval == 0

    def next_actuation_iteration(self, clock):
        it = int(clock.iteration)
        k = (it - self.offset) // self.interval + 1
        return self.offset + k * self.interval


class WallTimeInterval(AbstractSchedule):
    def __init__(self, interval):
        self.interval = float(interval)
        self.previous = _time.monotonic()

    def actuates(self, clock):
        now = _time.monotonic()
        if now - self.previous >= self.interval:
            self.previous = now
            return True
        return False


class SpecifiedTimes(AbstractSchedule):
    def __init__(self, *times):
        if len(times) == 1 and np.ndim(times[0]) == 1:
            times = tuple(times[0])
        self.times = sorted(float(t) for t in times)
        self.previous_index = -1

    def actuates(self, clock):
        t = float(clock.time)
        for i, st in enumerate(self.times):
            if i > self.previous_index and t >= st - 1e-10:
                self.previous_index = i
                return True
        return False

    def next_actuation_time(self, clock):
        t = float(clock.time)
        for st in self.times:
            if st > t + 1e-12:
                return st
        return None


class _CompositeSchedule(AbstractSchedule):
    def __init__(self, *schedules):
        if not schedules:
            raise ValueError("composite schedule needs at least one child")
        self.schedules = tuple(schedules)

    def initialize(self, clock):
        for s in self.schedules:
            s.initialize(clock)

    # Aligning dispatch windows to the EARLIEST child actuation is always
    # safe (actuation itself is re-checked host-side), so both combinators
    # use min over the children's horizons.
    def next_actuation_time(self, clock):
        ts = [t for s in self.schedules
              if (t := s.next_actuation_time(clock)) is not None]
        return min(ts) if ts else None

    def next_actuation_iteration(self, clock):
        its = [i for s in self.schedules
               if (i := s.next_actuation_iteration(clock)) is not None]
        return min(its) if its else None


class AndSchedule(_CompositeSchedule):
    """Actuates when ALL child schedules actuate (reference
    ``src/Utils/schedules.jl`` ``AndSchedule``)."""

    def actuates(self, clock):
        # evaluate every child: stateful schedules must all advance
        return all([s.actuates(clock) for s in self.schedules])


class OrSchedule(_CompositeSchedule):
    """Actuates when ANY child schedule actuates (reference
    ``src/Utils/schedules.jl`` ``OrSchedule``)."""

    def actuates(self, clock):
        return any([s.actuates(clock) for s in self.schedules])


class AveragedTimeInterval(TimeInterval):
    """Like TimeInterval, but outputs are time-averaged over the trailing
    ``window`` with substeps of ``stride`` iterations (reference
    ``windowed_time_average.jl:16``)."""

    def __init__(self, interval, window=None, stride=1):
        super().__init__(interval)
        self.window = float(window if window is not None else interval)
        self.stride = int(stride)

    def averaging(self, clock):
        """True while inside the averaging window preceding an actuation."""
        t = float(clock.time)
        n = np.floor(t / self.interval + 1e-12) + 1
        window_start = n * self.interval - self.window
        return t >= window_start - 1e-12
