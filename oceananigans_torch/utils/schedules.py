"""Schedules: when diagnostics/writers/callbacks actuate.

Reference: ``src/Utils/schedules.jl`` — ``TimeInterval``,
``IterationInterval``, ``WallTimeInterval``, ``SpecifiedTimes``,
``AveragedTimeInterval`` (``src/OutputWriters/windowed_time_average.jl:16``).

Counterpart of ``oceananigans_tpu/utils/schedules.py``: host-side objects
that ``Simulation`` consults between its windows of steps; they hold no
tensors.

A clock coarser than float64 compares times in its own precision (see
``time_margin``); a float64 clock keeps the JAX package's margins.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

__all__ = ["TimeInterval", "IterationInterval", "WallTimeInterval",
           "SpecifiedTimes", "AveragedTimeInterval", "AndSchedule",
           "OrSchedule", "time_margin"]

#: the margin of a clock coarser than float64, in units of its machine
#: epsilon times its time (16 to 32 ulps of the time)
MARGIN_EPS = 16


def time_margin(clock):
    """How far the clock's time may lie from a time and still be at it,
    beyond the JAX package's margins (1e-10 of max(1, |t|) in
    ``TimeInterval``, 1e-10 and 1e-12 elsewhere), which are kept as they
    are. 0 for a float64 clock or a plain float. A float32 clock sums its
    steps with a rounding of up to half an ulp each, so a window of steps
    aligned onto a time can end a few ulps from it (50 steps of 1e-4 s end
    1.1e-10 s short of 5e-3 s, outside the 1e-10 margin); its margin is
    ``MARGIN_EPS`` × its epsilon × |t|. A window that ends further off
    takes one more, short step onto the time."""
    if not isinstance(clock.time, torch.Tensor):
        return 0.0
    finfo = torch.finfo(clock.time.dtype)
    if finfo.bits >= 64:
        return 0.0
    return MARGIN_EPS * finfo.eps * abs(float(clock.time))


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
        margin = max(1e-10 * max(1.0, abs(t)), time_margin(clock))
        if abs(t - n * self.interval) < margin:
            if self.previous_actuation_time != n * self.interval:
                self.previous_actuation_time = n * self.interval
                return True
        return False

    def _next_multiple(self, clock):
        t = float(clock.time)
        return np.floor((t + time_margin(clock)) / self.interval
                        + 1e-12) + 1

    def next_actuation_time(self, clock):
        return self._next_multiple(clock) * self.interval


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
        margin = max(1e-10, time_margin(clock))
        for i, st in enumerate(self.times):
            if i > self.previous_index and t >= st - margin:
                self.previous_index = i
                return True
        return False

    def next_actuation_time(self, clock):
        t = float(clock.time)
        margin = max(1e-12, time_margin(clock))
        for st in self.times:
            if st > t + margin:
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
        window_start = self._next_multiple(clock) * self.interval - self.window
        return t >= window_start - max(1e-12, time_margin(clock))
