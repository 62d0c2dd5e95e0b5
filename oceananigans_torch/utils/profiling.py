"""Tracing and step timing: ``trace(logdir)`` on ``torch.profiler`` and a
per-window timing callback.

Counterpart of ``oceananigans_tpu/utils/profiling.py``, with
``torch.profiler`` in place of ``jax.profiler``.

Usage::

    with trace("traces/run"):              # open in Perfetto or TensorBoard
        sim.run()

    sim.callbacks["timing"] = Callback(StepTimer(), IterationInterval(50))
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` trace of the host and, where there is one, the
    CUDA device, for anything run inside; written to ``logdir`` as a
    Chrome trace (``trace.json``) when the context exits. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class StepTimer:
    """Progress callback printing iteration, model time, and wall-clock
    time per step since the previous call (the reference's
    ``run_wall_time`` bookkeeping, per window)."""

    def __init__(self, printer=print):
        self._last_wall = None
        self._last_iter = 0
        self._printer = printer

    def __call__(self, sim):
        now = time.monotonic()
        it = int(sim.state.clock.iteration)
        t = float(sim.state.clock.time)
        if self._last_wall is not None and it > self._last_iter:
            per_step = (now - self._last_wall) / (it - self._last_iter)
            self._printer(f"iter {it:7d}  t={t:12.3f}  "
                          f"{per_step * 1e3:8.2f} ms/step")
        else:
            self._printer(f"iter {it:7d}  t={t:12.3f}")
        self._last_wall = now
        self._last_iter = it
