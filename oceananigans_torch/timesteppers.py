"""Time stepping coefficients and the clock.

Counterpart of ``oceananigans_tpu/timesteppers.py``. The clock's time and
last step are 0-d tensors in the state's dtype, so float32 time accumulates
exactly as the JAX package's does. They stay on the CPU whatever the model's
device: nothing on the device reads them in this slice, and a host scalar
costs no kernel launch and no synchronisation. The iteration is a Python
int, so the AB2 Euler first step is a host branch. A clock may carry a
calendar origin, ``epoch`` (a ``datetime.datetime`` or None): the time stays
in seconds since it, the step never does calendar arithmetic, and
``clock.date`` reads the calendar time on the host.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch


@dataclasses.dataclass
class Clock:
    time: torch.Tensor
    iteration: int
    last_dt: torch.Tensor
    epoch: datetime.datetime | None = None

    @classmethod
    def start(cls, time=0.0, dtype=torch.float64, epoch=None):
        """A clock at ``time`` seconds; a ``datetime`` starts the clock at 0
        s with that epoch."""
        if isinstance(time, datetime.datetime):
            epoch, time = time, 0.0
        t = torch.tensor(float(time), dtype=dtype)
        return cls(time=t, iteration=0, last_dt=torch.zeros_like(t),
                   epoch=epoch)

    @property
    def date(self):
        """Calendar time ``epoch + time`` seconds, or None without an
        epoch."""
        if self.epoch is None:
            return None
        return self.epoch + datetime.timedelta(seconds=float(self.time))


def tick(clock: Clock, dt) -> Clock:
    return Clock(time=clock.time + dt, iteration=clock.iteration + 1,
                 last_dt=torch.as_tensor(dt, dtype=clock.time.dtype).clone(),
                 epoch=clock.epoch)


#: low-storage Wray RK3 (γ, ζ) per stage: Ψ += Δt (γ Gⁿ + ζ G⁻); the
#: pressure correction of each stage uses the substep Δt·(γ+ζ).
RK3_STAGES = ((8.0 / 15.0, 0.0),
              (5.0 / 12.0, -17.0 / 60.0),
              (3.0 / 4.0, -5.0 / 12.0))


def ab2_coefficients(iteration: int, chi=0.1):
    """Quasi-AB2 coefficients: Euler on iteration 0, else
    ``(3/2+χ, −(1/2+χ))``."""
    if iteration == 0:
        return 1.0, 0.0
    return 1.5 + chi, -(0.5 + chi)


__all__ = ["Clock", "RK3_STAGES", "ab2_coefficients", "tick"]
