"""Carry a model state across as numpy arrays.

Tests hand the JAX package and the port the same starting state through
these two functions: every field of the state as a halo-extended array,
each tracer and its previous tendency under ``tracers/<name>`` and
``Gtracers/<name>``, and the clock as ``time``, ``iteration`` and
``last_dt``. The fields are :data:`FIELDS` for a nonhydrostatic state (u,
v, w, pressure, Gu, Gv, Gw) and :data:`SW_FIELDS` for a shallow-water one
(uh, vh, h, Guh, Gvh, Gh).
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.models.nonhydrostatic import NonhydrostaticState
from oceananigans_torch.models.shallow_water import (
    ShallowWaterModel, ShallowWaterState,
)
from oceananigans_torch.timesteppers import Clock

FIELDS = ("u", "v", "w", "pressure", "Gu", "Gv", "Gw")
SW_FIELDS = ("uh", "vh", "h", "Guh", "Gvh", "Gh")
CLOCK = ("time", "iteration", "last_dt")


def tracer_keys(names):
    """The array keys of the tracers ``names`` and their tendencies."""
    return tuple(f"{group}/{n}" for group in ("tracers", "Gtracers")
                 for n in names)


def state_from_numpy(model, arrays):
    """A state of ``model`` (on its device, in its grid's dtype) from a
    mapping of numpy arrays with the keys of the model's fields
    (:data:`FIELDS`, or :data:`SW_FIELDS` for a ``ShallowWaterModel``), of
    :func:`tracer_keys` for its tracers, and of :data:`CLOCK`. The tensors
    are copies."""
    g = model.grid
    names = model.tracer_names
    if isinstance(model, ShallowWaterModel):
        cls, fields = ShallowWaterState, SW_FIELDS
    else:
        cls, fields = NonhydrostaticState, FIELDS
    missing = set(fields + tracer_keys(names) + CLOCK) - set(arrays)
    if missing:
        raise KeyError(f"state_from_numpy needs {sorted(missing)}")

    def tensor(key):
        a = np.asarray(arrays[key])
        if a.shape != tuple(g.shape):
            raise ValueError(f"{key}: shape {a.shape} != grid {g.shape}")
        return torch.tensor(a, dtype=g.dtype, device=g.device)

    clock = Clock(time=torch.tensor(float(arrays["time"]), dtype=g.dtype),
                  iteration=int(arrays["iteration"]),
                  last_dt=torch.tensor(float(arrays["last_dt"]),
                                       dtype=g.dtype))
    return cls(clock=clock, **{name: tensor(name) for name in fields},
               tracers={n: tensor(f"tracers/{n}") for n in names},
               Gtracers={n: tensor(f"Gtracers/{n}") for n in names})


def state_to_numpy(state):
    """The state's fields, tracers and clock as numpy arrays (copied to the
    host)."""
    fields = SW_FIELDS if isinstance(state, ShallowWaterState) else FIELDS
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in fields}
    for group in ("tracers", "Gtracers"):
        for n, t in getattr(state, group).items():
            out[f"{group}/{n}"] = t.detach().cpu().numpy()
    out["time"] = state.clock.time.numpy()
    out["iteration"] = np.asarray(state.clock.iteration)
    out["last_dt"] = state.clock.last_dt.numpy()
    return out


__all__ = ["CLOCK", "FIELDS", "SW_FIELDS", "state_from_numpy",
           "state_to_numpy", "tracer_keys"]
