"""Carry a nonhydrostatic state across as numpy arrays.

Tests hand the JAX package and the port the same starting state through
these two functions: every field of the state (u, v, w, pressure, Gu, Gv,
Gw, and each tracer and its previous tendency under ``tracers/<name>`` and
``Gtracers/<name>``) as a halo-extended array, and the clock as ``time``,
``iteration`` and ``last_dt``.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.models.nonhydrostatic import NonhydrostaticState
from oceananigans_torch.timesteppers import Clock

FIELDS = ("u", "v", "w", "pressure", "Gu", "Gv", "Gw")
CLOCK = ("time", "iteration", "last_dt")


def tracer_keys(names):
    """The array keys of the tracers ``names`` and their tendencies."""
    return tuple(f"{group}/{n}" for group in ("tracers", "Gtracers")
                 for n in names)


def state_from_numpy(model, arrays):
    """A state of ``model`` (on its device, in its grid's dtype) from a
    mapping of numpy arrays with the keys of :data:`FIELDS`, of
    :func:`tracer_keys` for the model's tracers, and of :data:`CLOCK`. The
    tensors are copies."""
    g = model.grid
    names = model.tracer_names
    missing = set(FIELDS + tracer_keys(names) + CLOCK) - set(arrays)
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
    return NonhydrostaticState(
        clock=clock, **{name: tensor(name) for name in FIELDS},
        tracers={n: tensor(f"tracers/{n}") for n in names},
        Gtracers={n: tensor(f"Gtracers/{n}") for n in names})


def state_to_numpy(state):
    """The state's fields, tracers and clock as numpy arrays (copied to the
    host)."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in FIELDS}
    for group in ("tracers", "Gtracers"):
        for n, t in getattr(state, group).items():
            out[f"{group}/{n}"] = t.detach().cpu().numpy()
    out["time"] = state.clock.time.numpy()
    out["iteration"] = np.asarray(state.clock.iteration)
    out["last_dt"] = state.clock.last_dt.numpy()
    return out


__all__ = ["CLOCK", "FIELDS", "state_from_numpy", "state_to_numpy",
           "tracer_keys"]
