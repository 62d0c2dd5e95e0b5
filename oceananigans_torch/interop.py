"""Carry a model state and a grid across as numpy arrays.

Tests hand the JAX package and the port the same starting state through
:func:`state_from_numpy` and :func:`state_to_numpy`: every field of the
state as a halo-extended array,
each tracer and its previous tendency under ``tracers/<name>`` and
``Gtracers/<name>``, and the clock as ``time``, ``iteration`` and
``last_dt``. The fields are :data:`FIELDS` for a nonhydrostatic state (u,
v, w, pressure, Gu, Gv, Gw), :data:`SW_FIELDS` for a shallow-water one (uh,
vh, h, Guh, Gvh, Gh) and :data:`HYDROSTATIC_FIELDS` for a hydrostatic one
(u, v, w, Gu, Gv, and η, Gη and the barotropic transports U, V, these four
shaped (nx, ny, 1)). They build both packages' grids from the same
constructor arguments (:func:`grid_from_arguments`); an orthogonal grid's
(λ, φ) nodes cross as numpy arrays (:func:`orthogonal_nodes`,
:func:`orthogonal_grid_like`).
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch import grids
from oceananigans_torch.grids.orthogonal import (
    NODE_KEYS, OrthogonalSphericalShellGrid,
)
from oceananigans_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, HydrostaticState,
)
from oceananigans_torch.models.nonhydrostatic import NonhydrostaticState
from oceananigans_torch.models.shallow_water import (
    ShallowWaterModel, ShallowWaterState,
)
from oceananigans_torch.timesteppers import Clock

FIELDS = ("u", "v", "w", "pressure", "Gu", "Gv", "Gw")
SW_FIELDS = ("uh", "vh", "h", "Guh", "Gvh", "Gh")
HYDROSTATIC_FIELDS = ("u", "v", "w", "eta", "Gu", "Gv", "Geta", "U", "V")
#: the hydrostatic fields without a z extent
FIELDS_2D = ("eta", "Geta", "U", "V")
CLOCK = ("time", "iteration", "last_dt")


def tracer_keys(names):
    """The array keys of the tracers ``names`` and their tendencies."""
    return tuple(f"{group}/{n}" for group in ("tracers", "Gtracers")
                 for n in names)


def state_from_numpy(model, arrays):
    """A state of ``model`` (on its device, in its grid's dtype) from a
    mapping of numpy arrays with the keys of the model's fields
    (:data:`FIELDS`, :data:`SW_FIELDS` for a ``ShallowWaterModel`` or
    :data:`HYDROSTATIC_FIELDS` for a ``HydrostaticFreeSurfaceModel``), of
    :func:`tracer_keys` for its tracers, and of :data:`CLOCK`. The tensors
    are copies."""
    g = model.grid
    names = model.tracer_names
    if isinstance(model, ShallowWaterModel):
        cls, fields = ShallowWaterState, SW_FIELDS
    elif isinstance(model, HydrostaticFreeSurfaceModel):
        cls, fields = HydrostaticState, HYDROSTATIC_FIELDS
    else:
        cls, fields = NonhydrostaticState, FIELDS
    missing = set(fields + tracer_keys(names) + CLOCK) - set(arrays)
    if missing:
        raise KeyError(f"state_from_numpy needs {sorted(missing)}")

    def tensor(key):
        a = np.asarray(arrays[key])
        shape = tuple(g.shape)
        if cls is HydrostaticState and key in FIELDS_2D:
            shape = shape[:2] + (1,)
        if a.shape != shape:
            raise ValueError(f"{key}: shape {a.shape} != {shape}")
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
    fields = (SW_FIELDS if isinstance(state, ShallowWaterState)
              else HYDROSTATIC_FIELDS if isinstance(state, HydrostaticState)
              else FIELDS)
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in fields}
    for group in ("tracers", "Gtracers"):
        for n, t in getattr(state, group).items():
            out[f"{group}/{n}"] = t.detach().cpu().numpy()
    out["time"] = state.clock.time.numpy()
    out["iteration"] = np.asarray(state.clock.iteration)
    out["last_dt"] = state.clock.last_dt.numpy()
    return out


def grid_from_arguments(kind, **kwargs):
    """The port's grid ``kind`` ("RectilinearGrid", "LatitudeLongitudeGrid",
    "OrthogonalSphericalShellGrid", "RotatedLatitudeLongitudeGrid" or
    "TripolarGrid") from the keyword arguments that build the JAX package's
    grid of that name (``dtype`` may be a name), plus ``device=``."""
    return getattr(grids, kind)(**kwargs)


def orthogonal_nodes(grid):
    """``(lam, phi)``: the (λ, φ) nodes of an orthogonal spherical-shell
    grid of either package, dicts of float64 numpy (nx, ny) arrays keyed by
    ``NODE_KEYS``, as ``OrthogonalSphericalShellGrid`` takes them."""
    def nodes(name):
        return {k: np.asarray(getattr(grid, f"{name}{k.upper()}"),
                              dtype=np.float64)[:, :, 0] for k in NODE_KEYS}
    return nodes("lam"), nodes("phi")


def orthogonal_grid_like(grid, **kwargs):
    """The port's ``OrthogonalSphericalShellGrid`` with the nodes, sizes,
    halos, topology, zipper flag, radius and regular z of ``grid`` (either
    package's); ``kwargs`` add ``dtype`` and ``device``."""
    lam, phi = orthogonal_nodes(grid)
    z0 = float(np.asarray(grid.zF).reshape(-1)[grid.H[2]])
    return OrthogonalSphericalShellGrid(
        lam, phi, (z0, z0 + grid.Lz), grid.N, halo=grid.H,
        radius=grid.radius, topology=grid.topology, zipper=grid.zipper,
        **kwargs)


__all__ = ["CLOCK", "FIELDS", "FIELDS_2D", "HYDROSTATIC_FIELDS",
           "SW_FIELDS", "grid_from_arguments", "orthogonal_grid_like",
           "orthogonal_nodes", "state_from_numpy", "state_to_numpy",
           "tracer_keys"]
