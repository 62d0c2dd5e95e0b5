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
shaped (nx, ny, 1)). A model's Lagrangian particles cross as
``particles/x``, ``particles/y``, ``particles/z`` and
``particles/properties/<name>``, 1-D arrays. They build both packages' grids from the same
constructor arguments (:func:`grid_from_arguments`); an orthogonal grid's
(λ, φ) nodes cross as numpy arrays (:func:`orthogonal_nodes`,
:func:`orthogonal_grid_like`).

The cubed sphere's states cross the same way, as stacked (6, nx, ny, ·)
arrays: :data:`CS_SW_FIELDS` for a ``CubedSphereState`` (u, v, h and their
previous tendencies, each (6, nx, ny, 1)) and :data:`CS_HYDROSTATIC_FIELDS`
for a ``CubedSphereHydrostaticState`` (u, v, η, U, V), with Gu, Gv and Gη
(:data:`CS_AB2_FIELDS`) and the ``Gtracers`` when the state has them (a
quasi-AB2 model's does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oceananigans_torch import grids
from oceananigans_torch.grids.orthogonal import (
    NODE_KEYS, OrthogonalSphericalShellGrid,
)
from oceananigans_torch.grids.cubed_sphere_grid import (
    ConformalCubedSphereGrid,
)
from oceananigans_torch.models.cubed_sphere import (
    CubedSphereHydrostaticModel, CubedSphereHydrostaticState,
    CubedSphereShallowWaterModel, CubedSphereState,
)
from oceananigans_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, HydrostaticState,
)
from oceananigans_torch.models.nonhydrostatic import NonhydrostaticState
from oceananigans_torch.models.shallow_water import (
    ShallowWaterModel, ShallowWaterState,
)
from oceananigans_torch.particles import ParticleState
from oceananigans_torch.timesteppers import Clock

FIELDS = ("u", "v", "w", "pressure", "Gu", "Gv", "Gw")
SW_FIELDS = ("uh", "vh", "h", "Guh", "Gvh", "Gh")
HYDROSTATIC_FIELDS = ("u", "v", "w", "eta", "Gu", "Gv", "Geta", "U", "V")
#: the hydrostatic fields without a z extent
FIELDS_2D = ("eta", "Geta", "U", "V")
CLOCK = ("time", "iteration", "last_dt")
CS_SW_FIELDS = ("u", "v", "h", "Gu", "Gv", "Gh")
CS_HYDROSTATIC_FIELDS = ("u", "v", "eta", "U", "V")
CS_AB2_FIELDS = ("Gu", "Gv", "Geta")
#: the cubed-sphere fields with one level
CS_FIELDS_2D = ("eta", "U", "V", "Geta")


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
    are copies. A cubed-sphere model's state takes the keys of
    :data:`CS_SW_FIELDS` or :data:`CS_HYDROSTATIC_FIELDS` (see
    :func:`cube_state_from_numpy`). A model with particles takes them
    from the ``particles/...`` keys where they are given, else from its
    particles' initial positions."""
    if isinstance(model, (CubedSphereShallowWaterModel,
                          CubedSphereHydrostaticModel)):
        return cube_state_from_numpy(model, arrays)
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

    extra = {}
    particles = getattr(model, "particles", None)
    if particles is not None:
        extra["particles"] = _particles_from_numpy(particles, arrays, g)
    return cls(clock=_clock_from_numpy(arrays, g.dtype),
               **{name: tensor(name) for name in fields},
               tracers={n: tensor(f"tracers/{n}") for n in names},
               Gtracers={n: tensor(f"Gtracers/{n}") for n in names},
               **extra)


def _particles_from_numpy(particles, arrays, grid):
    """The particle state from the ``particles/...`` keys of ``arrays``,
    or ``particles``' initial one, in ``grid``'s dtype on its device."""
    if "particles/x" not in arrays:
        return particles.state_on(grid)

    def tensor(key):
        return torch.tensor(np.asarray(arrays[key]), dtype=grid.dtype,
                            device=grid.device)
    return ParticleState(
        x=tensor("particles/x"), y=tensor("particles/y"),
        z=tensor("particles/z"),
        properties={k: tensor(f"particles/properties/{k}")
                    for k in particles.tracked_fields})


def _clock_from_numpy(arrays, dtype):
    return Clock(time=torch.tensor(float(arrays["time"]), dtype=dtype),
                 iteration=int(arrays["iteration"]),
                 last_dt=torch.tensor(float(arrays["last_dt"]), dtype=dtype))


def cube_state_from_numpy(model, arrays):
    """A cubed-sphere state of ``model`` from stacked numpy arrays: the
    keys of :data:`CS_SW_FIELDS` for the shallow-water model; of
    :data:`CS_HYDROSTATIC_FIELDS` for the hydrostatic one, with
    :data:`CS_AB2_FIELDS` and the ``Gtracers`` under quasi-AB2; the
    tracers and :data:`CLOCK`."""
    grid = model.grid
    names = model.tracer_names
    nx, ny, nz = grid.panel_grid.shape
    sw = isinstance(model, CubedSphereShallowWaterModel)
    ab2 = (not sw) and model.timestepper == "QuasiAdamsBashforth2"
    fields = (CS_SW_FIELDS if sw else CS_HYDROSTATIC_FIELDS
              + (CS_AB2_FIELDS if ab2 else ()))
    groups = ("tracers", "Gtracers") if (sw or ab2) else ("tracers",)
    keys = fields + tuple(f"{g}/{n}" for g in groups for n in names)
    missing = set(keys + CLOCK) - set(arrays)
    if missing:
        raise KeyError(f"cube_state_from_numpy needs {sorted(missing)}")

    def tensor(key):
        a = np.asarray(arrays[key])
        one = sw or key.split("/")[0] in CS_FIELDS_2D
        shape = (6, nx, ny, 1 if one else nz)
        if a.shape != shape:
            raise ValueError(f"{key}: shape {a.shape} != {shape}")
        return torch.tensor(a, dtype=grid.dtype, device=grid.device)

    out = {name: tensor(name) for name in fields}
    for group in groups:
        out[group] = {n: tensor(f"{group}/{n}") for n in names}
    cls = CubedSphereState if sw else CubedSphereHydrostaticState
    return cls(clock=_clock_from_numpy(arrays, grid.dtype), **out)


def flatten_state(state, prefix=""):
    """Every tensor and int of a state dataclass as a flat dict, keyed as
    this module's arrays are: members by name, a dict member's entries as
    ``<member>/<key>``, the clock's members by the names of :data:`CLOCK`
    and any other nested dataclass's members as ``<member>/<name>``; None
    members and the clock's epoch are left out. The walk goes by
    ``dataclasses.fields``, so a member added to a state is carried with
    no edit here."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        key = prefix + f.name
        if v is None or f.name == "epoch":
            continue
        if isinstance(v, Clock):
            out.update(flatten_state(v, prefix))
        elif dataclasses.is_dataclass(v):
            out.update(flatten_state(v, key + "/"))
        elif isinstance(v, dict):
            out.update({f"{key}/{n}": t for n, t in v.items()})
        else:
            out[key] = v
    return out


def unflatten_state(template, flat, prefix=""):
    """A state with ``template``'s structure, devices, dtypes and epoch
    from a flat dict keyed as :func:`flatten_state` keys it."""

    def leaf(key, like):
        if key not in flat:
            raise KeyError(f"no {key!r} for the state")
        v = flat[key]
        if isinstance(like, torch.Tensor):
            return v.to(device=like.device, dtype=like.dtype)
        return type(like)(v)

    new = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        key = prefix + f.name
        if v is None or f.name == "epoch":
            continue
        if isinstance(v, Clock):
            new[f.name] = unflatten_state(v, flat, prefix)
        elif dataclasses.is_dataclass(v):
            new[f.name] = unflatten_state(v, flat, key + "/")
        elif isinstance(v, dict):
            new[f.name] = {n: leaf(f"{key}/{n}", t) for n, t in v.items()}
        else:
            new[f.name] = leaf(key, v)
    return dataclasses.replace(template, **new)


def state_to_numpy(state):
    """The state's fields, tracers and clock as numpy arrays (copied to the
    host), keyed by :func:`flatten_state`."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in flatten_state(state).items()}


def _rank_window(a, dstep, layout):
    """This rank's block of the numpy array ``a``: from the global layout
    (the rank's window of the halo-extended array, its halo rings
    included, z as it is: ``dstep.window``) or from the JAX package's
    local-halos layout (the rank's block with its halo slots, as they
    are; even blocks)."""
    if layout == "global":
        return dstep.window(a)
    rx, ry = dstep.dist.coords
    Hx, Hy = dstep.global_grid.H[:2]
    bx, by = dstep.nxl + 2 * Hx, dstep.nyl + 2 * Hy
    return a[rx * bx:(rx + 1) * bx, ry * by:(ry + 1) * by]


def _is_field(a, shape2):
    return np.ndim(a) == 3 and tuple(np.shape(a)[:2]) == tuple(shape2)


def local_state_from_numpy(dstep, arrays, layout="global"):
    """This rank's local-halos state of the ``DistributedStep`` ``dstep``
    from numpy arrays keyed as :func:`state_from_numpy` takes them, given
    on every rank: each field in the global layout (``layout="global"``,
    the halo-extended arrays of the global grid) or in the JAX package's
    local-halos layout (``layout="local"``, the ``(px·(nxl + 2Hx),
    py·(nyl + 2Hy), ·)`` arrays of its ``DistributedStep.to_local_state``).
    No rank sends anything: each takes its own block."""
    g = dstep.global_grid
    if layout == "global":
        shape2 = g.shape[:2]
    elif layout == "local":
        shape2 = (dstep.px * (dstep.nxl + 2 * g.H[0]),
                  dstep.py * (dstep.nyl + 2 * g.H[1]))
    else:
        raise ValueError(f"layout {layout!r}: 'global' or 'local'")
    local = {k: _rank_window(np.asarray(a), dstep, layout)
             if _is_field(a, shape2) else a for k, a in arrays.items()}
    return state_from_numpy(dstep.lmodel, local)


def local_state_to_numpy(dstep, state, layout="global"):
    """The numpy arrays of the whole distributed state on rank 0, keyed as
    :func:`state_to_numpy` keys them, in the global layout (the domain's
    halo rings from the edge ranks') or the JAX package's local-halos
    layout; None on the other ranks.
    Every rank calls it together (it gathers)."""
    dist = dstep.dist
    if layout == "global":
        gs = dstep.from_local_state(state)
        return None if gs is None else state_to_numpy(gs)
    if layout != "local":
        raise ValueError(f"layout {layout!r}: 'global' or 'local'")
    lshape = dstep.local_grid.shape[:2]
    out = {}
    for k, v in flatten_state(state).items():
        if isinstance(v, torch.Tensor) and v.ndim == 3 and \
                tuple(v.shape[:2]) == tuple(lshape):
            blocks = dist.gather_blocks(v)
            if blocks is not None:
                py = dist.partition[1]
                rows = [torch.cat(blocks[rx * py:(rx + 1) * py], dim=1)
                        for rx in range(dist.partition[0])]
                out[k] = torch.cat(rows, dim=0).cpu().numpy()
        else:
            out[k] = (v.detach().cpu().numpy()
                      if isinstance(v, torch.Tensor) else np.asarray(v))
    return out if dist.rank == 0 else None


def grid_from_arguments(kind, **kwargs):
    """The port's grid ``kind`` ("RectilinearGrid", "LatitudeLongitudeGrid",
    "OrthogonalSphericalShellGrid", "RotatedLatitudeLongitudeGrid",
    "TripolarGrid", or "cubed_sphere" for ``ConformalCubedSphereGrid``) from
    the keyword arguments that build the JAX package's grid of that name
    (``dtype`` may be a name), plus ``device=``."""
    if kind in ("cubed_sphere", "ConformalCubedSphereGrid"):
        return ConformalCubedSphereGrid(**kwargs)
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
    halos, topology, zipper flag, radius and z (regular or stretched) of
    ``grid`` (either package's); ``kwargs`` add ``dtype`` and ``device``."""
    lam, phi = orthogonal_nodes(grid)
    zF = np.asarray(grid.zF, dtype=np.float64).reshape(-1)
    H, N = grid.H[2], grid.N[2]
    z0 = float(zF[H])
    # the right wall face sits in the first halo slot
    z = (z0, z0 + grid.Lz) if grid.z_regular else zF[H:H + N + 1]
    return OrthogonalSphericalShellGrid(
        lam, phi, z, grid.N, halo=grid.H,
        radius=grid.radius, topology=grid.topology, zipper=grid.zipper,
        **kwargs)


__all__ = ["CLOCK", "CS_AB2_FIELDS", "CS_FIELDS_2D",
           "CS_HYDROSTATIC_FIELDS", "CS_SW_FIELDS", "FIELDS", "FIELDS_2D",
           "HYDROSTATIC_FIELDS", "SW_FIELDS", "cube_state_from_numpy",
           "flatten_state", "grid_from_arguments",
           "local_state_from_numpy", "local_state_to_numpy", "orthogonal_grid_like",
           "orthogonal_nodes", "state_from_numpy", "state_to_numpy",
           "tracer_keys", "unflatten_state"]
