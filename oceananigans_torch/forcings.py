"""Forcing terms: user functions of the coordinates and time, discrete
functions of the state, relaxation, sums of forcings, advective forcings and
time series.

Counterpart of ``oceananigans_tpu/forcings.py``. A forcing is reduced at
model construction (:func:`materialize_forcing`) to a callable ``(grid,
time, fields) -> tendency term``, evaluated each step; ``fields`` maps the
names of the prognostic fields (and a hydrostatic model's auxiliary fields)
to tensors, and ``time`` is the clock's 0-d tensor. Continuous forcings
receive the broadcast-ready coordinates of the forced field's location. No
forcing reads the time as a Python number: the term is built from tensors,
so a step on the card makes no host synchronisation for it. The JAX package
reaches no Pallas kernel here; this is plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.fields import (
    LOC_U, LOC_V, LOC_W, location_coords, set_field,
)


class ContinuousForcing:
    """``func(x, y, z, t, *field_args[, parameters])`` evaluated at the
    forced field's staggered nodes. ``field_dependencies`` names fields
    passed positionally after the time (each at its own location)."""

    def __init__(self, func, parameters=None, field_dependencies=()):
        self.func = func
        self.parameters = parameters
        if isinstance(field_dependencies, str):
            field_dependencies = (field_dependencies,)
        self.field_dependencies = tuple(field_dependencies)

    def __call__(self, grid, loc, time, fields):
        x, y, z = location_coords(grid, loc)
        args = tuple(fields[name] for name in self.field_dependencies)
        if self.parameters is not None:
            return self.func(x, y, z, time, *args, self.parameters)
        return self.func(x, y, z, time, *args)


def Forcing(func, parameters=None, field_dependencies=(), discrete_form=False):
    """The user-facing constructor: a :class:`DiscreteForcing` with
    ``discrete_form=True``, else a :class:`ContinuousForcing`."""
    if discrete_form:
        return DiscreteForcing(func, parameters)
    return ContinuousForcing(func, parameters, field_dependencies)


class DiscreteForcing:
    """``func(grid, loc, time, fields[, parameters])``: full access to the
    discrete state."""

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def __call__(self, grid, loc, time, fields):
        if self.parameters is not None:
            return self.func(grid, loc, time, fields, self.parameters)
        return self.func(grid, loc, time, fields)


class GaussianMask:
    """exp(−(r − center)² / (2 width²)) in one coordinate."""

    def __init__(self, center, width, coordinate="z"):
        self.center = float(center)
        self.width = float(width)
        self.coordinate = coordinate

    def __call__(self, x, y, z):
        r = {"x": x, "y": y, "z": z}[self.coordinate]
        return torch.exp(-((r - self.center) ** 2) / (2.0 * self.width ** 2))


class LinearTarget:
    """target = intercept + gradient · coordinate."""

    def __init__(self, intercept, gradient, coordinate="z"):
        self.intercept = float(intercept)
        self.gradient = float(gradient)
        self.coordinate = coordinate

    def __call__(self, x, y, z, t):
        r = {"x": x, "y": y, "z": z}[self.coordinate]
        return self.intercept + self.gradient * r


class Relaxation:
    """F = −rate · mask(x, y, z) · (q − target); ``mask`` and ``target``
    are numbers or callables (``target(x, y, z, t)``)."""

    def __init__(self, rate, mask=1.0, target=0.0):
        self.rate = float(rate)
        self.mask = mask
        self.target = target

    def __call__(self, grid, loc, time, fields, field_name=None):
        x, y, z = location_coords(grid, loc)
        mask = self.mask(x, y, z) if callable(self.mask) else self.mask
        target = (self.target(x, y, z, time) if callable(self.target)
                  else self.target)
        return -self.rate * mask * (fields[field_name] - target)


class MultipleForcings:
    """The sum of several forcings."""

    def __init__(self, *forcings):
        self.forcings = tuple(forcings)


class AdvectiveForcing:
    """Advection by an extra velocity (u, v, w), e.g. sinking: the models
    add it to the velocity that advects the forced tracer, inside the
    tracer's own advection term (so the flux uses the model's scheme).
    Components are numbers or callables ``f(x, y, z)`` at the velocity
    locations. Only tracers take one."""

    def __init__(self, u=0.0, v=0.0, w=0.0):
        self.u = u
        self.v = v
        self.w = w

    def velocities(self, grid):
        """(u′, v′, w′) at (f,c,c), (c,f,c) and (c,c,f), made once per grid
        device, dtype and shape and kept."""
        cache = self.__dict__.setdefault("_on_grid", {})
        key = (grid.device, grid.dtype, tuple(grid.shape))
        if key not in cache:
            out = []
            for comp, loc in ((self.u, LOC_U), (self.v, LOC_V),
                              (self.w, LOC_W)):
                if callable(comp):
                    out.append(set_field(grid, comp, loc))
                else:
                    out.append(set_field(grid, float(comp), loc))
            cache[key] = tuple(out)
        return cache[key]

    def __repr__(self):
        return f"AdvectiveForcing(u={self.u!r}, v={self.v!r}, w={self.w!r})"


def split_advective_forcings(spec):
    """``(advective forcings, rest)`` of a user forcing spec: the
    :class:`AdvectiveForcing` entries (also those inside a
    :class:`MultipleForcings`) are summed into the advecting velocity; the
    rest goes through :func:`materialize_forcing`."""
    if isinstance(spec, AdvectiveForcing):
        return (spec,), None
    if isinstance(spec, MultipleForcings):
        adv = tuple(f for f in spec.forcings
                    if isinstance(f, AdvectiveForcing))
        rest = tuple(f for f in spec.forcings
                     if not isinstance(f, AdvectiveForcing))
        if not adv:
            return (), spec
        return adv, (MultipleForcings(*rest) if rest else None)
    return (), spec


class FieldTimeSeriesForcing:
    """A forcing interpolated linearly in time from a stored series
    (``output.FieldTimeSeries`` or any object with ``times`` (T,) and
    ``data`` (T, nx, ny, nz), interior-shaped for the forced field), clamped
    to the series' ends. The index search runs where the clock's time is (a
    host tensor, ``timesteppers.py``), on float64 times, so no step waits
    for the device; the two snapshots are blended on the grid's device in
    float64 and the term is cast to the grid's dtype."""

    def __init__(self, fts):
        self.times = torch.as_tensor(np.asarray(fts.times),
                                     dtype=torch.float64)
        self.data = torch.as_tensor(np.asarray(fts.data),
                                    dtype=torch.float64)

    def _data_on(self, device):
        cache = self.__dict__.setdefault("_on_device", {})
        if device not in cache:
            cache[device] = self.data.to(device)
        return cache[device]

    def __call__(self, grid, loc, time, fields):
        times = self.times
        t = torch.as_tensor(time, dtype=torch.float64).to(times.device)
        t = torch.clamp(t, times[0], times[-1])
        i = int(torch.searchsorted(times, t.reshape(1), right=True)[0]) - 1
        i = min(max(i, 0), times.shape[0] - 2)
        f = (t - times[i]) / torch.clamp(times[i + 1] - times[i], min=1e-30)
        data = self._data_on(grid.device)
        val = (1.0 - f) * data[i] + f * data[i + 1]
        out = torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
        out[grid.interior_slices] = val.to(grid.dtype)
        return out


def materialize_forcing(forcing, name, loc):
    """A user forcing spec as ``(grid, time, fields) -> term``, or None:
    None, a number, a callable ``f(x, y, z, t)``, a
    Continuous/DiscreteForcing, a Relaxation, a field time series (an object
    with ``times`` and ``data``) or a MultipleForcings of these."""
    if forcing is None:
        return None
    if isinstance(forcing, MultipleForcings):
        parts = [materialize_forcing(f, name, loc) for f in forcing.forcings]

        def summed(grid, time, fields):
            out = 0.0
            for p in parts:
                out = out + p(grid, time, fields)
            return out
        return summed
    if isinstance(forcing, Relaxation):
        return lambda grid, time, fields: forcing(grid, loc, time, fields,
                                                  field_name=name)
    if isinstance(forcing, (ContinuousForcing, DiscreteForcing,
                            FieldTimeSeriesForcing)):
        return lambda grid, time, fields: forcing(grid, loc, time, fields)
    if hasattr(forcing, "times") and hasattr(forcing, "data"):
        fts = FieldTimeSeriesForcing(forcing)
        return lambda grid, time, fields: fts(grid, loc, time, fields)
    if callable(forcing):
        cf = ContinuousForcing(forcing)
        return lambda grid, time, fields: cf(grid, loc, time, fields)
    value = forcing
    return lambda grid, time, fields: value


def materialize_forcings(forcing, locations, tracer_names):
    """``(forcings, advective_forcings)`` of a model: each field of
    ``locations`` with its materialized forcing (or None), and each tracer
    with its tuple of :class:`AdvectiveForcing` entries; an advective
    forcing of a velocity raises."""
    forcing = dict(forcing or {})
    forcings, advective = {}, {}
    for name, loc in locations.items():
        adv, rest = split_advective_forcings(forcing.get(name))
        if adv and name not in tracer_names:
            raise ValueError(f"AdvectiveForcing is only supported on "
                             f"tracers, got it for {name!r}")
        if adv:
            advective[name] = adv
        forcings[name] = materialize_forcing(rest, name, loc)
    return forcings, advective


__all__ = ["AdvectiveForcing", "ContinuousForcing", "DiscreteForcing",
           "FieldTimeSeriesForcing", "Forcing", "GaussianMask",
           "LinearTarget", "MultipleForcings", "Relaxation",
           "materialize_forcing", "materialize_forcings",
           "split_advective_forcings"]
