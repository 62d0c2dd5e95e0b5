"""Lagrangian particles advected by a model's velocities.

Counterpart of ``oceananigans_tpu/particles.py``. The particles are a
struct of arrays, :class:`ParticleState` (positions and tracked
properties, each a 1-D tensor over the particles); a step advects all of
them at once with forward Euler from the trilinearly interpolated
velocities (``fields.interpolate``), applies the boundary rules of each
axis (periodic wrap, or a bounce off a wall damped by ``restitution``),
bounces particles that land in a solid cell of an immersed grid back into
the cell they came from, and interpolates the ``tracked_fields``. Whole
tensor operations, with no loop over particles; the domain bounds are
read from the grid once per grid and kept. Plain PyTorch, as the JAX
package reaches no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from oceananigans_torch.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, _axis_edges, interpolate,
)
from oceananigans_torch.grids.base import AXIS_NAMES, Flat, Periodic


@dataclasses.dataclass
class ParticleState:
    """Positions and tracked properties, 1-D tensors over the particles."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    properties: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


class LagrangianParticles:
    """A batch of particles at ``x``, ``y``, ``z`` (numbers or 1-D arrays of
    one length). ``tracked_fields`` maps property names to field names;
    each property is interpolated from its field every step. ``initial``
    holds the positions in float64 on the host; a model's
    ``initial_state`` carries them to its grid's dtype and device
    (:meth:`state_on`)."""

    def __init__(self, x, y, z, restitution=1.0, tracked_fields=None):
        def pos(q):
            if torch.is_tensor(q):
                q = q.detach().cpu()
            return torch.atleast_1d(torch.as_tensor(np.asarray(q),
                                                    dtype=torch.float64))
        x, y, z = pos(x), pos(y), pos(z)
        if not (x.shape == y.shape == z.shape):
            raise ValueError("x, y, z must have the same shape")
        self.restitution = float(restitution)
        self.tracked_fields = dict(tracked_fields or {})
        self.initial = ParticleState(
            x=x, y=y, z=z,
            properties={k: torch.zeros_like(x) for k in self.tracked_fields})

    def __len__(self):
        return self.initial.x.shape[0]

    def state_on(self, grid) -> ParticleState:
        """:attr:`initial` in ``grid``'s dtype on its device."""
        def put(t):
            return t.to(device=grid.device, dtype=grid.dtype)
        s = self.initial
        return ParticleState(x=put(s.x), y=put(s.y), z=put(s.z),
                             properties={k: put(v)
                                         for k, v in s.properties.items()})

    # ------------------------------------------------------------------
    def _bounds(self, grid):
        """Per axis ``(lo, hi)``: the first and last interior faces, as
        Python floats, read from the grid once and kept."""
        cache = self.__dict__.setdefault("_bounds_of", {})
        key = (id(grid), tuple(grid.shape))
        if key not in cache:
            out = []
            for axis in range(3):
                if grid.axis_topo(axis) == Flat:
                    out.append(None)
                    continue
                edges = _axis_edges(grid, axis)
                out.append((float(edges[0]), float(edges[-1])))
            cache[key] = (grid, tuple(out))
        return cache[key][1]

    def _enforce_boundaries(self, grid, q, axis):
        """Periodic wrap, or a bounce off the walls damped by
        ``restitution``."""
        topo = grid.axis_topo(axis)
        if topo == Flat:
            return q
        lo, hi = self._bounds(grid)[axis]
        if topo == Periodic:
            return lo + torch.remainder(q - lo, hi - lo)
        r = self.restitution
        q = torch.where(q > hi, hi - r * (q - hi), q)
        q = torch.where(q < lo, lo + r * (lo - q), q)
        return torch.clamp(q, lo, hi)

    def _domain(self, grid):
        """The grid whose bounds and solid mask hold the particles."""
        return grid

    def _values(self, grid, pairs, x, y, z):
        """The fields of ``pairs`` ``(field, location)`` interpolated at the
        particles at ``(x, y, z)``: one 1-D tensor each."""
        return [interpolate(grid, a, loc, x, y, z) for a, loc in pairs]

    def advect(self, grid, particles: ParticleState, u, v, w, dt):
        """Forward Euler from the velocities interpolated at the
        particles."""
        px, py, pz = particles.x, particles.y, particles.z
        up, vp, wp = self._values(
            grid, ((u, LOC_U), (v, LOC_V), (w, LOC_W)), px, py, pz)
        dom = self._domain(grid)
        x = self._enforce_boundaries(dom, px + dt * up, 0)
        y = self._enforce_boundaries(dom, py + dt * vp, 1)
        z = self._enforce_boundaries(dom, pz + dt * wp, 2)
        x, y, z = self._bounce_immersed(dom, particles, x, y, z)
        return dataclasses.replace(particles, x=x, y=y, z=z)

    def _bounce_immersed(self, grid, prev, x, y, z):
        """A particle that lands in a solid cell of an immersed grid is
        reflected back into the bounds of the cell it came from, damped by
        ``restitution``."""
        solid = getattr(grid, "solid_c", None)
        if solid is None:
            return x, y, z
        faces = [getattr(grid, f"{name}F").reshape(-1).contiguous()
                 for name in AXIS_NAMES]

        def idx(f, q):
            return torch.clamp(torch.searchsorted(f, q, right=True) - 1,
                               0, max(f.shape[0] - 2, 0))

        dest = solid[idx(faces[0], x), idx(faces[1], y), idx(faces[2], z)]
        r = self.restitution
        out = []
        for axis, (q, qp, f) in enumerate(((x, prev.x, faces[0]),
                                           (y, prev.y, faces[1]),
                                           (z, prev.z, faces[2]))):
            if grid.axis_topo(axis) == Flat or grid.N[axis] == 1:
                out.append(q)
                continue
            ip = idx(f, qp)
            lo, hi = f[ip], f[ip + 1]
            qb = torch.where(q > hi, hi - r * (q - hi), q)
            qb = torch.where(qb < lo, lo + r * (lo - qb), qb)
            qb = torch.minimum(torch.maximum(qb, lo), hi)
            out.append(torch.where(dest, qb, q))
        return tuple(out)

    def update_properties(self, grid, particles: ParticleState, fields):
        """Each tracked property interpolated from its field at the
        particles."""
        names = list(self.tracked_fields.items())
        vals = self._values(grid, [(fields[name], LOC_C) for _, name in names],
                            particles.x, particles.y, particles.z)
        return dataclasses.replace(particles, properties={
            prop: vals[k] for k, (prop, _) in enumerate(names)})

    def step(self, grid, particles, u, v, w, fields, dt):
        particles = self.advect(grid, particles, u, v, w, dt)
        if self.tracked_fields:
            particles = self.update_properties(grid, particles, fields)
        return particles

    def __repr__(self):
        return (f"LagrangianParticles({len(self)} particles, "
                f"restitution={self.restitution}, "
                f"tracked_fields={self.tracked_fields})")


class ShardedParticles(LagrangianParticles):
    """``particles`` as a rank's LOCAL model steps them in a sharded step
    (``parallel.sharded_step_fn``): every rank holds every particle, as the
    JAX package's GSPMD path replicates them, and moves them alike within
    the bounds and solid mask of ``global_grid``. Only the interpolation
    differs from the serial step: each rank interpolates the particles it
    owns, those whose (x, y) lies in its block's half-open intervals
    ``owned`` (taken from the global face coordinates, open to ±∞ at the
    domain's edges, so each particle has exactly one owner), and writes
    zero for the others; ``reduce_sum`` (the ranks' all-reduce) then gives
    every rank the serial values exactly: once for the velocities at the
    old positions and once for the tracked fields at the new ones.
    ``clamps`` holds, for an axis that the global grid has no halo on, the
    first and last interior node at centers (``"c"``) and faces (``"f"``):
    the serial interpolation stays within them, and so does the block's."""

    def __init__(self, particles, global_grid, owned, reduce_sum,
                 clamps=(None, None)):
        self.restitution = particles.restitution
        self.tracked_fields = particles.tracked_fields
        self.initial = particles.initial
        self.global_grid = global_grid
        self.owned = owned
        self.reduce_sum = reduce_sum
        self.clamps = clamps

    def owns(self, x, y):
        """Which of the particles at (x, y) this rank owns."""
        (xlo, xhi), (ylo, yhi) = self.owned
        return (x >= xlo) & (x < xhi) & (y >= ylo) & (y < yhi)

    def _domain(self, grid):
        return self.global_grid

    def _values(self, grid, pairs, x, y, z):
        """The serial values, a ``(len(pairs), n)`` tensor: interpolated
        by each particle's owner (zero at the others) and summed over the
        ranks."""
        own = self.owns(x, y)
        q = [x, y]
        rows = []
        for a, loc in pairs:
            for axis in (0, 1):
                clamp = self.clamps[axis]
                q[axis] = (torch.clamp((x, y)[axis], *clamp[loc[axis]])
                           if clamp is not None else (x, y)[axis])
            val = interpolate(grid, a, loc, q[0], q[1], z)
            rows.append(torch.where(own, val, torch.zeros_like(val)))
        return self.reduce_sum(torch.stack(rows))

    def __repr__(self):
        return (f"ShardedParticles({len(self)} particles, "
                f"owned={self.owned})")


__all__ = ["LagrangianParticles", "ParticleState", "ShardedParticles"]
