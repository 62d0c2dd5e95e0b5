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

    def advect(self, grid, particles: ParticleState, u, v, w, dt):
        """Forward Euler from the velocities interpolated at the
        particles."""
        px, py, pz = particles.x, particles.y, particles.z
        up = interpolate(grid, u, LOC_U, px, py, pz)
        vp = interpolate(grid, v, LOC_V, px, py, pz)
        wp = interpolate(grid, w, LOC_W, px, py, pz)
        x = self._enforce_boundaries(grid, px + dt * up, 0)
        y = self._enforce_boundaries(grid, py + dt * vp, 1)
        z = self._enforce_boundaries(grid, pz + dt * wp, 2)
        x, y, z = self._bounce_immersed(grid, particles, x, y, z)
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
        props = {prop: interpolate(grid, fields[name], LOC_C, particles.x,
                                   particles.y, particles.z)
                 for prop, name in self.tracked_fields.items()}
        return dataclasses.replace(particles, properties=props)

    def step(self, grid, particles, u, v, w, fields, dt):
        particles = self.advect(grid, particles, u, v, w, dt)
        if self.tracked_fields:
            particles = self.update_properties(grid, particles, fields)
        return particles

    def __repr__(self):
        return (f"LagrangianParticles({len(self)} particles, "
                f"restitution={self.restitution}, "
                f"tracked_fields={self.tracked_fields})")


__all__ = ["LagrangianParticles", "ParticleState"]
