"""Stokes drift: the Craik-Leibovich vortex force of surface waves.

Counterpart of ``oceananigans_tpu/stokes_drift.py``: ``UniformStokesDrift``
(a drift that depends on depth and time only) and ``StokesDrift`` (fully
spatial). Each gives the models the vortex-force terms with the wave
field's time tendencies, ``x/y/z_tendency(grid, u, v, w, time)``; the
nonhydrostatic model adds all three, the hydrostatic model x and y. The
user's callables take broadcast-ready coordinate tensors and the clock's
0-d time tensor. Plain PyTorch, as the JAX package reaches no Pallas
kernel here.
"""

from __future__ import annotations

import torch

from oceananigans_torch.fields import location_coords
from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops.operators import ix_c, ix_f, iy_c, iy_f, iz_c, iz_f


def _zero_xyzt(x, y, z, t):
    """Zeros in the coordinates' dtype and broadcast shape."""
    return torch.zeros_like(x + y + z)


def _zero_zt(z, t):
    return torch.zeros_like(z)


class StokesDrift:
    """A spatially varying Stokes drift uˢ(x, y, z, t), given by the nine
    callables ``f(x, y, z, t)`` of its pseudovorticity and time
    tendencies (missing ones are zero): ``dx_vs``, ``dx_ws`` (∂x vˢ, ∂x
    wˢ), ``dy_us``, ``dy_ws``, ``dz_us``, ``dz_vs`` and ``dt_us``,
    ``dt_vs``, ``dt_ws``."""

    def __init__(self, dx_vs=None, dx_ws=None, dy_us=None, dy_ws=None,
                 dz_us=None, dz_vs=None, dt_us=None, dt_vs=None,
                 dt_ws=None):
        self.dx_vs = dx_vs or _zero_xyzt
        self.dx_ws = dx_ws or _zero_xyzt
        self.dy_us = dy_us or _zero_xyzt
        self.dy_ws = dy_ws or _zero_xyzt
        self.dz_us = dz_us or _zero_xyzt
        self.dz_vs = dz_vs or _zero_xyzt
        self.dt_us = dt_us or _zero_xyzt
        self.dt_vs = dt_vs or _zero_xyzt
        self.dt_ws = dt_ws or _zero_xyzt

    def x_tendency(self, grid, u, v, w, time):
        """∂t uˢ + wᶠᶜᶜ (∂z uˢ − ∂x wˢ) − vᶠᶜᶜ (∂x vˢ − ∂y uˢ) at (f,c,c)."""
        x, y, z = location_coords(grid, (Face, Center, Center))
        w_fcc = ix_f(iz_c(w))
        v_fcc = ix_f(iy_c(v))
        return (self.dt_us(x, y, z, time)
                + w_fcc * (self.dz_us(x, y, z, time)
                           - self.dx_ws(x, y, z, time))
                - v_fcc * (self.dx_vs(x, y, z, time)
                           - self.dy_us(x, y, z, time)))

    def y_tendency(self, grid, u, v, w, time):
        x, y, z = location_coords(grid, (Center, Face, Center))
        w_cfc = iy_f(iz_c(w))
        u_cfc = iy_f(ix_c(u))
        return (self.dt_vs(x, y, z, time)
                + u_cfc * (self.dx_vs(x, y, z, time)
                           - self.dy_us(x, y, z, time))
                - w_cfc * (self.dy_ws(x, y, z, time)
                           - self.dz_vs(x, y, z, time)))

    def z_tendency(self, grid, u, v, w, time):
        x, y, z = location_coords(grid, (Center, Center, Face))
        u_ccf = iz_f(ix_c(u))
        v_ccf = iz_f(iy_c(v))
        return (self.dt_ws(x, y, z, time)
                + v_ccf * (self.dy_ws(x, y, z, time)
                           - self.dz_vs(x, y, z, time))
                - u_ccf * (self.dz_us(x, y, z, time)
                           - self.dx_ws(x, y, z, time)))


class UniformStokesDrift:
    """A horizontally uniform drift uˢ(z, t), vˢ(z, t): ``us``/``vs`` and
    their vertical derivatives ``dusdz``/``dvsdz`` (the vortex force needs
    them), and optional time tendencies ``dusdt``/``dvsdt``, each a callable
    ``(z, t)``.

    With uˢ = (uˢ(z), vˢ(z), 0), ∇ × uˢ = (−∂z vˢ, ∂z uˢ, 0) and the
    vortex force (∇ × uˢ) × u is ∂z uˢ · w̄ at (f,c,c), ∂z vˢ · w̄ at (c,f,c)
    and −(∂z uˢ ū + ∂z vˢ v̄) at (c,c,f)."""

    def __init__(self, us=None, vs=None, dusdz=None, dvsdz=None,
                 dusdt=None, dvsdt=None):
        self.us = us or _zero_zt
        self.vs = vs or _zero_zt
        self.dusdz = dusdz or _zero_zt
        self.dvsdz = dvsdz or _zero_zt
        self.dusdt = dusdt or _zero_zt
        self.dvsdt = dvsdt or _zero_zt

    def x_tendency(self, grid, u, v, w, time):
        z = grid.zC
        return self.dusdt(z, time) + self.dusdz(z, time) * ix_f(iz_c(w))

    def y_tendency(self, grid, u, v, w, time):
        z = grid.zC
        return self.dvsdt(z, time) + self.dvsdz(z, time) * iy_f(iz_c(w))

    def z_tendency(self, grid, u, v, w, time):
        z = grid.zF
        return -(self.dusdz(z, time) * iz_f(ix_c(u))
                 + self.dvsdz(z, time) * iz_f(iy_c(v)))


__all__ = ["StokesDrift", "UniformStokesDrift"]
