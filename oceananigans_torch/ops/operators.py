"""Discrete calculus on the staggered C-grid as whole-tensor shifted ops.

Counterpart of ``oceananigans_tpu/ops/operators.py``. A shift is
``torch.roll``: on a haloed axis the wrapped values land only in the
outermost halo cells, which the next halo fill overwrites; on a halo-free
periodic axis the wrap is the periodic boundary itself, so it is exact.

- ``dx_f(a)`` : out[i] = a[i] - a[i-1]        (lands on faces)
- ``dx_c(a)`` : out[i] = a[i+1] - a[i]        (lands on centers)
- ``ix_f(a)`` : out[i] = (a[i] + a[i-1]) / 2
- ``ix_c(a)`` : out[i] = (a[i+1] + a[i]) / 2

Axes count from the end: x, y and z are the last three axes of a tensor,
so the same expression serves one grid's ``(nx, ny, nz)`` fields and the
cubed sphere's ``(6, nx, ny, nz)`` stacks of panels, whose leading axis
broadcasts against the panel grid's ``(nx, ny, 1)`` metrics. ``X``, ``Y``
and ``Z`` name those axes for every module of the package.
"""

from __future__ import annotations

import torch

from oceananigans_torch.grids.base import Center, Face

X, Y, Z = -3, -2, -1


def shift(a, n: int, axis: int):
    """``out[i] = a[i + n]`` along ``axis`` (``X``, ``Y`` or ``Z``; wraps;
    identity on size-1 axes)."""
    if a.ndim < 3 or a.shape[axis] == 1 or n == 0:
        return a
    return torch.roll(a, -n, axis)


def dx_f(a):
    return a - shift(a, -1, X)


def dx_c(a):
    return shift(a, 1, X) - a


def dy_f(a):
    return a - shift(a, -1, Y)


def dy_c(a):
    return shift(a, 1, Y) - a


def dz_f(a):
    return a - shift(a, -1, Z)


def dz_c(a):
    return shift(a, 1, Z) - a


def ix_f(a):
    return 0.5 * (a + shift(a, -1, X))


def ix_c(a):
    return 0.5 * (shift(a, 1, X) + a)


def iy_f(a):
    return 0.5 * (a + shift(a, -1, Y))


def iy_c(a):
    return 0.5 * (shift(a, 1, Y) + a)


def iz_f(a):
    return 0.5 * (a + shift(a, -1, Z))


def iz_c(a):
    return 0.5 * (shift(a, 1, Z) + a)


def ddx_f(grid, a, ly=Center):
    """∂/∂x of center-located data, landing on faces."""
    return dx_f(a) / grid.dx(Face, ly)


def ddx_c(grid, a, ly=Center):
    """∂/∂x of face-located data, landing on centers."""
    return dx_c(a) / grid.dx(Center, ly)


def ddy_f(grid, a, lx=Center):
    return dy_f(a) / grid.dy(Face, lx)


def ddy_c(grid, a, lx=Center):
    return dy_c(a) / grid.dy(Center, lx)


def ddz_f(grid, a):
    return dz_f(a) / grid.dz(Face)


def ddz_c(grid, a):
    return dz_c(a) / grid.dz(Center)


def divergence_ccc(grid, u, v, w):
    """Finite-volume divergence at cell centers of a C-grid vector:
    ``(δx(Ax u) + δy(Ay v) + δz(Az w)) / V``."""
    flux_x = grid.Ax(Face, Center, Center) * u
    flux_y = grid.Ay(Center, Face, Center) * v
    flux_z = grid.Az(Center, Center) * w
    return (dx_c(flux_x) + dy_c(flux_y) + dz_c(flux_z)) / grid.V(
        Center, Center, Center)


def div_xy_cc(grid, u, v):
    """Horizontal divergence at centers: ``(δx(Ax u) + δy(Ay v)) / V``."""
    flux_x = grid.Ax(Face, Center, Center) * u
    flux_y = grid.Ay(Center, Face, Center) * v
    return (dx_c(flux_x) + dy_c(flux_y)) / grid.V(Center, Center, Center)


def vorticity_z_ff(grid, u, v):
    """Vertical vorticity ζ = (δx(Δy v) − δy(Δx u)) / Az at (Face, Face),
    the circulation form: each velocity is weighted by the edge length at
    its own location."""
    return (dx_f(grid.dy(Face, Center) * v) -
            dy_f(grid.dx(Face, Center) * u)) / grid.Az(Face, Face)


def laplacian_ccc(grid, c):
    """∇²c at centers: the divergence of the face-staggered gradient."""
    gx = grid.Ax(Face, Center, Center) * dx_f(c) / grid.dx(Face, Center)
    gy = grid.Ay(Center, Face, Center) * dy_f(c) / grid.dy(Face, Center)
    gz = grid.Az(Center, Center) * dz_f(c) / grid.dz(Face)
    return (dx_c(gx) + dy_c(gy) + dz_c(gz)) / grid.V(Center, Center, Center)


def kinetic_energy_cc(grid, u, v, w=None):
    """Kinetic energy per unit mass at centers; horizontal unless ``w`` is
    given."""
    ke = 0.5 * (ix_c(u * u) + iy_c(v * v))
    if w is not None:
        ke = ke + 0.5 * iz_c(w * w)
    return ke


__all__ = ["shift", "dx_f", "dx_c", "dy_f", "dy_c", "dz_f", "dz_c",
           "ix_f", "ix_c", "iy_f", "iy_c", "iz_f", "iz_c",
           "ddx_c", "ddx_f", "ddy_c", "ddy_f", "ddz_c", "ddz_f",
           "divergence_ccc", "div_xy_cc", "vorticity_z_ff", "laplacian_ccc",
           "kinetic_energy_cc"]
