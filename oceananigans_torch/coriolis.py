"""Coriolis formulations.

Counterpart of ``oceananigans_tpu/coriolis.py``. Each formulation gives
``x_f_cross_U / y_f_cross_U / z_f_cross_U``: the components of ``f × 𝐯`` at
the (f,c,c), (c,f,c) and (c,c,f) velocity points, as whole-tensor
expressions. Tendencies subtract them. The planes and the constant
Cartesian rotation serve Cartesian grids; ``HydrostaticSphericalCoriolis``
(f = 2Ω sinφ) serves the latitude-longitude grid, whose face latitudes
``phiF`` it reads.
"""

from __future__ import annotations

import math

import torch

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops.operators import (
    ix_c, ix_f, iy_c, iy_f, iz_c, iz_f,
)

#: default rotation rate of the Earth [s⁻¹]
Omega_Earth = 7.292115e-5


class AbstractCoriolis:
    def x_f_cross_U(self, grid, u, v, w):
        raise NotImplementedError

    def y_f_cross_U(self, grid, u, v, w):
        raise NotImplementedError

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)

    def _key(self):
        return tuple(vars(self).values())

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__, self._key()))


class FPlane(AbstractCoriolis):
    """Constant rotation about the vertical: f given, or f = 2Ω sin(φ)."""

    def __init__(self, f=None, rotation_rate=Omega_Earth, latitude=None):
        if f is None:
            if latitude is None:
                raise ValueError("FPlane needs f= or latitude=")
            f = 2.0 * rotation_rate * math.sin(math.radians(latitude))
        elif latitude is not None:
            raise ValueError("give FPlane either f= or latitude=, not both")
        self.f = float(f)

    # (f × U)_x at (f,c,c) = -f v̄ˣʸ ; (f × U)_y at (c,f,c) = +f ūˣʸ
    def x_f_cross_U(self, grid, u, v, w):
        return -self.f * ix_f(iy_c(v))

    def y_f_cross_U(self, grid, u, v, w):
        return self.f * iy_f(ix_c(u))

    def __repr__(self):
        return f"FPlane(f={self.f:g})"


class ConstantCartesianCoriolis(AbstractCoriolis):
    """Rotation about an axis in any direction: f⃗ = (fx, fy, fz)."""

    def __init__(self, fx=0.0, fy=0.0, fz=0.0, f=None,
                 rotation_axis=(0.0, 0.0, 1.0),
                 rotation_rate=Omega_Earth, latitude=None):
        if latitude is not None:
            f = 2.0 * rotation_rate
            phi = math.radians(latitude)
            rotation_axis = (0.0, math.cos(phi), math.sin(phi))
        if f is not None:
            n = math.sqrt(sum(c * c for c in rotation_axis))
            fx, fy, fz = (f * c / n for c in rotation_axis)
        self.fx, self.fy, self.fz = float(fx), float(fy), float(fz)

    def x_f_cross_U(self, grid, u, v, w):
        return self.fy * ix_f(iz_c(w)) - self.fz * ix_f(iy_c(v))

    def y_f_cross_U(self, grid, u, v, w):
        return self.fz * iy_f(ix_c(u)) - self.fx * iy_f(iz_c(w))

    def z_f_cross_U(self, grid, u, v, w):
        return self.fx * iz_f(iy_c(v)) - self.fy * iz_f(ix_c(u))

    def __repr__(self):
        return (f"ConstantCartesianCoriolis(fx={self.fx:g}, fy={self.fy:g}, "
                f"fz={self.fz:g})")


class BetaPlane(AbstractCoriolis):
    """f = f₀ + βy."""

    def __init__(self, f0=None, beta=None, rotation_rate=Omega_Earth,
                 latitude=None, radius=6.371e6):
        if f0 is None or beta is None:
            if latitude is None:
                raise ValueError("BetaPlane needs (f0, beta) or latitude=")
            phi = math.radians(latitude)
            f0 = 2.0 * rotation_rate * math.sin(phi)
            beta = 2.0 * rotation_rate * math.cos(phi) / radius
        self.f0 = float(f0)
        self.beta = float(beta)

    def _f(self, grid, ly):
        return self.f0 + self.beta * (grid.yF if ly == Face else grid.yC)

    # v̄ˣʸ lands at (f,c,c), so f at y-centers; ūˣʸ at (c,f,c), f at y-faces
    def x_f_cross_U(self, grid, u, v, w):
        return -self._f(grid, Center) * ix_f(iy_c(v))

    def y_f_cross_U(self, grid, u, v, w):
        return self._f(grid, Face) * iy_f(ix_c(u))

    def __repr__(self):
        return f"BetaPlane(f0={self.f0:g}, beta={self.beta:g})"


class NonTraditionalBetaPlane(AbstractCoriolis):
    """Non-traditional β-plane (Dellar 2011), with the horizontal rotation
    component kept:

    fz(y) = 2Ω sinφ₀ + βy,  fy(z) = 2Ω cosφ₀ + γz,
    β = 2Ω cosφ₀/R,  γ = -4Ω sinφ₀/R.
    """

    def __init__(self, fz=None, fy=None, beta=None, gamma=None,
                 rotation_rate=Omega_Earth, latitude=None, radius=6.371e6):
        if latitude is not None:
            phi = math.radians(latitude)
            fz = 2.0 * rotation_rate * math.sin(phi)
            fy = 2.0 * rotation_rate * math.cos(phi)
            beta = 2.0 * rotation_rate * math.cos(phi) / radius
            gamma = -4.0 * rotation_rate * math.sin(phi) / radius
        self.fz0 = float(fz)
        self.fy0 = float(fy)
        self.beta = float(beta)
        self.gamma = float(gamma)

    def _fz(self, grid, ly):
        return self.fz0 + self.beta * (grid.yF if ly == Face else grid.yC)

    def _fy(self, grid, lz):
        return self.fy0 + self.gamma * (grid.zF if lz == Face else grid.zC)

    def x_f_cross_U(self, grid, u, v, w):
        return (self._fy(grid, Center) * ix_f(iz_c(w))
                - self._fz(grid, Center) * ix_f(iy_c(v)))

    def y_f_cross_U(self, grid, u, v, w):
        return self._fz(grid, Face) * iy_f(ix_c(u))

    def z_f_cross_U(self, grid, u, v, w):
        return -self._fy(grid, Face) * iz_f(ix_c(u))

    def __repr__(self):
        return (f"NonTraditionalBetaPlane(fz={self.fz0:g}, fy={self.fy0:g}, "
                f"beta={self.beta:g}, gamma={self.gamma:g})")


class HydrostaticSphericalCoriolis(AbstractCoriolis):
    """f = 2Ω sinφ at the (f,f) vorticity points of a latitude-longitude
    grid, applied to length-weighted transverse velocities: the
    "enstrophy_conserving" scheme (default) interpolates f and the
    weighted velocity separately, "energy_conserving" their product."""

    def __init__(self, rotation_rate=Omega_Earth,
                 scheme="enstrophy_conserving"):
        if scheme not in ("enstrophy_conserving", "energy_conserving"):
            raise ValueError(f"unknown Coriolis scheme {scheme!r}")
        self.rotation_rate = float(rotation_rate)
        self.scheme = scheme

    def _f_ff(self, grid):
        return 2.0 * self.rotation_rate * torch.sin(torch.deg2rad(grid.phiF))

    def x_f_cross_U(self, grid, u, v, w):
        f = self._f_ff(grid)
        dxv = grid.dx(Center, Face) * v
        if self.scheme == "energy_conserving":
            num = iy_c(f * ix_f(dxv))
        else:
            num = iy_c(f) * ix_f(iy_c(dxv))
        return -num / grid.dx(Face, Center)

    def y_f_cross_U(self, grid, u, v, w):
        f = self._f_ff(grid)
        dyu = grid.dy(Center, Face) * u
        if self.scheme == "energy_conserving":
            num = ix_c(f * iy_f(dyu))
        else:
            num = ix_c(f) * iy_f(ix_c(dyu))
        return num / grid.dy(Face, Center)

    def __repr__(self):
        return (f"HydrostaticSphericalCoriolis(Ω={self.rotation_rate:g}, "
                f"{self.scheme})")


__all__ = ["BetaPlane", "ConstantCartesianCoriolis", "FPlane",
           "HydrostaticSphericalCoriolis", "NonTraditionalBetaPlane",
           "Omega_Earth"]
