"""Conformal cubed-sphere panels.

Counterpart of ``oceananigans_tpu/grids/cubed_sphere.py``, with its own copy
of the numpy geometry, so the map's coefficients and every panel metric
equal the JAX package's bit for bit. The Rančić, Purser & Mesinger (1996)
conformal map is derived numerically in the corner parameterization:

- the sphere is rotated so the panel corner (1,1,1)/√3 sits at the north
  pole and projected stereographically from the south pole; the two panel
  edges through the corner become straight lines at ±π/3;
- the square corner variable z maps as w = z^{4/3}·G(z⁴)^{1/3}, G analytic
  with real Taylor coefficients A_k (Rančić's expansion);
- the A_k are fitted by Gauss-Newton collocation so that the square's
  mid-lines land on the images of the great circles X = 0 and Y = 0 and
  its center on the panel center;
- every square point is folded into its quadrant before evaluation and
  unfolded with the matching sphere reflections.

A panel is an ``OrthogonalSphericalShellGrid`` with topology (Bounded,
Bounded, Bounded).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from oceananigans_torch.config import config
from oceananigans_torch.grids.base import Bounded
from oceananigans_torch.grids.latlon import R_EARTH
from oceananigans_torch.grids.orthogonal import OrthogonalSphericalShellGrid

__all__ = ["conformal_cubed_sphere_mapping", "conformal_cubed_sphere_panel",
           "rancic_coefficients"]

_SQRT3 = np.sqrt(3.0)


def _corner_rotation():
    """Rotation matrix taking the corner n̂=(1,1,1)/√3 to (0,0,1) with the
    panel diagonal (the great circle X=Y) going to the plane containing
    the real axis of the projection."""
    n = np.array([1.0, 1.0, 1.0]) / _SQRT3
    # first basis vector: direction along the diagonal toward the panel
    # center (0,0,1), orthonormalized against n
    c = np.array([0.0, 0.0, 1.0])
    e1 = c - (c @ n) * n
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    # rows: the rotated frame: R @ n = ẑ, R @ e1 = x̂ (toward center)
    return np.stack([e1, e2, n])


_R = _corner_rotation()
_RT = _R.T


def _stereo(P):
    """Stereographic projection from the south pole; P: (..., 3)."""
    return (P[..., 0] + 1j * P[..., 1]) / (1.0 + P[..., 2])


def _stereo_inv(w):
    u, v = np.real(w), np.imag(w)
    d = 1.0 + u * u + v * v
    return np.stack([2 * u / d, 2 * v / d, (2.0 - d) / d], axis=-1)


def _great_circle_image(normal):
    """(center, radius) of the w-plane circle that is the image of the
    great circle with plane normal ``normal`` under rotate-then-project."""
    n = np.asarray(normal, float)
    n = n / np.linalg.norm(n)
    # three points on the great circle
    a = np.cross(n, [0.0, 0.0, 1.0])
    if np.linalg.norm(a) < 1e-12:
        a = np.cross(n, [1.0, 0.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(n, a)
    pts = [a, (a + b) / np.sqrt(2), b]
    ws = [_stereo((_R @ p)) for p in pts]
    z1, z2, z3 = ws
    ax, ay = z1.real, z1.imag
    bx, by = z2.real, z2.imag
    cx, cy = z3.real, z3.imag
    d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    ux = ((ax ** 2 + ay ** 2) * (by - cy) + (bx ** 2 + by ** 2) * (cy - ay)
          + (cx ** 2 + cy ** 2) * (ay - by)) / d
    uy = ((ax ** 2 + ay ** 2) * (cx - bx) + (bx ** 2 + by ** 2) * (ax - cx)
          + (cx ** 2 + cy ** 2) * (bx - ax)) / d
    C = complex(ux, uy)
    return C, abs(z1 - C)


def _corner_z(x, y):
    """Corner-centered square variable for the (1,1) corner: wedge
    |arg z| ≤ π/4 with the square diagonal x = y on the positive real
    axis."""
    return ((1.0 - x) + 1j * (1.0 - y)) * np.exp(-1j * np.pi / 4) / 2.0


def _w_of_z(A, z):
    """w = z^{4/3} · G(z⁴)^{1/3}, G = Σ A_k Z^{k-1} (branch-safe)."""
    z = np.asarray(z, complex)
    Z = z ** 4
    G = np.polyval(np.asarray(A)[::-1], Z)
    return z ** (4.0 / 3.0) * G ** (1.0 / 3.0)


@lru_cache(None)
def rancic_coefficients(K: int = 20, n_colloc: int = 80, iters: int = 80):
    """Fit the corner-expansion coefficients by collocation:
    the square mid-lines map onto the images of the X=0 / Y=0 great
    circles, and the square center maps to the panel center."""
    C_x0, R_x0 = _great_circle_image([1.0, 0.0, 0.0])   # X = 0 circle
    C_y0, R_y0 = _great_circle_image([0.0, 1.0, 0.0])   # Y = 0 circle
    w_center = _stereo(_R @ np.array([0.0, 0.0, 1.0]))

    ys = np.linspace(0.0, 1.0, n_colloc)
    z_seam_x = _corner_z(np.zeros_like(ys), ys)     # x = 0 line
    z_seam_y = _corner_z(ys, np.zeros_like(ys))     # y = 0 line
    z_center = _corner_z(0.0, 0.0)

    A = np.zeros(K)
    A[0] = 1.0

    def residuals(A):
        w1 = _w_of_z(A, z_seam_x)
        w2 = _w_of_z(A, z_seam_y)
        wc = _w_of_z(A, np.array([z_center]))[0]
        return np.concatenate([
            np.abs(w1 - C_x0) - R_x0,
            np.abs(w2 - C_y0) - R_y0,
            [wc.real - w_center.real, wc.imag - w_center.imag],
        ])

    lam = 1e-10
    for _ in range(iters):
        r = residuals(A)
        J = np.zeros((r.size, K))
        eps = 1e-7
        for k in range(K):
            dA = A.copy()
            dA[k] += eps
            J[:, k] = (residuals(dA) - r) / eps
        step, *_ = np.linalg.lstsq(J.T @ J + lam * np.eye(K), -J.T @ r,
                                   rcond=None)
        best = None
        for s in (1.0, 0.5, 0.25, 0.1):
            An = A + s * step
            rn = float(np.linalg.norm(residuals(An)))
            if best is None or rn < best[0]:
                best = (rn, An)
        A = best[1]
        if np.linalg.norm(step) < 1e-15:
            break
    return A, float(np.abs(residuals(A)).max())


def conformal_cubed_sphere_mapping(x, y, K: int = 20):
    """Map TOP-panel coordinates (x, y) ∈ [-1,1]² to unit-sphere cartesian
    (X, Y, Z) via the numerically-derived Rancic conformal map (the analog
    of CubedSphere.jl's function of the same name)."""
    A, _ = rancic_coefficients(K)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    scalar = (x.ndim == 0)
    x, y = np.atleast_1d(x), np.atleast_1d(y)

    # fold to the first quadrant (the (1,1)-corner wedge covers it)
    xa, ya = np.abs(x), np.abs(y)
    w = _w_of_z(A, _corner_z(xa, ya))
    P = _stereo_inv(w) @ _R            # rotate back: R^T · P
    X, Y, Z = P[..., 0], P[..., 1], P[..., 2]
    # unfold with the matching sphere reflections
    X = np.where(x < 0, -X, X)
    Y = np.where(y < 0, -Y, Y)
    if scalar:
        return float(X[0]), float(Y[0]), float(Z[0])
    return X, Y, Z


def conformal_cubed_sphere_panel(size, z, radius=R_EARTH, halo=None,
                                 dtype=None, device=None):
    """A single conformal cubed-sphere panel as an
    ``OrthogonalSphericalShellGrid`` with (Bounded, Bounded, Bounded)
    topology."""
    if halo is None:
        halo = config.halo
    Nx, Ny, Nz = size
    Hx, Hy = min(halo, Nx), min(halo, Ny)

    dx = 2.0 / Nx
    dy = 2.0 / Ny
    iF = -1.0 + dx * np.arange(-Hx, Nx + Hx)
    iC = iF + dx / 2
    jF = -1.0 + dy * np.arange(-Hy, Ny + Hy)
    jC = jF + dy / 2

    lam, phi = {}, {}
    for key, (xs, ys) in (("ff", (iF, jF)), ("fc", (iF, jC)),
                          ("cf", (iC, jF)), ("cc", (iC, jC))):
        XX, YY = np.meshgrid(xs, ys, indexing="ij")
        X, Y, Z = conformal_cubed_sphere_mapping(XX, YY)
        phi[key] = np.rad2deg(np.arcsin(np.clip(Z, -1, 1)))
        lam[key] = np.rad2deg(np.arctan2(Y, X))

    return OrthogonalSphericalShellGrid(
        lam, phi, z, size, halo=halo, radius=radius,
        topology=(Bounded, Bounded, Bounded), dtype=dtype, device=device)
