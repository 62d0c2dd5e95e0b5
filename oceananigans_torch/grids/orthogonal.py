"""Curvilinear spherical-shell grids: orthogonal shells, the rotated
lat-lon grid, and the tripolar grid with its north-fold (zipper) halo.

Counterpart of ``oceananigans_tpu/grids/orthogonal.py``. A grid is built on
the host in float64 numpy from its (λ, φ) nodes at the four horizontal
staggerings; its metrics are (nx, ny, 1) tensors from great-circle
distances between those nodes, consumed by the same operators as every
other grid.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.config import as_dtype, config
from oceananigans_torch.grids.base import (
    AbstractGrid, Bounded, Center, Face, Flat, Periodic, bshape,
    generate_coordinate, halo_per_axis,
)
from oceananigans_torch.grids.latlon import R_EARTH

#: the staggerings of the node dicts: x location, then y location
NODE_KEYS = ("ff", "fc", "cf", "cc")

#: marker of the y-axis "topology" of grids whose north edge is a tripolar
#: fold (the halo filled by the fold, not a wall)
ZIPPER_NORTH = "zipper_north"


def _haversine(lam1, phi1, lam2, phi2, radius):
    """Great-circle distance (in the units of ``radius``) between points
    given in degrees."""
    p1, p2 = np.deg2rad(phi1), np.deg2rad(phi2)
    dl = np.deg2rad(lam2 - lam1)
    dp = p2 - p1
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * radius * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def _spacing(lam, phi, axis, at_faces, radius):
    """Distances between neighbouring nodes along ``axis``: at centers from
    faces i, i+1 (``at_faces`` False) or at faces from centers i-1, i; the
    outermost row repeats its neighbour."""
    n = lam.shape[axis]
    lo = [slice(None)] * 2
    hi = [slice(None)] * 2
    lo[axis], hi[axis] = slice(0, n - 1), slice(1, n)
    lo, hi = tuple(lo), tuple(hi)
    d = np.empty(lam.shape)
    dist = _haversine(lam[lo], phi[lo], lam[hi], phi[hi], radius)
    edge = [slice(None)] * 2
    near = [slice(None)] * 2
    if at_faces:
        d[hi] = dist
        edge[axis], near[axis] = 0, 1
    else:
        d[lo] = dist
        edge[axis], near[axis] = n - 1, n - 2
    d[tuple(edge)] = d[tuple(near)]
    return d


def _guard(d):
    """Floor zero lengths (poles inside the domain) to a tiny positive
    value, so that divisions stay finite."""
    tiny = 1e-3 * np.median(d[d > 0]) if np.any(d > 0) else 1.0
    return np.maximum(d, tiny)


class OrthogonalSphericalShellGrid(AbstractGrid):
    """Curvilinear horizontal C-grid with 2-D (λ, φ) nodes at the four
    staggerings and 2-D metrics. ``z`` is a ``(bottom, top)`` pair, an
    array of ``Nz + 1`` faces or a callable ``k -> face`` (a stretched z).

    ``lam``/``phi`` map each key of :data:`NODE_KEYS` (x location, then y
    location) to a halo-extended (nx, ny) array of longitudes/latitudes in
    degrees. ``zipper`` marks a tripolar north fold: the north y halo is
    filled by :func:`fill_zipper_north`, not by a wall condition.
    """

    x_regular = y_regular = False

    def __init__(self, lam, phi, z, size, halo=None, radius=R_EARTH,
                 topology=None, zipper=False, dtype=None, device=None):
        super().__init__()
        dtype = as_dtype(dtype)
        device = torch.device(config.device if device is None else device)
        if halo is None:
            halo = config.halo
        if topology is None:
            topology = (Periodic, Bounded, Bounded)
        topology = tuple(topology)
        halos = halo_per_axis(halo)
        Nx, Ny, Nz = (int(n) for n in size)
        Hx, Hy = min(halos[0], Nx), min(halos[1], Ny)
        Hz = 0 if topology[2] == Flat else min(halos[2], Nz)
        zF, zC, dzC, dzF, z_reg, Lz = generate_coordinate(z, Nz, Hz,
                                                          topology[2])

        nx, ny = Nx + 2 * Hx, Ny + 2 * Hy
        lam = {k: np.array(lam[k], dtype=np.float64) for k in NODE_KEYS}
        phi = {k: np.array(phi[k], dtype=np.float64) for k in NODE_KEYS}
        for key in NODE_KEYS:
            if lam[key].shape != (nx, ny) or phi[key].shape != (nx, ny):
                raise ValueError(f"lam[{key}] and phi[{key}] must be "
                                 f"halo-extended ({nx}, {ny}), got "
                                 f"{lam[key].shape} and {phi[key].shape}")

        def dx(key, at_faces):
            return _guard(_spacing(lam[key], phi[key], 0, at_faces, radius))

        def dy(key, at_faces):
            return _guard(_spacing(lam[key], phi[key], 1, at_faces, radius))

        metrics = {
            "dxCC": dx("fc", False), "dxFC": dx("cc", True),
            "dxCF": dx("ff", False), "dxFF": dx("cf", True),
            "dyCC": dy("cf", False), "dyFC": dy("ff", False),
            "dyCF": dy("cc", True), "dyFF": dy("fc", True),
        }
        for key in NODE_KEYS:
            metrics[f"lam{key.upper()}"] = lam[key]
            metrics[f"phi{key.upper()}"] = phi[key]
        for name, arr in metrics.items():
            self.register_buffer(name, torch.as_tensor(
                arr, dtype=dtype, device=device).reshape(nx, ny, 1))
        for name, arr in (("zF", zF), ("zC", zC), ("dzC_", dzC),
                          ("dzF_", dzF)):
            self.register_buffer(name, torch.as_tensor(
                arr, dtype=dtype, device=device).reshape(bshape(2, len(arr))))
        for name, mask in zip(("fold_wrap", "fold_half"),
                              fold_masks(Nx, Hx, device)):
            self.register_buffer(name, mask, persistent=False)
        self.topology = topology
        self.zipper = bool(zipper)
        self.radius = float(radius)
        self.N, self.H = (Nx, Ny, Nz), (Hx, Hy, Hz)
        self.Nx, self.Ny, self.Nz = self.N
        self.Lz = Lz
        self.z_regular = z_reg

    # ---- metrics -------------------------------------------------------------
    def dx(self, lx=Center, ly=Center):
        return getattr(self, "dx" + ("F" if lx == Face else "C")
                       + ("F" if ly == Face else "C"))

    def dy(self, ly=Center, lx=Center):
        return getattr(self, "dy" + ("F" if lx == Face else "C")
                       + ("F" if ly == Face else "C"))

    def dz(self, lz=Center):
        return self.dzC_ if lz == Center else self.dzF_

    # the coordinates under the names set_field and location_coords use
    @property
    def xC(self):
        return self.lamCC

    @property
    def xF(self):
        return self.lamFC

    @property
    def yC(self):
        return self.phiCC

    @property
    def yF(self):
        return self.phiCF

    def nodes_2d(self, loc):
        """(λ, φ) at the horizontal location ``loc[:2]``."""
        key = (("F" if loc[0] == Face else "C")
               + ("F" if loc[1] == Face else "C"))
        return getattr(self, f"lam{key}"), getattr(self, f"phi{key}")

    def extra_repr(self):
        return (f"size={self.N}, topology={self.topology}, halo={self.H}, "
                f"zipper={self.zipper}, radius={self.radius:g}")


def _halo_xy(halo, size):
    halos = halo_per_axis(config.halo if halo is None else halo)
    return min(halos[0], size[0]), min(halos[1], size[1])


# ---------------------------------------------------------------------------
# Rotated latitude-longitude grid
# ---------------------------------------------------------------------------

def _rotate_coords(lam, phi, north_pole):
    """Geographic (λ, φ) of points given in a rotated system whose north
    pole sits at the geographic ``north_pole = (λp, φp)`` (degrees)."""
    lam_p, phi_p = np.deg2rad(north_pole[0]), np.deg2rad(north_pole[1])
    lr, pr = np.deg2rad(lam), np.deg2rad(phi)
    x = np.cos(pr) * np.cos(lr)
    y = np.cos(pr) * np.sin(lr)
    z = np.sin(pr)
    # about the y axis by 90° − φp, then about the z axis by λp
    beta = np.pi / 2 - phi_p
    xb = np.cos(beta) * x + np.sin(beta) * z
    zb = -np.sin(beta) * x + np.cos(beta) * z
    yb = y
    xg = np.cos(lam_p) * xb - np.sin(lam_p) * yb
    yg = np.sin(lam_p) * xb + np.cos(lam_p) * yb
    phi_g = np.rad2deg(np.arcsin(np.clip(zb, -1, 1)))
    lam_g = np.rad2deg(np.arctan2(yg, xg))
    return lam_g, phi_g


def RotatedLatitudeLongitudeGrid(size, longitude, latitude, z,
                                 north_pole=(0.0, 90.0), radius=R_EARTH,
                                 halo=None, dtype=None, device=None):
    """A lat-lon grid in a rotated coordinate system: ``longitude`` and
    ``latitude`` are the extents in the rotated system, ``north_pole`` the
    geographic position of its north pole."""
    Nx, Ny, _ = size
    Hx, Hy = _halo_xy(halo, size)
    dlam = (longitude[1] - longitude[0]) / Nx
    dphi = (latitude[1] - latitude[0]) / Ny
    lamF = longitude[0] + np.arange(-Hx, Nx + Hx) * dlam
    lamC = lamF + dlam / 2
    phiF = latitude[0] + np.arange(-Hy, Ny + Hy) * dphi
    phiC = phiF + dphi / 2
    lam, phi = {}, {}
    for key, (l1, p1) in (("ff", (lamF, phiF)), ("fc", (lamF, phiC)),
                          ("cf", (lamC, phiF)), ("cc", (lamC, phiC))):
        L, P = np.meshgrid(l1, p1, indexing="ij")
        lam[key], phi[key] = _rotate_coords(L, P, north_pole)
    span = abs(longitude[1] - longitude[0])
    TX = Periodic if abs(span - 360.0) < 1e-10 else Bounded
    return OrthogonalSphericalShellGrid(
        lam, phi, z, size, halo=halo, radius=radius,
        topology=(TX, Bounded, Bounded), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tripolar grid (Murray 1996)
# ---------------------------------------------------------------------------

def _murray(lam1d, phi1d, focal_distance, first_pole_longitude):
    """Geographic tripolar coordinates of the nominal (λ, φ) index grid."""
    L, P = np.meshgrid(lam1d, phi1d, indexing="ij")
    P = np.minimum(P, 90.0 - 1e-9)
    a = focal_distance
    psi = np.arcsinh(np.tan(np.deg2rad((90.0 - P) / 2)) / a)
    x = a * np.sin(np.deg2rad(L)) * np.cosh(psi)
    y = a * np.cos(np.deg2rad(L)) * np.sinh(psi)
    # exact zeros of sin at multiples of 180°, so that the columns on the
    # hemisphere boundary take the x = 0 branch
    x = np.where(np.mod(np.abs(L), 180.0) == 0.0, 0.0, x)
    # the half-range atan: the ±90° hemisphere shift below picks the
    # branch; at x = 0 its limit is −90° on both boundary columns
    with np.errstate(divide="ignore", invalid="ignore"):
        lam_g = np.where(
            x == 0, -90.0,
            -180.0 / np.pi * np.arctan(y / np.where(x == 0, 1.0, x)))
    phi_g = 90.0 - 360.0 / np.pi * np.arctan(np.sqrt(x * x + y * y))
    # the hemisphere of the nominal longitude (halo columns included) puts
    # the singularities at first_pole_longitude and 180° east of it
    lam_nom = np.mod(L, 360.0)
    lam_g = lam_g + np.where(lam_nom < 180.0, -90.0, 90.0)
    lam_g = lam_g + first_pole_longitude + 90.0
    return np.mod(lam_g, 360.0), phi_g


def TripolarGrid(size, southernmost_latitude=-80.0, z=(-1000.0, 0.0),
                 first_pole_longitude=70.0, focal_distance=0.45,
                 radius=R_EARTH, halo=None, dtype=None, device=None):
    """The global tripolar grid: lat-lon in the south, Murray's (1996)
    cofocal-ellipse coordinates towards the two displaced north poles, and
    a zipper fold along the north edge."""
    Nx, Ny, _ = size
    Hx, Hy = _halo_xy(halo, size)
    dlam = 360.0 / Nx
    dphi = (90.0 - southernmost_latitude) / Ny
    lamF = np.arange(-Hx, Nx + Hx) * dlam
    lamC = lamF + dlam / 2
    phiF = southernmost_latitude + np.arange(-Hy, Ny + Hy) * dphi
    phiC = phiF + dphi / 2
    lam, phi = {}, {}
    for key, (l1, p1) in (("ff", (lamF, phiF)), ("fc", (lamF, phiC)),
                          ("cf", (lamC, phiF)), ("cc", (lamC, phiC))):
        lam[key], phi[key] = _murray(l1, p1, focal_distance,
                                     first_pole_longitude)
    return OrthogonalSphericalShellGrid(
        lam, phi, z, size, halo=halo, radius=radius,
        topology=(Periodic, Bounded, Bounded), zipper=True, dtype=dtype,
        device=device)


# ---------------------------------------------------------------------------
# The zipper north-fold halo fill
# ---------------------------------------------------------------------------

def fold_masks(Nx, Hx, device=None):
    """The fold's column masks over a halo-extended x axis of ``Nx + 2Hx``
    columns, ``(nx, 1)`` boolean tensors: the x-Face column that wraps
    (interior column 0), and the second half of the duplicated row."""
    i_int = (np.arange(Nx + 2 * Hx) - Hx) % Nx
    return tuple(torch.as_tensor(m.reshape(-1, 1), device=device)
                 for m in (i_int == 0, i_int >= Nx // 2))


def fold_sign(loc):
    """The fold's sign at ``loc``: −1 for a horizontal velocity component
    (an x- or y-Face location), +1 otherwise."""
    return -1.0 if (loc[0] == Face or loc[1] == Face) else 1.0


def fill_zipper_north(a, grid, loc, sign):
    """Fill the north y halo of a tripolar field by the fold, in place, and
    return ``a``: the halo row Ny + h takes the interior row on the other
    side of the fold with i reversed, times ``sign`` (−1 for a horizontal
    velocity component).

    With 0-based interior indices:

    - x-Center: i' = Nx − 1 − i;
    - x-Face:   i' = (Nx − i) mod Nx, the wrapped column i = 0 unflipped;
    - y-Center: halo row Ny − 1 + h ← interior row Ny − 1 − h, and the
      second half of row Ny − 1 itself, which the fold duplicates, is
      overwritten by the first;
    - y-Face:   halo row Ny − 1 + h ← interior row Ny − h.

    The reversal is a flip of the halo-extended x axis (and a roll by one
    for x-Face fields), so the x axis, periodic, is filled first.
    """
    Ny, Hx, Hy = grid.Ny, grid.H[0], grid.H[1]
    x_face, y_face = loc[0] == Face, loc[1] == Face
    flipped = torch.flip(a, dims=(0,))
    if x_face:
        flipped = torch.roll(flipped, 1, dims=0)
        if 2 * Hx < a.shape[0]:
            flipped[0] = a[2 * Hx]

    def signed(row):
        if x_face:
            return torch.where(grid.fold_wrap, row * abs(sign), row * sign)
        return row * sign

    top = Hy + Ny
    for h in range(1, Hy + 1):
        j_src = top - h if y_face else top - 1 - h
        a[:, top - 1 + h] = signed(flipped[:, j_src])
    if not y_face:
        a[:, top - 1] = torch.where(grid.fold_half,
                                    signed(flipped[:, top - 1]),
                                    a[:, top - 1])
    return a


# ---------------------------------------------------------------------------
# Rotations between the grid's intrinsic frame and geographic east/north
# ---------------------------------------------------------------------------

def rotation_angles(grid):
    """(cosθ, sinθ) of the rotation from the grid's x/y frame to geographic
    east/north at cell centers, (nx, ny, 1) tensors; (1.0, 0.0) on a grid
    whose frame is geographic (rectilinear, lat-lon)."""
    if not isinstance(grid, OrthogonalSphericalShellGrid):
        return 1.0, 0.0
    from oceananigans_torch.ops.operators import X, Y, shift

    d2r = np.pi / 180.0
    ff = grid.phiFF
    ff_p0 = shift(ff, 1, X)            # (i+1, j)
    ff_0p = shift(ff, 1, Y)            # (i, j+1)
    ff_pp = shift(ff_p0, 1, Y)         # (i+1, j+1)
    dy_m = grid.dy(Center, Face)       # Δy at (x Face, y Center)
    dy_p = shift(dy_m, 1, X)
    dx_m = grid.dx(Center, Face)       # Δx at (x Center, y Face)
    dx_p = shift(dx_m, 1, Y)
    Rcos = 0.5 * (d2r * (ff_pp - ff_p0) / dy_p
                  + d2r * (ff_0p - ff) / dy_m)
    # sinθ = +∂φ/∂s_x, so that the grid's own x direction maps to (1, 0)
    # under intrinsic_vector
    Rsin = 0.5 * (d2r * (ff_pp - ff_0p) / dx_p
                  + d2r * (ff_p0 - ff) / dx_m)
    R = torch.clamp(torch.sqrt(Rcos ** 2 + Rsin ** 2), min=1e-30)
    return Rcos / R, Rsin / R


def intrinsic_vector(grid, u_e, v_e):
    """A geographic (east, north) vector in the grid's intrinsic (x, y)
    frame, with the angles at cell centers."""
    cos, sin = rotation_angles(grid)
    return u_e * cos + v_e * sin, -u_e * sin + v_e * cos


def extrinsic_vector(grid, u_i, v_i):
    """A grid-intrinsic (x, y) vector as geographic (east, north)
    components."""
    cos, sin = rotation_angles(grid)
    return u_i * cos - v_i * sin, u_i * sin + v_i * cos


__all__ = ["NODE_KEYS", "OrthogonalSphericalShellGrid",
           "RotatedLatitudeLongitudeGrid", "TripolarGrid", "ZIPPER_NORTH",
           "extrinsic_vector", "fill_zipper_north", "fold_masks",
           "fold_sign", "intrinsic_vector",
           "rotation_angles"]
