"""Grids: topology, halos, coordinates and metrics of the rectilinear,
latitude-longitude and orthogonal spherical-shell C-grids, the conformal
cubed sphere's panels and six-panel grid, and the module-level node and
spacing queries.

Counterpart of ``oceananigans_tpu/grids/__init__.py``. On the curvilinear
grids the x/y coordinates are longitude/latitude, so the λ/φ queries alias
the x/y ones.
"""

from oceananigans_torch.grids.base import (
    AbstractGrid, Bounded, Center, Face, Flat, Periodic, total_length,
)
from oceananigans_torch.grids.cubed_sphere import (
    conformal_cubed_sphere_mapping, conformal_cubed_sphere_panel,
)
from oceananigans_torch.grids.cubed_sphere_grid import (
    ConformalCubedSphereGrid,
)
from oceananigans_torch.grids.latlon import R_EARTH, LatitudeLongitudeGrid
from oceananigans_torch.grids.orthogonal import (
    OrthogonalSphericalShellGrid, RotatedLatitudeLongitudeGrid, TripolarGrid,
    extrinsic_vector, fill_zipper_north, intrinsic_vector, rotation_angles,
)
from oceananigans_torch.grids.rectilinear import RectilinearGrid


def nodes(grid, locs=(Center, Center, Center), **kw):
    return grid.nodes(locs, **kw)


def xnodes(grid, loc=Center, **kw):
    return grid.xnodes(loc, **kw)


def ynodes(grid, loc=Center, **kw):
    return grid.ynodes(loc, **kw)


def znodes(grid, loc=Center, **kw):
    return grid.znodes(loc, **kw)


lambda_nodes = λnodes = xnodes
phi_nodes = φnodes = ynodes
rnodes = znodes


def _interior_spacing(grid, d):
    sl = tuple(grid.interior_slices[ax] if d.shape[ax] > 1 else slice(None)
               for ax in range(3))
    return d[sl]


def xspacings(grid, lx=Center, ly=Center):
    return _interior_spacing(grid, grid.dx(lx, ly))


def yspacings(grid, ly=Center, lx=Center):
    return _interior_spacing(grid, grid.dy(ly, lx))


def zspacings(grid, lz=Center):
    return _interior_spacing(grid, grid.dz(lz))


lambda_spacings = λspacings = xspacings
phi_spacings = φspacings = yspacings
rspacings = zspacings


def minimum_xspacing(grid):
    return grid.min_spacing(0)


def minimum_yspacing(grid):
    return grid.min_spacing(1)


def minimum_zspacing(grid):
    return grid.min_spacing(2)


__all__ = [
    "AbstractGrid", "Bounded", "Center", "ConformalCubedSphereGrid", "Face",
    "Flat", "LatitudeLongitudeGrid", "OrthogonalSphericalShellGrid", "Periodic",
    "R_EARTH", "RectilinearGrid", "RotatedLatitudeLongitudeGrid",
    "TripolarGrid", "conformal_cubed_sphere_mapping",
    "conformal_cubed_sphere_panel", "extrinsic_vector", "fill_zipper_north",
    "intrinsic_vector", "lambda_nodes", "lambda_spacings",
    "minimum_xspacing", "minimum_yspacing", "minimum_zspacing", "nodes",
    "phi_nodes", "phi_spacings", "rnodes", "rotation_angles", "rspacings",
    "total_length", "xnodes", "xspacings", "ynodes", "yspacings", "znodes",
    "zspacings",
]
