"""Immersed boundaries: masked topography on a rectilinear, lat-lon or
orthogonal grid.

Counterpart of ``oceananigans_tpu/immersed.py``: ``GridFittedBottom``,
``PartialCellBottom``, ``GridFittedBoundary``, the ``ImmersedBoundaryGrid``
that wraps an underlying grid with dense boolean solid masks at every
staggered location, the masking helpers, the masked Poisson operator and
its preconditioned conjugate-gradient solver, and the per-interface
``ImmersedBoundaryCondition``. Solid faces carry zero velocity, tendencies
and fluxes are masked with ``torch.where``, and the pressure problem is the
masked 7-point operator solved by FFT-preconditioned CG (Jacobi-
preconditioned with partial cells or a stretched grid).

The wrapper is an ``nn.Module`` whose masks are buffers. It is no subclass
of the grid it wraps: the kernel gates test ``isinstance`` of the grid
classes, so an immersed grid never reaches a kernel, which would read
unmasked fields, as in the JAX package. It delegates every other metric
and query to the underlying grid.
"""

from __future__ import annotations

import torch

from oceananigans_torch.boundary_conditions import (
    FLUX, GRADIENT, VALUE, _fill_axis, fill_halo_regions,
    regularize_field_boundary_conditions,
)
from oceananigans_torch.fields import LOC_C, location_coords
from oceananigans_torch.grids.base import (
    AbstractGrid, Center, Face, pad_interior,
)
from oceananigans_torch.ops.operators import (
    X, Y, Z, dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, shift,
)

__all__ = ["GridFittedBottom", "GridFittedBoundary",
           "ImmersedBoundaryCondition", "ImmersedBoundaryGrid",
           "ImmersedPoissonSolver", "PartialCellBottom",
           "immersed_flux_divergence", "mask_flux", "mask_immersed_field",
           "masked_cg_solve", "masked_laplacian", "regularize_immersed_bc",
           "scalar_diffusivity_of", "solid_mask_at"]


class GridFittedBottom:
    """Solid below z = bottom_height(x, y): a callable of the cell centers'
    (x, y) coordinate tensors (metres on a rectilinear grid, degrees on a
    spherical one) or a 2-D array over the interior (its halos are filled
    by the grid's topology)."""

    def __init__(self, bottom_height):
        self.bottom_height = bottom_height

    def solid_ccc(self, grid):
        return grid.zC.expand(grid.shape) < self._bottom_full(grid)

    def _bottom_full(self, grid):
        """The bottom height on the halo-extended horizontal plane."""
        if callable(self.bottom_height):
            h = self.bottom_height(grid.xC, grid.yC)
            return torch.as_tensor(h, dtype=grid.dtype, device=grid.device)
        h = torch.as_tensor(self.bottom_height, dtype=grid.dtype,
                            device=grid.device)
        if h.ndim != 2:
            return h
        # an interior array: its halos filled by the grid's topology
        sx, sy, _ = grid.interior_slices
        full = torch.zeros((grid.shape[0], grid.shape[1], 1),
                           dtype=grid.dtype, device=grid.device)
        full[sx, sy, :] = h.reshape(h.shape[0], h.shape[1], 1)
        bcs = regularize_field_boundary_conditions(None, grid, LOC_C)
        for axis in (0, 1):
            _fill_axis(full, grid, axis, Center, *bcs.sides(axis))
        return full

    def __repr__(self):
        return f"GridFittedBottom({self.bottom_height!r})"


class PartialCellBottom(GridFittedBottom):
    """A bottom with partial cells: a cell is solid only where less than
    ``minimum_fractional_cell_height`` of it lies above the bottom, and the
    bottom-adjacent fluid cell's height shrinks to its water fraction
    (:meth:`dz_fraction`)."""

    def __init__(self, bottom_height, minimum_fractional_cell_height=0.2):
        super().__init__(bottom_height)
        self.minimum_fractional_cell_height = float(
            minimum_fractional_cell_height)

    def solid_ccc(self, grid):
        return self._water_fraction(grid) < \
            self.minimum_fractional_cell_height

    def _water_fraction(self, grid):
        """The fraction of each cell above the bottom, in [0, 1]."""
        zf = grid.zF.expand(grid.shape)
        dz = grid.dz(Center).expand(grid.shape)
        z_top = zf + dz             # zF is the bottom face of each cell
        return torch.clamp((z_top - self._bottom_full(grid)) / dz, 0.0, 1.0)

    def dz_fraction(self, grid, solid):
        frac = torch.clamp(self._water_fraction(grid),
                           self.minimum_fractional_cell_height, 1.0)
        return torch.where(solid, 1.0, frac)

    def __repr__(self):
        return (f"PartialCellBottom({self.bottom_height!r}, "
                f"{self.minimum_fractional_cell_height})")


class GridFittedBoundary:
    """An arbitrary 3-D solid mask: a callable ``mask(x, y, z)`` of the
    cell centers' coordinate tensors, or a boolean array over the interior
    or the halo-extended grid."""

    def __init__(self, mask):
        self.mask = mask

    def solid_ccc(self, grid):
        if callable(self.mask):
            x, y, z = (c.expand(grid.shape)
                       for c in (grid.xC, grid.yC, grid.zC))
            return torch.as_tensor(self.mask(x, y, z),
                                   device=grid.device).to(torch.bool)
        m = torch.as_tensor(self.mask, device=grid.device).to(torch.bool)
        if tuple(m.shape) == tuple(grid.N):
            full = torch.zeros(grid.shape, dtype=torch.bool,
                               device=grid.device)
            full[grid.interior_slices] = m
            return full
        return m

    def __repr__(self):
        return "GridFittedBoundary(...)"


class ImmersedBoundaryGrid(AbstractGrid):
    """An underlying grid with solid masks at every staggered location.

    ``solid_c`` is the cell mask, made halo-consistent (filled with the
    underlying grid's default halo rules and thresholded again), so the
    periodic images agree at the seams and the masked Poisson operator
    stays symmetric across them; a velocity face is solid where either
    adjacent cell is (``solid_u``, ``solid_v``, ``solid_w``). With a
    :class:`PartialCellBottom`, ``dz_sigma`` ∈ [ε, 1] scales the cell
    heights (:meth:`dz`). Every other metric and query is the underlying
    grid's; ``Ax``, ``Ay`` and ``V`` are built on this grid's ``dz``.
    """

    def __init__(self, underlying_grid, immersed_boundary):
        super().__init__()
        g = underlying_grid
        self.underlying_grid = g
        self.immersed_boundary = immersed_boundary
        solid = immersed_boundary.solid_ccc(g).expand(g.shape)
        solid = fill_halo_regions(solid.to(g.dtype).clone(), g) > 0.5
        self.register_buffer("solid_c", solid)
        # a velocity face is solid if either adjacent cell is
        self.register_buffer("solid_u", solid | shift(solid, -1, X))
        self.register_buffer("solid_v", solid | shift(solid, -1, Y))
        self.register_buffer("solid_w", solid | shift(solid, -1, Z))
        sigma = None
        if isinstance(immersed_boundary, PartialCellBottom):
            sigma = fill_halo_regions(immersed_boundary.dz_fraction(g, solid),
                                      g)
        self.register_buffer("dz_sigma", sigma)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            modules = self.__dict__.get("_modules", {})
            if "underlying_grid" not in modules:
                raise
            return getattr(modules["underlying_grid"], name)

    # ---- what the underlying grid says -----------------------------------
    @property
    def N(self):
        return self.underlying_grid.N

    @property
    def H(self):
        return self.underlying_grid.H

    @property
    def topology(self):
        return self.underlying_grid.topology

    @property
    def x_regular(self):
        return self.underlying_grid.x_regular

    @property
    def y_regular(self):
        return self.underlying_grid.y_regular

    @property
    def z_regular(self):
        return self.underlying_grid.z_regular

    def dx(self, *a, **k):
        return self.underlying_grid.dx(*a, **k)

    def dy(self, *a, **k):
        return self.underlying_grid.dy(*a, **k)

    def Az(self, *a, **k):
        return self.underlying_grid.Az(*a, **k)

    # ---- partial-cell-aware vertical metrics -----------------------------
    def dz(self, lz=Center):
        base = self.underlying_grid.dz(lz)
        if self.dz_sigma is None:
            return base
        dzc = self.dz_sigma * self.underlying_grid.dz(Center)
        if lz == Center:
            return dzc
        # a face's spacing is the distance between the adjacent centers of
        # the scaled cells: the mean of their heights
        return 0.5 * (dzc + shift(dzc, -1, Z))

    def mask_for(self, loc):
        """The solid mask at a velocity or center location."""
        if loc[0] == Face:
            return self.solid_u
        if loc[1] == Face:
            return self.solid_v
        if loc[2] == Face:
            return self.solid_w
        return self.solid_c

    @property
    def fluid_fraction(self):
        """The fluid share of the interior cells (a 0-d tensor)."""
        return 1.0 - self.interior(self.solid_c).to(torch.float32).mean()

    def extra_repr(self):
        return f"immersed_boundary={self.immersed_boundary!r}"


def mask_immersed_field(grid, a, loc, value=0.0):
    """``a`` with its solid values set to ``value`` (zero) on an immersed
    grid; ``a`` itself on any other grid."""
    if not isinstance(grid, ImmersedBoundaryGrid):
        return a
    return torch.where(grid.mask_for(loc), value, a)


def solid_mask_at(grid, loc):
    """The solid mask at any staggered location: a point is solid where
    any cell it touches is. None on a grid without ``solid_c`` (the cubed
    sphere's bathymetry view carries one too)."""
    m = getattr(grid, "solid_c", None)
    if m is None:
        return None
    for axis, lo in zip((X, Y, Z), loc):
        if lo == Face:
            m = m | shift(m, -1, axis)
    return m


def mask_flux(grid, f, loc):
    """A flux at ``loc`` zeroed wherever that location touches a solid
    cell: no flux through or inside the boundary, the default free-slip,
    no-flux immersed boundary. ``f`` itself on a grid without a mask."""
    m = solid_mask_at(grid, loc)
    if m is None or not torch.is_tensor(f):
        return f
    return torch.where(m, 0.0, f)


# ---------------------------------------------------------------------------
# The masked Poisson operator and its preconditioned CG
# ---------------------------------------------------------------------------

def masked_laplacian(grid, p):
    """∇·(∇p) with the flux through solid faces zeroed, zero in solid
    cells: the immersed pressure operator (negative semidefinite). Its
    metrics are the immersed grid's, so partial cells agree with the
    divergence the model computes."""
    g = grid
    gx = torch.where(grid.solid_u, 0.0, dx_f(p) / g.dx(Face, Center)) \
        * g.Ax(Face, Center, Center)
    gy = torch.where(grid.solid_v, 0.0, dy_f(p) / g.dy(Face, Center)) \
        * g.Ay(Center, Face, Center)
    gz = torch.where(grid.solid_w, 0.0, dz_f(p) / g.dz(Face)) \
        * g.Az(Center, Center)
    lap = (dx_c(gx) + dy_c(gy) + dz_c(gz)) / g.V(Center, Center, Center)
    return torch.where(grid.solid_c, 0.0, lap)


class _MaskedSystem(torch.nn.Module):
    """The constants of the volume-weighted masked system on an immersed
    grid: the interior fluid cells, the volumes, their count and, for the
    Jacobi preconditioner, the diagonal."""

    def __init__(self, grid, jacobi):
        super().__init__()
        g = grid.underlying_grid
        interior = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
        interior[g.interior_slices] = True
        fluid = interior & ~grid.solid_c
        self.register_buffer("fluid", fluid)
        self.register_buffer(
            "Vw", grid.V(Center, Center, Center).expand(g.shape).clone())
        self.register_buffer(
            "nf", torch.clamp(torch.sum(g.interior(fluid)), min=1))
        diag = None
        if jacobi:
            cx = torch.where(grid.solid_u, 0.0,
                             grid.Ax(Face, Center, Center)
                             / g.dx(Face, Center))
            cy = torch.where(grid.solid_v, 0.0,
                             grid.Ay(Center, Face, Center)
                             / g.dy(Face, Center))
            cz = torch.where(grid.solid_w, 0.0,
                             grid.Az(Center, Center) / grid.dz(Face))
            diag = -(cx + shift(cx, 1, X) + cy + shift(cy, 1, Y)
                     + cz + shift(cz, 1, Z))
            diag = torch.where(fluid & (diag < 0), diag, -1.0)
        self.register_buffer("diag", diag)


def masked_cg_solve(grid, rhs_interior, fill_halos, precond_apply, maxiter,
                    reltol, system=None, info=None, reduce_sum=None):
    """Solve the masked Poisson problem for an interior-shaped right-hand
    side: PCG on the volume-weighted system G p = V·rhs (symmetric for any
    cell volumes; V⁻¹G is the Laplacian), with the nullspace (constants on
    the fluid) projected out of the right-hand side and the fluid mean of
    the result removed. ``precond_apply`` solves the uniform-volume
    Laplacian on interior-shaped tensors (the FFT solver), or is None for
    the Jacobi preconditioner. ``system``: the grid's
    :class:`_MaskedSystem`, built here when not given. Returns the
    interior-shaped solution; ``info`` receives the iterations (a 0-d
    tensor) and the host reads of the convergence flag. ``reduce_sum``
    sums a tensor over the domain (default ``torch.sum``; on a rank's block
    the all-reduced sum), for the means and the inner products."""
    # the solvers package reaches the kernels, whose gates import the
    # advection schemes, which import this module: imported here
    from oceananigans_torch.solvers.conjugate_gradient import (
        conjugate_gradient,
    )
    if system is None:
        system = _MaskedSystem(grid, precond_apply is None)
    g = grid.underlying_grid
    ii = g.interior_slices
    fluid, Vw, nf = system.fluid, system.Vw, system.nf
    dot = None
    if reduce_sum is None:
        reduce_sum = torch.sum
    else:
        nf = torch.clamp(reduce_sum(g.interior(fluid).to(torch.int64)),
                         min=1)

        def dot(x, y):
            return reduce_sum(x * y)

    # CG iterates live on the interior fluid cells: every operator output
    # is zeroed elsewhere, or the dot products would pick up halo values
    rhs = pad_interior(rhs_interior, g.H)
    b = torch.where(fluid, rhs * Vw, 0.0)
    b_mean = reduce_sum(b[ii]) / nf
    b = torch.where(fluid, b - b_mean, 0.0)

    def A(p):
        # the fill writes only halo cells, which the iterates ignore
        return torch.where(fluid,
                           Vw * masked_laplacian(grid, fill_halos(p)), 0.0)

    if precond_apply is not None:
        def M(r):
            # the FFT inverse of the uniform-volume operator: exact when V
            # is uniform (G = V₀·L, so M ∝ L⁻¹)
            out = torch.zeros_like(r)
            out[ii] = precond_apply(r[ii] / Vw[ii]).to(r.dtype)
            return torch.where(fluid, out, 0.0)
    else:
        diag = system.diag

        def M(r):
            return torch.where(fluid, r / diag, 0.0)

    stats = {}
    p, it, _ = conjugate_gradient(
        A, b, torch.zeros_like(b), preconditioner=M, maxiter=maxiter,
        reltol=reltol, dot=dot, info=stats)
    if info is not None:
        info.update(stats, iterations=it)
    # gauge: zero fluid mean
    p_mean = reduce_sum(torch.where(fluid, p, 0.0)[ii]) / nf
    p = torch.where(fluid, p - p_mean, 0.0)
    return p[ii]


class ImmersedPoissonSolver(torch.nn.Module):
    """Preconditioned CG for the masked Poisson problem; takes and returns
    interior-shaped tensors like the FFT solver. The preconditioner is the
    FFT solver of the underlying grid where that grid is regular and has
    no partial cells (their scaled heights make the FFT inverse
    inconsistent with the operator), else Jacobi. The defaults follow the
    grid's dtype: ``reltol`` 1e-8 in float64 and 2e-5 in float32 (1e-8 is
    below float32's floor, where CG stalls), ``maxiter`` 200 with the FFT
    preconditioner and 600 with Jacobi. After each solve ``iterations``
    (a 0-d tensor on the device) and ``host_syncs`` (the host's reads of
    the convergence flag, ``solvers/conjugate_gradient.py``) say what it
    did."""

    def __init__(self, grid, preconditioner=None, maxiter=None,
                 reltol=None):
        super().__init__()
        from oceananigans_torch.solvers.fft_poisson import FFTPoissonSolver
        self.grid = grid
        base = grid.underlying_grid
        if reltol is None:
            reltol = 1e-8 if grid.dtype.itemsize >= 8 else 2e-5
        self.reltol = reltol
        scaled = grid.dz_sigma is not None
        if preconditioner is None and base.regular and not scaled:
            preconditioner = FFTPoissonSolver(base)
        self.preconditioner = preconditioner
        if maxiter is None:
            maxiter = 600 if preconditioner is None else 200
        self.maxiter = maxiter
        self.system = _MaskedSystem(grid, preconditioner is None)
        self._bcs = regularize_field_boundary_conditions(None, base, LOC_C)
        self.iterations = None
        self.host_syncs = 0

    def solve(self, rhs_interior):
        base = self.grid.underlying_grid
        info = {}
        out = masked_cg_solve(
            self.grid, rhs_interior,
            fill_halos=lambda p: fill_halo_regions(p, base, self._bcs),
            precond_apply=(None if self.preconditioner is None
                           else self.preconditioner.solve),
            maxiter=self.maxiter, reltol=self.reltol, system=self.system,
            info=info)
        self.iterations = info["iterations"]
        self.host_syncs = info["host_syncs"]
        return out


# ---------------------------------------------------------------------------
# ImmersedBoundaryCondition: conditions on the wet/solid interfaces
# ---------------------------------------------------------------------------

class ImmersedBoundaryCondition:
    """Conditions on the individual wet-cell/solid-cell interfaces
    ``west/east/south/north/bottom/top``, each a ``FluxBC``, ``ValueBC`` or
    ``GradientBC`` (or None); given as the ``immersed=`` member of a
    field's ``FieldBoundaryConditions``."""

    _sides = ("west", "east", "south", "north", "bottom", "top")

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None):
        self.west, self.east = west, east
        self.south, self.north = south, north
        self.bottom, self.top = bottom, top

    def __repr__(self):
        parts = [f"{s}={getattr(self, s)!r}" for s in self._sides
                 if getattr(self, s) is not None]
        return f"ImmersedBoundaryCondition({', '.join(parts)})"


def regularize_immersed_bc(bc, loc):
    """A plain condition expanded to all six sides, with the sides normal
    to the field's Face-located axes dropped (a Face-located field lies on
    the boundary in its normal direction); None when no side is left."""
    if bc is None:
        return None
    if not isinstance(bc, ImmersedBoundaryCondition):
        bc = ImmersedBoundaryCondition(*(bc,) * 6)
    sides = {}
    for i, s in enumerate(ImmersedBoundaryCondition._sides):
        sides[s] = None if loc[i // 2] == Face else getattr(bc, s)
    out = ImmersedBoundaryCondition(**sides)
    if all(getattr(out, s) is None for s in out._sides):
        return None
    return out


def _immersed_bc_value(bc, grid, loc, time):
    """A side condition at the 3-D nodes of ``loc``: numbers and arrays as
    given, callables ``f(x, y, z, t)`` evaluated."""
    cond = bc.condition
    if cond is None:
        return None
    if callable(cond):
        x, y, z = location_coords(grid, loc)
        return cond(x, y, z, 0.0 if time is None else time)
    if hasattr(cond, "__array__") and not torch.is_tensor(cond):
        return torch.as_tensor(cond, dtype=grid.dtype, device=grid.device)
    return cond


def immersed_flux_divergence(grid, ibc, loc, c, kappa, time=None):
    """The tendency (added to G) of the immersed-interface fluxes of the
    field ``c`` at ``loc``. A wet node has an immersed interface on a side
    where its neighbour (same location, shifted along the axis) is solid.
    Per side: ``FluxBC(q)`` adds A q / V (positive into the fluid);
    ``ValueBC(cb)`` adds A κ 2 (cb − c) / (Δ V), a one-sided gradient;
    ``GradientBC(g)`` adds ∓ A κ g / V, the sign from the side the solid
    is on. ``kappa`` is the scalar diffusivity (ν for momentum)."""
    solid = solid_mask_at(grid, loc)
    if solid is None or ibc is None:
        return 0.0
    wet = ~solid
    V = grid.V(*loc)
    flip = [Center if lo == Face else Face for lo in loc]
    areas = (grid.Ax(flip[0], loc[1], loc[2]),
             grid.Ay(loc[0], flip[1], loc[2]),
             grid.Az(loc[0], loc[1]))
    spacings = (grid.dx(*loc[:2]), grid.dy(*loc[:2]), grid.dz(loc[2]))
    out = 0.0
    for i, side in enumerate(ImmersedBoundaryCondition._sides):
        bc = getattr(ibc, side)
        if bc is None:
            continue
        axis, right = i // 2, i % 2
        if grid.N[axis] == 1:
            continue
        mask = wet & shift(solid, 1 if right else -1, axis - 3)
        A, d = areas[axis], spacings[axis]
        if bc.classification == FLUX:
            q = _immersed_bc_value(bc, grid, loc, time)
            if q is None:
                continue
            term = A * q / V
        elif bc.classification == VALUE:
            cb = _immersed_bc_value(bc, grid, loc, time)
            term = A * kappa * 2.0 * (cb - c) / (d * V)
        elif bc.classification == GRADIENT:
            gv = _immersed_bc_value(bc, grid, loc, time)
            term = (1.0 if right else -1.0) * A * kappa * gv / V
        else:
            raise ValueError(
                f"unsupported immersed boundary condition "
                f"{bc.classification!r} on side {side!r}")
        out = out + torch.where(mask, term, 0.0)
    return out


def scalar_diffusivity_of(closure, tracer=None):
    """The constant ν (``tracer=None``) or κ of ``tracer`` summed over the
    scalar-diffusivity members of ``closure``: the coefficient of the
    immersed Value and Gradient fluxes. Other closures contribute zero."""
    if closure is None:
        return 0.0
    if isinstance(closure, (tuple, list)):
        return sum(scalar_diffusivity_of(cl, tracer) for cl in closure)
    from oceananigans_torch.closures import ScalarDiffusivity, _kappa_for
    if not isinstance(closure, ScalarDiffusivity):
        return 0.0
    if tracer is None:
        return closure.nu
    return _kappa_for(closure.kappa, tracer)
