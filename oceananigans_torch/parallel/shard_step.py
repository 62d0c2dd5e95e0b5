"""The distributed model step with explicit halo exchange.

Counterpart of ``oceananigans_tpu/parallel/shard_step.py``. The JAX package
runs the step inside ``shard_map`` on a local-halos layout; here each rank
is a process that holds its own block, in the same layout: an ``(nxl, nyl,
Nz)`` grid with its own halo rings, so a rank's LOCAL model is an ordinary
single-device model and every operator and kernel of the port runs on it
unchanged. Communication happens only in the halo fills
(:func:`dist_fill_halos`, two paired transfers for each distributed axis
and field), in the pencil transposes of the pressure solve, in the
all-reduced inner products of the CG solvers and, with particles, in the
all-reduce of their interpolated values.

Every local grid is the rank's window of the global grid: its coordinate,
metric and mask tensors are the halo-extended windows of the global ones,
so forcings, boundary functions and background fields evaluate at the
block's true coordinates. The local model decides its kernels when it is
built, on its own block: the tendency kernels engage where their gates
hold, and no fused AB2 kernel runs (``dist_halo`` is set, as the JAX step
refuses them).

Scope of ``DistributedStep(make_model, grid, dist)``, as in the JAX
package: ``NonhydrostaticModel`` (regular or stretched-z
``RectilinearGrid``, an ``ImmersedBoundaryGrid`` over one, x/y Periodic or
Bounded, quasi-AB2 or RK3) and ``HydrostaticFreeSurfaceModel`` (explicit,
split-explicit or implicit free surface, the last as a rank-local CG with
all-reduced inner products; ``RectilinearGrid``, ``LatitudeLongitudeGrid``
and immersed grids; z-star; constant-coefficient and the ocean closures),
on interiors that divide the mesh. It refuses what the JAX
``DistributedStep`` refuses, in its words (particles, background fields,
forcings and boundary functions on plain rectilinear grids), and a split
axis without a halo: a halo-free periodic axis wraps by rolling the array,
which on a block would wrap each rank onto itself.

``DistributedStep(..., gspmd=True)``, which only
:func:`~oceananigans_torch.parallel.distributed.sharded_step_fn` builds,
takes what the JAX package's GSPMD path takes on these grids: the
shallow-water model too; forcings, callable and array boundary conditions,
background fields, hydrostatic models on stretched x/y; particles,
replicated on every rank (each rank interpolates the particles it owns, an
all-reduce gives every rank all of them); interiors that do not divide the
mesh, in blocks that differ by one cell; and split periodic axes without a
halo, which the local grids carry a halo on (the global grid's largest),
filled by the exchange; blocks narrower than their halo, whose halo
cells take the cells they image from whichever block owns them, in a
second round where they lie past a wall; and the grids of
``OrthogonalSphericalShellGrid``, the tripolar north fold across the
ranks that hold mirror columns among them (:class:`NorthFold`). Without a
``make_model`` the local model is the global one's class built from its
recorded arguments, each horizontal field among them cut to the block
(:func:`_localize`). A split Bounded axis without a halo stays refused
(the serial operators wrap across its walls, which no halo cell of a
block holds).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import types

import numpy as np
import torch

from oceananigans_torch.boundary_conditions import (
    COMMUNICATION, FLUX, OPEN, VALUE, _bc_value, _fill_axis,
    fill_halo_regions, regularize_field_boundary_conditions,
)
from oceananigans_torch.fields import LOC_C, location_coords
from oceananigans_torch.grids.base import (
    AXIS_NAMES, Bounded, Center, Face, Flat, Periodic,
)
from oceananigans_torch.grids.orthogonal import (
    fill_zipper_north, fold_masks, fold_sign,
)
from oceananigans_torch.parallel.distributed import (
    Distributed, _map_tensors, block_offsets, block_sizes,
)
from oceananigans_torch.parallel.halo_exchange import (
    _exchange_axis, exchange_runs, ghost_runs,
)

__all__ = ["DistributedStep", "dist_fill_halos", "dist_fill_xy", "DistHalo",
           "DistributedModel", "DistributedImmersedPoissonSolver",
           "NorthFold"]

@dataclasses.dataclass(frozen=True)
class DistHalo:
    """The mesh decomposition a LOCAL model carries, so that its halo
    fills go through the exchange: the rank's :class:`Distributed`, the
    blocks' sizes along each mesh axis, the grid's :class:`NorthFold`
    (None without one) and ``corner``, the local column of the global
    array's column (0, 0) on the block at mesh position (0, 0) (not (0, 0)
    where a halo-free axis was padded)."""

    dist: Distributed
    sizes: tuple
    fold: object = None
    corner: tuple = (0, 0)

    def surface_cell_height(self, grid):
        """CATKE's surface cell height on this rank's block ``grid`` (the
        local grid, or its σ-scaled view): the serial step's, the top
        interior cell of the GLOBAL metric's column (0, 0)
        (``closures_ocean._surface_cell_height``). Where the heights vary
        by column (σ-scaled or partial cells) only the block at mesh
        position (0, 0) holds that column: it writes the value and every
        other rank zero, merged over the ranks (one all-reduce of one
        number, counted as ``"surface_dz"``). Where they do not, every
        block's own column is the same."""
        dz = grid.dz(Center)
        k = grid.H[2] + grid.N[2] - 1
        if dz.shape[0] == dz.shape[1] == 1:
            return dz.reshape(-1)[k]
        value = dz.new_zeros(1)
        if tuple(self.dist.coords) == (0, 0):
            value[0] = dz[self.corner[0], self.corner[1], k]
        return self.dist.merge_disjoint(value, "surface_dz").reshape(())

    def size(self, axis):
        return self.dist.partition[axis]

    def index(self, axis):
        """This rank's coordinate along mesh ``axis`` (``axis_index``)."""
        return self.dist.coords[axis]

    def offset(self, axis):
        """The global index of this rank's first cell along mesh
        ``axis``."""
        return block_offsets(self.sizes[axis])[self.index(axis)]

    def extent(self, axis):
        """The global interior's extent along mesh ``axis``."""
        return sum(self.sizes[axis])


class NorthFold:
    """The tripolar north fold (``fill_zipper_north``) of a sharded grid.
    The rows the fold reads, the top ``Hy + 1`` interior rows, are
    gathered into one strip of the global width on every rank (each rank
    writes the cells it owns into zeros, merged by
    :meth:`~oceananigans_torch.parallel.distributed.Distributed.
    merge_disjoint`), the
    strip's x halo takes its periodic images, and the serial fold folds it;
    each rank then writes its window of the folded rows, the north halo
    rows and, of a y-Center field, the second half of row ``Ny − 1``,
    wherever they lie in its block, halo included. So no rank needs
    another's folded rows, and the fill is the serial one bit for bit.
    ``grid`` is the global grid, ``sizes`` the blocks' sizes along x and y
    and ``hx`` the local grids' x halo."""

    def __init__(self, grid, sizes, hx, device):
        (Nx, Ny), Hy = grid.N[:2], grid.H[1]
        if Ny < Hy + 1:
            raise ValueError(f"a north fold of {Ny} rows needs more than "
                             f"its halo of {Hy}")
        self.Nx, self.Ny, self.hx, self.Hy = Nx, Ny, hx, Hy
        self.sizes = sizes
        self.offsets = tuple(block_offsets(s) for s in sizes)
        # fill_zipper_north's view of the strip: Hy + 1 "interior" rows
        # between Hy rows below and the Hy halo rows above
        wrap, half = fold_masks(Nx, hx, device)
        self.strip_grid = types.SimpleNamespace(
            Ny=Hy + 1, H=(hx, Hy, 0), fold_wrap=wrap, fold_half=half)

    def _block(self, dist):
        (rx, ry), (ox, oy) = dist.coords, (self.offsets[0][dist.coords[0]],
                                           self.offsets[1][dist.coords[1]])
        return ox, oy, self.sizes[0][rx], self.sizes[1][ry]

    def folded(self, a, loc, dist):
        """The folded strip of the LOCAL block ``a`` at ``loc`` (every
        rank calls it together): rows ``2Hy`` on hold global rows ``Ny −
        1`` on."""
        Hy, hx, R0 = self.Hy, self.hx, self.Ny - 1 - self.Hy
        ox, oy, nxl, nyl = self._block(dist)
        strip = a.new_zeros((self.Nx, Hy + 1) + tuple(a.shape[2:]))
        lo, hi = max(R0, oy), min(self.Ny, oy + nyl)
        if lo < hi:
            strip[ox:ox + nxl, lo - R0:hi - R0] = \
                a[hx:hx + nxl, lo - oy + Hy:hi - oy + Hy]
        dist.merge_disjoint(strip,
                            "fold_2d" if a.shape[-1] == 1 else "fold_3d")
        full = a.new_zeros((self.Nx + 2 * hx, 3 * Hy + 1)
                           + tuple(a.shape[2:]))
        full[:, Hy:2 * Hy + 1] = _wrap_pad(strip, 0, hx)
        return fill_zipper_north(full, self.strip_grid, loc, fold_sign(loc))

    def write(self, a, full, loc, dist):
        """Write the rows of the folded strip ``full`` that fall in the
        LOCAL block ``a`` (halo rows included), in place."""
        Hy, Ny = self.Hy, self.Ny
        ox, oy, nxl, nyl = self._block(dist)
        first = Ny if loc[1] == Face else Ny - 1
        lo, hi = max(first, oy - Hy), min(Ny + Hy, oy + nyl + Hy)
        if lo < hi:
            a[:, lo - oy + Hy:hi - oy + Hy] = full[
                ox:ox + nxl + 2 * self.hx,
                lo - Ny + 2 * Hy + 1:hi - Ny + 2 * Hy + 1]
        return a


def _values(lbc, rbc, grid, axis, loc, time, use_values):
    """The side conditions' values for a fill (None for flux conditions,
    whose values enter the tendencies, and when ``use_values`` is off)."""
    if not use_values:
        return None, None

    def one(bc):
        if bc is None or bc.classification == FLUX:
            return None
        return _bc_value(bc, grid, axis, loc, time)
    return one(lbc), one(rbc)


def _writes(bc):
    """Whether a wall fill writes past the wall by ``bc`` (None and a
    communication condition leave the halo)."""
    return bc is not None and bc.classification != COMMUNICATION


def dist_fill_xy(a, grid, bcs, loc, time, dt, ctx, global_topo,
                 use_values=True, fold=False):
    """The distributed x/y halo fill of a LOCAL block, in place: the
    neighbour exchange along each distributed axis (the ring wraps where
    the domain is periodic), and the physical boundary fill only on the
    ranks that own a domain edge, on that edge's side. ``use_values=False``
    skips the conditions' values (the η and transport fills take none, as
    their serial counterparts). Unlike the JAX package, whose edge shard
    keeps only the halo strips of its physical fill, the edge rank's fill
    also imposes the left wall-face value, as the serial fill does.

    Where a block is narrower than its halo, the halo cells of other
    blocks that image what the edge fills write (the ghosts past a wall,
    and the wall face itself) take them in a second round. ``fold`` (the
    3-D fills') folds the north y halo of a grid with a :class:`NorthFold`
    as ``fill_halo_regions`` does; the 2-D fills, like their serial
    counterpart, take the north wall's condition."""
    for axis in (0, 1):
        n_shards = ctx.size(axis)
        topo = global_topo[axis]
        if topo == Flat:
            continue
        lbc, rbc = bcs.sides(axis)
        zipper = (fold and axis == 1 and ctx.fold is not None
                  and a.shape[1] == grid.shape[1])
        if zipper:
            # as fill_halo_regions folds: the south side's fill alone,
            # without the last step's Δt
            rbc, dt = None, None
        lval, rval = _values(lbc, rbc, grid, axis, loc, time, use_values)
        if n_shards == 1:
            _fill_axis(a, grid, axis, loc[axis], lbc, rbc, lval, rval,
                       dt=dt)
        else:
            H = grid.H[axis]
            sizes = tuple(ctx.sizes[axis])
            _exchange_axis(a, ctx.dist, axis, H, topo == Periodic, sizes)
            if topo == Periodic:
                continue
            i = ctx.index(axis)
            first, last = i == 0, i == n_shards - 1
            if first or last:
                _fill_axis(a, grid, axis, loc[axis], lbc if first else None,
                           rbc if last else None, lval, rval, dt=dt)
        if zipper:
            ctx.fold.write(a, ctx.fold.folded(a, loc, ctx.dist), loc,
                           ctx.dist)
        if n_shards > 1:
            low = -H
            if _writes(lbc):
                low = 1 if loc[axis] == Face and lbc.classification in (
                    OPEN, VALUE) else 0
            runs = ghost_runs(sizes, H, low, H if _writes(rbc) else 0)
            if runs is not None:
                exchange_runs(a, ctx.dist, axis, runs, "ghosts")
    return a


def dist_fill_halos(a, grid, bcs, loc, time, dt, ctx, global_topo):
    """Fill every halo ring of a LOCAL block in place: x/y through
    :func:`dist_fill_xy` with the north fold, z with the ordinary local
    fill (z is never distributed)."""
    dist_fill_xy(a, grid, bcs, loc, time, dt, ctx, global_topo, fold=True)
    return fill_halo_regions(a, grid, bcs, loc, time, dt=dt, axes=(2,))


def _local_sizes(grid, dist):
    px, py = dist.partition
    Nx, Ny, Nz = grid.N
    if Nx % px or Ny % py:
        raise ValueError(f"grid interior {grid.N[:2]} must divide the "
                         f"mesh ({px}, {py})")
    return px, py, Nx // px, Ny // py


def _cut(a, axis, start, length):
    """``a[..., start:start + length, ...]`` along ``axis`` (a tensor or a
    numpy array)."""
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, start + length)
    return a[tuple(idx)]


def _wrap_pad(a, axis, h):
    """``a`` with ``h`` periodic images of its ends on either side along
    ``axis`` (a tensor or a numpy array)."""
    n = a.shape[axis]
    parts = (_cut(a, axis, n - h, h), a, _cut(a, axis, 0, h))
    if isinstance(a, np.ndarray):
        return np.concatenate(parts, axis=axis)
    return torch.cat(parts, dim=axis)


def _pad_grid(grid, pads):
    """A copy of ``grid`` with a halo of ``pads[axis]`` cells on each
    halo-free x/y axis that has one: the metric and mask tensors take the
    periodic images of their ends, the axis's own coordinates those images
    shifted by the axis's extent."""
    pg = copy.deepcopy(grid)
    for axis, h in enumerate(pads):
        if not h:
            continue
        N = grid.N[axis]
        L = (grid.Lx, grid.Ly)[axis]
        coords = {f"{AXIS_NAMES[axis]}F", f"{AXIS_NAMES[axis]}C",
                  *(("lamF", "lamC"), ("phiF", "phiC"))[axis]}
        for mod in pg.modules():
            for name, buf in list(mod._buffers.items()):
                if buf is None or buf.ndim < 3 or buf.shape[axis - 3] != N:
                    continue
                d = buf.ndim - 3 + axis
                out = _wrap_pad(buf, d, h)
                if name in coords:
                    shift = torch.zeros(N + 2 * h, dtype=buf.dtype,
                                        device=buf.device)
                    shift[:h], shift[h + N:] = -L, L
                    view = [1] * out.ndim
                    view[d] = -1
                    out = out + shift.reshape(view)
                mod._buffers[name] = out.contiguous()
            if "H" in mod.__dict__:
                H = list(mod.H)
                H[axis] = h
                mod.H = tuple(H)
    return pg


def _window_grid(grid, device, x0, y0, nxl, nyl):
    """A copy of ``grid`` whose coordinate, metric and mask tensors are the
    halo-extended windows starting at ``(x0, y0)`` of the global ones (the
    JAX package's stacked grid leaves), with the local sizes ``(nxl,
    nyl)``, on ``device``: the local model sees the TRUE coordinates and
    metrics of its own block (a latitude band's, a bathymetry's masks, a
    cube block's)."""
    (gx, gy, _), (Hx, Hy) = grid.shape, grid.H[:2]
    lg = copy.deepcopy(grid)
    for mod in lg.modules():
        for name, buf in list(mod._buffers.items()):
            if buf is None or buf.ndim < 3:
                continue
            if gx > 1 and buf.shape[-3] == gx:
                buf = buf.narrow(-3, x0, nxl + 2 * Hx)
            if gy > 1 and buf.shape[-2] == gy:
                buf = buf.narrow(-2, y0, nyl + 2 * Hy)
            mod._buffers[name] = buf.clone()
        if "N" in mod.__dict__:
            Nx, Ny, Nz = mod.N
            mod.N = (nxl, nyl, Nz)
            mod.Nx, mod.Ny = nxl, nyl
            # keep the regular-spacing identities (dx = Lx/Nx) true
            for attr, n, full in (("Lx", nxl, Nx), ("Ly", nyl, Ny)):
                if attr in mod.__dict__:
                    setattr(mod, attr, getattr(mod, attr) * n / full)
    return lg.to(device)


def _cut_field(a, window):
    """The horizontal field ``a`` (a tensor or a numpy array that broadcasts
    against the grid's ``(x, y, z)`` shape) cut by ``window``."""
    if a.ndim > 3:
        raise ValueError(f"a {a.ndim}-dimensional array where a field or "
                         "a boundary slab was expected")
    lead = (1,) * (3 - a.ndim)
    out = window(a.reshape(lead + tuple(a.shape)))
    return out.reshape(tuple(out.shape)[len(lead):])


def _is_array(a):
    return isinstance(a, (torch.Tensor, np.ndarray)) and a.ndim >= 1


def _localize(kwargs, window):
    """A model's recorded constructor arguments ``kwargs`` with each
    horizontal field among them cut to a rank's block by ``window``
    (:meth:`DistributedStep.window`): the array conditions of the boundary
    conditions (a boundary slab, or the immersed nodes), the array
    diffusivities of the closures, array background and auxiliary fields
    and a shallow-water bathymetry. Everything else is passed as it is:
    the port takes arrays of x and y nowhere else (a time series keeps its
    global snapshots, which the model's shape check refuses on a
    block)."""
    kw = dict(kwargs)

    def fields(d):
        return None if d is None else {
            k: _cut_field(v, window) if _is_array(v) else v
            for k, v in dict(d).items()}

    for name in ("background_fields", "auxiliary_fields"):
        if kw.get(name) is not None:
            kw[name] = fields(kw[name])
    if _is_array(kw.get("bathymetry")):
        kw["bathymetry"] = _cut_field(kw["bathymetry"], window)
    if kw.get("boundary_conditions") is not None:
        bcs = {}
        for name, fbcs in dict(kw["boundary_conditions"]).items():
            if fbcs is not None and dataclasses.is_dataclass(fbcs):
                fbcs = dataclasses.replace(fbcs, **{
                    f.name: dataclasses.replace(
                        bc, condition=_cut_field(bc.condition, window))
                    for f in dataclasses.fields(fbcs)
                    for bc in (getattr(fbcs, f.name),)
                    if _is_array(getattr(bc, "condition", None))})
            bcs[name] = fbcs
        kw["boundary_conditions"] = bcs
    closure = kw.get("closure")
    if closure is not None:
        def local(c):
            cut = {}
            for attr in ("nu", "kappa"):
                v = getattr(c, attr, None)
                if _is_array(v):
                    cut[attr] = _cut_field(v, window)
                elif isinstance(v, dict) and any(map(_is_array,
                                                     v.values())):
                    cut[attr] = fields(v)
            if not cut:
                return c
            c = copy.copy(c)
            c.__dict__.pop("_on_grid", None)
            for attr, v in cut.items():
                setattr(c, attr, v)
            return c
        kw["closure"] = (tuple(local(c) for c in closure)
                         if isinstance(closure, (tuple, list))
                         else local(closure))
    return kw


class DistributedStep:
    """The explicit-halo distributed step of a model configuration::

        dstep = DistributedStep(make_model, grid, dist)
        state = dstep.to_local_state(global_state)   # once
        state = dstep.step(state, dt)
        final = dstep.from_local_state(state)        # on rank 0

    ``make_model(grid)`` is called twice on every rank: on the global grid
    (the validation, the conversions and the writers' view) and on this
    rank's local grid (the model the rank runs). ``dist`` is the rank's
    :class:`~oceananigans_torch.parallel.distributed.Distributed`; the
    local grid lives on ``dist.device``. ``gspmd=True`` widens the scope to
    that of the JAX package's GSPMD path (see the module's docstring), and
    then ``make_model`` may be None with ``model``, the model on ``grid``:
    the local model is rebuilt from its recorded arguments
    (:func:`_localize`).
    """

    def __init__(self, make_model, grid, dist: Distributed, gspmd=False,
                 model=None):
        from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
        from oceananigans_torch.immersed import ImmersedBoundaryGrid
        from oceananigans_torch.models import (
            HydrostaticFreeSurfaceModel, NonhydrostaticModel,
            ShallowWaterModel,
        )
        from oceananigans_torch.parallel.distributed_fft import (
            DistributedFFTPoissonSolver, DistributedFourierTridiagonalSolver,
        )

        self.dist = dist
        self.global_grid = grid
        self.gspmd = gspmd
        immersed = isinstance(grid, ImmersedBoundaryGrid)
        base_grid = grid.underlying_grid if immersed else grid
        gmodel = make_model(grid) if make_model is not None else model
        kinds = (NonhydrostaticModel, HydrostaticFreeSurfaceModel)
        if gspmd:
            kinds += (ShallowWaterModel,)
        if not isinstance(gmodel, kinds):
            raise ValueError("DistributedStep supports Nonhydrostatic and "
                             "HydrostaticFreeSurface models")
        self.hydrostatic = isinstance(gmodel, HydrostaticFreeSurfaceModel)
        self.shallow_water = isinstance(gmodel, ShallowWaterModel)
        self.global_solve = not (self.hydrostatic or self.shallow_water)
        # Hydrostatic notes: implicit free surfaces run via CG on this
        # path regardless of solver_method (the spectral/matrix variants
        # need global transforms) — shard-local operator applications
        # with exchanged halos + psum-reduced inner products. Bounded
        # distributed axes are fine: the wall-transport zeroing and η
        # boundary fills are shard-index-guarded.
        self.latlon = isinstance(base_grid, LatitudeLongitudeGrid)
        self.stacked = self.latlon or immersed
        if self.latlon and not self.hydrostatic and not self.shallow_water:
            raise ValueError("lat-lon on the explicit-halo path is "
                             "supported for the hydrostatic model (the "
                             "nonhydrostatic pressure solve needs a "
                             "global transform; use the GSPMD path)")
        if not self.latlon:
            if not (base_grid.x_regular and base_grid.y_regular) \
                    and not gspmd:
                raise ValueError("DistributedStep needs regular x/y "
                                 "spacings (z may be stretched)")
            if not base_grid.regular and grid.axis_topo(2) != Bounded \
                    and self.global_solve:
                raise ValueError(
                    "stretched z must be Bounded (the distributed "
                    "Fourier-tridiagonal solver's assumption)")
        if not gspmd:
            self._refuse_as_jax(gmodel)
        self.gmodel = gmodel

        px, py = dist.partition
        if not gspmd:
            _local_sizes(grid, dist)
        self.px, self.py = px, py
        #: each mesh axis's block sizes and first cells, in rank order
        self.sizes = (block_sizes(grid.N[0], px), block_sizes(grid.N[1], py))
        self.offsets = tuple(block_offsets(s) for s in self.sizes)
        rx, ry = dist.coords
        self.nxl, self.nyl = self.sizes[0][rx], self.sizes[1][ry]
        topo = tuple(grid.axis_topo(ax) for ax in range(3))
        self.topo = topo
        # under gspmd a split periodic axis without a halo gets one on the
        # local grids, as wide as the global grid's largest (at least one
        # cell)
        pad = max(max(grid.H), 1)
        self.pads = tuple(pad if gspmd and dist.size(axis) > 1
                          and grid.H[axis] == 0 and topo[axis] == Periodic
                          else 0 for axis in (0, 1))
        for axis in (0, 1):
            if dist.size(axis) == 1 or grid.H[axis] or self.pads[axis]:
                continue
            if not gspmd:
                raise ValueError(
                    f"axis {axis} is split over {dist.size(axis)} ranks but "
                    "has no halo: a halo-free periodic axis wraps each "
                    "rank's block onto itself; build the grid with a halo "
                    "on every distributed axis or partition another axis")
            raise ValueError(
                f"axis {axis} is {topo[axis].capitalize()} and split over "
                f"{dist.size(axis)} ranks but has no halo: the serial "
                "operators wrap across its walls, which no halo cell of a "
                "block holds; build the grid with a halo on every "
                "distributed Bounded axis or partition another axis")
        #: the local grids' x/y halos
        self.halo = tuple(grid.H[axis] or self.pads[axis] for axis in (0, 1))
        pgrid = _pad_grid(grid, self.pads) if any(self.pads) else grid
        lgrid = _window_grid(pgrid, dist.device, self.offsets[0][rx],
                             self.offsets[1][ry], self.nxl, self.nyl)
        self.local_grid = lgrid
        if make_model is not None:
            lmodel = make_model(lgrid)
        else:
            kwargs = getattr(gmodel, "_init_kwargs", None)
            if kwargs is None:
                raise ValueError("pass make_model(grid): this model did not "
                                 "record its constructor arguments")
            lmodel = type(gmodel)(grid=lgrid,
                                  **_localize(kwargs, self.window))
        # route the local model's halo fills through the exchange, with
        # the blocks' sizes and the grid's fold
        fold = None
        if getattr(base_grid, "zipper", False):
            fold = NorthFold(base_grid, self.sizes, self.halo[0],
                             dist.device)
        ctx = DistHalo(dist, self.sizes, fold, tuple(
            self.halo[axis] - grid.H[axis] for axis in (0, 1)))
        lmodel.set_dist_halo(ctx, topo)
        # CATKE's surface cell height is the global column (0, 0)'s on
        # every block (a plain function: a deep copy of the grid keeps it)
        lmodel.grid.dist_surface_cell_height = \
            lambda g: ctx.surface_cell_height(g)
        self.lmodel = lmodel
        if getattr(lmodel, "particles", None) is not None:
            lmodel.particles = self._sharded_particles(lmodel.particles)
        # the local model's own step is the whole step: its fills go
        # through the exchange, and its projection through a
        # distribution-aware solver (the hydrostatic free surfaces are
        # rank-local apart from their exchanges and all-reduced CG dots)
        if immersed and self.global_solve:
            # masked CG on each rank's block, FFT-preconditioned when the
            # underlying grid admits the pencil solver
            precond = None
            if base_grid.regular and grid.dz_sigma is None:
                precond = DistributedFFTPoissonSolver(base_grid, dist)
            lmodel.pressure_solver = DistributedImmersedPoissonSolver(
                lgrid, lmodel.dist_halo, topo, preconditioner=precond)
        elif self.global_solve:
            lmodel.pressure_solver = (
                DistributedFFTPoissonSolver(grid, dist) if grid.z_regular
                else DistributedFourierTridiagonalSolver(grid, dist))

    def _refuse_as_jax(self, gmodel):
        """The JAX ``DistributedStep``'s refusals, in its words."""
        if getattr(gmodel, "particles", None) is not None or \
                getattr(gmodel, "background_fields", None):
            raise ValueError("particles/background fields are not "
                             "supported on the explicit-halo path")
        if any(f is not None for f in gmodel.forcings.values()) \
                and not self.stacked:
            raise ValueError(
                "forcings need per-shard coordinates: supported on "
                "stacked (lat-lon / immersed) grids, whose local grids "
                "carry true coordinates; use the GSPMD path "
                "(sharded_step_fn) on plain rectilinear grids")
        if not self.stacked:
            # function-valued boundary conditions evaluate against the
            # LOCAL grid's coordinates, which are shard-0's on every
            # shard for plain rectilinear local grids — reject rather
            # than silently apply the wrong boundary pattern
            for name, fbcs in getattr(gmodel, "bcs", {}).items():
                for side in ("west", "east", "south", "north",
                             "bottom", "top"):
                    bc = getattr(fbcs, side, None)
                    if bc is not None and callable(
                            getattr(bc, "condition", None)):
                        raise ValueError(
                            f"boundary condition {name}.{side} is a "
                            "function of position: on the explicit-halo "
                            "path this needs per-shard coordinates — "
                            "use a stacked (lat-lon/immersed) grid, a "
                            "constant/array value, or the GSPMD path")

    def _sharded_particles(self, particles):
        """``particles`` as the local model steps them: replicated, each
        rank interpolating the ones in its block (the half-open interval
        between the global faces at its block's edges, open to ±∞ at the
        domain's), their values summed over the ranks."""
        from oceananigans_torch.particles import ShardedParticles
        g, dist = self.global_grid, self.dist
        owned, clamps = [], []
        for axis in (0, 1):
            c, n = dist.coords[axis], dist.size(axis)
            faces = getattr(g, f"{AXIS_NAMES[axis]}F").reshape(-1)
            H = g.H[axis]
            lo = -math.inf if c == 0 else float(
                faces[H + self.offsets[axis][c]])
            hi = math.inf if c == n - 1 else float(
                faces[H + self.offsets[axis][c + 1]])
            owned.append((lo, hi))
            # a halo-free global axis interpolates within its interior
            # nodes, which a padded block must keep to
            clamp = None
            if self.pads[axis]:
                clamp = {}
                for loc in ("c", "f"):
                    full = (LOC_C if loc == "c" else
                            tuple("f" if a == axis else "c"
                                  for a in range(3)))
                    q = location_coords(g, full)[axis].reshape(-1)
                    clamp[loc] = (float(q[0]), float(q[-1]))
            clamps.append(clamp)
        return ShardedParticles(
            particles, g, tuple(owned),
            lambda t: dist.all_reduce(t), tuple(clamps))

    # ---- layout conversions ------------------------------------------------
    def _coords_of(self, rank):
        return divmod(rank, self.py)

    def _block_shape(self, rank, rest):
        rx, ry = self._coords_of(rank)
        return (self.sizes[0][rx] + 2 * self.halo[0],
                self.sizes[1][ry] + 2 * self.halo[1]) + tuple(rest)

    def window(self, a, rank=None):
        """Rank ``rank``'s (default this rank's) window of the global array
        ``a`` (a tensor or a numpy array whose first two axes are x and y;
        a copy): of a halo-extended extent, the block with its halo rings
        (a halo-free split axis wrapped periodically to the local halo
        first); of an interior extent, the block's interior; of extent 1,
        whole. Any other extent on a split axis raises ``ValueError``."""
        g = self.global_grid
        coords = self.dist.coords if rank is None else self._coords_of(rank)
        for axis in (0, 1):
            if a.ndim <= axis or self.dist.size(axis) == 1:
                continue
            n, N, full = a.shape[axis], g.N[axis], g.shape[axis]
            off = self.offsets[axis][coords[axis]]
            nl = self.sizes[axis][coords[axis]]
            if n == full:
                if self.pads[axis]:
                    a = _wrap_pad(a, axis, self.pads[axis])
                a = _cut(a, axis, off, nl + 2 * self.halo[axis])
            elif n == N:
                a = _cut(a, axis, off, nl)
            elif n != 1:
                raise ValueError(
                    f"an array of extent {n} along axis {axis}, which is "
                    f"split over {self.dist.size(axis)} ranks: neither the "
                    f"interior ({N}) nor the halo-extended extent ({full})")
        return a.copy() if isinstance(a, np.ndarray) else a.clone()

    def _is_global(self, t):
        g = self.global_grid
        return (isinstance(t, torch.Tensor) and t.ndim == 3
                and tuple(t.shape[:2]) == tuple(g.shape[:2]))

    def _is_local(self, t):
        lg = self.local_grid
        return (isinstance(t, torch.Tensor) and t.ndim == 3
                and tuple(t.shape[:2]) == tuple(lg.shape[:2]))

    def to_local_state(self, state):
        """This rank's local-halos state from the global-layout ``state``
        held on rank 0 (the other ranks may pass None): the 3-D fields are
        scattered as the ranks' windows of the halo-extended arrays, the
        rest (the clock, particles) is broadcast.
        Rank 0 broadcasts the state's structure with each field's place
        taken by its z extent and dtype, and every rank then walks it in
        the same order, so the scatters pair up."""
        dist = self.dist
        lg = self.local_grid
        skeleton = None
        if dist.rank == 0:
            skeleton = _map_tensors(
                state, lambda t: (("block", t.shape[2], t.dtype)
                                  if self._is_global(t)
                                  else ("whole", t.detach().cpu(),
                                        t.device.type == "cpu")))
        skeleton = dist.broadcast_object(skeleton)
        if dist.rank == 0:
            def place(t):
                if not self._is_global(t):
                    return t.detach().clone()
                blocks = [self.window(t, rank=r)
                          for r in range(dist.world_size)]
                return dist.scatter_blocks(blocks, blocks[0]).to(
                    dist.device)
            return _map_tensors(state, place)

        def walk(obj):
            if isinstance(obj, tuple) and obj and obj[0] == "block":
                _, nz, dtype = obj
                like = torch.empty((lg.shape[0], lg.shape[1], nz),
                                   dtype=dtype, device=dist.device)
                return dist.scatter_blocks(None, like)
            if isinstance(obj, tuple) and obj and obj[0] == "whole":
                # host tensors (the clock) stay on the host
                return obj[1] if obj[2] else obj[1].to(dist.device)
            if isinstance(obj, dict):
                return {k: walk(v) for k, v in obj.items()}
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return dataclasses.replace(obj, **{
                    f.name: walk(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)
                    if f.init and getattr(obj, f.name) is not None})
            return obj

        return walk(skeleton)

    def from_local_state(self, state, root=0):
        """The global-layout state on rank ``root``, gathered from every
        rank's local state: the blocks' interiors, and the domain's halo
        rings from the edge blocks' (so that :meth:`to_local_state` of it
        gives every rank its block back as it was); None on the other
        ranks."""
        dist, g = self.dist, self.global_grid

        def gather(t):
            if not self._is_local(t):
                return t
            shapes = [self._block_shape(r, t.shape[2:])
                      for r in range(dist.world_size)]
            blocks = dist.gather_blocks(t, root=root, shapes=shapes)
            if blocks is None:
                return t
            out = torch.zeros((g.shape[0], g.shape[1], t.shape[2]),
                              dtype=t.dtype, device=t.device)
            for r, b in enumerate(blocks):
                dst, src = [], []
                for axis, c in enumerate(self._coords_of(r)):
                    n, off = self.sizes[axis][c], self.offsets[axis][c]
                    h = self.halo[axis]
                    if self.pads[axis]:
                        # the global axis has no halo: the interior only
                        src.append(slice(h, h + n))
                        dst.append(slice(off, off + n))
                        continue
                    lo = 0 if c == 0 else h
                    hi = n + 2 * h if c == dist.size(axis) - 1 else h + n
                    src.append(slice(lo, hi))
                    dst.append(slice(off + lo, off + hi))
                out[tuple(dst)] = b[tuple(src)]
            return out

        out = _map_tensors(state, gather)
        return out if dist.rank == root else None

    # ---- the distributed step ----------------------------------------------
    def step(self, state, dt):
        """One step of every rank's block; every rank calls it
        together."""
        return self.lmodel.step(state, dt)


class DistributedModel:
    """Makes a :class:`DistributedStep` drivable by
    :class:`~oceananigans_torch.simulation.Simulation`, on every rank::

        dstep = DistributedStep(make_model, grid, dist)
        dmodel = DistributedModel(dstep)
        sim = Simulation(dmodel, state=dmodel.initial_state(u=...),
                         dt=60.0, stop_time=3600.0)
        sim.output_writers["f"] = HDF5Writer(...)  # writes GLOBAL fields
        sim.run()

    The simulation state is the rank's local-halos state. Output writers
    and windowed averages get a GLOBAL view with halos filled through
    :meth:`writer_sim`, gathered to rank 0, which alone writes them; the
    sharded checkpointer (``OrbaxCheckpointer``) saves every rank's own
    block. The time-step wizard's time scales are the all-reduced minima
    of the ranks'. Callbacks get the raw ``sim`` (local state, local grid);
    ``sim.model.global_state(sim.state)`` gathers the global one.
    """

    def __init__(self, dstep: DistributedStep):
        self.dstep = dstep
        self.dist = dstep.dist
        #: the local grid: Simulation's defaults see the local spacings
        self.grid = dstep.local_grid
        #: the model on the GLOBAL grid (for writers and diagnostics)
        self.global_model = dstep.gmodel

    @property
    def tracer_names(self):
        return self.dstep.lmodel.tracer_names

    def initial_state(self, **field_values):
        """The global model's initial state on rank 0, scattered."""
        gs = (self.dstep.gmodel.initial_state(**field_values)
              if self.dist.rank == 0 else None)
        return self.dstep.to_local_state(gs)

    def step(self, state, dt):
        return self.dstep.step(state, dt)

    def fill_state_halos(self, state):
        # every step fills its halos itself
        return state

    def global_state(self, state):
        """The global layout on rank 0 with halos filled by the global
        model's boundary conditions; None on the other ranks."""
        gs = self.dstep.from_local_state(state)
        if gs is None:
            return None
        return self.dstep.gmodel.fill_state_halos(gs)

    def _reduced_min(self, value):
        t = torch.as_tensor(value, dtype=torch.float64).reshape(1)
        return self.dist.all_reduce(
            t.to(self.dist.device) if self.dist.backend == "nccl" else t,
            op=torch.distributed.ReduceOp.MIN).reshape(()).cpu()

    def cfl_timescale(self, state):
        return self._reduced_min(self.dstep.lmodel.cfl_timescale(state))

    def diffusion_timescale(self, state):
        return self._reduced_min(
            self.dstep.lmodel.diffusion_timescale(state))

    def writer_sim(self, sim):
        """A view with the GLOBAL, halo-filled state and the global model
        for the output writers, on rank 0; None on the other ranks, which
        write nothing. Every rank calls it together (it gathers)."""
        gs = self.global_state(sim.state)
        if gs is None:
            return None

        class _View:
            pass

        v = _View()
        v.model = self.dstep.gmodel
        v.state = gs
        v.dt = sim.dt
        v.output_writers = sim.output_writers
        v.callbacks = sim.callbacks
        return v


class DistributedImmersedPoissonSolver(torch.nn.Module):
    """The masked-Poisson CG of :class:`~oceananigans_torch.immersed.
    ImmersedPoissonSolver` on each rank's block: operator applications fill
    their halos through the exchange, inner products and nullspace
    projections are all-reduced, and the preconditioner is the pencil FFT
    solver (``preconditioner``, its ``local_solve``) or rank-local Jacobi.
    ``grid`` is the rank's local immersed grid."""

    def __init__(self, grid, ctx, global_topo, maxiter=None, reltol=None,
                 preconditioner=None):
        from oceananigans_torch.immersed import _MaskedSystem
        super().__init__()
        self.grid = grid
        self.ctx = ctx
        self.topo = global_topo
        if reltol is None:
            reltol = 1e-8 if grid.dtype.itemsize >= 8 else 2e-5
        self.reltol = reltol
        #: a DistributedFFTPoissonSolver on the (regular) underlying
        #: grid, or None for rank-local Jacobi
        self.preconditioner = preconditioner
        if maxiter is None:
            maxiter = 200 if preconditioner is not None else 600
        self.maxiter = maxiter
        self.system = _MaskedSystem(grid, preconditioner is None)
        self._bcs = regularize_field_boundary_conditions(
            None, grid.underlying_grid, LOC_C)
        self.iterations = None
        self.host_syncs = 0

    def solve(self, rhs_interior):
        from oceananigans_torch.immersed import masked_cg_solve
        g = self.grid.underlying_grid
        ctx, topo = self.ctx, self.topo
        info = {}
        out = masked_cg_solve(
            self.grid, rhs_interior,
            fill_halos=lambda p: dist_fill_halos(p, g, self._bcs, LOC_C,
                                                 None, None, ctx, topo),
            precond_apply=(None if self.preconditioner is None
                           else self.preconditioner.local_solve),
            maxiter=self.maxiter, reltol=self.reltol, system=self.system,
            info=info,
            reduce_sum=lambda v: ctx.dist.all_reduce(torch.sum(v)))
        self.iterations = info["iterations"]
        self.host_syncs = info["host_syncs"]
        return out
