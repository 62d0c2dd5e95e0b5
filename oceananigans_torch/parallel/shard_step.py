"""The distributed model step with explicit halo exchange.

Counterpart of ``oceananigans_tpu/parallel/shard_step.py``. The JAX package
runs the step inside ``shard_map`` on a local-halos layout; here each rank
is a process that holds its own block, in the same layout: an ``(nxl, nyl,
Nz)`` grid with its own halo rings, so a rank's LOCAL model is an ordinary
single-device model and every operator and kernel of the port runs on it
unchanged. Communication happens only in the halo fills
(:func:`dist_fill_halos`, two paired transfers for each distributed axis
and field), in the pencil transposes of the pressure solve and in the
all-reduced inner products of the CG solvers.

Scope, as in the JAX package: ``NonhydrostaticModel`` (regular or
stretched-z ``RectilinearGrid``, an ``ImmersedBoundaryGrid`` over one, x/y
Periodic or Bounded, quasi-AB2 or RK3) and ``HydrostaticFreeSurfaceModel``
(explicit, split-explicit or implicit free surface, the last as a
rank-local CG with all-reduced inner products; ``RectilinearGrid``,
``LatitudeLongitudeGrid`` and immersed grids, whose local grids are the
rank's windows of the global coordinates, metrics and masks; z-star;
constant-coefficient and the ocean closures). The local model decides its
kernels when it is built, on its own block: the tendency kernels engage
where their gates hold, and no fused AB2 kernel runs (``dist_halo`` is set,
as the JAX step refuses them). Particles, background fields and
position-dependent forcings or boundary functions on plain rectilinear
grids are refused, as in the JAX package, whose GSPMD path takes them
(ROADMAP Queue 1 item 19).

An axis split over several ranks must carry a halo: a halo-free periodic
axis wraps by rolling the array, which on a block would wrap each rank onto
itself (the JAX package's exchange skips such an axis, ``h == 0``, and
its step then differs from the serial one); such a partition raises here.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from oceananigans_torch.boundary_conditions import (
    FLUX, _bc_value, _fill_axis, fill_halo_regions,
    regularize_field_boundary_conditions,
)
from oceananigans_torch.fields import LOC_C
from oceananigans_torch.grids.base import Bounded, Flat, Periodic
from oceananigans_torch.parallel.distributed import (
    Distributed, _map_tensors,
)
from oceananigans_torch.parallel.halo_exchange import _exchange_axis

__all__ = ["DistributedStep", "dist_fill_halos", "dist_fill_xy", "DistHalo",
           "DistributedModel", "DistributedImmersedPoissonSolver"]


class GSPMDOnly(ValueError):
    """A configuration the explicit-halo step refuses and the JAX
    package's GSPMD path takes (ROADMAP Queue 1 item 19)."""


@dataclasses.dataclass(frozen=True)
class DistHalo:
    """The mesh decomposition a LOCAL model carries, so that its halo
    fills go through the exchange: the rank's :class:`Distributed`."""

    dist: Distributed

    def size(self, axis):
        return self.dist.partition[axis]

    def index(self, axis):
        """This rank's coordinate along mesh ``axis`` (``axis_index``)."""
        return self.dist.coords[axis]


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


def dist_fill_xy(a, grid, bcs, loc, time, dt, ctx, global_topo,
                 use_values=True):
    """The distributed x/y halo fill of a LOCAL block, in place: the
    neighbour exchange along each distributed axis (the ring wraps where
    the domain is periodic), and the physical boundary fill only on the
    ranks that own a domain edge, on that edge's side. ``use_values=False``
    skips the conditions' values (the η and transport fills take none, as
    their serial counterparts). Unlike the JAX package, whose edge shard
    keeps only the halo strips of its physical fill, the edge rank's fill
    also imposes the left wall-face value, as the serial fill does."""
    for axis in (0, 1):
        n_shards = ctx.size(axis)
        topo = global_topo[axis]
        if topo == Flat:
            continue
        lbc, rbc = bcs.sides(axis)
        if n_shards == 1:
            lval, rval = _values(lbc, rbc, grid, axis, loc, time,
                                 use_values)
            _fill_axis(a, grid, axis, loc[axis], lbc, rbc, lval, rval,
                       dt=dt)
            continue
        periodic = topo == Periodic
        _exchange_axis(a, ctx.dist, axis, grid.H[axis], periodic)
        if periodic:
            continue
        i = ctx.index(axis)
        first, last = i == 0, i == n_shards - 1
        if first or last:
            lval, rval = _values(lbc, rbc, grid, axis, loc, time,
                                 use_values)
            _fill_axis(a, grid, axis, loc[axis], lbc if first else None,
                       rbc if last else None, lval, rval, dt=dt)
    return a


def dist_fill_halos(a, grid, bcs, loc, time, dt, ctx, global_topo):
    """Fill every halo ring of a LOCAL block in place: x/y through
    :func:`dist_fill_xy`, z with the ordinary local fill (z is never
    distributed)."""
    dist_fill_xy(a, grid, bcs, loc, time, dt, ctx, global_topo)
    return fill_halo_regions(a, grid, bcs, loc, time, dt=dt, axes=(2,))


def _local_sizes(grid, dist):
    px, py = dist.partition
    Nx, Ny, Nz = grid.N
    if Nx % px or Ny % py:
        raise ValueError(f"grid interior {grid.N[:2]} must divide the "
                         f"mesh ({px}, {py})")
    return px, py, Nx // px, Ny // py


def _window_grid(grid, device, x0, y0, nxl, nyl):
    """A copy of ``grid`` whose coordinate, metric and mask tensors are the
    halo-extended windows starting at ``(x0, y0)`` of the global ones (the
    JAX package's stacked grid leaves), with the local sizes ``(nxl,
    nyl)``, on ``device``: the local model sees the TRUE metrics of its own
    block (a latitude band's, a bathymetry's masks, a cube block's)."""
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


class DistributedStep:
    """The explicit-halo distributed step of a nonhydrostatic or
    hydrostatic model configuration::

        dstep = DistributedStep(make_model, grid, dist)
        state = dstep.to_local_state(global_state)   # once
        state = dstep.step(state, dt)
        final = dstep.from_local_state(state)        # on rank 0

    ``make_model(grid)`` is called twice on every rank: on the global grid
    (the validation, the conversions and the writers' view) and on this
    rank's local grid (the model the rank runs). ``dist`` is the rank's
    :class:`~oceananigans_torch.parallel.distributed.Distributed`; the
    local grid lives on ``dist.device``.
    """

    def __init__(self, make_model, grid, dist: Distributed):
        from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
        from oceananigans_torch.grids.rectilinear import RectilinearGrid
        from oceananigans_torch.immersed import ImmersedBoundaryGrid
        from oceananigans_torch.models import (
            HydrostaticFreeSurfaceModel, NonhydrostaticModel,
        )
        from oceananigans_torch.parallel.distributed_fft import (
            DistributedFFTPoissonSolver, DistributedFourierTridiagonalSolver,
        )

        self.dist = dist
        self.global_grid = grid
        gmodel = make_model(grid)
        if not isinstance(gmodel, (NonhydrostaticModel,
                                   HydrostaticFreeSurfaceModel)):
            raise ValueError("DistributedStep supports Nonhydrostatic and "
                             "HydrostaticFreeSurface models")
        self.hydrostatic = isinstance(gmodel, HydrostaticFreeSurfaceModel)
        # Hydrostatic notes: implicit free surfaces run via CG on this
        # path regardless of solver_method (the spectral/matrix variants
        # need global transforms) — shard-local operator applications
        # with exchanged halos + psum-reduced inner products. Bounded
        # distributed axes are fine: the wall-transport zeroing and η
        # boundary fills are shard-index-guarded.
        immersed = isinstance(grid, ImmersedBoundaryGrid)
        base_grid = grid.underlying_grid if immersed else grid
        self.latlon = isinstance(base_grid, LatitudeLongitudeGrid)
        self.stacked = self.latlon or immersed
        if self.latlon and not self.hydrostatic:
            raise GSPMDOnly("lat-lon on the explicit-halo path is "
                             "supported for the hydrostatic model (the "
                             "nonhydrostatic pressure solve needs a "
                             "global transform; use the GSPMD path)")
        if not self.latlon:
            if not (base_grid.x_regular and base_grid.y_regular):
                raise ValueError("DistributedStep needs regular x/y "
                                 "spacings (z may be stretched)")
            if not base_grid.regular and grid.axis_topo(2) != Bounded \
                    and not self.hydrostatic:
                raise ValueError(
                    "stretched z must be Bounded (the distributed "
                    "Fourier-tridiagonal solver's assumption)")
        if getattr(gmodel, "particles", None) is not None or \
                getattr(gmodel, "background_fields", None):
            raise GSPMDOnly("particles/background fields are not "
                             "supported on the explicit-halo path")
        if any(f is not None for f in gmodel.forcings.values()) \
                and not self.stacked:
            raise GSPMDOnly(
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
                        raise GSPMDOnly(
                            f"boundary condition {name}.{side} is a "
                            "function of position: on the explicit-halo "
                            "path this needs per-shard coordinates — "
                            "use a stacked (lat-lon/immersed) grid, a "
                            "constant/array value, or the GSPMD path")
        self.gmodel = gmodel

        px, py, nxl, nyl = _local_sizes(grid, dist)
        self.px, self.py, self.nxl, self.nyl = px, py, nxl, nyl
        topo = tuple(grid.axis_topo(ax) for ax in range(3))
        self.topo = topo
        for axis in (0, 1):
            if dist.size(axis) > 1 and grid.H[axis] == 0:
                raise ValueError(
                    f"axis {axis} is split over {dist.size(axis)} ranks but "
                    "has no halo: a halo-free periodic axis wraps each "
                    "rank's block onto itself; build the grid with a halo "
                    "on every distributed axis or partition another axis")
        if self.stacked:
            rx, ry = dist.coords
            lgrid = _window_grid(grid, dist.device, rx * nxl, ry * nyl, nxl,
                                 nyl)
        else:
            zF = grid.zF.reshape(-1).detach().cpu().double()
            if grid.z_regular:
                z0 = float(zF[grid.H[2]])
                zspec = (z0, z0 + grid.Lz)
            else:
                # z is never distributed: every rank carries the full
                # (stretched) column
                zspec = zF[grid.H[2]:grid.H[2] + grid.N[2] + 1].numpy()
            lgrid = RectilinearGrid(
                size=(nxl, nyl, grid.N[2]),
                x=(0.0, grid.Lx / px), y=(0.0, grid.Ly / py), z=zspec,
                topology=topo, halo=tuple(grid.H), dtype=grid.dtype,
                device=dist.device)
        self.local_grid = lgrid
        lmodel = make_model(lgrid)
        # route the local model's halo fills through the exchange
        lmodel.set_dist_halo(DistHalo(dist), topo)
        self.lmodel = lmodel
        # the local model's own step is the whole step: its fills go
        # through the exchange, and its projection through a
        # distribution-aware solver (the hydrostatic free surfaces are
        # rank-local apart from their exchanges and all-reduced CG dots)
        if immersed and not self.hydrostatic:
            # masked CG on each rank's block, FFT-preconditioned when the
            # underlying grid admits the pencil solver
            precond = None
            if base_grid.regular and grid.dz_sigma is None:
                try:
                    precond = DistributedFFTPoissonSolver(base_grid, dist)
                except ValueError:
                    precond = None   # pencil divisibility not met
            lmodel.pressure_solver = DistributedImmersedPoissonSolver(
                lgrid, lmodel.dist_halo, topo, preconditioner=precond)
        elif not self.hydrostatic:
            lmodel.pressure_solver = (
                DistributedFFTPoissonSolver(grid, dist) if grid.z_regular
                else DistributedFourierTridiagonalSolver(grid, dist))

    # ---- layout conversions ------------------------------------------------
    def _is_global(self, t):
        g = self.global_grid
        return (isinstance(t, torch.Tensor) and t.ndim == 3
                and tuple(t.shape[:2]) == tuple(g.shape[:2]))

    def _is_local(self, t):
        lg = self.local_grid
        return (isinstance(t, torch.Tensor) and t.ndim == 3
                and tuple(t.shape[:2]) == tuple(lg.shape[:2]))

    def _blocks(self, a):
        """The ranks' windows of the global halo-extended ``a`` (each
        block's interior with the halo rings around it: the neighbours'
        edge cells, or the domain's halos at its edges; z whole), in rank
        order."""
        Hx, Hy = self.global_grid.H[:2]
        nxl, nyl = self.nxl, self.nyl
        return [a[rx * nxl:rx * nxl + nxl + 2 * Hx,
                  ry * nyl:ry * nyl + nyl + 2 * Hy].clone()
                for rx in range(self.px) for ry in range(self.py)]

    def _spans(self, b, n, H, nl):
        """The part of block ``b`` of ``n`` along an axis that the global
        layout takes from it: its interior, and the domain's halo ring
        where it is an edge block."""
        lo = 0 if b == 0 else H
        hi = nl + 2 * H if b == n - 1 else H + nl
        return lo, hi

    def to_local_state(self, state):
        """This rank's local-halos state from the global-layout ``state``
        held on rank 0 (the other ranks may pass None): the 3-D fields are
        scattered as the ranks' windows of the halo-extended arrays, the
        rest is broadcast.
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
                                  else ("whole", t.detach().cpu())))
        skeleton = dist.broadcast_object(skeleton)
        if dist.rank == 0:
            def place(t):
                if not self._is_global(t):
                    return t.detach().clone()
                blocks = self._blocks(t)
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
                return obj[1]
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
        Hx, Hy = g.H[0], g.H[1]
        nxl, nyl = self.nxl, self.nyl

        def gather(t):
            if not self._is_local(t):
                return t
            blocks = dist.gather_blocks(t, root=root)
            if blocks is None:
                return t
            out = torch.zeros((g.shape[0], g.shape[1], t.shape[2]),
                              dtype=t.dtype, device=t.device)
            for r, b in enumerate(blocks):
                rx, ry = divmod(r, self.py)
                x0, x1 = self._spans(rx, self.px, Hx, nxl)
                y0, y1 = self._spans(ry, self.py, Hy, nyl)
                out[rx * nxl + x0:rx * nxl + x1,
                    ry * nyl + y0:ry * nyl + y1] = b[x0:x1, y0:y1]
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
