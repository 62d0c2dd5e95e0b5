"""The distributed cubed sphere with explicit halo exchange.

Counterpart of ``oceananigans_tpu/parallel/cubed_sphere_shard.py``. The
stacked ``(6, nx, ny, nz)`` state is laid out over ``panels · R²`` ranks:
each rank holds ``6 / panels`` panels' ``(bx, by)`` block of an ``R × R``
block grid, each block with its OWN halo rings, ``(P_loc, nloc + 2H, nloc +
2H, nz)``. Every transfer between blocks (the within-panel block halos, the
rotated inter-panel velocity and centre strips, and the synchronisation of
the fluxes through shared edge faces) is precomputed into per-rank-pair
index tables and runs as one paired ``batch_isend_irecv`` over the ranks
(where the JAX package runs ``ppermute`` rounds), moving edge strips, not
panels.

The pair tables derive from the port's own serial cube maps
(``_exchange_maps``, ``_velocity_maps_flat``, ``_edge_face_maps_flat``,
the corner-circulation tables), as the JAX package's derive from its own,
so each rank's block window evolves as the same window of the serial panel
frame. The rank's model is the serial model itself, windowed: a shallow
copy whose per-panel and stacked arrays (metrics, masks, Coriolis,
bathymetry, corner bands) are its block's windows and whose grid is a
:class:`_BlockCube`, which carries the block exchanges into the four cube
operations the serial step calls (``cubed_sphere_halo_exchange``,
``cubed_sphere_velocity_exchange``, ``cubed_sphere_sync_edge_fluxes``,
``cubed_sphere_corner_vorticity``) and an all-reduced sum into the
implicit free surface's inner product. Every physics option of the serial
models therefore runs here as it does there. No kernel of the port lies on
a cube path.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from oceananigans_torch.grids.cubed_sphere_grid import (
    _edge_face_maps_flat, _exchange_maps, _velocity_maps_flat,
)
from oceananigans_torch.parallel.distributed import (
    TAG_FORWARD, Distributed, _map_tensors,
)
from oceananigans_torch.parallel.shard_step import _window_grid

__all__ = ["CubedSphereDistributedSW", "CubedSphereDistributedHydrostatic"]


# ---------------------------------------------------------------------------
# Block layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    N: int          # panel interior size
    H: int          # halo width
    R: int          # blocks per panel dimension
    panels: int     # ways the panel axis is split (divides 6)
    nloc: int       # block interior size (N // R)
    nl2: int        # block frame size (nloc + 2H)
    P_loc: int      # panels per rank (6 // panels)
    n_dev: int

    def dev(self, p, bx, by):
        pg = p // self.P_loc
        return (pg * self.R + bx) * self.R + by

    def coords(self, dev):
        """(panel group, bx, by) of rank ``dev``."""
        return dev // (self.R * self.R), (dev // self.R) % self.R, \
            dev % self.R

    def cell(self, p, li, lj):
        """Flat cell index within one field's per-rank block stack."""
        pl = p % self.P_loc
        return (pl * self.nl2 + li) * self.nl2 + lj

    @property
    def cells(self):
        """Cells per field per rank."""
        return self.P_loc * self.nl2 * self.nl2

    def locate(self, p, gi, gj, face_x=False, face_y=False):
        """(rank, flat cell) owning panel-frame cell (gi, gj).
        ``face_x``/``face_y``: the coordinate is face-located along that
        axis, so the shared panel-edge slot at H + N clips to the last
        block (within-panel shared faces resolve to the right/up block;
        either side holds the identical value)."""
        H, nloc, R = self.H, self.nloc, self.R
        bx = (gi - H) // nloc
        if face_x:
            bx = min(bx, R - 1)
        by = (gj - H) // nloc
        if face_y:
            by = min(by, R - 1)
        li = gi - bx * nloc
        lj = gj - by * nloc
        return self.dev(p, bx, by), self.cell(p, li, lj)


# ---------------------------------------------------------------------------
# Pair exchanges
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Exchange:
    """One rank's part of an exchange: the rank-local copies and, for each
    peer, what it sends there and where what it receives goes. Indices are
    flat rows of the fields' concatenated ``(cells·n_fields, nz)`` view."""
    local: tuple            # (src, sgn, dst) or None
    sends: dict             # peer -> (src, sgn)
    recvs: dict             # peer -> dst


def _build_exchange(entries, lay: _Layout, rank, device, dtype):
    """``entries``: (dst_rank, dst_flat, src_rank, src_flat, sign) with the
    field offsets folded into the flat indices; this rank's tables."""
    def long(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def real(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=dtype, device=device)[:, None]

    pairs = {}
    for dd, df, sd, sf, sg in entries:
        if dd == rank or sd == rank:
            pairs.setdefault((sd, dd), []).append((df, sf, sg))
    local = None
    sends, recvs = {}, {}
    for (s, d), ent in sorted(pairs.items()):
        df, sf, sg = (list(x) for x in zip(*ent))
        if s == d:
            local = (long(sf), real(sg), long(df))
        elif s == rank:
            sends[d] = (long(sf), real(sg))
        else:
            recvs[s] = long(df)
    return _Exchange(local, sends, recvs)


def _apply_exchange(ex: _Exchange, arrays, dist: Distributed, mean=False,
                    key="cs"):
    """The exchange on a list of same-shaped ``(P_loc, nl2, nl2, nz)``
    arrays. ``mean``: received values are averaged with the destination's
    values before the exchange (the edge-face flux synchronisation)
    instead of overwriting them."""
    nz = arrays[0].shape[-1]
    flat = torch.cat([a.reshape(-1, nz) for a in arrays], dim=0)
    out = flat.clone()

    def put(dst, val):
        out[dst] = 0.5 * (flat[dst] + val) if mean else val

    if ex.local is not None:
        src, sgn, dst = ex.local
        put(dst, flat[src] * sgn.to(flat.dtype))
    peers = sorted(ex.recvs)
    sends = [(peer, flat[src] * sgn.to(flat.dtype), TAG_FORWARD)
             for peer, (src, sgn) in sorted(ex.sends.items())]
    recvs = [(peer, flat.new_empty((len(ex.recvs[peer]), nz)), TAG_FORWARD)
             for peer in peers]
    got = dist.p2p(sends, recvs, key=f"{key}{nz}")
    for peer, buf in zip(peers, got):
        put(ex.recvs[peer], buf)
    c = arrays[0].numel() // nz
    return [out[i * c:(i + 1) * c].reshape(arrays[0].shape)
            for i in range(len(arrays))]


# ---------------------------------------------------------------------------
# Entries from the serial global tables
# ---------------------------------------------------------------------------

def _state_fill_entries(grid, lay: _Layout, n_center, with_velocity=True):
    """Entries of the state fill over fields [u, v, c0, c1, ...] (the
    velocity rotation tables, the centre tables and the within-panel
    copies); ``with_velocity=False``: centre fields only, from offset 0."""
    N, H, nloc, nl2 = lay.N, lay.H, lay.nloc, lay.nl2
    C = lay.cells
    coff = 2 * C if with_velocity else 0

    dp, di, dj, sp, si, sj = _exchange_maps(grid, H)
    cdict = {(int(dp[k]), int(di[k]), int(dj[k])):
             (int(sp[k]), int(si[k]), int(sj[k])) for k in range(dp.size)}
    vdict = {}
    if with_velocity:
        for comp, (DP, DI, DJ, SQ, SI, SJ, SGN, ISU) in \
                _velocity_maps_flat(N, H).items():
            for k in range(DP.size):
                vdict[(comp, int(DP[k]), int(DI[k]), int(DJ[k]))] = (
                    int(SQ[k]), int(SI[k]), int(SJ[k]), float(SGN[k]),
                    bool(ISU[k]))

    entries = []
    for p in range(6):
        for bx in range(lay.R):
            for by in range(lay.R):
                ddev = lay.dev(p, bx, by)
                for li in range(nl2):
                    gi = bx * nloc + li
                    for lj in range(nl2):
                        gj = by * nloc + lj
                        dflat = lay.cell(p, li, lj)
                        # u (field 0) and v (field 1): each field's owned
                        # region includes its shared block face
                        for f, comp in (((0, "u"), (1, "v"))
                                        if with_velocity else ()):
                            iu = comp == "u"
                            if (H <= li < H + nloc + iu
                                    and H <= lj < H + nloc + (not iu)):
                                continue        # owned locally
                            hit = vdict.get((comp, p, gi, gj))
                            if hit is not None:
                                q, sgi, sgj, sg, isu = hit
                                sdev, sflat = lay.locate(
                                    q, sgi, sgj, face_x=isu,
                                    face_y=not isu)
                                entries.append(
                                    (ddev, f * C + dflat, sdev,
                                     (0 if isu else 1) * C + sflat, sg))
                            elif (H <= gi < H + N + iu
                                    and H <= gj < H + N + (not iu)):
                                sdev, sflat = lay.locate(
                                    p, gi, gj, face_x=iu, face_y=not iu)
                                entries.append(
                                    (ddev, f * C + dflat, sdev,
                                     f * C + sflat, 1.0))
                            # else: a panel-corner wedge, stale in the
                            # serial frame too (never read)
                        if H <= li < H + nloc and H <= lj < H + nloc:
                            continue
                        hit = cdict.get((p, gi, gj))
                        if hit is not None:
                            q, sgi, sgj = hit
                            sdev, sflat = lay.locate(q, sgi, sgj)
                        elif H <= gi < H + N and H <= gj < H + N:
                            sdev, sflat = lay.locate(p, gi, gj)
                        else:
                            continue    # a panel corner: the averaging
                        for f in range(n_center):
                            off = coff + f * C
                            entries.append((ddev, off + dflat, sdev,
                                            off + sflat, 1.0))
    return entries


def _copies(lay: _Layout, p, gi, gj):
    """Every (rank, flat cell) whose block frame holds panel-frame cell
    (gi, gj) of panel ``p``: its owner, and the blocks that hold it in a
    halo ring."""
    out = []
    for bx in range(lay.R):
        li = gi - bx * lay.nloc
        if not 0 <= li < lay.nl2:
            continue
        for by in range(lay.R):
            lj = gj - by * lay.nloc
            if 0 <= lj < lay.nl2:
                out.append((lay.dev(p, bx, by), lay.cell(p, li, lj)))
    return out


def _flux_sync_entries(lay: _Layout, n_pairs):
    """Entries of the edge-face flux synchronisation over flux pairs
    [Fx0, Fy0, Fx1, Fy1, ...] (mean mode: both sides take the
    rotation-consistent mean). Every copy of an edge face takes the mean,
    the halo copies that neighbouring blocks of its panel hold too (the
    JAX package syncs only the owner's): continuity integrates the synced
    fluxes into w in the halo rings as well, as the serial frame does."""
    PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = _edge_face_maps_flat(lay.N, lay.H)
    C = lay.cells
    entries = []
    for k in range(PP.size):
        oc = int(OC[k])
        nc = int(NC[k])
        sdev, sflat = lay.locate(int(QQ[k]), int(NI[k]), int(NJ[k]),
                                 face_x=nc == 0, face_y=nc == 1)
        for ddev, dflat in _copies(lay, int(PP[k]), int(OI[k]),
                                   int(OJ[k])):
            for f in range(n_pairs):
                entries.append((ddev, (2 * f + oc) * C + dflat,
                                sdev, (2 * f + nc) * C + sflat,
                                float(SG[k])))
    return entries


# ---------------------------------------------------------------------------
# The rank's cube: exchanges into the serial model's cube operations
# ---------------------------------------------------------------------------

class _BlockExchanges:
    """The block versions of the serial cube operations, for one rank."""

    def __init__(self, grid, lay: _Layout, dist: Distributed, device, dtype):
        self.lay = lay
        self.dist = dist
        rank = dist.rank
        self.ex_vel = _build_exchange(_state_fill_entries(grid, lay, 0),
                                      lay, rank, device, dtype)
        self.ex_center = _build_exchange(
            _state_fill_entries(grid, lay, 1, with_velocity=False), lay,
            rank, device, dtype)
        self.ex_flux = _build_exchange(_flux_sync_entries(lay, 1), lay,
                                       rank, device, dtype)
        pg, bx, by = lay.coords(rank)
        R, H, N, nloc = lay.R, lay.H, lay.N, lay.nloc
        #: which of the block's frame corners are cube corners (SW, SE,
        #: NW, NE: x-low/high × y-low/high)
        self.corner_flags = (bx == 0 and by == 0, bx == R - 1 and by == 0,
                             bx == 0 and by == R - 1,
                             bx == R - 1 and by == R - 1)
        # the cube-corner circulation taps of this rank's panels, in block
        # indices, for the corners its block owns
        block_of = {(H, H): (0, 0), (H + N, H): (R - 1, 0),
                    (H, H + N): (0, R - 1), (H + N, H + N): (R - 1, R - 1)}
        panels = slice(pg * lay.P_loc, (pg + 1) * lay.P_loc)
        self.corners = []
        for c in grid._corner:
            if block_of[(c["ci"], c["cj"])] != (bx, by):
                continue
            ii = c["ii"][panels] - bx * nloc
            jj = c["jj"][panels] - by * nloc
            if int(ii.min()) < 0 or int(ii.max()) >= lay.nl2 or \
                    int(jj.min()) < 0 or int(jj.max()) >= lay.nl2:
                raise ValueError(
                    "cube-corner circulation taps leave the block window "
                    f"(block {nloc}, halo {H}); use a larger block or halo")
            self.corners.append({
                "ci": c["ci"] - bx * nloc, "cj": c["cj"] - by * nloc,
                "ii": ii.to(device), "jj": jj.to(device),
                "is_u": c["is_u"][panels].to(device),
                "w": c["w"][panels].to(device, dtype),
                "area": c["area"][panels].to(device, dtype)})
        self.panels = torch.arange(lay.P_loc, device=device)[:, None]
        self.radius = grid.panel_grid.radius

    def _corner_avg(self, a):
        """The serial corner-halo reflection averaging, at this block's
        cube-corner frames only."""
        H, nloc = self.lay.H, self.lay.nloc
        lo, hi = slice(0, H), slice(H + nloc, 2 * H + nloc)
        rlo, rhi = slice(H, 2 * H), slice(nloc, H + nloc)

        def mean(x_strip, y_strip):
            return 0.5 * (x_strip.flip(-2) + y_strip.flip(-3))

        sw, se, nw, ne = self.corner_flags
        if sw:
            a[:, lo, lo] = mean(a[:, lo, rlo], a[:, rlo, lo])
        if se:
            a[:, hi, lo] = mean(a[:, hi, rlo], a[:, rhi, lo])
        if nw:
            a[:, lo, hi] = mean(a[:, lo, rhi], a[:, rlo, hi])
        if ne:
            a[:, hi, hi] = mean(a[:, hi, rhi], a[:, rhi, hi])
        return a

    def halo_exchange(self, a, width=None, fill_corners=True):
        if width is not None and width != self.lay.H:
            raise ValueError("a distributed cube exchanges its full halo "
                             "width only")
        out = _apply_exchange(self.ex_center, [a], self.dist, key="c")[0]
        return self._corner_avg(out) if fill_corners else out

    def velocity_exchange(self, u, v):
        u, v = _apply_exchange(self.ex_vel, [u, v], self.dist, key="v")
        return u, v

    def sync_edge_fluxes(self, Fx, Fy):
        Fx, Fy = _apply_exchange(self.ex_flux, [Fx, Fy], self.dist,
                                 mean=True, key="f")
        return Fx, Fy

    def corner_vorticity(self, zeta, u, v):
        zeta = zeta.clone()
        pp = self.panels
        for c in self.corners:
            vel = torch.where(c["is_u"], u[pp, c["ii"], c["jj"]],
                              v[pp, c["ii"], c["jj"]])
            legs = vel * c["w"].to(vel.dtype)
            total = legs[:, 0]
            for k in range(1, legs.shape[1]):
                total = total + legs[:, k]
            val = total / (c["area"].to(vel.dtype) * self.radius)
            zeta[:, c["ci"], c["cj"]] = val.to(zeta.dtype)
        return zeta

    def reduce_sum(self, t):
        return self.dist.all_reduce(t)


class _BlockCube:
    """A rank's blocks as the grid of a cube model: the block-windowed
    panel grid, the global panel size, and the exchanges
    (``distributed``), which the cube operations of
    ``grids/cubed_sphere_grid.py`` take in place of their own tables."""

    def __init__(self, grid, panel_grid, exchanges):
        self.N_panel = grid.N_panel
        self.panel_grid = panel_grid
        self.distributed = exchanges

    @property
    def device(self):
        return self.panel_grid.device

    @property
    def dtype(self):
        return self.panel_grid.dtype


# ---------------------------------------------------------------------------
# The distributed models
# ---------------------------------------------------------------------------

class _CSDistBase:
    """The shared machinery of the distributed cube models: the block
    layout over the ranks, the layout conversions, the windowed model::

        dm = CubedSphereDistributed*(model, dist, R=2, panels=2)  # 8 ranks
        bstate = dm.to_local_state(state)          # once, every rank
        bstate = dm.step(bstate, dt)
        state = dm.from_local_state(bstate)        # on rank 0

    ``model`` is the serial model, built the same way on every rank;
    ``dist`` the rank's ``Distributed`` (its partition is not used: the
    layout is ``panels · R²`` ranks). Each block window evolves as the
    same window of the serial panel frame."""

    def __init__(self, model, dist: Distributed, R=1, panels=6):
        grid = model.grid
        g = grid.panel_grid
        N, H = grid.N_panel, g.H[0]
        if g.H[0] != g.H[1]:
            raise ValueError("anisotropic halos unsupported")
        if 6 % panels:
            raise ValueError(f"panels={panels} must divide 6")
        if N % R:
            raise ValueError(f"panel size {N} must divide R={R}")
        nloc = N // R
        if nloc <= H:
            raise ValueError(f"block interior {nloc} must exceed the "
                             f"halo width {H}")
        need = panels * R * R
        if dist.world_size != need:
            raise ValueError(f"needs {need} ranks, got {dist.world_size}")
        for name, fbc in getattr(model, "bcs", {}).items():
            for side in ("top", "bottom"):
                bc = getattr(fbc, side, None)
                cond = getattr(bc, "condition", None)
                if cond is not None and hasattr(cond, "ndim") and \
                        np.ndim(cond) >= 3:
                    raise ValueError(
                        f"boundary condition {name}.{side} is an array: on "
                        "the distributed cube give a number or a function "
                        "of (lam, phi, t)")
        self.model = model
        self.grid = grid
        self.dist = dist
        self.lay = _Layout(N=N, H=H, R=R, panels=panels, nloc=nloc,
                           nl2=nloc + 2 * H, P_loc=6 // panels, n_dev=need)
        self.coords = self.lay.coords(dist.rank)
        device, dtype = dist.device, g.dtype
        self.exchanges = _BlockExchanges(grid, self.lay, dist, device,
                                         dtype)
        _, bx, by = self.coords
        pg_grid = _window_grid(g, device, bx * nloc, by * nloc, nloc, nloc)
        pg_grid.reduce_sum = self.exchanges.reduce_sum
        self.block_grid = _BlockCube(grid, pg_grid, self.exchanges)
        self.lmodel = self._window_model(model)

    # ---- the windowed model ---------------------------------------------
    def _window_model(self, model):
        """A shallow copy of ``model`` on the rank's blocks: every stacked
        ``(6, nx, ny, ·)`` and per-panel ``(nx, ny, ·)`` array windowed,
        the interior masks made block-local (each block owns its interior,
        the face masks include its shared high face), the grid the block
        cube."""
        lay = self.lay
        pg, bx, by = self.coords
        nx, ny = self.grid.panel_grid.shape[:2]
        x0, y0 = bx * lay.nloc, by * lay.nloc
        panels = slice(pg * lay.P_loc, (pg + 1) * lay.P_loc)
        lm = copy.copy(model)
        for name, val in vars(model).items():
            if not isinstance(val, (np.ndarray, torch.Tensor)):
                continue
            shape = tuple(val.shape)
            if len(shape) >= 3 and shape[0] == 6 and shape[1:3] == (nx, ny):
                w = val[panels, x0:x0 + lay.nl2, y0:y0 + lay.nl2]
            elif len(shape) >= 2 and shape[:2] == (nx, ny):
                w = val[x0:x0 + lay.nl2, y0:y0 + lay.nl2]
            else:
                continue
            if isinstance(w, torch.Tensor):
                w = w.to(self.dist.device).clone()
            else:
                w = np.array(w)
            setattr(lm, name, w)
        H, nloc, nl2 = lay.H, lay.nloc, lay.nl2
        owned = {}
        for loc, (ex, ey) in (("c", (0, 0)), ("u", (1, 0)), ("v", (0, 1))):
            m = np.zeros((nl2, nl2, 1))
            m[H:H + nloc + ex, H:H + nloc + ey] = 1.0
            owned[loc] = m
        for name, loc in (("_mask_c", "c"), ("_mask_u", "u"),
                          ("_mask_v", "v"), ("_mask_u2", "u"),
                          ("_mask_v2", "v")):
            if getattr(lm, name, None) is not None:
                setattr(lm, name, np.asarray(getattr(lm, name))
                        * owned[loc])
        lm.grid = self.block_grid
        lm._device_arrays = {}
        if hasattr(model, "free_surface_info"):
            lm.free_surface_info = {}
        return lm

    # ---- layout conversions ---------------------------------------------
    def _block(self, a):
        lay = self.lay
        pg, bx, by = self.coords
        x0, y0 = bx * lay.nloc, by * lay.nloc
        return a[pg * lay.P_loc:(pg + 1) * lay.P_loc,
                 x0:x0 + lay.nl2, y0:y0 + lay.nl2].to(
            self.dist.device).clone()

    def _unblock(self, blocks):
        """The stacked panel frame from every rank's block (in rank order):
        block interiors, and the panel halo ring from the edge blocks."""
        lay = self.lay
        N, H, nloc, nl2, R = lay.N, lay.H, lay.nloc, lay.nl2, lay.R
        b0 = blocks[0]
        out = b0.new_zeros((6, N + 2 * H, N + 2 * H) + tuple(b0.shape[3:]))

        def span(b):
            if R == 1:
                return 0, nl2
            if b == 0:
                return 0, H + nloc
            if b == R - 1:
                return H, nl2
            return H, H + nloc

        for r, blk in enumerate(blocks):
            pg, bx, by = lay.coords(r)
            x0, x1 = span(bx)
            y0, y1 = span(by)
            out[pg * lay.P_loc:(pg + 1) * lay.P_loc,
                bx * nloc + x0:bx * nloc + x1,
                by * nloc + y0:by * nloc + y1] = blk[:, x0:x1, y0:y1]
        return out

    @staticmethod
    def _stacked(t):
        return isinstance(t, torch.Tensor) and t.ndim == 4 and \
            t.shape[0] == 6

    def to_local_state(self, state):
        """This rank's blocks of a stacked state given on every rank."""
        return _map_tensors(state, lambda t: self._block(t)
                            if self._stacked(t) else t)

    def from_local_state(self, bstate, root=0):
        """The stacked state on rank ``root`` from every rank's blocks;
        None on the other ranks."""
        lay = self.lay

        def gather(t):
            if not (isinstance(t, torch.Tensor) and t.ndim == 4
                    and t.shape[0] == lay.P_loc
                    and t.shape[1] == t.shape[2] == lay.nl2):
                return t
            blocks = self.dist.gather_blocks(t, root=root)
            return t if blocks is None else self._unblock(blocks)

        out = _map_tensors(bstate, gather)
        return out if self.dist.rank == root else None

    def initial_state(self, **kw):
        return self.to_local_state(self.model.initial_state(**kw))

    def step(self, state, dt):
        return self.lmodel.step(state, dt)

    def __repr__(self):
        lay = self.lay
        return (f"{type(self).__name__}(N={lay.N}, R={lay.R}, "
                f"panels={lay.panels}, ranks={lay.n_dev})")


class CubedSphereDistributedSW(_CSDistBase):
    """The explicit-halo distributed ``CubedSphereShallowWaterModel`` (see
    :class:`_CSDistBase` for the usage and guarantees)."""

    def __init__(self, model, dist, R=1, panels=6):
        from oceananigans_torch.models.cubed_sphere import (
            CubedSphereShallowWaterModel,
        )
        if not isinstance(model, CubedSphereShallowWaterModel):
            raise ValueError("CubedSphereDistributedSW wraps a "
                             "CubedSphereShallowWaterModel")
        super().__init__(model, dist, R=R, panels=panels)


class CubedSphereDistributedHydrostatic(_CSDistBase):
    """The explicit-halo distributed ``CubedSphereHydrostaticModel`` (see
    :class:`_CSDistBase`): the 3-D state (u, v and the tracers at nz, η at
    one level) exchanges block halos at every fill; w and the pressure
    integrals, the closures (the vertically implicit column solves too),
    the forcings and the free surface's substeps run on the blocks, the
    implicit free surface's CG with all-reduced inner products."""

    def __init__(self, model, dist, R=1, panels=6):
        from oceananigans_torch.models.cubed_sphere import (
            CubedSphereHydrostaticModel,
        )
        if not isinstance(model, CubedSphereHydrostaticModel):
            raise ValueError("CubedSphereDistributedHydrostatic wraps a "
                             "CubedSphereHydrostaticModel")
        super().__init__(model, dist, R=R, panels=panels)
