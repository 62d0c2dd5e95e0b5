"""Six-panel conformal cubed-sphere grid with inter-panel halo exchange.

Counterpart of ``oceananigans_tpu/grids/cubed_sphere_grid.py``. Fields
live as stacked ``(6, nx, ny, nz)`` tensors, one conformal panel a slice
of the leading axis; every panel shares one ``OrthogonalSphericalShellGrid``
(``panel_grid``), whose ``(nx, ny, 1)`` metrics broadcast against the
stack, and the operators of ``ops/operators.py`` count their axes from
the end, so a stacked field goes through them whole.

The connectivity (which neighbour panel, which side, index order, the
rotation of the velocity components) is derived numerically, by matching
edge and staggered node coordinates between panels, in float64 numpy, with
the JAX package's rules, so the tables are the same. They are built once
per grid and kept as index tensors on the grid's device: an exchange is
one gather and one scatter on the card and copies nothing from the host.
Every fill is functional, as the JAX package's ``.at[].set`` is: it reads
the old tensors whole before it writes a copy, and no table writes one
destination twice (``index_put_`` with repeated indices would be
nondeterministic on CUDA).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from oceananigans_torch.config import as_dtype, config
from oceananigans_torch.grids.cubed_sphere import (
    conformal_cubed_sphere_mapping, conformal_cubed_sphere_panel,
)
from oceananigans_torch.grids.latlon import R_EARTH

__all__ = ["ConformalCubedSphereGrid", "corner_circulation_tables",
           "cubed_sphere_corner_vorticity", "cubed_sphere_halo_exchange",
           "cubed_sphere_sync_edge_fluxes", "cubed_sphere_velocity_exchange",
           "panel_geographic_coords"]

# rotations taking the TOP panel onto the 6 cube faces
_PANEL_ROTATIONS = [
    np.eye(3),                                           # 0: +z (top)
    np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]]).T,      # 1: +x
    np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]]).T,      # 2: +y
    np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]]).T,      # 3: -x
    np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]]).T,      # 4: -y
    np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]]),       # 5: -z (bottom)
]

_SIDES = ("west", "east", "south", "north")


def _panel_xyz(p, x, y):
    """Cartesian points of panel p at panel coordinates (x, y)."""
    X, Y, Z = conformal_cubed_sphere_mapping(x, y)
    P = np.stack([X, Y, Z], axis=-1)
    return P @ np.asarray(_PANEL_ROTATIONS[p]).T


def _edge_nodes(p, side, N, offset):
    """(N,) cartesian nodes along an interior line ``offset`` cells inside
    ``side`` of panel p (offset 0 = on the edge), at cell-center spacing."""
    t = -1.0 + (2.0 / N) * (np.arange(N) + 0.5)
    d = 2.0 / N
    if side == "west":
        x = np.full(N, -1.0 + offset * d)
        y = t
    elif side == "east":
        x = np.full(N, 1.0 - offset * d)
        y = t
    elif side == "south":
        x = t
        y = np.full(N, -1.0 + offset * d)
    else:
        x = t
        y = np.full(N, 1.0 - offset * d)
    return _panel_xyz(p, x, y)


@lru_cache(None)
def _connectivity(N: int):
    """For each (panel, side): (neighbor_panel, neighbor_side, reversed).

    Derived by matching the ON-EDGE node sets numerically."""
    conn = {}
    edges = {(p, s): _edge_nodes(p, s, N, 0.0)
             for p in range(6) for s in _SIDES}
    for (p, s), pts in edges.items():
        for (q, r), qts in edges.items():
            if q == p:
                continue
            if np.allclose(pts, qts, atol=1e-10):
                conn[(p, s)] = (q, r, False)
                break
            if np.allclose(pts, qts[::-1], atol=1e-10):
                conn[(p, s)] = (q, r, True)
                break
        if (p, s) not in conn:
            raise RuntimeError(f"no neighbor found for panel {p} side {s}")
    return conn


class ConformalCubedSphereGrid:
    """Six conformal panels and their numeric connectivity. Fields are
    stacked ``(6, nx, ny, nz)`` tensors; ``panel_grid`` is the per-panel
    ``OrthogonalSphericalShellGrid`` that all panels share (they are
    congruent). ``panel_size`` is ``(N, Nz)``. The grid lives on
    ``device`` (``config.device``, the GPU, by default) in ``dtype``."""

    def __init__(self, panel_size, z, radius=R_EARTH, halo=None,
                 dtype=None, device=None):
        if halo is None:
            halo = min(config.halo, 2)
        N, Nz = panel_size
        self.N_panel = N
        self.panel_grid = conformal_cubed_sphere_panel(
            (N, N, Nz), z=z, radius=radius, halo=halo, dtype=as_dtype(dtype),
            device=device)
        self.connectivity = _connectivity(N)
        self.rotations = _PANEL_ROTATIONS

        # per-panel geographic coordinates at the interior centers (for
        # set_tracer)
        t = -1.0 + (2.0 / N) * (np.arange(N) + 0.5)
        XX, YY = np.meshgrid(t, t, indexing="ij")
        lams, phis = [], []
        for p in range(6):
            P = _panel_xyz(p, XX.ravel(), YY.ravel()).reshape(N, N, 3)
            phis.append(np.rad2deg(np.arcsin(np.clip(P[..., 2], -1, 1))))
            lams.append(np.rad2deg(np.arctan2(P[..., 1], P[..., 0])))
        self.lam_cc = np.stack(lams)    # (6, N, N)
        self.phi_cc = np.stack(phis)

        # the exchange tables, once, on the grid's device
        H = self.panel_grid.H[0]
        self._exchange = {}
        self._exchange_tables(H)
        self._velocity = {
            comp: self._tensors(tab, n_index=6)
            for comp, tab in _velocity_maps_flat(N, H).items()}
        ef = _edge_face_maps_flat(N, H)
        self._edge = self._edge_tables(ef)
        self._corner = self._corner_tables(N, H)
        self._panels = torch.arange(6, device=self.device)[:, None]

    # ---- device tables -------------------------------------------------
    def _long(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    def _real(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    def _tensors(self, tab, n_index):
        """(indices..., sign, is_u) of a flat velocity table."""
        DP, DI, DJ, SQ, SI, SJ, SGN, ISU = tab
        return (tuple(self._long(a) for a in (DP, DI, DJ, SQ, SI, SJ))
                + (self._real(SGN)[:, None],
                   torch.as_tensor(ISU, device=self.device)[:, None]))

    def _exchange_tables(self, H):
        """The center-located exchange's flat (dst, src) index tensors for
        halo width ``H`` (built on first use of a width, then kept)."""
        if H not in self._exchange:
            self._exchange[H] = tuple(
                self._long(a) for a in _exchange_maps(self, H))
        return self._exchange[H]

    def _edge_tables(self, flat):
        PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = flat
        is_u = OC == 0
        return {"own": tuple(self._long(a) for a in (PP, OI, OJ)),
                "own_u": torch.as_tensor(OC == 0,
                                         device=self.device)[:, None],
                "oth": tuple(self._long(a) for a in (QQ, NI, NJ)),
                "oth_u": torch.as_tensor(NC == 0,
                                         device=self.device)[:, None],
                "sign": self._real(SG)[:, None],
                "sel_u": self._long(np.nonzero(is_u)[0]),
                "sel_v": self._long(np.nonzero(~is_u)[0]),
                "dst_u": tuple(self._long(a[is_u]) for a in (PP, OI, OJ)),
                "dst_v": tuple(self._long(a[~is_u]) for a in (PP, OI, OJ))}

    def _corner_tables(self, N, H):
        corners, comp_t, ii_t, jj_t, w_t, area_t = \
            corner_circulation_tables(N, H)
        return [{"ci": ci, "cj": cj,
                 "ii": self._long(ii_t[c]), "jj": self._long(jj_t[c]),
                 "is_u": torch.as_tensor(comp_t[c] == 0,
                                         device=self.device)[..., None],
                 "w": self._real(w_t[c])[..., None],
                 "area": self._real(area_t[c])[:, None]}
                for c, (ci, cj) in enumerate(corners)]

    # ---- fields --------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.panel_grid.device

    @property
    def dtype(self) -> torch.dtype:
        return self.panel_grid.dtype

    def new_field(self, dtype=None):
        g = self.panel_grid
        return torch.zeros((6, *g.shape), dtype=dtype or self.dtype,
                           device=self.device)

    def set_tracer(self, fn):
        """A stacked (6, nx, ny, nz) tracer from ``fn(lam, phi, z)``
        (degrees, numpy arrays; z broadcast), zero in the halos."""
        g = self.panel_grid
        full = np.zeros((6, *g.shape))
        sx, sy, sz = g.interior_slices
        zc = (g.zC.reshape(-1).cpu().numpy()[sz] if g.shape[2] > 1
              else np.zeros(g.Nz))
        for p in range(6):
            vals = fn(self.lam_cc[p][:, :, None],
                      self.phi_cc[p][:, :, None],
                      zc[None, None, :])
            full[p][sx, sy, sz] = vals
        return torch.as_tensor(full, dtype=self.dtype, device=self.device)

    # ---- Simulation / writer interface (stacked-panel semantics) ------
    @property
    def N(self):
        """(N, N, Nz) per-panel interior sizes."""
        return (self.N_panel, self.N_panel, self.panel_grid.Nz)

    @property
    def interior_slices(self):
        return self.panel_grid.interior_slices

    def interior(self, a):
        """Interior view of a stacked (6, nx, ny, nz) field: the panel axis
        passes through, per-panel halos drop, and size-1 reduced axes
        (η's z) pass through."""
        sl = list(self.panel_grid.interior_slices)
        full = self.panel_grid.shape
        for ax in range(3):
            if a.shape[ax - 3] != full[ax] and a.shape[ax - 3] == 1:
                sl[ax] = slice(None)
        return a[(Ellipsis, *sl)]

    def xnodes(self, *a, **kw):
        """Cell-center longitudes, flattened (6·N·N,): a curvilinear grid
        has no separable 1-D x coordinate."""
        return np.asarray(self.lam_cc).ravel()

    def ynodes(self, *a, **kw):
        return np.asarray(self.phi_cc).ravel()

    def znodes(self, *a, **kw):
        return self.panel_grid.znodes(*a, **kw)

    def __repr__(self):
        return (f"ConformalCubedSphereGrid(panels=6, "
                f"N={self.N_panel}, Nz={self.panel_grid.Nz})")


def panel_geographic_coords(xs, ys):
    """(longitude, latitude) in degrees at the panel-coordinate tensor
    grid ``(xs, ys)`` for all six panels: (6, len(xs), len(ys)) arrays.
    The single source of truth for staggered geographic coordinates
    (used by the hydrostatic model's forcing/BC evaluation AND the
    NetCDF writer's coordinate variables — keep them identical)."""
    XX, YY = np.meshgrid(np.asarray(xs, float), np.asarray(ys, float),
                         indexing="ij")
    lam = np.zeros((6,) + XX.shape)
    phi = np.zeros((6,) + XX.shape)
    for p in range(6):
        P = _panel_xyz(p, XX.ravel(), YY.ravel()).reshape(*XX.shape, 3)
        phi[p] = np.rad2deg(np.arcsin(np.clip(P[..., 2], -1.0, 1.0)))
        lam[p] = np.rad2deg(np.arctan2(P[..., 1], P[..., 0]))
    return lam, phi


def _tangent(p, x, y, axis, h=1e-6):
    """Unit tangent of panel p's grid direction at panel coords (x, y)."""
    if axis == 0:
        d = _panel_xyz(p, np.atleast_1d(x + h), np.atleast_1d(y)) \
            - _panel_xyz(p, np.atleast_1d(x - h), np.atleast_1d(y))
    else:
        d = _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y + h)) \
            - _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y - h))
    d = d[0]
    return d / np.linalg.norm(d)


def _tangent(p, x, y, axis, h=1e-6):
    """Unit tangent of panel p's grid direction at panel coords (x, y)."""
    if axis == 0:
        d = _panel_xyz(p, np.atleast_1d(x + h), np.atleast_1d(y)) \
            - _panel_xyz(p, np.atleast_1d(x - h), np.atleast_1d(y))
    else:
        d = _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y + h)) \
            - _panel_xyz(p, np.atleast_1d(x), np.atleast_1d(y - h))
    d = d[0]
    return d / np.linalg.norm(d)


def _tangents(p, x, y, axis, h=1e-6):
    """(n, 3) unit tangents of panel p's grid direction at panel coords."""
    x = np.asarray(x, float).ravel()
    y = np.asarray(y, float).ravel()
    if axis == 0:
        d = _panel_xyz(p, x + h, y) - _panel_xyz(p, x - h, y)
    else:
        d = _panel_xyz(p, x, y + h) - _panel_xyz(p, x, y - h)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _slot_xy(comp, i, j, N, H):
    """Panel coords of the staggered point of component ``comp`` (0 = u
    at (f, c), 1 = v at (c, f)) at array indices (i, j)."""
    d = 2.0 / N
    if comp == 0:
        return -1.0 + (i - H) * d, -1.0 + (j - H + 0.5) * d
    return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H) * d


def _rotation_signs(p, comp, x, y, q, scomp, si, sj, N, H):
    """±1 per slot: the receiving component's tangent (panel p, component
    ``comp`` at (x, y)) projected on the source component's (panel q,
    components ``scomp`` at indices (si, sj)), rounded."""
    t_dst = _tangents(p, x, y, comp)
    t_src = np.empty_like(t_dst)
    for sc in (0, 1):
        m = scomp == sc
        if m.any():
            xs, ys = _slot_xy(sc, si[m].astype(float), sj[m].astype(float),
                              N, H)
            t_src[m] = _tangents(q, xs, ys, sc)
    s = np.round(np.sum(t_dst * t_src, axis=-1))
    if np.any(s == 0.0):
        raise RuntimeError("non-orthogonal edge rotation")
    return s


def _near_side(I, J, side, N, H, reach):
    """Mask of array indices within ``reach`` cells of a panel side."""
    if side == "west":
        return I <= H + reach
    if side == "east":
        return I >= H + N - reach
    if side == "south":
        return J <= H + reach
    return J >= H + N - reach


@lru_cache(None)
def _velocity_maps(N: int, H: int):
    """Numerically derived gather maps for the staggered velocity halo
    exchange: for every halo slot of every panel side, which neighbour
    panel, component and index supply it, and with which sign (the
    component rotation across rotated panel edges).

    The tables are those of the JAX package's ``_velocity_maps``: each slot
    takes the nearest staggered point of the neighbour (which must lie
    within 1e-5, the conformal fit's residual being ~1e-7). The search runs
    over the neighbour's points within H + 1 cells of the shared side, and
    over all slots of a side at once; the nearest point is the same.

    Arrays follow the co-shaped field convention: every field is
    (N + 2H, N + 2H, nz), and a face field's meaningful faces are i in
    [H, H + N] (the shared edge face at H + N is interior-owned, never
    overwritten here)."""
    Hx = Hy = H

    def coords(comp, i, j):
        return _slot_xy(0 if comp == "u" else 1, i, j, N, H)

    # source tables: interior staggered points of every panel
    src_pts = {}
    src_idx = {}
    for comp in ("u", "v"):
        if comp == "u":
            ii = np.arange(Hx, Hx + N + 1)      # x-faces incl shared edge
            jj = np.arange(Hy, Hy + N)
        else:
            ii = np.arange(Hx, Hx + N)
            jj = np.arange(Hy, Hy + N + 1)
        I, J = np.meshgrid(ii, jj, indexing="ij")
        x, y = coords(comp, I.ravel().astype(float),
                      J.ravel().astype(float))
        src_idx[comp] = (I.ravel(), J.ravel())
        src_pts[comp] = {p: _panel_xyz(p, x, y) for p in range(6)}

    conn = _connectivity(N)
    maps = {}
    for p in range(6):
        for side in _SIDES:
            q, r, _ = conn[(p, side)]
            for comp in ("u", "v"):
                # halo slots of this side (transverse range: interior)
                if side in ("west", "east"):
                    if side == "west":
                        ih = np.arange(0, Hx)
                    else:
                        ih = np.arange(Hx + N + (1 if comp == "u" else 0),
                                       2 * Hx + N + (1 if comp == "u"
                                                     else 0))
                        ih = ih[ih < 2 * Hx + N + 1]
                    jh = np.arange(Hy, Hy + N + (1 if comp == "v" else 0))
                else:
                    ih = np.arange(Hx, Hx + N + (1 if comp == "u" else 0))
                    if side == "south":
                        jh = np.arange(0, Hy)
                    else:
                        jh = np.arange(Hy + N + (1 if comp == "v" else 0),
                                       2 * Hy + N + (1 if comp == "v"
                                                     else 0))
                        jh = jh[jh < 2 * Hy + N + 1]
                I, J = np.meshgrid(ih, jh, indexing="ij")
                I = I.ravel()
                J = J.ravel()
                # clip to the co-shaped array extent (N + 2H per axis)
                ni = nj = 2 * Hx + N
                keep = (I < ni) & (J < nj)
                I, J = I[keep], J[keep]
                if I.size == 0:
                    continue
                x, y = coords(comp, I.astype(float), J.astype(float))
                P = _panel_xyz(p, x, y)
                best = np.full(I.size, np.inf)
                scomp = np.zeros(I.size, np.int64)
                out_i = np.zeros(I.size, np.int32)
                out_j = np.zeros(I.size, np.int32)
                for sc_i, sc in enumerate(("u", "v")):
                    near = _near_side(*src_idx[sc], r, N, H, H + 1)
                    pts = src_pts[sc][q][near]
                    dist = np.linalg.norm(pts[None, :, :] - P[:, None, :],
                                          axis=2)
                    k = np.argmin(dist, axis=1)
                    dk = dist[np.arange(I.size), k]
                    better = dk < best
                    best = np.where(better, dk, best)
                    scomp = np.where(better, sc_i, scomp)
                    out_i = np.where(better, src_idx[sc][0][near][k], out_i)
                    out_j = np.where(better, src_idx[sc][1][near][k], out_j)
                if np.any(best > 1e-5):
                    raise RuntimeError(
                        f"no staggered match p{p} {side} {comp} "
                        f"(dist {best.max():.2e})")
                out_s = _rotation_signs(p, 0 if comp == "u" else 1, x, y,
                                        q, scomp, out_i, out_j, N, H)
                out_comp = np.where(scomp == 0, "u", "v").astype("U1")
                maps[(p, side, comp)] = (q, I, J, out_comp,
                                         out_i.astype(np.int32),
                                         out_j.astype(np.int32), out_s)
    return maps


def _closest_pair(P, Q, reach=4):
    """The indices ``(i, j)`` of the least |P_i − Q_j| over unit vectors
    ``P`` and ``Q``, as ``np.argmin`` of the whole table of distances gives
    them: the largest P_i·Q_j finds the pair, and the distances themselves
    are taken over the pairs within ``reach`` of it, where rounding alone
    could move the least, the first of equal ones winning, as in
    ``np.argmin``."""
    i0, j0 = np.unravel_index(np.argmax(P @ Q.T), (len(P), len(Q)))
    i1, j1 = max(i0 - reach, 0), max(j0 - reach, 0)
    dm = np.linalg.norm(P[i1:i0 + reach + 1, None, :]
                        - Q[None, j1:j0 + reach + 1, :], axis=2)
    a, b = np.unravel_index(np.argmin(dm), dm.shape)
    return i1 + a, j1 + b


@lru_cache(None)
def corner_circulation_tables(N: int, H: int):
    """Exact 3-segment circulation stencils for the vertical vorticity at
    the 8 cube-corner vertices (each panel's 4 corners are cube corners).

    The standard 4-segment C-grid circulation is wrong there: the vertex
    is 3-valent, so the loop through the four surrounding "cell centers"
    references a fictitious quadrant and double-samples one edge.
    Instead we integrate around the spherical TRIANGLE through the three
    REAL adjacent cell centers; each leg crosses one emanating edge at a
    staggered velocity point, whose slot/sign is found numerically (the
    same position-matching used for the velocity halo exchange).

    Returns (corners, comp, ii, jj, w, area):
      corners: list of 4 (ci, cj) vertex indices,
      comp[c]: (6, 3) 0=u/1=v slot of each leg's sample,
      ii/jj[c]: (6, 3) array indices,
      w[c]: (6, 3) signed UNIT-SPHERE leg lengths,
      area[c]: (6,) unit-sphere triangle areas.
    ζ_corner = Σ_k w_k · vel_k / (area · radius)."""
    d = 2.0 / N

    def cc_xy(i, j):
        return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H + 0.5) * d

    def slot_xy(comp, i, j):
        if comp == 0:    # u at (f, c)
            return -1.0 + (i - H) * d, -1.0 + (j - H + 0.5) * d
        return -1.0 + (i - H + 0.5) * d, -1.0 + (j - H) * d

    def tri_area(A, B, C):
        # l'Huilier on the unit sphere
        def side(P, Q):
            return np.arccos(np.clip(np.dot(P, Q), -1.0, 1.0))
        a_, b_, c_ = side(B, C), side(C, A), side(A, B)
        s = 0.5 * (a_ + b_ + c_)
        t = np.sqrt(max(np.tan(s / 2) * np.tan((s - a_) / 2)
                        * np.tan((s - b_) / 2) * np.tan((s - c_) / 2), 0.0))
        return 4.0 * np.arctan(t)

    corners = [(H, H), (H + N, H), (H, H + N), (H + N, H + N)]
    comp_t, ii_t, jj_t, w_t, area_t = [], [], [], [], []
    for (ci, cj) in corners:
        di = 1 if ci == H else -1
        dj = 1 if cj == H else -1
        # the three real cell centers around the vertex: own + the two
        # edge-strip cells (their extension positions match the true
        # neighbor centers)
        own = (ci - (0 if di > 0 else 1), cj - (0 if dj > 0 else 1))
        cx = (own[0] - di, own[1])
        cy = (own[0], own[1] - dj)
        # candidate staggered slots adjacent to the vertex
        cands = [(0, ci, cj - (0 if dj > 0 else 1)),
                 (0, ci, cj - (1 if dj > 0 else 0)),
                 (1, ci - (0 if di > 0 else 1), cj),
                 (1, ci - (1 if di > 0 else 0), cj)]
        comp_p = np.zeros((6, 6), np.int32)
        ii_p = np.zeros((6, 6), np.int32)
        jj_p = np.zeros((6, 6), np.int32)
        w_p = np.zeros((6, 6))
        area_p = np.zeros(6)
        def at(p, xy):
            return _panel_xyz(p, np.atleast_1d(xy[0]),
                              np.atleast_1d(xy[1]))[0]

        for p in range(6):
            P = {c: at(p, cc_xy(*c)) for c in (own, cx, cy)}
            # counterclockwise (w.r.t. outward normal) vertex order
            order = [own, cx, cy]
            n = P[own] / np.linalg.norm(P[own])
            if np.dot(np.cross(P[cx] - P[own], P[cy] - P[own]), n) < 0:
                order = [own, cy, cx]
            area_p[p] = tri_area(*(P[c] for c in order))
            for k in range(3):
                A, B = P[order[k]], P[order[(k + 1) % 3]]
                mid = 0.5 * (A + B)
                mid /= np.linalg.norm(mid)
                leg = B - A
                leg = leg / np.linalg.norm(leg)
                # among the slots at this leg's crossing point, pick the
                # component whose direction is ALONG the leg (two slots
                # can alias the same physical point with different
                # component directions; only the leg-normal one carries
                # the circulation contribution)
                best = None
                for (sc, si, sj) in cands:
                    sp = at(p, slot_xy(sc, si, sj))
                    if np.linalg.norm(sp - mid) > 0.45 * d:
                        continue
                    t = _tangent(p, *slot_xy(sc, si, sj), sc)
                    al = abs(np.dot(t, leg))
                    if best is None or al > best[0]:
                        best = (al, sc, si, sj, t)
                if best is None or best[0] < 0.95:
                    raise RuntimeError(
                        f"corner leg sample ambiguous (align "
                        f"{0 if best is None else best[0]:.3f})")
                _, sc, si, sj, t = best
                s = 1.0 if np.dot(t, leg) > 0 else -1.0
                L = np.arccos(np.clip(np.dot(A / np.linalg.norm(A),
                                             B / np.linalg.norm(B)),
                                      -1.0, 1.0))
                # ONE-point quadrature at the staggered sample is O(1)
                # wrong for zeta: the sample sits off the leg's true
                # edge-crossing radius and the circulation is a small
                # residual. Interpolate the edge-normal velocity to the
                # exact chord/edge crossing from the TWO samples along
                # the emanating edge.
                vx, vy = -1.0 + (ci - H) * d, -1.0 + (cj - H) * d
                Pv = at(p, (vx, vy))
                # second sample: one step farther from the vertex along
                # the same edge line
                opts = ([(sc, si, sj + 1), (sc, si, sj - 1)]
                        if sc == 0 else
                        [(sc, si + 1, sj), (sc, si - 1, sj)])
                def arcd(Q, R):
                    return np.arccos(np.clip(
                        np.dot(Q / np.linalg.norm(Q),
                               R / np.linalg.norm(R)), -1.0, 1.0))
                P0 = at(p, slot_xy(sc, si, sj))
                cand2 = max(opts,
                            key=lambda o: arcd(at(p, slot_xy(*o)), Pv))
                P1 = at(p, slot_xy(*cand2))
                # chord/edge crossing: nearest point of the edge sample
                # line to the chord (both curves are smooth; minimize
                # pointwise distance)
                ts = np.linspace(0.0, 1.0, 801)
                chord = (1 - ts)[:, None] * A + ts[:, None] * B
                chord /= np.linalg.norm(chord, axis=1, keepdims=True)
                rs = np.linspace(0.0, 3.0, 1201)
                e0 = np.array(slot_xy(sc, si, sj))
                e1 = np.array(slot_xy(*cand2))
                exy = e0[None, :] + (e1 - e0)[None, :] * (
                    (rs - 0.5) / 1.0)[:, None] / 1.0
                E = _panel_xyz(p, exy[:, 0], exy[:, 1])
                E /= np.linalg.norm(E, axis=1, keepdims=True)
                ic, ie = _closest_pair(chord, E)
                X = E[ie]
                s0 = arcd(P0, Pv)
                s1 = arcd(P1, Pv)
                sxd = arcd(X, Pv)
                c1 = (sxd - s0) / (s1 - s0)
                c0 = 1.0 - c1
                comp_p[p, 2 * k] = sc
                ii_p[p, 2 * k] = si
                jj_p[p, 2 * k] = sj
                w_p[p, 2 * k] = s * L * c0
                comp_p[p, 2 * k + 1] = cand2[0]
                ii_p[p, 2 * k + 1] = cand2[1]
                jj_p[p, 2 * k + 1] = cand2[2]
                w_p[p, 2 * k + 1] = s * L * c1
        comp_t.append(comp_p)
        ii_t.append(ii_p)
        jj_t.append(jj_p)
        w_t.append(w_p)
        area_t.append(area_p)
    return corners, comp_t, ii_t, jj_t, w_t, area_t


@lru_cache(None)
def _edge_face_maps(N: int, H: int):
    """Match every panel's edge faces (the face-normal component slots on
    each panel boundary) to the neighbour panel's matching edge faces, with
    the component-rotation sign: the tables of the JAX package's
    ``_edge_face_maps``, searched a side at a time. Used to make fluxes
    through shared faces single-valued (exact global conservation)."""
    conn = _connectivity(N)
    # neighbour candidate table: all edge-face slots of every panel
    cand = {}
    for q in range(6):
        slots = []
        for i in (H, H + N):
            for j in range(H, H + N):
                slots.append((0, i, j))
        for j in (H, H + N):
            for i in range(H, H + N):
                slots.append((1, i, j))
        slots = np.array(slots)
        x, y = np.where(slots[:, 0] == 0,
                        _slot_xy(0, slots[:, 1], slots[:, 2], N, H),
                        _slot_xy(1, slots[:, 1], slots[:, 2], N, H))
        cand[q] = (slots, _panel_xyz(q, x, y))

    maps = []
    for p in range(6):
        for side in _SIDES:
            q = conn[(p, side)][0]
            ks = np.arange(H, H + N)
            if side == "west":
                oc, oi, oj = 0, np.full(N, H), ks
            elif side == "east":
                oc, oi, oj = 0, np.full(N, H + N), ks
            elif side == "south":
                oc, oi, oj = 1, ks, np.full(N, H)
            else:
                oc, oi, oj = 1, ks, np.full(N, H + N)
            x, y = _slot_xy(oc, oi.astype(float), oj.astype(float), N, H)
            P = _panel_xyz(p, x, y)
            qslots, qpts = cand[q]
            dist = np.linalg.norm(qpts[None, :, :] - P[:, None, :], axis=2)
            k = np.argmin(dist, axis=1)
            dk = dist[np.arange(N), k]
            if np.any(dk > 1e-5):
                raise RuntimeError(
                    f"edge-face match failed p{p} {side} ({dk.max():.1e})")
            nc, ni, nj = (qslots[k, c].astype(np.int32) for c in range(3))
            sg = _rotation_signs(p, oc, x, y, q, nc, ni, nj, N, H)
            maps.append((p, np.full(N, oc), oi, oj, q, nc, ni, nj, sg))
    return maps


@lru_cache(None)
def _edge_face_maps_flat(N: int, H: int):
    """All (panel, side) edge-face tables concatenated into one flat
    table."""
    maps = _edge_face_maps(N, H)
    PP, OC, OI, OJ, QQ, NC, NI, NJ, SG = ([] for _ in range(9))
    for (p, oc, oi, oj, q, nc, ni, nj, sg) in maps:
        PP.append(np.full(oi.size, p))
        OC.append(oc)
        OI.append(oi)
        OJ.append(oj)
        QQ.append(np.full(oi.size, q))
        NC.append(nc)
        NI.append(ni)
        NJ.append(nj)
        SG.append(sg)
    return tuple(np.concatenate(v) for v in
                 (PP, OC, OI, OJ, QQ, NC, NI, NJ, SG))


@lru_cache(None)
def _velocity_maps_flat(N: int, H: int):
    """The per-(panel, side, component) velocity maps concatenated into one
    flat table per destination component: two gathers and one scatter a
    component."""
    maps = _velocity_maps(N, H)
    flat = {}
    for dst_comp in ("u", "v"):
        DP, DI, DJ, SQ, SI, SJ, SGN, ISU = ([] for _ in range(8))
        for (p, side, comp), (q, I, J, scomp, iq, jq, sgn) in maps.items():
            if comp != dst_comp:
                continue
            DP.append(np.full(I.size, p))
            DI.append(I)
            DJ.append(J)
            SQ.append(np.full(I.size, q))
            SI.append(iq)
            SJ.append(jq)
            SGN.append(sgn)
            ISU.append(scomp == "u")
        flat[dst_comp] = tuple(np.concatenate(v) for v in
                               (DP, DI, DJ, SQ, SI, SJ, SGN, ISU))
    return flat


def _exchange_maps(grid, H: int):
    """Flat (dst_p, dst_i, dst_j, src_p, src_i, src_j) index tables of the
    center-located inter-panel halo fill: the 6 panels × 4 sides × H rings
    × N cells as one gather."""
    g = grid.panel_grid
    N = g.N[0]
    Hx, Hy = g.H[0], g.H[1]
    ks = np.arange(N)
    dst_p, dst_i, dst_j, src_p, src_i, src_j = ([] for _ in range(6))
    for p in range(6):
        for side in _SIDES:
            q, r, rev = grid.connectivity[(p, side)]
            for h in range(H):
                # source line: interior cells ``h`` in from side ``r`` of
                # panel ``q`` (index order along the edge)
                if r == "west":
                    si, sj = np.full(N, Hx + h), Hy + ks
                elif r == "east":
                    si, sj = np.full(N, Hx + N - 1 - h), Hy + ks
                elif r == "south":
                    si, sj = Hx + ks, np.full(N, Hy + h)
                else:
                    si, sj = Hx + ks, np.full(N, Hy + N - 1 - h)
                if rev:
                    si, sj = si[::-1], sj[::-1]
                if side == "west":
                    di, dj = np.full(N, Hx - 1 - h), Hy + ks
                elif side == "east":
                    di, dj = np.full(N, Hx + N + h), Hy + ks
                elif side == "south":
                    di, dj = Hx + ks, np.full(N, Hy - 1 - h)
                else:
                    di, dj = Hx + ks, np.full(N, Hy + N + h)
                dst_p.append(np.full(N, p))
                dst_i.append(di)
                dst_j.append(dj)
                src_p.append(np.full(N, q))
                src_i.append(si)
                src_j.append(sj)
    return tuple(np.concatenate(v) for v in
                 (dst_p, dst_i, dst_j, src_p, src_i, src_j))


# ---------------------------------------------------------------------------
# The exchanges on stacked (6, nx, ny, nz) tensors
# ---------------------------------------------------------------------------

def cubed_sphere_sync_edge_fluxes(Fx, Fy, grid):
    """Make the x/y fluxes through shared panel-edge faces single-valued:
    both panels' values become the (rotation-consistent) mean, so the flux
    leaving one panel is exactly the flux entering its neighbour (global
    conservation to rounding)."""
    if getattr(grid, "distributed", None) is not None:
        return grid.distributed.sync_edge_fluxes(Fx, Fy)
    e = grid._edge
    own = torch.where(e["own_u"], Fx[e["own"]], Fy[e["own"]])
    oth = torch.where(e["oth_u"], Fx[e["oth"]], Fy[e["oth"]])
    mean = 0.5 * (own + e["sign"].to(own.dtype) * oth)
    out_x = Fx.clone()
    out_y = Fy.clone()
    out_x[e["dst_u"]] = mean[e["sel_u"]]
    out_y[e["dst_v"]] = mean[e["sel_v"]]
    return out_x, out_y


def cubed_sphere_corner_vorticity(zeta, u, v, grid):
    """Overwrite the 4 cube-corner points of each panel of a stacked
    vorticity field with the exact 3-segment circulation
    (:func:`corner_circulation_tables`)."""
    if getattr(grid, "distributed", None) is not None:
        return grid.distributed.corner_vorticity(zeta, u, v)
    radius = grid.panel_grid.radius
    pp = grid._panels
    zeta = zeta.clone()
    for c in grid._corner:
        vel = torch.where(c["is_u"], u[pp, c["ii"], c["jj"]],
                          v[pp, c["ii"], c["jj"]])          # (6, 6, nz)
        legs = vel * c["w"].to(vel.dtype)
        # the six legs summed in order, as XLA reduces them
        total = legs[:, 0]
        for k in range(1, 6):
            total = total + legs[:, k]
        val = total / (c["area"].to(vel.dtype) * radius)
        zeta[:, c["ci"], c["cj"]] = val.to(zeta.dtype)
    return zeta


def cubed_sphere_velocity_exchange(u, v, grid):
    """Fill the x/y halos of stacked u (x-face) and v (y-face) with the
    cross-edge component rotation. Both destinations read the old u and v:
    every gather is done before either copy is written."""
    if getattr(grid, "distributed", None) is not None:
        return grid.distributed.velocity_exchange(u, v)
    vals = {}
    for comp, (DP, DI, DJ, SQ, SI, SJ, SGN, ISU) in grid._velocity.items():
        src = torch.where(ISU, u[SQ, SI, SJ], v[SQ, SI, SJ])
        vals[comp] = (DP, DI, DJ, src * SGN.to(src.dtype))
    out = {"u": u.clone(), "v": v.clone()}
    for comp, (DP, DI, DJ, val) in vals.items():
        out[comp][DP, DI, DJ] = val
    return out["u"], out["v"]


def _fill_halo_corners(a, H, N):
    """Fill the H×H corner halo blocks of a stacked field in place. Every
    panel corner is a 3-valent cube corner, so the corner halo has no source
    panel; each corner cell takes the mean of its reflections into the two
    adjacent (already filled) edge-halo strips."""
    lo, hi = slice(0, H), slice(H + N, 2 * H + N)
    rlo, rhi = slice(H, 2 * H), slice(N, H + N)   # read reversed

    def mean(x_strip, y_strip):
        return 0.5 * (x_strip.flip(-2) + y_strip.flip(-3))

    a[:, lo, lo] = mean(a[:, lo, rlo], a[:, rlo, lo])
    a[:, hi, lo] = mean(a[:, hi, rlo], a[:, rhi, lo])
    a[:, lo, hi] = mean(a[:, lo, rhi], a[:, rlo, hi])
    a[:, hi, hi] = mean(a[:, hi, rhi], a[:, rhi, hi])
    return a


def cubed_sphere_halo_exchange(a, grid, width=None, fill_corners=True):
    """Fill the x/y halos of a stacked center-located field from the
    neighbouring panels: one gather and one scatter, then the corner
    blocks. Returns a new tensor."""
    if getattr(grid, "distributed", None) is not None:
        return grid.distributed.halo_exchange(a, width, fill_corners)
    g = grid.panel_grid
    H = g.H[0] if width is None else width
    dp, di, dj, sp, si, sj = grid._exchange_tables(H)
    out = a.clone()
    out[dp, di, dj] = a[sp, si, sj]
    if fill_corners:
        _fill_halo_corners(out, H, g.N[0])
    return out
