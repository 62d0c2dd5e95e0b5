"""Topology and location vocabulary, coordinate generation, and the grid
base class.

Counterpart of ``oceananigans_tpu/grids/base.py``. Coordinates are built on
the host in float64 numpy, then stored as broadcast-ready tensors: x-arrays
shaped ``(nx, 1, 1)``, y ``(1, ny, 1)``, z ``(1, 1, nz)``; the metrics of a
curvilinear grid are ``(nx, ny, 1)``.
"""

from __future__ import annotations

import numpy as np
import torch

Periodic = "periodic"
Bounded = "bounded"
Flat = "flat"
#: a distributed axis whose halos a neighbour exchange fills (the
#: reference's ``FullyConnected``): its boundary conditions classify as
#: communication, and the ordinary fill leaves its halos to the exchange
Connected = "connected"

Center = "c"
Face = "f"

AXIS_NAMES = ("x", "y", "z")


def total_length(N: int, H: int) -> int:
    """Array length along an axis: interior + two halo rings (flat: N=1, H=0)."""
    return N + 2 * H


def generate_coordinate(spec, N: int, H: int, topo: str):
    """Halo-extended 1-D coordinates of one axis, in float64 numpy.

    ``spec`` is ``(left, right)`` (regular spacing), an array of the
    ``N + 1`` interior faces, or a callable ``i -> face`` sampled at ``i =
    0..N`` (stretched). Returns ``(xF, xC, dxC, dxF, regular, extent)``,
    each array of length ``N + 2H``. Interior cells occupy ``H..H+N-1``;
    ``xF[i]`` is the left face of cell ``i``, so the right wall face of a
    bounded axis sits at index ``H + N``, inside the first halo slot. A
    stretched axis's halo faces repeat the periodic images (Periodic) or
    the edge spacings (Bounded); ``regular`` is the JAX package's rule,
    ``np.allclose`` of the spacings, so uniform faces given as an array
    count as regular.
    """
    if topo == Flat:
        one, zero = np.ones(1), np.zeros(1)
        return zero, zero, one, one, True, 1.0

    if isinstance(spec, tuple) and len(spec) == 2 and np.isscalar(spec[0]):
        left, right = float(spec[0]), float(spec[1])
        dx = (right - left) / N
        faces = left + np.arange(-H, N + H + 1, dtype=np.float64) * dx
        regular = True
    else:
        if callable(spec):
            inner = np.asarray([float(spec(i)) for i in range(N + 1)],
                               dtype=np.float64)
        else:
            inner = np.asarray(spec, dtype=np.float64)
            if inner.shape != (N + 1,):
                raise ValueError(
                    f"stretched coordinate needs N+1={N + 1} faces, "
                    f"got shape {inner.shape}")
        if np.any(np.diff(inner) <= 0):
            raise ValueError("coordinate faces must be strictly increasing")
        faces = np.empty(N + 2 * H + 1, dtype=np.float64)
        faces[H:H + N + 1] = inner
        if topo == Periodic:
            L = inner[-1] - inner[0]
            for h in range(1, H + 1):
                faces[H - h] = inner[N - h] - L
                faces[H + N + h] = inner[h] + L
        else:   # bounded: the edge spacings repeat outward
            dl, dr = inner[1] - inner[0], inner[-1] - inner[-2]
            for h in range(1, H + 1):
                faces[H - h] = faces[H - h + 1] - dl
                faces[H + N + h] = faces[H + N + h - 1] + dr
        regular = bool(np.allclose(np.diff(faces), np.diff(faces)[0]))

    centers = 0.5 * (faces[:-1] + faces[1:])
    dxC = np.diff(faces)
    dxF = np.empty_like(centers)
    dxF[1:] = centers[1:] - centers[:-1]
    dxF[0] = dxF[1]
    extent = float(faces[H + N] - faces[H])
    return faces[:-1], centers, dxC, dxF, regular, extent


def bshape(axis: int, n: int):
    """The broadcast-ready shape of a 1-D array of length ``n`` on ``axis``."""
    shape = [1, 1, 1]
    shape[axis] = n
    return tuple(shape)


def broadcastable(a, axis: int, device=None):
    """A 1-D per-axis array (a tensor or a numpy array) as a tensor of its
    ``(n, 1, 1)``, ``(1, n, 1)`` or ``(1, 1, n)`` shape, on ``device``
    (default: a tensor's own device, the CPU for a numpy array)."""
    return torch.as_tensor(a, device=device).reshape(bshape(axis,
                                                            a.shape[0]))


def interior_slices(N, H):
    """Per-axis slices of the interior cells of a halo-extended array."""
    return tuple(slice(h, h + n) for n, h in zip(N, H))


def pad_interior(a, H):
    """An interior-shaped tensor ``a`` (its last three axes) in the
    halo-extended frame of halos ``H``, zero in the halos. Out of place, so
    a batched ``a`` under ``torch.func.vmap`` stays batched (an in-place
    write into a fresh ``torch.zeros`` cannot be)."""
    pads = []
    for h in reversed(tuple(H)):
        pads += [int(h), int(h)]
    return torch.nn.functional.pad(a, pads)


def halo_per_axis(halo):
    """A halo given as one width or a per-axis triple, as a triple."""
    if isinstance(halo, (tuple, list)):
        return tuple(int(h) for h in halo)
    return (int(halo),) * 3


class AbstractGrid(torch.nn.Module):
    """What every grid has: sizes ``N``, halos ``H`` and ``topology``; the
    halo-extended ``shape``; the areas and volumes built on the subclass's
    ``dx``/``dy``/``dz``; and the node and spacing queries. Coordinate and
    metric tensors are buffers, so ``grid.to(device)`` moves them all.

    ``x_regular``/``y_regular``/``z_regular`` say whether an axis has
    regular spacing in its own coordinate (metres or degrees), by the JAX
    grids' rule (:func:`generate_coordinate`); ``regular`` is all three.
    """

    x_regular = y_regular = z_regular = True

    @property
    def regular(self) -> bool:
        return self.x_regular and self.y_regular and self.z_regular

    # ---- shapes -----------------------------------------------------------
    @property
    def shape(self):
        """Full (halo-extended) field shape on this grid."""
        return tuple(total_length(n, h) for n, h in zip(self.N, self.H))

    @property
    def interior_slices(self):
        return interior_slices(self.N, self.H)

    @property
    def dtype(self) -> torch.dtype:
        return self.zC.dtype

    @property
    def device(self) -> torch.device:
        return self.zC.device

    def interior(self, a):
        """Interior view of ``a``, whose last three axes are x, y and z
        (leading axes, such as an ensemble's members, pass through); an
        axis of size 1 where the grid has more (η's z) carries no halo and
        passes through whole."""
        sl = list(self.interior_slices)
        for ax, n in enumerate(self.shape):
            if a.shape[ax - 3] != n and a.shape[ax - 3] == 1:
                sl[ax] = slice(None)
        return a[(Ellipsis, *sl)]

    def axis_topo(self, axis: int) -> str:
        return self.topology[axis]

    # ---- metrics (dx, dy, dz come from the subclass) -----------------------
    def Ax(self, lx, ly, lz):
        """Area of the x-normal face of the (lx, ly, lz) control volume."""
        return self.dy(ly, lx) * self.dz(lz)

    def Ay(self, lx, ly, lz):
        return self.dx(lx, ly) * self.dz(lz)

    def Az(self, lx, ly, lz=None):
        return self.dx(lx, ly) * self.dy(ly, lx)

    def V(self, lx, ly, lz):
        return self.Az(lx, ly) * self.dz(lz)

    def min_spacing(self, axis: int):
        """The smallest cell width along ``axis`` over the interior (at cell
        centers), as a 0-d tensor; +inf on an axis of one cell."""
        if self.N[axis] == 1:
            return torch.tensor(float("inf"), dtype=self.dtype)
        d = (self.dx(), self.dy(), self.dz())[axis]
        sl = tuple(self.interior_slices[ax] if d.shape[ax] > 1
                   else slice(None) for ax in range(3))
        return torch.min(d[sl])

    # ---- node queries -------------------------------------------------------
    def nodes_1d(self, axis: int, loc: str, with_halos: bool = False):
        """Coordinate values along ``axis`` at location ``loc``, flattened;
        the interior ones (N + 1 faces on a Bounded axis) unless
        ``with_halos``."""
        name = AXIS_NAMES[axis]
        flat = getattr(self, f"{name}F" if loc == Face
                       else f"{name}C").reshape(-1)
        if with_halos:
            return flat
        H, N = self.H[axis], self.N[axis]
        n = N + 1 if (loc == Face and self.axis_topo(axis) == Bounded) else N
        return flat[H:H + n]

    def xnodes(self, loc=Center, **kw):
        return self.nodes_1d(0, loc, **kw)

    def ynodes(self, loc=Center, **kw):
        return self.nodes_1d(1, loc, **kw)

    def znodes(self, loc=Center, **kw):
        return self.nodes_1d(2, loc, **kw)

    def nodes(self, locs=(Center, Center, Center), **kw):
        return (self.xnodes(locs[0], **kw), self.ynodes(locs[1], **kw),
                self.znodes(locs[2], **kw))
