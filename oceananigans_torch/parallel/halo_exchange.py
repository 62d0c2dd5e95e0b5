"""Explicit halo exchange between neighbouring ranks.

Counterpart of ``oceananigans_tpu/parallel/halo_exchange.py``: each rank
sends the edge strips of its block to its mesh neighbours and writes the
strips it receives into its halo slots, a paired ``batch_isend_irecv``
(:meth:`~oceananigans_torch.parallel.distributed.Distributed.p2p`) where
the JAX package has ``jax.lax.ppermute``. Where a block is narrower than
its halo, a halo cell takes the cell it images from whichever block owns
it (:func:`halo_runs`), and one message goes to and from each block a
rank pairs with.

Local-halos layout: each rank's block carries its OWN halo rings (the
layout a kernel consumes), unlike the global layout, where only the domain
edges have halo slots. A rank's block of a global interior ``(Nx, Ny, Nz)``
is ``(Nx/px + 2Hx, Ny/py + 2Hy, Nz)``; :func:`to_local_layout` scatters the
blocks from rank 0 (which holds the global view) and
:func:`from_local_layout` gathers them back to it.
"""

from __future__ import annotations

import bisect
import functools

import torch

from oceananigans_torch.grids.base import Periodic
from oceananigans_torch.parallel.distributed import (
    TAG_FORWARD, Distributed, block_offsets,
)

__all__ = ["halo_exchange", "halo_exchange_spec", "to_local_layout",
           "from_local_layout"]


def _blocks(a_interior, dist: Distributed, grid):
    """The interior cut into the mesh's blocks, each padded with zero x/y
    halo slots, in rank order."""
    px, py = dist.partition
    Nx, Ny = a_interior.shape[:2]
    Hx, Hy = grid.H[0], grid.H[1]
    nxl, nyl = Nx // px, Ny // py
    out = []
    for rx in range(px):
        for ry in range(py):
            b = a_interior[rx * nxl:(rx + 1) * nxl, ry * nyl:(ry + 1) * nyl]
            p = torch.zeros((nxl + 2 * Hx, nyl + 2 * Hy) + b.shape[2:],
                            dtype=b.dtype, device=b.device)
            p[Hx:Hx + nxl, Hy:Hy + nyl] = b
            out.append(p)
    return out


def to_local_layout(a_interior, dist: Distributed, grid, interior_shape=None):
    """This rank's block of a global interior array given on rank 0 (other
    ranks may pass None and then give ``interior_shape``), with zero x/y
    halo slots: call :func:`halo_exchange` to populate them."""
    px, py = dist.partition
    if dist.rank == 0:
        blocks = _blocks(a_interior, dist, grid)
        like = blocks[0]
    else:
        blocks = None
        Nx, Ny = interior_shape[:2]
        like = torch.empty(
            (Nx // px + 2 * grid.H[0], Ny // py + 2 * grid.H[1])
            + tuple(interior_shape[2:]), dtype=grid.dtype,
            device=dist.device)
    return dist.scatter_blocks(blocks, like.to(dist.device)).to(dist.device)


def from_local_layout(a_local, dist: Distributed, grid, interior_shape):
    """The global interior on rank 0 from every rank's block (None on the
    other ranks)."""
    px, py = dist.partition
    Nx, Ny = interior_shape[:2]
    Hx, Hy = grid.H[0], grid.H[1]
    nxl, nyl = Nx // px, Ny // py
    blocks = dist.gather_blocks(a_local)
    if blocks is None:
        return None
    out = torch.empty(tuple(interior_shape), dtype=a_local.dtype,
                      device=a_local.device)
    for r, b in enumerate(blocks):
        rx, ry = divmod(r, py)
        out[rx * nxl:(rx + 1) * nxl, ry * nyl:(ry + 1) * nyl] = \
            b[Hx:Hx + nxl, Hy:Hy + nyl]
    return out


def _exchange_axis(local, dist: Distributed, axis, h, periodic, sizes):
    """Fill the ``h``-wide halo slots at both ends of mesh ``axis`` of
    ``local`` (the block INCLUDING its halo slots), in place: each halo
    cell takes the cell it images from whichever block owns it
    (:func:`halo_runs`; ``sizes`` are the blocks' extents along ``axis`` in
    coordinate order). Where every block is at least ``h`` wide, that is
    one edge strip from each neighbour. Past a non-periodic edge nothing
    is received and the halo slots are zeroed, as ``ppermute`` leaves a
    device without a source."""
    if h == 0 or dist.size(axis) == 1:
        return local
    return exchange_runs(local, dist, axis,
                         halo_runs(tuple(sizes), h, periodic), "exchange")


def _owner(offsets, g):
    """The block of ``offsets`` (their first cells) that holds cell
    ``g``."""
    return bisect.bisect_right(offsets, g) - 1


def _as_runs(cells):
    """``(dst, dst_index, src, src_index)`` cells merged into runs
    ``(dst, dst_start, src, src_start, length)`` of consecutive indices on
    both sides, in order."""
    runs = []
    for dst, di, src, si in cells:
        if runs:
            d, ds, s_, ss, n = runs[-1]
            if (d, s_) == (dst, src) and ds + n == di and ss + n == si:
                runs[-1] = (d, ds, s_, ss, n + 1)
                continue
        runs.append((dst, di, src, si, 1))
    return tuple(runs)


@functools.lru_cache(maxsize=None)
def halo_runs(sizes, h, periodic):
    """Where every halo cell of an axis cut into blocks of ``sizes`` (a
    halo of ``h`` on either side of each) takes its value: runs ``(dst,
    dst_start, src, src_start, length)``, block coordinates and indices
    into the halo-extended blocks, of the cells whose image is an interior
    cell (the periodic image on a periodic axis). A cell past a wall has
    none: its run has ``src`` None."""
    offsets = block_offsets(sizes)
    N = sum(sizes)
    cells = []
    for dst, (n, off) in enumerate(zip(sizes, offsets)):
        for L in list(range(h)) + list(range(n + h, n + 2 * h)):
            g = off - h + L
            if periodic:
                g %= N
            elif not 0 <= g < N:
                cells.append((dst, L, None, L))
                continue
            src = _owner(offsets, g)
            cells.append((dst, L, src, g - offsets[src] + h))
    return _as_runs(cells)


@functools.lru_cache(maxsize=None)
def ghost_runs(sizes, h, low, high):
    """The second round of a split wall-bounded axis: the halo cells of
    other blocks that image what the edge blocks' wall fills write, global
    cells ``[-h, low)`` of the first block and ``[N, N + high)`` of the
    last (``low`` is 1 where the fill also imposes the wall-face value on
    cell 0); runs as :func:`halo_runs`'s, None when there are none."""
    offsets = block_offsets(sizes)
    N, last = sum(sizes), len(sizes) - 1
    cells = []
    for dst, (n, off) in enumerate(zip(sizes, offsets)):
        for L in list(range(h)) + list(range(n + h, n + 2 * h)):
            g = off - h + L
            if -h <= g < low and dst != 0:
                cells.append((dst, L, 0, g + h))
            elif N <= g < N + high and dst != last:
                cells.append((dst, L, last, g - offsets[last] + h))
    return _as_runs(cells) or None


def _pack(local, axis, parts):
    """The cells ``(start, length)`` of ``parts`` along ``axis``, in order:
    a view where there is one."""
    if len(parts) == 1:
        return local.narrow(axis, *parts[0])
    return torch.cat([local.narrow(axis, s, n) for s, n in parts], dim=axis)


def exchange_runs(local, dist: Distributed, axis, runs, kind):
    """The transfers of ``runs`` (:func:`halo_runs`, :func:`ghost_runs`)
    along mesh ``axis``, in place: one message to and one from each other
    block a run pairs this rank with, the runs between two blocks packed
    in order; runs within this block are copied, and the cells without a
    source zeroed. ``kind`` names the round in the counts (``exchange``,
    ``ghosts``)."""
    me = dist.coords[axis]

    def peer(c):
        coords = list(dist.coords)
        coords[axis] = c
        return dist.rank_of(*coords)

    sends, recvs, zeros = {}, {}, []
    for dst, ds, src, ss, n in runs:
        if dst == me and src is None:
            zeros.append((ds, n))
        elif dst == me and src == me:
            local.narrow(axis, ds, n).copy_(local.narrow(axis, ss, n))
        elif src == me:
            sends.setdefault(dst, []).append((ss, n))
        elif dst == me:
            recvs.setdefault(src, []).append((ds, n))
    dist._count(f"{kind}_{'2d' if local.shape[-1] == 1 else '3d'}")
    send = [(peer(c), _pack(local, axis, parts), TAG_FORWARD)
            for c, parts in sends.items()]
    recv = [(peer(c), local.narrow(axis, 0, sum(n for _, n in parts)),
             TAG_FORWARD) for c, parts in recvs.items()]
    got = dist.p2p(send, recv, key=f"{kind}{axis}.{tuple(local.shape)}")
    for parts, buf in zip(recvs.values(), got):
        at = 0
        for ds, n in parts:
            local.narrow(axis, ds, n).copy_(buf.narrow(axis, at, n))
            at += n
    for ds, n in zeros:
        local.narrow(axis, ds, n).zero_()
    return local


def halo_exchange(a, dist: Distributed, grid, axes=("x", "y")):
    """Fill the x/y halo rings of this rank's local-halos block by
    neighbour exchange, in place; the periodic wrap follows the grid's
    topology."""
    for axis, name in ((0, "x"), (1, "y")):
        if name not in axes:
            continue
        h = grid.H[axis]
        _exchange_axis(a, dist, axis, h, grid.axis_topo(axis) == Periodic,
                       (a.shape[axis] - 2 * h,) * dist.size(axis))
    return a


def halo_exchange_spec(dist: Distributed = None):
    """How :func:`halo_exchange` lays a field over the mesh: x over the
    mesh's first axis, y over its second, z whole on every rank (the JAX
    package's ``P("x", "y", None)``)."""
    return ("x", "y", None)
