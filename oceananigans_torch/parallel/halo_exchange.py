"""Explicit halo exchange between neighbouring ranks.

Counterpart of ``oceananigans_tpu/parallel/halo_exchange.py``: each rank
sends the edge strips of its block to its mesh neighbours and writes the
strips it receives into its halo slots, a paired ``batch_isend_irecv``
(:meth:`~oceananigans_torch.parallel.distributed.Distributed.p2p`) where
the JAX package has ``jax.lax.ppermute``.

Local-halos layout: each rank's block carries its OWN halo rings (the
layout a kernel consumes), unlike the global layout, where only the domain
edges have halo slots. A rank's block of a global interior ``(Nx, Ny, Nz)``
is ``(Nx/px + 2Hx, Ny/py + 2Hy, Nz)``; :func:`to_local_layout` scatters the
blocks from rank 0 (which holds the global view) and
:func:`from_local_layout` gathers them back to it.
"""

from __future__ import annotations

import torch

from oceananigans_torch.grids.base import Periodic
from oceananigans_torch.parallel.distributed import (
    TAG_BACKWARD, TAG_FORWARD, Distributed,
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


def _exchange_axis(local, dist: Distributed, axis, h, periodic):
    """Exchange ``h``-wide edge strips with the ± neighbours along mesh
    ``axis``, in place. ``local`` is the block INCLUDING its halo slots
    (width ``h`` at each end of ``axis``): its edge interior strips are
    sent and the strips received overwrite the halo slots. Past a
    non-periodic edge nothing is sent or received and the halo slots are
    zeroed, as ``ppermute`` leaves a device without a source."""
    n_shards = dist.size(axis)
    if h == 0 or n_shards == 1:
        return local
    n = local.shape[axis]
    left = dist.neighbour(axis, -1, periodic)
    right = dist.neighbour(axis, +1, periodic)
    # our left edge strip goes to the left neighbour's right halo (data
    # moving backward); our right edge strip to the right neighbour's left
    # halo (data moving forward)
    sends, recvs, where = [], [], []
    halo_lo = local.narrow(axis, 0, h)
    halo_hi = local.narrow(axis, n - h, h)
    if left is not None:
        sends.append((left, local.narrow(axis, h, h), TAG_BACKWARD))
    if right is not None:
        sends.append((right, local.narrow(axis, n - 2 * h, h), TAG_FORWARD))
    if right is not None:
        recvs.append((right, halo_hi, TAG_BACKWARD))
        where.append(halo_hi)
    if left is not None:
        recvs.append((left, halo_lo, TAG_FORWARD))
        where.append(halo_lo)
    dist._count("exchange_2d" if local.shape[-1] == 1 else "exchange_3d")
    got = dist.p2p(sends, recvs, key=f"x{axis}.{tuple(local.shape)}")
    for dst, src in zip(where, got):
        dst.copy_(src)
    if left is None:
        halo_lo.zero_()
    if right is None:
        halo_hi.zero_()
    return local


def halo_exchange(a, dist: Distributed, grid, axes=("x", "y")):
    """Fill the x/y halo rings of this rank's local-halos block by
    neighbour exchange, in place; the periodic wrap follows the grid's
    topology."""
    for axis, name in ((0, "x"), (1, "y")):
        if name not in axes:
            continue
        _exchange_axis(a, dist, axis, grid.H[axis],
                       grid.axis_topo(axis) == Periodic)
    return a


def halo_exchange_spec(dist: Distributed = None):
    """How :func:`halo_exchange` lays a field over the mesh: x over the
    mesh's first axis, y over its second, z whole on every rank (the JAX
    package's ``P("x", "y", None)``)."""
    return ("x", "y", None)
