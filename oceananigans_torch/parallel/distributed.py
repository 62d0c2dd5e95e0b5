"""Ranks, the mesh of ranks, and the transport between them.

Counterpart of ``oceananigans_tpu/parallel/distributed.py``. The JAX
package runs SPMD over a ``jax.sharding.Mesh`` with axes ``("x", "y")``;
here one process is one rank of a ``torch.distributed`` process group (the
launcher, :mod:`~oceananigans_torch.parallel.launch`, starts them), and a
:class:`Distributed` object maps its rank to mesh coordinates ``(rx, ry)``
(row-major, as the JAX mesh's ``reshape(px, py)``: rank = rx·py + ry) and
carries the collectives the distributed step uses:

- ``jax.lax.ppermute`` of edge strips -> :meth:`Distributed.p2p`, a paired
  ``batch_isend_irecv``;
- ``psum`` -> :meth:`Distributed.all_reduce`;
- a gather of disjoint parts into one array on every rank (the tripolar
  fold's rows) -> :meth:`Distributed.merge_disjoint`, an ``all_reduce`` of
  the floats' bits;
- the pencil ``all_to_all`` -> :meth:`Distributed.all_to_all`, an
  ``all_to_all_single`` over the ranks of one mesh row or column on
  contiguous packed buffers;
- ``jax.lax.axis_index`` -> :attr:`Distributed.coords`, Python ints.

The backend is the process group's, chosen by whoever started the ranks:
"nccl" (one GPU a rank) or "gloo". Gloo takes CUDA tensors in
``all_reduce`` and ``all_to_all_single``, but a point-to-point send of a
CUDA tensor aborts the process ("writev ... Bad address", torch 2.x on an
H100), so under gloo on CUDA the point-to-point strips are copied through
reused pinned host buffers: only halo strips and blocks cross the host.
Nothing picks a backend or a device by looking at the machine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as tdist

from oceananigans_torch.config import config

__all__ = ["Partition", "Distributed", "block_sizes", "shard_state",
           "sharded_step_fn"]

#: p2p tags: a strip moving to the lower or to the higher coordinate
TAG_BACKWARD, TAG_FORWARD = 0, 1
#: the integer type of a float's bits (:meth:`Distributed.merge_disjoint`)
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


@dataclasses.dataclass(frozen=True)
class Partition:
    """Domain decomposition: ``x``/``y`` ranks a direction; None fills with
    the remaining ranks (the reference's ``Equal``)."""
    x: Optional[int] = None
    y: Optional[int] = 1

    def resolve(self, n_devices: int):
        x, y = self.x, self.y
        if x is None and y is None:
            x = int(math.floor(math.sqrt(n_devices)))
            while n_devices % x:
                x -= 1
            y = n_devices // x
        elif x is None:
            x = n_devices // y
        elif y is None:
            y = n_devices // x
        if x * y != n_devices:
            raise ValueError(f"Partition({x}, {y}) != {n_devices} devices")
        return x, y


class Distributed:
    """This rank's place in the ``(px, py)`` mesh of the initialised
    default process group, and the collectives over it. ``device`` is where
    the rank's fields live (default ``config.device``); under NCCL it must
    be a CUDA device. Every rank builds its ``Distributed`` at the same
    point (the row and column groups are created collectively)."""

    def __init__(self, partition: Partition = None, device=None):
        if not tdist.is_initialized():
            raise RuntimeError(
                "Distributed needs an initialised torch.distributed process "
                "group; start the ranks with oceananigans_torch.parallel."
                "launch")
        self.backend = tdist.get_backend()
        self.rank = tdist.get_rank()
        self.world_size = tdist.get_world_size()
        px, py = (partition or Partition()).resolve(self.world_size)
        self.partition = (px, py)
        self.coords = divmod(self.rank, py)
        self.device = torch.device(config.device if device is None
                                   else device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not "
                             f"{self.device}")
        # the ranks of each mesh row (fixed ry: the "x" axis) and column
        # (fixed rx: the "y" axis), in coordinate order; new_group is
        # collective, so every rank creates every group
        self._groups = {}
        for axis in (0, 1):
            if self.partition[axis] == 1:
                continue
            for other in range(self.partition[1 - axis]):
                ranks = [self.rank_of(*((i, other) if axis == 0
                                        else (other, i)))
                         for i in range(self.partition[axis])]
                group = tdist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = (group, ranks)
        self._host = {}
        #: point-to-point strips copy through pinned host buffers (gloo
        #: sends no CUDA tensor)
        self.stage_p2p = (self.backend == "gloo"
                          and self.device.type == "cuda")
        #: collective calls by kind since the last :meth:`reset_counts`
        self.counts = {}

    # ---- the mesh ----------------------------------------------------------
    def rank_of(self, rx, ry):
        return rx * self.partition[1] + ry

    def size(self, axis):
        return self.partition[axis]

    def neighbour(self, axis, step, periodic):
        """The rank ``step`` (±1) along ``axis``, or None past a
        non-periodic edge."""
        n = self.partition[axis]
        i = self.coords[axis] + step
        if not periodic and not 0 <= i < n:
            return None
        c = list(self.coords)
        c[axis] = i % n
        return self.rank_of(*c)

    def validate_grid(self, grid):
        px, py = self.partition
        for axis, parts in ((0, px), (1, py)):
            if grid.shape[axis] % parts:
                raise ValueError(
                    f"halo-extended size {grid.shape[axis]} on axis {axis} "
                    f"not divisible by {parts} mesh ranks; choose N so that "
                    f"N + 2H is a multiple of the partition")

    # ---- transport -----------------------------------------------------------
    def _count(self, kind):
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def reset_counts(self):
        self.counts = {}

    def _buffer(self, key, like):
        """A reused pinned host buffer shaped and typed like ``like``."""
        k = (key, tuple(like.shape), like.dtype)
        buf = self._host.get(k)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[k] = buf
        return buf

    def _out(self, t, key):
        """``t`` as a send takes it: itself, or a pinned host copy."""
        if not self.stage_p2p or t.device.type == "cpu":
            return t.contiguous()
        buf = self._buffer(key, t)
        buf.copy_(t)
        return buf

    def _in(self, like, key):
        """A receive buffer for a tensor like ``like``."""
        if not self.stage_p2p or like.device.type == "cpu":
            return torch.empty(like.shape, dtype=like.dtype,
                               device=like.device)
        return self._buffer(key, like)

    def p2p(self, sends, recvs, key=""):
        """Paired point-to-point transfers: ``sends`` of ``(peer, tensor,
        tag)`` and ``recvs`` of ``(peer, like, tag)``; returns the received
        tensors, on ``like``'s device, in the order of ``recvs``."""
        self._count("p2p")
        ops, outs = [], []
        for i, (peer, t, tag) in enumerate(sends):
            ops.append(tdist.P2POp(tdist.isend,
                                   self._out(t, f"{key}s{i}"),
                                   peer, tag=tag))
        for i, (peer, like, tag) in enumerate(recvs):
            buf = self._in(like, f"{key}r{i}")
            outs.append((buf, like))
            ops.append(tdist.P2POp(tdist.irecv, buf, peer, tag=tag))
        if ops:
            for req in tdist.batch_isend_irecv(ops):
                req.wait()
        return [buf if buf.device == like.device
                else buf.to(like.device, non_blocking=False)
                for buf, like in outs]

    def all_reduce(self, t, op=tdist.ReduceOp.SUM):
        """``t`` reduced over every rank (a new tensor on ``t``'s device;
        ``t`` itself when there is one rank)."""
        if self.world_size == 1:
            return t
        self._count("all_reduce")
        out = t.detach().clone()
        tdist.all_reduce(out, op=op)
        return out

    def merge_disjoint(self, t, kind):
        """Every rank's ``t`` merged in place, each rank having written the
        cells it owns into zeros: an all-reduce that sums the integers of
        the floats' bits, so that each cell keeps its owner's value bit for
        bit (a −0.0 too). Counted as ``kind``."""
        self._count(kind)
        if self.world_size > 1:
            tdist.all_reduce(t.view(_BITS[t.dtype]))
        return t

    def all_to_all(self, t, axis, split_axis, concat_axis, split_sizes=None,
                   concat_sizes=None):
        """The tiled ``jax.lax.all_to_all`` over the ranks of mesh ``axis``:
        ``t`` is cut along ``split_axis`` into chunks of ``split_sizes``
        (one a rank of the group, equal by default), chunk i goes to the
        rank at coordinate i, and the chunks received are joined along
        ``concat_axis`` in the senders' order; ``concat_sizes`` are the
        senders' extents along ``concat_axis`` (each this rank's by
        default), through ``all_to_all_single``'s split sizes."""
        n = self.partition[axis]
        if n == 1:
            return t
        self._count("all_to_all")
        group, _ = self._groups[axis]
        me = self.coords[axis]
        if split_sizes is None:
            split_sizes = [t.shape[split_axis] // n] * n
        if concat_sizes is None:
            concat_sizes = [t.shape[concat_axis]] * n
        chunks = torch.split(t, list(split_sizes), dim=split_axis)
        send = torch.cat([c.reshape(-1) for c in chunks])
        shapes = []
        for size in concat_sizes:
            shape = list(t.shape)
            shape[split_axis] = split_sizes[me]
            shape[concat_axis] = size
            shapes.append(shape)
        counts = [math.prod(s) for s in shapes]
        recv = torch.empty(sum(counts), dtype=t.dtype, device=t.device)
        tdist.all_to_all_single(
            recv, send, output_split_sizes=counts,
            input_split_sizes=[c.numel() for c in chunks], group=group)
        return torch.cat([piece.reshape(shape) for piece, shape in
                          zip(recv.split(counts), shapes)], dim=concat_axis)

    def gather_blocks(self, block, root=0, shapes=None):
        """Every rank's ``block``, in rank order, on ``root`` (on
        ``block``'s device); None elsewhere. ``shapes`` gives each rank's
        block shape where they differ (default: all ``block``'s)."""
        if self.world_size == 1:
            return [block]
        self._count("gather")
        if self.rank != root:
            self.p2p([(root, block, TAG_FORWARD)], [], key="g")
            return None
        likes = [block if shapes is None or tuple(shapes[r]) == tuple(
            block.shape) else block.new_empty(shapes[r])
            for r in range(self.world_size)]
        got = self.p2p([], [(r, likes[r], TAG_FORWARD)
                            for r in range(self.world_size) if r != root],
                       key="g")
        got.insert(root, block.contiguous())
        return got

    def scatter_blocks(self, blocks, like, root=0):
        """This rank's entry of ``blocks`` (a list in rank order, given on
        ``root``; the blocks may differ in shape), as a tensor like
        ``like``, this rank's own block's shape."""
        if self.world_size == 1:
            return blocks[0]
        self._count("scatter")
        if self.rank == root:
            self.p2p([(r, blocks[r], TAG_BACKWARD)
                      for r in range(self.world_size) if r != root], [],
                     key="sc")
            return blocks[root].to(like.device)
        return self.p2p([], [(root, like, TAG_BACKWARD)], key="sc")[0]

    def broadcast_object(self, obj, root=0):
        """A picklable object from ``root`` on every rank."""
        if self.world_size == 1:
            return obj
        box = [obj]
        tdist.broadcast_object_list(box, src=root,
                                    device=(self.device
                                            if self.backend == "nccl"
                                            else None))
        return box[0]

    def barrier(self):
        if self.world_size > 1:
            if self.backend == "nccl":
                tdist.barrier(device_ids=[self.device.index or 0])
            else:
                tdist.barrier()

    def __repr__(self):
        return (f"Distributed(partition={self.partition}, rank={self.rank}, "
                f"coords={self.coords}, backend={self.backend!r}, "
                f"device={self.device})")


def shard_state(dist: Distributed, state):
    """This rank's even slab of every 3-D field of a global-layout state
    (the halo-extended array cut into ``(px, py)`` equal blocks, as the JAX
    package's ``P("x", "y", None)`` sharding lays it out); other members
    are kept as they are. ``dist.validate_grid`` says when the cut is
    even."""
    px, py = dist.partition
    rx, ry = dist.coords

    def place(a):
        if not (isinstance(a, torch.Tensor) and a.ndim == 3):
            return a
        bx, by = a.shape[0] // px, a.shape[1] // py
        return a[rx * bx:(rx + 1) * bx, ry * by:(ry + 1) * by].to(
            dist.device)

    return _map_tensors(state, place)


def _map_tensors(state, f):
    """``state`` (a dataclass, dict or tensor) with ``f`` applied to every
    tensor member, nested dataclasses and dicts included."""
    if isinstance(state, torch.Tensor):
        return f(state)
    if isinstance(state, dict):
        return {k: _map_tensors(v, f) for k, v in state.items()}
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            fl.name: _map_tensors(getattr(state, fl.name), f)
            for fl in dataclasses.fields(state)
            if fl.init and getattr(state, fl.name) is not None})
    return state


def block_sizes(n, parts):
    """``n`` cells over ``parts`` ranks in blocks that differ by at most
    one cell, the larger first (26 over 4: 7, 7, 6, 6)."""
    q, r = divmod(int(n), int(parts))
    return [q + (1 if i < r else 0) for i in range(parts)]


def block_offsets(sizes):
    """The first cell of each block of ``sizes``."""
    out, o = [], 0
    for n in sizes:
        out.append(o)
        o += n
    return out


def sharded_step_fn(model, dist: Distributed, dt, make_model=None):
    """A step ``global_state -> global_state`` over the mesh, the
    counterpart of the JAX package's GSPMD step. PyTorch has no compiler
    that partitions a step, so this is :class:`~oceananigans_torch.
    parallel.shard_step.DistributedStep` (built with ``gspmd=True``)
    between a scatter of the global state from rank 0 and a gather back to
    it (None on the other ranks). ``make_model(grid)`` builds the model on
    a grid (default: the model itself on its grid, and on a rank's grid
    the model's class with the constructor arguments it recorded, each
    horizontal field among them cut to the rank's block).

    It takes the nonhydrostatic, hydrostatic and shallow-water models on a
    ``RectilinearGrid``, ``LatitudeLongitudeGrid``,
    ``OrthogonalSphericalShellGrid`` (a ``TripolarGrid``'s north fold
    across the ranks that hold its mirror columns, a
    ``RotatedLatitudeLongitudeGrid``) or ``ImmersedBoundaryGrid``, with
    forcings, callable or array boundary conditions, background fields
    and particles (replicated on every rank, as the GSPMD path keeps
    them), any interior whose halo-extended size divides the mesh (blocks
    that differ by one cell, of any width: a block narrower than its halo
    too), split axes with a halo and split periodic axes without one. A
    split Bounded axis without a halo raises ``ValueError`` (the serial
    operators wrap across its walls, which no halo cell of a block
    holds)."""
    from oceananigans_torch.parallel.shard_step import DistributedStep

    dist.validate_grid(model.grid)
    dstep = DistributedStep(make_model, model.grid, dist, gspmd=True,
                            model=model)

    def step(global_state):
        local = dstep.to_local_state(global_state)
        local = dstep.step(local, dt)
        return dstep.from_local_state(local)

    step.dstep = dstep
    return step
