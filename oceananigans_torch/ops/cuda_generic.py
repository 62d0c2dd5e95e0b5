"""The hand-written CUDA kernel of momentum advection with any scheme, with
its plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_generic.py``
(``fused_momentum_tendency``): (Gu, Gv, Gw) = −∇·(𝐯⊗𝐯) in one pass, with
Centered (orders 2–12), UpwindBiased (1–11) or WENO (3–11) on each axis,
the same scheme on all three or a ``FluxFormAdvection`` of them. The kernel
is the x-marching tile ``generic_march`` of ``csrc/generic_tile.h`` (entry
points in ``csrc/generic_momentum.cu``), a template on the scheme when one
serves all three axes and on the largest reach for a ``FluxFormAdvection``
of different schemes; its coefficients come from ``csrc/linear_tables.h``
and ``csrc/weno_tables.h``. :func:`momentum_plan` is its launch plan: the
panel each block owns and the x-segments it marches over.

The contract is the JAX wrapper's: a regular grid, an x halo of at least
``scheme.required_halo``, the metrics of a regular grid as scalars
(:class:`RegularMetricProxy`, Δ = 1 on an axis of one cell), and output
x-halo rows of zeros. The interior x-rows equal the port's
``advection.div_vu/div_vv/div_vw`` on every y and z point, to rounding:
the kernel wraps its y and z neighbours modulo the full extent, as the
plain version's ``torch.roll`` does, but it evaluates one mirrored side of
each biased reconstruction, forms the WENO weights with reciprocals, and
contracts products and sums, so it is not bit for bit its plain version
(float32 WENO of order 9 or 11 is ill-conditioned enough that two
evaluation orders differ by ~1e-5 of the largest value; the kernel forms
the indicators of orders 7 and up in the plain version's order). Like the
JAX package's models, the port's models do not call this kernel; it is an
entry point of its own.

The wrapper takes its plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device through its custom operator
(``ops/library.py``, batched by ``torch.func.vmap`` one launch per member;
``fused_momentum_tendency_op`` takes it on either device); there is no
fallback from one to the other. It counts its launches in its
``launches`` attribute (one a call, one a member under ``vmap``).
"""

from __future__ import annotations

from oceananigans_torch.advection import (
    WENO, Centered, FluxFormAdvection, UpwindBiased, _scheme_for, div_vu,
    div_vv, div_vw,
)
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import (
    check_operands, on_cuda, sm_count,
)
from oceananigans_torch.ops.cuda_tracer import axes_reachable
from oceananigans_torch.ops.library import KernelOp
from oceananigans_torch.ops.march import march_plan

#: the kernel's scheme kinds; a scheme's code is kind * 16 + order
KINDS = {Centered: 0, UpwindBiased: 1, WENO: 2}
#: ring planes of the tile (``kSlots`` in ``csrc/generic_tile.h``)
TILE_SLOTS = 6


class RegularMetricProxy:
    """The scalar metrics of a regular grid (Δ = 1 on an axis of one cell),
    as the JAX wrapper's ``_RegularMetricProxy`` gives them to the
    advection code."""

    def __init__(self, g):
        self._dx = g.Lx / g.Nx if g.N[0] > 1 else 1.0
        self._dy = g.Ly / g.Ny if g.N[1] > 1 else 1.0
        self._dz = g.Lz / g.Nz if g.N[2] > 1 else 1.0

    def dx(self, *a):
        return self._dx

    def dy(self, *a):
        return self._dy

    def dz(self, *a):
        return self._dz

    def Ax(self, *a):
        return self._dy * self._dz

    def Ay(self, *a):
        return self._dx * self._dz

    def Az(self, *a):
        return self._dx * self._dy

    def V(self, *a):
        return self._dx * self._dy * self._dz


def axis_schemes(scheme):
    """The schemes that reconstruct along x, y and z."""
    return tuple(_scheme_for(scheme, axis) for axis in range(3))


def scheme_code(s):
    """The kernel's code of a scheme, or None for a type it does not take
    (the type must be exact: no subclass)."""
    kind = KINDS.get(type(s))
    if kind is None or getattr(s, "bounds", None) is not None:
        return None
    return kind * 16 + s.order


def reach(schemes):
    """The largest reach of the axis schemes: it sizes the tile's y/z halo,
    ring and x-queues."""
    return max(s.required_halo for s in schemes)


def blocks_per_sm(schemes, itemsize):
    """Blocks of the tile resident on one SM, as its ``__launch_bounds__``
    (``kBlocksPerSm`` in ``csrc/generic_tile.h``) ask: in float32 two for
    one scheme on all axes (one code) that is WENO of order 7 and up or
    linear of reach 5 and up, and for different schemes of reach 4 and up,
    else three; in float64 one."""
    if itemsize != 4:
        return 1
    if len({scheme_code(s) for s in schemes}) == 1:
        s = schemes[0]
        heavy = (s.required_halo >= 5
                 or (type(s) is WENO and s.order >= 7))
    else:
        heavy = reach(schemes) >= 4
    return 2 if heavy else 3


def momentum_plan(shape, h, schemes, sms, itemsize=4):
    """The tile's launch plan ``(py, pz, seg_len, nseg)`` for ``(nx, ny,
    nz)`` fields with x halo ``h`` and the axis ``schemes``, on a card with
    ``sms`` SMs: ``march.march_plan`` for the ``nx - 2h`` output x-rows
    ``[h, nx-h)`` (segment ``s`` covers rows ``[h + s·seg_len, h +
    (s+1)·seg_len) ∩ [h, nx-h)``), with an extra row and column of threads
    for the panel's far faces."""
    nx, ny, nz = shape
    return march_plan((nx - 2 * h, int(ny), int(nz)), 1, sms, itemsize,
                      (1, 1), blocks_per_sm(schemes, itemsize))


def tile_smem_bytes(B, py, pz, itemsize):
    """The dynamic shared memory of one block of the tile of largest reach
    ``B`` for a ``py × pz`` panel (``tile_bytes`` in
    ``csrc/generic_tile.h``): the row offsets, the ring of u, v and w
    tiles with a B-wide halo, twelve face arrays (three y and three z, by
    the step's parity), the column offsets and the offsets and indices of
    the halo, the (2B - 1)(pz + 2B + py + 1) values of a field's tile that
    no thread owns."""
    tr, tc, nt = py + 2 * B, pz + 2 * B, (py + 1) * (pz + 1)
    halo = (2 * B - 1) * (tc + py + 1)
    return (8 * tr + (TILE_SLOTS * 3 * tr * tc + 12 * nt) * itemsize
            + 4 * (tc + 6 * halo))


def _check_contract(grid, scheme):
    """The JAX wrapper's ``ValueError``s."""
    if not grid.regular:
        raise ValueError("fused_momentum_tendency needs a regular grid")
    if grid.H[0] < scheme.required_halo:
        raise ValueError("axis-0 halo smaller than the scheme stencil")


def generic_available(grid, scheme) -> bool:
    """True when the kernel applies: a regular rectilinear grid; a
    Centered, UpwindBiased or WENO scheme (or a FluxFormAdvection of them)
    on every axis; an x halo of at least ``scheme.required_halo``; and on
    every axis more than one cell, more cells than that axis's reach and a
    halo of the reach or none on a periodic axis
    (``cuda_tracer.axes_reachable``)."""
    from oceananigans_torch.grids.rectilinear import RectilinearGrid
    if not (isinstance(grid, RectilinearGrid) and grid.regular):
        return False
    if not isinstance(scheme, (Centered, UpwindBiased, WENO,
                               FluxFormAdvection)):
        return False
    schemes = axis_schemes(scheme)
    if any(scheme_code(s) is None for s in schemes):
        return False
    if grid.H[0] < scheme.required_halo:
        return False
    return axes_reachable(grid, tuple(s.required_halo for s in schemes))


def fused_momentum_tendency_plain(grid, scheme, u, v, w):
    """Plain version of :func:`fused_momentum_tendency`: −div_vu, −div_vv
    and −div_vw with the scalar metrics of :class:`RegularMetricProxy`, the
    x-halo rows set to zero."""
    _check_contract(grid, scheme)
    pgrid = RegularMetricProxy(grid)
    H = grid.H[0]
    out = []
    for div in (div_vu, div_vv, div_vw):
        G = -div(pgrid, scheme, u, v, w)
        G[:H] = 0.0
        G[G.shape[0] - H:] = 0.0
        out.append(G)
    return tuple(out)


def fused_momentum_tendency(grid, scheme, u, v, w, tile_x=1):
    """(Gu, Gv, Gw) = −∇·(𝐯⊗𝐯) with ``scheme`` on a regular grid, in one
    launch. Inputs are halo-extended with halos filled; output x-halo rows
    are zero.

    Raises ``ValueError`` where the JAX wrapper does (a grid that is not
    regular, an x halo smaller than ``scheme.required_halo``) and, on both
    devices, where :func:`generic_available` refuses a layout or scheme the
    JAX wrapper would take (a Flat or one-cell axis, a y or z halo short of
    the reach). ``tile_x`` is the JAX wrapper's x tile, which changes no
    value; the kernel's segments come from :func:`momentum_plan`.
    """
    name = "fused_momentum_tendency"
    _check_contract(grid, scheme)
    if not generic_available(grid, scheme):
        raise ValueError(f"{name}: no kernel for {scheme!r} on {grid!r} "
                         "(see generic_available)")
    check_operands(name, (u, v, w), grid.shape)
    if not on_cuda(u):
        return fused_momentum_tendency_plain(grid, scheme, u, v, w)
    if u.shape[1] * u.shape[2] >= 2 ** 31:
        raise ValueError(f"{name}: x-planes of {u.shape[1] * u.shape[2]} "
                         "points exceed the kernel's 32-bit plane offsets")
    return fused_momentum_tendency_op(grid, scheme, u, v, w)


def _launch_generic(fields, state, ints, floats):
    u, v, w = fields
    h, *codes, bps = ints
    G = [u.new_empty(u.shape) for _ in range(3)]
    nx, ny, nz = u.shape
    # momentum_plan, with the schemes' blocks per SM passed as ``bps``
    plan = march_plan((nx - 2 * h, ny, nz), 1, sm_count(u.device),
                      u.element_size(), (1, 1), bps)
    _build.launch("ot_generic_momentum", u.dtype, u.device,
                  *(t.data_ptr() for t in (u, v, w, *G)), *u.shape, h,
                  *codes, *floats, *plan)
    fused_momentum_tendency.launches += 1
    return G


MOMENTUM = KernelOp("generic_momentum", _launch_generic)


def fused_momentum_tendency_op(grid, scheme, u, v, w):
    """:func:`fused_momentum_tendency` through its operator, on either
    device."""
    schemes = axis_schemes(scheme)
    m = RegularMetricProxy(grid)
    return tuple(MOMENTUM(
        lambda f, s: list(fused_momentum_tendency_plain(grid, scheme, *f)),
        (u, v, w),
        ints=(grid.H[0], *(scheme_code(s) for s in schemes),
              blocks_per_sm(schemes, u.element_size())),
        floats=(m.Ax(), m.Ay(), m.Az(), m.V(),
                *(getattr(s, "epsilon", 0.0) for s in schemes))))


fused_momentum_tendency.launches = 0

__all__ = ["KINDS", "RegularMetricProxy", "fused_momentum_tendency",
           "fused_momentum_tendency_op", "fused_momentum_tendency_plain",
           "generic_available",
           "momentum_plan", "scheme_code", "tile_smem_bytes"]
