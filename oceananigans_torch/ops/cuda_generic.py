"""The hand-written CUDA kernel of momentum advection with any scheme, with
its plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_generic.py``
(``fused_momentum_tendency``): (Gu, Gv, Gw) = −∇·(𝐯⊗𝐯) in one pass, with
Centered (orders 2–12), UpwindBiased (1–11) or WENO (3–11) on each axis,
the same scheme on all three or a ``FluxFormAdvection`` of them. The kernel
is ``csrc/generic_momentum.cu``; its coefficients come from
``csrc/linear_tables.h`` and ``csrc/weno_tables.h``.

The contract is the JAX wrapper's: a regular grid, an x halo of at least
``scheme.required_halo``, the metrics of a regular grid as scalars
(:class:`RegularMetricProxy`, Δ = 1 on an axis of one cell), and output
x-halo rows of zeros. The interior x-rows equal the port's
``advection.div_vu/div_vv/div_vw`` on every y and z point: the kernel wraps
its y and z neighbours modulo the full extent, as the plain version's
``torch.roll`` does, and it rounds every operation as the plain version
does on the card (no FMA contraction, the division by V a product with
its reciprocal), so the two agree to the last bit or nearly: float32 WENO
of order 9 or 11 is otherwise ill-conditioned enough that two evaluation
orders differ by ~1e-5 of the largest value. Like the JAX package's
models, the port's models do not call this kernel; it is an entry point of
its own.

The wrapper takes its plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; there is no fallback from one to the
other. It counts its launches in its ``launches`` attribute (one a call).
"""

from __future__ import annotations

from oceananigans_torch.advection import (
    WENO, Centered, FluxFormAdvection, UpwindBiased, _scheme_for, div_vu,
    div_vv, div_vw,
)
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import check_operands, on_cuda
from oceananigans_torch.ops.cuda_tracer import axes_reachable

#: the kernel's scheme kinds; a scheme's code is kind * 16 + order
KINDS = {Centered: 0, UpwindBiased: 1, WENO: 2}


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
    value; the kernel takes one thread per point and does not use it.
    """
    name = "fused_momentum_tendency"
    _check_contract(grid, scheme)
    if not generic_available(grid, scheme):
        raise ValueError(f"{name}: no kernel for {scheme!r} on {grid!r} "
                         "(see generic_available)")
    check_operands(name, (u, v, w), grid.shape)
    if not on_cuda(u):
        return fused_momentum_tendency_plain(grid, scheme, u, v, w)
    if u.numel() >= 2 ** 31:
        raise ValueError(f"{name}: fields of {u.numel()} points exceed the "
                         "kernel's 32-bit indexing")
    schemes = axis_schemes(scheme)
    m = RegularMetricProxy(grid)
    G = [u.new_empty(u.shape) for _ in range(3)]
    _build.launch("ot_generic_momentum", u.dtype, u.device,
                  u.data_ptr(), v.data_ptr(), w.data_ptr(),
                  *(g.data_ptr() for g in G), *u.shape, grid.H[0],
                  *(scheme_code(s) for s in schemes),
                  m.Ax(), m.Ay(), m.Az(), m.V(),
                  *(float(getattr(s, "epsilon", 0.0)) for s in schemes))
    fused_momentum_tendency.launches += 1
    return tuple(G)


fused_momentum_tendency.launches = 0

__all__ = ["KINDS", "RegularMetricProxy", "fused_momentum_tendency",
           "fused_momentum_tendency_plain", "generic_available",
           "scheme_code"]
