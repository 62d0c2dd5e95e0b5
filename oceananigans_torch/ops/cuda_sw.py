"""The hand-written CUDA kernel of the shallow-water RK3 stage, with its
plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_sw.py``: ``sw_rk3_stage``
(``csrc/shallow_water.cu``) computes the conservative Centered(2)
tendencies with the g·h·∂h gradient and the stage update
``q' = q + a·G + b·G⁻`` for (uh, vh, h) in one pass over the (nx, ny)
plane of a Flat-z grid.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; there is no fallback from one to
the other. It counts its launches in its ``launches`` attribute. Fields are
halo-extended ``(nx, ny, 1)`` tensors whose halos are filled; outputs cover
the interior x-rows ``[H, nx-H)`` with ``H`` the x halo, and y neighbours
wrap modulo the full extent.
"""

from __future__ import annotations

import torch

from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import check_operands, on_cuda

#: x-rows each side that the stencil reads (i-2 .. i+1)
REACH = 2


def sw_fused_available(grid, model) -> bool:
    """True when the stage kernel applies to ``model`` on ``grid``.

    The physics conditions are the JAX gate's: a regular rectilinear grid
    with a Flat z axis, the conservative formulation, Centered(2) momentum
    advection, no Coriolis, no tracers, zero bathymetry, no forcing and no
    flux condition with a value. The TPU's tiling rules (an x halo of
    exactly 8, an 8-divisible interior x extent, a 128-divisible
    halo-free y) do not apply on the GPU. What the kernel needs instead: an
    x halo of at least 2 (the stencil reaches two rows back), more than one
    cell on x and y, and y either with a halo of at least 2 or periodic
    without a halo."""
    from oceananigans_torch.advection import Centered
    from oceananigans_torch.grids.rectilinear import RectilinearGrid
    from oceananigans_torch.models.shallow_water import (
        ConservativeFormulation,
    )
    g = grid
    if not (type(g) is RectilinearGrid and g.regular):
        return False
    if model.formulation != ConservativeFormulation:
        return False
    ma = model.momentum_advection
    if not (type(ma) is Centered and ma.order == 2):
        return False
    if model.coriolis is not None or model.tracer_names:
        return False
    b = model.bathymetry
    if (torch.is_tensor(b) and b.ndim != 0) or float(b) != 0.0:
        return False
    # no forcing: the port's model refuses any (forcings are not ported)
    for name in ("uh", "vh", "h"):
        for axis in range(2):
            for bc in model.bcs[name].sides(axis):
                if (bc is not None and bc.classification == "flux"
                        and bc.condition is not None):
                    return False
    return _layout_ok(g)


def _layout_ok(grid):
    """The layout the kernel takes: a Flat z axis, more than one cell on x
    and y, an x halo of at least 2, and y haloed by at least 2 or periodic
    without a halo."""
    from oceananigans_torch.grids.base import Flat, Periodic
    return (grid.axis_topo(2) == Flat and grid.N[0] > 1 and grid.N[1] > 1
            and grid.H[0] >= REACH
            and (grid.H[1] >= REACH
                 or (grid.axis_topo(1) == Periodic and grid.H[1] == 0)))


def _check_grid(name, grid, uh):
    if not _layout_ok(grid):
        raise ValueError(f"{name}: no kernel for the layout of {grid!r} "
                         "(see sw_fused_available)")
    if tuple(uh.shape) != tuple(grid.shape):
        raise ValueError(f"{name}: fields must be grid-shaped {grid.shape}")


def sw_rk3_stage_plain(grid, uh, vh, h, Guh_prev, Gvh_prev, Gh_prev, a, b,
                       gravitational_acceleration):
    """Plain version of :func:`sw_rk3_stage`: the shallow-water model's own
    conservative tendencies, with the same in-place write of G over G⁻ and
    the same x-rows."""
    from oceananigans_torch.advection import Centered
    from oceananigans_torch.models.shallow_water import (
        conservative_tendencies,
    )
    gs = conservative_tendencies(grid, float(gravitational_acceleration),
                                 Centered(2), uh, vh, h)
    H = grid.H[0]
    rows = slice(H, grid.shape[0] - H)
    news = []
    for q, g, gm in zip((uh, vh, h), gs, (Guh_prev, Gvh_prev, Gh_prev)):
        qn = q.clone()
        qn[rows] = q[rows] + a * g[rows] + b * gm[rows]
        gm[rows] = g[rows]
        news.append(qn)
    return (*news, Guh_prev, Gvh_prev, Gh_prev)


def sw_rk3_stage(grid, uh, vh, h, Guh_prev, Gvh_prev, Gh_prev, a, b,
                 gravitational_acceleration):
    """One fused shallow-water RK3 stage.

    Inputs are halo-extended ``(nx, ny, 1)`` fields with their halos
    filled. Returns ``(uh', vh', h', Guh, Gvh, Gh)`` with
    ``q' = q + a·G + b·G⁻`` on the interior x-rows. Guh, Gvh, Gh are
    written over the G⁻ tensors in place, as the JAX kernel aliases them,
    so their x-halo rows keep the previous values; uh', vh', h' are new
    tensors (neighbouring points still read the old ones) whose x-halo rows
    are copies of the inputs', where the JAX kernel leaves them unwritten.
    """
    name = "sw_rk3_stage"
    _check_grid(name, grid, uh)
    check_operands(name, (uh, vh, h, Guh_prev, Gvh_prev, Gh_prev),
                   grid.shape)
    if not on_cuda(uh):
        return sw_rk3_stage_plain(grid, uh, vh, h, Guh_prev, Gvh_prev,
                                  Gh_prev, a, b, gravitational_acceleration)
    news = tuple(torch.empty_like(uh) for _ in range(3))
    nx, ny, _ = uh.shape
    _build.launch("ot_sw_rk3_stage", uh.dtype, uh.device,
                  uh.data_ptr(), vh.data_ptr(), h.data_ptr(),
                  Guh_prev.data_ptr(), Gvh_prev.data_ptr(), Gh_prev.data_ptr(),
                  *(q.data_ptr() for q in news), nx, ny, grid.H[0],
                  float(grid.Nx / grid.Lx), float(grid.Ny / grid.Ly),
                  float(gravitational_acceleration), float(a), float(b))
    sw_rk3_stage.launches += 1
    return (*news, Guh_prev, Gvh_prev, Gh_prev)


sw_rk3_stage.launches = 0

__all__ = ["sw_fused_available", "sw_rk3_stage", "sw_rk3_stage_plain"]
