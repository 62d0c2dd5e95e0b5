"""The hand-written CUDA kernel of the shallow-water RK3 stage, with its
plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_sw.py``: ``sw_rk3_stage``
(``csrc/shallow_water.cu``) computes the conservative Centered(2)
tendencies with the g·h·∂h gradient and the stage update
``q' = q + a·G + b·G⁻`` for (uh, vh, h) in one pass over the (nx, ny)
plane of a Flat-z grid.

The kernel is an x-marching strip: a block owns :data:`STRIP`
consecutive y and a segment of the output x-rows, which it marches
upward. :func:`stage_plan` sizes the segments from the grid and the card's
SM count, and the wrapper passes that plan to the kernel.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device through its custom operator
(``ops/library.py``, batched by ``torch.func.vmap`` one launch per
member; ``sw_rk3_stage_op`` takes it on either device); there is no
fallback from one to the other. It counts its launches in its
``launches`` attribute. Fields are
halo-extended ``(nx, ny, 1)`` tensors whose halos are filled; outputs cover
the interior x-rows ``[H, nx-H)`` with ``H`` the x halo, and y neighbours
wrap modulo the full extent.
"""

from __future__ import annotations

import torch

from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import (
    check_operands, on_cuda, sm_count,
)
from oceananigans_torch.ops.library import KernelOp

#: x-rows each side that the stencil reads (i-2 .. i+1)
REACH = 2
#: output y a block owns (``kStrip`` in ``csrc/shallow_water.cu``)
STRIP = 512
#: fewest output x-rows of a segment where there are that many: a segment
#: also reads 3 rows beyond its own, ≤ 5% more at 64
MIN_SEGMENT = 64
#: waves of resident blocks a launch aims for
WAVES = 3


def blocks_per_sm(itemsize):
    """Blocks of the kernel resident on one SM: the minimum of its
    ``__launch_bounds__`` (``kMinBlocks``), 4 in float32 and 2 in
    float64."""
    return 4 if itemsize == 4 else 2


def stage_plan(nx, ny, x0, sms, itemsize=4):
    """The kernel's launch plan for an ``(nx, ny)`` plane with x halo
    ``x0`` on a card with ``sms`` SMs: ``(strips, seg_len, nseg)``.

    Block ``(s, g)`` computes output y ``[s·STRIP, (s+1)·STRIP) ∩ [0, ny)``
    on output x-rows ``[x0 + g·seg_len, x0 + (g+1)·seg_len) ∩ [x0,
    nx-x0)``; the plan covers each output point once and leaves no segment
    empty. It aims for :data:`WAVES` waves of resident blocks, with
    segments of at least :data:`MIN_SEGMENT` rows where there are that
    many."""
    rows = nx - 2 * x0
    if rows < 1 or ny < 1 or sms < 1:
        raise ValueError(f"no stage plan for ({nx}, {ny}) with x halo {x0}")
    strips = -(-ny // STRIP)
    target = WAVES * sms * blocks_per_sm(itemsize)
    nseg = max(1, min(-(-target // strips), rows // MIN_SEGMENT))
    seg_len = -(-rows // nseg)
    return strips, seg_len, -(-rows // seg_len)


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
    without a halo; and on a rank's block of a sharded step
    (``model.dist_halo``) a y split over several ranks is never taken
    without a halo, since the kernel would wrap y within the block."""
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
    if any(f is not None for f in model.forcings.values()):
        return False
    for name in ("uh", "vh", "h"):
        for axis in range(2):
            for bc in model.bcs[name].sides(axis):
                if (bc is not None and bc.classification == "flux"
                        and bc.condition is not None):
                    return False
    ctx = getattr(model, "dist_halo", None)
    if ctx is not None and ctx.size(1) > 1 and g.H[1] == 0:
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
    return sw_rk3_stage_op(grid, uh, vh, h, Guh_prev, Gvh_prev, Gh_prev, a, b,
                           gravitational_acceleration)


def _launch_stage(fields, state, ints, floats):
    uh = fields[0]
    news = [torch.empty_like(uh) for _ in range(3)]
    nx, ny, _ = uh.shape
    x0 = ints[0]
    _, seg_len, nseg = stage_plan(nx, ny, x0, sm_count(uh.device),
                                  uh.element_size())
    _build.launch("ot_sw_rk3_stage", uh.dtype, uh.device,
                  *(t.data_ptr() for t in (*fields, *state, *news)), nx, ny,
                  x0, STRIP, seg_len, nseg, *floats)
    sw_rk3_stage.launches += 1
    return news


STAGE = KernelOp("sw_rk3_stage", _launch_stage, mutates=True)


def sw_rk3_stage_op(grid, uh, vh, h, Guh_prev, Gvh_prev, Gh_prev, a, b,
                    gravitational_acceleration):
    """:func:`sw_rk3_stage` through its operator, on either device."""
    news = STAGE(
        lambda f, s: list(sw_rk3_stage_plain(
            grid, *f, *s, a, b, gravitational_acceleration)[:3]),
        (uh, vh, h), (Guh_prev, Gvh_prev, Gh_prev), (grid.H[0],),
        (grid.Nx / grid.Lx, grid.Ny / grid.Ly, gravitational_acceleration,
         a, b))
    return (*news, Guh_prev, Gvh_prev, Gh_prev)


sw_rk3_stage.launches = 0

__all__ = ["STRIP", "stage_plan", "sw_fused_available", "sw_rk3_stage",
           "sw_rk3_stage_op", "sw_rk3_stage_plain"]
