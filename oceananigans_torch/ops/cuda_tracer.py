"""The hand-written CUDA kernel of WENO tracer advection of any odd order,
with its plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_tracer.py``
(``weno_tracer_tendencies``, ``_tracer_core``, ``_kernel``): one launch
computes −∇·(𝐯c) for up to :data:`MAX_TRACERS` tracers. The kernel is
``weno_tracer_march`` of ``csrc/vi_tile.h``, an x-marching tile and a
template on the WENO order (3 to 11, one order per translation unit
``csrc/vi_tile_k<K>.cu``) whose coefficients come from
``csrc/weno_tables.h``: each face flux once, one mirrored WENO side, a
block for each pair of tracers.

Both TPU layouts, (x, y, z) and the transposed (z, y, x), exist only for
the TPU's 128 lanes; on the GPU the one kernel works on the port's
(x, y, z) tensors with z contiguous. It computes every point of the
halo-extended tensors, with neighbours wrapped modulo the full extent on
every axis, exactly as the plain version's whole-tensor operators
(``advection.div_Uc``, built on ``torch.roll``) do: the two agree on every
point, halo rows included, where the JAX kernels write zeros into their
output halo rows. The face areas and the volume enter as y-profiles
(:func:`tracer_metric_profiles`), built once by the model: constants on a
regular rectilinear grid, functions of latitude on a lat-lon grid.

``ops/march.py: march_plan`` is the launch plan of this kernel, of the
vector-invariant one (``ops/cuda_vi.py``) and of the other x-marching
tiles: the panel each block owns and the x-segments it marches over; the
kernels refuse a plan that misses an x-row.

The wrapper takes its plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device through its custom operator
(``ops/library.py``, batched by ``torch.func.vmap`` one launch per member,
the metric profiles unbatched; ``weno_tracer_tendencies_op`` takes it on
either device); there is no fallback from one to the other. It counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from oceananigans_torch.advection import WENO, div_Uc
from oceananigans_torch.grids.base import Center, Face, Periodic
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import (
    MAX_TRACERS, check_operands, on_cuda, pointers, sm_count,
)
from oceananigans_torch.ops.library import KernelOp
from oceananigans_torch.ops.march import (  # noqa: F401 (re-exported)
    MAX_THREADS, PANEL_Z, SEGMENT_START, blocks_per_sm, march_plan,
)

#: the WENO orders the kernel is instantiated for
ORDERS = (3, 5, 7, 9, 11)
#: the threads beyond the panel, (rows, columns), that compute the faces on
#: its far side: the vector-invariant kernel's extra column, the tracer
#: kernel's extra row and column
VI_EXTRA = (0, 1)
TRACER_EXTRA = (1, 1)
#: tracers a tracer block marches (``kTG`` in ``csrc/vi_tile.h``)
TRACERS_PER_BLOCK = 2
#: the face areas and the cell volume of the flux divergence, in the order
#: the kernel reads its metric profiles
METRICS = ("ax_fcc", "ay_cfc", "az_cc", "v_ccc")


def tracer_reach(scheme) -> int:
    """Cells each side that the kernel reads: a face reconstruction reads
    offsets -B..B-1 and the divergence takes the faces i and i+1."""
    return (scheme.order + 1) // 2


def axes_reachable(grid, reach) -> bool:
    """Every axis has more than one cell, more cells than ``reach`` (the
    kernels wrap a neighbour by one period at most) and either a halo of
    ``reach[axis]`` or more or no halo on a periodic axis (where the wrap
    is the periodic boundary itself)."""
    return all(
        grid.N[axis] > 1 and grid.shape[axis] > reach[axis]
        and (grid.H[axis] >= reach[axis]
             or (grid.axis_topo(axis) == Periodic and grid.H[axis] == 0))
        for axis in range(3))


def grid_ok(grid) -> bool:
    """The grids of the JAX gates of kernels 11-13: a regular rectilinear
    grid, or a lat-lon grid regular in x and z, whose metrics vary along y
    only (the kernels read them as y-profiles). No orthogonal grid, and no
    immersed grid (an ``ImmersedBoundaryGrid`` is no instance of the grid
    it wraps), whose fields the kernels would read unmasked."""
    from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
    from oceananigans_torch.grids.rectilinear import RectilinearGrid
    return ((isinstance(grid, RectilinearGrid) and grid.regular)
            or (type(grid) is LatitudeLongitudeGrid and grid.z_regular
                and grid.x_regular))


def tracer_fusion_available(grid, scheme) -> bool:
    """True when the kernel applies: a grid of :func:`grid_ok`, plain WENO
    (no bounds, no stretched-axis tables) of an order in :data:`ORDERS`,
    and the reach of :func:`axes_reachable` on every axis. Unlike the JAX
    gate, a halo-free periodic axis needs no (8, 128) alignment and may be
    x."""
    if not grid_ok(grid):
        return False
    if not (type(scheme) is WENO and scheme.bounds is None
            and getattr(scheme, "_tables", None) is None
            and scheme.order in ORDERS):
        return False
    return axes_reachable(grid, (tracer_reach(scheme),) * 3)


def metric_profile(grid, expr):
    """A metric that varies at most along y, as its y-profile over the full
    y extent (taken at the first interior x and z)."""
    full = torch.broadcast_to(expr, grid.shape)
    return full[grid.H[0], :, grid.H[2]]


def tracer_metric_profiles(grid):
    """The (4, ny) profiles of :data:`METRICS`."""
    exprs = (grid.Ax(Face, Center, Center), grid.Ay(Center, Face, Center),
             grid.Az(Center, Center), grid.V(Center, Center, Center))
    return torch.stack([metric_profile(grid, e) for e in exprs]).contiguous()


def weno_tracer_tendencies_plain(grid, scheme, u, v, w, tracers):
    """Plain version of :func:`weno_tracer_tendencies`: −div_Uc per
    tracer."""
    return {n: -div_Uc(grid, scheme, u, v, w, c) for n, c in tracers.items()}


def weno_tracer_tendencies(grid, scheme, u, v, w, tracers, metrics=None):
    """``{name: −∇·(𝐯c)}`` with ``scheme``'s WENO fluxes for each tracer of
    the dict ``tracers``, on every point. ``metrics``: the profiles of
    :func:`tracer_metric_profiles` (built here when not given)."""
    name = "weno_tracer_tendencies"
    if not tracer_fusion_available(grid, scheme):
        raise ValueError(f"{name}: no kernel for {scheme!r} on {grid!r} "
                         "(see tracer_fusion_available)")
    names = list(tracers)
    check_operands(name, (u, v, w, *tracers.values()), grid.shape)
    if not names:
        return {}
    if not on_cuda(u):
        return weno_tracer_tendencies_plain(grid, scheme, u, v, w, tracers)
    if metrics is None:
        metrics = tracer_metric_profiles(grid)
    check_operands(name, (metrics,), (len(METRICS), grid.shape[1]))
    if metrics.device != u.device or metrics.dtype != u.dtype:
        raise ValueError(f"{name}: metrics differ from the fields in device "
                         "or dtype")
    return weno_tracer_tendencies_op(grid, scheme, u, v, w, tracers, metrics)


def _launch_march(fields, state, ints, floats):
    u, v, w, metrics, *cs = fields
    out = [torch.empty_like(u) for _ in cs]
    sms = sm_count(u.device)
    for lo in range(0, len(cs), MAX_TRACERS):
        chunk = cs[lo:lo + MAX_TRACERS]
        c_ptrs, g_ptrs = pointers(chunk), pointers(out[lo:lo + MAX_TRACERS])
        roles = -(-len(chunk) // TRACERS_PER_BLOCK)
        plan = march_plan(u.shape, roles, sms, u.element_size(),
                          TRACER_EXTRA)
        _build.launch("ot_weno_tracer_march", u.dtype, u.device,
                      u.data_ptr(), v.data_ptr(), w.data_ptr(),
                      ctypes.addressof(c_ptrs), ctypes.addressof(g_ptrs),
                      len(chunk), *u.shape, metrics.data_ptr(), ints[0],
                      *plan, *floats)
        weno_tracer_tendencies.launches += 1
    return out


MARCH = KernelOp("weno_tracer_march", _launch_march)


def weno_tracer_tendencies_op(grid, scheme, u, v, w, tracers, metrics=None):
    """:func:`weno_tracer_tendencies` through its operator, on either
    device (the metric profiles are built here when not given)."""
    names = list(tracers)
    if metrics is None:
        metrics = tracer_metric_profiles(grid)

    def plain(f, s):
        out = weno_tracer_tendencies_plain(grid, scheme, *f[:3],
                                           dict(zip(names, f[4:])))
        return [out[n] for n in names]

    out = MARCH(plain, (u, v, w, metrics, *tracers.values()),
                ints=(scheme.order,), floats=(scheme.epsilon,))
    return dict(zip(names, out))


weno_tracer_tendencies.launches = 0

__all__ = ["METRICS", "ORDERS", "grid_ok", "march_plan",
           "tracer_fusion_available", "tracer_metric_profiles",
           "weno_tracer_tendencies", "weno_tracer_tendencies_op",
           "weno_tracer_tendencies_plain"]
