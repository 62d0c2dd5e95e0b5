"""Hand-written CUDA kernels of the WENO-5 path, with their plain PyTorch
versions.

Counterpart of ``oceananigans_tpu/ops/pallas_weno.py``; its four kernels:

- ``weno5_ab2_update`` (``csrc/weno5_science_tile.cu``): the WENO-5
  momentum tendency fused with the quasi-AB2 update, the AB2 path of pure
  momentum advection: the science step's momentum blocks alone, without
  Coriolis, buoyancy or tracers;
- ``weno5_momentum_tendency`` (``csrc/weno5_tile.cu``): the momentum
  tendency alone (RK3, and AB2 where no fused kernel applies);
- ``weno5_science_ab2_update`` (``csrc/weno5_science_tile.cu``): momentum,
  f-plane Coriolis, the buoyancy of a BuoyancyTracer, the advection of up
  to :data:`MAX_TRACERS` tracers and the AB2 update of every prognostic
  field, in one pass;
- ``weno5_tracer_tendencies`` (``csrc/weno5_science_tile.cu``): -∇·(𝐯c) of
  any number of tracers, one launch for every :data:`MAX_TRACERS` of them.

All four are x-marching tiles (``csrc/weno5_tile.h``) that compute each
face flux once.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; there is no fallback from one to
the other. On the card it calls its kernel's custom operator
(``ops/library.py``, batched by ``torch.func.vmap`` one launch per member);
its ``*_op`` function takes that operator on either device. Each counts
its kernel launches in its ``launches`` attribute.
Fields are halo-extended ``(nx, ny, nz)`` tensors whose halos are filled;
outputs cover x-rows ``[3, nx-3)``, and y/z neighbours wrap modulo the
full extent. The plain versions are the port's own whole-tensor operators
(``advection.div_vu/div_vv/div_vw/div_Uc`` with ``WENO(5)``, the
``coriolis.FPlane`` and ``buoyancy.BuoyancyForce`` terms), cropped to those
rows.
"""

from __future__ import annotations

import ctypes

import torch

from oceananigans_torch.advection import (
    WENO, div_Uc, div_vu, div_vv, div_vw,
)
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import (
    MAX_TRACERS, ab2_rows, check_operands, on_cuda, pointers,
    science_ab2_plain, science_op, science_operands,
)
from oceananigans_torch.ops.library import KernelOp

#: rows each side that a WENO-5 stencil reads
H = 3


def weno5_available(grid, advection) -> bool:
    """True when the kernels apply: a regular rectilinear grid, WENO(5)
    advection without bounds, every axis with more than one cell, a halo of
    at least 3 on x (outputs cover x-rows [3, nx-3)), and each of y and z
    either with a halo of at least 3 or periodic without a halo. The TPU's
    (8, 128) alignment rules do not apply on the GPU."""
    from oceananigans_torch.grids.base import Periodic
    from oceananigans_torch.grids.rectilinear import RectilinearGrid
    if not (isinstance(grid, RectilinearGrid) and grid.regular):
        return False
    if not (type(advection) is WENO and advection.order == 5
            and advection.bounds is None):
        return False
    if not all(n > 1 for n in grid.N) or grid.H[0] < H:
        return False
    return all(grid.H[axis] >= H
               or (grid.axis_topo(axis) == Periodic and grid.H[axis] == 0)
               for axis in (1, 2))


def _inv_spacings(grid):
    return tuple(float(n / L) for n, L in zip(grid.N,
                                             (grid.Lx, grid.Ly, grid.Lz)))


def _check_grid(name, grid, u):
    if not weno5_available(grid, WENO(5)):
        raise ValueError(f"{name}: no kernel for the layout of {grid!r} "
                         "(see weno5_available)")
    if tuple(u.shape) != tuple(grid.shape):
        raise ValueError(f"{name}: fields must be grid-shaped {grid.shape}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _momentum_plain(grid, u, v, w, epsilon):
    """[Gu, Gv, Gw] on x-rows [3, nx-3) from the whole-tensor WENO(5)
    operators."""
    sch = WENO(5, epsilon=epsilon)
    return [-div(grid, sch, u, v, w)[H:-H] for div in (div_vu, div_vv,
                                                       div_vw)]


def _tracers_plain(grid, u, v, w, tracers, epsilon):
    sch = WENO(5, epsilon=epsilon)
    return [-div_Uc(grid, sch, u, v, w, c)[H:-H] for c in tracers]


def _embed(g, like):
    full = torch.zeros_like(like)
    full[H:-H] = g
    return full


def weno5_momentum_tendency_plain(grid, u, v, w, epsilon=1e-8):
    """Plain version of :func:`weno5_momentum_tendency`."""
    return tuple(_embed(g, u) for g in _momentum_plain(grid, u, v, w,
                                                       epsilon))


def weno5_tracer_tendencies_plain(grid, u, v, w, tracers, epsilon=1e-8):
    """Plain version of :func:`weno5_tracer_tendencies`."""
    names = list(tracers)
    gs = _tracers_plain(grid, u, v, w, [tracers[n] for n in names], epsilon)
    return {n: _embed(g, u) for n, g in zip(names, gs)}


def weno5_ab2_update_plain(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a, b,
                           epsilon=1e-8):
    """Plain version of :func:`weno5_ab2_update`, with the same in-place
    write of G over G_prev."""
    news = ab2_rows((u, v, w), _momentum_plain(grid, u, v, w, epsilon),
                    (Gu_prev, Gv_prev, Gw_prev), a, b, H)
    return (*news, Gu_prev, Gv_prev, Gw_prev)


def weno5_science_ab2_update_plain(grid, u, v, w, tracers, Gu_prev, Gv_prev,
                                   Gw_prev, Gc_prev, a, b, f=0.0,
                                   buoyancy_tracer=None, epsilon=1e-8):
    """Plain version of :func:`weno5_science_ab2_update`: the model's own
    Coriolis and buoyancy terms on top of the WENO(5) operators."""
    return science_ab2_plain(grid, WENO(5, epsilon=epsilon), H, u, v, w,
                             tracers, Gu_prev, Gv_prev, Gw_prev, Gc_prev, a,
                             b, f, buoyancy_tracer)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _launch_tendency(fields, state, ints, floats):
    u, v, w = fields
    G = [torch.empty_like(u) for _ in range(3)]
    _build.launch("ot_weno5_tendency", u.dtype, u.device,
                  *(t.data_ptr() for t in (u, v, w, *G)), *u.shape, *floats)
    weno5_momentum_tendency.launches += 1
    return G


def _launch_tracers(fields, state, ints, floats):
    u, v, w, *cs = fields
    out = [torch.empty_like(u) for _ in cs]
    for lo in range(0, len(cs), MAX_TRACERS):
        c_ptrs = pointers(cs[lo:lo + MAX_TRACERS])
        g_ptrs = pointers(out[lo:lo + MAX_TRACERS])
        _build.launch("ot_weno5_tracers", u.dtype, u.device,
                      u.data_ptr(), v.data_ptr(), w.data_ptr(),
                      ctypes.addressof(c_ptrs), ctypes.addressof(g_ptrs),
                      len(cs[lo:lo + MAX_TRACERS]), *u.shape, *floats)
        weno5_tracer_tendencies.launches += 1
    return out


def _launch_ab2(fields, state, ints, floats):
    u, v, w = fields
    news = [torch.empty_like(u) for _ in range(3)]
    _build.launch("ot_weno5_ab2", u.dtype, u.device,
                  *(t.data_ptr() for t in (*fields, *state, *news)),
                  *u.shape, *floats)
    weno5_ab2_update.launches += 1
    return news


def _launch_science_ab2(fields, state, ints, floats):
    u, v, w, *cs = fields
    news = [torch.empty_like(u) for _ in range(3 + len(cs))]
    c_ptrs, g_ptrs, n_ptrs = (pointers(cs), pointers(state[3:]),
                              pointers(news[3:]))
    _build.launch("ot_weno5_science_ab2", u.dtype, u.device,
                  *(t.data_ptr() for t in (u, v, w, *state[:3], *news[:3])),
                  ctypes.addressof(c_ptrs), ctypes.addressof(g_ptrs),
                  ctypes.addressof(n_ptrs), len(cs), *u.shape, *floats,
                  *ints)
    weno5_science_ab2_update.launches += 1
    return news


TENDENCY = KernelOp("weno5_tendency", _launch_tendency)
TRACERS = KernelOp("weno5_tracers", _launch_tracers)
AB2 = KernelOp("weno5_ab2", _launch_ab2, mutates=True)
SCIENCE_AB2 = KernelOp("weno5_science_ab2", _launch_science_ab2,
                       mutates=True)


def weno5_momentum_tendency(grid, u, v, w, epsilon=1e-8):
    """(Gu, Gv, Gw) = -∇·(𝐯 ⊗ 𝐯) with WENO-5 fluxes on x-rows [3, nx-3).
    The outputs' x-halo rows are zero, their y/z halo rows junk that the
    next fill overwrites."""
    name = "weno5_momentum_tendency"
    _check_grid(name, grid, u)
    check_operands(name, (u, v, w), grid.shape)
    if not on_cuda(u):
        return weno5_momentum_tendency_plain(grid, u, v, w, epsilon)
    return weno5_momentum_tendency_op(grid, u, v, w, epsilon)


def weno5_momentum_tendency_op(grid, u, v, w, epsilon=1e-8):
    """:func:`weno5_momentum_tendency` through its operator, on either
    device."""
    return tuple(TENDENCY(
        lambda f, s: list(weno5_momentum_tendency_plain(grid, *f, epsilon)),
        (u, v, w), floats=(*_inv_spacings(grid), epsilon)))


def weno5_tracer_tendencies(grid, u, v, w, tracers, epsilon=1e-8):
    """``{name: -∇·(𝐯c)}`` with WENO-5 fluxes on x-rows [3, nx-3) for each
    tracer of the dict ``tracers``, zero on the other x-rows. One launch
    takes up to :data:`MAX_TRACERS` tracers."""
    name = "weno5_tracer_tendencies"
    _check_grid(name, grid, u)
    check_operands(name, (u, v, w, *tracers.values()), grid.shape)
    if not tracers:
        return {}
    if not on_cuda(u):
        return weno5_tracer_tendencies_plain(grid, u, v, w, tracers, epsilon)
    return weno5_tracer_tendencies_op(grid, u, v, w, tracers, epsilon)


def weno5_tracer_tendencies_op(grid, u, v, w, tracers, epsilon=1e-8):
    """:func:`weno5_tracer_tendencies` through its operator, on either
    device."""
    names = list(tracers)

    def plain(f, s):
        out = weno5_tracer_tendencies_plain(
            grid, *f[:3], dict(zip(names, f[3:])), epsilon)
        return [out[n] for n in names]

    out = TRACERS(plain, (u, v, w, *tracers.values()),
                  floats=(*_inv_spacings(grid), epsilon))
    return dict(zip(names, out))


def weno5_ab2_update(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a, b,
                     epsilon=1e-8):
    """Fused WENO-5 momentum tendency and quasi-AB2 update.

    Returns ``(u', v', w', Gu, Gv, Gw)`` with ``u' = u + a·Gu + b·Gu_prev``
    on x-rows [3, nx-3). Gu, Gv, Gw are written over Gu_prev, Gv_prev,
    Gw_prev in place, as the JAX kernel aliases them, so their x-halo rows
    keep the previous values; u', v', w' are new tensors whose x-halo rows
    are copies of u's, where the JAX kernel leaves them unwritten.
    """
    name = "weno5_ab2_update"
    _check_grid(name, grid, u)
    check_operands(name, (u, v, w, Gu_prev, Gv_prev, Gw_prev), grid.shape)
    if not on_cuda(u):
        return weno5_ab2_update_plain(grid, u, v, w, Gu_prev, Gv_prev,
                                      Gw_prev, a, b, epsilon)
    return weno5_ab2_update_op(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a,
                               b, epsilon)


def weno5_ab2_update_op(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a, b,
                        epsilon=1e-8):
    """:func:`weno5_ab2_update` through its operator, on either device."""
    news = AB2(
        lambda f, s: list(weno5_ab2_update_plain(grid, *f, *s, a, b,
                                                 epsilon)[:3]),
        (u, v, w), (Gu_prev, Gv_prev, Gw_prev),
        floats=(*_inv_spacings(grid), epsilon, a, b))
    return (*news, Gu_prev, Gv_prev, Gw_prev)


def weno5_science_ab2_update(grid, u, v, w, tracers, Gu_prev, Gv_prev,
                             Gw_prev, Gc_prev, a, b, f=0.0,
                             buoyancy_tracer=None, epsilon=1e-8):
    """One fused pass of the WENO-5 science step: momentum, f-plane
    Coriolis (``f``), the buoyancy of the tracer named ``buoyancy_tracer``
    (a BuoyancyTracer with gravity along -z), the advection of every tracer
    and the quasi-AB2 update of all 3 + T fields. Same contract as
    :func:`weno5_ab2_update`; returns ``(u', v', w', {c'}, Gu, Gv, Gw,
    {Gc})`` with the dicts in the order of ``tracers``. Takes at most
    :data:`MAX_TRACERS` tracers."""
    name = "weno5_science_ab2_update"
    _check_grid(name, grid, u)
    names, b_idx, cs, gcs = science_operands(name, tracers, Gc_prev,
                                             buoyancy_tracer)
    check_operands(name, (u, v, w, *cs, Gu_prev, Gv_prev, Gw_prev, *gcs),
                   grid.shape)
    if not on_cuda(u):
        return weno5_science_ab2_update_plain(
            grid, u, v, w, tracers, Gu_prev, Gv_prev, Gw_prev, Gc_prev, a, b,
            f, buoyancy_tracer, epsilon)
    return weno5_science_ab2_update_op(
        grid, u, v, w, tracers, Gu_prev, Gv_prev, Gw_prev, Gc_prev, a, b, f,
        buoyancy_tracer, epsilon)


def weno5_science_ab2_update_op(grid, u, v, w, tracers, Gu_prev, Gv_prev,
                                Gw_prev, Gc_prev, a, b, f=0.0,
                                buoyancy_tracer=None, epsilon=1e-8):
    """:func:`weno5_science_ab2_update` through its operator, on either
    device."""
    names, b_idx, cs, gcs = science_operands(
        "weno5_science_ab2_update", tracers, Gc_prev, buoyancy_tracer)

    def plain(fs, ss):
        return weno5_science_ab2_update_plain(
            grid, *fs[:3], dict(zip(names, fs[3:])), *ss[:3],
            dict(zip(names, ss[3:])), a, b, f, buoyancy_tracer, epsilon)

    return science_op(SCIENCE_AB2, plain, names, u, v, w, cs, Gu_prev,
                      Gv_prev, Gw_prev, gcs, (b_idx,),
                      (*_inv_spacings(grid), epsilon, a, b, f))


weno5_momentum_tendency.launches = 0
weno5_tracer_tendencies.launches = 0
weno5_ab2_update.launches = 0
weno5_science_ab2_update.launches = 0

__all__ = ["MAX_TRACERS", "weno5_ab2_update", "weno5_ab2_update_op",
           "weno5_ab2_update_plain", "weno5_available",
           "weno5_momentum_tendency", "weno5_momentum_tendency_op",
           "weno5_momentum_tendency_plain", "weno5_science_ab2_update",
           "weno5_science_ab2_update_op", "weno5_science_ab2_update_plain",
           "weno5_tracer_tendencies", "weno5_tracer_tendencies_op",
           "weno5_tracer_tendencies_plain"]
