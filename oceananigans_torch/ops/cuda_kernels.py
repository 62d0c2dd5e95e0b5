"""Hand-written CUDA kernels of the nonhydrostatic main path, with their
plain PyTorch versions.

Counterpart of ``oceananigans_tpu/ops/pallas_kernels.py``:

- ``centered2_ab2_update``: the Centered-2 momentum tendency fused with the
  quasi-AB2 update (``csrc/centered2.cu``), the default AB2 path;
- ``centered2_momentum_tendency``: the tendency alone (same source, the
  x-marching tile ``c2_tile``, launch plan :func:`tendency_plan`), used by
  RK3;
- ``centered2_science_ab2_update``: the science step in one pass
  (``csrc/centered2.cu``): the Centered-2 momentum tendency, f-plane
  Coriolis, the buoyancy of a BuoyancyTracer, the Centered-2 advection of
  up to :data:`MAX_TRACERS` tracers and the AB2 update of every field;
- ``pressure_correction``: (u, v, w) -= Δt∇p in one pass
  (``csrc/pressure_correction.cu``), opt-in as ``model.fused_correction``.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; there is no fallback from one to
the other. On the card it calls its kernel's custom operator
(``ops/library.py``), which ``torch.func.vmap`` batches one launch per
member and through which no gradient flows; its ``*_op`` function takes
that operator on either device (the CPU's implementation is the plain
version). Each counts its kernel launches in its ``launches`` attribute.
All fields are halo-extended ``(nx, ny, nz)`` tensors whose halos are
filled; output x-rows are ``[1, nx-1)``, and y/z neighbours wrap modulo the
full extent (exact on a halo-free periodic axis, landing in halo rows on a
haloed one).
"""

from __future__ import annotations

import ctypes

import torch

from oceananigans_torch.advection import (
    Centered, div_Uc, div_vu, div_vv, div_vw,
)
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.library import KernelOp
from oceananigans_torch.ops.march import march_plan

_FLOATS = (torch.float32, torch.float64)
#: the most tracers one launch of a science or tracer kernel takes
#: (``kMaxTracers`` in ``csrc/centered2.cu`` and
#: ``csrc/weno5_science_tile.cu``); the model takes the unfused route above
#: it, as the JAX model does above its VMEM budget
MAX_TRACERS = 8


def fused_available(grid, advection=None) -> bool:
    """True when the kernels apply: a regular rectilinear grid, Centered(2)
    advection (when ``advection`` is given), every axis with more than one
    cell, a halo on x (outputs cover x-rows [1, nx-1)), and each of y and z
    either haloed or periodic without a halo (the wrap is then the periodic
    boundary). The TPU's (8, 128) tiling rules do not apply on the GPU."""
    from oceananigans_torch.grids.base import Periodic
    from oceananigans_torch.grids.rectilinear import RectilinearGrid
    if not (isinstance(grid, RectilinearGrid) and grid.regular):
        return False
    if advection is not None and not (type(advection) is Centered
                                      and advection.order == 2):
        return False
    if not all(n > 1 for n in grid.N) or grid.H[0] < 1:
        return False
    return all(grid.H[axis] >= 1 or grid.axis_topo(axis) == Periodic
               for axis in (1, 2))


def on_cuda(t) -> bool:
    """False for a CPU tensor, True for a CUDA one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for tensors on {t.device}")


def sm_count(device):
    """The number of SMs of the CUDA ``device``, for the kernels' launch
    plans."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operands(name, tensors, shape):
    """Raise unless ``tensors`` share a device and a float32/float64 dtype,
    have ``shape`` and are contiguous."""
    t0 = tensors[0]
    if t0.dtype not in _FLOATS:
        raise TypeError(f"{name}: dtype {t0.dtype} is not float32/float64")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def pointers(tensors):
    """A C array of the tensors' data pointers (kept alive by the caller
    for the duration of the launch call)."""
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *(t.data_ptr() for t in tensors))


#: ring planes of the Centered-2 tendency tile (``kSlots`` in
#: ``csrc/centered2.cu``)
TILE_SLOTS = 4


def tile_blocks_per_sm(itemsize):
    """Blocks of the Centered-2 tendency tile resident on one SM, as its
    ``__launch_bounds__`` ask: 4 in float32 and 2 in float64."""
    return 4 if itemsize == 4 else 2


def tendency_plan(shape, sms, itemsize=4):
    """The launch plan ``(py, pz, seg_len, nseg)`` of the Centered-2
    tendency tile for ``(nx, ny, nz)`` fields on a card with ``sms`` SMs:
    ``march.march_plan`` for the ``nx - 2`` output x-rows ``[1, nx-1)``
    (segment ``s`` covers rows ``[1 + s·seg_len, 1 + (s+1)·seg_len) ∩ [1,
    nx-1)``), with an extra row and column of threads for the panel's far
    faces."""
    nx, ny, nz = shape
    return march_plan((nx - 2, int(ny), int(nz)), 1, sms, itemsize, (1, 1),
                      tile_blocks_per_sm(itemsize))


def tile_smem_bytes(py, pz, itemsize):
    """The dynamic shared memory of one block of the Centered-2 tendency
    tile for a ``py × pz`` panel (``tile_bytes`` in ``csrc/centered2.cu``):
    the row offsets, the ring of u, v and w tiles with a 1-wide halo, seven
    face arrays, the column offsets and the halo's offsets and indices."""
    tr, tc, nt = py + 2, pz + 2, (py + 1) * (pz + 1)
    nh = 3 * (tc + py + 1)
    return (8 * tr + (TILE_SLOTS * 3 * tr * tc + 7 * nt) * itemsize
            + 4 * (tc + 2 * nh))


def _inv_spacings(grid):
    return tuple(float(n / L) if n > 1 else 0.0
                 for n, L in zip(grid.N, (grid.Lx, grid.Ly, grid.Lz)))


def _check_grid(name, grid, u):
    if not fused_available(grid):
        raise ValueError(f"{name}: no kernel for the layout of {grid!r} "
                         "(see fused_available)")
    if tuple(u.shape) != tuple(grid.shape):
        raise ValueError(f"{name}: fields must be grid-shaped {grid.shape}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _tendency_plain(grid, u, v, w):
    """(Gu, Gv, Gw) on x-rows [1, nx-1), from the whole-array Centered(2)
    operators of ``advection.py``."""
    c2 = Centered(2)
    return tuple(-div(grid, c2, u, v, w)[1:-1]
                 for div in (div_vu, div_vv, div_vw))


def centered2_momentum_tendency_plain(grid, u, v, w):
    """Plain version of :func:`centered2_momentum_tendency`."""
    gs = _tendency_plain(grid, u, v, w)
    out = []
    for g in gs:
        full = torch.zeros_like(u)
        full[1:-1] = g
        out.append(full)
    return tuple(out)


def centered2_ab2_update_plain(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev,
                               a, b):
    """Plain version of :func:`centered2_ab2_update`, with the same
    in-place write of G over G_prev."""
    gs = _tendency_plain(grid, u, v, w)
    news = []
    for q, g, gm in zip((u, v, w), gs, (Gu_prev, Gv_prev, Gw_prev)):
        qn = q.clone()
        qn[1:-1] = q[1:-1] + a * g + b * gm[1:-1]
        gm[1:-1] = g
        news.append(qn)
    return (*news, Gu_prev, Gv_prev, Gw_prev)


def ab2_rows(qs, gs, g_prevs, a, b, H):
    """q' = q + a·G + b·G⁻ on x-rows [H, nx-H) for each field, with G
    (given on those rows) written over G⁻ in place; q' copies q's other
    rows."""
    news = []
    for q, g, gm in zip(qs, gs, g_prevs):
        qn = q.clone()
        qn[H:-H] = q[H:-H] + a * g + b * gm[H:-H]
        gm[H:-H] = g
        news.append(qn)
    return news


def science_ab2_plain(grid, scheme, H, u, v, w, tracers, Gu_prev, Gv_prev,
                      Gw_prev, Gc_prev, a, b, f, buoyancy_tracer):
    """The plain science step on x-rows [H, nx-H) with advection
    ``scheme``: the model's own operators (``advection.div_vu/div_vv/
    div_vw/div_Uc``, the ``coriolis.FPlane`` and ``buoyancy.BuoyancyForce``
    terms), the AB2 update of every field and G written over G⁻. Returns
    ``(u', v', w', {c'}, Gu, Gv, Gw, {Gc})``."""
    from oceananigans_torch.buoyancy import BuoyancyForce, BuoyancyTracer
    from oceananigans_torch.coriolis import FPlane
    names = list(tracers)
    r = slice(H, -H)
    gu, gv, gw = (-div(grid, scheme, u, v, w)[r]
                  for div in (div_vu, div_vv, div_vw))
    if f != 0.0:
        cor = FPlane(f=f)
        gu = gu - cor.x_f_cross_U(grid, u, v, w)[r]
        gv = gv - cor.y_f_cross_U(grid, u, v, w)[r]
    if buoyancy_tracer is not None:
        force = BuoyancyForce(BuoyancyTracer())
        gw = gw + force.z_contribution(
            grid, {"b": tracers[buoyancy_tracer]})[r]
    gcs = [-div_Uc(grid, scheme, u, v, w, tracers[n])[r] for n in names]
    news = ab2_rows((u, v, w, *(tracers[n] for n in names)),
                    (gu, gv, gw, *gcs),
                    (Gu_prev, Gv_prev, Gw_prev,
                     *(Gc_prev[n] for n in names)), a, b, H)
    return (*news[:3], dict(zip(names, news[3:])), Gu_prev, Gv_prev,
            Gw_prev, {n: Gc_prev[n] for n in names})


def centered2_science_ab2_update_plain(grid, u, v, w, tracers, Gu_prev,
                                       Gv_prev, Gw_prev, Gc_prev, a, b,
                                       f=0.0, buoyancy_tracer=None):
    """Plain version of :func:`centered2_science_ab2_update`."""
    return science_ab2_plain(grid, Centered(2), 1, u, v, w, tracers,
                             Gu_prev, Gv_prev, Gw_prev, Gc_prev, a, b, f,
                             buoyancy_tracer)


def pressure_correction_plain(grid, p, u, v, w, dt):
    """Plain version of :func:`pressure_correction`."""
    inv_dx, inv_dy, inv_dz = _inv_spacings(grid)
    p_c = p[1:-1]
    grads = ((p_c - p[:-2]) * inv_dx,
             (p_c - torch.roll(p_c, 1, 1)) * inv_dy,
             (p_c - torch.roll(p_c, 1, 2)) * inv_dz)
    out = []
    for q, g in zip((u, v, w), grads):
        qn = torch.zeros_like(q)
        qn[1:-1] = q[1:-1] - dt * g
        out.append(qn)
    return tuple(out)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _launch_c2_tendency(fields, state, ints, floats):
    u, v, w = fields
    G = [torch.empty_like(u) for _ in range(3)]
    plan = tendency_plan(u.shape, sm_count(u.device), u.element_size())
    _build.launch("ot_c2_tendency", u.dtype, u.device,
                  u.data_ptr(), v.data_ptr(), w.data_ptr(),
                  *(g.data_ptr() for g in G), *u.shape, *floats, *plan)
    centered2_momentum_tendency.launches += 1
    return G


def _launch_c2_ab2(fields, state, ints, floats):
    u, v, w = fields
    news = [torch.empty_like(u) for _ in range(3)]
    _build.launch("ot_c2_ab2", u.dtype, u.device,
                  *(t.data_ptr() for t in (*fields, *state, *news)),
                  *u.shape, *floats)
    centered2_ab2_update.launches += 1
    return news


def _launch_c2_science_ab2(fields, state, ints, floats):
    u, v, w, *cs = fields
    news = [torch.empty_like(u) for _ in range(3 + len(cs))]
    c_ptrs, g_ptrs, n_ptrs = (pointers(cs), pointers(state[3:]),
                              pointers(news[3:]))
    _build.launch("ot_c2_science_ab2", u.dtype, u.device,
                  *(t.data_ptr() for t in (u, v, w, *state[:3], *news[:3])),
                  ctypes.addressof(c_ptrs), ctypes.addressof(g_ptrs),
                  ctypes.addressof(n_ptrs), len(cs), *u.shape, *floats,
                  *ints)
    centered2_science_ab2_update.launches += 1
    return news


def _launch_pressure_correction(fields, state, ints, floats):
    p, u, v, w = fields
    out = [torch.empty_like(u) for _ in range(3)]
    _build.launch("ot_pressure_correction", u.dtype, u.device,
                  *(t.data_ptr() for t in (*fields, *out)), *u.shape,
                  *floats)
    pressure_correction.launches += 1
    return out


C2_TENDENCY = KernelOp("c2_tendency", _launch_c2_tendency)
C2_AB2 = KernelOp("c2_ab2", _launch_c2_ab2, mutates=True)
C2_SCIENCE_AB2 = KernelOp("c2_science_ab2", _launch_c2_science_ab2,
                          mutates=True)
PRESSURE_CORRECTION = KernelOp("pressure_correction",
                               _launch_pressure_correction)


def centered2_momentum_tendency(grid, u, v, w):
    """(Gu, Gv, Gw) = -∇·(𝐯 ⊗ 𝐯) with Centered(2) fluxes on x-rows
    [1, nx-1). The outputs' x-halo rows are zero, their y/z halo rows junk
    that the next fill overwrites."""
    name = "centered2_momentum_tendency"
    _check_grid(name, grid, u)
    check_operands(name, (u, v, w), grid.shape)
    if not on_cuda(u):
        return centered2_momentum_tendency_plain(grid, u, v, w)
    return centered2_momentum_tendency_op(grid, u, v, w)


def centered2_momentum_tendency_op(grid, u, v, w):
    """:func:`centered2_momentum_tendency` through its operator, on either
    device."""
    return tuple(C2_TENDENCY(
        lambda f, s: list(centered2_momentum_tendency_plain(grid, *f)),
        (u, v, w), floats=_inv_spacings(grid)))


def centered2_ab2_update(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a, b):
    """Fused Centered-2 tendency and quasi-AB2 update.

    Returns ``(u', v', w', Gu, Gv, Gw)`` with ``u' = u + a·Gu + b·Gu_prev``
    on x-rows [1, nx-1) (the caller passes a = Δt(3/2+χ), b = −Δt(1/2+χ),
    or Δt and 0 for the Euler first step). Gu, Gv, Gw are written over
    Gu_prev, Gv_prev, Gw_prev in place, as the JAX kernel aliases them, so
    their x-halo rows keep the previous values; u', v', w' are new tensors
    (neighbouring points still read u), whose x-halo rows are copies of
    u's where the JAX kernel leaves them unwritten.
    """
    name = "centered2_ab2_update"
    _check_grid(name, grid, u)
    check_operands(name, (u, v, w, Gu_prev, Gv_prev, Gw_prev), grid.shape)
    if not on_cuda(u):
        return centered2_ab2_update_plain(grid, u, v, w, Gu_prev, Gv_prev,
                                          Gw_prev, a, b)
    return centered2_ab2_update_op(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev,
                                   a, b)


def centered2_ab2_update_op(grid, u, v, w, Gu_prev, Gv_prev, Gw_prev, a, b):
    """:func:`centered2_ab2_update` through its operator, on either
    device."""
    news = C2_AB2(
        lambda f, s: list(centered2_ab2_update_plain(grid, *f, *s, a,
                                                     b)[:3]),
        (u, v, w), (Gu_prev, Gv_prev, Gw_prev),
        floats=(*_inv_spacings(grid), a, b))
    return (*news, Gu_prev, Gv_prev, Gw_prev)


def science_operands(name, tracers, Gc_prev, buoyancy_tracer):
    """The tracer names in order, the index of the buoyancy tracer (-1 for
    none), the tracers and their G⁻, for a science kernel; raises above
    :data:`MAX_TRACERS` or when ``Gc_prev`` has other names."""
    names = list(tracers)
    if len(names) > MAX_TRACERS:
        raise ValueError(f"{name}: {len(names)} tracers, at most "
                         f"{MAX_TRACERS}")
    if set(Gc_prev) != set(names):
        raise ValueError(f"{name}: Gc_prev has {sorted(Gc_prev)}, tracers "
                         f"{sorted(names)}")
    b_idx = -1 if buoyancy_tracer is None else names.index(buoyancy_tracer)
    return (names, b_idx, [tracers[n] for n in names],
            [Gc_prev[n] for n in names])


def science_op(op, plain, names, u, v, w, cs, Gu_prev, Gv_prev, Gw_prev,
               gcs, ints, floats):
    """Run a science kernel's operator ``op``; ``plain(fields, state)``
    returns the plain version's ``(u', v', w', {c'}, ...)``. Returns the
    wrapper's ``(u', v', w', {c'}, Gu, Gv, Gw, {Gc})``."""
    def plain_news(f, s):
        out = plain(f, s)
        return [*out[:3], *(out[3][n] for n in names)]

    news = op(plain_news, (u, v, w, *cs), (Gu_prev, Gv_prev, Gw_prev, *gcs),
              ints, floats)
    return (*news[:3], dict(zip(names, news[3:])), Gu_prev, Gv_prev,
            Gw_prev, dict(zip(names, gcs)))


def centered2_science_ab2_update(grid, u, v, w, tracers, Gu_prev, Gv_prev,
                                 Gw_prev, Gc_prev, a, b, f=0.0,
                                 buoyancy_tracer=None):
    """One fused pass of the Centered-2 science step: the momentum tendency,
    f-plane Coriolis (``f``), the buoyancy of the tracer named
    ``buoyancy_tracer`` (a BuoyancyTracer with gravity along -z), the
    advection of every tracer and the quasi-AB2 update of all 3 + T fields
    on x-rows [1, nx-1). Same contract as :func:`centered2_ab2_update`;
    returns ``(u', v', w', {c'}, Gu, Gv, Gw, {Gc})`` with the dicts in the
    order of ``tracers``. Takes at most :data:`MAX_TRACERS` tracers."""
    name = "centered2_science_ab2_update"
    _check_grid(name, grid, u)
    names, b_idx, cs, gcs = science_operands(name, tracers, Gc_prev,
                                             buoyancy_tracer)
    check_operands(name, (u, v, w, *cs, Gu_prev, Gv_prev, Gw_prev, *gcs),
                   grid.shape)
    if not on_cuda(u):
        return centered2_science_ab2_update_plain(
            grid, u, v, w, tracers, Gu_prev, Gv_prev, Gw_prev, Gc_prev, a, b,
            f, buoyancy_tracer)
    return centered2_science_ab2_update_op(
        grid, u, v, w, tracers, Gu_prev, Gv_prev, Gw_prev, Gc_prev, a, b, f,
        buoyancy_tracer)


def centered2_science_ab2_update_op(grid, u, v, w, tracers, Gu_prev,
                                    Gv_prev, Gw_prev, Gc_prev, a, b, f=0.0,
                                    buoyancy_tracer=None):
    """:func:`centered2_science_ab2_update` through its operator, on either
    device."""
    names, b_idx, cs, gcs = science_operands(
        "centered2_science_ab2_update", tracers, Gc_prev, buoyancy_tracer)

    def plain(fs, ss):
        return centered2_science_ab2_update_plain(
            grid, *fs[:3], dict(zip(names, fs[3:])), *ss[:3],
            dict(zip(names, ss[3:])), a, b, f, buoyancy_tracer)

    return science_op(C2_SCIENCE_AB2, plain, names, u, v, w, cs, Gu_prev,
                      Gv_prev, Gw_prev, gcs, (b_idx,),
                      (*_inv_spacings(grid), a, b, f))


def pressure_correction(grid, p, u, v, w, dt):
    """(u, v, w) - dt ∇p on x-rows [1, nx-1), read and written once; the
    outputs' x-halo rows are zero. ``p`` is the halo-filled pressure."""
    name = "pressure_correction"
    _check_grid(name, grid, u)
    check_operands(name, (p, u, v, w), grid.shape)
    if not on_cuda(u):
        return pressure_correction_plain(grid, p, u, v, w, dt)
    return pressure_correction_op(grid, p, u, v, w, dt)


def pressure_correction_op(grid, p, u, v, w, dt):
    """:func:`pressure_correction` through its operator, on either
    device."""
    return tuple(PRESSURE_CORRECTION(
        lambda f, s: list(pressure_correction_plain(grid, *f, dt)),
        (p, u, v, w), floats=(*_inv_spacings(grid), dt)))


centered2_momentum_tendency.launches = 0
centered2_ab2_update.launches = 0
centered2_science_ab2_update.launches = 0
pressure_correction.launches = 0

__all__ = ["MAX_TRACERS", "centered2_ab2_update",
           "centered2_ab2_update_op", "centered2_ab2_update_plain",
           "centered2_momentum_tendency", "centered2_momentum_tendency_op",
           "centered2_momentum_tendency_plain",
           "centered2_science_ab2_update", "centered2_science_ab2_update_op",
           "centered2_science_ab2_update_plain", "fused_available",
           "pressure_correction", "pressure_correction_op",
           "pressure_correction_plain", "tendency_plan", "tile_smem_bytes"]
