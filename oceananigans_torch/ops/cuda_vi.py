"""The hand-written CUDA kernel of the WENO vector-invariant momentum
tendency, with its plain PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_vi.py``: its two TPU kernels,
``vi_momentum_tendency`` (``_kernel``, the (x, y, z) layout) and
``vi_momentum_tendency_zyx`` (``_kernel_zyx``, the transposed layout for
the TPU's 128 lanes), compute the same terms, so on the GPU they are one
kernel, ``vi_march`` of ``csrc/vi_tile.h``, on the port's (x, y, z)
tensors with z contiguous. One launch reads u, v and w and writes Gu and Gv
of ``VectorInvariant.u_tendency``/``v_tendency``: the WENO ζ flux with
VelocityStencil or ζ's own smoothness, the Bernoulli head (the self
difference δx(u²/2) upwinded on u, the cross difference Centered(2)), the
divergence flux with ``OnlySelfUpwinding`` and the flux-form WENO vertical
advection.

The kernel is an x-marching tile (a Gu block and a Gv block for each panel
and segment of ``march.march_plan``), a template on the vorticity
order and on the order of the other three schemes, with one vorticity
order per translation unit (``csrc/vi_tile_k<K>.cu``): the pairs of
:data:`ORDER_PAIRS`, the two families of ``WENOVectorInvariant``, are
instantiated as such, and any other orders of the kinetic energy
gradient, divergence and vertical schemes (each of 3 to 11) take the
instantiation in which those three are runtime values, each dispatched
where its reconstruction is made. Each scheme brings its own epsilon.

The kernel computes every point of the halo-extended tensors, with
neighbours wrapped modulo the full extent on every axis, as the plain
version's whole-tensor operators (``torch.roll``) do: the two agree on
every point, halo rows included, where the JAX kernels write zeros into
their output halo rows. The ten metric combinations enter as y-profiles
(:func:`vi_metric_profiles`), built once by the model: constants on a
regular rectilinear grid, functions of latitude on an x-regular lat-lon
grid (its Az and volumes from Δsinφ, not Δx·Δy).

The wrapper takes its plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device through its custom operator
(``ops/library.py``, batched by ``torch.func.vmap`` one launch per member,
the metric profiles unbatched; ``vi_momentum_tendency_op`` takes it on
either device); there is no fallback from one to the other. It counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import (
    check_operands, on_cuda, sm_count,
)
from oceananigans_torch.ops.cuda_tracer import (
    axes_reachable, grid_ok, metric_profile,
)
from oceananigans_torch.ops.library import KernelOp
from oceananigans_torch.ops.march import march_plan

#: the (vorticity, rest) WENO orders the kernel is instantiated for as
#: pairs, the rest being the kinetic energy gradient, divergence and
#: vertical schemes: ``WENOVectorInvariant(vorticity_order=N)`` (the rest
#: WENO(5); N = 9 is the default) and ``WENOVectorInvariant(order=N)`` (all
#: four of order N); other orders of the rest run in the instantiation of
#: runtime orders
ORDER_PAIRS = tuple(sorted({(n, 5) for n in (3, 5, 7, 9, 11)}
                           | {(n, n) for n in (3, 7, 9, 11)}))
#: the metric combinations, in the order the kernel reads their profiles
METRICS = ("dy_vf", "dx_uf", "dx_vf", "dy_uc", "az_ff", "az_cc", "ax_fcc",
           "ay_cfc", "v_fcc", "v_cfc")


def schemes(vi):
    """The vorticity, kinetic energy gradient, divergence and vertical
    schemes of ``vi``, in the order the kernel takes their orders and
    epsilons."""
    return (vi.vorticity_scheme, vi.kinetic_energy_gradient_scheme,
            vi.divergence_scheme, vi.vertical_scheme)


def _schemes_ok(vi) -> bool:
    """The options the kernel computes, those of the JAX gate's
    ``_vi_schemes_ok``: plain WENO schemes (no bounds) of any order and
    epsilon each, either vorticity stencil, 1-D stencils,
    ``OnlySelfUpwinding`` with Centered(2) cross terms."""
    from oceananigans_torch.advection import WENO, Centered
    from oceananigans_torch.models.hydrostatic import (
        OnlySelfUpwinding, VectorInvariant,
    )
    if not isinstance(vi, VectorInvariant) or vi.multi_dimensional_stencil:
        return False
    if not all(type(s) is WENO and s.bounds is None for s in schemes(vi)):
        return False
    up = vi.upwinding
    return (type(up) is OnlySelfUpwinding
            and type(up.cross_scheme) is Centered
            and up.cross_scheme.order == 2)


def vi_reach(vi):
    """Cells each side that the kernel reads on each axis. ζ's
    reconstruction to centers reads ζ at offsets −Bv+1..Bv and ζ itself
    one more row, so x and y reach Bv; the δ-quantities of the Bernoulli
    head and the divergence flux reach B of their scheme; z reaches the
    vertical scheme's B."""
    bv = (vi.vorticity_scheme.order + 1) // 2
    bke = (vi.kinetic_energy_gradient_scheme.order + 1) // 2
    bd = (vi.divergence_scheme.order + 1) // 2
    bz = (vi.vertical_scheme.order + 1) // 2
    r = max(bv, bke, bd)
    return (r, r, bz)


def vi_available(grid, vi) -> bool:
    """True when the kernel applies: a regular rectilinear grid or an
    x- and z-regular lat-lon grid (``cuda_tracer.grid_ok``, the JAX gate's
    grids), the options of :func:`_schemes_ok` (the JAX gate's
    ``_vi_schemes_ok``), and the reach of :func:`vi_reach` on every axis
    (``cuda_tracer.axes_reachable``). The JAX gates ask one more halo row
    on y and z, (8, 128) alignment of a halo-free axis and, for the
    transposed layout, a lane-padding rule; the port asks none of these,
    and takes a halo-free periodic x."""
    if not grid_ok(grid):
        return False
    if not _schemes_ok(vi):
        return False
    return axes_reachable(grid, vi_reach(vi))


def vi_metric_profiles(grid):
    """The (10, ny) y-profiles of :data:`METRICS`."""
    exprs = (grid.dy(Face, Center), grid.dx(Face, Center),
             grid.dx(Center, Face), grid.dy(Center, Face),
             grid.Az(Face, Face), grid.Az(Center, Center),
             grid.Ax(Face, Center, Center), grid.Ay(Center, Face, Center),
             grid.V(Face, Center, Center), grid.V(Center, Face, Center))
    return torch.stack([metric_profile(grid, e) for e in exprs]).contiguous()


def vi_momentum_tendency_plain(grid, vi, u, v, w):
    """Plain version of :func:`vi_momentum_tendency`."""
    return vi.u_tendency(grid, u, v, w), vi.v_tendency(grid, u, v, w)


def vi_momentum_tendency(grid, vi, u, v, w, metrics=None):
    """(Gu, Gv) of the vector-invariant momentum advection ``vi`` on every
    point. ``metrics``: the profiles of :func:`vi_metric_profiles` (built
    here when not given)."""
    name = "vi_momentum_tendency"
    if not vi_available(grid, vi):
        raise ValueError(f"{name}: no kernel for {vi!r} on {grid!r} (see "
                         "vi_available)")
    check_operands(name, (u, v, w), grid.shape)
    if not on_cuda(u):
        return vi_momentum_tendency_plain(grid, vi, u, v, w)
    if metrics is None:
        metrics = vi_metric_profiles(grid)
    check_operands(name, (metrics,), (len(METRICS), grid.shape[1]))
    if metrics.device != u.device or metrics.dtype != u.dtype:
        raise ValueError(f"{name}: metrics differ from the fields in device "
                         "or dtype")
    return vi_momentum_tendency_op(grid, vi, u, v, w, metrics)


def _launch_vi(fields, state, ints, floats):
    u, v, w, metrics = fields
    Gu, Gv = torch.empty_like(u), torch.empty_like(u)
    plan = march_plan(u.shape, 2, sm_count(u.device), u.element_size())
    _build.launch("ot_vi_march", u.dtype, u.device,
                  u.data_ptr(), v.data_ptr(), w.data_ptr(), Gu.data_ptr(),
                  Gv.data_ptr(), *u.shape, metrics.data_ptr(), *ints, *plan,
                  *floats)
    vi_momentum_tendency.launches += 1
    return [Gu, Gv]


VI_MARCH = KernelOp("vi_march", _launch_vi)


def vi_momentum_tendency_op(grid, vi, u, v, w, metrics=None):
    """:func:`vi_momentum_tendency` through its operator, on either device
    (the metric profiles are built here when not given)."""
    if metrics is None:
        metrics = vi_metric_profiles(grid)
    s = schemes(vi)
    return tuple(VI_MARCH(
        lambda f, _: list(vi_momentum_tendency_plain(grid, vi, *f[:3])),
        (u, v, w, metrics),
        ints=(*(x.order for x in s), int(vi.vorticity_stencil == "velocity")),
        floats=tuple(x.epsilon for x in s)))


vi_momentum_tendency.launches = 0

__all__ = ["METRICS", "ORDER_PAIRS", "schemes", "vi_available",
           "vi_metric_profiles", "vi_momentum_tendency",
           "vi_momentum_tendency_op", "vi_momentum_tendency_plain",
           "vi_reach"]
