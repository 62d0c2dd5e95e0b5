"""The launch plan of the x-marching tiles (``csrc/march.h``).

A tile kernel's block owns a panel of (y, z) output columns, one thread a
column plus the rows and columns of threads beyond it that compute the
faces on its far side, and marches along x over one segment of the output
x-rows. :func:`march_plan` sizes the panel and the segments; the kernels
(``csrc/vi_tile.h``, ``csrc/centered2.cu``, ``csrc/generic_tile.h``)
refuse a plan that misses an x-row (``plan_ok`` in ``csrc/march.h``).
"""

from __future__ import annotations

import functools
import math

#: most threads of a block (``kMaxThreads`` in ``csrc/march.h``)
MAX_THREADS = 256
#: the widest z-panel: a warp's width, so that a row of the panel is one
#: contiguous run
PANEL_Z = 32
#: the cost of starting a segment (its first planes and queues), in x-rows
#: of marching
SEGMENT_START = 4
#: the largest dynamic shared memory of a block on the H100 (``kMaxSmem``)
MAX_SMEM = 232448


def blocks_per_sm(itemsize):
    """Blocks of the vector-invariant and tracer tiles resident on one SM,
    as their ``__launch_bounds__`` (``kMinBlocks`` in ``csrc/vi_tile.h``)
    ask: 3 in float32 and 1 in float64."""
    return 3 if itemsize == 4 else 1


@functools.lru_cache(maxsize=256)
def march_plan(shape, roles, sms, itemsize=4, extra=(0, 1), per_sm=None):
    """The launch plan of the x-marching tiles for ``(nx, ny, nz)`` fields
    on a card with ``sms`` SMs: ``(py, pz, seg_len, nseg)``.

    Block ``(kp, jp, seg · roles + role)`` owns output columns ``[jp·py,
    (jp+1)·py) × [kp·pz, (kp+1)·pz) ∩ [0, ny) × [0, nz)`` on x-rows
    ``[seg·seg_len, (seg+1)·seg_len) ∩ [0, nx)`` with ``(py + ey) × (pz +
    ez)`` threads, ``(ey, ez) = extra``; ``roles`` blocks share each panel
    and segment (the vector-invariant kernel's Gu and Gv, the tracer
    kernel's pairs of tracers). The z-panel is the widest of at most
    :data:`PANEL_Z` that splits nz evenly (68: three of 23), the y-panel
    as tall as :data:`MAX_THREADS` threads allow, split evenly. The
    segment count minimises the x-rows a block marches times the waves of
    resident blocks (``per_sm`` on each SM, :func:`blocks_per_sm` unless
    given), ``⌈blocks / (sms · per_sm)⌉ · (seg_len + SEGMENT_START)``, the
    fewest segments among equals. The plan covers each output point once
    and leaves no segment empty. A kernel whose output x-rows start at
    ``h`` plans for its ``nx - 2h`` output rows and adds ``h``. The search
    costs a Python loop over nx; plans are cached, so a wrapper called
    every step pays it once a shape."""
    nx, ny, nz = shape
    ey, ez = extra
    if min(nx, ny, nz) < 1 or roles < 1 or sms < 1:
        raise ValueError(f"no march plan for {tuple(shape)}")
    pz = math.ceil(nz / math.ceil(nz / PANEL_Z))
    py_max = max(1, MAX_THREADS // (pz + ez) - ey)
    py = math.ceil(ny / math.ceil(ny / py_max))
    per_segment = math.ceil(ny / py) * math.ceil(nz / pz) * roles
    slots = blocks_per_sm(itemsize) if per_sm is None else per_sm
    best = None
    for n in range(1, nx + 1):
        seg_len = math.ceil(nx / n)
        nseg = math.ceil(nx / seg_len)
        if nseg != n:
            continue
        waves = math.ceil(per_segment * nseg / (sms * slots))
        cost = waves * (seg_len + SEGMENT_START)
        if best is None or cost < best[0]:
            best = (cost, seg_len, nseg)
    return py, pz, best[1], best[2]


__all__ = ["MAX_SMEM", "MAX_THREADS", "PANEL_Z", "SEGMENT_START",
           "blocks_per_sm", "march_plan"]
