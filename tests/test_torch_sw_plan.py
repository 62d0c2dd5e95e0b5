"""The launch plan of the port's shallow-water stage kernel, on the CPU.

``ops/cuda_sw.py: stage_plan`` sizes the x-marching strip kernel's launch:
strips of ``STRIP`` output y and segments of output x-rows. Block (s, g)
computes output y ``[s·STRIP, (s+1)·STRIP) ∩ [0, ny)`` on output x-rows
``[x0 + g·seg_len, x0 + (g+1)·seg_len) ∩ [x0, nx - x0)``, so the plan must
cover every output x-row and every y exactly once and leave no block
empty; these tests hold it to that over ragged shapes. The kernel itself
runs only on the card (``tests/test_torch_sw_gpu.py``).
"""

import numpy as np
import pytest

from oceananigans_torch.ops import cuda_sw

W = cuda_sw.STRIP


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nx,ny,x0,sms", [
    (8208, 8192, 8, 132),          # sw8192: many segments
    (16400, 16384, 8, 132),        # sw16384
    (204, 640, 2, 132),            # x halo 2; a strip edge inside y;
                                   # the last segment shorter
    (64, 256, 8, 132),             # one segment, ny < W
    (40, 20 + 6, 3, 132),          # fewer output rows than a segment; y
                                   # halo 3
    (80, 2, 8, 132),               # y = 2
    (164, 3, 2, 132),              # y = 3; two segments
    (135, 3, 2, 132),              # two segments, the last shorter
    (1000, W, 8, 1),               # one SM: exactly one strip
    (1000, W + 1, 8, 16),          # a strip of one column
    (3, 1000, 1, 132),             # one output row
])
def test_stage_plan_covers_each_point_once(nx, ny, x0, sms, itemsize):
    strips, seg_len, nseg = cuda_sw.stage_plan(nx, ny, x0, sms, itemsize)
    rows = nx - 2 * x0
    cover_x = np.zeros(nx, dtype=int)
    for g in range(nseg):
        lo, hi = x0 + g * seg_len, min(x0 + (g + 1) * seg_len, nx - x0)
        assert lo < hi, f"segment {g} is empty"
        cover_x[lo:hi] += 1
    cover_y = np.zeros(ny, dtype=int)
    for s in range(strips):
        lo, hi = s * W, min((s + 1) * W, ny)
        assert lo < hi, f"strip {s} is empty"
        cover_y[lo:hi] += 1
    assert (cover_x[x0:nx - x0] == 1).all()
    assert not cover_x[:x0].any() and not cover_x[nx - x0:].any()
    assert (cover_y == 1).all()
    # what the kernel's launch checks, and segments of at least
    # MIN_SEGMENT rows where there are that many
    assert (nseg - 1) * seg_len < rows <= nseg * seg_len and nseg <= 65535
    assert seg_len >= min(cuda_sw.MIN_SEGMENT, rows)
    # 2 to 4 waves of resident blocks where the rows allow that many
    resident = sms * cuda_sw.blocks_per_sm(itemsize)
    if strips * (rows // cuda_sw.MIN_SEGMENT) >= 4 * resident:
        assert 2 * resident <= strips * nseg <= 4 * resident


def test_stage_plan_refuses_an_empty_interior():
    with pytest.raises(ValueError):
        cuda_sw.stage_plan(16, 64, 8, 132)
