"""The launch plans of the port's Centered-2 tendency tile and generic
momentum tile, on the CPU.

``ops/cuda_kernels.py: tendency_plan`` (kernel 2, ``csrc/centered2.cu``
``c2_tile``) and ``ops/cuda_generic.py: momentum_plan`` (kernel 14,
``csrc/generic_tile.h`` ``generic_march``) size the x-marching tiles'
launches with ``ops/march.py: march_plan`` over the output x-rows: block
``(kp, jp, s)`` computes output columns ``[jp·py, (jp+1)·py) × [kp·pz,
(kp+1)·pz) ∩ [0, ny) × [0, nz)`` on output x-rows ``[h + s·seg_len, h +
(s+1)·seg_len) ∩ [h, nx-h)`` (h = 1 for kernel 2, the x halo for kernel
14) with ``(py + 1) × (pz + 1)`` threads. These tests hold each plan to
covering every output x-row and every (y, z) column exactly once, with
no empty block, at most 256 threads a block and a block's shared memory
within the H100's 227 KB, over ragged shapes; the kernels themselves run
only on the card (``tests/test_torch_kernels.py``,
``tests/test_torch_generic_gpu.py``).
"""

import numpy as np
import pytest

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_generic as cg
from oceananigans_torch.ops import cuda_kernels as ck
from oceananigans_torch.ops import march

#: (nx, ny, nz) of halo-extended fields: the main paths (256³ with x halo
#: 1; 256³ with x halo 3 and 6), a one-cell y and a one-cell z, partial
#: last panels in y and z with a shorter last segment, a narrow field, a
#: field narrower than one panel on every axis
SHAPES = [(258, 256, 256), (262, 256, 256), (268, 256, 256), (40, 1, 64),
          (40, 64, 1), (61, 20, 70), (57, 20, 70), (30, 13, 45),
          (14, 3, 5)]
SMS = (1, 132)


def check_plan(plan, rows, ny, nz, h):
    """Each output x-row in [h, h + rows) and each (y, z) column in one
    non-empty block, at most MAX_THREADS threads, the grid within CUDA's
    limits; returns the block count."""
    py, pz, seg_len, nseg = plan
    assert (py + 1) * (pz + 1) <= march.MAX_THREADS
    assert 1 <= pz <= march.PANEL_Z and py >= 1
    cover = np.zeros(h + rows + h, int)
    for s in range(nseg):
        lo, hi = h + s * seg_len, min(h + (s + 1) * seg_len, h + rows)
        assert lo < hi, f"segment {s} is empty"
        cover[lo:hi] += 1
    assert (cover[h:h + rows] == 1).all()
    assert not cover[:h].any() and not cover[h + rows:].any()
    cols = np.zeros((ny, nz), int)
    for jp in range(-(-ny // py)):
        for kp in range(-(-nz // pz)):
            lo_y, lo_z = jp * py, kp * pz
            assert lo_y < ny and lo_z < nz, "a panel is empty"
            cols[lo_y:lo_y + py, lo_z:lo_z + pz] += 1
    assert (cols == 1).all()
    assert -(-ny // py) <= 65535 and nseg <= 65535
    return -(-ny // py) * -(-nz // pz) * nseg


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tendency_plan_covers_each_point_once(shape, itemsize):
    nx, ny, nz = shape
    for sms in SMS:
        plan = ck.tendency_plan(shape, sms, itemsize)
        check_plan(plan, nx - 2, ny, nz, 1)
        assert (ck.tile_smem_bytes(plan[0], plan[1], itemsize)
                <= march.MAX_SMEM)


#: one scheme of each reach 1 to 6, and FluxFormAdvections whose largest
#: reach is 1, 3 and 6
SCHEMES = [ot.UpwindBiased(1), ot.Centered(4), ot.WENO(5), ot.Centered(8),
           ot.WENO(9), ot.WENO(11), ot.UpwindBiased(11),
           ot.FluxFormAdvection(ot.Centered(2), ot.UpwindBiased(1),
                                ot.Centered(2)),
           ot.FluxFormAdvection(ot.WENO(5), ot.Centered(2),
                                ot.UpwindBiased(3)),
           ot.FluxFormAdvection(ot.UpwindBiased(11), ot.WENO(9),
                                ot.Centered(12))]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("scheme", SCHEMES, ids=repr)
def test_momentum_plan_covers_each_point_once(scheme, itemsize):
    schemes = cg.axis_schemes(scheme)
    B = cg.reach(schemes)
    for nx, ny, nz in SHAPES:
        shape = (nx + 2 * B, ny, nz)     # the x halo of the reach
        for sms in SMS:
            plan = cg.momentum_plan(shape, B, schemes, sms, itemsize)
            check_plan(plan, nx, ny, nz, B)
            assert (cg.tile_smem_bytes(B, plan[0], plan[1], itemsize)
                    <= march.MAX_SMEM)


@pytest.mark.parametrize("B", range(1, 7))
def test_generic_tile_fits_every_reach(B):
    """The largest panel a plan can take (one of 6 × 32, or 15 × 15) fits
    the shared memory at every reach in float64, and two blocks fit an SM
    in float32."""
    for py, pz in ((6, 32), (15, 15)):
        assert cg.tile_smem_bytes(B, py, pz, 8) <= march.MAX_SMEM
        assert 2 * cg.tile_smem_bytes(B, py, pz, 4) <= march.MAX_SMEM


def test_plans_at_the_main_shapes():
    """What the main paths launch on a 132-SM card: kernel 2 at (258,
    256, 256) in three segments of 86, 86 and 84 rows; kernel 14's WENO(5)
    at (262, 256, 256) in eight segments of 32, both with panels of 6 ×
    32 (43 × 8 of them)."""
    assert ck.tendency_plan((258, 256, 256), 132) == (6, 32, 86, 3)
    assert cg.momentum_plan((262, 256, 256), 3,
                            cg.axis_schemes(ot.WENO(5)), 132) == (
        6, 32, 32, 8)
    assert cg.blocks_per_sm(cg.axis_schemes(ot.WENO(5)), 4) == 3
    assert cg.blocks_per_sm(cg.axis_schemes(ot.Centered(8)), 4) == 3
    assert cg.blocks_per_sm(cg.axis_schemes(ot.Centered(10)), 4) == 2
    assert cg.blocks_per_sm(cg.axis_schemes(ot.UpwindBiased(9)), 4) == 2
    assert cg.blocks_per_sm(cg.axis_schemes(ot.WENO(9)), 4) == 2
    mixed = cg.axis_schemes(ot.FluxFormAdvection(
        ot.UpwindBiased(11), ot.WENO(9), ot.Centered(12)))
    assert cg.blocks_per_sm(mixed, 4) == 2 and cg.blocks_per_sm(mixed, 8) == 1


def test_plans_refuse_an_empty_interior():
    with pytest.raises(ValueError):
        ck.tendency_plan((2, 8, 8), 132)
    with pytest.raises(ValueError):
        cg.momentum_plan((6, 8, 8), 3, cg.axis_schemes(ot.WENO(5)), 132)
