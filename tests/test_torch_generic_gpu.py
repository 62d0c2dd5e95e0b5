"""The port's generic momentum kernel (``fused_momentum_tendency``) against
its plain version on the card, for every scheme family, both dtypes and two
layouts.

These tests need a CUDA device and skip without one. The kernel is the
x-marching tile of ``csrc/generic_tile.h``, one instantiation per scheme
and one per largest reach for the FluxFormAdvections. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_generic_gpu.py -m gpu

Tolerances, relative to the largest plain value: 1e-12 in float64, where
the kernel and the plain version differ only by rounding order; in
float32 1e-5, the bound ``chip_smoke.py`` holds the WENO kernels to (the
WENO-Z weights are nonlinear in the rounding of the indicators).
"""

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_generic as cg

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
LOCS = (ot.LOC_U, ot.LOC_V, ot.LOC_W)
SCHEMES = ([ot.Centered(k) for k in range(2, 13, 2)]
           + [ot.UpwindBiased(k) for k in range(1, 12, 2)]
           + [ot.WENO(k) for k in range(3, 12, 2)]
           + [ot.FluxFormAdvection(ot.WENO(5), ot.Centered(2),
                                   ot.UpwindBiased(3)),
              ot.FluxFormAdvection(ot.UpwindBiased(11), ot.WENO(9),
                                   ot.Centered(12))])
#: (size, halo, topology): halo-free periodic y and z, haloed ones, and
#: a layout whose plans have partial last panels in y and z and a shorter
#: last segment (tests/test_torch_tile_plans.py)
LAYOUTS = [((13, 17, 24), (6, 0, 0),
            (ot.Bounded, ot.Periodic, ot.Periodic)),
           ((9, 11, 14), (6, 6, 6),
            (ot.Periodic, ot.Bounded, ot.Bounded)),
           ((45, 20, 70), (6, 0, 0),
            (ot.Bounded, ot.Periodic, ot.Periodic))]


def setup(size, halo, topology, dtype):
    """A grid on the card and halo-filled random u, v, w, with u and v
    exactly zero on some rows (velocities of both signs and exact
    zeros)."""
    grid = ot.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                              topology=topology, halo=halo, dtype=dtype,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fs = []
    for n, loc in enumerate(LOCS):
        a = torch.randn(grid.shape, generator=gen, device="cuda",
                        dtype=dtype)
        if n == 0:
            a[:, :, ::3] = 0.0
        if n == 1:
            a[::2] = 0.0
        fs.append(ot.fill_halo_regions(a, grid, loc=loc))
    return grid, fs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_generic_kernel_matches_plain(layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w) = setup(*layout, dtype)
    for scheme in SCHEMES:
        n = cg.fused_momentum_tendency.launches
        got = cg.fused_momentum_tendency(grid, scheme, u, v, w)
        ref = cg.fused_momentum_tendency_plain(grid, scheme, u, v, w)
        torch.cuda.synchronize()
        assert cg.fused_momentum_tendency.launches == n + 1
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        assert err <= RTOL[dtype] * scale, (scheme, err / scale)
        H = grid.H[0]
        for g in got:
            assert float(g[:H].abs().max()) == 0.0
            assert float(g[g.shape[0] - H:].abs().max()) == 0.0


@pytest.mark.gpu
def test_generic_kernel_refuses():
    """The JAX wrapper's ValueErrors, and the layouts the gate refuses,
    raise on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w) = setup((8, 8, 8), (2, 0, 0),
                            (ot.Bounded, ot.Periodic, ot.Periodic),
                            torch.float32)
    with pytest.raises(ValueError):        # x halo 2 < WENO(5)'s 3
        cg.fused_momentum_tendency(grid, ot.WENO(5), u, v, w)
    part = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Bounded, ot.Bounded,
                                        ot.Periodic), halo=(3, 1, 0),
                              device="cuda")
    with pytest.raises(ValueError):        # y halo 1 < WENO(5)'s reach
        cg.fused_momentum_tendency(part, ot.WENO(5), u, v, w)
