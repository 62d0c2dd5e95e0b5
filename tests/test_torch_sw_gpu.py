"""The port's shallow-water stage kernel against its plain version on the
card.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_sw_gpu.py -m gpu

Tolerances, as ``chip_smoke.py`` states them:

- one stage in float32 and float64: the updated fields to 8 ulps of their
  largest value; the tendencies to 32 ulps of the largest single term of
  the stencil (a flux difference or the g·h·∂h product over the spacing),
  since each tendency is a small residual of such terms;
- the model on the card against the model on the CPU (the plain path,
  which the CPU tests hold to the JAX package) over 4 steps in float64:
  the transports to 1e-12 of the largest transport and h to 1e-12 of its
  largest value (vh starts at zero, so its own largest value is no
  scale); the tendencies to 1e-9 absolute, the JAX package's own bound for
  its stage kernel, since one ulp of h ~ 1e3 moves the g·h·∂h term by
  ~1e-12 of the largest term.
"""

import math

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_sw

PPF = (ot.Periodic, ot.Periodic, ot.Flat)


def stage_inputs(grid, gen, dtype):
    """Random fields near the benchmark's: h ~ 1000, uh ~ 100."""
    def rnd(scale, offset=0.0):
        return offset + scale * torch.randn(grid.shape, generator=gen,
                                            device="cuda", dtype=dtype)
    q = [rnd(100.0), rnd(100.0), rnd(1.0, 1000.0)]
    for a, loc in zip(q, (ot.LOC_U, ot.LOC_V, ot.LOC_C)):
        ot.fill_halo_regions(a, grid, loc=loc)
    return q, [rnd(1e-2) for _ in range(3)]


def term_scale(grid, uh, vh, h, g):
    """The largest single term of the stencil: |U²/h|/Δ and g·h·|Δh|/Δ
    (its device is the fields')."""
    inv = max(grid.Nx / grid.Lx, grid.Ny / grid.Ly)
    flux = float(torch.maximum(uh.abs(), vh.abs()).max()) ** 2 / float(
        h.abs().min())
    dh = max(float((h - torch.roll(h, 1, 0)).abs().max()),
             float((h - torch.roll(h, 1, 1)).abs().max()))
    return inv * max(flux, g * float(h.abs().max()) * dh)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", [
    ((64, 256), (8, 0, 0), PPF),
    ((48, 200), (8, 0, 0), PPF),
    ((30, 20), (3, 3, 0), (ot.Periodic, ot.Bounded, ot.Flat)),
    # the strip kernel's edges (cuda_sw.stage_plan): an x halo of 2 with a
    # strip edge inside y (640 > STRIP) and three segments, the last
    # shorter; y = 2 (the y-halo wraps onto the strip twice); y = 3 with an
    # x halo of 2 and two segments. Their spacings are exact in binary:
    # the plain version takes them from coordinate differences, whose
    # rounding (an ulp of 1e5 over the spacing) would exceed the float64
    # bound at a spacing of 1e5/600
    ((200, 640), (2, 0, 0), PPF),
    ((64, 2), (8, 0, 0), PPF),
    ((160, 3), (2, 0, 0), PPF)])
def test_stage_kernel_matches_plain(layout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    size, halo, topology = layout
    grid = ot.RectilinearGrid(size=size, x=(0.0, 1e5), y=(0.0, 1e5),
                              topology=topology, halo=halo, dtype=dtype,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    (uh, vh, h), Gm = stage_inputs(grid, gen, dtype)
    n0 = cuda_sw.sw_rk3_stage.launches
    got = cuda_sw.sw_rk3_stage(grid, uh, vh, h, *(g.clone() for g in Gm),
                               0.4, -0.2, 9.81)
    ref = cuda_sw.sw_rk3_stage_plain(grid, uh, vh, h,
                                     *(g.clone() for g in Gm), 0.4, -0.2,
                                     9.81)
    torch.cuda.synchronize()
    assert cuda_sw.sw_rk3_stage.launches == n0 + 1
    # the x-halo rows of q' are copies of q's; G keeps G_prev's there
    H = halo[0]
    for a, q in zip(got[:3], (uh, vh, h)):
        assert torch.equal(a[:H], q[:H]) and torch.equal(a[-H:], q[-H:])
    for a, g in zip(got[3:], Gm):
        assert torch.equal(a[:H], g[:H]) and torch.equal(a[-H:], g[-H:])
    eps = torch.finfo(dtype).eps
    ii = grid.interior_slices
    for a, b in zip(got[:3], ref[:3]):
        scale = float(b[ii].abs().max())
        assert float((a[ii] - b[ii]).abs().max()) <= 8 * eps * scale
    tol = 32 * eps * term_scale(grid, uh, vh, h, 9.81)
    for a, b in zip(got[3:], ref[3:]):
        assert float((a[ii] - b[ii]).abs().max()) <= tol


@pytest.mark.gpu
def test_model_on_card_matches_cpu():
    """4 RK3 steps in float64 of the benchmark's configuration at a small
    size: the kernel path on the card against the plain path on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    finals = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(size=(48, 40), x=(0.0, 1e6),
                                  y=(0.0, 1e6), topology=PPF, halo=(8, 0, 0),
                                  dtype=torch.float64, device=device)
        m = ot.ShallowWaterModel(grid=grid, gravitational_acceleration=9.81)
        assert m.fused_rk3 == (device == "cuda")
        s = m.initial_state(
            h=lambda x, y, z: 1000.0 + torch.sin(2 * math.pi * x / 1e6)
            * torch.cos(2 * math.pi * y / 1e6),
            uh=lambda x, y, z: 100.0 * torch.cos(2 * math.pi * y / 1e6)
            + 0 * x)
        for _ in range(4):
            s = m.step(s, 1.0)
        finals[device] = (grid, s)
    (gk, sk), (gp, sp) = finals["cuda"], finals["cpu"]
    transports = max(float(gp.interior(q).abs().max())
                     for q in (sp.uh, sp.vh))
    scales = {"uh": transports, "vh": transports,
              "h": float(gp.interior(sp.h).abs().max())}
    for name in ("uh", "vh", "h", "Guh", "Gvh", "Gh"):
        a = gk.interior(getattr(sk, name)).cpu()
        b = gp.interior(getattr(sp, name))
        tol = 1e-9 if name.startswith("G") else 1e-12 * scales[name]
        assert float((a - b).abs().max()) <= tol, name
