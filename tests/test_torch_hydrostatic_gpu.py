"""The port's WENO tracer kernel and WENO vector-invariant kernel against
their plain versions on the card, and the hydrostatic model's kernel path on
the card against its plain path on the CPU.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_hydrostatic_gpu.py -m gpu

Tolerances, relative to the largest plain value: 1e-12 in float64, where
the kernels and the plain versions differ only by rounding order; in
float32, :data:`RTOL32`, the bound ``chip_smoke.py`` holds the kernels to
(stated there with its reason).
"""

import math

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi

#: float32 kernel-against-plain bound, as in chip_smoke.py
RTOL32 = 1e-5
RTOL = {torch.float32: RTOL32, torch.float64: 1e-12}
PBB = (ot.Periodic, ot.Bounded, ot.Bounded)
LOCS = (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C)


def setup(size, halo, dtype, topology=PBB):
    """A grid on the card and halo-filled random u, v, w, T, S, with u and v
    exactly zero on some rows (both signs and zeros of the velocities)."""
    grid = ot.RectilinearGrid(size=size, extent=(4e7, 2e7, 4e3),
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


def assert_match(got, ref, dtype):
    scale = max(float(r.abs().max()) for r in ref)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= RTOL[dtype] * scale


LAYOUTS = [((23, 17, 9), (6, 6, 4), PBB),
           ((16, 12, 32), (5, 0, 0),
            (ot.Bounded, ot.Periodic, ot.Periodic)),
           ((23, 17, 9), (6, 6, 6), (ot.Bounded, ot.Bounded, ot.Bounded))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernels_match_plain(layout, dtype):
    """Every instantiated (vorticity, rest) order pair with both vorticity
    stencils and every tracer order whose reach the layout's halo holds,
    one launch each; the wide halo (6, 6, 6) holds them all."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    size, halo, topology = layout
    grid, (u, v, w, T, S) = setup(size, halo, dtype, topology)
    n_vi = cvi.vi_momentum_tendency.launches
    n_tr = ctr.weno_tracer_tendencies.launches
    pairs = []
    for kv, kr in cvi.ORDER_PAIRS:
        for stencil in ("velocity", "default"):
            vi = ot.WENOVectorInvariant(vorticity_order=kv, order=kr,
                                        vorticity_stencil=stencil)
            if cvi.vi_available(grid, vi):
                pairs.append((cvi.vi_momentum_tendency(grid, vi, u, v, w),
                              cvi.vi_momentum_tendency_plain(grid, vi, u, v,
                                                             w)))
    n_vi_pairs = len(pairs)
    for order in ctr.ORDERS:
        sch = ot.WENO(order)
        if not ctr.tracer_fusion_available(grid, sch):
            continue
        tr = {"T": T, "S": S}
        pairs.append((
            list(ctr.weno_tracer_tendencies(grid, sch, u, v, w,
                                            tr).values()),
            list(ctr.weno_tracer_tendencies_plain(grid, sch, u, v, w,
                                                  tr).values())))
    torch.cuda.synchronize()
    assert n_vi_pairs >= 2 and len(pairs) > n_vi_pairs
    if halo == (6, 6, 6):
        assert n_vi_pairs == 2 * len(cvi.ORDER_PAIRS)
        assert len(pairs) - n_vi_pairs == len(ctr.ORDERS)
    assert cvi.vi_momentum_tendency.launches == n_vi + n_vi_pairs
    assert ctr.weno_tracer_tendencies.launches == \
        n_tr + len(pairs) - n_vi_pairs
    for got, ref in pairs:
        assert_match(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [None, 7])
def test_hydrostatic_model_on_card_matches_cpu(order):
    """A float64 (48, 16, 6) ``hydro_vi`` model, halo (6, 6, 4), with its
    default ``WENOVectorInvariant()`` or with ``WENOVectorInvariant(order=
    7)``: the kernel path on the card against the plain path on the CPU
    over 5 steps, from a state without rounding-level zeros of the
    velocities (``profile_step.hydro_generic_state`` says why)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from oceananigans_torch.profile_step import (
        hydro_generic_state, hydro_model,
    )
    momentum = None if order is None else ot.WENOVectorInvariant(order=order)
    finals = {}
    for device in ("cuda", "cpu"):
        m = hydro_model("auto", torch.float64, device, size=(48, 16, 6),
                        momentum_advection=momentum)
        assert m.fused_kernels == m.fused_tracer == (device == "cuda")
        s = hydro_generic_state(m)
        for _ in range(5):
            s = m.step(s, 60.0)
        finals[device] = (m, s)
    (mk, sk), (mp, sp) = finals["cuda"], finals["cpu"]
    g = mp.grid
    xy = g.interior_slices[:2]

    def owned(state, q):
        return state.eta[xy] if q == "eta" else g.interior(getattr(state, q))

    for group in (("u", "v"), ("w",), ("eta",)):
        ref = [owned(sp, q) for q in group]
        got = [owned(sk, q).cpu() for q in group]
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        assert err <= 1e-12 * scale, (group, err / scale)
    for name in ("T", "S"):
        a = g.interior(sk.tracers[name]).cpu()
        b = g.interior(sp.tracers[name])
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert math.isfinite(float(sk.u.abs().max()))
