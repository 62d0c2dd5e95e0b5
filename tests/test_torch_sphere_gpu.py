"""The port's WENO tracer kernel (row 11) and WENO vector-invariant kernel
(rows 12/13) on ``LatitudeLongitudeGrid`` layouts and at mixed WENO orders,
against their plain versions on the card; and the lat-lon hydrostatic model
(``profile_step.hydro_latlon_model``) on the card against the CPU.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_sphere_gpu.py -m gpu

Tolerances, relative to the largest plain value: 1e-12 in float64 and
1e-5 in float32, as in ``tests/test_torch_hydrostatic_gpu.py``.
"""

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
LOCS = (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C)

#: lat-lon layouts: (size, halo, longitude, latitude); a near-global
#: periodic ocean, one reaching both poles, and the sector of the JAX
#: package's lat-lon kernel tests
LAYOUTS = [((23, 17, 9), (6, 6, 4), (0.0, 360.0), (-80.0, 80.0)),
           ((24, 18, 9), (6, 6, 6), (0.0, 360.0), (-90.0, 90.0)),
           ((24, 16, 8), (6, 6, 6), (-30.0, 30.0), (15.0, 55.0))]

#: (vorticity, kinetic energy gradient, divergence, vertical) WENO orders
#: that no instantiated pair covers, the vertical scheme with an epsilon of
#: its own
MIXED = [(9, 7, 5, 3), (7, 3, 3, 3), (5, 11, 7, 9), (3, 5, 7, 11),
         (11, 3, 9, 5)]


def mixed_vi(orders, stencil="velocity"):
    """A ``VectorInvariant`` of the four WENO ``orders``, the vertical
    scheme's epsilon 1e-6, the others' 1e-8."""
    kv, kk, kd, kz = orders
    return ot.VectorInvariant(
        vorticity_scheme=ot.WENO(kv), vorticity_stencil=stencil,
        vertical_scheme=ot.WENO(kz, epsilon=1e-6),
        divergence_scheme=ot.WENO(kd),
        kinetic_energy_gradient_scheme=ot.WENO(kk))


def setup(layout, dtype):
    """A lat-lon grid on the card and halo-filled random u, v, w, T, S
    (u and v exactly zero on some rows)."""
    size, halo, lon, lat = layout
    grid = ot.LatitudeLongitudeGrid(size=size, longitude=lon, latitude=lat,
                                    z=(-4000.0, 0.0), halo=halo,
                                    dtype=dtype, device="cuda")
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_latlon_kernels_match_plain(layout, dtype):
    """Both WENOVectorInvariant families at orders 5 and 9, the mixed
    orders of :data:`MIXED` with both vorticity stencils, and every tracer
    order, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w, T, S) = setup(layout, dtype)
    schemes = [ot.WENOVectorInvariant(), ot.WENOVectorInvariant(order=5),
               ot.WENOVectorInvariant(vorticity_order=5,
                                      vorticity_stencil="default")]
    schemes += [mixed_vi(o, s) for o in MIXED
                for s in ("velocity", "default")]
    n_vi = cvi.vi_momentum_tendency.launches
    n_tr = ctr.weno_tracer_tendencies.launches
    pairs = []
    for vi in schemes:
        assert cvi.vi_available(grid, vi) == all(
            r <= h for r, h in zip(cvi.vi_reach(vi), grid.H))
        if cvi.vi_available(grid, vi):
            pairs.append((cvi.vi_momentum_tendency(grid, vi, u, v, w),
                          cvi.vi_momentum_tendency_plain(grid, vi, u, v,
                                                         w)))
    n_vi_pairs = len(pairs)
    n_orders = 0
    for order in ctr.ORDERS:
        sch = ot.WENO(order)
        fits = all(ctr.tracer_reach(sch) <= h for h in grid.H)
        assert ctr.tracer_fusion_available(grid, sch) == fits
        if not fits:
            continue
        n_orders += 1
        tr = {"T": T, "S": S}
        pairs.append((
            list(ctr.weno_tracer_tendencies(grid, sch, u, v, w,
                                            tr).values()),
            list(ctr.weno_tracer_tendencies_plain(grid, sch, u, v, w,
                                                  tr).values())))
    torch.cuda.synchronize()
    assert n_vi_pairs >= 8
    assert cvi.vi_momentum_tendency.launches == n_vi + n_vi_pairs
    assert n_orders >= 3
    assert ctr.weno_tracer_tendencies.launches == n_tr + n_orders
    for got, ref in pairs:
        assert_match(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("momentum", ["default", "mixed"])
def test_latlon_model_on_card_matches_cpu(momentum):
    """``hydro_vi_latlon`` at the (24, 16, 8) sector in float64, its
    default momentum advection or the mixed orders (9, 7, 5, 3): the
    kernel path on the card against the plain path on the CPU over 3
    steps, volume conserved on both."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from oceananigans_torch.profile_step import (
        hydro_latlon_initial_state, hydro_latlon_model, volume_drift,
    )
    vi = None if momentum == "default" else mixed_vi(MIXED[0])
    finals = {}
    for device in ("cuda", "cpu"):
        m = hydro_latlon_model("auto", torch.float64, device,
                               size=(24, 16, 8), momentum_advection=vi,
                               longitude=(-30.0, 30.0),
                               latitude=(15.0, 55.0), halo=6)
        assert m.fused_kernels == m.fused_tracer == (device == "cuda")
        s = hydro_latlon_initial_state(m, generic=True)
        eta0 = s.eta.clone()
        for _ in range(3):
            s = m.step(s, 60.0)
        assert volume_drift(m, eta0, s.eta) < 1e-12
        finals[device] = (m.grid, s)
    (gk, sk), (gp, sp) = finals["cuda"], finals["cpu"]
    for a, b in ((sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w),
                 *((sk.tracers[n], sp.tracers[n]) for n in ("T", "S"))):
        ai, bi = gk.interior(a).cpu(), gp.interior(b)
        assert float((ai - bi).abs().max()) <= 1e-12 * float(
            bi.abs().max())
