"""The port's WENO-5 CUDA kernels against their plain versions on the card.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_weno_gpu.py -m gpu

Tolerances, relative to the largest plain value: 1e-12 in float64, where
the kernels and the plain versions differ only by rounding order; in
float32, :data:`WENO_RTOL32`, the bound ``chip_smoke.py`` holds the kernels
to (set from its readings on the card and stated there).
"""

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_weno as cw

#: float32 kernel-against-plain bound, as in chip_smoke.py
WENO_RTOL32 = 1e-5
RTOL = {torch.float32: WENO_RTOL32, torch.float64: 1e-12}
BPP = (ot.Bounded, ot.Periodic, ot.Periodic)
LOCS = (ot.LOC_U, ot.LOC_V, ot.LOC_W)


def setup(size, halo, dtype, zero_rows=False, tracers=2):
    """Random filled u, v, w and ``tracers`` tracers; with ``zero_rows``, u
    is exactly zero on every third z-column and v on every other x-plane
    (faces whose taps and advecting velocity are exact zeros)."""
    grid = ot.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                              topology=BPP, halo=halo, dtype=dtype,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fs = []
    for n, loc in enumerate(LOCS + (ot.LOC_C,) * tracers):
        a = torch.randn(grid.shape, generator=gen, device="cuda", dtype=dtype)
        if zero_rows and n == 0:
            a[:, :, ::3] = 0.0
        if zero_rows and n == 1:
            a[::2] = 0.0
        fs.append(ot.fill_halo_regions(a, grid, loc=loc))
    return grid, fs


def assert_match(got, ref, dtype):
    scale = max(float(r.abs().max()) for r in ref)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", [
    ((16, 16, 32), (3, 0, 0)),
    ((10, 9, 7), (3, 3, 3)),
    # the tiles' edges: y and z extents not multiples of their 16 x 32
    # panel, y below 7 (the wrap crosses the tile more than once), 70 x-rows
    # (two x segments), and the ragged haloed layout of chip_smoke.py
    ((70, 5, 70), (3, 0, 0)),
    ((30, 20, 40), (3, 3, 3))])
def test_weno5_kernels_match_plain(layout, dtype, zero_rows):
    """Each WENO-5 kernel against its plain version; kernel 7's outputs
    cover every point (its x-halo rows are zero, as the plain version's
    are)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w, c, d) = setup(*layout, dtype, zero_rows)
    tr = {"c": c, "d": d}
    G = [0.5 * q for q in (u, v, w, c, d)]

    def science(fn):
        out = fn(grid, u, v, w, tr, *(g.clone() for g in G[:3]),
                 {"c": G[3].clone(), "d": G[4].clone()}, 0.3, -0.1, f=0.5,
                 buoyancy_tracer="d")
        return [*out[:3], *out[3].values(), *out[4:7], *out[7].values()]

    n0 = cw.weno5_science_ab2_update.launches
    n6 = cw.weno5_ab2_update.launches
    # NaN in the blocks the allocator is likely to hand kernel 7's outputs,
    # so that a point the kernel does not write cannot pass as a zero
    junk = [torch.full_like(u, float("nan")) for _ in range(3)]
    del junk
    pairs = [
        (cw.weno5_momentum_tendency(grid, u, v, w),
         cw.weno5_momentum_tendency_plain(grid, u, v, w)),
        (list(cw.weno5_tracer_tendencies(grid, u, v, w, tr).values()),
         list(cw.weno5_tracer_tendencies_plain(grid, u, v, w, tr).values())),
        (cw.weno5_ab2_update(grid, u, v, w, *(g.clone() for g in G[:3]),
                             0.3, -0.1),
         cw.weno5_ab2_update_plain(grid, u, v, w,
                                   *(g.clone() for g in G[:3]), 0.3, -0.1)),
        (science(cw.weno5_science_ab2_update),
         science(cw.weno5_science_ab2_update_plain)),
    ]
    torch.cuda.synchronize()
    assert cw.weno5_science_ab2_update.launches == n0 + 1
    assert cw.weno5_ab2_update.launches == n6 + 1
    for got, ref in pairs:
        assert len(got) == len(ref)
        assert_match(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", [((70, 5, 70), (3, 0, 0)),
                                    ((30, 20, 40), (3, 3, 3))])
@pytest.mark.parametrize("T,physics", [(1, False), (1, True), (2, True),
                                       (8, False), (8, True), (9, False)])
def test_weno5_tracer_tiles_match_plain(T, physics, layout, dtype,
                                        zero_rows):
    """The science step (kernel 8) and the tracer tendencies (kernel 9)
    against their plain versions for T tracers: tracer groups of the
    tiles, f != 0 with the last tracer as buoyancy or f = 0 without, and
    (T = 9) the tracer tendencies in two launches; the science step takes
    at most 8 tracers."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w, *cs) = setup(*layout, dtype, zero_rows, tracers=T)
    names = [f"c{t}" for t in range(T)]
    tr = dict(zip(names, cs))
    n9 = cw.weno5_tracer_tendencies.launches
    got = cw.weno5_tracer_tendencies(grid, u, v, w, tr)
    torch.cuda.synchronize()
    assert cw.weno5_tracer_tendencies.launches == n9 + (T + 7) // 8
    ref = cw.weno5_tracer_tendencies_plain(grid, u, v, w, tr)
    assert list(got) == names
    assert_match(list(got.values()), list(ref.values()), dtype)
    if T > cw.MAX_TRACERS:
        return
    G = [0.5 * q for q in (u, v, w, *cs)]
    kw = dict(f=0.5, buoyancy_tracer=names[-1]) if physics else {}

    def science(fn):
        out = fn(grid, u, v, w, tr, *(g.clone() for g in G[:3]),
                 {n: g.clone() for n, g in zip(names, G[3:])}, 0.3, -0.1,
                 **kw)
        return [*out[:3], *out[3].values(), *out[4:7], *out[7].values()]

    n8 = cw.weno5_science_ab2_update.launches
    got = science(cw.weno5_science_ab2_update)
    torch.cuda.synchronize()
    assert cw.weno5_science_ab2_update.launches == n8 + 1
    assert_match(got, science(cw.weno5_science_ab2_update_plain), dtype)


@pytest.mark.gpu
def test_weno5_science_tile_takes_no_tracers():
    """The science step with no tracer: momentum blocks alone."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, (u, v, w) = setup((30, 20, 40), (3, 3, 3), torch.float64,
                            tracers=0)
    G = [0.5 * q for q in (u, v, w)]

    def science(fn):
        out = fn(grid, u, v, w, {}, *(g.clone() for g in G), {}, 0.3, -0.1,
                 f=0.5)
        return [*out[:3], *out[4:7]]

    assert_match(science(cw.weno5_science_ab2_update),
                 science(cw.weno5_science_ab2_update_plain), torch.float64)


@pytest.mark.gpu
def test_weno7_tracer_model_on_card_matches_cpu():
    """A float64 WENO(7) model with tracers on the card, whose tracers take
    the any-order tracer kernel (kernel 11) once a step under AB2, against
    the plain path on the CPU over 3 steps."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import math
    from oceananigans_torch.ops import cuda_tracer as ctr
    finals = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(size=(12, 8, 16), extent=(1.0, 1.0, 1.0),
                                  topology=BPP, halo=(4, 4, 4),
                                  dtype=torch.float64, device=device)
        m = ot.NonhydrostaticModel(
            grid=grid, advection=ot.WENO(7), tracers=("T", "S"),
            timestepper="QuasiAdamsBashforth2", fused_kernels="auto")
        s = m.initial_state(
            u=lambda x, y, z: torch.sin(2 * math.pi * x)
            * torch.cos(2 * math.pi * y),
            T=lambda x, y, z: torch.cos(2 * math.pi * z) + 0 * x,
            S=lambda x, y, z: torch.sin(2 * math.pi * y) + 0 * x)
        n0 = ctr.weno_tracer_tendencies.launches
        for _ in range(3):
            s = m.step(s, 1e-2)
        finals[device] = (m, s, ctr.weno_tracer_tendencies.launches - n0)
    (mk, sk, nk), (mp, sp, np_) = finals["cuda"], finals["cpu"]
    assert mk.fused_tracer and not mp.fused_tracer
    assert nk == 3 and np_ == 0
    for name in ("u", "v", "w"):
        a = mk.grid.interior(getattr(sk, name)).cpu()
        b = mp.grid.interior(getattr(sp, name))
        assert float((a - b).abs().max()) <= 1e-12 * max(
            float(b.abs().max()), 1.0)
    for name in ("T", "S"):
        a = mk.grid.interior(sk.tracers[name]).cpu()
        b = mp.grid.interior(sp.tracers[name])
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.gpu
def test_weno_science_model_on_card_matches_cpu():
    """A float64 WENO science model (kernel 8) on the card against the
    plain path on the CPU, over 3 AB2 steps, and an RK3 step (kernels 7
    and 9)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import math
    finals = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(size=(12, 8, 16), extent=(1.0, 1.0, 1.0),
                                  topology=BPP, halo=(3, 0, 0),
                                  dtype=torch.float64, device=device)
        for ts in ("QuasiAdamsBashforth2", "RungeKutta3"):
            m = ot.NonhydrostaticModel(
                grid=grid, advection=ot.WENO(5), coriolis=ot.FPlane(f=1.0),
                buoyancy=ot.BuoyancyTracer(), tracers=("b", "c"),
                timestepper=ts, fused_kernels="auto")
            s = m.initial_state(
                u=lambda x, y, z: torch.sin(2 * math.pi * x)
                * torch.cos(2 * math.pi * y),
                b=lambda x, y, z: torch.cos(2 * math.pi * z) + 0 * x,
                c=lambda x, y, z: torch.sin(2 * math.pi * y) + 0 * x)
            for _ in range(3 if ts == "QuasiAdamsBashforth2" else 1):
                s = m.step(s, 1e-2)
            finals[device, ts] = (m, s)
    for ts in ("QuasiAdamsBashforth2", "RungeKutta3"):
        (mk, sk), (mp, sp) = finals["cuda", ts], finals["cpu", ts]
        assert mk.fused_kernels == "weno5" and mp.fused_kernels is False
        for name in ("u", "v", "w"):
            a = mk.grid.interior(getattr(sk, name)).cpu()
            b = mp.grid.interior(getattr(sp, name))
            assert float((a - b).abs().max()) <= 1e-12 * max(
                float(b.abs().max()), 1.0)
        for name in ("b", "c"):
            a = mk.grid.interior(sk.tracers[name]).cpu()
            b = mp.grid.interior(sp.tracers[name])
            assert float((a - b).abs().max()) <= 1e-12 * float(
                b.abs().max())
