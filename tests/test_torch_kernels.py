"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (run with ``interpret=True`` on the CPU), in float64, and
the CUDA kernels against their plain versions where a GPU is present.

The JAX package is imported inside the tests that use it, so that the GPU
case also runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu

Tolerance: atol 1e-12 on interiors. The plain tendency is built from the
whole-array advection operators, which agree with the Pallas body to a few
float64 ulps of the largest tendency (~1e3 here), and the pressure
correction multiplies by 1/Δ exactly as the Pallas kernel does. Halo rows
are not compared against JAX: the JAX kernels leave them unwritten or pad
through them; the port's own halo contract is tested separately.
"""

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_kernels as ck

ATOL = 1e-12
F64 = torch.float64
BPP = (ot.Bounded, ot.Periodic, ot.Periodic)
SHAPES = {"aligned": ((8, 16, 128), (1, 0, 0)),
          "haloed": ((16, 12, 8), 1)}
LOCS = {"u": ot.LOC_U, "v": ot.LOC_V, "w": ot.LOC_W, "p": ot.LOC_C}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def grid_kwargs(shape):
    N, halo = SHAPES[shape]
    return dict(size=N, extent=(1.0, 2.0, 0.5), topology=BPP, halo=halo)


def torch_setup(shape, seed=0, device="cpu", dtype=F64):
    """The port's grid and halo-filled fields, with the numpy arrays they
    were made from."""
    tg = ot.RectilinearGrid(dtype=dtype, device=device, **grid_kwargs(shape))
    rng = np.random.default_rng(seed)
    arrays = {name: rng.standard_normal(tg.shape)
              for name in ("u", "v", "w", "p", "Gu", "Gv", "Gw")}
    t = {name: torch.tensor(a, dtype=dtype, device=device)
         for name, a in arrays.items()}
    for name, loc in LOCS.items():
        ot.fill_halo_regions(t[name], tg, loc=loc)
    return tg, arrays, t


def setup(shape, seed=0):
    """The same inputs in both packages, in float64 on the CPU."""
    import jax.numpy as jnp

    import oceananigans_tpu as oj
    from oceananigans_tpu.boundary_conditions import (
        fill_halo_regions, regularize_field_boundary_conditions,
    )
    tg, arrays, t = torch_setup(shape, seed)
    jg = oj.RectilinearGrid(dtype="float64", **grid_kwargs(shape))
    j = {name: jnp.asarray(a) for name, a in arrays.items()}
    for name, loc in LOCS.items():
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = fill_halo_regions(j[name], jg, bcs, loc)
    return jg, tg, j, t


def pallas_kernels():
    from oceananigans_tpu.ops import pallas_kernels as pk
    return pk


def assert_interiors(tg, got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(tg.interior(g).cpu().numpy(),
                                   np.asarray(r)[tg.interior_slices],
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tendency_plain_matches_pallas(shape):
    jg, tg, j, t = setup(shape)
    ref = pallas_kernels().centered2_momentum_tendency(jg, j["u"], j["v"], j["w"],
                                         interpret=True)
    got = ck.centered2_momentum_tendency(tg, t["u"], t["v"], t["w"])
    assert_interiors(tg, got, ref)
    for g in got:                         # x-halo rows are zero, as in JAX
        assert not g[0].any() and not g[-1].any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pressure_correction_plain_matches_pallas(shape):
    jg, tg, j, t = setup(shape, seed=1)
    dt = 1e-2
    ref = pallas_kernels().pressure_correction(jg, j["p"], j["u"], j["v"], j["w"], dt,
                                 interpret=True)
    got = ck.pressure_correction(tg, t["p"], t["u"], t["v"], t["w"], dt)
    assert_interiors(tg, got, ref)
    for g in got:
        assert not g[0].any() and not g[-1].any()


def test_ab2_update_plain_matches_pallas():
    """Only the aligned shape: the JAX kernel refuses y/z extents that are
    not multiples of (8, 128) (``pallas_kernels.py:612-613``)."""
    jg, tg, j, t = setup("aligned", seed=2)
    a, b = 1.6e-2, -0.6e-2
    ref = pallas_kernels().centered2_ab2_update(jg, j["u"], j["v"], j["w"], j["Gu"],
                                  j["Gv"], j["Gw"], a, b, interpret=True)
    G_prev = [t[n].clone() for n in ("Gu", "Gv", "Gw")]
    G_ids = [id(g) for g in G_prev]
    got = ck.centered2_ab2_update(tg, t["u"], t["v"], t["w"], *G_prev, a, b)
    assert_interiors(tg, got, ref)
    # the port's halo contract: G is written over G_prev in place and keeps
    # its x-halo rows; u' is new and copies u's x-halo rows (the JAX
    # kernel leaves them unwritten)
    assert [id(g) for g in got[3:]] == G_ids
    for name, g in zip(("Gu", "Gv", "Gw"), got[3:]):
        assert torch.equal(g[0], t[name][0]) and torch.equal(g[-1],
                                                             t[name][-1])
    for name, q in zip("uvw", got[:3]):
        assert q is not t[name]
        assert torch.equal(q[0], t[name][0]) and torch.equal(q[-1],
                                                             t[name][-1])


def test_fused_available_gates():
    def grid(N, halo, topology=BPP):
        return ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                  topology=topology, halo=halo, dtype=F64)

    c2 = ot.Centered(2)
    # the TPU's (8, 128) alignment does not apply on the GPU
    assert ck.fused_available(grid((5, 7, 9), (1, 0, 0)), c2)
    assert ck.fused_available(grid((16, 12, 8), 1), c2)
    assert not ck.fused_available(grid((8, 8, 8), (0, 1, 1)), c2)
    assert not ck.fused_available(
        grid((8, 8, 8), (1, 0, 1), (ot.Bounded, ot.Bounded, ot.Periodic)),
        c2)
    import oceananigans_tpu as oj
    jg = oj.RectilinearGrid(size=(8, 16, 128), extent=(1.0, 1.0, 1.0),
                            topology=BPP, halo=(1, 0, 0), dtype="float64")
    assert pallas_kernels().ab2_fused_available(jg, oj.Centered(2))
    assert ck.fused_available(grid((8, 16, 128), (1, 0, 0)), c2)


def test_wrappers_check_operands():
    tg, _, t = torch_setup("haloed")
    u, v, w = t["u"], t["v"], t["w"]
    with pytest.raises(ValueError):
        ck.centered2_momentum_tendency(tg, u, v.float(), w)
    with pytest.raises(ValueError):
        ck.centered2_momentum_tendency(
            tg, u, v.transpose(0, 2).contiguous().transpose(0, 2), w)
    with pytest.raises(ValueError):
        ck.pressure_correction(tg, t["p"][1:], u, v, w, 0.1)
    flat_x = ot.RectilinearGrid(size=tg.N, extent=(1.0, 1.0, 1.0),
                                topology=BPP, halo=(0, 1, 1), dtype=F64)
    with pytest.raises(ValueError):       # outputs need an x halo
        ck.centered2_momentum_tendency(flat_x, *(
            torch.zeros(flat_x.shape, dtype=F64) for _ in range(3)))
    with pytest.raises(TypeError):
        ck.centered2_ab2_update(tg, *(q.to(torch.int32) for q in (
            u, v, w, t["Gu"], t["Gv"], t["Gw"])), 0.1, 0.0)
    counts = (ck.centered2_ab2_update.launches,
              ck.centered2_momentum_tendency.launches,
              ck.pressure_correction.launches)
    ck.centered2_momentum_tendency(tg, u, v, w)
    ck.pressure_correction(tg, t["p"], u, v, w, 0.1)
    assert counts == (ck.centered2_ab2_update.launches,
                      ck.centered2_momentum_tendency.launches,
                      ck.pressure_correction.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_plain(dtype):
    """Each CUDA kernel against its plain version on the card. The stencils
    round in another order than the plain versions and contract into FMA,
    so they agree to a few ulps of the largest value (8 ulps allowed); the
    Poisson middle stage sums its products in its own order, in float32 as
    3xTF32 products on the tensor cores (1e-5 of the largest value in
    float32, 1e-12 in float64)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from oceananigans_torch.ops import cuda_poisson as cp
    tg, _, t = torch_setup("haloed", device="cuda", dtype=dtype)
    u, v, w, p = t["u"], t["v"], t["w"], t["p"]
    G = [t[n] for n in ("Gu", "Gv", "Gw")]
    pairs = [
        (ck.centered2_momentum_tendency(tg, u, v, w),
         ck.centered2_momentum_tendency_plain(tg, u, v, w)),
        (ck.pressure_correction(tg, p, u, v, w, 0.1),
         ck.pressure_correction_plain(tg, p, u, v, w, 0.1)),
        (ck.centered2_ab2_update(tg, u, v, w, *(g.clone() for g in G),
                                 0.2, -0.1),
         ck.centered2_ab2_update_plain(tg, u, v, w, *(g.clone() for g in G),
                                       0.2, -0.1)),
    ]
    stencil_rtol = 8 * torch.finfo(dtype).eps
    for got, ref in pairs:
        scale = max(float(b.abs().max()) for b in ref)
        for a, b in zip(got, ref):
            assert float((a - b).abs().max()) <= stencil_rtol * scale
    # kernel 2's x-marching tile on fields with exact zero rows (u zero on
    # every third z-column, v on every other x-plane), at a layout whose
    # plan has partial last panels in y and z and a shorter last segment
    # (tests/test_torch_tile_plans.py), every point compared: 8 ulps in
    # float32, and in float64 1e-12, the bound of the other float64
    # kernels, since there the plain version's products with areas and
    # division by volumes differ from a kernel's products with inverse
    # spacings by more than 8 ulps of the largest value at this layout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = ot.RectilinearGrid(size=(59, 20, 70), extent=(1.0, 2.0, 0.5),
                           topology=BPP, halo=(1, 0, 0), dtype=dtype,
                           device="cuda")
    py, pz, seg_len, nseg = ck.tendency_plan(g.shape, sms,
                                             torch.finfo(dtype).bits // 8)
    if sms == 132:
        assert 20 % py and 70 % pz and (61 - 2) % seg_len and nseg > 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    fs = []
    for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W)):
        a = torch.randn(g.shape, generator=gen, device="cuda", dtype=dtype)
        if n == 0:
            a[:, :, ::3] = 0.0
        if n == 1:
            a[::2] = 0.0
        fs.append(ot.fill_halo_regions(a, g, loc=loc))
    n0 = ck.centered2_momentum_tendency.launches
    got = ck.centered2_momentum_tendency(g, *fs)
    ref = ck.centered2_momentum_tendency_plain(g, *fs)
    torch.cuda.synchronize()
    assert ck.centered2_momentum_tendency.launches == n0 + 1
    scale = max(float(b.abs().max()) for b in ref)
    rtol = stencil_rtol if dtype == torch.float32 else 1e-12
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= rtol * scale
    # the Poisson middle stage on the haloed grid, at shapes whose y and z
    # extents differ and are not multiples of the 128 x 128 tile, nor
    # (30, 20, 40) of the 4-float runs the 16-byte copies take, and at the
    # main path's 256 x 256 planes, whose sums over 256 terms show how the
    # float32 path accumulates
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for N in (tg.N, (8, 24, 136), (30, 20, 40), (2, 256, 256)):
        g = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 0.5), topology=BPP,
                               halo=1, dtype=dtype, device="cuda")
        s = ot.MatmulPoissonSolver(g)
        x = torch.randn(N, dtype=dtype, device="cuda")
        args = (x, s.T1, s.T2, s.lam0.to(dtype), s.lam1, s.lam2)
        n0 = cp.fused_middle_solve.launches
        got = cp.fused_middle_solve(*args)
        ref = cp.fused_middle_solve_plain(*args)
        torch.cuda.synchronize()
        assert cp.fused_middle_solve.launches == n0 + 1
        assert float((got - ref).abs().max()) <= rtol * float(
            ref.abs().max()), N


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_science_kernel_matches_plain(shape, dtype):
    """The Centered-2 science kernel against its plain version on the card,
    two tracers with one of them the buoyancy: 8 ulps of each group's
    largest value (the updated fields, the tendencies), as for the other
    Centered-2 kernels."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    tg, _, t = torch_setup(shape, seed=3, device="cuda", dtype=dtype)
    u, v, w = t["u"], t["v"], t["w"]
    tr = {"b": t["p"], "c": t["Gw"].clone()}
    G = [t[n] for n in ("Gu", "Gv", "Gw")] + [0.5 * t["p"], 0.5 * t["u"]]

    def run(fn):
        out = fn(tg, u, v, w, tr, *(g.clone() for g in G[:3]),
                 {"b": G[3].clone(), "c": G[4].clone()}, 0.2, -0.1, f=0.5,
                 buoyancy_tracer="b")
        return ([*out[:3], *out[3].values()], [*out[4:7], *out[7].values()])

    n0 = ck.centered2_science_ab2_update.launches
    got, ref = run(ck.centered2_science_ab2_update), run(
        ck.centered2_science_ab2_update_plain)
    torch.cuda.synchronize()
    assert ck.centered2_science_ab2_update.launches == n0 + 1
    rtol = 8 * torch.finfo(dtype).eps
    for gs, rs in zip(got, ref):
        scale = max(float(r.abs().max()) for r in rs)
        for a, b in zip(gs, rs):
            assert float((a - b).abs().max()) <= rtol * scale
