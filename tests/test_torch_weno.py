"""oceananigans_torch WENO advection and the plain versions of its four
WENO-5 kernels against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each relative to the largest reference value:

- 1e-12 in float64 against the JAX XLA path (``advection.WENO``): both
  evaluate the same whole-array formulas, so they differ by a few ulps;
- 3e-5 in float32 against the JAX Pallas kernels run with
  ``interpret=True``, the bound the JAX package holds its own kernels to
  (``tests/test_pallas_weno.py``): those kernels replace the divisions of
  the WENO-Z weights by an approximate reciprocal.

Only interior points are compared: both packages leave junk in y/z halo
rows, and the JAX kernels leave x-halo rows unwritten or zero. The port's
own x-halo contract is tested separately.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.ops import cuda_weno as cw
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)

F64 = torch.float64
RTOL64 = 1e-12
RTOL32 = 3e-5
BPP = (oj.Bounded, oj.Periodic, oj.Periodic)
#: the kernel layouts: the benchmark's halo-free periodic y/z (aligned to
#: the TPU's (8, 128) tiles, which the JAX kernels need), and a ragged
#: shape with halos of 3 on every axis
LAYOUTS = {"aligned": ((16, 16, 128), (3, 0, 0)),
           "haloed": ((10, 9, 7), (3, 3, 3))}
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "c": oj.LOC_C,
        "d": oj.LOC_C}


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


def setup(size, halo, dtype, seed=0, zero_u=False):
    """Both packages' grids and the same halo-filled random fields; with
    ``zero_u`` a band of u is exactly zero, so that some advecting
    velocities are exactly 0."""
    kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=BPP, halo=halo)
    jg = oj.RectilinearGrid(dtype=np.dtype(dtype).name, **kw)
    tg = ot.RectilinearGrid(dtype=dtype, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, loc in LOCS.items():
        a = rng.standard_normal(tg.shape).astype(dtype)
        if zero_u and name == "u":
            a[:, :, : a.shape[2] // 2] = 0.0
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = j_fill(jnp.asarray(a), jg, bcs, loc)
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=loc)
    return jg, tg, j, t


def assert_close(tg, got, ref, rtol, rows=None):
    """Interiors (x-rows ``rows`` of them, where given) within ``rtol`` of
    the largest reference value."""
    ii = tg.interior_slices
    if rows is not None:
        ii = (rows,) + ii[1:]
    got = got.detach().cpu().numpy()[ii]
    ref = np.asarray(ref)[ii]
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# WENO advection, port against the XLA path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["div_vu", "div_vv", "div_vw", "div_Uc"])
@pytest.mark.parametrize("order", [3, 5, 7, 9, 11])
def test_weno_advection_matches_xla(order, fn):
    """Bounded x with the order's halo, halo-free periodic y and z, and a
    band of exact zeros in u (the XLA path averages the two biased values
    where the advecting velocity is 0)."""
    B = (order + 1) // 2
    jg, tg, j, t = setup((2 * B + 4, 8, 12), (B, 0, 0), np.float64,
                         seed=order, zero_u=True)
    args = ("u", "v", "w") + (("c",) if fn == "div_Uc" else ())
    got = getattr(t_adv, fn)(tg, t_adv.WENO(order), *(t[a] for a in args))
    ref = getattr(j_adv, fn)(jg, j_adv.WENO(order), *(j[a] for a in args))
    assert_close(tg, got, ref, RTOL64)


@pytest.mark.parametrize("order", [7, 9, 11])
def test_reconstruction_coefficients_match(order):
    """The port's copy of the generated WENO coefficients equals the JAX
    module's, and the k = 3 forms are the classic Jiang–Shu indicators."""
    from oceananigans_torch.ops import reconstruction_coefficients as t_rc
    from oceananigans_tpu.ops import reconstruction_coefficients as j_rc
    assert t_rc.weno_substencils(order) == j_rc.weno_substencils(order)
    assert t_rc.weno_ideal_weights(order) == j_rc.weno_ideal_weights(order)
    for a, b in zip(t_rc.weno_beta_forms(order),
                    j_rc.weno_beta_forms(order)):
        np.testing.assert_array_equal(a, b)
    M1 = t_rc.weno_beta_forms(5)[1]
    classic = (13 / 12) * np.outer([1, -2, 1], [1, -2, 1]) \
        + 0.25 * np.outer([1, 0, -1], [1, 0, -1])
    np.testing.assert_allclose(M1, classic, rtol=0, atol=1e-12)


def test_weno_float32_ratio_cap():
    """A dimensional, piecewise-constant tracer: next to a jump one
    sub-stencil is flat (β = 0) while τ ~ 1e14, so the raw WENO-Z ratio
    reaches ~1e22 and its float32 square would overflow. The cap keeps the
    weights finite, as in the JAX package."""
    jg, tg, j, t = setup((10, 8, 12), (3, 0, 0), np.float32, seed=4)
    c = np.sign(t["c"].numpy()) * np.float32(1e7)
    got = t_adv.div_Uc(tg, t_adv.WENO(5), t["u"], t["v"], t["w"],
                       torch.tensor(c))
    ref = j_adv.div_Uc(jg, j_adv.WENO(5), j["u"], j["v"], j["w"],
                       jnp.asarray(c))
    assert torch.isfinite(got).all()
    assert_close(tg, got, ref, RTOL32)


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

def _xla_momentum(jg, j):
    sch = j_adv.WENO(5)
    return [-div(jg, sch, j["u"], j["v"], j["w"])
            for div in (j_adv.div_vu, j_adv.div_vv, j_adv.div_vw)]


def _xla_tracer(jg, j, name):
    return -j_adv.div_Uc(jg, j_adv.WENO(5), j["u"], j["v"], j["w"], j[name])


def _xla_science(jg, j, f):
    """The XLA path of the WENO science tendencies: momentum, FPlane(f),
    BuoyancyTracer on tracer "c", tracers "c" and "d"."""
    cor = oj.FPlane(f=f)
    force = oj.BuoyancyForce(oj.BuoyancyTracer())
    gu, gv, gw = _xla_momentum(jg, j)
    gu = gu - cor.x_f_cross_U(jg, j["u"], j["v"], j["w"])
    gv = gv - cor.y_f_cross_U(jg, j["u"], j["v"], j["w"])
    gw = gw + force.z_contribution(jg, {"b": j["c"]})
    return [gu, gv, gw, _xla_tracer(jg, j, "c"), _xla_tracer(jg, j, "d")]


def _port_kernel(kernel, tg, t, a=0.3, b=-0.1):
    """Run one kernel's plain version (through its wrapper, on the CPU) and
    return its outputs as a list, new fields before tendencies."""
    G = [t[n].clone() * 0.5 for n in ("u", "v", "w", "c", "d")]
    if kernel == "weno5_momentum_tendency":
        return list(cw.weno5_momentum_tendency(tg, t["u"], t["v"], t["w"]))
    if kernel == "weno5_tracer_tendencies":
        out = cw.weno5_tracer_tendencies(tg, t["u"], t["v"], t["w"],
                                         {"c": t["c"], "d": t["d"]})
        return [out["c"], out["d"]]
    if kernel == "weno5_ab2_update":
        return list(cw.weno5_ab2_update(tg, t["u"], t["v"], t["w"], *G[:3],
                                        a, b))
    un, vn, wn, cn, gu, gv, gw, gc = cw.weno5_science_ab2_update(
        tg, t["u"], t["v"], t["w"], {"c": t["c"], "d": t["d"]}, *G[:3],
        {"c": G[3], "d": G[4]}, a, b, f=1e-2, buoyancy_tracer="c")
    return [un, vn, wn, cn["c"], cn["d"], gu, gv, gw, gc["c"], gc["d"]]


def _xla_kernel(kernel, jg, j, a=0.3, b=-0.1):
    """The same outputs from the JAX XLA path."""
    if kernel == "weno5_momentum_tendency":
        return _xla_momentum(jg, j)
    if kernel == "weno5_tracer_tendencies":
        return [_xla_tracer(jg, j, "c"), _xla_tracer(jg, j, "d")]
    if kernel == "weno5_ab2_update":
        gs, names = _xla_momentum(jg, j), ("u", "v", "w")
    else:
        gs, names = _xla_science(jg, j, 1e-2), ("u", "v", "w", "c", "d")
    news = [j[n] + a * g + b * (0.5 * j[n]) for n, g in zip(names, gs)]
    return news + gs


KERNELS = ("weno5_ab2_update", "weno5_momentum_tendency",
           "weno5_science_ab2_update", "weno5_tracer_tendencies")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_xla(kernel, layout):
    """Each plain version against the XLA path in float64, on output rows
    [3, nx-3)."""
    size, halo = LAYOUTS[layout]
    jg, tg, j, t = setup(size, halo, np.float64, seed=1)
    got = _port_kernel(kernel, tg, t)
    ref = _xla_kernel(kernel, jg, j)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert_close(tg, g, r, RTOL64)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ab2_plain_is_science_plain_without_physics(layout):
    """The momentum AB2 step is the science step with no tracers, f = 0 and
    no buoyancy tracer, bit for bit in float64: the identity on which the
    momentum AB2 kernel runs as the science tile's momentum blocks
    alone."""
    size, halo = LAYOUTS[layout]
    _, tg, _, t = setup(size, halo, np.float64, seed=3)
    uvw = (t["u"], t["v"], t["w"])
    G = [0.5 * q for q in uvw]
    ab2 = cw.weno5_ab2_update_plain(tg, *uvw, *(g.clone() for g in G), 0.3,
                                    -0.1)
    sci = cw.weno5_science_ab2_update_plain(
        tg, *uvw, {}, *(g.clone() for g in G), {}, 0.3, -0.1)
    assert sci[3] == {} and sci[7] == {}
    for a, b in zip(ab2, (*sci[:3], *sci[4:7]), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_pallas_interpret(kernel):
    """Each plain version against the JAX kernel in interpret mode, in
    float32, at the aligned layout the JAX kernels accept."""
    from oceananigans_tpu.ops import pallas_weno as pw
    size, halo = LAYOUTS["aligned"]
    jg, tg, j, t = setup(size, halo, np.float32, seed=2)
    a, b = 0.3, -0.1
    u, v, w = j["u"], j["v"], j["w"]
    Gm = [0.5 * j[n] for n in ("u", "v", "w", "c", "d")]
    if kernel == "weno5_momentum_tendency":
        ref = pw.weno5_momentum_tendency(jg, u, v, w, interpret=True)
    elif kernel == "weno5_tracer_tendencies":
        out = pw.weno5_tracer_tendencies(jg, u, v, w,
                                         {"c": j["c"], "d": j["d"]},
                                         interpret=True)
        ref = [out["c"], out["d"]]
    elif kernel == "weno5_ab2_update":
        ref = pw.weno5_ab2_update(jg, u, v, w, *Gm[:3], a, b, interpret=True)
    else:
        un, vn, wn, cn, gu, gv, gw, gc = pw.weno5_science_ab2_update(
            jg, u, v, w, {"c": j["c"], "d": j["d"]}, *Gm[:3],
            {"c": Gm[3], "d": Gm[4]}, a, b, f=1e-2, buoyancy_tracer="c",
            interpret=True)
        ref = [un, vn, wn, cn["c"], cn["d"], gu, gv, gw, gc["c"], gc["d"]]
    got = _port_kernel(kernel, tg, t, a, b)
    assert len(got) == len(ref)
    # the JAX AB2 kernels write rows [3, nx-3) only
    rows = slice(3, size[0] + 3)
    for g, r in zip(got, ref):
        assert_close(tg, g, r, RTOL32, rows=rows)


def test_plain_halo_contract():
    """The port's x-halo rows: zero for the tendency kernels; copies of the
    inputs for the new fields of the AB2 kernels, whose tendencies are
    written over G_prev in place and keep G_prev's x-halo rows."""
    size, halo = LAYOUTS["haloed"]
    _, tg, _, t = setup(size, halo, np.float64, seed=3)
    H = cw.H
    for g in cw.weno5_momentum_tendency(tg, t["u"], t["v"], t["w"]):
        assert not g[:H].any() and not g[-H:].any()
    Gc = {"c": t["c"] * 2, "d": t["d"] * 3}
    G_prev = [t[n] * 4 for n in ("u", "v", "w")]
    before = [g.clone() for g in (*G_prev, *Gc.values())]
    out = cw.weno5_science_ab2_update(
        tg, t["u"], t["v"], t["w"], {"c": t["c"], "d": t["d"]}, *G_prev, Gc,
        0.1, 0.05, f=1.0, buoyancy_tracer="d")
    news = [*out[:3], *out[3].values()]
    gs = [*out[4:7], *out[7].values()]
    for q, src in zip(news, (t["u"], t["v"], t["w"], t["c"], t["d"])):
        assert q is not src
        assert torch.equal(q[:H], src[:H]) and torch.equal(q[-H:], src[-H:])
    for g, gm, old in zip(gs, (*G_prev, *Gc.values()), before):
        assert g is gm
        assert torch.equal(g[:H], old[:H]) and torch.equal(g[-H:], old[-H:])


def test_availability_gate():
    def grid(N, halo, topology=BPP):
        return ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                  topology=topology, halo=halo, dtype=F64)

    w5 = ot.WENO(5)
    # the TPU's (8, 128) alignment does not apply on the GPU
    assert cw.weno5_available(grid((8, 7, 9), (3, 0, 0)), w5)
    assert cw.weno5_available(grid((8, 7, 9), 3), w5)
    assert not cw.weno5_available(grid((8, 7, 9), (3, 0, 0)), ot.WENO(7))
    assert not cw.weno5_available(grid((8, 7, 9), (3, 0, 0)), ot.Centered())
    assert not cw.weno5_available(grid((8, 7, 9), (2, 0, 0)), w5)
    assert not cw.weno5_available(grid((8, 7, 9), (3, 2, 0)), w5)
    assert not cw.weno5_available(
        grid((8, 8, 8), (3, 0, 3), (ot.Bounded, ot.Bounded, ot.Periodic)),
        w5)
    jg = oj.RectilinearGrid(size=(16, 16, 128), extent=(1.0, 1.0, 1.0),
                            topology=BPP, halo=(3, 0, 0), dtype="float64")
    from oceananigans_tpu.ops.pallas_weno import weno5_available
    assert weno5_available(jg, oj.WENO(5))
    assert cw.weno5_available(grid((16, 16, 128), (3, 0, 0)), w5)


def test_wrappers_check_operands():
    size, halo = LAYOUTS["haloed"]
    _, tg, _, t = setup(size, halo, np.float64, seed=5)
    u, v, w, c = t["u"], t["v"], t["w"], t["c"]
    with pytest.raises(ValueError):
        cw.weno5_momentum_tendency(tg, u, v.float(), w)
    with pytest.raises(ValueError):
        cw.weno5_tracer_tendencies(tg, u, v, w, {"c": c[1:]})
    with pytest.raises(ValueError):
        cw.weno5_science_ab2_update(
            tg, u, v, w, {f"c{i}": c for i in range(cw.MAX_TRACERS + 1)},
            u, v, w, {f"c{i}": c for i in range(cw.MAX_TRACERS + 1)},
            0.1, 0.0)
    thin = ot.RectilinearGrid(size=tg.N, extent=(1.0, 1.0, 1.0),
                              topology=BPP, halo=(1, 1, 1), dtype=F64)
    with pytest.raises(ValueError):       # outputs need an x halo of 3
        cw.weno5_momentum_tendency(thin, *(
            torch.zeros(thin.shape, dtype=F64) for _ in range(3)))
    assert cw.weno5_tracer_tendencies(tg, u, v, w, {}) == {}
    counts = [k.launches for k in (
        cw.weno5_momentum_tendency, cw.weno5_tracer_tendencies,
        cw.weno5_ab2_update, cw.weno5_science_ab2_update)]
    cw.weno5_momentum_tendency(tg, u, v, w)
    cw.weno5_tracer_tendencies(tg, u, v, w, {"c": c})
    assert counts == [k.launches for k in (
        cw.weno5_momentum_tendency, cw.weno5_tracer_tendencies,
        cw.weno5_ab2_update, cw.weno5_science_ab2_update)]
