"""oceananigans_torch's WENO tracer kernel, WENO vector-invariant kernel and
vector-invariant momentum advection against the JAX package, on the CPU.

On the CPU the kernels' wrappers run their plain versions, so these tests
hold the kernel code paths (gates, metric profiles, operand checks) and the
plain versions to the JAX package; the CUDA kernels themselves are held to
the plain versions on the card (``tests/test_torch_hydrostatic_gpu.py``,
``tests/test_torch_sphere_gpu.py``, ``chip_smoke.py``). The gates are
also held to the JAX gates on lat-lon grids and at mixed order 4-tuples,
and the kernel paths to the JAX Pallas kernels on the lat-lon sector. Inputs are made with numpy from a seed and handed to
both packages. Tolerance: 1e-12 of the largest reference value, in float64
(both packages evaluate the same whole-array formulas, or the JAX Pallas
kernels the same terms in interpret mode).

The coefficient header ``csrc/weno_tables.h`` is read here and every
literal held to the JAX package's Python tables to one float64 ulp.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.models import hydrostatic as j_hyd

RTOL = 1e-12
F64 = torch.float64
BBB = (oj.Bounded, oj.Bounded, oj.Bounded)
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "T": oj.LOC_C,
        "S": oj.LOC_C}
HEADER = (Path(__file__).resolve().parent.parent / "oceananigans_torch"
          / "csrc" / "weno_tables.h")


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


def setup(size, halo, topology=BBB, extent=(1.0, 2.0, 0.5), seed=3,
          zero_bands=False):
    """Both packages' grids and the same halo-filled random fields; with
    ``zero_bands`` u and v are exactly zero on some rows, so that advecting
    velocities of both signs and exact zeros meet."""
    kw = dict(size=size, extent=extent, topology=topology, halo=halo)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, loc in LOCS.items():
        a = rng.standard_normal(tg.shape)
        if zero_bands and name == "u":
            a[:, :, ::3] = 0.0
        if zero_bands and name == "v":
            a[::2] = 0.0
        bcs = regularize_field_boundary_conditions(None, jg, loc)
        j[name] = j_fill(jnp.asarray(a), jg, bcs, loc)
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=loc)
    return jg, tg, j, t


def assert_close(got, ref, S=(slice(None),) * 3, rtol=RTOL):
    got = got.detach().numpy()[S]
    ref = np.asarray(ref)[S]
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# The coefficient header
# ---------------------------------------------------------------------------

def _parse_header():
    """{order: {table name: flat list of numbers, "form": BetaForm}}."""
    text = HEADER.read_text()
    number = r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"
    tables = {}
    for m in re.finditer(r"struct WenoTable<(\d+)> \{(.*?)\n\};", text, re.S):
        body = m.group(2)
        entry = {"form": re.search(r"BetaForm::(\w+);", body).group(1),
                 "B": int(re.search(r"int B = (\d+);", body).group(1))}
        for f in re.finditer(r"static constexpr \w+ (\w+)\([^)]*\) \{\s*"
                             r"constexpr \w+ c[\[\]\d]+ = (\{.*?\});",
                             body, re.S):
            entry[f.group(1)] = [float(x) for x in
                                 re.findall(number, f.group(2))]
        tables[int(m.group(1))] = entry
    return tables


def _quadratic_form(beta, B):
    """The symmetric matrix of the quadratic form ``beta(v)`` in B values."""
    e = np.eye(B)
    Q = np.zeros((B, B))
    for m in range(B):
        Q[m, m] = beta(e[m])
    for m in range(B):
        for n in range(m + 1, B):
            Q[m, n] = Q[n, m] = 0.5 * (beta(e[m] + e[n]) - Q[m, m]
                                       - Q[n, n])
    return Q


def _within_ulp(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= np.spacing(np.abs(ref))), (got, ref)


@pytest.mark.parametrize("order", [3, 5, 7, 9, 11])
def test_weno_tables_header_matches_python(order):
    """Every literal of ``csrc/weno_tables.h`` against the JAX package's
    tables: the sub-stencil offsets and coefficients, the ideal weights and
    the smoothness forms (the hand forms of orders 3, 5 and 7, the
    generated quadratic forms of 9 and 11), each to one ulp."""
    from oceananigans_tpu.ops import reconstruction_coefficients as j_rc
    tab = _parse_header()[order]
    B = (order + 1) // 2
    assert tab["B"] == B
    if order in j_adv._WENO_Q:
        qs, gammas = j_adv._WENO_Q[order], j_adv._WENO_GAMMA[order]
    else:
        qs = j_rc.weno_substencils(order)
        gammas = j_rc.weno_ideal_weights(order)
    lo = [min(q) for q in qs]
    assert tab["lo"] == lo
    assert all(sorted(q) == list(range(lo[r], lo[r] + B))
               for r, q in enumerate(qs))
    _within_ulp(tab["q"], [q[lo[r] + j] for r, q in enumerate(qs)
                           for j in range(B)])
    _within_ulp(tab["gamma"], gammas)

    def python_beta(r):
        def beta(v):
            s = {n: 0.0 for n in range(-B, B)}
            for j in range(B):
                s[lo[r] + j] = v[j]
            if order in j_adv._WENO_BETAS:
                return j_adv._WENO_BETAS[order](s)[r]
            return j_adv.WENO(order)._betas_from_forms(s)[r]
        return beta

    if order in (3, 5):
        assert tab["form"] == "kSquares"
        w = tab["w"]
        _within_ulp(w, (1.0,) if order == 3 else (13.0 / 12.0, 0.25))
        L = np.reshape(tab["l"], (B, len(w), B))
        assert np.array_equal(L, np.round(L))     # integer stencils
        for r in range(B):
            Q = sum(wt * np.outer(L[r, t], L[r, t]) for t, wt in enumerate(w))
            np.testing.assert_allclose(Q, _quadratic_form(python_beta(r), B),
                                       rtol=0, atol=1e-13)
        return
    assert tab["form"] == "kTriangular"
    P = np.reshape(tab["p"], (B, B, B))
    for r in range(B):
        assert not np.triu(P[r].T, 1).any()       # upper-triangular
        if order == 7:
            # the Balsara–Shu integers, read off the Python hand forms
            Q = _quadratic_form(python_beta(r), B)
            ref = np.triu(2 * Q, 1) + np.diag(np.diag(Q))
            assert np.array_equal(P[r], ref)
        else:
            M = j_rc.weno_beta_forms(order)[r]
            ref = np.triu(np.where(np.abs(M) > 1e-14, 2 * M, 0.0), 1) \
                + np.diag(np.diag(M))
            _within_ulp(P[r], ref)


# ---------------------------------------------------------------------------
# Kernel 11: WENO tracer tendencies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [5, 7])
def test_tracer_kernel_path_matches_xla(order):
    """``weno_tracer_tendencies`` (its plain version on the CPU) against
    the JAX −div_Uc on ``tests/test_pallas_vi.py``'s grids, every point."""
    B = (order + 1) // 2
    jg, tg, j, t = setup((16, 12, 8), B + 1, seed=7)
    sch = ot.WENO(order)
    assert ctr.tracer_fusion_available(tg, sch)
    got = ctr.weno_tracer_tendencies(tg, sch, t["u"], t["v"], t["w"],
                                     {"T": t["T"], "S": t["S"]})
    for name in ("T", "S"):
        ref = -j_adv.div_Uc(jg, j_adv.WENO(order), j["u"], j["v"], j["w"],
                            j[name])
        assert_close(got[name], ref)


def test_tracer_kernel_path_matches_pallas_zyx():
    """The port against the JAX kernel in its transposed (z, y, x) layout,
    in interpret mode, on the interior (the JAX kernel writes zeros into
    its output's z-halo rows)."""
    from oceananigans_tpu.ops.pallas_tracer import weno_tracer_tendencies
    jg, tg, j, t = setup((16, 12, 8), 5, seed=5)
    ref = weno_tracer_tendencies(jg, j_adv.WENO(7), j["u"], j["v"], j["w"],
                                 {"T": j["T"], "S": j["S"]}, interpret=True,
                                 layout="zyx")
    got = ctr.weno_tracer_tendencies(tg, ot.WENO(7), t["u"], t["v"], t["w"],
                                     {"T": t["T"], "S": t["S"]})
    for name in ("T", "S"):
        assert_close(got[name], ref[name], tg.interior_slices)


def test_tracer_gate():
    """The port's gate against the JAX one: the same verdict on the JAX
    tests' grids and on ``hydro_vi``'s; the port also takes halo-free
    periodic axes of any length (the JAX kernel needs (8, 128) alignment)
    and a halo-free periodic x."""
    from oceananigans_tpu.ops.pallas_tracer import (
        tracer_fusion_available, transposed_layout_preferred,
    )

    def both(size, halo, topology=BBB):
        kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=topology,
                  halo=halo)
        return (oj.RectilinearGrid(dtype="float64", **kw),
                ot.RectilinearGrid(dtype=F64, **kw))

    for order, halo in ((5, 4), (7, 5), (7, 3)):
        jg, tg = both((16, 12, 8), halo)
        assert ctr.tracer_fusion_available(tg, ot.WENO(order)) == \
            tracer_fusion_available(jg, j_adv.WENO(order))
    jg, tg = both((360, 160, 60), (6, 6, 4),
                  (oj.Periodic, oj.Bounded, oj.Bounded))
    assert ctr.tracer_fusion_available(tg, ot.WENO(7))
    assert tracer_fusion_available(jg, j_adv.WENO(7))
    assert transposed_layout_preferred(jg, j_adv.WENO(7))
    assert not ctr.tracer_fusion_available(tg, ot.Centered())
    # where the gates differ: halo-free periodic y of 12, x of 12
    PPB = (oj.Periodic, oj.Periodic, oj.Bounded)
    for halo in ((4, 0, 4), (0, 4, 4)):
        jg, tg = both((12, 12, 8), halo, PPB)
        assert ctr.tracer_fusion_available(tg, ot.WENO(7))
        assert not tracer_fusion_available(jg, j_adv.WENO(7))


def test_tracer_gate_differences_match_xla():
    """On the layouts only the port's gate takes, its kernel path matches
    the JAX XLA path (the halo-free periodic wrap is the boundary)."""
    PPB = (oj.Periodic, oj.Periodic, oj.Bounded)
    jg, tg, j, t = setup((12, 10, 8), (0, 0, 4), PPB, seed=9)
    sch = ot.WENO(7)
    assert ctr.tracer_fusion_available(tg, sch)
    got = ctr.weno_tracer_tendencies(tg, sch, t["u"], t["v"], t["w"],
                                     {"T": t["T"]})
    ref = -j_adv.div_Uc(jg, j_adv.WENO(7), j["u"], j["v"], j["w"], j["T"])
    assert_close(got["T"], ref)


# ---------------------------------------------------------------------------
# Kernels 12/13: the WENO vector-invariant momentum tendency
# ---------------------------------------------------------------------------

VI_GRIDS = {
    # tests/test_pallas_vi.py:47-68
    "bounded": ((16, 12, 8), 6, BBB, None),
    "halofree5": ((12, 16, 128), (4, 0, 0),
                  (oj.Bounded, oj.Periodic, oj.Periodic), 5),
}


def _vi_pair(stencil, order=None):
    kw = dict(vorticity_stencil=stencil)
    if order is not None:
        kw["order"] = order
    return ot.WENOVectorInvariant(**kw), j_hyd.WENOVectorInvariant(**kw)


@pytest.mark.parametrize("stencil", ["velocity", "default"])
@pytest.mark.parametrize("grid", sorted(VI_GRIDS))
def test_vi_kernel_path_matches_xla(grid, stencil):
    """``vi_momentum_tendency`` (its plain version on the CPU) against the
    JAX ``u_tendency``/``v_tendency``, every point."""
    size, halo, topo, order = VI_GRIDS[grid]
    jg, tg, j, t = setup(size, halo, topo)
    tvi, jvi = _vi_pair(stencil, order)
    assert cvi.vi_available(tg, tvi)
    Gu, Gv = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    assert_close(Gu, jvi.u_tendency(jg, j["u"], j["v"], j["w"]))
    assert_close(Gv, jvi.v_tendency(jg, j["u"], j["v"], j["w"]))


def test_vi_kernel_path_zero_velocities():
    """Exact zeros in u and v: the Bernoulli self difference then takes the
    mean of both biased values, every other term either side times 0."""
    jg, tg, j, t = setup((16, 12, 8), 6, zero_bands=True)
    tvi, jvi = _vi_pair("velocity")
    Gu, Gv = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    assert_close(Gu, jvi.u_tendency(jg, j["u"], j["v"], j["w"]))
    assert_close(Gv, jvi.v_tendency(jg, j["u"], j["v"], j["w"]))


@pytest.mark.parametrize("layout", ["xyz", "zyx"])
def test_vi_kernel_path_matches_pallas(layout):
    """The port against the JAX kernels ``vi_momentum_tendency`` ((x, y,
    z) layout) and ``vi_momentum_tendency_zyx`` in interpret mode, on the
    interior (the JAX kernels write zeros into their output halo rows)."""
    from oceananigans_tpu.ops import pallas_vi
    fn = (pallas_vi.vi_momentum_tendency if layout == "xyz"
          else pallas_vi.vi_momentum_tendency_zyx)
    jg, tg, j, t = setup((16, 12, 8), 6)
    tvi, jvi = _vi_pair("velocity")
    ref = fn(jg, jvi, j["u"], j["v"], j["w"], interpret=True)
    got = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    for g, r in zip(got, ref):
        assert_close(g, r, tg.interior_slices)


def test_vi_gate():
    """The cases of ``test_vi_availability_gate`` and ``hydro_vi``'s grid,
    with the JAX gates beside the port's."""
    from oceananigans_tpu.ops.pallas_vi import (
        vi_available, vi_transposed_layout_preferred,
    )

    def both(size, halo, topology=BBB):
        kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=topology,
                  halo=halo)
        return (oj.RectilinearGrid(dtype="float64", **kw),
                ot.RectilinearGrid(dtype=F64, **kw))

    jg, tg = both((16, 12, 8), 6)
    tvi, jvi = _vi_pair("velocity")
    assert cvi.vi_available(tg, tvi) and vi_available(jg, jvi)
    # conserving schemes and cross-and-self upwinding stay unfused
    assert not cvi.vi_available(tg, ot.VectorInvariant())
    assert not vi_available(jg, j_hyd.VectorInvariant())
    assert not cvi.vi_available(tg, ot.WENOVectorInvariant(
        upwinding=ot.CrossAndSelfUpwinding()))
    assert not cvi.vi_available(tg, ot.WENOVectorInvariant(
        multi_dimensional_stencil=True))
    # insufficient x halo for WENO-9 vorticity; order 5 fits
    jg, tg = both((16, 12, 8), 4)
    assert not cvi.vi_available(tg, ot.WENOVectorInvariant())
    assert not vi_available(jg, j_hyd.WENOVectorInvariant())
    assert cvi.vi_available(tg, ot.WENOVectorInvariant(order=5))
    assert vi_available(jg, j_hyd.WENOVectorInvariant(order=5))
    # the other three schemes of order 3 (the order=N family): both take it
    assert cvi.vi_available(tg, ot.WENOVectorInvariant(order=3))
    assert vi_available(jg, j_hyd.WENOVectorInvariant(order=3))
    # hydro_vi: both gates hold (the JAX model takes the transposed kernel)
    jg, tg = both((360, 160, 60), (6, 6, 4),
                  (oj.Periodic, oj.Bounded, oj.Bounded))
    tvi, jvi = _vi_pair("velocity")
    assert cvi.vi_available(tg, tvi)
    assert vi_available(jg, jvi) and vi_transposed_layout_preferred(jg, jvi)
    assert cvi.vi_reach(tvi) == (5, 5, 3)


@pytest.mark.parametrize("halo", [(5, 5, 3), (0, 6, 4)])
def test_vi_gate_differences(halo):
    """Where the port's gate differs from the JAX ones: halo (5, 5, 3) is
    the kernel's own reach (the JAX gates ask 6 on y and 4 on z), (0, 6, 4)
    a halo-free periodic x. The kernel path's interior then equals the one
    computed on a (7, 7, 5)-halo grid from the same interior fields."""
    from oceananigans_tpu.ops.pallas_vi import (
        vi_available, vi_transposed_layout_preferred,
    )
    size = (14, 10, 6)
    PBB = (oj.Periodic, oj.Bounded, oj.Bounded)
    jg, tg, _, t = setup(size, halo, PBB, seed=4)
    tvi, jvi = _vi_pair("velocity")
    assert cvi.vi_available(tg, tvi)
    assert not (vi_available(jg, jvi)
                or vi_transposed_layout_preferred(jg, jvi))
    wide = ot.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                              topology=PBB, halo=(7, 7, 5), dtype=F64)
    tw = {}
    for name in ("u", "v", "w"):
        a = torch.zeros(wide.shape, dtype=F64)
        a[wide.interior_slices] = tg.interior(t[name])
        tw[name] = ot.fill_halo_regions(a, wide, loc=LOCS[name])
    got = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    ref = cvi.vi_momentum_tendency(wide, tvi, tw["u"], tw["v"], tw["w"])
    for g, r in zip(got, ref):
        torch.testing.assert_close(tg.interior(g), wide.interior(r),
                                   rtol=0, atol=1e-13 * float(r.abs().max()))


ALL_ORDERS = (3, 5, 7, 9, 11)


@pytest.mark.parametrize("rest", ALL_ORDERS)
@pytest.mark.parametrize("vorticity", ALL_ORDERS)
def test_vi_gate_orders(vorticity, rest):
    """Every (vorticity, rest) WENO order pair: on a grid whose halo holds
    every reach both gates take them all, the pairs of ``ORDER_PAIRS``
    (``WENOVectorInvariant(vorticity_order=N)`` and ``(order=N)``) as
    instantiated pairs, the others such as (7, 3) in the instantiation of
    runtime orders. On ``hydro_vi``'s grid, halo (6, 6, 4), the port takes
    a pair exactly where its reach fits, and so does the JAX gate with one
    more halo row on y and z."""
    from oceananigans_tpu.ops.pallas_vi import vi_available
    tvi = ot.WENOVectorInvariant(vorticity_order=vorticity, order=rest)
    jvi = j_hyd.WENOVectorInvariant(vorticity_order=vorticity, order=rest)
    pair = (vorticity, rest) in cvi.ORDER_PAIRS
    assert pair == (rest == 5 or rest == vorticity)
    kw = dict(size=(16, 12, 8), extent=(1.0, 2.0, 0.5), topology=BBB,
              halo=7)
    assert vi_available(oj.RectilinearGrid(dtype="float64", **kw), jvi)
    assert cvi.vi_available(ot.RectilinearGrid(dtype=F64, **kw), tvi)
    kw = dict(size=(360, 160, 60), extent=(4e7, 2e7, 4e3),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded),
              halo=(6, 6, 4))
    reach = cvi.vi_reach(tvi)
    fits = reach[0] <= 6 and reach[1] <= 6 and reach[2] <= 4
    port = cvi.vi_available(ot.RectilinearGrid(dtype=F64, **kw), tvi)
    assert port == fits
    # the JAX gate asks one more halo row on y and z
    jax_fits = reach[0] <= 6 and reach[1] <= 5 and reach[2] <= 3
    assert vi_available(oj.RectilinearGrid(dtype="float64", **kw), jvi) \
        == jax_fits


#: (vorticity, kinetic energy gradient, divergence, vertical) WENO orders
#: and the roles whose epsilon is 1e-6 (the others 1e-8)
ORDER_MIXES = [((9, 7, 5, 3), (3,)), ((7, 3, 3, 3), ()),
               ((5, 11, 7, 9), (0, 2)), ((3, 5, 7, 11), (1,)),
               ((11, 3, 9, 5), (0, 1, 2, 3)), ((9, 5, 5, 5), (3,)),
               ((5, 5, 5, 5), (1,))]


def mixed_vi(pkg, hyd, orders, eps_roles=(), stencil="velocity"):
    """A ``VectorInvariant`` of the four WENO ``orders``, the roles of
    ``eps_roles`` with an epsilon of 1e-6."""
    s = [pkg.WENO(k, epsilon=1e-6 if r in eps_roles else 1e-8)
         for r, k in enumerate(orders)]
    return hyd.VectorInvariant(
        vorticity_scheme=s[0], vorticity_stencil=stencil,
        kinetic_energy_gradient_scheme=s[1], divergence_scheme=s[2],
        vertical_scheme=s[3])


def latlon_grids(size=(16, 12, 8), halo=7, x_regular=True, z_regular=True,
                 latitude=(-70.0, 70.0)):
    """Both packages' lat-lon grids, with stretched x or z faces where a
    flag is False."""
    lon = (0.0, 360.0)
    z = (-500.0, 0.0)
    jlon = lon if x_regular else tuple(
        360.0 * (np.arange(size[0] + 1) / size[0]) ** 1.2)
    jz = z if z_regular else tuple(
        -500.0 * (1.0 - np.arange(size[2] + 1) / size[2]) ** 1.5)
    jg = oj.LatitudeLongitudeGrid(
        size=size, longitude=np.asarray(jlon) if not x_regular else jlon,
        latitude=latitude, z=np.asarray(jz) if not z_regular else jz,
        halo=halo, dtype="float64",
        topology=(oj.Periodic, oj.Bounded, oj.Bounded))
    tg = ot.LatitudeLongitudeGrid(
        size=size, longitude=np.asarray(jlon) if not x_regular else jlon,
        latitude=latitude, z=np.asarray(jz) if not z_regular else jz,
        halo=halo, dtype=F64)
    assert (jg.x_regular, jg.z_regular) == (tg.x_regular, tg.z_regular) \
        == (x_regular, z_regular)
    return jg, tg


@pytest.mark.parametrize("halo", [7, 4])
@pytest.mark.parametrize("regular", [(True, True), (False, True),
                                     (True, False), (False, False)],
                         ids=["xz", "z", "x", "none"])
def test_gates_match_jax_on_latlon(regular, halo):
    """The lat-lon gates of rows 11 and 12/13, held to the JAX gates: a
    lat-lon grid regular in x and z with every tracer order and every
    order mix of :data:`ORDER_MIXES` (per-role epsilons) on both vorticity
    stencils; the same refused where x or z is stretched. The documented
    halo rule is the one difference: the JAX VI gate asks one more row on
    y and z than the kernel reads."""
    from oceananigans_tpu.ops.pallas_tracer import (
        tracer_fusion_available as j_tracer_ok,
    )
    from oceananigans_tpu.ops.pallas_vi import vi_available as j_vi_ok
    jg, tg = latlon_grids(halo=halo, x_regular=regular[0],
                          z_regular=regular[1])
    takes = all(regular)
    for order in ALL_ORDERS:
        reach = (order + 1) // 2
        assert ctr.tracer_fusion_available(tg, ot.WENO(order)) \
            == j_tracer_ok(jg, oj.WENO(order)) \
            == (takes and reach <= halo)
    for orders, eps_roles in ORDER_MIXES:
        for stencil in ("velocity", "default"):
            tvi = mixed_vi(ot, ot, orders, eps_roles, stencil)
            jvi = mixed_vi(oj, j_hyd, orders, eps_roles, stencil)
            r = cvi.vi_reach(tvi)
            port = takes and r[0] <= halo and r[1] <= halo \
                and r[2] <= halo
            jax = takes and r[0] <= halo and r[1] + 1 <= halo \
                and r[2] + 1 <= halo
            assert cvi.vi_available(tg, tvi) == port, (orders, stencil)
            assert j_vi_ok(jg, jvi) == jax, (orders, stencil)


def test_gates_refuse_what_jax_refuses():
    """Both packages' gates refuse an orthogonal grid, a non-WENO or
    upwinded-cross-term scheme, and the multidimensional stencil, on
    lat-lon as on rectilinear grids."""
    from oceananigans_tpu.ops.pallas_tracer import (
        tracer_fusion_available as j_tracer_ok,
    )
    from oceananigans_tpu.ops.pallas_vi import vi_available as j_vi_ok
    kw = dict(size=(16, 10, 6), z=(-100.0, 0.0), halo=7)
    jt = oj.TripolarGrid(dtype="float64", **kw)
    tt = ot.TripolarGrid(dtype=F64, **kw)
    for jg, tg in ((jt, tt), latlon_grids()):
        istrip = tg is tt
        assert ctr.tracer_fusion_available(tg, ot.WENO(5)) \
            == j_tracer_ok(jg, oj.WENO(5)) == (not istrip)
        assert cvi.vi_available(tg, ot.WENOVectorInvariant()) \
            == j_vi_ok(jg, j_hyd.WENOVectorInvariant()) == (not istrip)
        for kwv in (dict(upwinding=ot.CrossAndSelfUpwinding()),
                    dict(multi_dimensional_stencil=True)):
            jkw = {k: (oj.CrossAndSelfUpwinding() if k == "upwinding"
                       else v) for k, v in kwv.items()}
            assert not cvi.vi_available(tg, ot.WENOVectorInvariant(**kwv))
            assert not j_vi_ok(jg, j_hyd.WENOVectorInvariant(**jkw))
        for tvi, jvi in ((ot.VectorInvariant(), j_hyd.VectorInvariant()),
                         (ot.VectorInvariant(
                             vorticity_scheme=ot.UpwindBiased(5),
                             vertical_scheme=ot.WENO(5)),
                          j_hyd.VectorInvariant(
                              vorticity_scheme=oj.UpwindBiased(5),
                              vertical_scheme=oj.WENO(5)))):
            assert not cvi.vi_available(tg, tvi)
            assert not j_vi_ok(jg, jvi)
        assert not ctr.tracer_fusion_available(tg, ot.UpwindBiased(5))
        assert not j_tracer_ok(jg, oj.UpwindBiased(5))


def latlon_sector_fields(halo, seed):
    """The lat-lon sector of the JAX package's kernel tests, (24, 16, 8)
    on 30°W-30°E, 15°N-55°N, 1 km deep, in both packages, and the same
    halo-filled random u, v, w, c."""
    kw = dict(size=(24, 16, 8), longitude=(-30.0, 30.0),
              latitude=(15.0, 55.0), z=(-1000.0, 0.0), halo=halo)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name in ("u", "v", "w", "T"):
        a = rng.standard_normal(jg.shape)
        bcs = regularize_field_boundary_conditions(None, jg, LOCS[name])
        j[name] = j_fill(jnp.asarray(a), jg, bcs, LOCS[name])
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=LOCS[name])
    return jg, tg, j, t


@pytest.mark.parametrize("momentum", ["default", "order5", "mixed"])
def test_vi_kernel_path_matches_pallas_latlon(momentum):
    """The port's kernel path on the CPU (its plain version) against the
    JAX Pallas kernel in interpret mode on the lat-lon sector, over the
    interior (the Pallas kernel writes zeros into its output halo rows):
    ``WENOVectorInvariant()``, ``(order=5)`` and the mixed orders
    (9, 7, 5, 3) with the vertical scheme's own epsilon."""
    from oceananigans_tpu.ops.pallas_vi import (
        vi_available, vi_momentum_tendency,
    )
    jg, tg, j, t = latlon_sector_fields(6, seed=9)
    if momentum == "mixed":
        tvi = mixed_vi(ot, ot, (9, 7, 5, 3), (3,))
        jvi = mixed_vi(oj, j_hyd, (9, 7, 5, 3), (3,))
    else:
        kw = {} if momentum == "default" else dict(order=5)
        tvi = ot.WENOVectorInvariant(**kw)
        jvi = j_hyd.WENOVectorInvariant(**kw)
    assert cvi.vi_available(tg, tvi) and vi_available(jg, jvi)
    ref = vi_momentum_tendency(jg, jvi, j["u"], j["v"], j["w"],
                               interpret=True)
    got = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    S = tg.interior_slices
    for g, r in zip(got, ref):
        r = np.asarray(r)[S]
        assert float(np.abs(g.numpy()[S] - r).max()) <= RTOL * float(
            np.abs(r).max())


@pytest.mark.parametrize("order", [5, 7])
def test_tracer_kernel_path_matches_pallas_latlon(order):
    """The tracer kernel path against the JAX Pallas tracer kernel in
    interpret mode on the lat-lon sector, over the interior."""
    from oceananigans_tpu.ops.pallas_tracer import weno_tracer_tendencies
    jg, tg, j, t = latlon_sector_fields(5, seed=13)
    ref = weno_tracer_tendencies(jg, oj.WENO(order), j["u"], j["v"],
                                 j["w"], {"T": j["T"]}, interpret=True)
    got = ctr.weno_tracer_tendencies(tg, ot.WENO(order), t["u"], t["v"],
                                     t["w"], {"T": t["T"]})
    S = tg.interior_slices
    r = np.asarray(ref["T"])[S]
    assert float(np.abs(got["T"].numpy()[S] - r).max()) <= RTOL * float(
        np.abs(r).max())


VI_FAMILIES = [dict(order=7), dict(vorticity_order=3),
               dict(vorticity_order=7), dict(vorticity_order=11)]


@pytest.mark.parametrize("stencil", ["velocity", "default"])
@pytest.mark.parametrize("orders", VI_FAMILIES,
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_vi_kernel_path_orders_match_xla(orders, stencil):
    """The order pairs beyond the default through the kernel path (its
    plain version on the CPU) against the JAX ``u_tendency``/
    ``v_tendency``, every point, on fields with exact zero rows."""
    jg, tg, j, t = setup((16, 12, 8), 6, zero_bands=True, seed=11)
    kw = dict(orders, vorticity_stencil=stencil)
    tvi = ot.WENOVectorInvariant(**kw)
    jvi = j_hyd.WENOVectorInvariant(**kw)
    assert cvi.vi_available(tg, tvi)
    Gu, Gv = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    assert_close(Gu, jvi.u_tendency(jg, j["u"], j["v"], j["w"]))
    assert_close(Gv, jvi.v_tendency(jg, j["u"], j["v"], j["w"]))


@pytest.mark.parametrize("halo,orders", [
    ((4, 4, 4), dict(order=7)),
    ((6, 6, 3), dict(vorticity_order=11)),
    ((0, 2, 2), dict(order=3)),
])
def test_vi_gate_differences_orders(halo, orders):
    """As :func:`test_vi_gate_differences` for the other order families:
    at the kernel's own reach (and a halo-free periodic x) the port takes
    the layout where the JAX gates do not, and its interior equals the one
    computed on a (7, 7, 5)-halo grid from the same interior fields."""
    from oceananigans_tpu.ops.pallas_vi import (
        vi_available, vi_transposed_layout_preferred,
    )
    size = (14, 10, 6)
    PBB = (oj.Periodic, oj.Bounded, oj.Bounded)
    jg, tg, _, t = setup(size, halo, PBB, seed=4)
    tvi = ot.WENOVectorInvariant(**orders)
    jvi = j_hyd.WENOVectorInvariant(**orders)
    assert cvi.vi_available(tg, tvi)
    assert not (vi_available(jg, jvi)
                or vi_transposed_layout_preferred(jg, jvi))
    wide = ot.RectilinearGrid(size=size, extent=(1.0, 2.0, 0.5),
                              topology=PBB, halo=(7, 7, 5), dtype=F64)
    tw = {}
    for name in ("u", "v", "w"):
        a = torch.zeros(wide.shape, dtype=F64)
        a[wide.interior_slices] = tg.interior(t[name])
        tw[name] = ot.fill_halo_regions(a, wide, loc=LOCS[name])
    got = cvi.vi_momentum_tendency(tg, tvi, t["u"], t["v"], t["w"])
    ref = cvi.vi_momentum_tendency(wide, tvi, tw["u"], tw["v"], tw["w"])
    for g, r in zip(got, ref):
        torch.testing.assert_close(tg.interior(g), wide.interior(r),
                                   rtol=0, atol=1e-13 * float(r.abs().max()))


# ---------------------------------------------------------------------------
# The launch plan of the x-marching tiles
# ---------------------------------------------------------------------------

# hydro_vi; chip_smoke.py's ragged layouts (23, 17, 9) with halo (6, 6, 4)
# and (16, 12, 32) with (5, 0, 0) (a halo-free periodic y and z); a
# ragged layout with halo (6, 6, 6); the weno7 cell; a field narrower than
# one panel on every axis
PLAN_SHAPES = [(372, 172, 68), (35, 29, 17), (26, 12, 32), (35, 29, 21),
               (264, 256, 256), (3, 2, 1)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kernel", ["vi", "tracer"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_march_plan_covers_every_point_once(shape, kernel, itemsize):
    """``march_plan`` for either kernel (the vector-invariant one with its
    two roles and an extra column of face threads, the tracer one with one
    to four blocks of tracer pairs and an extra row and column): each
    x-row in exactly one non-empty segment, each (y, z) column in exactly
    one panel, at most ``MAX_THREADS`` threads and ``PANEL_Z`` columns a
    block, the grid within CUDA's limits, and no plan of the same panels
    with a lower cost (waves of resident blocks times the x-rows each
    marches)."""
    nx, ny, nz = shape
    extra = ctr.VI_EXTRA if kernel == "vi" else ctr.TRACER_EXTRA
    for roles in ((2,) if kernel == "vi" else (1, 2, 4)):
        for sms in (1, 132):
            py, pz, seg_len, nseg = ctr.march_plan(shape, roles, sms,
                                                   itemsize, extra)
            assert (py + extra[0]) * (pz + extra[1]) <= ctr.MAX_THREADS
            assert 1 <= pz <= ctr.PANEL_Z and py >= 1
            rows = np.zeros(nx, int)
            for seg in range(nseg):
                lo, hi = seg * seg_len, min((seg + 1) * seg_len, nx)
                assert lo < hi
                rows[lo:hi] += 1
            assert (rows == 1).all()
            cols = np.zeros((ny, nz), int)
            for jp in range(-(-ny // py)):
                for kp in range(-(-nz // pz)):
                    cols[jp * py:(jp + 1) * py, kp * pz:(kp + 1) * pz] += 1
            assert (cols == 1).all()
            panels = -(-ny // py) * -(-nz // pz) * roles
            assert -(-ny // py) <= 65535 and nseg * roles <= 65535
            slots = sms * ctr.blocks_per_sm(itemsize)

            def cost(n):
                return -(-panels * n // slots) * (-(-nx // n)
                                                  + ctr.SEGMENT_START)
            assert all(cost(nseg) <= cost(n) for n in range(1, nx + 1))
    if shape == (372, 172, 68):
        # three z-panels of 23 for hydro_vi's 68 columns
        assert ctr.march_plan(shape, 2, 132)[:2] == (10, 23)
        assert ctr.march_plan(shape, 1, 132, 4, extra)[:2] == (
            (10, 23) if kernel == "vi" else (9, 23))
    with pytest.raises(ValueError):
        ctr.march_plan((0, ny, nz), 1, 132, itemsize, extra)


# ---------------------------------------------------------------------------
# VectorInvariant options against the JAX package
# ---------------------------------------------------------------------------

def _smooth_fields(seed=2):
    """A (16, 16, 8) periodic-periodic-bounded grid with halo 6 and smooth
    velocities plus noise, in both packages."""
    topo = (oj.Periodic, oj.Periodic, oj.Bounded)
    kw = dict(size=(16, 16, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=(-1.0, 0.0),
              topology=topo, halo=6)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    rng = np.random.default_rng(seed)
    x = np.asarray(tg.xC).reshape(-1, 1, 1)
    y = np.asarray(tg.yC).reshape(1, -1, 1)
    z = np.asarray(tg.zC).reshape(1, 1, -1)
    base = {"u": np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) + 0 * z,
            "v": -np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y) + 0 * z,
            "w": 0.1 * np.sin(2 * np.pi * x) * np.sin(np.pi * z) + 0 * y}
    j, t = {}, {}
    for name in ("u", "v", "w"):
        a = base[name] + 0.1 * rng.standard_normal(tg.shape)
        bcs = regularize_field_boundary_conditions(None, jg, LOCS[name])
        j[name] = j_fill(jnp.asarray(a), jg, bcs, LOCS[name])
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=LOCS[name])
    return jg, tg, j, t


def _scheme(pkg, spec):
    if spec in ("enstrophy_conserving", "energy_conserving"):
        return spec
    if spec == "C2":
        return pkg.Centered(2)
    return pkg.WENO(spec)


# every option of tests/test_vector_invariant.py:53-80 the port has
# (UpwindBiased and Centered(4) are not ported), plus the multidimensional
# stencil and the "default" vorticity stencil
VI_OPTIONS = [
    dict(vorticity_scheme=zs, vertical_scheme=vs, upwinding=up)
    for zs in ("enstrophy_conserving", "energy_conserving", 5)
    for vs in ("energy_conserving", "C2", 5)
    for up in ("self", "cross")
] + [dict(vorticity_scheme=5, vertical_scheme=5, upwinding="self",
          multi_dimensional_stencil=True),
     dict(vorticity_scheme=9, vertical_scheme=5, upwinding="self",
          vorticity_stencil="default")]


def _build_vi(pkg, mod, opts):
    kw = dict(opts)
    kw["vorticity_scheme"] = _scheme(pkg, kw["vorticity_scheme"])
    kw["vertical_scheme"] = _scheme(pkg, kw["vertical_scheme"])
    if kw["vertical_scheme"] == pkg.Centered(2):
        # centred schemes are symmetric: the divergence flux needs a
        # biased one of its own
        kw["divergence_scheme"] = pkg.WENO(5)
    kw["upwinding"] = (mod.OnlySelfUpwinding() if kw["upwinding"] == "self"
                       else mod.CrossAndSelfUpwinding())
    return mod.VectorInvariant(**kw)


@pytest.mark.parametrize("opts", VI_OPTIONS,
                         ids=lambda o: "-".join(str(v) for v in o.values()))
def test_vector_invariant_options_match_jax(opts):
    from oceananigans_torch.models import hydrostatic as t_hyd
    jg, tg, j, t = _smooth_fields()
    tvi = _build_vi(ot, t_hyd, opts)
    jvi = _build_vi(oj, j_hyd, opts)
    assert tvi.required_halo == jvi.required_halo
    assert repr(tvi) == repr(jvi)
    assert_close(tvi.u_tendency(tg, t["u"], t["v"], t["w"]),
                 jvi.u_tendency(jg, j["u"], j["v"], j["w"]))
    assert_close(tvi.v_tendency(tg, t["u"], t["v"], t["w"]),
                 jvi.v_tendency(jg, j["u"], j["v"], j["w"]))


def test_multi_dimensional_filter_matches_jax():
    from oceananigans_torch.advection import multi_dimensional_filter
    jg, tg, j, t = _smooth_fields(seed=8)
    for axis in (0, 1):
        assert_close(multi_dimensional_filter(t["u"], axis),
                     j_adv.multi_dimensional_filter(j["u"], axis))


def test_required_halo_matches_reference_rule():
    assert ot.VectorInvariant().required_halo == 2
    assert ot.WENOVectorInvariant(5).required_halo == 4
    assert ot.WENOVectorInvariant(5, vertical_order=3).required_halo == 4
    vi = ot.WENOVectorInvariant()
    assert vi.vorticity_scheme.order == 9 and vi.vertical_scheme.order == 5
    assert vi.required_halo == 6
    assert ot.WENOVectorInvariant(multi_dimensional_stencil=True) \
        .required_halo == 8


def test_wrappers_check_operands():
    jg, tg, j, t = setup((16, 12, 8), 6)
    u, v, w, T = t["u"], t["v"], t["w"], t["T"]
    vi = ot.WENOVectorInvariant()
    with pytest.raises(ValueError):
        cvi.vi_momentum_tendency(tg, vi, u, v.float(), w)
    with pytest.raises(ValueError):              # not instantiated
        cvi.vi_momentum_tendency(tg, ot.VectorInvariant(), u, v, w)
    with pytest.raises(ValueError):
        ctr.weno_tracer_tendencies(tg, ot.WENO(7), u, v, w, {"T": T[1:]})
    with pytest.raises(ValueError):
        ctr.weno_tracer_tendencies(tg, ot.Centered(), u, v, w, {"T": T})
    assert ctr.weno_tracer_tendencies(tg, ot.WENO(7), u, v, w, {}) == {}
    counts = (cvi.vi_momentum_tendency.launches,
              ctr.weno_tracer_tendencies.launches)
    cvi.vi_momentum_tendency(tg, vi, u, v, w)
    ctr.weno_tracer_tendencies(tg, ot.WENO(7), u, v, w, {"T": T})
    # the plain versions on the CPU launch nothing
    assert counts == (cvi.vi_momentum_tendency.launches,
                      ctr.weno_tracer_tendencies.launches)
    m = cvi.vi_metric_profiles(tg)
    assert m.shape == (len(cvi.METRICS), tg.shape[1]) and m.is_contiguous()
    assert ctr.tracer_metric_profiles(tg).shape == (4, tg.shape[1])


#: the options of the hydrostatic model's second item-15 part and of item
#: 11, as model keywords of either package (``hyd``: its hydrostatic
#: module, ``adv``: its advection module)
NEW_OPTIONS = {
    "zstar": lambda pkg, hyd, adv: dict(vertical_coordinate=hyd.ZStar()),
    "implicit_fft": lambda pkg, hyd, adv: dict(
        free_surface=hyd.ImplicitFreeSurface()),
    "implicit_cg": lambda pkg, hyd, adv: dict(
        free_surface=hyd.ImplicitFreeSurface(solver_method="cg",
                                             maxiter=3)),
    "implicit_matrix": lambda pkg, hyd, adv: dict(
        free_surface=hyd.ImplicitFreeSurface(solver_method="matrix",
                                             maxiter=3)),
    "split_rk3": lambda pkg, hyd, adv: dict(timestepper="split_rk3"),
    "bound_preserving": lambda pkg, hyd, adv: dict(
        tracer_advection=adv.BoundPreserving(adv.WENO(7))),
    "weno_bounds": lambda pkg, hyd, adv: dict(
        tracer_advection=adv.WENO(7, bounds=(0.0, 1.0))),
}


@pytest.mark.parametrize("option", sorted(NEW_OPTIONS))
def test_gates_match_jax_under_new_options(option, monkeypatch):
    """On the lat-lon grid of ``test_gates_match_jax_on_latlon`` with
    ``WENOVectorInvariant()`` and WENO(7) tracers, forced on: one step of
    each package calls kernels 11 and 12/13 exactly where the other does.
    The JAX model runs them only on its own grid, so never under z-star
    (whose tendencies are taken on the σ-scaled grid); neither takes the
    tracer kernel under a limiter; the free surfaces and ``split_rk3``
    leave both kernels on (once a stage)."""
    from oceananigans_torch.models import hydrostatic as t_hyd_mod
    from oceananigans_tpu.ops import pallas_tracer, pallas_vi
    calls = {"jax": [], "port": []}

    def spy(who, kind, real=None):
        def f(grid, scheme, u, v, w, *rest, **kw):
            calls[who].append(kind)
            if real is not None:
                return real(grid, scheme, u, v, w, *rest, **kw)
            if kind == "vi":
                return jnp.zeros_like(u), jnp.zeros_like(v)
            return {n: jnp.zeros_like(c) for n, c in rest[0].items()}
        return f

    for name in ("vi_momentum_tendency", "vi_momentum_tendency_zyx"):
        monkeypatch.setattr(pallas_vi, name, spy("jax", "vi"))
    monkeypatch.setattr(pallas_tracer, "weno_tracer_tendencies",
                        spy("jax", "tracer"))
    monkeypatch.setattr(t_hyd_mod, "vi_momentum_tendency",
                        spy("port", "vi", t_hyd_mod.vi_momentum_tendency))
    monkeypatch.setattr(t_hyd_mod, "weno_tracer_tendencies", spy(
        "port", "tracer", t_hyd_mod.weno_tracer_tendencies))
    jg, tg = latlon_grids()
    models = {}
    for who, pkg, hyd, adv, grid in (("jax", oj, j_hyd, j_adv, jg),
                                     ("port", ot, ot, t_adv, tg)):
        kw = dict(momentum_advection=hyd.WENOVectorInvariant(),
                  tracer_advection=adv.WENO(7), tracers=("T",),
                  free_surface=hyd.ExplicitFreeSurface(),
                  fused_kernels=True)
        kw.update(NEW_OPTIONS[option](pkg, hyd, adv))
        m = pkg.HydrostaticFreeSurfaceModel(grid=grid, **kw)
        models[who] = m
        s = m.initial_state(T=1.0)
        calls[who].clear()
        m.step(s, 1.0)
    assert sorted(calls["port"]) == sorted(calls["jax"]), calls
    stages = 3 if option == "split_rk3" else 1
    assert calls["port"].count("vi") == (0 if option == "zstar"
                                         else stages)
    assert calls["port"].count("tracer") == (
        0 if option in ("zstar", "bound_preserving", "weno_bounds")
        else stages)
    port = models["port"]
    assert port.fused_kernels == ("vi" in calls["port"])
    assert port.fused_tracer == ("tracer" in calls["port"])
