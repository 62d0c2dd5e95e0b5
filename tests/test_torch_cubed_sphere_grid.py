"""oceananigans_torch's conformal cubed-sphere grid against the JAX
package's, on the CPU in float64: the Rančić map's coefficients and every
panel metric (bit for bit), the connectivity and the numeric exchange
tables, which write no destination twice, and the scalar exchange, the
velocity exchange, the edge-flux sync and the corner vorticity on the same
seeded random (6, nx, ny, nz) fields, which must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.grids import cubed_sphere as tcs
from oceananigans_torch.grids import cubed_sphere_grid as tcg
from oceananigans_torch.interop import grid_from_arguments
from oceananigans_tpu.grids import cubed_sphere as jcs
from oceananigans_tpu.grids import cubed_sphere_grid as jcg

#: (N, Nz, halo) of the grids held against each other
LAYOUTS = [(8, 3, 3), (6, 2, 2)]
METRICS = ("dxCC", "dxFC", "dxCF", "dxFF", "dyCC", "dyFC", "dyCF", "dyFF",
           "lamCC", "lamFC", "lamCF", "lamFF", "phiCC", "phiFC", "phiCF",
           "phiFF", "zC", "zF")


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


def grids(layout):
    N, Nz, halo = layout
    kw = dict(panel_size=(N, Nz), z=(-100.0, 0.0), radius=6.37122e6,
              halo=halo, dtype="float64")
    return jcg.ConformalCubedSphereGrid(**kw), grid_from_arguments(
        "cubed_sphere", **kw)


def fields(grid, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, *grid.panel_grid.shape))
            for _ in range(n)]


def test_rancic_coefficients_bitwise():
    A_j, res_j = jcs.rancic_coefficients()
    A_t, res_t = tcs.rancic_coefficients()
    assert np.array_equal(A_j, A_t) and res_j == res_t
    x = np.linspace(-1.0, 1.0, 9)
    for a, b in zip(jcs.conformal_cubed_sphere_mapping(x, x[::-1]),
                    tcs.conformal_cubed_sphere_mapping(x, x[::-1])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_panel_metrics_bitwise(layout):
    jg, tg = grids(layout)
    jp, tp = jg.panel_grid, tg.panel_grid
    assert tp.topology == (ot.Bounded, ot.Bounded, ot.Bounded)
    assert (tp.N, tp.H, tp.shape) == (
        (jp.Nx, jp.Ny, jp.Nz), (jp.Hx, jp.Hy, jp.Hz), tuple(jp.shape))
    for name in METRICS:
        a = np.asarray(getattr(jp, name)).reshape(-1)
        b = getattr(tp, name).numpy().reshape(-1)
        assert np.array_equal(a, b), name
    assert np.array_equal(jg.lam_cc, tg.lam_cc)
    assert np.array_equal(jg.phi_cc, tg.phi_cc)
    assert tg.panel_grid.device.type == "cpu"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tables_match_jax(layout):
    jg, tg = grids(layout)
    N, _, H = layout
    assert tg.connectivity == jg.connectivity
    # every side has one neighbour, and the relation is symmetric
    for (p, s), (q, r, rev) in tg.connectivity.items():
        assert tg.connectivity[(q, r)] == (p, s, rev)
    vj, vt = jcg._velocity_maps(N, H), tcg._velocity_maps(N, H)
    assert vj.keys() == vt.keys()
    for key in vj:
        for a, b in zip(vj[key], vt[key]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key
    for a, b in zip(jcg._edge_face_maps_flat(N, H),
                    tcg._edge_face_maps_flat(N, H)):
        assert np.array_equal(a, b)
    for a, b in zip(jcg._exchange_maps(jg, H), tcg._exchange_maps(tg, H)):
        assert np.array_equal(a, b)
    for a, b in zip(jcg.corner_circulation_tables(N, H),
                    tcg.corner_circulation_tables(N, H)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_destination_maps_have_no_duplicates(layout):
    """``index_put_`` with repeated destinations is nondeterministic on
    CUDA: every table writes each destination once."""
    _, tg = grids(layout)
    N, _, H = layout

    def unique(*idx):
        keys = np.stack([np.asarray(i) for i in idx], axis=1)
        return len(np.unique(keys, axis=0)) == len(keys)

    dp, di, dj, *_ = tcg._exchange_maps(tg, H)
    assert unique(dp, di, dj)
    for tab in tcg._velocity_maps_flat(N, H).values():
        assert unique(*tab[:3])
    PP, OC, OI, OJ, *_ = tcg._edge_face_maps_flat(N, H)
    for comp in (0, 1):
        m = OC == comp
        assert unique(PP[m], OI[m], OJ[m])
    # the tensors on the grid are the same tables
    assert all(torch.equal(t, torch.as_tensor(a)) for t, a in zip(
        tg._exchange_tables(H), tcg._exchange_maps(tg, H)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("width", [None, 1])
def test_halo_exchange_exact(layout, width):
    jg, tg = grids(layout)
    (a,) = fields(tg, 1, seed=1)
    ref = np.asarray(jcg.cubed_sphere_halo_exchange(jnp.asarray(a), jg,
                                                    width=width))
    got = tcg.cubed_sphere_halo_exchange(torch.tensor(a), tg, width=width)
    assert np.array_equal(got.numpy(), ref)
    # functional: the argument is untouched
    ref_nc = np.asarray(jcg.cubed_sphere_halo_exchange(
        jnp.asarray(a), jg, fill_corners=False))
    t = torch.tensor(a)
    got_nc = tcg.cubed_sphere_halo_exchange(t, tg, fill_corners=False)
    assert np.array_equal(got_nc.numpy(), ref_nc)
    assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_velocity_exchange_exact(layout):
    jg, tg = grids(layout)
    u, v = fields(tg, 2, seed=2)
    uj, vj = jcg.cubed_sphere_velocity_exchange(jnp.asarray(u),
                                                jnp.asarray(v), jg)
    ut, vt = tcg.cubed_sphere_velocity_exchange(torch.tensor(u),
                                                torch.tensor(v), tg)
    assert np.array_equal(ut.numpy(), np.asarray(uj))
    assert np.array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_sync_and_corner_vorticity_exact(layout):
    jg, tg = grids(layout)
    fx, fy, zeta = fields(tg, 3, seed=3)
    xj, yj = jcg.cubed_sphere_sync_edge_fluxes(jnp.asarray(fx),
                                               jnp.asarray(fy), jg)
    xt, yt = tcg.cubed_sphere_sync_edge_fluxes(torch.tensor(fx),
                                               torch.tensor(fy), tg)
    assert np.array_equal(xt.numpy(), np.asarray(xj))
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    zj = jcg.cubed_sphere_corner_vorticity(jnp.asarray(zeta),
                                           jnp.asarray(fx), jnp.asarray(fy),
                                           jg)
    zt = tcg.cubed_sphere_corner_vorticity(torch.tensor(zeta),
                                           torch.tensor(fx),
                                           torch.tensor(fy), tg)
    assert np.array_equal(zt.numpy(), np.asarray(zj))


def test_geographic_coords_and_set_tracer():
    jg, tg = grids(LAYOUTS[0])
    xs = np.linspace(-1.2, 1.2, 7)
    for a, b in zip(jcg.panel_geographic_coords(xs, xs),
                    tcg.panel_geographic_coords(xs, xs)):
        assert np.array_equal(a, b)

    def fn(lam, phi, z):
        return np.cos(np.deg2rad(phi)) * np.sin(np.deg2rad(lam)) + 1e-3 * z

    assert np.array_equal(tg.set_tracer(fn).numpy(),
                          np.asarray(jg.set_tracer(fn)))
    c = tg.set_tracer(fn)
    assert np.array_equal(tg.interior(c).numpy(),
                          np.asarray(jg.interior(jnp.asarray(c.numpy()))))
    eta = c[..., :1]
    assert tg.interior(eta).shape == (6, 8, 8, 1)
    assert tg.N == jg.N and np.array_equal(tg.xnodes(), jg.xnodes())


def test_grid_lives_on_the_default_device():
    """Without ``device=`` the grid takes ``config.device`` (the GPU
    unless a caller asks for the CPU, as these tests do)."""
    assert ot.config.device == "cpu"
    g = ot.ConformalCubedSphereGrid((4, 1), z=(-1.0, 0.0))
    assert g.device.type == "cpu" and g.panel_grid.H[0] == 2
    ot.config.device = "cuda"
    try:
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                ot.ConformalCubedSphereGrid((4, 1), z=(-1.0, 0.0))
        else:
            g = ot.ConformalCubedSphereGrid((4, 1), z=(-1.0, 0.0))
            assert g.device.type == "cuda"
    finally:
        ot.config.device = "cpu"
