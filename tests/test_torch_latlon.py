"""oceananigans_torch's ``LatitudeLongitudeGrid`` against the JAX package's,
on the CPU in float64: the 1-D factors and every metric at every location,
``min_spacing`` and the module-level node and spacing queries, a grid
from pole to pole, ``HydrostaticSphericalCoriolis`` in both schemes, the
polar boundary condition (its regularization and its fill), the field
layer on (λ, φ), and the shallow-water model on the sphere.

Grids of both packages are built from the same constructor arguments
(``interop.grid_from_arguments``); fields are made with numpy from a seed.
Coordinates and metrics are the same float64 host arithmetic in both
packages and agree to 1e-12 of their largest value; so do Coriolis terms,
fills and model steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import boundary_conditions as tbc
from oceananigans_torch.interop import grid_from_arguments
from oceananigans_tpu import boundary_conditions as jbc
from oceananigans_tpu import coriolis as jcor
from oceananigans_tpu import fields as jfields
from oceananigans_tpu import grids as jgrids

RTOL = 1e-12
F64 = torch.float64
C, F = oj.Center, oj.Face
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "c": oj.LOC_C}

#: constructor arguments: a near-global periodic ocean, a bounded sector,
#: a grid from pole to pole, and a wide halo
GRIDS = {
    "near-global": dict(size=(16, 8, 4), longitude=(0.0, 360.0),
                        latitude=(-80.0, 80.0), z=(-4000.0, 0.0), halo=3),
    "sector": dict(size=(12, 10, 3), longitude=(-30.0, 60.0),
                   latitude=(15.0, 55.0), z=(-100.0, 0.0), halo=2),
    "pole to pole": dict(size=(12, 9, 3), longitude=(0.0, 360.0),
                         latitude=(-90.0, 90.0), z=(-1000.0, 0.0), halo=3),
    "wide halo": dict(size=(10, 7, 5), longitude=(0.0, 360.0),
                      latitude=(-60.0, 70.0), z=(-50.0, 0.0), halo=5),
}


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


def grids(name):
    kw = GRIDS[name]
    return (oj.LatitudeLongitudeGrid(dtype="float64", **kw),
            grid_from_arguments("LatitudeLongitudeGrid", dtype="float64",
                                **kw))


def assert_close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rtol * scale


def random_field(grid, seed, shape=None):
    return np.random.default_rng(seed).standard_normal(shape or grid.shape)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_matches_jax(name):
    """Sizes, halos, topology, flags and extents; the 1-D factors with the
    |cos φ| mirror and the floors over the poles; every metric at every
    location (Az from Δsinφ, not Δx·Δy); ``min_spacing``."""
    jg, tg = grids(name)
    assert (tg.N, tg.H, tg.shape, tg.topology) == (
        jg.N, jg.H, jg.shape, jg.topology)
    assert (tg.x_regular, tg.y_regular, tg.z_regular) == (
        jg.x_regular, jg.y_regular, jg.z_regular)
    assert tg.regular
    assert (tg.Lx, tg.Ly, tg.Lz, tg.radius) == (
        jg.Lx, jg.Ly, jg.Lz, jg.radius)
    for attr in ("lamF", "lamC", "phiF", "phiC", "zF", "zC", "dzC_",
                 "dzF_", "dxlamC", "dxlamF", "cosC", "cosF", "dyC_", "dyF_",
                 "dsinC", "dsinF", "xF", "xC", "yF", "yC"):
        assert_close(getattr(tg, attr), getattr(jg, attr))
    for lx in (C, F):
        for ly in (C, F):
            assert_close(tg.dx(lx, ly), jg.dx(lx, ly))
            assert_close(tg.dy(ly, lx), jg.dy(ly, lx))
            assert_close(tg.Az(lx, ly), jg.Az(lx, ly))
            for lz in (C, F):
                assert_close(tg.Ax(lx, ly, lz), jg.Ax(lx, ly, lz))
                assert_close(tg.Ay(lx, ly, lz), jg.Ay(lx, ly, lz))
                assert_close(tg.V(lx, ly, lz), jg.V(lx, ly, lz))
    for axis in range(3):
        assert_close(tg.min_spacing(axis), jg.min_spacing(axis))
    # the areas of the interior rows sum to the sphere's zonal band
    band = np.deg2rad(jg.Lx) * jg.radius ** 2 * abs(
        np.sin(np.deg2rad(float(tg.phiF.reshape(-1)[tg.H[1] + tg.N[1]])))
        - np.sin(np.deg2rad(float(tg.phiF.reshape(-1)[tg.H[1]]))))
    area = float(torch.sum(tg.interior(
        torch.broadcast_to(tg.Az(C, C), tg.shape))[:, :, 0]))
    assert abs(area - band) <= 1e-12 * band


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_queries_match_jax(name):
    """``nodes``, ``x/y/z/rnodes`` and the λ/φ aliases at every location,
    with and without halos; ``x/y/z/rspacings`` and their aliases;
    ``minimum_x/y/zspacing``."""
    jg, tg = grids(name)
    for loc in ((C, C, C), (F, C, C), (C, F, C), (C, C, F), (F, F, F)):
        for kw in ({}, {"with_halos": True}):
            for a, b in zip(ot.nodes(tg, loc, **kw),
                            jgrids.nodes(jg, loc, **kw)):
                assert_close(a, b)
        for t_fn, j_fn, l in ((ot.xnodes, jgrids.xnodes, loc[0]),
                              (ot.ynodes, jgrids.ynodes, loc[1]),
                              (ot.znodes, jgrids.znodes, loc[2]),
                              (ot.rnodes, jgrids.rnodes, loc[2]),
                              (ot.lambda_nodes, jgrids.λnodes, loc[0]),
                              (ot.phi_nodes, jgrids.φnodes, loc[1])):
            assert_close(t_fn(tg, l), j_fn(jg, l))
    for lx in (C, F):
        for ly in (C, F):
            assert_close(ot.xspacings(tg, lx, ly), jgrids.xspacings(jg, lx,
                                                                    ly))
            assert_close(ot.lambda_spacings(tg, lx, ly),
                         jgrids.λspacings(jg, lx, ly))
            assert_close(ot.yspacings(tg, ly, lx), jgrids.yspacings(jg, ly,
                                                                    lx))
            assert_close(ot.phi_spacings(tg, ly, lx),
                         jgrids.φspacings(jg, ly, lx))
    for lz in (C, F):
        assert_close(ot.zspacings(tg, lz), jgrids.zspacings(jg, lz))
        assert_close(ot.rspacings(tg, lz), jgrids.rspacings(jg, lz))
    for t_fn, j_fn in ((ot.minimum_xspacing, jgrids.minimum_xspacing),
                       (ot.minimum_yspacing, jgrids.minimum_yspacing),
                       (ot.minimum_zspacing, jgrids.minimum_zspacing)):
        assert_close(t_fn(tg), j_fn(jg))


def test_rectilinear_queries_and_flags_match_jax():
    """The shared base gives the rectilinear grid the same queries and
    flags; a lat-lon grid with a stretched longitude has the JAX grid's
    flags and coordinates."""
    kw = dict(size=(6, 5, 4), extent=(1.0, 2.0, 0.5), halo=2)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    assert (tg.x_regular, tg.y_regular, tg.z_regular, tg.regular) == (
        True, True, True, jg.regular)
    for axis in range(3):
        assert_close(tg.min_spacing(axis), jg.min_spacing(axis))
    for a, b in zip(ot.nodes(tg, (F, C, F)), jgrids.nodes(jg, (F, C, F))):
        assert_close(a, b)
    assert_close(ot.xspacings(tg, F, C), jgrids.xspacings(jg, F, C))
    kw = dict(size=(4, 4, 4), longitude=np.linspace(0.0, 40.0, 5) ** 1.1,
              latitude=(0.0, 10.0), z=(-1.0, 0.0))
    ts = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    js = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    assert (ts.x_regular, ts.y_regular, ts.z_regular) == (
        js.x_regular, js.y_regular, js.z_regular) == (False, True, True)
    for name in ("lamF", "lamC", "dxlamC", "dxlamF"):
        assert_close(getattr(ts, name), getattr(js, name))


def test_topology_default_and_flat_z():
    """Periodic in x exactly when the longitude spans 360°; a 2-tuple size
    with a Flat z."""
    _, tg = grids("near-global")
    assert tg.topology == (ot.Periodic, ot.Bounded, ot.Bounded)
    _, ts = grids("sector")
    assert ts.topology == (ot.Bounded, ot.Bounded, ot.Bounded)
    kw = dict(size=(8, 6), longitude=(0.0, 360.0), latitude=(-60.0, 60.0),
              topology=(oj.Periodic, oj.Bounded, oj.Flat), halo=2)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    assert (tg.N, tg.H, tg.shape) == (jg.N, jg.H, jg.shape)
    assert_close(tg.V(C, C, C), jg.V(C, C, C))


@pytest.mark.parametrize("scheme", ["enstrophy_conserving",
                                    "energy_conserving"])
@pytest.mark.parametrize("name", ["near-global", "pole to pole"])
def test_spherical_coriolis_matches_jax(name, scheme):
    """f = 2Ω sinφ at (f, f) applied to the length-weighted transverse
    velocities, in both schemes; no vertical component."""
    jg, tg = grids(name)
    u, v, w = (random_field(jg, s) for s in (1, 2, 3))
    jc = jcor.HydrostaticSphericalCoriolis(scheme=scheme)
    tc = ot.HydrostaticSphericalCoriolis(scheme=scheme)
    assert tc == ot.HydrostaticSphericalCoriolis(scheme=scheme)
    args_j = [jnp.asarray(a) for a in (u, v, w)]
    args_t = [torch.tensor(a) for a in (u, v, w)]
    for fn in ("x_f_cross_U", "y_f_cross_U", "z_f_cross_U"):
        assert_close(getattr(tc, fn)(tg, *args_t),
                     getattr(jc, fn)(jg, *args_j))
    with pytest.raises(ValueError):
        ot.HydrostaticSphericalCoriolis(scheme="nonsense")


@pytest.mark.parametrize("loc", sorted(LOCS))
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_regularization_and_fill_match_jax(name, loc):
    """The default conditions, the polar one on the pole sides of
    center-located fields of a grid that reaches a pole, and the fill of
    every halo (the pole rows' ghosts mirror about the zonal mean of the
    polemost interior row, recomputed from the field)."""
    jg, tg = grids(name)
    L = LOCS[loc]
    jb = jbc.regularize_field_boundary_conditions(None, jg, L)
    tb = tbc.regularize_field_boundary_conditions(None, tg, L)
    for axis in range(3):
        for j, t in zip(jb.sides(axis), tb.sides(axis)):
            assert (j.classification, j.condition) == (
                t.classification, t.condition)
    polar = [bc.classification == tbc.POLAR for bc in tb.sides(1)]
    assert polar == [name == "pole to pole" and loc in ("c", "w")] * 2
    a = random_field(jg, 5)
    ref = jbc.fill_halo_regions(jnp.asarray(a), jg, jb, L)
    got = ot.fill_halo_regions(torch.tensor(a), tg, tb, L)
    assert_close(got, ref)


def test_polar_fill_of_a_surface_field():
    """η, (nx, ny, 1), takes the polar fill along x and y as the models
    fill it (``_fill_axis``), with the zonal mean over the interior x."""
    jg, tg = grids("pole to pole")
    jb = jbc.regularize_field_boundary_conditions(None, jg, oj.LOC_C)
    tb = tbc.regularize_field_boundary_conditions(None, tg, oj.LOC_C)
    a = random_field(jg, 6, jg.shape[:2] + (1,))
    ref, got = jnp.asarray(a), torch.tensor(a)
    for axis in (0, 1):
        ref = jbc._fill_axis(ref, jg, axis, C, *jb.sides(axis), None, None)
        tbc._fill_axis(got, tg, axis, C, *tb.sides(axis))
    assert_close(got, ref)
    # the pole value is the zonal mean: for a field constant along x it is
    # the polemost row itself, and the ghosts mirror about it
    H, N = tg.H[1], tg.N[1]
    col = np.cos(np.arange(jg.shape[1], dtype=float))
    want = col.copy()
    for h in range(H):
        want[H - 1 - h] = 2 * col[H] - col[H + h]
        want[N + H + h] = 2 * col[N + H - 1] - col[N + H - 1 - h]
    got = torch.tensor(np.broadcast_to(col[None, :, None], a.shape).copy())
    tbc._fill_axis(got, tg, 1, C, *tb.sides(1))
    assert_close(got, np.broadcast_to(want[None, :, None], a.shape))


@pytest.mark.parametrize("loc", sorted(LOCS))
def test_set_field_and_location_coords_match_jax(loc):
    """A callable of (λ, φ, z) evaluated at each staggered location."""
    jg, tg = grids("near-global")
    L = LOCS[loc]
    for a, b in zip(ot.fields.location_coords(tg, L),
                    jfields.location_coords(jg, L)):
        assert_close(a, b)
    ref = jfields.set_field(
        jg, lambda lam, phi, z: jnp.sin(jnp.deg2rad(lam))
        * jnp.cos(jnp.deg2rad(phi)) + 1e-3 * z, loc=L)
    got = ot.set_field(
        tg, lambda lam, phi, z: torch.sin(torch.deg2rad(lam))
        * torch.cos(torch.deg2rad(phi)) + 1e-3 * z, loc=L)
    assert_close(got, ref)


@pytest.mark.parametrize("axis", [1, 2])
def test_regrid_matches_jax(axis):
    """Conservative regridding along latitude and depth between two lat-lon
    grids that share the other axes."""
    kw = dict(longitude=(0.0, 360.0), z=(-100.0, 0.0), halo=2)
    src_kw = dict(size=(8, 10, 6), latitude=(-60.0, 60.0), **kw)
    dst_kw = dict(size=(8, 10, 6), latitude=(-60.0, 60.0), **kw)
    dst_kw["size"] = (8, 7, 6) if axis == 1 else (8, 10, 4)
    js = oj.LatitudeLongitudeGrid(dtype="float64", **src_kw)
    jd = oj.LatitudeLongitudeGrid(dtype="float64", **dst_kw)
    ts = ot.LatitudeLongitudeGrid(dtype=F64, **src_kw)
    td = ot.LatitudeLongitudeGrid(dtype=F64, **dst_kw)
    a = random_field(js, 8)
    ref = jfields.regrid(js, jd, jnp.asarray(a), axis=axis)
    got = ot.fields.regrid(ts, td, torch.tensor(a), axis=axis)
    assert_close(got, ref)


def test_diffusive_cfl_uses_min_spacing():
    """The diffusive CFL takes the smallest interior cell width, the
    high-latitude Δx on the sphere."""
    jg, tg = grids("near-global")
    closure_kw = dict(nu=1e3, kappa=1e2)
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=tg, closure=ot.HorizontalScalarDiffusivity(**closure_kw))
    jm = oj.HydrostaticFreeSurfaceModel(
        grid=jg, closure=oj.HorizontalScalarDiffusivity(**closure_kw))
    got = ot.DiffusiveCFL(60.0)(tm, None)
    ref = oj.DiffusiveCFL(60.0)(jm, None)
    assert abs(got - ref) <= RTOL * abs(ref)
    dmin = min(float(tg.min_spacing(axis)) for axis in range(3))
    assert abs(got - 60.0 * 1e3 / dmin ** 2) <= RTOL * got


@pytest.mark.parametrize("formulation", ["conservative", "vector"])
def test_shallow_water_on_the_sphere_matches_jax(formulation):
    """The shallow-water model runs on a lat-lon grid with a Flat z, as the
    JAX package's does (its stage kernel stays rectilinear): 3 RK3 steps
    with spherical Coriolis."""
    kw = dict(size=(16, 8), longitude=(0.0, 360.0), latitude=(-60.0, 60.0),
              topology=(oj.Periodic, oj.Bounded, oj.Flat), halo=3)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    if formulation == "vector":
        mk = dict(formulation=ot.VectorInvariantFormulation,
                  momentum_advection=ot.VectorInvariant())
        jmk = dict(formulation=oj.VectorInvariantFormulation,
                   momentum_advection=oj.VectorInvariant())
    else:
        mk, jmk = {}, {}
    tm = ot.ShallowWaterModel(grid=tg, gravitational_acceleration=9.81,
                              coriolis=ot.HydrostaticSphericalCoriolis(),
                              **mk)
    jm = oj.ShallowWaterModel(grid=jg, gravitational_acceleration=9.81,
                              coriolis=oj.HydrostaticSphericalCoriolis(),
                              **jmk)
    assert not tm.fused_rk3
    h = lambda lam, phi, z: 1000.0 + 10.0 * np.exp(  # noqa: E731
        -((lam - 180.0) / 30.0) ** 2 - (phi / 15.0) ** 2)
    js = jm.initial_state(h=lambda lam, phi, z: h(lam, phi, z))
    from oceananigans_torch.interop import SW_FIELDS, state_from_numpy
    arrays = {k: np.asarray(getattr(js, k)) for k in SW_FIELDS}
    arrays.update(time=0.0, iteration=0, last_dt=0.0)
    ts = state_from_numpy(tm, arrays)
    for _ in range(3):
        js = jm.step(js, 60.0)
        ts = tm.step(ts, 60.0)
    S = tg.interior_slices
    for k in ("uh", "vh", "h"):
        assert_close(getattr(ts, k)[S], np.asarray(getattr(js, k))[S])


def test_nonhydrostatic_model_refuses_the_sphere():
    """The JAX nonhydrostatic model does not run on the spherical grids
    (its pressure-solver choice reads a ``regular`` flag they lack); the
    port refuses them by name."""
    _, tg = grids("near-global")
    with pytest.raises(AttributeError):
        oj.NonhydrostaticModel(grid=grids("near-global")[0])
    with pytest.raises(ValueError, match="RectilinearGrid"):
        ot.NonhydrostaticModel(grid=tg)
    tt = ot.TripolarGrid(size=(8, 6, 3), z=(-10.0, 0.0), dtype=F64)
    with pytest.raises(ValueError, match="RectilinearGrid"):
        ot.NonhydrostaticModel(grid=tt)
