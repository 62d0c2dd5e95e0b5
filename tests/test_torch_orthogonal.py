"""oceananigans_torch's orthogonal spherical-shell grids against the JAX
package's, on the CPU in float64: ``OrthogonalSphericalShellGrid`` from
(λ, φ) nodes, ``RotatedLatitudeLongitudeGrid`` and ``TripolarGrid`` with
their haversine metrics; the zipper fold (``fill_zipper_north``) at each
location and sign and through ``fill_halo_regions``; the rotations between
the grid's frame and geographic east/north; the field layer on 2-D nodes;
and the hydrostatic model on the tripolar and rotated grids.

Both packages' grids come from the same constructor arguments, or from the
same nodes carried across as numpy arrays (``interop.orthogonal_nodes``,
``interop.orthogonal_grid_like``); fields are made with numpy from a seed.
Everything agrees to 1e-12 of the largest value of each array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import boundary_conditions as tbc
from oceananigans_torch.interop import (
    HYDROSTATIC_FIELDS, grid_from_arguments, orthogonal_grid_like,
    orthogonal_nodes, state_from_numpy, state_to_numpy,
)
from oceananigans_tpu import boundary_conditions as jbc
from oceananigans_tpu import fields as jfields
from oceananigans_tpu.grids import orthogonal as jorth
from oceananigans_tpu.models import hydrostatic as jhyd

RTOL = 1e-12
F64 = torch.float64
C, F = oj.Center, oj.Face
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "c": oj.LOC_C}

#: constructor arguments of each grid: tripolar grids with an even and an
#: odd Nx, a rotated lat-lon region and a rotated global one
GRIDS = {
    "tripolar": ("TripolarGrid", dict(size=(16, 10, 4), z=(-1000.0, 0.0),
                                      halo=3)),
    "tripolar odd": ("TripolarGrid", dict(size=(15, 8, 3), z=(-500.0, 0.0),
                                          halo=2,
                                          first_pole_longitude=40.0)),
    "rotated": ("RotatedLatitudeLongitudeGrid",
                dict(size=(12, 10, 3), longitude=(-30.0, 30.0),
                     latitude=(-20.0, 20.0), z=(-100.0, 0.0),
                     north_pole=(30.0, 50.0), halo=2)),
    "rotated global": ("RotatedLatitudeLongitudeGrid",
                       dict(size=(16, 8, 3), longitude=(0.0, 360.0),
                            latitude=(-60.0, 60.0), z=(-100.0, 0.0),
                            north_pole=(-40.0, 60.0), halo=3)),
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
    kind, kw = GRIDS[name]
    return (getattr(oj.grids, kind)(dtype="float64", **kw),
            grid_from_arguments(kind, dtype="float64", **kw))


def assert_close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rtol * scale


def assert_metrics_match(tg, jg):
    assert (tg.N, tg.H, tg.shape, tg.topology, tg.zipper) == (
        jg.N, jg.H, jg.shape, jg.topology, jg.zipper)
    assert (tg.x_regular, tg.y_regular, tg.z_regular, tg.regular) == (
        False, False, jg.z_regular, False)
    for key in ("FF", "FC", "CF", "CC"):
        for pre in ("lam", "phi", "dx", "dy"):
            assert_close(getattr(tg, pre + key), getattr(jg, pre + key))
    for attr in ("xC", "xF", "yC", "yF", "zC", "zF"):
        assert_close(getattr(tg, attr), getattr(jg, attr))
    for lx in (C, F):
        for ly in (C, F):
            assert_close(tg.dx(lx, ly), jg.dx(lx, ly))
            assert_close(tg.dy(ly, lx), jg.dy(ly, lx))
            assert_close(tg.Az(lx, ly), jg.Az(lx, ly))
            for a, b in zip(tg.nodes_2d((lx, ly)), jg.nodes_2d((lx, ly))):
                assert_close(a, b)
            for lz in (C, F):
                assert_close(tg.Ax(lx, ly, lz), jg.Ax(lx, ly, lz))
                assert_close(tg.Ay(lx, ly, lz), jg.Ay(lx, ly, lz))
                assert_close(tg.V(lx, ly, lz), jg.V(lx, ly, lz))
    for axis in range(3):
        assert_close(tg.min_spacing(axis), jg.min_spacing(axis))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_matches_jax(name):
    """Nodes, the haversine metrics with their ``guard`` floor, areas,
    volumes, ``min_spacing`` and flags."""
    jg, tg = grids(name)
    assert_metrics_match(tg, jg)


def test_shell_from_nodes_matches_jax():
    """An ``OrthogonalSphericalShellGrid`` built directly from another
    grid's nodes, carried across as numpy arrays; a node array of the
    wrong shape is refused."""
    jt, _ = grids("tripolar")
    lam, phi = orthogonal_nodes(jt)
    jg = oj.grids.OrthogonalSphericalShellGrid(
        lam, phi, (-200.0, 0.0), (16, 10, 5), halo=3, dtype="float64")
    tg = ot.OrthogonalSphericalShellGrid(
        lam, phi, (-200.0, 0.0), (16, 10, 5), halo=3, dtype=F64)
    assert_metrics_match(tg, jg)
    assert_metrics_match(orthogonal_grid_like(jt, dtype=F64), jt)
    bad = dict(lam, ff=lam["ff"][1:])
    with pytest.raises(ValueError, match="halo-extended"):
        ot.OrthogonalSphericalShellGrid(bad, phi, (-1.0, 0.0), (16, 10, 5),
                                        halo=3, dtype=F64)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("loc", sorted(LOCS) + ["ff"])
@pytest.mark.parametrize("name", ["tripolar", "tripolar odd"])
def test_fill_zipper_north_matches_jax(name, loc, sign):
    """The fold at each location and sign: the x-Face roll and its
    wrap-column sign, and the duplicated Ny row of y-Center fields."""
    jg, tg = grids(name)
    L = LOCS.get(loc, (F, F, C))
    a = np.random.default_rng(11).standard_normal(jg.shape)
    ref = jorth.fill_zipper_north(jnp.asarray(a), jg, L, sign)
    t = torch.tensor(a)
    got = ot.grids.fill_zipper_north(t, tg, L, sign)
    assert got is t                        # the fold writes in place
    assert_close(got, ref)


@pytest.mark.parametrize("loc", ["c", "u"])
def test_fill_zipper_north_of_a_surface_field(loc):
    """An (nx, ny, 1) field folds as a 3-D one does."""
    jg, tg = grids("tripolar")
    a = np.random.default_rng(12).standard_normal(jg.shape[:2] + (1,))
    ref = jorth.fill_zipper_north(jnp.asarray(a), jg, LOCS[loc], -1.0)
    got = ot.grids.fill_zipper_north(torch.tensor(a), tg, LOCS[loc], -1.0)
    assert_close(got, ref)


@pytest.mark.parametrize("loc", sorted(LOCS))
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fill_halo_regions_matches_jax(name, loc):
    """The whole fill: periodic x first, then the south wall and the
    north fold (tripolar: horizontal velocities flip sign), then z."""
    jg, tg = grids(name)
    L = LOCS[loc]
    jb = jbc.regularize_field_boundary_conditions(None, jg, L)
    tb = tbc.regularize_field_boundary_conditions(None, tg, L)
    a = np.random.default_rng(13).standard_normal(jg.shape)
    ref = jbc.fill_halo_regions(jnp.asarray(a), jg, jb, L)
    assert_close(ot.fill_halo_regions(torch.tensor(a), tg, tb, L), ref)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_rotations_match_jax(name):
    """(cosθ, sinθ) at cell centers and the intrinsic/extrinsic rotations
    of a geographic vector; the two are inverse."""
    jg, tg = grids(name)
    for a, b in zip(ot.rotation_angles(tg), jorth.rotation_angles(jg)):
        assert_close(a, b)
    rng = np.random.default_rng(14)
    ue, ve = (rng.standard_normal(jg.shape) for _ in range(2))
    ti = ot.intrinsic_vector(tg, torch.tensor(ue), torch.tensor(ve))
    ji = jorth.intrinsic_vector(jg, jnp.asarray(ue), jnp.asarray(ve))
    for a, b in zip(ti, ji):
        assert_close(a, b)
    te = ot.extrinsic_vector(tg, *ti)
    je = jorth.extrinsic_vector(jg, *ji)
    for a, b, c in zip(te, je, (ue, ve)):
        assert_close(a, b)
        assert_close(a, c, rtol=1e-10)


def test_rotations_on_geographic_grids():
    """A rectilinear or lat-lon grid's frame is geographic."""
    g = ot.LatitudeLongitudeGrid(size=(4, 4, 2), longitude=(0.0, 40.0),
                                 latitude=(0.0, 20.0), z=(-1.0, 0.0),
                                 dtype=F64)
    assert ot.rotation_angles(g) == (1.0, 0.0)
    u = torch.ones(g.shape, dtype=F64)
    assert all(torch.equal(a, b) for a, b in
               zip(ot.intrinsic_vector(g, u, 2 * u), (u, 2 * u)))


@pytest.mark.parametrize("loc", sorted(LOCS))
def test_set_field_on_2d_nodes_matches_jax(loc):
    """A callable of (λ, φ, z) at 2-D nodes (the aliases xC/xF/yC/yF)."""
    jg, tg = grids("tripolar")
    L = LOCS[loc]
    ref = jfields.set_field(
        jg, lambda lam, phi, z: jnp.sin(jnp.deg2rad(lam))
        * jnp.cos(jnp.deg2rad(phi)) + 1e-3 * z, loc=L)
    got = ot.set_field(
        tg, lambda lam, phi, z: torch.sin(torch.deg2rad(lam))
        * torch.cos(torch.deg2rad(phi)) + 1e-3 * z, loc=L)
    assert_close(got, ref)


def test_regrid_on_2d_nodes():
    """Regridding in depth works on an orthogonal grid, as in the JAX
    package; along x its 2-D nodes have no 1-D edges."""
    kind, kw = GRIDS["tripolar"]
    kw2 = dict(kw, size=(16, 10, 6))
    js, ts = grids("tripolar")
    jd = getattr(oj.grids, kind)(dtype="float64", **kw2)
    td = grid_from_arguments(kind, dtype="float64", **kw2)
    a = np.random.default_rng(15).standard_normal(js.shape)
    ref = jfields.regrid(js, jd, jnp.asarray(a), axis=2)
    assert_close(ot.fields.regrid(ts, td, torch.tensor(a), axis=2), ref)
    with pytest.raises(ValueError, match="1-D coordinates"):
        ot.fields.regrid(ts, td, torch.tensor(a), axis=0)


def test_spherical_coriolis_needs_latitude_faces():
    """``HydrostaticSphericalCoriolis`` reads the face latitudes ``phiF``,
    which an orthogonal grid lacks, in both packages."""
    jg, tg = grids("tripolar")
    u = np.zeros(jg.shape)
    with pytest.raises(AttributeError):
        oj.HydrostaticSphericalCoriolis().x_f_cross_U(jg, u, u, u)
    t = torch.zeros(tg.shape, dtype=F64)
    with pytest.raises(AttributeError):
        ot.HydrostaticSphericalCoriolis().x_f_cross_U(tg, t, t, t)


def jax_arrays(state, names):
    out = {k: np.asarray(getattr(state, k)) for k in HYDROSTATIC_FIELDS}
    for n in names:
        out[f"tracers/{n}"] = np.asarray(state.tracers[n])
        out[f"Gtracers/{n}"] = np.asarray(state.Gtracers[n])
    out.update(time=np.asarray(state.clock.time),
               iteration=np.asarray(state.clock.iteration),
               last_dt=np.asarray(state.clock.last_dt))
    return out


@pytest.mark.parametrize("name,momentum", [
    ("tripolar", "default"), ("tripolar", "weno"),
    ("rotated global", "weno")])
def test_hydrostatic_model_matches_jax(name, momentum):
    """3 steps of the hydrostatic model with a T tracer and linear
    seawater buoyancy, split-explicit free surface: the zipper fold fills
    the north halos of u, v and T each step; no kernel takes the grid.
    Compared on the interior to 1e-12 of each field's largest value."""
    jg, tg = grids(name)

    def build(pkg, hyd, grid):
        ma = (hyd.VectorInvariant() if momentum == "default"
              else hyd.WENOVectorInvariant(order=5))
        return hyd.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=ma, tracers=("T", "S"),
            tracer_advection=pkg.WENO(5),
            buoyancy=pkg.SeawaterBuoyancy(
                equation_of_state=pkg.LinearEquationOfState()),
            free_surface=hyd.SplitExplicitFreeSurface(substeps=10))

    jm = build(oj, jhyd, jg)
    tm = build(ot, ot.models.hydrostatic, tg)
    assert not tm.fused_kernels and not tm.fused_tracer
    js = jm.initial_state(
        u=lambda lam, phi, z: 0.1 * jnp.sin(jnp.deg2rad(lam) + 0.3)
        * jnp.cos(jnp.deg2rad(phi)),
        v=lambda lam, phi, z: 0.05 * jnp.cos(jnp.deg2rad(lam)),
        T=lambda lam, phi, z: 20.0 + 1e-3 * z + 0.05 * jnp.cos(
            jnp.deg2rad(phi)),
        S=lambda lam, phi, z: 35.0 + 1e-3 * phi)
    ts = state_from_numpy(tm, jax_arrays(js, ("T", "S")))
    for _ in range(3):
        js = jm.step(js, 120.0)
        ts = tm.step(ts, 120.0)
    ref, got = jax_arrays(js, ("T", "S")), state_to_numpy(ts)
    S = tg.interior_slices
    for group in (("u", "v"), ("w",), ("eta",), ("U", "V"),
                  ("tracers/T",), ("tracers/S",)):
        sl = S[:2] + (slice(None),) if group[0] in ("eta", "U") else S
        scale = max(np.abs(ref[k][sl]).max() for k in group)
        for k in group:
            assert np.abs(got[k][sl] - ref[k][sl]).max() <= RTOL * scale, k
    assert all(np.isfinite(got[k]).all() for k in ("u", "v", "eta"))


def test_tripolar_volume_is_conserved():
    """The fold and the walls keep the free surface's volume to 1e-12 of
    Σ|η|·Az over 3 steps."""
    from oceananigans_torch.profile_step import volume_drift
    _, tg = grids("tripolar")
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=ot.WENOVectorInvariant(order=5),
        tracers=("b",), buoyancy=ot.BuoyancyTracer())
    ts = tm.initial_state(
        u=lambda lam, phi, z: 0.2 * torch.cos(torch.deg2rad(phi)),
        b=lambda lam, phi, z: 1e-5 * z)
    eta0 = ts.eta.clone()
    for _ in range(3):
        ts = tm.step(ts, 300.0)
    assert float(ts.eta.abs().max()) > 0
    assert volume_drift(tm, eta0, ts.eta) < 1e-12


def test_shallow_water_on_a_shell_matches_jax():
    """The shallow-water model runs on an orthogonal shell with a Flat z
    (the rotated global grid's nodes), as the JAX package's does: 3 RK3
    steps of a Gaussian bump."""
    from oceananigans_torch.interop import SW_FIELDS
    jr, _ = grids("rotated global")
    lam, phi = orthogonal_nodes(jr)
    kw = dict(halo=3, topology=(oj.Periodic, oj.Bounded, oj.Flat))
    jg = oj.grids.OrthogonalSphericalShellGrid(lam, phi, None, (16, 8, 1),
                                               dtype="float64", **kw)
    tg = ot.OrthogonalSphericalShellGrid(lam, phi, None, (16, 8, 1),
                                         dtype=F64, **kw)
    jm = oj.ShallowWaterModel(grid=jg, gravitational_acceleration=9.81)
    tm = ot.ShallowWaterModel(grid=tg, gravitational_acceleration=9.81)
    js = jm.initial_state(h=lambda lam, phi, z: 1000.0 + 10.0 * jnp.exp(
        -((lam - 180.0) / 30.0) ** 2 - (phi / 15.0) ** 2))
    arrays = {k: np.asarray(getattr(js, k)) for k in SW_FIELDS}
    arrays.update(time=0.0, iteration=0, last_dt=0.0)
    ts = state_from_numpy(tm, arrays)
    for _ in range(3):
        js = jm.step(js, 60.0)
        ts = tm.step(ts, 60.0)
    S = tg.interior_slices
    for k in ("uh", "vh", "h"):
        assert_close(getattr(ts, k)[S], np.asarray(getattr(js, k))[S])
    assert float(ts.uh.abs().max()) > 0
