"""oceananigans_torch's boundary conditions against the JAX package's, on the
CPU in float64.

Every condition kind (flux, value, gradient, open with its matching
schemes, periodic) with every kind of value (none, a number, an array over
the boundary slab, a callable of the transverse coordinates and time, a
time series, and, for fluxes into tendencies, a callable of a field's
boundary slab through ``field_dependencies``), on each axis and at each
location along it: ``fill_halo_regions`` fills the same halos and
``apply_flux_bcs`` adds the same boundary fluxes, to 1e-12 of the largest
value. Callables are given to each package as its own function of the same
math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import boundary_conditions as tbc
from oceananigans_tpu import boundary_conditions as jbc

RTOL = 1e-12
SIZE = (6, 5, 4)
HALO = (2, 2, 2)
EXTENT = (1.0, 2.0, 0.5)
TIME, DT = 0.3, 0.01


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


def grids(topology=("Bounded",) * 3):
    kw = dict(size=SIZE, extent=EXTENT, halo=HALO)
    return (oj.RectilinearGrid(dtype="float64",
                               topology=tuple(getattr(oj, t)
                                              for t in topology), **kw),
            ot.RectilinearGrid(dtype=torch.float64,
                               topology=tuple(getattr(ot, t)
                                              for t in topology), **kw))


def slab_shape(axis):
    """The halo-extended boundary slab of ``axis``."""
    shape = [n + 2 * h for n, h in zip(SIZE, HALO)]
    shape[axis] = 1
    return tuple(shape)


class TimeSeries:
    """Boundary slabs over the interior transverse extents at three
    times, the duck type both packages interpolate."""

    def __init__(self, axis):
        n1, n2 = [n for ax, n in enumerate(SIZE) if ax != axis]
        rng = np.random.default_rng(7)
        self.times = np.array([0.0, 0.25, 1.0])
        self.data = rng.standard_normal((3, n1, n2))


def value(kind, axis, pkg):
    """The condition value of ``kind`` for package ``pkg`` (oj or ot)."""
    mod = jnp if pkg is oj else torch
    if kind == "none":
        return None
    if kind == "number":
        return 0.7
    if kind == "array":
        return np.random.default_rng(3).standard_normal(slab_shape(axis))
    if kind == "callable":
        return lambda c1, c2, t: (0.5 + 0.1 * mod.sin(3 * c1)
                                  * mod.cos(2 * c2) + 0.2 * t)
    if kind == "series":
        return TimeSeries(axis)
    if kind == "field":
        return lambda c1, c2, t, c: 0.1 * c + 0.01 * t
    raise ValueError(kind)


def condition(kind, val, pkg, side):
    """A boundary condition of ``kind`` with value ``val``."""
    if kind == "flux":
        return (pkg.FluxBC(val, field_dependencies="c") if callable(val)
                and val.__code__.co_argcount == 4 else pkg.FluxBC(val))
    if kind == "value":
        return pkg.ValueBC(val)
    if kind == "gradient":
        return pkg.GradientBC(val)
    if kind == "open":
        return pkg.OpenBC(val)
    if kind == "flat_extrapolation":
        return pkg.FlatExtrapolationOpenBC()
    if kind == "perturbation_advection":
        # inflow on one side and outflow on the other for a positive mean
        return pkg.PerturbationAdvectionOpenBC(
            val, inflow_timescale=0.05 if side == "west" else 0.2,
            outflow_timescale=float("inf") if side == "west" else 1.0)
    raise ValueError(kind)


SIDES = (("west", "east"), ("south", "north"), ("bottom", "top"))


def bundles(axis, kind, vkind, loc):
    """The regularized condition bundles of both packages, with the
    condition on both sides of ``axis``."""
    jg, tg = grids()
    out = []
    for pkg, bc_mod, grid in ((oj, jbc, jg), (ot, tbc, tg)):
        sides = {s: condition(kind, value(vkind, axis, pkg), pkg, s)
                 for s in SIDES[axis]}
        out.append(bc_mod.regularize_field_boundary_conditions(
            pkg.FieldBoundaryConditions(**sides), grid, loc))
    return jg, tg, out


def location(axis, where):
    loc = [oj.Center] * 3
    if where == "face":
        loc[axis] = oj.Face
    return tuple(loc)


def f64(x):
    """A clock value as the port's models carry it: a 0-d tensor in the
    state's dtype."""
    return torch.tensor(x, dtype=torch.float64)


def random_field(seed=0):
    shape = tuple(n + 2 * h for n, h in zip(SIZE, HALO))
    return np.random.default_rng(seed).standard_normal(shape)


def assert_close(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale)


FILL_CASES = (
    [("flux", v, w) for v in ("none", "number", "callable")
     for w in ("center", "face")]
    + [("value", v, w) for v in ("number", "array", "callable", "series")
       for w in ("center", "face")]
    + [("gradient", v, w) for v in ("number", "array", "callable")
       for w in ("center", "face")]
    + [("open", v, w) for v in ("none", "number", "array", "callable")
       for w in ("center", "face")]
    + [("flat_extrapolation", "none", "face"),
       ("perturbation_advection", "number", "face"),
       ("perturbation_advection", "array", "face")])


@pytest.mark.parametrize("case", FILL_CASES, ids="-".join)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fill_halo_regions_matches_jax(axis, case):
    """Every halo of a random field after a fill at time 0.3 with the last
    Δt 0.01 (which the radiation condition reads)."""
    kind, vkind, where = case
    loc = location(axis, where)
    jg, tg, (jb, tb) = bundles(axis, kind, vkind, loc)
    a = random_field()
    ref = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, jb, loc,
                                           time=TIME, dt=DT))
    t = torch.tensor(a)
    got = tbc.fill_halo_regions(t, tg, tb, loc, time=f64(TIME), dt=f64(DT))
    assert got is t
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("side", ["first", "no_dt"])
def test_perturbation_advection_first_fill_is_a_no_op(side):
    """Without a last Δt (the first fill) the radiation condition keeps
    the wall value, in both packages."""
    loc = location(0, "face")
    jg, tg, (jb, tb) = bundles(0, "perturbation_advection", "number", loc)
    a = random_field(1)
    dt = None if side == "no_dt" else 0.0
    ref = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, jb, loc,
                                           time=TIME, dt=dt))
    got = tbc.fill_halo_regions(torch.tensor(a), tg, tb, loc,
                                time=f64(TIME),
                                dt=None if dt is None else f64(dt))
    assert_close(got.numpy(), ref)
    # the wall faces' interior rows (x = 2 and 8) are the given values
    yz = (slice(2, 7), slice(2, 6))
    for wall in (2, 8):
        assert np.array_equal(ref[(wall, *yz)], a[(wall, *yz)])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_periodic_fill_matches_jax(axis):
    topology = ["Bounded"] * 3
    topology[axis] = "Periodic"
    jg, tg = grids(tuple(topology))
    a = random_field(2)
    loc = location(axis, "face")
    jb = jbc.regularize_field_boundary_conditions(None, jg, loc)
    tb = tbc.regularize_field_boundary_conditions(None, tg, loc)
    ref = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, jb, loc))
    got = tbc.fill_halo_regions(torch.tensor(a), tg, tb, loc)
    assert_close(got.numpy(), ref)


@pytest.mark.parametrize("vkind", ["number", "array", "callable", "series",
                                   "field"])
@pytest.mark.parametrize("where", ["center", "face"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_apply_flux_bcs_matches_jax(axis, where, vkind):
    """Boundary fluxes into a random tendency: a number, an array, a
    callable of (c1, c2, t), a time series, and a callable of the field
    ``c``'s boundary slab."""
    loc = location(axis, where)
    jg, tg, (jb, tb) = bundles(axis, "flux", vkind, loc)
    G, c = random_field(3), random_field(4)
    ref = np.asarray(jbc.apply_flux_bcs(jnp.asarray(G), jg, jb, loc,
                                        time=TIME,
                                        fields={"c": jnp.asarray(c)}))
    t = torch.tensor(G)
    got = tbc.apply_flux_bcs(t, tg, tb, loc, time=f64(TIME),
                             fields={"c": torch.tensor(c)})
    assert got is t
    assert not np.array_equal(ref, G)
    assert_close(got.numpy(), ref)


def test_homogeneous_flux_adds_nothing():
    loc = location(2, "center")
    _, tg, (_, tb) = bundles(2, "flux", "none", loc)
    G = random_field(5)
    got = tbc.apply_flux_bcs(torch.tensor(G), tg, tb, loc)
    assert np.array_equal(got.numpy(), G)


def test_field_dependent_value_needs_fields():
    loc = location(2, "center")
    _, tg, (_, tb) = bundles(2, "flux", "field", loc)
    with pytest.raises(ValueError, match="field-dependent"):
        tbc.apply_flux_bcs(torch.tensor(random_field()), tg, tb, loc)


def test_regularization_matches_jax():
    """Defaults per topology and location, the long-form aliases, and the
    refusals: a non-periodic condition on a periodic axis; communication
    conditions name their ROADMAP item. Polar and zipper conditions given
    on the south and north of a center-located field are kept and fill as
    in the JAX package (the polar value the zonal mean of the boundary
    row; the zipper, on a grid without a fold, a no-flux mirror)."""
    jg, tg = grids(("Periodic", "Bounded", "Bounded"))
    for loc in (oj.LOC_U, oj.LOC_V, oj.LOC_W, oj.LOC_C):
        jb = jbc.regularize_field_boundary_conditions(None, jg, loc)
        tb = tbc.regularize_field_boundary_conditions(None, tg, loc)
        for axis in range(3):
            for j, t in zip(jb.sides(axis), tb.sides(axis)):
                assert (j.classification, j.condition) == (
                    t.classification, t.condition)
    assert ot.FluxBoundaryCondition is ot.FluxBC
    assert ot.ValueBoundaryCondition is ot.ValueBC
    assert ot.GradientBoundaryCondition is ot.GradientBC
    assert ot.OpenBoundaryCondition is ot.OpenBC
    with pytest.raises(ValueError, match="periodic"):
        tbc.regularize_field_boundary_conditions(
            ot.FieldBoundaryConditions(west=ot.ValueBC(1.0)), tg, oj.LOC_C)
    for cls in ("polar", "zipper"):
        bcs = [pkg.FieldBoundaryConditions(
            south=pkg.BoundaryCondition(cls),
            north=pkg.BoundaryCondition(cls)) for pkg in (oj, ot)]
        jb = jbc.regularize_field_boundary_conditions(bcs[0], jg, oj.LOC_C)
        tb = tbc.regularize_field_boundary_conditions(bcs[1], tg, oj.LOC_C)
        assert [b.classification for b in tb.sides(1)] == [
            b.classification for b in jb.sides(1)] == [cls, cls]
        a = np.random.default_rng(4).standard_normal(tg.shape)
        ref = jbc.fill_halo_regions(jnp.asarray(a), jg, jb, oj.LOC_C)
        got = tbc.fill_halo_regions(torch.tensor(a), tg, tb, oj.LOC_C)
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= RTOL * \
            np.abs(np.asarray(ref)).max()
    # a communication condition (the distributed exchange's side) is kept,
    # and the fill leaves its halo rows as they are, as the JAX fill does
    bcs = [pkg.FieldBoundaryConditions(
        south=pkg.BoundaryCondition("communication")) for pkg in (oj, ot)]
    jb = jbc.regularize_field_boundary_conditions(bcs[0], jg, oj.LOC_C)
    tb = tbc.regularize_field_boundary_conditions(bcs[1], tg, oj.LOC_C)
    assert tb.south.classification == jb.south.classification == \
        "communication"
    a = np.random.default_rng(6).standard_normal(tg.shape)
    ref = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, jb, oj.LOC_C))
    got = tbc.fill_halo_regions(torch.tensor(a), tg, tb, oj.LOC_C).numpy()
    sx, _, sz = tg.interior_slices
    H = tg.H[1]
    np.testing.assert_array_equal(got[sx, :H, sz], a[sx, :H, sz])
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_array_condition_moves_to_the_grid():
    """An array condition becomes a tensor in the grid's dtype."""
    _, tg = grids()
    tb = tbc.regularize_field_boundary_conditions(
        ot.FieldBoundaryConditions(top=ot.ValueBC(
            np.ones(slab_shape(2), dtype=np.float32))), tg, oj.LOC_C)
    assert torch.is_tensor(tb.top.condition)
    assert tb.top.condition.dtype == torch.float64
