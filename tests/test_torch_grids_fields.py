"""oceananigans_torch grids, fields and halo fills against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
torch side runs in float64 on the CPU. Coordinates, set_field and halo
fills involve no arithmetic beyond what both packages do identically, so
they are compared to atol 1e-12 over the whole halo-extended array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.fields import set_field as j_set_field

ATOL = 1e-12
F64 = torch.float64
TOPOLOGIES = {
    "bpp": (oj.Bounded, oj.Periodic, oj.Periodic),
    "pbb": (oj.Periodic, oj.Bounded, oj.Bounded),
}
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "c": oj.LOC_C}


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


def grids(topology, halo, size=(6, 8, 5)):
    kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=topology,
              halo=halo)
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


@pytest.mark.parametrize("halo", [(1, 0, 0), (1, 1, 1), 2])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_coordinates_match(topo, halo):
    jg, tg = grids(TOPOLOGIES[topo], halo)
    assert tg.N == jg.N and tg.H == jg.H and tg.shape == jg.shape
    assert (tg.Lx, tg.Ly, tg.Lz) == (jg.Lx, jg.Ly, jg.Lz)
    assert tg.interior_slices == jg.interior_slices
    for j_name, t_name in (("xF", "xF"), ("xC", "xC"), ("dxC_", "xC_d"),
                           ("dxF_", "xF_d"), ("yF", "yF"), ("yC", "yC"),
                           ("dyC_", "yC_d"), ("dyF_", "yF_d"),
                           ("zF", "zF"), ("zC", "zC"), ("dzC_", "zC_d"),
                           ("dzF_", "zF_d")):
        a = getattr(tg, t_name)
        assert a.dtype == F64
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jg, j_name)),
                                   rtol=0, atol=ATOL, err_msg=t_name)


def test_flat_axis_and_unported_grids():
    jg = oj.RectilinearGrid(size=(6, 5), x=(0.0, 1.0), z=(-1.0, 0.0),
                            topology=(oj.Bounded, oj.Flat, oj.Bounded),
                            halo=1, dtype="float64")
    tg = ot.RectilinearGrid(size=(6, 5), x=(0.0, 1.0), z=(-1.0, 0.0),
                            topology=(ot.Bounded, ot.Flat, ot.Bounded),
                            halo=1, dtype=F64)
    assert tg.shape == jg.shape and tg.H == jg.H
    # a stretched x (once refused) builds as the JAX grid does
    kw = dict(size=(4, 4, 4), x=np.linspace(0, 1, 5) ** 2, y=(0.0, 1.0),
              z=(0.0, 1.0))
    ts = ot.RectilinearGrid(dtype=F64, **kw)
    js = oj.RectilinearGrid(dtype="float64", **kw)
    assert (ts.x_regular, ts.regular) == (js.x_regular, js.regular) == (
        False, False)
    np.testing.assert_array_equal(ts.xF.numpy(), np.asarray(js.xF))
    np.testing.assert_array_equal(ts.xF_d.numpy(), np.asarray(js.dxF_))


@pytest.mark.parametrize("loc", sorted(LOCS))
def test_set_field_matches(loc):
    jg, tg = grids(TOPOLOGIES["bpp"], (1, 1, 1))
    L = LOCS[loc]

    def f(x, y, z):
        return x * x - 2.0 * y * z + 0.5 * z

    np.testing.assert_allclose(
        ot.set_field(tg, f, loc=L).numpy(),
        np.asarray(j_set_field(jg, f, loc=L)), rtol=0, atol=ATOL)
    rng = np.random.default_rng(1)
    interior = rng.standard_normal(tg.N)
    np.testing.assert_allclose(
        ot.set_field(tg, interior, loc=L).numpy(),
        np.asarray(j_set_field(jg, interior, loc=L)), rtol=0, atol=ATOL)
    assert float(ot.set_field(tg, 2.5).sum()) == 2.5 * np.prod(tg.shape)


@pytest.mark.parametrize("halo", [(1, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("loc", sorted(LOCS))
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_fill_halo_regions_matches(topo, loc, halo):
    jg, tg = grids(TOPOLOGIES[topo], halo)
    L = LOCS[loc]
    a = np.random.default_rng(2).standard_normal(tg.shape)
    bcs = regularize_field_boundary_conditions(None, jg, L)
    ref = np.asarray(j_fill(jnp.asarray(a), jg, bcs, L))
    t = torch.tensor(a, dtype=F64)
    got = ot.fill_halo_regions(t, tg, loc=L)
    assert got is t                       # the fill writes in place
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_fill_halo_regions_axes_subset():
    jg, tg = grids(TOPOLOGIES["pbb"], (1, 1, 1))
    a = np.random.default_rng(3).standard_normal(tg.shape)
    bcs = regularize_field_boundary_conditions(None, jg, oj.LOC_V)
    ref = np.asarray(j_fill(jnp.asarray(a), jg, bcs, oj.LOC_V,
                            axes=(1,)))
    got = ot.fill_halo_regions(torch.tensor(a, dtype=F64), tg, loc=ot.LOC_V,
                               axes=(1,))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_unported_boundary_conditions_raise():
    """The communication classification (the distributed exchange's
    side), the polar and the zipper ones are ported and, on a Bounded y,
    fill as in the JAX package; a Connected axis takes communication
    conditions by default."""
    _, tg = grids(TOPOLOGIES["bpp"], 1)
    from oceananigans_torch.boundary_conditions import (
        regularize_field_boundary_conditions as t_regularize,
    )
    # valued conditions are ported, and so is the communication one
    t_regularize(ot.FieldBoundaryConditions(west=ot.FluxBC(1.0)), tg,
                 ot.LOC_C)
    from oceananigans_torch.boundary_conditions import default_bc
    from oceananigans_torch.grids.base import Connected
    assert default_bc(Connected, "c", "west").classification == \
        "communication"
    jp, tp = grids(TOPOLOGIES["pbb"], 2)
    for cls in ("polar", "zipper", "communication"):
        jb = regularize_field_boundary_conditions(
            oj.FieldBoundaryConditions(south=oj.BoundaryCondition(cls)), jp,
            oj.LOC_C)
        tb = t_regularize(
            ot.FieldBoundaryConditions(south=ot.BoundaryCondition(cls)), tp,
            ot.LOC_C)
        assert tb.south.classification == jb.south.classification == cls
        a = np.random.default_rng(5).standard_normal(tp.shape)
        ref = np.asarray(j_fill(jnp.asarray(a), jp, jb, oj.LOC_C))
        got = ot.fill_halo_regions(torch.tensor(a, dtype=F64), tp, tb,
                                   ot.LOC_C)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        t_regularize(ot.FieldBoundaryConditions(south=ot.FluxBC()), tg,
                     ot.LOC_C)


def test_grid_moves_with_to():
    _, tg = grids(TOPOLOGIES["bpp"], 1)
    names = {n for n, _ in tg.named_buffers()}
    assert {"xF", "xC", "xC_d", "xF_d", "zF_d"} <= names
    assert tg.device == torch.device("cpu") and tg.dtype == F64
