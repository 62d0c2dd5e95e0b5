"""oceananigans_torch's cubed-sphere hydrostatic model with the immersed
boundary objects as its bathymetry, against the JAX package, on the CPU in
float64 at C8.

``GridFittedBottom`` (the continents of
``tests/test_torch_cubed_sphere_hydrostatic.py``), ``GridFittedBoundary``
(the continents and a 3-D ridge below 400 m) and ``PartialCellBottom``
(the continents in partial cells, a minimum fraction of 0.2): the wet
masks, column depths, boundary cells and the partial cells' fractions
equal the JAX model's bit for bit. A ``GridFittedBottom`` model steps bit
for bit as the model given the bare bottom height (the path the cube test
file holds to the JAX model); the ``GridFittedBoundary`` model keeps its
volume to 1e-12 of the ocean's; the ``PartialCellBottom`` model, whose
heights scale every metric of its dynamics, steps within 1e-12 of each
group's largest value of the JAX model: 2 split-explicit RK3 steps, and 2
quasi-AB2 steps with the corner filter and flux conditions on b (the JAX
model stepping eagerly).
"""

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFieldBCs,
)
from oceananigans_tpu.boundary_conditions import FluxBC as JFluxBC
from oceananigans_tpu.models import cubed_sphere as jcs
from oceananigans_tpu.models import hydrostatic as jhyd

from test_torch_cubed_sphere_hydrostatic import (
    assert_close, b_init, bump, grids, two_continents,
)

NAMES = ("_wet_c", "_wet_u", "_wet_v", "_wet_w", "_Hc", "_Hu", "_Hv",
         "_bot_c", "_bot_u", "_top_c", "_top_v")


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


@pytest.fixture(scope="module")
def cube_grids():
    return grids(Nz=4)


def ridge_mask(lam, phi, z):
    return (z < two_continents(lam, phi)) | (
        (np.abs(lam - 100.0) < 10.0) & (z < -400.0))


def step(model, grid):
    return model.step(model.initial_state(eta=bump(grid), b=b_init), 600.0)


def test_grid_fitted_objects_match_jax(cube_grids):
    jg, tg = cube_grids

    def model(bathymetry):
        return ot.CubedSphereHydrostaticModel(
            tg, bathymetry=bathymetry,
            free_surface=ot.SplitExplicitFreeSurface(substeps=8))

    for tb, jb in ((ot.GridFittedBottom(two_continents),
                    oj.GridFittedBottom(two_continents)),
                   (ot.GridFittedBoundary(ridge_mask),
                    oj.GridFittedBoundary(ridge_mask))):
        tm = model(tb)
        jm = jcs.CubedSphereHydrostaticModel(jg, bathymetry=jb)
        for name in NAMES:
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name), name)
    a = step(model(ot.GridFittedBottom(two_continents)), tg)
    b = step(model(two_continents), tg)
    assert all(torch.equal(getattr(a, n), getattr(b, n))
               for n in ("u", "v", "eta", "U", "V"))
    m = model(ot.GridFittedBoundary(ridge_mask))
    s0 = m.initial_state(eta=bump(tg), b=b_init)
    s1 = m.step(s0, 600.0)
    assert all(bool(torch.isfinite(q).all()) for q in (s1.u, s1.v, s1.eta))
    drift = abs(float(m.total_volume(s1)) - float(m.total_volume(s0)))
    assert drift <= 1e-12 * float(m.ocean_volume())


@pytest.mark.parametrize("case", ["split_rk3", "ab2_filter_fluxes"])
def test_partial_cells_match_jax(cube_grids, case):
    jg, tg = cube_grids
    if case == "split_rk3":
        jkw = dict(free_surface=jhyd.SplitExplicitFreeSurface(substeps=8))
        tkw = dict(free_surface=ot.SplitExplicitFreeSurface(substeps=8))
    else:
        jkw = dict(timestepper="QuasiAdamsBashforth2", corner_filter=0.005,
                   boundary_conditions={"b": JFieldBCs(
                       top=JFluxBC(1e-8), bottom=JFluxBC(-1e-8))})
        tkw = dict(timestepper="QuasiAdamsBashforth2", corner_filter=0.005,
                   boundary_conditions={"b": ot.FieldBoundaryConditions(
                       top=ot.FluxBC(1e-8), bottom=ot.FluxBC(-1e-8))})
    jm = jcs.CubedSphereHydrostaticModel(
        jg, bathymetry=oj.PartialCellBottom(two_continents, 0.2), **jkw)
    tm = ot.CubedSphereHydrostaticModel(
        tg, bathymetry=ot.PartialCellBottom(two_continents, 0.2), **tkw)
    for name in NAMES + ("_frac_c", "_frac_u", "_frac_v"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      name)
    assert 0.2 <= tm._frac_c.min() < 1.0
    sj = jm.initial_state(eta=bump(jg), b=b_init)
    st = tm.initial_state(eta=bump(tg), b=b_init)
    for _ in range(2):
        sj = jm.step(sj, 600.0)
        st = tm.step(st, 600.0)
    for names in (("u", "v"), ("eta",), ("U", "V")):
        assert_close([(getattr(st, n), getattr(sj, n)) for n in names],
                     names)
    assert_close([(st.tracers["b"], sj.tracers["b"])], "b")
    for a, b in ((tm.ocean_volume(), jm.ocean_volume()),
                 (tm.total_tracer(st, "b"), jm.total_tracer(sj, "b"))):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))
