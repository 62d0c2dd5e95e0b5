"""oceananigans_torch's operations, ensembles and plots against the JAX
package's, on the CPU in float64.

Each function of ``operations.py`` takes the same seeded fields on a
rectilinear and a lat-lon grid in both packages, and the results agree to
1e-12 of their largest value. ``EnsembleModel`` steps the JAX package's
ensemble test (diffusion columns, ``tests/test_ensemble_and_pallas.py``)
and holds every member to the JAX ensemble within 1e-13, and three to
their serial runs bit for bit. The plotting helpers, with matplotlib's Agg
backend, draw the same arrays with the same labels as the JAX package's
for 1-D and 2-D fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import operations as top
from oceananigans_tpu import operations as jop

RTOL = 1e-12
F, C = oj.Face, oj.Center


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


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def rectilinear(pkg):
    kw = {"dtype": "float64"} if pkg is oj else {"dtype": torch.float64}
    return pkg.RectilinearGrid(size=(8, 6, 5), x=(0.0, 2.0), y=(0.0, 1.5),
                               z=(-1.0, 0.0), halo=2,
                               topology=(pkg.Periodic, pkg.Bounded,
                                         pkg.Bounded), **kw)


def latlon(pkg):
    kw = {"dtype": "float64"} if pkg is oj else {"dtype": torch.float64}
    return pkg.LatitudeLongitudeGrid(size=(8, 6, 5), longitude=(0.0, 40.0),
                                     latitude=(-30.0, 30.0),
                                     z=(-100.0, 0.0), halo=2, **kw)


GRIDS = {"rectilinear": rectilinear, "latlon": latlon}

#: each operation as f(pkg, ops, grid, fields), with fields u, v, w, c and
#: the boolean mask m, arrays of the package
OPERATIONS = {
    "dx_c": lambda p, o, g, f: o.dx(g, f["c"]),
    "dx_f": lambda p, o, g, f: o.dx(g, f["u"], (F, C, C)),
    "dy_c": lambda p, o, g, f: o.dy(g, f["c"]),
    "dy_f": lambda p, o, g, f: o.dy(g, f["v"], (C, F, C)),
    "dz_c": lambda p, o, g, f: o.dz(g, f["c"]),
    "dz_f": lambda p, o, g, f: o.dz(g, f["w"], (C, C, F)),
    "at_u_to_c": lambda p, o, g, f: o.at(g, f["u"], (F, C, C), (C, C, C)),
    "at_c_to_fff": lambda p, o, g, f: o.at(g, f["c"], (C, C, C), (F, F, F)),
    "average": lambda p, o, g, f: o.Average(g, f["c"]),
    "average_xy": lambda p, o, g, f: o.Average(g, f["c"], dims=(0, 1)),
    "average_z_at_u": lambda p, o, g, f: o.Average(g, f["u"], dims=2,
                                                   loc=(F, C, C)),
    "average_condition": lambda p, o, g, f: o.Average(
        g, f["c"], dims=(0, 2), condition=f["m"]),
    "conditional_average": lambda p, o, g, f: o.ConditionalAverage(
        g, f["c"], f["m"], dims=1),
    "integral": lambda p, o, g, f: o.Integral(g, f["c"]),
    "integral_x_at_v": lambda p, o, g, f: o.Integral(g, f["v"], dims=0,
                                                     loc=(C, F, C)),
    "cumulative_integral": lambda p, o, g, f: o.CumulativeIntegral(
        g, f["c"]),
    "cumulative_integral_y": lambda p, o, g, f: o.CumulativeIntegral(
        g, f["c"], dim=1),
    "reduction_max": lambda p, o, g, f: o.Reduction(
        jnp.max if p is oj else torch.amax, g, f["c"], dims=(1, 2)),
    "reduction_sum": lambda p, o, g, f: o.Reduction(
        jnp.sum if p is oj else torch.sum, g, f["c"]),
    "accumulation_cumsum": lambda p, o, g, f: o.Accumulation(
        jnp.cumsum if p is oj else torch.cumsum, g, f["c"], dims=0),
    "kernel_function": lambda p, o, g, f: o.KernelFunctionOperation(
        lambda grid, a, b, s=1.0: s * o.dx(grid, a) * b, g, f["c"], f["w"],
        s=2.0),
    "vertical_vorticity": lambda p, o, g, f: o.vertical_vorticity(
        g, f["u"], f["v"]),
    "kinetic_energy": lambda p, o, g, f: o.kinetic_energy(g, f["u"],
                                                          f["v"]),
    "kinetic_energy_3d": lambda p, o, g, f: o.kinetic_energy(
        g, f["u"], f["v"], f["w"]),
    "speed": lambda p, o, g, f: o.speed(g, f["u"], f["v"], f["w"]),
    "divergence": lambda p, o, g, f: o.divergence(g, f["u"], f["v"],
                                                  f["w"]),
    "laplacian": lambda p, o, g, f: o.laplacian(g, f["c"]),
}


@pytest.fixture(scope="module")
def fields():
    """Seeded fields of each grid's shape (the grids share it)."""
    shape = rectilinear(ot).shape
    rng = np.random.default_rng(11)
    out = {n: rng.standard_normal(shape) for n in ("u", "v", "w", "c")}
    out["m"] = rng.standard_normal(shape) > 0
    return out


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("op", sorted(OPERATIONS))
def test_operation_matches_jax(fields, grid, op):
    jg, tg = GRIDS[grid](oj), GRIDS[grid](ot)
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = {k: torch.from_numpy(v) for k, v in fields.items()}
    ref = np.asarray(OPERATIONS[op](oj, jop, jg, jf))
    got = OPERATIONS[op](ot, top, tg, tf)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == ref.shape
    if got.shape == tuple(tg.shape):
        # whole fields: the interior (halo cells hold the shifts' wraps)
        got, ref = tg.interior(got), tg.interior(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale)


def test_leading_axis_passes_through(fields):
    """Axes count from the end: a leading member axis passes through the
    operations and the reductions."""
    tg = rectilinear(ot)
    c = torch.from_numpy(np.stack([fields["c"], 2 * fields["c"]]))
    one = top.Average(tg, c[0], dims=(0, 1))
    both = top.Average(tg, c, dims=(0, 1))
    assert both.shape == (2, *one.shape)
    torch.testing.assert_close(both[1], 2 * one, rtol=1e-15, atol=0)
    assert torch.equal(top.laplacian(tg, c)[0], top.laplacian(tg, c[0]))


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------

def column_model(pkg):
    kw = {} if pkg is oj else {"dtype": torch.float64}
    grid = pkg.RectilinearGrid(size=(16,), z=(0.0, np.pi),
                               topology=(pkg.Flat, pkg.Flat, pkg.Bounded),
                               **kw)
    Model = oj.models.NonhydrostaticModel if pkg is oj else \
        ot.NonhydrostaticModel
    return Model(grid=grid, advection=None, tracers=("c",),
                 closure=pkg.VerticalScalarDiffusivity(
                     kappa=0.1, time_discretization=(
                         pkg.VerticallyImplicitTimeDiscretization)))


def test_ensemble_matches_jax():
    """8 diffusion columns, 20 steps: each member of the port's batched
    ensemble within 1e-13 of the JAX ensemble's and bitwise equal to the
    port's serial run of the same column."""
    from oceananigans_tpu.ensemble import EnsembleModel as JEnsemble
    n, dt, steps = 8, 1e-3, 20
    amps = np.linspace(0.5, 2.0, n)
    jmodel, tmodel = column_model(oj), column_model(ot)
    jens, tens = JEnsemble(jmodel, n=n), ot.EnsembleModel(tmodel, n=n)
    js = jens.initial_states(c=lambda m, x, y, z: amps[m] * jnp.cos(z))
    ts = tens.initial_states(c=lambda m, x, y, z: amps[m] * torch.cos(z))
    assert ts.tracers["c"].shape == (n, *tmodel.grid.shape)
    for _ in range(steps):
        js = jens.step(js, dt)
        ts = tens.step(ts, dt)
    assert ts.clock.iteration == steps
    ref = np.asarray(js.tracers["c"])
    np.testing.assert_allclose(ts.tracers["c"].numpy(), ref, rtol=0,
                               atol=1e-13)
    for m in (0, 3, n - 1):
        serial = tmodel.initial_state(
            c=lambda x, y, z: amps[m] * torch.cos(z))
        for _ in range(steps):
            serial = tmodel.step(serial, dt)
        member = tens.member(ts, m)
        assert torch.equal(member.tracers["c"], serial.tracers["c"])
        assert member.clock.iteration == serial.clock.iteration
        np.testing.assert_allclose(
            member.tracers["c"].numpy(),
            np.asarray(jens.member(js, m).tracers["c"]), rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# Plots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plt():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def plot_cases(pkg):
    """(grid, field, location) of a profile, an x-z section and a lat-lon
    map."""
    kw = {} if pkg is oj else {"dtype": torch.float64}
    xp = jnp if pkg is oj else torch
    set_field = (oj.fields.set_field if pkg is oj else ot.set_field)
    g1 = pkg.RectilinearGrid(size=16, z=(-1.0, 0.0),
                             topology=(pkg.Flat, pkg.Flat, pkg.Bounded), **kw)
    g2 = pkg.RectilinearGrid(size=(16, 12), x=(0.0, 2.0), z=(-1.0, 0.0),
                             topology=(pkg.Periodic, pkg.Flat, pkg.Bounded),
                             **kw)
    g3 = pkg.LatitudeLongitudeGrid(size=(12, 8, 1), longitude=(0.0, 60.0),
                                   latitude=(-20.0, 20.0), z=(-10.0, 0.0),
                                   **kw)
    return {
        "profile": (g1, set_field(g1, lambda x, y, z: xp.exp(z)), (C, C, C)),
        "section": (g2, set_field(g2, lambda x, y, z: xp.sin(np.pi * x) * z,
                                  loc=(F, C, C)), (F, C, C)),
        "map": (g3, set_field(g3, lambda x, y, z: xp.cos(xp.deg2rad(y))
                              * xp.sin(xp.deg2rad(x)) + 0 * z), (C, C, C)),
    }


@pytest.mark.parametrize("case", ["profile", "section", "map"])
def test_plots_match_jax(plt, case):
    from oceananigans_torch.utils import plotting as tplot
    from oceananigans_tpu.utils import plotting as jplot
    (jg, ja, loc), (tg, ta, _) = plot_cases(oj)[case], plot_cases(ot)[case]
    assert (tplot.deduce_dimensionality(tg, ta)
            == jplot.deduce_dimensionality(jg, ja))
    jart = jplot.fieldplot(jg, ja, loc=loc)
    tart = tplot.fieldplot(tg, ta, loc=loc)
    for art in (jart, tart):
        assert art.axes.get_xlabel() or art.axes.get_ylabel()
    assert tart.axes.get_xlabel() == jart.axes.get_xlabel()
    assert tart.axes.get_ylabel() == jart.axes.get_ylabel()
    if case == "profile":
        np.testing.assert_allclose(tart.get_xdata(), jart.get_xdata(),
                                   rtol=RTOL)
        np.testing.assert_allclose(tart.get_ydata(), jart.get_ydata(),
                                   rtol=RTOL)
    else:
        np.testing.assert_allclose(np.asarray(tart.get_array()),
                                   np.asarray(jart.get_array()), rtol=RTOL)
        np.testing.assert_allclose(tart.get_coordinates(),
                                   jart.get_coordinates(), rtol=RTOL)
    with pytest.raises(ValueError, match="3-D"):
        g = rectilinear(ot)
        tplot.fieldplot(g, ot.new_field(g))
