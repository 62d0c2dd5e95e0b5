"""oceananigans_torch's field layer, closures and tridiagonal solve against
the JAX package, on the CPU in float64.

The field constructors and reductions, regridding and interpolation; each
closure's diffusivities and flux divergences on the same random fields;
``tridiagonal_solve`` (also against a dense solve); the vertically implicit
diffusion step; and ``cell_diffusion_timescale``. Results agree to 1e-12
of the largest value. Also the configuration and buoyancy names the
package exports beside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import closures as tcl
from oceananigans_torch import fields as tf
from oceananigans_torch.solvers.tridiagonal import tridiagonal_solve
from oceananigans_tpu import closures as jcl
from oceananigans_tpu import fields as jf
from oceananigans_tpu.solvers.tridiagonal import (
    tridiagonal_solve as j_tridiagonal_solve,
)

RTOL = 1e-12
KW = dict(size=(8, 6, 5), x=(0.0, 1.0), y=(0.0, 2.0), z=(-0.5, 0.0),
          topology=(oj.Periodic, oj.Periodic, oj.Bounded), halo=2)


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


def grids(**over):
    kw = dict(KW, **over)
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=torch.float64, **kw))


def close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert got.shape == ref.shape or ref.ndim == 0, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * scale, np.abs(got - ref).max()


def random_fields(grid, names, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(grid.shape) for n in names}


# ---------------------------------------------------------------------------
# Fields
# ---------------------------------------------------------------------------

CONSTRUCTORS = ("Field", "CenterField", "XFaceField", "YFaceField",
                "ZFaceField")


@pytest.mark.parametrize("kind", ["number", "interior", "full", "callable"])
@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_field_constructors_match_jax(name, kind):
    jg, tg = grids()
    rng = np.random.default_rng(1)
    values = {
        "number": (1.5, 1.5),
        "interior": (rng.standard_normal(tuple(tg.N)),) * 2,
        "full": (rng.standard_normal(tg.shape),) * 2,
        "callable": (lambda x, y, z: jnp.sin(x) * y + z,
                     lambda x, y, z: torch.sin(x) * y + z)}[kind]
    close(getattr(tf, name)(tg, values[1]), getattr(jf, name)(jg, values[0]))


def test_lazy_fields_match_jax():
    jg, tg = grids()
    for jfn, tfn in ((jf.ConstantField(2.5), tf.ConstantField(2.5)),
                     (jf.ZeroField(), tf.ZeroField()),
                     (jf.FunctionField(lambda x, y, z: x * y - z),
                      tf.FunctionField(lambda x, y, z: x * y - z))):
        np.testing.assert_array_equal(tf.set_field(tg, tfn).numpy(),
                                      np.asarray(jf.set_field(jg, jfn)))
    jb = jf.BackgroundField(lambda x, y, z, t, p: p * x + t, parameters=3.0)
    tb = tf.BackgroundField(lambda x, y, z, t, p: p * x + t, parameters=3.0)
    x = np.linspace(0, 1, 5)
    np.testing.assert_array_equal(tb(torch.tensor(x), 0, 0, 0.5).numpy(),
                                  np.asarray(jb(jnp.asarray(x), 0, 0, 0.5)))
    np.testing.assert_array_equal(tb(torch.tensor(x), 0, 0).numpy(),
                                  np.asarray(jb(jnp.asarray(x), 0, 0)))


@pytest.mark.parametrize("loc", ["LOC_C", "LOC_U", "LOC_V", "LOC_W"])
def test_reductions_match_jax(loc):
    jg, tg = grids()
    a = random_fields(tg, "a")["a"]
    ja, ta = jnp.asarray(a), torch.tensor(a)
    L = getattr(oj, loc)
    for name in ("field_mean", "field_integral", "field_sum"):
        close(getattr(tf, name)(tg, ta, L), getattr(jf, name)(jg, ja, L))
    for name in ("field_max", "field_min", "field_abs_max"):
        close(getattr(tf, name)(tg, ta), getattr(jf, name)(jg, ja))


def test_with_interior_matches_jax():
    jg, tg = grids()
    a = random_fields(tg, "a")["a"]
    vals = np.random.default_rng(2).standard_normal(tuple(tg.N))
    ta = torch.tensor(a)
    got = tf.with_interior(tg, ta, vals)
    close(got, jf.with_interior(jg, jnp.asarray(a), vals))
    assert np.array_equal(ta.numpy(), a)    # the argument is unchanged


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_regrid_matches_jax(axis):
    """Conservative regridding onto a grid with another resolution along
    ``axis``; the integral along the axis is kept."""
    size = list(KW["size"])
    size[axis] = 3 + axis
    (jg, tg), (jd, td) = grids(), grids(size=tuple(size))
    a = random_fields(tg, "a")["a"]
    fn = ("regrid_x", "regrid_y", "regrid_z")[axis]
    got = getattr(tf, fn)(tg, td, torch.tensor(a))
    close(got, getattr(jf, fn)(jg, jd, jnp.asarray(a)))
    close(tf.field_integral(td, got), tf.field_integral(tg, torch.tensor(a)))


@pytest.mark.parametrize("loc", ["LOC_C", "LOC_U", "LOC_W"])
def test_interpolate_matches_jax(loc):
    jg, tg = grids()
    a = random_fields(tg, "a")["a"]
    rng = np.random.default_rng(3)
    pts = (rng.uniform(0, 1, 7), rng.uniform(0, 2, 7), rng.uniform(-0.5, 0, 7))
    L = getattr(oj, loc)
    got = tf.interpolate(tg, torch.tensor(a), L, *pts)
    ref = jf.interpolate(jg, jnp.asarray(a), L, *(jnp.asarray(p)
                                                   for p in pts))
    close(got, ref)
    one = tf.interpolate(tg, torch.tensor(a), L, 0.3, 0.7, -0.2)
    close(one, jf.interpolate(jg, jnp.asarray(a), L, 0.3, 0.7, -0.2))


def test_config_and_exported_names():
    """``set_float_type``/``float_type``, ``TEOS10``, ``BuoyancyField`` and
    ``PressureField``; ``Clock``, ``ZCoordinate``, ``field_integral`` and
    ``BoundaryCondition`` are exported."""
    old = ot.config.float_type
    try:
        ot.set_float_type("float64")
        assert ot.float_type() == torch.float64
        ot.set_float_type(np.float32)
        assert ot.float_type() == torch.float32
    finally:
        ot.config.float_type = old
    assert ot.TEOS10 is ot.TEOS10EquationOfState
    for name in ("Clock", "ZCoordinate", "field_integral",
                 "BoundaryCondition", "PressureField", "BuoyancyField"):
        assert name in ot.__all__ and hasattr(ot, name)
    grid = ot.RectilinearGrid(size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64)
    model = ot.NonhydrostaticModel(grid=grid, buoyancy=ot.BuoyancyTracer())
    state = model.initial_state(b=lambda x, y, z: z)
    assert ot.BuoyancyField(model, state) is state.tracers["b"]
    assert ot.PressureField(model, state) is state.pressure
    hydro = ot.HydrostaticFreeSurfaceModel(grid=grid)
    with pytest.raises(ValueError):
        ot.PressureField(hydro, hydro.initial_state())
    with pytest.raises(ValueError):
        ot.BuoyancyField(hydro, hydro.initial_state())


def test_teos10_buoyancy_field_matches_jax():
    jg, tg = grids()
    f = random_fields(tg, ("T", "S"))
    jm = oj.NonhydrostaticModel(grid=jg, buoyancy=oj.SeawaterBuoyancy(
        equation_of_state=oj.TEOS10()))
    tm = ot.NonhydrostaticModel(grid=tg, buoyancy=ot.SeawaterBuoyancy(
        equation_of_state=ot.TEOS10()))

    class S:
        pass
    js, ts = S(), S()
    js.tracers = {k: jnp.asarray(v) for k, v in f.items()}
    ts.tracers = {k: torch.tensor(v) for k, v in f.items()}
    close(ot.BuoyancyField(tm, ts), oj.BuoyancyField(jm, js))


# ---------------------------------------------------------------------------
# Closures
# ---------------------------------------------------------------------------

def closure_pair(name):
    """The same closure in both packages."""
    def make(pkg):
        mod = jnp if pkg is oj else torch
        nu_arr = 1e-3 * (1 + np.random.default_rng(4).random((12, 10, 9)))
        implicit = pkg.VerticallyImplicitTimeDiscretization
        return {
            "scalar": pkg.ScalarDiffusivity(nu=1e-3, kappa=2e-3),
            "scalar_dict": pkg.ScalarDiffusivity(nu=1e-3,
                                                 kappa={"b": 3e-3}),
            "scalar_array": pkg.ScalarDiffusivity(nu=nu_arr, kappa=1e-3),
            "scalar_callable": pkg.ScalarDiffusivity(
                nu=lambda x, y, z: 1e-3 * (1.5 + mod.sin(x)) + 0 * y + 0 * z,
                kappa=1e-3),
            "vertical": pkg.VerticalScalarDiffusivity(nu=1e-3, kappa=2e-3),
            "vertical_implicit": pkg.VerticalScalarDiffusivity(
                nu=1e-3, kappa=2e-3, time_discretization=implicit),
            "horizontal": pkg.HorizontalScalarDiffusivity(nu=1e-3,
                                                          kappa=2e-3),
            "biharmonic": pkg.ScalarBiharmonicDiffusivity(nu=1e-6,
                                                          kappa=2e-6),
            "biharmonic_h": pkg.HorizontalScalarBiharmonicDiffusivity(
                nu=1e-6, kappa=2e-6),
            "biharmonic_v": pkg.VerticalScalarBiharmonicDiffusivity(
                nu=1e-6, kappa=2e-6),
            "smagorinsky": pkg.SmagorinskyLilly(),
            "smagorinsky_pr": pkg.Smagorinsky(coefficient=0.2, Cb=0.5,
                                              Pr={"b": 0.7}),
            "dynamic": pkg.DynamicSmagorinsky(),
            "amd": pkg.AnisotropicMinimumDissipation(),
            "convective": pkg.ConvectiveAdjustmentVerticalDiffusivity(
                convective_kappa_z=1.0, convective_nu_z=0.5,
                background_kappa_z=1e-5, background_nu_z=1e-4),
        }[name]
    return make(oj), make(ot)


CLOSURE_NAMES = ("scalar", "scalar_dict", "scalar_array", "scalar_callable",
                 "vertical", "vertical_implicit", "horizontal", "biharmonic",
                 "biharmonic_h", "biharmonic_v", "smagorinsky",
                 "smagorinsky_pr", "dynamic", "amd", "convective")


def closure_inputs():
    jg, tg = grids()
    f = random_fields(tg, ("u", "v", "w", "b"))
    # an unstable top half, so the convective adjustment switches on
    f["b"] = f["b"] * 0.1 + 0.05 * np.asarray(tg.zC) ** 2
    jb = oj.BuoyancyForce(oj.BuoyancyTracer())
    tb = ot.BuoyancyForce(ot.BuoyancyTracer())
    jin = {k: jnp.asarray(v) for k, v in f.items()}
    tin = {k: torch.tensor(v) for k, v in f.items()}
    return (jg, jin, jb), (tg, tin, tb)


@pytest.mark.parametrize("name", CLOSURE_NAMES)
def test_closure_terms_match_jax(name):
    """Diffusivities, the momentum stress divergences and the tracer flux
    divergence, with and without the implicit part, over whole arrays."""
    jc, tc = closure_pair(name)
    (jg, jin, jb), (tg, tin, tb) = closure_inputs()
    jd = jcl.compute_diffusivities(jc, jg, jin["u"], jin["v"], jin["w"],
                                   {"b": jin["b"]}, jb)
    td = tcl.compute_diffusivities(tc, tg, tin["u"], tin["v"], tin["w"],
                                   {"b": tin["b"]}, tb)
    assert len(jd) == len(td) == 1
    if jd[0] is None:
        assert td[0] is None
    else:
        assert sorted(jd[0]) == sorted(td[0])
        for k in jd[0]:
            close(td[0][k], jd[0][k])
    for implicit in (True, False):
        jm = jcl.momentum_flux_divergences(
            jc, jg, jin["u"], jin["v"], jin["w"], {"b": jin["b"]}, jd,
            include_implicit=implicit)
        tm = tcl.momentum_flux_divergences(
            tc, tg, tin["u"], tin["v"], tin["w"], {"b": tin["b"]}, td,
            include_implicit=implicit)
        for t, j in zip(tm, jm):
            close(torch.as_tensor(t, dtype=torch.float64).expand(tg.shape),
                  np.broadcast_to(np.asarray(j), tg.shape))
        jt = jcl.tracer_flux_divergence(jc, jg, "b", jin["b"],
                                        {"b": jin["b"]}, jd,
                                        include_implicit=implicit)
        tt = tcl.tracer_flux_divergence(tc, tg, "b", tin["b"],
                                        {"b": tin["b"]}, td,
                                        include_implicit=implicit)
        close(torch.as_tensor(tt, dtype=torch.float64).expand(tg.shape),
              np.broadcast_to(np.asarray(jt), tg.shape))
    # the diffusivity and viscosity accessors and the implicit flag
    assert tc.vertically_implicit == jc.vertically_implicit
    assert tc.required_halo() == jc.required_halo()
    for t, j in ((tcl.viscosity(tc, td[0]), jcl.viscosity(jc, jd[0])),
                 (tcl.diffusivity(tc, td[0], "b"),
                  jcl.diffusivity(jc, jd[0], "b"))):
        if callable(j):
            assert callable(t)
        elif torch.is_tensor(t):
            close(t.expand(tg.shape), np.broadcast_to(np.asarray(j),
                                                      tg.shape))
        else:
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("names", [(), ("scalar",), ("biharmonic",),
                                   ("smagorinsky",), ("dynamic",),
                                   ("scalar_dict", "convective")])
def test_cell_diffusion_timescale_matches_jax(names):
    pairs = [closure_pair(n) for n in names]
    jc = tuple(p[0] for p in pairs) or None
    tc = tuple(p[1] for p in pairs) or None
    (jg, jin, jb), (tg, tin, tb) = closure_inputs()
    jd = jcl.compute_diffusivities(jc, jg, jin["u"], jin["v"], jin["w"],
                                   {"b": jin["b"]}, jb)
    td = tcl.compute_diffusivities(tc, tg, tin["u"], tin["v"], tin["w"],
                                   {"b": tin["b"]}, tb)
    ref = float(jcl.cell_diffusion_timescale(jc, jg, jd))
    got = float(tcl.cell_diffusion_timescale(tc, tg, td))
    if not names:
        assert got == ref == float("inf")
    else:
        assert got == pytest.approx(ref, rel=RTOL)
    assert tcl.closure_required_halo(tc) == jcl.closure_required_halo(jc)
    assert (tcl.closure_is_vertically_implicit(tc)
            == jcl.closure_is_vertically_implicit(jc))


def test_smagorinsky_dispatch_matches_jax():
    """``Smagorinsky`` builds the Lilly or the dynamic closure from its
    coefficient, as the JAX constructor does."""
    for coef in (None, 0.1, "lilly", "dynamic"):
        out = []
        for pkg in (oj, ot):
            c = {"lilly": pkg.LillyCoefficient(0.2, 0.5),
                 "dynamic": pkg.DynamicCoefficient(averaging=1)}.get(
                     coef, coef)
            out.append(pkg.Smagorinsky(coefficient=c, Cb=2.0, Pr=0.5))
        assert type(out[0]).__name__ == type(out[1]).__name__
        assert vars(out[0]) == vars(out[1])


# ---------------------------------------------------------------------------
# The tridiagonal solve and the implicit step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [
    # (a, b, c, d) shapes: all full, coefficients per level only, a mix
    ((4, 3, 9),) * 4,
    ((1, 1, 9), (1, 1, 9), (1, 1, 9), (4, 3, 9)),
    ((9,), (1, 3, 9), (4, 1, 9), (4, 3, 9))])
def test_tridiagonal_solve_matches_jax_and_dense(shapes):
    rng = np.random.default_rng(5)
    a, c = (rng.uniform(-1, 0, s) for s in (shapes[0], shapes[2]))
    b = 3.0 + rng.random(shapes[1])
    d = rng.standard_normal(shapes[3])
    got = tridiagonal_solve(*(torch.tensor(t) for t in (a, b, c, d)))
    ref = np.asarray(j_tridiagonal_solve(*(jnp.asarray(t)
                                           for t in (a, b, c, d))))
    close(got, ref)
    A = np.broadcast_to(a, d.shape)[1, 2]
    B = np.broadcast_to(b, d.shape)[1, 2]
    C = np.broadcast_to(c, d.shape)[1, 2]
    M = np.diag(B) + np.diag(A[1:], -1) + np.diag(C[:-1], 1)
    close(got[1, 2], np.linalg.solve(M, d[1, 2]), rtol=1e-13)
    assert got.is_contiguous()


@pytest.mark.parametrize("axis", [0, 1])
def test_tridiagonal_solve_along_other_axes(axis):
    rng = np.random.default_rng(6)
    shape = (7, 5, 3)
    a, c, d = (rng.standard_normal(shape) for _ in range(3))
    b = 5.0 + rng.random(shape)
    got = tridiagonal_solve(*(torch.tensor(t) for t in (a, b, c, d)),
                            axis=axis)
    ref = j_tridiagonal_solve(*(jnp.asarray(t) for t in (a, b, c, d)),
                              axis=axis)
    close(got, ref)


@pytest.mark.parametrize("kappa", ["number", "profile", "full"])
def test_implicit_step_field_matches_jax(kappa):
    """Backward-Euler vertical diffusion of one field: the interior levels
    couple, the halo levels pass through, and ∫ q dz is conserved in every
    column (no flux through the walls)."""
    jg, tg = grids()
    q = random_fields(tg, "q")["q"]
    rng = np.random.default_rng(8)
    k = {"number": 0.3,
         "profile": rng.uniform(0.1, 1, (1, 1, tg.shape[2])),
         "full": rng.uniform(0.1, 1, tg.shape)}[kappa]
    dt = 0.05
    ref = jcl._implicit_step_field(jg, jnp.asarray(q), k, dt)
    got = tcl._implicit_step_field(tg, torch.tensor(q), k if np.isscalar(k)
                                   else torch.tensor(k),
                                   torch.tensor(dt, dtype=torch.float64))
    close(got, ref)
    sl = slice(tg.H[2], tg.H[2] + tg.N[2])
    np.testing.assert_allclose(got[:, :, sl].sum(-1).numpy(),
                               q[:, :, sl].sum(-1), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(got[:, :, :tg.H[2]].numpy(),
                                  q[:, :, :tg.H[2]])


@pytest.mark.parametrize("name", ["vertical_implicit", "convective"])
def test_implicit_vertical_diffusion_step_matches_jax(name):
    jc, tc = closure_pair(name)
    (jg, jin, jb), (tg, tin, tb) = closure_inputs()
    jd = jcl.compute_diffusivities(jc, jg, jin["u"], jin["v"], jin["w"],
                                   {"b": jin["b"]}, jb)
    td = tcl.compute_diffusivities(tc, tg, tin["u"], tin["v"], tin["w"],
                                   {"b": tin["b"]}, tb)
    ju, jv, jt = jcl.implicit_vertical_diffusion_step(
        jg, jc, jd, jnp.asarray(0.1), u=jin["u"], v=jin["v"],
        tracers={"b": jin["b"]})
    tu, tv, tt = tcl.implicit_vertical_diffusion_step(
        tg, tc, td, 0.1, u=tin["u"], v=tin["v"], tracers={"b": tin["b"]})
    for t, j in ((tu, ju), (tv, jv), (tt["b"], jt["b"])):
        close(t, j)
