"""oceananigans_torch's ocean closures (``closures_ocean.py``: CATKE, the
Ri-based diffusivity, k-ε, Leith, GM/Redi) against the JAX package, on the
CPU in float64.

The initial states are built in the port and handed to the JAX models
(``test_torch_forcings.jax_state_from``). The JAX reference runs eagerly
(but on the flat cube, where jitted JAX agrees with it within 1e-12): CATKE,
k-ε and the Ri-based closure switch on signs (Ri < 0, the convecting and
entraining branches, negative TKE), and jitted JAX's evaluation order can
flip a cell near a switch (ROADMAP caveats 5 and 9); eager JAX evaluates
each operation as the port does. Each closure's coefficients are held to
JAX's from one seeded state to 1e-12 of each coefficient's largest value;
then 2 model steps: CATKE, k-ε and the Ri-based closure in a column under
a destabilizing surface buoyancy flux, CATKE on a C8 cube (no top fluxes,
in both packages), GM/Redi and Leith on a small lat-lon grid, and
``examples/baroclinic_adjustment.py`` at a reduced size; the fields agree
to 1e-12 (``test_torch_closure_models.run_both``). Also here: the surface
flux values CATKE receives (ROADMAP caveat 8) and that a top flux with
field dependencies raises alike in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.buoyancy import regularize_buoyancy as tregularize
from oceananigans_torch.interop import grid_from_arguments
from oceananigans_tpu import closures_ocean as jco
from oceananigans_tpu.buoyancy import regularize_buoyancy as jregularize
from oceananigans_tpu.models import (
    HydrostaticFreeSurfaceModel as JHydrostatic,
    SplitExplicitFreeSurface as JSplit,
)
from test_torch_closure_models import F64, RTOL, grids, run_both
from test_torch_forcings import jax_state_from


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


#: each closure in both packages: (JAX, port)
CLOSURES = {
    "catke": lambda p: (jco.CATKEVerticalDiffusivity() if p is oj
                        else ot.CATKEVerticalDiffusivity()),
    "ri_based": lambda p: (jco.RiBasedVerticalDiffusivity() if p is oj
                           else ot.RiBasedVerticalDiffusivity()),
    "k_epsilon": lambda p: (jco.TKEDissipationVerticalDiffusivity()
                            if p is oj
                            else ot.TKEDissipationVerticalDiffusivity()),
    "leith": lambda p: (jco.LeithEnstrophyDiffusivity(C=2.0) if p is oj
                        else ot.LeithEnstrophyDiffusivity(C=2.0)),
    "gm_redi": lambda p: (jco.IsopycnalSkewSymmetricDiffusivity(
        kappa_redi=50.0, kappa_gm=30.0, maximum_slope=0.2) if p is oj
        else ot.IsopycnalSkewSymmetricDiffusivity(
            kappa_redi=50.0, kappa_gm=30.0, maximum_slope=0.2)),
}


def seeded_fields(grid, seed=0):
    """Seeded random u, v, w and an unstable-on-top b, e and eps (positive
    but for a few negative e cells), halo-extended numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = tuple(grid.shape)
    z = np.asarray(grid.zC, dtype=np.float64).reshape(1, 1, -1)
    out = {k: 0.1 * rng.standard_normal(shape) for k in ("u", "v", "w")}
    out["b"] = 0.05 * z + np.where(z > -0.25, -0.02 * z, 0.0) \
        + 1e-3 * rng.standard_normal(shape)
    out["e"] = 1e-4 * (rng.random(shape) - 0.02)
    out["eps"] = 1e-6 * (0.5 + rng.random(shape))
    return out


def assert_dicts_close(got, ref, where):
    for key, r in ref.items():
        r = np.asarray(r)
        g = got[key]
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        scale = max(np.abs(r).max(), 1e-300)
        assert np.abs(g - r).max() <= RTOL * scale, (where, key)


@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_closure_terms_match_jax(name):
    """Each closure's coefficients and explicit flux divergences, and the
    linear coefficients of the TKE equations, from one seeded state (CATKE
    with surface fluxes of u, v and b that convect the top cells)."""
    jg, tg = grids(size=(6, 5, 10), extent=(1.0, 1.0, 1.0),
                   topology=(oj.Periodic, oj.Periodic, oj.Bounded), halo=2)
    f = seeded_fields(tg)
    out = {}
    for pkg, grid in ((oj, jg), (ot, tg)):
        a = {k: (jnp.asarray(v) if pkg is oj else torch.tensor(v))
             for k, v in f.items()}
        closure = CLOSURES[name](pkg)
        buoyancy = (jregularize if pkg is oj else tregularize)(
            pkg.BuoyancyTracer())
        tracers = {"b": a["b"], "e": a["e"], "eps": a["eps"]}
        kw = {}
        if name == "catke":
            kw["top_fluxes"] = {"u": 1e-4, "v": a["u"][:, :, -1:] * 1e-3,
                                "b": 1e-7}
        d = closure.compute_diffusivities(grid, a["u"], a["v"], a["w"],
                                          tracers, buoyancy, **kw)
        du, dv, dw = closure.momentum_flux_divergences(
            grid, a["u"], a["v"], a["w"], tracers, d)
        terms = {k: v for k, v in d.items() if k != "b"}
        for q, t in (("du", du), ("dv", dv), ("dw", dw)):
            terms[q] = t + (0 * a["u"] if pkg is oj else torch.zeros_like(
                a["u"]))
        for n in tracers:
            terms[f"G{n}"] = closure.tracer_flux_divergence(
                grid, n, tracers[n], tracers, d) + (
                    0 * a["u"] if pkg is oj else torch.zeros_like(a["u"]))
            lin = getattr(closure, "implicit_linear_coefficient", None)
            if lin is not None and lin(grid, d, n) is not None:
                terms[f"L{n}"] = lin(grid, d, n)
        out[pkg] = terms
    assert out[ot].keys() == out[oj].keys()
    assert_dicts_close(out[ot], out[oj], name)


def column_pair(closure, Nz=16):
    """Both packages' column models (Flat, Flat, Bounded), 100 m deep, a
    BuoyancyTracer with a destabilizing surface flux of 1e-7 m² s⁻³."""
    kw = dict(size=(Nz,), z=(-100.0, 0.0),
              topology=(oj.Flat, oj.Flat, oj.Bounded))
    jg, tg = grids(**kw)

    def build(pkg, grid, **extra):
        return pkg.NonhydrostaticModel(
            grid=grid, advection=None, tracers=("b",),
            buoyancy=pkg.BuoyancyTracer(), closure=closure(pkg),
            boundary_conditions={"b": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(1e-7)), "u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(-2e-5))},
            timestepper="QuasiAdamsBashforth2", **extra)
    return build(oj, jg), build(ot, tg, fused_kernels=True)


@pytest.mark.parametrize("name", ["catke", "k_epsilon", "ri_based"])
def test_column_models_match_jax(name):
    """The vertically implicit closures in a surface-cooled column under a
    wind stress: 2 steps of 60 s (CATKE's convective lengths and surface
    TKE flux engage, k-ε's Patankar split, the Ri-based step)."""
    jm, tm = column_pair(CLOSURES[name])
    assert tm.tracer_names == jm.tracer_names
    init = dict(b=lambda x, y, z: 1e-5 * z, u=lambda x, y, z: 0.01 * z / 100)
    if "e" in jm.tracer_names:
        init["e"] = 1e-7
    if "eps" in jm.tracer_names:
        init["eps"] = 1e-10
    # w is the rounding residue of the hydrostatic balance: held relative
    # to Δt·max|∂z p| (``run_both(balanced=True)``)
    run_both(jm, tm, jax_state_from(jm, tm.initial_state(**init)), 60.0, 2,
             eager=True, balanced=True)


def test_catke_top_fluxes_and_field_dependent_raise():
    """CATKE receives the top flux values of u, v and b (ROADMAP caveat 8:
    the port evaluates them only for a closure that takes them, JAX every
    step); with a field-dependent top flux on u both packages raise the
    same ``ValueError``."""
    jm, tm = column_pair(CLOSURES["catke"])
    from oceananigans_torch.boundary_conditions import top_flux_values
    got = top_flux_values(tm.bcs, tm.grid, torch.tensor(0.0, dtype=F64))
    ref = jm._top_flux_values(jnp.asarray(0.0))
    assert sorted(got) == sorted(ref) == ["b", "u"]
    for k in got:
        assert float(got[k]) == float(ref[k])

    def build(pkg, grid, **extra):
        return pkg.NonhydrostaticModel(
            grid=grid, advection=None, tracers=("b",),
            buoyancy=pkg.BuoyancyTracer(), closure=CLOSURES["catke"](pkg),
            boundary_conditions={"u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(lambda x, y, t, u: -0.1 * u,
                               field_dependencies=("u",)))}, **extra)
    jg, tg = grids(size=(8,), z=(-100.0, 0.0),
                   topology=(oj.Flat, oj.Flat, oj.Bounded))
    jmodel, tmodel = build(oj, jg), build(ot, tg)
    messages = []
    for model in (jmodel, tmodel):
        with pytest.raises(ValueError, match="field-dependent") as err:
            s = model.initial_state(b=0.0)
            model.step(s, 1.0)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_catke_cubed_sphere_matches_jax():
    """CATKE on a C8 cube with 3 levels, seawater buoyancy, the
    split-explicit free surface and the wind and heat fluxes of
    ``examples/global_ocean.py``: both packages give CATKE no top fluxes
    (the cube models do not pass them), 2 steps. Without the example's
    continents: over their mirrored solid cells CATKE's sign switches flip
    between jitted and eager JAX, far past 1e-12 in u after one step; on
    the flat cube the two agree within 1e-12, so the quicker jitted step
    serves."""
    import jax
    from oceananigans_tpu.boundary_conditions import (
        FieldBoundaryConditions as JFBC, FluxBC as JFlux,
    )
    from oceananigans_tpu.grids.cubed_sphere_grid import (
        ConformalCubedSphereGrid as JCube,
    )
    from oceananigans_tpu.models.cubed_sphere import (
        CubedSphereHydrostaticModel as JCubeModel,
    )
    from test_torch_cubed_sphere_hydrostatic import T_init, assert_close
    kw = dict(panel_size=(8, 3), z=(-1000.0, 0.0), radius=6.37122e6, halo=3,
              dtype="float64")
    jg, tg = JCube(**kw), grid_from_arguments("cubed_sphere", **kw)

    def build(pkg, grid, xp):
        lib = oj if pkg == "j" else ot
        FBC = JFBC if pkg == "j" else ot.FieldBoundaryConditions
        Flux = JFlux if pkg == "j" else ot.FluxBC
        cls = JCubeModel if pkg == "j" else ot.CubedSphereHydrostaticModel
        return cls(
            grid, buoyancy=lib.SeawaterBuoyancy(),
            closure=CLOSURES["catke"](oj if pkg == "j" else ot),
            free_surface=(JSplit if pkg == "j"
                          else ot.SplitExplicitFreeSurface)(substeps=10),
            boundary_conditions={
                "u": FBC(top=Flux(lambda lam, phi, t: -1e-4 * xp.sin(
                    xp.deg2rad(2 * phi)))),
                "T": FBC(top=Flux(lambda lam, phi, t: 1e-5 * xp.cos(
                    xp.deg2rad(phi))))}, tracers=())

    jm, tm = build("j", jg, jnp), build("t", tg, torch)
    assert tm.tracer_names == jm.tracer_names
    init = dict(T=T_init, S=35.0, e=1e-6)
    js, ts = jm.initial_state(**init), tm.initial_state(**init)
    step = jax.jit(lambda s: jm.step(s, 600.0))
    for _ in range(2):
        js, ts = step(js), tm.step(ts, 600.0)
    for names in (("u", "v"), ("eta",), ("U", "V")):
        assert_close([(getattr(ts, n), getattr(js, n)) for n in names],
                     names)
    for n in tm.tracer_names:
        assert_close([(ts.tracers[n], js.tracers[n])], n)


def latlon_pair(closure, tracers=("T", "S"), **extra_kw):
    kw = dict(size=(10, 8, 4), longitude=(0.0, 40.0), latitude=(20.0, 50.0),
              z=(-1000.0, 0.0), halo=3)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)

    def build(pkg, grid, **extra):
        hyd = oj.models if pkg is oj else ot
        return hyd.HydrostaticFreeSurfaceModel(
            grid=grid, tracers=tracers,
            buoyancy=pkg.SeawaterBuoyancy(
                equation_of_state=pkg.LinearEquationOfState()),
            coriolis=pkg.HydrostaticSphericalCoriolis(),
            tracer_advection=pkg.WENO(5),
            free_surface=hyd.SplitExplicitFreeSurface(substeps=10),
            closure=closure(pkg), **extra_kw, **extra)
    return build(oj, jg), build(ot, tg, fused_kernels=True)


@pytest.mark.parametrize("name", ["gm_redi", "leith"])
def test_latlon_closures_match_jax(name):
    """GM/Redi and Leith in the hydrostatic model on a 10 x 8 x 4 lat-lon
    sector with sloping isopycnals and a sheared flow, 2 steps of 600 s."""
    jm, tm = latlon_pair(CLOSURES[name])
    js = jax_state_from(jm, tm.initial_state(
        u=lambda lam, phi, z: 0.1 * torch.sin(torch.deg2rad(9 * lam))
        * torch.cos(torch.deg2rad(6 * phi)) + 0 * z,
        T=lambda lam, phi, z: 10.0 + 5e-3 * z - 0.1 * phi
        + 0.05 * torch.sin(torch.deg2rad(9 * lam)),
        S=lambda lam, phi, z: 35.0 + 0.01 * phi + 0 * z + 0 * lam))
    run_both(jm, tm, js, 600.0, 2, eager=True)


def test_baroclinic_adjustment_example_matches_jax():
    """``examples/baroclinic_adjustment.py`` at 10 x 8 x 4: its lat-lon
    front, VectorInvariant momentum, WENO(5) buoyancy, spherical Coriolis,
    CATKE and the split-explicit free surface, with a destabilizing b
    surface flux added (so CATKE's convective lengths engage, as
    ``chip_smoke.py`` phase 22 runs it), 2 steps of 600 s."""
    kw = dict(size=(10, 8, 4), longitude=(-10.0, 10.0),
              latitude=(30.0, 50.0), z=(-1000.0, 0.0), halo=3)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)
    from oceananigans_torch.profile_step import baroclinic_adjustment_model
    tm = baroclinic_adjustment_model(grid=tg, fused=True)
    jm = JHydrostatic(
        grid=jg, tracers=("b",), buoyancy=oj.BuoyancyTracer(),
        coriolis=oj.HydrostaticSphericalCoriolis(),
        momentum_advection=oj.models.VectorInvariant(),
        tracer_advection=oj.WENO(5),
        closure=jco.CATKEVerticalDiffusivity(),
        free_surface=JSplit(substeps=30),
        boundary_conditions={"b": oj.FieldBoundaryConditions(
            top=oj.FluxBC(1e-8))})
    from oceananigans_torch.profile_step import (
        baroclinic_adjustment_initial_state,
    )
    js = jax_state_from(jm, baroclinic_adjustment_initial_state(tm))
    run_both(jm, tm, js, 600.0, 2, eager=True)
