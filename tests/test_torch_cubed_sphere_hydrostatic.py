"""oceananigans_torch's cubed-sphere hydrostatic model against the JAX
package's, on the CPU in float64 at C8 with 3 or 4 levels, 3 steps each
(the global ocean 2): the explicit free surface under RK3 (from a seeded
state carried across with ``state_from_numpy``), the split-explicit one,
quasi-AB2 with momentum and tracer forcings and the corner filter,
``test_cs_global_ocean_configuration``'s ocean at C8×4 (continents,
seawater buoyancy, convective adjustment, wind and heat fluxes),
``WENOVectorInvariant(order=3)`` in a halo of 3 with a horizontal and a
vertically implicit closure over the bathymetry (whose diffusive fluxes
vanish through the bottom and coasts), prescribed velocities with WENO(5)
tracers over an array bathymetry, and a ``Simulation`` run; and the
``NotImplementedError`` of what is not ported, naming its ROADMAP item.

Each group of fields (u and v, U and V, η, each tracer) is held within
1e-12 of the group's largest value. The JAX references of the WENO
tracer case and of the global ocean step eagerly: under ``jax.jit``
XLA's evaluation order moves the WENO weights, and the convective
adjustment's switch on the sign of N², past 1e-12; their Thomas solves
run jitted (``test_torch_closure_models.jitted_thomas``: the eager
solve's bits). The explicit RK3 and the quasi-AB2 cases step eagerly too,
on the global ocean's 4 levels: the eager operations it compiled serve
them, which is quicker than compiling their steps. The JAX runs are
shared through a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import (
    grid_from_arguments, state_from_numpy, state_to_numpy,
)
from oceananigans_torch.models import cubed_sphere as tcs
from oceananigans_tpu import closures as jclosures
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFieldBCs,
)
from oceananigans_tpu.boundary_conditions import FluxBC as JFluxBC
from oceananigans_tpu.grids import cubed_sphere_grid as jcg
from oceananigans_tpu.models import cubed_sphere as jcs
from oceananigans_tpu.models import hydrostatic as jhyd
from test_torch_closure_models import jitted_thomas

RTOL = 1e-12
A = 6.37122e6


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


def grids(Nz=3, depth=1000.0, halo=3, N=8):
    kw = dict(panel_size=(N, Nz), z=(-depth, 0.0), radius=A, halo=halo,
              dtype="float64")
    return jcg.ConformalCubedSphereGrid(**kw), grid_from_arguments(
        "cubed_sphere", **kw)


def two_continents(lam, phi):
    """1000 m ocean with polar land caps and a mid-latitude ridge."""
    land = np.abs(phi) > 65.0
    ridge = 600.0 * np.exp(-((lam - 30.0) ** 2 + phi ** 2) / 400.0)
    return np.where(land, 100.0, -1000.0 + ridge)


def bump(grid):
    """A Gaussian η bump (0.5 m) at 30°E on the equator, (6, nx, ny, 1)."""
    g = grid.panel_grid
    H = g.H[0] if hasattr(g, "H") else g.Hx
    N = grid.N_panel
    e = np.zeros((6, g.shape[0], g.shape[1], 1))
    e[:, H:H + N, H:H + N, 0] = 0.5 * np.exp(
        -((grid.lam_cc - 30.0) ** 2 + grid.phi_cc ** 2) / 400.0)
    return e


def b_init(lam, phi, z):
    return 1e-5 * z + 1e-4 * np.cos(np.deg2rad(lam)) * np.cos(
        np.deg2rad(phi))


def T_init(lam, phi, z):
    return 15.0 + 10.0 * np.cos(np.deg2rad(phi)) * np.exp(z / 500.0)


def configs(pkg):
    """Each case's (model keywords, grid keywords, initial fields, Δt),
    for the JAX package (``pkg == "j"``) or the port."""
    j = pkg == "j"
    lib = oj if j else ot
    xp = jnp if j else torch
    FBC = JFieldBCs if j else ot.FieldBoundaryConditions
    Flux = JFluxBC if j else ot.FluxBC
    hyd = jhyd if j else ot
    clos = jclosures if j else ot
    bathy = np.full((6, 8, 8), -800.0)
    bathy[:, :2, :3] = 50.0          # a coast on every panel
    return {
        "explicit_rk3": (dict(), dict(Nz=4), dict(b=b_init), 600.0),
        "split_rk3": (dict(free_surface=hyd.SplitExplicitFreeSurface(
            substeps=8)), dict(), dict(b=b_init), 600.0),
        "ab2_forcing_filter": (dict(
            timestepper="QuasiAdamsBashforth2", corner_filter=0.005,
            forcing={"u": lambda lam, phi, z, t:
                     1e-6 * xp.cos(xp.deg2rad(phi)) + 0 * z,
                     "b": lambda lam, phi, z, t:
                     1e-10 * xp.sin(xp.deg2rad(lam)) + 0 * z}),
            dict(Nz=4), dict(b=b_init), 600.0),
        "global_ocean": (dict(
            bathymetry=two_continents, buoyancy=lib.SeawaterBuoyancy(),
            closure=clos.ConvectiveAdjustmentVerticalDiffusivity(
                convective_kappa_z=0.1, background_kappa_z=1e-5),
            free_surface=hyd.SplitExplicitFreeSurface(substeps=10),
            boundary_conditions={
                "u": FBC(top=Flux(lambda lam, phi, t:
                                  -1e-4 * xp.sin(xp.deg2rad(2 * phi)))),
                "T": FBC(top=Flux(lambda lam, phi, t:
                                  1e-5 * xp.cos(xp.deg2rad(phi))))},
            tracers=()), dict(Nz=4), dict(T=T_init, S=35.0), 600.0),
        "weno_vi_closures": (dict(
            momentum_advection=hyd.WENOVectorInvariant(order=3),
            bathymetry=two_continents,
            closure=(clos.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                     clos.VerticalScalarDiffusivity(
                         nu=1e-3, kappa=1e-5, time_discretization=clos
                         .VerticallyImplicitTimeDiscretization))),
            dict(), dict(b=b_init), 600.0),
        "prescribed_weno_tracer": (dict(
            prescribed_velocities=True, tracers=("c",), buoyancy=None,
            tracer_advection=lib.WENO(5), bathymetry=bathy), dict(Nz=4),
            dict(c=lambda lam, phi, z: np.exp(
                -((lam - 30.0) ** 2 + phi ** 2) / 800.0) + 0 * z), 600.0),
    }


CASES = ("explicit_rk3", "split_rk3", "ab2_forcing_filter", "global_ocean",
         "weno_vi_closures", "prescribed_weno_tracer")
#: the cases whose JAX reference steps eagerly, in this order: jitted
#: JAX's evaluation order moves WENO tracers and the convective
#: adjustment's N² < 0 switch by more than 1e-12; the explicit RK3 and
#: quasi-AB2 cases, on the global ocean's grid shape, step quicker eagerly
#: than their steps compile
EAGER = ("global_ocean", "explicit_rk3", "ab2_forcing_filter",
         "prescribed_weno_tracer")
#: steps of each case (the eager global ocean takes ~3 s a JAX step)
STEPS = {case: 2 if case == "global_ocean" else 3 for case in CASES}


def seeded_velocities(grid, seed):
    """Seeded random interior u, v (≈ 1 cm/s), numpy."""
    rng = np.random.default_rng(seed)
    g = grid.panel_grid
    H, N = g.H[0], grid.N_panel
    u = np.zeros((6, *g.shape))
    v = np.zeros((6, *g.shape))
    sz = slice(g.H[2], g.H[2] + g.N[2])
    u[:, H:H + N + 1, H:H + N, sz] = 1e-2 * rng.standard_normal(
        (6, N + 1, N, g.N[2]))
    v[:, H:H + N, H:H + N + 1, sz] = 1e-2 * rng.standard_normal(
        (6, N, N + 1, g.N[2]))
    return u, v


def build(case):
    """Both packages' models and initial states of ``case``."""
    out = {}
    for pkg in ("j", "t"):
        model_kw, grid_kw, init, dt = configs(pkg)[case]
        jg, tg = grids(**grid_kw)
        grid = jg if pkg == "j" else tg
        cls = (jcs if pkg == "j" else ot).CubedSphereHydrostaticModel
        model = cls(grid, **model_kw)
        kw = dict(init)
        if case in ("explicit_rk3", "split_rk3", "weno_vi_closures"):
            kw["eta"] = bump(grid)
        if case == "prescribed_weno_tracer":
            u, v = seeded_velocities(tg, 7)
            kw.update(u=0.1 * u / 1e-2, v=0.1 * v / 1e-2)
        out[pkg] = (model, model.initial_state(**kw), dt)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every case, :data:`STEPS` in both packages, from equal initial states
    (the explicit RK3 case from a seeded state handed to the port with
    ``state_from_numpy``)."""
    out = {}
    for case in EAGER + tuple(c for c in CASES if c not in EAGER):
        b = build(case)
        (mj, sj, dt), (mt, st, _) = b["j"], b["t"]
        if case == "explicit_rk3":
            u, v = seeded_velocities(mt.grid, 3)
            sj = mj.fill_state_halos(dataclasses.replace(
                sj, u=sj.u + u, v=sj.v + v))
            arrays = state_to_numpy(st)
            arrays["u"] = arrays["u"] + u
            arrays["v"] = arrays["v"] + v
            st = mt.fill_state_halos(state_from_numpy(mt, arrays))
        st0 = st
        if case in EAGER:
            with jitted_thomas():
                for _ in range(STEPS[case]):
                    sj = mj.step(sj, dt)
        else:
            step = jax.jit(lambda s, m=mj, d=dt: m.step(s, d))
            for _ in range(STEPS[case]):
                sj = step(sj)
        for _ in range(STEPS[case]):
            st = mt.step(st, dt)
        out[case] = (mj, mt, sj, st, st0, dt)
    return out


def assert_close(pairs, name):
    """max|port − JAX| over a group of fields (the two components of a
    vector, or one scalar field) within 1e-12 of the group's largest
    value."""
    gap = scale = 0.0
    for got, ref in pairs:
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        ref = np.asarray(ref)
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        scale = max(scale, float(np.abs(ref).max()))
        gap = max(gap, float(np.abs(got - ref).max()))
    assert gap <= RTOL * max(scale, 1e-300), (name, gap, scale)


#: the groups compared: velocities, transports, η and previous tendencies
GROUPS = {"velocities": ("u", "v"), "eta": ("eta",), "transports": ("U", "V"),
          "Gvelocities": ("Gu", "Gv"), "Geta": ("Geta",)}


@pytest.mark.parametrize("case", CASES)
def test_matches_jax(runs, case):
    mj, mt, sj, st, st0, dt = runs[case]
    ab2 = mt.timestepper == "QuasiAdamsBashforth2"
    for group, names in GROUPS.items():
        if group.startswith("G") and not ab2:
            continue
        assert_close([(getattr(st, n), getattr(sj, n)) for n in names],
                     group)
    assert set(st.tracers) == set(sj.tracers)
    for name in sj.tracers:
        assert_close([(st.tracers[name], sj.tracers[name])], name)
    assert st.clock.iteration == STEPS[case]
    assert all(bool(torch.isfinite(q).all())
               for q in (st.u, st.v, st.eta, *st.tracers.values()))


@pytest.mark.parametrize("case", CASES)
def test_budgets_match_jax(runs, case):
    """Volume, tracer content and the CFL timescale agree with the JAX
    model's; the volume holds to 1e-12 of the ocean's."""
    mj, mt, sj, st, st0, dt = runs[case]
    scale = float(mt.ocean_volume())
    assert abs(scale - float(mj.ocean_volume())) <= 1e-13 * scale
    assert abs(float(mt.total_volume(st))
               - float(mt.total_volume(st0))) <= 1e-12 * scale
    assert abs(float(mt.total_volume(st))
               - float(mj.total_volume(sj))) <= 1e-12 * scale
    for name in st.tracers:
        ref = float(mj.total_tracer(sj, name))
        assert abs(float(mt.total_tracer(st, name)) - ref) \
            <= 1e-12 * max(abs(ref), 1e-300)
    tau_j = float(mj.cfl_timescale(sj))
    assert abs(float(mt.cfl_timescale(st)) - tau_j) <= 1e-12 * tau_j


def test_global_ocean_budgets(runs):
    """test_cs_global_ocean_configuration's checks on the port: the wind
    did work, salt is conserved, the masks and depths are the JAX
    model's."""
    mj, mt, sj, st, st0, dt = runs["global_ocean"]
    assert float(st.u.abs().max()) > 1e-6
    S0 = 35.0 * float(mt.ocean_volume())
    assert abs(float(mt.total_tracer(st, "S")) - S0) < 1e-9 * abs(S0)
    for name in ("_wet_c", "_wet_u", "_wet_v", "_wet_w", "_Hc", "_Hu",
                 "_Hv", "_bot_c", "_bot_u", "_top_c"):
        assert np.array_equal(getattr(mt, name),
                              np.asarray(getattr(mj, name))), name


def test_closure_fluxes_masked_by_bathymetry(runs):
    """The closures see the bathymetry: through the solid view their
    diffusive fluxes vanish at solid faces (the masked tendency differs
    from the all-wet one, and ``test_matches_jax`` holds it to JAX's)."""
    from oceananigans_torch.models.cubed_sphere import _PanelSolidView
    mj, mt, sj, st, st0, dt = runs["weno_vi_closures"]
    g = mt.grid.panel_grid
    w = torch.zeros_like(st.u)
    diff = ot.closures.compute_diffusivities(mt.closure, g, st.u, st.v, w,
                                             st.tracers, mt.buoyancy)

    def div(grid):
        return ot.closures.tracer_flux_divergence(
            mt.closure, grid, "b", st.tracers["b"], st.tracers, diff,
            include_implicit=False)

    solid = mt._dev("_wet_c", st.u.dtype) < 0.5
    masked, open_ = div(_PanelSolidView(g, solid)), div(g)
    assert not torch.equal(masked, open_)
    # away from solid cells the two agree
    near = solid.clone()
    for axis in (-3, -2, -1):
        for n in (1, -1):
            near |= torch.roll(solid, n, axis)
    assert torch.equal(masked[~near], open_[~near])


def test_weno_vi_requires_halo():
    _, tg = grids()
    with pytest.raises(ValueError, match="halo"):
        ot.CubedSphereHydrostaticModel(
            tg, momentum_advection=ot.WENOVectorInvariant(order=5),
            tracers=(), buoyancy=None)


def test_simulation_matches_jax(runs):
    """``Simulation`` (a window of steps that skip their leading fill, a
    progress callback and the NaN checker) reaches the JAX split-explicit
    run's state."""
    mj, mt, sj, st, st0, dt = runs["split_rk3"]
    n = STEPS["split_rk3"]
    sim = ot.Simulation(mt, state=st0, dt=dt, stop_iteration=n)
    seen = []
    sim.callbacks["progress"] = ot.Callback(
        lambda s: seen.append(int(s.state.clock.iteration)),
        ot.IterationInterval(1))
    sim.run()
    assert sim.state.clock.iteration == n and seen[-1] == n
    for group in ("velocities", "eta", "transports"):
        assert_close([(getattr(sim.state, n), getattr(sj, n))
                      for n in GROUPS[group]], group)
    wizard = ot.TimeStepWizard(cfl=0.3, max_change=1.1, max_dt=900.0)
    wizard(sim)
    assert 0 < sim.dt <= 900.0


@pytest.mark.parametrize("what", ["ImplicitFreeSurface", "ZStar", "CATKE",
                                  "GridFittedBottom", "GridFittedBoundary",
                                  "PartialCellBottom",
                                  "cubed_sphere_partition"])
def test_not_ported_raises_with_its_item(what):
    """What is not ported raises, naming its ROADMAP item; the
    bathymetry objects ``GridFittedBottom``, ``GridFittedBoundary`` and
    ``PartialCellBottom``, once refused, build the masks of the bottom they
    describe; CATKE, once refused, builds with its TKE tracer (an object
    that is no closure raises a ``TypeError``); the implicit free surface
    and ``ZStar``, once refused, build where the JAX cube takes them and
    raise its ``ValueError`` elsewhere."""
    _, tg = grids()
    if what == "CATKE":
        m = ot.CubedSphereHydrostaticModel(
            tg, closure=ot.CATKEVerticalDiffusivity())
        assert "e" in m.tracer_names
        with pytest.raises(TypeError, match="AbstractClosure"):
            ot.CubedSphereHydrostaticModel(tg, closure=object())
        return
    if what in ("GridFittedBottom", "GridFittedBoundary",
                "PartialCellBottom"):
        arg = ((lambda lam, phi, z: z < two_continents(lam, phi))
               if what == "GridFittedBoundary" else two_continents)
        m = ot.CubedSphereHydrostaticModel(tg, bathymetry=getattr(ot, what)(
            arg))
        bare = ot.CubedSphereHydrostaticModel(tg, bathymetry=two_continents)
        g = tg.panel_grid
        kz = slice(g.H[2], g.H[2] + g.N[2])
        if what != "PartialCellBottom":
            np.testing.assert_array_equal(m._wet_c[..., kz],
                                          bare._wet_c[..., kz])
        else:
            # partial cells keep every cell with 0.2 of it above the bottom
            assert (m._wet_c >= bare._wet_c).all()
            assert 0.2 <= m._frac_c.min() < 1.0
        return
    if what == "ImplicitFreeSurface":
        # ported (item 15): CG across the panels builds, the spectral and
        # matrix methods raise JAX's ValueError
        m = ot.CubedSphereHydrostaticModel(
            tg, free_surface=ot.ImplicitFreeSurface(solver_method="cg"))
        assert not m._explicit_eta_grad
        with pytest.raises(ValueError, match="solver_method='cg'"):
            ot.CubedSphereHydrostaticModel(
                tg, free_surface=ot.ImplicitFreeSurface())
        return
    if what == "ZStar":
        # ported (item 15): builds under quasi-AB2, JAX's ValueError with RK3
        m = ot.CubedSphereHydrostaticModel(
            tg, vertical_coordinate=ot.ZStar(),
            timestepper="QuasiAdamsBashforth2")
        assert m.zstar
        with pytest.raises(ValueError, match="QuasiAdamsBashforth2"):
            ot.CubedSphereHydrostaticModel(tg, vertical_coordinate=ot.ZStar())
        return
    # ported (item 18): the rank layout and the slab of a stacked state;
    # one process holds a one-rank layout, and six panels need six ranks
    with pytest.raises(ValueError, match="needs 6 ranks"):
        tcs.cubed_sphere_partition(R=1)
    layout, shard = tcs.cubed_sphere_partition(R=1, panels=1)
    assert layout["coords"] == (0, 0, 0)
    st = ot.CubedSphereHydrostaticModel(tg).initial_state()
    assert shard(st).u.shape == st.u.shape
    # a bathymetry object that is neither callable nor an array
    with pytest.raises(ValueError, match="bathymetry"):
        ot.CubedSphereHydrostaticModel(tg, bathymetry=object())
