"""oceananigans_torch's stretched grids and their solvers against the JAX
package, on the CPU in float64.

The coordinates, regularity flags and coefficient tables of a stretched
axis are the JAX package's bit for bit (the same numpy arithmetic); the
advection operators bound to them too. The Fourier-tridiagonal solver
agrees with the JAX solver to 1e-12 of the largest value (it takes a real
FFT on the first periodic axis and its own order of summation), and with
the FFT solver on a regular z; its one-solve-for-both-parts Thomas sweep
equals two real solves bit for bit. The stretched-z LES of the JAX
package's ``examples/wind_mixing_and_convection.py`` and the tilted-bottom
configuration of ``examples/tilted_bottom_boundary_layer.py`` (without its
background fields, ROADMAP Queue 1 item 12) step for 3 steps within 1e-12
of each field's largest value (the velocities of the stratified LES
relative to the projection's Δt·max|∂z p|, as in
``test_torch_closure_models.py``). The kernel gates refuse a stretched
grid where the JAX gates do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.grids.base import generate_coordinate as t_coord
from oceananigans_torch.ops import reconstruction_coefficients as t_rc
from oceananigans_torch.solvers.fourier_tridiagonal import thomas_solve_
from oceananigans_torch.solvers.tridiagonal import tridiagonal_solve
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.grids.base import generate_coordinate as j_coord
from oceananigans_tpu.ops import reconstruction_coefficients as j_rc
from oceananigans_tpu.solvers.fourier_tridiagonal import (
    FourierTridiagonalPoissonSolver as JFT,
)

from test_torch_closure_models import QT, run_both

F64 = torch.float64
PPB = ("periodic", "periodic", "bounded")


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


def wind_mixing_z(Nz, Lz=32.0):
    """``examples/wind_mixing_and_convection.py``'s faces, finer at the
    surface."""
    return lambda k: -Lz * (1 - k / Nz) ** 1.2


def tilted_z(Nz, Lz=100.0, refinement=1.8, stretching=10.0):
    """``examples/tilted_bottom_boundary_layer.py``'s faces, finer at the
    bottom."""
    def z_faces(k):
        h = (Nz - k) / Nz
        zeta = 1 + (h - 1) / refinement
        sig = (1 - np.exp(-stretching * h)) / (1 - np.exp(-stretching))
        return -Lz * (zeta * sig - 1)
    return z_faces


def both_grids(**kw):
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


# ---------------------------------------------------------------------------
# Coordinates and grids
# ---------------------------------------------------------------------------

SPECS = {
    "callable": wind_mixing_z(10),
    "array": np.cumsum(np.r_[0.0, np.linspace(1.0, 2.0, 10)]),
    "uniform-array": np.linspace(-1.0, 1.0, 11),
    "pair": (-3.0, 2.0),
}


@pytest.mark.parametrize("topo", ["periodic", "bounded"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_generate_coordinate_matches_jax(spec, topo):
    """Faces, centres, spacings, the regular flag (``np.allclose`` of the
    spacings: uniform faces given as an array count as regular) and the
    extent, bit for bit."""
    t = t_coord(SPECS[spec], 10, 3, topo)
    j = j_coord(SPECS[spec], 10, 3, topo, np.float64)
    for a, b in zip(t[:4], j[:4]):
        np.testing.assert_array_equal(a, b)
    assert t[4] == j[4] == (spec in ("uniform-array", "pair"))
    assert t[5] == j[5]


def test_stretched_grids_match_jax():
    """A rectilinear grid stretched on every axis, a lat-lon grid and a
    tripolar grid with a stretched z: the flags and every coordinate and
    spacing buffer."""
    kw = dict(size=(6, 5, 8), x=np.linspace(0, 1, 7) ** 1.3,
              y=lambda j: 2.0 * j + 0.1 * j ** 2, z=wind_mixing_z(8),
              topology=("periodic", "bounded", "bounded"), halo=3)
    jg, tg = both_grids(**kw)
    assert (tg.x_regular, tg.y_regular, tg.z_regular) == (
        jg.x_regular, jg.y_regular, jg.z_regular) == (False, False, False)
    for t_name, j_name in (("xF", "xF"), ("xC", "xC"), ("xC_d", "dxC_"),
                           ("yF_d", "dyF_"), ("zF", "zF"),
                           ("zC_d", "dzC_"), ("zF_d", "dzF_")):
        np.testing.assert_array_equal(getattr(tg, t_name).numpy(),
                                      np.asarray(getattr(jg, j_name)))
    kl = dict(size=(8, 6, 8), longitude=(0.0, 360.0), latitude=(-60, 60),
              z=wind_mixing_z(8, 4000.0), halo=3)
    tl = ot.LatitudeLongitudeGrid(dtype=F64, **kl)
    jl = oj.LatitudeLongitudeGrid(dtype="float64", **kl)
    kt = dict(size=(8, 7, 8), z=wind_mixing_z(8, 4000.0), halo=3)
    tt = ot.TripolarGrid(dtype=F64, **kt)
    jt = oj.TripolarGrid(dtype="float64", **kt)
    for t, j in ((tl, jl), (tt, jt)):
        assert (t.x_regular, t.z_regular) == (j.x_regular, j.z_regular)
        assert not t.z_regular
        for name in ("zF", "zC", "dzC_", "dzF_"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))


# ---------------------------------------------------------------------------
# Coefficient tables and the bound schemes
# ---------------------------------------------------------------------------

def sine_faces(N):
    """``tests/test_stretched_reconstruction.py``'s smoothly stretched
    faces."""
    r = np.linspace(0, 1, N + 1)
    return r + 0.15 * np.sin(2 * np.pi * r) / (2 * np.pi)


@pytest.mark.parametrize("N", [32, 64])
def test_stretched_tables_match_jax(N):
    """The tables of ``tests/test_stretched_reconstruction.py``'s grids
    (and of its Chebyshev z): every Centered and UpwindBiased stencil and
    every WENO order's sub-stencils and ideal weights, both sides, bit for
    bit."""
    edges = np.append(sine_faces(N), 1.0 + sine_faces(N)[1:4])
    cheb = -np.cos(np.linspace(0, np.pi, 9)) * 0.5 - 0.5
    for e in (edges, cheb):
        for offs in ([-1, 0], [-2, -1, 0, 1], [-3, -2, -1], [-1, 0, 1]):
            if len(offs) >= len(e) - 2:
                continue
            a = t_rc.stretched_reconstruction_tables(e, offs)
            b = j_rc.stretched_reconstruction_tables(e, offs)
            for k in offs:
                np.testing.assert_array_equal(a[k], b[k])
    for order in (3, 5, 7, 9, 11):
        for side in ("left", "right"):
            a = t_rc.weno_stretched_tables(edges, order, side)
            b = j_rc.weno_stretched_tables(edges, order, side)
            np.testing.assert_array_equal(a[1], b[1])
            for ta, tb in zip(a[0], b[0]):
                for k in ta:
                    np.testing.assert_array_equal(ta[k], tb[k])


def scheme_pair(name):
    def make(pkg):
        return {"Centered(2)": lambda: pkg.Centered(2),
                "Centered(4)": lambda: pkg.Centered(4),
                "UpwindBiased(1)": lambda: pkg.UpwindBiased(1),
                "UpwindBiased(5)": lambda: pkg.UpwindBiased(5),
                "WENO(3)": lambda: pkg.WENO(3),
                "WENO(5)": lambda: pkg.WENO(5),
                "WENO(7)": lambda: pkg.WENO(7),
                "WENO(9)": lambda: pkg.WENO(9),
                "FluxForm": lambda: pkg.FluxFormAdvection(
                    pkg.WENO(5), pkg.Centered(4), pkg.UpwindBiased(3)),
                }[name]()
    return make(ot), make(oj)


@pytest.mark.parametrize("name", ["Centered(2)", "Centered(4)",
                                  "UpwindBiased(1)", "UpwindBiased(5)",
                                  "WENO(3)", "WENO(5)", "WENO(7)", "WENO(9)",
                                  "FluxForm"])
def test_bound_schemes_match_jax(name):
    """Each scheme bound to a grid stretched on every axis: the tracer
    and the three momentum flux divergences, bit for bit (the tables are
    applied in the JAX package's order), on random fields with exact zero
    rows of the velocities."""
    kw = dict(size=(10, 9, 12), x=np.linspace(0, 1, 11) ** 1.3,
              y=lambda j: 2.0 * j + 0.1 * j ** 2, z=wind_mixing_z(12),
              topology=("periodic", "bounded", "bounded"), halo=5)
    jg, tg = both_grids(**kw)
    ts, js = scheme_pair(name)
    ts, js = t_adv.bind_grid(ts, tg), js.bind_grid(jg)
    rng = np.random.default_rng(1)
    u, v, w, c = (rng.standard_normal(tg.shape) for _ in range(4))
    u[:, 3] = v[4] = w[..., 5] = 0.0
    targs = [torch.tensor(a) for a in (u, v, w, c)]
    jargs = [jnp.asarray(a) for a in (u, v, w, c)]
    ii = tg.interior_slices
    pairs = [(t_adv.div_Uc(tg, ts, *targs), j_adv.div_Uc(jg, js, *jargs))]
    for fn in ("div_vu", "div_vv", "div_vw"):
        pairs.append((getattr(t_adv, fn)(tg, ts, *targs[:3]),
                      getattr(j_adv, fn)(jg, js, *jargs[:3])))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy()[ii], np.asarray(b)[ii])


def test_tables_bind_at_model_build():
    """A model on a stretched z takes the tables (both targets of the z
    axis), a regular grid keeps the scheme itself; the hydrostatic model
    binds its tracer scheme only, as the JAX model does."""
    tg = ot.RectilinearGrid(size=(8, 8), x=(0, 1), topology=(
        ot.Periodic, ot.Flat, ot.Bounded), halo=3,
        z=-np.cos(np.linspace(0, np.pi, 9)) * 0.5 - 0.5, dtype=F64)
    scheme = ot.Centered(4)
    reg = ot.RectilinearGrid(size=(8,), x=(0, 1), halo=3, dtype=F64,
                             topology=(ot.Periodic, ot.Flat, ot.Flat))
    assert t_adv.bind_grid(scheme, reg) is scheme
    model = ot.NonhydrostaticModel(grid=tg, advection=scheme)
    assert sorted(model.advection._tables) == [(2, 0), (2, 1)]
    hg = ot.RectilinearGrid(size=(8, 8, 6), x=(0.0, 1e5), y=(0.0, 1e5),
                            z=wind_mixing_z(6, 1e3), halo=3, dtype=F64)
    hm = ot.HydrostaticFreeSurfaceModel(
        grid=hg, momentum_advection=ot.WENO(5), tracer_advection=ot.WENO(5),
        tracers=("T",))
    assert hm.tracer_advection._tables
    assert getattr(hm.momentum_advection, "_tables", None) is None


# ---------------------------------------------------------------------------
# The Fourier-tridiagonal solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", [PPB, ("bounded", "periodic", "bounded"),
                                      ("bounded", "bounded", "bounded"),
                                      ("periodic", "flat", "bounded")],
                         ids=["ppb", "bpb", "bbb", "pfb"])
def test_fourier_tridiagonal_matches_jax(topology):
    """On a stretched z, to 1e-12 of the largest value of the JAX solve
    (rounding: a real FFT here, two real systems there); on a regular z,
    to 1e-12 of the FFT solver's."""
    flat = topology[1] == "flat"
    size = (8, 12) if flat else (8, 6, 12)
    kw = dict(size=size, x=(0.0, 1.0), z=tilted_z(12), topology=topology)
    if not flat:
        kw["y"] = (0.0, 2.0)
    jg, tg = both_grids(**kw)
    rhs = np.random.default_rng(0).standard_normal(tg.N)
    got = ot.FourierTridiagonalPoissonSolver(tg).solve(torch.tensor(rhs))
    ref = np.asarray(JFT(jg).solve(jnp.asarray(rhs)))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    kw["z"] = (-1.0, 0.0)
    reg = ot.RectilinearGrid(dtype=F64, **kw)
    a = ot.FourierTridiagonalPoissonSolver(reg).solve(torch.tensor(rhs))
    b = ot.FFTPoissonSolver(reg).solve(torch.tensor(rhs))
    assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_complex_thomas_equals_two_real_solves():
    """The one sweep over ``view_as_real`` of a complex right-hand side
    equals the real and imaginary parts solved apart by
    ``tridiagonal_solve``, bit for bit."""
    from oceananigans_torch.solvers.fourier_tridiagonal import (
        thomas_factors,
    )
    rng = np.random.default_rng(2)
    n = 9
    a = torch.tensor(rng.uniform(1, 2, n))
    c = torch.tensor(rng.uniform(1, 2, n))
    b = torch.tensor(-4.0 - rng.uniform(0, 3, (n, 5, 4)))
    d = torch.complex(torch.tensor(rng.standard_normal((n, 5, 4))),
                      torch.tensor(rng.standard_normal((n, 5, 4))))
    pivots, cps = thomas_factors(a.reshape(n, 1, 1, 1), b.unsqueeze(-1),
                                 c.reshape(n, 1, 1, 1).expand(n, 5, 4, 1))
    x = d.clone()
    thomas_solve_(a.reshape(n, 1, 1, 1), pivots, cps, torch.view_as_real(x))
    a3, c3 = a.reshape(n, 1, 1), c.reshape(n, 1, 1)
    for part, got in ((d.real, x.real), (d.imag, x.imag)):
        ref = tridiagonal_solve(a3, b, c3, part.contiguous(), axis=0)
        assert torch.equal(got, ref)


def test_pressure_solver_selection():
    """Regular: FFT; stretched z: Fourier-tridiagonal; stretched x: the
    JAX package's error; immersed: preconditioned CG."""
    kw = dict(size=(8, 8, 6), extent=(1.0, 1.0, 1.0), dtype=F64)
    assert isinstance(ot.NonhydrostaticModel(
        grid=ot.RectilinearGrid(**kw)).pressure_solver, ot.FFTPoissonSolver)
    zs = ot.RectilinearGrid(size=(8, 8, 6), x=(0, 1), y=(0, 1),
                            z=wind_mixing_z(6, 1.0), dtype=F64)
    assert isinstance(ot.NonhydrostaticModel(grid=zs).pressure_solver,
                      ot.FourierTridiagonalPoissonSolver)
    xs = ot.RectilinearGrid(size=(8, 8, 6), x=np.linspace(0, 1, 9) ** 2,
                            y=(0, 1), z=(0, 1), dtype=F64)
    with pytest.raises(NotImplementedError, match="stretched x/y"):
        ot.NonhydrostaticModel(grid=xs)
    with pytest.raises(ValueError, match="x and y must be regular"):
        ot.FourierTridiagonalPoissonSolver(xs)
    ib = ot.ImmersedBoundaryGrid(ot.RectilinearGrid(**kw),
                                 ot.GridFittedBottom(lambda x, y: -0.5 + 0
                                                     * x))
    assert isinstance(ot.NonhydrostaticModel(grid=ib).pressure_solver,
                      ot.ImmersedPoissonSolver)


# ---------------------------------------------------------------------------
# Models on stretched z
# ---------------------------------------------------------------------------

def test_stretched_les_matches_jax():
    """The wind-mixing LES (chip_smoke.py phase 20) at 16 x 16 x 12 on the
    example's stretched z, its kernel code paths asked for (no kernel
    takes a stretched grid, so it runs the plain path with the
    Fourier-tridiagonal projection and WENO(5)'s z tables)."""
    N, Nz = 16, 12

    def build(pkg, **extra):
        g = pkg.RectilinearGrid(
            size=(N, N, Nz), x=(0.0, 64.0), y=(0.0, 64.0),
            z=wind_mixing_z(Nz), topology=(pkg.Periodic, pkg.Periodic,
                                           pkg.Bounded), halo=(3, 3, 3),
            dtype="float64" if pkg is oj else F64)
        return pkg.NonhydrostaticModel(
            grid=g, advection=pkg.WENO(5),
            buoyancy=pkg.SeawaterBuoyancy(
                equation_of_state=pkg.LinearEquationOfState(
                    thermal_expansion=2e-4), constant_salinity=35.0),
            closure=pkg.SmagorinskyLilly(),
            boundary_conditions={
                "T": pkg.FieldBoundaryConditions(
                    top=pkg.FluxBC(QT), bottom=pkg.GradientBC(0.01)),
                "u": pkg.FieldBoundaryConditions(top=pkg.FluxBC(6.2e-5))},
            timestepper="QuasiAdamsBashforth2", **extra)

    jm, tm = build(oj, fused_kernels=False), build(ot, fused_kernels=True)
    assert tm.fused_kernels is False and not tm.fused_tracer
    assert isinstance(tm.pressure_solver, ot.FourierTridiagonalPoissonSolver)
    rng = np.random.default_rng(0)
    js = jm.initial_state(T=lambda x, y, z: 20.0 + 0.01 * z,
                          u=1e-4 * rng.standard_normal((N, N, Nz)))
    run_both(jm, tm, js, 1.0, 3, balanced=True)


def test_tilted_bottom_matches_jax():
    """``examples/tilted_bottom_boundary_layer.py`` at 16 x 12 on its
    stretched z: tilted gravity, rotation about the tilted axis, quadratic
    drag through field-dependent flux conditions and a bottom gradient
    condition (its background fields run in
    ``tests/test_torch_forcings.py``)."""
    Lx, Nx, Nz = 200.0, 16, 12
    zf = tilted_z(Nz)
    theta = np.radians(3.0)
    g_hat = (np.sin(theta), 0.0, np.cos(theta))
    cD = (0.4 / np.log(0.5 * (zf(0) + zf(1)) / 0.1)) ** 2

    def build(pkg, xp):
        g = pkg.RectilinearGrid(
            size=(Nx, Nz), x=(0.0, Lx), z=zf,
            topology=(pkg.Periodic, pkg.Flat, pkg.Bounded),
            dtype="float64" if pkg is oj else F64)

        def drag(comp):
            return lambda x, y, t, u, v: (
                -cD * xp.sqrt(u ** 2 + (v + 0.1) ** 2)
                * (u if comp == "u" else v + 0.1))

        return pkg.NonhydrostaticModel(
            grid=g, advection=pkg.WENO(5), tracers=("b",),
            buoyancy=pkg.BuoyancyForce(
                pkg.BuoyancyTracer(),
                gravity_unit_vector=tuple(-c for c in g_hat)),
            coriolis=pkg.ConstantCartesianCoriolis(f=1e-4,
                                                   rotation_axis=g_hat),
            closure=pkg.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
            boundary_conditions={
                n: pkg.FieldBoundaryConditions(bottom=pkg.FluxBC(
                    drag(n), field_dependencies=("u", "v")))
                for n in ("u", "v")} | {
                "b": pkg.FieldBoundaryConditions(
                    bottom=pkg.GradientBC(-1e-5 * np.cos(theta)))})

    jm, tm = build(oj, jnp), build(ot, torch)
    assert isinstance(tm.pressure_solver, ot.FourierTridiagonalPoissonSolver)
    js = jm.initial_state(
        u=lambda x, y, z: 0.01 * jnp.sin(2 * np.pi * x / Lx)
        * jnp.exp(z / 20), b=lambda x, y, z: 1e-5 * z)
    run_both(jm, tm, js, 30.0, 3)


# ---------------------------------------------------------------------------
# Kernel gates
# ---------------------------------------------------------------------------

def test_gates_refuse_stretched_grids():
    """Each kernel gate of the port against its JAX gate on grids
    stretched along each axis in turn (and on the regular grid, which both
    take): rows 1-9 (Centered-2 and WENO-5), 10 (shallow water), 11-13 (the
    WENO tracer and vector-invariant kernels, whose lat-lon gate takes a
    stretched y), 14 (generic momentum, whose JAX wrapper raises)."""
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    from oceananigans_tpu.ops import pallas_generic as jgen
    from oceananigans_tpu.ops import pallas_kernels as jk
    from oceananigans_tpu.ops import pallas_sw as jsw
    from oceananigans_tpu.ops import pallas_tracer as jtr
    from oceananigans_tpu.ops import pallas_vi as jvi
    from oceananigans_tpu.ops import pallas_weno as jw
    N = 16
    stretched = np.linspace(0.0, 1.0, N + 1) ** 1.5
    for axis in (None, 0, 1, 2):
        specs = [(0.0, 1.0)] * 3
        if axis is not None:
            specs[axis] = stretched
        kw = dict(size=(N, N, N), x=specs[0], y=specs[1], z=specs[2],
                  topology=("bounded", "periodic", "periodic"), halo=6)
        jg, tg = both_grids(**kw)
        takes = axis is None
        assert ck.fused_available(tg, ot.Centered(2)) \
            == jk.pallas_available(jg, oj.Centered(2)) == takes
        assert cw.weno5_available(tg, ot.WENO(5)) \
            == jw.weno5_available(jg, oj.WENO(5)) == takes
        tw7 = t_adv.bind_grid(ot.WENO(7), tg)
        jw7 = oj.WENO(7).bind_grid(jg)
        assert ctr.tracer_fusion_available(tg, tw7) \
            == jtr.tracer_fusion_available(jg, jw7) == takes
        assert cvi.vi_available(tg, ot.WENOVectorInvariant()) \
            == jvi.vi_available(jg, oj.models.hydrostatic
                                .WENOVectorInvariant()) == takes
        assert cg.generic_available(tg, ot.WENO(5)) == takes
        if not takes:
            with pytest.raises(ValueError, match="regular"):
                cg._check_contract(tg, ot.WENO(5))
            with pytest.raises(ValueError, match="regular"):
                jgen.fused_momentum_tendency(
                    jg, oj.WENO(5), *(jnp.zeros(jg.shape),) * 3)
        # the shallow-water kernel on a layout the JAX gate's tiling
        # rules take (an x halo of 8, a halo-free y of 128)
        sw_specs = [(0.0, 1.0), (0.0, 1.0)]
        if axis in (0, 1):
            sw_specs[axis] = np.linspace(0.0, 1.0, (N, 128)[axis] + 1) ** 1.5
        sw_kw = dict(size=(N, 128), x=sw_specs[0], y=sw_specs[1],
                     topology=("periodic", "periodic", "flat"),
                     halo=(8, 0, 0))
        jsg, tsg = both_grids(**sw_kw)
        tsm = ot.ShallowWaterModel(grid=tsg, gravitational_acceleration=1.0)
        jsm = oj.ShallowWaterModel(grid=jsg, gravitational_acceleration=1.0)
        assert csw.sw_fused_available(tsg, tsm) \
            == jsw.sw_fused_available(jsg, jsm) == (axis is None or axis == 2)
    # a lat-lon grid stretched in y keeps the tracer and VI kernels, as in
    # the JAX package; the tracer scheme's y tables refuse the tracer one
    kl = dict(size=(16, 12, 8), longitude=(0.0, 360.0),
              latitude=np.linspace(-60.0, 60.0, 13) ** 1.0 * np.linspace(
                  0.8, 1.0, 13), z=(-500.0, 0.0), halo=7)
    tl = ot.LatitudeLongitudeGrid(dtype=F64, **kl)
    jl = oj.LatitudeLongitudeGrid(dtype="float64", **kl)
    assert not tl.y_regular and not jl.y_regular
    assert cvi.vi_available(tl, ot.WENOVectorInvariant()) \
        == jvi.vi_available(jl, oj.models.hydrostatic.WENOVectorInvariant())
    assert ctr.tracer_fusion_available(tl, t_adv.bind_grid(ot.WENO(5), tl)) \
        == jtr.tracer_fusion_available(jl, oj.WENO(5).bind_grid(jl)) \
        is False
