"""oceananigans_torch's immersed boundaries against the JAX package, on the
CPU in float64.

Held bit for bit: the masks of every boundary kind (``GridFittedBottom``
from a callable and from an interior array, ``PartialCellBottom``,
``GridFittedBoundary`` from a callable and from an array) on periodic and
bounded rectilinear grids and on a lat-lon grid; to 1e-14, the partial
cells' scaled heights and the metrics on them (a callable bottom's exp
may round differently in torch and in JAX). Held to 1e-12 of the largest
value: the masked Laplacian; conjugate gradient at a fixed iteration
count (``reltol = 0``, both preconditioners: the iterates differ only by
the order of the dot products' sums); the seamount model of
``chip_smoke.py`` phase 18 at (16, 16, 8), 3 steps with Centered(2) and
with WENO(5); and the immersed flux, drag, value and gradient conditions
of ``tests/test_immersed.py``, 3 steps.

``ImmersedPoissonSolver`` at its default tolerance takes the JAX solver's
iteration count, and its true residual ‖b − Gp‖ is within reltol·‖b‖ (the
stopping test on the recurrence residual, which equals the true one to
rounding: 1.0001·reltol is the bound held), so the port's and the JAX
solution differ by at most 2·reltol·‖b‖ in the operator's norm, ‖G(p −
p_JAX)‖ (held with the same 1.0001; over ~190 Jacobi iterations their
rounding moves the solutions apart by ~4e-11 of the largest value, so a
rounding-level bound does not hold there). The convergence flag read
every k iterations gives the result of a read every iteration, bit for
bit, with the same count, for k = 1 to 7.

Also: every kernel gate of the port refuses an immersed grid (the JAX
gates test ``type(grid) is RectilinearGrid``); ``interop`` carries an
immersed state; the NetCDF coordinates of an immersed grid are its
underlying grid's, and the plots draw its solid cells as NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import immersed as t_ib
from oceananigans_torch.interop import (
    FIELDS, state_from_numpy, state_to_numpy, tracer_keys,
)
from oceananigans_tpu import immersed as j_ib
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions as
    j_regularize,
)
from oceananigans_tpu.fields import LOC_C as J_LOC_C

from test_torch_closure_models import run_both

F64 = torch.float64


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


def seamount(xp, height=1.0, width2=2.0, depth=2.0):
    """phase 18's bottom: -depth + height·exp(-(x² + y²)/width2)."""
    return lambda x, y: -depth + height * xp.exp(-(x ** 2 + y ** 2)
                                                 / width2)


def rect_grids(size=(16, 16, 8), topology=("periodic", "periodic",
                                           "bounded"), halo=(3, 3, 3)):
    kw = dict(size=size, x=(-10.0, 10.0), y=(-10.0, 10.0), z=(-2.0, 0.0),
              topology=topology, halo=halo)
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


def boundaries(kind, xp, interior_shape):
    """Each package's boundary object of ``kind``."""
    pkg = oj if xp is jnp else ot
    if kind == "bottom":
        return pkg.GridFittedBottom(seamount(xp, width2=8.0))
    if kind == "bottom_array":
        rng = np.random.default_rng(3)
        h = -2.0 + 1.5 * rng.random(interior_shape[:2])
        return pkg.GridFittedBottom(h)
    if kind == "partial":
        return pkg.PartialCellBottom(seamount(xp, width2=8.0), 0.3)
    if kind == "boundary":
        return pkg.GridFittedBoundary(
            lambda x, y, z: (x - 2.0) ** 2 + y ** 2 + (z + 1.0) ** 2 < 9.0)
    rng = np.random.default_rng(4)
    return pkg.GridFittedBoundary(rng.random(interior_shape) < 0.2)


KINDS = ["bottom", "bottom_array", "partial", "boundary", "boundary_array"]
MASKS = ("solid_c", "solid_u", "solid_v", "solid_w")


def immersed_pair(kind, jg, tg):
    return (oj.ImmersedBoundaryGrid(jg, boundaries(kind, jnp, jg.N)),
            ot.ImmersedBoundaryGrid(tg, boundaries(kind, torch, tg.N)))


# ---------------------------------------------------------------------------
# Masks and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", [("periodic", "periodic", "bounded"),
                                      ("bounded", "bounded", "bounded")],
                         ids=["ppb", "bbb"])
@pytest.mark.parametrize("kind", KINDS)
def test_masks_match_jax(kind, topology):
    """The halo-consistent cell mask, the face masks (a face is solid
    where either cell is), the partial cells' scaled heights and the
    metrics on them, bit for bit."""
    jg, tg = immersed_pair(kind, *rect_grids(topology=topology))
    for name in MASKS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    assert (tg.dz_sigma is None) == (jg.dz_sigma is None) \
        == (kind != "partial")
    # the scaled heights and the metrics on them to 1e-14: the bottom's
    # exp may round differently in torch
    if tg.dz_sigma is not None:
        np.testing.assert_allclose(tg.dz_sigma.numpy(),
                                   np.asarray(jg.dz_sigma), rtol=1e-14)
    C, F = ot.Center, ot.Face
    for fn, args in (("dz", (C,)), ("dz", (F,)), ("Ax", (F, C, C)),
                     ("Ay", (C, F, C)), ("V", (C, C, C))):
        np.testing.assert_allclose(
            np.broadcast_to(getattr(tg, fn)(*args).numpy(), tg.shape),
            np.broadcast_to(np.asarray(getattr(jg, fn)(*args)), jg.shape),
            rtol=1e-14)
    assert tg.shape == jg.shape and tg.N == jg.N and tg.H == jg.H
    assert float(tg.fluid_fraction) == pytest.approx(
        float(jg.fluid_fraction), abs=1e-7)
    for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_W, (F, F, C), (C, F, F)):
        np.testing.assert_array_equal(
            t_ib.solid_mask_at(tg, loc).numpy(),
            np.asarray(j_ib.solid_mask_at(jg, loc)))


@pytest.mark.parametrize("kind", ["bottom", "partial", "boundary"])
def test_latlon_masks_match_jax(kind):
    """On a lat-lon grid the callables take degrees; the same masks."""
    kw = dict(size=(16, 12, 6), longitude=(0.0, 360.0),
              latitude=(-60.0, 60.0), z=(-4000.0, 0.0), halo=4)
    jg = oj.LatitudeLongitudeGrid(dtype="float64", **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, **kw)

    def objects(pkg, xp):
        bottom = (lambda lam, phi: -4000.0 + 3500.0
                  * xp.exp(-((lam - 180.0) ** 2 + phi ** 2) / 800.0))
        if kind == "bottom":
            return pkg.GridFittedBottom(bottom)
        if kind == "partial":
            return pkg.PartialCellBottom(bottom)
        return pkg.GridFittedBoundary(
            lambda lam, phi, z: (xp.abs(phi) > 50.0) | (z < -3000.0))

    tib = ot.ImmersedBoundaryGrid(tg, objects(ot, torch))
    jib = oj.ImmersedBoundaryGrid(jg, objects(oj, jnp))
    for name in MASKS:
        np.testing.assert_array_equal(getattr(tib, name).numpy(),
                                      np.asarray(getattr(jib, name)), name)
    if kind == "partial":
        # to 1e-14: the bottom's exp may round differently in torch
        np.testing.assert_allclose(tib.dz_sigma.numpy(),
                                   np.asarray(jib.dz_sigma), rtol=1e-14)
    np.testing.assert_array_equal(
        np.broadcast_to(tib.Az(ot.Center, ot.Center).numpy(), tib.shape),
        np.broadcast_to(np.asarray(jib.Az("c", "c")), jib.shape))


# ---------------------------------------------------------------------------
# The masked operator and CG
# ---------------------------------------------------------------------------

def filled_random(jg, tg, seed=0):
    """The same halo-filled random center field in both packages."""
    a = np.random.default_rng(seed).standard_normal(tg.shape)
    j = j_fill(jnp.asarray(a), jg.underlying_grid,
               j_regularize(None, jg.underlying_grid, J_LOC_C), J_LOC_C)
    return j, torch.tensor(np.asarray(j))


@pytest.mark.parametrize("kind", ["bottom", "partial", "boundary"])
def test_masked_laplacian_matches_jax(kind):
    jg, tg = immersed_pair(kind, *rect_grids())
    jp, tp = filled_random(jg, tg)
    a = t_ib.masked_laplacian(tg, tp).numpy()
    b = np.asarray(j_ib.masked_laplacian(jg, jp))
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    assert not a[tg.solid_c.numpy()].any()


def cg_pair(jg, tg, rhs, maxiter, reltol, info=None):
    """Both packages' masked CG solves of the interior ``rhs``, the FFT
    preconditioner where the JAX solver picks it."""
    jsolver = j_ib.ImmersedPoissonSolver(jg)
    tsolver = t_ib.ImmersedPoissonSolver(tg)
    assert (jsolver.preconditioner is None) == (
        tsolver.preconditioner is None)
    jb = jg.underlying_grid
    jbcs = j_regularize(None, jb, J_LOC_C)
    j = j_ib.masked_cg_solve(
        jg, jnp.asarray(rhs),
        fill_halos=lambda p: j_fill(p, jb, jbcs, J_LOC_C),
        reduce_sum=jnp.sum,
        precond_apply=(None if jsolver.preconditioner is None
                       else jsolver.preconditioner.solve),
        maxiter=maxiter, reltol=reltol)
    tb = tg.underlying_grid
    t = t_ib.masked_cg_solve(
        tg, torch.tensor(rhs),
        fill_halos=lambda p: ot.fill_halo_regions(p, tb),
        precond_apply=(None if tsolver.preconditioner is None
                       else tsolver.preconditioner.solve),
        maxiter=maxiter, reltol=reltol, info=info)
    return np.asarray(j), t


@pytest.mark.parametrize("kind", ["bottom", "partial"],
                         ids=["fft-preconditioned", "jacobi"])
def test_cg_fixed_iterations_matches_jax(kind):
    """reltol = 0: both run every iteration; 6 iterations agree to 1e-12
    of the largest value (the sums of the dot products are ordered
    differently, nothing else)."""
    jg, tg = immersed_pair(kind, *rect_grids())
    rhs = np.random.default_rng(1).standard_normal(tg.N)
    info = {}
    j, t = cg_pair(jg, tg, rhs, maxiter=6, reltol=0.0, info=info)
    assert int(info["iterations"]) == 6
    assert np.abs(t.numpy() - j).max() <= 1e-12 * np.abs(j).max()


@pytest.mark.parametrize("kind", ["bottom", "partial", "boundary"])
def test_immersed_poisson_solver_matches_jax(kind):
    """The default tolerance (reltol 1e-8 in float64): the JAX solver's
    iteration count, the solution within 1e-12 of its largest value (the
    same iterations, so rounding apart), and a true residual within
    1.0001·reltol·‖b‖."""
    jg, tg = immersed_pair(kind, *rect_grids())
    rhs = np.random.default_rng(2).standard_normal(tg.N)
    jsolver = j_ib.ImmersedPoissonSolver(jg)
    tsolver = t_ib.ImmersedPoissonSolver(tg)
    assert (tsolver.reltol, tsolver.maxiter) == (jsolver.reltol,
                                                 jsolver.maxiter)
    t = tsolver.solve(torch.tensor(rhs))
    j = np.asarray(jsolver.solve(jnp.asarray(rhs)))
    # the JAX count, from the JAX loop itself
    jb = jg.underlying_grid
    import importlib
    jcg = importlib.import_module(
        "oceananigans_tpu.solvers.conjugate_gradient")
    seen = {}
    orig = jcg.conjugate_gradient

    def spy(*a, **k):
        out = orig(*a, **k)
        seen["it"] = int(out[1])
        return out

    jcg.conjugate_gradient = spy
    try:
        j_ib.masked_cg_solve(
            jg, jnp.asarray(rhs),
            fill_halos=lambda p: j_fill(p, jb, j_regularize(
                None, jb, J_LOC_C), J_LOC_C),
            reduce_sum=jnp.sum,
            precond_apply=(None if jsolver.preconditioner is None
                           else jsolver.preconditioner.solve),
            maxiter=jsolver.maxiter, reltol=jsolver.reltol)
    finally:
        jcg.conjugate_gradient = orig
    assert int(tsolver.iterations) == seen["it"] > 1
    # the true residuals of the volume-weighted system G p = b
    sysm = tsolver.system
    ii = tg.interior_slices
    full = torch.zeros(tg.shape, dtype=F64)
    full[ii] = torch.tensor(rhs)
    b = torch.where(sysm.fluid, full * sysm.Vw, 0.0)
    b = torch.where(sysm.fluid, b - b[ii].sum() / sysm.nf, 0.0)

    def G(interior_p):
        p = torch.zeros(tg.shape, dtype=F64)
        p[ii] = interior_p
        return torch.where(sysm.fluid, sysm.Vw * t_ib.masked_laplacian(
            tg, ot.fill_halo_regions(p, tg.underlying_grid)), 0.0)

    def norm(a):
        return float(torch.linalg.vector_norm(a))

    bound = tsolver.reltol * norm(b)
    assert norm(b - G(t)) <= 1.0001 * bound
    # both solutions within reltol of b, so their difference within
    # 2 reltol in the operator's norm
    assert norm(G(t - torch.tensor(j))) <= 2.0002 * bound


def test_cg_flag_read_every_k_equals_every_iteration(monkeypatch):
    """The sticky convergence flag: reading it every k iterations gives
    the solution and the count of a read every iteration, bit for bit,
    with ⌈count/k⌉ + 1 reads."""
    import importlib
    cgmod = importlib.import_module(
        "oceananigans_torch.solvers.conjugate_gradient")
    jg, tg = immersed_pair("partial", *rect_grids())
    rhs = np.random.default_rng(5).standard_normal(tg.N)
    ref_info = {}
    monkeypatch.setattr(cgmod, "CHECK_EVERY", 1)
    _, ref = cg_pair(jg, tg, rhs, 600, 1e-8, info=ref_info)
    n = int(ref_info["iterations"])
    assert ref_info["host_syncs"] == n + 1
    for k in (2, 3, 4, 7):
        info = {}
        monkeypatch.setattr(cgmod, "CHECK_EVERY", k)
        _, got = cg_pair(jg, tg, rhs, 600, 1e-8, info=info)
        assert torch.equal(got, ref)
        assert int(info["iterations"]) == n
        assert info["host_syncs"] == -(-n // k) + 1


# ---------------------------------------------------------------------------
# The seamount model and immersed boundary conditions
# ---------------------------------------------------------------------------

def seamount_models(adv, size=(16, 16, 8)):
    out = []
    for pkg, xp in ((oj, jnp), (ot, torch)):
        g = pkg.RectilinearGrid(
            size=size, x=(-10.0, 10.0), y=(-10.0, 10.0), z=(-2.0, 0.0),
            topology=(pkg.Periodic, pkg.Periodic, pkg.Bounded),
            halo=(3, 3, 3), dtype="float64" if pkg is oj else F64)
        ib = pkg.ImmersedBoundaryGrid(g, pkg.GridFittedBottom(
            seamount(xp, width2=8.0)))
        out.append(pkg.NonhydrostaticModel(
            grid=ib, advection=adv(pkg), tracers=("b",),
            buoyancy=pkg.BuoyancyTracer(),
            timestepper="QuasiAdamsBashforth2"))
    return out


@pytest.mark.parametrize("adv", [lambda p: p.Centered(2),
                                 lambda p: p.WENO(5)],
                         ids=["Centered2", "WENO5"])
def test_seamount_matches_jax(adv):
    """phase 18's seamount at (16, 16, 8): u = 0.1, b = z, AB2, 3 steps;
    WENO(5) reaches the two-point fallback next to the bottom. The
    velocities stay exactly zero on solid faces."""
    jm, tm = seamount_models(adv)
    assert tm.fused_kernels is False and isinstance(
        tm.pressure_solver, ot.ImmersedPoissonSolver)
    js = jm.initial_state(u=0.1, b=lambda x, y, z: z)
    _, ts = run_both(jm, tm, js, 0.02, 3, eager=True)
    g = tm.grid
    for name, mask in (("u", g.solid_u), ("v", g.solid_v),
                       ("w", g.solid_w)):
        assert not getattr(ts, name)[mask].any(), name


def step_bottom(pkg, N=16, depth=0.5):
    """``tests/test_immersed.py``'s flat step bottom on a (Periodic, Flat,
    Bounded) grid."""
    base = pkg.RectilinearGrid(size=(N, N), x=(0.0, 1.0), z=(0.0, 1.0),
                               topology=(pkg.Periodic, pkg.Flat, pkg.Bounded),
                               dtype="float64" if pkg is oj else F64)
    return pkg.ImmersedBoundaryGrid(base, pkg.GridFittedBottom(
        lambda x, y: depth + 0 * x))


def ibc_case(case, pkg):
    """The model keywords and initial fields of a case: a tracer flux into
    the bottom with a linear drag on u, or a value condition on c's bottom
    with a gradient condition on every side of d under a diffusivity."""
    ibc = pkg.ImmersedBoundaryCondition
    if case == "flux_drag":
        return dict(tracers=("c",), boundary_conditions={
            "c": pkg.FieldBoundaryConditions(immersed=ibc(
                bottom=pkg.FluxBC(1e-3))),
            "u": pkg.FieldBoundaryConditions(immersed=ibc(
                bottom=pkg.FluxBC(-1e-4)))}), dict(
            u=lambda x, y, z: 0.1 + 0 * x)
    return dict(tracers=("c", "d"),
                closure=pkg.ScalarDiffusivity(nu=1e-3, kappa=1e-3),
                boundary_conditions={
                    "c": pkg.FieldBoundaryConditions(immersed=ibc(
                        bottom=pkg.ValueBC(2.0))),
                    "d": pkg.FieldBoundaryConditions(
                        immersed=pkg.GradientBC(0.5))}), dict(
        c=lambda x, y, z: 1.0 + 0 * x, d=lambda x, y, z: 1.0 + x)


@pytest.mark.parametrize("case", ["flux_drag", "value_gradient"])
def test_immersed_conditions_match_jax(case):
    """``tests/test_immersed.py``'s immersed flux budget, momentum drag and
    value relaxation, and a gradient condition on every side, 3 steps; the
    tracer's content grows by q·A·t under the flux condition, and the
    first step's drag tendency is τ/Δz in the cells above the bottom."""
    (jkw, jinit), (tkw, _) = ibc_case(case, oj), ibc_case(case, ot)
    jm = oj.NonhydrostaticModel(grid=step_bottom(oj), **jkw)
    tm = ot.NonhydrostaticModel(grid=step_bottom(ot), **tkw)
    assert set(tm.immersed_bcs) == set(jm.immersed_bcs)
    js = jm.initial_state(**jinit)
    g = tm.grid
    if case == "flux_drag":
        s0 = state_from_numpy(tm, state_to_numpy_jax(js, tm))
        Gu = g.interior(tm.compute_tendencies(tm.fill_state_halos(s0))[0])
        solid_u = g.interior(g.solid_u).numpy()
        adj = (~solid_u) & np.roll(solid_u, 1, 2) & (
            np.arange(solid_u.shape[2]) > 0)
        np.testing.assert_allclose(Gu.numpy()[adj], -1e-4 * 16, rtol=1e-12)
    _, ts = run_both(jm, tm, js, 0.01, 3)
    if case == "flux_drag":
        dV = g.V(ot.Center, ot.Center, ot.Center).expand(g.shape)
        wet = ~g.solid_c
        content = float((ts.tracers["c"] * dV)[g.interior_slices][
            wet[g.interior_slices]].sum())
        solid = g.interior(g.solid_c).numpy()
        adj = (~solid) & np.roll(solid, 1, 2) & (
            np.arange(solid.shape[2]) > 0)
        Az = np.broadcast_to(g.Az(ot.Center, ot.Center).numpy(), g.shape)
        area = (g.interior(torch.tensor(Az)).numpy() * adj).sum()
        assert content == pytest.approx(1e-3 * area * 0.03, rel=1e-6)


def state_to_numpy_jax(state, tmodel):
    """A JAX nonhydrostatic state as ``interop``'s numpy mapping."""
    from test_torch_closure_models import jax_arrays
    return jax_arrays(state, FIELDS, tmodel.tracer_names)


def test_regularize_immersed_bc():
    """The sides normal to a Face axis are dropped, as in the JAX
    package."""
    rib = t_ib.regularize_immersed_bc(ot.FluxBC(1.0), ot.LOC_U)
    assert rib.west is None and rib.east is None
    assert rib.bottom is not None and rib.north is not None
    only_z = ot.ImmersedBoundaryCondition(bottom=ot.FluxBC(1.0))
    assert t_ib.regularize_immersed_bc(only_z, ot.LOC_W) is None
    assert t_ib.scalar_diffusivity_of(
        (ot.ScalarDiffusivity(nu=2.0, kappa={"c": 3.0}),
         ot.SmagorinskyLilly()), "c") == 3.0


# ---------------------------------------------------------------------------
# Kernel gates, the cubed sphere, interop, output and plots
# ---------------------------------------------------------------------------

def test_gates_refuse_immersed_grids():
    """Every port gate refuses an immersed grid over a grid it takes, as
    the JAX gates do; the models run no kernel there."""
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    from oceananigans_tpu.ops import pallas_kernels as jk
    from oceananigans_tpu.ops import pallas_sw as jsw
    from oceananigans_tpu.ops import pallas_tracer as jtr
    from oceananigans_tpu.ops import pallas_vi as jvi
    from oceananigans_tpu.ops import pallas_weno as jw
    jg, tg = rect_grids(size=(16, 16, 16), topology=(
        "bounded", "periodic", "periodic"), halo=(6, 6, 6))
    jib, tib = immersed_pair("boundary", jg, tg)
    jvi_scheme = oj.models.hydrostatic.WENOVectorInvariant()
    for jgrid, tgrid, takes in ((jg, tg, True), (jib, tib, False)):
        assert ck.fused_available(tgrid, ot.Centered(2)) \
            == jk.pallas_available(jgrid, oj.Centered(2)) == takes
        assert cw.weno5_available(tgrid, ot.WENO(5)) \
            == jw.weno5_available(jgrid, oj.WENO(5)) == takes
        assert ctr.tracer_fusion_available(tgrid, ot.WENO(7)) \
            == jtr.tracer_fusion_available(jgrid, oj.WENO(7)) == takes
        assert cvi.vi_available(tgrid, ot.WENOVectorInvariant()) \
            == jvi.vi_available(jgrid, jvi_scheme) == takes
        assert cg.generic_available(tgrid, ot.WENO(5)) == takes
    kl = dict(size=(16, 12, 8), longitude=(0.0, 360.0),
              latitude=(-60.0, 60.0), z=(-500.0, 0.0), halo=7)
    jl = oj.LatitudeLongitudeGrid(dtype="float64", **kl)
    tl = ot.LatitudeLongitudeGrid(dtype=F64, **kl)
    bottom = lambda lam, phi: -400.0 + 0 * lam + 0 * phi   # noqa: E731
    jli = oj.ImmersedBoundaryGrid(jl, oj.GridFittedBottom(bottom))
    tli = ot.ImmersedBoundaryGrid(tl, ot.GridFittedBottom(bottom))
    for jgrid, tgrid, takes in ((jl, tl, True), (jli, tli, False)):
        assert ctr.tracer_fusion_available(tgrid, ot.WENO(5)) \
            == jtr.tracer_fusion_available(jgrid, oj.WENO(5)) == takes
        assert cvi.vi_available(tgrid, ot.WENOVectorInvariant()) \
            == jvi.vi_available(jgrid, jvi_scheme) == takes
    # the shallow-water gate on a layout the JAX tiling rules take
    sw = dict(size=(16, 128), x=(0.0, 1.0), y=(0.0, 1.0),
              topology=("periodic", "periodic", "flat"), halo=(8, 0, 0))
    jsg = oj.RectilinearGrid(dtype="float64", **sw)
    tsg = ot.RectilinearGrid(dtype=F64, **sw)
    jsi = oj.ImmersedBoundaryGrid(jsg, oj.GridFittedBottom(bottom))
    tsi = ot.ImmersedBoundaryGrid(tsg, ot.GridFittedBottom(bottom))
    tsm = ot.ShallowWaterModel(grid=tsg, gravitational_acceleration=1.0)
    jsm = oj.ShallowWaterModel(grid=jsg, gravitational_acceleration=1.0)
    assert csw.sw_fused_available(tsg, tsm) == jsw.sw_fused_available(
        jsg, jsm) is True
    assert csw.sw_fused_available(tsi, tsm) == jsw.sw_fused_available(
        jsi, jsm) is False
    # models on immersed grids: no kernel, whatever fused_kernels asks
    tm = ot.NonhydrostaticModel(grid=tib, advection=ot.WENO(5),
                                fused_kernels=True)
    assert tm.fused_kernels is False and not tm.fused_tracer
    hm = ot.HydrostaticFreeSurfaceModel(
        grid=tli, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(5), tracers=("T",), fused_kernels=True)
    assert not hm.fused_kernels and not hm.fused_tracer


def test_interop_carries_immersed_state():
    """``state_to_numpy`` and ``state_from_numpy`` carry a state of a model
    on an immersed grid unchanged (and across to a fresh model)."""
    _, tm = seamount_models(lambda p: p.WENO(5), size=(8, 8, 4))
    s = tm.initial_state(u=0.1, b=lambda x, y, z: z)
    s = tm.step(s, 0.02)
    arrays = state_to_numpy(s)
    assert set(FIELDS + tracer_keys(("b",))) <= set(arrays)
    back = state_from_numpy(tm, arrays)
    for key, a in state_to_numpy(back).items():
        np.testing.assert_array_equal(a, arrays[key])
    again = tm.step(back, 0.02)
    ref = tm.step(state_from_numpy(tm, arrays), 0.02)
    assert torch.equal(again.u, ref.u) and torch.equal(again.w, ref.w)


def test_output_schema_and_plots():
    """The NetCDF coordinates of an immersed grid are its underlying
    grid's; a plot of a field on it draws the solid cells as NaN."""
    import matplotlib
    matplotlib.use("Agg")
    from oceananigans_torch.output import NetCDFWriter
    from oceananigans_torch.utils import plotting
    tib = step_bottom(ot, N=8)
    a = NetCDFWriter._coordinate_schema(tib)
    b = NetCDFWriter._coordinate_schema(tib.underlying_grid)
    assert [[(k, v[0]) for k, v in ax.items()] for ax in a[1]] == [
        [(k, v[0]) for k, v in ax.items()] for ax in b[1]]
    mesh = plotting.heatmap(tib, torch.ones(tib.shape, dtype=F64))
    vals = np.ma.getdata(mesh.get_array()).reshape(-1)
    solid = tib.interior(tib.solid_c).numpy()
    assert np.isnan(vals).sum() == solid.sum() > 0
    import matplotlib.pyplot as plt
    plt.close("all")
