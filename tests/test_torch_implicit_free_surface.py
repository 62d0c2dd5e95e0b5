"""oceananigans_torch's implicit free surface, its stencil-matrix solver
and the ``split_rk3`` time stepper against the JAX package, on the CPU in
float64.

- ``StencilMatrix`` and ``HeptadiagonalIterativeSolver`` on the JAX
  package's 1-D Poisson test and on a 2-D Helmholtz matrix with seeded
  conductances, with the Jacobi and the "spai" preconditioner: the
  products equal to 1e-15, the solutions at a fixed iteration count
  within 1e-12 of the largest value.
- ``ImplicitFreeSurface`` with each method, 3 steps on a rectilinear
  channel and on a lat-lon sector: "fft" within 1e-12; "cg" and "matrix"
  at a fixed iteration count (``reltol=0``) within 1e-12 (CG agrees with
  JAX only to rounding, so the counts are fixed).
- ``split_rk3`` under the explicit, implicit and split-explicit free
  surfaces, 2 steps within 1e-12.
- A bitwise pickup of an implicit ``split_rk3`` state through
  ``Checkpointer``.

The cube's implicit free surface is tested in ``tests/test_torch_zstar.py``
beside the cube's z-star, whose JAX reference compiles the same eager
operations.

Each field is held within 1e-12 of its largest JAX value after every step
(``run_both``); the JAX model steps eagerly, quicker than compiling these
small cases. The initial states carry numpy-seeded perturbations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.solvers.matrix_solver import (
    HeptadiagonalIterativeSolver, StencilMatrix,
)
from oceananigans_tpu.models import hydrostatic as j_hyd
from oceananigans_tpu.solvers import matrix_solver as j_ms

from test_torch_closure_models import run_both

F64 = torch.float64
SIZE = (16, 12, 4)


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


def close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The stencil matrix and its solver
# ---------------------------------------------------------------------------

def test_stencil_matrix_poisson_1d():
    """The JAX package's 1-D test: a uniform conductance gives the
    discrete Laplacian, CG recovers a known solution, and product,
    diagonal and solution equal the JAX ones."""
    n = 32
    x = np.sin(2 * np.pi * np.arange(n) / n).reshape(n, 1, 1)
    A = StencilMatrix(ax=torch.ones((n, 1, 1), dtype=F64), extra=-0.1,
                      periodic=(True, False, False))
    jA = j_ms.StencilMatrix(ax=jnp.ones((n, 1, 1)), extra=-0.1,
                            periodic=(True, False, False))
    b = A(torch.from_numpy(x))
    close(b, jA(jnp.asarray(x)), 1e-15)
    close(A.diagonal(), jA.diagonal(), 1e-15)
    x2, it, _ = HeptadiagonalIterativeSolver(A, maxiter=200,
                                             reltol=1e-13).solve(b)
    np.testing.assert_allclose(x2.numpy(), x, atol=1e-10)
    jx2, jit, _ = j_ms.HeptadiagonalIterativeSolver(
        jA, maxiter=200, reltol=1e-13).solve(jnp.asarray(b.numpy()))
    assert int(it) == int(jit)
    close(x2, jx2)


@pytest.mark.parametrize("preconditioner", ["jacobi", "spai", 3])
def test_helmholtz_2d_matches_jax(preconditioner):
    """A 2-D Helmholtz matrix with seeded anisotropic conductances, a wall
    on y (its first faces zero) and a periodic x: 25 iterations of each
    preconditioner's CG equal JAX's within 1e-12; at reltol 1e-10 "spai"
    takes fewer iterations than Jacobi, as in JAX."""
    rng = np.random.default_rng(3)
    nx, ny = 24, 20
    axn = 1.0 + 0.5 * rng.random((nx, ny, 1))
    ayn = 30.0 * (1.0 + 0.5 * rng.random((nx, ny, 1)))
    ayn[:, 0, :] = 0.0
    bn = rng.standard_normal((nx, ny, 1))
    per = (True, False, False)
    A = StencilMatrix(ax=torch.from_numpy(axn), ay=torch.from_numpy(ayn),
                      extra=-0.3, periodic=per)
    jA = j_ms.StencilMatrix(ax=jnp.asarray(axn), ay=jnp.asarray(ayn),
                            extra=-0.3, periodic=per)
    close(A(torch.from_numpy(bn)), jA(jnp.asarray(bn)), 1e-15)
    x, it, res = HeptadiagonalIterativeSolver(
        A, maxiter=25, reltol=0.0, preconditioner=preconditioner).solve(
            torch.from_numpy(bn))
    jx, jit, jres = j_ms.HeptadiagonalIterativeSolver(
        jA, maxiter=25, reltol=0.0, preconditioner=preconditioner).solve(
            jnp.asarray(bn))
    assert int(it) == int(jit) == 25
    close(x, jx)
    if preconditioner == "spai":
        counts = [int(HeptadiagonalIterativeSolver(
            A, maxiter=500, reltol=1e-10, preconditioner=p).solve(
                torch.from_numpy(bn))[1]) for p in ("jacobi", "spai")]
        assert counts[1] < counts[0], counts


# ---------------------------------------------------------------------------
# The implicit free surface in the hydrostatic model
# ---------------------------------------------------------------------------

def rect_grid(pkg):
    return pkg.RectilinearGrid(
        size=SIZE, x=(0.0, 1e5), y=(0.0, 5e4), z=(-100.0, 0.0),
        topology=(pkg.Periodic, pkg.Bounded, pkg.Bounded), halo=3,
        dtype="float64" if pkg is oj else F64)


def latlon_grid(pkg):
    return pkg.LatitudeLongitudeGrid(
        size=SIZE, longitude=(0.0, 30.0), latitude=(10.0, 40.0),
        z=(-500.0, 0.0), halo=3, dtype="float64" if pkg is oj else F64)


def build(pkg, grid, free_surface, **kw):
    return pkg.HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=free_surface, tracers=("T",),
        tracer_advection=pkg.WENO(5),
        buoyancy=pkg.SeawaterBuoyancy(
            equation_of_state=pkg.LinearEquationOfState(),
            constant_salinity=35.0),
        coriolis=pkg.FPlane(f=1e-4), **kw)


def seeded_state(jm, rect=True):
    """A JAX state: a sloshing η, a stratified T and u, v, T perturbed by
    numpy-seeded noise."""
    rng = np.random.default_rng(17)
    N = jm.grid.N
    L = (1e5, 5e4) if rect else (30.0, 30.0)
    x0 = 0.0 if rect else 10.0
    return jm.initial_state(
        eta=lambda x, y: 0.1 * jnp.sin(2 * jnp.pi * x / L[0])
        * jnp.cos(jnp.pi * (y - (0.0 if rect else x0)) / L[1]),
        u=0.01 * rng.standard_normal(N), v=0.01 * rng.standard_normal(N),
        T=15.0 + 0.01 * rng.standard_normal(N))


def implicit(pkg, method):
    if method == "fft":
        return pkg.ImplicitFreeSurface()
    # CG agrees with JAX only to rounding: a fixed count of iterations
    return pkg.ImplicitFreeSurface(solver_method=method, maxiter=30,
                                   reltol=0.0)


@pytest.mark.parametrize("method", ["fft", "cg", "matrix"])
@pytest.mark.parametrize("where", ["rectilinear", "latlon"])
def test_implicit_free_surface_matches_jax(method, where):
    """3 steps of 100 s with each method on a (Periodic, Bounded) channel
    and on a lat-lon sector (the "fft" eigenvalues take the grid's extent
    over its size, degrees on the sector, as in JAX)."""
    make = rect_grid if where == "rectilinear" else latlon_grid
    jm = build(oj, make(oj), implicit(j_hyd, method))
    tm = build(ot, make(ot), implicit(ot, method))
    assert tm.free_surface == implicit(ot, method)
    _, ts = run_both(jm, tm, seeded_state(jm, where == "rectilinear"),
                     100.0, 3, eager=True)
    if method != "fft":
        assert int(tm.free_surface_info["iterations"]) == 30
        assert tm.free_surface_info["host_syncs"] == 30 // 4 + 1


def test_implicit_free_surface_options():
    """JAX's surface: the unknown method's ValueError, equality and
    hashing, and "fft" turned into "cg" over bathymetry in both
    packages."""
    with pytest.raises(ValueError, match="solver_method"):
        ot.ImplicitFreeSurface(solver_method="multigrid")
    a, b = ot.ImplicitFreeSurface(), ot.ImplicitFreeSurface()
    assert a == b and hash(a) == hash(b)
    assert a != ot.ImplicitFreeSurface(solver_method="cg")
    assert repr(a) == repr(j_hyd.ImplicitFreeSurface())
    for pkg, xp in ((ot, torch), (oj, jnp)):
        ib = pkg.ImmersedBoundaryGrid(rect_grid(pkg), pkg.GridFittedBottom(
            lambda x, y: -100.0 + 50.0 * xp.exp(-((x - 5e4) / 1e4) ** 2)
            + 0 * y))
        m = pkg.HydrostaticFreeSurfaceModel(
            grid=ib, free_surface=pkg.ImplicitFreeSurface(maxiter=7,
                                                          reltol=1e-6))
        fs = m.free_surface
        assert (fs.solver_method, fs.maxiter, fs.reltol) == ("cg", 7, 1e-6)


# ---------------------------------------------------------------------------
# split_rk3
# ---------------------------------------------------------------------------

def free_surface(pkg, kind):
    if kind == "explicit":
        return pkg.ExplicitFreeSurface()
    if kind == "split_explicit":
        return pkg.SplitExplicitFreeSurface(substeps=10)
    return implicit(pkg, "fft")


@pytest.mark.parametrize("kind", ["explicit", "implicit", "split_explicit"])
def test_split_rk3_matches_jax(kind):
    """2 steps of 50 s of ``split_rk3`` under each free surface: u, v, η,
    the tracer and the barotropic transports (combined in every stage
    under each free surface, as the JAX stepper does where both are
    present) within 1e-12."""
    jm = build(oj, rect_grid(oj), free_surface(j_hyd, kind),
               timestepper="split_rk3")
    tm = build(ot, rect_grid(ot), free_surface(ot, kind),
               timestepper="split_rk3")
    run_both(jm, tm, seeded_state(jm), 50.0, 2, eager=True)


def test_split_rk3_refuses_zstar():
    grid = rect_grid(ot)
    with pytest.raises(ValueError, match="split_rk3"):
        ot.HydrostaticFreeSurfaceModel(grid=grid, timestepper="split_rk3",
                                       vertical_coordinate=ot.ZStar())
    with pytest.raises(ValueError, match="split_rk3"):
        oj.HydrostaticFreeSurfaceModel(grid=rect_grid(oj),
                                       timestepper="split_rk3",
                                       vertical_coordinate=oj.ZStar())


def test_implicit_split_rk3_pickup_is_bitwise(tmp_path):
    """A ``split_rk3`` model with the implicit "matrix" free surface
    through ``Checkpointer``: 4 steps with a checkpoint at 2, and a pickup
    at 2 run to 4, bit for bit."""
    tm = build(ot, rect_grid(ot), ot.ImplicitFreeSurface(
        solver_method="matrix", preconditioner="spai"),
        timestepper="split_rk3")
    s0 = tm.initial_state(eta=lambda x, y: 0.1 * torch.sin(
        2 * torch.pi * x / 1e5) + 0 * y, T=15.0)
    out = []
    for pickup in (False, True):
        sim = ot.Simulation(tm, state=s0, dt=100.0, stop_iteration=4)
        sim.output_writers["ckpt"] = ot.Checkpointer(
            tmp_path, ot.IterationInterval(2))
        sim.run(pickup=pickup)
        out.append(sim.state)
    for n in ("u", "v", "w", "eta", "U", "V"):
        assert torch.equal(getattr(out[0], n), getattr(out[1], n)), n
    assert torch.equal(out[0].tracers["T"], out[1].tracers["T"])
