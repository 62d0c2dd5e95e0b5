"""oceananigans_torch transforms and Poisson solvers against the JAX
package, in float64 on the CPU.

Tolerances: the DCT round trip and every solver comparison hold to atol
1e-12 on O(1) right-hand sides (solutions are O(0.01)); FFT libraries
(pocketfft in both packages here) sum in their own order, which costs a
few ulps, far inside that bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.ops.cuda_poisson import (
    fused_middle_solve, fused_middle_solve_plain,
)
from oceananigans_torch.solvers.transforms import dct2, idct2
from oceananigans_tpu.ops.pallas_poisson import (
    fused_middle_solve as j_fused_middle_solve,
)
from oceananigans_tpu.solvers import transforms as j_transforms
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver as JFFT
from oceananigans_tpu.solvers.matmul_poisson import (
    MatmulPoissonSolver as JMatmul,
)

ATOL = 1e-12
F64 = torch.float64
TOPOLOGIES = {
    "ppb": (oj.Periodic, oj.Periodic, oj.Bounded),
    "pbb": (oj.Periodic, oj.Bounded, oj.Bounded),
    "bpp": (oj.Bounded, oj.Periodic, oj.Periodic),
}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU."""
    old = ot.config.device
    ot.config.device = "cpu"
    yield
    ot.config.device = old


def grids(topo, size=(8, 6, 10)):
    kw = dict(size=size, extent=(1.0, 0.7, 0.5), topology=TOPOLOGIES[topo],
              halo=1)
    return (oj.RectilinearGrid(dtype="float64", **kw),
            ot.RectilinearGrid(dtype=F64, **kw))


def rhs_for(N, seed=1):
    rhs = np.random.default_rng(seed).standard_normal(N)
    return rhs - rhs.mean()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_dct_round_trip_and_parity(axis):
    x = np.random.default_rng(axis).standard_normal((6, 7, 8))
    t = torch.tensor(x, dtype=F64)
    X = dct2(t, axis)
    np.testing.assert_allclose(X.numpy(),
                               np.asarray(j_transforms.dct2(jnp.asarray(x),
                                                            axis)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(idct2(X, axis).numpy(), x, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_fft_solver_matches(topo):
    jg, tg = grids(topo)
    rhs = rhs_for(tg.N)
    ref = np.asarray(JFFT(jg).solve(jnp.asarray(rhs)))
    got = ot.FFTPoissonSolver(tg).solve(torch.tensor(rhs, dtype=F64))
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_matmul_solver_matches(topo):
    jg, tg = grids(topo)
    rhs = rhs_for(tg.N, seed=2)
    ref = np.asarray(JMatmul(jg).solve(jnp.asarray(rhs)))
    solver = ot.MatmulPoissonSolver(tg)
    got = solver.solve(torch.tensor(rhs, dtype=F64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # the fused middle stage (its plain version on the CPU) is the same
    # solve: only the order of the four middle products' sums differs
    solver.fused = True
    fused = solver.solve(torch.tensor(rhs, dtype=F64))
    np.testing.assert_allclose(fused.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [(8, 12, 16), (6, 10, 4)])
def test_fused_middle_plain_matches_jax_kernel(size):
    """The plain version of the Poisson middle kernel against JAX's
    ``fused_middle_solve`` run in interpret mode. JAX's wrapper rounds the
    x eigenvalues to float32 (``pallas_poisson.py:94``), so both sides get
    float32-representable ones; everything else runs in float64."""
    jg, tg = grids("bpp", size)
    js = JMatmul(jg)
    x = np.random.default_rng(4).standard_normal(size)
    lamx = js.lams[0].astype(np.float32).astype(np.float64)
    ref = np.asarray(j_fused_middle_solve(
        jnp.asarray(x), js.T[1], js.T[2], lamx, js.lams[1], js.lams[2],
        interpret=True))
    args = (torch.tensor(x, dtype=F64), torch.tensor(js.T[1], dtype=F64),
            torch.tensor(js.T[2], dtype=F64), torch.tensor(lamx, dtype=F64),
            torch.tensor(js.lams[1], dtype=F64),
            torch.tensor(js.lams[2], dtype=F64))
    np.testing.assert_allclose(fused_middle_solve_plain(*args).numpy(), ref,
                               rtol=0, atol=ATOL)
    before = fused_middle_solve.launches
    np.testing.assert_allclose(fused_middle_solve(*args).numpy(), ref,
                               rtol=0, atol=ATOL)
    assert fused_middle_solve.launches == before   # CPU: no kernel launch


def test_fused_middle_rejects_bad_operands():
    _, tg = grids("bpp")
    s = ot.MatmulPoissonSolver(tg)
    x = torch.zeros(tg.N, dtype=F64)
    with pytest.raises(ValueError):       # eigenvalues must be float64
        fused_middle_solve(x, s.T1, s.T2, s.lam0, s.lam1.float(), s.lam2)
    with pytest.raises(ValueError):
        fused_middle_solve(x, s.T2, s.T1, s.lam0, s.lam1, s.lam2)
    with pytest.raises(TypeError):
        fused_middle_solve(x.to(torch.int64), s.T1, s.T2, s.lam0, s.lam1,
                           s.lam2)


def test_solver_constants_are_buffers():
    _, tg = grids("ppb")
    names = {n for n, _ in ot.MatmulPoissonSolver(tg).named_buffers()}
    assert {"T0", "T1", "T2", "lam0", "lam1", "lam2", "inv_lam"} <= names
    assert "inv_lam" in dict(ot.FFTPoissonSolver(tg).named_buffers())
    assert not torch.backends.cuda.matmul.allow_tf32
