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
from oceananigans_torch.solvers.matmul_poisson import (
    _bounded_basis, _periodic_basis,
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
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


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


# ---------------------------------------------------------------------------
# The float32 kernel's arithmetic: 3xTF32 products on the tensor cores
# ---------------------------------------------------------------------------

#: the bound the card holds the float32 kernel to (chip_smoke.py GEMM_RTOL)
GEMM_RTOL = 1e-5


def _tf32(a):
    """float32 values rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` rounds them."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b as ``csrc/poisson_middle.cu`` forms it on the tensor cores:
    for each k-step of 8, the products of TF32 operands added into a float32
    accumulator; one pass (hi·hi) or the 3xTF32 split, hi = TF32(x) and
    lo = TF32(x - hi), as lo·hi + hi·lo + hi·hi."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if passes == 3:
            acc += al[:, s] @ bh[s]
            acc += ah[:, s] @ bl[s]
        acc += ah[:, s] @ bh[s]
    return acc


def _middle_float32(x, Ey, Ez, lamx, lamy, lamz, matmul):
    """The kernel's middle stage in float32 with the given product; λyz is
    summed in float64 and rounded to float32, the zero-sum mode zeroed."""
    f32 = np.float32
    lyz = (lamy[:, None] + lamz[None, :]).astype(f32)
    out = np.empty(x.shape, f32)
    for i in range(x.shape[0]):
        ls = f32(lamx[i]) + lyz
        inv = np.where(ls == 0, f32(0), f32(1) / np.where(ls == 0, f32(1),
                                                          ls))
        S = matmul(matmul(Ey, x[i]), Ez.T) * inv
        out[i] = matmul(Ey.T, matmul(S, Ez))
    return out


@pytest.mark.parametrize("size", [(4, 12, 16), (1, 256, 256)])
def test_tf32x3_middle_stage_keeps_float32_accuracy(size):
    """The 3xTF32 split keeps the float32 kernel within GEMM_RTOL of the
    float64 middle stage with margin (~2e-7 at (4, 12, 16), ~1.1e-6 on one
    256 x 256 plane of DCT and Fourier bases, as plain float32 products
    give ~1.6e-6), where one TF32 pass misses it by ~60x (~6e-4): the
    kernel's float32 path needs all three products."""
    Nx, Ny, Nz = size
    Ey, lamy = _periodic_basis(Ny, 1.0 / Ny)
    Ez, lamz = _periodic_basis(Nz, 0.5 / Nz)
    _, lamx = _bounded_basis(Nx, 1.0 / Nx)
    Ey, Ez, lamx = (a.astype(np.float32) for a in (Ey, Ez, lamx))
    x = np.random.default_rng(5).standard_normal(size).astype(np.float32)
    ref = fused_middle_solve_plain(*(torch.tensor(a, dtype=F64) for a in (
        x, Ey, Ez, lamx, lamy, lamz))).numpy()
    scale = np.abs(ref).max()
    errs = {}
    for passes in (3, 1):
        got = _middle_float32(x, Ey, Ez, lamx, lamy, lamz,
                              lambda a, b: _tf32_matmul(a, b, passes))
        errs[passes] = np.abs(got - ref).max() / scale
    assert errs[3] <= GEMM_RTOL / 4, errs
    assert errs[1] > GEMM_RTOL, f"one TF32 pass would do: {errs}"
