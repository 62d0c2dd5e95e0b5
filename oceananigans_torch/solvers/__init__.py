"""Poisson solvers for the pressure projection, the batched tridiagonal
solve, preconditioned conjugate gradient and the stencil-matrix solver of
the implicit free surface."""

from oceananigans_torch.solvers.conjugate_gradient import conjugate_gradient
from oceananigans_torch.solvers.fft_poisson import (
    FFTPoissonSolver, poisson_eigenvalues,
)
from oceananigans_torch.solvers.fourier_tridiagonal import (
    FourierTridiagonalPoissonSolver,
)
from oceananigans_torch.solvers.matmul_poisson import MatmulPoissonSolver
from oceananigans_torch.solvers.matrix_solver import (
    HeptadiagonalIterativeSolver, StencilMatrix,
)
from oceananigans_torch.solvers.pressure_solver import make_pressure_solver
from oceananigans_torch.solvers.transforms import dct2, idct2
from oceananigans_torch.solvers.tridiagonal import tridiagonal_solve

__all__ = ["FFTPoissonSolver", "FourierTridiagonalPoissonSolver",
           "HeptadiagonalIterativeSolver", "MatmulPoissonSolver",
           "StencilMatrix", "conjugate_gradient", "dct2", "idct2",
           "make_pressure_solver", "poisson_eigenvalues",
           "tridiagonal_solve"]
