"""Pressure-solver selection.

Counterpart of ``oceananigans_tpu/solvers/pressure_solver.py``: an
immersed grid takes the preconditioned conjugate-gradient
``ImmersedPoissonSolver``; a fully regular grid the FFT solver; a grid
stretched in z alone the ``FourierTridiagonalPoissonSolver``; a stretched x
or y raises, as in the JAX package. On a regular grid the JAX package picks
the matmul solver on any accelerator for two reasons that hold only on a
TPU: its FFT chain miscompiles there, and the matrix unit makes dense
transforms cheap. Neither holds on a GPU, where cuFFT is exact and
O(N log N), so the FFT solver serves the CPU and the GPU alike and both
run the same solver. ``MatmulPoissonSolver`` stays selectable by hand
(``model.pressure_solver = MatmulPoissonSolver(grid, fused=True)``).
"""

from __future__ import annotations

from oceananigans_torch.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_torch.solvers.fourier_tridiagonal import (
    FourierTridiagonalPoissonSolver,
)


def make_pressure_solver(grid):
    from oceananigans_torch.immersed import (
        ImmersedBoundaryGrid, ImmersedPoissonSolver,
    )
    if isinstance(grid, ImmersedBoundaryGrid):
        return ImmersedPoissonSolver(grid)
    if grid.regular:
        return FFTPoissonSolver(grid)
    if grid.x_regular and grid.y_regular:
        return FourierTridiagonalPoissonSolver(grid)
    raise NotImplementedError(
        "stretched x/y directions need the conjugate-gradient Poisson path")


__all__ = ["make_pressure_solver"]
