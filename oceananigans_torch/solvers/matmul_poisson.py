"""Poisson solver with the transforms written as dense matrix products.

Counterpart of ``oceananigans_tpu/solvers/matmul_poisson.py``. Each axis is
transformed by an orthonormal real basis of 1-D Laplacian eigenvectors
(DCT-II rows on Bounded axes, the real Fourier cos/sin rows on Periodic
axes), so the inverse transform is the transpose and everything stays
real: six contractions and one elementwise scale.

The JAX package made this the accelerator default for TPU reasons. On the
GPU the FFT solver is the default (see ``pressure_solver.py``); this one
stays selectable, and with ``fused = True`` its middle four contractions
and the scale run as one hand-written kernel (``ops/cuda_poisson.py``).
All products run in full float32 or float64: TF32 is switched off.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.grids.base import (
    Bounded, Connected, Flat, Periodic,
)
from oceananigans_torch.ops.cuda_poisson import fused_middle_solve


def _bounded_basis(N, d):
    """Orthonormal DCT-II rows T[k, i] and the staggered-grid Laplacian
    eigenvalues (Neumann): λ_k = -(2/d²)(1 - cos(πk/N))."""
    i = np.arange(N)
    k = np.arange(N)[:, None]
    T = np.cos(np.pi * (i[None, :] + 0.5) * k / N) * np.sqrt(2.0 / N)
    T[0] /= np.sqrt(2.0)
    lam = -(2.0 / d ** 2) * (1.0 - np.cos(np.pi * np.arange(N) / N))
    return T, lam


def _periodic_basis(N, d):
    """Orthonormal real-Fourier rows (const, cos k, sin k, Nyquist) and
    the periodic Laplacian eigenvalues λ = -(2/d²)(1 - cos(2πk/N)); the
    cos and sin rows share λ_k."""
    i = np.arange(N)
    rows = [np.full(N, 1.0 / np.sqrt(N))]
    lam = [0.0]

    def lam_k(k):
        return -(2.0 / d ** 2) * (1.0 - np.cos(2.0 * np.pi * k / N))

    for k in range(1, N // 2):
        rows.append(np.sqrt(2.0 / N) * np.cos(2 * np.pi * k * i / N))
        lam.append(lam_k(k))
        rows.append(np.sqrt(2.0 / N) * np.sin(2 * np.pi * k * i / N))
        lam.append(lam_k(k))
    if N % 2 == 0 and N > 1:
        rows.append(np.cos(np.pi * i) / np.sqrt(N))
        lam.append(lam_k(N // 2))
    return np.stack(rows), np.asarray(lam)


_SUBSCRIPTS = ("ai,ijk->ajk", "aj,ijk->iak", "ak,ijk->ija")


def _product(T, x, axis, transpose):
    """``x`` transformed along ``axis`` by the basis ``T`` (by its
    transpose, the inverse, where ``transpose``); ``x`` itself where ``T``
    is None (a Flat axis)."""
    if T is None:
        return x
    return torch.einsum(_SUBSCRIPTS[axis], T.T if transpose else T, x)


class MatmulPoissonSolver(torch.nn.Module):
    """∇²φ = rhs by per-axis orthonormal eigenbasis products; takes and
    returns interior-shaped tensors (a drop-in for ``FFTPoissonSolver``).

    Buffers: the bases ``T0``/``T1``/``T2`` (None on a Flat axis), the
    per-axis eigenvalues ``lam0``/``lam1``/``lam2`` in float64, and the
    reciprocal eigenvalue table ``inv_lam`` in the grid's dtype.
    """

    def __init__(self, grid, fused=False):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        lams = []
        for axis in range(3):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            T = None
            lam = np.zeros(1)
            if topo != Flat and N > 1:
                d = grid.spacing(axis)
                if topo == Periodic:
                    T, lam = _periodic_basis(N, d)
                elif topo == Bounded:
                    T, lam = _bounded_basis(N, d)
                else:
                    raise ValueError(f"unsupported topology {topo}")
            self.register_buffer(f"T{axis}", None if T is None else
                                 torch.as_tensor(T, dtype=grid.dtype,
                                                 device=grid.device))
            self.register_buffer(f"lam{axis}", torch.as_tensor(
                lam, dtype=torch.float64, device=grid.device))
            lams.append(lam)
        lam_sum = (lams[0][:, None, None] + lams[1][None, :, None]
                   + lams[2][None, None, :])
        inv_lam = np.where(lam_sum == 0, 0.0,
                           1.0 / np.where(lam_sum == 0, 1.0, lam_sum))
        self.register_buffer("inv_lam", torch.as_tensor(
            inv_lam, dtype=grid.dtype, device=grid.device))
        #: run the middle four products and the 1/λ scale as one kernel
        #: (``ops/cuda_poisson.fused_middle_solve``); off by default, as
        #: in the JAX package
        self.fused = fused

    def _apply(self, x, axis, transpose):
        return _product(getattr(self, f"T{axis}"), x, axis, transpose)

    def solve(self, rhs):
        """rhs: interior-shaped (Nx, Ny, Nz) -> φ with zero mean."""
        if self.fused:
            if self.T1 is None or self.T2 is None:
                raise ValueError("the fused middle solve needs non-flat "
                                 "y and z axes")
            x = self._apply(rhs, 0, transpose=False)
            x = fused_middle_solve(x, self.T1, self.T2,
                                   self.lam0.to(rhs.dtype), self.lam1,
                                   self.lam2)
            return self._apply(x, 0, transpose=True)
        x = rhs
        for axis in range(3):
            x = self._apply(x, axis, transpose=False)
        x = x * self.inv_lam
        for axis in range(3):
            x = self._apply(x, axis, transpose=True)
        return x


class MatmulHorizontalBasis(torch.nn.Module):
    """The horizontal eigen-transform of the implicit free surface's
    Helmholtz solve as matrix products, as the JAX package builds it for
    its TPU backend (the port's "fft" method solves through cuFFT and takes
    no basis): :meth:`forward` and :meth:`inverse` transform the first two
    axes of an interior-shaped ``(Nx, Ny, 1)`` tensor, and ``lam2d`` holds
    the horizontal Laplacian's eigenvalues, ``(Nx, Ny, 1)`` in float64.

    Buffers: the bases ``T0`` and ``T1`` (None on a Flat axis or one of a
    single cell) in the grid's dtype."""

    def __init__(self, grid):
        super().__init__()
        lams = []
        for axis in (0, 1):
            topo = grid.axis_topo(axis)
            N = grid.N[axis]
            T = None
            lam = np.zeros(max(N, 1))
            if topo != Flat and N > 1:
                d = (grid.Lx / grid.Nx, grid.Ly / grid.Ny)[axis]
                if topo in (Periodic, Connected):
                    T, lam = _periodic_basis(N, d)
                elif topo == Bounded:
                    T, lam = _bounded_basis(N, d)
                else:
                    raise ValueError(f"unsupported topology {topo}")
            self.register_buffer(f"T{axis}", None if T is None else
                                 torch.as_tensor(T, dtype=grid.dtype,
                                                 device=grid.device))
            lams.append(lam)
        self.register_buffer("lam2d", torch.as_tensor(
            lams[0][:, None, None] + lams[1][None, :, None],
            dtype=torch.float64, device=grid.device))

    def forward(self, x):
        return _product(self.T1, _product(self.T0, x, 0, False), 1, False)

    def inverse(self, x):
        return _product(self.T1, _product(self.T0, x, 0, True), 1, True)


__all__ = ["MatmulHorizontalBasis", "MatmulPoissonSolver"]
