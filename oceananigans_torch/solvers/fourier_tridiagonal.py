"""Fourier-tridiagonal Poisson solver: FFT/DCT in x and y, a tridiagonal
solve in a (possibly stretched) z.

Counterpart of ``oceananigans_tpu/solvers/fourier_tridiagonal.py``. Each
horizontal mode (kx, ky) gives an independent tridiagonal system in z,
exact for the finite-volume operator on a stretched z; the column of the
zero horizontal eigenvalue is singular (pure Neumann), so its mean is
projected out and its first level pinned, and the result takes the
volume-mean gauge of the FFT solver.

Three departures from the JAX solver, none of which changes a value beyond
rounding:

- the first periodic axis takes a real FFT, as in ``fft_poisson.py``;
- the Thomas recurrence of the coefficients (``c'`` and the pivots) does
  not depend on the right-hand side, so it runs once, at construction;
  a solve runs only the right-hand side's recurrence and the back
  substitution;
- the JAX solver solves the real and the imaginary parts of the
  transformed right-hand side as two real systems. The coefficients are
  real, so here both run as one real solve over ``torch.view_as_real`` of
  the complex tensor, whose trailing axis of two holds them: every
  element sees the same operations as in two separate solves (bit for bit,
  ``tests/test_torch_stretched.py``), at half the launches.

The solve runs level by level in a Python loop with z moved to the
leading axis, so each level is a contiguous plane: five small kernels a
level on a GPU (three forward, two back).
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.grids.base import Bounded, Flat, Periodic
from oceananigans_torch.solvers.fft_poisson import poisson_eigenvalues
from oceananigans_torch.solvers.transforms import dct2, idct2


def thomas_factors(a, b, c):
    """The right-hand-side-free part of the Thomas recurrence down the
    leading axis of ``b`` (``a`` and ``c`` broadcast against it):
    ``(pivots, c')`` with pivot[k] = b[k] − a[k] c'[k−1] and c'[k] =
    c[k] / pivot[k], the operations and order of ``tridiagonal_solve``."""
    n = b.shape[0]
    pivots, cps = [], []
    cp = torch.zeros((), dtype=b.dtype, device=b.device)
    for k in range(n):
        ak = a[k] if a.shape[0] > 1 else a[0]
        denom = b[k] - ak * cp
        cp = (c[k] if c.shape[0] > 1 else c[0]) / denom
        pivots.append(denom.expand(b.shape[1:]))
        cps.append(cp.expand(b.shape[1:]))
    return torch.stack(pivots), torch.stack(cps)


def thomas_solve_(a, pivots, cps, d):
    """Solve in place down the leading axis of ``d`` with the factors of
    :func:`thomas_factors`: d'[k] = (d[k] − a[k] d'[k−1]) / pivot[k], then
    x[k] = d'[k] − c'[k] x[k+1], each level's result written over d[k].
    ``pivots`` and ``cps`` broadcast against ``d``'s levels. Returns
    ``d``."""
    n = d.shape[0]
    d[0].div_(pivots[0])
    for k in range(1, n):
        ak = a[k] if a.shape[0] > 1 else a[0]
        d[k].sub_(ak * d[k - 1])
        d[k].div_(pivots[k])
    for k in range(n - 2, -1, -1):
        d[k].sub_(cps[k] * d[k + 1])
    return d


class FourierTridiagonalPoissonSolver(torch.nn.Module):
    """∇²φ = rhs on a grid regular in x and y, with any z; takes and
    returns interior-shaped tensors. The eigenvalues, vertical
    coefficients and Thomas factors are buffers in the grid's dtype."""

    def __init__(self, grid):
        super().__init__()
        if not (grid.x_regular and grid.y_regular):
            raise ValueError("x and y must be regular (stretched handled "
                             "only in z)")
        self.Nz = grid.N[2]
        self.fft_axes, self.dct_axes = [], []
        lams = []
        for axis in (0, 1):
            topo = grid.axis_topo(axis)
            d = ((grid.Lx / grid.N[0], grid.Ly / grid.N[1])[axis]
                 if topo != Flat else 1.0)
            lam = poisson_eigenvalues(grid.N[axis], d, topo)
            shape = [1, 1, 1]
            shape[axis] = lam.shape[0]
            lams.append(lam.reshape(shape))
            if topo == Periodic:
                self.fft_axes.append(axis)
            elif topo == Bounded:
                self.dct_axes.append(axis)
        self.rfft_axis = self.fft_axes[0] if self.fft_axes else None
        self.cfft_axes = self.fft_axes[1:]
        if self.rfft_axis is not None:
            ax = self.rfft_axis
            lams[ax] = lams[ax].take(np.arange(grid.N[ax] // 2 + 1), axis=ax)
        lam_h = lams[0] + lams[1]                  # (nx', ny', 1)

        # vertical finite-volume coefficients from the interior spacings:
        # dzf[k] is the distance between centers k − 1 and k
        Hz, Nz = grid.H[2], grid.N[2]
        dzc = grid.dz("c").detach().cpu().double().numpy().reshape(-1)
        dzf = grid.dz("f").detach().cpu().double().numpy().reshape(-1)
        dzc = dzc[Hz:Hz + Nz]
        dzf = dzf[Hz:Hz + Nz + 1]
        a = np.zeros(Nz)
        c = np.zeros(Nz)
        a[1:] = 1.0 / dzf[1:Nz]
        c[:-1] = 1.0 / dzf[1:Nz]

        def t(x):
            return torch.as_tensor(x, dtype=grid.dtype, device=grid.device)

        # the operations of the JAX solve, in the grid's dtype
        lam_t = t(lam_h)
        az, cz, dzc_t = (t(v.reshape(1, 1, Nz)) for v in (a, c, dzc))
        b = -(az + cz) + lam_t * dzc_t
        singular = lam_t == 0
        k0 = (torch.arange(Nz, device=grid.device) == 0).reshape(1, 1, Nz)
        b = torch.where(singular & k0, 1.0, b)
        czs = torch.where(singular & k0, 0.0, cz)
        # Thomas factors with z leading, a trailing axis of 1 broadcasting
        # over the real and imaginary parts
        a_z = az.reshape(Nz, 1, 1, 1)
        pivots, cps = thomas_factors(
            a_z, b.permute(2, 0, 1).unsqueeze(-1).contiguous(),
            czs.permute(2, 0, 1).unsqueeze(-1).expand(
                Nz, *b.shape[:2], 1))
        self.register_buffer("a_z", a_z)
        self.register_buffer("pivots", pivots.contiguous())
        self.register_buffer("cps", cps.contiguous())
        self.register_buffer("dzc", dzc_t)
        self.register_buffer("singular_col", singular)
        self.register_buffer("k0", k0)

    def solve(self, rhs):
        """rhs: interior-shaped (Nx, Ny, Nz) tensor -> φ with zero volume
        mean."""
        dtype = rhs.dtype
        x = rhs
        for axis in self.dct_axes:
            x = dct2(x, axis)
        if self.rfft_axis is not None:
            n_full = x.shape[self.rfft_axis]
            x = torch.fft.rfft(x, dim=self.rfft_axis)
        for axis in self.cfft_axes:
            x = torch.fft.fft(x, dim=axis)
        dzc = self.dzc
        # project the nullspace out of the singular column, so the pure
        # Neumann system is exactly compatible; then pin its first level
        col_mean = torch.sum(x * dzc, dim=2, keepdim=True) / torch.sum(dzc)
        x = torch.where(self.singular_col, x - col_mean, x)
        d = x * dzc
        d = torch.where(self.singular_col & self.k0, 0.0, d)

        dz_first = d.permute(2, 0, 1).contiguous()
        view = (torch.view_as_real(dz_first) if dz_first.is_complex()
                else dz_first.unsqueeze(-1))
        thomas_solve_(self.a_z, self.pivots, self.cps, view)
        phi = dz_first.permute(1, 2, 0)

        for axis in self.cfft_axes:
            phi = torch.fft.ifft(phi, dim=axis)
        if self.rfft_axis is not None:
            phi = torch.fft.irfft(phi, n=n_full, dim=self.rfft_axis)
        phi = torch.real(phi)
        for axis in self.dct_axes:
            phi = idct2(phi, axis)
        # remove the volume mean (the FFT solver's gauge)
        w = dzc / torch.sum(dzc)
        mean = torch.sum(torch.mean(phi, dim=(0, 1), keepdim=True) * w)
        return (phi - mean).to(dtype)


__all__ = ["FourierTridiagonalPoissonSolver", "thomas_factors",
           "thomas_solve_"]
