"""An explicit stencil-matrix (hepta- or pentadiagonal) iterative solver.

Counterpart of ``oceananigans_tpu/solvers/matrix_solver.py``: the seven
diagonals are dense per-cell coefficient tensors and the matrix-vector
product is seven shifted multiply-adds (``torch.roll`` with the wrapped
slice zeroed on a wall axis); no sparse format. The preconditioner is the
inverse diagonal (Jacobi) or a truncated Neumann series of it, on the
port's conjugate gradient (``solvers/conjugate_gradient.py``).
"""

from __future__ import annotations

import torch

from oceananigans_torch.solvers.conjugate_gradient import conjugate_gradient

__all__ = ["HeptadiagonalIterativeSolver", "StencilMatrix"]


def _shift(a, off, axis, periodic):
    """``a`` shifted so that result[i] = a[i + off] along ``axis``; on a
    non-periodic axis zeros come in where the roll wraps."""
    out = torch.roll(a, -off, axis)
    if not periodic:
        n = a.shape[axis]
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(n - off, n) if off > 0 else slice(0, -off)
        out[tuple(idx)] = 0.0
    return out


class StencilMatrix:
    """A symmetric 7-diagonal operator on (nx, ny, nz) tensors:

        (A x)[ijk] = extra[ijk] x[ijk]
                   + ax[i+1] (x[i+1] − x[i]) − ax[i] (x[i] − x[i−1])
                   + (the same in y with ay and in z with az)

    from the face conductances ``ax``, ``ay``, ``az`` (zero on walls) and
    a cell term ``extra``; symmetric by construction, so CG applies."""

    def __init__(self, ax=None, ay=None, az=None, extra=0.0,
                 periodic=(False, False, False)):
        self.ax, self.ay, self.az = ax, ay, az
        self.extra = extra
        self.periodic = tuple(periodic)

    def _faces(self):
        return ((a, axis) for axis, a in enumerate((self.ax, self.ay,
                                                    self.az))
                if a is not None)

    def diagonal(self):
        d = torch.zeros_like(next(a for a, _ in self._faces()))
        for a, axis in self._faces():
            d = d - a - _shift(a, 1, axis, self.periodic[axis])
        return d + self.extra

    def __call__(self, x):
        out = x * self.extra
        for a, axis in self._faces():
            per = self.periodic[axis]
            xp = _shift(x, 1, axis, per)
            xm = _shift(x, -1, axis, per)
            ap = _shift(a, 1, axis, per)
            out = out + ap * (xp - x) - a * (x - xm)
        return out


class HeptadiagonalIterativeSolver:
    """Preconditioned CG on a :class:`StencilMatrix`.

    ``preconditioner``: ``"jacobi"`` (the inverse diagonal), or ``"spai"``
    or an int k ≥ 1: the truncated Neumann series
    M = (I + N + … + N^k) D⁻¹ with N = I − D⁻¹A, applied as k more stencil
    products (``"spai"`` is k = 2)."""

    def __init__(self, matrix: StencilMatrix, maxiter=500, reltol=1e-10,
                 preconditioner="jacobi"):
        self.matrix = matrix
        self.maxiter = maxiter
        self.reltol = reltol
        d = matrix.diagonal()
        self._inv_diag = torch.where(
            d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)
        if preconditioner == "spai":
            preconditioner = 2
        self._poly_degree = (int(preconditioner)
                             if not isinstance(preconditioner, str) else 0)
        #: the last solve's host reads of the convergence flag
        self.host_syncs = 0

    def _precondition(self, r):
        y = r * self._inv_diag
        for _ in range(self._poly_degree):
            # y ← D⁻¹ r + (I − D⁻¹A) y, the Horner form of Σ N^j D⁻¹ r
            y = r * self._inv_diag + y - self.matrix(y) * self._inv_diag
        return y

    def solve(self, b, x0=None):
        """``(x, iterations, residual_norm)`` of A x = b from ``x0``
        (zeros by default); the last two are 0-d tensors on b's device."""
        x0 = torch.zeros_like(b) if x0 is None else x0
        info = {}
        out = conjugate_gradient(self.matrix, b, x0,
                                 preconditioner=self._precondition,
                                 maxiter=self.maxiter, reltol=self.reltol,
                                 info=info)
        self.host_syncs = info["host_syncs"]
        return out
