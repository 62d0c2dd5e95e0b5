"""Distributed pencil-transpose Poisson solvers.

Counterpart of ``oceananigans_tpu/parallel/distributed_fft.py``: transform
z (local), transpose z→y, transform y, transpose y→x, transform x, divide
by the eigenvalues, and back; the transposes are ``all_to_all_single``
calls over the ranks of one mesh row or column
(:meth:`~oceananigans_torch.parallel.distributed.Distributed.all_to_all`),
where the JAX package has ``jax.lax.all_to_all`` inside ``shard_map``.
Every pencil is cut into blocks that differ by at most one cell
(:func:`~oceananigans_torch.parallel.distributed.block_sizes`), so any
interior size goes through; uneven cuts take the split sizes of
``all_to_all_single``, and each rank takes the eigenvalues of its own
slice.

The transforms are products with the orthonormal bases of the serial
``MatmulPoissonSolver`` (real-Fourier rows on Periodic axes, DCT-II rows
on Bounded ones), as in the JAX package: all-real, right on any topology
mix. They are ``torch.einsum`` products (a matmul), not kernels of this
package; their caller keeps TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) so that float32 runs
multiply in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.grids.base import Bounded, Flat, Periodic
from oceananigans_torch.parallel.distributed import (
    Distributed, block_offsets, block_sizes,
)
from oceananigans_torch.solvers.matmul_poisson import (
    _bounded_basis, _periodic_basis,
)
from oceananigans_torch.solvers.tridiagonal import tridiagonal_solve

__all__ = ["DistributedFFTPoissonSolver",
           "DistributedFourierTridiagonalSolver"]

_SUBSCRIPTS = ("ai,ijk->ajk", "aj,ijk->iak", "ak,ijk->ija")


def _basis(grid, axis):
    """The orthonormal basis rows and the eigenvalues of ``axis`` (None
    and zeros on a Flat axis or one of one cell)."""
    topo = grid.axis_topo(axis)
    N = grid.N[axis]
    if topo == Flat or N == 1:
        return None, np.zeros((1,))
    d = (grid.Lx, grid.Ly, grid.Lz)[axis] / N
    if topo == Periodic:
        return _periodic_basis(N, d)
    if topo == Bounded:
        return _bounded_basis(N, d)
    raise ValueError(f"unsupported topology {topo} on a distributed axis")


def _apply(a, T, axis, transpose):
    if T is None:
        return a
    return torch.einsum(_SUBSCRIPTS[axis], T.T if transpose else T, a)


class DistributedFFTPoissonSolver(torch.nn.Module):
    """∇²φ = rhs on a fully regular grid; ``rhs`` is this rank's interior
    block ``(nx[rx], ny[ry], Nz)`` (``block_sizes`` of Nx over px and Ny
    over py).

    Pencils (local shapes, mesh (px, py); ``a/p`` a block of ``a`` cut
    into p):
        (Nx/px, Ny/py, Nz)  --Tz (local)-->  same
        --all_to_all over y (split z, join y)--> (Nx/px, Ny, Nz/py)
        --Ty--> --all_to_all over x (split y, join x)--> (Nx, Ny/px, Nz/py)
        --Tx--> divide by the eigenvalues --> everything in reverse.
    """

    def __init__(self, grid, dist: Distributed):
        super().__init__()
        if not grid.regular:
            raise ValueError("needs regular spacings on every axis")
        self.grid = grid
        self.dist = dist
        self.px, self.py = dist.partition
        Nx, Ny, Nz = grid.N
        #: the blocks of x and y (the interiors), of z over the y ranks and
        #: of y over the x ranks (the pencils)
        self.nx, self.ny = block_sizes(Nx, self.px), block_sizes(Ny, self.py)
        self.nz_p, self.ny_p = (block_sizes(Nz, self.py),
                                block_sizes(Ny, self.px))
        self.topo = tuple(grid.axis_topo(ax) for ax in range(3))
        dtype, device = grid.dtype, dist.device
        self.T = []
        lams = []
        for axis in range(3):
            T, lam = _basis(grid, axis)
            self.T.append(None if T is None else torch.as_tensor(
                T, dtype=dtype, device=device))
            lams.append(lam)
        lam_x, lam_y, lam_z = lams
        # this rank's eigenvalues in the (Nx, Ny/px, Nz/py) pencil, formed
        # in float64 and cast once
        ix, iy = dist.coords
        oy, oz = block_offsets(self.ny_p)[ix], block_offsets(self.nz_p)[iy]
        ly = (lam_y[oy:oy + self.ny_p[ix]] if lam_y.size > 1 else lam_y)
        lz = (lam_z[oz:oz + self.nz_p[iy]] if lam_z.size > 1 else lam_z)
        lam = (lam_x.reshape(-1, 1, 1) + ly.reshape(1, -1, 1)
               + lz.reshape(1, 1, -1))
        inv = np.where(lam == 0, 0.0, 1.0 / np.where(lam == 0, 1.0, lam))
        self.inv = torch.as_tensor(inv, dtype=dtype, device=device)

    def local_solve(self, r):
        """The solve of this rank's interior block ``r``; every rank calls
        it together (the preconditioner of a distributed CG calls it
        inside the CG)."""
        dist = self.dist
        Tx, Ty, Tz = self.T
        nx, ny, nz_p, ny_p = self.nx, self.ny, self.nz_p, self.ny_p
        r = _apply(r, Tz, 2, False)
        r = dist.all_to_all(r, 1, split_axis=2, concat_axis=1,
                            split_sizes=nz_p, concat_sizes=ny)
        r = _apply(r, Ty, 1, False)
        r = dist.all_to_all(r, 0, split_axis=1, concat_axis=0,
                            split_sizes=ny_p, concat_sizes=nx)
        r = _apply(r, Tx, 0, False)
        r = r * self.inv.to(r.dtype)
        r = _apply(r, Tx, 0, True)
        r = dist.all_to_all(r, 0, split_axis=0, concat_axis=1,
                            split_sizes=nx, concat_sizes=ny_p)
        r = _apply(r, Ty, 1, True)
        r = dist.all_to_all(r, 1, split_axis=1, concat_axis=2,
                            split_sizes=ny, concat_sizes=nz_p)
        return _apply(r, Tz, 2, True)

    def solve(self, rhs):
        """φ (zero mean) of this rank's interior block ``rhs``."""
        return self.local_solve(rhs).to(rhs.dtype)


class DistributedFourierTridiagonalSolver(torch.nn.Module):
    """∇²φ = rhs with a STRETCHED z over an (x, y) mesh: the horizontal
    basis products through pencil transposes that keep the FULL z column on
    every rank, then a batched Thomas solve for each horizontal mode, as
    the serial ``FourierTridiagonalPoissonSolver``.

    Pencils (local shapes, mesh (px, py); ``a/p`` a block of ``a`` cut
    into p):
        (Nx/px, Ny/py, Nz)
        --all_to_all over y (split x, join y)--> (Nx/px/py, Ny, Nz)
        --Ty--> --back-->
        --all_to_all over x (split y, join x)--> (Nx, Ny/py/px, Nz)
        --Tx--> tridiagonal in z --> everything in reverse.
    """

    def __init__(self, grid, dist: Distributed):
        super().__init__()
        if not (grid.x_regular and grid.y_regular):
            raise ValueError("x and y must be regular")
        if grid.axis_topo(2) != Bounded:
            raise ValueError("z must be Bounded (stretched allowed)")
        self.grid = grid
        self.dist = dist
        self.px, self.py = dist.partition
        Nx, Ny, Nz = grid.N
        ix, iy = dist.coords
        #: the interiors' blocks, this rank's x block over the y ranks and
        #: its y block over the x ranks
        self.nx, self.ny = block_sizes(Nx, self.px), block_sizes(Ny, self.py)
        self.nx_p = block_sizes(self.nx[ix], self.py)
        self.ny_p = block_sizes(self.ny[iy], self.px)
        dtype, device = grid.dtype, dist.device
        self.T = []
        lams = []
        for axis in (0, 1):
            T, lam = _basis(grid, axis)
            self.T.append(None if T is None else torch.as_tensor(
                T, dtype=dtype, device=device))
            lams.append(lam)
        lam_x, lam_y = lams
        # the vertical finite-volume coefficients, as the serial solver's
        Hz = grid.H[2]
        dzc = grid.dz("c").detach().cpu().double().numpy().reshape(-1)
        dzf = grid.dz("f").detach().cpu().double().numpy().reshape(-1)
        dzc = dzc[Hz:Hz + Nz]
        dzf = dzf[Hz:Hz + Nz + 1]
        a = np.zeros(Nz)
        c = np.zeros(Nz)
        a[1:] = 1.0 / dzf[1:Nz]
        c[:-1] = 1.0 / dzf[1:Nz]
        # this rank's modes in the (Nx, Ny/py/px, Nz) pencil
        off_y = block_offsets(self.ny)[iy] + block_offsets(self.ny_p)[ix]
        ny_ll = self.ny_p[ix]
        ly = (lam_y[off_y:off_y + ny_ll] if lam_y.size > 1 else lam_y)

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        lam_h = t(lam_x.reshape(-1, 1, 1) + ly.reshape(1, -1, 1))
        self.az, self.cz, self.dzc = (t(v.reshape(1, 1, Nz))
                                      for v in (a, c, dzc))
        b = -(self.az + self.cz) + lam_h * self.dzc
        self.singular = lam_h == 0
        k0 = (torch.arange(Nz, device=device) == 0).reshape(1, 1, Nz)
        self.pin = self.singular & k0
        self.b = torch.where(self.pin, 1.0, b)
        self.czs = torch.where(self.pin, 0.0, self.cz)

    def solve(self, rhs):
        """φ (zero volume mean) of this rank's interior block ``rhs``."""
        dist = self.dist
        Tx, Ty = self.T
        rdt = rhs.dtype
        nx, ny, nx_p, ny_p = self.nx, self.ny, self.nx_p, self.ny_p
        r = dist.all_to_all(rhs, 1, split_axis=0, concat_axis=1,
                            split_sizes=nx_p, concat_sizes=ny)
        r = _apply(r, Ty, 1, False)
        r = dist.all_to_all(r, 1, split_axis=1, concat_axis=0,
                            split_sizes=ny, concat_sizes=nx_p)
        r = dist.all_to_all(r, 0, split_axis=1, concat_axis=0,
                            split_sizes=ny_p, concat_sizes=nx)
        r = _apply(r, Tx, 0, False)
        dzc = self.dzc
        col_mean = torch.sum(r * dzc, dim=2, keepdim=True) / torch.sum(dzc)
        r = torch.where(self.singular, r - col_mean, r)
        d = torch.where(self.pin, 0.0, r * dzc)
        phi = tridiagonal_solve(self.az, self.b, self.czs, d, axis=2)
        phi = _apply(phi, Tx, 0, True)
        phi = dist.all_to_all(phi, 0, split_axis=0, concat_axis=1,
                              split_sizes=nx, concat_sizes=ny_p)
        phi = dist.all_to_all(phi, 1, split_axis=0, concat_axis=1,
                              split_sizes=nx_p, concat_sizes=ny)
        phi = _apply(phi, Ty, 1, True)
        phi = dist.all_to_all(phi, 1, split_axis=1, concat_axis=0,
                              split_sizes=ny, concat_sizes=nx_p)
        # the volume mean (the gauge), over every rank: each rank's sum
        # over its cells, divided by the global count
        w = dzc / torch.sum(dzc)
        local = torch.sum(torch.sum(phi, dim=(0, 1), keepdim=True) * w)
        gmean = dist.all_reduce(local) / (self.grid.N[0] * self.grid.N[1])
        return (phi - gmean).to(rdt)
