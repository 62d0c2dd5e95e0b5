"""Fused middle stage of the eigenbasis-matmul Poisson solve, as a
hand-written CUDA kernel (``csrc/poisson_middle.cu``) with its plain
PyTorch version.

Counterpart of ``oceananigans_tpu/ops/pallas_poisson.py``. Per x-plane of
the x-transformed right-hand side it applies the forward y and z
transforms, the 1/λ scale and the inverse z and y transforms in one pass;
the x-axis contractions need the full x extent and stay outside. The
wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors through its custom operator (``ops/library.py``: batched
by ``torch.func.vmap`` one launch per member, the bases and eigenvalues
unbatched; ``fused_middle_solve_op`` takes it on either device), and
counts launches in ``fused_middle_solve.launches``.
"""

from __future__ import annotations

import torch

from oceananigans_torch.ops import _build
from oceananigans_torch.ops.cuda_kernels import check_operands, on_cuda
from oceananigans_torch.ops.library import KernelOp


def _inv_lambda(lamx, lamy, lamz, dtype):
    """1/(λx + λyz) with λyz = λy + λz summed in float64, and the mode whose
    sum is exactly 0 (the mean) zeroed."""
    lyz = (lamy[:, None] + lamz[None, :]).to(dtype)
    ls = lamx[:, None, None] + lyz[None]
    return torch.where(ls == 0, torch.zeros_like(ls),
                       1.0 / torch.where(ls == 0, torch.ones_like(ls), ls))


def fused_middle_solve_plain(x, Ey, Ez, lamx, lamy, lamz):
    """Plain version of :func:`fused_middle_solve`: four batched products
    around the materialised 1/λ table."""
    Zf = torch.matmul(torch.matmul(Ey, x), Ez.T)
    Zs = Zf * _inv_lambda(lamx, lamy, lamz, x.dtype)
    return torch.matmul(Ey.T, torch.matmul(Zs, Ez))


def fused_middle_solve(x, Ey, Ez, lamx, lamy, lamz):
    """Apply Eyᵀ·(Ey·M·Ezᵀ ⊙ λ⁻¹)·Ez to each x-plane M of ``x``.

    ``x``: the x-transformed right-hand side, (Nx, Ny, Nz); ``Ey``/``Ez``:
    the orthonormal basis-row matrices, (Ny, Ny) and (Nz, Nz), in x's
    dtype; ``lamx``: (Nx,) eigenvalues in x's dtype; ``lamy``/``lamz``:
    (Ny,) and (Nz,) eigenvalues in float64. Returns the scaled array, still
    in x-spectral space.
    """
    name = "fused_middle_solve"
    Nx, Ny, Nz = x.shape
    check_operands(name, (x,), (Nx, Ny, Nz))
    for t, shape, dtype in ((Ey, (Ny, Ny), x.dtype), (Ez, (Nz, Nz), x.dtype),
                            (lamx, (Nx,), x.dtype),
                            (lamy, (Ny,), torch.float64),
                            (lamz, (Nz,), torch.float64)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operand of shape {tuple(t.shape)}, {t.dtype} on "
                f"{t.device} does not match {shape}, {dtype} on {x.device}")
    if not on_cuda(x):
        return fused_middle_solve_plain(x, Ey, Ez, lamx, lamy, lamz)
    return fused_middle_solve_op(x, Ey, Ez, lamx, lamy, lamz)


def _launch_middle(fields, state, ints, floats):
    x = fields[0]
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    _build.launch("ot_poisson_middle", x.dtype, x.device,
                  x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  *(t.data_ptr() for t in fields[1:]), *x.shape)
    fused_middle_solve.launches += 1
    return [out]


MIDDLE = KernelOp("poisson_middle", _launch_middle)


def fused_middle_solve_op(x, Ey, Ez, lamx, lamy, lamz):
    """:func:`fused_middle_solve` through its operator, on either
    device."""
    return MIDDLE(lambda f, s: [fused_middle_solve_plain(*f)],
                  (x, Ey, Ez, lamx, lamy, lamz))[0]


fused_middle_solve.launches = 0

__all__ = ["fused_middle_solve", "fused_middle_solve_op",
           "fused_middle_solve_plain"]
