"""Batched tridiagonal (Thomas) solve along one axis.

Counterpart of ``oceananigans_tpu/solvers/tridiagonal.py``, with the same
elimination order, so float64 results agree to rounding. The batch (every
column across the other axes) advances one level per iteration of a Python
loop over the solve axis. The coefficients keep their own broadcast shapes:
coefficients that depend on the level alone (a constant diffusivity on a
regular grid) run their recurrence on one value a level, and only the
right-hand side's recurrence runs on whole planes. Each operation is
elementwise, so the values equal those of the fully broadcast solve.

This is plain PyTorch: a solve of ``n`` levels launches about nine small
kernels a level on a GPU.
"""

from __future__ import annotations

import torch


def tridiagonal_solve(a, b, c, d, axis: int = -1):
    """Solve ``a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k]`` along ``axis``.

    ``a``/``b``/``c``/``d`` are tensors (or numbers) that broadcast against
    each other; ``a[0]`` and ``c[n-1]`` are ignored. Returns ``x`` with the
    broadcast shape."""
    ts = [torch.as_tensor(t) for t in (a, b, c, d)]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    nd = len(shape)
    axis %= nd
    n = shape[axis]
    # each operand at full rank with the solve axis first, size-1 axes kept
    a_, b_, c_, d_ = (torch.movedim(t.reshape((1,) * (nd - t.ndim)
                                              + tuple(t.shape)), axis, 0)
                      for t in ts)

    def level(t, k):
        return t[k if t.shape[0] > 1 else 0]

    # forward elimination: c'[k] = c/(b - a c'[k-1]), d' likewise
    cp = dp = torch.zeros((), dtype=d_.dtype, device=d_.device)
    cps, dps = [], []
    for k in range(n):
        ak = level(a_, k)
        denom = level(b_, k) - ak * cp
        cp = level(c_, k) / denom
        dp = (level(d_, k) - ak * dp) / denom
        cps.append(cp)
        dps.append(dp)

    # back substitution; the levels are stacked into a tensor of the
    # broadcast shape (out of place, so the solve also runs under
    # torch.func.vmap)
    plane = shape[:axis] + shape[axis + 1:]
    xs = [None] * n
    x = torch.zeros((), dtype=dps[-1].dtype, device=d_.device)
    for k in range(n - 1, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x.expand(plane)
    return torch.stack(xs, dim=axis)


__all__ = ["tridiagonal_solve"]
