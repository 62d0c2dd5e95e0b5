"""Preconditioned conjugate gradient on tensors.

Counterpart of ``oceananigans_tpu/solvers/conjugate_gradient.py``, whose
``lax.while_loop`` tests ``dot(r, r) > tol²`` before every iteration. Here
the loop runs on the host, and reading that test every iteration would
block the host on the device each time. Instead a device-side flag
``active`` is carried: once the test fails it stays false, and an inactive
iteration takes a zero step (α = β = 0), so x and r freeze exactly where
the JAX loop stops and the iteration count is the JAX count. The host
reads the flag once every :data:`CHECK_EVERY` iterations and leaves the
loop when it is false, so a solve does at most ``CHECK_EVERY − 1`` frozen
iterations and one host synchronization per ``CHECK_EVERY`` iterations.
The divisions are the JAX package's breakdown-safe ones: a zero ``p·Ap``
or ``r·z`` gives a zero step instead of inf or NaN.

Under ``torch.func.vmap`` (an ``EnsembleModel``) every member carries its
own flag and count, and the host reads the flag of any member
(``ops/library.py: any_member``): the loop runs until every member has
converged, the converged ones frozen, as JAX's ``lax.while_loop`` does
under ``jax.vmap``. A serial solve reads its own flag.
"""

from __future__ import annotations

import torch

from oceananigans_torch.ops.library import any_member

#: iterations between two host reads of the convergence flag
CHECK_EVERY = 4


def _dot(x, y):
    return torch.sum(x * y)


def conjugate_gradient(A, b, x0, *, preconditioner=None, maxiter=100,
                       reltol=1e-7, abstol=0.0, dot=None, info=None):
    """Solve ``A(x) = b`` for a symmetric positive (semi)definite linear
    operator ``A`` (a function of a tensor), from ``x0``.

    ``dot`` overrides the inner product. The host reads the convergence
    flag every :data:`CHECK_EVERY` iterations (1 would read it every
    iteration, as the JAX loop tests it; the result does not depend on
    it). ``info``, a dict, receives ``host_syncs``: the reads made.

    Returns ``(x, iterations, residual_norm)``; the last two are 0-d
    tensors on ``b``'s device."""
    if preconditioner is None:
        preconditioner = lambda r: r   # noqa: E731
    dot = _dot if dot is None else dot
    check_every = CHECK_EVERY

    r = b - A(x0)
    z = preconditioner(r)
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b))
    tol2 = torch.clamp(reltol * bnorm, min=abstol) ** 2
    x, p = x0, z
    active = dot(r, r) > tol2
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    syncs = 0
    for k in range(maxiter):
        if k % check_every == 0:
            syncs += 1
            if not bool(any_member(active)):
                break
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(active & (pAp != 0),
                            rz / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = preconditioner(r)
        rz_new = dot(r, z)
        beta = torch.where(active & (rz != 0),
                           rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = z + beta * p
        rz = rz_new
        it = it + active
        active = active & (dot(r, r) > tol2)
    if info is not None:
        info["host_syncs"] = syncs
    return x, it, torch.sqrt(dot(r, r))


__all__ = ["CHECK_EVERY", "conjugate_gradient"]
