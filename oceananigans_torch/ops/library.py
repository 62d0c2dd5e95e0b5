"""The package's hand-written kernels as PyTorch custom operators.

Every kernel entry point is an operator ``oceananigans_torch::<name>``
(:class:`KernelOp`) with the two rules that ``pallas_call`` has in JAX:

- a batching rule (``register_vmap``), so ``torch.func.vmap`` batches a
  step that launches kernels, as ``jax.vmap`` batches a ``pallas_call``:
  each batched operand's member axis is moved to 0 and the kernel runs
  once per member on that member's contiguous slice; the outputs are
  stacked on axis 0. Operands that are not batched (metric profiles, the
  Poisson solve's bases and eigenvalues) are passed as they are. An
  operator that writes an operand in place (the AB2 kernels write G over
  G⁻) writes each member's slice of the batched operand;
- no differentiation rule: a backward through a kernel raises
  ``RuntimeError`` ("no autograd formula was registered"), as ``jax.grad``
  through a ``pallas_call`` raises, where a kernel's fresh outputs would
  otherwise be constants that drop their part of the gradient.

An operator takes ``fields`` (its read-only tensors), ``state`` (the
tensors it writes in place), ``ints`` and ``floats``, and returns a list
of new tensors. Its CUDA implementation is the kernel's launch; its CPU
implementation is the kernel's plain version, which the caller binds with
the grid and the scheme for the call (:meth:`KernelOp.__call__`). The
kernel wrappers of ``ops/cuda_*.py`` call their operator for CUDA tensors
and their plain version directly for CPU tensors, so CPU models keep their
gradients; a wrapper's ``*_op`` function takes the operator on either
device.

:func:`any_member` is the one reduction that a batched conjugate gradient
needs: its batching rule reduces a flag over the members, so the host can
read it inside ``vmap``.
"""

from __future__ import annotations

import torch
from torch import Tensor

NAMESPACE = "oceananigans_torch"

#: the plain versions bound by the callers of :class:`KernelOp`, innermost
#: last
_plain = []


def _select(t, d, m):
    return t if d is None else t.select(d, m)


class KernelOp:
    """The custom operator ``oceananigans_torch::<name>`` of one kernel.

    ``launch(fields, state, ints, floats)`` launches the kernel on CUDA
    tensors and returns its new tensors; ``mutates``: the kernel writes the
    ``state`` tensors in place."""

    def __init__(self, name, launch, mutates=False):
        self.name = name

        def impl(fields: list[Tensor], state: list[Tensor], ints: list[int],
                 floats: list[float]) -> list[Tensor]:
            return launch(fields, state, ints, floats)

        impl.__name__ = name
        self.op = torch.library.custom_op(
            f"{NAMESPACE}::{name}", impl,
            mutates_args=("state",) if mutates else (), device_types="cuda")
        self.op.register_kernel("cpu", self._plain_impl)
        self.op.register_vmap(self._vmap)

    def __call__(self, plain, fields, state=(), ints=(), floats=()):
        """Run the operator; ``plain(fields, state)`` is the plain version
        that its CPU implementation runs (with the same in-place writes)."""
        _plain.append(plain)
        try:
            return self.op(list(fields), list(state), [int(i) for i in ints],
                           [float(x) for x in floats])
        finally:
            _plain.pop()

    def _plain_impl(self, fields, state, ints, floats):
        if not _plain:
            raise RuntimeError(f"{NAMESPACE}::{self.name}: no plain version "
                               "bound; call the operator through its "
                               "wrapper")
        return _plain[-1](fields, state)

    def _vmap(self, info, in_dims, fields, state, ints, floats):
        fdims, sdims = in_dims[0], in_dims[1]
        if (any(d is None for d in sdims)
                and any(d is not None for d in (*fdims, *sdims))):
            raise RuntimeError(
                f"vmap: {NAMESPACE}::{self.name} writes an operand in "
                "place that is not batched while another operand is")
        outs = []
        for m in range(info.batch_size):
            fs = [_select(t, d, m).contiguous()
                  for t, d in zip(fields, fdims)]
            ss = [_select(t, d, m) for t, d in zip(state, sdims)]
            work = [s if s.is_contiguous() else s.contiguous() for s in ss]
            outs.append(self.op(fs, work, ints, floats))
            for s, w in zip(ss, work):
                if w is not s:
                    s.copy_(w)
        return ([torch.stack(o) for o in zip(*outs)],
                [0] * len(outs[0]))


@torch.library.custom_op(f"{NAMESPACE}::any_member", mutates_args=())
def any_member(flag: Tensor) -> Tensor:
    """``flag`` (a 0-d bool tensor) unchanged, or under ``torch.func.vmap``
    the flag of any member: unbatched, so the host can read it."""
    return flag.clone()


def _any_member_vmap(info, in_dims, flag):
    d = in_dims[0]
    if d is None:
        return flag.clone(), None
    # an outer vmap's members stay batched: reduce them in turn
    return any_member(flag.any(dim=d)), None


any_member.register_vmap(_any_member_vmap)


__all__ = ["KernelOp", "NAMESPACE", "any_member"]
