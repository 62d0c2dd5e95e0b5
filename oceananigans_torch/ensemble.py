"""Ensembles of models batched over a leading member axis.

Counterpart of ``oceananigans_tpu/ensemble.py`` (reference
``slice_ensemble_model_mode.jl`` and ``single_column_model_mode.jl``: an
ensemble of column models batched over the horizontal plane). The JAX
package ``jax.vmap``s ``model.step`` over a leading axis of the state;
here ``torch.func.vmap`` does: each tensor of the members' states is
stacked on a leading axis, and one call of the batched step advances every
member. The clock is shared: every member steps with the same Δt from the
same time.

Any model the JAX ``EnsembleModel`` batches is batched here, on the CPU
and on the card, including those whose step runs:

- the hand-written kernels: each is a custom operator with a batching
  rule (``ops/library.py``), as ``pallas_call`` has one under ``jax.vmap``;
  a batched model takes the same kernels as the model stepped alone, one
  launch per member, and each member's kernel outputs are those of its
  serial step;
- the conjugate gradient (immersed pressure solves, the implicit free
  surface's "cg" and "matrix" methods): the loop runs until every member
  has converged, the converged members frozen, as JAX's batched
  ``lax.while_loop`` does; each member keeps its own iteration count.

Batched FFTs and reductions may round differently from the serial ones
(the nonhydrostatic pressure solve's FFT, by an ulp of the velocities). A
tensor that a step leaves on the model, such as a solver's ``iterations``,
is read per member with :func:`member_values`.
"""

from __future__ import annotations

import dataclasses

import torch

from oceananigans_torch.interop import CLOCK, flatten_state, unflatten_state
from oceananigans_torch.timesteppers import tick

__all__ = ["EnsembleModel", "member_values"]


class EnsembleModel:
    """Batch a column (or any) model over an ensemble axis::

        column = NonhydrostaticModel(grid=column_grid, ...)
        ens = EnsembleModel(column, n=64)
        states = ens.initial_states(
            c=lambda member, x, y, z: profiles[member])
        states = ens.step(states, dt)      # every member at once
        state3 = ens.member(states, 3)
    """

    def __init__(self, model, n: int):
        self.model = model
        self.n = int(n)

    def initial_states(self, **field_values):
        """The members' initial states, stacked. A value is a callable
        ``f(member_index, x, y, z)`` or an array with a leading (n,)
        axis."""
        states = []
        for m in range(self.n):
            kw = {}
            for name, val in field_values.items():
                if callable(val):
                    kw[name] = (lambda x, y, z, val=val, m=m:
                                val(m, x, y, z))
                else:
                    kw[name] = val[m]
            states.append(self.model.initial_state(**kw))
        return self.stack(states)

    def stack(self, states):
        """The ensemble state of the member states ``states`` (one a
        member, on one clock), stacked on a leading axis."""
        if len(states) != self.n:
            raise ValueError(f"{len(states)} states for {self.n} members")
        flats = [flatten_state(s) for s in states]
        stacked = {k: (torch.stack([f[k] for f in flats])
                       if k not in CLOCK else v)
                   for k, v in flats[0].items()}
        return unflatten_state(states[0], stacked)

    def step(self, states, dt):
        """One step of every member (``torch.func.vmap`` of
        ``model.step``); the shared clock ticks outside the batch, as every
        model's step ticks it."""
        flat = flatten_state(states)
        clock = {k: flat.pop(k) for k in CLOCK}

        def member_step(fields):
            out = flatten_state(self.model.step(
                unflatten_state(states, {**fields, **clock}), dt))
            return {k: v for k, v in out.items() if k not in CLOCK}

        fields = torch.func.vmap(member_step)(flat)
        new = unflatten_state(states, {**fields, **clock})
        return dataclasses.replace(new, clock=tick(states.clock, dt))

    def member(self, states, m: int):
        """Member ``m``'s state (views of the stacked tensors)."""
        flat = flatten_state(states)
        return unflatten_state(states, {
            k: v if k in CLOCK else v[m] for k, v in flat.items()})


def member_values(t):
    """The members' values, stacked on a leading axis, of a tensor that the
    batched step left on a model (``model.free_surface_info
    ["iterations"]``, an ``ImmersedPoissonSolver``'s ``iterations``);
    any other tensor as it is."""
    from torch._C import _functorch
    while _functorch.is_batchedtensor(t):
        t = torch.movedim(_functorch.get_unwrapped(t),
                          _functorch.maybe_get_bdim(t), 0)
    return t
