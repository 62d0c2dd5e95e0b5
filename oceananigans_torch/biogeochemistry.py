"""Biogeochemistry: the hooks a model calls for reacting and sinking
tracers.

Counterpart of ``oceananigans_tpu/biogeochemistry.py``. A model adds the
``required_tracers``, then for each tracer the ``transition`` (a reaction
term at cell centres) and the advection by ``drift_velocity`` (e.g.
sinking, through the plain flux divergence ``advection.div_Uc``), and
finally passes the tendency dict through ``update_tendencies``. Plain
PyTorch, as the JAX package reaches no Pallas kernel here.
"""

from __future__ import annotations


class Biogeochemistry:
    """Subclass and override; every hook is a function of its arguments."""

    required_tracers: tuple = ()

    def transition(self, grid, name, time, fields):
        """The reaction term of tracer ``name`` at cell centres, or None."""
        return None

    def drift_velocity(self, name):
        """A drift (wu, wv, ww) of tracer ``name`` (e.g. ww < 0 for
        sinking), or None."""
        return None

    def update_tendencies(self, grid, tendencies, time, fields):
        """A last pass over the tendency dict; returns it."""
        return tendencies


class SimpleBiogeochemistry(Biogeochemistry):
    """One tracer with a growth (or decay) rate μ, a number or a callable
    ``mu(z, t)`` of the centre depths and the time, and a sinking speed:
    ∂t P = μ P − ∂z(−w_s P)."""

    def __init__(self, tracer="P", growth_rate=None, sinking_speed=0.0):
        self.required_tracers = (tracer,)
        self.tracer = tracer
        self.growth_rate = growth_rate
        self.sinking_speed = float(sinking_speed)

    def transition(self, grid, name, time, fields):
        if name != self.tracer or self.growth_rate is None:
            return None
        mu = self.growth_rate
        if callable(mu):
            mu = mu(grid.zC, time)
        return mu * fields[name]

    def drift_velocity(self, name):
        if name == self.tracer and self.sinking_speed != 0.0:
            return (0.0, 0.0, -abs(self.sinking_speed))
        return None


__all__ = ["Biogeochemistry", "SimpleBiogeochemistry"]
