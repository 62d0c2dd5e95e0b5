"""Models of the port."""

from oceananigans_torch.models.hydrostatic import VectorInvariant
from oceananigans_torch.models.nonhydrostatic import (
    NonhydrostaticModel, NonhydrostaticState,
)
from oceananigans_torch.models.shallow_water import (
    ConservativeFormulation, ShallowWaterModel, ShallowWaterState,
    VectorInvariantFormulation,
)

__all__ = ["ConservativeFormulation", "NonhydrostaticModel",
           "NonhydrostaticState", "ShallowWaterModel", "ShallowWaterState",
           "VectorInvariant", "VectorInvariantFormulation"]
