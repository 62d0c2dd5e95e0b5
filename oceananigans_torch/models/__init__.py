"""Models of the port."""

from oceananigans_torch.models.hydrostatic import (
    CrossAndSelfUpwinding, ExplicitFreeSurface, HydrostaticFreeSurfaceModel,
    HydrostaticState, OnlySelfUpwinding, SplitExplicitFreeSurface,
    VectorInvariant, WENOVectorInvariant,
)
from oceananigans_torch.models.nonhydrostatic import (
    NonhydrostaticModel, NonhydrostaticState,
)
from oceananigans_torch.models.shallow_water import (
    ConservativeFormulation, ShallowWaterModel, ShallowWaterState,
    VectorInvariantFormulation,
)

__all__ = ["ConservativeFormulation", "CrossAndSelfUpwinding",
           "ExplicitFreeSurface", "HydrostaticFreeSurfaceModel",
           "HydrostaticState", "NonhydrostaticModel", "NonhydrostaticState",
           "OnlySelfUpwinding", "ShallowWaterModel", "ShallowWaterState",
           "SplitExplicitFreeSurface", "VectorInvariant",
           "VectorInvariantFormulation", "WENOVectorInvariant"]
