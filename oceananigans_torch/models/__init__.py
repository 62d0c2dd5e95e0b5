"""Models of the port."""

from oceananigans_torch.models.cubed_sphere import (
    CubedSphereHydrostaticModel, CubedSphereHydrostaticState,
    CubedSphereShallowWaterModel, CubedSphereState, panel_vector_components,
)
from oceananigans_torch.models.hydrostatic import (
    CrossAndSelfUpwinding, ExplicitFreeSurface, HydrostaticFreeSurfaceModel,
    HydrostaticState, ImplicitFreeSurface, OnlySelfUpwinding,
    PrescribedVelocityFields, SplitExplicitFreeSurface, VectorInvariant,
    WENOVectorInvariant, ZCoordinate, ZStar,
)
from oceananigans_torch.models.nonhydrostatic import (
    NonhydrostaticModel, NonhydrostaticState,
)
from oceananigans_torch.models.shallow_water import (
    ConservativeFormulation, ShallowWaterModel, ShallowWaterState,
    VectorInvariantFormulation,
)


def PressureField(model, state):
    """The nonhydrostatic model's kinematic pressure, which its state
    carries; the hydrostatic model carries none."""
    if hasattr(state, "pressure"):
        return state.pressure
    raise ValueError(f"{type(model).__name__} does not carry a pressure "
                     "field; use BuoyancyField or the free-surface height")


def fields(state):
    """The state's prognostic and diagnostic fields by name: whichever of
    u, v, w, η, h, uh, vh and the pressure it has, then its tracers."""
    out = {}
    for name in ("u", "v", "w", "eta", "h", "uh", "vh", "pressure"):
        if hasattr(state, name):
            out[name] = getattr(state, name)
    out.update(getattr(state, "tracers", {}))
    return out


__all__ = ["ConservativeFormulation", "CrossAndSelfUpwinding",
           "CubedSphereHydrostaticModel", "CubedSphereHydrostaticState",
           "CubedSphereShallowWaterModel", "CubedSphereState",
           "ExplicitFreeSurface", "HydrostaticFreeSurfaceModel",
           "HydrostaticState", "ImplicitFreeSurface", "NonhydrostaticModel",
           "NonhydrostaticState", "OnlySelfUpwinding",
           "PrescribedVelocityFields", "PressureField", "ShallowWaterModel",
           "ShallowWaterState", "SplitExplicitFreeSurface", "VectorInvariant",
           "VectorInvariantFormulation", "WENOVectorInvariant", "ZCoordinate",
           "ZStar", "fields", "panel_vector_components"]
