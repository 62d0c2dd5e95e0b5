"""oceananigans_torch — the ocean dynamical core of ``oceananigans_tpu``
ported to PyTorch, with its hot kernels hand-written in CUDA for Hopper.

It covers the nonhydrostatic model on a ``RectilinearGrid`` with regular
spacing: Centered(2) or WENO (orders 3 to 11) advection of momentum and
tracers, f-plane, β-plane and constant Cartesian Coriolis, BuoyancyTracer
and seawater buoyancy, quasi-AB2 or RK3 time stepping, halo fills, and the
FFT or eigenbasis matmul Poisson projection; the shallow-water model on a
Flat-z grid in its conservative and vector-invariant formulations, with
Coriolis, bathymetry and tracers, stepped by RK3; and the hydrostatic
free-surface model with the vector-invariant (WENOVectorInvariant) or
flux-form momentum advection, WENO or Centered(2) tracers, explicit or
split-explicit free surface, Coriolis and buoyancy, stepped by quasi-AB2. Grids and models run on the
GPU unless they are given ``device="cpu"`` (or ``config.device`` is set to
"cpu"); without a GPU, a grid built with no ``device=`` raises.

    grid = RectilinearGrid(size=(N, N, N), extent=(1, 1, 1),
                           topology=(Bounded, Periodic, Periodic),
                           halo=(3, 0, 0), dtype="float32")
    model = NonhydrostaticModel(grid=grid, advection=WENO(5),
                                tracers=("T", "S"),
                                timestepper="QuasiAdamsBashforth2")
    state = model.initial_state(u=lambda x, y, z: ..., T=...)
    state = model.step(state, 1e-4)
"""

from oceananigans_torch.advection import WENO, Centered
from oceananigans_torch.boundary_conditions import (
    FieldBoundaryConditions, FluxBC, OpenBC, PeriodicBC, fill_halo_regions,
)
from oceananigans_torch.buoyancy import (
    BuoyancyForce, BuoyancyTracer, LinearEquationOfState, SeawaterBuoyancy,
    TEOS10EquationOfState,
)
from oceananigans_torch.config import config
from oceananigans_torch.coriolis import (
    BetaPlane, ConstantCartesianCoriolis, FPlane, NonTraditionalBetaPlane,
)
from oceananigans_torch.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, interior, new_field, set_field,
)
from oceananigans_torch.grids import (
    Bounded, Center, Face, Flat, Periodic, RectilinearGrid,
)
from oceananigans_torch.models import (
    ConservativeFormulation, CrossAndSelfUpwinding, ExplicitFreeSurface,
    HydrostaticFreeSurfaceModel, HydrostaticState, NonhydrostaticModel,
    NonhydrostaticState, OnlySelfUpwinding, ShallowWaterModel,
    ShallowWaterState, SplitExplicitFreeSurface, VectorInvariant,
    VectorInvariantFormulation, WENOVectorInvariant,
)
from oceananigans_torch.solvers import FFTPoissonSolver, MatmulPoissonSolver

__all__ = [
    "BetaPlane", "Bounded", "BuoyancyForce", "BuoyancyTracer", "Center",
    "Centered", "ConservativeFormulation", "ConstantCartesianCoriolis",
    "CrossAndSelfUpwinding", "ExplicitFreeSurface", "FFTPoissonSolver",
    "FPlane",
    "Face", "FieldBoundaryConditions", "Flat", "FluxBC", "LOC_C", "LOC_U",
    "HydrostaticFreeSurfaceModel", "HydrostaticState",
    "LOC_V", "LOC_W", "LinearEquationOfState", "MatmulPoissonSolver",
    "NonTraditionalBetaPlane", "NonhydrostaticModel", "NonhydrostaticState",
    "OnlySelfUpwinding", "OpenBC", "Periodic", "PeriodicBC",
    "RectilinearGrid", "SeawaterBuoyancy", "ShallowWaterModel",
    "ShallowWaterState", "SplitExplicitFreeSurface",
    "TEOS10EquationOfState", "VectorInvariant",
    "VectorInvariantFormulation", "WENO", "WENOVectorInvariant", "config",
    "fill_halo_regions", "interior", "new_field", "set_field",
]
