"""oceananigans_torch — the ocean dynamical core of ``oceananigans_tpu``
ported to PyTorch, with its hot kernels hand-written in CUDA for Hopper.

It covers, on a ``RectilinearGrid`` with regular or stretched axes, and
on any of its grids wrapped in an ``ImmersedBoundaryGrid`` with a
``GridFittedBottom``, ``PartialCellBottom`` or ``GridFittedBoundary``
(and, for the hydrostatic and shallow-water models, on the
``LatitudeLongitudeGrid`` and the orthogonal spherical shells:
``RotatedLatitudeLongitudeGrid`` and ``TripolarGrid`` with its zipper fold, with spherical Coriolis and the
polar condition; and on the ``ConformalCubedSphereGrid``, with its own
shallow-water and hydrostatic models, ``CubedSphereShallowWaterModel``
and ``CubedSphereHydrostaticModel``, the latter with a grid-fitted
bathymetry): the advection
schemes Centered (orders 2 to 12), UpwindBiased (1 to 11), WENO (3 to 11)
and FluxFormAdvection, with the bound-preserving limiters
(``WENO(bounds=...)``, ``BoundPreserving``); the nonhydrostatic model with f-plane, β-plane and
constant Cartesian Coriolis, BuoyancyTracer and seawater buoyancy,
quasi-AB2 or RK3 time stepping, halo fills, and the FFT or eigenbasis
matmul Poisson projection; the shallow-water model on a Flat-z grid in its
conservative and vector-invariant formulations, with Coriolis, bathymetry
and tracers, stepped by RK3; the hydrostatic free-surface model with the
vector-invariant (WENOVectorInvariant) or flux-form momentum advection,
explicit, split-explicit or implicit free surface (FFT, CG or the
stencil-matrix solver), Coriolis and buoyancy, the z-star coordinate,
stepped by quasi-AB2 or split RK3; the closures of ``closures.py`` (scalar, biharmonic,
Smagorinsky-Lilly, dynamic Smagorinsky, AMD, convective adjustment;
explicit or vertically implicit) and the ocean closures of
``closures_ocean.py`` (CATKE, Ri-based, k-ε, Leith, GM/Redi), and valued,
gradient, flux and open boundary conditions on the nonhydrostatic and
hydrostatic models; forcings (continuous, discrete, relaxation, advective,
time series), background fields, Stokes drift, biogeochemistry, Lagrangian
particles and auxiliary fields on the models that take them; the
field layer (constructors, reductions, regridding, interpolation) and
the operations (derivatives, metric averages and integrals, derived
fields); the ``Simulation`` run loop with its callbacks, schedules,
``TimeStepWizard`` and NaN guard; output (HDF5 and NetCDF writers,
windowed time averages, checkpoints and pickup, field time series,
calendar clocks); ensembles of models batched by ``torch.func.vmap``; and
matplotlib plots (``utils/plotting.py``). Grids and models run on the GPU
unless they are given ``device="cpu"`` (or ``config.device`` is set to
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

from oceananigans_torch.advection import (
    WENO, BoundPreserving, Centered, FluxFormAdvection, UpwindBiased,
    adapt_advection_order,
)
from oceananigans_torch.boundary_conditions import (
    BoundaryCondition, FieldBoundaryConditions, FlatExtrapolationOpenBC,
    FluxBC, FluxBoundaryCondition, GradientBC, GradientBoundaryCondition,
    OpenBC, OpenBoundaryCondition, PerturbationAdvection,
    PerturbationAdvectionOpenBC, PeriodicBC, ValueBC, ValueBoundaryCondition,
    fill_halo_regions,
)
from oceananigans_torch.buoyancy import (
    TEOS10, BuoyancyField, BuoyancyForce, BuoyancyTracer,
    LinearEquationOfState, SeawaterBuoyancy, TEOS10EquationOfState,
)
from oceananigans_torch.closures import (
    AnisotropicMinimumDissipation, ConvectiveAdjustmentVerticalDiffusivity,
    DynamicCoefficient, DynamicSmagorinsky, ExplicitTimeDiscretization,
    HorizontalScalarBiharmonicDiffusivity, HorizontalScalarDiffusivity,
    LillyCoefficient, ScalarBiharmonicDiffusivity, ScalarDiffusivity,
    Smagorinsky, SmagorinskyLilly, VerticallyImplicitTimeDiscretization,
    VerticalScalarBiharmonicDiffusivity, VerticalScalarDiffusivity,
    diffusivity, viscosity,
)
from oceananigans_torch.closures_ocean import (
    CATKEVerticalDiffusivity, IsopycnalSkewSymmetricDiffusivity,
    LeithEnstrophyDiffusivity, RiBasedVerticalDiffusivity,
    TKEDissipationVerticalDiffusivity,
)
from oceananigans_torch.biogeochemistry import (
    Biogeochemistry, SimpleBiogeochemistry,
)
from oceananigans_torch.config import config, float_type, set_float_type
from oceananigans_torch.forcings import (
    AdvectiveForcing, Forcing, GaussianMask, LinearTarget, MultipleForcings,
    Relaxation,
)
from oceananigans_torch.particles import LagrangianParticles
from oceananigans_torch.stokes_drift import StokesDrift, UniformStokesDrift
from oceananigans_torch.coriolis import (
    BetaPlane, ConstantCartesianCoriolis, FPlane,
    HydrostaticSphericalCoriolis, NonTraditionalBetaPlane,
)
from oceananigans_torch.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, BackgroundField, CenterField, ConstantField,
    Field, FunctionField, XFaceField, YFaceField, ZeroField, ZFaceField,
    field_abs_max, field_integral, field_max, field_mean, field_min,
    interior, interpolate, new_field, set_field, with_interior,
)
from oceananigans_torch.grids import (
    AbstractGrid, Bounded, Center, ConformalCubedSphereGrid, Face, Flat,
    LatitudeLongitudeGrid, conformal_cubed_sphere_panel,
    OrthogonalSphericalShellGrid, Periodic, RectilinearGrid,
    RotatedLatitudeLongitudeGrid, TripolarGrid, extrinsic_vector,
    intrinsic_vector, lambda_nodes, lambda_spacings, minimum_xspacing,
    minimum_yspacing, minimum_zspacing, nodes, phi_nodes, phi_spacings,
    rnodes, rotation_angles, rspacings, total_length, xnodes, xspacings,
    ynodes, yspacings, znodes, zspacings,
)
from oceananigans_torch.immersed import (
    GridFittedBottom, GridFittedBoundary, ImmersedBoundaryCondition,
    ImmersedBoundaryGrid, ImmersedPoissonSolver, PartialCellBottom,
)
from oceananigans_torch.models import (
    ConservativeFormulation, CrossAndSelfUpwinding,
    CubedSphereHydrostaticModel, CubedSphereShallowWaterModel,
    ExplicitFreeSurface, HydrostaticFreeSurfaceModel, HydrostaticState,
    ImplicitFreeSurface, NonhydrostaticModel, NonhydrostaticState,
    OnlySelfUpwinding, PrescribedVelocityFields, PressureField,
    ShallowWaterModel, ShallowWaterState, SplitExplicitFreeSurface,
    VectorInvariant, VectorInvariantFormulation, WENOVectorInvariant,
    ZCoordinate, ZStar,
)
from oceananigans_torch.operations import (
    Accumulation, Average, ConditionalAverage, CumulativeIntegral, Integral,
    KernelFunctionOperation, Reduction,
)
from oceananigans_torch.output import (
    Checkpointer, FieldDataset, FieldTimeSeries, FileSizeLimit, HDF5Writer,
    InMemory, JLD2Writer, NetCDFWriter, OnDisk, OrbaxCheckpointer,
    WindowedTimeAverage, load_field_time_series,
)
from oceananigans_torch.ensemble import EnsembleModel
from oceananigans_torch.simulation import (
    Callback, NaNChecker, Simulation, TendencyCallsite, TimeStepCallsite,
    TimeStepWizard, UpdateStateCallsite, add_callback,
    conjure_time_step_wizard, iteration,
)
from oceananigans_torch.solvers import (
    FFTPoissonSolver, FourierTridiagonalPoissonSolver,
    HeptadiagonalIterativeSolver, MatmulPoissonSolver, StencilMatrix,
    conjugate_gradient,
)
from oceananigans_torch.diagnostics import (
    CFL, AdvectiveCFL, DiffusiveCFL, StateChecker, seawater_density,
)
from oceananigans_torch.timesteppers import Clock
from oceananigans_torch.utils.pretty import prettytime
from oceananigans_torch.utils.schedules import (
    AndSchedule, AveragedTimeInterval, IterationInterval, OrSchedule,
    SpecifiedTimes, TimeInterval, WallTimeInterval,
)
from oceananigans_torch.utils.units import (
    GiB, KiB, MiB, TiB, day, days, hour, hours, kilometer, kilometers,
    meter, meters, minute, minutes, second, seconds, year, years,
)

from oceananigans_torch.parallel import Distributed, Partition

__all__ = [
    "AbstractGrid", "Accumulation", "AdvectiveCFL", "AdvectiveForcing",
    "AndSchedule", "AnisotropicMinimumDissipation", "Average",
    "AveragedTimeInterval", "BackgroundField", "BetaPlane", "Biogeochemistry",
    "BoundPreserving",
    "BoundaryCondition", "Bounded", "BuoyancyField", "BuoyancyForce",
    "BuoyancyTracer", "CATKEVerticalDiffusivity", "CFL", "Callback", "Center",
    "CenterField", "Centered", "Checkpointer", "Clock", "ConditionalAverage",
    "Distributed", "OrbaxCheckpointer", "Partition",
    "ConformalCubedSphereGrid", "ConservativeFormulation",
    "ConstantCartesianCoriolis", "ConstantField",
    "ConvectiveAdjustmentVerticalDiffusivity", "CrossAndSelfUpwinding",
    "CubedSphereHydrostaticModel", "CubedSphereShallowWaterModel",
    "CumulativeIntegral", "DiffusiveCFL", "DynamicCoefficient",
    "DynamicSmagorinsky", "EnsembleModel", "ExplicitFreeSurface",
    "ExplicitTimeDiscretization", "FFTPoissonSolver", "FPlane", "Face",
    "Field", "FieldBoundaryConditions", "FieldDataset", "FieldTimeSeries",
    "FileSizeLimit", "Flat", "FlatExtrapolationOpenBC", "FluxBC",
    "FluxBoundaryCondition", "FluxFormAdvection", "Forcing",
    "FourierTridiagonalPoissonSolver", "FunctionField", "GaussianMask", "GiB",
    "GradientBC", "GradientBoundaryCondition", "GridFittedBottom",
    "GridFittedBoundary", "HDF5Writer", "HeptadiagonalIterativeSolver",
    "HorizontalScalarBiharmonicDiffusivity", "HorizontalScalarDiffusivity",
    "HydrostaticFreeSurfaceModel", "HydrostaticSphericalCoriolis",
    "HydrostaticState", "ImmersedBoundaryCondition", "ImmersedBoundaryGrid",
    "ImmersedPoissonSolver", "ImplicitFreeSurface", "InMemory", "Integral",
    "IsopycnalSkewSymmetricDiffusivity", "IterationInterval", "JLD2Writer",
    "KernelFunctionOperation", "KiB", "LOC_C", "LOC_U", "LOC_V", "LOC_W",
    "LagrangianParticles", "LatitudeLongitudeGrid",
    "LeithEnstrophyDiffusivity", "LillyCoefficient", "LinearEquationOfState",
    "LinearTarget", "MatmulPoissonSolver", "MiB", "MultipleForcings",
    "NaNChecker", "NetCDFWriter", "NonTraditionalBetaPlane",
    "NonhydrostaticModel", "NonhydrostaticState", "OnDisk",
    "OnlySelfUpwinding", "OpenBC", "OpenBoundaryCondition", "OrSchedule",
    "OrthogonalSphericalShellGrid", "PartialCellBottom", "Periodic",
    "PeriodicBC", "PerturbationAdvection", "PerturbationAdvectionOpenBC",
    "PrescribedVelocityFields", "PressureField", "RectilinearGrid",
    "Reduction", "Relaxation", "RiBasedVerticalDiffusivity",
    "RotatedLatitudeLongitudeGrid", "ScalarBiharmonicDiffusivity",
    "ScalarDiffusivity", "SeawaterBuoyancy", "ShallowWaterModel",
    "ShallowWaterState", "SimpleBiogeochemistry", "Simulation", "Smagorinsky",
    "SmagorinskyLilly", "SpecifiedTimes", "SplitExplicitFreeSurface",
    "StateChecker", "StencilMatrix", "StokesDrift", "TEOS10", "TEOS10EquationOfState",
    "TKEDissipationVerticalDiffusivity", "TendencyCallsite", "TiB",
    "TimeInterval", "TimeStepCallsite", "TimeStepWizard", "TripolarGrid",
    "UniformStokesDrift", "UpdateStateCallsite", "UpwindBiased", "ValueBC",
    "ValueBoundaryCondition", "VectorInvariant", "VectorInvariantFormulation",
    "VerticalScalarBiharmonicDiffusivity", "VerticalScalarDiffusivity",
    "VerticallyImplicitTimeDiscretization", "WENO", "WENOVectorInvariant",
    "WallTimeInterval", "WindowedTimeAverage", "XFaceField", "YFaceField",
    "ZCoordinate", "ZFaceField", "ZStar", "ZeroField",
    "adapt_advection_order", "add_callback", "config",
    "conformal_cubed_sphere_panel", "conjugate_gradient",
    "conjure_time_step_wizard", "day", "days", "diffusivity",
    "extrinsic_vector", "field_abs_max", "field_integral", "field_max",
    "field_mean", "field_min", "fill_halo_regions", "float_type", "hour",
    "hours", "interior", "interpolate", "intrinsic_vector", "iteration",
    "kilometer", "kilometers", "lambda_nodes", "lambda_spacings",
    "load_field_time_series", "meter", "meters", "minimum_xspacing",
    "minimum_yspacing", "minimum_zspacing", "minute", "minutes", "new_field",
    "nodes", "phi_nodes", "phi_spacings", "prettytime", "rnodes",
    "rotation_angles", "rspacings", "seawater_density", "second", "seconds",
    "set_field", "set_float_type", "total_length", "viscosity",
    "with_interior", "xnodes", "xspacings", "year", "years", "ynodes",
    "yspacings", "znodes", "zspacings",
]
