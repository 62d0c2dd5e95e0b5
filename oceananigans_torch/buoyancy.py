"""Buoyancy formulations and equations of state.

Counterpart of ``oceananigans_tpu/buoyancy.py``. A formulation gives
``buoyancy_ccc(grid, tracers)``, the buoyancy perturbation at cell
centers, and ``required_tracers``; ``BuoyancyForce`` turns it into momentum
contributions by interpolating it to the velocity points along the gravity
unit vector. ``buoyancy_frequency`` is N² = ∂b/∂z at (c,c,f).
"""

from __future__ import annotations

from oceananigans_torch.ops.operators import ddz_f, ix_f, iy_f, iz_f

#: standard gravitational acceleration [m s⁻²]
g_Earth = 9.80665


class _Config:
    """Equality and hashing by type and attributes."""

    def __eq__(self, other):
        return type(self) is type(other) and vars(self) == vars(other)

    def __hash__(self):
        return hash((type(self).__name__, repr(sorted(vars(self).items()))))


class BuoyancyTracer(_Config):
    """Buoyancy is itself the prognostic tracer ``b``."""

    required_tracers = ("b",)

    def buoyancy_ccc(self, grid, tracers):
        return tracers["b"]

    def __repr__(self):
        return "BuoyancyTracer()"


class LinearEquationOfState(_Config):
    """ρ′ = ρ₀ (−α T + β S), with α the thermal expansion and β the haline
    contraction coefficient."""

    def __init__(self, thermal_expansion=1.67e-4, haline_contraction=7.8e-4):
        self.alpha = float(thermal_expansion)
        self.beta = float(haline_contraction)

    def buoyancy(self, g, T, S):
        return g * (self.alpha * T - self.beta * S)

    def __repr__(self):
        return f"LinearEquationOfState(α={self.alpha:g}, β={self.beta:g})"


class TEOS10EquationOfState(_Config):
    """The simplified second-order polynomial of the TEOS-10 seawater
    equation of state (Roquet et al. 2015, Eq. 17, "polyTEOS10-simple"):

        ρ′ = −(a₀ + λ₁ (T − T₀)/2 + μ₁ (−z)) (T − T₀) + b₀ (S − S₀),

    which keeps thermobaricity (μ₁) and cabbeling (λ₁)."""

    def __init__(self, reference_density=1026.0):
        self.rho0 = float(reference_density)
        self.a0 = 1.6550e-1        # thermal expansion [kg m⁻³ °C⁻¹]
        self.b0 = 7.6554e-1        # haline contraction [kg m⁻³ (g/kg)⁻¹]
        self.lam1 = 5.9520e-2      # cabbeling [kg m⁻³ °C⁻²]
        self.mu1 = 1.4970e-4       # thermobaricity [kg m⁻³ °C⁻¹ m⁻¹]
        self.T0 = 10.0
        self.S0 = 35.0

    def buoyancy(self, g, T, S, z=0.0):
        Ta = T - self.T0
        Sa = S - self.S0
        rho_prime = (-(self.a0 + 0.5 * self.lam1 * Ta + self.mu1 * (-z))
                     * Ta + self.b0 * Sa)
        return -g * rho_prime / self.rho0

    def __repr__(self):
        return f"TEOS10EquationOfState(ρ₀={self.rho0:g})"


class SeawaterBuoyancy(_Config):
    """b from temperature T and salinity S through an equation of state.
    ``constant_temperature=`` or ``constant_salinity=`` replaces that
    tracer by a constant and drops it from the required tracers."""

    def __init__(self, gravitational_acceleration=g_Earth,
                 equation_of_state=None, constant_temperature=None,
                 constant_salinity=None):
        self.g = float(gravitational_acceleration)
        self.eos = equation_of_state or LinearEquationOfState()
        self.constant_temperature = constant_temperature
        self.constant_salinity = constant_salinity
        self.required_tracers = tuple(
            name for name, const in (("T", constant_temperature),
                                     ("S", constant_salinity))
            if const is None)

    def buoyancy_ccc(self, grid, tracers):
        T = (tracers["T"] if self.constant_temperature is None
             else self.constant_temperature)
        S = (tracers["S"] if self.constant_salinity is None
             else self.constant_salinity)
        if isinstance(self.eos, TEOS10EquationOfState):
            return self.eos.buoyancy(self.g, T, S, z=grid.zC)
        return self.eos.buoyancy(self.g, T, S)

    def __repr__(self):
        return f"SeawaterBuoyancy(g={self.g:g}, eos={self.eos!r})"


class BuoyancyForce(_Config):
    """A formulation plus a gravity unit vector (default −ẑ)."""

    def __init__(self, formulation, gravity_unit_vector=(0.0, 0.0, -1.0)):
        self.formulation = formulation
        self.gravity_unit_vector = tuple(float(c) for c in gravity_unit_vector)

    @property
    def required_tracers(self):
        return self.formulation.required_tracers

    def buoyancy_ccc(self, grid, tracers):
        return self.formulation.buoyancy_ccc(grid, tracers)

    # momentum contributions: −ĝ·b interpolated to each velocity point;
    # None where the gravity vector has no component (only w for −ẑ)
    def x_contribution(self, grid, tracers):
        gx = self.gravity_unit_vector[0]
        if gx == 0.0:
            return None
        return -gx * ix_f(self.buoyancy_ccc(grid, tracers))

    def y_contribution(self, grid, tracers):
        gy = self.gravity_unit_vector[1]
        if gy == 0.0:
            return None
        return -gy * iy_f(self.buoyancy_ccc(grid, tracers))

    def z_contribution(self, grid, tracers):
        gz = self.gravity_unit_vector[2]
        if gz == 0.0:
            return None
        return -gz * iz_f(self.buoyancy_ccc(grid, tracers))

    def __repr__(self):
        return (f"BuoyancyForce({self.formulation!r}, "
                f"gravity_unit_vector={self.gravity_unit_vector})")


def regularize_buoyancy(buoyancy):
    """Wrap a bare formulation in a BuoyancyForce with gravity along −ẑ."""
    if buoyancy is None or isinstance(buoyancy, BuoyancyForce):
        return buoyancy
    return BuoyancyForce(buoyancy)


def buoyancy_frequency(grid, buoyancy, tracers):
    """N² = ∂z b at (c,c,f), or None without a buoyancy."""
    if buoyancy is None:
        return None
    return ddz_f(grid, buoyancy.buoyancy_ccc(grid, tracers))


#: the reference's short name of the TEOS-10 equation of state
TEOS10 = TEOS10EquationOfState


def BuoyancyField(model, state):
    """Buoyancy at cell centers from ``model``'s formulation and the
    tracers of ``state``."""
    if model.buoyancy is None:
        raise ValueError("model has no buoyancy formulation")
    return model.buoyancy.buoyancy_ccc(model.grid, state.tracers)


__all__ = ["BuoyancyField", "BuoyancyForce", "BuoyancyTracer",
           "LinearEquationOfState", "SeawaterBuoyancy", "TEOS10",
           "TEOS10EquationOfState", "buoyancy_frequency", "g_Earth",
           "regularize_buoyancy"]
