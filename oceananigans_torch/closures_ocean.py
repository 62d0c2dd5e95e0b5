"""Ocean boundary-layer and mesoscale closures: CATKE, the Ri-based
diffusivity, k-ε, Leith and the isopycnal (GM/Redi) diffusivity.

Counterpart of ``oceananigans_tpu/closures_ocean.py``, on the closure
interface of ``closures.py``: each closure computes its coefficients once a
step (``compute_diffusivities``), gives its explicit flux divergences, and
the vertically implicit ones (CATKE, k-ε, Ri-based) hand their z-face
diffusivities, and for the TKE equations a linear coefficient, to the
Thomas solve of ``closures.implicit_vertical_diffusion_step``. CATKE takes
the surface fluxes of u, v and b (``wants_top_fluxes``); without them its
convective and entrainment lengths and its surface TKE flux vanish. CATKE
and k-ε assume the surface at z = 0 and read ``grid.Lz``. Every expression
is a branch-free tensor expression with the JAX package's order of
evaluation; the axes count from the end (``ops/operators.py``), so the
cubed sphere's stacked panels go through whole. The JAX package reaches no
Pallas kernel here; this is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from oceananigans_torch.buoyancy import buoyancy_frequency
from oceananigans_torch.closures import (
    AbstractClosure, VerticallyImplicitTimeDiscretization,
    _div_c_fluxes, _div_u_fluxes, _div_v_fluxes, _div_w_fluxes,
    _laplacian_momentum_divs, _laplacian_tracer_div,
)
from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops.operators import (
    Z, dx_f, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f, shift,
    vorticity_z_ff,
)


def _shear_squared_ccf(grid, u, v):
    """|∂z 𝐮|² at (c,c,f)."""
    uz = ix_c(dz_f(u)) / grid.dz(Face)
    vz = iy_c(dz_f(v)) / grid.dz(Face)
    return uz * uz + vz * vz


def _surface_cell_height(grid):
    """The surface cell height that scales CATKE's surface TKE flux and
    its w_δ³: as the JAX package takes it, the flat element ``Hz + Nz −
    1`` of ``grid.dz(Center)``, the top cell of the metric's column (0, 0)
    (under ``ZStar`` σ·Δz of the halo corner, used for every column). A
    rank's block in a distributed step holds another column (0, 0): its
    grid carries ``dist_surface_cell_height``, which gives the global
    array's value (``parallel/shard_step.py: DistHalo``). The cube's
    models pass CATKE no surface fluxes, so there the height scales a flux
    of zero, serially or sharded."""
    hook = getattr(grid, "dist_surface_cell_height", None)
    if hook is not None:
        return hook(grid)
    return grid.dz(Center).reshape(-1)[grid.H[2] + grid.N[2] - 1]


def _interior_faces(grid, device):
    """True on the z-faces strictly between the bottom and the top."""
    k = torch.arange(grid.shape[2], device=device).reshape(1, 1, -1)
    return (k > grid.H[2]) & (k < grid.H[2] + grid.N[2])


def _value_on(x, like):
    """A top flux (a number, or a tensor that broadcasts against the top
    slab) as a tensor in ``like``'s dtype; a number is filled on the
    device, not copied there."""
    if torch.is_tensor(x):
        return x.to(dtype=like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


class RiBasedVerticalDiffusivity(AbstractClosure):
    """Vertical ν and κ of the Richardson number:
    κ = κ₀ step(Ri) + κᶜᵃ (N² < 0) + κmin with the smooth step
    ``step(Ri) = (1 − tanh((Ri − Ri₀)/δ))/2``. Vertically implicit."""

    time_discretization = VerticallyImplicitTimeDiscretization

    def __init__(self, nu_0=0.7, kappa_0=0.5, Ri_0=0.1, Ri_delta=0.4,
                 convective_kappa=1.0, minimum_kappa=1e-5):
        self.nu_0 = float(nu_0)
        self.kappa_0 = float(kappa_0)
        self.Ri_0 = float(Ri_0)
        self.Ri_delta = float(Ri_delta)
        self.convective_kappa = float(convective_kappa)
        self.minimum_kappa = float(minimum_kappa)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        N2 = buoyancy_frequency(grid, buoyancy, tracers)
        Ri = N2 / torch.clamp(_shear_squared_ccf(grid, u, v), min=1e-14)
        step = 0.5 * (1.0 - torch.tanh((Ri - self.Ri_0) / self.Ri_delta))
        # κᶜᵃ where N² < 0, else 0, in N²'s dtype (a torch.where of two
        # numbers would take the default dtype)
        conv = (N2 < 0).to(N2.dtype) * self.convective_kappa
        kappa = self.kappa_0 * step + conv + self.minimum_kappa
        nu = self.nu_0 * step + conv + self.minimum_kappa
        return {"kappa_z_ccf": kappa, "nu_z_ccf": nu}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        fzz = iz_c(nu) * dz_c(w) / grid.dz(Center)
        zero = torch.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                _div_w_fluxes(grid, zero, zero, fzz))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if not include_implicit:
            return torch.zeros_like(c)
        fz = diffusivities["kappa_z_ccf"] * dz_f(c) / grid.dz(Face)
        zero = torch.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return (f"RiBasedVerticalDiffusivity(ν₀={self.nu_0}, "
                f"κ₀={self.kappa_0})")


@dataclasses.dataclass(frozen=True)
class CATKEMixingLength:
    """CATKE's mixing-length parameters (the reference's calibrated
    defaults, names romanized)."""
    Cs: float = 1.131         # surface distance coefficient
    Cb: float = 0.28          # bottom distance coefficient
    Csp: float = 0.505        # sheared convective plume coefficient
    CRi_delta: float = 1.02   # stability function width
    CRi0: float = 0.254       # stability function lower Ri
    Chi_u: float = 0.242
    Clo_u: float = 0.361
    Cun_u: float = 0.370
    Cc_u: float = 3.705
    Ce_u: float = 0.0
    Chi_c: float = 0.098
    Clo_c: float = 0.369
    Cun_c: float = 0.572
    Cc_c: float = 4.793
    Ce_c: float = 0.112
    Chi_e: float = 0.548
    Clo_e: float = 7.863
    Cun_e: float = 1.447
    Cc_e: float = 3.642
    Ce_e: float = 0.0


@dataclasses.dataclass(frozen=True)
class CATKEEquation:
    """CATKE's TKE-equation parameters."""
    Chi_D: float = 0.579
    Clo_D: float = 1.604
    Cun_D: float = 0.923
    Cc_D: float = 3.254
    Ce_D: float = 0.0
    CW_ustar: float = 3.179   # surface shear-driven TKE flux coefficient
    CW_wdelta: float = 0.383  # surface convective TKE flux coefficient
    CW_eps: float = 1.0


class CATKEVerticalDiffusivity(AbstractClosure):
    """CATKE: a prognostic TKE ``e`` and the reference's mixing lengths:
    stability functions σ(Ri) per quantity; a stable length σ · min(Cˢ
    depth, Cᵇ height above the bottom, √e/N); convective and entrainment
    lengths driven by the surface buoyancy flux Jᵇ with the
    sheared-convection reduction; dissipation ω e with ω = √e/ℓᴰ (its own
    coefficients) and fast damping of negative e; the surface TKE flux
    −(Cᵂu★ u★³ + CᵂwΔ wΔ³). The dissipation and the destabilizing buoyancy
    flux enter the implicit solve as a linear coefficient (a Patankar
    split). The models pass the top flux values of u, v and b
    (``top_fluxes``); without them (the cubed sphere) the convective
    machinery and the surface flux vanish."""

    time_discretization = VerticallyImplicitTimeDiscretization
    required_tracers = ("e",)
    wants_top_fluxes = True

    def __init__(self, mixing_length=None, tke_equation=None,
                 maximum_viscosity=float("inf"),
                 maximum_tracer_diffusivity=float("inf"),
                 minimum_tke=1e-9,
                 minimum_convective_buoyancy_flux=1e-11,
                 negative_tke_damping_time_scale=60.0):
        self.mixing_length = mixing_length or CATKEMixingLength()
        self.tke_equation = tke_equation or CATKEEquation()
        self.maximum_viscosity = float(maximum_viscosity)
        self.maximum_tracer_diffusivity = float(maximum_tracer_diffusivity)
        self.minimum_tke = float(minimum_tke)
        self.Jb_eps = float(minimum_convective_buoyancy_flux)
        self.neg_damping = float(negative_tke_damping_time_scale)

    def _sigma(self, Ri, Cun, Clo, Chi):
        """σ(Ri): Cun for Ri < 0; for Ri ≥ 0, Clo to Chi over the step
        [CRi0, CRi0 + CRiδ]."""
        ml = self.mixing_length
        t = torch.clamp((Ri - ml.CRi0) / ml.CRi_delta, 0.0, 1.0)
        return torch.where(Ri < 0, Cun, Clo + (Chi - Clo) * t)

    def _stable_length(self, sigma, w_star, N2, d_up, d_down):
        lN = torch.where(N2 > 0,
                         w_star / torch.sqrt(torch.clamp(N2, min=1e-30)),
                         1e20)
        return sigma * torch.minimum(torch.minimum(d_up, d_down), lN)

    def _convective_length(self, Cc, Ce, w_star, S2, N2, N2_above, Jb,
                           depth):
        ml = self.mixing_length
        Jb_tot = Jb + self.Jb_eps
        lc = Cc * w_star ** 3 / Jb_tot
        Rif = depth * w_star * S2 / Jb_tot    # flux Richardson number
        lc = torch.clamp((1.0 - ml.Csp * Rif) * lc, min=0.0)
        le = Ce * Jb / (w_star * N2 + self.Jb_eps)
        convecting = (Jb > self.Jb_eps) & (N2 < 0)
        entraining = (Jb > self.Jb_eps) & (N2 > 0) & (N2_above < 0)
        return torch.where(convecting, lc,
                           torch.where(entraining, le, 0.0))

    def _lengths_at(self, grid, e_loc, N2, S2, Ri, Jb, z, coeffs):
        """The mixing length of one quantity at the z-faces; ``coeffs`` =
        (Cun, Clo, Chi, Cc, Ce)."""
        Cun, Clo, Chi, Cc, Ce = coeffs
        ml = self.mixing_length
        w_star = torch.sqrt(torch.clamp(e_loc, min=0.0))
        depth = torch.clamp(-z, min=0.0)              # surface at z = 0
        habove = torch.clamp(z + grid.Lz, min=0.0)
        sigma = self._sigma(Ri, Cun, Clo, Chi)
        l_star = self._stable_length(sigma, w_star, N2, ml.Cs * depth,
                                     ml.Cb * habove)
        lh = self._convective_length(Cc, Ce, w_star, S2, N2,
                                     shift(N2, 1, Z), Jb, depth)
        return torch.clamp(torch.maximum(l_star, lh), max=grid.Lz)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy,
                              top_fluxes=None):
        top_fluxes = top_fluxes or {}
        e = tracers["e"]
        e_ccf = iz_f(e)
        N2_ccf = (buoyancy_frequency(grid, buoyancy, tracers)
                  if buoyancy is not None else torch.zeros_like(e_ccf))
        S2_ccf = _shear_squared_ccf(grid, u, v)
        Ri_ccf = N2_ccf / torch.clamp(S2_ccf, min=1e-20)
        Jb = top_fluxes.get("b")
        Jb = _value_on(0.0 if Jb is None else Jb, e)
        Jb = torch.clamp(Jb, min=0.0)   # only a destabilizing flux convects

        ml = self.mixing_length
        zF = grid.zF.expand(grid.shape)
        lengths = [self._lengths_at(grid, e_ccf, N2_ccf, S2_ccf, Ri_ccf, Jb,
                                    zF, coeffs)
                   for coeffs in ((ml.Cun_u, ml.Clo_u, ml.Chi_u, ml.Cc_u,
                                   ml.Ce_u),
                                  (ml.Cun_c, ml.Clo_c, ml.Chi_c, ml.Cc_c,
                                   ml.Ce_c),
                                  (ml.Cun_e, ml.Clo_e, ml.Chi_e, ml.Cc_e,
                                   ml.Ce_e))]
        ell_u, ell_c, ell_e = lengths
        w_star_ccf = torch.sqrt(torch.clamp(e_ccf, min=self.minimum_tke))
        ku = torch.clamp(ell_u * w_star_ccf, max=self.maximum_viscosity)
        kc = torch.clamp(ell_c * w_star_ccf,
                         max=self.maximum_tracer_diffusivity)
        ke = torch.clamp(ell_e * w_star_ccf,
                         max=self.maximum_tracer_diffusivity)

        # the dissipation rate at the centres, with its own coefficients;
        # its stability function divides the stable length
        te = self.tke_equation
        N2_ccc = iz_c(N2_ccf)
        S2_ccc = iz_c(S2_ccf)
        Ri_ccc = N2_ccc / torch.clamp(S2_ccc, min=1e-20)
        zC = grid.zC.expand(grid.shape)
        sigma_D = self._sigma(Ri_ccc, te.Cun_D, te.Clo_D, te.Chi_D)
        w_star_ccc = torch.sqrt(torch.clamp(e, min=0.0))
        depth_c = torch.clamp(-zC, min=0.0)
        habove_c = torch.clamp(zC + grid.Lz, min=0.0)
        l_star_D = self._stable_length(1.0 / sigma_D, w_star_ccc, N2_ccc,
                                       ml.Cs * depth_c, ml.Cb * habove_c)
        lh_D = self._convective_length(te.Cc_D, te.Ce_D, w_star_ccc, S2_ccc,
                                       N2_ccc, shift(N2_ccc, 1, Z), Jb,
                                       depth_c)
        ell_D = torch.clamp(torch.maximum(l_star_D, lh_D), max=grid.Lz)
        omega = torch.where(
            e < 0, 1.0 / self.neg_damping,
            torch.sqrt(torch.abs(e)) / torch.clamp(ell_D, min=1e-10))

        # the surface TKE flux from the momentum and buoyancy surface fluxes
        tx = _value_on(top_fluxes.get("u", 0.0), e)
        ty = _value_on(top_fluxes.get("v", 0.0), e)
        u_star = (tx ** 2 + ty ** 2) ** 0.25
        dz_top = _surface_cell_height(grid)
        wdelta3 = torch.clamp(Jb, min=0.0) * dz_top
        J_e = -(te.CW_ustar * u_star ** 3 + te.CW_wdelta * wdelta3)

        # the linear implicit coefficient of ∂t e = Le e + …: the
        # dissipation −ω e and the destabilizing part of the buoyancy flux
        # go into the diagonal of the implicit solve (a Patankar split), so
        # a large Δt cannot drive e negative through explicit destruction
        in_faces = _interior_faces(grid, e.device)
        wb_ccf = torch.where(in_faces, -kc * N2_ccf, 0.0)
        wb_minus = iz_c(torch.clamp(wb_ccf, max=0.0))
        Le = wb_minus / torch.clamp(e, min=self.minimum_tke) - omega

        return {"nu_z_ccf": ku, "kappa_z_ccf": kc, "kappa_e_ccf": ke,
                "mixing_length_ccf": ell_u, "N2_ccf": N2_ccf,
                "shear_production_ccf": ku * S2_ccf,
                "dissipation_rate_ccc": omega, "Le_ccc": Le,
                "tke_top_flux": J_e, "dz_top": dz_top}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        zero = torch.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                torch.zeros_like(w))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if name == "e":
            # the explicit sources: shear production and the stabilizing
            # part of the buoyancy flux, and the surface TKE flux into the
            # top cell; dissipation and the destabilizing part are implicit
            kc = diffusivities["kappa_z_ccf"]
            wb = torch.clamp(-kc * diffusivities["N2_ccf"], min=0.0)
            in_faces = _interior_faces(grid, c.device)
            source = torch.where(
                in_faces, diffusivities["shear_production_ccf"] + wb, 0.0)
            src = iz_c(source)
            k = torch.arange(grid.shape[2], device=c.device).reshape(1, 1, -1)
            top_cell = k == grid.H[2] + grid.N[2] - 1
            return src + torch.where(
                top_cell, -diffusivities["tke_top_flux"]
                / diffusivities["dz_top"], 0.0)
        if not include_implicit:
            return torch.zeros_like(c)
        fz = diffusivities["kappa_z_ccf"] * dz_f(c) / grid.dz(Face)
        zero = torch.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def implicit_linear_coefficient(self, grid, diffusivities, name):
        """The diagonal L of ∂t e = L e + … (dissipation and the
        destabilizing buoyancy flux), solved with the vertical
        diffusion."""
        if name == "e":
            return diffusivities["Le_ccc"]
        return None

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        if name == "e":
            return diffusivities["kappa_e_ccf"]
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return "CATKEVerticalDiffusivity(reference coefficient set)"


class VariableStabilityFunctions:
    """Umlauf & Burchard (2005) stability functions of k-ε: rational
    functions 𝕊(αᴺ, αᴹ) of the stratification number αᴺ = τ²N² and the
    shear number αᴹ = τ²S², with the realizability clamps (the
    free-convection minimum of αᴺ scaled by a safety factor, and the
    maximum αᴹ(αᴺ))."""

    def __init__(self, Csigma_e=1.0, Csigma_eps=1.2,
                 Cu0=0.1067, Cu1=0.0173, Cu2=-0.0001205,
                 Cc0=0.1120, Cc1=0.003766, Cc2=0.0008871,
                 Cd0=1.0, Cd1=0.2398, Cd2=0.02872, Cd3=0.005154,
                 Cd4=0.006930, Cd5=-0.0003372, Su0=None):
        self.Csigma_e = float(Csigma_e)
        self.Csigma_eps = float(Csigma_eps)
        self.Cu0, self.Cu1, self.Cu2 = float(Cu0), float(Cu1), float(Cu2)
        self.Cc0, self.Cc1, self.Cc2 = float(Cc0), float(Cc1), float(Cc2)
        self.Cd0, self.Cd1, self.Cd2 = float(Cd0), float(Cd1), float(Cd2)
        self.Cd3, self.Cd4, self.Cd5 = float(Cd3), float(Cd4), float(Cd5)
        if Su0 is None:
            # the log-layer equilibrium (production = dissipation)
            a = self.Cd5 - self.Cu2
            b = self.Cd2 - self.Cu0
            c = self.Cd0
            Su0 = (2 * a / (-b - math.sqrt(b * b - 4 * a * c))) ** 0.25
        self.Su0 = float(Su0)

    def minimum_stratification_number(self, safety):
        """The free-convection realizability bound, reduced by the safety
        factor."""
        a = self.Cd4 + self.Cc1
        b = self.Cd1 + self.Cc0
        c = self.Cd0
        return safety * (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)

    def maximum_shear_number(self, aN):
        """The shear-anisotropy bound αᴹmax(αᴺ)."""
        n0, n1 = self.Cu0, self.Cu1
        d0, d1, d2, d3, d4 = (self.Cd0, self.Cd1, self.Cd2, self.Cd3,
                              self.Cd4)
        e0 = d0 * n0
        e1 = d0 * n1 + d1 * n0
        e2 = d1 * n1 + d4 * n0
        e3 = d4 * n1
        e4 = d2 * n0
        e5 = d2 * n1 + d3 * n0
        e6 = d3 * n1
        num = e0 + e1 * aN + e2 * aN ** 2 + e3 * aN ** 3
        den = e4 + e5 * aN + e6 * aN ** 2
        return num / den

    def momentum_and_tracer(self, aN, aM):
        den = (self.Cd0 + self.Cd1 * aN + self.Cd2 * aM
               + self.Cd3 * aN * aM + self.Cd4 * aN ** 2
               + self.Cd5 * aM ** 2)
        Su = (self.Cu0 + self.Cu1 * aN + self.Cu2 * aM) / den
        Sc = (self.Cc0 + self.Cc1 * aN + self.Cc2 * aM) / den
        return Su, Sc

    def __repr__(self):
        return "VariableStabilityFunctions()"


class TKEDissipationVerticalDiffusivity(AbstractClosure):
    """k-ε: two prognostic tracers, the TKE ``e`` and its dissipation rate
    ``eps`` (Umlauf & Burchard 2003/2005). The diffusivities 𝕊 e★²/ε★ at
    the z-faces with :class:`VariableStabilityFunctions`; the dissipation
    floored by the stratified displacement scale Cᴺ √(e★/N²⁺); the sources
    split Patankar-style: the positive parts explicit, the destruction
    terms as linear coefficients of the implicit solve, with negative-TKE
    damping."""

    time_discretization = VerticallyImplicitTimeDiscretization
    required_tracers = ("e", "eps")

    def __init__(self, Ceps_eps=1.92, Cp_eps=1.44,
                 Cb_eps_stable=-0.65, Cb_eps_unstable=-0.65,
                 stability_functions=None,
                 Cn_length=0.75, minimum_N2=1e-14,
                 stratification_number_safety_factor=0.73,
                 maximum_viscosity=float("inf"),
                 maximum_tracer_diffusivity=float("inf"),
                 maximum_tke_diffusivity=float("inf"),
                 maximum_dissipation_diffusivity=float("inf"),
                 minimum_tke=1e-6, minimum_eps=1e-12,
                 negative_tke_damping_time_scale=60.0):
        self.Ceps_eps = float(Ceps_eps)
        self.Cp_eps = float(Cp_eps)
        self.Cb_eps_stable = float(Cb_eps_stable)
        self.Cb_eps_unstable = float(Cb_eps_unstable)
        self.stability_functions = (stability_functions
                                    or VariableStabilityFunctions())
        self.Cn_length = float(Cn_length)
        self.minimum_N2 = float(minimum_N2)
        self.safety = float(stratification_number_safety_factor)
        self.maximum_viscosity = float(maximum_viscosity)
        self.maximum_tracer_diffusivity = float(maximum_tracer_diffusivity)
        self.maximum_tke_diffusivity = float(maximum_tke_diffusivity)
        self.maximum_dissipation_diffusivity = float(
            maximum_dissipation_diffusivity)
        self.minimum_tke = float(minimum_tke)
        self.minimum_eps = float(minimum_eps)
        self.neg_damping = float(negative_tke_damping_time_scale)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        sf = self.stability_functions
        e_raw = tracers["e"]
        eps_raw = tracers["eps"]
        e_star = torch.clamp(e_raw, min=self.minimum_tke)
        N2_ccf = (buoyancy_frequency(grid, buoyancy, tracers)
                  if buoyancy is not None else torch.zeros_like(e_raw))
        S2_ccf = _shear_squared_ccf(grid, u, v)

        # the stratified displacement floor of the dissipation
        N2p_ccc = iz_c(torch.clamp(N2_ccf, min=self.minimum_N2))
        l_st = self.Cn_length * torch.sqrt(e_star / N2p_ccc)
        l_min = torch.clamp(l_st, max=grid.Lz)
        eps_floor = torch.clamp(sf.Su0 ** 3 * e_star ** 1.5 / l_min,
                                min=self.minimum_eps)
        eps_star = torch.maximum(eps_raw, eps_floor)

        # the stability functions on the realizability-clamped numbers
        tau2_ccf = iz_f((e_star / eps_star) ** 2)
        aN_min = sf.minimum_stratification_number(self.safety)
        aN = torch.clamp(tau2_ccf * N2_ccf, aN_min, 1e10)
        aM = torch.minimum(torch.clamp(tau2_ccf * S2_ccf, min=0.0),
                           sf.maximum_shear_number(aN))
        Su, Sc = sf.momentum_and_tracer(aN, aM)

        e2_over_eps = iz_f(e_star ** 2) / iz_f(eps_star)
        ku = torch.clamp(Su * e2_over_eps, max=self.maximum_viscosity)
        kc = torch.clamp(Sc * e2_over_eps,
                         max=self.maximum_tracer_diffusivity)
        ke = torch.clamp(Su / sf.Csigma_e * e2_over_eps,
                         max=self.maximum_tke_diffusivity)
        keps = torch.clamp(Su / sf.Csigma_eps * e2_over_eps,
                           max=self.maximum_dissipation_diffusivity)

        # the source ingredients at the centres (interior z-faces only)
        mask = _interior_faces(grid, e_raw.device)
        P_ccc = iz_c(torch.where(mask, ku * S2_ccf, 0.0))
        wb_ccc = -iz_c(torch.where(mask, kc * N2_ccf, 0.0))
        omega_e = torch.where(e_raw < 0, 1.0 / self.neg_damping,
                              eps_star / e_star)
        omega_eps = eps_raw / e_star
        N2_ccc = iz_c(N2_ccf)
        Cb = torch.where(N2_ccc >= 0,
                         torch.full_like(N2_ccc, self.Cb_eps_stable),
                         torch.full_like(N2_ccc, self.Cb_eps_unstable))
        Cb_wb = Cb * wb_ccc
        active = e_raw > self.minimum_tke
        wb_minus_over_e = torch.where(
            active, torch.clamp(wb_ccc, max=0.0)
            / torch.where(active, e_raw, 1.0), 0.0)

        return {"nu_z_ccf": ku, "kappa_z_ccf": kc,
                "kappa_e_ccf": ke, "kappa_eps_ccf": keps,
                "P_ccc": P_ccc, "wb_ccc": wb_ccc,
                "Le_ccc": wb_minus_over_e - omega_e,
                "Leps_ccc": (torch.clamp(Cb_wb, max=0.0) / e_star
                             - self.Ceps_eps * omega_eps),
                "Ge_fast_ccc": P_ccc + torch.clamp(wb_ccc, min=0.0),
                "Geps_fast_ccc": omega_eps * (self.Cp_eps * P_ccc
                                              + torch.clamp(Cb_wb, min=0.0)),
                "N2_ccf": N2_ccf}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        if not include_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        zero = torch.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                torch.zeros_like(w))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if name == "e":
            # the positive sources only; the destruction is in the linear
            # implicit coefficient
            return diffusivities["Ge_fast_ccc"]
        if name == "eps":
            return diffusivities["Geps_fast_ccc"]
        if not include_implicit:
            return torch.zeros_like(c)
        fz = diffusivities["kappa_z_ccf"] * dz_f(c) / grid.dz(Face)
        zero = torch.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def implicit_linear_coefficient(self, grid, diffusivities, name):
        """The diagonal L of ∂t q = L q + …, solved with the vertical
        diffusion."""
        if name == "e":
            return diffusivities["Le_ccc"]
        if name == "eps":
            return diffusivities["Leps_ccc"]
        return None

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        if name == "e":
            return diffusivities["kappa_e_ccf"]
        if name == "eps":
            return diffusivities["kappa_eps_ccf"]
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return ("TKEDissipationVerticalDiffusivity(k-epsilon, "
                "variable stability functions)")


class LeithEnstrophyDiffusivity(AbstractClosure):
    """The 2-D Leith horizontal eddy viscosity ν = (C Δ/π)³ |∇ζ|."""

    def __init__(self, C=1.0):
        self.C = float(C)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        zeta = vorticity_z_ff(grid, u, v)
        dzx = ix_c(dx_f(iy_c(zeta))) / grid.dx(Center, Center)
        dzy = iy_c(dy_f(ix_c(zeta))) / grid.dy(Center, Center)
        grad_z = torch.sqrt(dzx * dzx + dzy * dzy)
        delta = torch.sqrt(grid.dx(Center, Center) * grid.dy(Center, Center))
        return {"nu_e": (self.C * delta / math.pi) ** 3 * grad_z}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w,
                                        include_z=False)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        return _laplacian_tracer_div(grid, diffusivities["nu_e"], c,
                                     include_z=False)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"LeithEnstrophyDiffusivity(C={self.C})"


class IsopycnalSkewSymmetricDiffusivity(AbstractClosure):
    """Gent-McWilliams and Redi: along-isopycnal tracer diffusion (κ_R)
    and the eddy-induced skew flux (κ_GM) in the small-slope
    approximation, the slope terms tapered (Gerdes-Köberle-Willebrand)
    above ``maximum_slope``:

        Fx = −κ_R ∂x c − (κ_R − κ_GM) Sx ∂z c
        Fy = −κ_R ∂y c − (κ_R − κ_GM) Sy ∂z c
        Fz = −(κ_R + κ_GM)(Sx ∂x c + Sy ∂y c) − κ_R |S|² ∂z c − κ_z ∂z c

    with the slopes S = −∇ₕb / ∂z b. Each face takes its slope and tracer
    gradients from the same stencils, so a tracer aligned with the
    isopycnals feels no Redi flux."""

    def __init__(self, kappa_redi=1000.0, kappa_gm=1000.0,
                 maximum_slope=1e-2, kappa_z=1e-5):
        self.kappa_redi = float(kappa_redi)
        self.kappa_gm = float(kappa_gm)
        self.maximum_slope = float(maximum_slope)
        self.kappa_z = float(kappa_z)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        return {"b": buoyancy.buoyancy_ccc(grid, tracers)}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        return 0.0, 0.0, 0.0

    def _taper(self, Sx, Sy):
        """min(1, (Smax/|S|)²)."""
        smax = self.maximum_slope
        S2 = Sx * Sx + Sy * Sy
        return torch.clamp(smax * smax / torch.clamp(S2, min=1e-30),
                           max=1.0)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        kR, kG = self.kappa_redi, self.kappa_gm
        b = diffusivities["b"]
        floor = 1e-12

        def grads_at_xface(q):
            qx = dx_f(q) / grid.dx(Face, Center)
            qz = ix_f(iz_c(dz_f(q) / grid.dz(Face)))
            return qx, qz

        def grads_at_yface(q):
            qy = dy_f(q) / grid.dy(Face, Center)
            qz = iy_f(iz_c(dz_f(q) / grid.dz(Face)))
            return qy, qz

        def grads_at_zface(q):
            qz = dz_f(q) / grid.dz(Face)
            qx = iz_f(ix_c(dx_f(q) / grid.dx(Face, Center)))
            qy = iz_f(iy_c(dy_f(q) / grid.dy(Face, Center)))
            return qx, qy, qz

        # the taper multiplies the whole slope-dependent term (raw slopes
        # inside), so tapered regions fall back to horizontal diffusion
        # while the c ≡ b cancellation stays exact
        bx, bzx = grads_at_xface(b)
        Sx_f = -bx / torch.clamp(bzx, min=floor)
        tx = self._taper(Sx_f, 0.0)
        cx, czx = grads_at_xface(c)
        fx = kR * cx + tx * (kR - kG) * Sx_f * czx

        by, bzy = grads_at_yface(b)
        Sy_f = -by / torch.clamp(bzy, min=floor)
        ty = self._taper(0.0, Sy_f)
        cy, czy = grads_at_yface(c)
        fy = kR * cy + ty * (kR - kG) * Sy_f * czy

        # at wall faces ∂z b → 0 through the mirror halos, the slopes blow
        # up and the taper drives the slope terms to zero
        bxz, byz, bz = grads_at_zface(b)
        Sxz = -bxz / torch.clamp(bz, min=floor)
        Syz = -byz / torch.clamp(bz, min=floor)
        tz = self._taper(Sxz, Syz)
        cxz, cyz, cz = grads_at_zface(c)
        fz = (tz * ((kR + kG) * (Sxz * cxz + Syz * cyz)
                    + kR * (Sxz * Sxz + Syz * Syz) * cz)
              + self.kappa_z * cz)
        return _div_c_fluxes(grid, fx, fy, fz)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return (f"IsopycnalSkewSymmetricDiffusivity(κ_R={self.kappa_redi}, "
                f"κ_GM={self.kappa_gm})")


__all__ = ["CATKEEquation", "CATKEMixingLength", "CATKEVerticalDiffusivity",
           "IsopycnalSkewSymmetricDiffusivity", "LeithEnstrophyDiffusivity",
           "RiBasedVerticalDiffusivity",
           "TKEDissipationVerticalDiffusivity", "VariableStabilityFunctions"]
