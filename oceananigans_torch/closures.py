"""Turbulence closures: viscous and diffusive flux divergences and eddy
coefficients.

Counterpart of ``oceananigans_tpu/closures.py``. A closure gives the
momentum stress divergences and each tracer's flux divergence, a
``compute_diffusivities`` pass run each step, and an explicit or vertically
implicit time discretization; the latter routes vertical diffusion into a
backward-Euler tridiagonal solve down every column
(:func:`implicit_vertical_diffusion_step`, on
``solvers/tridiagonal.py``). Fluxes are whole-tensor expressions with the
staggering of the advective fluxes; eddy coefficients (Smagorinsky, AMD,
convective adjustment) are center-located tensors recomputed each step.
The JAX package reaches no Pallas kernel here, and neither does the port:
this is plain PyTorch on both the CPU and the GPU. The ocean closures
(CATKE and the rest) are in ``closures_ocean.py``, on the same interface.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.immersed import mask_flux as _mask_flux
from oceananigans_torch.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f,
    X, Y, Z, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f, shift,
)
from oceananigans_torch.solvers.tridiagonal import tridiagonal_solve

ExplicitTimeDiscretization = "explicit"
VerticallyImplicitTimeDiscretization = "vertically_implicit"


def _kappa_for(kappa, name):
    """Per-tracer diffusivity: a value, or a dict keyed by tracer name."""
    if isinstance(kappa, dict):
        return kappa.get(name, 0.0)
    return kappa


# ---------------------------------------------------------------------------
# Flux-divergence assembly. Diffusive fluxes mirror the advective flux
# staggering:
#   tracer  c(c,c,c): qx at (f,c,c), qy at (c,f,c), qz at (c,c,f)
#   u(f,c,c): τxx at (c,c,c), τxy at (f,f,c), τxz at (f,c,f)
#   v(c,f,c): τyx at (f,f,c), τyy at (c,c,c), τyz at (c,f,f)
#   w(c,c,f): τzx at (f,c,f), τzy at (c,f,f), τzz at (c,c,c)
# ν is center-located (c,c,c); it is interpolated onto each flux point.
# ---------------------------------------------------------------------------

def _nu_at(nu, to):
    """Interpolate a center-located coefficient to a staggered flux point;
    ``to`` names the axes to face-shift, e.g. "xy"."""
    if not torch.is_tensor(nu) or nu.ndim == 0:
        return nu
    for ax in to:
        nu = {"x": ix_f, "y": iy_f, "z": iz_f}[ax](nu)
    return nu


def _div_u_fluxes(grid, fx_ccc, fy_ffc, fz_fcf):
    """Divergence of the fluxes of a (f,c,c)-located field. On a grid with
    a solid mask (an immersed grid, the cubed sphere's bathymetry view)
    every flux is zeroed through and inside the boundary: the default
    free-slip, no-flux immersed boundary."""
    fx_ccc = _mask_flux(grid, fx_ccc, (Center, Center, Center))
    fy_ffc = _mask_flux(grid, fy_ffc, (Face, Face, Center))
    fz_fcf = _mask_flux(grid, fz_fcf, (Face, Center, Face))
    return (dx_f(grid.Ax(Center, Center, Center) * fx_ccc)
            + dy_c(grid.Ay(Face, Face, Center) * fy_ffc)
            + dz_c(grid.Az(Face, Center) * fz_fcf)) / grid.V(
                Face, Center, Center)


def _div_v_fluxes(grid, fx_ffc, fy_ccc, fz_cff):
    fx_ffc = _mask_flux(grid, fx_ffc, (Face, Face, Center))
    fy_ccc = _mask_flux(grid, fy_ccc, (Center, Center, Center))
    fz_cff = _mask_flux(grid, fz_cff, (Center, Face, Face))
    return (dx_c(grid.Ax(Face, Face, Center) * fx_ffc)
            + dy_f(grid.Ay(Center, Center, Center) * fy_ccc)
            + dz_c(grid.Az(Center, Face) * fz_cff)) / grid.V(
                Center, Face, Center)


def _div_w_fluxes(grid, fx_fcf, fy_cff, fz_ccc):
    fx_fcf = _mask_flux(grid, fx_fcf, (Face, Center, Face))
    fy_cff = _mask_flux(grid, fy_cff, (Center, Face, Face))
    fz_ccc = _mask_flux(grid, fz_ccc, (Center, Center, Center))
    return (dx_c(grid.Ax(Face, Center, Face) * fx_fcf)
            + dy_c(grid.Ay(Center, Face, Face) * fy_cff)
            + dz_f(grid.Az(Center, Center) * fz_ccc)) / grid.V(
                Center, Center, Face)


def _div_c_fluxes(grid, fx_fcc, fy_cfc, fz_ccf):
    fx_fcc = _mask_flux(grid, fx_fcc, (Face, Center, Center))
    fy_cfc = _mask_flux(grid, fy_cfc, (Center, Face, Center))
    fz_ccf = _mask_flux(grid, fz_ccf, (Center, Center, Face))
    return (dx_c(grid.Ax(Face, Center, Center) * fx_fcc)
            + dy_c(grid.Ay(Center, Face, Center) * fy_cfc)
            + dz_c(grid.Az(Center, Center) * fz_ccf)) / grid.V(
                Center, Center, Center)


def _laplacian_momentum_divs(grid, nu_ccc, u, v, w, include_z=True,
                             include_h=True):
    """(∇·τ) of u, v, w for an isotropic (possibly spatially varying)
    viscosity in Laplacian form, τ = ν ∂ⱼ uᵢ."""
    zeros_u = torch.zeros_like(u)

    # u fluxes
    fxx = (_nu_at(nu_ccc, "") * dx_c(u) / grid.dx(Center, Center)
           if include_h else zeros_u)
    fxy = (_nu_at(nu_ccc, "xy") * dy_f(u) / grid.dy(Face, Face)
           if include_h else zeros_u)
    fxz = (_nu_at(nu_ccc, "xz") * dz_f(u) / grid.dz(Face)
           if include_z else zeros_u)
    # v fluxes
    fyx = (_nu_at(nu_ccc, "xy") * dx_f(v) / grid.dx(Face, Face)
           if include_h else zeros_u)
    fyy = (_nu_at(nu_ccc, "") * dy_c(v) / grid.dy(Center, Center)
           if include_h else zeros_u)
    fyz = (_nu_at(nu_ccc, "yz") * dz_f(v) / grid.dz(Face)
           if include_z else zeros_u)
    # w fluxes
    fzx = (_nu_at(nu_ccc, "xz") * dx_f(w) / grid.dx(Face, Center)
           if include_h else zeros_u)
    fzy = (_nu_at(nu_ccc, "yz") * dy_f(w) / grid.dy(Face, Center)
           if include_h else zeros_u)
    fzz = (_nu_at(nu_ccc, "") * dz_c(w) / grid.dz(Center)
           if include_z else zeros_u)

    du = _div_u_fluxes(grid, fxx, fxy, fxz)
    dv = _div_v_fluxes(grid, fyx, fyy, fyz)
    dw = _div_w_fluxes(grid, fzx, fzy, fzz)
    return du, dv, dw


def _laplacian_tracer_div(grid, kappa_ccc, c, include_z=True,
                          include_h=True):
    """∇·(κ∇c) at centers. With neither direction the divergence of zero
    fluxes is exactly zero, returned as the number 0.0 without computing
    it."""
    if not (include_h or include_z):
        return 0.0
    zero = torch.zeros_like(c)
    fx = (_nu_at(kappa_ccc, "x") * dx_f(c) / grid.dx(Face, Center)
          if include_h else zero)
    fy = (_nu_at(kappa_ccc, "y") * dy_f(c) / grid.dy(Face, Center)
          if include_h else zero)
    fz = (_nu_at(kappa_ccc, "z") * dz_f(c) / grid.dz(Face)
          if include_z else zero)
    return _div_c_fluxes(grid, fx, fy, fz)


# ---------------------------------------------------------------------------
# Closures
# ---------------------------------------------------------------------------

class AbstractClosure:
    time_discretization = ExplicitTimeDiscretization

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        """The eddy coefficients of this step (None for constant ones)."""
        return None

    @property
    def vertically_implicit(self):
        return (self.time_discretization
                == VerticallyImplicitTimeDiscretization)

    def required_halo(self):
        return 1


class ScalarDiffusivity(AbstractClosure):
    """Laplacian diffusion with a viscosity ν and a diffusivity κ (one for
    all tracers, or a dict keyed by tracer name), each a number, a
    center-located array or a callable ``f(x, y, z)`` evaluated at cell
    centers. ``isotropy``: "iso" (all directions), "vertical" or
    "horizontal"."""

    def __init__(self, nu=0.0, kappa=0.0, isotropy="iso",
                 time_discretization=ExplicitTimeDiscretization):
        self.nu = nu
        self.kappa = kappa
        self.isotropy = isotropy
        self.time_discretization = time_discretization

    def _coeff(self, grid, c):
        """A coefficient as a number or a tensor on the grid; an array or a
        callable ``f(x, y, z)`` is carried onto the grid once and kept."""
        if not (callable(c) or isinstance(c, (np.ndarray, torch.Tensor))):
            return c
        cache = self.__dict__.setdefault("_on_grid", {})
        key = (id(c), grid.device, grid.dtype, tuple(grid.shape))
        if key not in cache:
            if callable(c):
                from oceananigans_torch.fields import set_field
                cache[key] = set_field(grid, c)
            else:
                cache[key] = torch.as_tensor(c, dtype=grid.dtype,
                                             device=grid.device)
        return cache[key]

    def _flags(self, include_implicit):
        include_z = self.isotropy != "horizontal" and (
            include_implicit or not self.vertically_implicit)
        return include_z, self.isotropy != "vertical"

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        include_z, include_h = self._flags(include_implicit)
        if not include_h:
            if not include_z:
                return 0.0, 0.0, 0.0
            nu = self._coeff(grid, self.nu)
            fxz = _nu_at(nu, "xz") * dz_f(u) / grid.dz(Face)
            fyz = _nu_at(nu, "yz") * dz_f(v) / grid.dz(Face)
            fzz = nu * dz_c(w) / grid.dz(Center)
            zero = torch.zeros_like(u)
            du = _div_u_fluxes(grid, zero, zero, fxz)
            dv = _div_v_fluxes(grid, zero, zero, fyz)
            dw = _div_w_fluxes(grid, zero, zero, fzz)
            return du, dv, dw
        return _laplacian_momentum_divs(grid, self._coeff(grid, self.nu),
                                        u, v, w, include_z=include_z)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        include_z, include_h = self._flags(include_implicit)
        kappa = self._coeff(grid, _kappa_for(self.kappa, name))
        return _laplacian_tracer_div(grid, kappa, c, include_z=include_z,
                                     include_h=include_h)

    # vertical coefficients of the implicit solve, at the z-faces
    def vertical_nu(self, grid, diffusivities):
        if self.isotropy == "horizontal":
            return 0.0
        return _nu_at(self._coeff(grid, self.nu), "z")

    def vertical_kappa(self, grid, diffusivities, name):
        if self.isotropy == "horizontal":
            return 0.0
        return _nu_at(self._coeff(grid, _kappa_for(self.kappa, name)), "z")

    def __repr__(self):
        return (f"ScalarDiffusivity(ν={self.nu}, κ={self.kappa}, "
                f"{self.isotropy}, {self.time_discretization})")


def VerticalScalarDiffusivity(nu=0.0, kappa=0.0,
                              time_discretization=ExplicitTimeDiscretization):
    return ScalarDiffusivity(nu, kappa, isotropy="vertical",
                             time_discretization=time_discretization)


def HorizontalScalarDiffusivity(nu=0.0, kappa=0.0):
    return ScalarDiffusivity(nu, kappa, isotropy="horizontal")


class ScalarBiharmonicDiffusivity(AbstractClosure):
    """∇⁴ hyperdiffusion with constant coefficients: the flux divergence of
    the Laplacian, applied twice with a sign flip."""

    def __init__(self, nu=0.0, kappa=0.0, isotropy="iso"):
        self.nu = nu
        self.kappa = kappa
        self.isotropy = isotropy

    def required_halo(self):
        return 2

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        include_z = self.isotropy != "horizontal"
        include_h = self.isotropy != "vertical"
        lu, lv, lw = _laplacian_momentum_divs(grid, 1.0, u, v, w,
                                              include_z=include_z,
                                              include_h=include_h)
        du, dv, dw = _laplacian_momentum_divs(grid, self.nu, lu, lv, lw,
                                              include_z=include_z,
                                              include_h=include_h)
        return -du, -dv, -dw

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        include_z = self.isotropy != "horizontal"
        include_h = self.isotropy != "vertical"
        lc = _laplacian_tracer_div(grid, 1.0, c, include_z=include_z,
                                   include_h=include_h)
        return -_laplacian_tracer_div(grid, _kappa_for(self.kappa, name), lc,
                                      include_z=include_z,
                                      include_h=include_h)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"ScalarBiharmonicDiffusivity(ν={self.nu}, κ={self.kappa})"


def _strain_rate_products_ccc(grid, u, v, w):
    """Σᵢⱼ SᵢⱼSᵢⱼ at cell centers. The diagonal components are natively
    (c,c,c); the off-diagonal ones live at edges and are interpolated back
    to centers."""
    Sxx = dx_c(u) / grid.dx(Center, Center)
    Syy = dy_c(v) / grid.dy(Center, Center)
    Szz = dz_c(w) / grid.dz(Center)
    # Sxy at (f,f,c)
    Sxy = 0.5 * (dy_f(u) / grid.dy(Face, Face) + dx_f(v) / grid.dx(Face, Face))
    # Sxz at (f,c,f)
    Sxz = 0.5 * (dz_f(u) / grid.dz(Face) + dx_f(w) / grid.dx(Face, Center))
    # Syz at (c,f,f)
    Syz = 0.5 * (dz_f(v) / grid.dz(Face) + dy_f(w) / grid.dy(Face, Center))
    return (Sxx * Sxx + Syy * Syy + Szz * Szz
            + 2.0 * ix_c(iy_c(Sxy * Sxy))
            + 2.0 * ix_c(iz_c(Sxz * Sxz))
            + 2.0 * iy_c(iz_c(Syz * Syz)))


def _delta_filter_ccc(grid):
    """(Δx Δy Δz)^(1/3) filter width at centers."""
    return (grid.dx(Center, Center) * grid.dy(Center, Center)
            * grid.dz(Center)) ** (1.0 / 3.0)


class SmagorinskyLilly(AbstractClosure):
    """Smagorinsky-Lilly LES closure:

    νₑ = (C Δ)² √(Σ 2SᵢⱼSᵢⱼ) ς,  ς² = max(0, 1 − N²/(Cb Pr |S|²)),
    κₑ = νₑ / Pr.
    """

    def __init__(self, C=0.16, Cb=1.0, Pr=1.0):
        self.C = float(C)
        self.Cb = float(Cb)
        self.Pr = Pr

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_torch.buoyancy import buoyancy_frequency
        tr2 = 2.0 * _strain_rate_products_ccc(grid, u, v, w)
        delta = _delta_filter_ccc(grid)
        if buoyancy is not None and self.Cb != 0.0:
            N2 = iz_c(buoyancy_frequency(grid, buoyancy, tracers))
            Pr = _kappa_for(self.Pr, None) or 1.0
            denom = torch.clamp(tr2, min=1e-30)
            stability = torch.sqrt(torch.clamp(
                1.0 - self.Cb * N2 / (Pr * denom), 0.0, 1.0))
        else:
            stability = 1.0
        nu_e = (self.C * delta) ** 2 * torch.sqrt(tr2) * stability
        return {"nu_e": nu_e}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        Pr = _kappa_for(self.Pr, name)
        return _laplacian_tracer_div(grid, diffusivities["nu_e"] / Pr, c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0   # explicit only

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"SmagorinskyLilly(C={self.C}, Cb={self.Cb}, Pr={self.Pr})"


def _box_filter_ccc(a):
    """Top-hat 2Δ test filter at centers (trapezoidal 3-point per axis)."""
    fx = 0.25 * (shift(a, -1, X) + 2.0 * a + shift(a, 1, X))
    fy = 0.25 * (shift(fx, -1, Y) + 2.0 * fx + shift(fx, 1, Y))
    return 0.25 * (shift(fy, -1, Z) + 2.0 * fy + shift(fy, 1, Z))


class DynamicSmagorinsky(AbstractClosure):
    """Scale-invariant dynamic Smagorinsky: the coefficient follows from the
    Germano identity with a 2Δ test filter, averaged over the
    ``averaging_dims`` (horizontal planes by default; the classic
    Germano-Lilly form):

        c_s² = ⟨L_ij M_ij⟩ / ⟨M_ij M_ij⟩,   ν_e = c_s² Δ² √(2 S_ij S_ij)
    """

    def __init__(self, Pr=1.0, averaging_dims=(0, 1)):
        self.Pr = Pr
        self.averaging_dims = tuple(averaging_dims)

    def _collocated_strain(self, grid, u, v, w):
        dxs = grid.dx(Center, Center)
        dys = grid.dy(Center, Center)
        dzs = grid.dz(Center)
        ux = dx_c(u) / dxs
        vy = dy_c(v) / dys
        wz = dz_c(w) / dzs
        uy = ix_c(iy_c(dy_f(u))) / dys
        vx = iy_c(ix_c(dx_f(v))) / dxs
        uz = ix_c(iz_c(dz_f(u))) / dzs
        wx = iz_c(ix_c(dx_f(w))) / dxs
        vz = iy_c(iz_c(dz_f(v))) / dzs
        wy = iz_c(iy_c(dy_f(w))) / dys
        S = {(0, 0): ux, (1, 1): vy, (2, 2): wz,
             (0, 1): 0.5 * (uy + vx), (0, 2): 0.5 * (uz + wx),
             (1, 2): 0.5 * (vz + wy)}
        Smag = torch.sqrt(2.0 * (S[(0, 0)] ** 2 + S[(1, 1)] ** 2
                                 + S[(2, 2)] ** 2
                                 + 2 * (S[(0, 1)] ** 2 + S[(0, 2)] ** 2
                                        + S[(1, 2)] ** 2)))
        return S, Smag

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        vel = {0: ix_c(u), 1: iy_c(v), 2: iz_c(w)}
        S, Smag = self._collocated_strain(grid, u, v, w)
        delta2 = (grid.dx(Center, Center) * grid.dy(Center, Center)
                  * grid.dz(Center)) ** (2.0 / 3.0)
        LM = 0.0
        MM = 0.0
        for (i, j), Sij in S.items():
            mult = 1.0 if i == j else 2.0   # symmetric off-diagonals
            Lij = (_box_filter_ccc(vel[i] * vel[j])
                   - _box_filter_ccc(vel[i]) * _box_filter_ccc(vel[j]))
            # test-filter scale = 2Δ -> factor 4 on the filtered-scale term
            Mij = 2.0 * delta2 * (_box_filter_ccc(Smag * Sij)
                                  - 4.0 * _box_filter_ccc(Smag)
                                  * _box_filter_ccc(Sij))
            LM = LM + mult * Lij * Mij
            MM = MM + mult * Mij * Mij
        # per grid (per panel of a stacked cubed-sphere field)
        dims = tuple(d - 3 if d >= 0 else d for d in self.averaging_dims)
        LM_avg = torch.mean(LM, dim=dims, keepdim=True)
        MM_avg = torch.mean(MM, dim=dims, keepdim=True)
        cs2 = torch.clamp(-LM_avg / torch.clamp(MM_avg, min=1e-30),
                          0.0, 0.25)
        nu_e = cs2 * delta2 * Smag
        return {"nu_e": nu_e, "cs2": cs2}

    def momentum_flux_divergences(self, grid, u, v, w, tracers,
                                  diffusivities, include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        Pr = _kappa_for(self.Pr, name)
        return _laplacian_tracer_div(grid, diffusivities["nu_e"] / Pr, c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"DynamicSmagorinsky(Pr={self.Pr})"


class AnisotropicMinimumDissipation(AbstractClosure):
    """Verstappen's anisotropic minimum dissipation:

    νₑ = C max(0, −Σᵢⱼ (∂̂ᵢuⱼ)(∂̂ᵢuₖ)Sⱼₖ / Σᵢⱼ (∂ᵢuⱼ)²) with the
    directionally scaled gradients ∂̂ᵢ = Δᵢ ∂ᵢ, collocated at centers by
    interpolation. (``Cb`` and ``Pr`` are accepted and unused, as in the
    JAX package.)
    """

    def __init__(self, C=1 / 12, Cb=0.0, Pr=None):
        self.C = float(C)
        self.Cb = float(Cb)

    def _gradients_ccc(self, grid, u, v, w):
        dxs = grid.dx(Center, Center)
        dys = grid.dy(Center, Center)
        dzs = grid.dz(Center)
        # all nine ∂ᵢuⱼ interpolated to centers
        ux = dx_c(u) / dxs
        uy = ix_c(iy_c(dy_f(u))) / dys
        uz = ix_c(iz_c(dz_f(u))) / dzs
        vx = iy_c(ix_c(dx_f(v))) / dxs
        vy = dy_c(v) / dys
        vz = iy_c(iz_c(dz_f(v))) / dzs
        wx = iz_c(ix_c(dx_f(w))) / dxs
        wy = iz_c(iy_c(dy_f(w))) / dys
        wz = dz_c(w) / dzs
        return ((ux, uy, uz), (vx, vy, vz), (wx, wy, wz)), (dxs, dys, dzs)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        G, deltas = self._gradients_ccc(grid, u, v, w)
        # gradient matrix G[j][i] = ∂ᵢ u_j ; scaled Ĝ[j][i] = Δᵢ ∂ᵢ u_j
        Gh = tuple(tuple(d * g for d, g in zip(deltas, row)) for row in G)
        S = [[0.5 * (G[j][i] + G[i][j]) for i in range(3)] for j in range(3)]
        num = 0.0
        den = 0.0
        for j in range(3):
            for k in range(3):
                acc = 0.0
                for i in range(3):
                    acc = acc + Gh[j][i] * Gh[k][i]
                num = num + acc * S[j][k]
                den = den + G[j][k] * G[j][k]
        nu_e = (self.C * torch.clamp(-num, min=0.0)
                / torch.clamp(den, min=1e-30))
        return {"nu_e": nu_e, "kappa_e": nu_e}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        return _laplacian_momentum_divs(grid, diffusivities["nu_e"], u, v, w)

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        return _laplacian_tracer_div(grid, diffusivities["kappa_e"], c)

    def vertical_nu(self, grid, diffusivities):
        return 0.0

    def vertical_kappa(self, grid, diffusivities, name):
        return 0.0

    def __repr__(self):
        return f"AnisotropicMinimumDissipation(C={self.C})"


class ConvectiveAdjustmentVerticalDiffusivity(AbstractClosure):
    """A large convective κ/ν where the stratification is unstable (N² <
    0), background values elsewhere. Vertically implicit: the convective κ
    is huge."""

    time_discretization = VerticallyImplicitTimeDiscretization

    def __init__(self, convective_kappa_z=1.0, convective_nu_z=0.0,
                 background_kappa_z=0.0, background_nu_z=0.0):
        self.convective_kappa_z = float(convective_kappa_z)
        self.convective_nu_z = float(convective_nu_z)
        self.background_kappa_z = float(background_kappa_z)
        self.background_nu_z = float(background_nu_z)

    def compute_diffusivities(self, grid, u, v, w, tracers, buoyancy):
        from oceananigans_torch.buoyancy import buoyancy_frequency
        N2 = buoyancy_frequency(grid, buoyancy, tracers)  # (c,c,f)
        unstable = N2 < 0.0
        kz = torch.full_like(N2, self.background_kappa_z).masked_fill_(
            unstable, self.convective_kappa_z)
        nz = torch.full_like(N2, self.background_nu_z).masked_fill_(
            unstable, self.convective_nu_z)
        return {"kappa_z_ccf": kz, "nu_z_ccf": nz}

    def momentum_flux_divergences(self, grid, u, v, w, tracers, diffusivities,
                                  include_implicit=True):
        if not include_implicit and self.vertically_implicit:
            return 0.0, 0.0, 0.0
        nu = diffusivities["nu_z_ccf"]   # (c,c,f)
        fxz = ix_f(nu) * dz_f(u) / grid.dz(Face)
        fyz = iy_f(nu) * dz_f(v) / grid.dz(Face)
        fzz = iz_c(nu) * dz_c(w) / grid.dz(Center)
        zero = torch.zeros_like(u)
        return (_div_u_fluxes(grid, zero, zero, fxz),
                _div_v_fluxes(grid, zero, zero, fyz),
                _div_w_fluxes(grid, zero, zero, fzz))

    def tracer_flux_divergence(self, grid, name, c, tracers, diffusivities,
                               include_implicit=True):
        if not include_implicit and self.vertically_implicit:
            return torch.zeros_like(c)
        kz = diffusivities["kappa_z_ccf"]
        fz = kz * dz_f(c) / grid.dz(Face)
        zero = torch.zeros_like(c)
        return _div_c_fluxes(grid, zero, zero, fz)

    def vertical_nu(self, grid, diffusivities):
        return diffusivities["nu_z_ccf"]

    def vertical_kappa(self, grid, diffusivities, name):
        return diffusivities["kappa_z_ccf"]

    def __repr__(self):
        return (f"ConvectiveAdjustmentVerticalDiffusivity("
                f"κᶜ={self.convective_kappa_z}, κᵇ={self.background_kappa_z})")


# ---------------------------------------------------------------------------
# Closure tuples: models take one closure or a tuple; these helpers fan out
# over them.
# ---------------------------------------------------------------------------

def _as_tuple(closure):
    if closure is None:
        return ()
    if isinstance(closure, (tuple, list)):
        return tuple(closure)
    return (closure,)


def _max_closure_diffusivity(c, d, grid):
    """A conservative estimate of a closure's largest diffusivity: the max
    over its computed coefficient tensors and its numeric nu/kappa.
    Over-estimating only makes the wizard's Δt smaller."""
    vals = []
    for leaf in (d or {}).values():
        if torch.is_tensor(leaf) and leaf.ndim >= 1:
            vals.append(torch.max(torch.abs(leaf)))
    for attr in ("nu", "kappa"):
        a = getattr(c, attr, None)
        if isinstance(a, (int, float)):
            vals.append(abs(float(a)))
        elif isinstance(a, dict):
            vals.extend(abs(float(x)) for x in a.values()
                        if isinstance(x, (int, float)))
    out = torch.zeros((), dtype=grid.dtype, device=grid.device)
    for v in vals:
        out = torch.maximum(out, torch.as_tensor(v, dtype=grid.dtype,
                                                 device=grid.device))
    return out


def cell_diffusion_timescale(closure, grid, diffusivities=None):
    """min over the closures of Δmin^p / ν_max (p = 2 Laplacian, 4
    biharmonic), a 0-d tensor; +inf without a closure."""
    dmin = None
    for a in (grid.dx(Face, Center), grid.dy(Face, Center),
              grid.dz(Face)):
        ai = grid.interior(a.expand(grid.shape))
        if ai.numel():
            m = torch.min(ai)
            dmin = m if dmin is None else torch.minimum(dmin, m)
    inf = torch.tensor(float("inf"), dtype=grid.dtype, device=grid.device)
    tau = inf
    ds = (diffusivities if diffusivities is not None
          else (None,) * len(_as_tuple(closure)))
    for c, d in zip(_as_tuple(closure), ds):
        nu_max = _max_closure_diffusivity(c, d, grid)
        p = 4 if isinstance(c, ScalarBiharmonicDiffusivity) else 2
        tau = torch.minimum(tau, torch.where(nu_max > 0, dmin ** p / nu_max,
                                             inf))
    return tau


def compute_diffusivities(closure, grid, u, v, w, tracers, buoyancy,
                          top_fluxes=None):
    """Each closure's coefficients for this step, as a tuple. A closure
    with ``wants_top_fluxes`` also receives the mapping that the callable
    ``top_fluxes`` returns, called only for such a closure (the surface
    fluxes of u, v and b may be callables of time); without ``top_fluxes``
    it receives an empty mapping, as the JAX package's ``top_fluxes or
    {}`` gives it."""
    out = []
    for c in _as_tuple(closure):
        if getattr(c, "wants_top_fluxes", False):
            out.append(c.compute_diffusivities(
                grid, u, v, w, tracers, buoyancy,
                top_fluxes=top_fluxes() if top_fluxes is not None else {}))
        else:
            out.append(c.compute_diffusivities(grid, u, v, w, tracers,
                                               buoyancy))
    return tuple(out)


def momentum_flux_divergences(closure, grid, u, v, w, tracers,
                              diffusivities, include_implicit=True):
    du = dv = dw = 0.0
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        ddu, ddv, ddw = c.momentum_flux_divergences(
            grid, u, v, w, tracers, d, include_implicit=include_implicit)
        du = du + ddu
        dv = dv + ddv
        dw = dw + ddw
    return du, dv, dw


def tracer_flux_divergence(closure, grid, name, c_field, tracers,
                           diffusivities, include_implicit=True):
    out = 0.0
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        out = out + c.tracer_flux_divergence(
            grid, name, c_field, tracers, d, include_implicit=include_implicit)
    return out


def closure_is_vertically_implicit(closure):
    return any(c.vertically_implicit for c in _as_tuple(closure))


def closure_required_halo(closure):
    return max([c.required_halo() for c in _as_tuple(closure)] or [1])


# ---------------------------------------------------------------------------
# The vertically implicit diffusion step: solve (I − Δt ∂z κ ∂z) q* = q down
# every column with the batched Thomas solve.
# ---------------------------------------------------------------------------

def _implicit_step_field(grid, q, kappa_ccf, dt, lz=Center,
                         linear_ccc=None):
    """Backward-Euler vertical diffusion of one field. ``kappa_ccf`` is the
    vertical diffusivity at the z-faces bounding each cell (a number or a
    tensor that broadcasts against the grid). The solve runs over the
    halo-extended column; only the interior levels couple (halo levels get
    identity rows). ``linear_ccc``: the diagonal coefficient L of an extra
    linear term ∂t q = L q solved implicitly with the diffusion."""
    Hz, Nz = grid.H[Z], grid.N[Z]
    nz = grid.shape[Z]
    dzC = grid.dz(Center)     # cell heights
    dzF = grid.dz(Face)       # center-to-center
    if torch.is_tensor(kappa_ccf):
        kap = kappa_ccf.reshape((1,) * (3 - kappa_ccf.ndim)
                                + tuple(kappa_ccf.shape))
    else:   # a number, filled on the device without a copy from the host
        kap = torch.full((1, 1, 1), kappa_ccf, dtype=q.dtype,
                         device=q.device)

    # cell k couples down through face k (kappa[k]) and up through face
    # k + 1 (kappa[k + 1])
    kap_up = torch.roll(kap, -1, Z) if kap.shape[Z] > 1 else kap
    dzF_up = torch.roll(dzF, -1, Z)
    lower = -dt * kap / (dzC * dzF)
    upper = -dt * kap_up / (dzC * dzF_up)

    # zero flux at the physical boundaries: no coupling across the bottom
    # wall (face Hz) or the top wall (face Hz + Nz)
    k_idx = torch.arange(nz, device=q.device).reshape(1, 1, -1)
    in_interior = (k_idx >= Hz) & (k_idx < Hz + Nz)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    lower = torch.where((k_idx > Hz) & in_interior, lower, zero)
    upper = torch.where((k_idx < Hz + Nz - 1) & in_interior, upper, zero)
    diag = 1.0 - lower - upper
    if linear_ccc is not None:
        diag = diag - dt * torch.where(in_interior, linear_ccc, zero)
    return tridiagonal_solve(lower, diag, upper, q, axis=Z)


def implicit_vertical_diffusion_step(grid, closure, diffusivities, dt,
                                     u=None, v=None, tracers=None):
    """The implicit vertical-diffusion solve of the velocities and tracers
    for every vertically implicit closure; returns ``(u, v, tracers)``.
    ``dt`` is a number or a 0-d tensor (a host tensor stays on the host:
    it combines with device tensors without a copy)."""
    dt = torch.as_tensor(dt, dtype=grid.dtype)
    for c, d in zip(_as_tuple(closure), diffusivities or ()):
        if not c.vertically_implicit:
            continue
        nu = c.vertical_nu(grid, d)
        if u is not None and not _is_zero(nu):
            u = _implicit_step_field(grid, u, nu, dt)
            v = _implicit_step_field(grid, v, nu, dt)
        if tracers is not None:
            lin_of = getattr(c, "implicit_linear_coefficient", None)
            new_tracers = {}
            for name, cf in tracers.items():
                kap = c.vertical_kappa(grid, d, name)
                lin = lin_of(grid, d, name) if lin_of is not None else None
                if _is_zero(kap) and lin is None:
                    new_tracers[name] = cf
                else:
                    new_tracers[name] = _implicit_step_field(
                        grid, cf, kap, dt, linear_ccc=lin)
            tracers = new_tracers
    return u, v, tracers


def _is_zero(x):
    return isinstance(x, (int, float)) and x == 0.0


# ---------------------------------------------------------------------------
# The reference's constructor names
# ---------------------------------------------------------------------------

def VerticalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    """Biharmonic fluxes in z only."""
    return ScalarBiharmonicDiffusivity(nu=nu, kappa=kappa,
                                       isotropy="vertical")


def HorizontalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    """Biharmonic fluxes in (x, y) only, the standard mesoscale
    hyperviscosity."""
    return ScalarBiharmonicDiffusivity(nu=nu, kappa=kappa,
                                       isotropy="horizontal")


class LillyCoefficient:
    """Constant Smagorinsky coefficient with Lilly's buoyancy
    modification."""

    def __init__(self, smagorinsky=0.16, reduction_factor=1.0):
        self.smagorinsky = float(smagorinsky)
        self.reduction_factor = float(reduction_factor)


class DynamicCoefficient:
    """Germano-identity dynamic coefficient, averaged over ``averaging``
    (the plane-averaged Germano-Lilly form)."""

    def __init__(self, averaging=(0, 1)):
        if isinstance(averaging, int):
            averaging = (averaging,)
        self.averaging = tuple(averaging)


def Smagorinsky(coefficient=None, Cb=1.0, Pr=1.0):
    """``Smagorinsky(coefficient, Cb, Pr)``: a number or a
    :class:`LillyCoefficient` gives the static :class:`SmagorinskyLilly`, a
    :class:`DynamicCoefficient` the :class:`DynamicSmagorinsky`."""
    if coefficient is None:
        coefficient = LillyCoefficient()
    if isinstance(coefficient, DynamicCoefficient):
        return DynamicSmagorinsky(Pr=Pr, averaging_dims=coefficient.averaging)
    if isinstance(coefficient, LillyCoefficient):
        return SmagorinskyLilly(C=coefficient.smagorinsky,
                                Cb=Cb * coefficient.reduction_factor, Pr=Pr)
    return SmagorinskyLilly(C=float(coefficient), Cb=Cb, Pr=Pr)


def viscosity(closure, diffusivities):
    """The closure's eddy (or molecular) viscosity: a number or a
    tensor."""
    if isinstance(closure, (tuple, list)):
        return tuple(viscosity(c, d)
                     for c, d in zip(closure, diffusivities))
    if diffusivities:
        for key in ("nu_e", "nu_z_ccf"):
            if key in diffusivities:
                return diffusivities[key]
    return getattr(closure, "nu", 0.0)


def diffusivity(closure, diffusivities, name=None):
    """The closure's diffusivity of tracer ``name``."""
    if isinstance(closure, (tuple, list)):
        return tuple(diffusivity(c, d, name)
                     for c, d in zip(closure, diffusivities))
    if diffusivities:
        for key in ("kappa_e", "kappa_e_ccf", "kappa_z_ccf"):
            if key in diffusivities:
                return diffusivities[key]
        if "nu_e" in diffusivities:   # Pr-scaled LES closures
            Pr = _kappa_for(getattr(closure, "Pr", 1.0), name) or 1.0
            return diffusivities["nu_e"] / Pr
    return _kappa_for(getattr(closure, "kappa", 0.0), name)


def check_closure(closure, model_name):
    """Raise ``TypeError`` for a closure that is not an
    :class:`AbstractClosure` (every closure of ``closures.py`` and
    ``closures_ocean.py`` is one)."""
    for c in _as_tuple(closure):
        if not isinstance(c, AbstractClosure):
            raise TypeError(f"{model_name}(closure={c!r}): a closure "
                            "derives from closures.AbstractClosure")


__all__ = [
    "AbstractClosure", "AnisotropicMinimumDissipation",
    "ConvectiveAdjustmentVerticalDiffusivity", "DynamicCoefficient",
    "DynamicSmagorinsky", "ExplicitTimeDiscretization",
    "HorizontalScalarBiharmonicDiffusivity", "HorizontalScalarDiffusivity",
    "LillyCoefficient", "ScalarBiharmonicDiffusivity", "ScalarDiffusivity",
    "Smagorinsky", "SmagorinskyLilly", "VerticalScalarBiharmonicDiffusivity",
    "VerticalScalarDiffusivity", "VerticallyImplicitTimeDiscretization",
    "cell_diffusion_timescale", "check_closure",
    "closure_is_vertically_implicit", "closure_required_halo",
    "compute_diffusivities", "diffusivity", "implicit_vertical_diffusion_step",
    "momentum_flux_divergences", "tracer_flux_divergence", "viscosity",
]
