"""HydrostaticFreeSurfaceModel: the primitive equations with a free surface,
and the vector-invariant momentum advection it shares with the
shallow-water model.

Counterpart of ``oceananigans_tpu/models/hydrostatic.py`` on a
``RectilinearGrid``, a ``LatitudeLongitudeGrid`` or an
``OrthogonalSphericalShellGrid`` (the rotated lat-lon and tripolar grids),
regular or stretched, or an ``ImmersedBoundaryGrid`` over any of them
(bathymetry: the fields and tendencies masked, wet column depths in the
barotropic mode, immersed boundary conditions; no kernel takes an immersed
grid, as in the JAX package):

- ``VectorInvariant`` with every option of the reference: the conserving
  (string) and upwinded (scheme-valued) vorticity, vertical, divergence and
  kinetic-energy-gradient schemes, ``OnlySelfUpwinding`` and
  ``CrossAndSelfUpwinding``, the "velocity" and "default" vorticity
  stencils and the multidimensional stencil, each scheme-valued option
  taking Centered, UpwindBiased or WENO; ``WENOVectorInvariant``; or
  flux-form momentum advection with any scheme of ``advection.py``;
- ``ExplicitFreeSurface``, ``SplitExplicitFreeSurface`` (the barotropic
  substeps are a Python loop over the averaging weights) and
  ``ImplicitFreeSurface`` (a backward-Euler barotropic step: "fft", DCT-II
  on Bounded and FFT on Periodic axes through cuFFT with the eigenvalue
  denominator made in float64; "cg", matrix-free CG; "matrix", the
  pentadiagonal ``solvers/matrix_solver.py`` operator with its Jacobi or
  Neumann-series preconditioner; over bathymetry "fft" becomes "cg");
- ``ZStar``, the free-surface-following coordinate: the dynamics on a
  σ-scaled view of the grid (:class:`_ScaledZGrid`, face σ from the face
  wet depths), σ-weighted AB2 tendencies, the slope term b ∂x(z) of the
  pressure gradient, the z-star w, and the σⁿ/σⁿ⁺¹ rescale after the free
  surface; and ``PrescribedVelocityFields``, a data class the model does
  not take (as in JAX);
- ``HydrostaticState`` and ``HydrostaticFreeSurfaceModel`` with quasi-AB2
  or ``split_rk3`` (SSP Shu-Osher RK3, each stage a full-Δt Euler substep
  with its own free-surface step, convex-combined with the step's start;
  not with ``ZStar``, as in JAX) stepping: w diagnosed from continuity by a
  ``torch.cumsum`` over z, the
  hydrostatic pressure anomaly of a buoyancy, Coriolis, Stokes drift (its
  x and y terms), the closures of ``closures.py`` and ``closures_ocean.py``
  (explicit divergences in the tendencies, the vertically implicit part
  solved after the update), forcings (advective ones too),
  biogeochemistry, auxiliary fields (seen by the forcings and the
  boundary conditions), Lagrangian particles stepped at the end of the
  step, valued boundary conditions on every field, and
  ``tendency_callbacks`` hooks on the tendencies.

The state is a dataclass of tensors. ``step`` returns a new state but
reuses its argument's storage: halo fills write halo rows in place, the
persistent barotropic transports ``U``/``V`` among them.

Fused kernels: with ``fused_kernels="auto"`` the WENO vector-invariant
momentum kernel (``ops/cuda_vi.py``) and the WENO tracer kernel
(``ops/cuda_tracer.py``) run exactly when the model's device is a CUDA
device and their gates hold; ``fused_kernels=True`` takes the same code
paths on the CPU, where the wrappers run their plain versions. The gates
are decided at construction; under ``ZStar`` neither kernel runs (the JAX
model runs them only on its own grid, never on the σ-scaled one), and the
gates refuse the bound-preserving limiters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from oceananigans_torch import closures as closures_mod
from oceananigans_torch.advection import (
    SCHEMES, WENO, Centered, _face_value, _face_value_smooth, bind_grid,
    cell_advection_timescale, div_Uc, div_vu, div_vv,
    multi_dimensional_filter,
)
from oceananigans_torch.boundary_conditions import (
    _fill_axis, apply_flux_bcs, fill_halo_regions,
    regularize_field_boundary_conditions, top_flux_values,
)
from oceananigans_torch.buoyancy import g_Earth, regularize_buoyancy
from oceananigans_torch.fields import (
    LOC_C, LOC_U, LOC_V, LOC_W, new_field, set_field,
)
from oceananigans_torch.forcings import materialize_forcings
from oceananigans_torch.grids.base import (
    Bounded, Center, Face, Periodic, pad_interior,
)
from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
from oceananigans_torch.grids.orthogonal import OrthogonalSphericalShellGrid
from oceananigans_torch.grids.rectilinear import RectilinearGrid
from oceananigans_torch.immersed import (
    ImmersedBoundaryGrid, immersed_flux_divergence, mask_immersed_field,
    regularize_immersed_bc, scalar_diffusivity_of,
)
from oceananigans_torch.ops.cuda_tracer import (
    tracer_fusion_available, tracer_metric_profiles, weno_tracer_tendencies,
)
from oceananigans_torch.ops.cuda_vi import (
    vi_available, vi_metric_profiles, vi_momentum_tendency,
)
from oceananigans_torch.ops.operators import (
    X, Y, Z, div_xy_cc, dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c,
    iy_f, iz_c, shift, vorticity_z_ff,
)
from oceananigans_torch.particles import ParticleState
from oceananigans_torch.solvers.conjugate_gradient import conjugate_gradient
from oceananigans_torch.solvers.fft_poisson import poisson_eigenvalues
from oceananigans_torch.solvers.matrix_solver import (
    HeptadiagonalIterativeSolver, StencilMatrix,
)
from oceananigans_torch.solvers.transforms import dct2, idct2
from oceananigans_torch.timesteppers import Clock, ab2_coefficients, tick

#: the grids the model runs on
GRIDS = (RectilinearGrid, LatitudeLongitudeGrid, OrthogonalSphericalShellGrid)


# ---------------------------------------------------------------------------
# Momentum advection
# ---------------------------------------------------------------------------

class OnlySelfUpwinding:
    """Upwinding of the divergence flux and kinetic-energy gradient in
    which only the terms in the transporting velocity are upwinded; the
    cross terms use ``cross_scheme`` (Centered(2), the symmetric
    counterpart of any upwind scheme) symmetrically."""

    def __init__(self, cross_scheme=None):
        if cross_scheme is None or not getattr(cross_scheme, "symmetric",
                                               False):
            cross_scheme = Centered(2)
        self.cross_scheme = cross_scheme

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cross_scheme == other.cross_scheme)

    def __hash__(self):
        return hash((type(self).__name__, self.cross_scheme))

    def __repr__(self):
        return f"{type(self).__name__}(cross_scheme={self.cross_scheme!r})"


class CrossAndSelfUpwinding(OnlySelfUpwinding):
    """The self and cross contributions of the divergence flux upwinded
    together, as one reconstruction of δx(Ax u) + δy(Ay v); the kinetic
    energy gradient keeps self-only upwinding."""


class VectorInvariant:
    """Rotational-form momentum advection: 𝐯·∇u = ζ ẑ×u + ∇K + w ∂z u.

    - ``vorticity_scheme``: "enstrophy_conserving" (default: ℑy(ζ)·v̂ with
      the length-weighted transverse velocity v̂ = ℑxy(Δx v)/Δxᶠᶜᶜ),
      "energy_conserving" (ℑy(ζ·ℑx(Δx v))/Δxᶠᶜᶜ), or a biased scheme: ζ
      reconstructed transversely, biased on the sign of v̂.
    - ``vorticity_stencil``: "velocity" (default: WENO smoothness measured
      on the tangential velocities ℑy(u), ℑx(v)) or "default" (on ζ).
    - ``vertical_scheme``: "energy_conserving" (default: ℑz(ℑx(w)∂z u)) or
      a biased scheme: the flux form δz(ℑx(Az w)·uᴿ) plus the upwinded
      horizontal divergence flux.
    - ``divergence_scheme``: the biased scheme of δx(Ax u) (defaults to a
      scheme-valued ``vertical_scheme``).
    - ``kinetic_energy_gradient_scheme``: "energy_conserving" (∂x of the
      centred horizontal kinetic energy) or a biased scheme for the self
      difference δx(u²/2) (defaults to ``divergence_scheme``).
    - ``upwinding``: ``OnlySelfUpwinding()`` (default) or
      ``CrossAndSelfUpwinding()``.
    - ``multi_dimensional_stencil``: filter every scheme-based horizontal
      reconstruction transversely (fifth-order centred WENO).
    """

    def __init__(self, vorticity_scheme="enstrophy_conserving",
                 vorticity_stencil="velocity",
                 vertical_scheme="energy_conserving",
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=None, multi_dimensional_stencil=False):
        if isinstance(vorticity_scheme, str) and vorticity_scheme not in (
                "enstrophy_conserving", "energy_conserving"):
            raise ValueError(
                f"unknown vorticity_scheme {vorticity_scheme!r}")
        if vorticity_stencil not in ("velocity", "default"):
            raise ValueError(
                f"unknown vorticity_stencil {vorticity_stencil!r}")
        if isinstance(vertical_scheme, str) and \
                vertical_scheme != "energy_conserving":
            raise ValueError(f"unknown vertical_scheme {vertical_scheme!r}")
        self.vorticity_scheme = vorticity_scheme
        self.vorticity_stencil = vorticity_stencil
        self.vertical_scheme = vertical_scheme
        if divergence_scheme is None and not isinstance(vertical_scheme,
                                                        str):
            divergence_scheme = vertical_scheme
        self.divergence_scheme = divergence_scheme
        if kinetic_energy_gradient_scheme is None:
            kinetic_energy_gradient_scheme = (
                divergence_scheme if divergence_scheme is not None
                else "energy_conserving")
        self.kinetic_energy_gradient_scheme = kinetic_energy_gradient_scheme
        self.upwinding = upwinding if upwinding is not None \
            else OnlySelfUpwinding()
        self.multi_dimensional_stencil = bool(multi_dimensional_stencil)

    @property
    def required_halo(self):
        """The largest scheme halo, plus one for ζ (2 with only conserving
        schemes), plus two for the multidimensional filter."""
        h = 1
        for s in (self.vorticity_scheme, self.vertical_scheme,
                  self.divergence_scheme,
                  self.kinetic_energy_gradient_scheme):
            if s is not None and not isinstance(s, str):
                h = max(h, s.required_halo)
        h = h + 1 if h > 1 else 2
        if self.multi_dimensional_stencil:
            h += 2
        return h

    def _key(self):
        return ("VectorInvariant", self.vorticity_scheme,
                self.vorticity_stencil, self.vertical_scheme,
                self.divergence_scheme, self.kinetic_energy_gradient_scheme,
                self.upwinding, self.multi_dimensional_stencil)

    def __eq__(self, other):
        return isinstance(other, VectorInvariant) and \
            self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"VectorInvariant({self.vorticity_scheme!r}, "
                f"vertical_scheme={self.vertical_scheme!r})")

    def _md(self, q, interp_axis):
        """The transverse filter of a horizontal reconstruction (an x
        interpolation is filtered along y and the reverse); the identity
        unless ``multi_dimensional_stencil``."""
        if not self.multi_dimensional_stencil:
            return q
        return multi_dimensional_filter(q, Y if interp_axis == X else X)

    # -- vorticity term -----------------------------------------------------
    def _zeta_smooth(self, u, v):
        if self.vorticity_stencil == "velocity" and \
                isinstance(self.vorticity_scheme, WENO):
            # the tangential velocities at ζ's (f,f) location
            return [iy_f(u), ix_f(v)]
        return None

    def _zeta_v(self, grid, zeta, u, v):
        """The +ζ v̂ term of the u equation, at (f,c,c)."""
        dxv = grid.dx(Center, Face) * v
        if self.vorticity_scheme == "energy_conserving":
            return iy_c(zeta * ix_f(dxv)) / grid.dx(Face, Center)
        if self.vorticity_scheme == "enstrophy_conserving":
            return iy_c(zeta) * ix_f(iy_c(dxv)) / grid.dx(Face, Center)
        vhat = self._md(ix_f(iy_c(dxv)) / grid.dx(Face, Center), X)
        # ζ sits on y-faces: reconstruct it to y-centers (o = 1)
        zr = self._md(_face_value_smooth(self.vorticity_scheme, vhat, zeta,
                                         Y, 1, self._zeta_smooth(u, v)), Y)
        return vhat * zr

    def _zeta_u(self, grid, zeta, u, v):
        """The ζ û term that the v equation subtracts, at (c,f,c)."""
        dyu = grid.dy(Center, Face) * u
        if self.vorticity_scheme == "energy_conserving":
            return ix_c(zeta * iy_f(dyu)) / grid.dy(Face, Center)
        if self.vorticity_scheme == "enstrophy_conserving":
            return ix_c(zeta) * iy_f(ix_c(dyu)) / grid.dy(Face, Center)
        uhat = self._md(iy_f(ix_c(dyu)) / grid.dy(Face, Center), Y)
        zr = self._md(_face_value_smooth(self.vorticity_scheme, uhat, zeta,
                                         X, 1, self._zeta_smooth(u, v)), X)
        return uhat * zr

    # -- Bernoulli head -----------------------------------------------------
    def _bernoulli_u(self, grid, u, v):
        """∂x K at (f,c,c)."""
        ke = self.kinetic_energy_gradient_scheme
        if isinstance(ke, str):
            K = 0.5 * (ix_c(u * u) + iy_c(v * v))
            return dx_f(K) / grid.dx(Face, Center)
        du2 = dx_c(0.5 * u * u)          # δx(u²/2) at (c,c,c)
        dv2 = dx_f(0.5 * v * v)          # δx(v²/2) at (f,f,c)
        smooth = [ix_c(u)] if isinstance(ke, WENO) else None
        duR = self._md(_face_value_smooth(ke, u, du2, X, 0, smooth), X)
        dvS = self._md(self.upwinding.cross_scheme.reconstruct(dv2, Y, 1), Y)
        return (duR + dvS) / grid.dx(Face, Center)

    def _bernoulli_v(self, grid, u, v):
        ke = self.kinetic_energy_gradient_scheme
        if isinstance(ke, str):
            K = 0.5 * (ix_c(u * u) + iy_c(v * v))
            return dy_f(K) / grid.dy(Face, Center)
        dv2 = dy_c(0.5 * v * v)          # (c,c,c)
        du2 = dy_f(0.5 * u * u)          # (f,f,c)
        smooth = [iy_c(v)] if isinstance(ke, WENO) else None
        dvR = self._md(_face_value_smooth(ke, v, dv2, Y, 0, smooth), Y)
        duS = self._md(self.upwinding.cross_scheme.reconstruct(du2, X, 1), X)
        return (dvR + duS) / grid.dy(Face, Center)

    # -- vertical and divergence flux ---------------------------------------
    def _div_terms(self, grid, u, v):
        dxU = dx_c(grid.Ax(Face, Center, Center) * u)    # (c,c,c)
        dyV = dy_c(grid.Ay(Center, Face, Center) * v)    # (c,c,c)
        return dxU, dyV

    def _vertical_u(self, grid, u, v, w):
        """The +[w ∂z u] term of 𝐯·∇u at (f,c,c)."""
        vs = self.vertical_scheme
        if isinstance(vs, str):
            return iz_c(ix_f(w) * (dz_f(u) / grid.dz(Face)))
        dxU, dyV = self._div_terms(grid, u, v)
        ds = self.divergence_scheme
        if isinstance(self.upwinding, CrossAndSelfUpwinding):
            dR = self._md(_face_value_smooth(ds, u, dxU + dyV, X, 0, None), X)
            phi = u * dR
        else:
            smooth = [dxU + dyV] if isinstance(ds, WENO) else None
            duR = self._md(_face_value_smooth(ds, u, dxU, X, 0, smooth), X)
            dvS = self._md(
                self.upwinding.cross_scheme.reconstruct(dyV, X, 0), X)
            phi = u * (dvS + duR)
        Wadv = ix_f(grid.Az(Center, Center) * w)         # (f,c,f)
        uz = _face_value(vs, Wadv, u, Z, 0)
        return (phi + dz_c(Wadv * uz)) / grid.V(Face, Center, Center)

    def _vertical_v(self, grid, u, v, w):
        vs = self.vertical_scheme
        if isinstance(vs, str):
            return iz_c(iy_f(w) * (dz_f(v) / grid.dz(Face)))
        dxU, dyV = self._div_terms(grid, u, v)
        ds = self.divergence_scheme
        if isinstance(self.upwinding, CrossAndSelfUpwinding):
            dR = self._md(_face_value_smooth(ds, v, dxU + dyV, Y, 0, None), Y)
            phi = v * dR
        else:
            smooth = [dxU + dyV] if isinstance(ds, WENO) else None
            dvR = self._md(_face_value_smooth(ds, v, dyV, Y, 0, smooth), Y)
            duS = self._md(
                self.upwinding.cross_scheme.reconstruct(dxU, Y, 0), Y)
            phi = v * (duS + dvR)
        Wadv = iy_f(grid.Az(Center, Center) * w)         # (c,f,f)
        vz = _face_value(vs, Wadv, v, Z, 0)
        return (phi + dz_c(Wadv * vz)) / grid.V(Center, Face, Center)

    # -- tendencies ---------------------------------------------------------
    def u_tendency(self, grid, u, v, w, zeta=None):
        """−[𝐯·∇u]ₓ at (f,c,c). ``zeta`` overrides the vorticity computed
        here (the cubed sphere passes its corner-corrected ζ)."""
        if zeta is None:
            zeta = vorticity_z_ff(grid, u, v)
        return (self._zeta_v(grid, zeta, u, v)
                - self._bernoulli_u(grid, u, v)
                - self._vertical_u(grid, u, v, w))

    def v_tendency(self, grid, u, v, w, zeta=None):
        if zeta is None:
            zeta = vorticity_z_ff(grid, u, v)
        return (-self._zeta_u(grid, zeta, u, v)
                - self._bernoulli_v(grid, u, v)
                - self._vertical_v(grid, u, v, w))


class WENOVectorInvariant(VectorInvariant):
    """WENO vorticity (order 9 by default) with VelocityStencil smoothness,
    flux-form WENO vertical advection and upwinded divergence flux and
    kinetic-energy gradient (order 5 by default) with
    ``OnlySelfUpwinding``."""

    def __init__(self, vorticity_order=None, order=None,
                 vertical_order=None, divergence_order=None,
                 kinetic_energy_gradient_order=None, upwinding=None,
                 vorticity_stencil="velocity",
                 multi_dimensional_stencil=False):
        vorticity_order = vorticity_order or order or 9
        vertical_order = vertical_order or order or 5
        divergence_order = divergence_order or order or 5
        kinetic_energy_gradient_order = (kinetic_energy_gradient_order
                                         or order or 5)
        super().__init__(
            vorticity_scheme=WENO(vorticity_order),
            vorticity_stencil=vorticity_stencil,
            vertical_scheme=WENO(vertical_order),
            divergence_scheme=WENO(divergence_order),
            kinetic_energy_gradient_scheme=WENO(
                kinetic_energy_gradient_order),
            upwinding=upwinding,
            multi_dimensional_stencil=multi_dimensional_stencil)

    def __repr__(self):
        return (f"WENOVectorInvariant(vorticity_order="
                f"{self.vorticity_scheme.order}, vertical_order="
                f"{self.vertical_scheme.order})")


# ---------------------------------------------------------------------------
# Free surfaces and vertical coordinates
# ---------------------------------------------------------------------------

class ExplicitFreeSurface:
    """∂t η = −∇·U with g∇η explicit in the momentum tendency; the
    gravity-wave CFL limits Δt."""

    def __init__(self, gravitational_acceleration=g_Earth):
        self.g = float(gravitational_acceleration)

    def __eq__(self, other):
        return type(self) is type(other) and self.g == other.g

    def __hash__(self):
        return hash(("ExplicitFS", self.g))

    def __repr__(self):
        return f"ExplicitFreeSurface(g={self.g:g})"


def averaging_shape_function(tau, p=2, q=4, r=0.18927):
    """Shchepetkin & McWilliams (2005) dispersion-minimizing barotropic
    averaging kernel."""
    tau0 = (p + 2) * (p + q + 2) / (p + 1) / (p + q + 1)
    return (tau / tau0) ** p * (1 - (tau / tau0) ** q) - r * (tau / tau0)


def weights_from_substeps(substeps, kernel=averaging_shape_function):
    """The fractional substep and the normalized averaging weights over
    τ ∈ (0, 2], cut after the last positive weight."""
    tau_f = np.linspace(0.0, 2.0, substeps + 1)
    frac = tau_f[1] - tau_f[0]
    w = np.array([kernel(t) for t in tau_f[1:]])
    idx = len(w)
    while idx > 0 and w[idx - 1] <= 0:
        idx -= 1
    w = w[:idx]
    return frac, w / w.sum()


class SplitExplicitFreeSurface:
    """Barotropic substepping with filtered averaging."""

    def __init__(self, substeps=30, gravitational_acceleration=g_Earth,
                 averaging_kernel=averaging_shape_function):
        self.g = float(gravitational_acceleration)
        self.substeps = int(substeps)
        frac, w = weights_from_substeps(self.substeps, averaging_kernel)
        self.fractional_step = float(frac)
        self.weights = tuple(float(x) for x in w)

    def __eq__(self, other):
        return (type(self) is type(other) and self.g == other.g
                and self.weights == other.weights)

    def __hash__(self):
        return hash(("SplitExplicitFS", self.g, self.weights))

    def __repr__(self):
        return (f"SplitExplicitFreeSurface(substeps={len(self.weights)}, "
                f"g={self.g:g})")


class ImplicitFreeSurface:
    """Backward-Euler barotropic step: solve the 2-D elliptic problem

        [∇·(gH∇) − 1/Δt²] η^{n+1} = (∇·U* − η^n/Δt)/Δt

    then correct u and v with −Δt g ∇η^{n+1}.

    ``solver_method``: "fft" (a flat bottom on a regular grid: DCT on the
    Bounded axes, FFT on the Periodic ones, an eigenvalue division), "cg"
    (matrix-free CG on any grid) or "matrix" (the pentadiagonal
    :class:`~oceananigans_torch.solvers.matrix_solver.StencilMatrix` and
    its preconditioned CG, ``preconditioner`` "jacobi", "spai" or an int).
    Over an immersed grid the model turns "fft" into "cg"."""

    def __init__(self, gravitational_acceleration=g_Earth,
                 solver_method="fft", maxiter=200, reltol=1e-9,
                 preconditioner="jacobi"):
        self.g = float(gravitational_acceleration)
        if solver_method not in ("fft", "cg", "matrix"):
            raise ValueError(f"unknown solver_method {solver_method!r} "
                             "(expected 'fft', 'cg', or 'matrix')")
        self.solver_method = solver_method
        self.maxiter = maxiter
        self.reltol = reltol
        self.preconditioner = preconditioner

    def __eq__(self, other):
        return (type(self) is type(other) and self.g == other.g
                and self.solver_method == other.solver_method
                and self.preconditioner == other.preconditioner)

    def __hash__(self):
        return hash(("ImplicitFS", self.g, self.solver_method,
                     str(self.preconditioner)))

    def __repr__(self):
        return (f"ImplicitFreeSurface(g={self.g:g}, "
                f"solver={self.solver_method})")


class ZStar:
    """Free-surface-following vertical coordinate: the cell heights scale
    with the column stretching σ = (H + η)/H, and u, v and the tracers are
    rescaled by σⁿ/σⁿ⁺¹ after the free-surface update, so the σ-weighted
    content ∫ σ q dV is kept to rounding. A uniform tracer stays uniform
    exactly under the explicit free surface. Quasi-AB2 only."""

    def __repr__(self):
        return "ZStar()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash("ZStar")


class _ScaledZGrid:
    """A grid view whose cell heights are scaled by ``sigma`` at the centres
    and by ``sigma_fc`` and ``sigma_cf`` in the x and y flux areas; every
    other attribute is the base grid's. Built each step under
    :class:`ZStar` (σ, its face values from the face wet depths), and by
    the cubed sphere's models for z-star and partial cells."""

    def __init__(self, base, sigma, sigma_fc=None, sigma_cf=None):
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "sigma", sigma)
        object.__setattr__(self, "sigma_fc",
                           sigma if sigma_fc is None else sigma_fc)
        object.__setattr__(self, "sigma_cf",
                           sigma if sigma_cf is None else sigma_cf)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "base"), name)

    def dz(self, lz=Center):
        return self.sigma * self.base.dz(lz)

    def Ax(self, lx, ly, lz):
        s = self.sigma_fc if lx == Face else self.sigma
        return self.base.dy(ly, lx) * (s * self.base.dz(lz))

    def Ay(self, lx, ly, lz):
        s = self.sigma_cf if ly == Face else self.sigma
        return self.base.dx(lx, ly) * (s * self.base.dz(lz))

    def V(self, lx, ly, lz):
        return self.base.Az(lx, ly) * self.dz(lz)


class PrescribedVelocityFields:
    """Diagnostic velocities ``u``, ``v`` and ``w`` that advect the
    tracers (a data class; the hydrostatic model does not take it, as in
    the JAX package)."""

    def __init__(self, u=None, v=None, w=None):
        self.u = u
        self.v = v
        self.w = w


class ZCoordinate:
    """Static vertical coordinate (the default)."""

    def __repr__(self):
        return "ZCoordinate()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash("ZCoordinate")


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HydrostaticState:
    """Prognostic and diagnostic fields. ``eta``, ``Geta``, ``U`` and ``V``
    are (nx, ny, 1); ``U``/``V`` are the split-explicit free surface's
    persistent barotropic transports (zeros otherwise). ``Gu``/``Gv``,
    ``Geta`` and ``Gtracers`` hold the previous tendencies quasi-AB2
    needs."""
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    eta: torch.Tensor
    tracers: Dict[str, torch.Tensor]
    clock: Clock
    Gu: torch.Tensor
    Gv: torch.Tensor
    Geta: torch.Tensor
    Gtracers: Dict[str, torch.Tensor]
    U: torch.Tensor
    V: torch.Tensor
    particles: Optional[ParticleState] = None

    @property
    def velocities(self):
        return {"u": self.u, "v": self.v, "w": self.w}

    def fields(self):
        return {"u": self.u, "v": self.v, "w": self.w, "eta": self.eta,
                **self.tracers}


_replace = dataclasses.replace


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class HydrostaticFreeSurfaceModel(torch.nn.Module):
    """Hydrostatic Boussinesq dynamics with a free surface. Mirrors the JAX
    constructor's keywords, and its ``ValueError`` on an unknown
    timestepper, free surface or coordinate and on ``split_rk3`` with
    ``ZStar``."""

    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 free_surface=None, tracers=(), buoyancy=None, coriolis=None,
                 closure=None, forcing=None, boundary_conditions=None,
                 vertical_coordinate=None, timestepper="quasi_ab2",
                 particles=None, biogeochemistry=None, stokes_drift=None,
                 auxiliary_fields=None, fused_kernels="auto", device=None):
        super().__init__()
        #: the constructor's arguments but the grid, for a rebuild on
        #: another grid (``parallel.sharded_step_fn``)
        self._init_kwargs = dict(
            momentum_advection=momentum_advection,
            tracer_advection=tracer_advection, free_surface=free_surface,
            tracers=tracers, buoyancy=buoyancy, coriolis=coriolis,
            closure=closure, forcing=forcing,
            boundary_conditions=boundary_conditions,
            vertical_coordinate=vertical_coordinate,
            timestepper=timestepper, particles=particles,
            biogeochemistry=biogeochemistry, stokes_drift=stokes_drift,
            auxiliary_fields=auxiliary_fields, fused_kernels=fused_kernels)
        base = (grid.underlying_grid
                if isinstance(grid, ImmersedBoundaryGrid) else grid)
        if not isinstance(base, GRIDS):
            raise NotImplementedError(
                f"HydrostaticFreeSurfaceModel does not take a "
                f"{type(base).__name__}: a ConformalCubedSphereGrid takes "
                "CubedSphereHydrostaticModel")
        if timestepper not in ("quasi_ab2", "split_rk3"):
            raise ValueError(f"unknown timestepper {timestepper!r}")
        closures_mod.check_closure(closure, "HydrostaticFreeSurfaceModel")
        if timestepper == "split_rk3" and isinstance(vertical_coordinate,
                                                     ZStar):
            raise ValueError("split_rk3 supports ZCoordinate only")
        if vertical_coordinate is None:
            vertical_coordinate = ZCoordinate()
        if not isinstance(vertical_coordinate, (ZCoordinate, ZStar)):
            raise ValueError(
                f"unknown vertical_coordinate {vertical_coordinate!r}")
        if momentum_advection is None:
            momentum_advection = VectorInvariant()
        if not isinstance(momentum_advection, (VectorInvariant, *SCHEMES)):
            raise ValueError(
                f"unknown momentum advection {momentum_advection!r}")
        if tracer_advection is None:
            tracer_advection = Centered(2)
        if not isinstance(tracer_advection, SCHEMES):
            raise ValueError(
                f"unknown tracer advection {tracer_advection!r}")
        if free_surface is None:
            free_surface = SplitExplicitFreeSurface()
        if not isinstance(free_surface, (ExplicitFreeSurface,
                                         SplitExplicitFreeSurface,
                                         ImplicitFreeSurface)):
            raise ValueError(f"unknown free surface {free_surface!r}")
        if (isinstance(grid, ImmersedBoundaryGrid)
                and isinstance(free_surface, ImplicitFreeSurface)
                and free_surface.solver_method == "fft"):
            # the eigenbasis assumes a flat bottom: over bathymetry CG
            free_surface = ImplicitFreeSurface(
                gravitational_acceleration=free_surface.g,
                solver_method="cg", maxiter=free_surface.maxiter,
                reltol=free_surface.reltol)
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        buoyancy = regularize_buoyancy(buoyancy)
        # the required tracers in the JAX model's order (a buoyancy
        # formulation and a biogeochemistry must name theirs, a closure may)
        if buoyancy is not None:
            tracers += tuple(t for t in buoyancy.required_tracers
                             if t not in tracers)
        for cl in closures_mod._as_tuple(closure):
            tracers += tuple(t for t in getattr(cl, "required_tracers", ())
                             if t not in tracers)
        if biogeochemistry is not None:
            tracers += tuple(t for t in biogeochemistry.required_tracers
                             if t not in tracers)

        self.grid = grid
        self.momentum_advection = momentum_advection
        # the tracer scheme takes a stretched grid's per-point tables; the
        # momentum scheme keeps the uniform ones, as in the JAX package
        self.tracer_advection = bind_grid(tracer_advection, grid)
        self.free_surface = free_surface
        self.vertical_coordinate = vertical_coordinate
        self.timestepper = timestepper
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        self.particles = particles
        self.biogeochemistry = biogeochemistry
        self.stokes_drift = stokes_drift
        #: fields by name that the forcings and boundary conditions see
        #: beside the state's: an array or a tensor (halo-extended) as it
        #: is, anything else (a number, a callable ``f(x, y, z)``) through
        #: ``set_field`` at the centres; made once on the grid's device and
        #: kept
        self.auxiliary_fields = dict(auxiliary_fields or {})
        self._aux_on_grid = {}
        self._fused = fused_kernels
        #: hooks ``(grid, state, {name: G}) -> {name: G}`` applied to the
        #: tendencies at the end of :meth:`compute_tendencies` (wired by
        #: ``Simulation`` for ``TendencyCallsite`` callbacks)
        self.tendency_callbacks = ()

        boundary_conditions = dict(boundary_conditions or {})
        self.locations = {"u": LOC_U, "v": LOC_V, "w": LOC_W,
                          **{t: LOC_C for t in tracers}}
        self.bcs = {name: regularize_field_boundary_conditions(
            boundary_conditions.get(name), grid, loc)
            for name, loc in self.locations.items()}
        self.eta_bcs = regularize_field_boundary_conditions(
            boundary_conditions.get("eta"), grid, LOC_C)
        self.forcings, self.advective_forcings = materialize_forcings(
            forcing, self.locations, tracers)
        # the immersed boundary conditions, and the scalar diffusivity
        # their Value and Gradient fluxes use
        self.immersed = isinstance(grid, ImmersedBoundaryGrid)
        self.immersed_bcs = {}
        if self.immersed:
            for name, loc in self.locations.items():
                rib = regularize_immersed_bc(self.bcs[name].immersed, loc)
                if rib is not None:
                    self.immersed_bcs[name] = rib
        self._ib_kappa = {
            name: scalar_diffusivity_of(
                closure, None if name in ("u", "v", "w") else name)
            for name in self.immersed_bcs}

        # static column geometry, computed once: the z-interior mask and
        # spacing, and the wet column depths at u and v faces (the
        # shallower of the two adjacent columns; zero where a face is
        # dry); without an immersed boundary every column is full
        nz = grid.shape[Z]
        k = torch.arange(nz, device=grid.device).reshape(1, 1, -1)
        interior = (k >= grid.H[Z]) & (k < grid.H[Z] + grid.N[Z])
        dzm = torch.where(interior, grid.dz(Center), 0.0)
        shape2d = (grid.shape[X], grid.shape[Y], 1)
        wet = interior & ~grid.solid_c if self.immersed else interior
        H = torch.sum(torch.where(wet, grid.dz(Center), 0.0).expand(
            grid.shape), dim=Z, keepdim=True)
        self.register_buffer("_z_interior", interior)
        inside = torch.zeros(shape2d, dtype=torch.bool, device=grid.device)
        inside[grid.interior_slices[0], grid.interior_slices[1], :] = True
        self.register_buffer("_interior2d", inside)
        self.register_buffer("_dzm", dzm)
        self.register_buffer("_H_cc", H)
        self.register_buffer("_H_fc", torch.minimum(H, shift(H, -1, X)))
        self.register_buffer("_H_cf", torch.minimum(H, shift(H, -1, Y)))
        self.zstar = isinstance(vertical_coordinate, ZStar)
        # z-star: the share of the wet column below each w face, over which
        # the grid's motion is distributed (0 at the bottom, 1 at the top)
        frac = None
        if self.zstar:
            h_below = shift(torch.cumsum(
                torch.where(wet, grid.dz(Center), 0.0).expand(grid.shape),
                dim=Z), -1, Z)
            h_below = torch.where(k == 0, 0.0, h_below)
            frac = torch.where(H > 0, h_below / torch.where(H > 0, H, 1.0),
                               0.0)
        self.register_buffer("_zstar_below", frac)
        # wall and halo faces of the barotropic transports on Bounded axes
        self._set_transport_walls()
        # the kernels' metric profiles, built once; under z-star the
        # tendencies are taken on the σ-scaled grid, which no kernel takes
        # (the JAX model runs its kernels only on its own grid)
        self.register_buffer(
            "_vi_metrics",
            vi_metric_profiles(grid)
            if isinstance(momentum_advection, VectorInvariant)
            and not self.zstar and vi_available(grid, momentum_advection)
            else None)
        self.register_buffer(
            "_tracer_metrics",
            tracer_metric_profiles(grid)
            if not self.zstar
            and tracer_fusion_available(grid, self.tracer_advection)
            else None)
        #: the last implicit free-surface solve's CG iterations (a 0-d
        #: tensor) and host reads of its convergence flag
        self.free_surface_info = {}
        self._fs_denominators = {}
        if device is not None:
            self.to(device)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    #: the mesh context of a rank's LOCAL model in a ``DistributedStep``
    #: (``parallel/shard_step.py``): its halo fills exchange strips with the
    #: neighbouring ranks, its transports see only the domain's own walls
    #: and its implicit free surface is CG with all-reduced inner products;
    #: ``dist_topo`` is the global grid's topology
    dist_halo = None
    dist_topo = None

    def set_dist_halo(self, ctx, topo):
        """Route this (local) model's halo fills through the exchange of
        ``ctx``, a ``DistHalo``, with the global topology ``topo``."""
        self.dist_halo = ctx
        self.dist_topo = tuple(topo)
        self._set_transport_walls()

    def _set_transport_walls(self):
        """The wall faces (and beyond) of the barotropic transports on
        each Bounded axis. A distributed rank's block has the domain's walls
        where its faces, halo included, are the domain's wall faces or lie
        beyond them: its other faces carry exchanged data."""
        grid = self.grid
        ctx = self.dist_halo
        for name, axis in (("_U_walls", X), ("_V_walls", Y)):
            walls = None
            if grid.axis_topo(axis) == Bounded:
                H, N = grid.H[axis], grid.N[axis]
                idx = torch.arange(grid.shape[axis], device=grid.device)
                idx = idx.reshape((-1, 1, 1) if axis == X else (1, -1, 1))
                # the faces' global indices
                face, total = idx - H, N
                mesh_axis = axis % 3       # X, Y count from the end
                if ctx is not None and ctx.size(mesh_axis) > 1:
                    face = face + ctx.offset(mesh_axis)
                    total = ctx.extent(mesh_axis)
                walls = (face <= 0) | (face >= total)
            self.register_buffer(name, walls)

    def _fill_field(self, a, bcs, loc, t, dt=None, g=None):
        """Fill ``a``'s halos in place on ``g`` (default the grid):
        through the distributed exchange under a ``dist_halo``, else the
        ordinary fill."""
        g = self.grid if g is None else g
        if self.dist_halo is not None:
            from oceananigans_torch.parallel.shard_step import (
                dist_fill_halos,
            )
            return dist_fill_halos(a, g, bcs, loc, t, dt, self.dist_halo,
                                   self.dist_topo)
        return fill_halo_regions(a, g, bcs, loc, t, dt=dt)

    def _fill_xy(self, a, bcs, loc):
        """The x/y fill of a 2-D field without the conditions' values
        (η, the transports), in place; distributed under a ``dist_halo``."""
        if self.dist_halo is not None:
            from oceananigans_torch.parallel.shard_step import dist_fill_xy
            return dist_fill_xy(a, self.grid, bcs, loc, None, None,
                                self.dist_halo, self.dist_topo,
                                use_values=False)
        for axis in (X, Y):
            _fill_axis(a, self.grid, axis, loc[axis], *bcs.sides(axis))
        return a

    def _on(self) -> bool:
        if self._fused == "auto":
            return self.device.type == "cuda"
        return bool(self._fused)

    @property
    def fused_kernels(self) -> bool:
        """The WENO vector-invariant momentum kernel
        (``vi_momentum_tendency``) computes Gu and Gv; "auto" means: on a
        CUDA device."""
        return self._vi_metrics is not None and self._on()

    @property
    def fused_tracer(self) -> bool:
        """The WENO tracer kernel (``weno_tracer_tendencies``) computes
        every tracer's advection; "auto" means: on a CUDA device."""
        return self._tracer_metrics is not None and self._on()

    # ------------------------------------------------------------------
    # State construction and halos
    # ------------------------------------------------------------------
    def initial_state(self, time=0.0, **field_values):
        """A state from initial ``u``, ``v`` and tracers (numbers, arrays or
        callables ``f(x, y, z)`` of coordinate tensors) and ``eta`` (a
        number, an (nx, ny, 1) array or a callable ``f(x, y)``)."""
        g = self.grid
        allowed = {"u", "v", "eta"} | set(self.tracer_names)
        unknown = set(field_values) - allowed
        if unknown:
            raise ValueError(
                f"unknown initial_state fields {sorted(unknown)}; "
                f"this model takes {sorted(allowed)}")

        def mk(name, loc):
            if name in field_values:
                return set_field(g, field_values[name], loc=loc)
            return new_field(g)

        eta = self._eta_field(field_values.get("eta", 0.0))
        state = HydrostaticState(
            u=mk("u", LOC_U), v=mk("v", LOC_V), w=new_field(g), eta=eta,
            tracers={t: mk(t, LOC_C) for t in self.tracer_names},
            clock=Clock.start(time, g.dtype),
            Gu=new_field(g), Gv=new_field(g), Geta=torch.zeros_like(eta),
            Gtracers={t: new_field(g) for t in self.tracer_names},
            U=torch.zeros_like(eta), V=torch.zeros_like(eta),
            particles=(self.particles.state_on(g)
                       if self.particles is not None else None))
        state = self.update_state(state)
        # the persistent barotropic transports start from the initial
        # velocities (through the moving thicknesses under z-star)
        sig = ((self._sigma_at(state.eta, "fc"), self._sigma_at(state.eta,
                                                                "cf"))
               if self.zstar else ())
        U0, V0 = self._zero_wall_transports(
            *self._barotropic_mode(state.u, state.v, *sig))
        return _replace(state, U=U0, V=V0)

    def _eta_field(self, value):
        g = self.grid
        shape2d = (g.shape[X], g.shape[Y], 1)
        if callable(value):
            value = value(g.xC, g.yC)
        value = torch.as_tensor(value, dtype=g.dtype, device=g.device)
        return value.expand(shape2d).clone()

    def _fill_transport_halos(self, U, V):
        """x/y halo fill of the barotropic transports with the velocities'
        side conditions (in place)."""
        return (self._fill_xy(U, self.bcs["u"], LOC_U),
                self._fill_xy(V, self.bcs["v"], LOC_V))

    def _fill_eta_halos(self, eta):
        """x/y halo fill of η (in place; η has no z extent)."""
        return self._fill_xy(eta, self.eta_bcs, LOC_C)

    def fill_state_halos(self, state):
        """Fill u, v, the tracers and η in place at the clock time (u and v
        also with the last Δt, which the radiation condition reads); on an
        immersed grid u, v and the tracers are masked first."""
        g = self.grid
        if self.immersed:
            state = _replace(
                state, u=mask_immersed_field(g, state.u, LOC_U),
                v=mask_immersed_field(g, state.v, LOC_V),
                tracers={n: mask_immersed_field(g, c, LOC_C)
                         for n, c in state.tracers.items()})
        t, dtl = state.clock.time, state.clock.last_dt
        self._fill_field(state.u, self.bcs["u"], LOC_U, t, dt=dtl)
        self._fill_field(state.v, self.bcs["v"], LOC_V, t, dt=dtl)
        for name, c in state.tracers.items():
            self._fill_field(c, self.bcs[name], LOC_C, t)
        self._fill_eta_halos(state.eta)
        return state

    def compute_w(self, state):
        """w from continuity: w(zF_k) = −∫ from the bottom to k of ∇ₕ·𝐮 dz,
        a ``torch.cumsum`` over z; then its halo fill. Under z-star, on the
        σ-scaled grid, less the grid's own motion: the velocity across the
        moving levels, zero at the bottom and at the surface."""
        g = self._active_grid(state)
        hdiv = div_xy_cc(g, state.u, state.v)
        contrib = torch.where(self._z_interior, hdiv * g.dz(Center), 0.0)
        csum = torch.cumsum(contrib, dim=Z)
        # w at face k (the bottom face of cell k) = −Σ over cells k' < k
        w = -shift(csum, -1, Z)
        if self.zstar:
            w = w + self._zstar_below * torch.sum(contrib, dim=Z,
                                                  keepdim=True)
        w[..., 0] = 0.0
        w = mask_immersed_field(self.grid, w, LOC_W)
        self._fill_field(w, self.bcs["w"], LOC_W, state.clock.time, g=g)
        return _replace(state, w=w)

    def update_state(self, state):
        return self.compute_w(self.fill_state_halos(state))

    # ------------------------------------------------------------------
    # The z-star coordinate
    # ------------------------------------------------------------------
    def _sigma(self, eta):
        """The column stretching σ = (H + η)/H at the centres (1 over
        land)."""
        H = self._H_cc
        return torch.where(H > 0, 1.0 + eta / torch.where(H > 0, H, 1.0),
                           1.0)

    def _sigma_at(self, eta, loc):
        """σ at the u ("fc") or v ("cf") faces, from the face's wet depth
        and η interpolated to it."""
        H = self._H_fc if loc == "fc" else self._H_cf
        eta_l = ix_f(eta) if loc == "fc" else iy_f(eta)
        return torch.where(H > 0, 1.0 + eta_l / torch.where(H > 0, H, 1.0),
                           torch.ones_like(eta_l))

    def _active_grid(self, state):
        """The grid the dynamics see: σ-scaled under z-star."""
        if not self.zstar:
            return self.grid
        return _ScaledZGrid(self.grid, self._sigma(state.eta),
                            self._sigma_at(state.eta, "fc"),
                            self._sigma_at(state.eta, "cf"))

    # ------------------------------------------------------------------
    # Tendencies
    # ------------------------------------------------------------------
    def hydrostatic_pressure_anomaly(self, state, g=None):
        """p′(z) = −∫_z^0 b dz′ at centers (∂z p′ = b, p′ = 0 at the top),
        or None without a buoyancy."""
        if self.buoyancy is None:
            return None
        g = self.grid if g is None else g
        b = self.buoyancy.buoyancy_ccc(g, state.tracers)
        contrib = torch.where(self._z_interior, b * g.dz(Center), 0.0)
        total = torch.sum(contrib, dim=Z, keepdim=True)
        above = total - torch.cumsum(contrib, dim=Z)
        return -(above + 0.5 * contrib)

    def compute_diffusivities(self, state, g=None):
        """The closure's coefficients of this step, one entry a closure."""
        return closures_mod.compute_diffusivities(
            self.closure, self.grid if g is None else g, state.u, state.v,
            state.w,
            state.tracers, self.buoyancy,
            top_fluxes=lambda: top_flux_values(self.bcs, self.grid,
                                               state.clock.time))

    def fields(self, state):
        """The fields that forcings and boundary conditions see: the
        state's and the auxiliary fields."""
        fields = state.fields()
        if not self.auxiliary_fields:
            return fields
        g = self.grid
        for name, val in self.auxiliary_fields.items():
            key = (name, g.device, g.dtype)
            if key not in self._aux_on_grid:
                self._aux_on_grid[key] = (
                    torch.as_tensor(val, dtype=g.dtype, device=g.device)
                    if hasattr(val, "ndim") else set_field(g, val, loc=LOC_C))
            fields[name] = self._aux_on_grid[key]
        return fields

    def momentum_tendencies(self, state, diffusivities=None, g=None):
        """``(Gu, Gv)``: momentum advection, Stokes drift, Coriolis, the
        hydrostatic pressure gradient (with the σ-levels' slope term under
        z-star), the explicit free surface's g∇η, the closure's explicit
        stress divergence (with ``diffusivities``, computed here when not
        given), the forcings and the boundary fluxes; on ``g``, the
        model's active grid by default."""
        if g is None:
            g = self._active_grid(state)
        u, v, w = state.u, state.v, state.w
        time, fields = state.clock.time, self.fields(state)
        ma = self.momentum_advection
        if isinstance(ma, VectorInvariant):
            if self.fused_kernels:
                Gu, Gv = vi_momentum_tendency(g, ma, u, v, w,
                                              metrics=self._vi_metrics)
            else:
                Gu = ma.u_tendency(g, u, v, w)
                Gv = ma.v_tendency(g, u, v, w)
        else:
            Gu = -div_vu(g, ma, u, v, w)
            Gv = -div_vv(g, ma, u, v, w)
        if self.stokes_drift is not None:
            Gu = Gu + self.stokes_drift.x_tendency(g, u, v, w, time)
            Gv = Gv + self.stokes_drift.y_tendency(g, u, v, w, time)
        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(g, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(g, u, v, w)
        p_anom = self.hydrostatic_pressure_anomaly(state, g)
        if p_anom is not None:
            Gu = Gu - dx_f(p_anom) / g.dx(Face, Center)
            Gv = Gv - dy_f(p_anom) / g.dy(Face, Center)
            if self.zstar:
                # the gradient along a σ-level differs from the one at
                # constant z by b ∂x(z), with z = σ z_ref + η; ∂z p′ = +b,
                # so the correction adds it
                b = self.buoyancy.buoyancy_ccc(g, state.tracers)
                z_c = (self._sigma(state.eta)
                       * self.grid.zC.reshape(1, 1, -1) + state.eta)
                Gu = Gu + ix_f(b) * dx_f(z_c) / g.dx(Face, Center)
                Gv = Gv + iy_f(b) * dy_f(z_c) / g.dy(Face, Center)
        fs = self.free_surface
        if isinstance(fs, ExplicitFreeSurface):
            Gu = Gu - fs.g * dx_f(state.eta) / g.dx(Face, Center)
            Gv = Gv - fs.g * dy_f(state.eta) / g.dy(Face, Center)
        if self.closure is not None:
            if diffusivities is None:
                diffusivities = self.compute_diffusivities(state, g)
            du, dv, _ = closures_mod.momentum_flux_divergences(
                self.closure, g, u, v, w, state.tracers, diffusivities,
                include_implicit=False)
            Gu, Gv = Gu + du, Gv + dv
        f = self.forcings
        Gu = Gu if f["u"] is None else Gu + f["u"](g, time, fields)
        Gv = Gv if f["v"] is None else Gv + f["v"](g, time, fields)
        Gu = apply_flux_bcs(Gu, g, self.bcs["u"], LOC_U, time, fields)
        Gv = apply_flux_bcs(Gv, g, self.bcs["v"], LOC_V, time, fields)
        if not self.immersed:
            return Gu, Gv
        for name, vel, loc in (("u", u, LOC_U), ("v", v, LOC_V)):
            ib = self.immersed_bcs.get(name)
            if ib is None:
                continue
            term = immersed_flux_divergence(g, ib, loc, vel,
                                            self._ib_kappa[name], time)
            if name == "u":
                Gu = Gu + term
            else:
                Gv = Gv + term
        return (mask_immersed_field(self.grid, Gu, LOC_U),
                mask_immersed_field(self.grid, Gv, LOC_V))

    def tracer_tendencies(self, state, diffusivities=None, g=None):
        """``{name: Gc}``: each tracer's advection (by its advective
        forcings' velocities too), the closure's explicit flux divergence
        (with ``diffusivities``, computed here when not given), the
        biogeochemical transition and drift, the forcing and the boundary
        fluxes; then the biogeochemistry's ``update_tendencies``; on
        ``g``, the model's active grid by default."""
        if g is None:
            g = self._active_grid(state)
        u, v, w = state.u, state.v, state.w
        tracers = state.tracers
        time, fields = state.clock.time, self.fields(state)
        if self.closure is not None and diffusivities is None:
            diffusivities = self.compute_diffusivities(state, g)
        fused = {}
        if self.fused_tracer:
            # one kernel for every tracer without an advective forcing:
            # the velocities are read once
            fused = weno_tracer_tendencies(
                g, self.tracer_advection, u, v, w,
                {n: tracers[n] for n in self.tracer_names
                 if n not in self.advective_forcings},
                metrics=self._tracer_metrics)
        bgc = self.biogeochemistry
        Gtracers = {}
        for name in self.tracer_names:
            c = tracers[name]
            Gc = fused.get(name)
            if Gc is None:
                ua, va, wa = u, v, w
                for af in self.advective_forcings.get(name, ()):
                    du, dv, dw = af.velocities(g)
                    ua, va, wa = ua + du, va + dv, wa + dw
                Gc = -div_Uc(g, self.tracer_advection, ua, va, wa, c)
            if self.closure is not None:
                Gc = Gc + closures_mod.tracer_flux_divergence(
                    self.closure, g, name, c, tracers, diffusivities,
                    include_implicit=False)
            if bgc is not None:
                reaction = bgc.transition(g, name, time, fields)
                if reaction is not None:
                    Gc = Gc + reaction
                drift = bgc.drift_velocity(name)
                if drift is not None:
                    wu, wv, ww = (torch.zeros_like(c) + d for d in drift)
                    Gc = Gc - div_Uc(g, self.tracer_advection, wu, wv, ww,
                                     c)
            forcing = self.forcings[name]
            if forcing is not None:
                Gc = Gc + forcing(g, time, fields)
            Gc = apply_flux_bcs(Gc, g, self.bcs[name], LOC_C, time, fields)
            ib = self.immersed_bcs.get(name)
            if ib is not None:
                Gc = Gc + immersed_flux_divergence(
                    g, ib, LOC_C, c, self._ib_kappa[name], time)
            Gtracers[name] = mask_immersed_field(self.grid, Gc, LOC_C)
        if bgc is not None:
            Gtracers = bgc.update_tendencies(g, Gtracers, time, fields)
        return Gtracers

    def compute_tendencies(self, state, diffusivities=None, g=None):
        """``(Gu, Gv, {name: Gc})`` on ``g`` (the active grid by default),
        with the ``tendency_callbacks`` applied in order; ``diffusivities``
        are computed here when not given."""
        if g is None:
            g = self._active_grid(state)
        if diffusivities is None:
            diffusivities = self.compute_diffusivities(state, g)
        Gu, Gv = self.momentum_tendencies(state, diffusivities, g)
        Gt = self.tracer_tendencies(state, diffusivities, g)
        for hook in self.tendency_callbacks:
            G = hook(g, state, {"u": Gu, "v": Gv, **Gt})
            Gu, Gv = G["u"], G["v"]
            Gt = {n: G[n] for n in Gt}
        return Gu, Gv, Gt

    # ------------------------------------------------------------------
    # Barotropic mode and the split-explicit free surface
    # ------------------------------------------------------------------
    def _barotropic_mode(self, u, v, sigma_fc=None, sigma_cf=None):
        """(U, V) = ∫ (u, v) dz over the interior; under z-star through the
        moving thicknesses σ dz (``sigma_fc``, ``sigma_cf``)."""
        dzu = self._dzm if sigma_fc is None else sigma_fc * self._dzm
        dzv = self._dzm if sigma_cf is None else sigma_cf * self._dzm
        return (torch.sum(u * dzu, dim=Z, keepdim=True),
                torch.sum(v * dzv, dim=Z, keepdim=True))

    def _zero_wall_transports(self, U, V):
        """Zero the transports on the wall faces (and beyond) of Bounded
        axes: the substepped transports must keep the impenetrability the
        baroclinic velocities get from their wall conditions."""
        if self._U_walls is not None:
            U = torch.where(self._U_walls, 0.0, U)
        if self._V_walls is not None:
            V = torch.where(self._V_walls, 0.0, V)
        return U, V

    def _div_transports(self, U, V):
        """(δx(Δy U) + δy(Δx V)) / Az of transports at (f,c) and (c,f)."""
        g = self.grid
        return (dx_c(g.dy(Center, Face) * U)
                + dy_c(g.dx(Center, Face) * V)) / g.Az(Center, Center)

    def _split_explicit_substep(self, eta, U, V, GU, GV, dtau, fs):
        """One forward-backward barotropic substep: η ← η − Δτ ∇·(U, V),
        then (U, V) ← (U, V) + Δτ (−g H ∇η + (GU, GV))."""
        g = self.grid
        U, V = self._zero_wall_transports(U, V)
        eta = eta - dtau * self._div_transports(U, V)
        eta = self._fill_eta_halos(eta)
        H_fc, H_cf = self._H_fc, self._H_cf
        U = U + dtau * (-fs.g * H_fc * dx_f(eta) / g.dx(Face, Center) + GU)
        V = V + dtau * (-fs.g * H_cf * dy_f(eta) / g.dy(Face, Center) + GV)
        if self.immersed:
            # no transport through a dry face
            U = torch.where(H_fc > 0, U, 0.0)
            V = torch.where(H_cf > 0, V, 0.0)
        U, V = self._zero_wall_transports(U, V)
        return eta, U, V

    def _step_free_surface_split(self, state, Gu_ab2, Gv_ab2, dt, fs):
        """The substep loop from the persistent transports, forced by the
        vertically integrated AB2 tendencies; returns the weighted averages
        (η, U, V). ``dt`` is a 0-d CPU tensor in the state's dtype."""
        GU = torch.sum(Gu_ab2 * self._dzm, dim=Z, keepdim=True)
        GV = torch.sum(Gv_ab2 * self._dzm, dim=Z, keepdim=True)
        eta, U, V = (state.eta,
                     *self._fill_transport_halos(state.U, state.V))
        dtau = (dt * fs.fractional_step).item()
        # the weights in the fields' dtype, as the JAX scan casts them
        weights = torch.tensor(fs.weights, dtype=eta.dtype).tolist()
        eta_f = torch.zeros_like(eta)
        U_f = torch.zeros_like(U)
        V_f = torch.zeros_like(V)
        for wgt in weights:
            eta, U, V = self._split_explicit_substep(eta, U, V, GU, GV, dtau,
                                                     fs)
            eta_f = eta_f + wgt * eta
            U_f = U_f + wgt * U
            V_f = V_f + wgt * V
        return eta_f, U_f, V_f

    def _barotropic_correct(self, state, U_target, V_target, sigma_fc=None,
                            sigma_cf=None):
        """u ← u + (Ū − ∫u dz)/H: the baroclinic velocities take the
        averaged barotropic transports (the mode and H through the moving
        thicknesses under z-star). On an immersed grid H is the wet depth,
        dry columns are left as they are and solid faces stay zero."""
        U, V = self._barotropic_mode(state.u, state.v, sigma_fc, sigma_cf)
        H_fc, H_cf = self._H_fc, self._H_cf
        if sigma_fc is not None:
            H_fc, H_cf = H_fc * sigma_fc, H_cf * sigma_cf
        if not self.immersed:
            return _replace(state, u=state.u + (U_target - U) / H_fc,
                            v=state.v + (V_target - V) / H_cf)
        du = torch.where(H_fc > 0, (U_target - U)
                         / torch.where(H_fc > 0, H_fc, 1.0), 0.0)
        dv = torch.where(H_cf > 0, (V_target - V)
                         / torch.where(H_cf > 0, H_cf, 1.0), 0.0)
        g = self.grid
        return _replace(state,
                        u=mask_immersed_field(g, state.u + du, LOC_U),
                        v=mask_immersed_field(g, state.v + dv, LOC_V))

    # ------------------------------------------------------------------
    # The implicit free surface
    # ------------------------------------------------------------------
    def _fs_denominator(self, fs, dtf):
        """g H λ − 1/Δt² over the horizontal eigenvalues of the flat-bottom
        operator (DCT-II on Bounded axes, FFT on Periodic ones), formed in
        float64 once for each g and Δt and cast once to the fields' dtype:
        g H λ reaches ~1e5 where 1/Δt² is ~1e-4."""
        g = self.grid
        key = (fs.g, dtf, g.device, g.dtype)
        den = self._fs_denominators.get(key)
        if den is None:
            lam = 0.0
            for axis in (0, 1):
                N = g.N[axis]
                extent = (g.Lx, g.Ly)[axis]
                ev = poisson_eigenvalues(N, extent / N, g.axis_topo(axis))
                shape = [1, 1, 1]
                shape[axis] = ev.shape[0]
                lam = lam + ev.reshape(shape)
            den = fs.g * float(g.Lz) * lam - 1.0 / (dtf * dtf)
            den = torch.as_tensor(den, dtype=g.dtype, device=g.device)
            self._fs_denominators[key] = den
        return den

    def _step_free_surface_implicit(self, state, dtf, fs, sigma_fc=None,
                                    sigma_cf=None):
        """η^{n+1} of [∇·(gH∇) − 1/Δt²] η = (∇·U* − ηⁿ/Δt)/Δt, U* the
        barotropic mode of the updated velocities; halos filled."""
        g = self.grid
        U, V = self._barotropic_mode(state.u, state.v, sigma_fc, sigma_cf)
        rhs = (self._div_transports(U, V) - state.eta / dtf) / dtf
        if self.dist_halo is not None:
            # a rank's block: the spectral and matrix solvers need global
            # transforms, so CG with all-reduced inner products
            eta = self._implicit_fs_cg(rhs, dtf, fs)
        elif fs.solver_method == "fft":
            sx, sy, _ = g.interior_slices
            axes = [ax for ax in (0, 1) if g.N[ax] > 1]
            fft_axes = [ax for ax in axes if g.axis_topo(ax) == Periodic]
            dct_axes = [ax for ax in axes if g.axis_topo(ax) == Bounded]
            x = rhs[sx, sy, :]
            for ax in dct_axes:
                x = dct2(x, ax)
            for ax in fft_axes:
                x = torch.fft.fft(x, dim=ax)
            x = x / self._fs_denominator(fs, dtf)
            for ax in fft_axes:
                x = torch.fft.ifft(x, dim=ax)
            if x.is_complex():
                x = torch.real(x)
            for ax in dct_axes:
                x = idct2(x, ax)
            eta = torch.zeros_like(state.eta)
            eta[sx, sy, :] = x
        elif fs.solver_method == "matrix":
            eta = self._implicit_fs_matrix(rhs, dtf, fs)
        else:
            eta = self._implicit_fs_cg(rhs, dtf, fs)
        return self._fill_eta_halos(eta)

    def _implicit_fs_matrix(self, rhs, dtf, fs):
        """The volume-weighted pentadiagonal operator Az·L = Σ_faces a_f
        (η_nb − η_c) − Az η/Δt², a_f = g H Δy/Δx (zero on the walls),
        solved by the preconditioned :class:`HeptadiagonalIterativeSolver`
        over the interior."""
        g = self.grid
        sx, sy, _ = g.interior_slices
        shape2d = (g.shape[0], g.shape[1], 1)

        def b2(m):
            return torch.broadcast_to(m, shape2d)[sx, sy, :]

        ax = (fs.g * b2(self._H_fc) * b2(g.dy(Center, Face))
              / b2(g.dx(Face, Center)))
        ay = (fs.g * b2(self._H_cf) * b2(g.dx(Center, Face))
              / b2(g.dy(Face, Center)))
        per_x = g.axis_topo(0) == Periodic
        per_y = g.axis_topo(1) == Periodic
        if not per_x:
            ax[0, :, :] = 0.0
        if not per_y:
            ay[:, 0, :] = 0.0
        Az = b2(g.Az(Center, Center))
        A = StencilMatrix(ax=ax, ay=ay, extra=-Az / (dtf * dtf),
                          periodic=(per_x, per_y, False))
        solver = HeptadiagonalIterativeSolver(
            A, maxiter=fs.maxiter, reltol=fs.reltol,
            preconditioner=fs.preconditioner)
        x, it, _ = solver.solve(Az * rhs[sx, sy, :])
        self.free_surface_info = {"iterations": it,
                                  "host_syncs": solver.host_syncs}
        return pad_interior(x, (g.H[0], g.H[1], 0))

    def _implicit_fs_cg(self, rhs, dtf, fs):
        """Matrix-free CG on the 2-D Helmholtz operator over the interior,
        from η = 0, on any grid."""
        g = self.grid
        H_fc, H_cf, inside = self._H_fc, self._H_cf, self._interior2d

        def L(eta):
            # a copy: CG's search direction may share its residual's storage
            eta = self._fill_eta_halos(eta.clone())
            gx = fs.g * H_fc * dx_f(eta) / g.dx(Face, Center)
            gy = fs.g * H_cf * dy_f(eta) / g.dy(Face, Center)
            div = (dx_c(g.dy(Center, Face) * gx)
                   + dy_c(g.dx(Center, Face) * gy)) / g.Az(Center, Center)
            return torch.where(inside, div - eta / (dtf * dtf), 0.0)

        b = torch.where(inside, rhs, 0.0)
        info = {}
        dot = None
        if self.dist_halo is not None:
            dist = self.dist_halo.dist

            def dot(x, y):
                return dist.all_reduce(torch.sum(x * y))
        eta, it, _ = conjugate_gradient(L, b, torch.zeros_like(b),
                                        maxiter=fs.maxiter, reltol=fs.reltol,
                                        dot=dot, info=info)
        self.free_surface_info = {"iterations": it,
                                  "host_syncs": info["host_syncs"]}
        return eta

    def _implicit_correct(self, state, dtf, fs, sigma_fc=None,
                          sigma_cf=None):
        """The implicit free-surface solve from a filled state, then
        u, v ← u, v − Δt g ∇η^{n+1}; halos filled."""
        g = self.grid
        eta = self._step_free_surface_implicit(state, dtf, fs, sigma_fc,
                                               sigma_cf)
        u = state.u - dtf * fs.g * dx_f(eta) / g.dx(Face, Center)
        v = state.v - dtf * fs.g * dy_f(eta) / g.dy(Face, Center)
        return self.fill_state_halos(_replace(state, u=u, v=v, eta=eta))

    # ------------------------------------------------------------------
    # Time stepping
    # ------------------------------------------------------------------
    def step(self, state, dt, chi=0.1, assume_filled=False):
        """One step of the configured time stepper (quasi-AB2 or
        ``split_rk3``) with the configured free surface.
        ``assume_filled=True`` skips the leading fill and w diagnosis:
        every step ends with them, so a loop does them once before its
        first step and passes ``assume_filled=True``."""
        dt = torch.tensor(dt, dtype=state.u.dtype)
        if not assume_filled:
            state = self.update_state(state)
        if self.timestepper == "split_rk3":
            state = self._step_split_rk3(state, dt)
        else:
            state = self._step_qab2(state, dt, chi)
        if self.particles is None or state.particles is None:
            return state
        # the particles advect at the end of the step, as in the JAX step
        return _replace(state, particles=self.particles.step(
            self.grid, state.particles, state.u, state.v, state.w,
            state.fields(), dt))

    def ab2_update(self, state, dt, chi=0.1, tendencies=None, sigmas=None):
        """The quasi-AB2 update of u, v and the tracers with the
        ``tendencies`` ``(Gu, Gv, Gtracers)`` (computed here when not
        given): ``(u, v, tracers, Gu, Gv, Gtracers, Gu_ab2, Gv_ab2)``; the
        first part of :meth:`step`. Under z-star the tendencies are
        σ-weighted and ``sigmas`` = (σ, σ_fc, σ_cf) divide the updates."""
        dtf = dt.item()
        Gu, Gv, Gt = (self.compute_tendencies(state) if tendencies is None
                      else tendencies)
        c_now, c_prev = ab2_coefficients(state.clock.iteration, chi)
        Gu_ab2 = c_now * Gu + c_prev * state.Gu
        Gv_ab2 = c_now * Gv + c_prev * state.Gv
        if sigmas is None:
            u = state.u + dtf * Gu_ab2
            v = state.v + dtf * Gv_ab2
            tracers = {n: state.tracers[n]
                       + dtf * (c_now * Gt[n] + c_prev * state.Gtracers[n])
                       for n in self.tracer_names}
        else:
            s_c, s_fc, s_cf = sigmas
            u = state.u + dtf * Gu_ab2 / s_fc
            v = state.v + dtf * Gv_ab2 / s_cf
            tracers = {n: state.tracers[n]
                       + dtf * (c_now * Gt[n] + c_prev * state.Gtracers[n])
                       / s_c for n in self.tracer_names}
        return u, v, tracers, Gu, Gv, Gt, Gu_ab2, Gv_ab2

    def _step_qab2(self, state, dt, chi=0.1):
        """Quasi-AB2 from a filled state with w diagnosed, then the
        closure's implicit vertical diffusion. ``dt`` is a 0-d CPU tensor in
        the state's dtype. Under z-star the tendencies are σ-weighted (only
        those telescope across the grid's update), and u, v and the
        tracers are rescaled by σⁿ/σⁿ⁺¹ after the free surface's."""
        g = self._active_grid(state)
        diffusivities = self.compute_diffusivities(state, g)
        Gu, Gv, Gt = self.compute_tendencies(state, diffusivities, g)
        sig_n = sig_fc = sig_cf = None
        if self.zstar:
            sig_n, sig_fc, sig_cf = g.sigma, g.sigma_fc, g.sigma_cf
            Gu, Gv = Gu * sig_fc, Gv * sig_cf
            Gt = {n: Gc * sig_n for n, Gc in Gt.items()}
        u, v, tracers, Gu, Gv, Gt, Gu_ab2, Gv_ab2 = self.ab2_update(
            state, dt, chi, (Gu, Gv, Gt),
            (sig_n, sig_fc, sig_cf) if self.zstar else None)
        dtf = dt.item()
        fs = self.free_surface
        Geta = state.Geta
        if isinstance(fs, ExplicitFreeSurface):
            # η is an AB2 prognostic with Gη = −∇·U of the same time-n
            # transports whose fluxes move the tracers (no wall zeroing:
            # under z-star they must match the tracer fluxes bit for bit)
            c_now, c_prev = ab2_coefficients(state.clock.iteration, chi)
            Geta = -self._div_transports(*self._barotropic_mode(
                state.u, state.v, sig_fc, sig_cf))
            eta = state.eta + dtf * (c_now * Geta + c_prev * state.Geta)
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers, eta=eta))
        elif isinstance(fs, ImplicitFreeSurface):
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers))
            state2 = self._implicit_correct(state2, dtf, fs, sig_fc, sig_cf)
        else:
            eta_f, U_f, V_f = self._step_free_surface_split(
                _replace(state, u=u, v=v), Gu_ab2, Gv_ab2, dt, fs)
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers, eta=eta_f,
                         U=U_f, V=V_f))
            state2 = self._barotropic_correct(state2, U_f, V_f, sig_fc,
                                              sig_cf)
        if self.zstar:
            # the columns stretched from σⁿ to σⁿ⁺¹: ∫ σ q dV is kept
            ratio = sig_n / self._sigma(state2.eta)
            state2 = _replace(
                state2,
                u=state2.u * (sig_fc / self._sigma_at(state2.eta, "fc")),
                v=state2.v * (sig_cf / self._sigma_at(state2.eta, "cf")),
                tracers={n: c * ratio for n, c in state2.tracers.items()})
        state2 = _replace(state2, Gu=Gu, Gv=Gv, Gtracers=Gt, Geta=Geta)
        state2 = self._implicit_diffusion(state2, diffusivities, dt)
        state2 = _replace(state2, clock=tick(state2.clock, dt))
        return self.update_state(state2)

    def _substep_euler(self, state, dt):
        """One forward-Euler substep of ``split_rk3`` from a filled state
        with w diagnosed: the tendencies, the update, the free surface and
        its correction. Returns the stepped state (halos filled) and the
        diffusivities."""
        dtf = dt.item()
        diffusivities = self.compute_diffusivities(state)
        Gu, Gv, Gt = self.compute_tendencies(state, diffusivities)
        u = state.u + dtf * Gu
        v = state.v + dtf * Gv
        tracers = {n: state.tracers[n] + dtf * Gt[n]
                   for n in self.tracer_names}
        fs = self.free_surface
        if isinstance(fs, ExplicitFreeSurface):
            # η from the time-n transports, the level the tracer fluxes used
            eta = state.eta - dtf * self._div_transports(
                *self._barotropic_mode(state.u, state.v))
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers, eta=eta))
        elif isinstance(fs, ImplicitFreeSurface):
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers))
            state2 = self._implicit_correct(state2, dtf, fs)
        else:
            eta_f, U_f, V_f = self._step_free_surface_split(
                _replace(state, u=u, v=v), Gu, Gv, dt, fs)
            state2 = self.fill_state_halos(
                _replace(state, u=u, v=v, tracers=tracers, eta=eta_f,
                         U=U_f, V=V_f))
            state2 = self._barotropic_correct(state2, U_f, V_f)
        return state2, diffusivities

    def _step_split_rk3(self, state, dt):
        """SSP (Shu-Osher) RK3 from a filled state: each stage a full-Δt
        Euler substep (with its own free-surface solve), convex-combined
        with the state at the start of the step (u, v, η, the tracers and
        the barotropic transports); the implicit vertical diffusion once at
        the end."""
        psi = state
        s = state
        for k, (gamma, zeta) in enumerate(((1.0, 0.0), (0.25, 0.75),
                                           (2.0 / 3.0, 1.0 / 3.0))):
            if k:
                s = self.update_state(s)
            s2, diffusivities = self._substep_euler(s, dt)
            s = self.fill_state_halos(_replace(
                s2,
                u=zeta * psi.u + gamma * s2.u,
                v=zeta * psi.v + gamma * s2.v,
                eta=zeta * psi.eta + gamma * s2.eta,
                tracers={n: zeta * psi.tracers[n] + gamma * s2.tracers[n]
                         for n in self.tracer_names},
                U=zeta * psi.U + gamma * s2.U,
                V=zeta * psi.V + gamma * s2.V))
        s = self._implicit_diffusion(s, diffusivities, dt)
        s = _replace(s, clock=tick(s.clock, dt))
        return self.update_state(s)

    def _implicit_diffusion(self, state, diffusivities, dt):
        """The closure's vertically implicit diffusion of u, v and the
        tracers over ``dt``, where it has one: a Thomas solve down every
        column of the halo-extended grid for each field."""
        if not closures_mod.closure_is_vertically_implicit(self.closure):
            return state
        u, v, tracers = closures_mod.implicit_vertical_diffusion_step(
            self.grid, self.closure, diffusivities, dt,
            u=state.u, v=state.v, tracers=state.tracers)
        return _replace(state, u=u, v=v, tracers=tracers)

    def cfl_timescale(self, state):
        return cell_advection_timescale(self.grid, state.u, state.v,
                                        state.w)

    def diffusion_timescale(self, state):
        """Δmin²/ν_max of the closure (Δmin⁴ for biharmonic ones), +inf
        without one; for ``TimeStepWizard(diffusive_cfl=)``."""
        return closures_mod.cell_diffusion_timescale(
            self.closure, self.grid, self.compute_diffusivities(state))

    def extra_repr(self):
        return (f"free_surface={self.free_surface!r}, "
                f"momentum_advection={self.momentum_advection!r}, "
                f"tracer_advection={self.tracer_advection!r}, "
                f"tracers={self.tracer_names}, closure={self.closure!r}")


__all__ = ["CrossAndSelfUpwinding", "ExplicitFreeSurface",
           "HydrostaticFreeSurfaceModel", "HydrostaticState",
           "ImplicitFreeSurface", "OnlySelfUpwinding",
           "PrescribedVelocityFields", "SplitExplicitFreeSurface",
           "VectorInvariant", "WENOVectorInvariant", "ZCoordinate", "ZStar",
           "averaging_shape_function", "weights_from_substeps"]
