"""Momentum advection of the hydrostatic and shallow-water models.

Counterpart of the momentum-advection part of
``oceananigans_tpu/models/hydrostatic.py``. For now it holds only
``VectorInvariant`` with its two centred vorticity schemes, which the
shallow-water model's vector-invariant formulation uses. The hydrostatic
free-surface model itself, the scheme-valued (upwinded) vorticity,
vertical, divergence and kinetic-energy schemes, the upwinding treatments
and the multi-dimensional stencil come with ROADMAP Queue 1 item 15 and
raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.ops.operators import ix_c, ix_f, iy_c, iy_f

_LATER = "is not ported yet (ROADMAP Queue 1 item 15)"

VORTICITY_SCHEMES = ("enstrophy_conserving", "energy_conserving")


class VectorInvariant:
    """Rotational-form momentum advection: 𝐯·∇u = ζ ẑ×u + ∇K + w ∂z u.

    ``vorticity_scheme`` is "enstrophy_conserving" (the default: ℑy(ζ)·v̂
    with the length-weighted transverse velocity v̂ = ℑxy(Δx v)/Δxᶠᶜᶜ) or
    "energy_conserving" (ℑy(ζ·ℑx(Δx v))/Δxᶠᶜᶜ). ``vorticity_stencil`` is
    kept for the keyword surface; it matters only for upwinded vorticity.
    """

    def __init__(self, vorticity_scheme="enstrophy_conserving",
                 vorticity_stencil="velocity",
                 vertical_scheme="energy_conserving",
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=None, multi_dimensional_stencil=False):
        for name, scheme in (
                ("vorticity_scheme", vorticity_scheme),
                ("vertical_scheme", vertical_scheme),
                ("divergence_scheme", divergence_scheme),
                ("kinetic_energy_gradient_scheme",
                 kinetic_energy_gradient_scheme)):
            if scheme is not None and not isinstance(scheme, str):
                raise NotImplementedError(
                    f"VectorInvariant({name}={scheme!r}), an upwinded "
                    f"vector-invariant form, {_LATER}")
        if upwinding is not None:
            raise NotImplementedError(f"VectorInvariant(upwinding=...) "
                                      f"{_LATER}")
        if multi_dimensional_stencil:
            raise NotImplementedError(
                f"VectorInvariant(multi_dimensional_stencil=True) {_LATER}")
        if vorticity_scheme not in VORTICITY_SCHEMES:
            raise ValueError(
                f"unknown vorticity_scheme {vorticity_scheme!r}")
        if vorticity_stencil not in ("velocity", "default"):
            raise ValueError(
                f"unknown vorticity_stencil {vorticity_stencil!r}")
        if vertical_scheme != "energy_conserving":
            raise ValueError(f"unknown vertical_scheme {vertical_scheme!r}")
        self.vorticity_scheme = vorticity_scheme
        self.vorticity_stencil = vorticity_stencil
        self.vertical_scheme = vertical_scheme

    @property
    def required_halo(self):
        """ζ consumes one halo cell on top of the centred interpolations."""
        return 2

    def _key(self):
        return ("VectorInvariant", self.vorticity_scheme,
                self.vorticity_stencil, self.vertical_scheme)

    def __eq__(self, other):
        return isinstance(other, VectorInvariant) and \
            self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"VectorInvariant({self.vorticity_scheme!r}, "
                f"vertical_scheme={self.vertical_scheme!r})")

    def _zeta_v(self, grid, zeta, u, v):
        """The +ζ v̂ term of the u equation, at (f,c,c)."""
        dxv = grid.dx(Center, Face) * v
        if self.vorticity_scheme == "energy_conserving":
            return iy_c(zeta * ix_f(dxv)) / grid.dx(Face, Center)
        return iy_c(zeta) * ix_f(iy_c(dxv)) / grid.dx(Face, Center)

    def _zeta_u(self, grid, zeta, u, v):
        """The ζ û term that the v equation subtracts, at (c,f,c)."""
        dyu = grid.dy(Center, Face) * u
        if self.vorticity_scheme == "energy_conserving":
            return ix_c(zeta * iy_f(dyu)) / grid.dy(Face, Center)
        return ix_c(zeta) * iy_f(ix_c(dyu)) / grid.dy(Face, Center)


__all__ = ["VectorInvariant"]
