"""Advection schemes: reconstruction and flux-form divergences.

Counterpart of ``oceananigans_tpu/advection.py``: Centered of orders 2 to
12, UpwindBiased of orders 1 to 11, WENO-Z of orders 3 to 11, and
FluxFormAdvection (one scheme per axis). Each reconstruction is a
whole-tensor expression over shifted copies of its operand; upwinding is a
``torch.where`` on the sign of the advecting velocity. On a stretched axis
a scheme bound to the grid (``bind_grid``, at model build) takes per-point
coefficient tables (and per-point WENO ideal weights) in place of the
uniform coefficients. On an immersed grid a flux whose full stencil
touches a solid value falls back to Centered(2) or UpwindBiased(1)
(:func:`_face_value_ib`), and the momentum cross-term fluxes are zeroed
where they touch a solid cell.

Index convention (``ops/operators.py``): ``shift(a, n, axis)[i] = a[i+n]``.
A reconstruction that lands on faces (``o = 0``) gives the value at face
``i``, between centers ``i-1`` and ``i``; one that lands on centers
(``o = 1``) gives the value at center ``i``, the same stencil shifted by +1.

Two limiters keep a tracer within bounds: ``WENO(bounds=(lo, hi))`` takes
the Zhang-Shu limited flux divergence (:func:`_bounded_div_Uc`), and
``BoundPreserving(scheme)`` clips every face reconstruction to the range of
its two adjacent cells. Strict bound preservation also needs an SSP time
stepper (the hydrostatic model's ``split_rk3``). No kernel takes either.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.immersed import mask_flux, solid_mask_at
from oceananigans_torch.ops.operators import (
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f,
    X, Y, Z, shift,
)
from oceananigans_torch.ops.reconstruction_coefficients import (
    face_reconstruction_coefficients, stretched_reconstruction_tables,
    weno_stretched_tables,
)

def _mirror(stencil):
    """The right-biased mirror of a left-biased stencil: offsets reflected
    about the target face (n -> -1 - n)."""
    return {-1 - n: c for n, c in stencil.items()}


def _apply_stencil(a, axis, stencil, o):
    """Σ c · shift(a, n + o) over the stencil, in ascending offsets; the
    coefficients are numbers, or per-point tensors along ``axis`` (a
    stretched axis's tables)."""
    out = None
    for n, c in sorted(stencil.items()):
        term = c * shift(a, n + o, axis)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Stretched axes: per-point coefficient tables, bound at model build
# ---------------------------------------------------------------------------

def _stretched_axes(grid):
    """The axes of ``grid`` that are stretched, have more than one cell and
    a separable 1-D coordinate (a curvilinear grid's 2-D coordinates keep
    the uniform coefficients), as in the JAX package."""
    axes = []
    for axis, name in enumerate(("x", "y", "z")):
        if grid.N[axis] <= 1 or getattr(grid, f"{name}_regular", True):
            continue
        coord = getattr(grid, f"{name}F", None)
        if coord is None or coord.numel() != coord.shape[axis]:
            continue
        axes.append(axis)
    return axes


def _cell_edges(grid, axis, o=0):
    """Halo-extended source-cell edges along ``axis`` in float64 numpy:
    the faces for center-located data (o = 0), the centers for
    face-located data reconstructed to centers (o = 1, the dual cells).
    Length n + 1."""
    name = ("x", "y", "z")[axis]
    arr = getattr(grid, f"{name}F" if o == 0 else f"{name}C")
    c = arr.detach().cpu().double().numpy().reshape(-1)
    return np.append(c, 2 * c[-1] - c[-2])


def _table(c, axis, grid):
    """A (n,) numpy table as a broadcast-ready tensor on ``grid``."""
    shape = [1, 1, 1]
    shape[axis] = len(c)
    return torch.as_tensor(c, dtype=grid.dtype,
                           device=grid.device).reshape(shape)


def _tables_of(grid, offsets):
    """``{(axis, o): {offset: tensor}}`` for every stretched axis of
    ``grid`` and both targets."""
    return {(axis, o): {n: _table(c, axis, grid) for n, c in
                        stretched_reconstruction_tables(
                            _cell_edges(grid, axis, o), offsets).items()}
            for axis in _stretched_axes(grid) for o in (0, 1)}


class AdvectionScheme:
    """The base of the reconstruction schemes: a symmetric scheme provides
    ``reconstruct``, a biased one ``biased``, which the flux assemblies
    combine with the sign of the advecting velocity. Two schemes are equal
    when their type and order are."""

    symmetric = False
    order: int = 2

    @property
    def required_halo(self):
        # a centered scheme of order p = 2B, an upwind or WENO one of
        # p = 2B − 1, needs a halo of B
        return (self.order + 1) // 2

    def __eq__(self, other):
        return type(self) is type(other) and self.order == other.order

    def __hash__(self):
        return hash((type(self).__name__, self.order))


class Centered(AdvectionScheme):
    """Even-order centered reconstruction, orders 2 to 12 (coefficients
    generated exactly); Centered(2) gives ``(a[i-1] + a[i]) / 2`` at face
    i."""

    symmetric = True

    def __init__(self, order: int = 2):
        if order % 2 or not 2 <= order <= 12:
            raise ValueError(f"Centered order must be even in 2..12, "
                             f"got {order}")
        self.order = order
        self._stencil = face_reconstruction_coefficients(order, "centered")

    def reconstruct(self, a, axis, o):
        """Face value (o = 0) or center value (o = 1) of ``a``; the same
        stencil, shifted by ``o``."""
        tables = getattr(self, "_tables", None)
        if tables and (axis % 3, o) in tables:
            return _apply_stencil(a, axis, tables[(axis % 3, o)], o)
        return _apply_stencil(a, axis, self._stencil, o)

    def bind_grid(self, grid):
        """A copy carrying per-point coefficient tables for ``grid``'s
        stretched axes, for both targets; ``self`` on a regular grid."""
        if not _stretched_axes(grid):
            return self
        new = Centered(self.order)
        new._tables = _tables_of(grid, sorted(self._stencil))
        return new

    def __repr__(self):
        return f"Centered(order={self.order})"


class UpwindBiased(AdvectionScheme):
    """Odd-order upwind-biased reconstruction, orders 1 to 11
    (coefficients generated exactly); the right-biased stencil mirrors the
    left one about the face."""

    def __init__(self, order: int = 3):
        if order % 2 == 0 or not 1 <= order <= 11:
            raise ValueError(f"UpwindBiased order must be odd in 1..11, "
                             f"got {order}")
        self.order = order
        self._left = face_reconstruction_coefficients(order, "left")

    def biased(self, a, axis, o):
        """The left- and right-biased reconstructions of ``a`` at faces
        (o = 0) or centers (o = 1) along ``axis``."""
        tables = getattr(self, "_tables", None)
        if tables and (axis % 3, o) in tables:
            tl, tr = tables[(axis % 3, o)]
            return (_apply_stencil(a, axis, tl, o),
                    _apply_stencil(a, axis, tr, o))
        return (_apply_stencil(a, axis, self._left, o),
                _apply_stencil(a, axis, _mirror(self._left), o))

    def bind_grid(self, grid):
        """A copy carrying the left and right per-point tables of
        ``grid``'s stretched axes; ``self`` on a regular grid."""
        if not _stretched_axes(grid):
            return self
        new = UpwindBiased(self.order)
        left = _tables_of(grid, sorted(self._left))
        right = _tables_of(grid, sorted(_mirror(self._left)))
        new._tables = {key: (left[key], right[key]) for key in left}
        return new

    def __repr__(self):
        return f"UpwindBiased(order={self.order})"


# WENO sub-stencil coefficients and ideal weights, left-biased at face i.
# Sub-stencil r uses cells i-1-r .. i-1-r+(k-1) for order 2k-1; orders 9
# and 11 are generated (ops/reconstruction_coefficients.py).
_WENO_GAMMA = {
    3: (1 / 3, 2 / 3),
    5: (1 / 10, 6 / 10, 3 / 10),
    7: (1 / 35, 12 / 35, 18 / 35, 4 / 35),
}

_WENO_Q = {
    3: ({-2: -1 / 2, -1: 3 / 2},
        {-1: 1 / 2, 0: 1 / 2}),
    5: ({-3: 2 / 6, -2: -7 / 6, -1: 11 / 6},
        {-2: -1 / 6, -1: 5 / 6, 0: 2 / 6},
        {-1: 2 / 6, 0: 5 / 6, 1: -1 / 6}),
    7: ({-4: -3 / 12, -3: 13 / 12, -2: -23 / 12, -1: 25 / 12},
        {-3: 1 / 12, -2: -5 / 12, -1: 13 / 12, 0: 3 / 12},
        {-2: -1 / 12, -1: 7 / 12, 0: 7 / 12, 1: -1 / 12},
        {-1: 3 / 12, 0: 13 / 12, 1: -5 / 12, 2: 1 / 12}),
}


def _weno3_betas(s):
    return ((s[-1] - s[-2]) ** 2,
            (s[0] - s[-1]) ** 2)


def _weno5_betas(s):
    c1, c2 = 13.0 / 12.0, 0.25
    b0 = (c1 * (s[-3] - 2 * s[-2] + s[-1]) ** 2
          + c2 * (s[-3] - 4 * s[-2] + 3 * s[-1]) ** 2)
    b1 = (c1 * (s[-2] - 2 * s[-1] + s[0]) ** 2
          + c2 * (s[-2] - s[0]) ** 2)
    b2 = (c1 * (s[-1] - 2 * s[0] + s[1]) ** 2
          + c2 * (3 * s[-1] - 4 * s[0] + s[1]) ** 2)
    return b0, b1, b2


def _weno7_betas(s):
    """Balsara & Shu (2000) indicators for k = 4: the two edge and the two
    inner sub-stencils have mirrored quadratic forms."""
    def beta_edge(a, b, c, d):
        # most-upwind stencil, target face next to d
        return (a * (547 * a - 3882 * b + 4642 * c - 1854 * d)
                + b * (7043 * b - 17246 * c + 7042 * d)
                + c * (11003 * c - 9402 * d)
                + d * 2107 * d)

    def beta_inner(a, b, c, d):
        # one point downwind of the target face (face between c and d)
        return (a * (267 * a - 1642 * b + 1602 * c - 494 * d)
                + b * (2843 * b - 5966 * c + 1922 * d)
                + c * (3443 * c - 2522 * d)
                + d * 547 * d)

    return (beta_edge(s[-4], s[-3], s[-2], s[-1]),
            beta_inner(s[-3], s[-2], s[-1], s[0]),
            beta_inner(s[1], s[0], s[-1], s[-2]),
            beta_edge(s[2], s[1], s[0], s[-1]))


_WENO_BETAS = {3: _weno3_betas, 5: _weno5_betas, 7: _weno7_betas}


def _apply_stencil_shifted(shifts, stencil):
    out = None
    for n, c in sorted(stencil.items()):
        term = c * shifts[n]
        out = term if out is None else out + term
    return out


class WENO(AdvectionScheme):
    """WENO-Z reconstruction (Borges et al. 2008), orders 3 to 11. Orders
    3/5/7 use the classic hand-derived smoothness indicators, orders 9/11
    the generated quadratic forms."""

    def __init__(self, order: int = 5, epsilon: float = 1e-8, bounds=None):
        if order % 2 == 0 or not 3 <= order <= 11:
            raise ValueError(f"WENO order must be odd in 3..11, got {order}")
        self.order = order
        self.epsilon = epsilon
        #: (lo, hi): the tracer flux divergence takes the limited form
        self.bounds = None if bounds is None else (float(bounds[0]),
                                                   float(bounds[1]))
        if order in _WENO_Q:
            self._qs = _WENO_Q[order]
            self._gammas = _WENO_GAMMA[order]
            self._beta_forms = None
        else:
            from oceananigans_torch.ops.reconstruction_coefficients import (
                weno_beta_forms, weno_ideal_weights, weno_substencils,
            )
            self._qs = weno_substencils(order)
            self._gammas = weno_ideal_weights(order)
            self._beta_forms = tuple(
                [[float(x) for x in row] for row in M]
                for M in weno_beta_forms(order))

    def _betas_of(self, s):
        if self._beta_forms is None:
            return _WENO_BETAS[self.order](s)
        # β_r = sᵀ M_r s over the sub-stencil values
        k = self.required_halo
        betas = []
        for r, M in enumerate(self._beta_forms):
            vals = [s[(-1 - r) + j] for j in range(k)]
            b = 0.0
            for m in range(k):
                b = b + M[m][m] * vals[m] * vals[m]
                for n in range(m + 1, k):
                    if abs(M[m][n]) > 1e-14:
                        b = b + 2.0 * M[m][n] * vals[m] * vals[n]
            betas.append(b)
        return tuple(betas)

    @staticmethod
    def _z_alphas(gammas, betas, eps):
        """α_r = γ_r (1 + (τ/(β_r + ε))²). The ratio is capped (1e12 in
        float32, 1e60 in float64): for a dimensional field β can reach 1e14
        while ε = 1e-8, and the float32 square would overflow to inf and
        the normalisation give inf/inf = NaN. Weights below the cap are
        unchanged."""
        tau = abs(betas[0] - betas[-1])
        cap = 1e12 if tau.dtype == torch.float32 else 1e60
        return [g * (1.0 + torch.clamp(tau / (b + eps), max=cap) ** 2)
                for g, b in zip(gammas, betas)]

    def _onesided(self, shifts, reflect, smooth_shifts=None, tables=None):
        """One biased reconstruction from the taps ``shifts`` (offset ->
        tensor). ``smooth_shifts``: taps of other fields whose summed
        indicators replace ψ's own (the reference's FunctionStencil and
        VelocityStencil smoothness: β from the smoothness fields, the
        sub-stencil values from ψ). ``tables``: a stretched axis's
        ``(sub-stencil tables, ideal weights)`` of this side, applied to
        the unreflected taps; the indicators keep their uniform forms."""
        s = {n: shifts[-1 - n] for n in shifts} if reflect else shifts
        if tables is None:
            qs = [_apply_stencil_shifted(s, q) for q in self._qs]
            gammas = self._gammas
        else:
            subs, gammas = tables
            qs = [_apply_stencil_shifted(shifts, q) for q in subs]
        if smooth_shifts is None:
            betas = self._betas_of(s)
        else:
            betas = None
            for sm in smooth_shifts:
                smr = {n: sm[-1 - n] for n in sm} if reflect else sm
                bs = self._betas_of(smr)
                betas = bs if betas is None else tuple(
                    b0 + b1 for b0, b1 in zip(betas, bs))
        alphas = self._z_alphas(gammas, betas, self.epsilon)
        asum = alphas[0]
        for al in alphas[1:]:
            asum = asum + al
        out = alphas[0] * qs[0]
        for al, q in zip(alphas[1:], qs[1:]):
            out = out + al * q
        return out / asum

    def biased(self, a, axis, o, smooth=None):
        """The left- and right-biased reconstructions of ``a`` at faces
        (o = 0) or centers (o = 1) along ``axis``. ``smooth``: a list of
        fields at ``a``'s location whose summed smoothness indicators
        drive the nonlinear weights (see ``_onesided``)."""
        B = self.required_halo
        shifts = {n: shift(a, n + o, axis) for n in range(-B, B)}
        sm = None
        if smooth is not None:
            sm = [{n: shift(f, n + o, axis) for n in range(-B, B)}
                  for f in smooth]
        tables = getattr(self, "_tables", None)
        tl = tr = None
        if tables and (axis % 3, o) in tables:
            tl, tr = tables[(axis % 3, o)]
        return (self._onesided(shifts, reflect=False, smooth_shifts=sm,
                               tables=tl),
                self._onesided(shifts, reflect=True, smooth_shifts=sm,
                               tables=tr))

    def bind_grid(self, grid):
        """A copy carrying, for ``grid``'s stretched axes and both
        targets, per-point sub-stencil coefficients and ideal weights of
        the left and the right side (the reflection of the uniform
        stencils holds only on uniform spacing); ``self`` on a regular
        grid."""
        axes = _stretched_axes(grid)
        if not axes:
            return self
        new = WENO(self.order, self.epsilon, bounds=self.bounds)
        new._tables = {}
        for axis in axes:
            for o in (0, 1):
                edges = _cell_edges(grid, axis, o)
                sides = []
                for side in ("left", "right"):
                    subs, gam = weno_stretched_tables(edges, self.order,
                                                      side=side)
                    sides.append((
                        [{n: _table(c, axis, grid) for n, c in t.items()}
                         for t in subs],
                        [_table(g.copy(), axis, grid) for g in gam]))
                new._tables[(axis, o)] = tuple(sides)
        return new

    def __eq__(self, other):
        return (type(self) is type(other) and self.order == other.order
                and self.epsilon == other.epsilon
                and self.bounds == other.bounds)

    def __hash__(self):
        return hash(("WENO", self.order, self.epsilon, self.bounds))

    def __repr__(self):
        if self.bounds is not None:
            return f"WENO(order={self.order}, bounds={self.bounds})"
        return f"WENO(order={self.order})"


class FluxFormAdvection:
    """One scheme per direction: ``x`` reconstructs along x, ``y`` along y
    and ``z`` along z (``y`` and ``z`` default to ``x``)."""

    def __init__(self, x, y=None, z=None):
        self.x = x
        self.y = x if y is None else y
        self.z = x if z is None else z

    @property
    def required_halo(self):
        return max(s.required_halo for s in (self.x, self.y, self.z))

    def bind_grid(self, grid):
        return FluxFormAdvection(*(bind_grid(s, grid)
                                   for s in (self.x, self.y, self.z)))

    def scheme_for(self, axis):
        return (self.x, self.y, self.z)[axis]

    def __eq__(self, other):
        return (type(self) is type(other) and self.x == other.x
                and self.y == other.y and self.z == other.z)

    def __hash__(self):
        return hash((self.x, self.y, self.z))

    def __repr__(self):
        return f"FluxFormAdvection({self.x}, {self.y}, {self.z})"


class BoundPreserving(AdvectionScheme):
    """A wrapper that clips the scheme's face reconstructions to the range
    of the two cells adjacent to the face, so advection adds no new
    extremum there (with an SSP time stepper)."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.order = scheme.order
        self.symmetric = scheme.symmetric

    def bind_grid(self, grid):
        b = getattr(self.scheme, "bind_grid", None)
        return BoundPreserving(b(grid)) if b else self

    @property
    def required_halo(self):
        return self.scheme.required_halo

    @staticmethod
    def _bounds(a, axis, o):
        lo_n = shift(a, o - 1, axis)    # the cell below the target
        hi_n = shift(a, o, axis)        # the cell above
        return torch.minimum(lo_n, hi_n), torch.maximum(lo_n, hi_n)

    def reconstruct(self, a, axis, o):
        lo, hi = self._bounds(a, axis, o)
        return torch.clamp(self.scheme.reconstruct(a, axis, o), lo, hi)

    def biased(self, a, axis, o):
        lo, hi = self._bounds(a, axis, o)
        left, right = self.scheme.biased(a, axis, o)
        return torch.clamp(left, lo, hi), torch.clamp(right, lo, hi)

    def __eq__(self, other):
        return type(self) is type(other) and self.scheme == other.scheme

    def __hash__(self):
        return hash(("BoundPreserving", self.scheme))

    def __repr__(self):
        return f"BoundPreserving({self.scheme!r})"


#: the scheme types the models take
SCHEMES = (Centered, UpwindBiased, WENO, FluxFormAdvection, BoundPreserving)


def bind_grid(scheme, grid):
    """``scheme`` with the per-point tables of ``grid``'s stretched axes
    (the scheme itself where it has no ``bind_grid`` or the grid none)."""
    b = getattr(scheme, "bind_grid", None)
    return scheme if b is None else b(grid)


def required_halo(scheme) -> int:
    if scheme is None:
        return 1
    return scheme.required_halo


def adapt_advection_order(scheme, grid):
    """Shrink the scheme's order on each axis so its stencil fits a small
    grid. Returns the scheme unchanged when every axis fits, else a
    FluxFormAdvection of the orders clamped per axis."""
    if scheme is None or isinstance(scheme, FluxFormAdvection):
        return scheme

    def clamp(s, N):
        if N <= 1 or s.required_halo <= N:
            return s
        if isinstance(s, Centered):
            return Centered(max(2, 2 * N - (2 * N) % 2))
        order = max(1, min(s.order, 2 * N - 1))
        if order % 2 == 0:
            order -= 1
        if isinstance(s, WENO):
            return WENO(max(3, order), bounds=s.bounds) if order >= 3 \
                else UpwindBiased(1)
        return UpwindBiased(order)

    per_axis = [clamp(scheme, grid.N[ax]) for ax in range(3)]
    if all(p == scheme for p in per_axis):
        return scheme
    return FluxFormAdvection(*per_axis)


def _scheme_for(scheme, axis):
    """The scheme that reconstructs along ``axis``: a FluxFormAdvection's
    scheme of that axis, any other scheme itself."""
    if isinstance(scheme, FluxFormAdvection):
        return scheme.scheme_for(axis)
    return scheme


def cell_advection_timescale(grid, u, v, w):
    """min over the interior of (|u|/Δx + |v|/Δy + |w|/Δz)⁻¹ (over every
    panel of stacked cubed-sphere fields)."""
    dx = grid.dx(Face, Center).expand(grid.shape)
    dy = grid.dy(Face, Center).expand(grid.shape)
    dz = grid.dz(Face).expand(grid.shape)
    ii = grid.interior_slices
    jj = (Ellipsis, *ii)
    rate = (u[jj].abs() / dx[ii] + v[jj].abs() / dy[ii]
            + w[jj].abs() / dz[ii])
    return 1.0 / torch.clamp(rate.max(), min=1e-30)


def _face_value(scheme, U, a, axis, o):
    """Reconstructed value of ``a`` at the flux location, upwinded on the
    sign of the (already interpolated) advecting velocity ``U``; where U is
    exactly 0, the mean of the two biased values."""
    if scheme.symmetric:
        return scheme.reconstruct(a, axis, o)
    left, right = scheme.biased(a, axis, o)
    return torch.where(U > 0, left,
                       torch.where(U < 0, right, 0.5 * (left + right)))


def _face_value_smooth(scheme, U, a, axis, o, smooth=None):
    """Like ``_face_value``, but a WENO scheme measures smoothness on the
    ``smooth`` fields instead of on ``a`` itself."""
    if scheme.symmetric:
        return scheme.reconstruct(a, axis, o)
    if smooth is not None and isinstance(scheme, WENO):
        left, right = scheme.biased(a, axis, o, smooth=smooth)
    else:
        left, right = scheme.biased(a, axis, o)
    return torch.where(U > 0, left,
                       torch.where(U < 0, right, 0.5 * (left + right)))


def _near_boundary(a_solid, scheme, axis, o):
    """True where the scheme's full stencil touches a solid value of the
    reconstructed field (offsets [-R, R-1] for face targets, [-(R-1), R]
    for center targets, R the scheme's halo)."""
    R = required_halo(scheme)
    lo, hi = (-R, R - 1) if o == 0 else (-(R - 1), R)
    near = None
    for n in range(lo, hi + 1):
        s = shift(a_solid, n, axis)
        near = s if near is None else (near | s)
    return near


def _face_value_ib(grid, scheme, U, a, axis, o, a_loc):
    """:func:`_face_value` on an immersed grid: where the full stencil
    touches a solid cell, the value of the two-point scheme (Centered(2)
    for a symmetric scheme, UpwindBiased(1) otherwise), whose stencil reads
    only the two adjacent values and so never a solid one at a wet flux
    point. On any other grid, :func:`_face_value`."""
    fv = _face_value(scheme, U, a, axis, o)
    if required_halo(scheme) <= 1:
        return fv
    a_solid = solid_mask_at(grid, a_loc)
    if a_solid is None:
        return fv
    near = _near_boundary(a_solid, scheme, axis, o)
    fb = Centered(2) if scheme.symmetric else UpwindBiased(1)
    return torch.where(near, _face_value(fb, U, a, axis, o), fv)


# The Zhang-Shu limiter's constants: the endpoint weight of the 3-point
# Gauss-Lobatto quadrature through which the cell mean bounds the
# reconstruction, and the guard of its quotients.
_GL_W = 5.0 / 18.0
_GL_EPS = 1e-20


def _bounded_axis_flux(scheme, U, c, axis, A):
    """The limited upwind tracer flux on ``axis`` faces: each cell's two
    face reconstructions are pulled toward the cell mean by θ ∈ [0, 1], so
    that the implied quadrature stays inside ``scheme.bounds``."""
    lo, hi = scheme.bounds
    left, right = scheme.biased(c, axis, 0)
    # cell i's own reconstructions: at its lower face (right-biased, face
    # i) and its upper face (left-biased, face i + 1)
    c_up_L = shift(left, 1, axis)
    c_lo_R = right
    p = (c - _GL_W * c_lo_R - _GL_W * c_up_L) / (1.0 - 2.0 * _GL_W)
    M = torch.maximum(p, torch.maximum(c_up_L, c_lo_R))
    m = torch.minimum(p, torch.minimum(c_up_L, c_lo_R))
    theta = torch.clamp(torch.minimum(
        torch.abs((hi - c) / (M - c + _GL_EPS)),
        torch.abs((lo - c) / (m - c + _GL_EPS))), max=1.0)
    # face i: left from cell i − 1 (its limited upper value), right from
    # cell i (its limited lower value)
    cm = shift(c, -1, axis)
    lim_left = shift(theta, -1, axis) * (left - cm) + cm
    lim_right = theta * (c_lo_R - c) + c
    face = torch.where(U > 0, lim_left,
                       torch.where(U < 0, lim_right,
                                   0.5 * (lim_left + lim_right)))
    return A * U * face


def _bounded_div_Uc(grid, scheme, u, v, w, c):
    fx = _bounded_axis_flux(scheme, u, c, X, grid.Ax(Face, Center, Center))
    fy = _bounded_axis_flux(scheme, v, c, Y, grid.Ay(Center, Face, Center))
    fz = _bounded_axis_flux(scheme, w, c, Z, grid.Az(Center, Center))
    return (dx_c(fx) + dy_c(fy) + dz_c(fz)) / grid.V(Center, Center, Center)


def div_Uc(grid, scheme, u, v, w, c):
    """Tracer advective flux divergence ∇·(𝐯c) at (c,c,c); the limited
    form for a WENO with ``bounds``."""
    if scheme is None:
        return torch.zeros_like(c)
    if getattr(scheme, "bounds", None) is not None:
        return _bounded_div_Uc(grid, scheme, u, v, w, c)
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LC = (Center, Center, Center)
    fx = grid.Ax(Face, Center, Center) * u * _face_value_ib(grid, sx, u, c,
                                                            X, 0, LC)
    fy = grid.Ay(Center, Face, Center) * v * _face_value_ib(grid, sy, v, c,
                                                            Y, 0, LC)
    fz = grid.Az(Center, Center) * w * _face_value_ib(grid, sz, w, c,
                                                      Z, 0, LC)
    return (dx_c(fx) + dy_c(fy) + dz_c(fz)) / grid.V(Center, Center, Center)


def div_vu(grid, scheme, u, v, w):
    """Momentum advection ∇·(𝐯u) at u's location (f,c,c). On an immersed
    grid the cross-term fluxes are zeroed where they touch a solid cell
    (their transverse averages would reach across the boundary)."""
    if scheme is None:
        return torch.zeros_like(u)
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LU = (Face, Center, Center)
    # x-flux at (c,c,c): ℑx_c(Ax u) advects u, landing on centers (o=1)
    Uadv = ix_c(grid.Ax(Face, Center, Center) * u)
    fxx = Uadv * _face_value_ib(grid, sx, Uadv, u, X, 1, LU)
    # y-flux at (f,f,c) and z-flux at (f,c,f), landing on faces (o=0)
    Vadv = ix_f(grid.Ay(Center, Face, Center) * v)
    fxy = Vadv * _face_value_ib(grid, sy, Vadv, u, Y, 0, LU)
    Wadv = ix_f(grid.Az(Center, Center) * w)
    fxz = Wadv * _face_value_ib(grid, sz, Wadv, u, Z, 0, LU)
    fxy = mask_flux(grid, fxy, (Face, Face, Center))
    fxz = mask_flux(grid, fxz, (Face, Center, Face))
    return (dx_f(fxx) + dy_c(fxy) + dz_c(fxz)) / grid.V(Face, Center, Center)


def div_vv(grid, scheme, u, v, w):
    """∇·(𝐯v) at v's location (c,f,c)."""
    if scheme is None:
        return torch.zeros_like(v)
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LV = (Center, Face, Center)
    Uadv = iy_f(grid.Ax(Face, Center, Center) * u)
    fyx = Uadv * _face_value_ib(grid, sx, Uadv, v, X, 0, LV)
    Vadv = iy_c(grid.Ay(Center, Face, Center) * v)
    fyy = Vadv * _face_value_ib(grid, sy, Vadv, v, Y, 1, LV)
    Wadv = iy_f(grid.Az(Center, Center) * w)
    fyz = Wadv * _face_value_ib(grid, sz, Wadv, v, Z, 0, LV)
    fyx = mask_flux(grid, fyx, (Face, Face, Center))
    fyz = mask_flux(grid, fyz, (Center, Face, Face))
    return (dx_c(fyx) + dy_f(fyy) + dz_c(fyz)) / grid.V(Center, Face, Center)


def div_vw(grid, scheme, u, v, w):
    """∇·(𝐯w) at w's location (c,c,f)."""
    if scheme is None:
        return torch.zeros_like(w)
    sx, sy, sz = (_scheme_for(scheme, ax) for ax in range(3))
    LW = (Center, Center, Face)
    Uadv = iz_f(grid.Ax(Face, Center, Center) * u)
    fzx = Uadv * _face_value_ib(grid, sx, Uadv, w, X, 0, LW)
    Vadv = iz_f(grid.Ay(Center, Face, Center) * v)
    fzy = Vadv * _face_value_ib(grid, sy, Vadv, w, Y, 0, LW)
    Wadv = iz_c(grid.Az(Center, Center) * w)
    fzz = Wadv * _face_value_ib(grid, sz, Wadv, w, Z, 1, LW)
    fzx = mask_flux(grid, fzx, (Face, Center, Face))
    fzy = mask_flux(grid, fzy, (Center, Face, Face))
    return (dx_c(fzx) + dy_c(fzy) + dz_f(fzz)) / grid.V(Center, Center, Face)


# ---------------------------------------------------------------------------
# The multidimensional (2-D horizontal) reconstruction filter: a fifth-order
# centered-WENO filter applied transverse to a 1-D reconstruction, the
# published constants of the fifth-order centered WENO interpolant.
# ---------------------------------------------------------------------------

_S15 = math.sqrt(15.0)
_MD_G1 = ((1008 + 71 * _S15) / 5240, 408 / 655, (1008 - 71 * _S15) / 5240)
_MD_G3 = ((1008 - 71 * _S15) / 5240, 408 / 655, (1008 + 71 * _S15) / 5240)
_MD_SP, _MD_SM = 214 / 80, 67 / 40
_MD_G2P = (9 / 80 / _MD_SP, 49 / 20 / _MD_SP, 9 / 80 / _MD_SP)
_MD_G2M = (9 / 40 / _MD_SM, 49 / 40 / _MD_SM, 9 / 40 / _MD_SM)
_MD_A1 = (((2 - 3 * _S15) / 60, (-4 + 12 * _S15) / 60, (62 - 9 * _S15) / 60),
          ((2 + 3 * _S15) / 60, 56 / 60, (2 - 3 * _S15) / 60),
          ((62 + 9 * _S15) / 60, (-4 - 12 * _S15) / 60, (2 + 3 * _S15) / 60))
_MD_A2 = ((-1 / 24, 2 / 24, 23 / 24),
          (-1 / 24, 26 / 24, -1 / 24),
          (23 / 24, 2 / 24, -1 / 24))
_MD_A3 = (((2 + 3 * _S15) / 60, (-4 - 12 * _S15) / 60, (62 + 9 * _S15) / 60),
          ((2 - 3 * _S15) / 60, 56 / 60, (2 + 3 * _S15) / 60),
          ((62 - 9 * _S15) / 60, (-4 + 12 * _S15) / 60, (2 - 3 * _S15) / 60))
_MD_EPS = 1e-6


def multi_dimensional_filter(q, axis):
    """Fifth-order centered-WENO filter of ``q`` along ``axis`` (the
    transverse leg of the reference's multidimensional reconstruction).
    Preserves constants exactly; in smooth regions reproduces ``q`` to
    fifth order."""
    t = {n: shift(q, n, axis) for n in (-2, -1, 0, 1, 2)}
    S = ((t[-2], t[-1], t[0]), (t[-1], t[0], t[1]), (t[0], t[1], t[2]))

    def comb(A):
        return tuple(A[r][0] * S[r][0] + A[r][1] * S[r][1]
                     + A[r][2] * S[r][2] for r in range(3))

    q1h = comb(_MD_A1)
    q2h = comb(_MD_A2)
    q3h = comb(_MD_A3)

    c1, c2 = 13.0 / 12.0, 0.25
    b0 = (c1 * (S[0][0] - 2 * S[0][1] + S[0][2]) ** 2
          + c2 * (S[0][0] - 4 * S[0][1] + 3 * S[0][2]) ** 2)
    b1 = (c1 * (S[1][0] - 2 * S[1][1] + S[1][2]) ** 2
          + c2 * (S[1][0] - S[1][2]) ** 2)
    b2 = (c1 * (S[2][0] - 2 * S[2][1] + S[2][2]) ** 2
          + c2 * (3 * S[2][0] - 4 * S[2][1] + S[2][2]) ** 2)

    def weights(g):
        a0 = g[0] / (b0 + _MD_EPS) ** 2
        a1 = g[1] / (b1 + _MD_EPS) ** 2
        a2 = g[2] / (b2 + _MD_EPS) ** 2
        s = a0 + a1 + a2
        return a0 / s, a1 / s, a2 / s

    def total(g, qh):
        w0, w1, w2 = weights(g)
        return w0 * qh[0] + w1 * qh[1] + w2 * qh[2]

    q1 = total(_MD_G1, q1h)
    q3 = total(_MD_G3, q3h)
    q2 = _MD_SP * total(_MD_G2P, q2h) - _MD_SM * total(_MD_G2M, q2h)
    return q1 / 6 + 2 * q2 / 3 + q3 / 6


__all__ = ["AdvectionScheme", "BoundPreserving", "Centered",
           "FluxFormAdvection", "UpwindBiased", "WENO",
           "adapt_advection_order", "bind_grid", "cell_advection_timescale",
           "div_Uc", "div_vu", "div_vv", "div_vw", "multi_dimensional_filter",
           "required_halo"]
