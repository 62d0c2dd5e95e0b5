"""Shallow-water and hydrostatic dynamics on the six-panel conformal cubed
sphere.

Counterpart of ``oceananigans_tpu/models/cubed_sphere.py``. The JAX package
stacks the panels on a leading axis and ``jax.vmap``s every per-panel
function over it; here the same stacked ``(6, nx, ny, nz)`` tensors go
through the operators of ``ops/operators.py`` whole, since they count their
axes from the end and the panel grid's ``(nx, ny, 1)`` metrics broadcast
against the stack. So a step launches one kernel per operation for all six
panels, with no ``vmap`` and no loop over panels. The inter-panel coupling
is the gather maps of ``grids/cubed_sphere_grid.py``.

The momentum equations use the vector-invariant (circulation) form, which
has no metric terms on curvilinear panels. At the 3-valent cube corners the
vorticity is the exact 3-segment circulation, the vertex depth the mean of
the three real cells, the potential-vorticity flux first-order upwind in a
band of ``corner_upwind_width`` cells, and the Bernoulli head self-upwinded
in a band of :data:`CS_KE_BAND` cells: C32 Williamson 2 is stable without a
filter only with the last of these.

The hydrostatic model's ``bathymetry`` is a ``GridFittedBottom`` (or its
bottom height given bare, a callable or an array), a ``PartialCellBottom``
(the partial cells' height fractions scale every metric of the dynamics
through the hydrostatic model's scaled-height view ``_ScaledZGrid``) or a
``GridFittedBoundary`` (a 3-D solid mask). Its free surface is explicit,
split-explicit or implicit (one CG across the stacked panels,
:func:`cs_implicit_free_surface`), and under quasi-AB2 its vertical
coordinate may be ``ZStar``: the z-star σ composes with the partial cells'
fractions in the same scaled panel view. ``cubed_sphere_partition``
lays the stacked panels over the ranks of a distributed group; the
distributed models are in ``parallel/cubed_sphere_shard.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from oceananigans_torch import closures as closures_mod
from oceananigans_torch.advection import (
    Centered, UpwindBiased, _face_value, _scheme_for,
    cell_advection_timescale,
)
from oceananigans_torch.boundary_conditions import FLUX
from oceananigans_torch.buoyancy import BuoyancyTracer, g_Earth
from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.immersed import (
    GridFittedBottom, GridFittedBoundary, PartialCellBottom,
)
from oceananigans_torch.grids.cubed_sphere_grid import (
    ConformalCubedSphereGrid, _panel_xyz, _tangents,
    cubed_sphere_corner_vorticity, cubed_sphere_halo_exchange,
    cubed_sphere_sync_edge_fluxes, cubed_sphere_velocity_exchange,
    panel_geographic_coords,
)
from oceananigans_torch.models.hydrostatic import (
    ExplicitFreeSurface, ImplicitFreeSurface, SplitExplicitFreeSurface,
    VectorInvariant, ZCoordinate, ZStar, _ScaledZGrid,
)
from oceananigans_torch.ops.operators import (
    X, Y, Z, dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f,
    iz_c, vorticity_z_ff,
)
from oceananigans_torch.solvers.conjugate_gradient import conjugate_gradient
from oceananigans_torch.timesteppers import (
    RK3_STAGES, Clock, ab2_coefficients, tick,
)

__all__ = ["CS_KE_BAND", "CubedSphereHydrostaticModel",
           "CubedSphereHydrostaticState", "CubedSphereShallowWaterModel",
           "CubedSphereState", "cubed_sphere_partition",
           "panel_vector_components"]

OMEGA_EARTH = 7.292115e-5

#: width in cells of the corner band of the self-upwinded Bernoulli head
#: (capped at ``corner_upwind_width``). The JAX package reads an override
#: from the environment variable ``CS_KE_BAND``; the port keeps its default.
CS_KE_BAND = 2

_replace = dataclasses.replace


# ---------------------------------------------------------------------------
# Barotropic (free-surface) machinery. Every field is a stacked
# (6, nx, ny, ·) tensor; ``g`` is the panel grid.
# ---------------------------------------------------------------------------

def _z_interior(g):
    k = torch.arange(g.shape[2], device=g.device)
    return (k >= g.H[2]) & (k < g.H[2] + g.N[2])


def cs_column_depth(g):
    """Total fluid column depth Σ dz over the interior z-cells, as a
    (1, nx, ny, 1) tensor that broadcasts against barotropic fields."""
    dz = g.dz(Center).expand(g.shape)
    return torch.sum(torch.where(_z_interior(g), dz, 0.0), dim=Z,
                     keepdim=True)[None]


def cs_barotropic_mode(g, u, v, sigma_u=None, sigma_v=None):
    """(U, V) = ∫ (u, v) dz over the interior levels, per column; with
    ``sigma_u``/``sigma_v`` (the z-star σ and the partial cells' height
    fractions at the faces) over the scaled thicknesses σ dz."""
    dzm = torch.where(_z_interior(g), g.dz(Center), 0.0)
    dzu = dzm if sigma_u is None else sigma_u * dzm
    dzv = dzm if sigma_v is None else sigma_v * dzm
    return (torch.sum(u * dzu, dim=Z, keepdim=True),
            torch.sum(v * dzv, dim=Z, keepdim=True))


def cs_transport_divergence(g, U, V, sync_fluxes):
    """∇·(U, V) per unit area with edge-synced panel fluxes: the flux
    leaving a panel through a shared edge face is exactly the flux entering
    its neighbour, so Σ Az η is conserved to rounding."""
    Fx = g.dy(Center, Face)[..., :1] * U
    Fy = g.dx(Center, Face)[..., :1] * V
    Fx, Fy = sync_fluxes(Fx, Fy)
    return (dx_c(Fx) + dy_c(Fy)) / g.Az(Center, Center)[..., :1]


def cs_eta_gradients(g, eta):
    """(∂x η at u-faces, ∂y η at v-faces); η's halos must be exchanged."""
    return (dx_f(eta) / g.dx(Face, Center)[..., :1],
            dy_f(eta) / g.dy(Center, Face)[..., :1])


def cs_split_explicit_free_surface(g, U0, V0, eta0, GU, GV, dt, fs,
                                   exchange_eta, sync_fluxes, mask_u,
                                   mask_v, Hu=None, Hv=None):
    """Barotropic substepping: a Python loop over the averaging weights,
    each substep a forward η step (edge-synced transport divergence), the η
    panel exchange and a backward transport step. ``U0``/``V0`` are the
    persistent barotropic transports; ``dt`` is a 0-d CPU tensor in the
    fields' dtype; ``mask_u``/``mask_v`` are tensors; ``Hu``/``Hv`` the
    wet-column depths at the faces (the flat-bottom column by default).
    Returns the filtered (η̄, Ū, V̄)."""
    if Hu is None:
        Hu = Hv = cs_column_depth(g)
    dtau = float(dt * fs.fractional_step)
    weights = torch.tensor(fs.weights, dtype=eta0.dtype).tolist()
    eta, U, V = eta0, U0, V0
    eta_f = torch.zeros_like(eta0)
    U_f = torch.zeros_like(U0)
    V_f = torch.zeros_like(V0)
    for wgt in weights:
        eta = eta - dtau * cs_transport_divergence(g, U, V, sync_fluxes)
        eta = exchange_eta(eta)
        gx, gy = cs_eta_gradients(g, eta)
        U = (U + dtau * (-fs.g * Hu * gx + GU)) * mask_u
        V = (V + dtau * (-fs.g * Hv * gy + GV)) * mask_v
        eta_f = eta_f + wgt * eta
        U_f = U_f + wgt * U
        V_f = V_f + wgt * V
    return eta_f, U_f, V_f


def cs_barotropic_correct(g, u, v, U_target, V_target, mask_u, mask_v,
                          Hu=None, Hv=None, sigma_u=None, sigma_v=None,
                          depth_u=None, depth_v=None):
    """Replace the barotropic mode of (u, v) with the filtered substepped
    transports; land faces (depth 0) are left untouched. ``sigma_u`` and
    ``sigma_v`` scale the mode's thicknesses (z-star σ and partial cells;
    ``Hu`` and ``Hv`` already hold the partial depths), ``depth_u`` and
    ``depth_v`` the column depths (the z-star σ)."""
    U, V = cs_barotropic_mode(g, u, v, sigma_u, sigma_v)
    if Hu is None:
        Hu = Hv = cs_column_depth(g)
    if depth_u is not None:
        Hu, Hv = Hu * depth_u, Hv * depth_v
    Hu_safe = torch.where(Hu > 0, Hu, 1.0)
    Hv_safe = torch.where(Hv > 0, Hv, 1.0)
    u = u + torch.where(Hu > 0, (U_target - U) / Hu_safe, 0.0) * mask_u
    v = v + torch.where(Hv > 0, (V_target - V) / Hv_safe, 0.0) * mask_v
    return u, v


def cs_implicit_free_surface(g, u_star, v_star, eta0, dt, fs, exchange_eta,
                             sync_fluxes, mask_c, Hu=None, Hv=None,
                             info=None):
    """The backward-Euler barotropic step across all panels: one CG on
    [∇·(gH∇) − 1/Δt²] η = (∇·U* − ηⁿ/Δt)/Δt with the panel exchange inside
    the operator and the Az-weighted inner product, under which the
    flux-form operator is symmetric on the curvilinear panels. ``dt`` is a
    float; ``info`` (a dict) receives the iterations and host syncs.
    Returns η exchanged."""
    Az = g.Az(Center, Center)[..., :1] * mask_c
    if Hu is None:
        Hu = Hv = cs_column_depth(g)
    U, V = cs_barotropic_mode(g, u_star, v_star)
    div_U = cs_transport_divergence(g, U, V, sync_fluxes)
    rhs = (div_U - eta0 / dt) / dt * mask_c

    def L(eta):
        gx, gy = cs_eta_gradients(g, exchange_eta(eta))
        div = cs_transport_divergence(g, fs.g * Hu * gx, fs.g * Hv * gy,
                                      sync_fluxes)
        return (div - eta / (dt * dt)) * mask_c

    # on a distributed cube's blocks the sum runs over every rank
    reduce_sum = getattr(g, "reduce_sum", torch.sum)

    def dot(x, y):
        return reduce_sum(torch.sum(Az * x * y))

    cg = {}
    eta, it, _ = conjugate_gradient(L, rhs, torch.zeros_like(eta0),
                                    maxiter=fs.maxiter, reltol=fs.reltol,
                                    dot=dot, info=cg)
    if info is not None:
        info.update(iterations=it, host_syncs=cg["host_syncs"])
    return exchange_eta(eta * mask_c)


class _PanelSolidView:
    """The panel grid with a boolean ``solid_c``, so that the closures'
    diffusive fluxes vanish through and inside the bathymetry
    (``closures._mask_flux``)."""

    def __init__(self, base, solid_c):
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "solid_c", solid_c)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "base"), name)


# ---------------------------------------------------------------------------
# Corner machinery
# ---------------------------------------------------------------------------

def _vertex_orientation_masks(g, N):
    """(nx, ny, 4) one-hot masks of the 4 cube-corner vertex slots of a
    panel, by orientation (SW, SE, NW, NE); shared by all panels."""
    H = g.H[0]
    m = np.zeros((g.shape[0], g.shape[1], 4))
    m[H, H, 0] = 1.0
    m[H + N, H, 1] = 1.0
    m[H, H + N, 2] = 1.0
    m[H + N, H + N, 3] = 1.0
    return m


def _corner_vertex_scalar_fix(q_ff, h, vmasks):
    """Replace the 4 cube-corner vertex values of a vertex interpolant
    (``ix_f(iy_f(h))``) with the mean of the 3 real adjacent cells: the
    4-point mean reads the phantom diagonal halo cell, which a 3-valent
    corner does not have."""
    A = h
    B = torch.roll(h, 1, X)
    C = torch.roll(h, 1, Y)
    D = torch.roll(B, 1, Y)
    third = torch.tensor(1.0 / 3.0, dtype=h.dtype)
    means = (A + B + C, A + B + D, A + C + D, B + C + D)
    for k in range(4):
        m = vmasks[..., k:k + 1]
        q_ff = q_ff + m * (means[k] * third - q_ff)
    return q_ff


def _corner_bernoulli_upwind_correction(g, u, v, K, cmf):
    """The corner band's self-upwinded Bernoulli head: the correction that
    replaces the centred ∂K with the form whose u²-part is biased to the
    upwind cell by sign(u) (the v²-part symmetric). At the 3-valent corners
    the centred ∂x(K) closes a positive u² feedback (NaN by day 4 of C32
    Williamson 2); the upwinded form makes it dissipative. The two forms
    agree to O(Δx)."""
    u2h = 0.5 * u * u
    v2h = 0.5 * v * v
    t1 = dx_c(u2h)
    t1f = torch.where(u >= 0, torch.roll(t1, 1, X), t1)
    t2f = iy_c(dx_f(v2h))
    dKx_up = (t1f + t2f) / g.dx(Face, Center)
    dKx_c = dx_f(K) / g.dx(Face, Center)
    t1v = dy_c(v2h)
    t1vf = torch.where(v >= 0, torch.roll(t1v, 1, Y), t1v)
    t2vf = ix_c(dy_f(u2h))
    dKy_up = (t1vf + t2vf) / g.dy(Face, Center)
    dKy_c = dy_f(K) / g.dy(Face, Center)
    return cmf * (dKx_c - dKx_up), cmf * (dKy_c - dKy_up)


def _corner_filter_setup(model, corner_filter):
    """The corner-band filter's weights (numpy): a local Laplacian smoother
    of coefficient ``corner_filter`` (0.005 is a good value when enabled)
    confined to the ``corner_upwind_width`` band at the 24 panel corners,
    plain for velocities and conservative flux-form, within each panel, for
    cell-centred fields (Σ Az q telescopes exactly)."""
    model.corner_filter = None if not corner_filter else float(corner_filter)
    if model.corner_filter is None:
        return
    g = model.grid.panel_grid
    N, H = model.grid.N_panel, g.H[0]
    cm = model._corner_mask[..., 0]                  # (nx, ny)
    fx = np.maximum(cm, np.roll(cm, 1, axis=0))     # x-face coverage
    fy = np.maximum(cm, np.roll(cm, 1, axis=1))     # y-face coverage
    # within-panel faces only: no flux across the shared edge faces
    idx = np.arange(fx.shape[0])
    inner = ((idx > H) & (idx < H + N)).astype(float)
    fx = fx * inner[:, None]
    fy = fy * inner[None, :]
    eps = model.corner_filter
    Az = g.Az(Center, Center).cpu().numpy()[:, :, 0]
    Az_fx = 0.5 * (Az + np.roll(Az, 1, axis=0))
    Az_fy = 0.5 * (Az + np.roll(Az, 1, axis=1))
    model._cf_x = (eps * fx * Az_fx)[..., None]
    model._cf_y = (eps * fy * Az_fy)[..., None]
    model._cf_inv_az = (1.0 / Az)[..., None]
    # over bathymetry, no filter flux into land: the wet masks restricted
    # to the interior levels (the z-halo slots above the surface read wet)
    wu = getattr(model, "_wet_u", None)
    if wu is not None:
        kz = np.arange(g.shape[2]).reshape(1, 1, 1, -1)
        kin_z = ((kz >= g.H[2]) & (kz < g.H[2] + g.N[2])).astype(float)
        model._cf_x = model._cf_x[None] * model._wet_u * kin_z
        model._cf_y = model._cf_y[None] * model._wet_v * kin_z


def _corner_smooth_center(model, q):
    """Az-content-conserving corner-band smoothing of a stacked cell field:
    Δq = ∇·(w ∇q)/Az with face weights confined to the corner band and to
    within-panel faces."""
    cfx = model._dev("_cf_x", q.dtype)
    cfy = model._dev("_cf_y", q.dtype)
    inv_az = model._dev("_cf_inv_az", q.dtype)
    if cfx.ndim == 4 and q.shape[-1] != cfx.shape[-1]:
        # bathymetry: a single-level field (η) takes the any-wet column
        # weight
        cfx = torch.amax(cfx, dim=Z, keepdim=True)
        cfy = torch.amax(cfy, dim=Z, keepdim=True)
    return q + (dx_c(cfx * dx_f(q)) + dy_c(cfy * dy_f(q))) * inv_az


def _corner_smooth_velocity(model, q, mask):
    """Plain corner-band Laplacian smoothing of a velocity component;
    ``mask`` (a tensor) confines it to the component's interior/wet
    faces."""
    eps = model.corner_filter
    cm = model._dev("_corner_mask", q.dtype)
    lap = (torch.roll(q, 1, X) + torch.roll(q, -1, X)
           + torch.roll(q, 1, Y) + torch.roll(q, -1, Y) - 4.0 * q)
    return q + ((q + eps * cm * lap) - q) * mask


def panel_vector_components(grid: ConformalCubedSphereGrid, vec_fn):
    """Project a cartesian vector field onto every panel's staggered (u, v).

    ``vec_fn(P)`` maps (n, 3) unit-sphere cartesian points (numpy) to (n, 3)
    vectors. Returns stacked (6, nx, ny, 1) ``u`` (x-face) and ``v``
    (y-face) tensors on the grid's device, with the interior and shared
    edge-face slots filled."""
    g = grid.panel_grid
    N, H = grid.N_panel, g.H[0]
    nx, ny, _ = g.shape
    d = 2.0 / N
    u = np.zeros((6, nx, ny, 1))
    v = np.zeros((6, nx, ny, 1))
    for comp in ("u", "v"):
        if comp == "u":
            ii = np.arange(H, H + N + 1)
            jj = np.arange(H, H + N)
            xs = -1.0 + (ii - H) * d
            ys = -1.0 + (jj - H + 0.5) * d
        else:
            ii = np.arange(H, H + N)
            jj = np.arange(H, H + N + 1)
            xs = -1.0 + (ii - H + 0.5) * d
            ys = -1.0 + (jj - H) * d
        Xs, Ys = np.meshgrid(xs, ys, indexing="ij")
        ax = 0 if comp == "u" else 1
        for p in range(6):
            P = _panel_xyz(p, Xs.ravel(), Ys.ravel())
            T = _tangents(p, Xs.ravel(), Ys.ravel(), ax)
            vals = (vec_fn(P) * T).sum(-1).reshape(Xs.shape)
            tgt = u if comp == "u" else v
            tgt[p, ii[0]:ii[-1] + 1, jj[0]:jj[-1] + 1, 0] = vals
    return (torch.as_tensor(u, dtype=grid.dtype, device=grid.device),
            torch.as_tensor(v, dtype=grid.dtype, device=grid.device))


def _coriolis_ff(grid, rotation_rate):
    """2Ω sin φ at each panel's (f, f) points, halos included: (6, nx, ny,
    1) numpy."""
    g = grid.panel_grid
    N, H = grid.N_panel, g.H[0]
    nx, ny, _ = g.shape
    d = 2.0 / N
    iF = -1.0 + (np.arange(nx) - H) * d
    jF = -1.0 + (np.arange(ny) - H) * d
    Xs, Ys = np.meshgrid(iF, jF, indexing="ij")
    f = []
    for p in range(6):
        P = _panel_xyz(p, Xs.ravel(), Ys.ravel()).reshape(nx, ny, 3)
        f.append(2.0 * rotation_rate * np.clip(P[..., 2], -1.0, 1.0))
    return np.stack(f)[..., None]


def _panel_masks(model):
    """The interior masks (faces include the shared edge) and the corner
    bands of the potential-vorticity flux and of the Bernoulli head, as
    numpy attributes of ``model``."""
    g = model.grid.panel_grid
    N, H = model.grid.N_panel, g.H[0]
    nx, ny, _ = g.shape
    mc = np.zeros((nx, ny, 1))
    mc[H:H + N, H:H + N] = 1.0
    mu = np.zeros((nx, ny, 1))
    mu[H:H + N + 1, H:H + N] = 1.0
    mv = np.zeros((nx, ny, 1))
    mv[H:H + N, H:H + N + 1] = 1.0
    model._mask_c, model._mask_u, model._mask_v = mc, mu, mv
    idx = np.arange(nx)
    near = ((idx < H + model.corner_upwind_width)
            | (idx >= H + N - model.corner_upwind_width))
    model._corner_mask = (near[:, None]
                          & near[None, :]).astype(float)[..., None]
    wke = min(CS_KE_BAND, model.corner_upwind_width)
    near_ke = (idx < H + wke) | (idx >= H + N - wke)
    model._corner_mask_ke = (near_ke[:, None]
                             & near_ke[None, :]).astype(float)[..., None]


class _OnDevice:
    """Numpy attributes of a model as tensors on its grid's device, made
    once per dtype."""

    def _dev(self, name, dtype):
        key = (name, dtype)
        t = self._device_arrays.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name)), dtype=dtype,
                                device=self.grid.device)
            self._device_arrays[key] = t
        return t


def _as_tensor(a, grid, dtype=None):
    return torch.as_tensor(a, dtype=dtype or grid.dtype, device=grid.device)


# ---------------------------------------------------------------------------
# Shallow water
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CubedSphereState:
    """Stacked-panel shallow-water state: (6, nx, ny, 1) tensors."""
    u: torch.Tensor
    v: torch.Tensor
    h: torch.Tensor
    tracers: Dict[str, torch.Tensor]
    Gu: torch.Tensor
    Gv: torch.Tensor
    Gh: torch.Tensor
    Gtracers: Dict[str, torch.Tensor]
    clock: Clock

    def fields(self):
        return {"u": self.u, "v": self.v, "h": self.h, **self.tracers}


class CubedSphereShallowWaterModel(_OnDevice):
    """Vector-invariant shallow water on the conformal cubed sphere,
    stepped by RK3 with an inter-panel exchange each stage.

    ``vorticity_scheme``: "hybrid_upwind" (default: first-order upwind
    potential-vorticity flux within ``corner_upwind_width`` cells of each
    cube corner, UpwindBiased(3) elsewhere), "upwind" (first order
    everywhere) or "energy_conserving" (the Sadourny centred form).
    ``prescribed_velocities=True`` freezes (u, v, h) and steps only the
    tracers. ``bathymetry``: the surface height hs(λ, φ) (a callable of
    degrees, or a stacked array) under the fluid: the momentum gradient acts
    on g (h + hs)."""

    def __init__(self, grid: ConformalCubedSphereGrid,
                 gravitational_acceleration=g_Earth,
                 rotation_rate=OMEGA_EARTH, tracer_advection=None,
                 tracers=(), prescribed_velocities=False,
                 vorticity_scheme="hybrid_upwind", corner_upwind_width=4,
                 corner_filter=None, bathymetry=None):
        if vorticity_scheme not in ("hybrid_upwind", "upwind",
                                    "energy_conserving"):
            raise ValueError(f"unknown vorticity_scheme {vorticity_scheme!r}")
        self.grid = grid
        self._device_arrays = {}
        self.g = float(gravitational_acceleration)
        g = grid.panel_grid
        if bathymetry is None:
            self.hs = None
        else:
            hs = (bathymetry if hasattr(bathymetry, "ndim")
                  else grid.set_tracer(
                      lambda lam, phi, z: bathymetry(lam, phi) + 0 * z))
            hs = cubed_sphere_halo_exchange(_as_tensor(hs, grid), grid)
            # a single level, like the state
            if hs.shape[-1] != 1:
                hs = hs[..., g.H[2]:g.H[2] + 1]
            self.hs = hs
        self.rotation_rate = float(rotation_rate or 0.0)
        self.tracer_advection = tracer_advection or Centered(2)
        self.tracer_names = tuple(tracers)
        self.prescribed_velocities = bool(prescribed_velocities)
        self.vorticity_scheme = vorticity_scheme
        self.corner_upwind_width = int(corner_upwind_width)
        self.f_ff = _coriolis_ff(grid, self.rotation_rate)
        _panel_masks(self)
        self._vfix = _vertex_orientation_masks(g, grid.N_panel)
        _corner_filter_setup(self, corner_filter)

    # ------------------------------------------------------------------
    def initial_state(self, u=None, v=None, h=1.0, time=0.0, **tracers):
        """``u``/``v``: stacked tensors or arrays (from
        ``panel_vector_components``) or None; ``h``: a number or a stacked
        array; tracers by name (stacked arrays, numbers or callables
        ``f(lam, phi, z)`` of degrees)."""
        grid = self.grid
        g = grid.panel_grid
        nx, ny, _ = g.shape
        dtype = grid.dtype

        def one_level(a):
            """The layer is 2-D: a z-extended field keeps its single
            interior level, so no z-halo slot (h = 0 there) feeds 1/h."""
            a = _as_tensor(a, grid)
            if a.shape[-1] != 1:
                a = a[..., g.H[2]:g.H[2] + 1]
            return a

        zero = torch.zeros((6, nx, ny, 1), dtype=dtype, device=grid.device)
        mc = self._dev("_mask_c", dtype)
        u = zero if u is None else one_level(u)
        v = zero if v is None else one_level(v)
        h = torch.full_like(zero, h) * mc if np.ndim(h) == 0 \
            else one_level(h)
        tr = {}
        for name in self.tracer_names:
            val = tracers.get(name, 0.0)
            if callable(val):
                tr[name] = one_level(grid.set_tracer(val))
            elif np.ndim(val) == 0:
                tr[name] = torch.full_like(zero, val) * mc
            else:
                tr[name] = one_level(val)
        state = CubedSphereState(
            u=u, v=v, h=h, tracers=tr, Gu=zero, Gv=zero, Gh=zero,
            Gtracers={n: zero for n in self.tracer_names},
            clock=Clock.start(time, dtype))
        return self.fill_state_halos(state)

    def fill_state_halos(self, state):
        grid = self.grid
        u, v = cubed_sphere_velocity_exchange(state.u, state.v, grid)
        h = cubed_sphere_halo_exchange(state.h, grid)
        tracers = {n: cubed_sphere_halo_exchange(c, grid)
                   for n, c in state.tracers.items()}
        return _replace(state, u=u, v=v, h=h, tracers=tracers)

    # ------------------------------------------------------------------
    def _momentum_tendencies(self, u, v, h, f_ff, zeta):
        """(Gu, Gv) of all panels; ``zeta`` carries the corner
        circulation."""
        g = self.grid.panel_grid
        U = u * ix_f(h)
        V = v * iy_f(h)
        # potential vorticity q = (ζ + f)/h at the vorticity points
        eps = torch.tensor(1e-30, dtype=h.dtype)
        h_ff = _corner_vertex_scalar_fix(ix_f(iy_f(h)), h,
                                         self._dev("_vfix", h.dtype))
        q = (zeta + f_ff) / (h_ff + eps)
        K = 0.5 * (ix_c(u * u) + iy_c(v * v))
        phi = K + self.g * (h if self.hs is None
                            else h + self.hs.to(h.dtype))
        if self.vorticity_scheme == "energy_conserving":
            Gu = iy_c(q * ix_f(V)) - dx_f(phi) / g.dx(Face, Center)
            Gv = -ix_c(q * iy_f(U)) - dy_f(phi) / g.dy(Face, Center)
            return Gu, Gv
        # length-weighted transverse transports
        Vu = ix_f(iy_c(g.dx(Center, Face) * V)) / g.dx(Face, Center)
        Uv = iy_f(ix_c(g.dy(Center, Face) * U)) / g.dy(Face, Center)
        q1y = torch.where(Vu >= 0, q, torch.roll(q, -1, Y))
        q1x = torch.where(Uv >= 0, q, torch.roll(q, -1, X))
        if self.vorticity_scheme == "hybrid_upwind":
            cm = self._dev("_corner_mask", q.dtype)
            ub3 = UpwindBiased(3)
            q_up = cm * q1y + (1 - cm) * _face_value(ub3, Vu, q, Y, 1)
            q_upx = cm * q1x + (1 - cm) * _face_value(ub3, Uv, q, X, 1)
        else:
            q_up, q_upx = q1y, q1x
        Gu = q_up * Vu - dx_f(phi) / g.dx(Face, Center)
        Gv = -q_upx * Uv - dy_f(phi) / g.dy(Face, Center)
        dGu, dGv = _corner_bernoulli_upwind_correction(
            g, u, v, K, self._dev("_corner_mask_ke", q.dtype))
        return Gu + dGu, Gv + dGv

    def _fluxes(self, u, v, h, tracers):
        """Mass and tracer advective fluxes of all panels, before the edge
        sync."""
        g = self.grid.panel_grid
        U = u * ix_f(h)
        V = v * iy_f(h)
        Fx = g.dy(Center, Face) * U
        Fy = g.dx(Center, Face) * V
        # the metrics at the single interior level
        kz = slice(g.H[2], g.H[2] + 1)
        Ft = {}
        for name, c in tracers.items():
            sxs = _scheme_for(self.tracer_advection, 0)
            sys_ = _scheme_for(self.tracer_advection, 1)
            fcx = (g.Ax(Face, Center, Center)[..., kz] * u
                   * _face_value(sxs, u, c, X, 0))
            fcy = (g.Ay(Center, Face, Center)[..., kz] * v
                   * _face_value(sys_, v, c, Y, 0))
            Ft[name] = (fcx, fcy)
        return Fx, Fy, Ft

    def compute_tendencies(self, state):
        dtype = state.u.dtype
        g = self.grid.panel_grid
        zeta = vorticity_z_ff(g, state.u, state.v)
        # the exact 3-segment circulation at the 8 cube-corner vertices
        zeta = cubed_sphere_corner_vorticity(zeta, state.u, state.v,
                                             self.grid)
        Gu, Gv = self._momentum_tendencies(
            state.u, state.v, state.h, self._dev("f_ff", dtype), zeta)
        # fluxes through shared edge faces made single-valued before the
        # divergence: the flux out of one panel is the flux into the next
        Fx, Fy, Ft = self._fluxes(state.u, state.v, state.h, state.tracers)
        Fx, Fy = cubed_sphere_sync_edge_fluxes(Fx, Fy, self.grid)
        Ft = {n: cubed_sphere_sync_edge_fluxes(fx, fy, self.grid)
              for n, (fx, fy) in Ft.items()}
        kz = slice(g.H[2], g.H[2] + 1)
        Gh = -(dx_c(Fx) + dy_c(Fy)) / g.Az(Center, Center)
        Gt = {n: -(dx_c(fx) + dy_c(fy)) / g.V(Center, Center, Center)[..., kz]
              for n, (fx, fy) in Ft.items()}
        mc = self._dev("_mask_c", dtype)
        if self.prescribed_velocities:
            Gu = torch.zeros_like(Gu)
            Gv = torch.zeros_like(Gv)
            Gh = torch.zeros_like(Gh)
        else:
            Gu = Gu * self._dev("_mask_u", dtype)
            Gv = Gv * self._dev("_mask_v", dtype)
            Gh = Gh * mc
        Gt = {n: G * mc for n, G in Gt.items()}
        return Gu, Gv, Gh, Gt

    # ------------------------------------------------------------------
    def step(self, state, dt):
        """RK3 with an inter-panel exchange before each stage."""
        dt = torch.tensor(dt, dtype=state.h.dtype)
        dtf = dt.item()
        G_prev = (state.Gu, state.Gv, state.Gh, state.Gtracers)
        for gamma, zeta in RK3_STAGES:
            state = self.fill_state_halos(state)
            Gu, Gv, Gh, Gt = self.compute_tendencies(state)
            state = _replace(
                state,
                u=state.u + dtf * (gamma * Gu + zeta * G_prev[0]),
                v=state.v + dtf * (gamma * Gv + zeta * G_prev[1]),
                h=state.h + dtf * (gamma * Gh + zeta * G_prev[2]),
                tracers={n: state.tracers[n]
                         + dtf * (gamma * Gt[n] + zeta * G_prev[3][n])
                         for n in self.tracer_names})
            G_prev = (Gu, Gv, Gh, Gt)
        state = _replace(state, Gu=G_prev[0], Gv=G_prev[1], Gh=G_prev[2],
                         Gtracers=G_prev[3], clock=tick(state.clock, dt))
        if self.corner_filter is not None \
                and not self.prescribed_velocities:
            # filter on filled halos (the taps reach one ring into them)
            state = self.fill_state_halos(state)
            dtype = state.u.dtype
            state = _replace(
                state,
                u=_corner_smooth_velocity(self, state.u,
                                          self._dev("_mask_u", dtype)),
                v=_corner_smooth_velocity(self, state.v,
                                          self._dev("_mask_v", dtype)),
                h=_corner_smooth_center(self, state.h))
        return self.fill_state_halos(state)

    # ------------------------------------------------------------------
    def total_mass(self, state):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :]
        return torch.sum(state.h[:, sx, sy, :] * Az)

    def total_tracer(self, state, name):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :]
        return torch.sum(state.tracers[name][:, sx, sy, :]
                         * state.h[:, sx, sy, :] * Az)

    def __repr__(self):
        return (f"CubedSphereShallowWaterModel(N={self.grid.N_panel}, "
                f"tracers={list(self.tracer_names)}, "
                f"prescribed={self.prescribed_velocities})")


# ---------------------------------------------------------------------------
# Hydrostatic primitive equations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CubedSphereHydrostaticState:
    """Stacked-panel hydrostatic state: (6, nx, ny, nz) u, v and tracers;
    (6, nx, ny, 1) η and the split-explicit free surface's persistent
    barotropic transports U, V. ``Gu``/``Gv``/``Geta``/``Gtracers`` hold
    quasi-AB2's previous tendencies (None under RK3)."""
    u: torch.Tensor
    v: torch.Tensor
    eta: torch.Tensor
    tracers: Dict[str, torch.Tensor]
    clock: Clock
    U: Optional[torch.Tensor] = None
    V: Optional[torch.Tensor] = None
    Gu: Optional[torch.Tensor] = None
    Gv: Optional[torch.Tensor] = None
    Geta: Optional[torch.Tensor] = None
    Gtracers: Optional[Dict[str, torch.Tensor]] = None

    def fields(self):
        return {"u": self.u, "v": self.v, "eta": self.eta, **self.tracers}


class CubedSphereHydrostaticModel(_OnDevice):
    """Hydrostatic Boussinesq primitive equations on the cubed sphere:
    vector-invariant momentum with the upwinded (ζ + f) flux and the exact
    corner circulation; w from continuity of the edge-synced transports;
    the hydrostatic pressure p′ = −∫ b dz; an explicit, split-explicit or
    implicit (``ImplicitFreeSurface(solver_method="cg")``: one CG across the
    panels) free surface with edge-synced barotropic transports (volume
    conserved to rounding); SSP-RK3 ("RungeKutta3", default) or quasi-AB2
    ("QuasiAdamsBashforth2") stepping with an exchange each stage; under
    quasi-AB2 the ``ZStar`` coordinate (``vertical_coordinate``).

    - ``momentum_advection``: None (the hybrid upwinded form) or a
      ``VectorInvariant``/``WENOVectorInvariant``, blended back to the
      hybrid form inside the corner band; the panel halo must cover it.
    - ``buoyancy``: "default" (``BuoyancyTracer`` when a "b" tracer is
      present) or any formulation of ``buoyancy.py``, whose tracers join.
    - ``closure``: any closure of ``closures.py`` or ``closures_ocean.py``
      (or a tuple), with the vertically implicit part solved down every
      column after each stage. CATKE gets no top fluxes here, as in the
      JAX cube model: its convective lengths and surface TKE flux vanish.
    - ``bathymetry``: a callable ``h(lam_deg, phi_deg) -> bottom z``
      (negative depths, ≥ 0 for land) or a stacked bottom-height array:
      grid-fitted wet masks, wet-column depths, and the bottom-most wet
      value mirrored into the solid cells at each exchange.
    - ``forcing``: ``name -> f(lam, phi, z, t)`` for tracers and "u"/"v".
    - ``boundary_conditions``: ``name -> FieldBoundaryConditions(top=FluxBC,
      bottom=FluxBC)`` with numbers, arrays or callables
      ``f(lam, phi, t, *field_dependencies)``.
    - ``prescribed_velocities=True`` freezes (u, v, η).
    """

    def __init__(self, grid: ConformalCubedSphereGrid,
                 gravitational_acceleration=g_Earth,
                 rotation_rate=OMEGA_EARTH, momentum_advection=None,
                 tracer_advection=None, tracers=("b",), buoyancy="default",
                 closure=None, forcing=None, boundary_conditions=None,
                 bathymetry=None, free_surface=None,
                 prescribed_velocities=False, timestepper="RungeKutta3",
                 vertical_coordinate=None, corner_upwind_width=4,
                 corner_filter=None):
        if timestepper in ("AB2", "ab2"):
            timestepper = "QuasiAdamsBashforth2"
        if timestepper not in ("RungeKutta3", "QuasiAdamsBashforth2"):
            raise ValueError(f"unknown timestepper {timestepper!r}")
        self.timestepper = timestepper
        if vertical_coordinate is None:
            vertical_coordinate = ZCoordinate()
        if not isinstance(vertical_coordinate, (ZCoordinate, ZStar)):
            raise ValueError(
                f"unknown vertical_coordinate {vertical_coordinate!r}")
        self.vertical_coordinate = vertical_coordinate
        self.zstar = isinstance(vertical_coordinate, ZStar)
        if self.zstar and timestepper != "QuasiAdamsBashforth2":
            raise ValueError("cubed-sphere ZStar needs "
                             "timestepper='QuasiAdamsBashforth2'")
        self.corner_upwind_width = int(corner_upwind_width)
        self.grid = grid
        self._device_arrays = {}
        self.rotation_rate = float(rotation_rate or 0.0)
        self.prescribed_velocities = bool(prescribed_velocities)
        if free_surface is None:
            free_surface = ExplicitFreeSurface(gravitational_acceleration)
        if (isinstance(free_surface, ImplicitFreeSurface)
                and free_surface.solver_method != "cg"):
            raise ValueError(
                "the cubed sphere supports ImplicitFreeSurface("
                "solver_method='cg') only (spectral/matrix solvers need "
                "a separable grid)")
        if not isinstance(free_surface, (ExplicitFreeSurface,
                                         ImplicitFreeSurface,
                                         SplitExplicitFreeSurface)):
            raise ValueError(f"unknown free surface {free_surface!r}")
        self.free_surface = free_surface
        #: the last implicit solve's CG iterations (a 0-d tensor) and host
        #: reads of its convergence flag
        self.free_surface_info = {}
        self.g = float(free_surface.g)
        #: the momentum tendency carries −g∇η only under the explicit free
        #: surface (the split and implicit ones apply it in their own steps)
        self._explicit_eta_grad = isinstance(free_surface,
                                             ExplicitFreeSurface)
        self.tracer_advection = tracer_advection or Centered(2)
        tracers = tuple(tracers)
        if buoyancy == "default":
            buoyancy = BuoyancyTracer() if "b" in tracers else None
        self.buoyancy = buoyancy
        if buoyancy is not None:
            tracers += tuple(t for t in buoyancy.required_tracers
                             if t not in tracers)
        closures_mod.check_closure(closure, "CubedSphereHydrostaticModel")
        for cl in closures_mod._as_tuple(closure):
            tracers += tuple(t for t in getattr(cl, "required_tracers", ())
                             if t not in tracers)
        self.tracer_names = tracers
        self.closure = closure
        self._implicit = (closure is not None and closures_mod
                          .closure_is_vertically_implicit(closure))
        self.momentum_advection = momentum_advection
        if momentum_advection is not None:
            if not isinstance(momentum_advection, VectorInvariant):
                raise ValueError(
                    "cubed-sphere momentum_advection must be a "
                    "VectorInvariant/WENOVectorInvariant instance or None "
                    f"(the default hybrid upwinding), got "
                    f"{momentum_advection!r}")
            need = momentum_advection.required_halo
            if grid.panel_grid.H[0] < need:
                raise ValueError(
                    f"{momentum_advection!r} needs a panel halo of {need} "
                    f"(grid has {grid.panel_grid.H[0]}); rebuild the grid "
                    f"with halo={need}")
        self.forcings = dict(forcing or {})
        for name in self.forcings:
            if name not in self.tracer_names and name not in ("u", "v"):
                raise ValueError(
                    f"cubed-sphere forcing supports tracers and u/v "
                    f"momentum, got {name!r}")
        self.bcs = dict(boundary_conditions or {})
        for name, fbc in self.bcs.items():
            if name not in self.tracer_names and name not in ("u", "v"):
                raise ValueError(
                    f"cubed-sphere boundary_conditions support tracers "
                    f"and u/v momentum, got {name!r}")
            for side in ("west", "east", "south", "north"):
                if getattr(fbc, side, None) is not None:
                    raise ValueError(
                        "the cubed sphere has no lateral open boundaries; "
                        "only top/bottom flux conditions apply")
            for side in ("top", "bottom"):
                bc = getattr(fbc, side, None)
                if bc is not None and bc.classification != FLUX:
                    raise ValueError(
                        f"cubed-sphere {side} conditions must be FluxBC "
                        f"(got {bc.classification} for {name!r})")

        g = grid.panel_grid
        N, H = grid.N_panel, g.H[0]
        nx = g.shape[0]
        d = 2.0 / N
        self.f_ff = _coriolis_ff(grid, self.rotation_rate)
        _panel_masks(self)
        self._z_row = g.zC.cpu().numpy().reshape(1, 1, 1, -1)
        self._dz_row = g.dz(Center).cpu().numpy().reshape(1, 1, 1, -1)

        # geographic coordinates on the whole extended panel plane at the
        # three horizontal staggerings (the map's extension is exact in the
        # halos)
        def geo(xs, ys):
            lam, phi = panel_geographic_coords(xs, ys)
            return lam[..., None], phi[..., None]

        tC = -1.0 + d * (np.arange(nx) - H + 0.5)
        tF = -1.0 + d * (np.arange(nx) - H)
        self._lam_c, self._phi_c = geo(tC, tC)
        self._lam_u, self._phi_u = geo(tF, tC)
        self._lam_v, self._phi_v = geo(tC, tF)
        # tracer forcings see the centres with the halo columns zeroed
        self._lam_full = self._lam_c * self._mask_c[None]
        self._phi_full = self._phi_c * self._mask_c[None]

        self.bathymetry = bathymetry
        self._wet_c = self._wet_u = self._wet_v = self._wet_w = None
        self._frac_c = self._frac_u = self._frac_v = None
        self._Hu = self._Hv = self._Hc = None
        self._wet2_c = self._wet2_u = self._wet2_v = None
        kk = np.arange(g.shape[2]).reshape(1, 1, 1, -1)
        Hz, Nz = g.H[2], g.N[2]
        kin = ((kk >= Hz) & (kk < Hz + Nz)).astype(float)
        top = (kk == Hz + Nz - 1).astype(float)
        if bathymetry is None:
            self._top_c = self._top_u = self._top_v = top
            bot = (kk == Hz).astype(float)
            self._bot_c = self._bot_u = self._bot_v = bot
        else:
            self._grid_fitted_bottom(bathymetry, kin, top)
        self._mask_u2 = (self._mask_u if self._wet2_u is None
                         else self._mask_u * self._wet2_u)
        self._mask_v2 = (self._mask_v if self._wet2_v is None
                         else self._mask_v * self._wet2_v)
        if self._wet_u is None:
            self._cf_mask_u, self._cf_mask_v = self._mask_u, self._mask_v
        else:
            # the smoother writes no velocity into land or the z halos
            self._cf_mask_u = self._mask_u * self._wet_u * kin
            self._cf_mask_v = self._mask_v * self._wet_v * kin
        self._kin = kin
        if self.zstar:
            self._zstar_setup(kin)
        _corner_filter_setup(self, corner_filter)

    def _zstar_setup(self, kin):
        """The static parts of z-star: the wet column depths σ divides by
        (fraction-aware, the flat column without bathymetry), and the share
        of each wet column below each w face, over which the grid's motion
        is distributed (0 at the bottom, 1 at the surface)."""
        g = self.grid.panel_grid
        dz0 = np.broadcast_to(g.dz(Center).cpu().numpy(), g.shape)[None]
        dzw = dz0 * kin
        if self._wet_c is not None:
            dzw = dzw * self._wet_c
            if self._frac_c is not None:
                dzw = dzw * self._frac_c
        full = np.sum(dz0 * kin, axis=3, keepdims=True)
        self._sig_Hc = full if self._Hc is None else self._Hc
        self._sig_Hu = full if self._Hu is None else self._Hu
        self._sig_Hv = full if self._Hv is None else self._Hv
        hb = np.roll(np.cumsum(dzw, axis=3), 1, axis=3)
        hb[..., 0] = 0.0
        H = np.sum(dzw, axis=3, keepdims=True)
        self._zstar_below = np.where(H > 0, hb / np.where(H > 0, H, 1.0),
                                     0.0)

    def _sigma_field(self, eta):
        """The z-star column stretching σ = (H + η)/H at the centres (1 on
        land columns)."""
        H = self._dev("_sig_Hc", eta.dtype)
        return torch.where(H > 0, 1.0 + eta / torch.where(H > 0, H, 1.0),
                           1.0)

    def _sigma_faces(self, eta):
        """σ at the u and v faces from the faces' wet column depths and η
        interpolated to them."""
        out = []
        for tag, e in (("u", ix_f(eta)), ("v", iy_f(eta))):
            H = self._dev(f"_sig_H{tag}", eta.dtype)
            out.append(torch.where(
                H > 0, 1.0 + e / torch.where(H > 0, H, 1.0), 1.0))
        return tuple(out)

    def _grid_fitted_bottom(self, bathymetry, kin, top):
        """Wet masks, wet-column depths and boundary-cell indicators of the
        bathymetry: a ``GridFittedBottom`` (or its bottom height given
        bare: a callable ``h(lam, phi)`` or an array of bottom heights), a
        ``PartialCellBottom`` (its cells' height fractions too) or a
        ``GridFittedBoundary`` (a 3-D solid mask), built in numpy."""
        grid = self.grid
        g = grid.panel_grid
        N, H = grid.N_panel, g.H[0]
        nx, ny, _ = g.shape
        Hz, Nz = g.H[2], g.N[2]
        eps_min = (bathymetry.minimum_fractional_cell_height
                   if isinstance(bathymetry, PartialCellBottom) else None)
        if isinstance(bathymetry, GridFittedBoundary):
            wet = self._boundary_wet(bathymetry.mask)
            # below-domain z halos read dry, so the bottom indicator marks
            # the deepest wet cell of a full-depth column; above-surface
            # halos stay wet, so the top mirror is kept
            wet[..., :Hz] = 0.0
            wet[..., Hz + Nz:] = 1.0
            self._wet_columns(wet, kin, top)
            return
        if isinstance(bathymetry, GridFittedBottom):
            bathymetry = bathymetry.bottom_height
        if callable(bathymetry):
            bot_full = np.asarray(
                bathymetry(self._lam_c[..., 0], self._phi_c[..., 0])
            )[..., None]
        elif hasattr(bathymetry, "ndim") or isinstance(bathymetry,
                                                        (list, tuple)):
            botv = (bathymetry.detach().cpu().numpy()
                    if torch.is_tensor(bathymetry)
                    else np.asarray(bathymetry))
            bot_full = np.zeros((6, nx, ny, 1))
            if botv.shape == (6, N, N):
                bot_full[:, H:H + N, H:H + N, 0] = botv
            elif botv.shape == (6, nx, ny):
                bot_full[..., 0] = botv
            elif botv.shape == (6, nx, ny, 1):
                bot_full = botv.copy()
            else:
                raise ValueError(
                    f"bathymetry array must be (6, {N}, {N}) or "
                    f"(6, {nx}, {ny}[, 1]), got {botv.shape}")
            # halo-consistent across the panel seams
            bot_full = cubed_sphere_halo_exchange(
                torch.as_tensor(bot_full, dtype=torch.float64,
                                device=grid.device), grid).cpu().numpy()
        else:
            raise ValueError(
                f"bathymetry={bathymetry!r}: give a GridFittedBottom, a "
                "GridFittedBoundary, a callable h(lam, phi) or an array of "
                "bottom heights")
        if eps_min is None:
            zc = g.zC.cpu().numpy().reshape(1, 1, 1, -1)
            self._wet_columns((zc >= bot_full).astype(float), kin, top)
            return
        # partial bottom cells: a cell is wet where at least the minimum
        # fraction of it lies above the bottom, and keeps that fraction
        # of its height; a face takes the shallower of its two cells
        zf = g.zF.cpu().numpy().reshape(1, 1, 1, -1)
        dzf = np.broadcast_to(g.dz(Center).cpu().numpy(), g.shape)[None]
        with np.errstate(invalid="ignore"):
            water = np.clip((zf + dzf - bot_full) / dzf, 0.0, 1.0)
        wet = (water >= eps_min).astype(float)
        frac = np.where(wet > 0, np.clip(water, eps_min, 1.0), 1.0)
        self._frac_c = frac
        self._frac_u = np.minimum(frac, np.roll(frac, 1, axis=1))
        self._frac_v = np.minimum(frac, np.roll(frac, 1, axis=2))
        self._wet_columns(wet, kin, top)

    def _boundary_wet(self, mask):
        """The wet cells (1.0) of a ``GridFittedBoundary`` mask: a callable
        ``mask(lam, phi, z)`` (degrees, metres) or a (6, N, N, Nz) or
        halo-extended array, made consistent across the panel seams."""
        grid = self.grid
        g = grid.panel_grid
        N, H = grid.N_panel, g.H[0]
        nx, ny, nz = g.shape
        Hz, Nz = g.H[2], g.N[2]
        zc = g.zC.cpu().numpy().reshape(1, 1, 1, -1)
        if callable(mask):
            solid = np.asarray(mask(self._lam_c, self._phi_c, zc), float)
            solid = np.broadcast_to(solid, (6, nx, ny, nz)).copy()
        else:
            mv = (mask.detach().cpu().numpy() if torch.is_tensor(mask)
                  else np.asarray(mask)).astype(float)
            solid = np.zeros((6, nx, ny, nz))
            if mv.shape == (6, N, N, Nz):
                solid[:, H:H + N, H:H + N, Hz:Hz + Nz] = mv
            elif mv.shape == (6, nx, ny, nz):
                solid = mv.copy()
            else:
                raise ValueError(
                    f"GridFittedBoundary mask must be (6, {N}, {N}, {Nz}) "
                    f"or full-frame, got {mv.shape}")
            solid = (cubed_sphere_halo_exchange(
                torch.as_tensor(solid, dtype=torch.float64,
                                device=grid.device),
                grid).cpu().numpy() > 0.5).astype(float)
        return 1.0 - np.clip(solid, 0.0, 1.0)

    def _wet_columns(self, wet, kin, top):
        """The masks, wet-column depths and boundary-cell indicators of the
        wet cells ``wet`` (a (6, nx, ny, nz) array of 0.0 and 1.0)."""
        g = self.grid.panel_grid
        dzf = np.broadcast_to(g.dz(Center).cpu().numpy(), g.shape)[None]
        self._wet_c = wet
        # a face is wet only when both adjacent cells are (face i sits
        # between cells i - 1 and i)
        self._wet_u = wet * np.roll(wet, 1, axis=1)
        self._wet_v = wet * np.roll(wet, 1, axis=2)
        self._wet_w = wet * np.roll(wet, 1, axis=3)
        dzi = dzf * kin
        fc, fu, fv = ((1.0, 1.0, 1.0) if self._frac_c is None
                      else (self._frac_c, self._frac_u, self._frac_v))
        self._Hc = np.sum(self._wet_c * fc * dzi, axis=3, keepdims=True)
        self._Hu = np.sum(self._wet_u * fu * dzi, axis=3, keepdims=True)
        self._Hv = np.sum(self._wet_v * fv * dzi, axis=3, keepdims=True)
        self._wet2_c = (self._Hc > 0).astype(float)
        self._wet2_u = (self._Hu > 0).astype(float)
        self._wet2_v = (self._Hv > 0).astype(float)
        # flux boundary conditions act on the surface cell of each wet
        # column and on its bottom-most wet cell
        self._top_c = top * self._wet2_c
        self._top_u = top * self._wet2_u
        self._top_v = top * self._wet2_v

        def bot_ind(w3):
            return w3 * (1.0 - np.roll(w3, 1, axis=3)) * kin

        self._bot_c = bot_ind(self._wet_c)
        self._bot_u = bot_ind(self._wet_u)
        self._bot_v = bot_ind(self._wet_v)

    # ------------------------------------------------------------------
    def initial_state(self, u=None, v=None, eta=0.0, time=0.0, **tracers):
        """``u``/``v``: stacked (6, nx, ny, nz) arrays or None; ``eta``: a
        number or a stacked (6, nx, ny, 1) array; tracers by name (numbers,
        stacked arrays or callables ``f(lam, phi, z)`` of degrees and
        metres, numpy)."""
        grid = self.grid
        g = grid.panel_grid
        nx, ny, nz = g.shape
        dtype = grid.dtype
        zero3 = torch.zeros((6, nx, ny, nz), dtype=dtype, device=grid.device)
        zero2 = torch.zeros((6, nx, ny, 1), dtype=dtype, device=grid.device)
        mc = self._dev("_mask_c", dtype)
        u = zero3 if u is None else _as_tensor(u, grid)
        v = zero3 if v is None else _as_tensor(v, grid)
        eta = torch.full_like(zero2, eta) * mc if np.ndim(eta) == 0 \
            else _as_tensor(eta, grid)
        tr = {}
        for name in self.tracer_names:
            val = tracers.get(name, 0.0)
            if callable(val):
                tr[name] = grid.set_tracer(val)
            elif np.ndim(val) == 0:
                tr[name] = torch.full_like(zero3, val) * mc
            else:
                tr[name] = _as_tensor(val, grid)
        ab2 = self.timestepper == "QuasiAdamsBashforth2"
        state = CubedSphereHydrostaticState(
            u=u, v=v, eta=eta, tracers=tr,
            clock=Clock.start(time, dtype),
            U=zero2, V=zero2,
            Gu=zero3 if ab2 else None, Gv=zero3 if ab2 else None,
            Geta=zero2 if ab2 else None,
            Gtracers={n: zero3 for n in self.tracer_names} if ab2 else None)
        state = self.fill_state_halos(state)
        # the persistent barotropic transports start from the initial
        # velocities
        um, vm = self._wet_masked(state.u, state.v)
        U0, V0 = cs_barotropic_mode(g, um, vm, *self._mode_sigmas(
            dtype, *(self._sigma_faces(state.eta) if self.zstar
                     else (None, None))))
        return _replace(state, U=U0 * self._dev("_mask_u2", dtype),
                        V=V0 * self._dev("_mask_v2", dtype))

    def _wet_masked(self, u, v):
        if self._wet_u is None:
            return u, v
        return (u * self._dev("_wet_u", u.dtype),
                v * self._dev("_wet_v", v.dtype))

    # ------------------------------------------------------------------
    def _mirror_solid(self, a, wet, bot_ind):
        """Fill the solid cells of each column with its bottom-most wet
        value: zero gradient across the bottom, so vertical diffusive fluxes
        vanish there, and a free-slip extension of the velocities."""
        cbot = torch.sum(a * self._dev(bot_ind, a.dtype), dim=Z,
                         keepdim=True)
        w = self._dev(wet, a.dtype)
        return a * w + (1 - w) * cbot

    def _fill_z(self, a):
        """Mirror one z-ghost on each side (free slip, no flux), in place:
        ``a`` is a fresh tensor from an exchange."""
        g = self.grid.panel_grid
        Hz, Nz = g.H[2], g.N[2]
        if Hz == 0 or a.shape[-1] == 1:
            return a
        a[..., Hz - 1] = a[..., Hz]
        a[..., Hz + Nz] = a[..., Hz + Nz - 1]
        return a

    def fill_state_halos(self, state):
        grid = self.grid
        u, v = self._wet_masked(state.u, state.v)
        u, v = cubed_sphere_velocity_exchange(u, v, grid)
        u = self._fill_z(u)
        v = self._fill_z(v)
        eta = state.eta
        if self._wet2_c is not None:
            eta = eta * self._dev("_wet2_c", eta.dtype)
        eta = cubed_sphere_halo_exchange(eta, grid)
        tracers = {n: self._fill_z(cubed_sphere_halo_exchange(c, grid))
                   for n, c in state.tracers.items()}
        if self._wet_c is not None:
            u = self._mirror_solid(u, "_wet_u", "_bot_u")
            v = self._mirror_solid(v, "_wet_v", "_bot_v")
            tracers = {n: self._mirror_solid(c, "_wet_c", "_bot_c")
                       for n, c in tracers.items()}
        return _replace(state, u=u, v=v, eta=eta, tracers=tracers)

    # ------------------------------------------------------------------
    def _w_from_divergence(self, hdiv, dz):
        """w at the z-faces from continuity: minus the cumulative sum of
        the interior levels' horizontal divergence × dz below each face."""
        contrib = torch.where(_z_interior(self.grid.panel_grid), hdiv * dz,
                              0.0)
        csum = torch.cumsum(contrib, dim=Z)
        w = -torch.roll(csum, 1, Z)
        w[..., 0] = 0.0
        return w

    def _panel_w(self, u, v):
        """w of all panels from the panel-local transports (no edge
        sync)."""
        g = self.grid.panel_grid
        hdiv = (dx_c(g.dy(Center, Face) * u)
                + dy_c(g.dx(Center, Face) * v)) / g.Az(Center, Center)
        return self._w_from_divergence(hdiv, g.dz(Center))

    def _w_from_fluxes(self, Fxl, Fyl, g):
        """w from edge-synced per-level transports (Ax u, Ay v): the same
        single-valued seam transports as the tracer fluxes, so a uniform
        tracer stays uniform at edge columns too. ``g``: the (scaled)
        panel grid of :meth:`_dynamics_grid`. Under z-star less the grid's
        motion, spread over the wet column: the velocity across the moving
        levels, zero at the bottom and at the surface."""
        hdiv = (dx_c(Fxl) + dy_c(Fyl)) / g.V(Center, Center, Center)
        dz = g.dz(Center)
        w = self._w_from_divergence(hdiv, dz)
        if self.zstar:
            total = torch.sum(torch.where(
                _z_interior(self.grid.panel_grid), hdiv * dz, 0.0), dim=Z,
                keepdim=True)
            w = w + self._dev("_zstar_below", w.dtype) * total
        return w

    def _dynamics_grid(self, dtype, sig=None, sig_u=None, sig_v=None):
        """The panel grid the dynamics see: its cell heights scaled by the
        z-star σ (``sig`` at the centres, ``sig_u`` and ``sig_v`` at the
        faces) and the partial cells' fractions (``_ScaledZGrid``);
        the panel grid itself without either."""
        g = self.grid.panel_grid
        if self._frac_c is not None:
            f = [self._dev(f"_frac_{t}", dtype) for t in "cuv"]
            if sig is None:
                sig, sig_u, sig_v = f
            else:
                sig, sig_u, sig_v = sig * f[0], sig_u * f[1], sig_v * f[2]
        if sig is None:
            return g
        return _ScaledZGrid(g, sig, sig_u, sig_v)

    def _mode_sigmas(self, dtype, sig_u=None, sig_v=None):
        """The factors of the barotropic mode's thicknesses at the u and v
        faces: the z-star σ times the partial cells' fractions (None where
        neither applies)."""
        fu, fv = self._frac("u", dtype), self._frac("v", dtype)
        if fu is None:
            return sig_u, sig_v
        if sig_u is None:
            return fu, fv
        return sig_u * fu, sig_v * fv

    def _frac(self, name, dtype):
        """The height fractions of the partial cells at the location of
        field ``name``, or None without partial cells."""
        if self._frac_c is None:
            return None
        tag = "u" if name == "u" else "v" if name == "v" else "c"
        return self._dev(f"_frac_{tag}", dtype)

    def _pressure(self, b, g):
        """p′ = −∫_z^0 b dz′ at the centres."""
        contrib = torch.where(_z_interior(g), b * g.dz(Center), 0.0)
        total = torch.sum(contrib, dim=Z, keepdim=True)
        below_incl = torch.cumsum(contrib, dim=Z)
        return -((total - below_incl) + 0.5 * contrib)

    def _buoyancy_ccc(self, tracers, g):
        if self.buoyancy is not None:
            return self.buoyancy.buoyancy_ccc(g, tracers)
        # without a formulation, a "b" tracer is the buoyancy
        return tracers.get("b")

    def _momentum_tendencies(self, u, v, eta, f_ff, zeta, tracers, w, g,
                             sig=None):
        """(Gu, Gv) of all panels on the (scaled) panel grid ``g``.
        Transports use the wet-masked velocities (no flux through the
        bottom); gradients and shear the mirrored fields the exchange
        made. Under z-star (``sig``, its σ alone) and with partial cells
        the pressure gradient along a level takes the levels' slope."""
        um, vm = self._wet_masked(u, v)
        b = self._buoyancy_ccc(tracers, g)
        p = self._pressure(b, g) if b is not None else 0.0
        eta_term = self.g * eta if self._explicit_eta_grad else 0.0
        q = zeta + f_ff
        K = 0.5 * (ix_c(u * u) + iy_c(v * v))
        phi = K + p + eta_term
        # the hybrid upwinded (ζ + f) flux: first order in the corner band,
        # UpwindBiased(3) elsewhere, on length-weighted transverse
        # velocities
        Vu = ix_f(iy_c(g.dx(Center, Face) * vm)) / g.dx(Face, Center)
        Uv = iy_f(ix_c(g.dy(Center, Face) * um)) / g.dy(Face, Center)
        cm = self._dev("_corner_mask", q.dtype)
        ub3 = UpwindBiased(3)
        q1y = torch.where(Vu >= 0, q, torch.roll(q, -1, Y))
        q1x = torch.where(Uv >= 0, q, torch.roll(q, -1, X))
        q_up = cm * q1y + (1 - cm) * _face_value(ub3, Vu, q, Y, 1)
        q_upx = cm * q1x + (1 - cm) * _face_value(ub3, Uv, q, X, 1)
        dudz = dz_f(u) / g.dz(Face)
        Gu = (q_up * Vu - dx_f(phi) / g.dx(Face, Center)
              - iz_c(ix_f(w) * dudz))
        dvdz = dz_f(v) / g.dz(Face)
        Gv = (-q_upx * Uv - dy_f(phi) / g.dy(Face, Center)
              - iz_c(iy_f(w) * dvdz))
        dGu, dGv = _corner_bernoulli_upwind_correction(
            g, u, v, K, self._dev("_corner_mask_ke", u.dtype))
        Gu = Gu + dGu
        Gv = Gv + dGv
        slope_x = slope_y = None
        if (self._frac_c is not None or self.zstar) and b is not None:
            # the gradient of p′ along a level differs from the gradient at
            # constant z by b ∂x(z) (p′ has ∂z p′ = +b): z = σ z_ref + η,
            # and a partial bottom cell's centre rises by (1 − frac)·Δz/2
            base = g.base
            if self._frac_c is not None:
                s2 = 1.0 if sig is None else sig
                frac = g.sigma / s2
                z_ref = base.zC + 0.5 * (1.0 - frac) * base.dz(Center)
            else:
                s2, z_ref = g.sigma, base.zC
            z_c = s2 * z_ref + eta
            slope_x = ix_f(b) * dx_f(z_c) / g.dx(Face, Center)
            slope_y = iy_f(b) * dy_f(z_c) / g.dy(Face, Center)
            Gu = Gu + slope_x
            Gv = Gv + slope_y
        adv = self.momentum_advection
        if adv is None:
            return Gu, Gv
        # the vector-invariant scheme away from the corner band, on the
        # corner-fixed ζ; Coriolis keeps the transverse-averaged form
        Gu_adv = adv.u_tendency(g, u, v, w, zeta=zeta)
        Gv_adv = adv.v_tendency(g, u, v, w, zeta=zeta)
        phig = p + eta_term
        if not torch.is_tensor(phig):
            phig = torch.zeros_like(u)
        Gu_vi = (Gu_adv + iy_c(f_ff) * Vu
                 - dx_f(phig) / g.dx(Face, Center))
        Gv_vi = (Gv_adv - ix_c(f_ff) * Uv
                 - dy_f(phig) / g.dy(Face, Center))
        if slope_x is not None:
            Gu_vi = Gu_vi + slope_x
            Gv_vi = Gv_vi + slope_y
        return cm * Gu + (1 - cm) * Gu_vi, cm * Gv + (1 - cm) * Gv_vi

    def _fluxes(self, u, v, w, tracers, g):
        """Barotropic and tracer fluxes of all panels on the (scaled) panel
        grid ``g`` (the horizontal ones before the edge sync); advective
        fluxes through solid faces are zero. The transports integrate the
        thickness of each face, as the tracer fluxes' areas do."""
        um, vm = self._wet_masked(u, v)
        if self._frac_c is None and not self.zstar:
            dzi = torch.where(_z_interior(g), g.dz(Center), 0.0)
            U = torch.sum(um * dzi, dim=Z, keepdim=True)
            V = torch.sum(vm * dzi, dim=Z, keepdim=True)
        else:
            dzi0 = torch.where(_z_interior(g), g.base.dz(Center), 0.0)
            U = torch.sum(um * (g.sigma_fc * dzi0), dim=Z, keepdim=True)
            V = torch.sum(vm * (g.sigma_cf * dzi0), dim=Z, keepdim=True)
        Fx = g.dy(Center, Face) * U
        Fy = g.dx(Center, Face) * V
        k = torch.arange(g.shape[2], device=g.device)
        wall = (k <= g.H[2]) | (k > g.H[2] + g.N[2] - 1)
        Ft = {}
        for name, c in tracers.items():
            sxs = _scheme_for(self.tracer_advection, 0)
            sys_ = _scheme_for(self.tracer_advection, 1)
            szs = _scheme_for(self.tracer_advection, 2)
            fcx = (g.Ax(Face, Center, Center) * um
                   * _face_value(sxs, um, c, X, 0))
            fcy = (g.Ay(Center, Face, Center) * vm
                   * _face_value(sys_, vm, c, Y, 0))
            fcz = g.Az(Center, Center) * w * _face_value(szs, w, c, Z, 0)
            # no flux through the top and bottom walls
            fcz = torch.where(wall, 0.0, fcz)
            if self._wet_w is not None:
                fcz = fcz * self._dev("_wet_w", fcz.dtype)
            Ft[name] = (fcx, fcy, fcz)
        return Fx, Fy, Ft

    # -- surface and bottom flux boundary conditions -----------------------
    def _boundary_indicator(self, name, side):
        tag = "u" if name == "u" else "v" if name == "v" else "c"
        return f"_{'top' if side == 'top' else 'bot'}_{tag}"

    def _boundary_value(self, state, name, side):
        """The boundary-adjacent interior value of a field (the surface cell
        or the bottom-most wet cell), (6, nx, ny, 1)."""
        a = state.fields()[name]
        if a.shape[-1] == 1:
            return a
        ind = self._dev(self._boundary_indicator(name, side), a.dtype)
        return torch.sum(a * ind, dim=Z, keepdim=True)

    def _eval_cs_flux(self, bc, name, side, state, t, dtype):
        """A top/bottom FluxBC's value as a broadcastable (6, nx, ny, 1)
        tensor. Callables get ``f(lam, phi, t, *field_deps)`` (degrees, on
        the field's staggering) with each dependency's boundary-adjacent
        value."""
        q = bc.condition
        if isinstance(q, (int, float)):
            return float(q)
        if callable(q):
            tag = "u" if name == "u" else "v" if name == "v" else "c"
            deps = [self._boundary_value(state, dep, side)
                    for dep in bc.field_dependencies]
            q = q(self._dev(f"_lam_{tag}", dtype),
                  self._dev(f"_phi_{tag}", dtype), t, *deps)
        elif not torch.is_tensor(q):
            # an array: on the device once
            key = ("bc", name, side, dtype)
            if key not in self._device_arrays:
                self._device_arrays[key] = torch.as_tensor(
                    np.asarray(q), dtype=dtype, device=self.grid.device)
            q = self._device_arrays[key]
        q = torch.as_tensor(q, dtype=dtype, device=self.grid.device)
        if q.ndim == 3:
            q = q[..., None]
        g = self.grid.panel_grid
        N = self.grid.N_panel
        if q.ndim == 4 and q.shape[1] == N and q.shape[1] != g.shape[0]:
            # an interior-shaped array, embedded in the halo frame
            H = g.H[0]
            full = torch.zeros((q.shape[0], g.shape[0], g.shape[1], 1),
                               dtype=dtype, device=self.grid.device)
            full[:, H:H + N, H:H + N, :] = q
            q = full
        return q

    def _apply_cs_flux_bcs(self, state, Gu, Gv, Gt):
        """Add top/bottom boundary fluxes into the tendencies at the
        surface or bottom-most wet cell: a bottom flux adds +q/Δz, a top
        flux −q/Δz."""
        dtype = Gu.dtype
        dz = self._dev("_dz_row", dtype)
        t = state.clock.time
        sig = None
        if self.zstar:
            # the boundary cell's moving thickness is σΔz: the σ-weighted
            # tendency then carries q/Δz
            sig = dict(zip("uv", self._sigma_faces(state.eta)))
            sig["c"] = self._sigma_field(state.eta)
        for name, fbc in self.bcs.items():
            for side, sign in (("top", -1.0), ("bottom", 1.0)):
                bc = getattr(fbc, side, None)
                if bc is None or bc.condition is None:
                    continue
                q = self._eval_cs_flux(bc, name, side, state, t, dtype)
                ind = self._dev(self._boundary_indicator(name, side), dtype)
                contrib = sign * q * ind / dz
                if sig is not None:
                    contrib = contrib / sig[name if name in ("u", "v")
                                             else "c"]
                frac = self._frac(name, dtype)
                if frac is not None:
                    # a partial bottom cell is frac·Δz thick
                    contrib = contrib / frac
                if name == "u":
                    Gu = Gu + contrib
                elif name == "v":
                    Gv = Gv + contrib
                else:
                    Gt[name] = Gt[name] + contrib
        return Gu, Gv, Gt

    def _closure_tendencies(self, u, v, tracers):
        """The closure's explicit stress and flux divergences of all panels,
        and its coefficients (for the implicit solve)."""
        g = self.grid.panel_grid
        um, vm = self._wet_masked(u, v)
        w = self._panel_w(um, vm)
        gx = g if self._wet_c is None else _PanelSolidView(
            g, self._dev("_wet_c", u.dtype) < 0.5)
        diff = closures_mod.compute_diffusivities(
            self.closure, g, u, v, w, tracers, self.buoyancy)
        du, dv, _ = closures_mod.momentum_flux_divergences(
            self.closure, gx, u, v, w, tracers, diff, include_implicit=False)
        gt = {n: closures_mod.tracer_flux_divergence(
            self.closure, gx, n, tracers[n], tracers, diff,
            include_implicit=False) for n in tracers}
        return du, dv, gt, diff

    def compute_tendencies(self, state):
        """``(Gu, Gv, Geta, {name: Gc}, diffusivities)``."""
        g = self.grid.panel_grid
        dtype = state.u.dtype
        f = self._dev("f_ff", dtype)
        zeta = vorticity_z_ff(g, state.u, state.v)
        zeta = cubed_sphere_corner_vorticity(zeta, state.u, state.v,
                                             self.grid)
        # edge-synced w: continuity integrates the same single-valued seam
        # transports as the tracer fluxes
        um, vm = self._wet_masked(state.u, state.v)
        sig = sig_u = sig_v = None
        if self.zstar:
            sig = self._sigma_field(state.eta)
            sig_u, sig_v = self._sigma_faces(state.eta)
        gd = self._dynamics_grid(dtype, sig, sig_u, sig_v)
        Fxl, Fyl = cubed_sphere_sync_edge_fluxes(
            gd.Ax(Face, Center, Center) * um,
            gd.Ay(Center, Face, Center) * vm, self.grid)
        w = self._w_from_fluxes(Fxl, Fyl, gd)
        Gu, Gv = self._momentum_tendencies(state.u, state.v, state.eta, f,
                                           zeta, state.tracers, w, gd, sig)
        Fx, Fy, Ft = self._fluxes(state.u, state.v, w, state.tracers, gd)
        Fx, Fy = cubed_sphere_sync_edge_fluxes(Fx, Fy, self.grid)
        Ft = {n: (*cubed_sphere_sync_edge_fluxes(fx, fy, self.grid), fz)
              for n, (fx, fy, fz) in Ft.items()}
        Geta = -(dx_c(Fx) + dy_c(Fy)) / g.Az(Center, Center)[..., :1]
        Gt = {n: -(dx_c(fx) + dy_c(fy) + dz_c(fz))
              / gd.V(Center, Center, Center)
              for n, (fx, fy, fz) in Ft.items()}

        diffusivities = None
        if self.closure is not None:
            du, dv, gtc, diffusivities = self._closure_tendencies(
                state.u, state.v, state.tracers)
            Gu = Gu + du
            Gv = Gv + dv
            Gt = {n: Gt[n] + gtc[n] for n in Gt}

        if self.forcings:
            t = state.clock.time
            z = self._dev("_z_row", dtype)
            for name, fn in self.forcings.items():
                if name == "u":
                    Gu = Gu + fn(self._dev("_lam_u", dtype),
                                 self._dev("_phi_u", dtype), z, t)
                elif name == "v":
                    Gv = Gv + fn(self._dev("_lam_v", dtype),
                                 self._dev("_phi_v", dtype), z, t)
                else:
                    Gt[name] = Gt[name] + fn(self._dev("_lam_full", dtype),
                                             self._dev("_phi_full", dtype),
                                             z, t)

        if self.bcs:
            Gu, Gv, Gt = self._apply_cs_flux_bcs(state, Gu, Gv, Gt)

        mu = self._dev("_mask_u", dtype)
        mv = self._dev("_mask_v", dtype)
        mc = self._dev("_mask_c", dtype)
        if self._wet_u is not None:
            mu = mu * self._dev("_wet_u", dtype)
            mv = mv * self._dev("_wet_v", dtype)
            mc2 = mc * self._dev("_wet2_c", dtype)
            mcw = mc * self._dev("_wet_c", dtype)
        else:
            mc2 = mcw = mc
        # no tendency in the z-halo levels (only one ghost level is
        # re-mirrored a fill)
        kin = self._dev("_kin", dtype)
        if self.prescribed_velocities:
            Gu = torch.zeros_like(Gu)
            Gv = torch.zeros_like(Gv)
            Geta = torch.zeros_like(Geta)
        return (Gu * mu * kin, Gv * mv * kin, Geta * mc2,
                {n: G * mcw * kin for n, G in Gt.items()}, diffusivities)

    # ------------------------------------------------------------------
    def _euler_free_surface(self, s, u_e, v_e, Gu, Gv, Geta, dt,
                            sig_u=None, sig_v=None):
        """The free-surface part of one Euler substage: the stage's (u, v,
        η, U, V) after the explicit, split-explicit or implicit barotropic
        step. ``dt`` is a 0-d CPU tensor; under z-star ``sig_u``/``sig_v``
        scale the transports' thicknesses and the column depths."""
        if self.prescribed_velocities:
            return u_e, v_e, s.eta, s.U, s.V
        fs = self.free_surface
        g = self.grid.panel_grid
        grid = self.grid
        dtype = u_e.dtype
        mu = self._dev("_mask_u2", dtype)
        mv = self._dev("_mask_v2", dtype)
        Hu = Hv = None
        if self._Hu is not None:
            Hu = self._dev("_Hu", dtype)
            Hv = self._dev("_Hv", dtype)
        um, vm = self._wet_masked(u_e, v_e)
        # the transports integrate the faces' moving and partial
        # thicknesses
        mode_u, mode_v = self._mode_sigmas(dtype, sig_u, sig_v)

        def exchange(e):
            return cubed_sphere_halo_exchange(e, grid)

        def sync(fx, fy):
            return cubed_sphere_sync_edge_fluxes(fx, fy, grid)

        if isinstance(fs, ExplicitFreeSurface):
            eta = s.eta + dt.item() * Geta
            U, V = cs_barotropic_mode(g, um, vm, mode_u, mode_v)
            return u_e, v_e, eta, U * mu, V * mv
        if isinstance(fs, ImplicitFreeSurface):
            dtf = dt.item()
            mc = self._dev("_mask_c", dtype)
            if self._wet2_c is not None:
                mc = mc * self._dev("_wet2_c", dtype)
            eta = cs_implicit_free_surface(g, um, vm, s.eta, dtf, fs,
                                           exchange, sync, mc, Hu=Hu, Hv=Hv,
                                           info=self.free_surface_info)
            gx, gy = cs_eta_gradients(g, eta)
            u_e = u_e - dtf * fs.g * gx * mu
            v_e = v_e - dtf * fs.g * gy * mv
            um, vm = self._wet_masked(u_e, v_e)
            U, V = cs_barotropic_mode(g, um, vm, mode_u, mode_v)
            return u_e, v_e, eta, U * mu, V * mv
        # split-explicit substepping from the persistent transports, forced
        # by ∫ G dz (G σ-weighted under z-star)
        fu, fv = self._frac("u", dtype), self._frac("v", dtype)
        GU, GV = cs_barotropic_mode(g, Gu, Gv, fu, fv)
        eta_f, U_f, V_f = cs_split_explicit_free_surface(
            g, s.U, s.V, s.eta, GU, GV, dt, fs, exchange, sync, mu, mv,
            Hu=Hu, Hv=Hv)
        u_c, v_c = cs_barotropic_correct(g, um, vm, U_f, V_f, mu, mv,
                                         Hu=Hu, Hv=Hv, sigma_u=mode_u,
                                         sigma_v=mode_v, depth_u=sig_u,
                                         depth_v=sig_v)
        if self._wet_u is not None:
            # the solid cells keep their mirror until the next exchange
            wu = self._dev("_wet_u", dtype)
            wv = self._dev("_wet_v", dtype)
            u_c = u_c * wu + u_e * (1 - wu)
            v_c = v_c * wv + v_e * (1 - wv)
        return u_c, v_c, eta_f, U_f, V_f

    def _implicit_step(self, u, v, tracers, diffusivities, dt):
        if not self._implicit:
            return u, v, tracers
        return closures_mod.implicit_vertical_diffusion_step(
            self.grid.panel_grid, self.closure, diffusivities, dt, u=u, v=v,
            tracers=tracers)

    def step(self, state, dt, assume_filled=False):
        """One step of the configured timestepper. ``assume_filled=True``
        skips the leading exchange: every step ends with one."""
        dt = torch.tensor(dt, dtype=state.u.dtype)
        if self.timestepper == "QuasiAdamsBashforth2":
            return self._ab2_step(state, dt, assume_filled=assume_filled)
        return self._rk3_step(state, dt, assume_filled=assume_filled)

    def _ab2_step(self, state, dt, chi=0.1, assume_filled=False):
        """χ-weighted quasi-AB2 with an Euler first step: the AB2-effective
        tendency drives the momentum and tracer update and the barotropic
        step. Under z-star the tendencies are σ-weighted (only those
        telescope across the moving grid), and u, v and the tracers are
        rescaled by σⁿ/σⁿ⁺¹ after the free surface's step."""
        dtf = dt.item()
        s = state if assume_filled else self.fill_state_halos(state)
        c_now, c_prev = ab2_coefficients(s.clock.iteration, chi)
        Gu, Gv, Geta, Gt, diff = self.compute_tendencies(s)
        sig_u = sig_v = None
        if self.zstar:
            sig_n = self._sigma_field(s.eta)
            sig_u, sig_v = self._sigma_faces(s.eta)
            Gu, Gv = Gu * sig_u, Gv * sig_v
            Gt = {n: Gt[n] * sig_n for n in self.tracer_names}
        Gu_eff = c_now * Gu + c_prev * s.Gu
        Gv_eff = c_now * Gv + c_prev * s.Gv
        Geta_eff = c_now * Geta + c_prev * s.Geta
        Gt_eff = {n: c_now * Gt[n] + c_prev * s.Gtracers[n]
                  for n in self.tracer_names}
        if self.zstar:
            u_e = s.u + dtf * Gu_eff / sig_u
            v_e = s.v + dtf * Gv_eff / sig_v
        else:
            u_e = s.u + dtf * Gu_eff
            v_e = s.v + dtf * Gv_eff
        u, v, eta, U, V = self._euler_free_surface(
            s, u_e, v_e, Gu_eff, Gv_eff, Geta_eff, dt, sig_u, sig_v)
        if self.zstar:
            tracers = {n: s.tracers[n] + dtf * Gt_eff[n] / sig_n
                       for n in self.tracer_names}
            # the columns stretched from σⁿ to σⁿ⁺¹: ∫ σ q dV is kept
            ratio = sig_n / self._sigma_field(eta)
            sig_u1, sig_v1 = self._sigma_faces(eta)
            u = u * (sig_u / sig_u1)
            v = v * (sig_v / sig_v1)
            tracers = {n: c * ratio for n, c in tracers.items()}
        else:
            tracers = {n: s.tracers[n] + dtf * Gt_eff[n]
                       for n in self.tracer_names}
        u, v, tracers = self._implicit_step(u, v, tracers, diff, dt)
        s = _replace(s, u=u, v=v, eta=eta, U=U, V=V, tracers=tracers,
                     Gu=Gu, Gv=Gv, Geta=Geta, Gtracers=Gt,
                     clock=tick(s.clock, dt))
        s = self._apply_corner_filter(s)
        return self.fill_state_halos(s)

    def _rk3_step(self, state, dt, assume_filled=False):
        """SSP (Shu-Osher) RK3: each stage a full-Δt Euler substage with
        its own free-surface step, convex-combined with Ψⁿ, then the
        closure's implicit vertical solve over γΔt."""
        dtf = dt.item()
        psi = (state.u, state.v, state.eta,
               {n: state.tracers[n] for n in self.tracer_names},
               state.U, state.V)
        s = state
        for stage, (gamma, zeta_c) in enumerate((
                (1.0, 0.0), (0.25, 0.75), (2.0 / 3.0, 1.0 / 3.0))):
            if stage > 0 or not assume_filled:
                s = self.fill_state_halos(s)
            Gu, Gv, Geta, Gt, diff = self.compute_tendencies(s)
            u_e = s.u + dtf * Gu
            v_e = s.v + dtf * Gv
            u_e, v_e, eta_e, U_e, V_e = self._euler_free_surface(
                s, u_e, v_e, Gu, Gv, Geta, dt)
            u = zeta_c * psi[0] + gamma * u_e
            v = zeta_c * psi[1] + gamma * v_e
            tracers = {n: zeta_c * psi[3][n]
                       + gamma * (s.tracers[n] + dtf * Gt[n])
                       for n in self.tracer_names}
            u, v, tracers = self._implicit_step(u, v, tracers, diff,
                                                gamma * dt)
            s = _replace(s, u=u, v=v,
                         eta=zeta_c * psi[2] + gamma * eta_e,
                         U=zeta_c * psi[4] + gamma * U_e,
                         V=zeta_c * psi[5] + gamma * V_e,
                         tracers=tracers)
        s = _replace(s, clock=tick(s.clock, dt))
        s = self._apply_corner_filter(s)
        return self.fill_state_halos(s)

    def _apply_corner_filter(self, s):
        if self.corner_filter is None or self.prescribed_velocities:
            return s
        # filter on filled halos; the caller's exchange fills them again
        s = self.fill_state_halos(s)
        dtype = s.u.dtype
        frac = self._frac("c", dtype)
        eta = _corner_smooth_center(self, s.eta)
        if frac is None and not self.zstar:
            tracers = {n: _corner_smooth_center(self, c)
                       for n, c in s.tracers.items()}
        else:
            # a cell holds σ·frac of a cell's content: smooth the content
            # and divide by the thickness of the smoothed η, so Σ Az dz σ
            # frac c is kept (η is the σ carrier, and Σ Az η is kept)
            sig, sig_f = ((self._sigma_field(s.eta), self._sigma_field(eta))
                          if self.zstar else (1.0, 1.0))
            if frac is not None:
                sig, sig_f = sig * frac, sig_f * frac
            tracers = {n: _corner_smooth_center(self, c * sig) / sig_f
                       for n, c in s.tracers.items()}
        return _replace(
            s,
            u=_corner_smooth_velocity(self, s.u,
                                      self._dev("_cf_mask_u", dtype)),
            v=_corner_smooth_velocity(self, s.v,
                                      self._dev("_cf_mask_v", dtype)),
            eta=eta, tracers=tracers)

    # ------------------------------------------------------------------
    def cfl_timescale(self, state):
        """min over the panels of Δ/|u| (for ``TimeStepWizard``)."""
        return cell_advection_timescale(self.grid.panel_grid, state.u,
                                        state.v,
                                        self._panel_w(state.u, state.v))

    def total_volume(self, state):
        g = self.grid.panel_grid
        sx, sy, _ = g.interior_slices
        Az = g.Az(Center, Center)[sx, sy, :1]
        return torch.sum(state.eta[:, sx, sy, :] * Az)

    def _cell_volumes(self):
        g = self.grid.panel_grid
        sx, sy, sz = g.interior_slices
        return (g.Az(Center, Center)[sx, sy, :1]
                * g.dz(Center).expand(g.shape)[sx, sy, sz])

    def total_tracer(self, state, name):
        g = self.grid.panel_grid
        sx, sy, sz = g.interior_slices
        c = state.tracers[name][:, sx, sy, sz]
        if self.zstar:
            # the conserved content is ∫ σ c dV
            c = c * self._sigma_field(state.eta)[:, sx, sy, :]
        if self._wet_c is not None:
            c = c * self._dev("_wet_c", c.dtype)[:, sx, sy, sz]
        if self._frac_c is not None:
            # partial bottom cells hold only their water fraction
            c = c * self._dev("_frac_c", c.dtype)[:, sx, sy, sz]
        return torch.sum(c * self._cell_volumes())

    def ocean_volume(self):
        """Total wet volume (the conservation budget's denominator)."""
        g = self.grid.panel_grid
        sx, sy, sz = g.interior_slices
        dV = self._cell_volumes()
        if self._wet_c is None:
            return 6.0 * torch.sum(dV)
        w = self._dev("_wet_c", dV.dtype)[:, sx, sy, sz]
        if self._frac_c is not None:
            w = w * self._dev("_frac_c", dV.dtype)[:, sx, sy, sz]
        return torch.sum(w * dV)

    def __repr__(self):
        return (f"CubedSphereHydrostaticModel(N={self.grid.N_panel}, "
                f"Nz={self.grid.panel_grid.N[2]})")


def cubed_sphere_partition(dist=None, R=1, panels=6):
    """The panel axis (and, with ``R > 1``, an ``R × R`` block grid within
    each panel) over the ranks of a ``torch.distributed`` group (the
    reference's ``CubedSpherePartition(R=...)``: R ranks a panel dimension,
    ``panels · R²`` ranks). ``panels`` divides 6: how many ways the panel
    axis is split. ``dist`` is the rank's ``parallel.Distributed`` (its
    partition is not used), or None for the default group.

    Returns ``(layout, shard_state)``: ``layout`` maps every rank to its
    ``(panel group, bx, by)`` and gives this rank's ``coords``; ``shard_state``
    takes a stacked state and returns this rank's even slab of every
    leading-6 tensor (its panels, and its block of each halo-extended panel
    frame), the layout the JAX package's ``("panel", "x", "y")`` sharding
    gives. The explicit-halo distributed models, whose blocks carry their
    own halo rings, are ``parallel.CubedSphereDistributedSW`` and
    ``CubedSphereDistributedHydrostatic``."""
    import torch.distributed as tdist

    from oceananigans_torch.parallel.distributed import _map_tensors
    need = panels * R * R
    if 6 % panels:
        raise ValueError(f"panels={panels} must divide 6")
    if dist is not None:
        rank, world = dist.rank, dist.world_size
    elif tdist.is_available() and tdist.is_initialized():
        rank, world = tdist.get_rank(), tdist.get_world_size()
    else:
        rank, world = 0, 1
    if world != need:
        raise ValueError(f"cubed_sphere_partition(R={R}, panels={panels}) "
                         f"needs {need} ranks (got {world})")
    coords = {r: (r // (R * R), (r // R) % R, r % R) for r in range(need)}
    layout = {"R": R, "panels": panels, "ranks": coords,
              "coords": coords[rank]}
    pg, bx, by = coords[rank]
    p_loc = 6 // panels

    def shard_state(state):
        def put(a):
            if a.ndim < 1 or a.shape[0] != 6:
                return a
            a = a[pg * p_loc:(pg + 1) * p_loc]
            if R > 1:
                nx, ny = a.shape[1] // R, a.shape[2] // R
                a = a[:, bx * nx:(bx + 1) * nx, by * ny:(by + 1) * ny]
            return a
        return _map_tensors(state, put)

    return layout, shard_state
