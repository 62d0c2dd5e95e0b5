"""The WENO-5 tendency kernels (7 and 9) on the closure paths' layout, and
the models with closures and valued boundary conditions, on the card.

Kernels 7 and 9 run at a ragged (Periodic, Periodic, Bounded) layout with
halos on y and z and a Bounded z filled by ValueBC and GradientBC
conditions, against their plain versions; the phase-12 and phase-13
configurations of ``chip_smoke.py`` at small sizes run their kernel paths
on the card against their plain paths on the CPU.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_closures_gpu.py -m gpu

Tolerances, relative to the largest plain value: 1e-12 in float64; in
float32, the kernels' bound of ``chip_smoke.py`` (1e-5).
"""

import math

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.boundary_conditions import (
    regularize_field_boundary_conditions,
)
from oceananigans_torch.ops import cuda_weno as cw
from oceananigans_torch.ops.operators import ddz_f

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
PPB = (ot.Periodic, ot.Periodic, ot.Bounded)


def filled_fields(size, dtype):
    """Random u, v, w, T and S on a ragged layout, their halos filled with
    a ValueBC top and bottom on u, a GradientBC bottom and a ValueBC top
    on T, a GradientBC on S and the impenetrable wall on w."""
    grid = ot.RectilinearGrid(size=size, x=(0.0, 1.0), y=(0.0, 2.0),
                              z=(-0.5, 0.0), topology=PPB, halo=(3, 3, 3),
                              dtype=dtype, device="cuda")
    bcs = {"u": ot.FieldBoundaryConditions(top=ot.ValueBC(0.1),
                                           bottom=ot.ValueBC(0.0)),
           "v": None, "w": None,
           "T": ot.FieldBoundaryConditions(top=ot.ValueBC(20.0),
                                           bottom=ot.GradientBC(0.01)),
           "S": ot.FieldBoundaryConditions(bottom=ot.GradientBC(-0.02))}
    locs = {"u": ot.LOC_U, "v": ot.LOC_V, "w": ot.LOC_W, "T": ot.LOC_C,
            "S": ot.LOC_C}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, loc in locs.items():
        a = torch.randn(grid.shape, generator=gen, device="cuda",
                        dtype=dtype)
        b = regularize_field_boundary_conditions(bcs[name], grid, loc)
        out[name] = ot.fill_halo_regions(a, grid, b, loc)
    return grid, out


def assert_match(got, ref, dtype):
    scale = max(float(r.abs().max()) for r in ref)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [(37, 21, 19), (10, 9, 70)])
def test_weno5_tendency_kernels_on_bounded_z(size, dtype):
    """Kernel 7 (momentum) and kernel 9 (two tracers) read the filled y and
    z halos, the value and gradient halos of the Bounded z among them,
    as their plain versions do."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    grid, f = filled_fields(size, dtype)
    u, v, w = f["u"], f["v"], f["w"]
    tr = {"T": f["T"], "S": f["S"]}
    n7 = cw.weno5_momentum_tendency.launches
    n9 = cw.weno5_tracer_tendencies.launches
    got7 = cw.weno5_momentum_tendency(grid, u, v, w)
    got9 = cw.weno5_tracer_tendencies(grid, u, v, w, tr)
    torch.cuda.synchronize()
    assert cw.weno5_momentum_tendency.launches == n7 + 1
    assert cw.weno5_tracer_tendencies.launches == n9 + 1
    assert_match(got7, cw.weno5_momentum_tendency_plain(grid, u, v, w),
                 dtype)
    assert_match(list(got9.values()),
                 list(cw.weno5_tracer_tendencies_plain(grid, u, v, w,
                                                       tr).values()), dtype)


def les(device, N=12):
    """Phase 12's configuration (``chip_smoke.les_model``) at N³ in
    float64."""
    grid = ot.RectilinearGrid(size=(N, N, N), x=(0.0, 64.0), y=(0.0, 64.0),
                              z=(-32.0, 0.0), topology=PPB, halo=(3, 3, 3),
                              dtype=torch.float64, device=device)
    model = ot.NonhydrostaticModel(
        grid=grid, advection=ot.WENO(5),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState(
                thermal_expansion=2e-4), constant_salinity=35.0),
        closure=ot.SmagorinskyLilly(),
        boundary_conditions={
            "T": ot.FieldBoundaryConditions(
                top=ot.FluxBC(200.0 / (1026.0 * 3991.0)),
                bottom=ot.GradientBC(0.01)),
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(6.2e-5))},
        timestepper="QuasiAdamsBashforth2")
    u = 1e-4 * np.random.default_rng(0).standard_normal((N, N, N))
    return model, model.initial_state(T=lambda x, y, z: 20.0 + 0.01 * z,
                                      u=u)


@pytest.mark.gpu
def test_les_on_card_matches_cpu():
    """The LES's kernel path on the card (kernels 7 and 9 once a step, no
    fused AB2 kernel) against the plain path on the CPU, 3 steps; the
    velocities relative to Δt·max|∂z p|, the hydrostatic balance they are
    the residual of."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    (mk, sk), (mp, sp) = les("cuda"), les("cpu")
    assert mk.fused_kernels == "weno5" and not mk.fused_ab2_weno_science
    n7 = cw.weno5_momentum_tendency.launches
    for _ in range(3):
        sk, sp = mk.step(sk, 1.0), mp.step(sp, 1.0)
    assert cw.weno5_momentum_tendency.launches == n7 + 3
    g = mp.grid
    dpdz = g.interior(ddz_f(g, sp.pressure))[:, :, 1:]
    scale = max(float(g.interior(sp.u).abs().max()),
                float(dpdz.abs().max()))
    for a, b in ((sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w)):
        assert float((g.interior(a).cpu() - g.interior(b)).abs().max()) \
            <= 1e-12 * scale
    T = g.interior(sp.tracers["T"])
    assert float((g.interior(sk.tracers["T"]).cpu() - T).abs().max()) \
        <= 1e-12 * float(T.abs().max())


@pytest.mark.gpu
def test_hydro_closure_on_card_matches_cpu():
    """Phase 13's configuration (closures, the callable wind stress, the
    array T flux) at (36, 14, 6): the kernel path on the card against the
    plain path on the CPU, 3 steps, in float64."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    states = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(
            size=(36, 14, 6), extent=(4e7, 2e7, 4e3),
            topology=(ot.Periodic, ot.Bounded, ot.Bounded), halo=(6, 6, 4),
            dtype=torch.float64, device=device)
        flux = np.zeros(tuple(grid.shape[:2]) + (1,))
        flux[6:-6, 6:-6, 0] = 1e-5 * np.random.default_rng(0).standard_normal(
            (36, 14))
        model = ot.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=ot.WENOVectorInvariant(),
            tracer_advection=ot.WENO(7), tracers=("T", "S"),
            closure=(ot.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                     ot.VerticalScalarDiffusivity(
                         nu=1e-3, kappa=1e-5, time_discretization=(
                             ot.VerticallyImplicitTimeDiscretization))),
            boundary_conditions={
                "u": ot.FieldBoundaryConditions(top=ot.FluxBC(
                    lambda x, y, t: -1e-4 * torch.cos(math.pi * y / 2e7))),
                "T": ot.FieldBoundaryConditions(top=ot.FluxBC(flux))})
        assert model.fused_kernels == (device == "cuda")
        s = model.initial_state(
            u=lambda x, y, z: 0.1 * torch.sin(2 * math.pi * x / 4e7 + 0.5)
            * torch.cos(math.pi * y / 2e7 + 0.2) + 0.01,
            v=lambda x, y, z: 0.05 * torch.cos(2 * math.pi * x / 4e7 + 0.3)
            * torch.sin(math.pi * y / 2e7),
            T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y,
            S=lambda x, y, z: 35.0 + 1e-8 * y)
        for _ in range(3):
            s = model.step(s, 60.0)
        states[device] = (grid, s)
    (gk, sk), (gp, sp) = states["cuda"], states["cpu"]
    for a, b in ((sk.u, sp.u), (sk.v, sp.v), (sk.tracers["T"],
                                              sp.tracers["T"]),
                 (sk.tracers["S"], sp.tracers["S"])):
        ref = gp.interior(b)
        assert float((gk.interior(a).cpu() - ref).abs().max()) \
            <= 1e-12 * float(ref.abs().max())
