"""Forcings, Stokes drift, biogeochemistry, particles and the ocean closures
on the card: the kernel paths on the card against the plain paths on the
CPU, in float64 to 1e-12.

The Langmuir configuration of ``chip_smoke.py`` phase 21 (kernels 7 and 9,
a growing and sinking tracer, particles tracking b), the ``weno`` cell
with a sponge (kernels 7 and 9 under ``Relaxation`` forcings), CATKE in
phase 22's lat-lon ocean (kernels 11 and 12/13, the TKE through the
tracer kernel), and a field time series forcing, whose step makes no host
synchronization for it. These tests need a CUDA device and skip without
one. They import nothing of JAX, so they also run on a machine without
it:

    python -m pytest --noconftest tests/test_torch_physics_gpu.py -m gpu
"""

import math

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.interop import flatten_state, unflatten_state
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi
from oceananigans_torch.ops import cuda_weno as cw
from oceananigans_torch.profile_step import (
    hydro_catke_model, hydro_latlon_initial_state, langmuir_initial_state,
    langmuir_model, langmuir_particles,
)

RTOL = 1e-12


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def assert_states_close(card, cpu, grid, rtol=RTOL):
    """The card's state (copied to the host) against the CPU's on the
    interior (the kernels leave the tendencies' halo rows as their plain
    versions do not): u, v and w within ``rtol`` of their largest value,
    each tracer, η and each particle array of its own."""
    got = unflatten_state(cpu, flatten_state(card))
    ii = grid.interior_slices
    groups = [[(getattr(got, n)[ii], getattr(cpu, n)[ii])
               for n in ("u", "v", "w")]]
    groups += [[(got.tracers[n][ii], c[ii])] for n, c in cpu.tracers.items()]
    if hasattr(cpu, "eta"):
        groups.append([(got.eta[ii[:2]], cpu.eta[ii[:2]])])
    if getattr(cpu, "particles", None) is not None:
        p, q = got.particles, cpu.particles
        groups += [[(getattr(p, n), getattr(q, n))] for n in "xyz"]
        groups += [[(p.properties[k], v)] for k, v in q.properties.items()]
    for pairs in groups:
        scale = max(max(float(b.abs().max()) for _, b in pairs), 1e-300)
        err = max(float((a - b).abs().max()) for a, b in pairs)
        assert err <= rtol * scale, (err, scale)


@pytest.mark.gpu
def test_langmuir_on_card_matches_cpu():
    """Phase 21's Langmuir LES at 16³ with 2048 particles: kernels 7 and 9
    once a step on the card, 4 AB2 steps, against the plain path on the
    CPU."""
    needs_card()
    states = {}
    n7 = cw.weno5_momentum_tendency.launches
    for device in ("cuda", "cpu"):
        model = langmuir_model(size=(16, 16, 16), dtype=torch.float64,
                               device=device, fused=device == "cuda",
                               particles=langmuir_particles(2048))
        s = langmuir_initial_state(model)
        for _ in range(4):
            s = model.step(s, 0.5)
        states[device] = s
    assert cw.weno5_momentum_tendency.launches == n7 + 4
    assert_states_close(states["cuda"], states["cpu"], model.grid)


@pytest.mark.gpu
def test_sponge_on_card_matches_cpu():
    """``Relaxation`` sponges of u and T masked by a ``GaussianMask`` on the
    ``weno`` layout at 24³: kernels 7 and 9 on the card, the fused AB2
    kernels refused, 3 steps against the CPU."""
    needs_card()
    states = {}
    mask = ot.GaussianMask(1.0, 0.05, coordinate="x")
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(
            size=(24, 24, 24), extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=(3, 0, 0),
            dtype=torch.float64, device=device)
        model = ot.NonhydrostaticModel(
            grid=grid, advection=ot.WENO(5), tracers=("T", "S"),
            timestepper="QuasiAdamsBashforth2",
            fused_kernels=device == "cuda",
            forcing={"u": ot.Relaxation(100.0, mask=mask),
                     "T": ot.Relaxation(100.0, mask=mask,
                                        target=ot.LinearTarget(0.0, 0.01))})
        assert not model.fused_ab2_weno_science
        assert (model.fused_kernels == "weno5") == (device == "cuda")
        s = model.initial_state(
            u=lambda x, y, z: 0.01 * torch.sin(8 * math.pi * x)
            * torch.cos(6 * math.pi * y),
            T=lambda x, y, z: 0.01 * z + 0.001 * torch.cos(2 * math.pi * y))
        for _ in range(3):
            s = model.step(s, 1e-4)
        states[device] = s
    assert_states_close(states["cuda"], states["cpu"], model.grid)


@pytest.mark.gpu
def test_catke_latlon_on_card_matches_cpu():
    """Phase 22's CATKE ocean on the (24, 16, 8) lat-lon sector: kernels 11
    (T, S and e) and 12/13 on the card, 3 steps against the CPU."""
    needs_card()
    states = {}
    n11 = ctr.weno_tracer_tendencies.launches
    n12 = cvi.vi_momentum_tendency.launches
    for device in ("cuda", "cpu"):
        model = hydro_catke_model("auto", torch.float64, device,
                                  size=(24, 16, 8), longitude=(-30.0, 30.0),
                                  latitude=(15.0, 55.0), halo=6)
        assert model.fused_tracer == model.fused_kernels == (
            device == "cuda")
        s = hydro_latlon_initial_state(model, generic=True)
        for _ in range(3):
            s = model.step(s, 60.0)
        states[device] = s
    assert ctr.weno_tracer_tendencies.launches == n11 + 3
    assert cvi.vi_momentum_tendency.launches == n12 + 3
    assert_states_close(states["cuda"], states["cpu"], model.grid)


@pytest.mark.gpu
def test_time_series_forcing_makes_no_host_sync():
    """A field time series forcing on the card: the step's forcing term
    reads the host clock and the series' host times, and launches its
    blend with no host synchronization (torch's sync debug mode); its term
    equals the CPU's."""
    needs_card()
    import warnings

    class Series:
        times = np.array([0.0, 1.0, 2.0])
        data = np.random.default_rng(0).standard_normal((3, 8, 8, 8))

    terms = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device=device)
        model = ot.NonhydrostaticModel(grid=grid, tracers=("c",),
                                       forcing={"c": Series()})
        s = model.initial_state()
        s = model.step(s, 0.3)
        f = model.forcings["c"]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    term = f(grid, s.clock.time, s.fields())
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert not [w for w in caught if "synchroniz" in str(w.message)]
            terms[device] = term.cpu()
        else:
            terms[device] = f(grid, s.clock.time, s.fields())
    assert torch.equal(terms["cuda"], terms["cpu"])
