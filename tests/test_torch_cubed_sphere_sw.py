"""oceananigans_torch's cubed-sphere shallow-water model against the JAX
package's, on the CPU in float64 at C8: Williamson 2 for 10 steps against
the golden ``tests/golden/cubed_sphere_w2.npz`` (atol 1e-12, as
``tests/test_regression.py`` holds the JAX model); and 3 steps of each
``vorticity_scheme``, WENO(5) and UpwindBiased(3) tracers under prescribed
velocities (Williamson 1), the bathymetry of Williamson 5 and the corner
filter, each held to the JAX step within 1e-12 of each field's largest
value. The JAX runs are shared through module-scoped fixtures; the WENO
tracer case steps the JAX model eagerly (jitted JAX reorders the WENO
weights' rounding).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.interop import (
    grid_from_arguments, state_from_numpy, state_to_numpy,
)
from oceananigans_torch.models import cubed_sphere as tcs
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection import UpwindBiased as JUpwindBiased
from oceananigans_tpu.grids import cubed_sphere_grid as jcg
from oceananigans_tpu.models import cubed_sphere as jcs

RTOL = 1e-12
GOLDEN = Path(__file__).parent / "golden" / "cubed_sphere_w2.npz"
A, OMEGA, GACC = 6.37122e6, 7.292e-5, 9.80616
U0 = 2 * np.pi * A / (12.0 * 86400)
H0 = 2.94e4 / GACC


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def grids(N=8, radius=A):
    kw = dict(panel_size=(N, 1), z=(-1.0, 0.0), radius=radius, halo=3,
              dtype="float64")
    return jcg.ConformalCubedSphereGrid(**kw), grid_from_arguments(
        "cubed_sphere", **kw)


def zonal(P):
    return np.cross(np.array([0.0, 0.0, U0 / A]), P * A)


def h_w2(lam, phi, z):
    s = np.sin(np.deg2rad(phi))
    return H0 - (A * OMEGA * U0 + 0.5 * U0 ** 2) * s ** 2 / GACC + 0 * z


def assert_close(got, ref, rtol=RTOL, name=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    gap = float(np.abs(got - ref).max())
    assert gap <= rtol * scale, (name, gap, scale)


def assert_states_close(sj, st):
    for name in ("u", "v", "h"):
        assert_close(getattr(st, name), getattr(sj, name), name=name)
    for name in sj.tracers:
        assert_close(st.tracers[name], sj.tracers[name], name=name)


def run_jax(model, state, dt, n, eager=False):
    step = (lambda s: model.step(s, dt)) if eager else jax.jit(
        lambda s: model.step(s, dt))
    for _ in range(n):
        state = step(state)
    return state


def run_port(model, state, dt, n):
    for _ in range(n):
        state = model.step(state, dt)
    return state


# ---------------------------------------------------------------------------
# Williamson 2 against the golden
# ---------------------------------------------------------------------------

def w2_port(**kw):
    _, tg = grids()
    model = ot.CubedSphereShallowWaterModel(
        tg, gravitational_acceleration=GACC, rotation_rate=OMEGA, **kw)
    u, v = tcs.panel_vector_components(tg, zonal)
    return model, model.initial_state(u=u, v=v, h=tg.set_tracer(h_w2))


def test_williamson2_golden():
    model, state = w2_port()
    mass0 = float(model.total_mass(state))
    state = run_port(model, state, 600.0, 10)
    with np.load(GOLDEN) as golden:
        for name in golden.files:
            got = getattr(state, name).numpy()
            gap = float(np.abs(got - golden[name]).max())
            print(f"Williamson 2, {name}: max|port - golden| = {gap:.3e}")
            np.testing.assert_allclose(got, golden[name], atol=1e-12,
                                       rtol=0)
    assert abs(float(model.total_mass(state)) - mass0) <= 1e-13 * mass0


# ---------------------------------------------------------------------------
# 3-step parity with the JAX step
# ---------------------------------------------------------------------------

def perturbation(tg, seed):
    """A seeded perturbation of h's interior (≈ 1 m)."""
    g = tg.panel_grid
    H, N = g.H[0], tg.N_panel
    p = np.zeros((6, *g.shape[:2], 1))
    p[:, H:H + N, H:H + N, 0] = np.random.default_rng(seed).standard_normal(
        (6, N, N))
    return p


@pytest.fixture(scope="module")
def scheme_runs():
    """Williamson 2 plus a seeded h perturbation, 3 steps of each
    vorticity scheme in both packages."""
    out = {}
    for k, scheme in enumerate(("hybrid_upwind", "upwind",
                                "energy_conserving")):
        jg, tg = grids()
        kw = dict(gravitational_acceleration=GACC, rotation_rate=OMEGA,
                  vorticity_scheme=scheme)
        mj = jcs.CubedSphereShallowWaterModel(jg, **kw)
        mt = ot.CubedSphereShallowWaterModel(tg, **kw)
        pert = perturbation(tg, k)
        uj, vj = jcs.panel_vector_components(jg, zonal)
        sj = mj.initial_state(u=uj, v=vj, h=jg.set_tracer(h_w2))
        sj = mj.fill_state_halos(dataclasses.replace(sj, h=sj.h + pert))
        ut, vt = tcs.panel_vector_components(tg, zonal)
        st = mt.initial_state(u=ut, v=vt, h=tg.set_tracer(h_w2))
        arrays = state_to_numpy(st)
        arrays["h"] = arrays["h"] + pert
        st = mt.fill_state_halos(state_from_numpy(mt, arrays))
        out[scheme] = (run_jax(mj, sj, 600.0, 3), run_port(mt, st, 600.0, 3))
    return out


@pytest.mark.parametrize("scheme", ["hybrid_upwind", "upwind",
                                    "energy_conserving"])
def test_vorticity_schemes_match_jax(scheme_runs, scheme):
    sj, st = scheme_runs[scheme]
    assert_states_close(sj, st)
    assert st.clock.iteration == 3
    assert float(st.clock.time) == float(sj.clock.time)
    for name in ("Gu", "Gv", "Gh"):
        assert_close(getattr(st, name), getattr(sj, name), name=name)


def bell(lam, phi, z):
    lam0, R = np.deg2rad(270.0), 1.0 / 3.0
    lam, phi = np.deg2rad(lam), np.deg2rad(phi)
    r = np.arccos(np.clip(np.cos(phi) * np.cos(lam - lam0), -1, 1))
    return np.where(r < R, 0.5 * (1 + np.cos(np.pi * r / R)), 0.0) + 0 * z


@pytest.fixture(scope="module")
def tracer_runs():
    """Williamson 1 at C8 on the unit sphere: a cosine bell under a
    solid-body rotation tilted 45°, velocities prescribed, 3 steps."""
    alpha = np.deg2rad(45.0)
    axis = np.array([-np.sin(alpha), 0.0, np.cos(alpha)]) * 2 * np.pi / 12

    def rotation(P):
        return np.cross(axis, P)

    out = {}
    for name, jscheme, tscheme in (
            ("WENO(5)", JWENO(5), ot.WENO(5)),
            ("UpwindBiased(3)", JUpwindBiased(3), ot.UpwindBiased(3))):
        jg, tg = grids(radius=1.0)
        kw = dict(tracers=("c",), prescribed_velocities=True,
                  rotation_rate=0.0)
        mj = jcs.CubedSphereShallowWaterModel(jg, tracer_advection=jscheme,
                                              **kw)
        mt = ot.CubedSphereShallowWaterModel(tg, tracer_advection=tscheme,
                                             **kw)
        uj, vj = jcs.panel_vector_components(jg, rotation)
        ut, vt = tcs.panel_vector_components(tg, rotation)
        sj = mj.initial_state(u=uj, v=vj, h=1.0, c=bell)
        st = mt.initial_state(u=ut, v=vt, h=1.0, c=bell)
        out[name] = (mj, mt, sj, st,
                     run_jax(mj, sj, 0.04, 3, eager=name.startswith("WENO")),
                     run_port(mt, st, 0.04, 3))
    return out


@pytest.mark.parametrize("scheme", ["WENO(5)", "UpwindBiased(3)"])
def test_prescribed_tracers_match_jax(tracer_runs, scheme):
    mj, mt, sj0, st0, sj, st = tracer_runs[scheme]
    assert_states_close(sj, st)
    # the velocities and the depth stay as they were
    for name in ("u", "v", "h"):
        assert torch.equal(getattr(st, name), getattr(st0, name))
    m0 = float(mt.total_tracer(st0, "c"))
    assert abs(float(mt.total_tracer(st, "c")) - m0) <= 1e-13 * m0
    assert abs(float(mt.total_tracer(st, "c"))
               - float(mj.total_tracer(sj, "c"))) <= 1e-13 * m0


def mountain(lam, phi):
    """Williamson 5's conical mountain (2000 m, radius π/9, at 90°W
    30°N)."""
    R = np.pi / 9
    dlam = np.deg2rad((lam + 90.0 + 180.0) % 360.0 - 180.0)
    dphi = np.deg2rad(phi - 30.0)
    return 2000.0 * (1.0 - np.minimum(R, np.sqrt(dlam ** 2 + dphi ** 2)) / R)


def w5_h(lam, phi, z):
    s = np.sin(np.deg2rad(phi))
    return 5960.0 - (A * OMEGA * 20.0 + 0.5 * 20.0 ** 2) * s ** 2 / GACC \
        + 0 * z


def w5_zonal(P):
    return np.cross(np.array([0.0, 0.0, 20.0 / A]), P * A)


@pytest.mark.parametrize("case", ["bathymetry", "corner_filter"])
def test_bathymetry_and_corner_filter_match_jax(case):
    """Williamson 5 (flow over the mountain, h the fluid depth) and
    Williamson 2 with the corner-band filter (0.005), 3 steps each."""
    jg, tg = grids()
    kw = dict(gravitational_acceleration=GACC, rotation_rate=OMEGA)
    if case == "bathymetry":
        mj = jcs.CubedSphereShallowWaterModel(jg, bathymetry=mountain, **kw)
        mt = ot.CubedSphereShallowWaterModel(tg, bathymetry=mountain, **kw)
        assert_close(mt.hs, mj.hs, name="hs")
        uj, vj = jcs.panel_vector_components(jg, w5_zonal)
        ut, vt = tcs.panel_vector_components(tg, w5_zonal)
        hj = jg.set_tracer(w5_h) - np.asarray(mj.hs)
        ht = tg.set_tracer(w5_h) - mt.hs
        dt = 450.0
    else:
        mj = jcs.CubedSphereShallowWaterModel(jg, corner_filter=0.005, **kw)
        mt = ot.CubedSphereShallowWaterModel(tg, corner_filter=0.005, **kw)
        uj, vj = jcs.panel_vector_components(jg, zonal)
        ut, vt = tcs.panel_vector_components(tg, zonal)
        hj, ht = jg.set_tracer(h_w2), tg.set_tracer(h_w2)
        dt = 600.0
    sj = run_jax(mj, mj.initial_state(u=uj, v=vj, h=hj), dt, 3)
    st0 = mt.initial_state(u=ut, v=vt, h=ht)
    st = run_port(mt, st0, dt, 3)
    assert_states_close(sj, st)
    m0 = float(mt.total_mass(st0))
    assert abs(float(mt.total_mass(st)) - m0) <= 1e-13 * m0


def test_simulation_runs_shallow_water():
    """``Simulation`` drives the cube's shallow water (a step with no
    ``assume_filled``) bit for bit as the bare loop, its windows aligned on
    a ``TimeInterval``."""
    model, state = w2_port()
    bare = run_port(model, state, 200.0, 10)
    sim = ot.Simulation(model, state=state, dt=200.0, stop_time=2000.0)
    ticks = []
    sim.callbacks["t"] = ot.Callback(
        lambda s: ticks.append(float(s.state.clock.time)),
        ot.TimeInterval(1000.0))
    sim.run()
    assert sim.state.clock.iteration == 10
    assert any(abs(t - 1000.0) < 1e-6 for t in ticks)
    for name in ("u", "v", "h"):
        assert torch.equal(getattr(sim.state, name), getattr(bare, name))


def test_unknown_vorticity_scheme_raises():
    _, tg = grids()
    with pytest.raises(ValueError, match="vorticity_scheme"):
        ot.CubedSphereShallowWaterModel(tg, vorticity_scheme="centered")
