"""oceananigans_torch's shallow-water model and its stage kernel
(``sw_rk3_stage``) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; model
runs start from the JAX package's initial state, carried across with
``oceananigans_torch.interop``. Tolerances:

- the model, step for step, against the JAX model's XLA path in float64:
  1e-12 of each field's largest value; both evaluate the same whole-array
  formulas;
- the stage kernel's plain version against the JAX XLA stage in float64:
  1e-12 of each field's largest value;
- the port's kernel code path (``fused_kernels=True``: on the CPU, the
  plain version) against the JAX kernel in interpret mode over 4 steps, at
  the JAX package's own bound (``tests/test_ensemble_and_pallas.py::
  test_fused_sw_rk3_stage_matches_plain``): 1e-9 absolute in float64,
  against h ~ 1e3;
- the physics checks of ``tests/test_shallow_water.py``, cut to fewer
  steps, at that file's tolerances.

Only interior points are compared.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.fields import field_integral
from oceananigans_torch.interop import (
    SW_FIELDS, state_from_numpy, state_to_numpy, tracer_keys,
)
from oceananigans_torch.models.hydrostatic import VectorInvariant
from oceananigans_torch.ops import cuda_sw
from oceananigans_tpu.models import ShallowWaterModel as JModel

F64 = torch.float64
G = 9.80665
PPF = (oj.Periodic, oj.Periodic, oj.Flat)
PBF = (oj.Periodic, oj.Bounded, oj.Flat)
CONS, VI = "conservative", "vector_invariant"


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


def jax_state_to_numpy(s):
    out = {name: np.asarray(getattr(s, name)) for name in SW_FIELDS}
    for group in ("tracers", "Gtracers"):
        for n, a in getattr(s, group).items():
            out[f"{group}/{n}"] = np.asarray(a)
    out.update(time=np.asarray(s.clock.time),
               iteration=int(s.clock.iteration),
               last_dt=np.asarray(s.clock.last_dt))
    return out


def assert_close(grid, got, ref, names, rtol=1e-12):
    ii = grid.interior_slices
    for name in names:
        a, b = np.asarray(got[name])[ii], np.asarray(ref[name])[ii]
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The model against the JAX model
# ---------------------------------------------------------------------------

def bump(x, y):
    return 0.2 * np.exp(-((x - 5.0) ** 2 + (y - 4.0) ** 2) / 4.0)


#: name: (topology, halo, model keywords for either package, initial
#: fields as functions of interior x and y numpy coordinates, Δt)
CASES = {
    "conservative": (PPF, 3, lambda m: {}, ("uh", "vh"), 2e-3),
    "vector_invariant": (PPF, 3, lambda m: dict(formulation=VI),
                         ("u", "v"), 2e-3),
    "conservative_fplane_bathymetry": (
        PPF, 3, lambda m: dict(coriolis=m.FPlane(f=1.0),
                               bathymetry=lambda x, y: -0.1 + 0.05
                               * (x / 10.0) * (y / 10.0)),
        ("uh", "vh"), 2e-3),
    "vi_energy_fplane_bathymetry": (
        PPF, 3, lambda m: dict(
            formulation=VI, coriolis=m.FPlane(f=1.0),
            momentum_advection=m.VectorInvariant("energy_conserving"),
            bathymetry=lambda x, y: 0.05 * (x / 10.0) + 0.0 * y),
        ("u", "v"), 2e-3),
    "weno_momentum_beta_plane": (
        PPF, 3, lambda m: dict(momentum_advection=m.WENO(5),
                               coriolis=m.BetaPlane(f0=1.0, beta=0.1)),
        ("uh", "vh"), 2e-3),
    "tracers_centered": (
        PPF, 3, lambda m: dict(tracers=("c", "d"),
                               tracer_advection=m.Centered(2)),
        ("uh", "vh"), 2e-3),
    "tracers_weno": (
        PPF, 3, lambda m: dict(tracers=("c", "d"),
                               tracer_advection=m.WENO(5)),
        ("uh", "vh"), 2e-3),
    "bickley_centered": (
        PBF, 3, lambda m: dict(coriolis=m.FPlane(f=1.0),
                               gravitational_acceleration=G),
        ("uh", "vh"), 1e-2),
    "bickley_weno": (
        PBF, 3, lambda m: dict(coriolis=m.FPlane(f=1.0),
                               momentum_advection=m.WENO(5),
                               gravitational_acceleration=G),
        ("uh", "vh"), 1e-2),
}


def make_grid(pkg, topology, halo, dtype):
    if topology == PBF:
        kw = dict(size=(16, 12), x=(0.0, 4 * math.pi),
                  y=(-2 * math.pi, 2 * math.pi))
        topology = (pkg.Periodic, pkg.Bounded, pkg.Flat)
    else:
        kw = dict(size=(16, 12), x=(0.0, 10.0), y=(0.0, 8.0))
        topology = (pkg.Periodic, pkg.Periodic, pkg.Flat)
    return pkg.RectilinearGrid(topology=topology, halo=halo, dtype=dtype,
                               **kw)


def initial_values(case, grid, vel):
    """Interior numpy arrays of the initial fields."""
    x = np.asarray(grid.xC).ravel()[grid.interior_slices[0]][:, None]
    y = np.asarray(grid.yC).ravel()[grid.interior_slices[1]][None, :]
    rng = np.random.default_rng(7)
    shape = (x.shape[0], y.shape[1])
    if case.startswith("bickley"):
        H, U0 = 10.0, 1.0
        jet = U0 / np.cosh(y) ** 2 + 1e-2 * np.exp(-y ** 2) * np.cos(x)
        vals = {vel[0]: H * jet + 0 * x,
                "h": H - (U0 / G) * np.tanh(y) + 0 * x}
    else:
        vals = {"h": 1.0 + bump(x, y) + 0.01 * rng.standard_normal(shape),
                vel[0]: 0.1 * rng.standard_normal(shape),
                vel[1]: 0.1 * rng.standard_normal(shape)}
    for name in ("c", "d"):
        vals[name] = rng.standard_normal(shape)
    return {k: v[..., None] for k, v in vals.items()}


def run_pair(case, steps, fused=False):
    """The JAX XLA path and the port over ``steps`` steps from the same
    initial state; returns the port's model and both final states as
    numpy."""
    topology, halo, kwargs, vel, dt = CASES[case]
    jg = make_grid(oj, topology, halo, "float64")
    jm = JModel(grid=jg, **kwargs(oj))
    vals = initial_values(case, jg, vel)
    vals = {k: v for k, v in vals.items()
            if k in set(vel) | {"h"} | set(jm.tracer_names)}
    s = jm.initial_state(**vals)
    start = jax_state_to_numpy(s)
    for _ in range(steps):
        s = jm.step(s, dt)
    tg = make_grid(ot, topology, halo, F64)
    tm = ot.ShallowWaterModel(grid=tg, fused_kernels=fused,
                              **kwargs(ot))
    st = state_from_numpy(tm, start)
    for _ in range(steps):
        st = tm.step(st, dt)
    return tm, state_to_numpy(st), jax_state_to_numpy(s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case):
    """Three RK3 steps against the JAX model, 1e-12 of each field's largest
    value, for every field and tendency."""
    tm, got, ref = run_pair(case, 3)
    assert not tm.fused_rk3
    names = SW_FIELDS + tracer_keys(tm.tracer_names)
    assert_close(tm.grid, got, ref, names)
    assert got["iteration"] == ref["iteration"] == 3
    assert float(got["time"]) == float(ref["time"])


def test_tendencies_and_cfl_match_jax():
    """``compute_tendencies`` and ``cfl_timescale`` of one state, both
    formulations."""
    for case in ("conservative_fplane_bathymetry",
                 "vi_energy_fplane_bathymetry", "tracers_weno"):
        topology, halo, kwargs, vel, _ = CASES[case]
        jg = make_grid(oj, topology, halo, "float64")
        jm = JModel(grid=jg, **kwargs(oj))
        vals = initial_values(case, jg, vel)
        vals = {k: v for k, v in vals.items()
                if k in set(vel) | {"h"} | set(jm.tracer_names)}
        js = jm.initial_state(**vals)
        tm = ot.ShallowWaterModel(grid=make_grid(ot, topology, halo, F64),
                                  **kwargs(ot))
        ts = state_from_numpy(tm, jax_state_to_numpy(js))
        got = tm.compute_tendencies(ts)
        ref = jm.compute_tendencies(js)
        names = ("Guh", "Gvh", "Gh")
        assert_close(tm.grid, dict(zip(names, got[:3])),
                     dict(zip(names, ref[:3])), names)
        assert_close(tm.grid, got[3], ref[3], tm.tracer_names)
        np.testing.assert_allclose(float(tm.cfl_timescale(ts)),
                                   float(jm.cfl_timescale(js)), rtol=1e-12)


def test_interop_round_trip():
    tm, got, _ = run_pair("tracers_weno", 0)
    s = state_from_numpy(tm, got)
    assert list(s.tracers) == ["c", "d"]
    back = state_to_numpy(s)
    for key in SW_FIELDS + tracer_keys(tm.tracer_names):
        np.testing.assert_array_equal(back[key], got[key])
    with pytest.raises(KeyError):
        state_from_numpy(tm, {k: v for k, v in got.items() if k != "Gh"})


# ---------------------------------------------------------------------------
# The stage kernel
# ---------------------------------------------------------------------------

def kernel_grid(pkg, size=(48, 128), halo=(8, 0, 0), dtype="float64"):
    return pkg.RectilinearGrid(size=size, x=(0.0, 1e5), y=(0.0, 1e5),
                               topology=(pkg.Periodic, pkg.Periodic,
                                         pkg.Flat), halo=halo, dtype=dtype)


def kernel_init(xp, m):
    """The JAX package's stage-kernel test state."""
    sin, cos, pi = xp.sin, xp.cos, math.pi
    return m.initial_state(
        h=lambda x, y, z: 1000.0 + sin(2 * pi * x / 1e5)
        * cos(2 * pi * y / 1e5),
        uh=lambda x, y, z: 100.0 * cos(2 * pi * y / 1e5) + 0 * x,
        vh=lambda x, y, z: 50.0 * sin(2 * pi * x / 1e5) + 0 * y)


def test_stage_plain_matches_xla():
    """One stage (the second RK3 stage's coefficients, G⁻ nonzero): the
    plain version against the JAX model's XLA tendencies and update."""
    jg = kernel_grid(oj)
    jm = JModel(grid=jg, gravitational_acceleration=9.81)
    js = kernel_init(jnp, jm)
    rng = np.random.default_rng(1)
    Gm = [rng.standard_normal(jg.shape) for _ in range(3)]
    a, b = 5.0 / 12.0, -17.0 / 60.0
    ref_G = [np.asarray(g) for g in jm.compute_tendencies(js)[:3]]
    arrays = jax_state_to_numpy(js)
    ref_new = [arrays[n] + a * g + b * gm
               for n, g, gm in zip(("uh", "vh", "h"), ref_G, Gm)]
    tg = kernel_grid(ot, dtype=F64)
    t = [torch.tensor(arrays[n]) for n in ("uh", "vh", "h")]
    Gt = [torch.tensor(g) for g in Gm]
    ids = [id(g) for g in Gt]
    got = cuda_sw.sw_rk3_stage(tg, *t, *Gt, a, b, 9.81)
    names = ("uh", "vh", "h", "Guh", "Gvh", "Gh")
    assert_close(tg, dict(zip(names, got)),
                 dict(zip(names, ref_new + ref_G)), names)
    # G is written over G⁻ in place and keeps its x-halo rows; the new
    # fields are new tensors that copy the old x-halo rows
    assert [id(g) for g in got[3:]] == ids
    H = tg.H[0]
    for q, new, g, gm in zip(t, got[:3], got[3:], Gm):
        assert new is not q
        for rows in (slice(0, H), slice(-H, None)):
            assert torch.equal(new[rows], q[rows])
            np.testing.assert_array_equal(g[rows].numpy(), gm[rows])


@pytest.mark.parametrize("layout", ["jax", "halo3", "ragged"])
def test_kernel_path_matches_pallas_interpret(layout):
    """The JAX package's stage-kernel test: 4 steps of the float64 kernel
    path against the JAX kernel in interpret mode, 1e-9 absolute. The JAX
    kernel needs an x halo of 8, an 8-divisible interior x and a 128-wide
    halo-free y; the port's gate takes the other layouts too (``halo3``: x
    halo 3; ``ragged``: (100, 128), which the JAX gate refuses), and there
    the kernel path is held to the JAX XLA path instead."""
    from oceananigans_tpu.config import config
    from oceananigans_tpu.ops.pallas_sw import sw_fused_available as j_gate
    size, halo = {"jax": ((48, 128), (8, 0, 0)),
                  "halo3": ((48, 128), (3, 0, 0)),
                  "ragged": ((100, 128), (8, 0, 0))}[layout]
    jg = kernel_grid(oj, size, halo)
    jm = JModel(grid=jg, gravitational_acceleration=9.81)
    assert j_gate(jg, jm) == (layout == "jax")
    old = config.pallas_interpret
    config.pallas_interpret = True
    jm.fused_rk3 = layout == "jax"
    try:
        js = kernel_init(jnp, jm)
        step = jax.jit(lambda s: jm.step(s, 1.0))
        for _ in range(4):
            js = step(js)
    finally:
        jm.fused_rk3 = False
        config.pallas_interpret = old
    tm = ot.ShallowWaterModel(grid=kernel_grid(ot, size, halo, F64),
                              gravitational_acceleration=9.81,
                              fused_kernels=True)
    assert tm.fused_rk3
    n0 = cuda_sw.sw_rk3_stage.launches
    ts = kernel_init(torch, tm)
    for _ in range(4):
        ts = tm.step(ts, 1.0)
    assert cuda_sw.sw_rk3_stage.launches == n0          # CPU: plain
    ii = tm.grid.interior_slices
    ref = jax_state_to_numpy(js)
    for name in SW_FIELDS:
        a = getattr(ts, name).numpy()[ii]
        assert np.abs(a - ref[name][ii]).max() < 1e-9, name


GATE_CASES = {
    # name: (grid size, halo, topology, model keywords, port, JAX)
    "benchmark": ((48, 128), (8, 0, 0), PPF, {}, True, True),
    "fplane": ((48, 128), (8, 0, 0), PPF,
               dict(coriolis="fplane"), False, False),
    "tracer": ((48, 128), (8, 0, 0), PPF, dict(tracers=("c",)), False,
               False),
    "vector_invariant": ((48, 128), (8, 0, 0), PPF, dict(formulation=VI),
                         False, False),
    "weno": ((48, 128), (8, 0, 0), PPF, dict(momentum_advection="weno"),
             False, False),
    "bathymetry": ((48, 128), (8, 0, 0), PPF, dict(bathymetry=-0.5), False,
                   False),
    # the TPU's tiling rules, which the port's gate drops on purpose
    "halo3": ((48, 128), (3, 0, 0), PPF, {}, True, False),
    "ragged_x": ((100, 128), (8, 0, 0), PPF, {}, True, False),
    "narrow_y": ((48, 40), (8, 0, 0), PPF, {}, True, False),
    "bounded_y": ((48, 40), (3, 3, 0), PBF, {}, True, False),
    # what the CUDA kernel itself needs
    "halo1": ((48, 128), (1, 0, 0), PPF, {}, False, False),
    "bounded_y_halo1": ((48, 40), (2, 1, 0), PBF, {}, False, False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate(case):
    """The port's re-derived gate against the JAX gate: the same physics
    conditions; the JAX package's tiling rules dropped, the kernel's own
    reach (x halo ≥ 2, y halo ≥ 2 or periodic and halo-free) added."""
    from oceananigans_tpu.ops.pallas_sw import sw_fused_available as j_gate
    size, halo, topology, kw, port, jax_ok = GATE_CASES[case]

    def build(pkg, dtype):
        topo = tuple(getattr(pkg, t.capitalize()) for t in topology)
        grid = pkg.RectilinearGrid(size=size, x=(0.0, 1e5), y=(0.0, 1e5),
                                   topology=topo, halo=halo, dtype=dtype)
        kws = dict(kw)
        if kws.get("coriolis") == "fplane":
            kws["coriolis"] = pkg.FPlane(f=1e-4)
        if kws.get("momentum_advection") == "weno":
            kws["momentum_advection"] = pkg.WENO(5)
        return grid, kws

    jg, jkw = build(oj, "float64")
    tg, tkw = build(ot, F64)
    jm = JModel(grid=jg, **jkw)
    assert j_gate(jg, jm) == jax_ok
    tm = ot.ShallowWaterModel(grid=tg, fused_kernels=True, **tkw)
    assert cuda_sw.sw_fused_available(tg, tm) == port == tm.fused_rk3
    assert not ot.ShallowWaterModel(grid=tg, fused_kernels="auto",
                                    **tkw).fused_rk3    # CPU
    if port and not jax_ok:
        # the kernel path on a layout the JAX kernel refuses: held to the
        # plain path of the same model
        runs = {}
        for fused in (True, False):
            m = ot.ShallowWaterModel(grid=tg, fused_kernels=fused, **tkw)
            s = kernel_init(torch, m)
            for _ in range(2):
                s = m.step(s, 1.0)
            runs[fused] = s
        ii = tg.interior_slices
        for name in SW_FIELDS:
            a, b = (getattr(runs[f], name)[ii] for f in (True, False))
            assert float((a - b).abs().max()) < 1e-9, name


def test_stage_wrapper_checks_operands():
    tg = kernel_grid(ot, dtype=F64)
    z = torch.zeros(tg.shape, dtype=F64)
    with pytest.raises(ValueError):
        cuda_sw.sw_rk3_stage(tg, z, z.float(), z, z, z, z, 0.1, 0.0, 9.81)
    with pytest.raises(ValueError):
        cuda_sw.sw_rk3_stage(tg, z[1:], z, z, z, z, z, 0.1, 0.0, 9.81)
    small = kernel_grid(ot, halo=(1, 0, 0), dtype=F64)
    zs = torch.zeros(small.shape, dtype=F64)
    with pytest.raises(ValueError):             # the stencil needs 2 rows
        cuda_sw.sw_rk3_stage(small, *(zs for _ in range(6)), 0.1, 0.0, 9.81)


# ---------------------------------------------------------------------------
# Physics, from tests/test_shallow_water.py, cut to fewer steps
# ---------------------------------------------------------------------------

def sw_grid(N=32, L=10.0):
    return ot.RectilinearGrid(size=(N, N), x=(0.0, L), y=(0.0, L),
                              topology=(ot.Periodic, ot.Periodic, ot.Flat),
                              halo=3, dtype=F64)


@pytest.mark.parametrize("formulation", [CONS, VI])
def test_gravity_wave_speed(formulation):
    """A standing mode h = H + A cos(kx) on depth H returns to −A cos(kx)
    after half a period, at the speed √(gH)."""
    H, L, A = 1.0, 10.0, 1e-6
    k = 2 * np.pi / L
    period = 2 * np.pi / (k * np.sqrt(G * H))
    grid = sw_grid(N=32, L=L)
    model = ot.ShallowWaterModel(grid=grid, gravitational_acceleration=G,
                                 formulation=formulation)
    state = model.initial_state(
        h=lambda x, y, z: H + A * torch.cos(k * x) + 0 * y)
    nsteps = 64
    h0 = grid.interior(state.h).numpy() - H
    for _ in range(nsteps):
        state = model.step(state, (period / 2) / nsteps)
    h1 = grid.interior(state.h).numpy() - H
    np.testing.assert_allclose(h1, -h0, atol=A * 0.05)


def test_mass_conservation():
    grid = sw_grid()
    model = ot.ShallowWaterModel(grid=grid, coriolis=ot.FPlane(f=1.0),
                                 momentum_advection=ot.WENO(5))
    state = model.initial_state(
        h=lambda x, y, z: 1.0 + 0.1 * torch.exp(-((x - 5) ** 2
                                                  + (y - 5) ** 2)),
        uh=lambda x, y, z: 0.1 * torch.sin(2 * np.pi * y / 10) + 0 * x)
    m0 = float(field_integral(grid, state.h))
    for _ in range(20):
        state = model.step(state, 1e-3)
    m1 = float(field_integral(grid, state.h))
    assert abs(m1 - m0) / m0 < 1e-13
    assert bool(torch.isfinite(state.uh).all())


def test_tracer_conservation():
    grid = sw_grid()
    model = ot.ShallowWaterModel(grid=grid, tracers=("c",),
                                 tracer_advection=ot.WENO(5))
    state = model.initial_state(
        h=1.0, uh=0.5,
        c=lambda x, y, z: torch.exp(-((x - 5) ** 2) / 0.5) + 0 * y)
    c0 = float(field_integral(grid, state.tracers["c"]))
    for _ in range(20):
        state = model.step(state, 5e-3)
    c1 = float(field_integral(grid, state.tracers["c"]))
    assert abs(c1 - c0) / abs(c0) < 1e-12


def test_unported_arguments_raise():
    grid = sw_grid(N=8)
    # forcings are ported: one builds, off the stage kernel's path
    assert not ot.ShallowWaterModel(grid=grid, forcing={"uh": 1.0},
                                    fused_kernels=True).fused_rk3
    # any Coriolis object builds, as in the JAX package; its step calls
    # the object's x_f_cross_U
    model = ot.ShallowWaterModel(grid=grid, coriolis=object())
    with pytest.raises(AttributeError, match="x_f_cross_U"):
        model.step(model.initial_state(h=1.0), 1e-3)
    # the scheme-valued VectorInvariant options are ported now (with the
    # hydrostatic model); they build as in the JAX package
    from oceananigans_tpu import WENO as JWENO
    from oceananigans_tpu.models.hydrostatic import VectorInvariant as JVI
    for kw, jkw in ((dict(vorticity_scheme=ot.WENO(5)),
                     dict(vorticity_scheme=JWENO(5))),
                    (dict(vertical_scheme=ot.WENO(5)),
                     dict(vertical_scheme=JWENO(5))),
                    (dict(divergence_scheme=ot.WENO(5)),
                     dict(divergence_scheme=JWENO(5))),
                    (dict(kinetic_energy_gradient_scheme=ot.WENO(5)),
                     dict(kinetic_energy_gradient_scheme=JWENO(5))),
                    (dict(multi_dimensional_stencil=True),
                     dict(multi_dimensional_stencil=True))):
        assert VectorInvariant(**kw).required_halo == \
            JVI(**jkw).required_halo
    with pytest.raises(ValueError):
        VectorInvariant("unknown")
    with pytest.raises(ValueError):               # needs the VI formulation
        ot.ShallowWaterModel(grid=grid, momentum_advection=VectorInvariant())
    with pytest.raises(ValueError):               # 3-D grid
        ot.ShallowWaterModel(grid=ot.RectilinearGrid(
            size=(4, 4, 4), extent=(1.0, 1.0, 1.0), dtype=F64))
    with pytest.raises(ValueError):               # WENO(7) needs a halo of 4
        ot.ShallowWaterModel(grid=grid, momentum_advection=ot.WENO(7))
    assert VectorInvariant().required_halo == 2
    from oceananigans_tpu.models.hydrostatic import VectorInvariant as JVI
    for scheme in ("enstrophy_conserving", "energy_conserving"):
        assert repr(VectorInvariant(scheme)) == repr(JVI(scheme))
        assert VectorInvariant(scheme).required_halo == JVI(
            scheme).required_halo


@pytest.mark.parametrize("fused", [True, False])
def test_profiled_phases_repeat_step(fused):
    """``profile_step.phased_sw_step``, which the profiling script times
    phase by phase, computes exactly what ``model.step`` does, on the
    benchmark's configuration at a small size."""
    import copy

    from oceananigans_torch.profile_step import (
        SW_PHASES, phased_sw_step, sw_initial_state, sw_model,
    )
    m = sw_model(24, fused, dtype=F64, device="cpu")
    assert m.fused_rk3 == fused
    s = m.step(sw_initial_state(m), 1.0)
    ref = m.step(copy.deepcopy(s), 1.0, assume_filled=True)
    marks = []
    got = phased_sw_step(m, copy.deepcopy(s), 1.0, lambda: marks.append(1))
    assert len(marks) == len(SW_PHASES)
    for name in SW_FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.clock.iteration == ref.clock.iteration == 2


def test_benchmark_step_is_unstable():
    """``bench.py``'s shallow-water Δt = 1 s is above RK3's stability limit
    at its spacing (1e6 m / 8192): the grid-scale gravity waves have
    ω·Δt = 2√2·√(gH)·Δt/Δx ≈ 2.3 > √3, so float32 rounding noise grows
    until the fields overflow within ~50 steps; at Δt = 0.5 s the same
    run stays put. Shown at 64² with the benchmark's Δx, on the CPU."""
    N = 64
    L = N * 1e6 / 8192
    grid = ot.RectilinearGrid(size=(N, N), x=(0.0, L), y=(0.0, L),
                              topology=(ot.Periodic, ot.Periodic, ot.Flat),
                              halo=(8, 0, 0), dtype=torch.float32)
    model = ot.ShallowWaterModel(grid=grid, gravitational_acceleration=9.81)
    assert 2 * math.sqrt(2) * math.sqrt(9.81 * 1000.0) * 1.0 / (L / N) > \
        math.sqrt(3)
    from oceananigans_torch.profile_step import sw_initial_state
    anomaly = {}
    for dt in (1.0, 0.5):
        s = sw_initial_state(model)
        for _ in range(48):
            s = model.step(s, dt)
        dh = float((grid.interior(s.h) - 1000.0).abs().max())
        anomaly[dt] = dh if math.isfinite(dh) else math.inf
    assert anomaly[1.0] > 100.0
    assert anomaly[0.5] < 0.1
