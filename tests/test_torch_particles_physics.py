"""oceananigans_torch's Lagrangian particles against the JAX package, on the
CPU in float64: advection with periodic wraps and wall bounces (with a
restitution below one), tracked fields, the bounce off an immersed
boundary, particles in the nonhydrostatic and hydrostatic models; and a
checkpoint pickup of a model with particles, bit for bit.

Each model case steps both packages from the same state (built in the
port, ``test_torch_forcings.jax_state_from``; the JAX step eagerly, which
is quicker than compiling these small cases) and holds the
fields to 1e-12 of their largest values (``test_torch_closure_models``)
and the particles' positions and properties to 1e-12 of theirs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import (
    FIELDS, HYDROSTATIC_FIELDS, flatten_state, state_from_numpy,
)
from oceananigans_tpu.immersed import (
    GridFittedBottom as JBottom, ImmersedBoundaryGrid as JIBG,
)
from oceananigans_tpu.particles import LagrangianParticles as JParticles
from test_torch_closure_models import (
    AB2, F64, RTOL, assert_close, grids, jax_arrays,
)
from test_torch_forcings import jax_state_from


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


def positions(n, seed, lo=(0.0, 0.0, -1.0), hi=(1.0, 1.0, 0.0)):
    rng = np.random.default_rng(seed)
    return [lo[a] + (hi[a] - lo[a]) * rng.random(n) for a in range(3)]


def assert_particles_close(tp, jp):
    """Positions and properties within 1e-12 of their largest values."""
    pairs = [(tp.x, jp.x), (tp.y, jp.y), (tp.z, jp.z)]
    pairs += [(tp.properties[k], jp.properties[k]) for k in jp.properties]
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= RTOL * max(np.abs(ref).max(), 1e-300), err


def step_both(jmodel, tmodel, jstate, dt, steps):
    """Step both models from the JAX state, eagerly; compare the fields and
    the particles after every step."""
    names = tmodel.tracer_names
    fields = (HYDROSTATIC_FIELDS
              if isinstance(tmodel, ot.HydrostaticFreeSurfaceModel)
              else FIELDS)
    ts = state_from_numpy(tmodel, jax_arrays(jstate, fields, names))
    assert_particles_close(ts.particles, jstate.particles)
    js = jstate
    for _ in range(steps):
        ts = tmodel.step(ts, dt)
        js = jmodel.step(js, dt)
        assert_close(tmodel.grid, ts, jax_arrays(js, fields, names), fields,
                     names)
        assert_particles_close(ts.particles, js.particles)
    return ts, js


@pytest.mark.parametrize("restitution", [1.0, 0.6])
def test_nonhydrostatic_particles_match_jax(restitution):
    """96 particles in a (Periodic, Periodic, Bounded) box with a strong
    vertical flow: they wrap in x and y and bounce off the top and bottom
    walls (with ``restitution``), tracking b and u; 2 RK3 steps."""
    kw = dict(size=(8, 6, 8), extent=(1.0, 1.0, 1.0),
              topology=(oj.Periodic, oj.Periodic, oj.Bounded), halo=2)
    jg, tg = grids(**kw)
    x, y, z = positions(96, 0)
    tracked = {"buoyancy": "b", "speed": "u"}

    def build(pkg, grid, Particles, **extra):
        return pkg.NonhydrostaticModel(
            grid=grid, buoyancy=pkg.BuoyancyTracer(),
            particles=Particles(x=x, y=y, z=z, restitution=restitution,
                                tracked_fields=tracked), **extra)
    jm = build(oj, jg, JParticles)
    tm = build(ot, tg, ot.LagrangianParticles, fused_kernels=True)
    js = jax_state_from(jm, tm.initial_state(
        u=lambda x, y, z: 2.0 + torch.sin(2 * np.pi * y) + 0 * z,
        v=lambda x, y, z: -1.5 + 0 * x,
        w=lambda x, y, z: 3.0 * torch.sin(2 * np.pi * x) + 0 * z,
        b=lambda x, y, z: z + 0.1 * torch.cos(2 * np.pi * x)))
    ts, _ = step_both(jm, tm, js, 0.05, 2)
    assert ts.particles.x.dtype == F64
    assert ((ts.particles.z >= -1.0) & (ts.particles.z <= 0.0)).all()


def test_hydrostatic_particles_match_jax():
    """Particles in the hydrostatic model, on a (Periodic, Bounded,
    Bounded) box, tracking T; 2 steps."""
    kw = dict(size=(8, 8, 4), extent=(1e5, 1e5, 400.0),
              topology=(oj.Periodic, oj.Bounded, oj.Bounded), halo=3)
    jg, tg = grids(**kw)
    x, y, z = positions(64, 1, hi=(1e5, 1e5, 0.0), lo=(0.0, 0.0, -400.0))

    def build(pkg, grid, Particles, **extra):
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, tracers=("T",),
            buoyancy=pkg.SeawaterBuoyancy(constant_salinity=35.0),
            free_surface=pkg.SplitExplicitFreeSurface(substeps=8),
            particles=Particles(x=x, y=y, z=z,
                                tracked_fields={"T": "T"}), **extra)
    jm = build(oj, jg, JParticles)
    tm = build(ot, tg, ot.LagrangianParticles, fused_kernels=True)
    js = jax_state_from(jm, tm.initial_state(
        u=lambda x, y, z: 0.5 + 0.2 * torch.sin(2 * np.pi * y / 1e5) + 0 * z,
        v=lambda x, y, z: 0.3 * torch.sin(2 * np.pi * x / 1e5) + 0 * z,
        T=lambda x, y, z: 15.0 + 0.01 * z + torch.cos(2 * np.pi * x / 1e5)))
    step_both(jm, tm, js, 300.0, 2)


@pytest.mark.parametrize("bottom", ["flat", "seamount"])
def test_immersed_bounce_matches_jax(bottom):
    """The JAX package's immersed bounce cases (``tests/test_particles.py``)
    through ``advect``: particles pushed by a strong downwelling into a
    solid bottom (flat at z = −0.5, or the seamount −1 + 0.6 exp(−(x −
    0.5)²/0.02)) bounce back into the cell they came from; those in open
    water move freely."""
    base = dict(size=(16, 4, 16), extent=(1.0, 1.0, 1.0),
                topology=(oj.Periodic, oj.Periodic, oj.Bounded))
    jb, tb = grids(**base)
    if bottom == "flat":
        jh, th = -0.5, -0.5
    else:
        jh, th = (lambda x, y, xp=xp: -1.0 + 0.6 * xp.exp(
            -((x - 0.5) ** 2) / 0.02) for xp in (jnp, torch))
    jgrid = JIBG(jb, JBottom(jh))
    tgrid = ot.ImmersedBoundaryGrid(tb, ot.GridFittedBottom(th))
    x, y, z = positions(64, 4, lo=(0.0, 0.0, -0.7), hi=(1.0, 1.0, -0.1))
    rng = np.random.default_rng(5)
    w = -0.4 - 0.1 * rng.random(tuple(tgrid.shape))
    u = 0.2 * rng.standard_normal(tuple(tgrid.shape))
    zero = np.zeros(tuple(tgrid.shape))
    for r in (1.0, 0.5):
        jp = JParticles(x=x, y=y, z=z, restitution=r)
        tp = ot.LagrangianParticles(x=x, y=y, z=z, restitution=r)
        jout = jp.advect(jgrid, jp.initial, *(jnp.asarray(a)
                                              for a in (u, zero, w)), dt=0.5)
        tout = tp.advect(tgrid, tp.state_on(tgrid), *(
            torch.tensor(a) for a in (u, zero, w)), dt=0.5)
        assert_particles_close(tout, jout)
        zs = tout.z.numpy()
        moved = np.abs(zs - z) > 0.1
        assert moved.any() and (zs < z).any()


def test_particle_pickup_is_bitwise(tmp_path):
    """A ``Checkpointer`` carries the particles (``particles/x``, …,
    ``particles/properties/<name>``): a run picked up from iteration 4
    ends bit for bit where the uninterrupted run ends, particles
    included."""
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Periodic, ot.Periodic, ot.Bounded),
                              dtype=F64)
    x, y, z = positions(32, 2)
    model = ot.NonhydrostaticModel(
        grid=grid, tracers=("c",), timestepper=AB2,
        particles=ot.LagrangianParticles(x=x, y=y, z=z,
                                         tracked_fields={"c": "c"}))

    def fresh():
        return model.initial_state(
            u=lambda x, y, z: torch.sin(2 * np.pi * y) + 0 * z,
            w=lambda x, y, z: 0.5 * torch.sin(2 * np.pi * x) + 0 * z,
            c=lambda x, y, z: torch.cos(2 * np.pi * z) + x)

    assert {"particles/x", "particles/y", "particles/z",
            "particles/properties/c"} <= set(flatten_state(fresh()))
    ref = ot.Simulation(model, state=fresh(), dt=1e-2, stop_iteration=8)
    ref.run()
    first = ot.Simulation(model, state=fresh(), dt=1e-2, stop_iteration=4)
    first.output_writers["ckpt"] = ot.Checkpointer(
        tmp_path, ot.IterationInterval(4))
    first.run()
    again = ot.Simulation(model, state=fresh(), dt=1e-2, stop_iteration=8)
    again.output_writers["ckpt"] = first.output_writers["ckpt"]
    again.run(pickup=True)
    a, b = flatten_state(again.state), flatten_state(ref.state)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert not torch.equal(ref.state.particles.x, torch.tensor(x))
