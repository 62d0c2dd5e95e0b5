"""oceananigans_torch's bound-preserving limiters against the JAX package,
on the CPU in float64.

``WENO(bounds=(lo, hi))`` (the Zhang-Shu limited flux divergence) and
``BoundPreserving(scheme)`` (each face reconstruction clipped to its two
adjacent cells): their surface (equality, hashing, ``bind_grid`` on a
stretched grid, the orders reduced near a small axis) as JAX's; the flux
divergence of seeded fields within 1e-12 of JAX's largest value; the
nonhydrostatic (RK3), hydrostatic (``split_rk3``) and shallow-water
models with each limiter on a top-hat tracer, 2 steps within 1e-12 of
each field's largest JAX value (the JAX models step eagerly: jitted JAX
takes the limiter's θ, a minimum of quotients near 0/0, in another
order); the bound itself under ``split_rk3``, as
``tests/test_split_rk3.py`` holds it; and every kernel gate of the port
refusing both limiters, as the JAX gates do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import advection as t_adv
from oceananigans_torch.interop import SW_FIELDS, state_from_numpy
from oceananigans_torch.ops import (
    cuda_generic, cuda_kernels, cuda_sw, cuda_tracer, cuda_vi, cuda_weno,
)
from oceananigans_tpu import advection as j_adv
from oceananigans_tpu.models import ShallowWaterModel as JShallowWater
from oceananigans_tpu.models import hydrostatic as j_hyd
from oceananigans_tpu.ops import (
    pallas_kernels, pallas_sw, pallas_tracer, pallas_vi, pallas_weno,
)

from test_torch_closure_models import run_both
from test_torch_shallow_water import assert_close as sw_close
from test_torch_shallow_water import jax_state_to_numpy as sw_arrays

F64 = torch.float64


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


#: each limiter, made by either package's advection module
LIMITERS = {
    "weno5_bounds": lambda m: m.WENO(5, bounds=(0.0, 1.0)),
    "weno7_bounds": lambda m: m.WENO(7, bounds=(0.0, 1.0)),
    "bp_weno5": lambda m: m.BoundPreserving(m.WENO(5)),
    "bp_centered4": lambda m: m.BoundPreserving(m.Centered(4)),
}


def adv(pkg):
    """A package's advection module."""
    return j_adv if pkg is oj else t_adv


def top_hat(x):
    return np.where(np.abs(x - 0.5) < 0.2, 1.0, 0.0)


def test_scheme_surface_matches_jax():
    """Equality, hashing and repr; the bounds kept through a stretched
    grid's tables and the reduced orders near a small axis; the wrapper's
    order, halo and symmetry its scheme's."""
    for name, make in LIMITERS.items():
        t, j = make(t_adv), make(j_adv)
        assert repr(t) == repr(j), name
        assert t == make(t_adv) and hash(t) == hash(make(t_adv))
        assert t.required_halo == j.required_halo
    assert ot.WENO(5, bounds=(0, 1)) != ot.WENO(5)
    bp = ot.BoundPreserving(ot.Centered(4))
    assert (bp.order, bp.symmetric, bp.required_halo) == (4, True, 2)
    z = -(1.0 - np.linspace(0.0, 1.0, 9)) ** 1.5
    kw = dict(size=(8, 8, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=z, halo=4)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    for make in (LIMITERS["weno5_bounds"], LIMITERS["bp_weno5"]):
        tb, jb = make(t_adv).bind_grid(tg), make(j_adv).bind_grid(jg)
        assert repr(tb) == repr(jb)
        inner = getattr(tb, "scheme", tb)
        assert (2, 0) in inner._tables
        assert getattr(tb, "bounds", None) == getattr(jb, "bounds", None)
    small = dict(size=(8, 8, 2), extent=(1.0, 1.0, 1.0))
    for make in LIMITERS.values():
        assert repr(t_adv.adapt_advection_order(
            make(t_adv), ot.RectilinearGrid(dtype=F64, **small))) == repr(
                j_adv.adapt_advection_order(
                    make(j_adv), oj.RectilinearGrid(dtype="float64",
                                                    **small)))


@pytest.mark.parametrize("name", sorted(LIMITERS))
def test_div_Uc_matches_jax(name):
    """The flux divergence of a seeded top-hat-plus-noise tracer in
    seeded velocities with exact zeros, on a grid stretched in z."""
    rng = np.random.default_rng(11)
    z = -(1.0 - np.linspace(0.0, 1.0, 9)) ** 1.3
    kw = dict(size=(12, 10, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=z, halo=4,
              topology=(ot.Periodic, ot.Periodic, ot.Bounded))
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    shape = tg.shape
    c = np.clip(top_hat(np.linspace(0, 1, shape[0]))[:, None, None]
                + 0.3 * rng.standard_normal(shape), 0.0, 1.0)
    vel = [rng.standard_normal(shape) * (rng.random(shape) > 0.2)
           for _ in range(3)]
    got = t_adv.div_Uc(tg, LIMITERS[name](t_adv).bind_grid(tg),
                       *(torch.from_numpy(a) for a in vel),
                       torch.from_numpy(c))
    ref = j_adv.div_Uc(jg, LIMITERS[name](j_adv).bind_grid(jg),
                       *(jnp.asarray(a) for a in vel), jnp.asarray(c))
    ii = tg.interior_slices
    ref = np.asarray(ref)[ii]
    assert np.abs(got.numpy()[ii] - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["weno5_bounds", "bp_weno5"])
def test_nonhydrostatic_matches_jax(name):
    """A top hat in u = 1 through the nonhydrostatic model (RK3, Bounded
    z), 2 steps."""
    kw = dict(size=(16, 4, 8), extent=(1.0, 1.0, 1.0), halo=3,
              topology=(oj.Periodic, oj.Periodic, oj.Bounded))

    def build(pkg, make):
        grid = pkg.RectilinearGrid(
            dtype="float64" if pkg is oj else F64, **kw)
        return pkg.NonhydrostaticModel(grid=grid, advection=make(adv(pkg)),
                                       tracers=("c",))

    jm = build(oj, LIMITERS[name])
    tm = build(ot, LIMITERS[name])
    rng = np.random.default_rng(2)
    js = jm.initial_state(
        u=1.0 + 0.1 * rng.standard_normal(jm.grid.N),
        w=0.05 * rng.standard_normal(jm.grid.N),
        c=lambda x, y, z: jnp.where(jnp.abs(x - 0.5) < 0.2, 1.0, 0.0)
        + 0 * z)
    _, ts = run_both(jm, tm, js, 0.01, 2, eager=True)
    c = tm.grid.interior(ts.tracers["c"])
    assert float(c.min()) > -0.05 and float(c.max()) < 1.05


def hydro_pair(name, N=(32, 4, 4)):
    def build(pkg, hyd):
        grid = pkg.RectilinearGrid(
            size=N, x=(0.0, 1e6), y=(0.0, 1e5), z=(-1000.0, 0.0), halo=4,
            topology=(pkg.Periodic, pkg.Periodic, pkg.Bounded),
            dtype="float64" if pkg is oj else F64)
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, free_surface=hyd.ExplicitFreeSurface(),
            tracers=("c",), tracer_advection=LIMITERS[name](adv(pkg)),
            timestepper="split_rk3")
    return build(oj, j_hyd), build(ot, ot)


@pytest.mark.parametrize("name", ["weno7_bounds", "bp_weno5"])
def test_hydrostatic_split_rk3_matches_jax(name):
    """The JAX package's bound test's configuration (u = 0.5, a top hat of
    c) at 32 columns with seeded shear: 2 ``split_rk3`` steps of 30 s."""
    jm, tm = hydro_pair(name)
    rng = np.random.default_rng(4)
    js = jm.initial_state(
        u=0.5 + 0.05 * rng.standard_normal(jm.grid.N),
        c=lambda x, y, z: jnp.where(jnp.abs(x - 5e5) < 1e5, 1.0, 0.0)
        + 0 * z)
    run_both(jm, tm, js, 30.0, 2, eager=True)


def test_split_rk3_keeps_bounds():
    """``tests/test_split_rk3.py``'s property on the port: with
    ``BoundPreserving(WENO(5))`` and with ``WENO(5, bounds=(0, 1))``, 50
    steps in a uniform flow keep a [0, 1] top hat within [−1e-12,
    1 + 1e-12] and its mean to 1e-9."""
    for name in ("bp_weno5", "weno5_bounds"):
        _, tm = hydro_pair(name, N=(64, 1, 4))
        s = tm.initial_state(
            u=lambda x, y, z: 0.5 + 0 * x,
            c=lambda x, y, z: torch.where(torch.abs(x - 5e5) < 1e5, 1.0,
                                          0.0) + 0 * z)
        c = tm.grid.interior(s.tracers["c"])
        m0 = float(c.mean())
        for _ in range(50):
            s = tm.step(s, 30.0)
        c = tm.grid.interior(s.tracers["c"])
        assert bool(torch.isfinite(c).all())
        assert float(c.min()) > -1e-12 and float(c.max()) < 1.0 + 1e-12
        assert abs(float(c.mean()) - m0) <= 1e-9 * m0


@pytest.mark.parametrize("name", ["weno5_bounds", "bp_weno5"])
def test_shallow_water_matches_jax(name):
    """Two tracers of a shallow-water layer (a top hat and seeded noise in
    [0, 1]) under each limiter, 2 RK3 steps."""
    kw = dict(size=(16, 12), x=(0.0, 10.0), y=(0.0, 8.0), halo=3)

    def build(pkg):
        grid = pkg.RectilinearGrid(
            topology=(pkg.Periodic, pkg.Periodic, pkg.Flat),
            dtype="float64" if pkg is oj else F64, **kw)
        cls = JShallowWater if pkg is oj else ot.ShallowWaterModel
        return cls(grid=grid, tracers=("c", "d"),
                   tracer_advection=LIMITERS[name](adv(pkg)))

    jm, tm = build(oj), build(ot)
    rng = np.random.default_rng(8)
    shape = (16, 12, 1)
    x = np.linspace(0.0, 1.0, 16)[:, None, None]
    js = jm.initial_state(
        h=1.0 + 0.01 * rng.standard_normal(shape),
        uh=0.1 * rng.standard_normal(shape),
        vh=0.1 * rng.standard_normal(shape),
        c=top_hat(x) + 0 * rng.random(shape), d=rng.random(shape))
    ts = state_from_numpy(tm, sw_arrays(js))
    for _ in range(2):
        js = jm.step(js, 2e-3)
        ts = tm.step(ts, 2e-3)
    got = {k: np.asarray(v) for k, v in sw_arrays(js).items()}
    from oceananigans_torch.interop import state_to_numpy
    sw_close(tm.grid, state_to_numpy(ts), got,
             SW_FIELDS + ("tracers/c", "tracers/d"))


@pytest.mark.parametrize("name", sorted(LIMITERS))
def test_every_gate_refuses_the_limiters(name):
    """The gates of the 13 CUDA kernels refuse both limiters, as the JAX
    gates do: kernels 1, 2 and 5 (Centered(2)), 3 and 4 stand aside with
    them (their models take no advection kernel), 6–9 (WENO(5)), 10 (the
    shallow-water stage), 11 (any-order WENO tracers), 12/13
    (vector-invariant WENO schemes) and 14 (the generic momentum tile);
    and so do the models' own flags."""
    tg = ot.RectilinearGrid(size=(8, 8, 16), extent=(1.0, 1.0, 1.0),
                            halo=(6, 6, 6), dtype=F64)
    jg = oj.RectilinearGrid(size=(8, 8, 16), extent=(1.0, 1.0, 1.0),
                            halo=(6, 6, 6), dtype="float64")
    t, j = LIMITERS[name](t_adv), LIMITERS[name](j_adv)
    assert not cuda_kernels.fused_available(tg, t)
    assert not pallas_kernels.pallas_available(jg, j)
    assert not pallas_kernels.ab2_fused_available(jg, j)
    assert not cuda_weno.weno5_available(tg, t)
    assert not pallas_weno.weno5_available(jg, j)
    assert not pallas_weno.weno5_ab2_available(jg, j)
    assert not cuda_tracer.tracer_fusion_available(tg, t)
    assert not pallas_tracer.tracer_fusion_available(jg, j)
    assert not cuda_generic.generic_available(tg, t)
    tvi = ot.VectorInvariant(vorticity_scheme=t, vertical_scheme=t)
    jvi = j_hyd.VectorInvariant(vorticity_scheme=j, vertical_scheme=j)
    assert not cuda_vi.vi_available(tg, tvi)
    assert not pallas_vi.vi_available(jg, jvi)
    nh = ot.NonhydrostaticModel(grid=tg, advection=t, fused_kernels=True,
                                timestepper="QuasiAdamsBashforth2")
    assert not (nh.fused_kernels or nh.fused_ab2 or nh.fused_tracer)
    hy = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=tvi, tracer_advection=t, tracers="c",
        fused_kernels=True)
    assert not (hy.fused_kernels or hy.fused_tracer)
    sw_kw = dict(size=(16, 128), extent=(1.0, 1.0), halo=(8, 0, 0),
                 topology=(ot.Periodic, ot.Periodic, ot.Flat))
    sw = ot.ShallowWaterModel(
        grid=ot.RectilinearGrid(dtype=F64, **sw_kw), momentum_advection=t,
        fused_kernels=True)
    jsw = JShallowWater(
        grid=oj.RectilinearGrid(dtype="float64", **sw_kw),
        momentum_advection=j)
    assert not sw.fused_rk3 and not cuda_sw.sw_fused_available(sw.grid, sw)
    assert not pallas_sw.sw_fused_available(jsw.grid, jsw)


def test_bounded_flux_keeps_cell_means_in_bounds():
    """One forward-Euler step of the limited divergence at CFL 0.25 (within
    the limiter's Gauss-Lobatto weight 5/18) keeps a seeded field of
    zeros and ones in [0, 1] exactly, where the plain WENO(5) flux leaves
    it by ~0.1."""
    g = ot.RectilinearGrid(size=64, x=(0.0, 1.0), halo=3,
                           topology=(ot.Periodic, ot.Flat, ot.Flat),
                           dtype=F64)
    c0 = (np.random.default_rng(0).random(64) > 0.5) * 1.0
    c = torch.from_numpy(np.pad(c0, (3, 3), mode="wrap")).reshape(70, 1, 1)
    u = torch.ones_like(c)
    zero = torch.zeros_like(c)
    dt = 0.25 / 64
    ii = g.interior_slices
    out = {}
    for name, s in (("bounded", ot.WENO(5, bounds=(0.0, 1.0))),
                    ("plain", ot.WENO(5))):
        out[name] = (c - dt * t_adv.div_Uc(g, s, u, zero, zero, c))[ii]
    assert float(out["bounded"].min()) >= 0.0
    assert float(out["bounded"].max()) <= 1.0
    assert float(out["plain"].min()) < -0.1
    assert float(out["plain"].max()) > 1.1
