"""The port's Centered-2 science kernel (``centered2_science_ab2_update``)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:

- the plain version against the JAX XLA path (the JAX model's own
  ``compute_tendencies`` and the AB2 update) in float64: 1e-12 of each
  group's largest value; both evaluate the same whole-array formulas;
- the port's kernel code path (``fused_kernels=True``: on the CPU, the
  plain version) against the JAX kernel in interpret mode over 4 AB2 steps
  in float32, with the JAX package's own test and tolerance
  (``tests/test_ensemble_and_pallas.py::
  test_fused_science_ab2_step_matches_plain``): 1e-5 relative, and the
  tracer tendencies scaled by the size of one flux-divergence term rather
  than by the cancelling residual.

Only interior points are compared; halo rows are junk or unwritten in both
packages.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.ops import cuda_kernels as ck
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions,
)
from oceananigans_tpu.models import NonhydrostaticModel as JModel

F64 = torch.float64
AB2 = "QuasiAdamsBashforth2"
BPP = (oj.Bounded, oj.Periodic, oj.Periodic)
LAYOUTS = {"aligned": ((16, 16, 128), (1, 0, 0)),
           "haloed": ((10, 9, 7), (1, 1, 1))}
LOCS = {"u": oj.LOC_U, "v": oj.LOC_V, "w": oj.LOC_W, "b": oj.LOC_C,
        "c": oj.LOC_C}


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


def science_kwargs(m, f=1e-2):
    return dict(coriolis=m.FPlane(f=f), buoyancy=m.BuoyancyTracer(),
                tracers=("b", "c"))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_xla(layout):
    """One science AB2 update: the port's plain version against the JAX
    model's XLA tendencies and update, float64."""
    size, halo = LAYOUTS[layout]
    kw = dict(size=size, extent=(1.0, 2.0, 0.5), topology=BPP, halo=halo)
    jg = oj.RectilinearGrid(dtype="float64", **kw)
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    jm = JModel(grid=jg, timestepper=AB2, fused_kernels=False,
                **science_kwargs(oj))
    rng = np.random.default_rng(0)
    arrays, t = {}, {}
    for name, loc in LOCS.items():
        a = rng.standard_normal(tg.shape)
        arrays[name] = np.asarray(j_fill(
            jnp.asarray(a), jg, regularize_field_boundary_conditions(
                None, jg, loc), loc))
        t[name] = ot.fill_halo_regions(torch.tensor(a), tg, loc=loc)
    Gm = {n: rng.standard_normal(tg.shape) for n in ("u", "v", "w", "b", "c")}
    s = jm.initial_state()
    s = dataclasses.replace(
        s, u=jnp.asarray(arrays["u"]), v=jnp.asarray(arrays["v"]),
        w=jnp.asarray(arrays["w"]),
        tracers={n: jnp.asarray(arrays[n]) for n in ("b", "c")})
    Gu, Gv, Gw, Gt, _ = jm.compute_tendencies(s)
    a, b = 1.6e-2, -0.6e-2
    tr = {n: t[n] for n in ("b", "c")}
    got = ck.centered2_science_ab2_update_plain(
        tg, t["u"], t["v"], t["w"], tr,
        *(torch.tensor(Gm[n]) for n in ("u", "v", "w")),
        {n: torch.tensor(Gm[n]) for n in ("b", "c")}, a, b, f=1e-2,
        buoyancy_tracer="b")
    refG = {"u": Gu, "v": Gv, "w": Gw, **Gt}
    ii = tg.interior_slices
    groups = {
        "new": ([got[0], got[1], got[2], got[3]["b"], got[3]["c"]],
                [arrays[n] + a * np.asarray(refG[n]) + b * Gm[n]
                 for n in ("u", "v", "w", "b", "c")]),
        "G": ([got[4], got[5], got[6], got[7]["b"], got[7]["c"]],
              [np.asarray(refG[n]) for n in ("u", "v", "w", "b", "c")]),
    }
    for name, (gs, refs) in groups.items():
        scale = max(np.abs(r[ii]).max() for r in refs)
        for g, r in zip(gs, refs):
            np.testing.assert_allclose(g.numpy()[ii], r[ii], rtol=0,
                                       atol=1e-12 * scale, err_msg=name)


def test_kernel_path_matches_pallas_interpret():
    """The JAX package's own science-kernel test: 4 AB2 steps of the
    float32 (16, 16, 128) model, the port's kernel code path against the
    JAX kernel in interpret mode."""
    from oceananigans_tpu.config import config
    kw = dict(size=(16, 16, 128), extent=(1.0, 1.0, 1.0), topology=BPP,
              halo=(1, 0, 0))
    jm = JModel(grid=oj.RectilinearGrid(dtype="float32", **kw),
                timestepper=AB2, fused_kernels=True, **science_kwargs(oj))
    tm = ot.NonhydrostaticModel(
        grid=ot.RectilinearGrid(dtype=torch.float32, **kw),
        timestepper=AB2, fused_kernels=True, **science_kwargs(ot))
    assert jm.fused_ab2_science and tm.fused_ab2_science

    def init(xp, m):
        sin, cos, pi = xp.sin, xp.cos, math.pi
        return m.initial_state(
            u=lambda x, y, z: 0.1 * sin(4 * pi * x) * cos(2 * pi * y),
            v=lambda x, y, z: 0.1 * cos(2 * pi * x) * sin(6 * pi * z),
            b=lambda x, y, z: 0.01 * sin(2 * pi * z)
            + 0.001 * cos(2 * pi * x),
            c=lambda x, y, z: cos(2 * pi * y) * sin(2 * pi * x))

    old = config.pallas_interpret
    config.pallas_interpret = True
    try:
        sj = init(jnp, jm)
        step = jax.jit(lambda s: jm.step(s, jnp.float32(1e-3)))
        for _ in range(4):
            sj = step(sj)
    finally:
        config.pallas_interpret = old
    st = init(torch, tm)
    n0 = ck.centered2_science_ab2_update.launches
    for _ in range(4):
        st = tm.step(st, 1e-3)
    assert ck.centered2_science_ab2_update.launches == n0   # CPU: plain
    ii = tm.grid.interior_slices
    floor = float(np.abs(np.asarray(sj.u)).max())
    for name in ("u", "v", "w", "Gu", "Gv", "Gw"):
        a = getattr(st, name).numpy()[ii]
        b = np.asarray(getattr(sj, name))[ii]
        scale = max(float(np.abs(b).max()), floor)
        assert np.abs(a - b).max() / scale < 1e-5, name
    for name in ("b", "c"):
        a = st.tracers[name].numpy()[ii]
        bb = np.asarray(sj.tracers[name])[ii]
        ga = st.Gtracers[name].numpy()[ii]
        gb = np.asarray(sj.Gtracers[name])[ii]
        assert np.abs(a - bb).max() / np.abs(bb).max() < 1e-5, name
        term = 2 * 16 * floor * float(np.abs(bb).max())
        assert np.abs(ga - gb).max() < 1e-5 * term, "G" + name


GATES = {
    "fplane": lambda m: science_kwargs(m),
    "beta_plane": lambda m: dict(coriolis=m.BetaPlane(f0=1e-4, beta=1e-11),
                                 buoyancy=m.BuoyancyTracer(),
                                 tracers=("b",)),
    "no_tracers": lambda m: dict(coriolis=m.FPlane(f=1e-4)),
    "tracers_only": lambda m: dict(tracers=("c",)),
    "seawater": lambda m: dict(buoyancy=m.SeawaterBuoyancy()),
}


@pytest.mark.parametrize("config", sorted(GATES))
def test_gate_matches_jax(config):
    """On the aligned layout the port's Centered-2 science gate agrees with
    the JAX gate."""
    kw = dict(size=(16, 16, 128), extent=(1.0, 1.0, 1.0), topology=BPP,
              halo=(1, 0, 0))
    for fused in (True, False):
        jm = JModel(grid=oj.RectilinearGrid(dtype="float64", **kw),
                    timestepper=AB2, fused_kernels=fused,
                    **GATES[config](oj))
        tm = ot.NonhydrostaticModel(grid=ot.RectilinearGrid(dtype=F64, **kw),
                                    timestepper=AB2, fused_kernels=fused,
                                    **GATES[config](ot))
        assert tm.fused_ab2_science == jm.fused_ab2_science, config
        assert tm.fused_ab2 == jm.fused_ab2, config


def test_gate_above_max_tracers():
    """Above MAX_TRACERS tracers the port's gate is off where the JAX gate,
    which budgets VMEM instead, is on (nine tracers fit its 64 MiB at this
    size): the port then takes the unfused route, whose result matches the
    plain path's to 1e-12, and the kernel wrapper refuses the call."""
    names = tuple(f"c{i}" for i in range(ck.MAX_TRACERS + 1))
    kw = dict(size=(4, 8, 128), extent=(1.0, 1.0, 1.0), topology=BPP,
              halo=(1, 0, 0))
    jm = JModel(grid=oj.RectilinearGrid(dtype="float64", **kw),
                timestepper=AB2, fused_kernels=True, tracers=names)
    assert jm.fused_ab2_science
    tg = ot.RectilinearGrid(dtype=F64, **kw)
    runs = {}
    for fused in (True, False):
        tm = ot.NonhydrostaticModel(grid=tg, timestepper=AB2, tracers=names,
                                    fused_kernels=fused)
        assert not tm.fused_ab2_science
        rng = np.random.default_rng(5)
        s = tm.initial_state(**{n: rng.standard_normal(tg.N)
                                for n in ("u", "v") + names})
        for _ in range(2):
            s = tm.step(s, 1e-3)
        runs[fused] = s
    for n in names:
        a, b = (tg.interior(runs[k].tracers[n]) for k in (True, False))
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    z = torch.zeros(tg.shape, dtype=F64)
    with pytest.raises(ValueError):
        ck.centered2_science_ab2_update(
            tg, z, z, z, {n: z for n in names}, z, z, z,
            {n: z.clone() for n in names}, 0.1, 0.0)


def test_halo_contract_and_operands():
    """G is written over G⁻ in place and keeps its x-halo rows; the new
    fields are new tensors that copy the old x-halo rows. A wrong
    ``Gc_prev`` or an unknown buoyancy tracer raises."""
    tg = ot.RectilinearGrid(size=(6, 5, 4), extent=(1.0, 1.0, 1.0),
                            topology=BPP, halo=1, dtype=F64)
    rng = np.random.default_rng(2)
    f = {n: ot.fill_halo_regions(torch.tensor(rng.standard_normal(tg.shape)),
                                 tg, loc=LOCS[n]) for n in LOCS}
    G = {n: torch.tensor(rng.standard_normal(tg.shape)) for n in LOCS}
    G0 = {n: g.clone() for n, g in G.items()}
    tr = {"b": f["b"], "c": f["c"]}
    out = ck.centered2_science_ab2_update(
        tg, f["u"], f["v"], f["w"], tr, G["u"], G["v"], G["w"],
        {"b": G["b"], "c": G["c"]}, 0.2, -0.1, f=0.5, buoyancy_tracer="b")
    news = [out[0], out[1], out[2], out[3]["b"], out[3]["c"]]
    gs = [out[4], out[5], out[6], out[7]["b"], out[7]["c"]]
    for n, q, g in zip(("u", "v", "w", "b", "c"), news, gs):
        assert g is G[n] and q is not f[n]
        for row in (0, -1):
            assert torch.equal(g[row], G0[n][row])
            assert torch.equal(q[row], f[n][row])
    with pytest.raises(ValueError):
        ck.centered2_science_ab2_update(
            tg, f["u"], f["v"], f["w"], tr, G["u"], G["v"], G["w"],
            {"b": G["b"]}, 0.2, -0.1)
    with pytest.raises(ValueError):
        ck.centered2_science_ab2_update(
            tg, f["u"], f["v"], f["w"], tr, G["u"], G["v"], G["w"],
            {"b": G["b"], "c": G["c"]}, 0.2, -0.1, buoyancy_tracer="T")
