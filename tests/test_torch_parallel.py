"""The port's distributed layer (``oceananigans_torch/parallel``) on the CPU
against the JAX package, in float64.

Four gloo ranks are spawned once for the module (the ``ranks`` fixture);
every case's rank program (``tests/torch_parallel_ranks.py``, which imports
no JAX) runs in that one spawn, from the port's initial state handed over
as numpy arrays. Each test then steps the JAX package's SERIAL model from
the same state (the arrays in the JAX model's state: both packages step
from the same numbers, and the JAX package's eager initial projections,
half a minute for these cases, are spared) and holds the port's sharded result to it at the
tolerance of the matching case in ``tests/test_parallel.py`` or
``tests/test_dist_pallas.py``. The JAX step is jitted as there, and run
eagerly for CATKE (whose sign switches move jitted JAX past 1e-12,
ROADMAP Queue 3, caveat 9). Meshes are (2, 2) and (4, 1) where the JAX
tests take (4, 2): four ranks keep the module quick.

Also here: ``Partition.resolve``, the step's refusals word for word
against the JAX package's, the halo exchange against the JAX package's,
the pencil FFT and Fourier-tridiagonal solves, ``Simulation`` driving a
``DistributedModel`` with a bitwise sharded pickup (and a plain
``Checkpointer`` refused there), the local model's
kernel choices against the JAX local model's with the kernels forced on,
a split halo-free periodic axis refused, and ``dryrun_multichip``.

``sharded_step_fn`` (the counterpart of the JAX package's GSPMD step) runs
the configurations only that path takes, held against the JAX serial
step: ``tests/test_parallel.py``'s (26, 10, 8) model over four uneven
blocks and ``tests/test_orbax_checkpoint.py``'s halo-free grid at the
JAX package's 1e-13; forcings, a callable boundary flux, background
fields and particles, phase 13's ``hydro_vi_closure`` configuration, a
hydrostatic model with particles on a stretched x, and the shallow-water
model split in x and in a halo-free y, at 1e-12; and its
``NotImplementedError`` naming ROADMAP Queue 1 item 20 for a tripolar
grid and for blocks narrower than their halo. The ranks start on the
device of ``config.device`` (``launch``'s default).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.parallel import Partition, launch

import torch_parallel_ranks as tr

@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def jax_arrays(state):
    """A JAX state as the numpy mapping of ``interop``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if f.name == "particles":
            out.update({f"particles/{k}": np.asarray(getattr(v, k))
                        for k in ("x", "y", "z")})
            out.update({f"particles/properties/{k}": np.asarray(a)
                        for k, a in v.properties.items()})
        elif f.name == "clock":
            out["time"] = np.asarray(v.time)
            out["iteration"] = np.asarray(v.iteration)
            out["last_dt"] = np.asarray(v.last_dt)
        elif isinstance(v, dict):
            out.update({f"{f.name}/{n}": np.asarray(a)
                        for n, a in v.items()})
        else:
            out[f.name] = np.asarray(v)
    return out


def initial_arrays(case):
    """The case's initial state, made by the port on its global grid, as
    ``interop``'s numpy mapping."""
    from oceananigans_torch.interop import state_to_numpy
    grid = tr.grid_of(ot, torch, case)
    model = tr.model_of(ot, torch, case, grid)
    return state_to_numpy(model.initial_state(**tr.fields_of(torch,
                                                             case)))


def jax_state(model, arrays):
    """The JAX model's state holding ``arrays`` (``interop``'s keys)."""
    from oceananigans_tpu.models.hydrostatic import HydrostaticState
    from oceananigans_tpu.models.nonhydrostatic import NonhydrostaticState
    from oceananigans_tpu.models.shallow_water import ShallowWaterState
    from oceananigans_tpu.particles import ParticleState
    from oceananigans_tpu.timesteppers import Clock
    cls = (HydrostaticState
           if isinstance(model, oj.HydrostaticFreeSurfaceModel)
           else ShallowWaterState
           if isinstance(model, oj.ShallowWaterModel)
           else NonhydrostaticState)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "particles" and "particles/x" in arrays:
            kw[f.name] = ParticleState(
                **{k: jnp.asarray(arrays[f"particles/{k}"])
                   for k in ("x", "y", "z")},
                properties={k: jnp.asarray(arrays[
                    f"particles/properties/{k}"])
                    for k in model.particles.tracked_fields})
        elif f.name == "clock":
            kw["clock"] = Clock(
                time=jnp.asarray(arrays["time"]),
                iteration=jnp.asarray(arrays["iteration"], jnp.int32),
                last_dt=jnp.asarray(arrays["last_dt"]))
        elif f.name in ("tracers", "Gtracers"):
            kw[f.name] = {n: jnp.asarray(arrays[f"{f.name}/{n}"])
                          for n in model.tracer_names}
        else:
            kw[f.name] = (jnp.asarray(arrays[f.name]) if f.name in arrays
                          else None)
    return cls(**kw)


def rect(size, topology, halo, **kw):
    return {"size": size, "topology": topology, "halo": halo, **kw}


PPB = ("Periodic", "Periodic", "Bounded")

#: the model cases: the grid, the model, the initial fields, Δt and steps,
#: the partition, and the JAX package's tolerances for them
STEP_CASES = {
    # test_explicit_halo_step_matches_serial_and_bounds_collectives
    "weno_periodic": dict(
        kind="nonhydrostatic", grid=rect((32, 16, 16), PPB, 5,
                                         extent=(1.0, 1.0, 1.0)),
        model={"advection": ("WENO", 5), "tracers": ("b",),
               "buoyancy": "BuoyancyTracer"},
        ic="weno", dt=1e-3, steps=3, partition=(2, 2)),
    # test_explicit_halo_step_bounded_axis
    "bounded_ab2": dict(
        kind="nonhydrostatic",
        grid=rect((32, 16, 8), ("Bounded", "Periodic", "Bounded"), 2,
                  extent=(1.0, 1.0, 1.0)),
        model={"advection": ("Centered", 2),
               "timestepper": "QuasiAdamsBashforth2"},
        ic="bounded", dt=1e-3, steps=4, partition=(4, 1)),
    # test_explicit_halo_step_stretched_z_matches_serial
    "stretched_z": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), PPB, 3, x=(0, 1.0), y=(0, 1.0),
                  z_power=(8, 1.4)),
        model={"advection": ("WENO", 5), "tracers": ("b",),
               "buoyancy": "BuoyancyTracer"},
        ic="stretched", dt=1e-3, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_step_matches_serial
    "hydro_explicit": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), PPB, 3, x=(0, 1e5), y=(0, 5e4),
                  z=(-500.0, 0.0)),
        model={"free_surface": ("ExplicitFreeSurface", {}),
               "tracers": ("T", "S"), "buoyancy": "SeawaterLinear"},
        ic="hydro", dt=2.0, steps=3, partition=(2, 2)),
    "hydro_split": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), PPB, 3, x=(0, 1e5), y=(0, 5e4),
                  z=(-500.0, 0.0)),
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 12}),
               "tracers": ("T", "S"), "buoyancy": "SeawaterLinear"},
        ic="hydro", dt=30.0, steps=3, partition=(2, 2)),
    # the same on a Bounded y split over two ranks (the walls of the
    # barotropic transports on the edge ranks only)
    "hydro_split_bounded_y": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), ("Periodic", "Bounded", "Bounded"), 3,
                  x=(0, 1e5), y=(0, 5e4), z=(-500.0, 0.0)),
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 12}),
               "tracers": ("T", "S"), "buoyancy": "SeawaterLinear"},
        ic="hydro", dt=30.0, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_implicit_fs_matches_serial
    "hydro_implicit": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), PPB, 3, x=(0, 2e5), y=(0, 1e5),
                  z=(-500.0, 0.0)),
        model={"free_surface": ("ImplicitFreeSurface",
                                {"solver_method": "cg"}),
               "tracers": ("T",)},
        ic="implicit", dt=120.0, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_latlon_matches_serial
    "hydro_latlon": dict(
        kind="hydrostatic", grid_kind="LatitudeLongitudeGrid",
        grid={"size": (32, 16, 6), "longitude": (0.0, 360.0),
              "latitude": (15.0, 55.0), "z": (-500.0, 0.0), "halo": 3,
              "topology": ("Periodic", "Bounded", "Bounded")},
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 10}),
               "coriolis": "HydrostaticSphericalCoriolis",
               "tracers": ("T",), "forcing": "heat"},
        ic="latlon", dt=60.0, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_immersed_matches_serial
    "hydro_immersed": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), PPB, 3, x=(0, 2e5), y=(0, 1e5),
                  z=(-1000.0, 0.0)),
        bottom="hill",
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 10}),
               "tracers": ("T",)},
        ic="immersed", dt=60.0, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_zstar_matches_serial
    "hydro_zstar": dict(
        kind="hydrostatic",
        grid=rect((32, 16, 8), PPB, 3, x=(0, 2e5), y=(0, 1e5),
                  z=(-500.0, 0.0)),
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 10}),
               "vertical_coordinate": "ZStar", "tracers": ("T",)},
        ic="zstar", dt=60.0, steps=3, partition=(2, 2)),
    # test_explicit_halo_hydrostatic_catke_matches_serial
    "hydro_catke": dict(
        kind="hydrostatic",
        grid=rect((16, 16, 12), PPB, 3, x=(0, 1e4), y=(0, 1e4),
                  z=(-100.0, 0.0)),
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 8}),
               "tracers": ("b", "e"), "buoyancy": "BuoyancyTracer",
               "closure": "CATKEVerticalDiffusivity"},
        ic="catke", dt=30.0, steps=3, partition=(2, 2), eager=True),
    # test_explicit_halo_nonhydrostatic_immersed_matches_serial
    "nh_immersed": dict(
        kind="nonhydrostatic",
        grid=rect((32, 16, 8), PPB, 2, x=(0, 2.0), y=(0, 1.0),
                  z=(-1.0, 0.0)),
        bottom="bump", model={"timestepper": "QuasiAdamsBashforth2"},
        ic="flow", dt=5e-3, steps=3, partition=(2, 2)),
    # test_explicit_halo_nonhydrostatic_partial_cell_jacobi
    "nh_partial_cell": dict(
        kind="nonhydrostatic",
        grid=rect((32, 16, 8), PPB, 2, x=(0, 2.0), y=(0, 1.0),
                  z=(-1.0, 0.0)),
        bottom="partial", model={"timestepper": "QuasiAdamsBashforth2"},
        ic="flow", dt=5e-3, steps=2, partition=(2, 2)),
}
#: tests/test_dist_pallas.py: the kernels forced on in the local model
SPY_CASES = {
    "pallas_centered2": dict(
        kind="nonhydrostatic", grid=rect((16, 16, 8), PPB, 3,
                                         extent=(1.0, 1.0, 1.0)),
        model={"advection": ("Centered", 2)}, fused=True,
        ic="pallas", dt=1e-3, steps=3, partition=(2, 2)),
    "pallas_weno5": dict(
        kind="nonhydrostatic", grid=rect((16, 16, 8), PPB, 3,
                                         extent=(1.0, 1.0, 1.0)),
        model={"advection": ("WENO", 5), "tracers": ("b",),
               "buoyancy": "BuoyancyTracer"}, fused=True,
        ic="weno", dt=1e-3, steps=3, partition=(4, 1)),
    "pallas_weno5_ab2": dict(
        kind="nonhydrostatic", grid=rect((16, 16, 8), PPB, 3,
                                         extent=(1.0, 1.0, 1.0)),
        model={"advection": ("WENO", 5),
               "timestepper": "QuasiAdamsBashforth2"}, fused=True,
        ic="pallas", dt=1e-3, steps=3, partition=(2, 2)),
}
#: the configurations the explicit-halo step refuses
REFUSED = {
    "background_fields": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), PPB, 3, extent=(1.0, 1.0, 1.0)),
        model={"background_fields": "shear"}),
    "forcing": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), PPB, 3, extent=(1.0, 1.0, 1.0)),
        model={"tracers": ("b",), "forcing": "heat"}),
    "function_boundary_condition": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), PPB, 3, extent=(1.0, 1.0, 1.0)),
        model={"boundary_conditions": "surface_stress"}),
    "halo_free_split_axis": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), ("Bounded", "Periodic", "Bounded"),
                  (3, 0, 3), extent=(1.0, 1.0, 1.0)), model={}),
}

#: what only ``sharded_step_fn`` takes, held against the JAX serial step
SHARDED_CASES = {
    # tests/test_parallel.py::test_sharded_step_matches_serial, letter for
    # letter over (4, 1): blocks of 7, 7, 6 and 6 cells, uneven pencils
    "jax_sharded_serial": dict(
        kind="nonhydrostatic",
        grid=rect((26, 10, 8), PPB, 3, extent=(1.0, 1.0, 1.0)),
        model={"advection": ("WENO", 5), "tracers": ("b",),
               "buoyancy": "BuoyancyTracer",
               "coriolis": ("FPlane", {"f": 1e-4})},
        ic="stretched", dt=1e-3, steps=5, partition=(4, 1)),
    # tests/test_orbax_checkpoint.py: both split axes without a halo
    "orbax_halo_free": dict(
        kind="nonhydrostatic",
        grid=rect((16, 16, 8), ("Periodic",) * 3, (0, 0, 1), x=(0, 1),
                  y=(0, 1), z=(0, 1)),
        model={}, ic="orbax", dt=0.01, steps=3, partition=(2, 2)),
    # a sponge masked in x, a forcing of (x, y), a callable top flux of
    # (x, y, t), background fields of x and y, and particles on the block
    # boundaries and across them, walls with restitution 0.5
    "nh_forced_particles": dict(
        kind="nonhydrostatic",
        grid=rect((16, 12, 6), ("Periodic", "Bounded", "Bounded"), 3,
                  x=(0, 2.0), y=(0, 1.0), z=(-1.0, 0.0)),
        model={"advection": ("WENO", 5), "tracers": ("b",),
               "buoyancy": "BuoyancyTracer", "forcing": "xy",
               "boundary_conditions": "stress_xy",
               "background_fields": "xy",
               "timestepper": "QuasiAdamsBashforth2",
               "particles": dict(n=300, seed=3, restitution=0.5,
                                 tracked={"b": "b"})},
        ic="forced", dt=0.05, steps=4, partition=(2, 2)),
    # phase 13's hydro_vi_closure at (48, 16, 6): the closures, a callable
    # u stress and an array T flux, kernels 11 and 12/13's configuration
    "hydro_vi_closure": dict(
        kind="hydrostatic",
        grid=rect((48, 16, 6), ("Periodic", "Bounded", "Bounded"),
                  (6, 6, 4), extent=(4e7, 2e7, 4e3)),
        model={"momentum_advection": ("WENOVectorInvariant",),
               "tracer_advection": ("WENO", 7), "tracers": ("T", "S"),
               "free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 30}),
               "closure": "hydro_closure",
               "boundary_conditions": "closure"},
        ic="generic", dt=60.0, steps=3, partition=(2, 2)),
    # particles in a hydrostatic model on a stretched x with walls, and a
    # forcing of (x, y)
    "hydro_particles": dict(
        kind="hydrostatic",
        grid=rect((20, 12, 5), ("Bounded", "Periodic", "Bounded"), 3,
                  x=list(np.cumsum(np.concatenate([[0.0], 2e4 * (
                      1 + 0.3 * np.sin(np.arange(20.0)))]))),
                  y=(0, 1e5), z=(-500.0, 0.0)),
        model={"tracers": ("T",), "forcing": "T_xy",
               "particles": dict(n=200, seed=4, restitution=0.5,
                                 tracked={"T": "T"})},
        ic="hydro_particles", dt=300.0, steps=4, partition=(2, 2)),
    # the shallow-water model over (4, 1), kernel 10's code path forced
    # (whose plain version takes its spacings from coordinate differences:
    # spacings exact in binary keep it to the JAX step's rounding)
    "sw_x": dict(
        kind="shallow_water",
        grid=rect((28, 16), ("Periodic", "Periodic", "Flat"), (2, 0, 0),
                  x=(0.0, 28 * 2.0 ** 15), y=(0.0, 2.0 ** 20)),
        model={"gravitational_acceleration": 9.81}, fused=True,
        ic="sw", dt=100.0, steps=3, partition=(4, 1)),
    # and over (1, 4): the halo-free periodic y split, with a local halo
    "sw_y": dict(
        kind="shallow_water",
        grid=rect((28, 16), ("Periodic", "Periodic", "Flat"), (2, 0, 0),
                  x=(0.0, 28 * 2.0 ** 15), y=(0.0, 2.0 ** 20)),
        model={"gravitational_acceleration": 9.81}, fused=True,
        ic="sw", dt=100.0, steps=3, partition=(1, 4)),
}
#: the sharded cases' tolerances: 1e-13 for the JAX package's own
SHARDED_TOL = {"jax_sharded_serial": 1e-13, "orbax_halo_free": 1e-13}
#: blocks narrower than their halo: 10 cells over 4 ranks, halo 3
NARROW = dict(kind="nonhydrostatic",
              grid=rect((10, 8, 4), PPB, 3, extent=(1.0, 1.0, 1.0)),
              model={}, partition=(4, 1), program="gspmd_refusal")
#: a split Bounded axis without a halo: the serial operators wrap across
#: its walls, which no halo cell of a block holds
BOUNDED_HALO_FREE = dict(
    kind="hydrostatic",
    grid=rect((16, 16, 8), ("Bounded", "Periodic", "Bounded"), (0, 0, 1),
              x=(0, 1e5), y=(0, 1e5), z=(-500.0, 0.0)),
    model={"tracers": ("T",)}, partition=(2, 2), program="gspmd_refusal")

EXCHANGE = dict(grid=rect((32, 16, 8), PPB, 2, extent=(1.0, 1.0, 1.0)),
                partition=(2, 2))
FFT = dict(grid=rect((32, 16, 8), PPB, 1, extent=(1.0, 1.0, 1.0)),
           partition=(2, 2), solver="fft")
FT_TOPOLOGIES = {"ppb": PPB, "bpb": ("Bounded", "Periodic", "Bounded")}
SIMULATION = dict(
    kind="hydrostatic",
    grid=rect((32, 16, 8), PPB, 3, x=(0, 2e5), y=(0, 1e5), z=(-500.0, 0.0)),
    model={"free_surface": ("SplitExplicitFreeSurface", {"substeps": 10}),
           "tracers": ("T",)},
    ic="simulation", dt=60.0, partition=(2, 2))


def jax_model(case, fused=None):
    grid = tr.grid_of(oj, jnp, case)
    return grid, tr.model_of(oj, jnp, case, grid, fused)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's inputs (the JAX model and the port's initial state in
    it), every rank program run in one spawn of four gloo ranks;
    ``(inputs, results)`` by case name."""
    cases, inputs = {}, {}
    for name, case in {**STEP_CASES, **SPY_CASES}.items():
        grid, model = jax_model(case)
        arrays = initial_arrays(case)
        inputs[name] = (grid, model, jax_state(model, arrays))
        case = dict(case, program="spy" if name in SPY_CASES else "step")
        cases[name] = (case, arrays)
    rng = np.random.default_rng(0)
    exch = dict(EXCHANGE, program="exchange")
    a = rng.standard_normal(tuple(tr.grid_of(oj, jnp, exch).N))
    cases["exchange"] = (exch, {"interior": a})
    inputs["exchange"] = a
    rng = np.random.default_rng(1)
    fft = dict(FFT, program="solver")
    rhs = rng.standard_normal(tuple(tr.grid_of(oj, jnp, fft).N))
    rhs -= rhs.mean()
    cases["fft"] = (fft, {"rhs": rhs})
    inputs["fft"] = rhs
    for tag, topo in FT_TOPOLOGIES.items():
        ft = dict(program="solver", solver="ft", partition=(2, 2),
                  grid=rect((16, 16, 16), topo, 2, x=(0, 1.0), y=(0, 1.0),
                            z_power=(16, 1.5)))
        rng = np.random.default_rng(11)
        rhs = rng.standard_normal((16, 16, 16))
        rhs -= rhs.mean()
        cases[f"ft_{tag}"] = (ft, {"rhs": rhs})
        inputs[f"ft_{tag}"] = (ft, rhs)
    cases["refusals"] = (dict(program="refusal", partition=(2, 2),
                              refused=REFUSED), {})
    sim = dict(SIMULATION, program="simulation",
               dir=str(tmp_path_factory.mktemp("sim")))
    grid, model = jax_model(sim)
    arrays = initial_arrays(sim)
    cases["simulation"] = (sim, arrays)
    inputs["simulation"] = (grid, model, jax_state(model, arrays),
                            sim["dir"])
    widened = dict(REFUSED["background_fields"], ic="pallas", dt=1e-3,
                   steps=3, partition=(2, 2))
    grid, model = jax_model(widened)
    arrays = initial_arrays(widened)
    inputs["widened"] = (grid, model, jax_state(model, arrays))
    gspmd = dict(STEP_CASES["hydro_split"], program="gspmd",
                 widened=widened,
                 tripolar={"size": (16, 10, 2), "halo": 2})
    cases["gspmd"] = (gspmd, {"state": cases["hydro_split"][1],
                              "widened": arrays})
    for name, case in SHARDED_CASES.items():
        grid, model = jax_model(case)
        arrays = initial_arrays(case)
        inputs[name] = (grid, model, jax_state(model, arrays))
        cases[name] = (dict(case, program="sharded"), arrays)
    cases["narrow"] = (NARROW, {})
    cases["bounded_halo_free"] = (BOUNDED_HALO_FREE, {})
    # the ranks' device: launch's default, config.device (the CPU here)
    results = launch(4, tr.run_cases, (cases,),
                     rendezvous_dir=tmp_path_factory.mktemp("rdzv"),
                     backend="gloo")[0]
    return inputs, results


def serial_run(model, state, case):
    """The JAX package's serial steps (jitted, or eager where the case
    says so)."""
    step = ((lambda s: model.step(s, case["dt"])) if case.get("eager")
            else jax.jit(lambda s: model.step(s, case["dt"])))
    for _ in range(case["steps"]):
        state = step(state)
    return state


def interior(grid, a):
    """The x/y/z interior of a global-layout array (η's single level
    whole)."""
    sx, sy, sz = grid.interior_slices
    a = np.asarray(a)
    return a[sx, sy, sz] if a.shape[2] > 1 else a[sx, sy]


#: each case's tolerances: (field, atol) as the JAX package's tests hold
#: them (test_parallel.py; velocities of the WENO case relative to
#: max(1, max|u|/0.01), as there)
TOLERANCES = {
    "weno_periodic": {"u": "weno", "tracers/b": 1e-6},
    "bounded_ab2": {"u": 2e-7},
    "stretched_z": {"u": 1e-10, "v": 1e-10, "w": 1e-10, "tracers/b": 1e-10},
    "hydro_explicit": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11},
    "hydro_split": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11},
    "hydro_split_bounded_y": {"u": 1e-12, "v": 1e-12, "eta": 1e-12,
                              "tracers/T": 1e-11},
    "hydro_implicit": {"u": 1e-10, "v": 1e-10, "eta": 1e-10},
    "hydro_latlon": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11},
    "hydro_immersed": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11},
    "hydro_zstar": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11},
    "hydro_catke": {"u": 1e-12, "v": 1e-12, "tracers/b": 1e-11,
                    "tracers/e": 1e-11},
    "nh_immersed": {"u": 5e-7, "w": 5e-7},
    "nh_partial_cell": {"u": 5e-7, "w": 5e-7},
    "pallas_centered2": {"u": 2e-13, "v": 2e-13, "w": 2e-13},
    "pallas_weno5": {"u": 2e-13, "v": 2e-13, "w": 2e-13,
                     "tracers/b": 2e-13},
    "pallas_weno5_ab2": {"u": 2e-13, "v": 2e-13, "w": 2e-13},
}


@pytest.mark.parametrize("name", list(STEP_CASES) + list(SPY_CASES))
def test_sharded_step_matches_jax_serial(ranks, name):
    """The port's sharded step against the JAX package's serial step, at
    the tolerances of the JAX package's own sharded-vs-serial test."""
    inputs, results = ranks
    case = {**STEP_CASES, **SPY_CASES}[name]
    grid, model, state = inputs[name]
    ref = jax_arrays(serial_run(model, state, case))
    got = results[name]["state"]
    assert int(got["iteration"]) == case["steps"]
    for key, tol in TOLERANCES[name].items():
        want = interior(grid, ref[key])
        have = interior(grid, got[key])
        if tol == "weno":
            tol = 1e-7 * max(1.0, np.abs(want).max() / 0.01)
        np.testing.assert_allclose(have, want, rtol=0, atol=tol,
                                   err_msg=f"{name}: {key}")


def test_kernel_gates_match_jax_local_model(ranks):
    """With the kernels forced on, the port's local model takes the same
    kernel family as the JAX package's ``dstep.lmodel`` and runs its
    tendency kernels on the block (the spy counts the wrappers' calls):
    Centered(2) the Centered-2 tendency, WENO(5) the WENO-5 momentum and
    tracer ones, three times a step under RK3; and no fused AB2 kernel,
    which the JAX step refuses under ``dist_halo``."""
    from jax.sharding import Mesh
    from oceananigans_tpu.parallel import DistributedStep as JStep
    _, results = ranks
    for name, case in SPY_CASES.items():
        grid = tr.grid_of(oj, jnp, case)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(*case["partition"]),
                    ("x", "y"))
        jl = JStep(lambda g: tr.model_of(oj, jnp, case, g, True), grid,
                   mesh).lmodel
        gates = results[name]["gates"]
        assert gates["fused_kernels"] == jl.fused_kernels, name
        assert not any(gates[k] for k in (
            "fused_ab2", "fused_ab2_weno", "fused_ab2_science",
            "fused_ab2_weno_science")), name
        per_step = 3 if jl.timestepper == "RungeKutta3" else 1
        want = ({"centered2_momentum_tendency": per_step}
                if jl.fused_kernels == "centered2"
                else {"weno5_momentum_tendency": per_step})
        if jl.fused_kernels == "weno5":
            # called with no tracers too, when it launches nothing
            want["weno5_tracer_tendencies"] = per_step
        assert results[name]["calls"] == {
            k: n * case["steps"] for k, n in want.items()}, name


def test_sharded_step_fn_global_in_global_out(ranks):
    """``sharded_step_fn`` takes and returns the global layout (on rank
    0) and runs the explicit-halo step between, matching the JAX serial
    step as ``hydro_split`` does; a background field, which the
    explicit-halo step refuses, steps there too and matches the JAX
    serial step; a tripolar grid raises ``NotImplementedError`` naming
    ROADMAP Queue 1 item 20."""
    inputs, results = ranks
    out = results["gspmd"]
    grid, model, state = inputs["hydro_split"]
    ref = jax_arrays(serial_run(model, state, STEP_CASES["hydro_split"]))
    for key, tol in TOLERANCES["hydro_split"].items():
        np.testing.assert_allclose(interior(grid, out["state"][key]),
                                   interior(grid, ref[key]), rtol=0,
                                   atol=tol, err_msg=key)
    grid, model, state = inputs["widened"]
    ref = jax_arrays(serial_run(model, state, dict(steps=3, dt=1e-3)))
    for key in ("u", "v", "w"):
        np.testing.assert_allclose(interior(grid, out["widened"][key]),
                                   interior(grid, ref[key]), rtol=0,
                                   atol=1e-12, err_msg=key)
    assert "item 20" in out["refusal"]
    assert "OrthogonalSphericalShellGrid" in out["refusal"]
    # shard_state: each rank's even slab of the halo-extended arrays, the
    # layout of the JAX package's P("x", "y", None) sharding
    gx, gy, gz = out["global"]
    assert out["slab"] == (gx // 2, gy // 2, gz)


@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_step_fn_matches_jax_serial(ranks, name):
    """What only the JAX package's GSPMD path took, through the port's
    ``sharded_step_fn``, against the JAX serial step: every field of the
    state, and the particles' positions (to the tolerance of the domain's
    length) and tracked properties."""
    inputs, results = ranks
    case = SHARDED_CASES[name]
    grid, model, state = inputs[name]
    ref = jax_arrays(serial_run(model, state, case))
    got = results[name]["state"]
    tol = SHARDED_TOL.get(name, 1e-12)
    assert int(got["iteration"]) == case["steps"]
    # every field of the state; of the shallow water the prognostic ones,
    # as tests/test_torch_shallow_water.py compares them (its tendencies
    # are the difference of ~1e4-sized terms)
    fields = (["uh", "vh", "h"] if case["kind"] == "shallow_water" else
              [k for k in ref if not k.startswith((
                  "particles", "time", "iteration", "last_dt"))
               and np.ndim(ref[k]) == 3])
    assert fields
    for key in fields:
        want = interior(grid, ref[key])
        # the shallow water's h ~ 1e3 and uh ~ 1e2: relative to each
        # field's largest value, as tests/test_torch_shallow_water.py
        # holds the port's serial step to the JAX package's
        scale = (np.abs(want).max() if case["kind"] == "shallow_water"
                 else 1.0)
        np.testing.assert_allclose(interior(grid, got[key]), want, rtol=0,
                                   atol=tol * scale, err_msg=f"{name}: {key}")
    if "particles" in case["model"]:
        for key, L in zip(("x", "y", "z"), (grid.Lx, grid.Ly, grid.Lz)):
            np.testing.assert_allclose(got[f"particles/{key}"],
                                       ref[f"particles/{key}"], rtol=0,
                                       atol=1e-12 * L, err_msg=key)
        for prop in case["model"]["particles"]["tracked"]:
            key = f"particles/properties/{prop}"
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=tol, err_msg=key)


@pytest.mark.parametrize("name", [n for n, c in SHARDED_CASES.items()
                                  if "particles" in c["model"]])
def test_particle_owner_rule(ranks, name):
    """Every particle has exactly one owner, those exactly on a block
    boundary (a global face between two blocks) and at a corner of four
    blocks included: the ranks' owned intervals are half-open, from the
    global faces, open to ±∞ at the domain's edges."""
    _, results = ranks
    case = SHARDED_CASES[name]
    out = results[name]
    x, y, _ = tr.particle_positions(case)
    assert (out["owners"] == 1).all()
    (xlo, xhi), (ylo, yhi) = out["owned"]
    assert xlo == -np.inf and ylo == -np.inf
    on_x, on_y = x == xhi, y == yhi
    assert on_x.any() and on_y.any() and (on_x & on_y).any()


def test_sharded_local_grids_and_gates(ranks):
    """The local grids of a sharded step: uneven blocks of the (26, 10, 8)
    grid (7, 7, 6, 6 cells), a halo of the global grid's largest on each
    split halo-free axis, and the shallow-water stage kernel's gate: it
    holds on every block of the x split and of the halo-free y split,
    whose blocks carry a y halo; the kernels of the other sharded cases
    as their gates decide on the blocks, with no fused AB2 kernel."""
    _, results = ranks
    blocks = [r["block"][0] for r in results["jax_sharded_serial"][
        "locals"]]
    assert blocks == [7, 7, 6, 6]
    assert all(r["halo"] == (1, 1, 1)
               for r in results["orbax_halo_free"]["locals"])
    for name in ("sw_x", "sw_y"):
        for r in results[name]["locals"]:
            assert r["gates"]["fused_rk3"], name
    assert all(r["halo"][1] == 2 for r in results["sw_y"]["locals"])
    for name in SHARDED_CASES:
        for r in results[name]["locals"]:
            assert not any(r["gates"].get(k) for k in (
                "fused_ab2", "fused_ab2_weno", "fused_ab2_science",
                "fused_ab2_weno_science")), name


def test_sw_gate_refuses_halo_free_split_y():
    """The stage kernel wraps a halo-free periodic y within its block: on
    a rank's block of a y split over several ranks its gate holds only
    with a y halo (which the sharded step always gives such a block)."""
    from oceananigans_torch.ops.cuda_sw import sw_fused_available
    from oceananigans_torch.parallel.distributed import Partition as P

    class Ctx:
        def __init__(self, partition):
            self.partition = partition

        def size(self, axis):
            return self.partition[axis]

    for halo, ctx, want in (((2, 0, 0), None, True),
                            ((2, 0, 0), Ctx((1, 4)), False),
                            ((2, 0, 0), Ctx((4, 1)), True),
                            ((2, 2, 0), Ctx((1, 4)), True)):
        grid = ot.RectilinearGrid(size=(8, 8), x=(0.0, 1.0), y=(0.0, 1.0),
                                  topology=(ot.Periodic, ot.Periodic,
                                            ot.Flat), halo=halo,
                                  dtype="float64")
        model = ot.ShallowWaterModel(grid=grid, fused_kernels=True)
        if ctx is not None:
            model.set_dist_halo(ctx, grid.topology)
        assert sw_fused_available(grid, model) == want, (halo, ctx)
    assert P(1, 4).resolve(4) == (1, 4)


def test_sharded_step_fn_refuses_narrow_blocks(ranks):
    """Blocks narrower than their halo would need a neighbour's neighbour:
    ``NotImplementedError`` naming ROADMAP Queue 1 item 20."""
    _, results = ranks
    out = results["narrow"]
    assert out["error"] == "NotImplementedError"
    assert "item 20" in out["message"] and "narrower" in out["message"]


def test_sharded_step_fn_refuses_halo_free_bounded_split(ranks):
    """A split Bounded axis without a halo is refused with ``ValueError``:
    the serial operators wrap across its walls, which the halo of a block
    cannot hold (a split halo-free Periodic axis is padded instead)."""
    _, results = ranks
    out = results["bounded_halo_free"]
    assert out["error"] == "ValueError"
    assert "axis 0 is Bounded" in out["message"]
    assert "no halo" in out["message"]


def test_sharded_local_arrays_cut_to_the_block(ranks):
    """The default model maker cuts an array boundary condition to the
    rank's block (``hydro_vi_closure``'s T flux over the top slab), and
    ``DistributedStep.window`` refuses an array whose extent on a split
    axis is neither the interior's nor the halo-extended one's."""
    _, results = ranks
    for r in results["hydro_vi_closure"]["locals"]:
        assert r["slabs"] == {"T.top": r["shape"][:2] + (1,)}
    for name in SHARDED_CASES:
        for r in results[name]["locals"]:
            assert "neither the interior" in r["odd_extent"], name


def test_launch_device_defaults_to_config_device(ranks):
    """``launch`` and ``dryrun_multichip`` take ``device=None``, resolved
    from ``config.device`` in the caller's process: the ranks of the
    module's spawn, started without a device, run on the CPU that the
    module's fixture set."""
    import inspect

    from oceananigans_torch.parallel import dryrun_multichip
    _, results = ranks
    assert results["narrow"]["device"] == "cpu"
    for fn in (launch, dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default is None


def test_partition_resolve():
    for spec, n in (((4, 2), 8), ((None, 2), 8), ((None, None), 8),
                    ((2, None), 4), ((None, 1), 4), ((1, 1), 1)):
        assert Partition(*spec).resolve(n) == oj.Partition(*spec).resolve(n)
    for spec, n in (((3, 2), 8), ((4, 2), 4)):
        with pytest.raises(ValueError, match="devices"):
            Partition(*spec).resolve(n)
        with pytest.raises(ValueError, match="devices"):
            oj.Partition(*spec).resolve(n)


def test_refusals_match_jax_word_for_word(ranks):
    """The explicit-halo step refuses what the JAX package's refuses, with
    its words; a split halo-free periodic axis, which the JAX package
    steps wrongly, is refused too."""
    from jax.sharding import Mesh
    from oceananigans_tpu.parallel import DistributedStep as JStep
    _, results = ranks
    got = results["refusals"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    for name, case in REFUSED.items():
        if name == "halo_free_split_axis":
            assert "halo-free periodic axis" in got[name]
            continue
        grid = tr.grid_of(oj, jnp, case)
        with pytest.raises(ValueError) as err:
            JStep(lambda g: tr.model_of(oj, jnp, case, g), grid, mesh)
        assert got[name] == str(err.value), name


def test_halo_exchange_matches_jax(ranks):
    """The exchange's blocks equal the JAX package's exchange in its
    local-halos layout, and the round trip keeps the interior."""
    from jax.sharding import Mesh
    from oceananigans_tpu.parallel.halo_exchange import (
        halo_exchange, to_local_layout,
    )
    inputs, results = ranks
    a = inputs["exchange"]
    grid = tr.grid_of(oj, jnp, EXCHANGE)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    want = np.asarray(halo_exchange(to_local_layout(jnp.asarray(a), mesh,
                                                    grid), mesh, grid))
    np.testing.assert_array_equal(results["exchange"]["local"], want)
    np.testing.assert_array_equal(results["exchange"]["back"], a)


def test_pencil_fft_matches_jax_serial(ranks):
    from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver
    inputs, results = ranks
    grid = tr.grid_of(oj, jnp, FFT)
    want = np.asarray(FFTPoissonSolver(grid).solve(jnp.asarray(
        inputs["fft"])))
    np.testing.assert_allclose(results["fft"]["phi"], want, atol=1e-11)


@pytest.mark.parametrize("tag", FT_TOPOLOGIES)
def test_fourier_tridiagonal_matches_jax_serial(ranks, tag):
    from oceananigans_tpu.solvers.fourier_tridiagonal import (
        FourierTridiagonalPoissonSolver,
    )
    inputs, results = ranks
    case, rhs = inputs[f"ft_{tag}"]
    grid = tr.grid_of(oj, jnp, case)
    want = np.asarray(FourierTridiagonalPoissonSolver(grid).solve(
        jnp.asarray(rhs)))
    got = results[f"ft_{tag}"]["phi"]
    np.testing.assert_allclose(got, want, atol=2e-11)
    dz = np.asarray(grid.dz(lz="c")).reshape(-1)[grid.Hz:grid.Hz + grid.Nz]
    assert abs((got.mean(axis=(0, 1)) * dz / dz.sum()).sum()) < 1e-10


def test_simulation_drives_distributed_model_with_sharded_pickup(ranks):
    """``Simulation`` runs a ``DistributedModel``: the HDF5 writer writes
    the GLOBAL fields (rank 0), the final state matches the JAX serial run,
    and a run picked up from the sharded checkpoint at iteration 3 ends
    bit for bit where the first did."""
    import h5py
    inputs, results = ranks
    grid, model, state, path = inputs["simulation"]
    out = results["simulation"]
    assert out["iteration"] == 6 and out["bitwise"]
    ref = jax_arrays(serial_run(model, state, dict(SIMULATION, steps=6)))
    for key, tol in (("u", 1e-12), ("v", 1e-12), ("tracers/T", 1e-11)):
        np.testing.assert_allclose(interior(grid, out["state"][key]),
                                   interior(grid, ref[key]), rtol=0,
                                   atol=tol, err_msg=key)
    with h5py.File(f"{path}/fields.h5", "r") as fh:
        T = np.asarray(fh["fields"]["T"])
    assert T.shape[1:] == tuple(grid.N)
    np.testing.assert_allclose(T[-1], interior(grid, out["state"][
        "tracers/T"]), atol=1e-12)



def test_plain_checkpointer_refused_under_distribution(ranks):
    """Each rank's state is its own block: a plain ``Checkpointer`` would
    write every rank's block to one file, so ``Simulation`` refuses it
    under a ``DistributedModel`` and names ``OrbaxCheckpointer``."""
    _, results = ranks
    msg = results["simulation"]["plain_checkpointer"]
    assert msg is not None and "OrbaxCheckpointer" in msg
    assert "4 ranks" in msg

def test_dryrun_multichip():
    from oceananigans_torch.parallel import dryrun_multichip
    reports = dryrun_multichip(4, "gloo", "cpu")
    assert len(reports) == 4
    assert all(r["nonhydrostatic"] and r["hydrostatic"] for r in reports)
