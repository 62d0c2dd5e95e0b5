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
ROADMAP Queue 3, caveat 9). CATKE under z-star with a u surface flux,
whose surface cell height every block takes from the global halo corner,
runs in both distributed steps on a rectilinear grid and in
``sharded_step_fn`` on its lat-lon twin, at ``hydro_catke``'s
tolerances. Meshes are (2, 2) and (4, 1) where the JAX
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
model split in x and in a halo-free y, at 1e-12; the tripolar model of
``tests/test_orthogonal_grids.py::test_distributed_tripolar_fold_matches_serial``
over (4, 1) and (2, 2), a tripolar grid whose top block is narrower than
its halo over (1, 4) and a rotated lat-lon model over (2, 2), at 1e-12 of
each field's largest value, with the tripolar fill bit for bit against
the JAX serial fill on every rank's block; and blocks narrower than their
halo, a nonhydrostatic x split at 1e-13 and a hydrostatic split of a
Bounded y, whose halos reach past the wall. The ranks start on the
device of ``config.device`` (``launch``'s default).
"""

import concurrent.futures
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
from test_torch_closure_models import jitted_thomas


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
#: tests/test_orthogonal_grids.py::test_distributed_tripolar_fold_matches_
#: serial's model (its default halo of 3), 3 steps of 300 s: u, v and η
#: held at 1e-12 of each one's largest value, as there, the other fields
#: at 1e-12
TRIPOLAR = dict(
    kind="hydrostatic", grid_kind="TripolarGrid",
    grid={"size": (26, 8, 4), "southernmost_latitude": -75.0,
          "z": (-1000.0, 0.0)},
    model={"momentum_advection": ("VectorInvariant",), "tracers": ("b",),
           "buoyancy": "BuoyancyTracer",
           "free_surface": ("SplitExplicitFreeSurface", {"substeps": 10})},
    ic="tripolar", dt=300.0, steps=3, ref="tripolar",
    relative=("u", "v", "eta"))

#: CATKE under z-star with a u surface flux: the surface cell height that
#: scales its surface TKE flux is σ·Δz of the global halo corner on every
#: block, as in the serial step; 3 steps of 300 s, held against the eager
#: JAX serial step as hydro_catke
ZSTAR_CATKE = dict(
    kind="hydrostatic",
    grid=rect((24, 12, 4), ("Periodic", "Bounded", "Bounded"), 4,
              x=(0, 2e5), y=(0, 1e5), z=(-400.0, 0.0)),
    model={"momentum_advection": ("WENOVectorInvariant", None, 5),
           "tracer_advection": ("WENO", 5), "tracers": ("T", "S"),
           "buoyancy": "SeawaterLinear",
           "free_surface": ("SplitExplicitFreeSurface", {"substeps": 10}),
           "vertical_coordinate": "ZStar",
           "closure": "CATKEVerticalDiffusivity",
           "boundary_conditions": "u_flux"},
    ic="zstar_catke", dt=300.0, steps=3, partition=(2, 2), eager=True,
    ref="hydro_zstar_catke", atol={"tracers": 1e-11})

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
    "hydro_zstar_catke": ZSTAR_CATKE,
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
    # tests/test_orthogonal_grids.py::test_distributed_tripolar_fold_
    # matches_serial's model over (4, 1), every rank folding against
    # another, and over (2, 2), the top row folding; one JAX reference
    "tripolar_x": dict(TRIPOLAR, partition=(4, 1)),
    "tripolar_xy": dict(TRIPOLAR, partition=(2, 2)),
    # y blocks of 3, 3, 2 and 2 rows under a halo of 3: the fold's rows
    # span two ranks, and the top block is narrower than its halo
    "tripolar_narrow": dict(TRIPOLAR, grid=dict(TRIPOLAR["grid"],
                                                size=(24, 10, 4)),
                            partition=(1, 4), ref="tripolar_narrow"),
    # an OrthogonalSphericalShellGrid without a fold
    "rotated": dict(
        kind="hydrostatic", grid_kind="RotatedLatitudeLongitudeGrid",
        grid={"size": (16, 10, 4), "longitude": (-30.0, 30.0),
              "latitude": (-20.0, 20.0), "z": (-100.0, 0.0),
              "north_pole": (30.0, 50.0), "halo": 3},
        model={"momentum_advection": ("VectorInvariant",),
               "tracers": ("T", "S"), "buoyancy": "SeawaterLinear",
               "free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 10})},
        ic="rotated", dt=120.0, steps=3, partition=(2, 2),
        relative=("u", "v", "eta")),
    # CATKE under z-star with a u surface flux, the explicit-halo case's
    # model (one JAX reference), and its twin on a lat-lon grid
    "zstar_catke": ZSTAR_CATKE,
    "zstar_catke_latlon": dict(
        ZSTAR_CATKE, grid_kind="LatitudeLongitudeGrid",
        grid={"size": (24, 12, 4), "longitude": (0.0, 360.0),
              "latitude": (15.0, 55.0), "z": (-400.0, 0.0), "halo": 4,
              "topology": ("Periodic", "Bounded", "Bounded")},
        ic="zstar_catke_latlon", ref="zstar_catke_latlon"),
}
#: blocks narrower than their halo: 10 cells over 4 ranks under a halo of
#: 3 (blocks of 3, 3, 2 and 2); and a Bounded y so split, whose blocks'
#: halos reach past its walls, where the edge ranks' fills write
NARROW_CASES = {
    "narrow": dict(kind="nonhydrostatic",
                   grid=rect((10, 8, 4), PPB, 3, extent=(1.0, 1.0, 1.0)),
                   model={}, ic="pallas", dt=1e-3, steps=3,
                   partition=(4, 1)),
    "narrow_bounded": dict(
        kind="hydrostatic",
        grid=rect((16, 10, 4), ("Periodic", "Bounded", "Bounded"), 3,
                  x=(0, 1e5), y=(0, 5e4), z=(-500.0, 0.0)),
        model={"free_surface": ("SplitExplicitFreeSurface",
                                {"substeps": 12}),
               "tracers": ("T", "S"), "buoyancy": "SeawaterLinear"},
        ic="hydro", dt=30.0, steps=3, partition=(1, 4)),
}
#: the sharded cases' tolerances: 1e-13 for the JAX package's own, and
#: for the narrow blocks of its uneven (26, 10, 8) case's configuration
SHARDED_TOL = {"jax_sharded_serial": 1e-13, "orbax_halo_free": 1e-13,
               "narrow": 1e-13}
#: the fold's fills, bit for bit: the JAX test's TripolarGrid (26, 8, 4)
#: over (4, 1) (blocks of 7, 7, 6 and 6) and (2, 2), and the narrow
#: (24, 10, 4) over (1, 4)
FOLD_FILLS = {"x": ((26, 8, 4), (4, 1)), "xy": ((26, 8, 4), (2, 2)),
              "narrow": ((24, 10, 4), (1, 4))}
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
    it), every rank program run in one spawn of four gloo ranks, and,
    while the ranks run, every case's JAX serial state
    (:func:`sharded_reference`); ``(inputs, results)`` by case name."""
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
                 widened=widened)
    cases["gspmd"] = (gspmd, {"state": cases["hydro_split"][1],
                              "widened": arrays})
    built = {}
    for name, case in {**SHARDED_CASES, **NARROW_CASES}.items():
        # the cases of one reference share its model and initial state
        ref = case.get("ref", name)
        if ref in STEP_CASES:
            # an explicit-halo case's model and initial state
            built[ref] = inputs[ref], cases[ref][1]
        if ref not in built:
            grid, model = jax_model(case)
            arrays = initial_arrays(case)
            built[ref] = (grid, model, jax_state(model, arrays)), arrays
        inputs[name], arrays = built[ref]
        cases[name] = (dict(case, program="sharded"), arrays)
    rng = np.random.default_rng(0)
    for tag, (size, partition) in FOLD_FILLS.items():
        fill = dict(grid=dict(TRIPOLAR["grid"], size=size),
                    grid_kind="TripolarGrid", partition=partition,
                    program="fold_fill")
        shape = tuple(tr.grid_of(ot, torch, fill).shape)
        arrays = {loc: rng.standard_normal(shape) for loc in tr.FILL_LOCS}
        cases[f"fold_{tag}"] = (fill, arrays)
        inputs[f"fold_{tag}"] = (fill, arrays)
    cases["bounded_halo_free"] = (BOUNDED_HALO_FREE, {})
    # the ranks' device: launch's default, config.device (the CPU here);
    # this process only waits for them, so it steps the JAX references
    # meanwhile
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(launch, 4, tr.run_cases, (cases,),
                            rendezvous_dir=tmp_path_factory.mktemp("rdzv"),
                            backend="gloo")
        for name, case in {**STEP_CASES, **SPY_CASES, **SHARDED_CASES,
                           **NARROW_CASES, "widened": dict(steps=3, dt=1e-3),
                           "simulation": dict(SIMULATION, steps=6)}.items():
            sharded_reference(inputs, name, case)
        results = spawn.result()[0]
    return inputs, results


#: the JAX serial states of the cases, by reference
REFERENCES = {}


def sharded_reference(inputs, name, case):
    """The JAX serial state of a case (the cases of one reference share
    it, and every test that holds a case to it)."""
    ref = case.get("ref", name)
    if ref not in REFERENCES:
        model, state = inputs[name][1:3]
        REFERENCES[ref] = jax_arrays(serial_run(model, state, case))
    return REFERENCES[ref]


def serial_run(model, state, case):
    """The JAX package's serial steps (jitted, or eager where the case
    says so, its Thomas solves jitted: the eager solves' bits)."""
    step = ((lambda s: model.step(s, case["dt"])) if case.get("eager")
            else jax.jit(lambda s: model.step(s, case["dt"])))
    with jitted_thomas():
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
    "hydro_zstar_catke": {"u": 1e-12, "v": 1e-12, "tracers/T": 1e-11,
                          "tracers/S": 1e-11, "tracers/e": 1e-11},
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
    grid = inputs[name][0]
    ref = sharded_reference(inputs, name, case)
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
    serial step; a tripolar grid steps there too, its global state in and
    out, each field of its global shape."""
    inputs, results = ranks
    out = results["gspmd"]
    grid = inputs["hydro_split"][0]
    ref = sharded_reference(inputs, "hydro_split", STEP_CASES["hydro_split"])
    for key, tol in TOLERANCES["hydro_split"].items():
        np.testing.assert_allclose(interior(grid, out["state"][key]),
                                   interior(grid, ref[key]), rtol=0,
                                   atol=tol, err_msg=key)
    grid = inputs["widened"][0]
    ref = sharded_reference(inputs, "widened", dict(steps=3, dt=1e-3))
    for key in ("u", "v", "w"):
        np.testing.assert_allclose(interior(grid, out["widened"][key]),
                                   interior(grid, ref[key]), rtol=0,
                                   atol=1e-12, err_msg=key)
    tri = tr.grid_of(ot, torch, TRIPOLAR)
    for name in ("tripolar_x", "tripolar_xy"):
        got = results[name]["state"]
        assert int(got["iteration"]) == TRIPOLAR["steps"]
        for key in ("u", "v", "tracers/b"):
            assert got[key].shape == tuple(tri.shape), (name, key)
        assert got["eta"].shape == tuple(tri.shape[:2]) + (1,)
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
    check_sharded(ranks, name, SHARDED_CASES[name])


def check_sharded(ranks, name, case):
    """A sharded case's state against the JAX serial step's."""
    inputs, results = ranks
    grid = inputs[name][0]
    ref = sharded_reference(inputs, name, case)
    got = results[name]["state"]
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
        # a case's own tolerance of a group (its "atol"), else the case's
        tol = case.get("atol", {}).get(key.split("/")[0],
                                       SHARDED_TOL.get(name, 1e-12))
        want = interior(grid, ref[key])
        # the shallow water's h ~ 1e3 and uh ~ 1e2: relative to each
        # field's largest value, as tests/test_torch_shallow_water.py
        # holds the port's serial step to the JAX package's; so too the
        # shells' u, v and η, as tests/test_orthogonal_grids.py holds them
        scale = (np.abs(want).max()
                 if case["kind"] == "shallow_water"
                 or key in case.get("relative", ()) else 1.0)
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
                                       atol=SHARDED_TOL.get(name, 1e-12),
                                       err_msg=key)


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
    """Blocks narrower than their halo, whose halo cells reach past the
    neighbour (and, on a Bounded axis, past the wall), step through
    ``sharded_step_fn`` and match the JAX serial step: the nonhydrostatic
    x split at the 1e-13 of the JAX package's uneven case, the Bounded y
    split at 1e-12; its blocks as cut."""
    _, results = ranks
    for name, case in NARROW_CASES.items():
        check_sharded(ranks, name, case)
        axis = 0 if case["partition"][0] > 1 else 1
        blocks = [r["block"][axis] for r in results[name]["locals"]]
        assert blocks == [3, 3, 2, 2] and all(
            r["halo"][axis] == 3 for r in results[name]["locals"]), name


def test_halo_runs_image_every_halo_cell():
    """The exchange's runs (``halo_runs``) give every halo cell of every
    block the cell it images, on blocks of any width, whatever the
    periodicity (past a wall: no source); the second round's
    (``ghost_runs``) the wall's ghosts, and the left wall face where the
    fill writes it, in the other blocks' halos only; where every block is
    at least as wide as its halo, no second round but for that face."""
    from oceananigans_torch.parallel.distributed import (
        block_offsets, block_sizes,
    )
    from oceananigans_torch.parallel.halo_exchange import (
        ghost_runs, halo_runs,
    )
    for N, parts, h in ((10, 4, 3), (26, 4, 3), (5, 2, 3), (16, 4, 2),
                        (7, 3, 4), (12, 2, 6)):
        sizes = tuple(block_sizes(N, parts))
        offs = block_offsets(sizes)
        for periodic in (True, False):
            got = {}
            for dst, ds, src, ss, n in halo_runs(sizes, h, periodic):
                for k in range(n):
                    got[dst, ds + k] = (None if src is None else
                                        offs[src] - h + ss + k)
            for b, (nb, off) in enumerate(zip(sizes, offs)):
                for L in list(range(h)) + list(range(nb + h, nb + 2 * h)):
                    g = off - h + L
                    want = (g % N if periodic
                            else g if 0 <= g < N else None)
                    assert got.pop((b, L)) == want, (sizes, periodic, b, L)
            assert not got
        for low in (0, 1):
            runs = ghost_runs(sizes, h, low, h) or ()
            cells = set()
            for dst, ds, src, ss, n in runs:
                assert src in (0, parts - 1) and dst != src
                for k in range(n):
                    g = offs[dst] - h + ds + k
                    assert g == offs[src] - h + ss + k
                    cells.add((dst, ds + k))
            assert cells == {
                (b, L) for b, (nb, off) in enumerate(zip(sizes, offs))
                for L in list(range(h)) + list(range(nb + h, nb + 2 * h))
                if (b != 0 and -h <= off - h + L < low)
                or (b != parts - 1 and N <= off - h + L < N + h)}
            if min(sizes) >= h and sizes[0] > h:
                assert not runs


@pytest.mark.parametrize("tag", FOLD_FILLS)
def test_sharded_tripolar_fill_is_the_serial_fill(ranks, tag):
    """The sharded step's halo fill of a tripolar field (the fold across
    the ranks that hold the mirror columns) is bit for bit the JAX serial
    fill on every rank's block, halos included, at (C, C, C), (F, C, C)
    and (C, F, C); each 3-D fill folds once."""
    from oceananigans_tpu.boundary_conditions import fill_halo_regions
    from oceananigans_torch.parallel.distributed import (
        block_offsets, block_sizes,
    )
    inputs, results = ranks
    case, arrays = inputs[f"fold_{tag}"]
    grid = tr.grid_of(oj, jnp, case)
    out = results[f"fold_{tag}"]
    sizes = [block_sizes(n, p) for n, p in zip(grid.N, case["partition"])]
    offs = [block_offsets(s) for s in sizes]
    for name, a in arrays.items():
        loc = tuple(getattr(oj, c) for c in tr.FILL_LOCS[name])
        want = np.asarray(fill_halo_regions(jnp.asarray(a), grid, loc=loc))
        for rank, blocks in enumerate(out["blocks"]):
            rx, ry = divmod(rank, case["partition"][1])
            win = want[offs[0][rx]:offs[0][rx] + sizes[0][rx] + 2 * grid.Hx,
                       offs[1][ry]:offs[1][ry] + sizes[1][ry] + 2 * grid.Hy]
            np.testing.assert_array_equal(blocks[name], win,
                                          err_msg=f"{tag} {name} {rank}")
    assert out["counts"]["fold_3d"] == len(arrays)


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
    grid, path = inputs["simulation"][0], inputs["simulation"][3]
    out = results["simulation"]
    assert out["iteration"] == 6 and out["bitwise"]
    ref = sharded_reference(inputs, "simulation", dict(SIMULATION, steps=6))
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
