"""oceananigans_torch's output layer against the JAX package's, on the CPU in
float64.

The same run (or the same state, on the spherical grids) goes through the
JAX package's writers and the port's; the files are compared object by
object: dataset names, shapes, dtypes, attributes (apart from the NetCDF
``source``, which names the writing package), attached dimension scales,
and data to 1e-12 of each dataset's largest value. Covered: ``HDF5Writer``
(also ``with_halos`` and float32 storage), ``NetCDFWriter`` on rectilinear,
lat-lon, tripolar and C8 cubed-sphere grids with callable reduced outputs,
each package's files read by the other's ``load_field_time_series``, file
splitting by size and by schedule, the ``FieldTimeSeries`` backends,
``FieldDataset`` and ``WindowedTimeAverage``. Checkpoints: for the
nonhydrostatic AB2 model with a tracer, the hydrostatic split-explicit AB2
model, the shallow-water RK3 model and both cubed-sphere models, a run
picked up at iteration 5 is bitwise equal to the uninterrupted run and
within 1e-12 of the JAX package's. Time-based schedules on a float32 clock
whose Δt is not exact in binary. Also: ``Clock.start(datetime)`` and
``clock.date``. The JAX runs are shared through module-scoped fixtures.
"""

import dataclasses
import datetime
import functools
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch import output as tout
from oceananigans_torch.interop import (
    flatten_state, grid_from_arguments, state_from_numpy, unflatten_state,
)
from oceananigans_tpu import output as jout
from oceananigans_tpu.grids import cubed_sphere_grid as jcg
from oceananigans_tpu.grids.orthogonal import TripolarGrid as JTripolarGrid
from oceananigans_tpu.models import cubed_sphere as jcs
from oceananigans_tpu.models import hydrostatic as jhyd
from oceananigans_tpu.timesteppers import Clock as JClock

RTOL = 1e-12
F64 = np.float64
DT = 0.01
STEPS = 8


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


def jax_arrays(state):
    """A JAX state as the numpy mapping of ``interop.state_from_numpy``:
    members by name, dict entries as ``<member>/<key>``, the clock's
    ``time``, ``iteration`` and ``last_dt``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, JClock):
            out.update(time=np.asarray(v.time),
                       iteration=int(v.iteration),
                       last_dt=np.asarray(v.last_dt))
        elif isinstance(v, dict):
            out.update({f"{f.name}/{k}": np.asarray(a)
                        for k, a in v.items()})
        else:
            out[f.name] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# File comparison
# ---------------------------------------------------------------------------

#: HDF5 attributes that hold object references (compared through the
#: attached scales instead)
REFERENCE_ATTRS = {"DIMENSION_LIST", "REFERENCE_LIST"}


def h5_objects(path):
    """{name: (kind, shape, dtype, attrs, scales, data)} of every object
    of an HDF5 file, the root's ``source`` attribute left out."""
    out = {}
    with h5py.File(path, "r") as f:
        def describe(name, obj):
            attrs = {k: np.asarray(v) for k, v in obj.attrs.items()
                     if k not in REFERENCE_ATTRS
                     and not (name == "/" and k == "source")}
            if isinstance(obj, h5py.Dataset):
                scales = [[s.name for s in obj.dims[i].values()]
                          for i in range(obj.ndim)]
                out[name] = ("dataset", obj.shape, obj.dtype, attrs, scales,
                             np.asarray(obj))
            else:
                out[name] = ("group", None, None, attrs, None, None)
        describe("/", f)
        f.visititems(describe)
    return out


def assert_same_files(tpath, jpath, rtol=RTOL):
    """The port's file ``tpath`` has the JAX file's objects, layout and
    attributes, and its data within ``rtol`` of each dataset's largest
    value."""
    got, ref = h5_objects(tpath), h5_objects(jpath)
    assert sorted(got) == sorted(ref)
    for name, (kind, shape, dtype, attrs, scales, data) in ref.items():
        gk, gs, gd, ga, gsc, gdata = got[name]
        assert (gk, gs, gd) == (kind, shape, dtype), name
        assert sorted(ga) == sorted(attrs), name
        for k in attrs:
            assert np.array_equal(ga[k], attrs[k]), (name, k)
        assert gsc == scales, name
        if data is not None and data.size:
            scale = max(float(np.abs(data).max()), 1e-300)
            np.testing.assert_allclose(gdata, data, rtol=0,
                                       atol=rtol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# A nonhydrostatic run through both packages' Simulation with every writer
# ---------------------------------------------------------------------------

GRID = dict(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), halo=3,
            topology=(oj.Periodic, oj.Periodic, oj.Bounded))


def writers(pkg, out, d):
    """Each package's writers, into directory ``d``; ``out`` is the
    package's output module."""
    g = pkg.IterationInterval

    def profile(m, s):
        return pkg.Average(m.grid, s.tracers["c"], dims=(0, 1))

    def column_mean(m, s):
        return pkg.Average(m.grid, s.tracers["c"], dims=2)

    def weird(m, s):
        return np.zeros((5, 6, 4))          # no axis matches a scale

    def path(name):
        return os.path.join(d, name)

    return {
        "h5": out.HDF5Writer({"u": "u", "w": "w", "c": "c",
                              "pressure": "pressure", "cprof": profile},
                             path("fields.h5"), g(2), array_type=F64),
        "f32": out.HDF5Writer({"u": "u", "cprof": profile},
                              path("f32.h5"), g(4)),
        "halos": out.HDF5Writer({"u": "u", "c": "c"}, path("halos.h5"),
                                g(4), array_type=F64, with_halos=True),
        "nc": out.NetCDFWriter({"u": "u", "v": "v", "w": "w", "c": "c",
                                "cprof": profile, "cmean": column_mean,
                                "weird": weird}, path("fields.nc"), g(2),
                               array_type=F64,
                               global_attributes={"title": "parity"}),
        "avg": out.HDF5Writer(
            {"ua": out.WindowedTimeAverage("u"),
             "pa": out.WindowedTimeAverage(profile)}, path("avg.h5"),
            pkg.AveragedTimeInterval(4 * DT, window=2 * DT),
            array_type=F64),
        "size": out.HDF5Writer({"c": "c"}, path("size.h5"), g(1),
                               array_type=F64,
                               file_splitting=out.FileSizeLimit(12_000)),
        "sched": out.HDF5Writer({"c": "c"}, path("sched.h5"), g(1),
                                array_type=F64, file_splitting=g(3)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same AB2 run (tracer c, Δt = 0.01, 8 steps) through each
    package's Simulation with :func:`writers`; the port's also with a
    Checkpointer every 5 iterations. Returns {"j"|"t": (simulation,
    directory)}."""
    jg = oj.RectilinearGrid(dtype="float64", **GRID)
    tg = ot.RectilinearGrid(dtype=torch.float64, **GRID)
    jm = oj.models.NonhydrostaticModel(grid=jg, tracers=("c",),
                                       timestepper="QuasiAdamsBashforth2")
    tm = ot.NonhydrostaticModel(grid=tg, tracers=("c",),
                                timestepper="QuasiAdamsBashforth2")
    rng = np.random.default_rng(7)
    init = {n: rng.standard_normal(GRID["size"]) for n in ("u", "v", "w",
                                                           "c")}
    js = jm.initial_state(**init)
    ts = state_from_numpy(tm, jax_arrays(js))
    out = {}
    for key, pkg, outm, model, state in (("j", oj, jout, jm, js),
                                         ("t", ot, tout, tm, ts)):
        d = str(tmp_path_factory.mktemp(f"run_{key}"))
        sim = pkg.Simulation(model, state=state, dt=DT,
                             stop_iteration=STEPS)
        sim.output_writers.update(writers(pkg, outm, d))
        if key == "t":
            sim.output_writers["ckpt"] = ot.Checkpointer(
                os.path.join(d, "ckpt"), ot.IterationInterval(5))
        sim.run()
        out[key] = (sim, d)
    return out


@pytest.mark.parametrize("name", ["fields.h5", "f32.h5", "halos.h5",
                                  "fields.nc", "avg.h5"])
def test_files_match_jax(runs, name):
    """Each file of the run: HDF5 with float64 and float32 storage and
    with halos, NetCDF (staggered scales, callable reduced outputs, the
    global attributes), and the windowed time averages."""
    (_, jd), (_, td) = runs["j"], runs["t"]
    assert_same_files(os.path.join(td, name), os.path.join(jd, name))
    if name.endswith(".nc"):
        with h5py.File(os.path.join(td, name)) as f:
            assert f.attrs["source"] == "oceananigans_torch"
            assert f["cprof"].dims[3][0].name == "/z"
            assert f["u"].dims[1][0].name == "/xF"
            assert len(f["weird"].dims[1]) == 0


def test_series_cross_read(runs):
    """Each package's file read through the other's
    ``load_field_time_series``; the last u is the final interior u."""
    (jsim, jd), (tsim, td) = runs["j"], runs["t"]
    tpath, jpath = (os.path.join(d, "fields.h5") for d in (td, jd))
    for name in ("u", "c", "cprof"):
        a = ot.load_field_time_series(jpath, name)
        b = oj.load_field_time_series(tpath, name)
        np.testing.assert_array_equal(a.times, b.times)
        scale = np.abs(a.data).max()
        np.testing.assert_allclose(b.data, a.data, rtol=0,
                                   atol=RTOL * scale)
    u = ot.load_field_time_series(tpath, "u")
    assert np.array_equal(u[len(u) - 1],
                          tsim.model.grid.interior(tsim.state.u).numpy())
    np.testing.assert_allclose(u.times, DT * np.arange(0, STEPS + 1, 2),
                               rtol=RTOL)


def test_file_splitting(runs):
    """FileSizeLimit and a schedule split the series into the same parts in
    both packages, which together hold every write."""
    (_, jd), (_, td) = runs["j"], runs["t"]
    for base in ("size", "sched"):
        parts = sorted(p for p in os.listdir(td) if p.startswith(base))
        assert parts == sorted(p for p in os.listdir(jd)
                               if p.startswith(base))
        assert len(parts) >= 2
        total = 0
        for p in parts:
            assert_same_files(os.path.join(td, p), os.path.join(jd, p))
            total += len(ot.load_field_time_series(os.path.join(td, p), "c"))
        assert total == STEPS + 1


def test_field_time_series_backends(runs):
    """OnDisk and a moving InMemory window read what InMemory() holds; the
    interpolation in time agrees."""
    path = os.path.join(runs["t"][1], "fields.h5")
    full = ot.load_field_time_series(path, "c")
    disk = ot.load_field_time_series(path, "c", backend=ot.OnDisk())
    win = ot.load_field_time_series(path, "c", backend=ot.InMemory(3))
    assert len(full) == len(disk) == len(win) == STEPS // 2 + 1
    assert disk.data is None and win.data is None
    for i in (0, 4, 2, 3, 1):
        np.testing.assert_array_equal(full[i], disk[i])
        np.testing.assert_array_equal(full[i], win[i])
    jfull = oj.load_field_time_series(path, "c")
    for t in (-1.0, 0.033, 0.05, 1.0):
        np.testing.assert_array_equal(win.at_time(t), full.at_time(t))
        np.testing.assert_array_equal(disk.at_time(t), jfull.at_time(t))
    with pytest.raises(ValueError):
        ot.InMemory(1)


def test_field_dataset(runs):
    (_, jd), (_, td) = runs["j"], runs["t"]
    ds = ot.FieldDataset(os.path.join(td, "fields.h5"))
    jds = jout.FieldDataset(os.path.join(jd, "fields.h5"))
    assert ds.keys() == jds.keys() == ("c", "cprof", "pressure", "u", "w")
    assert list(ds) == list(ds.keys())
    np.testing.assert_allclose(ds["w"][2], jds["w"][2], rtol=0,
                               atol=RTOL * np.abs(jds["w"].data).max())
    assert ds["w"] is ds["w"]
    with pytest.raises(KeyError):
        ds["T"]


def test_windowed_time_average(runs):
    """The averaged u is the mean of the states inside each window: the
    port's run picked up at iteration 5 (bitwise the run, see
    test_checkpoint_pickup) is stepped again to take them."""
    tsim, td = runs["t"]
    series = ot.load_field_time_series(os.path.join(td, "avg.h5"), "ua")
    assert list(np.round(series.times / DT)) == [0, 4, 8]
    model = tsim.model
    s = ot.Checkpointer(os.path.join(td, "ckpt")).restore(
        model.initial_state(), os.path.join(td, "ckpt",
                                            "ckpt_iteration5.pt"))
    samples = {}
    for _ in range(3):
        s = model.step(s, DT)
        samples[s.clock.iteration] = model.grid.interior(s.u).clone()
    mean = (samples[6] + samples[7]) / 2
    assert torch.equal(torch.from_numpy(series[2]), mean)


#: a float32 clock's Δt that is not exact in binary: 50 steps of it end
#: 1.1e-10 s short of 50 Δt
F32_DT = 1e-4


@pytest.mark.parametrize("stop", ["iteration", "time"])
def test_float32_clock_time_schedules(tmp_path, stop):
    """On a float32 clock at Δt = 1e-4 s, time-based schedules actuate at
    their steps: a TimeInterval(50 Δt) callback at iterations 50 and 100,
    SpecifiedTimes(30 Δt, 75 Δt) at 30 and 75, a windowed average on
    AveragedTimeInterval(50 Δt, window=10 Δt) over the states after steps
    40-49 and 90-99; the run stops at iteration 100 by either stop rule,
    and every step is a plain Δt (the state equals the bare loop's bit for
    bit)."""
    dt, n = F32_DT, 100
    tg = ot.RectilinearGrid(dtype=torch.float32, **GRID)
    model = ot.NonhydrostaticModel(grid=tg)
    rng = np.random.default_rng(3)
    s0 = model.initial_state(**{k: rng.standard_normal((8, 8, 8))
                                for k in ("u", "v")})
    assert s0.clock.time.dtype == torch.float32
    keep = flatten_state(s0)

    def fresh():
        return unflatten_state(s0, {
            k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in keep.items()})

    bare, sums = model.fill_state_halos(fresh()), {}
    for it in range(1, n + 1):
        bare = model.step(bare, dt, assume_filled=True)
        if it % 50 >= 40:
            u = tg.interior(bare.u)
            end = it - it % 50 + 50
            sums[end] = u.clone() if end not in sums else sums[end] + u
    sim = ot.Simulation(model, state=fresh(), dt=dt,
                        **({"stop_iteration": n} if stop == "iteration"
                           else {"stop_time": n * dt}))
    seen = {"time": [], "specified": []}
    sim.callbacks["progress"] = ot.Callback(lambda s: None,
                                            ot.IterationInterval(10))
    for name, schedule in (("time", ot.TimeInterval(50 * dt)),
                           ("specified", ot.SpecifiedTimes(30 * dt,
                                                           75 * dt))):
        sim.callbacks[name] = ot.Callback(
            lambda s, name=name: seen[name].append(s.state.clock.iteration),
            schedule)
    path = os.path.join(tmp_path, "avg.h5")
    sim.output_writers["avg"] = ot.HDF5Writer(
        {"u": ot.WindowedTimeAverage("u")}, path,
        ot.AveragedTimeInterval(50 * dt, window=10 * dt))
    sim.run()
    assert sim.state.clock.iteration == n
    assert seen == {"time": [0, 50, 100], "specified": [30, 75]}
    a, b = flatten_state(sim.state), flatten_state(bare)
    assert all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else a[k] == b[k] for k in a)
    series = ot.load_field_time_series(path, "u")
    assert [round(float(t) / dt) for t in series.times] == [0, 50, 100]
    for i, end in ((1, 50), (2, 100)):
        mean = sums[end] / torch.tensor(10.0, dtype=torch.float32)
        assert torch.equal(torch.from_numpy(series[i]), mean), end


# ---------------------------------------------------------------------------
# The spherical grids (no step: both packages write the same state)
# ---------------------------------------------------------------------------

def latlon_models():
    kw = dict(size=(12, 8, 4), longitude=(0.0, 60.0), latitude=(10.0, 50.0),
              z=(-100.0, 0.0))
    jm = jhyd.HydrostaticFreeSurfaceModel(
        grid=oj.LatitudeLongitudeGrid(dtype="float64", **kw),
        tracers=("T",))
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=ot.LatitudeLongitudeGrid(dtype=torch.float64, **kw),
        tracers=("T",))
    return jm, tm, {"u": "u", "v": "v", "eta": "eta", "T": "T"}


def tripolar_models():
    kw = dict(size=(12, 9, 3), z=(-100.0, 0.0), halo=3)
    jm = jhyd.HydrostaticFreeSurfaceModel(
        grid=JTripolarGrid(dtype="float64", **kw), tracers=("T",))
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=ot.TripolarGrid(dtype=torch.float64, **kw), tracers=("T",))
    return jm, tm, {"u": "u", "v": "v", "w": "w", "eta": "eta", "T": "T"}


@functools.cache
def cube_grids(Nz):
    """Both packages' C8 grids with ``Nz`` levels, built once (a model
    does not change its grid)."""
    kw = dict(panel_size=(8, Nz), z=(-1000.0, 0.0), dtype="float64")
    return (jcg.ConformalCubedSphereGrid(**kw),
            grid_from_arguments("cubed_sphere", **kw))


def cube_models():
    jg, tg = cube_grids(2)
    return (jcs.CubedSphereHydrostaticModel(jg),
            ot.CubedSphereHydrostaticModel(tg),
            {"u": "u", "v": "v", "b": "b", "eta": "eta"})


class _Sim:
    """What a writer reads of a simulation."""

    def __init__(self, model, state):
        self.model, self.state = model, state


@pytest.mark.parametrize("family", ["latlon", "tripolar", "cube"])
def test_spherical_files_match_jax(tmp_path, family):
    """NetCDF and HDF5 files of the same seeded state on a lat-lon, a
    tripolar and a C8 cubed-sphere grid (coordinate schemas, staggered and
    auxiliary coordinates, the panel axis, η's reduced z), written twice,
    and a callable horizontal mean."""
    jm, tm, outputs = {"latlon": latlon_models, "tripolar": tripolar_models,
                       "cube": cube_models}[family]()
    js = jm.initial_state()
    arrays = jax_arrays(js)
    rng = np.random.default_rng(3)
    for k in outputs:
        key = k if k in arrays else f"tracers/{k}"
        arrays[key] = rng.standard_normal(arrays[key].shape)
    js = js.__class__(**{**js.__dict__, **{
        k: jnp.asarray(v) for k, v in arrays.items() if "/" not in k
        and k in js.__dict__}, "tracers": {
            n: jnp.asarray(arrays[f"tracers/{n}"]) for n in js.tracers}})
    ts = state_from_numpy(tm, arrays)
    for pkg, out, model, state in (("j", jout, jm, js), ("t", tout, tm, ts)):
        lib = oj if pkg == "j" else ot
        outs = dict(outputs)
        if family == "cube":
            outs["eta2d"] = lambda m, s: m.grid.interior(s.eta)[..., 0]
        else:
            outs["Tmean"] = (lambda m, s, lib=lib: lib.Average(
                m.grid, s.tracers["T"], dims=2))
        sim = _Sim(model, state)
        for w in (out.NetCDFWriter(outs, tmp_path / f"{pkg}.nc",
                                   ot.IterationInterval(1), array_type=F64),
                  out.HDF5Writer(outs, tmp_path / f"{pkg}.h5",
                                 ot.IterationInterval(1), array_type=F64)):
            w.write(sim)
            w.write(sim)
    for ext in ("nc", "h5"):
        assert_same_files(tmp_path / f"t.{ext}", tmp_path / f"j.{ext}")


def test_h5py_is_imported_lazily(monkeypatch, tmp_path):
    """Without h5py the writers and readers raise an ImportError naming
    it; the package and its checkpoints need no h5py."""
    import builtins
    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    tg = ot.RectilinearGrid(dtype=torch.float64, **GRID)
    model = ot.NonhydrostaticModel(grid=tg)
    sim = ot.Simulation(model, dt=DT, stop_iteration=1)
    for w in (ot.HDF5Writer({"u": "u"}, tmp_path / "a.h5",
                            ot.IterationInterval(1)),
              ot.NetCDFWriter({"u": "u"}, tmp_path / "a.nc",
                              ot.IterationInterval(1))):
        assert w.fetch(sim)["u"].dtype == np.float32
        with pytest.raises(ImportError, match="h5py"):
            w.write(sim)
    with pytest.raises(ImportError, match="h5py"):
        ot.load_field_time_series(tmp_path / "a.h5", "u")
    ckpt = ot.Checkpointer(tmp_path / "ckpt")
    ckpt.write(sim)
    assert ckpt.restore(model.initial_state()).clock.iteration == 0


def test_package_imports_without_h5py_and_matplotlib():
    """``import oceananigans_torch`` (and its output and plotting modules)
    needs neither h5py nor matplotlib, which the card's machine lacks."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['h5py'] = None; "
            "sys.modules['matplotlib'] = None; import oceananigans_torch; "
            "import oceananigans_torch.output, "
            "oceananigans_torch.utils.plotting; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# Checkpoint pickup
# ---------------------------------------------------------------------------

def _nonhydrostatic():
    kw = dict(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), halo=3,
              topology=(oj.Periodic, oj.Periodic, oj.Bounded))
    mk = dict(tracers=("c",), timestepper="QuasiAdamsBashforth2")
    jm = oj.models.NonhydrostaticModel(
        grid=oj.RectilinearGrid(dtype="float64", **kw), **mk)
    tm = ot.NonhydrostaticModel(
        grid=ot.RectilinearGrid(dtype=torch.float64, **kw), **mk)
    rng = np.random.default_rng(1)
    return jm, tm, jm.initial_state(**{
        n: rng.standard_normal((8, 8, 8)) for n in ("u", "v", "c")}), 0.01


def _hydrostatic():
    kw = dict(size=(8, 8, 4), extent=(1e5, 1e5, 1e3), halo=3,
              topology=(oj.Periodic, oj.Bounded, oj.Bounded))
    jm = jhyd.HydrostaticFreeSurfaceModel(
        grid=oj.RectilinearGrid(dtype="float64", **kw), tracers=("T",),
        free_surface=jhyd.SplitExplicitFreeSurface(substeps=8))
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=ot.RectilinearGrid(dtype=torch.float64, **kw), tracers=("T",),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8))
    return jm, tm, jm.initial_state(
        u=lambda x, y, z: 0.1 * jnp.sin(2 * np.pi * x / 1e5),
        T=lambda x, y, z: 10.0 + 1e-3 * z + jnp.cos(2 * np.pi * y / 1e5)
    ), 30.0


def _shallow_water():
    kw = dict(size=(8, 8), extent=(1e5, 1e5), halo=3,
              topology=(oj.Periodic, oj.Periodic, oj.Flat))
    jm = oj.models.ShallowWaterModel(
        grid=oj.RectilinearGrid(dtype="float64", **kw),
        gravitational_acceleration=9.81, tracers=("c",))
    tm = ot.ShallowWaterModel(
        grid=ot.RectilinearGrid(dtype=torch.float64, **kw),
        gravitational_acceleration=9.81, tracers=("c",))
    return jm, tm, jm.initial_state(
        h=lambda x, y, z: 10.0 + jnp.exp(-((x - 5e4) ** 2) / 4e8),
        c=lambda x, y, z: jnp.sin(2 * np.pi * y / 1e5)), 20.0


def _cube_bump(grid):
    g = grid.panel_grid
    H, N = g.Hx, grid.N_panel
    e = np.zeros((6, g.shape[0], g.shape[1], 1))
    e[:, H:H + N, H:H + N, 0] = np.exp(
        -((grid.lam_cc - 30.0) ** 2 + grid.phi_cc ** 2) / 400.0)
    return e


def _cube_sw():
    jg, tg = cube_grids(1)
    jm = jcs.CubedSphereShallowWaterModel(jg, tracers=("c",))
    tm = ot.CubedSphereShallowWaterModel(tg, tracers=("c",))
    h = 1000.0 + 10.0 * _cube_bump(jg)
    return jm, tm, jm.initial_state(h=h, c=jg.set_tracer(
        lambda lam, phi, z: np.cos(np.deg2rad(phi)))), 300.0


def _cube_hydrostatic(timestepper):
    def make():
        jg, tg = cube_grids(2)
        jm = jcs.CubedSphereHydrostaticModel(jg, timestepper=timestepper)
        tm = ot.CubedSphereHydrostaticModel(tg, timestepper=timestepper)
        return jm, tm, jm.initial_state(
            eta=0.5 * _cube_bump(jg),
            b=lambda lam, phi, z: 1e-5 * z), 600.0
    return make


#: each case's model factory and how its JAX reference steps: jitted, or
#: eagerly where that is quicker than the compile (the cube's shallow
#: water); the cube's RK3 hydrostatic case holds the pickup of a state
#: whose G's are None
PICKUP_CASES = {
    "nonhydrostatic_ab2": (_nonhydrostatic, "jit"),
    "hydrostatic_split_ab2": (_hydrostatic, "jit"),
    "shallow_water_rk3": (_shallow_water, "jit"),
    "cube_shallow_water": (_cube_sw, "eager"),
    "cube_hydrostatic_ab2": (_cube_hydrostatic("QuasiAdamsBashforth2"),
                             "jit"),
    "cube_hydrostatic_rk3": (_cube_hydrostatic("RungeKutta3"), "jit"),
}
PICKUP_STEPS, PICKUP_AT = 6, 5


#: the second member of each horizontal pair, held to the pair's largest
#: value (a component that is zero by symmetry picks up rounding noise in
#: one package and not the other)
PAIRS = {"v": "u", "V": "U", "Gv": "Gu", "vh": "uh", "Gvh": "Guh"}


def assert_close_to_jax(tm, ts, js):
    """Every interior field of the port's state within 1e-12 of the JAX
    state's largest value of that field (of the pair, for the horizontal
    components); the same clock."""
    ref = jax_arrays(js)
    got = flatten_state(ts)
    assert set(got) <= set(ref)
    for key, a in got.items():
        if key in ("time", "iteration", "last_dt"):
            continue
        b = tm.grid.interior(ref[key])
        a = tm.grid.interior(a).numpy()
        pair = {v: k for k, v in PAIRS.items()}.get(key, PAIRS.get(key))
        scale = max(float(np.abs(b).max()), 1e-300,
                    float(np.abs(ref[pair]).max()) if pair in ref else 0)
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale,
                                   err_msg=key)
    assert ts.clock.iteration == ref["iteration"]
    assert float(ts.clock.time) == pytest.approx(float(ref["time"]),
                                                 rel=RTOL)


@pytest.mark.parametrize("case", sorted(PICKUP_CASES))
def test_checkpoint_pickup(tmp_path, case):
    """6 steps with a Checkpointer every 5; a second Simulation picks up
    at iteration 5 (``run(pickup=True)``) and runs to 6: bitwise equal
    to the uninterrupted run, iteration 5 after the restore, and within
    1e-12 of the JAX package's 6 steps."""
    make, jax_mode = PICKUP_CASES[case]
    jm, tm, js, dt = make()
    arrays = jax_arrays(js)
    sims = []
    for pickup in (False, True):
        sim = ot.Simulation(tm, state=state_from_numpy(tm, arrays), dt=dt,
                            stop_iteration=PICKUP_STEPS)
        sim.output_writers["ckpt"] = ot.Checkpointer(
            tmp_path, ot.IterationInterval(PICKUP_AT), cleanup=True,
            keep=1)
        if pickup:
            restored = sim.output_writers["ckpt"].restore(sim.state)
            assert restored.clock.iteration == PICKUP_AT
            assert isinstance(restored.clock.iteration, int)
            assert restored.clock.time.dtype == torch.float64
        sim.run(pickup=pickup)
        sims.append(sim)
    # cleanup kept the last one
    assert os.listdir(tmp_path) == ["ckpt_iteration5.pt"]
    a, b = (flatten_state(s.state) for s in sims)
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert a[key].dtype == b[key].dtype
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key
    if case == "cube_hydrostatic_rk3":
        assert sims[1].state.Gu is None
    step = jax.jit(jm.step) if jax_mode == "jit" else jm.step
    for _ in range(PICKUP_STEPS):
        js = step(js, dt)
    assert_close_to_jax(tm, sims[1].state, js)


def test_pickup_needs_a_checkpointer(tmp_path):
    tg = ot.RectilinearGrid(dtype=torch.float64, **GRID)
    sim = ot.Simulation(ot.NonhydrostaticModel(grid=tg), dt=DT,
                        stop_iteration=1)
    with pytest.raises(ValueError, match="Checkpointer"):
        sim.run(pickup=True)
    # the sharded checkpointer is a Checkpointer: one without checkpoints
    # has nothing to pick up from
    sim.output_writers["sharded"] = tout.OrbaxCheckpointer(tmp_path / "x")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        sim.run(pickup=True)


# ---------------------------------------------------------------------------
# Calendar clocks
# ---------------------------------------------------------------------------

def test_datetime_clock():
    """``Clock.start(datetime)`` starts at 0 s with the epoch; a model run
    carries it and ``clock.date`` reads epoch + time, as in the JAX
    package."""
    t0 = datetime.datetime(2021, 3, 1, 12, 0, 0)
    tc, jc = ot.Clock.start(t0), JClock.start(t0)
    assert tc.epoch == jc.epoch == t0
    assert float(tc.time) == float(jc.time) == 0.0
    assert tc.date == jc.date == t0
    assert ot.Clock.start(5.0).date is None
    tg = ot.RectilinearGrid(dtype=torch.float64, **GRID)
    model = ot.NonhydrostaticModel(grid=tg, timestepper="QuasiAdamsBashforth2")
    s = model.initial_state(time=t0)
    for _ in range(3):
        s = model.step(s, 30.0)
    assert s.clock.date == t0 + datetime.timedelta(seconds=90)
    jc = dataclasses.replace(jc, time=jnp.asarray(90.0))
    assert s.clock.date == jc.date
    assert model.initial_state().clock.date is None
