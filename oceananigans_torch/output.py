"""Output writers and readers: HDF5 and NetCDF field output, time averages,
checkpoints, field time series.

Counterpart of ``oceananigans_tpu/output.py`` (reference
``src/OutputWriters/`` and ``src/OutputReaders/``: ``JLD2Writer``,
``NetCDFWriter``, ``Checkpointer``, ``WindowedTimeAverage``,
``FieldTimeSeries``). The writers run on the host between windows of
steps. Each output crosses from the device once a write: it is cast to the
writer's ``array_type`` on the device first, so a float64 run copies half
the bytes, and the copy waits for the device's queue. A file written by
either package has the same datasets, shapes, dtypes, attributes and
dimension scales, and reads in the other; only the NetCDF ``source``
attribute names the writing package.

A ``WindowedTimeAverage`` sums its output on the device, in the output's
dtype; the average crosses to the host when its writer writes.

A ``Checkpointer`` saves every tensor of a state with ``torch.save``, as a
flat dict keyed as ``oceananigans_torch.interop`` names the arrays (``u``,
``tracers/T``, ``Gtracers/T``, ``time``, ``iteration``, ``last_dt``, …):
it keeps every dtype bit for bit and needs no package beyond PyTorch.

h5py is imported where a file is opened, not with this module, so the
package imports without it; a writer or reader of HDF5 or NetCDF files
raises an ``ImportError`` naming h5py where it is missing.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

from oceananigans_torch.grids.base import Center, Face
from oceananigans_torch.interop import flatten_state, unflatten_state
from oceananigans_torch.utils.schedules import IterationInterval

__all__ = ["HDF5Writer", "JLD2Writer", "NetCDFWriter", "Checkpointer",
           "OrbaxCheckpointer", "FieldTimeSeries", "FieldDataset",
           "FileSizeLimit", "InMemory", "OnDisk", "load_field_time_series",
           "WindowedTimeAverage"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5 and NetCDF files need the h5py package, "
                          "which is not installed") from e
    return h5py


def _numpy(a):
    """A host numpy array of a tensor (copied from its device) or of any
    array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)


def _value(model, state, output, with_halos=False):
    """One named output as it lies in the state (a field name, or
    ``pressure``), its interior unless ``with_halos``; or what a callable
    ``f(model, state)`` returns."""
    if callable(output):
        return output(model, state)
    fields = state.fields()
    if output in fields:
        a = fields[output]
    elif output == "pressure":
        a = state.pressure
    else:
        raise KeyError(f"unknown output {output!r}")
    return a if with_halos else model.grid.interior(a)


def _fetch(model, state, output, with_halos=False, array_type=None):
    """One output on the host as numpy (reference ``fetch_output.jl``): a
    tensor is cast to ``array_type`` on its device, made contiguous there,
    and copied once."""
    v = _value(model, state, output, with_halos)
    if isinstance(v, torch.Tensor):
        if array_type is not None:
            v = v.to(getattr(torch, np.dtype(array_type).name))
        return _numpy(v.contiguous())
    v = np.asarray(v)
    return v if array_type is None else v.astype(array_type)


def _output_location(model, output):
    """Staggered location of a named output ("fcc" style letters, one per
    axis: the reference's ``loc2letter``). Callable outputs and unknown
    names are at cell centers."""
    if not isinstance(output, str):
        return "ccc"
    locs = getattr(model, "locations", None)
    loc = None
    if locs and output in locs:
        loc = locs[output]
    elif output in ("u", "uh"):
        loc = (Face, Center, Center)
    elif output in ("v", "vh"):
        loc = (Center, Face, Center)
    elif output == "w":
        loc = (Center, Center, Face)
    if loc is None:
        return "ccc"
    return "".join("f" if l == Face else "c" for l in loc)


class _Writer:
    """What the HDF5 and NetCDF writers share: the outputs, the schedule,
    the stored dtype and the fetch of every output to the host."""

    with_halos = False

    def _setup(self, outputs, filename, schedule, array_type,
               overwrite_existing):
        self.outputs = outputs
        self.schedule = schedule
        self.array_type = array_type
        if overwrite_existing and os.path.exists(filename):
            os.remove(filename)
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        self._initialized = False

    def fetch(self, sim):
        """Every output on the host, cast to ``array_type``: the part of a
        write that touches the device."""
        return {name: _fetch(sim.model, sim.state, out, self.with_halos,
                             self.array_type)
                for name, out in self.outputs.items()}


class HDF5Writer(_Writer):
    """Writes named outputs on a schedule into one HDF5 file with an
    unlimited time axis (the reference's ``JLD2Writer``; JLD2 is an HDF5
    container).

    Layout: ``/times`` (T,), ``/iterations`` (T,), ``/fields/<name>`` (T,
    nx, ny, nz), ``/grid/{x,y,z}`` and ``/grid/{xF,yF,zF}`` coordinate
    vectors. ``file_splitting`` (a ``FileSizeLimit`` or any schedule)
    sends later writes to ``_part2``, ``_part3``, … files.
    """

    def __init__(self, outputs, filename, schedule, array_type=np.float32,
                 overwrite_existing=True, with_halos=False,
                 file_splitting=None):
        self.base_filename = str(filename)
        self.with_halos = with_halos
        self.file_splitting = file_splitting
        self.part = 1
        self.filename = self._part_filename()
        self._setup(outputs, self.filename, schedule, array_type,
                    overwrite_existing)

    def _part_filename(self):
        if self.file_splitting is None or self.part == 1:
            return self.base_filename
        root, ext = os.path.splitext(self.base_filename)
        return f"{root}_part{self.part}{ext}"

    def _maybe_split(self, sim):
        fs = self.file_splitting
        if fs is None or not self._initialized:
            return
        if isinstance(fs, FileSizeLimit):
            split = (os.path.exists(self.filename)
                     and os.path.getsize(self.filename) >= fs.size_limit)
        else:
            split = fs.actuates(sim.state.clock)
        if split:
            self.part += 1
            self.filename = self._part_filename()
            if os.path.exists(self.filename):
                os.remove(self.filename)
            self._initialized = False

    def _init_file(self, h5py, sim, shapes):
        with h5py.File(self.filename, "a") as f:
            f.create_dataset("times", shape=(0,), maxshape=(None,),
                             dtype=np.float64)
            f.create_dataset("iterations", shape=(0,), maxshape=(None,),
                             dtype=np.int64)
            g = sim.model.grid
            grp = f.create_group("grid")
            grp.create_dataset("x", data=_numpy(g.xnodes()).ravel())
            grp.create_dataset("y", data=_numpy(g.ynodes()).ravel())
            grp.create_dataset("z", data=_numpy(g.znodes()).ravel())
            # face coordinates for staggered fields
            grp.create_dataset("xF", data=_numpy(g.xnodes(Face)).ravel())
            grp.create_dataset("yF", data=_numpy(g.ynodes(Face)).ravel())
            grp.create_dataset("zF", data=_numpy(g.znodes(Face)).ravel())
            grp.attrs["Nx"], grp.attrs["Ny"], grp.attrs["Nz"] = g.N
            fg = f.create_group("fields")
            for name, shape in shapes.items():
                ds = fg.create_dataset(name, shape=(0, *shape),
                                       maxshape=(None, *shape),
                                       dtype=self.array_type,
                                       chunks=(1, *shape))
                ds.attrs["location"] = _output_location(
                    sim.model, self.outputs[name])
        self._initialized = True

    def write(self, sim):
        h5py = _h5py()
        self._maybe_split(sim)
        data = self.fetch(sim)
        if not self._initialized:
            self._init_file(h5py, sim, {k: v.shape for k, v in data.items()})
        with h5py.File(self.filename, "a") as f:
            n = f["times"].shape[0]
            f["times"].resize((n + 1,))
            f["times"][n] = float(sim.state.clock.time)
            f["iterations"].resize((n + 1,))
            f["iterations"][n] = int(sim.state.clock.iteration)
            for name, arr in data.items():
                ds = f["fields"][name]
                ds.resize((n + 1, *arr.shape))
                ds[n] = arr


#: the reference's name
JLD2Writer = HDF5Writer


class NetCDFWriter(_Writer):
    """CF-style netCDF-4 output (reference ``netcdf_writer.jl``): netCDF-4
    is an HDF5 profile, so the file is written with h5py, with dimension
    scales (time, and x/y/z at each staggering) attached to each variable
    and CF attributes, readable by netCDF4, xarray and ncdump."""

    def __init__(self, outputs, filename, schedule, array_type=np.float32,
                 overwrite_existing=True, global_attributes=None):
        self.filename = str(filename)
        self.global_attributes = dict(global_attributes or {})
        self._setup(outputs, self.filename, schedule, array_type,
                    overwrite_existing)

    @staticmethod
    def _coordinate_schema(g):
        """CF coordinates per grid family, with both staggerings of every
        spatial axis (reference ``ext/OceananigansNCDatasetsExt.jl``):

        - rectilinear: ``x``/``xF``, ``y``/``yF``, ``z``/``zF`` in metres;
        - ``LatitudeLongitudeGrid``: ``longitude``/``longitude_f``,
          ``latitude``/``latitude_f``;
        - orthogonal shells (rotated, tripolar): index dims ``i``/``i_f``,
          ``j``/``j_f`` and 2-D geographic auxiliary coordinates at (c, c),
          (f, c) and (c, f);
        - ``ConformalCubedSphereGrid``: a leading ``panel`` dim and the
          same per panel;
        - ``ImmersedBoundaryGrid``: its underlying grid's.

        Returns ``(panel, axes, aux, coords)``: the panel dim or None; per
        spatial axis ``{"c": (name, values, attrs), "f": (...)}`` (faces
        trimmed to N, the first face of each interior cell); the 2-D
        coordinate variables; and the CF ``coordinates`` attribute per
        horizontal staggering ("cc", "fc", "cf").
        """
        from oceananigans_torch.grids.cubed_sphere_grid import (
            ConformalCubedSphereGrid, panel_geographic_coords,
        )
        from oceananigans_torch.grids.latlon import LatitudeLongitudeGrid
        from oceananigans_torch.grids.orthogonal import (
            OrthogonalSphericalShellGrid,
        )
        from oceananigans_torch.immersed import ImmersedBoundaryGrid
        if isinstance(g, ImmersedBoundaryGrid):
            g = g.underlying_grid
        deg_e = {"units": "degrees_east", "standard_name": "longitude"}
        deg_n = {"units": "degrees_north", "standard_name": "latitude"}
        zattrs = {"units": "m", "positive": "up", "standard_name": "depth"}
        geo_coords = {"cc": "longitude latitude",
                      "fc": "longitude_fc latitude_fc",
                      "cf": "longitude_cf latitude_cf"}

        def zaxis():
            zc = _numpy(g.znodes()).ravel()
            zf = _numpy(g.znodes(Face)).ravel()[:len(zc)]
            return {"c": ("z", zc, zattrs), "f": ("zF", zf, zattrs)}

        def index_axes(nx, ny, what):
            return [{"c": ("i", np.arange(nx),
                           {"long_name": f"{what} x index"}),
                     "f": ("i_f", np.arange(nx),
                           {"long_name": f"{what} x face index"})},
                    {"c": ("j", np.arange(ny),
                           {"long_name": f"{what} y index"}),
                     "f": ("j_f", np.arange(ny),
                           {"long_name": f"{what} y face index"})},
                    zaxis()]

        def geo_aux(lam_cc, phi_cc, lam_fc, phi_fc, lam_cf, phi_cf):
            return [("longitude", lam_cc, deg_e),
                    ("latitude", phi_cc, deg_n),
                    ("longitude_fc", lam_fc, deg_e),
                    ("latitude_fc", phi_fc, deg_n),
                    ("longitude_cf", lam_cf, deg_e),
                    ("latitude_cf", phi_cf, deg_n)]

        if isinstance(g, ConformalCubedSphereGrid):
            N = g.N_panel
            panel = ("panel", np.arange(6), {"long_name": "cube panel"})
            # the same coordinates the model evaluates forcings and
            # boundary conditions on
            d = 2.0 / N
            tC = -1.0 + d * (np.arange(N) + 0.5)
            tF = -1.0 + d * np.arange(N)
            lam_fc, phi_fc = panel_geographic_coords(tF, tC)
            lam_cf, phi_cf = panel_geographic_coords(tC, tF)
            aux = geo_aux(np.asarray(g.lam_cc), np.asarray(g.phi_cc),
                          lam_fc, phi_fc, lam_cf, phi_cf)
            return panel, index_axes(N, N, "panel"), aux, geo_coords
        if isinstance(g, OrthogonalSphericalShellGrid):
            sx, sy, _ = g.interior_slices
            nodes = [_numpy(getattr(g, name))[sx, sy, 0] for name in (
                "lamCC", "phiCC", "lamFC", "phiFC", "lamCF", "phiCF")]
            return (None, index_axes(g.N[0], g.N[1], "grid"),
                    geo_aux(*nodes), geo_coords)
        if isinstance(g, LatitudeLongitudeGrid):
            axes = [
                {"c": ("longitude", _numpy(g.xnodes()).ravel(), deg_e),
                 "f": ("longitude_f",
                       _numpy(g.xnodes(Face)).ravel()[:g.N[0]], deg_e)},
                {"c": ("latitude", _numpy(g.ynodes()).ravel(), deg_n),
                 "f": ("latitude_f",
                       _numpy(g.ynodes(Face)).ravel()[:g.N[1]], deg_n)},
                zaxis(),
            ]
            return None, axes, [], {}
        m = {"units": "m"}
        axes = [
            {"c": ("x", _numpy(g.xnodes()).ravel(), m),
             "f": ("xF", _numpy(g.xnodes(Face)).ravel()[:g.N[0]], m)},
            {"c": ("y", _numpy(g.ynodes()).ravel(), m),
             "f": ("yF", _numpy(g.ynodes(Face)).ravel()[:g.N[1]], m)},
            zaxis(),
        ]
        return None, axes, [], {}

    def _attach_scales(self, ds, name, shape, loc, panel_ds, scale_ds):
        """Attach the dimension scales of one variable's spatial axes. A
        named output is interior-shaped, so a mismatch raises; a callable
        output may drop axes (a profile, a horizontal mean): an axis of
        length 1 stays unattached, and one whose located coordinate does
        not match takes the first center scale of its length, if any."""
        strict = isinstance(self.outputs[name], str)
        off = 1 if panel_ds is not None else 0
        for di, n in enumerate(shape, start=1):
            ax = di - 1
            if panel_ds is not None and ax == 0:
                if n == 6:
                    ds.dims[di].attach_scale(panel_ds)
                    continue
                if strict:
                    raise ValueError(f"output {name!r}: leading axis has "
                                     f"length {n}, expected 6 panels")
            sp = ax - off
            if sp >= 3 or sp < 0:
                if strict:
                    raise ValueError(f"output {name!r} has more than 3 "
                                     f"spatial axes (shape {shape})")
                continue
            sds = scale_ds[sp][loc[sp]]
            ln = sds.shape[0]
            if n == 1 and ln != 1:
                continue        # a reduced axis (η's z)
            if ln != n:
                if strict:
                    raise ValueError(
                        f"output {name!r} axis {sp} has length {n} but its "
                        f"{loc[sp]!r}-located coordinate {sds.name!r} has "
                        f"{ln}; writer outputs must be interior-shaped")
                for alt in scale_ds:
                    if alt["c"].shape[0] == n:
                        ds.dims[di].attach_scale(alt["c"])
                        break
                continue
            ds.dims[di].attach_scale(sds)

    def _init_file(self, h5py, sim, shapes):
        panel, axes, aux, coords = self._coordinate_schema(sim.model.grid)
        with h5py.File(self.filename, "a") as f:
            for key, val in self.global_attributes.items():
                f.attrs[key] = val
            f.attrs["Conventions"] = "CF-1.8"
            f.attrs["source"] = "oceananigans_torch"
            t = f.create_dataset("time", shape=(0,), maxshape=(None,),
                                 dtype=np.float64)
            t.attrs["units"] = "seconds"
            t.attrs["long_name"] = "model time"
            t.make_scale("time")

            def variable(name, vals, attrs, scale):
                d = f.create_dataset(name, data=vals)
                for k, v in attrs.items():
                    d.attrs[k] = v
                if scale:
                    d.make_scale(name)
                return d

            panel_ds = variable(*panel, True) if panel is not None else None
            scale_ds = [{key: variable(*ent, True)
                         for key, ent in ax.items()} for ax in axes]
            for ent in aux:
                variable(*ent, False)
            for name, shape in shapes.items():
                loc = _output_location(sim.model, self.outputs[name])
                ds = f.create_dataset(name, shape=(0, *shape),
                                      maxshape=(None, *shape),
                                      dtype=self.array_type,
                                      chunks=(1, *shape))
                ds.attrs["location"] = loc
                ds.dims[0].attach_scale(f["time"])
                self._attach_scales(ds, name, shape, loc, panel_ds, scale_ds)
                hloc = loc[:2]
                if coords.get(hloc):
                    ds.attrs["coordinates"] = coords[hloc]
                elif coords.get("cc"):
                    ds.attrs["coordinates"] = coords["cc"]
        self._initialized = True

    def write(self, sim):
        h5py = _h5py()
        data = self.fetch(sim)
        if not self._initialized:
            self._init_file(h5py, sim, {k: v.shape for k, v in data.items()})
        with h5py.File(self.filename, "a") as f:
            n = f["time"].shape[0]
            f["time"].resize((n + 1,))
            f["time"][n] = float(sim.state.clock.time)
            for name, arr in data.items():
                ds = f[name]
                ds.resize((n + 1, *arr.shape))
                ds[n] = arr


class WindowedTimeAverage:
    """Wraps an output so that its writer receives its average over the
    trailing window (reference ``windowed_time_average.jl``). With an
    ``AveragedTimeInterval`` schedule, ``Simulation`` calls ``accumulate``
    after each step inside the window. The sum stays on the output's
    device, in its dtype, summed in the order the JAX package sums."""

    def __init__(self, output):
        self.output = output
        self._sum = None
        self._n = 0

    def accumulate(self, model, state):
        v = _value(model, state, self.output)
        if self._sum is None:
            self._sum = (v.clone() if isinstance(v, torch.Tensor)
                         else np.array(v))
        else:
            self._sum += v
        self._n += 1

    def __call__(self, model, state):
        if self._n == 0:
            self.accumulate(model, state)
        n = self._n
        if isinstance(self._sum, torch.Tensor):
            # a divisor on the device: PyTorch multiplies a CUDA tensor by
            # the reciprocal of a host scalar, which rounds differently
            # from the division the CPU and the JAX package take
            n = torch.full((), n, dtype=self._sum.dtype,
                           device=self._sum.device)
        out = self._sum / n
        self._sum = None
        self._n = 0
        return out


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _host_copy(t):
    """``t`` on the host in storage of its own size (``torch.save`` writes a
    tensor's whole storage)."""
    t = t.detach().to("cpu")
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _ckpt_iteration(path):
    m = re.search(r"iteration(\d+)", path)
    return int(m.group(1)) if m else -1


class Checkpointer:
    """Saves the whole state, clock included, so that a run picks up with
    its bits and its AB2 tendency history (reference ``checkpointer.jl``):
    ``{prefix}_iteration{n}.pt``, a ``torch.save`` of the state's tensors
    copied to the host. ``cleanup`` keeps the last ``keep`` files."""

    def __init__(self, dirname="checkpoints", schedule=None, prefix="ckpt",
                 cleanup=False, keep=2):
        self.dirname = str(dirname)
        self.schedule = schedule or IterationInterval(1000)
        self.prefix = prefix
        self.cleanup = cleanup
        self.keep = keep
        os.makedirs(self.dirname, exist_ok=True)

    def _path(self, iteration):
        return os.path.join(self.dirname,
                            f"{self.prefix}_iteration{iteration}.pt")

    def _checkpoints(self):
        return sorted(glob.glob(os.path.join(
            self.dirname, f"{self.prefix}_iteration*.pt")),
            key=_ckpt_iteration)

    def write(self, sim):
        state = sim.state
        flat = {k: _host_copy(v) if isinstance(v, torch.Tensor) else v
                for k, v in flatten_state(state).items()}
        torch.save(flat, self._path(int(state.clock.iteration)))
        if self.cleanup:
            for old in self._checkpoints()[:-self.keep]:
                os.remove(old)

    def restore(self, template_state, path=None):
        """A state from a checkpoint, the latest one unless ``path`` is
        given (reference ``set!(model, filepath)``). ``template_state``
        (e.g. ``model.initial_state()``) gives the structure, the devices,
        the dtypes and the clock's epoch."""
        if path is None:
            ckpts = self._checkpoints()
            if not ckpts:
                raise FileNotFoundError(
                    f"no checkpoints under {self.dirname}")
            path = ckpts[-1]
        like = flatten_state(template_state)
        device = next((v.device for v in like.values()
                       if isinstance(v, torch.Tensor) and v.ndim),
                      torch.device("cpu"))
        flat = torch.load(path, map_location=device, weights_only=True)
        for key, v in like.items():
            if isinstance(v, torch.Tensor) and key in flat and \
                    flat[key].shape != v.shape:
                raise ValueError(f"checkpoint {key!r}: shape "
                                 f"{tuple(flat[key].shape)} != "
                                 f"{tuple(v.shape)}")
        return unflatten_state(template_state, flat)


class OrbaxCheckpointer(Checkpointer):
    """Sharded checkpoints: the JAX package saves a sharded state with
    orbax, each shard from its own host; here every rank of a distributed
    run (a ``torch.distributed`` group, such as the ranks of a
    ``DistributedModel``) ``torch.save``s its own local state to
    ``{prefix}_iteration{n}/rank{r}.pt`` and rank 0 writes the manifest
    ``manifest.json`` (iteration, world size, files). ``restore`` gives
    each rank its own block back, so ``Simulation.run(pickup=True)``
    continues bit for bit. Without a process group it is one rank. The
    last ``keep`` checkpoints are kept."""

    def __init__(self, dirname="checkpoints_orbax", schedule=None,
                 prefix="ckpt", keep=2):
        super().__init__(dirname, schedule, prefix, cleanup=True, keep=keep)

    @staticmethod
    def _rank():
        import torch.distributed as tdist
        if tdist.is_available() and tdist.is_initialized():
            return tdist.get_rank(), tdist.get_world_size()
        return 0, 1

    def _dir(self, iteration):
        return os.path.join(self.dirname,
                            f"{self.prefix}_iteration{iteration}")

    def _checkpoints(self):
        rank, _ = self._rank()
        return sorted((d for d in glob.glob(os.path.join(
            self.dirname, f"{self.prefix}_iteration*"))
            if os.path.exists(os.path.join(d, f"rank{rank}.pt"))),
            key=_ckpt_iteration)

    def write(self, sim):
        rank, world = self._rank()
        state = sim.state
        it = int(state.clock.iteration)
        d = self._dir(it)
        os.makedirs(d, exist_ok=True)
        flat = {k: _host_copy(v) if isinstance(v, torch.Tensor) else v
                for k, v in flatten_state(state).items()}
        torch.save(flat, os.path.join(d, f"rank{rank}.pt"))
        if rank == 0:
            with open(os.path.join(d, "manifest.json"), "w") as f:
                json.dump({"iteration": it, "world_size": world,
                           "files": [f"rank{r}.pt" for r in range(world)]},
                          f)
        for old in self._checkpoints()[:-self.keep]:
            os.remove(os.path.join(old, f"rank{rank}.pt"))
            if rank == 0:
                os.remove(os.path.join(old, "manifest.json"))
            try:
                os.rmdir(old)
            except OSError:
                pass    # another rank's file is still there

    def restore(self, template_state, path=None):
        """This rank's state from a sharded checkpoint (the latest unless
        ``path``, a checkpoint's directory, is given); ``template_state``
        gives the structure, the devices, the dtypes and the epoch."""
        rank, world = self._rank()
        if path is None:
            ckpts = self._checkpoints()
            if not ckpts:
                raise FileNotFoundError(
                    f"no checkpoints of rank {rank} under {self.dirname}")
            path = ckpts[-1]
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["world_size"] != world:
            raise ValueError(f"checkpoint {path} was written by "
                             f"{manifest['world_size']} ranks, not {world}")
        return super().restore(template_state,
                               os.path.join(path, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

class FileSizeLimit:
    """File-splitting trigger by size in bytes (reference
    ``output_writer_utils.jl``): ``HDF5Writer(...,
    file_splitting=FileSizeLimit(200e6))``."""

    def __init__(self, size_limit):
        self.size_limit = int(size_limit)

    def __repr__(self):
        return f"FileSizeLimit({self.size_limit})"


class InMemory:
    """FieldTimeSeries backend keeping ``length`` snapshots in host memory
    as a moving window (reference ``field_time_series.jl`` InMemory);
    ``InMemory()`` holds the whole series."""

    def __init__(self, length=None):
        if length is not None and length < 2:
            raise ValueError("InMemory length must be >= 2")
        self.length = length


class OnDisk:
    """Lazy FieldTimeSeries backend: every index reads from the file
    (reference ``field_time_series.jl`` OnDisk)."""


class FieldTimeSeries:
    """A (time, x, y, z) series read from an ``HDF5Writer`` file, as numpy
    on the host, with linear interpolation in time (reference
    ``field_time_series.jl``). ``backend``: ``InMemory()`` (the default,
    all of it in memory), ``InMemory(n)`` (a moving window of n
    snapshots) or ``OnDisk()`` (every access reads the file)."""

    def __init__(self, times, data, name="", filename=None, backend=None):
        self.times = np.asarray(times)
        self.data = data                # None for OnDisk and windowed
        self.name = name
        self.filename = filename
        self.backend = backend or InMemory()
        self._window_start = 0
        self._window = None
        if isinstance(self.backend, InMemory) and \
                self.backend.length is not None and filename is None:
            raise ValueError("windowed InMemory backend needs filename=")
        if isinstance(self.backend, OnDisk) and filename is None:
            raise ValueError("OnDisk backend needs filename=")

    def __len__(self):
        return len(self.times)

    def _read(self, index):
        with _h5py().File(self.filename, "r") as f:
            return np.asarray(f["fields"][self.name][index])

    def __getitem__(self, i):
        if isinstance(self.backend, OnDisk):
            return self._read(i)
        if self.backend.length is None:
            return self.data[i]
        n = self.backend.length
        i = int(i)
        if self._window is None or not (
                self._window_start <= i < self._window_start + n):
            start = min(max(i, 0), max(len(self.times) - n, 0))
            self._window = self._read(slice(start, start + n))
            self._window_start = start
        return self._window[i - self._window_start]

    def at_time(self, t):
        """Linear interpolation in time, clamped at the ends."""
        times = self.times
        t = float(t)
        if t <= times[0]:
            return self[0]
        if t >= times[-1]:
            return self[len(times) - 1]
        i = int(np.searchsorted(times, t) - 1)
        f = (t - times[i]) / (times[i + 1] - times[i])
        return (1 - f) * self[i] + f * self[i + 1]


def load_field_time_series(filename, name, backend=None):
    """Open a series written by ``HDF5Writer``. ``backend``: ``InMemory()``
    (default), ``InMemory(n)`` or ``OnDisk()``. The parts of a split file
    are opened one by one."""
    backend = backend or InMemory()
    with _h5py().File(filename, "r") as f:
        times = np.asarray(f["times"])
        data = None
        if isinstance(backend, InMemory) and backend.length is None:
            data = np.asarray(f["fields"][name])
    return FieldTimeSeries(times, data, name, filename=filename,
                           backend=backend)


class FieldDataset:
    """Every series of a writer's file, by field name (reference
    ``field_dataset.jl``); each :class:`FieldTimeSeries` opens on first
    use."""

    def __init__(self, filename, backend=None):
        self.filename = filename
        self.backend = backend
        with _h5py().File(filename, "r") as f:
            self.names = tuple(f["fields"].keys())
        self._series = {}

    def __getitem__(self, name):
        if name not in self._series:
            if name not in self.names:
                raise KeyError(f"{name!r} not in {self.filename} "
                               f"(has {self.names})")
            self._series[name] = load_field_time_series(
                self.filename, name, backend=self.backend)
        return self._series[name]

    def keys(self):
        return self.names

    def __iter__(self):
        return iter(self.names)

    def __repr__(self):
        return f"FieldDataset({self.filename!r}, names={self.names})"
