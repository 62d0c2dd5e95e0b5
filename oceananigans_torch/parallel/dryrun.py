"""``dryrun_multichip``: one step of each distributed model over an n-rank
mesh, from a fresh start of the ranks.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
a WENO-5 nonhydrostatic step with buoyancy and f-plane Coriolis, and a
split-explicit hydrostatic step, on tiny grids over an (x, y) mesh that
factors ``n``, through :class:`~oceananigans_torch.parallel.shard_step.
DistributedStep`; each rank's fields must come out finite.
"""

from __future__ import annotations

import math
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _ranks(dist, dtype):
    """The rank program: both steps; returns what each produced."""
    import oceananigans_torch as ot
    from oceananigans_torch.parallel.shard_step import DistributedStep

    px, py = dist.partition
    H = 3
    grid = ot.RectilinearGrid(
        size=(8 * px, 8 * py, 8), extent=(1.0, 1.0, 1.0),
        topology=(ot.Periodic, ot.Periodic, ot.Bounded), halo=H,
        dtype=dtype, device=dist.device)

    def nonhydrostatic(g):
        return ot.NonhydrostaticModel(
            grid=g, advection=ot.WENO(5), tracers=("b",),
            buoyancy=ot.BuoyancyTracer(), coriolis=ot.FPlane(f=1e-4))

    dstep = DistributedStep(nonhydrostatic, grid, dist)
    state = dstep.gmodel.initial_state(
        u=lambda x, y, z: 0.01 * torch.sin(2 * np.pi * x),
        b=lambda x, y, z: 0.01 * z) if dist.rank == 0 else None
    local = dstep.step(dstep.to_local_state(state), 1e-3)
    out = {"nonhydrostatic": bool(torch.isfinite(local.u).all()),
           "kernels": str(dstep.lmodel.fused_kernels)}

    def hydrostatic(g):
        return ot.HydrostaticFreeSurfaceModel(
            grid=g, free_surface=ot.SplitExplicitFreeSurface(substeps=8),
            tracers=("b",), buoyancy=ot.BuoyancyTracer())

    hstep = DistributedStep(hydrostatic, grid, dist)
    hstate = hstep.gmodel.initial_state(
        b=lambda x, y, z: 1e-5 * z,
        eta=lambda x, y: 0.01 * torch.sin(2 * np.pi * x)) \
        if dist.rank == 0 else None
    hlocal = hstep.step(hstep.to_local_state(hstate), 10.0)
    out["hydrostatic"] = bool(torch.isfinite(hlocal.u).all())
    return out


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device: str = None, dtype="float32"):
    """Start ``n_devices`` ranks (``backend`` "gloo" or "nccl" on
    ``device``, as :func:`~oceananigans_torch.parallel.launch.launch`
    takes them; by default ``config.device`` of the caller), run one
    WENO-5 nonhydrostatic and one split-explicit hydrostatic step over the
    mesh that factors ``n_devices`` most
    squarely, and raise unless every rank's fields are finite. Returns the
    ranks' reports."""
    from oceananigans_torch.parallel.launch import launch
    if n_devices < 1 or int(n_devices) != n_devices:
        raise ValueError(f"n_devices={n_devices!r}")
    px = int(math.floor(math.sqrt(n_devices)))
    while n_devices % px:
        px -= 1
    from oceananigans_torch.parallel.distributed import Partition
    with tempfile.TemporaryDirectory() as tmp:
        reports = launch(n_devices, _ranks, (dtype,), rendezvous_dir=tmp,
                         backend=backend, device=device,
                         partition=Partition(px, n_devices // px))
    for r, rep in enumerate(reports):
        if not (rep["nonhydrostatic"] and rep["hydrostatic"]):
            raise RuntimeError(f"rank {r}: a step produced non-finite "
                               f"fields: {rep}")
    return reports
