"""The distributed layer: ranks of a ``torch.distributed`` process group
over an (x, y) mesh, each holding its own block with its own halo rings.

Counterpart of ``oceananigans_tpu/parallel/``: :class:`Partition` and
:class:`Distributed` (the mesh and the transport), :func:`halo_exchange`,
the pencil Poisson solvers, :class:`DistributedStep` and
:class:`DistributedModel` (the explicit-halo step of the nonhydrostatic and
hydrostatic models, and its ``Simulation`` adapter), the distributed cubed
sphere, :func:`launch` (start the ranks) and :func:`dryrun_multichip`.
"""

from oceananigans_torch.parallel.cubed_sphere_shard import (
    CubedSphereDistributedHydrostatic, CubedSphereDistributedSW,
)
from oceananigans_torch.parallel.distributed import (
    Distributed, Partition, shard_state, sharded_step_fn,
)
from oceananigans_torch.parallel.distributed_fft import (
    DistributedFFTPoissonSolver, DistributedFourierTridiagonalSolver,
)
from oceananigans_torch.parallel.dryrun import dryrun_multichip
from oceananigans_torch.parallel.halo_exchange import (
    from_local_layout, halo_exchange, halo_exchange_spec, to_local_layout,
)
from oceananigans_torch.parallel.launch import launch
from oceananigans_torch.parallel.shard_step import (
    DistHalo, DistributedImmersedPoissonSolver, DistributedModel,
    DistributedStep, dist_fill_halos, dist_fill_xy,
)

__all__ = ["CubedSphereDistributedHydrostatic", "CubedSphereDistributedSW",
           "DistHalo", "Distributed", "DistributedFFTPoissonSolver",
           "DistributedFourierTridiagonalSolver",
           "DistributedImmersedPoissonSolver", "DistributedModel",
           "DistributedStep", "Partition", "dist_fill_halos", "dist_fill_xy",
           "dryrun_multichip", "from_local_layout", "halo_exchange",
           "halo_exchange_spec", "launch", "shard_state", "sharded_step_fn",
           "to_local_layout"]
