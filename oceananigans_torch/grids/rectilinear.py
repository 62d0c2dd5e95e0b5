"""RectilinearGrid: Cartesian staggered grid, regular or stretched per axis.

Counterpart of ``oceananigans_tpu/grids/rectilinear.py``. The grid is an
``nn.Module`` whose coordinate and spacing tensors are buffers, so
``grid.to(device)`` (or moving a model that holds it) moves them all.
"""

from __future__ import annotations

import torch

from oceananigans_torch.config import as_dtype, config
from oceananigans_torch.grids.base import (
    AXIS_NAMES, AbstractGrid, Bounded, Center, Flat, Periodic, bshape,
    generate_coordinate, halo_per_axis,
)


def _expand_per_axis(values, topology, what):
    """Distribute a user tuple over the non-Flat axes."""
    non_flat = [i for i, t in enumerate(topology) if t != Flat]
    if not isinstance(values, (tuple, list)):
        values = (values,)
    if len(values) != len(non_flat):
        raise ValueError(f"{what}={values} does not match the {len(non_flat)} "
                         f"non-flat axes of topology {topology}")
    full = [None, None, None]
    for i, v in zip(non_flat, values):
        full[i] = v
    return tuple(full)


class RectilinearGrid(AbstractGrid):
    """Cartesian C-grid.

    ``x=``, ``y=``, ``z=`` are each a ``(left, right)`` pair (regular
    spacing), an array of ``N + 1`` faces or a callable ``i -> face``
    (stretched); ``extent=(Lx, Ly, Lz)`` is shorthand for ``x=(0, Lx),
    y=(0, Ly), z=(-Lz, 0)``. ``x_regular``, ``y_regular`` and
    ``z_regular`` say which axes are regular.
    """

    def __init__(self, size, x=None, y=None, z=None, extent=None,
                 topology=None, halo=None, dtype=None, device=None):
        super().__init__()
        if topology is None:
            topology = (Periodic, Periodic, Bounded)
        dtype = as_dtype(dtype)
        device = torch.device(config.device if device is None else device)
        if halo is None:
            halo = config.halo
        if extent is not None:
            exts = _expand_per_axis(extent, topology, "extent")
            x = (0.0, exts[0]) if exts[0] is not None else None
            y = (0.0, exts[1]) if exts[1] is not None else None
            z = (-exts[2], 0.0) if exts[2] is not None else None
        sizes = _expand_per_axis(size, topology, "size")
        specs = (x, y, z)
        halos = halo_per_axis(halo)
        Ns, Hs, Ls, regs = [], [], [], []
        for axis, name in enumerate(AXIS_NAMES):
            topo = topology[axis]
            if topo != Flat and specs[axis] is None:
                raise ValueError(f"missing coordinate spec {name}= for "
                                 f"non-flat axis {axis}")
            N = 1 if topo == Flat else int(sizes[axis])
            H = 0 if topo == Flat else min(int(halos[axis]), N)
            F, C, dC, dF, regular, L = generate_coordinate(specs[axis], N,
                                                           H, topo)
            for suffix, arr in (("F", F), ("C", C), ("C_d", dC),
                                ("F_d", dF)):
                t = torch.as_tensor(arr, dtype=dtype, device=device)
                self.register_buffer(
                    f"{name}{suffix}", t.reshape(bshape(axis, len(arr))))
            Ns.append(N)
            Hs.append(H)
            Ls.append(L)
            regs.append(regular)
        self.topology = tuple(topology)
        self.N = tuple(Ns)
        self.H = tuple(Hs)
        self.Nx, self.Ny, self.Nz = self.N
        self.Lx, self.Ly, self.Lz = Ls
        self.x_regular, self.y_regular, self.z_regular = regs

    # ---- metrics -----------------------------------------------------------
    def dx(self, lx=Center, ly=Center):
        return self.xC_d if lx == Center else self.xF_d

    def dy(self, ly=Center, lx=Center):
        return self.yC_d if ly == Center else self.yF_d

    def dz(self, lz=Center):
        return self.zC_d if lz == Center else self.zF_d

    def spacing(self, axis: int) -> float:
        """The regular spacing of ``axis`` (1 on a Flat axis; the mean
        spacing of a stretched axis)."""
        if self.topology[axis] == Flat:
            return 1.0
        return (self.Lx, self.Ly, self.Lz)[axis] / self.N[axis]

    def extra_repr(self):
        return (f"size={self.N}, topology={self.topology}, halo={self.H}, "
                f"extent=({self.Lx:g}, {self.Ly:g}, {self.Lz:g})")


__all__ = ["RectilinearGrid", "Bounded", "Periodic", "Flat"]
