"""LatitudeLongitudeGrid: the spherical-polar C-grid with curvature metrics.

Counterpart of ``oceananigans_tpu/grids/latlon.py``. The horizontal metrics
are separable products of 1-D factors (Δx = R cosφ Δλ, Δy = R Δφ, Az =
R² Δλ Δ(sinφ)): the grid stores the factors, and a metric is their
broadcast product, (nx, ny, 1) where it varies along both axes.
"""

from __future__ import annotations

import numpy as np
import torch

from oceananigans_torch.config import as_dtype, config
from oceananigans_torch.grids.base import (
    AbstractGrid, Bounded, Center, Flat, Periodic, bshape,
    generate_coordinate, halo_per_axis,
)

#: mean Earth radius [m]
R_EARTH = 6_371_000.0


class LatitudeLongitudeGrid(AbstractGrid):
    """Spherical shell C-grid on (longitude λ [deg], latitude φ [deg], z
    [m]).

    ``longitude=(λW, λE)`` (Periodic when it spans 360°, else Bounded),
    ``latitude=(φS, φN)`` (Bounded), ``z=(bottom, top)``; ``size`` may be
    (Nλ, Nφ) with a Flat z topology. ``halo`` is one width or a per-axis
    triple. Each of the three may also be an array of N + 1 faces or a
    callable ``i -> face`` (a stretched axis).
    The coordinates are also ``xC``/``xF`` (λ) and ``yC``/``yF`` (φ), so
    initial-state callables take (λ, φ, z).
    """

    def __init__(self, size, longitude=None, latitude=None, z=None,
                 radius=R_EARTH, topology=None, halo=None, dtype=None,
                 device=None):
        super().__init__()
        dtype = as_dtype(dtype)
        device = torch.device(config.device if device is None else device)
        if halo is None:
            halo = config.halo
        if topology is None:
            lon_span = (longitude[1] - longitude[0]
                        if isinstance(longitude, tuple) else None)
            TX = Periodic if (lon_span is not None
                              and abs(lon_span - 360.0) < 1e-10) else Bounded
            topology = (TX, Bounded, Bounded)
        topology = tuple(topology)
        if len(size) == 2 and topology[2] == Flat:
            size = (size[0], size[1], 1)
        halos = halo_per_axis(halo)
        N = tuple(1 if t == Flat else int(n) for n, t in zip(size, topology))
        H = tuple(0 if t == Flat else min(h, n)
                  for n, h, t in zip(N, halos, topology))

        lamF, lamC, dlamC, dlamF, x_reg, Lx = generate_coordinate(
            longitude, N[0], H[0], topology[0])
        phiF, phiC, dphiC, dphiF, y_reg, Ly = generate_coordinate(
            latitude, N[1], H[1], topology[1])
        zF, zC, dzC, dzF, z_reg, Lz = generate_coordinate(z, N[2], H[2],
                                                          topology[2])

        deg = np.pi / 180.0
        # |cos φ| mirrors the halo rows beyond a pole, floored so that the
        # divisions of the pole rows stay finite
        cos_floor = 1e-4
        cos_C = np.maximum(np.abs(np.cos(deg * phiC)), cos_floor)
        cos_F = np.maximum(np.abs(np.cos(deg * phiF)), cos_floor)
        # Δ(sinφ) of the exact spherical areas Az = R² Δλ Δsinφ
        sinF = np.sin(deg * phiF)
        sinC = np.sin(deg * phiC)
        dsin_C = np.empty_like(sinC)          # sinφF[j+1] − sinφF[j]
        dsin_C[:-1] = sinF[1:] - sinF[:-1]
        dsin_C[-1] = dsin_C[-2]
        dsin_F = np.empty_like(sinC)          # sinφC[j] − sinφC[j−1]
        dsin_F[1:] = sinC[1:] - sinC[:-1]
        dsin_F[0] = dsin_F[1]
        # halo rows over a pole keep positive areas
        dsin_C = np.maximum(np.abs(dsin_C), cos_floor * deg * np.abs(dphiC))
        dsin_F = np.maximum(np.abs(dsin_F), cos_floor * deg * np.abs(dphiF))

        arrays = {
            0: (("lamF", lamF), ("lamC", lamC),
                ("dxlamC", radius * deg * dlamC),
                ("dxlamF", radius * deg * dlamF)),
            1: (("phiF", phiF), ("phiC", phiC), ("cosC", cos_C),
                ("cosF", cos_F), ("dyC_", radius * deg * dphiC),
                ("dyF_", radius * deg * dphiF), ("dsinC", dsin_C),
                ("dsinF", dsin_F)),
            2: (("zF", zF), ("zC", zC), ("dzC_", dzC), ("dzF_", dzF)),
        }
        for axis, items in arrays.items():
            for name, arr in items:
                t = torch.as_tensor(arr, dtype=dtype, device=device)
                self.register_buffer(name,
                                     t.reshape(bshape(axis, len(arr))))
        self.topology = topology
        self.N, self.H = N, H
        self.Nx, self.Ny, self.Nz = N
        self.Lx, self.Ly, self.Lz = Lx, Ly, Lz
        self.radius = float(radius)
        self.x_regular, self.y_regular, self.z_regular = x_reg, y_reg, z_reg

    # the λ/φ coordinates under the names the node queries and the
    # initial-state callables use
    @property
    def xF(self):
        return self.lamF

    @property
    def xC(self):
        return self.lamC

    @property
    def yF(self):
        return self.phiF

    @property
    def yC(self):
        return self.phiC

    # ---- metrics -------------------------------------------------------------
    def dx(self, lx=Center, ly=Center):
        dlam = self.dxlamC if lx == Center else self.dxlamF
        cphi = self.cosC if ly == Center else self.cosF
        return dlam * cphi

    def dy(self, ly=Center, lx=Center):
        return self.dyC_ if ly == Center else self.dyF_

    def dz(self, lz=Center):
        return self.dzC_ if lz == Center else self.dzF_

    def Az(self, lx, ly, lz=None):
        dlam = self.dxlamC if lx == Center else self.dxlamF
        dsin = self.dsinC if ly == Center else self.dsinF
        return self.radius * dlam * dsin

    def extra_repr(self):
        return (f"size={self.N}, topology={self.topology}, halo={self.H}, "
                f"radius={self.radius:g}")


__all__ = ["LatitudeLongitudeGrid", "R_EARTH"]
