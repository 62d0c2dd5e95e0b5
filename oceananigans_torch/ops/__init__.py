"""Operators and the hand-written CUDA kernels with their plain versions.

The package re-exports the operator vocabulary of ``ops/operators.py``,
as the JAX package's ``ops`` does."""

from oceananigans_torch.ops.operators import (
    ddx_c, ddx_f, ddy_c, ddy_f, ddz_c, ddz_f, div_xy_cc, divergence_ccc,
    dx_c, dx_f, dy_c, dy_f, dz_c, dz_f, ix_c, ix_f, iy_c, iy_f, iz_c, iz_f,
    kinetic_energy_cc, laplacian_ccc, shift, vorticity_z_ff,
)

__all__ = ["ddx_c", "ddx_f", "ddy_c", "ddy_f", "ddz_c", "ddz_f",
           "div_xy_cc", "divergence_ccc", "dx_c", "dx_f", "dy_c", "dy_f",
           "dz_c", "dz_f", "ix_c", "ix_f", "iy_c", "iy_f", "iz_c", "iz_f",
           "kinetic_energy_cc", "laplacian_ccc", "shift", "vorticity_z_ff"]
