"""Global defaults, read only when grids and fields are constructed.

Counterpart of ``oceananigans_tpu/config.py``. The default device is the
GPU (``"cuda"``): a grid built without ``device=`` lives on the card, and on
a machine without one its construction raises torch's own error. Nothing
falls back to the CPU quietly; a CPU run asks for it
(``RectilinearGrid(..., device="cpu")`` or ``config.device = "cpu"``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    #: default floating point type of new grids and fields
    float_type: str = "float32"

    #: default device of new grids
    device: str = "cuda"

    #: default halo width
    halo: int = 3

    @property
    def float_dtype(self) -> torch.dtype:
        return getattr(torch, self.float_type)


config = Config()


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if dtype is None:
        return config.float_dtype
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return getattr(torch, np.dtype(dtype).name)


def set_float_type(ft) -> None:
    """Set the default floating point type of new grids and fields (a torch
    dtype, a numpy dtype or a name such as "float64")."""
    config.float_type = str(as_dtype(ft)).removeprefix("torch.")


def float_type() -> torch.dtype:
    """The default floating point type of new grids and fields."""
    return config.float_dtype
