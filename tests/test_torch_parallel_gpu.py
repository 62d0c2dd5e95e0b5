"""The distributed layer's kernels and a two-rank step on the card.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu

The kernels on a rank's path (the Centered-2 tendency, the WENO-5 momentum
and tracer tendencies, the WENO tracer and vector-invariant tendencies) are
held against their plain versions at the shapes of rank blocks: the main
path's (phase 27 of ``chip_smoke.py``: a quarter of 256³ along x, a
quarter of ``hydro_vi``) and ragged ones whose launch plans end in a
partial panel. A two-rank gloo step of a WENO-5 nonhydrostatic and of a
``hydro_vi`` model on the card (both ranks on ``cuda:0``) is held to the
same step on the CPU in float64 at 1e-12 of the largest value.
"""

import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.ops import cuda_kernels as ck
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi
from oceananigans_torch.ops import cuda_weno as cw

#: kernel-against-plain bounds, as in chip_smoke.py: 8 float32 ulps for the
#: Centered-2 tile, 1e-5 of the largest value for the others; 1e-12 in
#: float64
RTOL = {("c2", torch.float32): 8 * torch.finfo(torch.float32).eps,
        ("weno", torch.float32): 1e-5}
LOCS = (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C)
BPP = (ot.Bounded, ot.Periodic, ot.Periodic)
PBB = (ot.Periodic, ot.Bounded, ot.Bounded)

#: (kind, block interior, halo, topology): the main path's blocks and
#: ragged ones (their plans end in a partial panel)
BLOCKS = [("c2", (16, 64, 64), (1, 0, 0), BPP),
          ("c2", (61, 20, 70), (1, 0, 0), BPP),
          ("weno5", (64, 256, 256), (3, 0, 0), BPP),
          ("weno5", (57, 20, 70), (3, 0, 0), BPP),
          ("hydro", (180, 80, 60), (6, 6, 4), PBB),
          ("hydro", (23, 17, 9), (6, 6, 4), PBB)]


def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def fields(grid, dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(18)
    out = []
    for loc in LOCS:
        a = torch.randn(grid.shape, generator=gen, device=dev, dtype=dtype)
        out.append(ot.fill_halo_regions(a, grid, loc=loc))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"{b[0]}{b[1]}")
def test_kernels_match_plain_at_block_shapes(block, dtype):
    dev = card()
    kind, size, halo, topology = block
    extent = (4e7, 2e7, 4e3) if kind == "hydro" else (0.25, 1.0, 1.0)
    grid = ot.RectilinearGrid(size=size, extent=extent, topology=topology,
                              halo=halo, dtype=dtype, device=dev)
    u, v, w, T, S = fields(grid, dev, dtype)
    tr = {"T": T, "S": S}
    if kind == "c2":
        pairs = [(ck.centered2_momentum_tendency(grid, u, v, w),
                  ck.centered2_momentum_tendency_plain(grid, u, v, w))]
    elif kind == "weno5":
        pairs = [(cw.weno5_momentum_tendency(grid, u, v, w),
                  cw.weno5_momentum_tendency_plain(grid, u, v, w)),
                 (list(cw.weno5_tracer_tendencies(grid, u, v, w,
                                                  tr).values()),
                  list(cw.weno5_tracer_tendencies_plain(grid, u, v, w,
                                                        tr).values()))]
    else:
        vi, sch = ot.WENOVectorInvariant(), ot.WENO(7)
        assert cvi.vi_available(grid, vi)
        assert ctr.tracer_fusion_available(grid, sch)
        pairs = [(cvi.vi_momentum_tendency(grid, vi, u, v, w),
                  cvi.vi_momentum_tendency_plain(grid, vi, u, v, w)),
                 (list(ctr.weno_tracer_tendencies(grid, sch, u, v, w,
                                                  tr).values()),
                  list(ctr.weno_tracer_tendencies_plain(grid, sch, u, v, w,
                                                        tr).values()))]
    torch.cuda.synchronize()
    rtol = 1e-12 if dtype == torch.float64 else RTOL[
        ("c2" if kind == "c2" else "weno"), dtype]
    for got, ref in pairs:
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        assert err <= rtol * scale, (kind, size, err, scale)


CARD_CASES = {
    "weno5": dict(kind="nonhydrostatic",
                  grid={"size": (32, 16, 16), "extent": (1.0, 1.0, 1.0),
                        "topology": ("Bounded", "Periodic", "Periodic"),
                        "halo": (3, 0, 0)},
                  model={"advection": ("WENO", 5), "tracers": ("b",),
                         "buoyancy": "BuoyancyTracer"},
                  ic="weno", dt=1e-3, steps=3, partition=(2, 1)),
    "hydro_vi": dict(kind="hydrostatic",
                     grid={"size": (48, 16, 6), "extent": (4e7, 2e7, 4e3),
                           "topology": ("Periodic", "Bounded", "Bounded"),
                           "halo": (6, 6, 4)},
                     model={"momentum_advection": ("WENOVectorInvariant",),
                            "tracer_advection": ("WENO", 7),
                            "tracers": ("T", "S"),
                            "free_surface": ("SplitExplicitFreeSurface",
                                             {"substeps": 30})},
                     ic="generic", dt=60.0, steps=3, partition=(1, 2)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD_CASES)
def test_two_rank_gloo_step_on_card_matches_cpu(name, tmp_path):
    """Two gloo ranks on ``cuda:0`` (the kernels on each block, halo
    strips through pinned host buffers) against the same two-rank step on
    the CPU (the plain versions), float64, 1e-12 of the largest value."""
    card()
    import numpy as np

    from oceananigans_torch.parallel import launch

    import torch_parallel_ranks as tr
    case = dict(CARD_CASES[name], grid=dict(CARD_CASES[name]["grid"]))
    out = {}
    for device in ("cuda:0", "cpu"):
        out[device] = launch(2, tr.device_run, (case,),
                             rendezvous_dir=tmp_path / device.replace(
                                 ":", ""), backend="gloo", device=device)[0]
    # the card's local model takes its kernels (the momentum family, and
    # the WENO tracer kernel of hydro_vi), the CPU's none
    want = 2 if name == "hydro_vi" else 1
    assert all(out["cuda:0"]["gates"][:want])
    assert not any(out["cpu"]["gates"])
    a, b = out["cuda:0"]["state"], out["cpu"]["state"]
    for key in ("u", "v", *(k for k in b if k.startswith("tracers/"))):
        scale = float(np.abs(b[key]).max())
        assert float(np.abs(a[key] - b[key]).max()) <= 1e-12 * scale, key
