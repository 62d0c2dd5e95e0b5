"""The port's cubed sphere on the card against the CPU: the scalar and
velocity exchanges, the edge-flux sync and the corner vorticity on the same
seeded random fields (exactly equal), and one step of Williamson 2 and of
``bench.py``'s cs_global ocean at C8×4 (``profile_step.cs_w2_model``,
``cs_global_model``) in float64, within 1e-12 of each group's largest value
(u and v together, each other field alone). No port kernel lies on these
paths, so the kernel counts stay at zero.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cubed_sphere_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.grids import cubed_sphere_grid as cg
from oceananigans_torch.ops import cuda_tracer as ctr
from oceananigans_torch.ops import cuda_vi as cvi
from oceananigans_torch.profile_step import cs_global_model, cs_w2_model

RTOL = 1e-12
GROUPS = {"velocities": ("u", "v"), "h": ("h",), "eta": ("eta",),
          "T": ("T",), "S": ("S",)}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.gpu
def test_exchanges_on_card_match_cpu():
    need_card()
    grids = {d: ot.ConformalCubedSphereGrid((8, 3), z=(-100.0, 0.0),
                                            halo=3, dtype=torch.float64,
                                            device=d)
             for d in ("cuda", "cpu")}
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((6, *grids["cpu"].panel_grid.shape))
               for _ in range(3))

    def run(d):
        g = grids[d]
        ta, tb, tc = (torch.tensor(x, device=d) for x in (a, b, c))
        return (cg.cubed_sphere_halo_exchange(ta, g),
                *cg.cubed_sphere_velocity_exchange(ta, tb, g),
                *cg.cubed_sphere_sync_edge_fluxes(ta, tb, g),
                cg.cubed_sphere_corner_vorticity(tc, ta, tb, g))

    for got, ref in zip(run("cuda"), run("cpu")):
        assert torch.equal(got.cpu(), ref)


def compare(grid_gpu, st_gpu, grid_cpu, st_cpu):
    fg, fc = st_gpu.fields(), st_cpu.fields()
    for group, names in GROUPS.items():
        names = [n for n in names if n in fc]
        if not names:
            continue
        scale = max(float(grid_cpu.interior(fc[n]).abs().max())
                    for n in names)
        gap = max(float((grid_gpu.interior(fg[n]).cpu()
                         - grid_cpu.interior(fc[n])).abs().max())
                  for n in names)
        assert gap <= RTOL * max(scale, 1e-300), (group, gap, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["shallow_water", "hydrostatic"])
def test_step_on_card_matches_cpu(model):
    need_card()
    runs = {}
    for fn in (ctr.weno_tracer_tendencies, cvi.vi_momentum_tendency):
        fn.launches = 0
    for device in ("cuda", "cpu"):
        if model == "shallow_water":
            m, st = cs_w2_model(8, torch.float64, device)
        else:
            m, st = cs_global_model(8, 4, torch.float64, device)
        st = m.step(st, 600.0)
        runs[device] = (m.grid, st)
    compare(*runs["cuda"], *runs["cpu"])
    assert ctr.weno_tracer_tendencies.launches == 0
    assert cvi.vi_momentum_tendency.launches == 0
