"""The port's output layer on the card against the CPU: a checkpoint pickup
of a small quasi-AB2 model on the kernel path (kernel 1), bitwise equal to
the uninterrupted run; what a writer takes from a state on the card (cast
to float32 there, then copied) equal to what it takes from the same state
on the CPU, and, where h5py is installed, the same file; and a
``WindowedTimeAverage`` summed on the card equal to the CPU's sum.

These tests need a CUDA device and skip without one. They import nothing
of JAX, so they also run on a machine without it:

    python -m pytest --noconftest tests/test_torch_output_gpu.py -m gpu
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import oceananigans_torch as ot
from oceananigans_torch.interop import flatten_state
from oceananigans_torch.ops import cuda_kernels as ck

GRID = dict(size=(32, 24, 16), extent=(1.0, 1.0, 1.0), halo=(1, 0, 0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic))


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def seeded_state(model, seed=0):
    rng = np.random.default_rng(seed)
    shape = model.grid.N
    return model.initial_state(u=0.01 * rng.standard_normal(shape),
                               v=0.01 * rng.standard_normal(shape))


@pytest.mark.gpu
def test_pickup_on_card_is_bitwise(tmp_path):
    """10 steps with a Checkpointer every 5 through kernel 1, and the
    same run picked up at 5: every tensor and the clock equal."""
    need_card()
    grid = ot.RectilinearGrid(dtype=torch.float32, device="cuda", **GRID)
    model = ot.NonhydrostaticModel(grid=grid,
                                   timestepper="QuasiAdamsBashforth2")
    sims = []
    ck.centered2_ab2_update.launches = 0
    for pickup in (False, True):
        sim = ot.Simulation(model, state=seeded_state(model), dt=1e-3,
                            stop_iteration=10)
        ckpt = ot.Checkpointer(tmp_path, ot.IterationInterval(5))
        sim.output_writers["ckpt"] = ckpt
        sim.run(pickup=pickup and ckpt._path(5))
        sims.append(sim)
    assert ck.centered2_ab2_update.launches == 15
    a, b = (flatten_state(s.state) for s in sims)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert a[key].device == b[key].device, key
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key
    assert sims[1].state.clock.time.dtype == torch.float32


@pytest.mark.gpu
def test_writer_on_card_matches_cpu(tmp_path):
    """A float64 state on the card and its copy on the CPU: the writer's
    float32 outputs (cast on each device) are equal, and so are the files
    where h5py is installed."""
    need_card()
    sims = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(dtype=torch.float64, device=device,
                                  **GRID)
        model = ot.NonhydrostaticModel(grid=grid, tracers=("c",))
        sims[device] = ot.Simulation(model, dt=1e-3)
    state = seeded_state(sims["cpu"].model, seed=1)
    sims["cpu"].state = state
    sims["cuda"].state = type(state)(**{
        k: ({n: t.to("cuda") for n, t in v.items()} if isinstance(v, dict)
            else v.to("cuda") if isinstance(v, torch.Tensor)
            and k != "clock" else v) for k, v in state.__dict__.items()})

    def mean_u(m, s):
        return ot.Average(m.grid, s.u, dims=(0, 1))

    fetched, files = {}, {}
    for device, sim in sims.items():
        path = os.path.join(tmp_path, f"{device}.h5")
        w = ot.HDF5Writer({"u": "u", "c": "c", "mean_u": mean_u}, path,
                          ot.IterationInterval(1))
        fetched[device] = w.fetch(sim)
        if importlib.util.find_spec("h5py") is not None:
            w.write(sim)
            files[device] = path
    for name, ref in fetched["cpu"].items():
        assert fetched["cuda"][name].dtype == np.float32
        if name == "mean_u":   # a reduction: the devices sum in turns
            np.testing.assert_allclose(fetched["cuda"][name], ref,
                                       rtol=1e-6)
        else:
            assert np.array_equal(fetched["cuda"][name], ref), name
    if files:
        import h5py
        with h5py.File(files["cuda"]) as a, h5py.File(files["cpu"]) as b:
            for name in ("u", "c"):
                assert np.array_equal(a["fields"][name][:],
                                      b["fields"][name][:])
            for name in ("x", "xF", "z", "zF"):
                assert np.array_equal(a["grid"][name][:], b["grid"][name][:])


@pytest.mark.gpu
def test_windowed_average_on_card_matches_cpu():
    """Eleven seeded states summed by a WindowedTimeAverage on the card
    and on the CPU: the same averages, bit for bit, and the sum stays on
    the card."""
    need_card()
    rng = np.random.default_rng(2)
    fields = [rng.standard_normal((34, 24, 16)).astype(np.float32)
              for _ in range(11)]
    out = {}
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(dtype=torch.float32, device=device,
                                  **GRID)
        model = ot.NonhydrostaticModel(grid=grid)
        wta = ot.WindowedTimeAverage("u")
        for a in fields:
            state = model.initial_state()
            state.u = torch.tensor(a, device=device)
            wta.accumulate(model, state)
            assert wta._sum.device.type == device
        out[device] = wta(model, state)
    assert torch.equal(out["cuda"].cpu(), out["cpu"])
