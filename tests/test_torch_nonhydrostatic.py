"""The nonhydrostatic slice of oceananigans_torch as a whole, against the
JAX package, in float64 on the CPU.

Both models start from the same state, handed across as numpy arrays
through ``oceananigans_torch.interop``. The port runs its fused code path
(``fused_kernels=True``: on the CPU that is the kernels' plain versions)
and is held against the JAX package's XLA path and against its fused
Pallas kernels in interpret mode. Interiors are compared after the
trailing halo fill, to atol 1e-12 (the goldens' tolerance,
``tests/golden/README.md``); the fused kernels leave halo rows stale by
design.
"""

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.interop import (
    FIELDS, state_from_numpy, state_to_numpy,
)
from oceananigans_torch.ops.operators import divergence_ccc
from oceananigans_tpu.config import config as j_config
from oceananigans_tpu.models import NonhydrostaticModel as JModel

ATOL = 1e-12
F64 = torch.float64
AB2 = "QuasiAdamsBashforth2"
RK3 = "RungeKutta3"
DT = 1e-3
#: the aligned shape the JAX fused AB2 kernel accepts (y, z multiples of
#: 8 and 128), in the benchmark's (Bounded, Periodic, Periodic) layout
GRID = dict(size=(8, 16, 128), extent=(1.0, 1.0, 1.0),
            topology=(oj.Bounded, oj.Periodic, oj.Periodic), halo=(1, 0, 0))


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port runs on the GPU by default; these tests ask for the CPU,
    with one intra-op thread (the test workers share the machine's cores,
    and these small tensors gain nothing from more)."""
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def jax_state_to_numpy(s):
    out = {name: np.asarray(getattr(s, name)) for name in FIELDS}
    out.update(time=np.asarray(s.clock.time),
               iteration=int(s.clock.iteration),
               last_dt=np.asarray(s.clock.last_dt))
    return out


def initial_arrays(jg):
    rng = np.random.default_rng(0)
    return {name: rng.standard_normal(tuple(jg.N)) for name in "uvw"}


@pytest.fixture(scope="module")
def start():
    """The JAX grid and a projected starting state as numpy arrays."""
    jg = oj.RectilinearGrid(dtype="float64", **GRID)
    js = JModel(grid=jg, timestepper=AB2).initial_state(**initial_arrays(jg))
    return jg, jax_state_to_numpy(js)


def run_jax(jg, arrays, timestepper, steps, fused):
    jm = JModel(grid=jg, timestepper=timestepper, fused_kernels=fused)
    assert bool(jm.fused_ab2) == (fused and timestepper == AB2)
    s = dataclasses.replace(jm.initial_state(),
                            **{n: jnp.asarray(arrays[n]) for n in FIELDS})
    old = j_config.pallas_interpret
    j_config.pallas_interpret = fused
    try:
        # the XLA path steps eagerly (quicker than compiling it), the
        # interpreted kernels under jax.jit (quicker there)
        step = (jax.jit(lambda s_: jm.step(s_, DT)) if fused
                else (lambda s_: jm.step(s_, DT)))
        for _ in range(steps):
            s = step(s)
    finally:
        j_config.pallas_interpret = old
    return jax_state_to_numpy(s)


def run_port(arrays, timestepper, steps, configure=None, fused=True):
    tg = ot.RectilinearGrid(dtype=F64, **GRID)
    tm = ot.NonhydrostaticModel(grid=tg, timestepper=timestepper,
                                fused_kernels=fused)
    assert tm.fused_kernels == ("centered2" if fused else False)
    if configure is not None:
        configure(tm)
    s = state_from_numpy(tm, arrays)
    s = tm.fill_state_halos(s)
    for _ in range(steps):
        s = tm.step(s, DT, assume_filled=True)
    return tm, s


def assert_matches(tg, got, ref, names=FIELDS):
    ii = tg.interior_slices
    for name in names:
        np.testing.assert_allclose(got[name][ii], ref[name][ii], rtol=0,
                                   atol=ATOL, err_msg=name)
    assert got["iteration"] == ref["iteration"]
    assert float(got["time"]) == float(ref["time"])


def assert_divergence_free(tm, s):
    div = tm.grid.interior(divergence_ccc(tm.grid, s.u, s.v, s.w))
    assert float(div.abs().max()) < 1e-12


def test_initial_state_matches(start):
    jg, ref = start
    tg = ot.RectilinearGrid(dtype=F64, **GRID)
    tm = ot.NonhydrostaticModel(grid=tg, timestepper=AB2)
    s = tm.initial_state(**initial_arrays(jg))
    assert_matches(tg, state_to_numpy(s), ref, ("u", "v", "w", "pressure"))
    assert_divergence_free(tm, s)


@pytest.mark.parametrize("timestepper,steps", [(AB2, 5), (RK3, 3)])
@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_slice_matches_jax(start, timestepper, steps, jax_path):
    """5 AB2 steps (the first an Euler step) or 3 RK3 steps of the port's
    fused path against the JAX XLA path and the JAX fused kernels."""
    jg, arrays = start
    ref = run_jax(jg, arrays, timestepper, steps,
                  fused=jax_path == "pallas_interpret")
    tm, s = run_port(arrays, timestepper, steps)
    if timestepper == AB2:
        assert tm.fused_ab2
    assert_matches(tm.grid, state_to_numpy(s), ref)
    assert_divergence_free(tm, s)


def test_opt_in_kernels_match_jax(start):
    """The fused pressure correction and the fused matmul Poisson solver
    (both opt-in) against the JAX XLA path."""
    jg, arrays = start
    ref = run_jax(jg, arrays, AB2, 3, fused=False)

    def configure(tm):
        tm.fused_correction = True
        tm.pressure_solver = ot.MatmulPoissonSolver(tm.grid, fused=True)

    tm, s = run_port(arrays, AB2, 3, configure)
    assert_matches(tm.grid, state_to_numpy(s), ref)
    assert_divergence_free(tm, s)


def test_unfused_port_matches_fused_port(start):
    _, arrays = start
    tm_f, s_f = run_port(arrays, AB2, 3)
    tm_p, s_p = run_port(arrays, AB2, 3, fused=False)
    assert tm_f.fused_ab2 and not tm_p.fused_ab2
    assert_matches(tm_f.grid, state_to_numpy(s_f), state_to_numpy(s_p))


@pytest.mark.parametrize("path", ["fused", "plain", "opt_in"])
def test_profiled_phases_repeat_step(start, path):
    """``profile_step.phased_ab2_step``, which the profiling script times
    phase by phase, computes exactly what ``model.step`` does."""
    from oceananigans_torch.profile_step import PHASES, phased_ab2_step
    _, arrays = start

    def configure(tm):
        if path == "opt_in":
            tm.fused_correction = True
            tm.pressure_solver = ot.MatmulPoissonSolver(tm.grid, fused=True)

    tm, s = run_port(arrays, AB2, 2, configure, fused=path != "plain")
    # step writes halos and tendencies in place: each side gets a copy
    ref = tm.step(copy.deepcopy(s), DT, assume_filled=True)
    marks = []
    got = phased_ab2_step(tm, copy.deepcopy(s), DT, lambda: marks.append(1))
    assert len(marks) == len(PHASES)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.clock.iteration == ref.clock.iteration
    assert torch.equal(got.clock.time, ref.clock.time)


def test_interop_round_trip(start):
    _, arrays = start
    tm = ot.NonhydrostaticModel(grid=ot.RectilinearGrid(dtype=F64, **GRID))
    back = state_to_numpy(state_from_numpy(tm, arrays))
    for name in FIELDS:
        np.testing.assert_array_equal(back[name], arrays[name])
    with pytest.raises(KeyError):
        state_from_numpy(tm, {"u": arrays["u"]})


def test_gates_and_unported_arguments():
    tg = ot.RectilinearGrid(dtype=F64, **GRID)
    model = ot.NonhydrostaticModel(grid=tg)
    assert model.timestepper == RK3
    assert model.fused_kernels is False        # "auto" on a CPU device
    assert model.fused_correction is False
    assert isinstance(model.pressure_solver, ot.FFTPoissonSolver)
    assert "grid.xF" in dict(model.named_buffers())
    # any Coriolis object builds, as in the JAX package; its step calls
    # the object's x_f_cross_U
    model = ot.NonhydrostaticModel(grid=tg, coriolis=object())
    with pytest.raises(AttributeError, match="x_f_cross_U"):
        model.step(model.initial_state(), 1e-3)
    with pytest.raises(TypeError):
        ot.NonhydrostaticModel(grid=tg, closure=object())
    # forcings are ported: one builds, off the fused AB2 kernel's path
    assert not ot.NonhydrostaticModel(
        grid=tg, forcing={"u": 1.0}, timestepper="QuasiAdamsBashforth2",
        fused_kernels=True).fused_ab2
    with pytest.raises(ValueError):
        ot.NonhydrostaticModel(grid=tg, timestepper="Euler")


def test_import_leaves_jax_out():
    code = ("import sys, oceananigans_torch, oceananigans_torch.interop; "
            "sys.exit(int('jax' in sys.modules "
            "or 'oceananigans_tpu' in sys.modules))")
    root = Path(__file__).resolve().parent.parent
    assert subprocess.run([sys.executable, "-c", code],
                          cwd=root).returncode == 0
