"""The port's distributed cubed sphere (``oceananigans_torch/parallel/
cubed_sphere_shard.py``) on the CPU against the JAX package's SERIAL cube,
in float64, at ``tests/test_cubed_sphere_dist.py``'s tolerances.

The ranks are spawned once for each layout: six gloo ranks for ``R=1``
(one panel a rank) and eight for ``R=2, panels=2`` (three panels' blocks a
rank); each spawn runs every case of its layout (``tests/
torch_parallel_ranks.py``, which imports no JAX) from the JAX package's
stacked initial state. The shallow water is the JAX tests' solid-body
rotation with a tracer at C16; the hydrostatic cube their Gaussian η over
a stratified b at C16×6, with the explicit free surface, and with the
implicit one's CG (held to 1e-8, as there). Mass, volume and tracer
content are conserved as the JAX tests require. The cases of one
configuration (the layouts of one model) share one JAX model and one
serial run, recorded at each case's step count.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

import oceananigans_torch as ot
import oceananigans_tpu as oj
from oceananigans_torch.parallel import launch

import torch_parallel_ranks as tr

CASES = {
    # R, panels, kind, steps, Δt (test_cubed_sphere_dist.py)
    "sw_r1": dict(kind="sw", N=16, R=1, panels=6, steps=5, dt=30.0),
    "sw_r2": dict(kind="sw", N=16, R=2, panels=2, steps=5, dt=30.0),
    "sw_r2_conservation": dict(kind="sw", N=16, R=2, panels=2, steps=10,
                               dt=30.0),
    "hydro_r2": dict(kind="hydro", N=16, Nz=6, R=2, panels=2, steps=3,
                     dt=150.0),
    "hydro_r1_conservation": dict(kind="hydro", N=16, Nz=6, R=1, panels=6,
                                  steps=10, dt=150.0),
    "hydro_r2_implicit": dict(kind="hydro", N=16, Nz=6, R=2, panels=2,
                              steps=3, dt=2000.0, free_surface="implicit",
                              rtol=1e-8),
}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    old = ot.config.device, torch.get_num_threads()
    ot.config.device = "cpu"
    torch.set_num_threads(1)
    yield
    ot.config.device = old[0]
    torch.set_num_threads(old[1])


def jax_arrays(state):
    """A JAX cube state as the numpy mapping of ``interop``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if f.name == "clock":
            out["time"] = np.asarray(v.time)
            out["iteration"] = np.asarray(v.iteration)
            out["last_dt"] = np.asarray(v.last_dt)
        elif isinstance(v, dict):
            out.update({f"{f.name}/{n}": np.asarray(a)
                        for n, a in v.items()})
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_initial(case):
    """The JAX package's model and initial state of ``case``, as
    ``tests/test_cubed_sphere_dist.py`` sets them up."""
    from oceananigans_tpu.models.cubed_sphere import panel_vector_components
    model = tr.cube_model_of(oj, jax.numpy, case)
    grid = model.grid
    if case["kind"] == "sw":
        axis = np.array([0.3, 0.2, 1.0])
        u0, v0 = panel_vector_components(
            grid, lambda pts: 20.0 * np.cross(axis / np.linalg.norm(axis),
                                              pts))
        state = model.initial_state(
            u=u0, v=v0, h=8000.0,
            c=lambda lam, phi, z: np.exp(-((lam - 30) / 25) ** 2
                                         - (phi / 25) ** 2))
        return model, state

    def eta0(lam, phi, z):
        r = np.deg2rad(phi) ** 2 \
            + np.deg2rad(((lam + 180) % 360) - 180) ** 2
        return np.exp(-r / 0.02) + 0 * z

    g = grid.panel_grid
    e0 = grid.set_tracer(eta0)[..., g.Hz:g.Hz + 1]
    return model, model.initial_state(eta=e0,
                                      b=lambda lam, phi, z: 1e-5 * z)


def configuration(case):
    """What a case's model and serial run depend on: everything but its
    layout, its step count and its tolerance."""
    return tuple(sorted((k, v) for k, v in case.items()
                        if k not in ("R", "panels", "steps", "rtol")))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case stepped by the distributed cube, one spawn a layout,
    and, while the ranks run, the JAX serial states (:func:`serial`);
    ``(inputs, results)`` by case name (the cases of one configuration
    share the JAX model and initial state)."""
    inputs, by_layout, built = {}, {}, {}
    for name, case in CASES.items():
        key = configuration(case)
        if key not in built:
            built[key] = jax_initial(case)
        model, state = inputs[name] = built[key]
        n = case["panels"] * case["R"] ** 2
        by_layout.setdefault(n, {})[name] = (case, jax_arrays(state))
    def spawns():
        results = {}
        for n, cases in by_layout.items():
            results.update(launch(
                n, tr.run_cube_cases, (cases,),
                rendezvous_dir=tmp_path_factory.mktemp(f"rdzv{n}"),
                backend="gloo", device="cpu")[0])
        return results

    # this process only waits for the ranks: it steps the JAX references
    # meanwhile
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawns)
        for name in COMPARED:
            serial(inputs, name)
        return inputs, ranks_done.result()


#: the cases held to the JAX serial step
COMPARED = ("sw_r1", "sw_r2", "hydro_r2", "hydro_r2_implicit",
            "hydro_r1_conservation")
#: the JAX serial states by configuration, at each step count its cases
#: take: ``{configuration: {steps: state}}``
REFERENCES = {}


def serial(inputs, name):
    """The JAX serial state of case ``name`` after its steps: one jitted
    run for each configuration, to the most steps its cases take."""
    key = configuration(CASES[name])
    if key not in REFERENCES:
        counts = {c["steps"] for c in CASES.values()
                  if configuration(c) == key}
        model, state = inputs[name]
        step = jax.jit(model.step)
        REFERENCES[key] = {}
        for i in range(1, max(counts) + 1):
            state = step(state, CASES[name]["dt"])
            if i in counts:
                REFERENCES[key][i] = jax_arrays(state)
    return REFERENCES[key][CASES[name]["steps"]]


@pytest.mark.parametrize("name", COMPARED[:2])
def test_shallow_water_matches_jax_serial(ranks, name):
    inputs, results = ranks
    model, _ = inputs[name]
    ref = serial(inputs, name)
    got = results[name]["state"]
    sx, sy, _ = model.grid.panel_grid.interior_slices
    for key in ("u", "v", "h"):
        np.testing.assert_allclose(got[key][:, sx, sy], ref[key][:, sx, sy],
                                   rtol=1e-13, atol=1e-13, err_msg=key)
    np.testing.assert_allclose(got["tracers/c"][:, sx, sy],
                               ref["tracers/c"][:, sx, sy], rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("name", COMPARED[2:])
def test_hydrostatic_matches_jax_serial(ranks, name):
    inputs, results = ranks
    model, _ = inputs[name]
    rtol = CASES[name].get("rtol", 1e-12)
    ref = serial(inputs, name)
    got = results[name]["state"]
    sx, sy, sz = model.grid.panel_grid.interior_slices
    for key in ("u", "v"):
        np.testing.assert_allclose(got[key][:, sx, sy, sz],
                                   ref[key][:, sx, sy, sz], rtol=rtol,
                                   atol=1e-15, err_msg=key)
    np.testing.assert_allclose(got["eta"][:, sx, sy], ref["eta"][:, sx, sy],
                               rtol=rtol, atol=1e-13, err_msg="eta")
    np.testing.assert_allclose(got["tracers/b"][:, sx, sy, sz],
                               ref["tracers/b"][:, sx, sy, sz], rtol=rtol,
                               atol=1e-14, err_msg="b")


def test_shallow_water_conserves_mass(ranks):
    _, results = ranks
    m0, m1 = results["sw_r2_conservation"]["totals"]
    assert abs(m1 / m0 - 1) < 1e-13


def test_hydrostatic_conserves_volume_and_tracer(ranks):
    _, results = ranks
    (v0, b0), (v1, b1) = results["hydro_r1_conservation"]["totals"]
    assert abs(v1 - v0) < 1e-9 * max(abs(v0), 1e12) + 1.0
    assert abs(b1 / b0 - 1) < 1e-12


def test_rejects_bad_partitions():
    """The layout's refusals, as the JAX package's (a one-rank group
    stands in for the ranks: each refusal comes before any exchange)."""
    from oceananigans_torch.parallel.cubed_sphere_shard import _CSDistBase

    class One:
        world_size, rank, device = 1, 0, torch.device("cpu")

    model = tr.cube_model_of(ot, torch, dict(kind="sw", N=16))
    for R, panels, match in ((3, 2, "divide R=3"), (1, 4, "must divide 6"),
                             (8, 1, "must exceed the halo"),
                             (1, 6, "needs 6 ranks")):
        with pytest.raises(ValueError, match=match):
            _CSDistBase(model, One(), R=R, panels=panels)
