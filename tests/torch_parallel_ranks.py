"""Rank programs and case specifications of ``test_torch_parallel.py`` and
``test_torch_parallel_cube.py``.

The test modules spawn their ranks (``oceananigans_torch.parallel.launch``)
once and run every case's rank program in that spawn; each rank imports
this module afresh, so it imports neither JAX nor the JAX package (nor the
test modules' conftest). A case is a dict of plain values; :func:`grid_of`,
:func:`model_of` and :func:`fields_of` build its grid, model and initial
fields from either package (``pkg`` is ``oceananigans_torch`` or
``oceananigans_tpu``, ``m`` its array namespace, ``torch`` or
``jax.numpy``), so both packages build the same configuration from one
description. The initial state crosses to the ranks as numpy arrays in
the global layout, and every rank takes its own block of it
(``interop.local_state_from_numpy``); rank 0 returns the stepped global
state as numpy arrays.
"""

import math

import numpy as np
import torch

import oceananigans_torch as ot
from oceananigans_torch.interop import (
    local_state_from_numpy, local_state_to_numpy,
)
from oceananigans_torch.parallel import (
    Distributed, DistributedModel, DistributedStep, Partition,
)

PI = math.pi


# ---------------------------------------------------------------------------
# Case descriptions -> grids, models, initial fields of either package
# ---------------------------------------------------------------------------

def bottom_of(m, kind):
    """The bottom height function of an immersed case."""
    if kind == "hill":
        return lambda x, y: -1000.0 + 600.0 * m.exp(
            -((x - 1e5) ** 2 + (y - 5e4) ** 2) / (3e4) ** 2)
    if kind == "bump":
        return lambda x, y: -1.0 + 0.4 * m.exp(-((x - 1.0) / 0.3) ** 2)
    if kind == "partial":
        return lambda x, y: -1.0 + 0.35 * m.exp(-((x - 1.0) / 0.4) ** 2)
    raise ValueError(kind)


def grid_of(pkg, m, case):
    """The case's global grid in ``pkg`` (float64)."""
    kw = dict(case["grid"])
    kw["topology"] = tuple(getattr(pkg, t) for t in kw["topology"])
    if "z_power" in kw:
        n, p = kw.pop("z_power")
        kw["z"] = -(1.0 - np.linspace(0, 1, n + 1) ** p)
    kind = case.get("grid_kind", "RectilinearGrid")
    grid = getattr(pkg, kind)(dtype="float64", **kw)
    if "bottom" in case:
        cls = (pkg.PartialCellBottom if case["bottom"] == "partial"
               else pkg.GridFittedBottom)
        grid = pkg.ImmersedBoundaryGrid(grid, cls(bottom_of(m, case[
            "bottom"])))
    return grid


def model_of(pkg, m, case, grid, fused=None):
    """The case's model on ``grid`` in ``pkg``; ``fused`` overrides the
    kernel switch (``fused_kernels``)."""
    kw = {}
    for key, val in case.get("model", {}).items():
        if key in ("advection", "tracer_advection", "momentum_advection"):
            kw[key] = getattr(pkg, val[0])(*val[1:])
        elif key == "free_surface":
            kw[key] = getattr(pkg, val[0])(**val[1])
        elif key in ("buoyancy", "coriolis", "closure",
                     "vertical_coordinate"):
            if val == "SeawaterLinear":
                kw[key] = pkg.SeawaterBuoyancy(
                    equation_of_state=pkg.LinearEquationOfState())
            else:
                kw[key] = getattr(pkg, val)()
        elif key == "forcing":
            kw[key] = {case["model"]["tracers"][0]: pkg.Forcing(
                lambda lam, phi, z, t: 1e-7 * m.cos(m.deg2rad(phi)))}
        elif key == "background_fields":
            kw[key] = {"u": lambda x, y, z: 0.1 * z + 0 * x}
        elif key == "boundary_conditions":
            kw[key] = {"u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(lambda x, y, t: 1e-5 + 0 * x))}
        else:
            kw[key] = val
    if fused is not None:
        kw["fused_kernels"] = fused
    cls = (pkg.HydrostaticFreeSurfaceModel if case["kind"] == "hydrostatic"
           else pkg.NonhydrostaticModel)
    return cls(grid=grid, **kw)


def fields_of(m, case):
    """The case's initial fields (numbers and callables of the
    coordinates, in the array namespace ``m``)."""
    name = case["ic"]
    if name == "weno":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x)
                    * m.cos(2 * PI * y),
                    b=lambda x, y, z: 0.01 * z
                    + 0.001 * m.cos(2 * PI * y))
    if name == "bounded":
        return dict(u=lambda x, y, z: 0.1 * m.sin(PI * x) * m.cos(PI * z),
                    v=lambda x, y, z: 0.05 * m.cos(2 * PI * y) + 0 * x)
    if name == "stretched":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x) + 0 * y,
                    b=lambda x, y, z: 0.01 * z
                    + 0.001 * m.cos(2 * PI * y))
    if name == "pallas":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x)
                    * m.cos(2 * PI * y),
                    v=lambda x, y, z: 0.05 * m.cos(2 * PI * y) + 0 * x)
    if name == "hydro":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x / 1e5) + 0 * y,
                    T=lambda x, y, z: 15.0 + 8e-3 * z
                    + 0.2 * m.cos(2 * PI * y / 5e4),
                    S=35.0,
                    eta=lambda x, y: 0.05 * m.sin(2 * PI * x / 1e5) + 0 * y)
    if name == "generic":
        # profile_step.hydro_generic_state's fields: no velocity within
        # rounding of zero, where two devices' roundings would pick
        # different upwind sides
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x / 4e7 + 0.5)
                    * m.cos(PI * y / 2e7 + 0.2) + 0.01,
                    v=lambda x, y, z: 0.05 * m.cos(2 * PI * x / 4e7 + 0.3)
                    * m.sin(PI * y / 2e7) + 0 * z,
                    T=lambda x, y, z: 20.0 + 8e-4 * z + 1e-7 * y + 0 * x,
                    S=lambda x, y, z: 35.0 + 1e-8 * y + 0 * x + 0 * z)
    if name == "implicit":
        return dict(u=lambda x, y, z: 0.05 * m.sin(2 * PI * x / 2e5) + 0 * y,
                    T=lambda x, y, z: 10.0 + 5e-3 * z + 0 * x,
                    eta=lambda x, y: 0.05 * m.sin(2 * PI * x / 2e5)
                    * m.cos(2 * PI * y / 1e5))
    if name == "zstar":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x / 2e5) + 0 * y,
                    T=lambda x, y, z: 10.0 + 5e-3 * z + 0 * x,
                    eta=lambda x, y: 0.1 * m.sin(2 * PI * x / 2e5) + 0 * y)
    if name == "immersed":
        return dict(u=lambda x, y, z: 0.1 + 0 * x,
                    T=lambda x, y, z: 10.0 + 5e-3 * z + 0 * x,
                    eta=lambda x, y: 0.02 * m.sin(2 * PI * x / 2e5) + 0 * y)
    if name == "latlon":
        return dict(u=lambda lam, phi, z: 0.1 * m.cos(m.deg2rad(phi))
                    + 0 * lam,
                    T=lambda lam, phi, z: 10.0 + 5e-3 * z
                    + 0.3 * m.sin(m.deg2rad(lam) * 3.0),
                    eta=lambda lam, phi: 0.05 * m.sin(m.deg2rad(lam) * 2.0)
                    + 0 * phi)
    if name == "catke":
        return dict(u=lambda x, y, z: 0.05 * m.sin(2 * PI * x / 1e4) + 0 * y,
                    b=lambda x, y, z: 1e-5 * z
                    + 1e-7 * m.cos(2 * PI * y / 1e4),
                    e=1e-6)
    if name == "flow":
        return dict(u=lambda x, y, z: 0.1 + 0 * x)
    if name == "simulation":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x / 2e5) + 0 * y,
                    T=lambda x, y, z: 10.0 + 5e-3 * z + 0 * x)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Rank programs
# ---------------------------------------------------------------------------

def _dist(case, dist):
    """A Distributed over the case's partition (collective)."""
    return Distributed(Partition(*case["partition"]), device=dist.device)


def _step_case(dist, case, arrays):
    """The distributed steps of a model case from the given initial state;
    the global numpy state on rank 0, with the local model's kernel
    gates."""
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    dstep = DistributedStep(
        lambda g: model_of(ot, torch, case, g, case.get("fused")), grid, d)
    state = local_state_from_numpy(dstep, arrays)
    for _ in range(case["steps"]):
        state = dstep.step(state, case["dt"])
    out = local_state_to_numpy(dstep, state)
    lm = dstep.lmodel
    gates = {k: getattr(lm, k) for k in (
        "fused_kernels", "fused_tracer", "fused_ab2", "fused_ab2_weno",
        "fused_ab2_science", "fused_ab2_weno_science") if hasattr(lm, k)}
    solver = getattr(lm, "pressure_solver", None)
    gates["preconditioned"] = getattr(solver, "preconditioner", 0) is not None
    return None if out is None else {"state": out, "gates": gates}


def _spy_case(dist, case, arrays):
    """As :func:`_step_case`, counting the calls of the kernel wrappers
    that the local nonhydrostatic model makes (on the CPU they run their
    plain versions, so the launch counts stay 0)."""
    import oceananigans_torch.models.nonhydrostatic as nh
    names = ("centered2_momentum_tendency", "centered2_ab2_update",
             "centered2_science_ab2_update", "weno5_momentum_tendency",
             "weno5_tracer_tendencies", "weno5_ab2_update",
             "weno5_science_ab2_update", "weno_tracer_tendencies")
    calls = {n: 0 for n in names}
    saved = {n: getattr(nh, n) for n in names}

    def spy(name):
        def wrapped(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return wrapped

    for n in names:
        setattr(nh, n, spy(n))
    try:
        out = _step_case(dist, case, arrays)
    finally:
        for n, f in saved.items():
            setattr(nh, n, f)
    if out is not None:
        out["calls"] = {n: c for n, c in calls.items() if c}
    return out


def _exchange_case(dist, case, arrays):
    """to_local_layout -> halo_exchange -> from_local_layout; the blocks
    after the exchange, tiled in the JAX package's local layout."""
    from oceananigans_torch.parallel import (
        from_local_layout, halo_exchange, to_local_layout,
    )
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    a = torch.as_tensor(arrays["interior"]) if d.rank == 0 else None
    local = to_local_layout(a, d, grid, interior_shape=grid.N)
    local = halo_exchange(local, d, grid)
    back = from_local_layout(local, d, grid, grid.N)
    blocks = d.gather_blocks(local)
    if blocks is None:
        return None
    px, py = d.partition
    rows = [torch.cat(blocks[rx * py:(rx + 1) * py], dim=1)
            for rx in range(px)]
    return {"local": torch.cat(rows, dim=0).numpy(), "back": back.numpy()}


def _solver_case(dist, case, arrays):
    """The pencil FFT or Fourier-tridiagonal solve of a global right-hand
    side; the global solution on rank 0."""
    from oceananigans_torch.parallel import (
        DistributedFFTPoissonSolver, DistributedFourierTridiagonalSolver,
    )
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    cls = (DistributedFFTPoissonSolver if case["solver"] == "fft"
           else DistributedFourierTridiagonalSolver)
    solver = cls(grid, d)
    rx, ry = d.coords
    nxl, nyl = grid.N[0] // d.partition[0], grid.N[1] // d.partition[1]
    rhs = torch.as_tensor(arrays["rhs"])[rx * nxl:(rx + 1) * nxl,
                                         ry * nyl:(ry + 1) * nyl]
    phi = solver.solve(rhs.contiguous())
    blocks = d.gather_blocks(phi.contiguous())
    if blocks is None:
        return None
    py = d.partition[1]
    rows = [torch.cat(blocks[i * py:(i + 1) * py], dim=1)
            for i in range(d.partition[0])]
    return {"phi": torch.cat(rows, dim=0).numpy()}


def _refusal_case(dist, case, arrays):
    """The ValueError of each refused configuration."""
    d = _dist(case, dist)
    out = {}
    for name, sub in case["refused"].items():
        grid = grid_of(ot, torch, sub)
        try:
            DistributedStep(lambda g: model_of(ot, torch, sub, g), grid, d)
        except ValueError as err:
            out[name] = str(err)
        else:
            out[name] = None
    return out if d.rank == 0 else None


def _simulation_case(dist, case, arrays):
    """Simulation driving a DistributedModel: an HDF5 writer of the global
    fields (rank 0), sharded checkpoints every 3 steps, 6 steps; then a
    fresh run picked up from iteration 3 to 6, which must reproduce the
    first bit for bit."""
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    path = case["dir"]

    def fresh():
        dstep = DistributedStep(lambda g: model_of(ot, torch, case, g),
                                grid, d)
        return dstep, DistributedModel(dstep)

    dstep, dmodel = fresh()
    sim = ot.Simulation(dmodel, state=local_state_from_numpy(dstep, arrays),
                        dt=case["dt"], stop_iteration=6)
    sim.output_writers["f"] = ot.HDF5Writer(
        {"T": "T", "u": "u"}, f"{path}/fields.h5", ot.IterationInterval(3))
    sim.output_writers["ck"] = ot.OrbaxCheckpointer(
        f"{path}/ck", ot.IterationInterval(3))
    sim.run()
    first = local_state_to_numpy(dstep, sim.state)
    u_local = sim.state.u.clone()

    dstep2, dmodel2 = fresh()
    sim2 = ot.Simulation(dmodel2,
                         state=local_state_from_numpy(dstep2, arrays),
                         dt=case["dt"], stop_iteration=6)
    sim2.output_writers["ck"] = ot.OrbaxCheckpointer(
        f"{path}/ck", ot.IterationInterval(3))
    sim2.run(pickup=True)
    bitwise = bool(torch.equal(sim2.state.u, u_local))

    # a plain Checkpointer would save every rank's block to one file
    sim3 = ot.Simulation(dmodel2, state=sim2.state, dt=case["dt"],
                         stop_iteration=7)
    sim3.output_writers["plain"] = ot.Checkpointer(
        f"{path}/plain", ot.IterationInterval(1))
    try:
        sim3.run()
    except ValueError as err:
        refusal = str(err)
    else:
        refusal = None
    if d.rank != 0:
        return None
    return {"state": first, "iteration": int(sim2.state.clock.iteration),
            "bitwise": bitwise, "plain_checkpointer": refusal}


def _gspmd_case(dist, case, arrays):
    """``sharded_step_fn``: the global state in and out (rank 0), the
    explicit-halo step between; and its NotImplementedError for a
    configuration only the JAX package's GSPMD path takes."""
    from oceananigans_torch.interop import state_from_numpy, state_to_numpy
    from oceananigans_torch.parallel import sharded_step_fn
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    model = model_of(ot, torch, case, grid)
    step = sharded_step_fn(model, d, case["dt"])
    state = state_from_numpy(model, arrays) if d.rank == 0 else None
    for _ in range(case["steps"]):
        state = step(state)
    refused = case["refused"]
    rmodel = model_of(ot, torch, refused, grid_of(ot, torch, refused))
    try:
        sharded_step_fn(rmodel, d, case["dt"])
    except NotImplementedError as err:
        message = str(err)
    else:
        message = None
    from oceananigans_torch.parallel import shard_state
    slab = shard_state(d, model.initial_state())
    if d.rank != 0:
        return None
    return {"state": state_to_numpy(state), "refusal": message,
            "slab": tuple(slab.u.shape), "global": tuple(grid.shape)}


CASES = {"gspmd": _gspmd_case, "step": _step_case, "spy": _spy_case, "exchange": _exchange_case,
         "solver": _solver_case, "refusal": _refusal_case,
         "simulation": _simulation_case}


def run_cases(dist, cases):
    """Every case's rank program in turn on this rank: ``{name: result}``
    (rank 0's results; None elsewhere)."""
    ot.config.device = "cpu"
    out = {}
    for name, (case, arrays) in cases.items():
        out[name] = CASES[case["program"]](dist, case, arrays)
    return out if dist.rank == 0 else None


# ---------------------------------------------------------------------------
# The cube
# ---------------------------------------------------------------------------

def cube_case(dist, case, arrays):
    """A distributed cube model (``R``, ``panels``) stepped from the JAX
    package's stacked initial state; the stacked numpy state on rank 0
    and the model's conserved totals before and after."""
    from oceananigans_torch.interop import state_from_numpy, state_to_numpy
    from oceananigans_torch.parallel import (
        CubedSphereDistributedHydrostatic, CubedSphereDistributedSW,
    )
    model = cube_model_of(ot, torch, case)
    state = state_from_numpy(model, arrays)
    cls = (CubedSphereDistributedSW if case["kind"] == "sw"
           else CubedSphereDistributedHydrostatic)
    dm = cls(model, dist, R=case["R"], panels=case["panels"])
    b = dm.to_local_state(state)
    for _ in range(case["steps"]):
        b = dm.step(b, case["dt"])
    final = dm.from_local_state(b)
    if final is None:
        return None
    out = {"state": state_to_numpy(final)}
    if case["kind"] == "sw":
        out["totals"] = [float(model.total_mass(s)) for s in (state, final)]
    else:
        out["totals"] = [(float(model.total_volume(s)),
                          float(model.total_tracer(s, "b")))
                         for s in (state, final)]
    return out


def cube_model_of(pkg, m, case):
    """The cube case's model in ``pkg`` (its cube classes live in
    ``pkg.models.cubed_sphere`` and ``pkg.grids.cubed_sphere_grid``), as
    ``tests/test_cubed_sphere_dist.py`` builds them: the shallow water with
    a tracer c, the hydrostatic model with its default b, explicit free
    surface and RK3, or the implicit free surface's CG."""
    import importlib
    cs = importlib.import_module(pkg.__name__ + ".models.cubed_sphere")
    gridmod = importlib.import_module(pkg.__name__
                                      + ".grids.cubed_sphere_grid")
    if case["kind"] == "sw":
        grid = gridmod.ConformalCubedSphereGrid(
            (case["N"], 1), z=(-1.0, 0.0), radius=6.4e6, dtype="float64")
        return cs.CubedSphereShallowWaterModel(grid, tracers=("c",))
    grid = gridmod.ConformalCubedSphereGrid(
        (case["N"], case["Nz"]), z=(-1000.0, 0.0), radius=6.37122e6,
        dtype="float64")
    kw = {}
    if case.get("free_surface") == "implicit":
        kw["free_surface"] = pkg.ImplicitFreeSurface(solver_method="cg")
    return cs.CubedSphereHydrostaticModel(grid, **kw)


def run_cube_cases(dist, cases):
    ot.config.device = "cpu"
    out = {name: cube_case(dist, case, arrays)
           for name, (case, arrays) in cases.items()}
    return out if dist.rank == 0 else None


# ---------------------------------------------------------------------------
# On the card (tests/test_torch_parallel_gpu.py)
# ---------------------------------------------------------------------------

def device_run(dist, case):
    """A model case built, started and stepped by the port alone on the
    ranks' device (``dist.device``): the global numpy state on rank 0."""
    from oceananigans_torch.interop import state_to_numpy
    ot.config.device = str(dist.device)
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    dstep = DistributedStep(lambda g: model_of(ot, torch, case, g), grid, d)
    g0 = dstep.gmodel.initial_state(**fields_of(torch, case)) \
        if d.rank == 0 else None
    state = dstep.to_local_state(g0)
    for _ in range(case["steps"]):
        state = dstep.step(state, case["dt"])
    out = dstep.from_local_state(state)
    gates = (dstep.lmodel.fused_kernels, dstep.lmodel.fused_tracer)
    return None if out is None else {"state": state_to_numpy(out),
                                     "gates": gates}
