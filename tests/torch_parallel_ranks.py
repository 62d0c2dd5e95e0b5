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
    if "topology" in kw:
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
        elif key == "closure" and val == "hydro_closure":
            kw[key] = (pkg.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                       pkg.VerticalScalarDiffusivity(
                           nu=1e-3, kappa=1e-5, time_discretization=(
                               pkg.VerticallyImplicitTimeDiscretization)))
        elif key == "coriolis" and isinstance(val, tuple):
            kw[key] = getattr(pkg, val[0])(**val[1])
        elif key in ("buoyancy", "coriolis", "closure",
                     "vertical_coordinate"):
            if val == "SeawaterLinear":
                kw[key] = pkg.SeawaterBuoyancy(
                    equation_of_state=pkg.LinearEquationOfState())
            else:
                kw[key] = getattr(pkg, val)()
        elif key == "forcing" and val == "xy":
            # a sponge masked in x, and a forcing of (x, y)
            kw[key] = {
                "b": pkg.Relaxation(rate=2.0, mask=pkg.GaussianMask(
                    1.5, 0.2, "x"), target=pkg.LinearTarget(0.0, 0.01, "z")),
                "u": pkg.Forcing(lambda x, y, z, t: 0.01 * m.sin(PI * x)
                                 * m.cos(PI * y))}
        elif key == "forcing" and val == "T_xy":
            kw[key] = {"T": pkg.Forcing(
                lambda x, y, z, t: 1e-6 * m.cos(2 * PI * y / 1e5)
                + 1e-11 * x)}
        elif key == "forcing":
            kw[key] = {case["model"]["tracers"][0]: pkg.Forcing(
                lambda lam, phi, z, t: 1e-7 * m.cos(m.deg2rad(phi)))}
        elif key == "background_fields" and val == "xy":
            kw[key] = {"u": lambda x, y, z: 0.05 * y + 0.01 * x,
                       "b": lambda x, y, z: 0.001 * x + 0.002 * y}
        elif key == "background_fields":
            kw[key] = {"u": lambda x, y, z: 0.1 * z + 0 * x}
        elif key == "boundary_conditions" and val == "stress_xy":
            kw[key] = {"u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(lambda x, y, t: 1e-3 * m.sin(PI * x) * y))}
        elif key == "boundary_conditions" and val == "closure":
            # phase 13's: a callable wind stress on u, an array T flux
            # over the halo-extended top slab (zero halo)
            N, H = case["grid"]["size"], case["grid"]["halo"]
            flux = np.zeros((N[0] + 2 * H[0], N[1] + 2 * H[1], 1))
            flux[H[0]:-H[0], H[1]:-H[1], 0] = 1e-5 * \
                np.random.default_rng(0).standard_normal(N[:2])
            kw[key] = {
                "u": pkg.FieldBoundaryConditions(top=pkg.FluxBC(
                    lambda x, y, t: -1e-4 * m.cos(PI * y / 2e7))),
                "T": pkg.FieldBoundaryConditions(top=pkg.FluxBC(flux))}
        elif key == "boundary_conditions" and val == "u_flux":
            kw[key] = {"u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(-1e-4))}
        elif key == "boundary_conditions":
            kw[key] = {"u": pkg.FieldBoundaryConditions(
                top=pkg.FluxBC(lambda x, y, t: 1e-5 + 0 * x))}
        elif key == "particles":
            x, y, z = particle_positions(case)
            kw[key] = pkg.LagrangianParticles(
                x=x, y=y, z=z, restitution=val["restitution"],
                tracked_fields=val["tracked"])
        else:
            kw[key] = val
    if fused is not None:
        kw["fused_kernels"] = fused
    cls = {"hydrostatic": pkg.HydrostaticFreeSurfaceModel,
           "shallow_water": pkg.ShallowWaterModel}.get(
               case["kind"], pkg.NonhydrostaticModel)
    return cls(grid=grid, **kw)


def particle_positions(case):
    """A case's particles: ``n`` from ``default_rng(seed)`` over the
    domain; then particles exactly on the inner block boundaries of the
    case's partition (the global faces between blocks) and at their
    crossings, where the owner rule decides, and the same just short of
    them, which the flow may carry across."""
    from oceananigans_torch.parallel.distributed import (
        block_offsets, block_sizes,
    )
    spec = case["model"]["particles"]
    g = grid_of(ot, torch, case)
    ends, inner = [], []
    for axis, name in enumerate("xyz"):
        f = getattr(g, f"{name}F").reshape(-1).numpy()
        H, N = g.H[axis], g.N[axis]
        lo = f[H]
        ends.append((lo, lo + (g.Lx, g.Ly, g.Lz)[axis]))
        if axis < 2:
            offs = block_offsets(block_sizes(N, case["partition"][axis]))
            inner.append([f[H + o] for o in offs[1:]]
                         + [lo + 0.3 * (ends[-1][1] - lo)])
    rng = np.random.default_rng(spec["seed"])
    n = spec["n"]
    x, y, z = (a + (b - a) * rng.random(n) for a, b in ends)
    X, Y = (q.ravel() for q in np.meshgrid(*inner, indexing="ij"))
    near = 1e-3 * min(ends[0][1] - ends[0][0], ends[1][1] - ends[1][0])
    (z0, z1) = ends[2]
    return (np.concatenate([x, X, X - near]),
            np.concatenate([y, Y, Y - near]),
            np.concatenate([z, np.full(2 * X.size, 0.5 * (z0 + z1))]))


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
    if name == "tripolar":
        # tests/test_orthogonal_grids.py's distributed tripolar state
        return dict(b=lambda lam, phi, z: 1e-5 * z + 0 * lam,
                    eta=lambda lam, phi: 0.1 * m.exp(
                        -((lam - 200) / 40) ** 2 - ((phi - 10) / 20) ** 2))
    if name == "rotated":
        return dict(u=lambda lam, phi, z: 0.1 * m.sin(m.deg2rad(lam) + 0.3)
                    * m.cos(m.deg2rad(phi)) + 0 * z,
                    v=lambda lam, phi, z: 0.05 * m.cos(m.deg2rad(lam))
                    + 0 * z,
                    T=lambda lam, phi, z: 20.0 + 1e-3 * z
                    + 0.05 * m.cos(m.deg2rad(phi)),
                    S=lambda lam, phi, z: 35.0 + 1e-3 * phi + 0 * z,
                    eta=lambda lam, phi: 0.02 * m.sin(m.deg2rad(lam)) + 0 * phi)
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
    if name == "zstar_catke":
        return dict(u=lambda x, y, z: 0.1 * m.sin(2 * PI * x / 2e5) + 0 * y,
                    v=lambda x, y, z: 0.05 * m.cos(2 * PI * x / 2e5)
                    * m.sin(PI * y / 1e5) + 0 * z,
                    T=lambda x, y, z: 10.0 + 5e-3 * z
                    + 0.2 * m.cos(2 * PI * y / 1e5),
                    S=lambda x, y, z: 35.0 + 1e-6 * x + 0 * z,
                    eta=lambda x, y: 0.1 * m.sin(2 * PI * x / 2e5)
                    * m.cos(PI * y / 1e5),
                    e=1e-6)
    if name == "zstar_catke_latlon":
        return dict(u=lambda lam, phi, z: 0.1 * m.cos(m.deg2rad(phi))
                    * m.sin(m.deg2rad(lam) * 2.0) + 0 * z,
                    T=lambda lam, phi, z: 10.0 + 5e-3 * z
                    + 0.3 * m.sin(m.deg2rad(lam) * 3.0),
                    S=lambda lam, phi, z: 35.0 + 1e-3 * phi + 0 * z,
                    eta=lambda lam, phi: 0.1 * m.sin(m.deg2rad(lam) * 2.0)
                    * m.cos(m.deg2rad(phi)),
                    e=1e-6)
    if name == "flow":
        return dict(u=lambda x, y, z: 0.1 + 0 * x)
    if name == "forced":
        return dict(u=lambda x, y, z: 0.3 * m.sin(PI * x) * m.cos(PI * y),
                    v=lambda x, y, z: 0.3 * m.cos(PI * x) * m.sin(PI * y),
                    b=lambda x, y, z: 0.01 * z + 0 * x)
    if name == "orbax":
        return dict(u=lambda x, y, z: m.sin(2 * PI * x) * m.cos(2 * PI * y)
                    + 0 * z)
    if name == "hydro_particles":
        return dict(u=lambda x, y, z: 0.5 * m.sin(2 * PI * y / 1e5) + 0 * x,
                    v=lambda x, y, z: 0.3 * m.sin(PI * x / 2e5) + 0 * y,
                    T=lambda x, y, z: 10.0 + 5e-3 * z + 1e-5 * x + 0 * y,
                    eta=lambda x, y: 0.05 * m.sin(2 * PI * y / 1e5) + 0 * x)
    if name == "sw":
        return dict(h=lambda x, y, z: 1000.0 + m.sin(2 * PI * x / 1e6)
                    * m.cos(2 * PI * y / 1e6),
                    uh=lambda x, y, z: 100.0 * m.cos(2 * PI * y / 1e6)
                    + 0 * x)
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


def _sharded_run(d, case, arrays):
    """A case stepped through ``sharded_step_fn`` from the global state
    ``arrays`` (rank 0): the step function and the global numpy state on
    rank 0 (None elsewhere)."""
    from oceananigans_torch.interop import state_from_numpy, state_to_numpy
    from oceananigans_torch.parallel import sharded_step_fn
    grid = grid_of(ot, torch, case)
    model = model_of(ot, torch, case, grid, case.get("fused"))
    step = sharded_step_fn(model, d, case["dt"])
    state = state_from_numpy(model, arrays) if d.rank == 0 else None
    for _ in range(case["steps"]):
        state = step(state)
    return step, (None if state is None else state_to_numpy(state))


def _gspmd_case(dist, case, arrays):
    """``sharded_step_fn``: the global state in and out (rank 0), the
    explicit-halo step between, for a configuration the explicit-halo step
    takes and one that only the sharded step takes (``arrays`` holds each
    one's initial state); and ``shard_state``'s slab."""
    from oceananigans_torch.parallel import shard_state
    d = _dist(case, dist)
    out = {}
    for key, sub in (("state", case), ("widened", case["widened"])):
        _, out[key] = _sharded_run(d, sub, arrays[key])
    grid = grid_of(ot, torch, case)
    model = model_of(ot, torch, case, grid)
    slab = shard_state(d, model.initial_state())
    out["slab"], out["global"] = tuple(slab.u.shape), tuple(grid.shape)
    return out if d.rank == 0 else None


def _sharded_case(dist, case, arrays):
    """A case through ``sharded_step_fn``: the global numpy state on rank
    0, the local grid's halos and the local model's kernel gates of every
    rank, and, with particles, how many ranks own each initial particle
    (the owners' count summed over the ranks)."""
    d = _dist(case, dist)
    step, state = _sharded_run(d, case, arrays)
    dstep = step.dstep
    lm = dstep.lmodel
    gates = {k: getattr(lm, k) for k in (
        "fused_kernels", "fused_tracer", "fused_rk3", "fused_ab2",
        "fused_ab2_weno", "fused_ab2_science", "fused_ab2_weno_science")
        if hasattr(lm, k)}
    lg = dstep.local_grid
    # the array conditions as the local model holds them, cut to the block
    slabs = {f"{name}.{side}": tuple(bc.condition.shape)
             for name, fbcs in getattr(lm, "bcs", {}).items()
             for side in ("west", "east", "south", "north", "bottom", "top")
             for bc in (getattr(fbcs, side, None),)
             if hasattr(getattr(bc, "condition", None), "shape")}
    try:
        dstep.window(np.zeros((grid_of(ot, torch, case).N[0] + 1,
                               grid_of(ot, torch, case).N[1] + 1, 1)))
    except ValueError as err:
        odd = str(err)
    else:
        odd = None
    local = {"halo": tuple(lg.H), "block": tuple(lg.N), "gates": gates,
             "shape": tuple(lg.shape), "slabs": slabs, "odd_extent": odd}
    locals_ = [None] * d.world_size
    torch.distributed.all_gather_object(locals_, local)
    out = {"state": state, "locals": locals_, "device": str(dist.device)}
    particles = getattr(lm, "particles", None)
    if particles is not None:
        x, y, _ = particle_positions(case)
        own = particles.owns(torch.as_tensor(x), torch.as_tensor(y))
        out["owners"] = d.all_reduce(own.to(torch.int64)).numpy()
        out["owned"] = particles.owned
    return out if d.rank == 0 else None


#: the locations of the fold's fills, by name
FILL_LOCS = {"ccc": ("Center", "Center", "Center"),
             "fcc": ("Face", "Center", "Center"),
             "cfc": ("Center", "Face", "Center")}


def _fold_fill_case(dist, case, arrays):
    """The sharded step's halo fill (``dist_fill_halos``, the local
    model's own) of each global array in ``arrays`` at its location, each
    rank filling its window of it: every rank's filled block on rank 0,
    in rank order, with the fills' transfers by kind."""
    from oceananigans_torch.boundary_conditions import (
        regularize_field_boundary_conditions,
    )
    from oceananigans_torch.parallel import sharded_step_fn
    from oceananigans_torch.parallel.shard_step import dist_fill_halos
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    dstep = sharded_step_fn(ot.HydrostaticFreeSurfaceModel(grid=grid), d,
                            1.0).dstep
    lm, lg = dstep.lmodel, dstep.local_grid
    blocks = {}
    d.reset_counts()
    for name, a in arrays.items():
        loc = tuple(getattr(ot, c) for c in FILL_LOCS[name])
        block = dstep.window(torch.as_tensor(a))
        dist_fill_halos(block, lg, regularize_field_boundary_conditions(
            None, lg, loc), loc, None, None, lm.dist_halo, lm.dist_topo)
        blocks[name] = block.numpy()
    every = [None] * d.world_size
    torch.distributed.all_gather_object(every, blocks)
    return {"blocks": every, "counts": dict(d.counts)} \
        if d.rank == 0 else None


def _gspmd_refusal_case(dist, case, arrays):
    """What ``sharded_step_fn`` refuses: its error's type and message
    (None when it takes the case)."""
    from oceananigans_torch.parallel import sharded_step_fn
    d = _dist(case, dist)
    grid = grid_of(ot, torch, case)
    try:
        sharded_step_fn(model_of(ot, torch, case, grid), d, 1e-3)
    except (NotImplementedError, ValueError) as err:
        error, message = type(err).__name__, str(err)
    else:
        error = message = None
    return {"error": error, "message": message,
            "device": str(dist.device)} if d.rank == 0 else None


CASES = {"gspmd": _gspmd_case, "step": _step_case, "spy": _spy_case,
         "exchange": _exchange_case, "solver": _solver_case,
         "refusal": _refusal_case, "simulation": _simulation_case,
         "sharded": _sharded_case, "gspmd_refusal": _gspmd_refusal_case,
         "fold_fill": _fold_fill_case}


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
