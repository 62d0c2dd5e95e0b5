#!/usr/bin/env python3
"""Drive oceananigans_torch's main paths on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and fails without one; it has no CPU path. Phases,
each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``oceananigans_torch/csrc`` (nvcc,
   one process per source), with each kernel's registers and spills, the
   SASS of the float32 Poisson kernel held to tensor-core instructions
   (``cuobjdump -sass``: HGMMA) and that of the WENO-5 tiles to
   reciprocals without IEEE division (MUFU.RCP, no FCHK), as are the
   vector-invariant, WENO tracer and generic momentum tiles (every
   instantiation of the last), the Centered-2 tendency tile held to no
   FCHK, the shallow-water strip's instructions counted, and the dynamic
   shared memory of a block of the Centered-2 and generic tiles at the
   main path's plans (each equal to its Python mirror);
3. each of the thirteen kernels against its plain PyTorch version, in
   float32, at the main path's shapes and at a ragged shape (the WENO-5
   momentum AB2 kernel at both also on fields with exact zero rows, the
   WENO-5 science and tracer kernels at the ragged one also with one and
   with eight tracers), the
   Centered-2 science, shallow-water, WENO tracer and vector-invariant
   kernels also at a small size in float64 (the last two for every
   instantiated vector-invariant order pair, the mixed orders of
   :data:`VI_MIXED` and tracer order 3 to 11 at the ragged shapes, exact
   zero rows of u and v in every field; the last two also on
   ``LatitudeLongitudeGrid`` layouts: phase 14's, timed, a ragged one
   reaching both poles in float32 and float64, and the JAX package's
   lat-lon sector in float64), with
   times and the least time
   the card could take for the same work (the Poisson kernel also beside
   the ``torch.matmul`` chain with its 1/λ table made once; the Centered-2
   tendency kernel also on fields with exact zero rows at the main shape,
   timed there too, and in float64 at the ragged shape); the generic
   momentum kernel (kernel 14) at small ragged shapes for Centered(2..12),
   UpwindBiased(1..11), WENO(3..11) and two FluxFormAdvections, in float32
   and float64;
4. the main path: the 256³ Centered-2 quasi-AB2 model (``bench.py``'s
   default configuration) for 100 timed steps after a warm-up, on the
   kernel path and on the plain path, held against each other and against
   the divergence bound; plus a float64 16³ run of the kernel path held
   against the plain path on the CPU;
5. a few RK3 steps at 256³ (the tendency-only kernel);
6. a few AB2 steps with the fused pressure correction and the fused matmul
   Poisson solver, held against phase 4's path, and the solvers' times;
7. the WENO-5 and science paths at 256³ in ``bench.py``'s configurations:
   ``weno`` (two tracers, the WENO science kernel) and ``science``
   (Centered(2), f-plane, BuoyancyTracer, tracers b and c: the Centered-2
   science kernel) for 30 timed steps after a warm-up, and ``weno_mom``
   (the momentum AB2 kernel), the WENO science model (f-plane,
   BuoyancyTracer, tracers b and c), RK3 ``weno`` (the tendency and
   tracer kernels, 2 warm-up + 10 timed steps) and a WENO(7) model with
   tracers T and S (the any-order tracer kernel, plain momentum) for a few
   steps each, each on the kernel path and on the plain path; plus float64
   16³ science and WENO science runs of the kernel path held against the
   plain path on the CPU;
8. the shallow-water model in ``bench.py``'s ``sw8192`` configuration
   (8192², RK3, the stage kernel three times a step) on the kernel path
   and on the plain path, held against each other after 5 steps and timed
   over the next 20; a float64 run of the kernel path held against the
   plain path on the CPU; and a few kernel-path steps at 16384²
   (``sw16384``);
9. the hydrostatic model in ``bench.py``'s ``hydro_vi`` configuration
   (360 x 160 x 60, WENOVectorInvariant, WENO(7) tracers T and S,
   split-explicit free surface, AB2, the VI and tracer kernels once a step)
   on the kernel path and on the plain path for 2 + 20 steps, held against
   each other and timed, with the host's enqueue time and the device's idle
   share (``torch.profiler``'s device-busy time over 5 more steps, beside
   their wall time); the same model with ``WENOVectorInvariant(order=7)``
   for 1 + 3 steps on both paths (one launch of each kernel a step, held
   against the plain path); and a float64 (48, 16, 6) run of the kernel
   path held against the plain path on the CPU;
10. kernel 14 at full width: ``fused_momentum_tendency`` called once per
    scheme on ``bench.py``'s ``weno_mom`` grid (256³, (Bounded, Periodic,
    Periodic), float32, x halo of the scheme's reach) for WENO(5),
    Centered(4), UpwindBiased(5), WENO(9) and FluxFormAdvection(WENO(5),
    Centered(2), UpwindBiased(3)), each held against its plain version,
    WENO(5) also against kernel 7 (the same function), and timed against
    its plain version and its bound;
11. ``Simulation`` at full width: 100 constant-Δt steps of the 256³
    default model (kernel 1) through ``Simulation(stop_iteration=100)``,
    bit for bit against the bare loop of phase 4 from the same state, and
    timed against it; the same model with a ``TimeStepWizard(cfl=0.5)``
    every 10 iterations, a progress callback, a ``TimeInterval(0.002)``
    callback that must fire at 0, 0.002, 0.004 and 0.006 on the float32
    clock, and a ``stop_time`` whose alignment cuts the last Δt, held to
    finite fields and the divergence bound; and 20 steps of a 256³ UpwindBiased(5) model, which no kernel
    takes, on the plain path;
12. ``les``, the wind-mixing LES at 256³ (the JAX package's
    ``examples/wind_mixing_and_convection.py`` on a regular z: WENO(5),
    linear seawater buoyancy with a constant salinity, SmagorinskyLilly, a
    T surface flux and deep gradient, a u surface stress; float32, Δt = 1
    s): 2 + 10 steps on the kernel path (kernels 7 and 9 once a step, no
    fused AB2 kernel: the closure and the fluxes turn those off) and on the
    plain path, timed, with the host's enqueue time, the idle share, the
    kernel launches a step and the times of a step's phases (the closure's
    diffusivities and divergences, kernels 7 and 9, the Poisson solve, the
    fills); the divergence held to the float32 rounding bound of the
    projection; the same configuration in float64 for 3 steps on both
    paths, held to each other and to the divergence bound; and a float64
    16³ run of the kernel path on the card against the plain path on the
    CPU;
13. ``hydro_vi_closure``, ``hydro_vi`` with a horizontal Laplacian closure,
    a vertically implicit one, a callable zonal wind stress and an array T
    surface flux: 2 + 10 steps on each path (kernels 11 and 12/13 once a
    step), held against each other at phase 9's bounds and timed, with the
    host's enqueue time, the idle share and the launches of the implicit
    step's Thomas solves; and a float64 (48, 16, 6) run of the kernel path
    on the card against the plain path on the CPU;
14. ``hydro_vi_latlon``, ``hydro_vi`` on a 1° near-global
    ``LatitudeLongitudeGrid`` (360 x 160 x 60, 80°S to 80°N, 4 km deep)
    with ``HydrostaticSphericalCoriolis`` and linear seawater buoyancy:
    2 + 10 steps on each path (kernels 11 and 12/13 once a step through
    their lat-lon gates), held against each other at phase 9's bounds,
    timed, with the host's enqueue time and the idle share, and the
    volume held to the float32 rounding of η's updates; 3 float64 steps
    at full width, the volume held to 1e-12 of Σ|η|·Az; a float64 run at
    the (24, 16, 8) sector of the card against the CPU; 1 + 3 steps on
    each path with the mixed vector-invariant orders (9, 7, 5, 3) (the
    kernel's instantiation of runtime orders); and 3 float64 steps of a
    ``TripolarGrid(size=(360, 170, 60))`` model, which no kernel takes,
    its volume held to 1e-12 (the zipper fold on the card);
15. ``cs_w2``, Williamson 2 on a C192 ``ConformalCubedSphereGrid``
    (``CubedSphereShallowWaterModel``, float32, Δt = 40 s): 2 + 10 steps,
    timed, with the host's enqueue time, the idle share and the launches
    a step; held against a float64 card run of the same steps; the float64
    mass held to 1e-12 of itself; and a float64 C8 run of 10 steps on the
    card against the CPU to 1e-12 of each field's largest value;
16. ``cs_global``, ``bench.py``'s cubed-sphere ocean
    (``CubedSphereHydrostaticModel`` with continents, seawater buoyancy,
    convective adjustment, a split-explicit free surface of 20 substeps,
    wind and heat flux conditions, RK3, Δt = 300 s) at C48×16 and
    C192×32 in float32: Δt checked against the barotropic and advective
    limits, 2 + 10 steps timed and profiled as in phase 15, the volume
    held to the float32 rounding of η's substeps; 5 float64 steps at
    C48×16, the volume held to 1e-12 of the ocean's volume and the salt to
    1e-9; and a float64 C8×4 run on the card against the CPU to 1e-12.
    Neither cube phase may launch any of the port's kernels;
17. output (``output.py``): whether h5py is installed (``h5py: absent``
    on a line of its own where it is not; then ``HDF5Writer.write`` and
    ``NetCDFWriter.write`` must raise an ``ImportError`` naming it, and
    the writers below fetch their outputs to the host, cast on the card
    and copied, without writing files); 17a the 256³ default model
    (kernel 1, bench.py's Δt = 1e-4 s, :data:`OUTPUT_DT`) through
    ``Simulation(stop_iteration=100)`` with an ``HDF5Writer`` of u, w and
    the horizontal mean of u every 25 iterations, a ``NetCDFWriter`` of w
    every 50, an ``HDF5Writer`` of ``WindowedTimeAverage(u)`` on
    ``AveragedTimeInterval(50 Δt, window=10 Δt)`` and a ``Checkpointer``
    every 50, bitwise against the bare loop from the same state, picked
    up at iteration 50 and run to 100 bitwise (the clock too), the last u
    written equal to the final u, the averages within 10 float32 epsilons
    of max|u| of the float64 means of the bare loop's states, kernel 1
    launched 150 times, and the ms and MB of each write, of the
    checkpoint and of its restore beside phase 11's ms/step; 17b
    ``hydro_vi`` for 20 steps with a checkpoint at 10, picked up there
    bitwise, kernels 11 and 12/13 launched 30 times each, timed beside
    phase 9; 17c ``cs_w2`` at C192 with a ``NetCDFWriter`` of h and u
    every 10 of 20 steps (the last h equal to the final h) and
    ``cs_global`` at C48×16 for 10 steps with a checkpoint at 5, picked
    up bitwise, no port kernel launched; 17d ``EnsembleModel`` of the JAX
    package's diffusion column test at 1024 members of 256 levels in
    float64, three members held to their serial runs within 1e-12, timed
    against a serial member;
18. ``seamount``: the JAX package's ``examples/flow_over_seamount.py`` in
    3-D at 256 x 256 x 128 on an ``ImmersedBoundaryGrid`` with the bottom
    -2 + exp(-(x² + y²)/2) (WENO(5), BuoyancyTracer with N² = 1, u = 0.1,
    Δt = 0.02, AB2, float32): 2 + 10 steps timed and profiled, the
    conjugate gradient's iterations and host reads of its convergence
    flag each step (and one step's synchronizing calls counted by
    ``torch.cuda.set_sync_debug_mode``), the velocities exactly zero on
    every solid face, max|w| > 0, max|∇·u| over the fluid held to the
    bound the CG's reltol sets plus phase 12's rounding floor; a float64
    (32, 32, 16) run on the card against the CPU (10·reltol);
19. ``hydro_vi_bathy``: phase 14's ``hydro_vi_latlon`` with ``bench.py``'s
    continents as a ``GridFittedBottom`` (the plain path: the kernels
    refuse the grid), 2 + 10 steps timed and profiled, the float32 volume;
    ``hydro_vi`` over a Gaussian ridge in partial cells, 1 + 3 steps; 3
    float64 steps at full width, the volume to 1e-12 of Σ|η|·Az and T and
    S exactly 0 in solid cells; a float64 (24, 16, 8) sector on the card
    against the CPU to 1e-12;
20. ``les_stretched``: phase 12's 256³ LES on the stretched z of
    ``examples/wind_mixing_and_convection.py`` (the Fourier-tridiagonal
    projection, WENO(5)'s z tables, the plain path), 2 + 10 steps timed
    and profiled, the Poisson solve timed alone, max|∇·u| held to phase
    12's rounding floor at the smallest Δz; a float64 (32, 32, 24) run on
    the card against the CPU to 1e-12. Phases 18 to 20 print every port
    kernel's launch count, each of which must be 0.
21. ``langmuir``: ``examples/langmuir_turbulence.py`` at 256³ over its
    128 x 128 x 64 m box (WENO(5), a BuoyancyTracer, the example's wave as
    a ``UniformStokesDrift``, AMD, the u and b surface fluxes and the b
    bottom gradient), with a tracer P under ``SimpleBiogeochemistry``
    (growth (1/day)·exp(z/16 m), sinking 1e-4 m/s) and 2²⁰
    ``LagrangianParticles`` tracking b; Δt = 0.5 s, 2 + 10 steps on the
    kernel path (kernels 7 and 9 once a step; the fused AB2 kernels and
    the any-order tracer kernel never) and on the plain path, timed, with
    the device-busy time, the host syncs of a step (torch's sync debug
    mode) and every kernel's launch count; the float32 divergence held to
    phase 12's rounding floor, the paths to each other in float64 at full
    width (3 steps, 1e-10), a float64 16³ run with 4096 particles on the
    card against the CPU (1e-12, particles included). 21b: ``bench.py``'s
    ``weno`` cell with ``Relaxation`` sponges of u and T masked by a
    ``GaussianMask`` along x at the Bounded end, 1 + 3 steps a path
    (kernels 7 and 9 once a step, 6 and 8 never; the paths at phase 7's
    3e-5). 21c: the same cell with background fields of u and T, 1 + 3
    steps a path: as in the JAX package, whose model selects no kernel
    under background fields, every kernel launches 0 times and the two
    paths are equal bit for bit.
22. ``hydro_catke``: phase 14's ``hydro_vi_latlon`` with
    ``CATKEVerticalDiffusivity()`` (its TKE e a third tracer) and a zonal
    wind stress, 2 + 10 steps on each path (kernels 11, taking T, S and e,
    and 12/13 once a step; the Thomas solves plain), held to each other at
    phase 14's bounds, timed, with the host syncs of a step; and
    ``examples/baroclinic_adjustment.py`` at its own (60, 60, 10) with a
    destabilizing b surface flux (CATKE's convective lengths), float64, 3
    steps on the card against the CPU to 1e-12.
23. ``hydro_implicit``: phase 9's ``hydro_vi`` with
    ``ImplicitFreeSurface()`` ("fft": DCT-II in y, FFT in x through cuFFT,
    the eigenvalue denominator made in float64 and cast once), 2 + 10
    steps on each path (kernels 11 and 12/13 once a step), held to each
    other at phase 9's bounds, timed, with the device-busy time, idle
    share and host syncs a step; 23b the "matrix" and "cg" methods at
    JAX's defaults (maxiter 200, reltol 1e-9), 1 + 3 steps each with their
    CG iterations and host reads of the convergence flag a solve, η of the
    three methods held to each other at a bound derived from the
    operator's condition number; float64 (48, 16, 6) runs of each method
    on the card against the CPU to 1e-12 ("matrix" and "cg" at a fixed
    iteration count).
24. ``hydro_split_rk3``: phase 9's grid and momentum stepped by
    ``split_rk3`` (split-explicit, 30 substeps, no buoyancy) with a
    passive top-hat tracer c in a non-divergent zonal jet; 24a under
    ``WENO(7, bounds=(0, 1))``, 24b under ``BoundPreserving(WENO(5))``:
    2 + 10 steps on each path (kernel 12/13 three times a step, kernel 11
    never: the gates refuse the limiters), held to each other, c held to
    [0, 1] within its float32 rounding bound; float64 (48, 16, 6) runs on
    the card against the CPU to 1e-12, c within [−1e-12, 1 + 1e-12].
25. ``hydro_zstar``: phase 19's ``hydro_vi_bathy`` with ``ZStar()`` and a
    passive c = 1, 2 + 10 steps (no kernel: the tendencies are on the
    σ-scaled grid, as in JAX), timed and profiled, with max|c − 1| and the
    drift of ∫σ c dV; 3 float64 steps at full width with the explicit free
    surface, both held to 1e-12; a float64 (24, 16, 8) sector on the card
    against the CPU to 1e-12.
26. ``cs_global_implicit``: phase 16's ``cs_global`` at C48×16, 26a with
    the cube's implicit free surface (one CG across the panels, RK3) and
    26b with ``ZStar()`` under quasi-AB2, 2 + 10 steps each, timed and
    profiled (26a with the CG iterations of every step), the float32
    volume held to its rounding bound, 26a's float64 volume to 1e-12 of
    the ocean's; float64 C8×4 runs of both on the card against the CPU to
    1e-12 (CG at a fixed iteration count). Phases 25 and 26 launch no port
    kernel.
27. the distributed layer (``oceananigans_torch/parallel``): ranks
    started by ``parallel.launch`` (spawn; the kernel library built once,
    in phase 2), which gloo collectives take CUDA tensors (each tried in a
    group of its own), then for each part a serial run (rank 0) and a
    sharded run (every rank) from the same state, 2 warm-up + 10 timed
    steps, CUDA events; the ranks share one card, so the times are no
    scaling figure. 27a: ``weno`` at 256³ under RK3, ``Partition(4, 1)``,
    4 gloo ranks on ``cuda:0`` with the pencil FFT solve (kernels 7 and 9
    three times a step on every rank, held against their plain versions at
    the block shape (70, 256, 256)); the Centered(2) RK3 model at 64³
    (kernel 2 on every rank); ``weno`` at 64³ in float64 held to 1e-12;
    the world-size-1 NCCL step at 256³. 27b: ``hydro_vi`` at 360 × 160 ×
    60 under ``Partition(2, 2)``, 4 ranks (kernels 11 and 12/13 on every
    rank, at the block shape (192, 92, 68)), with the 2-D (η and
    transport) exchanges a step. 27c, float64: ``cs_w2`` C192 under
    ``CubedSphereDistributedSW(R=1, panels=6)``, 6 ranks, and
    ``cs_global`` C48×16 under ``CubedSphereDistributedHydrostatic(R=2,
    panels=2)``, 8 ranks, held to the serial cube at 1e-12 with their
    mass, volume and salt; no port kernel launches on the cube. The
    sharded runs are held to the serial ones at phase 7's (27a) and phase
    9's (27b) bounds. A rank's failure fails the run.
28. ``sharded_step_fn`` (the counterpart of the JAX package's GSPMD step:
    the global state scattered from rank 0, every block stepped, gathered
    back) at full width, 4 gloo ranks on ``cuda:0`` in one spawn; each
    part 2 warm-up + 10 timed steps serial (rank 0) and sharded (every
    rank) from the same state, CUDA events, with the transfers a step and
    each rank's kernel launches, its kernels against their plain versions
    at rank 0's block shape, and a float64 run at a small size held to
    the serial one at 1e-12. 28a: phase 13's ``hydro_vi_closure`` (a
    callable u stress, an array T flux cut to each block) at 360 × 160 ×
    60 over ``Partition(2, 2)`` (kernels 11 and 12/13 once a rank a step);
    28b: phase 21's ``langmuir`` at 256³ with 2²⁰ particles tracking b
    (replicated, each rank interpolating the ones in its block) over (2,
    2) (kernels 7 and 9 once a rank a step), the particles held too; 28c:
    ``examples/multi_chip_scaling.py``'s model (WENO(5), BuoyancyTracer,
    FPlane(1e-4), halo 3, RK3) at (250, 256, 256) with sponges of u and b
    masked in x, over (4, 1): blocks of 63, 63, 62 and 62 cells and
    uneven pencils (kernels 7 and 9 three times a rank a step); and
    ``bench.py``'s ``default`` at 256³ over (1, 4), a halo-free periodic y
    split through a local halo (kernel 2 once a rank a step); 28d:
    ``sw8192`` over (4, 1), blocks of (2048, 8192) (kernel 10 three times
    a rank a step), 12 steps from the initial state; 28e: phase 22's
    ``hydro_catke`` (CATKE, its callable u wind stress) under ``ZStar()``
    at 360 × 160 × 60 over (2, 2), no kernel (the σ-scaled grid takes
    none, as in the JAX package), with the all-reduces a step of CATKE's
    surface cell height (every block takes the global halo corner's σ·Δz,
    as the serial step does) on a line of their own, and its float64 run
    at (24, 12, 4). Held sharded against serial at the serial phases'
    kernel-against-plain bounds (phase 13's, phase 7's 3e-5, phase 8's;
    phase 9's for 28e).
29. ``sharded_step_fn`` where a rank needs cells beyond its neighbour, 4
    gloo ranks on ``cuda:0`` in one spawn, as phase 28. 29a: phase 14's
    tripolar ocean (``TripolarGrid`` 360 × 170 × 60, halo (6, 6, 4),
    ``WENOVectorInvariant``, WENO(7) T and S, split-explicit with 30
    substeps) in float32 at Δt = 20 s (``FOLD_DT``: the barotropic
    substeps' Courant number at the cells beside the north poles, printed,
    stays below 1) over ``Partition(4, 1)`` (every rank folds against
    another) and ``(2, 2)`` (the top row folds), 2 + 10 steps serial and
    sharded, the fold's transfers a step on a line of their own and
    whether sharded equals serial bit for bit, held at phase 14's bounds
    with no kernel launched (as in the JAX package); one float64 step at
    full width and a float64 (48, 20, 6) run, each at 1e-12. 29b: ``examples/multi_chip_scaling.py``'s
    model at (10, 256, 256) over (4, 1), x blocks of 3, 3, 2 and 2 cells
    under a halo of 3 (kernels 7 and 9 three times a rank a step, held
    against their plain versions at every rank's block shape), held at
    phase 7's 3e-5; a float64 (10, 16, 16) run at 1e-12.
30. ``EnsembleModel`` on the card, every kernel a custom operator that
    ``torch.func.vmap`` batches one launch per member
    (``oceananigans_torch/ops/library.py``), and the conjugate gradient
    batched over members. 30a: phases 4 to 9's models at full width,
    ``default`` (quasi-AB2, kernel 1, and RK3, kernel 2), ``science``
    (kernel 5), ``weno`` (quasi-AB2, kernel 8, and RK3, kernels 7 and 9),
    ``weno_mom`` (kernel 6) and ``hydro_vi`` (kernels 11 and 12/13) with 4
    members and ``sw8192`` (kernel 10) with 2, from states whose velocities
    (transports) are scaled by seeded amplitudes: 3 batched steps (the last
    two timed) and each member's serial run of the same steps, each run's
    launches (each row's count a member-step times members times steps),
    each member held to its serial run at 1e-5 of each field's largest
    value, the batched ms against the members' serial ms. 30b: phase 6's
    opt-in path (kernels 1, 3 and 4) with 2 members, and kernel 14 under
    ``torch.func.vmap`` over 2 members at phase 10's WENO(5) shape, bit for
    bit against two direct calls. 30c: ``hydro_implicit`` with
    ``solver_method="cg"`` at JAX's defaults with 4 members (the members
    held at phase 23's bounds) and phase 18's ``seamount`` at 256 x 256 x
    128 with 2 (at phase 18's 10·reltol), each member's CG iterations and
    the host reads of the flag printed each step. 30d: a gradient through
    one AB2 step of the 256³ default model raises a ``RuntimeError`` on
    the kernel path (no autograd formula, as ``jax.grad`` through a
    ``pallas_call`` raises) and is finite on the plain path. Every row
    launches in phase 30; its launches are added to the kernels line.

Each kernel's launch count is zeroed just before the run of the main path
that goes through it (phase 4's kernel path for the Centered-2 AB2 kernel,
phase 5's RK3 run for the Centered-2 tendency kernel, phase 6's opt-in
model for the pressure and Poisson kernels, phase 7's ``weno``,
``science``, ``weno_mom`` and RK3 runs for the WENO and science kernels
(its WENO science and WENO(7) runs are counted and checked too),
phase 8's ``sw8192`` run for the stage kernel, phase 9's ``hydro_vi`` run
for the tracer and vector-invariant kernels, phase 10's call of each
scheme for the generic kernel) and read just after it; each must equal the
launches that run makes. Phases 12 to 27 zero and check the counts of
their own runs and print them on lines of their own; phase 27's per-rank
launches of kernels 2, 7, 9, 11 and 12/13, phase 28's of kernels 2, 7,
9, 10, 11 and 12/13, phase 29's of kernels 7 and 9 and phase 30's of
every kernel are added to theirs. The line before
the last is the JSON summary of
the fourteen TPU kernels, with those counts (the one vector-invariant
kernel stands for both TPU kernels it replaces; kernel 14's times are its
WENO(5) ones); the last line is the device record.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time
from pathlib import Path


_STARTED = []


def log(*args):
    """Print a line with the seconds since the first line."""
    if not _STARTED:
        _STARTED.append(time.perf_counter())
    print(f"[{time.perf_counter() - _STARTED[0]:7.1f} s]", *args,
          flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_times(torch, plain, kernel, reps):
    """Times of ``plain`` and ``kernel`` taken in turns (plain, kernel,
    kernel, plain) after one warm-up call each; returns the two means."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps)
    k2 = time_ms(torch, kernel, reps)
    p2 = time_ms(torch, plain, reps)
    return (p1 + p2) / 2, (k1 + k2) / 2


#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
#: memory rate in bytes/s, float32 rate outside the tensor cores and dense
#: TF32 rate of the tensor cores in FLOP/s (a fused multiply-add counts two)
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
#: the float32 Poisson middle stage forms each product from three TF32
#: products on the tensor cores (hi·hi + hi·lo + lo·hi)
TF32X3_PASSES = 3

#: operations per output point, counted from the CUDA sources (an add,
#: multiply, divide, min, abs or select counts one, a fused multiply-add
#: two), for the work each function must do at least once:
#: Centered-2 tendency (``centered2.cu``, 34 per component), pressure
#: correction (4 per component)
C2_TENDENCY_OPS = 102
PRESSURE_OPS = 12
#: f-plane Coriolis on Gu and Gv, and the buoyancy average on Gw
SCIENCE_OPS = 14 + 3
#: q + a·G + b·G⁻ for one field
AB2_OPS = 4
#: the Centered-2 advection of one tracer (``centered2.cu``): six face
#: fluxes of 3 each, three differences with their scales and sums
C2_TRACER_OPS = 27
#: a shallow-water stage point (``shallow_water.cu``), the least work: two
#: velocities of 3 (the face depth's sum and half, the division; the strip
#: computes each once a point), eight momentum fluxes of 5, the two
#: momentum tendencies' 12 each with the g·h·∂h term, the mass tendency's
#: 6, and three updates
SW_STAGE_OPS = 2 * 3 + 8 * 5 + 2 * 12 + 6 + 3 * AB2_OPS
#: one side of a WENO reconstruction, counted from ``csrc/weno.h``: the
#: smoothness indicators, the WENO-Z weights and their combination with the
#: sub-stencil polynomials. WENO-5 (hand forms): 43 + 43; WENO-7
#: (Balsara-Shu forms): 92 + 65; WENO-9 with the two VelocityStencil
#: smoothness fields (generated forms): 2 x 170 + 5 + 91
WENO5_SIDE_OPS = 86
WENO7_SIDE_OPS = 157
WENO9_VS_SIDE_OPS = 436
#: a WENO-5 momentum point, the least work, counted as
#: ``generic_point_ops(WENO(5))`` counts it (kernels 7 and 14 compute the
#: same function): per component three faces of one side each (the
#: advecting velocity 4, the side, the select, the product with U), then
#: three differences, two sums, the scale and the sign
WENO_MOMENTUM_OPS = 3 * (3 * (4 + WENO5_SIDE_OPS + 1 + 1) + 7)
#: a WENO-5 tracer point: three faces of one side each (the side, the
#: select, the product with the face velocity), three differences, three
#: scales, two sums and the sign
WENO_TRACER_OPS = 3 * (WENO5_SIDE_OPS + 1 + 1) + 9
#: a WENO-7 tracer point (``weno_tracer_march``, ``csrc/vi_tile.h``), the
#: least work: three faces of one side each with the transport A·U, the
#: product and the select, then three differences, two sums, the division
#: by V and the sign (:func:`tracer_point_ops` for any order)
TRACER7_POINT_OPS = 3 * (WENO7_SIDE_OPS + 3) + 7
#: a vector-invariant point (``vi_march``, ``csrc/vi_tile.h``) of
#: ``WENOVectorInvariant()``, the least work: for Gu and Gv each the
#: WENO-9 ζ flux (one side, the select, the product) and v̂ or û (11); ζ
#: and its two smoothness values once (12); the Bernoulli head (the
#: δ(u²/2) value and its smoothness 5, a WENO-5 side, the select 2, the
#: cross term 6, the division 2); the divergence flux (dxU, dyV, their sum
#: 5, a side, the select, the cross term 3, the product 2); the vertical
#: flux (the advecting w 4, a side, the select and product 2, the
#: difference and division 3); the two sums (:func:`vi_point_ops` for any
#: order pair)
VI_POINT_OPS = (2 * (WENO9_VS_SIDE_OPS + 2 + 11) + 12
                + 2 * (5 + WENO5_SIDE_OPS + 2 + 6 + 2)
                + 2 * (5 + WENO5_SIDE_OPS + 1 + 3 + 2)
                + 2 * (4 + WENO5_SIDE_OPS + 2 + 3) + 4)
#: one side of a WENO reconstruction of order K = 2B - 1, counted from
#: ``csrc/weno.h``: the smoothness indicators (hand forms for orders 3 and
#: 5, the Balsara-Shu integers for 7, the generated quadratic forms with
#: every term nonzero for 9 and 11) and the WENO-Z combination, 2B² + 8B + 1
WENO_BETA_OPS = {3: 10, 5: 43, 7: 92, 9: 170, 11: 282}


def weno_side_ops(order):
    B = (order + 1) // 2
    return WENO_BETA_OPS[order] + 2 * B * B + 8 * B + 1


def tracer_point_ops(order):
    """A WENO tracer point of ``order`` as :data:`TRACER7_POINT_OPS`
    counts one of order 7."""
    return 3 * (weno_side_ops(order) + 3) + 7


def vi_point_ops(vorticity_order, *rest_orders, velocity=True):
    """A vector-invariant point as :data:`VI_POINT_OPS` counts the default
    one: the ζ side of ``vorticity_order`` with the indicators of its two
    smoothness fields and their sum (VelocityStencil) or of ζ itself (ζ
    alone then, 8 operations); ``rest_orders``, one order for the kinetic
    energy gradient, divergence and vertical schemes or one each, the
    sides of those three."""
    ke, div, vert = (rest_orders * 3 if len(rest_orders) == 1
                     else rest_orders)
    bv = (vorticity_order + 1) // 2
    zeta = weno_side_ops(vorticity_order)
    if velocity:
        zeta += WENO_BETA_OPS[vorticity_order] + bv
    return (2 * (zeta + 2 + 11) + (12 if velocity else 8)
            + 2 * (5 + weno_side_ops(ke) + 2 + 6 + 2)
            + 2 * (5 + weno_side_ops(div) + 1 + 3 + 2)
            + 2 * (4 + weno_side_ops(vert) + 2 + 3) + 4)


def vi_orders(vi):
    """The (vorticity, kinetic energy gradient, divergence, vertical) WENO
    orders of a vector-invariant scheme."""
    from oceananigans_torch.ops.cuda_vi import schemes
    return tuple(s.order for s in schemes(vi))


#: mixed (vorticity, kinetic energy gradient, divergence, vertical) WENO
#: orders that no instantiated pair covers: the kernel's instantiation of
#: runtime orders; the first is phase 14's mixed-order run
VI_MIXED = ((9, 7, 5, 3), (9, 5, 5, 3), (7, 3, 3, 3), (5, 11, 7, 9),
            (3, 5, 7, 11), (11, 3, 9, 5))


def mixed_vi(ot, orders, stencil="velocity"):
    """A ``VectorInvariant`` of the four WENO ``orders`` whose vertical
    scheme has an epsilon of its own (1e-6; the others 1e-8)."""
    kv, kk, kd, kz = orders
    return ot.VectorInvariant(
        vorticity_scheme=ot.WENO(kv), vorticity_stencil=stencil,
        vertical_scheme=ot.WENO(kz, epsilon=1e-6),
        divergence_scheme=ot.WENO(kd),
        kinetic_energy_gradient_scheme=ot.WENO(kk))


def face_value_ops(scheme):
    """Operations of one face value of ``scheme`` in
    ``csrc/generic_momentum.cu``: a linear stencil of K taps is a product
    and K - 1 fused multiply-adds; a biased scheme computes the one side
    its velocity's sign selects, plus the select."""
    kind, order = type(scheme).__name__, scheme.order
    if kind == "Centered":
        return 2 * order - 1
    if kind == "UpwindBiased":
        return 2 * order - 1 + 1
    return weno_side_ops(order) + 1


def generic_point_ops(scheme):
    """Operations of one output point of ``fused_momentum_tendency``, the
    least work: for each of the three components and three axes one face
    (the advecting velocity's two products, sum and half, the face value,
    its product with the velocity); per component the three differences,
    two sums, the division by V and the sign."""
    from oceananigans_torch.ops.cuda_generic import axis_schemes
    faces = sum(4 + face_value_ops(s) + 1 for s in axis_schemes(scheme))
    return 3 * (faces + 3 + 2 + 2)


def sass_counts(sass, kernels, ops):
    """``{kernel: {op: n}}``: the SASS lines of each function whose
    (mangled) name contains ``kernel`` that contain ``op``, from
    ``cuobjdump -sass``. The anonymous namespace of a source file, whose
    mangled name carries the file's name, is left out of the match."""
    import re
    out = {k: dict.fromkeys(ops, 0) for k in kernels}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "",
                          line.split("Function :", 1)[1])
            cur = next((k for k in kernels if k in name), None)
        elif cur is not None:
            for op in ops:
                out[cur][op] += op in line
    return out


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """The least time the card could take, in ms, and what sets it: the
    bytes the function must move (each input read once, each output
    written once) over the memory rate, or its operations over the peak
    rate of their type (float32 FFMA unless given), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases 12 and 13: the closure paths
# ---------------------------------------------------------------------------

#: phase 12: the wind-mixing LES (the JAX package's
#: ``examples/wind_mixing_and_convection.py`` with a regular z): surface
#: cooling of 200 W m⁻² as a temperature flux, a wind stress, a stratified
#: deep gradient; Δt = 1 s
LES_QT = 200.0 / (1026.0 * 3991.0)
LES_TAU = 6.2e-5
LES_DT = 1.0
LES_WARM, LES_STEPS = 2, 10
#: the float64 run at 256³ that holds the paths to each other, and its
#: bound (its rounding floor is ~1e-12 of the fields)
LES_F64_STEPS, LES_F64_RTOL = 3, 1e-10
#: phase 13: ``hydro_vi`` with closures; Δt = 60 s
HYDRO_CLOSURE_WARM, HYDRO_CLOSURE_STEPS = 2, 10
#: phase 14: ``hydro_vi_latlon``, the 1° near-global lat-lon ocean; Δt =
#: 60 s. Its volume is held to 1e-12 of Σ|η|·Az in float64, as the JAX
#: package's lat-lon test holds it; in float32 to the rounding of η's
#: updates, one float32 epsilon a barotropic substep
LATLON_WARM, LATLON_STEPS = 2, 10
VOLUME_RTOL = 1e-12


def les_model(torch, ot, fused, N=256, dtype=None, device="cuda", Nz=None,
              z=(-32.0, 0.0)):
    """The wind-mixing LES at N x N x Nz (Nz = N by default) on a 64 x 64 x
    32 m box: WENO(5), linear seawater buoyancy with a constant salinity,
    SmagorinskyLilly, the T surface flux and deep gradient and the u
    surface stress, quasi-AB2; ``z`` is the vertical coordinate (regular
    by default; phase 20 gives the example's stretched faces)."""
    grid = ot.RectilinearGrid(
        size=(N, N, Nz or N), x=(0.0, 64.0), y=(0.0, 64.0), z=z,
        topology=(ot.Periodic, ot.Periodic, ot.Bounded), halo=(3, 3, 3),
        dtype=dtype or torch.float32, device=device)
    return ot.NonhydrostaticModel(
        grid=grid, advection=ot.WENO(5),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState(
                thermal_expansion=2e-4), constant_salinity=35.0),
        closure=ot.SmagorinskyLilly(),
        boundary_conditions={
            "T": ot.FieldBoundaryConditions(top=ot.FluxBC(LES_QT),
                                            bottom=ot.GradientBC(0.01)),
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(LES_TAU))},
        timestepper="QuasiAdamsBashforth2", fused_kernels=fused)


def les_state(model):
    """T = 20 + 0.01 z and u = 1e-4 N(0, 1) from ``default_rng(0)``,
    projected."""
    import numpy as np
    u = 1e-4 * np.random.default_rng(0).standard_normal(model.grid.N)
    return model.initial_state(T=lambda x, y, z: 20.0 + 0.01 * z, u=u)


def hydro_closure_model(torch, ot, fused, dtype=None, device="cuda",
                        size=(360, 160, 60)):
    """``bench.py``'s ``hydro_vi`` with a horizontal Laplacian closure, an
    implicit vertical one, a zonal wind stress on u's top given as a
    callable of (x, y, t), and a T surface flux given as an array over the
    halo-extended top slab (zero halo, 1e-5 N(0, 1) from
    ``default_rng(0)`` inside)."""
    import numpy as np
    grid = ot.RectilinearGrid(size=size, extent=(4e7, 2e7, 4e3),
                              topology=(ot.Periodic, ot.Bounded, ot.Bounded),
                              halo=(6, 6, 4), dtype=dtype or torch.float32,
                              device=device)
    flux = np.zeros(tuple(grid.shape[:2]) + (1,))
    flux[6:-6, 6:-6, 0] = 1e-5 * np.random.default_rng(0).standard_normal(
        size[:2])
    return ot.HydrostaticFreeSurfaceModel(
        grid=grid, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(7), tracers=("T", "S"),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30),
        closure=(ot.HorizontalScalarDiffusivity(nu=1e4, kappa=1e3),
                 ot.VerticalScalarDiffusivity(
                     nu=1e-3, kappa=1e-5,
                     time_discretization=(
                         ot.VerticallyImplicitTimeDiscretization))),
        boundary_conditions={
            "u": ot.FieldBoundaryConditions(top=ot.FluxBC(
                lambda x, y, t: -1e-4 * torch.cos(math.pi * y / 2e7))),
            "T": ot.FieldBoundaryConditions(top=ot.FluxBC(flux))},
        fused_kernels=fused)


#: steps of each torch.profiler window: the host spends ~5 s on each
#: profiled step of a host-paced model (its trace's events), so the windows
#: stay short and the whole script well inside its time limit
PROFILE_STEPS = 1


def device_profile(torch, fn, n=PROFILE_STEPS):
    """Run ``fn`` ``n`` times under ``torch.profiler``: the device-busy ms
    and kernel launches per call, and the wall ms per call by CUDA
    events."""
    from torch.profiler import ProfilerActivity, profile

    from oceananigans_torch.profile_step import _kernel_time_us
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
    busy_us, rows = _kernel_time_us(prof)
    return (busy_us / 1e3 / n, sum(r[1] for r in rows) / n,
            e0.elapsed_time(e1) / n)


def timed_steps(torch, model, state, dt, n):
    """``n`` steps: (state, ms/step by CUDA events, host enqueue ms/step)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        state = model.step(state, dt, assume_filled=True)
    t1 = time.perf_counter()
    e1.record()
    e1.synchronize()
    return state, e0.elapsed_time(e1) / n, (t1 - t0) * 1e3 / n


def group_rel(pairs, scale=0.0):
    """max|a − b| over ``pairs`` relative to the larger of the largest |b|
    and ``scale``."""
    diff = max(float((a - b.to(a.device)).abs().max()) for a, b in pairs)
    return diff / max(max(float(b.abs().max()) for _, b in pairs), scale)


def balance_scale(grid, state, dt):
    """Δt·max|∂z p| over the interior: the velocity that the projection's
    pressure gradient removes against the buoyancy each step. In a
    stratified ocean at rest the velocities are its small residual, and
    their rounding (the pressure's float32 rounding in the FFT solve) is
    relative to it."""
    from oceananigans_torch.ops.operators import ddz_f
    gz = grid.interior(ddz_f(grid, state.pressure))[:, :, 1:]
    return dt * float(gz.abs().max())


def les_compare(grid, sk, sp):
    """Kernel-path state ``sk`` against plain-path state ``sp``: the
    velocities relative to max(max|u|, Δt·max|∂z p|), T relative to max|T|,
    and the kernel path's max|∇·u|."""
    from oceananigans_torch.ops.operators import divergence_ccc
    g = grid
    umax = max(float(g.interior(q).abs().max()) for q in (sk.u, sk.v, sk.w))
    return {**les_compare_fields(g, sk, sp, LES_DT, ("T",)),
            "div": float(g.interior(divergence_ccc(g, sk.u, sk.v,
                                                    sk.w)).abs().max()),
            "umax": umax, "ub": balance_scale(g, sp, LES_DT)}


def les_phase(torch, ot, wrappers, card):
    """Phase 12: the wind-mixing LES at 256³ in float32 on the kernel path
    (kernels 7 and 9, once a step each) and on the plain path: step and
    phase times, the idle share, the divergence against its rounding bound
    and the paths' difference; the same in float64 for a few steps, the
    paths held to each other; a float64 16³ run of the kernel path on the
    card against the plain path on the CPU."""
    from oceananigans_torch import closures
    from oceananigans_torch.ops import cuda_weno as cw
    from oceananigans_torch.ops.operators import divergence_ccc
    les_kernels = {"weno5_momentum_tendency": 1, "weno5_tracer_tendencies": 1}
    finals, out = {}, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = les_model(torch, ot, fused)
        require((model.fused_kernels == "weno5") == (path == "kernel")
                and not (model.fused_ab2_weno
                         or model.fused_ab2_weno_science),
                f"les {path} path selects fused_kernels="
                f"{model.fused_kernels}, no fused AB2 kernel")
        state = les_state(model)
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for _ in range(LES_WARM):
            state = model.step(state, LES_DT, assume_filled=True)
        state, ms, enqueue = timed_steps(torch, model, state, LES_DT,
                                         LES_STEPS)
        total = LES_WARM + LES_STEPS
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        want = ({k: n * total for k, n in les_kernels.items()}
                if path == "kernel" else {})
        require(counts == want, f"les {path} path launches {counts}, "
                f"expected {want}")
        g = model.grid
        require(all(bool(torch.isfinite(q).all())
                    for q in (state.u, state.v, state.w, state.pressure,
                              state.tracers["T"])),
                f"les {path} path: finite fields")
        out[path] = {"ms": ms, "enqueue": enqueue, "launches": counts}
        log(f"[12] les {path} path: {ms:.3f} ms/step at 256^3 float32 "
            f"(steps {LES_WARM + 1} to {total} of AB2, CUDA events); host "
            f"enqueue {enqueue:.3f} ms/step; launches in {total} steps "
            f"{counts}; max|u| {float(g.interior(state.u).abs().max()):.4e}"
            f", max|w| {float(g.interior(state.w).abs().max()):.4e}, T in "
            f"[{float(g.interior(state.tracers['T']).min()):.6f}, "
            f"{float(g.interior(state.tracers['T']).max()):.6f}]")
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, LES_DT, assume_filled=True), PROFILE_STEPS)
        require(busy > 0, f"les {path} path: the profiler saw device time")
        out[path].update(busy=busy, per_step_launches=n_launch)
        log(f"[12] les {path} path under torch.profiler, "
            f"{PROFILE_STEPS} steps: "
            f"device-busy {busy:.3f} ms/step in a wall of {wall:.3f} ms/step,"
            f" idle share {1 - busy / wall:.3f}; against the unprofiled "
            f"{ms:.3f} ms/step, idle share {1 - busy / ms:.3f}; "
            f"{n_launch:.0f} kernel launches a step")
        if path == "kernel":
            # the phases of a step, each timed alone on the final state
            st = state
            d = model.compute_diffusivities(st)
            rhs = g.interior(divergence_ccc(g, st.u, st.v, st.w))
            phases = {
                "diffusivities": lambda: model.compute_diffusivities(st),
                "momentum divergences": lambda: (
                    closures.momentum_flux_divergences(
                        model.closure, g, st.u, st.v, st.w, st.tracers, d,
                        include_implicit=False)),
                "tracer divergence": lambda: closures.tracer_flux_divergence(
                    model.closure, g, "T", st.tracers["T"], st.tracers, d,
                    include_implicit=False),
                "kernel 7": lambda: cw.weno5_momentum_tendency(
                    g, st.u, st.v, st.w),
                "kernel 9": lambda: cw.weno5_tracer_tendencies(
                    g, st.u, st.v, st.w, st.tracers),
                "Poisson solve": lambda: model.pressure_solver.solve(rhs),
                "fills": lambda: model.fill_state_halos(st)}
            out["phases"] = {}
            for name, fn in phases.items():
                fn()
                torch.cuda.synchronize()
                out["phases"][name] = time_ms(torch, fn, 5)
            log(f"[12] les kernel path, phases of a step on {card} (CUDA "
                "events, 5 calls each): " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in out["phases"].items()))
            del d, rhs, phases, st
        finals[path] = (g, state)
        del model
        torch.cuda.empty_cache()
    (g, sk), (_, sp) = finals["kernel"], finals["plain"]
    rel = les_compare(g, sk, sp)
    dz = g.spacing(2)
    pmax = float(g.interior(sp.pressure).abs().max())
    # the projection leaves the divergence of the float32 rounding of the
    # pressure: about eps·max|p| a point, its discrete Laplacian over Δz²,
    # times the FFT's log2(N³) growth of rounding
    eps32 = torch.finfo(torch.float32).eps
    div_bound = math.log2(g.N[0] * g.N[1] * g.N[2]) * eps32 * LES_DT \
        * pmax / dz ** 2
    out["rel"], out["div"], out["div_bound"] = rel, rel["div"], div_bound
    log(f"[12] les float32: kernel vs plain path after "
        f"{LES_WARM + LES_STEPS} steps: velocities {rel['velocities']:.3e} "
        f"of max(max|u|, Δt max|∂z p|) = max({rel['umax']:.4e}, "
        f"{rel['ub']:.4e}), T {rel['T']:.3e} of max|T| (not held: each "
        f"path's max|div| {rel['div']:.3e}, the float32 rounding of the "
        f"hydrostatic pressure max|p| = {pmax:.4f}, and the flux-form "
        f"advection of T = 20 by it, T·∇·u·Δt, set a noise floor that any "
        f"difference in the bits decorrelates); max|div| held to "
        f"log2(N³)·eps32·Δt·max|p|/Δz² = {div_bound:.3e}")
    require(rel["div"] <= div_bound,
            f"les max|div| {rel['div']:.3e} <= {div_bound:.3e}")
    del finals, sk, sp
    torch.cuda.empty_cache()

    # float64 at full width: the kernel path against the plain path, where
    # the rounding floor lies ~1e-12 below the fields (the float32 one does
    # not let the paths be held to each other)
    f64 = {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        m = les_model(torch, ot, fused, dtype=torch.float64)
        s = les_state(m)
        for _ in range(LES_F64_STEPS):
            s = m.step(s, LES_DT)
        f64[path], g = s, m.grid
        del m
    rel = les_compare(g, f64["kernel"], f64["plain"])
    dx = g.spacing(0)
    div_bound = 1e-5 * max(rel["umax"], rel["ub"]) / dx
    out["rel64"] = rel
    log(f"[12] les float64 256^3, {LES_F64_STEPS} AB2 steps: kernel vs "
        f"plain path: velocities {rel['velocities']:.3e} of max(max|u|, Δt "
        f"max|∂z p|), T {rel['T']:.3e} of max|T| (tolerance "
        f"{LES_F64_RTOL:g}); max|div| {rel['div']:.3e} (bound 1e-5 "
        f"max(max|u|, Δt max|∂z p|)/Δx = {div_bound:.3e})")
    require(rel["velocities"] <= LES_F64_RTOL and rel["T"] <= LES_F64_RTOL,
            f"les float64 kernel vs plain path {rel}")
    require(rel["div"] <= div_bound,
            f"les float64 max|div| {rel['div']:.3e} <= {div_bound:.3e}")
    del f64
    torch.cuda.empty_cache()

    # float64 16³: the kernel path on the card against the plain path on
    # the CPU, which the CPU tests hold against the JAX package
    f64 = {}
    for device, fused in (("cuda", True), ("cpu", False)):
        m = les_model(torch, ot, fused, N=16, dtype=torch.float64,
                      device=device)
        require((m.fused_kernels == "weno5") == (device == "cuda"),
                "float64 les routes")
        s = les_state(m)
        for _ in range(5):
            s = m.step(s, LES_DT)
        f64[device] = (m.grid, s)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    ub = balance_scale(gp, sp, LES_DT)
    vel64 = group_rel([(gk.interior(a).cpu(), gp.interior(b)) for a, b in (
        (sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w))], ub)
    trc64 = group_rel([(gk.interior(sk.tracers["T"]).cpu(),
                        gp.interior(sp.tracers["T"]))])
    abs64 = max(float((gk.interior(a).cpu() - gp.interior(b)).abs().max())
                for a, b in ((sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w),
                             (sk.tracers["T"], sp.tracers["T"])))
    log(f"[12] float64 16^3 les, 5 AB2 steps: kernel path on the card vs "
        f"plain path on the CPU: velocities {vel64:.3e} of max(max|u|, Δt "
        f"max|∂z p|), T {trc64:.3e} of max|T| (tolerance 1e-12); largest "
        f"absolute difference {abs64:.3e}")
    require(vel64 <= 1e-12 and trc64 <= 1e-12,
            f"float64 16^3 les card vs CPU {vel64:.3e}, {trc64:.3e}")
    return out


def hydro_closure_phase(torch, ot, wrappers, card, rtol):
    """Phase 13: ``hydro_vi`` with closures and wind stress at 360 x 160 x
    60 on the kernel path (kernels 11 and 12/13, once a step each) and on
    the plain path, held against each other; the launches of the Thomas
    solve; a float64 (48, 16, 6) run of the kernel path on the card against
    the plain path on the CPU."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_generic_state, hydro_initial_state,
    )
    hydro_kernels = {"weno_tracer_tendencies": 1, "vi_momentum_tendency": 1}
    finals, out = {}, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = hydro_closure_model(torch, ot, fused)
        require(model.fused_kernels == model.fused_tracer
                == (path == "kernel"),
                f"hydro_vi_closure {path} path selects fused_kernels="
                f"{model.fused_kernels}, fused_tracer={model.fused_tracer}")
        state = model.update_state(hydro_initial_state(model))
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for _ in range(HYDRO_CLOSURE_WARM):
            state = model.step(state, HYDRO_DT, assume_filled=True)
        state, ms, enqueue = timed_steps(torch, model, state, HYDRO_DT,
                                         HYDRO_CLOSURE_STEPS)
        total = HYDRO_CLOSURE_WARM + HYDRO_CLOSURE_STEPS
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        want = ({k: n * total for k, n in hydro_kernels.items()}
                if path == "kernel" else {})
        require(counts == want, f"hydro_vi_closure {path} path launches "
                f"{counts}, expected {want}")
        g = model.grid
        require(all(bool(torch.isfinite(q).all())
                    for q in (state.u, state.v, state.w, state.eta,
                              *state.tracers.values())),
                f"hydro_vi_closure {path} path: finite fields")
        xy = g.interior_slices[:2]
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, HYDRO_DT, assume_filled=True),
            PROFILE_STEPS)
        require(busy > 0, f"hydro_vi_closure {path} path: the profiler saw "
                "device time")
        d = model.compute_diffusivities(state)
        _, n_thomas, thomas_wall = device_profile(
            torch, lambda: model._implicit_diffusion(state, d,
                                                     torch.tensor(HYDRO_DT)),
            PROFILE_STEPS)
        out[path] = {"ms": ms, "enqueue": enqueue, "busy": busy,
                     "launches": counts, "per_step_launches": n_launch,
                     "thomas_launches": n_thomas, "thomas_ms": thomas_wall}
        log(f"[13] hydro_vi_closure {path} path: {ms:.3f} ms/step (steps "
            f"{HYDRO_CLOSURE_WARM + 1} to {total} of AB2, CUDA events); host "
            f"enqueue {enqueue:.3f} ms/step; launches in {total} steps "
            f"{counts}; max|u| {float(g.interior(state.u).abs().max()):.4e}"
            f", max|eta| {float(state.eta[xy].abs().max()):.4e}")
        log(f"[13] hydro_vi_closure {path} path under torch.profiler, "
            f"{PROFILE_STEPS} steps: device-busy {busy:.3f} ms/step in a wall of "
            f"{wall:.3f} ms/step, idle share {1 - busy / wall:.3f}; against "
            f"the unprofiled {ms:.3f} ms/step, idle share "
            f"{1 - busy / ms:.3f}; {n_launch:.0f} kernel launches a step, "
            f"{n_thomas:.0f} of them the implicit vertical diffusion (the "
            f"Thomas solves of u, v, T and S over {g.shape[2]} levels; "
            f"{thomas_wall:.3f} ms alone under the profiler)")
        finals[path] = (g, {
            "velocities": [g.interior(state.u).clone(),
                           g.interior(state.v).clone()],
            "eta": [state.eta[xy].clone()],
            "tracers": [g.interior(state.tracers[n]).clone()
                        for n in ("T", "S")]})
        del model, state, d
        torch.cuda.empty_cache()
    ks, ps = finals["kernel"][1], finals["plain"][1]
    rel = {k: group_rel(list(zip(ks[k], ps[k]))) for k in ks}
    log(f"[13] hydro_vi_closure: kernel vs plain path after "
        f"{HYDRO_CLOSURE_WARM + HYDRO_CLOSURE_STEPS} steps: " + ", ".join(
            f"{k} {v:.3e} of the largest value (tolerance {rtol[k]:g})"
            for k, v in rel.items()))
    require(all(rel[k] <= rtol[k] for k in rel),
            f"hydro_vi_closure kernel vs plain path {rel}")
    del finals, ks, ps
    torch.cuda.empty_cache()

    # float64 (48, 16, 6): the kernel path on the card against the plain
    # path on the CPU, from a state without rounding-level zeros of the
    # velocities (as phase 9's)
    f64 = {}
    for device in ("cuda", "cpu"):
        m = hydro_closure_model(torch, ot, "auto", torch.float64, device,
                                size=(48, 16, 6))
        require(m.fused_kernels == m.fused_tracer == (device == "cuda"),
                "float64 hydro_vi_closure routes")
        st = hydro_generic_state(m)
        for _ in range(5):
            st = m.step(st, HYDRO_DT)
        f64[device] = (m.grid, st)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    xy = gp.interior_slices[:2]
    groups = {"velocities": [(gk.interior(sk.u).cpu(), gp.interior(sp.u)),
                             (gk.interior(sk.v).cpu(), gp.interior(sp.v))],
              "w": [(gk.interior(sk.w).cpu(), gp.interior(sp.w))],
              "eta": [(sk.eta[xy].cpu(), sp.eta[xy])],
              "tracers": [(gk.interior(sk.tracers[n]).cpu(),
                           gp.interior(sp.tracers[n])) for n in ("T", "S")]}
    rel64 = {k: group_rel(p) for k, p in groups.items()}
    log("[13] float64 (48, 16, 6) hydro_vi_closure, 5 AB2 steps: kernel "
        "path on the card vs plain path on the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel64.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel64.values()),
            f"float64 (48, 16, 6) hydro_vi_closure card vs CPU {rel64}")
    return out


def hydro_latlon_phase(torch, ot, wrappers, card, rtol):
    """Phase 14: ``hydro_vi_latlon``, ``hydro_vi`` on a 1° near-global
    ``LatitudeLongitudeGrid`` (360 x 160 x 60, 80°S-80°N, 4 km deep, halo
    (6, 6, 4)) with spherical Coriolis and linear seawater buoyancy, on the
    kernel path (kernels 11 and 12/13 once a step through their lat-lon
    gates) and on the plain path; its volume; a float64 run at full width
    and one at the (24, 16, 8) sector of the card against the CPU; a
    mixed-order vector-invariant run; and a float64 tripolar run, which no
    kernel takes."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_latlon_initial_state, hydro_latlon_model,
        volume_drift,
    )
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    hydro_kernels = ("weno_tracer_tendencies", "vi_momentum_tendency")

    def run(model, state, warm, steps, kernels):
        """``warm`` + ``steps`` steps from ``state`` with the launch counts
        zeroed first and checked after: once a step for each of
        ``kernels``, none of the others."""
        for fn in wrappers.values():
            fn.launches = 0
        for _ in range(warm):
            state = model.step(state, HYDRO_DT, assume_filled=True)
        state, ms, enqueue = timed_steps(torch, model, state, HYDRO_DT,
                                         steps)
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        want = {k: warm + steps for k in kernels}
        require(counts == want, f"hydro_vi_latlon launches {counts}, "
                f"expected {want}")
        require(all(bool(torch.isfinite(q).all())
                    for q in (state.u, state.v, state.w, state.eta,
                              *state.tracers.values())),
                "hydro_vi_latlon: finite fields")
        return state, ms, enqueue, counts

    def fields(g, st):
        xy = g.interior_slices[:2]
        return {"velocities": [g.interior(st.u).clone(),
                               g.interior(st.v).clone()],
                "eta": [st.eta[xy].clone()],
                "tracers": [g.interior(st.tracers[n]).clone()
                            for n in ("T", "S")]}

    def paths(momentum, warm, steps, tag, scales=None):
        """Both paths at full width in float32 from the initial state,
        held to each other relative to the largest value of each group
        (or the larger ``scales`` entry)."""
        finals, out = {}, {}
        for path, fused in (("kernel", "auto"), ("plain", False)):
            model = hydro_latlon_model(fused, momentum_advection=momentum)
            g = model.grid
            require(type(g) is ot.LatitudeLongitudeGrid
                    and model.fused_kernels == model.fused_tracer
                    == (path == "kernel"),
                    f"{tag} {path} path selects fused_kernels="
                    f"{model.fused_kernels}, fused_tracer="
                    f"{model.fused_tracer}: the lat-lon gates take the "
                    "grid")
            state = model.update_state(hydro_latlon_initial_state(model))
            eta0 = state.eta.clone()
            torch.cuda.synchronize()
            state, ms, enqueue, counts = run(
                model, state, warm, steps,
                hydro_kernels if path == "kernel" else ())
            drift = volume_drift(model, eta0, state.eta)
            substeps = len(model.free_surface.weights)
            vbound = ((warm + steps) * substeps
                      * float(torch.finfo(torch.float32).eps))
            require(drift <= vbound, f"{tag} {path} path: volume drift "
                    f"{drift:.3e} of sum|eta| Az (float32 bound {vbound:.3e})")
            out[path] = {"ms": ms, "enqueue": enqueue, "counts": counts,
                         "drift": drift, "model": model, "state": state,
                         "vbound": vbound}
            finals[path] = fields(g, state)
            torch.cuda.synchronize()
        rel = {k: group_rel(list(zip(finals["kernel"][k],
                                     finals["plain"][k])),
                            (scales or {}).get(k, 0.0))
               for k in finals["kernel"]}
        out["eta_max"] = float(finals["plain"]["eta"][0].abs().max())
        require(all(rel[k] <= rtol[k] for k in rel),
                f"{tag} kernel vs plain path {rel}")
        return out, rel

    # the main run: 2 + 10 steps on each path
    out, rel = paths(None, LATLON_WARM, LATLON_STEPS, "hydro_vi_latlon")
    total = LATLON_WARM + LATLON_STEPS
    for path in ("kernel", "plain"):
        o = out[path]
        model, state = o.pop("model"), o.pop("state")
        g = model.grid
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, HYDRO_DT, assume_filled=True),
            PROFILE_STEPS)
        require(busy > 0, f"hydro_vi_latlon {path} path: the profiler saw "
                "device time")
        o.update(busy=busy, per_step_launches=n_launch)
        xy = g.interior_slices[:2]
        log(f"[14] hydro_vi_latlon {path} path: {o['ms']:.3f} ms/step (steps"
            f" {LATLON_WARM + 1} to {total} of AB2, CUDA events); host "
            f"enqueue {o['enqueue']:.3f} ms/step; launches in {total} steps "
            f"{o['counts']}; max|u| "
            f"{float(g.interior(state.u).abs().max()):.4e}, max|eta| "
            f"{float(state.eta[xy].abs().max()):.4e}; volume drift "
            f"{o['drift']:.3e} of sum|eta| Az (float32 bound "
            f"{o['vbound']:.3e})")
        log(f"[14] hydro_vi_latlon {path} path under torch.profiler, "
            f"{PROFILE_STEPS} steps: device-busy {busy:.3f} ms/step in a wall of "
            f"{wall:.3f} ms/step, idle share {1 - busy / wall:.3f}; against "
            f"the unprofiled {o['ms']:.3f} ms/step, idle share "
            f"{1 - busy / o['ms']:.3f}; {n_launch:.0f} kernel launches a "
            "step")
        del model, state
        torch.cuda.empty_cache()
    log(f"[14] hydro_vi_latlon: kernel vs plain path after {total} steps: "
        + ", ".join(f"{k} {v:.3e} of the largest value (tolerance "
                    f"{rtol[k]:g})" for k, v in rel.items()))

    # float64 at full width on the kernel path: the volume to 1e-12
    model = hydro_latlon_model("auto", torch.float64)
    state = model.update_state(hydro_latlon_initial_state(model))
    eta0 = state.eta.clone()
    state, ms64, _, counts64 = run(model, state, 0, 3, hydro_kernels)
    drift64 = volume_drift(model, eta0, state.eta)
    require(drift64 <= VOLUME_RTOL, f"float64 hydro_vi_latlon volume drift "
            f"{drift64:.3e}")
    log(f"[14] float64 hydro_vi_latlon at full width, 3 AB2 steps on the "
        f"kernel path: {ms64:.3f} ms/step; launches {counts64}; volume "
        f"drift {drift64:.3e} of sum|eta| Az (tolerance {VOLUME_RTOL:g})")
    del model, state, eta0
    torch.cuda.empty_cache()

    # float64 at the (24, 16, 8) sector: the card against the CPU
    f64 = {}
    for device in ("cuda", "cpu"):
        m = hydro_latlon_model("auto", torch.float64, device,
                               size=(24, 16, 8), longitude=(-30.0, 30.0),
                               latitude=(15.0, 55.0), halo=6)
        require(m.fused_kernels == m.fused_tracer == (device == "cuda"),
                "float64 hydro_vi_latlon sector routes")
        st = hydro_latlon_initial_state(m, generic=True)
        for _ in range(3):
            st = m.step(st, HYDRO_DT)
        f64[device] = (m.grid, st)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    xy = gp.interior_slices[:2]
    groups = {"velocities": [(gk.interior(sk.u).cpu(), gp.interior(sp.u)),
                             (gk.interior(sk.v).cpu(), gp.interior(sp.v))],
              "w": [(gk.interior(sk.w).cpu(), gp.interior(sp.w))],
              "eta": [(sk.eta[xy].cpu(), sp.eta[xy])],
              "tracers": [(gk.interior(sk.tracers[n]).cpu(),
                           gp.interior(sp.tracers[n])) for n in ("T", "S")]}
    rel64 = {k: group_rel(p) for k, p in groups.items()}
    log("[14] float64 (24, 16, 8) lat-lon sector, 3 AB2 steps: kernel path "
        "on the card vs plain path on the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel64.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel64.values()),
            f"float64 lat-lon sector card vs CPU {rel64}")
    del f64, m, st
    torch.cuda.empty_cache()

    # mixed orders: the vector-invariant kernel's instantiation of runtime
    # orders, 1 + 3 steps on both paths
    # η starts from rest and grows over the first steps while the paths'
    # rounding differences do not shrink with it: after 4 steps it is held
    # relative to the larger of its own largest value and the 22-step
    # run's
    mixed, mixed_rel = paths(mixed_vi(ot, VI_MIXED[0]), 1, 3,
                             "hydro_vi_latlon mixed orders",
                             {"eta": out["eta_max"]})
    for path in ("kernel", "plain"):
        del mixed[path]["model"], mixed[path]["state"]
    log(f"[14] hydro_vi_latlon with orders {VI_MIXED[0]} (the vertical "
        f"scheme's epsilon 1e-6), 1 + 3 steps: kernel path "
        f"{mixed['kernel']['ms']:.3f} ms/step, plain path "
        f"{mixed['plain']['ms']:.3f} ms/step; launches "
        f"{mixed['kernel']['counts']}; kernel vs plain path: " + ", ".join(
            f"{k} {v:.3e}" for k, v in mixed_rel.items())
        + f" of the largest value (eta: of max(max|eta| "
        f"{mixed['eta_max']:.4e}, the 22-step run's {out['eta_max']:.4e}))")
    torch.cuda.empty_cache()

    # the tripolar grid in float64: no kernel takes it (as in the JAX
    # package); the zipper fold fills the north halos on the card
    tg = ot.TripolarGrid(size=(360, 170, 60), z=(-4000.0, 0.0),
                         halo=(6, 6, 4), dtype=torch.float64, device="cuda")
    tm = ot.HydrostaticFreeSurfaceModel(
        grid=tg, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(7), tracers=("T", "S"),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState()),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30))
    require(not ctr.tracer_fusion_available(tg, tm.tracer_advection)
            and not cvi.vi_available(tg, tm.momentum_advection),
            "no kernel takes the tripolar grid")
    st = tm.update_state(hydro_latlon_initial_state(tm))
    eta0 = st.eta.clone()
    st, tms, _, tcounts = run(tm, st, 0, 3, ())
    tdrift = volume_drift(tm, eta0, st.eta)
    require(tdrift <= VOLUME_RTOL, f"tripolar volume drift {tdrift:.3e}")
    log(f"[14] float64 TripolarGrid(size=(360, 170, 60)), 3 AB2 steps on "
        f"the card: {tms:.3f} ms/step, launches {tcounts}; max|u| "
        f"{float(tg.interior(st.u).abs().max()):.4e}; volume drift "
        f"{tdrift:.3e} of sum|eta| Az (tolerance {VOLUME_RTOL:g})")
    del tm, st, tg, eta0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 15 and 16: the cubed sphere (no port kernel lies on its paths)
# ---------------------------------------------------------------------------

#: warm-up and timed steps of each cubed-sphere run
CS_WARM, CS_STEPS = 2, 10
#: phase 15's size
CS_W2_N = 192
#: phase 15's float32 run against the float64 run of the same steps on the
#: card, relative to the largest float64 value of each group (u and v; h)
CS_W2_F32_RTOL = 1e-5
#: phase 16's sizes: ``bench.py``'s own C48×16 and the throughput size
#: C192×32 (6·192²·32 ≈ 7.1 M cells)
CS_GLOBAL_SIZES = ((48, 16), (192, 32))
#: the float64 budgets: mass and volume to 1e-12 of themselves, salt to
#: 1e-9 (``tests/test_cubed_sphere_ocean.py:379-440``)
CS_SALT_RTOL = 1e-9


def cube_run(torch, model, state, dt, warm, steps, wrappers, tag,
             each=None):
    """``warm`` + ``steps`` steps of a model on a path no port kernel lies
    on (a cubed-sphere, immersed or stretched grid), with the port's kernel
    counts zeroed first: (state, ms/step by CUDA events, host enqueue
    ms/step). ``each(model)`` is called after every step. Fails if any
    port kernel launched (as in the JAX package, none takes these grids)
    or a field is not finite."""
    for fn in wrappers.values():
        fn.launches = 0
    for _ in range(warm):
        state = model.step(state, dt)
        if each is not None:
            each(model)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = model.step(state, dt)
        if each is not None:
            each(model)
    t1 = time.perf_counter()
    e1.record()
    e1.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    require(not counts, f"{tag}: port kernels launched on a path none "
            f"takes: {counts}")
    require(all(bool(torch.isfinite(q).all())
                for q in state.fields().values()), f"{tag}: finite fields")
    ms = e0.elapsed_time(e1) / steps if steps else float("nan")
    return state, ms, (t1 - t0) * 1e3 / max(steps, 1)


def cube_profile(torch, model, state, dt, tag):
    """Device-busy ms, launches and wall ms of a step under
    ``torch.profiler`` (``PROFILE_STEPS`` steps from ``state``)."""
    busy, n_launch, wall = device_profile(
        torch, lambda: model.step(state, dt), PROFILE_STEPS)
    require(busy > 0, f"{tag}: the profiler saw device time")
    return busy, n_launch, wall


def cube_groups(grid, state, names):
    """Interior views of ``state``'s fields, grouped as ``names`` says."""
    f = state.fields()
    return {k: [grid.interior(f[n]) for n in ns] for k, ns in names.items()}


def cs_w2_phase(torch, wrappers, card):
    """Phase 15: ``cs_w2``, Williamson 2 at C192 (Δt = 40 s) in float32
    for 2 + 10 steps, timed and profiled; held against a float64 card run
    of the same steps; its float64 mass to 1e-12; and a float64 C8 run of
    the golden's 10 steps on the card against the CPU."""
    from oceananigans_torch.profile_step import CS_W2_DT, cs_w2_model
    N, total = CS_W2_N, CS_WARM + CS_STEPS
    groups = {"velocities": ("u", "v"), "h": ("h",)}
    model, state = cs_w2_model(N, torch.float32)
    g = model.grid
    spacing = 2 * math.pi * 6.37122e6 / (4 * N)
    log(f"[15] cs_w2: C{N} Williamson 2, float32, dt {CS_W2_DT} s, gravity-"
        f"wave CFL {math.sqrt(2.94e4) * CS_W2_DT / spacing:.3f} at the mean "
        "panel spacing")
    state, ms, enqueue = cube_run(torch, model, state, CS_W2_DT, CS_WARM,
                                  CS_STEPS, wrappers, "cs_w2")
    busy, n_launch, wall = cube_profile(torch, model, state, CS_W2_DT,
                                        "cs_w2")
    log(f"[15] cs_w2 on {card}: {ms:.3f} ms/step (steps {CS_WARM + 1} to "
        f"{total} of RK3, CUDA events); host enqueue {enqueue:.3f} ms/step; "
        f"under torch.profiler, {PROFILE_STEPS} steps: device-busy "
        f"{busy:.3f} ms/step in "
        f"a wall of {wall:.3f} ms/step, idle share {1 - busy / wall:.3f} "
        f"(against the unprofiled {ms:.3f} ms/step: {1 - busy / ms:.3f}); "
        f"{n_launch:.0f} kernel launches a step; port kernels launched: "
        "none")
    f32 = cube_groups(g, state, groups)
    del model, state

    model, state = cs_w2_model(N, torch.float64)
    mass0 = float(model.total_mass(state))
    state, ms64, _ = cube_run(torch, model, state, CS_W2_DT, CS_WARM,
                              CS_STEPS, wrappers, "cs_w2 float64")
    drift = abs(float(model.total_mass(state)) - mass0) / mass0
    require(drift <= VOLUME_RTOL, f"cs_w2 float64 mass drift {drift:.3e}")
    f64 = cube_groups(model.grid, state, groups)
    rel = {k: group_rel(list(zip(f32[k], f64[k]))) for k in groups}
    log(f"[15] cs_w2 float64 at C{N}, {total} steps: {ms64:.3f} ms/step; "
        f"mass drift {drift:.3e} of the mass (tolerance {VOLUME_RTOL:g}); "
        "float32 vs float64 after "
        f"{total} steps: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" of the largest value (tolerance {CS_W2_F32_RTOL:g})")
    require(all(v <= CS_W2_F32_RTOL for v in rel.values()),
            f"cs_w2 float32 vs float64 {rel}")
    del model, state, f32, f64
    torch.cuda.empty_cache()

    runs = {}
    for device in ("cuda", "cpu"):
        m, st = cs_w2_model(8, torch.float64, device)
        for _ in range(10):
            st = m.step(st, 600.0)
        runs[device] = cube_groups(m.grid, st, groups)
    rel8 = {k: group_rel([(a, b) for a, b in zip(runs["cuda"][k],
                                                 runs["cpu"][k])])
            for k in groups}
    log("[15] float64 C8 Williamson 2, 10 steps of 600 s: the card vs the "
        "CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in rel8.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel8.values()),
            f"cs_w2 C8 card vs CPU {rel8}")
    return {"ms": ms, "enqueue": enqueue, "busy": busy,
            "launches": n_launch, "wall": wall}


def cs_global_phase(torch, wrappers, card):
    """Phase 16: ``cs_global``, ``bench.py``'s ocean (continents, seawater
    buoyancy, convective adjustment, split-explicit free surface with 20
    substeps, wind and heat fluxes, RK3, Δt = 300 s) at C48×16 and
    C192×32 in float32 for 2 + 10 steps, timed and profiled, Δt checked
    against the gravity-wave and advective limits and the float32 volume
    held to its rounding bound; its float64 volume and salt at C48×16; and
    a float64 C8×4 run on the card against the CPU."""
    from oceananigans_torch.grids.base import Center, Face
    from oceananigans_torch.profile_step import (
        CS_GLOBAL_DT, cs_global_model, volume_drift,
    )
    dt = CS_GLOBAL_DT
    out = {}
    for N, Nz in CS_GLOBAL_SIZES:
        tag = f"cs_global C{N}x{Nz}"
        model, state = cs_global_model(N, Nz, torch.float32)
        g = model.grid.panel_grid
        ii = g.interior_slices
        dmin = min(float(torch.broadcast_to(d, g.shape)[ii].min())
                   for d in (g.dx(Face, Center), g.dy(Center, Face)))
        Hmax = float(model._Hc.max())
        fs = model.free_surface
        dtau = dt * fs.fractional_step
        cfl_gw = math.sqrt(fs.g * Hmax) * dtau / dmin
        require(cfl_gw < 1.0, f"{tag}: barotropic substep CFL {cfl_gw:.3f}")
        state, _, _ = cube_run(torch, model, state, dt, CS_WARM, 0,
                               wrappers, tag)
        tau = float(model.cfl_timescale(state))
        cfl_adv = dt / tau
        require(cfl_adv < 1.0, f"{tag}: advective CFL {cfl_adv:.3e}")
        log(f"[16] {tag}: dt {dt} s; the smallest spacing {dmin:.1f} m, "
            f"deepest column {Hmax:.1f} m: barotropic substep (dt·"
            f"{fs.fractional_step:g} = {dtau:g} s) CFL {cfl_gw:.3f}; after "
            f"{CS_WARM} steps cfl_timescale {tau:.4e} s, advective CFL "
            f"{cfl_adv:.3e}: dt stands")
        eta0 = state.eta.clone()
        state, ms, enqueue = cube_run(torch, model, state, dt, 0, CS_STEPS,
                                      wrappers, tag)
        # float32 rounding of η over the RK3 stages' barotropic substeps
        substeps = 3 * len(fs.weights)
        vdrift = volume_drift(model, eta0, state.eta)
        vbound = (CS_STEPS * substeps
                  * float(torch.finfo(torch.float32).eps))
        require(vdrift <= vbound, f"{tag}: float32 volume drift "
                f"{vdrift:.3e} of sum|eta| Az (bound {vbound:.3e})")
        busy, n_launch, wall = cube_profile(torch, model, state, dt, tag)
        cells = 6 * N * N * Nz
        log(f"[16] {tag} on {card}: {ms:.3f} ms/step (steps {CS_WARM + 1} "
            f"to {CS_WARM + CS_STEPS} of RK3, CUDA events), "
            f"{cells / ms / 1e3:.2f} M cell-steps/s; host enqueue "
            f"{enqueue:.3f} ms/step; under torch.profiler, {PROFILE_STEPS} "
            f"steps: device-busy {busy:.3f} ms/step in a wall of {wall:.3f} ms/step, idle "
            f"share {1 - busy / wall:.3f} (against the unprofiled {ms:.3f} "
            f"ms/step: {1 - busy / ms:.3f}); {n_launch:.0f} kernel launches "
            f"a step; port kernels launched: none; float32 volume drift "
            f"{vdrift:.3e} of sum|eta| Az over {CS_STEPS} steps (bound "
            f"{vbound:.3e}: {CS_STEPS} steps x {substeps} barotropic "
            f"substeps x the float32 epsilon); max|u|"
            f" {float(model.grid.interior(state.u).abs().max()):.4e}")
        out[f"C{N}x{Nz}"] = {"ms": ms, "enqueue": enqueue, "busy": busy,
                             "launches": n_launch, "wall": wall}
        del model, state
        torch.cuda.empty_cache()

    # float64 at C48x16: volume to 1e-12 of the ocean's, salt to 1e-9
    model, state = cs_global_model(48, 16, torch.float64)
    vol0 = float(model.total_volume(state))
    S0 = float(model.total_tracer(state, "S"))
    state, ms64, _ = cube_run(torch, model, state, dt, 0, 5, wrappers,
                              "cs_global float64")
    scale = float(model.ocean_volume())
    vdrift = abs(float(model.total_volume(state)) - vol0) / scale
    sdrift = abs(float(model.total_tracer(state, "S")) - S0) / abs(S0)
    log(f"[16] float64 cs_global C48x16, 5 steps: {ms64:.3f} ms/step; "
        f"volume drift {vdrift:.3e} of the ocean's volume (tolerance "
        f"{VOLUME_RTOL:g}); salt drift {sdrift:.3e} (tolerance "
        f"{CS_SALT_RTOL:g})")
    require(vdrift <= VOLUME_RTOL and sdrift <= CS_SALT_RTOL,
            f"cs_global float64 budgets: volume {vdrift:.3e}, salt "
            f"{sdrift:.3e}")
    del model, state
    torch.cuda.empty_cache()

    groups = {"velocities": ("u", "v"), "eta": ("eta",), "T": ("T",),
              "S": ("S",)}
    runs = {}
    for device in ("cuda", "cpu"):
        m, st = cs_global_model(8, 4, torch.float64, device)
        for _ in range(3):
            st = m.step(st, 600.0)
        runs[device] = cube_groups(m.grid, st, groups)
    rel8 = {k: group_rel([(a, b) for a, b in zip(runs["cuda"][k],
                                                 runs["cpu"][k])])
            for k in groups}
    log("[16] float64 cs_global C8x4, 3 steps of 600 s: the card vs the "
        "CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in rel8.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel8.values()),
            f"cs_global C8x4 card vs CPU {rel8}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: output (writers, time averages, checkpoints, ensembles)
# ---------------------------------------------------------------------------

#: phase 17a's Δt, bench.py's: not exact in binary, so the float32 clock's
#: sum of 50 steps ends 1.1e-10 s short of 50 Δt, and the time-based
#: schedules compare in the clock's precision
#: (``utils.schedules.time_margin``)
OUTPUT_DT = 1e-4
#: 17a: the size; steps of the run, checkpoint interval, field and NetCDF
#: intervals, the averaging interval and window (in steps) and the progress
#: interval
OUT_N = 256
OUT_STEPS, OUT_CKPT, OUT_FIELDS, OUT_NC = 100, 50, 25, 50
OUT_AVG, OUT_WINDOW, OUT_PROGRESS = 50, 10, 10
#: 17b, 17c: steps and checkpoint or writer interval
HYDRO_OUT_STEPS, HYDRO_OUT_CKPT = 20, 10
CS_W2_OUT_STEPS, CS_W2_OUT_EVERY = 20, 10
CS_GLOBAL_OUT_SIZE, CS_GLOBAL_OUT_STEPS, CS_GLOBAL_OUT_CKPT = (48, 16), 10, 5
#: 17d: the JAX package's ensemble test (diffusion columns,
#: ``tests/test_ensemble_and_pallas.py:16-44``) at 1024 members of 256
#: levels in float64, three members held to their serial runs
ENS_MEMBERS, ENS_LEVELS, ENS_STEPS, ENS_DT = 1024, 256, 20, 1e-3
ENS_CHECKED, ENS_RTOL = (0, 511, 1023), 1e-12


class TimedWrites:
    """Times each write of ``writer`` on the host clock (after the device's
    queue is drained, so a write's time is its own: the copy to the host,
    then the file) and counts its bytes. Without h5py an HDF5 or NetCDF
    writer only fetches (the part of a write that touches the device:
    the cast on the device and the copy), and keeps what it fetched."""

    def __init__(self, torch, writer, files):
        self.torch, self.writer, self.files = torch, writer, files
        self.ms, self.nbytes, self.fetched = [], [], []
        self._write = writer.write
        writer.write = self

    def __call__(self, sim):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.files or not hasattr(self.writer, "fetch"):
            before = self.size()
            self._write(sim)
            nbytes = self.size() - before
        else:
            data = self.writer.fetch(sim)
            self.fetched.append((int(sim.state.clock.iteration), data))
            nbytes = sum(a.nbytes for a in data.values())
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.nbytes.append(nbytes)

    def size(self):
        import os
        w = self.writer
        if hasattr(w, "dirname"):
            return sum(os.path.getsize(os.path.join(w.dirname, f))
                       for f in os.listdir(w.dirname))
        return os.path.getsize(w.filename) if os.path.exists(
            w.filename) else 0

    def summary(self):
        n = len(self.ms)
        return (f"{n} writes, {sum(self.ms) / n:.3f} ms and "
                f"{sum(self.nbytes) / n / 1e6:.3f} MB a write (first "
                f"{self.ms[0]:.3f} ms)")


def flat_equal(torch, a, b):
    """Whether two states are bitwise equal (every tensor, the iteration),
    and the keys that differ."""
    from oceananigans_torch.interop import flatten_state
    fa, fb = flatten_state(a), flatten_state(b)
    bad = sorted(k for k in fa if not (
        torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
        else fa[k] == fb[k]))
    return sorted(fa) == sorted(fb) and not bad, bad


def output_main_path(torch, ot, wrappers, card, dev, h5, tmp, ref):
    """17a: the 256³ default model (kernel 1) through Simulation with its
    writers and a checkpoint; the pickup; the time averages."""
    import os

    from oceananigans_torch.grids.base import Center, Face
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.profile_step import initial_state
    N, dt = OUT_N, OUTPUT_DT
    grid = ot.RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Bounded, ot.Periodic, ot.Periodic),
                              halo=(1, 0, 0), dtype=torch.float32,
                              device=dev)
    model = ot.NonhydrostaticModel(grid=grid,
                                   timestepper="QuasiAdamsBashforth2")
    s0 = initial_state(model)
    keep = {k: getattr(s0, k).clone() for k in ("u", "v", "w", "pressure",
                                                "Gu", "Gv", "Gw")}

    def fresh():
        return dataclasses.replace(
            s0, **{k: t.clone() for k, t in keep.items()})

    def umean(m, s):
        return ot.Average(m.grid, s.u, dims=(0, 1),
                          loc=(Face, Center, Center))

    def attach(sim, d):
        """The phase's writers on ``sim``, files under ``d``, timed."""
        ws = {"fields": ot.HDF5Writer(
                  {"u": "u", "w": "w", "umean": umean},
                  os.path.join(d, "fields.h5"),
                  ot.IterationInterval(OUT_FIELDS)),
              "nc": ot.NetCDFWriter({"w": "w"}, os.path.join(d, "w.nc"),
                                    ot.IterationInterval(OUT_NC)),
              "avg": ot.HDF5Writer(
                  {"u": ot.WindowedTimeAverage("u")},
                  os.path.join(d, "avg.h5"),
                  ot.AveragedTimeInterval(OUT_AVG * dt,
                                          window=OUT_WINDOW * dt)),
              "ckpt": ot.Checkpointer(os.path.join(tmp, "ckpt"),
                                      ot.IterationInterval(OUT_CKPT))}
        sim.output_writers.update(ws)
        sim.callbacks["progress"] = ot.Callback(
            lambda s: None, ot.IterationInterval(OUT_PROGRESS))
        return {k: TimedWrites(torch, w, h5) for k, w in ws.items()}

    # the bare loop from the state, with the float64 sums of u over the
    # averaging windows (the states after steps 40-49 and 90-99)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    windows = {OUT_AVG * k: torch.zeros(grid.N, dtype=torch.float64,
                                        device=dev)
               for k in (1, 2)}
    umax = 0.0
    torch.cuda.synchronize()
    e0.record()
    bare = model.fill_state_halos(fresh())
    for it in range(1, OUT_STEPS + 1):
        bare = model.step(bare, dt, assume_filled=True)
        end = OUT_AVG * math.ceil(it / OUT_AVG)
        if end - OUT_WINDOW <= it < end:
            windows[end] += grid.interior(bare.u).double()
            umax = max(umax, float(grid.interior(bare.u).abs().max()))
    e1.record()
    e1.synchronize()
    bare_ms = e0.elapsed_time(e1) / OUT_STEPS

    # the run with its writers, from the same state
    for fn in wrappers.values():
        fn.launches = 0
    sim = ot.Simulation(model, state=fresh(), dt=dt,
                        stop_iteration=OUT_STEPS)
    timed = attach(sim, os.path.join(tmp, "run"))
    torch.cuda.synchronize()
    e0.record()
    sim.run()
    e1.record()
    e1.synchronize()
    run_ms = e0.elapsed_time(e1) / OUT_STEPS
    n_run = ck.centered2_ab2_update.launches
    same, bad = flat_equal(torch, sim.state, bare)
    log(f"[17] 17a two uninterrupted runs of {OUT_STEPS} steps from one "
        f"state (Simulation with writers; the bare loop): bitwise equal: "
        f"{same}")
    require(same, f"17a: the run with writers equals the bare loop bit for "
            f"bit (differ: {bad})")
    require(n_run == OUT_STEPS, f"17a: kernel 1 launched {n_run} times in "
            f"{OUT_STEPS} steps")
    final = sim.state

    # the pickup at the checkpoint of iteration OUT_CKPT, to OUT_STEPS
    path = os.path.join(tmp, "ckpt", f"ckpt_iteration{OUT_CKPT}.pt")
    template = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = sim.output_writers["ckpt"].restore(template, path)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(restored.clock.iteration == OUT_CKPT
            and type(restored.clock.iteration) is int
            and restored.clock.time.dtype == torch.float32,
            f"17a: the restored clock {restored.clock}")
    del restored
    sim2 = ot.Simulation(model, state=template, dt=dt,
                         stop_iteration=OUT_STEPS)
    attach(sim2, os.path.join(tmp, "pickup"))
    sim2.run(pickup=path)
    n_all = ck.centered2_ab2_update.launches
    same, bad = flat_equal(torch, sim2.state, final)
    log(f"[17] 17a pickup at iteration {OUT_CKPT} of {path} to "
        f"{OUT_STEPS}: bitwise equal to the uninterrupted run (u, v, w, "
        f"pressure, Gu, Gv, Gw, time {float(final.clock.time)!r}, "
        f"iteration, last_dt): {same}; kernel 1 launched {n_all} times "
        f"({OUT_STEPS} + {OUT_STEPS - OUT_CKPT})")
    require(same, f"17a: the pickup equals the uninterrupted run bit for "
            f"bit (differ: {bad})")
    want = 2 * OUT_STEPS - OUT_CKPT
    require(n_all == want, f"17a: kernel 1 launched {n_all} times, not "
            f"{want}")

    # what the writers wrote: the last u equals the final interior u; the
    # averages equal the float64 means of the bare loop's windows
    u_final = grid.interior(final.u).cpu().numpy()
    if h5:
        d = os.path.join(tmp, "run")
        u_series = ot.load_field_time_series(os.path.join(d, "fields.h5"),
                                             "u")
        u_last = u_series[len(u_series) - 1]
        u_times = [int(round(float(t) / dt)) for t in u_series.times]
        avg = ot.load_field_time_series(os.path.join(d, "avg.h5"), "u")
        averages = {int(round(float(t) / dt)): avg[i]
                    for i, t in enumerate(avg.times)}
    else:
        f = timed["fields"].fetched
        u_last, u_times = f[-1][1]["u"], [it for it, _ in f]
        averages = {it: data["u"] for it, data in timed["avg"].fetched}
    require((u_last == u_final).all(), "17a: the last written u equals the "
            "final interior u exactly")
    eps = float(torch.finfo(torch.float32).eps)
    bound = OUT_WINDOW * eps * umax
    errs = {}
    for end, total in windows.items():
        mean = (total / OUT_WINDOW).cpu().numpy()
        errs[end] = float(abs(averages[end] - mean).max())
    log(f"[17] 17a the written u at iterations {u_times} (the last equals "
        f"the "
        f"final interior u exactly); the windowed averages of u at "
        f"iterations {sorted(averages)}: against the float64 means of the "
        f"states {OUT_WINDOW} steps before {sorted(windows)}: max abs err "
        f"{errs} (bound {OUT_WINDOW} x eps32 x max|u| = {bound:.3e}, "
        f"max|u| {umax:.4e})")
    require(sorted(averages) == [0] + sorted(windows)
            and all(e <= bound for e in errs.values()),
            f"17a: the windowed averages {errs}")

    # the costs
    ck_w = timed["ckpt"]
    log(f"[17] 17a on {card}: {OUT_STEPS} steps with the writers "
        f"{run_ms:.4f} ms/step (CUDA events, writes included), the bare "
        f"loop {bare_ms:.4f} ms/step in this phase; phase 11's Simulation "
        f"{ref['sim_ms']:.4f} and bare loop {ref['bare_ms']:.4f} ms/step "
        f"without writers")
    for k, t in timed.items():
        what = ("written" if h5 or k == "ckpt"
                else "fetched to the host (h5py absent)")
        log(f"[17] 17a writer {k!r} ({what}): {t.summary()}")
    log(f"[17] 17a checkpoint: write {sum(ck_w.ms) / len(ck_w.ms):.3f} ms "
        f"and {ck_w.nbytes[-1] / 1e6:.3f} MB; restore (torch.load to the "
        f"card) {restore_ms:.3f} ms")
    return {"ms": run_ms, "bare_ms": bare_ms, "restore_ms": restore_ms,
            "writers": {k: (sum(t.ms) / len(t.ms),
                            sum(t.nbytes) / len(t.nbytes))
                        for k, t in timed.items()}}


def output_hydro(torch, ot, wrappers, card, tmp, ref_ms):
    """17b: ``hydro_vi`` through Simulation with a checkpoint and a
    pickup, kernels 11 and 12/13 once a step."""
    import os

    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_initial_state, hydro_model,
    )
    model = hydro_model("auto")
    s0 = model.update_state(hydro_initial_state(model))
    from oceananigans_torch.interop import flatten_state, unflatten_state
    keep = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in flatten_state(s0).items()}
    kernels = ("weno_tracer_tendencies", "vi_momentum_tendency")
    for fn in wrappers.values():
        fn.launches = 0
    sims = []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for pickup in (False, True):
        state = unflatten_state(s0, {k: v.clone() if isinstance(
            v, torch.Tensor) else v for k, v in keep.items()})
        sim = ot.Simulation(model, state=state, dt=HYDRO_DT,
                            stop_iteration=HYDRO_OUT_STEPS)
        ckpt = ot.Checkpointer(os.path.join(tmp, "hydro"),
                               ot.IterationInterval(HYDRO_OUT_CKPT))
        sim.output_writers["ckpt"] = ckpt
        timed = TimedWrites(torch, ckpt, True)
        torch.cuda.synchronize()
        e0.record()
        sim.run(pickup=pickup and ckpt._path(HYDRO_OUT_CKPT))
        e1.record()
        e1.synchronize()
        if not pickup:
            ms = e0.elapsed_time(e1) / HYDRO_OUT_STEPS
            ck_summary = timed.summary()
        sims.append(sim)
    counts = {k: wrappers[k].launches for k in kernels}
    others = [k for k in wrappers if k not in kernels
              and wrappers[k].launches]
    same, bad = flat_equal(torch, sims[1].state, sims[0].state)
    want = 2 * HYDRO_OUT_STEPS - HYDRO_OUT_CKPT
    log(f"[17] 17b hydro_vi: {HYDRO_OUT_STEPS} steps with a checkpoint at "
        f"{HYDRO_OUT_CKPT}, picked up at {HYDRO_OUT_CKPT} and run to "
        f"{HYDRO_OUT_STEPS}: bitwise equal (u, v, w, eta, U, V, Gu, Gv, "
        f"Geta, T, S, GT, GS, the clock): {same}; launches {counts} "
        f"({want} each); on {card}: {ms:.3f} ms/step with the checkpointer "
        f"(CUDA events, writes included) against phase 9's "
        f"{ref_ms:.3f} ms/step; checkpoint {ck_summary}")
    require(same, f"17b: the pickup equals the uninterrupted run (differ: "
            f"{bad})")
    require(all(n == want for n in counts.values()) and not others,
            f"17b: launches {counts}, others {others}")
    return {"ms": ms}


def output_cube(torch, ot, wrappers, card, h5, tmp):
    """17c: ``cs_w2`` at C192 with a NetCDF writer of h and u; ``cs_global``
    at C48×16 with a checkpoint and a pickup. No port kernel launches."""
    import os

    from oceananigans_torch.interop import flatten_state, unflatten_state
    from oceananigans_torch.profile_step import (
        CS_GLOBAL_DT, CS_W2_DT, cs_global_model, cs_w2_model,
    )

    def no_launches(tag):
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        require(not counts, f"{tag}: port kernels launched: {counts}")

    for fn in wrappers.values():
        fn.launches = 0
    model, state = cs_w2_model(CS_W2_N, torch.float32)
    sim = ot.Simulation(model, state=state, dt=CS_W2_DT,
                        stop_iteration=CS_W2_OUT_STEPS)
    nc = ot.NetCDFWriter({"h": "h", "u": "u"},
                         os.path.join(tmp, "cs_w2.nc"),
                         ot.IterationInterval(CS_W2_OUT_EVERY))
    sim.output_writers["nc"] = nc
    timed = TimedWrites(torch, nc, h5)
    sim.run()
    no_launches("17c cs_w2")
    h_final = model.grid.interior(sim.state.h).cpu().numpy()
    if h5:
        import h5py
        with h5py.File(nc.filename, "r") as f:
            h_last = f["h"][-1]
            layout = {k: f[k].shape for k in ("h", "u", "longitude")}
    else:
        h_last = timed.fetched[-1][1]["h"]
        layout = {k: v.shape for k, v in timed.fetched[-1][1].items()}
    require((h_last == h_final).all(), "17c: the written h equals the "
            "final h exactly")
    log(f"[17] 17c cs_w2 C{CS_W2_N}, {CS_W2_OUT_STEPS} steps with a "
        f"NetCDFWriter of h and u every {CS_W2_OUT_EVERY} on the cube's "
        f"coordinates ({'written' if h5 else 'fetched; h5py absent'}): "
        f"shapes {layout}; the last h equals the final h exactly; "
        f"{timed.summary()}; port kernels launched: none")
    del model, state, sim, timed
    torch.cuda.empty_cache()

    model, s0 = cs_global_model(*CS_GLOBAL_OUT_SIZE, torch.float32)
    keep = flatten_state(s0)
    keep = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in keep.items()}
    sims = []
    for pickup in (False, True):
        state = unflatten_state(s0, {k: v.clone() if isinstance(
            v, torch.Tensor) else v for k, v in keep.items()})
        sim = ot.Simulation(model, state=state, dt=CS_GLOBAL_DT,
                            stop_iteration=CS_GLOBAL_OUT_STEPS)
        ckpt = ot.Checkpointer(os.path.join(tmp, "cs_global"),
                               ot.IterationInterval(CS_GLOBAL_OUT_CKPT))
        sim.output_writers["ckpt"] = ckpt
        timed = TimedWrites(torch, ckpt, True)
        sim.run(pickup=pickup and ckpt._path(CS_GLOBAL_OUT_CKPT))
        if not pickup:
            ck_summary = timed.summary()
        sims.append(sim)
    no_launches("17c cs_global")
    same, bad = flat_equal(torch, sims[1].state, sims[0].state)
    log(f"[17] 17c cs_global C{CS_GLOBAL_OUT_SIZE[0]}x"
        f"{CS_GLOBAL_OUT_SIZE[1]} (RK3: U and V, no G's): "
        f"{CS_GLOBAL_OUT_STEPS} steps with a checkpoint at "
        f"{CS_GLOBAL_OUT_CKPT}, picked up there: bitwise equal: {same}; "
        f"checkpoint {ck_summary}; port kernels launched: none")
    require(same, f"17c: the cs_global pickup equals the uninterrupted run "
            f"(differ: {bad})")


def output_ensemble(torch, ot, wrappers, card, dev):
    """17d: ``EnsembleModel`` of the JAX package's diffusion columns, 1024
    members of 256 levels in float64, three members held to their serial
    runs."""
    import numpy as np
    grid = ot.RectilinearGrid(size=(ENS_LEVELS,), z=(0.0, math.pi),
                              topology=(ot.Flat, ot.Flat, ot.Bounded),
                              dtype=torch.float64, device=dev)
    model = ot.NonhydrostaticModel(
        grid=grid, advection=None, tracers=("c",),
        closure=ot.VerticalScalarDiffusivity(
            kappa=0.1,
            time_discretization=ot.VerticallyImplicitTimeDiscretization))
    amps = np.linspace(0.5, 2.0, ENS_MEMBERS)
    ens = ot.EnsembleModel(model, n=ENS_MEMBERS)
    t0 = time.perf_counter()
    states = ens.initial_states(
        c=lambda m, x, y, z: float(amps[m]) * torch.cos(z))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for fn in wrappers.values():
        fn.launches = 0
    states = ens.step(states, ENS_DT)      # warm-up
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(ENS_STEPS - 1):
        states = ens.step(states, ENS_DT)
    e1.record()
    e1.synchronize()
    ens_ms = e0.elapsed_time(e1) / (ENS_STEPS - 1)
    require(torch.isfinite(states.tracers["c"]).all(), "17d: finite")
    errs = {}
    for m in ENS_CHECKED:
        s = model.initial_state(c=lambda x, y, z: float(amps[m])
                                * torch.cos(z))
        e0.record()
        for _ in range(ENS_STEPS):
            s = model.step(s, ENS_DT)
        e1.record()
        e1.synchronize()
        serial_ms = e0.elapsed_time(e1) / ENS_STEPS
        ref = grid.interior(s.tracers["c"])
        got = grid.interior(ens.member(states, m).tracers["c"])
        errs[m] = float((got - ref).abs().max() / ref.abs().max())
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    log(f"[17] 17d EnsembleModel: {ENS_MEMBERS} diffusion columns of "
        f"{ENS_LEVELS} levels, float64, {ENS_STEPS} RK3 steps (implicit "
        f"diffusion) by torch.func.vmap on {card}: {ens_ms:.3f} ms a "
        f"batched step against {serial_ms:.3f} ms a serial member's step "
        f"({ENS_MEMBERS * serial_ms / ens_ms:.1f} times the serial "
        f"throughput); states built in {init_s:.2f} s; members "
        f"{list(ENS_CHECKED)} against their serial runs: {errs} of the "
        f"largest value (tolerance {ENS_RTOL:g}); port kernels launched: "
        f"{counts or 'none'}")
    require(all(e <= ENS_RTOL for e in errs.values()),
            f"17d: members against serial runs {errs}")
    require(not counts, f"17d: port kernels launched {counts}")


def output_phase(torch, ot, wrappers, card, dev, ref):
    """Phase 17: output on the card (17a-17d). ``ref`` holds phase 11's
    and phase 9's ms/step."""
    import importlib.util
    import tempfile
    import os
    t_phase = time.perf_counter()
    h5 = importlib.util.find_spec("h5py") is not None
    with tempfile.TemporaryDirectory() as tmp:
        if h5:
            import h5py
            log(f"[17] h5py: present ({h5py.__version__})")
        else:
            log("h5py: absent")
            grid = ot.RectilinearGrid(size=(4, 4, 4),
                                      extent=(1.0, 1.0, 1.0), device=dev)
            sim = ot.Simulation(ot.NonhydrostaticModel(grid=grid), dt=1.0)
            for w in (ot.HDF5Writer({"u": "u"}, os.path.join(tmp, "a.h5"),
                                    ot.IterationInterval(1)),
                      ot.NetCDFWriter({"u": "u"}, os.path.join(tmp, "a.nc"),
                                      ot.IterationInterval(1))):
                try:
                    w.write(sim)
                except ImportError as e:
                    require("h5py" in str(e),
                            f"the ImportError names h5py: {e}")
                else:
                    raise RuntimeError("check failed: a writer wrote "
                                       "without h5py")
            log("[17] h5py is absent: HDF5Writer.write and "
                "NetCDFWriter.write raise an ImportError naming h5py; the "
                "writers below fetch their outputs to the host (cast on "
                "the card, copied) without writing files; checkpoints "
                "(torch.save) are written")
        a = output_main_path(torch, ot, wrappers, card, dev, h5, tmp, ref)
        torch.cuda.empty_cache()
        b = output_hydro(torch, ot, wrappers, card, tmp, ref["hydro_ms"])
        torch.cuda.empty_cache()
        output_cube(torch, ot, wrappers, card, h5, tmp)
        torch.cuda.empty_cache()
        output_ensemble(torch, ot, wrappers, card, dev)
        torch.cuda.empty_cache()
    log(f"[17] phase 17 on {card} in {time.perf_counter() - t_phase:.1f} "
        f"s: 17a {a['ms']:.4f} ms/step with writers (bare loop "
        f"{a['bare_ms']:.4f}; phase 11 {ref['sim_ms']:.4f}), 17b "
        f"{b['ms']:.3f} ms/step with the checkpointer (phase 9 "
        f"{ref['hydro_ms']:.3f})")


# ---------------------------------------------------------------------------
# Phases 18 to 20: immersed boundaries and stretched grids (no port kernel
# lies on their paths: every kernel gate takes only a regular grid of its
# own class, as the JAX gates do)
# ---------------------------------------------------------------------------

#: warm-up and timed steps of phases 18 (seamount), 19 (hydro_vi_bathy and
#: its partial-cell ridge) and 20 (les_stretched)
SEAMOUNT_WARM, SEAMOUNT_STEPS = 2, 10
BATHY_WARM, BATHY_STEPS = 2, 10
RIDGE_WARM, RIDGE_STEPS = 1, 3
STRETCHED_WARM, STRETCHED_STEPS = 2, 10
#: phase 18's float64 card-against-CPU bound: the two CG solves each stop
#: within reltol = 1e-8 of ‖b‖, and a step's velocities move by Δt∇δp with
#: ‖Gδp‖ ≤ 2·reltol·‖b‖; 10·reltol of each group's largest value
SEAMOUNT_F64_RTOL = 1e-7


def zero_launches(wrappers):
    """Every port kernel's launch count, printed; all must be 0."""
    return {k: fn.launches for k, fn in wrappers.items()}


def profile_line(torch, model, state, dt, tag):
    """Device-busy ms, launches and wall ms of a step under
    ``torch.profiler`` (``PROFILE_STEPS`` steps from ``state``), for a log
    line."""
    busy, n_launch, wall = cube_profile(torch, model, state, dt, tag)
    return busy, n_launch, wall, (
        f"under torch.profiler, {PROFILE_STEPS} steps: device-busy "
        f"{busy:.3f} ms/step in a wall of {wall:.3f} ms/step, idle share {1 - busy / wall:.3f}; "
        f"{n_launch:.0f} kernel launches a step")


def seamount_phase(torch, ot, wrappers, card):
    """Phase 18: ``seamount``, the JAX package's
    ``examples/flow_over_seamount.py`` in 3-D at 256 x 256 x 128 (WENO(5),
    BuoyancyTracer with N² = 1, u = 0.1, Δt = 0.02, AB2, float32): 2 + 10
    steps timed and profiled, the CG iterations and host reads of the
    convergence flag of each step, no port kernel launched; finite fields,
    velocities exactly zero on solid faces, flow over the seamount
    (max|w| > 0), and max|∇·u| over the fluid within the bound the
    solver's reltol sets; and a float64 (32, 32, 16) run on the card
    against the CPU."""
    import warnings

    from oceananigans_torch.ops.operators import divergence_ccc
    from oceananigans_torch.profile_step import (
        SEAMOUNT_DT, seamount_initial_state, seamount_model,
    )
    dt = SEAMOUNT_DT
    model = seamount_model()
    g = model.grid
    solver = model.pressure_solver
    require(isinstance(g, ot.ImmersedBoundaryGrid)
            and model.fused_kernels is False and not model.fused_tracer
            and isinstance(solver, ot.ImmersedPoissonSolver)
            and solver.preconditioner is not None,
            "seamount: the plain path with FFT-preconditioned CG")
    state = seamount_initial_state(model)
    its, syncs = [], []

    def each(m):
        its.append(m.pressure_solver.iterations)
        syncs.append(m.pressure_solver.host_syncs)

    total = SEAMOUNT_WARM + SEAMOUNT_STEPS
    state, ms, enqueue = cube_run(torch, model, state, dt, SEAMOUNT_WARM,
                                  SEAMOUNT_STEPS, wrappers, "seamount",
                                  each=each)
    counts = zero_launches(wrappers)
    its = [int(i) for i in its]
    from oceananigans_torch.solvers.conjugate_gradient import CHECK_EVERY
    k = CHECK_EVERY
    log(f"[18] seamount on {card}: {' x '.join(map(str, g.N))} float32, "
        f"{float(g.fluid_fraction):.4f} of the cells fluid; {ms:.3f} ms/step "
        f"(steps {SEAMOUNT_WARM + 1} to {total} of AB2, CUDA events); host "
        f"enqueue {enqueue:.3f} ms/step; CG iterations of each step {its} "
        f"(reltol {solver.reltol:g}, FFT preconditioner); host syncs a step "
        f"{syncs} (the CG's reads of its convergence flag, one every {k} "
        f"iterations); port kernel launches {counts}")
    busy, n_launch, wall, line = profile_line(torch, model, state, dt,
                                              "seamount")
    log(f"[18] seamount {line}; against the unprofiled {ms:.3f} ms/step, "
        f"idle share {1 - busy / ms:.3f}")

    # the divergence after a projection, against its bound: on a fluid
    # cell it is Δt (r + b̄)/V, with r the CG residual of G p = b
    # (‖r‖ ≤ reltol·‖b‖, b = V∇·u*/Δt less its fluid mean b̄, itself a
    # rounding term), plus the float32 rounding of the projection (phase
    # 12's floor)
    seen = {}
    solve = solver.solve

    def recording(rhs):
        seen["rhs"] = rhs
        return solve(rhs)

    # one more step with the recording solve, its host synchronizations
    # counted by torch's sync debug mode
    solver.solve = recording
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = model.step(state, dt)
    torch.cuda.set_sync_debug_mode("default")
    del solver.solve
    n_sync = sum("synchroniz" in str(w.message) for w in caught)
    log(f"[18] seamount: one more step under torch.cuda.set_sync_debug_mode"
        f": {n_sync} synchronizing calls (the CG's flag reads "
        f"{solver.host_syncs}, iterations {int(solver.iterations)})")
    sysm = solver.system
    ii = g.interior_slices
    full = torch.zeros(g.shape, dtype=torch.float64, device=g.device)
    full[ii] = seen.pop("rhs").double()
    Vw = sysm.Vw.double()
    b = torch.where(sysm.fluid, full * Vw, 0.0)
    b = torch.where(sysm.fluid, b - b[ii].sum() / sysm.nf, 0.0)
    vmin = float(Vw[sysm.fluid].min())
    fluid = sysm.fluid
    div = divergence_ccc(g, state.u, state.v, state.w)
    div_max = float(div[fluid].abs().max())
    pmax = float(g.interior(state.pressure).abs().max())
    eps32 = float(torch.finfo(torch.float32).eps)
    dz = 2.0 / g.N[2]
    floor = math.log2(g.N[0] * g.N[1] * g.N[2]) * eps32 * dt * pmax / dz ** 2
    cg_part = dt * solver.reltol * float(torch.linalg.vector_norm(b)) / vmin
    bound = cg_part + floor
    w_max = float(state.w[fluid].abs().max())
    solid_zero = all(not bool(getattr(state, n)[m].any()) for n, m in (
        ("u", g.solid_u), ("v", g.solid_v), ("w", g.solid_w)))
    require(all(bool(torch.isfinite(q).all()) for q in state.fields().values())
            and solid_zero, "seamount: finite, and zero on solid faces")
    require(w_max > 1e-3, f"seamount: flow over the seamount, max|w| "
            f"{w_max:.3e}")
    log(f"[18] seamount after {total + 1} steps: u, v, w exactly 0 on every "
        f"solid face; max|w| {w_max:.4e} over the fluid; max|∇·u| over the "
        f"fluid {div_max:.3e}, held to Δt·reltol·‖b‖₂/min V = "
        f"{cg_part:.3e} (the CG's stopping residual) + log2(N³)·eps32·Δt·"
        f"max|p|/Δz² = {floor:.3e} (phase 12's rounding floor, max|p| "
        f"{pmax:.4e}) = {bound:.3e}")
    require(div_max <= bound, f"seamount max|div| {div_max:.3e} <= "
            f"{bound:.3e}")
    out = {"ms": ms, "enqueue": enqueue, "busy": busy, "launches": n_launch,
           "wall": wall, "iterations": its, "syncs": syncs,
           "sync_calls": n_sync, "div": div_max, "bound": bound}
    del model, state, b, full, Vw, div, sysm
    torch.cuda.empty_cache()

    # float64 (32, 32, 16): the card against the CPU
    runs, counts64 = {}, {}
    for device in ("cuda", "cpu"):
        m = seamount_model((32, 32, 16), torch.float64, device)
        st = seamount_initial_state(m)
        seen_its = []
        for _ in range(3):
            st = m.step(st, dt)
            seen_its.append(int(m.pressure_solver.iterations))
        counts64[device] = seen_its
        gg = m.grid
        runs[device] = {"velocities": [gg.interior(st.u), gg.interior(st.v),
                                       gg.interior(st.w)],
                        "b": [gg.interior(st.tracers["b"])]}
    rel = {k: group_rel([(a, b2) for a, b2 in zip(runs["cuda"][k],
                                                  runs["cpu"][k])])
           for k in runs["cuda"]}
    log(f"[18] float64 (32, 32, 16) seamount, 3 AB2 steps: the card vs the "
        f"CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" of the largest value (tolerance {SEAMOUNT_F64_RTOL:g}: 10 × "
        f"reltol 1e-8); CG iterations card {counts64['cuda']}, CPU "
        f"{counts64['cpu']}")
    require(all(v <= SEAMOUNT_F64_RTOL for v in rel.values()),
            f"float64 seamount card vs CPU {rel}")
    out["rel64"] = rel
    return out


def bathy_phase(torch, ot, wrappers, card):
    """Phase 19: ``hydro_vi_bathy``, phase 14's ``hydro_vi_latlon``
    (360 x 160 x 60, 1°, 80°S-80°N, 4 km) on an ``ImmersedBoundaryGrid``
    with ``bench.py``'s continents as a ``GridFittedBottom``: the plain
    path (the kernels refuse the grid, as in the JAX package), 2 + 10
    steps in float32 timed and profiled, the volume held to the float32
    rounding of η's substeps; ``hydro_vi`` over a Gaussian ridge in
    partial cells for 1 + 3 steps; in float64 at full width, 3 steps with
    the volume to 1e-12 of Σ|η|·Az and T and S exactly 0 in solid cells;
    and the (24, 16, 8) sector of the card against the CPU."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_initial_state, hydro_latlon_initial_state,
        hydro_latlon_model, hydro_model, latlon_continents, ridge_bottom,
        volume_drift,
    )
    dt = HYDRO_DT

    def solid_tracers_zero(model, st):
        solid = model.grid.solid_c
        return all(not bool(c[solid].any()) for c in st.tracers.values())

    model = hydro_latlon_model("auto", bathymetry=latlon_continents)
    g = model.grid
    require(isinstance(g, ot.ImmersedBoundaryGrid)
            and not model.fused_kernels and not model.fused_tracer,
            "hydro_vi_bathy: the kernels refuse the immersed grid")
    state = model.update_state(hydro_latlon_initial_state(model))
    eta0 = state.eta.clone()
    total = BATHY_WARM + BATHY_STEPS
    state, ms, enqueue = cube_run(torch, model, state, dt, BATHY_WARM,
                                  BATHY_STEPS, wrappers, "hydro_vi_bathy")
    counts = zero_launches(wrappers)
    drift = volume_drift(model, eta0, state.eta)
    substeps = len(model.free_surface.weights)
    vbound = total * substeps * float(torch.finfo(torch.float32).eps)
    require(drift <= vbound, f"hydro_vi_bathy volume drift {drift:.3e}")
    require(solid_tracers_zero(model, state),
            "hydro_vi_bathy: T and S zero in solid cells")
    xy = g.interior_slices[:2]
    log(f"[19] hydro_vi_bathy on {card}: {' x '.join(map(str, g.N))} "
        f"float32 with "
        f"continents, {float(g.fluid_fraction):.4f} of the cells fluid; "
        f"{ms:.3f} ms/step (steps {BATHY_WARM + 1} to {total} of AB2, CUDA "
        f"events); host enqueue {enqueue:.3f} ms/step; port kernel launches "
        f"{counts}; max|u| {float(g.interior(state.u).abs().max()):.4e}, "
        f"max|eta| {float(state.eta[xy].abs().max()):.4e}; volume drift "
        f"{drift:.3e} of sum|eta| Az (float32 bound {vbound:.3e}); T and S "
        f"exactly 0 in solid cells")
    busy, n_launch, wall, line = profile_line(torch, model, state, dt,
                                              "hydro_vi_bathy")
    log(f"[19] hydro_vi_bathy {line}; against the unprofiled {ms:.3f} "
        f"ms/step, idle share {1 - busy / ms:.3f}")
    out = {"ms": ms, "enqueue": enqueue, "busy": busy,
           "launches": n_launch, "wall": wall, "drift": drift}
    del model, state, eta0
    torch.cuda.empty_cache()

    # hydro_vi over a partial-cell ridge (Jacobi-free: no pressure solve;
    # the scaled heights enter every metric)
    model = hydro_model("auto", bottom=ridge_bottom())
    require(model.grid.dz_sigma is not None and not model.fused_kernels
            and not model.fused_tracer, "ridge: partial cells, no kernel")
    state = model.update_state(hydro_initial_state(model))
    state, rms, renq = cube_run(torch, model, state, dt, RIDGE_WARM,
                                RIDGE_STEPS, wrappers, "hydro_vi ridge")
    require(solid_tracers_zero(model, state),
            "ridge: T and S zero in solid cells")
    rg = model.grid
    log(f"[19] hydro_vi over a PartialCellBottom ridge on {card}: "
        f"{float(rg.fluid_fraction):.4f} of the cells fluid, partial cells "
        f"down to {float(rg.dz_sigma.min()):.3f} of their height; "
        f"{rms:.3f} ms/step (steps {RIDGE_WARM + 1} to "
        f"{RIDGE_WARM + RIDGE_STEPS}); host enqueue {renq:.3f} ms/step; port "
        f"kernel launches {zero_launches(wrappers)}; max|u| "
        f"{float(rg.interior(state.u).abs().max()):.4e}")
    out["ridge_ms"] = rms
    del model, state
    torch.cuda.empty_cache()

    # float64 at full width: the volume and the solid cells
    model = hydro_latlon_model("auto", torch.float64,
                               bathymetry=latlon_continents)
    state = model.update_state(hydro_latlon_initial_state(model))
    eta0 = state.eta.clone()
    state, ms64, _ = cube_run(torch, model, state, dt, 0, 3, wrappers,
                              "hydro_vi_bathy float64")
    drift64 = volume_drift(model, eta0, state.eta)
    require(drift64 <= VOLUME_RTOL, f"float64 hydro_vi_bathy volume drift "
            f"{drift64:.3e}")
    require(solid_tracers_zero(model, state),
            "float64 hydro_vi_bathy: T and S zero in solid cells")
    log(f"[19] float64 hydro_vi_bathy at full width, 3 AB2 steps: "
        f"{ms64:.3f} ms/step; volume drift {drift64:.3e} of sum|eta| Az "
        f"(tolerance {VOLUME_RTOL:g}); T and S exactly 0 in solid cells")
    del model, state, eta0
    torch.cuda.empty_cache()

    # float64 at a (24, 16, 8) sector: the card against the CPU
    f64 = {}
    for device in ("cuda", "cpu"):
        m = hydro_latlon_model("auto", torch.float64, device,
                               size=(24, 16, 8), longitude=(-60.0, 60.0),
                               latitude=(-80.0, 80.0), halo=6,
                               bathymetry=latlon_continents)
        st = hydro_latlon_initial_state(m, generic=True)
        for _ in range(3):
            st = m.step(st, dt)
        f64[device] = (m.grid, st)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    xy = gp.interior_slices[:2]
    groups = {"velocities": [(gk.interior(sk.u).cpu(), gp.interior(sp.u)),
                             (gk.interior(sk.v).cpu(), gp.interior(sp.v))],
              "w": [(gk.interior(sk.w).cpu(), gp.interior(sp.w))],
              "eta": [(sk.eta[xy].cpu(), sp.eta[xy])],
              "tracers": [(gk.interior(sk.tracers[n]).cpu(),
                           gp.interior(sp.tracers[n])) for n in ("T", "S")]}
    rel64 = {k: group_rel(p) for k, p in groups.items()}
    log("[19] float64 (24, 16, 8) sector with continents, 3 AB2 steps: the "
        "card vs the CPU: " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in rel64.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel64.values()),
            f"float64 hydro_vi_bathy sector card vs CPU {rel64}")
    out["rel64"] = rel64
    return out


def les_stretched_phase(torch, ot, wrappers, card):
    """Phase 20: ``les_stretched``, phase 12's 256³ LES on the stretched z
    of ``examples/wind_mixing_and_convection.py``, z_k = -Lz (1 - k/Nz)^1.2:
    the Fourier-tridiagonal projection and WENO(5)'s z tables on the plain
    path, 2 + 10 steps timed and profiled, the Poisson solve timed alone,
    max|∇·u| held to phase 12's rounding floor at the smallest Δz; and a
    float64 (32, 32, 24) run on the card against the CPU."""
    from oceananigans_torch.ops.operators import divergence_ccc
    N, Lz = 256, 32.0

    def zfaces(n):
        return lambda k: -Lz * (1 - k / n) ** 1.2

    model = les_model(torch, ot, "auto", N=N, z=zfaces(N))
    g = model.grid
    require(not g.z_regular and model.fused_kernels is False
            and not model.fused_tracer
            and isinstance(model.pressure_solver,
                           ot.FourierTridiagonalPoissonSolver)
            and model.advection._tables,
            "les_stretched: the plain path, Fourier-tridiagonal, tables")
    state = les_state(model)
    total = STRETCHED_WARM + STRETCHED_STEPS
    state, ms, enqueue = cube_run(torch, model, state, LES_DT,
                                  STRETCHED_WARM, STRETCHED_STEPS, wrappers,
                                  "les_stretched")
    counts = zero_launches(wrappers)
    dz_min = float(g.min_spacing(2))
    log(f"[20] les_stretched on {card}: {N}^3 float32, Δz from {dz_min:.4f}"
        f" m at the surface to {float(g.dz('c')[0, 0, g.H[2]]):.4f} m at the "
        f"bottom; {ms:.3f} ms/step (steps {STRETCHED_WARM + 1} to {total} of "
        f"AB2, CUDA events); host enqueue {enqueue:.3f} ms/step; port kernel "
        f"launches {counts}")
    busy, n_launch, wall, line = profile_line(torch, model, state, LES_DT,
                                              "les_stretched")
    log(f"[20] les_stretched {line}; against the unprofiled {ms:.3f} "
        f"ms/step, idle share {1 - busy / ms:.3f}")
    rhs = g.interior(divergence_ccc(g, state.u, state.v, state.w))
    solver = model.pressure_solver
    solver.solve(rhs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson_ms = time_ms(torch, lambda: solver.solve(rhs), 5)
    enq_solve = (time.perf_counter() - t0) * 1e3 / 5
    solve_busy, solve_launches, solve_wall = device_profile(
        torch, lambda: solver.solve(rhs), PROFILE_STEPS)
    log(f"[20] les_stretched Poisson solve (Fourier-tridiagonal, {g.N[2]} "
        f"levels): {poisson_ms:.3f} ms (CUDA events, 5 calls; host "
        f"{enq_solve:.3f} ms a call); under torch.profiler device-busy "
        f"{solve_busy:.3f} ms in a wall of {solve_wall:.3f} ms, "
        f"{solve_launches:.0f} kernel launches a solve")
    pmax = float(g.interior(state.pressure).abs().max())
    eps32 = float(torch.finfo(torch.float32).eps)
    div = float(g.interior(divergence_ccc(g, state.u, state.v,
                                          state.w)).abs().max())
    bound = math.log2(N ** 3) * eps32 * LES_DT * pmax / dz_min ** 2
    require(all(bool(torch.isfinite(q).all())
                for q in state.fields().values()),
            "les_stretched: finite fields")
    log(f"[20] les_stretched after {total} steps: max|u| "
        f"{float(g.interior(state.u).abs().max()):.4e}, max|w| "
        f"{float(g.interior(state.w).abs().max()):.4e}; max|∇·u| {div:.3e}, "
        f"held to log2(N³)·eps32·Δt·max|p|/Δz_min² = {bound:.3e} (max|p| "
        f"{pmax:.4f})")
    require(div <= bound, f"les_stretched max|div| {div:.3e} <= "
            f"{bound:.3e}")
    out = {"ms": ms, "enqueue": enqueue, "busy": busy,
           "launches": n_launch, "wall": wall, "poisson_ms": poisson_ms,
           "poisson_launches": solve_launches, "div": div, "bound": bound}
    del model, state, rhs, solver
    torch.cuda.empty_cache()

    # float64 (32, 32, 24): the card against the CPU
    f64 = {}
    for device in ("cuda", "cpu"):
        m = les_model(torch, ot, "auto", N=32, Nz=24, dtype=torch.float64,
                      device=device, z=zfaces(24))
        s = les_state(m)
        for _ in range(3):
            s = m.step(s, LES_DT)
        f64[device] = (m.grid, s)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    ub = balance_scale(gp, sp, LES_DT)
    vel = group_rel([(gk.interior(a).cpu(), gp.interior(b)) for a, b in (
        (sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w))], ub)
    trc = group_rel([(gk.interior(sk.tracers["T"]).cpu(),
                      gp.interior(sp.tracers["T"]))])
    log(f"[20] float64 (32, 32, 24) les_stretched, 3 AB2 steps: the card vs "
        f"the CPU: velocities {vel:.3e} of max(max|u|, Δt max|∂z p|), T "
        f"{trc:.3e} of max|T| (tolerance 1e-12)")
    require(vel <= 1e-12 and trc <= 1e-12,
            f"float64 les_stretched card vs CPU {vel:.3e}, {trc:.3e}")
    out["rel64"] = {"velocities": vel, "T": trc}
    return out


# ---------------------------------------------------------------------------
# Phases 21 and 22: forcings, background fields, Stokes drift,
# biogeochemistry, particles and the ocean closures
# ---------------------------------------------------------------------------

#: phase 21: ``examples/langmuir_turbulence.py`` at 256³ with a sinking,
#: growing tracer P and 2²⁰ particles tracking b; 2 + 10 steps a path
LANGMUIR_WARM, LANGMUIR_TIMED, LANGMUIR_PARTICLES = 2, 10, 2 ** 20
#: 21b and 21c: ``bench.py``'s ``weno`` cell with a sponge, then with
#: background fields, 1 + 3 steps a path at its Δt
SPONGE_WARM, SPONGE_STEPS, SPONGE_DT = 1, 3, 1e-4
#: phase 22: ``hydro_vi_latlon`` with CATKE, 2 + 10 steps a path
CATKE_WARM, CATKE_STEPS = 2, 10


def run_counted(torch, model, state, dt, warm, steps, wrappers, want, tag):
    """``warm`` + ``steps`` steps with the launch counts zeroed first:
    (state, ms/step, host enqueue ms/step, the counts of every kernel).
    Each kernel of ``want`` must launch that many times a step, every
    other kernel never; every field must be finite."""
    for fn in wrappers.values():
        fn.launches = 0
    for _ in range(warm):
        state = model.step(state, dt, assume_filled=True)
    state, ms, enqueue = timed_steps(torch, model, state, dt, steps)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    expected = {k: want.get(k, 0) * (warm + steps) for k in wrappers}
    require(counts == expected, f"{tag} launches {counts}, expected "
            f"{expected}")
    require(all(bool(torch.isfinite(q).all())
                for q in state.fields().values()), f"{tag}: finite fields")
    return state, ms, enqueue, counts


def count_syncs(torch, fn):
    """The host synchronizations of ``fn()``, counted by torch's sync
    debug mode."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def particle_rel(sk, sp):
    """Positions and properties of two particle states: the largest
    difference relative to the largest value of each."""
    pk, pp = sk.particles, sp.particles
    pairs = [(pk.x, pp.x), (pk.y, pp.y), (pk.z, pp.z)]
    pairs += [(pk.properties[k], pp.properties[k]) for k in pp.properties]
    return max(group_rel([(a, b)]) for a, b in pairs)


def langmuir_phase(torch, ot, wrappers, card):
    """Phase 21: ``langmuir``, the Langmuir LES at 256³ (Stokes drift, AMD,
    the example's fluxes, a growing and sinking P, 2²⁰ particles) on the
    kernel path (kernels 7 and 9 once a step; no fused AB2 kernel, no
    any-order tracer kernel) and on the plain path: step times, the
    device-busy time, the host syncs of a step, the launches; the
    float32 divergence held to its rounding floor, the paths to each other
    in float64 at full width, a float64 16³ run on the card against the
    CPU; then 21b (``weno`` with a sponge) and 21c (``weno`` with
    background fields)."""
    from oceananigans_torch.ops.operators import divergence_ccc
    from oceananigans_torch.profile_step import (
        LANGMUIR_DT, langmuir_initial_state, langmuir_model,
        langmuir_particles,
    )
    dt = LANGMUIR_DT
    want = {"weno5_momentum_tendency": 1, "weno5_tracer_tendencies": 1}
    out, finals = {}, {}
    total = LANGMUIR_WARM + LANGMUIR_TIMED
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = langmuir_model(fused=fused, particles=langmuir_particles(
            LANGMUIR_PARTICLES))
        require((model.fused_kernels == "weno5") == (path == "kernel")
                and not (model.fused_ab2_weno or model.fused_ab2_weno_science
                         or model.fused_tracer),
                f"langmuir {path} path selects fused_kernels="
                f"{model.fused_kernels}, no fused AB2 kernel, no any-order "
                "tracer kernel")
        g = model.grid
        state = model.fill_state_halos(langmuir_initial_state(model))
        state, ms, enqueue, counts = run_counted(
            torch, model, state, dt, LANGMUIR_WARM, LANGMUIR_TIMED, wrappers,
            want if path == "kernel" else {}, f"langmuir {path} path")
        p = state.particles
        inside = bool(((p.z >= -64.0) & (p.z <= 0.0) & (p.x >= 0.0)
                       & (p.x <= 128.0) & (p.y >= 0.0)
                       & (p.y <= 128.0)).all())
        require(inside and all(bool(torch.isfinite(q).all()) for q in (
            p.x, p.y, p.z, p.properties["b"])),
            f"langmuir {path} path: the particles are finite and inside")
        state, syncs = count_syncs(torch, lambda: model.step(
            state, dt, assume_filled=True))
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, dt, assume_filled=True), PROFILE_STEPS)
        require(busy > 0, f"langmuir {path} path: the profiler saw device "
                "time")
        out[path] = {"ms": ms, "busy": busy, "syncs": syncs,
                     "launches": counts}
        P = g.interior(state.tracers["P"])
        log(f"[21] langmuir {path} path on {card}: {ms:.3f} ms/step at "
            f"256^3 float32 with {len(model.particles)} particles (steps "
            f"{LANGMUIR_WARM + 1} to {total} of AB2, Δt {dt} s, CUDA "
            f"events); host enqueue {enqueue:.3f} ms/step; device-busy "
            f"{busy:.3f} ms/step in a wall of {wall:.3f} under "
            f"torch.profiler (idle share {1 - busy / wall:.3f}; against the "
            f"unprofiled ms, {1 - busy / ms:.3f}), {n_launch:.0f} launches a"
            f" step; host syncs in one step {syncs}; port kernel launches in"
            f" {total} steps {counts}; max|u| "
            f"{float(g.interior(state.u).abs().max()):.4e}, max|w| "
            f"{float(g.interior(state.w).abs().max()):.4e}, P in "
            f"[{float(P.min()):.6f}, {float(P.max()):.6f}], particle b in "
            f"[{float(p.properties['b'].min()):.4e}, "
            f"{float(p.properties['b'].max()):.4e}]")
        finals[path] = (g, state)
        del model
        torch.cuda.empty_cache()
    (g, sk), (_, sp) = finals["kernel"], finals["plain"]
    dz = g.spacing(2)
    pmax = float(g.interior(sp.pressure).abs().max())
    eps32 = torch.finfo(torch.float32).eps
    div_bound = math.log2(g.N[0] * g.N[1] * g.N[2]) * eps32 * dt * pmax \
        / dz ** 2
    divs = {k: float(g.interior(divergence_ccc(g, s.u, s.v, s.w)).abs()
                     .max()) for k, s in (("kernel", sk), ("plain", sp))}
    log(f"[21] langmuir float32 after {total + 1} steps: max|div| kernel "
        f"path {divs['kernel']:.3e}, plain path {divs['plain']:.3e}, held to"
        f" log2(N³)·eps32·Δt·max|p|/Δz² = {div_bound:.3e} (max|p| "
        f"{pmax:.4e}); the float32 paths are held to each other in float64 "
        "below (phase 12's rounding floor)")
    require(max(divs.values()) <= div_bound,
            f"langmuir max|div| {divs} <= {div_bound:.3e}")
    del finals, sk, sp
    torch.cuda.empty_cache()

    # float64 at full width: the paths to each other
    f64 = {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        m = langmuir_model(fused=fused, dtype=torch.float64,
                           particles=langmuir_particles(LANGMUIR_PARTICLES))
        s = langmuir_initial_state(m)
        for _ in range(3):
            s = m.step(s, dt)
        f64[path], g = s, m.grid
        del m
    rel = les_compare_fields(g, f64["kernel"], f64["plain"], dt,
                             ("b", "P"))
    rel["particles"] = particle_rel(f64["kernel"], f64["plain"])
    log(f"[21] langmuir float64 256^3, 3 AB2 steps: kernel vs plain path: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" of the largest value (velocities of max(max|u|, Δt max|∂z p|);"
        f" tolerance {LES_F64_RTOL:g})")
    require(all(v <= LES_F64_RTOL for v in rel.values()),
            f"langmuir float64 kernel vs plain path {rel}")
    del f64
    torch.cuda.empty_cache()

    # float64 16³ with 4096 particles: the card against the CPU
    from oceananigans_torch.interop import flatten_state, unflatten_state
    f64 = {}
    for device in ("cuda", "cpu"):
        m = langmuir_model(size=(16, 16, 16), dtype=torch.float64,
                           device=device, fused=device == "cuda",
                           particles=langmuir_particles(4096))
        require((m.fused_kernels == "weno5") == (device == "cuda"),
                "float64 langmuir routes")
        s = langmuir_initial_state(m)
        for _ in range(5):
            s = m.step(s, dt)
        f64[device] = (m.grid, s)
    gp, sp = f64["cpu"]
    sk = unflatten_state(sp, flatten_state(f64["cuda"][1]))
    rel = les_compare_fields(gp, sk, sp, dt, ("b", "P"))
    rel["particles"] = particle_rel(sk, sp)
    log("[21] float64 16^3 langmuir with 4096 particles, 5 AB2 steps: "
        "kernel path on the card vs plain path on the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel.values()),
            f"float64 16^3 langmuir card vs CPU {rel}")
    del f64, sk, sp
    out["sponge"] = weno_physics_phase(torch, ot, wrappers, card, "sponge")
    out["background"] = weno_physics_phase(torch, ot, wrappers, card,
                                           "background")
    return out


def les_compare_fields(g, sk, sp, dt, tracers):
    """The velocities of ``sk`` against ``sp`` relative to max(max|u|,
    Δt·max|∂z p|), each of ``tracers`` relative to its largest value."""
    ub = balance_scale(g, sp, dt)
    rel = {"velocities": group_rel([(g.interior(a), g.interior(b))
                                    for a, b in ((sk.u, sp.u), (sk.v, sp.v),
                                                 (sk.w, sp.w))], ub)}
    for n in tracers:
        rel[n] = group_rel([(g.interior(sk.tracers[n]),
                             g.interior(sp.tracers[n]))])
    return rel


def weno_physics_model(torch, ot, fused, physics):
    """``bench.py``'s ``weno`` cell (256³, (Bounded, Periodic, Periodic),
    halo (3, 0, 0), WENO(5), T and S, AB2) with ``physics``: "sponge", a
    ``Relaxation`` of u to rest and of T to 0.01 z masked by a
    ``GaussianMask`` along x centred on the Bounded end x = 1 (width
    0.05), at 100 s⁻¹; or "background", background fields U = 0.005
    cos 2πz and T = 0.001 sin 2πy."""
    from oceananigans_torch.profile_step import config_kwargs
    kwargs, halo = config_kwargs("weno")
    grid = ot.RectilinearGrid(
        size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
        topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
        dtype=torch.float32, device="cuda")
    if physics == "sponge":
        mask = ot.GaussianMask(1.0, 0.05, coordinate="x")
        extra = {"forcing": {
            "u": ot.Relaxation(100.0, mask=mask),
            "T": ot.Relaxation(100.0, mask=mask,
                               target=ot.LinearTarget(0.0, 0.01))}}
    else:
        extra = {"background_fields": {
            "u": lambda x, y, z: 0.005 * torch.cos(2 * math.pi * z) + 0 * x,
            "T": lambda x, y, z: 0.001 * torch.sin(2 * math.pi * y)
            + 0 * x * z}}
    return ot.NonhydrostaticModel(grid=grid, timestepper="QuasiAdamsBashforth2",
                                  fused_kernels=fused, **kwargs, **extra)


def weno_physics_phase(torch, ot, wrappers, card, physics):
    """21b (``physics="sponge"``): the ``weno`` cell with a relaxation
    sponge: kernels 7 and 9 once a step, the fused AB2 kernels (6, 8)
    never; the paths held to each other at phase 7's bound. 21c
    (``"background"``): the same cell with background fields of u and T:
    as in the JAX package (whose model selects no kernel under background
    fields), every kernel is refused, the momentum and both tracers run
    plain on both paths, and the two paths are equal bit for bit."""
    from oceananigans_torch.profile_step import initial_state
    tag = {"sponge": "21b", "background": "21c"}[physics]
    want = ({"weno5_momentum_tendency": 1, "weno5_tracer_tendencies": 1}
            if physics == "sponge" else {})
    finals, ms = {}, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = weno_physics_model(torch, ot, fused, physics)
        require(not (model.fused_ab2_weno or model.fused_ab2_weno_science
                     or model.fused_tracer)
                and (model.fused_kernels == "weno5")
                == (path == "kernel" and physics == "sponge"),
                f"[{tag}] {path} path selects fused_kernels="
                f"{model.fused_kernels}, no fused AB2 kernel")
        state = model.fill_state_halos(initial_state(model))
        state, ms[path], _, counts = run_counted(
            torch, model, state, SPONGE_DT, SPONGE_WARM, SPONGE_STEPS,
            wrappers, want if path == "kernel" else {},
            f"[{tag}] {path} path")
        finals[path] = (model.grid, state)
        log(f"[{tag}] weno with {physics} {path} path on {card}: "
            f"{ms[path]:.3f} ms/step at 256^3 float32 ({SPONGE_WARM} + "
            f"{SPONGE_STEPS} AB2 steps); port kernel launches {counts}")
        del model
    (g, sk), (_, sp) = finals["kernel"], finals["plain"]
    pairs = {"velocities": [(g.interior(a), g.interior(b)) for a, b in (
        (sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w))],
        "tracers": [(g.interior(sk.tracers[n]), g.interior(sp.tracers[n]))
                    for n in ("T", "S")]}
    rel = {k: group_rel(v) for k, v in pairs.items()}
    if physics == "sponge":
        log(f"[{tag}] kernel vs plain path: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel.items())
            + " of the largest value (tolerance 3e-05, phase 7's)")
        require(all(v <= 3e-5 for v in rel.values()),
                f"[{tag}] kernel vs plain path {rel}")
    else:
        same = all(torch.equal(a, b) for v in pairs.values() for a, b in v)
        log(f"[{tag}] both paths plain under background fields (the JAX "
            f"model selects no kernel then): equal bit for bit {same}")
        require(same, f"[{tag}] the two plain paths differ: {rel}")
    del finals, sk, sp
    torch.cuda.empty_cache()
    return ms


def catke_phase(torch, ot, wrappers, card, rtol):
    """Phase 22: ``hydro_catke``, phase 14's ``hydro_vi_latlon`` with
    ``CATKEVerticalDiffusivity()`` and a zonal wind stress: 2 + 10 steps on
    each path (kernels 11 and 12/13 once a step, the tracer kernel taking
    T, S and the TKE e; the Thomas solves plain), held to each other at
    phase 14's bounds, timed, with the host syncs of a step; and
    ``examples/baroclinic_adjustment.py`` at its own (60, 60, 10) with a
    destabilizing b surface flux, float64, 3 steps on the card (kernel 11)
    against the CPU."""
    from oceananigans_torch.profile_step import (
        HYDRO_CATKE_DT, baroclinic_adjustment_initial_state,
        baroclinic_adjustment_model, hydro_catke_model,
        hydro_latlon_initial_state,
    )
    dt = HYDRO_CATKE_DT
    want = {"weno_tracer_tendencies": 1, "vi_momentum_tendency": 1}
    out, finals = {}, {}
    total = CATKE_WARM + CATKE_STEPS
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = hydro_catke_model(fused)
        g = model.grid
        require(model.tracer_names == ("T", "S", "e")
                and model.fused_kernels == model.fused_tracer
                == (path == "kernel"),
                f"hydro_catke {path} path: tracers {model.tracer_names}, "
                f"fused_kernels={model.fused_kernels}, "
                f"fused_tracer={model.fused_tracer}")
        state = model.update_state(hydro_latlon_initial_state(model))
        state, ms, enqueue, counts = run_counted(
            torch, model, state, dt, CATKE_WARM, CATKE_STEPS, wrappers,
            want if path == "kernel" else {}, f"hydro_catke {path} path")
        state, syncs = count_syncs(torch, lambda: model.step(
            state, dt, assume_filled=True))
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, dt, assume_filled=True), PROFILE_STEPS)
        out[path] = {"ms": ms, "busy": busy, "syncs": syncs,
                     "launches": counts}
        e = g.interior(state.tracers["e"])
        xy = g.interior_slices[:2]
        log(f"[22] hydro_catke {path} path on {card}: {ms:.3f} ms/step "
            f"(steps {CATKE_WARM + 1} to {total} of AB2, Δt {dt} s, CUDA "
            f"events); host enqueue {enqueue:.3f} ms/step; device-busy "
            f"{busy:.3f} ms/step in a wall of {wall:.3f} under "
            f"torch.profiler (idle share {1 - busy / wall:.3f}; against the "
            f"unprofiled ms, {1 - busy / ms:.3f}), {n_launch:.0f} launches a"
            f" step; host syncs in one step {syncs}; port kernel launches in"
            f" {total} steps {counts}; max|u| "
            f"{float(g.interior(state.u).abs().max()):.4e}, max|eta| "
            f"{float(state.eta[xy].abs().max()):.4e}, e in "
            f"[{float(e.min()):.4e}, {float(e.max()):.4e}]")
        finals[path] = {
            "velocities": [g.interior(state.u), g.interior(state.v)],
            "eta": [state.eta[xy]],
            "tracers": [g.interior(state.tracers[n]) for n in ("T", "S")],
            "e": [e]}
        del model, state
        torch.cuda.empty_cache()
    rel = {k: group_rel(list(zip(finals["kernel"][k], finals["plain"][k])))
           for k in finals["kernel"]}
    log(f"[22] hydro_catke: kernel vs plain path after {total + 1} steps: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + " of the largest value (tolerances " + ", ".join(
            f"{k} {rtol[k]:g}" for k in rtol) + "; e reported, not held: "
        "CATKE switches on signs)")
    require(all(rel[k] <= rtol[k] for k in rtol),
            f"hydro_catke kernel vs plain path {rel}")
    del finals
    torch.cuda.empty_cache()

    # the baroclinic adjustment in float64: the card against the CPU
    f64 = {}
    for device in ("cuda", "cpu"):
        m = baroclinic_adjustment_model(device=device,
                                        fused=device == "cuda")
        require(m.fused_tracer == (device == "cuda"),
                "float64 baroclinic adjustment routes")
        s = baroclinic_adjustment_initial_state(m)
        for _ in range(3):
            s = m.step(s, 600.0)
        f64[device] = (m.grid, s)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    xy = gp.interior_slices[:2]
    groups = {"velocities": [(gk.interior(sk.u).cpu(), gp.interior(sp.u)),
                             (gk.interior(sk.v).cpu(), gp.interior(sp.v))],
              "w": [(gk.interior(sk.w).cpu(), gp.interior(sp.w))],
              "eta": [(sk.eta[xy].cpu(), sp.eta[xy])],
              "b": [(gk.interior(sk.tracers["b"]).cpu(),
                     gp.interior(sp.tracers["b"]))],
              "e": [(gk.interior(sk.tracers["e"]).cpu(),
                     gp.interior(sp.tracers["e"]))]}
    rel64 = {k: group_rel(p) for k, p in groups.items()}
    log("[22] float64 baroclinic adjustment (60, 60, 10) with a b surface "
        "flux of 1e-8, 3 AB2 steps of 600 s: kernel path on the card vs "
        "plain path on the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel64.items())
        + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel64.values()),
            f"float64 baroclinic adjustment card vs CPU {rel64}")
    out["rel"], out["rel64"] = rel, rel64
    return out


# ---------------------------------------------------------------------------
# Phases 23 to 26: the implicit free surface, split RK3 with the
# bound-preserving limiters, and z-star
# ---------------------------------------------------------------------------

#: phase 23: ``hydro_implicit``, 2 + 10 steps a path; 23b the "matrix" and
#: "cg" methods beside "fft", 1 + 3 steps each
IMPLICIT_WARM, IMPLICIT_STEPS, IMPLICIT_B_STEPS = 2, 10, 4
#: the float64 card-against-CPU runs of the CG methods stop at a fixed
#: iteration count (ROADMAP caveat 10: CG agrees across devices only to
#: rounding, which a tolerance test turns into a different count)
FIXED_CG_ITERATIONS = 20
#: phase 24: ``hydro_split_rk3``, 2 + 10 steps a path of each limiter
SPLIT_RK3_WARM, SPLIT_RK3_STEPS = 2, 10
#: phase 25: ``hydro_zstar``, 2 + 10 steps; phase 26: the cube, 2 + 10
ZSTAR_WARM, ZSTAR_STEPS = 2, 10
CS_IMPLICIT_WARM, CS_IMPLICIT_STEPS = 2, 10
EPS32 = 1.1920928955078125e-07


def hydro_groups(g, st, tracers):
    """Interior views of a hydrostatic state's u and v, w, η and
    ``tracers``, grouped as the comparisons take them."""
    xy = g.interior_slices[:2]
    return {"velocities": [g.interior(st.u), g.interior(st.v)],
            "w": [g.interior(st.w)], "eta": [st.eta[xy]],
            "tracers": [g.interior(st.tracers[n]) for n in tracers]}


def card_vs_cpu(make, init, steps, dt, tracers, scales=None):
    """``steps`` float64 steps of ``make(device)`` on the card and on the
    CPU from ``init(model)``: each group's difference relative to its
    largest CPU value (or to ``scales[group]`` where that is larger;
    ``scales`` a dict, or a function of the CPU model and state giving
    one); and the two final states."""
    runs = {}
    for device in ("cuda", "cpu"):
        m = make(device)
        st = init(m)
        for _ in range(steps):
            st = m.step(st, dt)
        runs[device] = (m, st)
    (mk, sk), (mp, sp) = runs["cuda"], runs["cpu"]
    gk, gp = hydro_groups(mk.grid, sk, tracers), hydro_groups(mp.grid, sp,
                                                              tracers)
    if callable(scales):
        scales = scales(mp, sp)
    rel = {k: group_rel([(a.cpu(), b) for a, b in zip(gk[k], gp[k])],
                        (scales or {}).get(k, 0.0)) for k in gp}
    return rel, runs


def path_rel(finals, scales=None):
    """The kernel path's groups against the plain path's, relative to the
    largest plain value (or to ``scales[group]`` where larger)."""
    return {k: group_rel(list(zip(finals["kernel"][k], finals["plain"][k])),
                         (scales or {}).get(k, 0.0))
            for k in finals["kernel"]}


def implicit_phase(torch, ot, wrappers, card, rtol):
    """Phase 23: ``hydro_implicit``, phase 9's ``hydro_vi`` with the
    implicit free surface ("fft": DCT-II in y, FFT in x, cuFFT): 2 + 10
    steps on each path (kernels 11 and 12/13 once a step), held to each
    other at phase 9's bounds, timed, with the device-busy time, idle
    share and host syncs a step; 23b the "matrix" (Jacobi-preconditioned
    stencil matrix) and "cg" methods at JAX's defaults (maxiter 200,
    reltol 1e-9), 1 + 3 steps each with their CG iterations and host
    reads of the convergence flag a solve, η of the three methods held to
    each other at the bound derived below; and float64 (48, 16, 6) runs on
    the card against the CPU: "fft" to 1e-12, "matrix" and "cg" at
    :data:`FIXED_CG_ITERATIONS` iterations to 1e-12."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_generic_state, hydro_implicit_model,
        hydro_initial_state,
    )
    dt = HYDRO_DT
    want = {"weno_tracer_tendencies": 1, "vi_momentum_tendency": 1}
    total = IMPLICIT_WARM + IMPLICIT_STEPS
    out, finals = {}, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = hydro_implicit_model(fused)
        require(model.fused_kernels == model.fused_tracer
                == (path == "kernel"),
                f"hydro_implicit {path} path: fused_kernels="
                f"{model.fused_kernels}, fused_tracer={model.fused_tracer}")
        state = model.update_state(hydro_initial_state(model))
        state, ms, enqueue, counts = run_counted(
            torch, model, state, dt, IMPLICIT_WARM, IMPLICIT_STEPS, wrappers,
            want if path == "kernel" else {}, f"hydro_implicit {path} path")
        state, syncs = count_syncs(torch, lambda: model.step(
            state, dt, assume_filled=True))
        busy, n_launch, wall = device_profile(
            torch, lambda: model.step(state, dt, assume_filled=True), PROFILE_STEPS)
        out[path] = {"ms": ms, "busy": busy, "syncs": syncs,
                     "launches": n_launch, "counts": counts}
        g = model.grid
        xy = g.interior_slices[:2]
        log(f"[23] hydro_implicit {path} path on {card}: "
            f"{model.free_surface!r}, {ms:.3f} ms/step (steps "
            f"{IMPLICIT_WARM + 1} to {total} of AB2, Δt {dt} s, CUDA "
            f"events); host enqueue {enqueue:.3f} ms/step; device-busy "
            f"{busy:.3f} ms/step in a wall of {wall:.3f} under "
            f"torch.profiler (idle share {1 - busy / wall:.3f}; against the "
            f"unprofiled ms, {1 - busy / ms:.3f}), {n_launch:.0f} launches a"
            f" step; host syncs in one step {syncs}; port kernel launches in"
            f" {total} steps {counts}; max|u| "
            f"{float(g.interior(state.u).abs().max()):.4e}, max|eta| "
            f"{float(state.eta[xy].abs().max()):.4e}")
        grp = hydro_groups(g, state, ("T", "S"))
        finals[path] = {k: grp[k] for k in ("velocities", "eta", "tracers")}
        del model, state
        torch.cuda.empty_cache()
    rel = path_rel(finals)
    log(f"[23] hydro_implicit: kernel vs plain path after {total + 1} "
        "steps: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + " of the largest value (tolerances " + ", ".join(
            f"{k} {rtol[k]:g}" for k in rtol) + ")")
    require(all(rel[k] <= rtol[k] for k in rtol),
            f"hydro_implicit kernel vs plain path {rel}")
    del finals
    torch.cuda.empty_cache()

    # 23b: the three methods from one state, JAX's defaults
    etas, kappa = {}, None
    for method in ("fft", "matrix", "cg"):
        model = hydro_implicit_model("auto", solver_method=method)
        fs = model.free_surface
        state = model.update_state(hydro_initial_state(model))
        for fn in wrappers.values():
            fn.launches = 0
        state = model.step(state, dt, assume_filled=True)
        its, syncs = [model.free_surface_info.get("iterations")], [
            model.free_surface_info.get("host_syncs")]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(IMPLICIT_B_STEPS - 1):
            state = model.step(state, dt, assume_filled=True)
            its.append(model.free_surface_info.get("iterations"))
            syncs.append(model.free_surface_info.get("host_syncs"))
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / (IMPLICIT_B_STEPS - 1)
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        require(counts == {k: IMPLICIT_B_STEPS for k in want},
                f"hydro_implicit {method}: launches {counts}")
        state, step_syncs = count_syncs(torch, lambda: model.step(
            state, dt, assume_filled=True))
        if method == "fft":
            den = model._fs_denominator(fs, dt).abs()
            kappa = float(den.max() / den.min())
            cg = "no CG"
        else:
            cg = (f"CG iterations a solve {[int(i) for i in its]} (maxiter "
                  f"{fs.maxiter}, reltol {fs.reltol:g}), host reads of the "
                  f"convergence flag a solve {syncs}")
        g = model.grid
        xy = g.interior_slices[:2]
        etas[method] = state.eta[xy].clone()
        log(f"[23b] hydro_implicit solver_method={method!r} on {card}: "
            f"{ms:.3f} ms/step (steps 2 to {IMPLICIT_B_STEPS}, CUDA "
            f"events); {cg}; host syncs in one step {step_syncs}; port "
            f"kernel launches in {IMPLICIT_B_STEPS} steps {counts}")
        out[method] = {"ms": ms, "iterations": [
            int(i) for i in its if i is not None], "syncs": step_syncs}
        del model, state
        torch.cuda.empty_cache()
    # each solve's error is within κ (the operator's condition number, from
    # its eigenvalue table) times the rounding of its passes: the DCT/FFT
    # chain's log2 N butterflies (~10), or a converged CG's iterations of
    # rounding-level steps (√maxiter of them adding at random); two
    # methods' errors add, and each step's error enters the next
    steps = IMPLICIT_B_STEPS + 1
    eta_bound = steps * 2 * (10 + math.sqrt(200)) * kappa * EPS32
    eta_rel = {m: group_rel([(etas[m], etas["fft"])])
               for m in ("matrix", "cg")}
    log(f"[23b] eta of the three methods after {steps} steps: "
        + ", ".join(f"{m} vs fft {v:.3e}" for m, v in eta_rel.items())
        + f" of the largest value (bound {eta_bound:.3e} = {steps} steps x "
        f"2 methods x (10 + sqrt(200)) passes x kappa {kappa:.4f} x the "
        "float32 epsilon)")
    require(all(v <= eta_bound for v in eta_rel.values()),
            f"hydro_implicit methods' eta {eta_rel}")

    # float64 (48, 16, 6): the card against the CPU
    rel64 = {}
    for method in ("fft", "matrix", "cg"):
        kw = ({} if method == "fft" else dict(
            solver_method=method, maxiter=FIXED_CG_ITERATIONS, reltol=0.0))
        rel64[method], _ = card_vs_cpu(
            lambda device: hydro_implicit_model(
                "auto", torch.float64, device, size=(48, 16, 6), **kw),
            hydro_generic_state, 5, dt, ("T", "S"))
        log(f"[23] float64 (48, 16, 6) hydro_implicit {method!r}"
            + ("" if method == "fft" else
               f" at {FIXED_CG_ITERATIONS} CG iterations a solve")
            + ", 5 AB2 steps: kernel path on the card vs plain path on the "
            "CPU: " + ", ".join(f"{k} {v:.3e}"
                                for k, v in rel64[method].items())
            + " of the largest value (tolerance 1e-12)")
    require(all(v <= 1e-12 for r in rel64.values() for v in r.values()),
            f"float64 hydro_implicit card vs CPU {rel64}")
    out["rel"], out["rel64"], out["eta_rel"] = rel, rel64, eta_rel
    return out


def split_rk3_phase(torch, ot, wrappers, card, rtol):
    """Phase 24: ``hydro_split_rk3``, phase 9's grid and momentum stepped by
    ``split_rk3`` with the split-explicit free surface (30 substeps), no
    buoyancy, a passive tracer c (a top-hat band in x) in a non-divergent
    zonal jet; 24a under ``WENO(7, bounds=(0, 1))``, 24b under
    ``BoundPreserving(WENO(5))``: 2 + 10 steps on each path (kernel 12/13
    once a stage, three times a step; kernel 11 never, its gate refuses
    the limiters), held to each other at phase 9's bounds (η and w, flat
    to rounding in the jet, against the flow's own scales), c held to
    [0, 1] within the float32 rounding bound below; and float64 (48, 16,
    6) runs on the card against the CPU to 1e-12, c within [−1e-12,
    1 + 1e-12]."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_split_rk3_initial_state, hydro_split_rk3_model,
    )
    dt = HYDRO_DT
    want = {"vi_momentum_tendency": 3}
    total = SPLIT_RK3_WARM + SPLIT_RK3_STEPS
    # each stage rounds c + Δt G and the convex combination once each
    # (≤ 3 roundings of values ≤ 1), three stages a step
    cbound = (total + 1) * 3 * 3 * EPS32
    out = {}
    for tag, limiter in (("24a", ot.WENO(7, bounds=(0.0, 1.0))),
                         ("24b", ot.BoundPreserving(ot.WENO(5)))):
        finals = {}
        for path, fused in (("kernel", "auto"), ("plain", False)):
            model = hydro_split_rk3_model(fused, tracer_advection=limiter)
            require(model.fused_kernels == (path == "kernel")
                    and not model.fused_tracer,
                    f"hydro_split_rk3 {tag} {path} path: fused_kernels="
                    f"{model.fused_kernels}, fused_tracer="
                    f"{model.fused_tracer}")
            state = model.update_state(hydro_split_rk3_initial_state(model))
            state, ms, enqueue, counts = run_counted(
                torch, model, state, dt, SPLIT_RK3_WARM, SPLIT_RK3_STEPS,
                wrappers, want if path == "kernel" else {},
                f"hydro_split_rk3 {tag} {path} path")
            state, syncs = count_syncs(torch, lambda: model.step(
                state, dt, assume_filled=True))
            busy, n_launch, wall = device_profile(
                torch, lambda: model.step(state, dt, assume_filled=True), PROFILE_STEPS)
            g = model.grid
            c = g.interior(state.tracers["c"])
            cmin, cmax = float(c.min()), float(c.max())
            log(f"[{tag}] hydro_split_rk3 {limiter!r} {path} path on "
                f"{card}: {ms:.3f} ms/step (steps {SPLIT_RK3_WARM + 1} to "
                f"{total} of split_rk3, Δt {dt} s, CUDA events); host "
                f"enqueue {enqueue:.3f} ms/step; device-busy {busy:.3f} "
                f"ms/step in a wall of {wall:.3f} under torch.profiler "
                f"(idle share {1 - busy / wall:.3f}; against the unprofiled "
                f"ms, {1 - busy / ms:.3f}), {n_launch:.0f} launches a step; "
                f"host syncs in one step {syncs}; port kernel launches in "
                f"{total} steps {counts}; min c {cmin:.6e}, max c "
                f"{cmax:.9f} (held to [-{cbound:.3e}, 1 + {cbound:.3e}]: "
                f"{total + 1} steps x 3 stages x 3 roundings x the float32 "
                "epsilon)")
            require(-cbound <= cmin and cmax <= 1.0 + cbound,
                    f"hydro_split_rk3 {tag} {path}: c in [{cmin}, {cmax}]")
            out[(tag, path)] = {"ms": ms, "busy": busy, "syncs": syncs,
                                "launches": n_launch, "cmin": cmin,
                                "cmax": cmax}
            umax = float(g.interior(state.u).abs().max())
            finals[path] = hydro_groups(g, state, ("c",))
            del model, state
            torch.cuda.empty_cache()
        # η and w of the jet are rounding noise: each is held against the
        # scale the flow gives it (a gravity wave of the jet's speed, U
        # sqrt(H/g); the vertical speed of a flow of that speed over the
        # domain's aspect, U H / Lx)
        scales = {"eta": umax * math.sqrt(4e3 / 9.81),
                  "w": umax * 4e3 / 4e7}
        rel = path_rel(finals, scales)
        trtol = dict(rtol, w=rtol["velocities"])
        log(f"[{tag}] hydro_split_rk3: kernel vs plain path after "
            f"{total + 1} steps: " + ", ".join(
                f"{k} {v:.3e}" for k, v in rel.items())
            + " (eta against max(|eta|, U sqrt(H/g)) = "
            f"{scales['eta']:.3e} m, w against U H/Lx = {scales['w']:.3e} "
            "m/s; tolerances " + ", ".join(
                f"{k} {trtol[k]:g}" for k in trtol) + ")")
        require(all(rel[k] <= trtol[k] for k in trtol),
                f"hydro_split_rk3 {tag} kernel vs plain path {rel}")
        out[tag] = rel
        del finals
        torch.cuda.empty_cache()

        # float64 (48, 16, 6): the card against the CPU
        rel64, runs = card_vs_cpu(
            lambda device: hydro_split_rk3_model(
                "auto", torch.float64, device, size=(48, 16, 6),
                tracer_advection=limiter),
            hydro_split_rk3_initial_state, 5, dt, ("c",), scales)
        c64 = [runs[d][0].grid.interior(runs[d][1].tracers["c"])
               for d in runs]
        c64min = min(float(c.min()) for c in c64)
        c64max = max(float(c.max()) for c in c64)
        log(f"[{tag}] float64 (48, 16, 6) hydro_split_rk3 {limiter!r}, 5 "
            "steps: kernel path on the card vs plain path on the CPU: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel64.items())
            + " (tolerance 1e-12); c on both in "
            f"[{c64min:.3e}, 1 + {c64max - 1:.3e}] (held to [-1e-12, "
            "1 + 1e-12])")
        require(all(v <= 1e-12 for v in rel64.values()),
                f"float64 hydro_split_rk3 {tag} card vs CPU {rel64}")
        require(c64min >= -1e-12 and c64max <= 1.0 + 1e-12,
                f"float64 hydro_split_rk3 {tag}: c in [{c64min}, {c64max}]")
        out[tag + "64"] = rel64
    return out


def zstar_content(torch, model, state):
    """∫σ c dV over the wet cells in float64, and max|c − 1| there."""
    from oceananigans_torch.grids.base import Center
    g = model.grid
    sig = model._sigma(state.eta).double()
    dV = g.V(Center, Center, Center).double()
    c = state.tracers["c"].double()
    wet = ~g.solid_c
    content = float(torch.sum(g.interior(torch.where(
        wet, sig * dV * c, 0.0).expand(g.shape))))
    dev = float(g.interior(torch.where(wet, (c - 1.0).abs(), 0.0)).max())
    return content, dev


def zstar_w_scale(model, state):
    """The speed of the moving surface, max|∇·∫σu dz| over the interior:
    under z-star w is the velocity across the moving levels, the
    difference of the continuity integral and the grid's motion, each of
    this size; their rounding is relative to it, not to their small
    difference."""
    g = model.grid
    sfc = model._sigma_at(state.eta, "fc")
    scf = model._sigma_at(state.eta, "cf")
    speed = model._div_transports(*model._barotropic_mode(
        state.u, state.v, sfc, scf))
    return {"w": float(speed[g.interior_slices[:2]].abs().max())}


def zstar_phase(torch, ot, wrappers, card):
    """Phase 25: ``hydro_zstar``, phase 19's ``hydro_vi_bathy`` with
    ``ZStar()`` and a passive tracer c = 1: 2 + 10 steps in float32 on the
    plain path (the tendencies are on the σ-scaled grid, which no kernel
    takes, as in JAX), timed and profiled, with max|c − 1| over the wet
    cells and the drift of ∫σ c dV; 3 float64 steps at full width with the
    explicit free surface, ∫σ c dV to 1e-12 relative and max|c − 1| to
    1e-12; and a float64 (24, 16, 8) sector on the card against the CPU."""
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_latlon_initial_state, hydro_zstar_model,
    )
    dt = HYDRO_DT
    model = hydro_zstar_model("auto")
    require(model.zstar and not model.fused_kernels
            and not model.fused_tracer,
            "hydro_zstar: no kernel on the σ-scaled grid")
    state = model.update_state(hydro_latlon_initial_state(model, c=1.0))
    c0, _ = zstar_content(torch, model, state)
    total = ZSTAR_WARM + ZSTAR_STEPS
    state, ms, enqueue = cube_run(torch, model, state, dt, ZSTAR_WARM,
                                  ZSTAR_STEPS, wrappers, "hydro_zstar")
    counts = zero_launches(wrappers)
    c1, dev = zstar_content(torch, model, state)
    busy, n_launch, wall, line = profile_line(torch, model, state, dt,
                                              "hydro_zstar")
    g = model.grid
    xy = g.interior_slices[:2]
    log(f"[25] hydro_zstar on {card}: {' x '.join(map(str, g.N))} float32,"
        f" {model.free_surface!r}; {ms:.3f} ms/step (steps {ZSTAR_WARM + 1}"
        f" to {total} of AB2, CUDA events); host enqueue {enqueue:.3f} "
        f"ms/step; {line}; against the unprofiled {ms:.3f} ms/step, idle "
        f"share {1 - busy / ms:.3f}; port kernel launches {counts}; "
        f"max|eta| {float(state.eta[xy].abs().max()):.4e}; max|c - 1| over "
        f"the wet cells {dev:.3e}; drift of the integral of sigma c dV "
        f"{abs(c1 - c0) / abs(c0):.3e} of itself")
    out = {"ms": ms, "enqueue": enqueue, "busy": busy, "launches": n_launch,
           "wall": wall, "dev": dev, "drift": abs(c1 - c0) / abs(c0)}
    del model, state
    torch.cuda.empty_cache()

    # float64 at full width with the explicit free surface: exact
    # telescoping of the σ-weighted content and a uniform c kept uniform
    model = hydro_zstar_model("auto", torch.float64,
                              free_surface=ot.ExplicitFreeSurface())
    state = model.update_state(hydro_latlon_initial_state(model, c=1.0))
    c0, _ = zstar_content(torch, model, state)
    state, ms64, _ = cube_run(torch, model, state, dt, 0, 3, wrappers,
                              "hydro_zstar float64")
    c1, dev64 = zstar_content(torch, model, state)
    drift64 = abs(c1 - c0) / abs(c0)
    log(f"[25] float64 hydro_zstar at full width, explicit free surface, 3 "
        f"AB2 steps: {ms64:.3f} ms/step; max|eta| "
        f"{float(state.eta[xy].abs().max()):.4e}; the integral of sigma c "
        f"dV drifts {drift64:.3e} of itself, max|c - 1| over the wet cells "
        f"{dev64:.3e} (tolerances 1e-12)")
    require(drift64 <= 1e-12 and dev64 <= 1e-12,
            f"float64 hydro_zstar: content drift {drift64:.3e}, max|c - 1| "
            f"{dev64:.3e}")
    out["drift64"], out["dev64"] = drift64, dev64
    del model, state
    torch.cuda.empty_cache()

    # float64 (24, 16, 8) sector: the card against the CPU
    rel64, _ = card_vs_cpu(
        lambda device: hydro_zstar_model(
            "auto", torch.float64, device, size=(24, 16, 8),
            longitude=(-60.0, 60.0), latitude=(-80.0, 80.0), halo=6),
        lambda m: hydro_latlon_initial_state(m, generic=True, c=1.0), 3, dt,
        ("T", "S", "c"), zstar_w_scale)
    log("[25] float64 (24, 16, 8) hydro_zstar sector with continents, 3 AB2 "
        "steps: the card vs the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rel64.items())
        + " of the largest value (w: of the larger of max|w| and the "
        "surface's speed max|div of the integral of sigma u dz|, the size "
        "of the two terms w is the difference of; tolerance 1e-12)")
    require(all(v <= 1e-12 for v in rel64.values()),
            f"float64 hydro_zstar sector card vs CPU {rel64}")
    out["rel64"] = rel64
    return out


def cs_implicit_phase(torch, wrappers, card):
    """Phase 26: ``cs_global_implicit``, phase 16's ``cs_global`` at
    C48×16: 26a with the implicit free surface (one CG across the panels,
    JAX's maxiter 200 and reltol 1e-9, RK3), 2 + 10 steps with the CG
    iterations of every step's last solve; 26b with ``ZStar()`` under
    quasi-AB2 (its split-explicit free surface), 2 + 10 steps; each timed
    and profiled, the float32 volume held to its rounding bound, 26a's
    float64 volume over 3 steps to 1e-12 of the ocean's; and float64 C8×4
    runs of both on the card against the CPU (26a's CG at
    :data:`FIXED_CG_ITERATIONS` iterations) to 1e-12. No port kernel
    launches."""
    from oceananigans_torch.profile_step import (
        CS_GLOBAL_DT, cs_global_implicit_model, volume_drift,
    )
    dt = CS_GLOBAL_DT
    total = CS_IMPLICIT_WARM + CS_IMPLICIT_STEPS
    out = {}
    for tag, zstar in (("26a", False), ("26b", True)):
        model, state = cs_global_implicit_model(48, 16, torch.float32,
                                                zstar=zstar)
        its = []

        def each(m):
            if not zstar:
                its.append(m.free_surface_info["iterations"])
        state, _, _ = cube_run(torch, model, state, dt, CS_IMPLICIT_WARM, 0,
                               wrappers, f"cs_global {tag}", each)
        eta0 = state.eta.clone()
        S0 = float(model.total_tracer(state, "S"))
        state, ms, enqueue = cube_run(torch, model, state, dt, 0,
                                      CS_IMPLICIT_STEPS, wrappers,
                                      f"cs_global {tag}", each)
        its = [int(i) for i in its]
        vdrift = volume_drift(model, eta0, state.eta)
        sdrift = abs(float(model.total_tracer(state, "S")) - S0) / abs(S0)
        if zstar:
            n = len(model.free_surface.weights)
            what = f"{CS_IMPLICIT_STEPS} steps x {n} barotropic substeps"
        else:
            n = 3 * max(its)
            what = (f"{CS_IMPLICIT_STEPS} steps x 3 solves x "
                    f"{max(its)} CG iterations")
        vbound = CS_IMPLICIT_STEPS * n * EPS32
        require(vdrift <= vbound, f"cs_global {tag}: float32 volume drift "
                f"{vdrift:.3e} (bound {vbound:.3e})")
        busy, n_launch, wall, line = profile_line(torch, model, state, dt,
                                                  f"cs_global {tag}")
        info = model.free_surface_info
        cg = (f"CG iterations of each step's last solve {its} (maxiter "
              f"{model.free_surface.maxiter}, reltol "
              f"{model.free_surface.reltol:g}), host reads of the flag a "
              f"solve {info['host_syncs']}; " if not zstar else "")
        log(f"[{tag}] cs_global_implicit C48x16 {model.free_surface!r}, "
            f"{model.timestepper}, {model.vertical_coordinate!r} on {card}: "
            f"{ms:.3f} ms/step (steps {CS_IMPLICIT_WARM + 1} to {total}, "
            f"CUDA events); host enqueue {enqueue:.3f} ms/step; {line}; "
            f"{cg}port kernels launched: none; float32 volume drift "
            f"{vdrift:.3e} of sum|eta| Az (bound {vbound:.3e}: {what} x the "
            f"float32 epsilon); salt drift {sdrift:.3e}")
        out[tag] = {"ms": ms, "enqueue": enqueue, "busy": busy,
                    "launches": n_launch, "wall": wall, "iterations": its,
                    "vdrift": vdrift}
        del model, state
        torch.cuda.empty_cache()

    # 26a in float64 at C48x16: the volume to 1e-12 of the ocean's
    model, state = cs_global_implicit_model(48, 16, torch.float64)
    vol0 = float(model.total_volume(state))
    state, ms64, _ = cube_run(torch, model, state, dt, 0, 3, wrappers,
                              "cs_global 26a float64")
    vdrift64 = abs(float(model.total_volume(state)) - vol0) / float(
        model.ocean_volume())
    log(f"[26a] float64 cs_global_implicit C48x16, 3 RK3 steps: {ms64:.3f} "
        f"ms/step; last CG solve {int(model.free_surface_info['iterations'])}"
        f" iterations; volume drift {vdrift64:.3e} of the ocean's volume "
        f"(tolerance {VOLUME_RTOL:g})")
    require(vdrift64 <= VOLUME_RTOL,
            f"cs_global 26a float64 volume drift {vdrift64:.3e}")
    out["vdrift64"] = vdrift64
    del model, state
    torch.cuda.empty_cache()

    groups = {"velocities": ("u", "v"), "eta": ("eta",), "T": ("T",),
              "S": ("S",)}
    for tag, kw in (("26a", dict(maxiter=FIXED_CG_ITERATIONS, reltol=0.0)),
                    ("26b", dict(zstar=True))):
        runs = {}
        for device in ("cuda", "cpu"):
            m, st = cs_global_implicit_model(8, 4, torch.float64, device,
                                             **kw)
            for _ in range(3):
                st = m.step(st, 600.0)
            runs[device] = cube_groups(m.grid, st, groups)
        rel8 = {k: group_rel([(a, b) for a, b in zip(runs["cuda"][k],
                                                     runs["cpu"][k])])
                for k in groups}
        log(f"[{tag}] float64 cs_global_implicit C8x4"
            + (f" (CG at {FIXED_CG_ITERATIONS} iterations a solve)"
               if tag == "26a" else " with ZStar")
            + ", 3 steps of 600 s: the card vs the CPU: " + ", ".join(
                f"{k} {v:.3e}" for k, v in rel8.items())
            + " of the largest value (tolerance 1e-12)")
        require(all(v <= 1e-12 for v in rel8.values()),
                f"cs_global_implicit {tag} C8x4 card vs CPU {rel8}")
        out[tag + "64"] = rel8
    return out


# ---------------------------------------------------------------------------
# Phase 27: the distributed layer. The rank programs are module-level
# functions: ``parallel.launch`` starts the ranks with the spawn method,
# which imports this script again in each rank (``main`` stays unrun).
# ---------------------------------------------------------------------------

#: warm-up and timed steps of each serial and sharded run of phase 27
DIST_WARM, DIST_TIMED = 2, 10
#: the kernels against their plain versions at a rank's block shape:
#: phase 3's bounds (8 float32 ulps for the Centered-2 tile, 1e-5 of the
#: largest value for the WENO, vector-invariant and tracer tiles)
DIST_KERNEL_RTOL = {"centered2_momentum_tendency": 8 * 2.0 ** -23,
                    "weno5_momentum_tendency": 1e-5,
                    "weno5_tracer_tendencies": 1e-5,
                    "weno_tracer_tendencies": 1e-5,
                    "vi_momentum_tendency": 1e-5}
#: sharded against serial on the card after the 12 steps, relative to
#: the largest value of each group: the nonhydrostatic runs solve the
#: pressure through the pencil basis products where the serial run has its
#: FFT solver, a float32 rounding that the WENO-Z weights carry on; phase
#: 7's kernel-against-plain bound. The hydrostatic step has no global
#: solve: phase 9's bounds
DIST_NH_RTOL = 3e-5
DIST_HY_RTOL = {"velocities": 1e-4, "eta": 1e-4, "tracers": 1e-5}
#: float64 sharded against serial, on the card
DIST_F64_RTOL = 1e-12


def dist_wrappers():
    """The launch-counting wrappers of every kernel, by name."""
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_poisson as cp
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    return {"centered2_ab2_update": ck.centered2_ab2_update,
            "centered2_momentum_tendency": ck.centered2_momentum_tendency,
            "pressure_correction": ck.pressure_correction,
            "fused_middle_solve": cp.fused_middle_solve,
            "weno5_ab2_update": cw.weno5_ab2_update,
            "weno5_momentum_tendency": cw.weno5_momentum_tendency,
            "weno5_science_ab2_update": cw.weno5_science_ab2_update,
            "weno5_tracer_tendencies": cw.weno5_tracer_tendencies,
            "centered2_science_ab2_update": ck.centered2_science_ab2_update,
            "sw_rk3_stage": csw.sw_rk3_stage,
            "weno_tracer_tendencies": ctr.weno_tracer_tendencies,
            "vi_momentum_tendency": cvi.vi_momentum_tendency,
            "fused_momentum_tendency": cg.fused_momentum_tendency}


def dist_config(spec, device):
    """``(grid, make_model, dt, initial_state, per_step)`` of a phase-27
    part: ``per_step`` the kernels each rank must launch a step."""
    import torch

    import oceananigans_torch as ot
    from oceananigans_torch.profile_step import (
        HYDRO_DT, hydro_generic_state, initial_state,
    )
    dtype = getattr(torch, spec["dtype"])
    if spec["kind"] == "hydro":
        grid = ot.RectilinearGrid(
            size=spec["size"], extent=(4e7, 2e7, 4e3),
            topology=(ot.Periodic, ot.Bounded, ot.Bounded), halo=(6, 6, 4),
            dtype=dtype, device=device)

        def make(g):
            return ot.HydrostaticFreeSurfaceModel(
                grid=g, momentum_advection=ot.WENOVectorInvariant(),
                tracer_advection=ot.WENO(7), tracers=("T", "S"),
                free_surface=ot.SplitExplicitFreeSurface(substeps=30))
        return (grid, make, HYDRO_DT, hydro_generic_state,
                {"vi_momentum_tendency": 1, "weno_tracer_tendencies": 1})
    weno = spec["kind"] == "weno"
    grid = ot.RectilinearGrid(
        size=spec["size"], extent=(1.0, 1.0, 1.0),
        topology=(ot.Bounded, ot.Periodic, ot.Periodic),
        halo=(3, 0, 0) if weno else (1, 0, 0), dtype=dtype, device=device)

    def make(g):
        if weno:
            return ot.NonhydrostaticModel(
                grid=g, advection=ot.WENO(5), tracers=("T", "S"),
                timestepper="RungeKutta3")
        return ot.NonhydrostaticModel(grid=g, advection=ot.Centered(2),
                                      timestepper="RungeKutta3")
    per = ({"weno5_momentum_tendency": 3, "weno5_tracer_tendencies": 3}
           if weno else {"centered2_momentum_tendency": 3})
    return grid, make, 1e-4, initial_state, per


def dist_groups(g, st, hydro):
    """The compared interiors of a state, by group."""
    if hydro:
        xy = g.interior_slices[:2]
        return {"velocities": [g.interior(st.u), g.interior(st.v)],
                "eta": [st.eta[xy]],
                "tracers": [g.interior(c) for c in st.tracers.values()]}
    out = {"velocities": [g.interior(q) for q in (st.u, st.v, st.w)]}
    if st.tracers:
        out["tracers"] = [g.interior(c) for c in st.tracers.values()]
    return out


def dist_block_kernels(torch, ot, lg, kind, gen):
    """Each kernel of the part against its plain version on random fields
    of the rank's block shape: ``{name: (max|kernel − plain|, scale)}``."""
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    fs = []
    # the block's own fill, on the axes at least as wide as their halo (a
    # periodic fill of a narrower block would copy over itself)
    axes = tuple(ax for ax in range(3) if lg.N[ax] >= lg.H[ax])
    for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C):
        a = torch.randn(lg.shape, generator=gen, device=lg.device,
                        dtype=lg.dtype)
        fs.append(ot.fill_halo_regions(a, lg, loc=loc, axes=axes))
    u, v, w, T, S = fs
    tr = {"T": T, "S": S}
    pairs = {}
    if kind == "weno":
        pairs["weno5_momentum_tendency"] = (
            cw.weno5_momentum_tendency(lg, u, v, w),
            cw.weno5_momentum_tendency_plain(lg, u, v, w))
        pairs["weno5_tracer_tendencies"] = (
            list(cw.weno5_tracer_tendencies(lg, u, v, w, tr).values()),
            list(cw.weno5_tracer_tendencies_plain(lg, u, v, w,
                                                  tr).values()))
    elif kind == "centered":
        pairs["centered2_momentum_tendency"] = (
            ck.centered2_momentum_tendency(lg, u, v, w),
            ck.centered2_momentum_tendency_plain(lg, u, v, w))
    else:
        vi = ot.WENOVectorInvariant()
        pairs["vi_momentum_tendency"] = (
            cvi.vi_momentum_tendency(lg, vi, u, v, w),
            cvi.vi_momentum_tendency_plain(lg, vi, u, v, w))
        sch = ot.WENO(7)
        pairs["weno_tracer_tendencies"] = (
            list(ctr.weno_tracer_tendencies(lg, sch, u, v, w, tr).values()),
            list(ctr.weno_tracer_tendencies_plain(lg, sch, u, v, w,
                                                  tr).values()))
    torch.cuda.synchronize()
    return {name: (max(float((a - b).abs().max()) for a, b in zip(k, p)),
                   max(float(b.abs().max()) for b in p))
            for name, (k, p) in pairs.items()}


def dist_part_rank(dist, spec):
    """One phase-27 part on this rank: the kernels at the block shape (rank
    0), the serial run (rank 0) and the sharded run (every rank), both from
    the same state; returns this rank's report."""
    import torch

    import oceananigans_torch as ot
    from oceananigans_torch.parallel import DistributedStep
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = dist_wrappers()
    grid, make, dt, init, per_step = dist_config(spec, dist.device)
    hydro = spec["kind"] == "hydro"
    dstep = DistributedStep(make, grid, dist)
    lm, lg = dstep.lmodel, dstep.local_grid
    rep = {"rank": dist.rank, "coords": dist.coords,
           "block": tuple(lg.shape), "stage_p2p": dist.stage_p2p}
    if hydro:
        rep["gates"] = {"fused_kernels": lm.fused_kernels,
                        "fused_tracer": lm.fused_tracer}
        require(lm.fused_kernels and lm.fused_tracer,
                f"rank {dist.rank}: the local hydro_vi model takes kernels "
                f"11 and 12/13 ({rep['gates']})")
    else:
        rep["gates"] = {k: getattr(lm, k) for k in (
            "fused_kernels", "fused_ab2", "fused_ab2_weno",
            "fused_ab2_science", "fused_ab2_weno_science")}
        want = "weno5" if spec["kind"] == "weno" else "centered2"
        require(lm.fused_kernels == want
                and not any(v for k, v in rep["gates"].items()
                            if k != "fused_kernels"),
                f"rank {dist.rank}: the local model takes the {want} "
                f"tendency kernels and no fused AB2 kernel ({rep['gates']})")
    s0 = init(dstep.gmodel) if dist.rank == 0 else None
    if s0 is not None and hydro:
        s0 = dstep.gmodel.update_state(s0)
    local = dstep.to_local_state(s0)
    steps = DIST_WARM + DIST_TIMED
    serial = None
    if dist.rank == 0:
        if spec.get("check"):
            gen = torch.Generator(device=dist.device).manual_seed(27)
            rep["block_kernels"] = dist_block_kernels(
                torch, ot, lg, spec["kind"], gen)
        if spec.get("serial"):
            gm = dstep.gmodel
            st = s0
            for _ in range(DIST_WARM):
                st = gm.step(st, dt)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(DIST_TIMED):
                st = gm.step(st, dt)
            e1.record()
            e1.synchronize()
            rep["serial_ms"] = e0.elapsed_time(e1) / DIST_TIMED
            serial = st
    dist.barrier()
    for fn in wrappers.values():
        fn.launches = 0
    dist.reset_counts()
    for _ in range(DIST_WARM):
        local = dstep.step(local, dt)
    torch.cuda.synchronize()
    dist.barrier()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(DIST_TIMED):
        local = dstep.step(local, dt)
    e1.record()
    e1.synchronize()
    dist.barrier()
    rep["ms"] = e0.elapsed_time(e1) / DIST_TIMED
    rep["wall_ms"] = (time.perf_counter() - t0) * 1e3 / DIST_TIMED
    rep["launches"] = {k: fn.launches for k, fn in wrappers.items()
                       if fn.launches}
    rep["collectives_a_step"] = {k: v / steps
                                 for k, v in dist.counts.items()}
    for name, per in per_step.items():
        require(rep["launches"].get(name, 0) == per * steps,
                f"rank {dist.rank}: {name} launched "
                f"{rep['launches'].get(name, 0)} times in {steps} steps "
                f"(want {per} a step)")
    others = [k for k in rep["launches"] if k not in per_step]
    require(not others, f"rank {dist.rank}: unexpected launches {others}")
    require(all(bool(torch.isfinite(q).all()) for q in (
        local.u, local.v, *local.tracers.values())),
        f"rank {dist.rank}: finite fields")
    final = dstep.from_local_state(local)
    if serial is not None:
        g = grid
        a = dist_groups(g, final, hydro)
        b = dist_groups(g, serial, hydro)
        rep["rel"] = {k: max(float((x - y).abs().max())
                             for x, y in zip(a[k], b[k]))
                      / max(float(y.abs().max()) for y in b[k])
                      for k in b}
    return rep


def dist_parts_rank(dist, specs):
    """Several phase-27 parts in one spawn of ranks, each over its own
    partition (``spec["partition"]``): this rank's reports."""
    from oceananigans_torch.parallel import Distributed, Partition
    return [dist_part_rank(Distributed(Partition(*spec["partition"]),
                                       device=dist.device), spec)
            for spec in specs]


def dist_nccl_rank(dist, spec):
    """The world-size-1 NCCL rank: the sharded step at one rank (its
    exchange the local fill, its pencils whole) against the serial step."""
    rep = dist_part_rank(dist, spec)
    rep["backend"] = dist.backend
    return rep


#: the distributed cube against the serial one, float64 on the card:
#: tests/test_cubed_sphere_dist.py's tolerances (relative to the largest
#: value; the mass of the shallow water to 1e-13, the volume and the salt
#: of the ocean, which no flux changes, to 1e-12)
DIST_CUBE_RTOL = 1e-12
DIST_CUBE_MASS_RTOL = {"sw": 1e-13, "hydro": 1e-12}


def dist_cube_rank(dist, spec):
    """One phase-27c part on this rank: the serial cube (rank 0) and the
    distributed one (every rank) from the same state, float64."""
    import torch

    from oceananigans_torch.parallel import (
        CubedSphereDistributedHydrostatic, CubedSphereDistributedSW,
    )
    from oceananigans_torch.profile_step import (
        CS_GLOBAL_DT, CS_W2_DT, cs_global_model, cs_w2_model,
    )
    wrappers = dist_wrappers()
    f64 = torch.float64
    if spec["kind"] == "sw":
        # phase 15's Δt at C192
        model, state = cs_w2_model(spec["N"], dtype=f64, device=dist.device)
        dt, cls = CS_W2_DT, CubedSphereDistributedSW
        groups = {"velocities": ("u", "v"), "h": ("h",)}
    else:
        model, state = cs_global_model(spec["N"], spec["Nz"], dtype=f64,
                                       device=dist.device)
        dt, cls = CS_GLOBAL_DT, CubedSphereDistributedHydrostatic
        groups = {"velocities": ("u", "v"), "eta": ("eta",)}
    t0 = time.perf_counter()
    dm = cls(model, dist, R=spec["R"], panels=spec["panels"])
    rep = {"rank": dist.rank, "coords": dm.coords,
           "tables_s": time.perf_counter() - t0}
    local = dm.to_local_state(state)
    steps = DIST_WARM + DIST_TIMED
    serial = None
    if dist.rank == 0:
        st = state
        for _ in range(DIST_WARM):
            st = model.step(st, dt)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(DIST_TIMED):
            st = model.step(st, dt)
        e1.record()
        e1.synchronize()
        rep["serial_ms"] = e0.elapsed_time(e1) / DIST_TIMED
        serial = st
    dist.barrier()
    for fn in wrappers.values():
        fn.launches = 0
    dist.reset_counts()
    for _ in range(DIST_WARM):
        local = dm.step(local, dt)
    torch.cuda.synchronize()
    dist.barrier()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(DIST_TIMED):
        local = dm.step(local, dt)
    e1.record()
    e1.synchronize()
    dist.barrier()
    rep["ms"] = e0.elapsed_time(e1) / DIST_TIMED
    rep["launches"] = {k: fn.launches for k, fn in wrappers.items()
                       if fn.launches}
    rep["collectives_a_step"] = {k: v / steps
                                 for k, v in dist.counts.items()}
    require(not rep["launches"], f"rank {dist.rank}: the distributed cube "
            f"launched {rep['launches']}")
    final = dm.from_local_state(local)
    if serial is not None:
        g = model.grid

        def interior(st, name):
            return g.interior(getattr(st, name))

        rep["rel"] = {k: max(float((interior(final, n) - interior(serial, n))
                                   .abs().max()) for n in names)
                      / max(float(interior(serial, n).abs().max())
                            for n in names)
                      for k, names in groups.items()}
        if spec["kind"] == "sw":
            m0, m1 = model.total_mass(state), model.total_mass(final)
            rep["conservation"] = {"mass": abs(float(m1 / m0) - 1)}
        else:
            v0, v1 = model.total_volume(state), model.total_volume(final)
            s0 = model.total_tracer(state, "S")
            s1 = model.total_tracer(final, "S")
            rep["conservation"] = {
                "volume": abs(float(v1 - v0)) / float(model.ocean_volume()),
                "salt": abs(float(s1 / s0) - 1)}
    return rep


#: the collectives the transport hands CUDA tensors under gloo
#: (``parallel/distributed.py``: only point-to-point strips are staged
#: through host buffers)
GLOO_CUDA_OPS = ("all_reduce", "all_to_all")


def dist_probe_rank(dist, ops):
    """Which of ``ops`` the gloo backend takes on CUDA tensors in this
    build of torch: each is tried once on a small CUDA tensor, unstaged,
    with a barrier after it, and its result checked; ``{op: True | "what
    went wrong"}``. A refused op may leave the group unusable, so a spawn
    tries the ops expected to pass or a single other one."""
    import torch
    import torch.distributed as tdist
    n, r = dist.world_size, dist.rank
    dev = dist.device

    def p2p():
        send = torch.full((4,), float(r), device=dev)
        recv = torch.empty(4, device=dev)
        ops_ = [tdist.P2POp(tdist.isend, send, (r + 1) % n, tag=7),
                tdist.P2POp(tdist.irecv, recv, (r - 1) % n, tag=7)]
        for req in tdist.batch_isend_irecv(ops_):
            req.wait()
        return bool((recv == float((r - 1) % n)).all())

    def all_reduce():
        t = torch.ones(4, device=dev)
        tdist.all_reduce(t)
        return bool((t == float(n)).all())

    def all_to_all():
        send = torch.arange(n, dtype=torch.float32, device=dev) + 10 * r
        recv = torch.empty(n, device=dev)
        tdist.all_to_all_single(recv, send)
        want = torch.arange(n, dtype=torch.float32, device=dev) * 10 + r
        return bool((recv == want).all())

    tries = {"p2p": p2p, "all_reduce": all_reduce, "all_to_all": all_to_all}
    out = {}
    for op in ops:
        try:
            ok = tries[op]()
            tdist.barrier()
            out[op] = True if ok else "wrong result"
        except (RuntimeError, ValueError, TypeError) as err:
            out[op] = f"{type(err).__name__}: {str(err).splitlines()[0]}"
    return out


def dist_phase(torch, wrappers, card, launches):
    """Phase 27: the distributed layer on the card (see the docstring)."""
    import tempfile

    from oceananigans_torch.parallel import Partition, launch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(tag, n, fn, spec, partition, backend="gloo",
                device="cuda:0"):
            t0 = time.perf_counter()
            reps = launch(n, fn, (spec,), rendezvous_dir=f"{tmp}/{tag}",
                          backend=backend, device=device,
                          partition=partition)
            log(f"[27] {tag}: {n} {backend} rank(s) on {device} in "
                f"{time.perf_counter() - t0:.1f} s")
            return reps

        # which gloo collectives take CUDA tensors in this torch build: the
        # ones the transport relies on in one group, point to point (which
        # may abort its ranks) in another
        probe = {}
        for ops in (GLOO_CUDA_OPS, ("p2p",)):
            try:
                probe.update(run("probe_" + "_".join(ops), 2,
                                 dist_probe_rank, ops, None)[0])
            except RuntimeError as err:
                probe.update({op: "a rank failed: " + str(err).strip()
                              .splitlines()[-1] for op in ops})
        log(f"[27] gloo on CUDA tensors: {probe}")
        require(all(probe[op] is True for op in GLOO_CUDA_OPS),
                f"gloo takes {sorted(GLOO_CUDA_OPS)} on CUDA tensors")
        out["probe"] = probe

        # 27a and 27b: the four-rank parts in one spawn
        parts = {
            "27a weno": dict(
                kind="weno", size=(256, 256, 256), dtype="float32",
                partition=(4, 1), check=True, serial=True),
            "27a centered2": dict(
                kind="centered", size=(64, 64, 64), dtype="float32",
                partition=(4, 1), check=True, serial=True),
            "27a weno float64": dict(
                kind="weno", size=(64, 64, 64), dtype="float64",
                partition=(4, 1), serial=True),
            "27b hydro_vi": dict(
                kind="hydro", size=(360, 160, 60), dtype="float32",
                partition=(2, 2), check=True, serial=True),
        }
        n = 4
        by_rank = run("27ab", n, dist_parts_rank, list(parts.values()),
                      None)
        for k, (tag, spec) in enumerate(parts.items()):
            reps = [r[k] for r in by_rank]
            r0 = reps[0]
            per_rank = [r["launches"] for r in reps]
            for name in per_rank[0]:
                launches[name] = launches.get(name, 0) + sum(
                    r["launches"].get(name, 0) for r in reps)
            for name, (err, sc) in r0.get("block_kernels", {}).items():
                tol = DIST_KERNEL_RTOL[name] * sc
                log(f"[27] {tag}: {name} at the block shape {r0['block']}:"
                    f" max|kernel - plain| {err:.3e} (tolerance {tol:.3e})")
                require(err <= tol, f"{tag}: {name} at {r0['block']}")
            rel = r0["rel"]
            if spec["dtype"] == "float64":
                bound = {k2: DIST_F64_RTOL for k2 in rel}
            elif spec["kind"] == "hydro":
                bound = DIST_HY_RTOL
            else:
                bound = {k2: DIST_NH_RTOL for k2 in rel}
            log(f"[27] {tag} {spec['size']} {spec['dtype']}, Partition"
                f"{spec['partition']}: serial {r0['serial_ms']:.3f} ms/step, "
                "sharded " + ", ".join(f"rank {r['rank']} {r['coords']} "
                                      f"{r['ms']:.3f}" for r in reps)
                + f" ms/step (CUDA events; host wall "
                f"{max(r['wall_ms'] for r in reps):.3f}) on {card}; the "
                f"{n} ranks share one card, so these are no scaling figure;"
                f" launches per rank {per_rank}; collectives a step on rank "
                f"0 {r0['collectives_a_step']}; p2p staged through the host "
                f"{r0['stage_p2p']}; sharded vs serial " + ", ".join(
                    f"{k2} {v:.3e}" for k2, v in rel.items())
                + f" of the largest value (tolerance {bound})")
            require(all(rel[k2] <= bound[k2] for k2 in rel),
                    f"{tag}: sharded vs serial {rel}")
            out[tag] = reps

        # 27c: the cube, float64, against the serial cube
        cubes = {"27c cs_w2 C192": (6, dict(kind="sw", N=192, R=1,
                                            panels=6)),
                 "27c cs_global C48x16": (8, dict(kind="hydro", N=48, Nz=16,
                                                  R=2, panels=2))}
        for tag, (n, spec) in cubes.items():
            reps = run(tag.replace(" ", "_"), n, dist_cube_rank, spec, None)
            r0 = reps[0]
            cons = DIST_CUBE_MASS_RTOL[spec["kind"]]
            log(f"[27] {tag} float64, R={spec['R']}, panels="
                f"{spec['panels']}, {n} ranks: serial {r0['serial_ms']:.3f} "
                "ms/step, distributed " + ", ".join(
                    f"rank {r['rank']} {r['coords']} {r['ms']:.3f}"
                    for r in reps)
                + f" ms/step (CUDA events) on {card}, no scaling figure "
                f"(the ranks share one card); exchange tables built in "
                f"{max(r['tables_s'] for r in reps):.1f} s; collectives a "
                f"step on rank 0 {r0['collectives_a_step']}; no port kernel "
                "launched; distributed vs serial " + ", ".join(
                    f"{k} {v:.3e}" for k, v in r0["rel"].items())
                + f" of the largest value (tolerance {DIST_CUBE_RTOL}); "
                + ", ".join(f"{k} drift {v:.3e}"
                            for k, v in r0["conservation"].items())
                + f" (tolerance {cons})")
            require(all(v <= DIST_CUBE_RTOL for v in r0["rel"].values()),
                    f"{tag}: distributed vs serial {r0['rel']}")
            require(all(v <= cons for v in r0["conservation"].values()),
                    f"{tag}: conservation {r0['conservation']}")
            out[tag] = reps

        # NCCL at world size 1: it initialises, sizes its pencils and steps
        spec = dict(kind="weno", size=(256, 256, 256), dtype="float32",
                    serial=True)
        r0 = run("27a_nccl", 1, dist_nccl_rank, spec, Partition(1, 1),
                 backend="nccl", device="cuda")[0]
        require(r0["backend"] == "nccl", "the one-rank group is NCCL")
        log(f"[27] 27a nccl world size 1: serial {r0['serial_ms']:.3f} "
            f"ms/step, sharded {r0['ms']:.3f} ms/step on {card}; launches "
            f"{r0['launches']}; sharded vs serial " + ", ".join(
                f"{k} {v:.3e}" for k, v in r0["rel"].items())
            + f" (tolerance {DIST_NH_RTOL})")
        require(all(v <= DIST_NH_RTOL for v in r0["rel"].values()),
                f"27a nccl: sharded vs serial {r0['rel']}")
        for name, n in r0["launches"].items():
            launches[name] = launches.get(name, 0) + n
        out["27a nccl"] = r0
    return out


# ---------------------------------------------------------------------------
# Phase 28: ``sharded_step_fn``, the counterpart of the JAX package's GSPMD
# step, at full width (the rank programs are module-level, as phase 27's)
# ---------------------------------------------------------------------------

#: warm-up and timed steps of each serial and sharded run of phase 28
GSPMD_WARM, GSPMD_TIMED = 2, 10
#: sharded against serial in float32, relative to the largest value of
#: each group: the serial phase's bound of its kernel path against its
#: plain path (phase 13's for ``hydro_vi_closure``, phase 8's for the
#: shallow water, phase 7's for the WENO and Centered-2 models; the
#: hydrostatic bounds of phase 9 for the z-star CATKE ocean too, whose
#: phase 25 holds no float32 pair of paths, and whose w, the small
#: difference of two terms under z-star, no hydrostatic part compares). The
#: float32 Langmuir LES, whose velocities are the residual of its
#: hydrostatic balance, is held as phase 21 holds its float32 paths, to
#: the rounding of its projection: phase 21's bound on max|∇·u|,
#: depth·eps32·Δt·max|p|/Δz², with the depth of its solve's sums,
#: log2(Nx·Ny·Nz) for cuFFT's radix stages and Nx + Ny + Nz for the
#: basis products of the pencil solver (and of the serial
#: ``MatmulPoissonSolver``, whose bases they are), each a dense sum along
#: a whole axis; every run at its solve's bound (given as the ratio to
#: it, limit 1); the velocities of two runs apart by at most the sum of
#: their floors, depth·eps32·Δt·max|p|/Δz (the ratio to that sum, limit
#: 1); the tracers and particles at phase 7's 3e-5 of their largest value
GSPMD_RTOL = {"hydro_vi_closure": DIST_HY_RTOL, "tripolar": DIST_HY_RTOL,
              "hydro_zstar_catke": DIST_HY_RTOL,
              "langmuir": {"velocities": 1.0, "tracers": 3e-5,
                           "particles": 3e-5, "div": 1.0,
                           "div serial": 1.0, "div basis": 1.0,
                           "basis velocities": 1.0},
              "scaling": {"velocities": 3e-5, "tracers": 3e-5},
              "default": {"velocities": 3e-5},
              "sw": {"transports": 1e-2, "h": 1e-4}}


def gspmd_config(spec, device):
    """``(model, initial_state, dt, per_step)`` of a phase-28 part: the
    model on its global grid, the initial state's builder, Δt and the
    kernels each rank must launch a step."""
    import torch

    import oceananigans_torch as ot
    from oceananigans_torch.profile_step import (
        HYDRO_DT, LANGMUIR_DT, hydro_generic_state, initial_state,
        langmuir_initial_state, langmuir_model, langmuir_particles,
        sw_initial_state, sw_model,
    )
    dtype = getattr(torch, spec["dtype"])
    kind, size = spec["kind"], spec["size"]
    if kind == "hydro_vi_closure":
        return (hydro_closure_model(torch, ot, "auto", dtype, device,
                                    size=size),
                hydro_generic_state, HYDRO_DT,
                {"vi_momentum_tendency": 1, "weno_tracer_tendencies": 1})
    if kind == "hydro_zstar_catke":
        # phase 22's hydro_catke (CATKE, its callable u wind stress) under
        # ZStar(), from hydro_vi's fields without their exact zeros: the
        # σ-scaled grid takes no kernel (as in the JAX package), and
        # CATKE's surface cell height is the global halo corner's σ·Δz on
        # every block, one all-reduce of a number each time the closure
        # runs
        from oceananigans_torch.profile_step import (
            HYDRO_CATKE_DT, hydro_catke_model, hydro_latlon_initial_state,
        )
        return (hydro_catke_model("auto", dtype, device, size=size,
                                  vertical_coordinate=ot.ZStar()),
                lambda m: m.update_state(
                    hydro_latlon_initial_state(m, generic=True)),
                HYDRO_CATKE_DT, {})
    if kind == "tripolar":
        # phase 14's tripolar ocean, which no kernel takes (as in the JAX
        # package), from hydro_vi's fields without their exact zeros, at
        # FOLD_DT
        from oceananigans_torch.profile_step import (
            hydro_latlon_initial_state,
        )
        grid = ot.TripolarGrid(size=size, z=(-4000.0, 0.0), halo=(6, 6, 4),
                               dtype=dtype, device=device)
        model = ot.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=ot.WENOVectorInvariant(),
            tracer_advection=ot.WENO(7), tracers=("T", "S"),
            buoyancy=ot.SeawaterBuoyancy(
                equation_of_state=ot.LinearEquationOfState()),
            free_surface=ot.SplitExplicitFreeSurface(substeps=30))
        return (model, lambda m: m.update_state(
            hydro_latlon_initial_state(m, generic=True)), FOLD_DT, {})
    if kind == "langmuir":
        return (langmuir_model(size=size, dtype=dtype, device=device,
                               particles=langmuir_particles(
                                   spec["particles"])),
                langmuir_initial_state, LANGMUIR_DT,
                {"weno5_momentum_tendency": 1, "weno5_tracer_tendencies": 1})
    if kind == "scaling":
        # examples/multi_chip_scaling.py's model, with sponges of u and b
        # masked in x (the blocks' true coordinates decide where they act),
        # from bench.py's initial state: the example's own u = 0.01 sin 2πx
        # is a gradient, which the initial projection removes whole, so
        # its flow would be rounding noise
        grid = ot.RectilinearGrid(
            size=size, extent=(1.0, 1.0, 1.0),
            topology=(ot.Periodic, ot.Periodic, ot.Bounded), halo=3,
            dtype=dtype, device=device)
        mask = ot.GaussianMask(0.9, 0.05, "x")
        model = ot.NonhydrostaticModel(
            grid=grid, advection=ot.WENO(5), tracers=("b",),
            buoyancy=ot.BuoyancyTracer(), coriolis=ot.FPlane(f=1e-4),
            forcing={"u": ot.Relaxation(rate=10.0, mask=mask),
                     "b": ot.Relaxation(rate=10.0, mask=mask,
                                        target=ot.LinearTarget(
                                            0.0, 0.01, "z"))})
        return (model, initial_state, 1e-3,
                {"weno5_momentum_tendency": 3, "weno5_tracer_tendencies": 3})
    if kind == "default":
        # bench.py's default: Centered(2), quasi-AB2, halo (1, 0, 0)
        grid = ot.RectilinearGrid(
            size=size, extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=(1, 0, 0),
            dtype=dtype, device=device)
        return (ot.NonhydrostaticModel(grid=grid,
                                       timestepper="QuasiAdamsBashforth2"),
                initial_state, 1e-4, {"centered2_momentum_tendency": 1})
    if kind == "sw":
        return (sw_model(size[0], dtype=dtype, device=device),
                sw_initial_state, 1.0, {"sw_rk3_stage": 3})
    raise ValueError(kind)


def gspmd_rel(kind, g, a, b, dt, basis=None):
    """Sharded state ``a`` against serial state ``b``, by group, relative
    to the largest value of each group (the float32 Langmuir LES's
    velocities and divergences as the ratio to its projections' rounding
    bounds, with ``basis`` the serial run through the basis products; see
    :data:`GSPMD_RTOL`)."""
    import torch
    if kind == "sw":
        xy = [(g.interior(a.uh), g.interior(b.uh)),
              (g.interior(a.vh), g.interior(b.vh))]
        return {"transports": group_rel(xy),
                "h": group_rel([(g.interior(a.h), g.interior(b.h))])}
    if kind == "langmuir":
        rel = les_compare_fields(g, a, b, dt, ("b", "P"))
        out = {"velocities": rel["velocities"],
               "tracers": max(rel["b"], rel["P"]),
               "particles": particle_rel(a, b)}
        if g.dtype == torch.float32:
            from oceananigans_torch.ops.operators import divergence_ccc
            dz = g.spacing(2)
            pmax = float(g.interior(b.pressure).abs().max())
            unit = torch.finfo(torch.float32).eps * dt * pmax / dz
            fft = math.log2(g.N[0] * g.N[1] * g.N[2]) * unit
            dense = (g.N[0] + g.N[1] + g.N[2]) * unit

            def gap(p, q):
                return max(float((g.interior(x) - g.interior(y)).abs().max())
                           for x, y in ((p.u, q.u), (p.v, q.v), (p.w, q.w)))

            def div(st):
                return float(g.interior(divergence_ccc(
                    g, st.u, st.v, st.w)).abs().max()) * dz
            out["velocities"] = gap(a, b) / (fft + dense)
            out["div"] = div(a) / dense
            out["div serial"] = div(b) / fft
            # phase 21's bound, to show what the basis products exceed
            out["div at phase 21's bound"] = div(a) / fft
            if basis is not None:
                out["basis velocities"] = gap(basis, b) / (fft + dense)
                out["div basis"] = div(basis) / dense
                out["div basis at phase 21's bound"] = div(basis) / fft
                out["velocities vs basis"] = gap(a, basis) / (2 * dense)
        return out
    hydro = kind in ("hydro_vi_closure", "tripolar", "hydro_zstar_catke")
    ga = dist_groups(g, a, hydro)
    gb = dist_groups(g, b, hydro)
    return {k: group_rel(list(zip(ga[k], gb[k]))) for k in gb}


def gspmd_block_kernels(torch, ot, lg, kind, gen):
    """The part's kernels against their plain versions at the rank's block
    shape: phase 27's, and the shallow-water stage kernel."""
    if kind != "sw":
        return dist_block_kernels(torch, ot, lg, {
            "hydro_vi_closure": "hydro", "langmuir": "weno",
            "scaling": "weno", "default": "centered"}[kind], gen)
    from oceananigans_torch.ops import cuda_sw as csw
    fs = [ot.fill_halo_regions(1000.0 + torch.randn(
        lg.shape, generator=gen, device=lg.device, dtype=lg.dtype), lg,
        loc=loc) for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_C)]
    G = [torch.randn(lg.shape, generator=gen, device=lg.device,
                     dtype=lg.dtype) for _ in range(3)]
    # the stage writes over its operands: each call takes its own copies
    k = csw.sw_rk3_stage(lg, *[q.clone() for q in fs + G], 0.5, -0.25,
                         9.81)
    p = csw.sw_rk3_stage_plain(lg, *[q.clone() for q in fs + G], 0.5,
                               -0.25, 9.81)
    torch.cuda.synchronize()
    return {"sw_rk3_stage": (max(float((a - b).abs().max())
                                     for a, b in zip(k, p)),
                             max(float(b.abs().max()) for b in p))}


def gspmd_part_rank(dist, spec):
    """One phase-28 part on this rank: the model on its global grid
    (every rank), ``sharded_step_fn`` of it, the serial run (rank 0) and
    the sharded run (every rank, the global state in and out on rank 0)
    from the same state; this rank's report."""
    import torch

    import oceananigans_torch as ot
    from oceananigans_torch.parallel import sharded_step_fn
    from oceananigans_torch.parallel.distributed import _map_tensors
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = dist_wrappers()
    model, init, dt, per_step = gspmd_config(spec, dist.device)
    step = sharded_step_fn(model, dist, dt)
    dstep = step.dstep
    lg = dstep.local_grid
    rep = {"rank": dist.rank, "coords": dist.coords, "block": tuple(lg.N),
           "halo": tuple(lg.H)}
    warm, timed = spec.get("steps", (GSPMD_WARM, GSPMD_TIMED))
    steps = warm + timed
    s0 = init(model) if dist.rank == 0 else None
    serial = basis = None
    if spec.get("check") == "every rank" or (spec.get("check")
                                             and dist.rank == 0):
        gen = torch.Generator(device=dist.device).manual_seed(28)
        rep["block_kernels"] = gspmd_block_kernels(
            torch, ot, lg, spec["kind"], gen)
    if dist.rank == 0:
        st = _map_tensors(s0, lambda t: t.clone())
        for _ in range(warm):
            st = model.step(st, dt)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(timed):
            st = model.step(st, dt)
        e1.record()
        e1.synchronize()
        rep["serial_ms"] = e0.elapsed_time(e1) / timed
        serial = st
        if spec.get("basis"):
            # the serial run through the basis products of the pencil
            # solver (the serial MatmulPoissonSolver's bases, unfused)
            from oceananigans_torch.solvers.matmul_poisson import (
                MatmulPoissonSolver,
            )
            fft = model.pressure_solver
            model.pressure_solver = MatmulPoissonSolver(model.grid)
            st = _map_tensors(s0, lambda t: t.clone())
            for _ in range(steps):
                st = model.step(st, dt)
            model.pressure_solver = fft
            basis = st
    dist.barrier()
    for fn in wrappers.values():
        fn.launches = 0
    dist.reset_counts()
    st = s0
    for _ in range(warm):
        st = step(st)
    torch.cuda.synchronize()
    dist.barrier()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(timed):
        st = step(st)
    e1.record()
    e1.synchronize()
    dist.barrier()
    rep["ms"] = e0.elapsed_time(e1) / timed
    rep["wall_ms"] = (time.perf_counter() - t0) * 1e3 / timed
    rep["launches"] = {k: fn.launches for k, fn in wrappers.items()
                       if fn.launches}
    rep["transfers_a_step"] = {k: v / steps for k, v in dist.counts.items()}
    for name, per in per_step.items():
        require(rep["launches"].get(name, 0) == per * steps,
                f"{spec['kind']} rank {dist.rank}: {name} launched "
                f"{rep['launches'].get(name, 0)} times in {steps} steps "
                f"(want {per} a step)")
    others = [k for k in rep["launches"] if k not in per_step]
    require(not others, f"{spec['kind']} rank {dist.rank}: unexpected "
            f"launches {others}")
    if dist.rank == 0:
        require(all(bool(torch.isfinite(q).all())
                    for q in st.fields().values()),
                f"{spec['kind']}: finite fields")
        if spec["kind"] == "tripolar":
            rep["courant"] = barotropic_courant(model, dt)
            rep["umax"] = [float(model.grid.interior(q.u).abs().max())
                           for q in (s0, serial)]
        rep["rel"] = gspmd_rel(spec["kind"], model.grid, st, serial, dt,
                               basis)
        fields, ref = st.fields(), serial.fields()
        rep["bitwise"] = all(torch.equal(q, ref[k])
                             for k, q in fields.items())
    del model, step, dstep, st, s0, serial, basis
    torch.cuda.empty_cache()
    return rep


def gspmd_parts_rank(dist, specs):
    """Several phase-28 parts in one spawn of ranks, each over its own
    partition (``spec["partition"]``): this rank's reports."""
    from oceananigans_torch.parallel import Distributed, Partition
    return [gspmd_part_rank(Distributed(Partition(*spec["partition"]),
                                        device=dist.device), spec)
            for spec in specs]


#: the parts of phase 28, float32 at full width and float64 at a small
#: size (uneven blocks where the full width has them)
GSPMD_PARTS = {
    "28a hydro_vi_closure": dict(
        kind="hydro_vi_closure", size=(360, 160, 60), dtype="float32",
        partition=(2, 2), check=True),
    "28a hydro_vi_closure float64": dict(
        kind="hydro_vi_closure", size=(48, 16, 6), dtype="float64",
        partition=(2, 2)),
    "28b langmuir": dict(
        kind="langmuir", size=(256, 256, 256), dtype="float32",
        particles=LANGMUIR_PARTICLES, partition=(2, 2), check=True,
        basis=True),
    "28b langmuir float64": dict(
        kind="langmuir", size=(16, 16, 16), dtype="float64",
        particles=4096, partition=(2, 2)),
    "28c multi_chip_scaling": dict(
        kind="scaling", size=(250, 256, 256), dtype="float32",
        partition=(4, 1), check=True),
    "28c multi_chip_scaling float64": dict(
        kind="scaling", size=(26, 16, 16), dtype="float64",
        partition=(4, 1)),
    "28c default": dict(
        kind="default", size=(256, 256, 256), dtype="float32",
        partition=(1, 4), check=True),
    "28c default float64": dict(
        kind="default", size=(16, 16, 16), dtype="float64",
        partition=(1, 4)),
    "28d sw8192": dict(
        kind="sw", size=(8192,), dtype="float32", partition=(4, 1),
        check=True),
    "28d sw8192 float64": dict(
        kind="sw", size=(64,), dtype="float64", partition=(4, 1)),
    "28e hydro_zstar_catke": dict(
        kind="hydro_zstar_catke", size=(360, 160, 60), dtype="float32",
        partition=(2, 2)),
    "28e hydro_zstar_catke float64": dict(
        kind="hydro_zstar_catke", size=(24, 12, 4), dtype="float64",
        partition=(2, 2)),
}


#: Δt of phase 29a's tripolar ocean. The cells beside the grid's two
#: north poles are about a hundredth as wide as the median cell, and there
#: the split-explicit substeps' gravity waves cross nearly a cell a
#: substep at phase 14's 60 s, and their velocities grow every step: the
#: phase prints the largest Courant number (:func:`barotropic_courant`)
#: and max|u| before and after its steps
FOLD_DT = 20.0


def barotropic_courant(model, dt):
    """The largest Courant number c Δτ √(1/Δx² + 1/Δy²) of a split-explicit
    free surface's substeps over the cells of a hydrostatic model's grid,
    at their centre spacings: c = √(g Lz) the gravity waves' speed over
    the grid's full depth, Δτ the substep (Δt times its fraction)."""
    g, fs = model.grid, model.free_surface
    c = math.sqrt(fs.g * g.Lz)
    dtau = dt * fs.fractional_step
    xy = g.interior_slices[:2]
    dx, dy = g.dx()[xy], g.dy()[xy]
    return float((c * dtau * (dx ** -2 + dy ** -2).sqrt()).max())


#: the parts of phase 29: phase 14's tripolar ocean over (4, 1), every
#: rank folding against another, and (2, 2), the top row folding (no
#: kernel), at :data:`FOLD_DT`; ``examples/multi_chip_scaling.py``'s model
#: on x blocks of 3, 3, 2 and 2 cells under a halo of 3 (kernels 7 and 9
#: three times a rank a step, held against their plain versions on every
#: rank's block); each with a float64 run at a small size, and the
#: tripolar ocean with one float64 step at full width
FOLD_PARTS = {
    "29a tripolar (4, 1)": dict(
        kind="tripolar", size=(360, 170, 60), dtype="float32",
        partition=(4, 1)),
    "29a tripolar (2, 2)": dict(
        kind="tripolar", size=(360, 170, 60), dtype="float32",
        partition=(2, 2)),
    "29a tripolar float64 one step": dict(
        kind="tripolar", size=(360, 170, 60), dtype="float64",
        partition=(4, 1), steps=(0, 1)),
    "29a tripolar float64": dict(
        kind="tripolar", size=(48, 20, 6), dtype="float64",
        partition=(2, 2)),
    "29b narrow multi_chip_scaling": dict(
        kind="scaling", size=(10, 256, 256), dtype="float32",
        partition=(4, 1), check="every rank"),
    "29b narrow multi_chip_scaling float64": dict(
        kind="scaling", size=(10, 16, 16), dtype="float64",
        partition=(4, 1)),
}


def gspmd_phase(torch, card, launches, parts=None, phase="28"):
    """Phase 28 (``parts`` None: :data:`GSPMD_PARTS`) or 29
    (:data:`FOLD_PARTS`): ``sharded_step_fn`` at full width on the card in
    one spawn of four gloo ranks (see the docstring)."""
    import tempfile

    from oceananigans_torch.parallel import launch

    from oceananigans_torch.profile_step import HYDRO_DT

    parts = GSPMD_PARTS if parts is None else parts
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        by_rank = launch(4, gspmd_parts_rank, (list(parts.values()),),
                         rendezvous_dir=f"{tmp}/{phase}", backend="gloo",
                         device="cuda:0")
        log(f"[{phase}] 4 gloo ranks on cuda:0 in "
            f"{time.perf_counter() - t0:.1f} s")
    for k, (tag, spec) in enumerate(parts.items()):
        reps = [r[k] for r in by_rank]
        r0 = reps[0]
        per_rank = [r["launches"] for r in reps]
        for name in per_rank[0]:
            launches[name] = launches.get(name, 0) + sum(
                r["launches"].get(name, 0) for r in reps)
        for r in reps:
            for name, (err, sc) in r.get("block_kernels", {}).items():
                tol = (DIST_KERNEL_RTOL.get(name, 1e-5)) * sc
                log(f"[{phase}] {tag}: rank {r['rank']}'s {name} at its "
                    f"block shape {r['block']} (halo {r['halo']}): "
                    f"max|kernel - plain| {err:.3e} (tolerance {tol:.3e})")
                require(err <= tol, f"{tag}: {name} at {r['block']}")
        rel = r0["rel"]
        bound = ({g: DIST_F64_RTOL for g in rel}
                 if spec["dtype"] == "float64"
                 else GSPMD_RTOL[spec["kind"]])
        if spec["kind"] == "hydro_zstar_catke":
            # CATKE's surface cell height: the block at mesh (0, 0) holds
            # the global halo corner, and every rank takes its value
            surface = [r["transfers_a_step"].get("surface_dz", 0.0)
                       for r in reps]
            log(f"[{phase}] {tag}: all-reduces of CATKE's surface cell "
                f"height a step by rank {surface} (one each time the "
                "closure runs); sharded bitwise equal to serial: "
                f"{r0['bitwise']}")
            require(min(surface) >= 1 and len(set(surface)) == 1,
                    f"{tag}: surface-height all-reduces a step {surface}")
        if spec["kind"] == "tripolar":
            log(f"[{phase}] {tag} fold transfers a step by rank: "
                + ", ".join(f"rank {r['rank']} " + str({
                    k2: v for k2, v in r["transfers_a_step"].items()
                    if k2.startswith("fold")}) for r in reps)
                + f"; sharded bitwise equal to serial: {r0['bitwise']}; "
                f"the substeps' largest Courant number {r0['courant']:.3f} "
                f"(phase 14's Δt {HYDRO_DT:g} s: "
                f"{r0['courant'] * HYDRO_DT / FOLD_DT:.3f}); serial max|u| "
                f"{r0['umax'][0]:.4e} at the start, {r0['umax'][1]:.4e} "
                "after the steps")
        log(f"[{phase}] {tag} {spec['size']} {spec['dtype']}, Partition"
            f"{spec['partition']}, blocks "
            f"{[tuple(r['block'][:2]) for r in reps]}, local halos "
            f"{r0['halo']}: serial {r0['serial_ms']:.3f} ms/step, "
            "sharded_step_fn (scatter, step, gather) " + ", ".join(
                f"rank {r['rank']} {r['ms']:.3f}" for r in reps)
            + f" ms/step (CUDA events; host wall "
            f"{max(r['wall_ms'] for r in reps):.3f}) on {card}; the 4 "
            f"ranks share one card, so these are no scaling figure; "
            f"launches per rank in "
            f"{sum(spec.get('steps', (GSPMD_WARM, GSPMD_TIMED)))} steps "
            f"{per_rank}; transfers a step on rank 0 "
            f"{r0['transfers_a_step']}; sharded vs serial " + ", ".join(
                f"{g} {v:.3e}" for g, v in rel.items())
            + " of the largest value" + (
                " (velocities and max|∇·u| as the ratio to the rounding "
                "bounds of their projections: the serial run's cuFFT, "
                "depth log2(N³), the sharded and the serial basis-product "
                "run's dense sums, depth Nx + Ny + Nz, see GSPMD_RTOL; "
                "the ratios 'at phase 21's bound' printed, not held)"
                if "div" in rel else "")
            + f" (tolerance {bound})")
        require(all(rel[g] <= bound[g] for g in bound),
                f"{tag}: sharded vs serial {rel}")
        out[tag] = reps
    return out


#: phase 30: ``EnsembleModel`` on the card. Steps of each run (the first
#: untimed), and the bound of a member against its serial run with the
#: same kernels, relative to each field's largest value: the kernels'
#: outputs are the serial ones bit for bit (the same kernel per member);
#: the batched FFTs and reductions of the plain parts round otherwise
#: (~1e-16 of the velocities in float64 on the CPU,
#: ``tests/test_torch_ensemble.py``), so a few float32 ulps
ENS30_STEPS = 3
ENS30_RTOL = 1e-5
#: the nonhydrostatic models' N³ (phases 4 to 7)
ENS30_N = 256
#: 30a: phases 4-9's models; name: (configuration, timestepper, members,
#: kernel launches a member-step)
ENS30_RUNS = {
    "default": ("default", "QuasiAdamsBashforth2", 4,
                {"centered2_ab2_update": 1}),
    "default_rk3": ("default", "RungeKutta3", 4,
                    {"centered2_momentum_tendency": 3}),
    "science": ("science", "QuasiAdamsBashforth2", 4,
                {"centered2_science_ab2_update": 1}),
    "weno": ("weno", "QuasiAdamsBashforth2", 4,
             {"weno5_science_ab2_update": 1}),
    "weno_rk3": ("weno", "RungeKutta3", 4,
                 {"weno5_momentum_tendency": 3,
                  "weno5_tracer_tendencies": 3}),
    "weno_mom": ("weno_mom", "QuasiAdamsBashforth2", 4,
                 {"weno5_ab2_update": 1}),
    "sw8192": ("sw8192", None, 2, {"sw_rk3_stage": 3}),
    "hydro_vi": ("hydro_vi", None, 4, {"weno_tracer_tendencies": 1,
                                       "vi_momentum_tendency": 1}),
}


def member_state(state, amp, keys):
    """``state`` with the fields ``keys`` scaled by ``amp``; every tensor a
    copy (the AB2 kernels write G⁻ in place)."""
    from oceananigans_torch.interop import flatten_state, unflatten_state
    flat = flatten_state(state)
    return unflatten_state(state, {
        k: (v * amp if k in keys else v.clone()) if hasattr(v, "clone")
        else v for k, v in flat.items()})


def field_interiors(grid, state):
    """The interior of each of the state's fields (η over its x-y
    interior)."""
    xy = grid.interior_slices[:2]
    return {k: grid.interior(q) if tuple(q.shape) == tuple(grid.shape)
            else q[xy] for k, q in state.fields().items()}


def hydro_groups30(bound):
    """The groups of phase 9's comparisons (``hydro_groups``), each at
    ``bound``, for :func:`ensemble_run`."""
    return {"velocities": (["u", "v"], bound), "w": (["w"], bound),
            "eta": (["eta"], bound), "tracers": (["T", "S"], bound)}


def ensemble_run(torch, ot, wrappers, card, tag, model, s0, dt, n, keys,
                 per_step, bounds=None, each=None):
    """``n`` members of ``model`` from ``s0`` with the fields ``keys``
    scaled by seeded amplitudes: :data:`ENS30_STEPS` batched steps (the
    last ones timed, CUDA events) with the kernels' launches counted, then
    each member's serial run of the same steps, and member 0's serial run
    once more (the serial runs' own spread). Each field's largest
    difference relative to its largest value is printed; ``bounds``: group
    -> (its fields, bound), held relative to the group's largest value
    (default: every field alone at :data:`ENS30_RTOL`). ``each(key)`` is
    called after every step (``key`` "batched" or the member's index) and
    its results logged."""
    gen = torch.Generator().manual_seed(30)
    amps = (1.0 + 0.5 * torch.rand(n, generator=gen,
                                   dtype=torch.float64)).tolist()
    states = [member_state(s0, a, keys) for a in amps]
    again = member_state(s0, amps[0], keys)
    ens = ot.EnsembleModel(model, n=n)
    S = ens.stack(states)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    seen = {}

    def steps(state, step, key):
        state = step(state, dt)
        if each:
            seen.setdefault(key, []).append(each(key))
        torch.cuda.synchronize()
        e0.record()
        for _ in range(ENS30_STEPS - 1):
            state = step(state, dt)
            if each:
                seen[key].append(each(key))
        e1.record()
        e1.synchronize()
        return state, e0.elapsed_time(e1) / (ENS30_STEPS - 1)

    for fn in wrappers.values():
        fn.launches = 0
    S, batched_ms = steps(S, ens.step, "batched")
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    want = {k: per * n * ENS30_STEPS for k, per in per_step.items()}
    g = model.grid
    groups = bounds or {k: ([k], ENS30_RTOL) for k in s0.fields()}
    serial_ms, rel, rel_grp = [], [], []
    for m, s in enumerate(states):
        s, ms = steps(s, model.step, m)
        serial_ms.append(ms)
        got, ref = field_interiors(g, ens.member(S, m)), field_interiors(g, s)
        require(all(bool(torch.isfinite(q).all()) for q in got.values()),
                f"30 {tag}: member {m} finite")
        rel.append({k: group_rel([(got[k], ref[k])]) for k in ref})
        rel_grp.append({grp: group_rel([(got[k], ref[k]) for k in names])
                        for grp, (names, _) in groups.items()})
        if m == 0:
            first = ref
    for _ in range(ENS30_STEPS):
        again = model.step(again, dt)
    spread = max(group_rel([(q, first[k])])
                 for k, q in field_interiors(g, again).items())
    worst = {grp: max(r[grp] for r in rel_grp) for grp in groups}
    limit = {grp: b for grp, (_, b) in groups.items()}
    log(f"[30] {tag}: {n} members (amplitudes {[round(a, 4) for a in amps]})"
        f" x {ENS30_STEPS} steps by EnsembleModel on {card}: batched "
        f"{batched_ms:.3f} ms/step against {n} x serial "
        f"{sum(serial_ms):.3f} ms/step ({[round(x, 3) for x in serial_ms]});"
        f" kernel launches {counts} (want {want}); each member against its "
        f"serial run with the same kernels, each field's largest difference "
        f"relative to its largest value: "
        + "; ".join(f"member {m} " + ", ".join(
            f"{k} {v:.3e}" for k, v in r.items())
            for m, r in enumerate(rel))
        + f"; member 0's serial run repeated: {spread:.3e}; held by group "
        f"{list(groups)}: worst {worst} (bounds {limit})"
        + (f"; per step {seen}" if each else ""))
    require(counts == want, f"30 {tag}: launches {counts}, want {want}")
    require(all(worst[k] <= limit[k] for k in worst),
            f"30 {tag}: members against serial runs {worst}")
    return {"ms": batched_ms, "serial_ms": serial_ms, "rel": worst,
            "launches": counts, "seen": seen}


def ensemble_phase(torch, ot, wrappers, card, dev, launches, hydro_rtol):
    """Phase 30: ``EnsembleModel`` on the card through the kernels' custom
    operators (one launch per member) and the batched conjugate gradient;
    see the docstring. Adds its launches to ``launches``."""
    from oceananigans_torch.ensemble import member_values
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.profile_step import (
        HYDRO_DT, SEAMOUNT_DT, config_kwargs, hydro_implicit_model,
        hydro_initial_state, hydro_model, initial_state,
        seamount_initial_state, seamount_model, sw_initial_state, sw_model,
    )
    out, total = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def full_grid(halo):
        return ot.RectilinearGrid(
            size=(ENS30_N,) * 3, extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
            dtype=torch.float32, device=dev)

    # 30a: phases 4 to 9's models at full width
    for tag, (config, ts, n, per_step) in ENS30_RUNS.items():
        if config == "sw8192":
            model = sw_model(8192)
            s0, dt, keys = sw_initial_state(model), 1.0, ("uh", "vh")
            require(model.fused_rk3, "30 sw8192 takes kernel 10")
        elif config == "hydro_vi":
            model = hydro_model("auto")
            s0 = model.update_state(hydro_initial_state(model))
            # the barotropic transports too, or the split-explicit step
            # takes the depth mean of u and v back to the unscaled U and V
            dt, keys = HYDRO_DT, ("u", "v", "U", "V")
            require(model.fused_kernels and model.fused_tracer,
                    "30 hydro_vi takes kernels 11 and 12/13")
        else:
            kwargs, halo = config_kwargs(config)
            model = ot.NonhydrostaticModel(grid=full_grid(halo),
                                           timestepper=ts, **kwargs)
            s0, dt, keys = initial_state(model), 1e-4, ("u", "v", "w")
            require(model.fused_kernels, f"30 {tag} takes the kernels")
        out[tag] = ensemble_run(
            torch, ot, wrappers, card, f"30a {tag}", model, s0, dt, n, keys,
            per_step, bounds=hydro_groups30(ENS30_RTOL) if config == "hydro_vi"
            else None)
        add(out[tag]["launches"])
        del model, s0
        torch.cuda.empty_cache()

    # 30b: rows 3 and 4 through phase 6's opt-in path; row 14 under vmap
    model = ot.NonhydrostaticModel(grid=full_grid((1, 0, 0)),
                                   timestepper="QuasiAdamsBashforth2")
    model.fused_correction = True
    model.pressure_solver = ot.MatmulPoissonSolver(model.grid, fused=True)
    out["opt_in"] = ensemble_run(
        torch, ot, wrappers, card, "30b opt-in", model,
        initial_state(model), 1e-4, 2, ("u", "v", "w"),
        {"centered2_ab2_update": 1, "pressure_correction": 1,
         "fused_middle_solve": 1})
    add(out["opt_in"]["launches"])
    del model
    torch.cuda.empty_cache()
    sch = ot.WENO(5)
    g10 = full_grid((sch.required_halo, 0, 0))
    gen = torch.Generator(device=dev).manual_seed(30)
    members = [[ot.fill_halo_regions(
        torch.randn(g10.shape, generator=gen, device=dev), g10, loc=loc)
        for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_W)] for _ in range(2)]
    stacked = [torch.stack(q) for q in zip(*members)]
    for fn in wrappers.values():
        fn.launches = 0
    batched = torch.func.vmap(
        lambda u, v, w: cg.fused_momentum_tendency(g10, sch, u, v, w))(
            *stacked)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    require(counts == {"fused_momentum_tendency": 2},
            f"30b row 14 under vmap launched {counts}")
    add(counts)
    equal = all(torch.equal(batched[i][m], ref)
                for m in range(2) for i, ref in enumerate(
                    cg.fused_momentum_tendency(g10, sch, *members[m])))
    log(f"[30] 30b fused_momentum_tendency (WENO(5), {tuple(g10.shape)}) "
        f"under torch.func.vmap over 2 members on {card}: launches {counts};"
        f" bit for bit against two direct calls: {equal}")
    require(equal, "30b row 14 under vmap equals two direct calls")
    del members, stacked, batched
    torch.cuda.empty_cache()

    # 30c: the batched conjugate gradient
    model = hydro_implicit_model("auto", solver_method="cg")
    fs = model.free_surface

    def implicit_each(key):
        i = model.free_surface_info
        return ([int(x) for x in member_values(i["iterations"]).reshape(-1)],
                i["host_syncs"])

    groups = {k: (names, hydro_rtol["velocities" if k == "w" else k])
              for k, (names, _) in hydro_groups30(None).items()}
    out["implicit_cg"] = ensemble_run(
        torch, ot, wrappers, card, f"30c hydro_implicit cg (maxiter "
        f"{fs.maxiter}, reltol {fs.reltol:g}; per step: [each member's CG "
        "iterations], host reads of the flag)", model,
        model.update_state(hydro_initial_state(model)), HYDRO_DT, 4,
        ("u", "v", "U", "V"),
        {"weno_tracer_tendencies": 1, "vi_momentum_tendency": 1},
        bounds=groups, each=implicit_each)
    add(out["implicit_cg"]["launches"])
    del model
    torch.cuda.empty_cache()
    model = seamount_model()
    solver = model.pressure_solver

    def seamount_each(key):
        return ([int(x) for x in member_values(solver.iterations).reshape(-1)],
                solver.host_syncs)

    cg_rtol = 10 * solver.reltol
    out["seamount"] = ensemble_run(
        torch, ot, wrappers, card, f"30c seamount {tuple(model.grid.N)} "
        f"(reltol {solver.reltol:g}, FFT preconditioner; per step: [each "
        "member's CG iterations], host reads of the flag)", model,
        seamount_initial_state(model), SEAMOUNT_DT, 2, ("u", "v", "w"), {},
        bounds={"velocities": (["u", "v", "w"], cg_rtol),
                "b": (["b"], cg_rtol)}, each=seamount_each)
    del model, solver
    torch.cuda.empty_cache()

    # 30d: no gradient through a kernel
    grads = {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = ot.NonhydrostaticModel(grid=full_grid((1, 0, 0)),
                                       timestepper="QuasiAdamsBashforth2",
                                       fused_kernels=fused)
        s0 = initial_state(model)
        u0 = s0.u.clone().requires_grad_(True)
        for fn in wrappers.values():
            fn.launches = 0
        # the step fills u's halos in place: a copy of the leaf
        s1 = model.step(dataclasses.replace(s0, u=u0.clone()), 1e-4)
        loss = (s1.u ** 2).sum()
        counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        try:
            (g,) = torch.autograd.grad(loss, u0)
            grads[path] = ("finite" if bool(torch.isfinite(g).all())
                           else "not finite", float(g.abs().max()), counts)
        except RuntimeError as err:
            grads[path] = ("RuntimeError", str(err).splitlines()[0], counts)
        del model, s0, s1, u0, loss
        torch.cuda.empty_cache()
    log(f"[30] 30d torch.autograd.grad of Σu'² through one AB2 step of the "
        f"{ENS30_N}^3 default model with u requiring grad, on {card}: {grads}")
    require(grads["kernel"][0] == "RuntimeError"
            and "autograd" in grads["kernel"][1]
            and grads["kernel"][2] == {"centered2_ab2_update": 1},
            "30d the kernel path's gradient raises")
    require(grads["plain"][0] == "finite" and grads["plain"][1] > 0
            and not grads["plain"][2], "30d the plain path's gradient")
    rows = sorted(total)
    require(set(rows) == set(wrappers), f"30: rows launched under vmap "
            f"{rows}, every row wanted")
    for k, v in total.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[30] every kernel launched under vmap: {total}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device is available; "
                         "this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import oceananigans_torch as ot
    from oceananigans_torch.ops import _build, cuda_kernels as ck
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.ops import cuda_poisson as cp
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.ops import cuda_weno as cw
    from oceananigans_torch.ops.operators import divergence_ccc
    from oceananigans_torch.profile_step import (
        HYDRO_DT, _kernel_time_us, config_kwargs, hydro_generic_state,
        hydro_initial_state, hydro_model, initial_state, sw_initial_state,
        sw_model,
    )

    dev = torch.device("cuda", 0)
    f32 = torch.float32

    # ---- phase 1: the card ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # ---- phase 2: build ------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"[2] kernel library ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            log(f"[2]   {line.strip()}")
    # what the kernels compiled to: the float32 Poisson kernel must run on
    # the tensor cores (HGMMA); the WENO-5 tiles must not divide (no
    # FCHK, the IEEE division's slow-path test); their reciprocals
    # (MUFU.RCP) are counted, and the shallow-water strip's instructions
    # (its two IEEE divisions a point, cp.async copies, loads and stores)
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path()[1])],
                          capture_output=True, text=True, check=True).stdout
    tiles = ("weno5_tile", "weno5_science_tile", "weno5_tracer_tile",
             "vi_march", "weno_tracer_march", "generic_march")
    counts = sass_counts(sass, ("poisson_middle_tf32x3", "c2_tile", *tiles),
                         ("HGMMA", "FCHK", "MUFU.RCP"))
    counts.update(sass_counts(sass, ("sw_strip",), (
        "FCHK", "MUFU.RCP", "FFMA", "LDGSTS", "LDG.E", "STG.E", "LDS",
        "BAR.SYNC")))
    log(f"[2] SASS instructions per kernel (every instantiation): {counts}")
    require(counts["poisson_middle_tf32x3"]["HGMMA"] > 0,
            "the float32 Poisson kernel issues tensor-core instructions")
    require(all(counts[k]["FCHK"] == 0 and counts[k]["MUFU.RCP"] > 0
                for k in tiles), "the WENO-5, vector-invariant, tracer and "
            "generic momentum tiles take reciprocals and divide nowhere")
    require(counts["c2_tile"]["FCHK"] == 0,
            "the Centered-2 tendency tile divides nowhere")
    # the dynamic shared memory of a block of the Centered-2 and generic
    # tiles at the main path's plans, from the library and from the
    # wrappers' mirrors of its formula
    import ctypes
    lib = _build.load()
    lib.ot_c2_tile_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ot_c2_tile_smem_bytes.restype = ctypes.c_longlong
    lib.ot_generic_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ot_generic_smem_bytes.restype = ctypes.c_longlong
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = {}
    for itemsize in (4, 8):
        py, pz, seg_len, nseg = ck.tendency_plan((258, 256, 256), sms,
                                                 itemsize)
        got_b = lib.ot_c2_tile_smem_bytes(py, pz, itemsize)
        require(got_b == ck.tile_smem_bytes(py, pz, itemsize),
                "the Centered-2 tile's shared memory equals its mirror")
        smem[f"c2_tile itemsize {itemsize} plan {(py, pz, seg_len, nseg)}"] \
            = got_b
        for B in range(1, 7):
            sch = (ot.Centered(2 * B),) * 3
            py, pz, seg_len, nseg = cg.momentum_plan(
                (256 + 2 * B, 256, 256), B, sch, sms, itemsize)
            got_b = lib.ot_generic_smem_bytes(B, py, pz, itemsize)
            require(got_b == cg.tile_smem_bytes(B, py, pz, itemsize),
                    "the generic tile's shared memory equals its mirror")
            smem[f"generic_march reach {B} itemsize {itemsize} plan "
                 f"{(py, pz, seg_len, nseg)}"] = got_b
    log(f"[2] dynamic shared memory a block (bytes) at the 256^3 plans: "
        f"{smem}")

    # ---- phase 3: kernels against their plain versions ------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def grid_of(N, halo, dtype=f32):
        return ot.RectilinearGrid(
            size=N, extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
            dtype=dtype, device=dev)

    def sw_grid(N, dtype, halo=(8, 0, 0)):
        return ot.RectilinearGrid(
            size=N, x=(0.0, 1e6), y=(0.0, 1e6),
            topology=(ot.Periodic, ot.Periodic, ot.Flat), halo=halo,
            dtype=dtype, device=dev)

    def sw_term_scale(grid, uh, vh, h, g=9.81):
        """The largest single term of the stage stencil: the momentum flux
        |U²/h| and the g·h·|Δh| product, over the spacing."""
        inv = max(grid.Nx / grid.Lx, grid.Ny / grid.Ly)
        flux = float(torch.maximum(uh.abs(), vh.abs()).max()) ** 2 / float(
            h.abs().min())
        dh = max(float((h - torch.roll(h, 1, 0)).abs().max()),
                 float((h - torch.roll(h, 1, 1)).abs().max()))
        return inv * max(flux, g * float(h.abs().max()) * dh)

    def filled_fields(grid, n):
        fs = []
        for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C)[:n]:
            a = torch.randn(grid.shape, generator=gen, device=dev, dtype=f32)
            fs.append(ot.fill_halo_regions(a, grid, loc=loc))
        return fs

    def max_err(got, ref):
        return max(float((g - r).abs().max()) for g, r in zip(got, ref))

    def scale(ref):
        return max(float(r.abs().max()) for r in ref)

    #: the kernels round in another order than the plain versions and
    #: contract into FMA: 8 float32 ulps of the largest value
    STENCIL_RTOL = 8 * torch.finfo(f32).eps
    #: float64 kernels against their plain versions
    F64_RTOL = 1e-12
    #: four float32 GEMMs in another summation order than cuBLAS; the JAX
    #: package holds its own kernel to 1e-5 of the largest value
    GEMM_RTOL = 1e-5
    shapes = {"main": ((256, 256, 256), (1, 0, 0)),
              "ragged": ((30, 20, 40), (1, 1, 1))}
    report = {}

    def check_groups(name, shape_name, groups):
        """``groups``: (what, got, ref, scale, rtol) for outputs held to
        ``rtol`` of their own scale; the float32 errors go to the
        report."""
        for what, got, ref, sc, rtol in groups:
            err = max_err(got, ref)
            tol = rtol * sc
            log(f"[3] {name} {shape_name}{what}: max|kernel - plain| = "
                f"{err:.3e} (tolerance {tol:.3e} = {rtol:.3g} x {sc:.4g})")
            require(err <= tol and math.isfinite(err),
                    f"{name} {shape_name}{what}")
            if shape_name.endswith("float64"):
                continue
            rep = report.setdefault(name, {"max_abs_err": 0.0})
            rep["max_abs_err"] = max(rep["max_abs_err"], err)

    def check(name, shape_name, got, ref, rtol):
        """All outputs held to ``rtol`` of the largest plain value."""
        check_groups(name, shape_name, [("", got, ref, scale(ref), rtol)])

    for shape_name, (N, halo) in shapes.items():
        grid = grid_of(N, halo)
        u, v, w, p = filled_fields(grid, 4)
        Gm = [torch.randn(grid.shape, generator=gen, device=dev, dtype=f32)
              for _ in range(3)]
        a, b = 1.6e-4, -0.6e-4

        # kernel 1: tendency + AB2 (G is written over a copy of G_prev)
        Gk = [g.clone() for g in Gm]
        Gp = [g.clone() for g in Gm]
        got = ck.centered2_ab2_update(grid, u, v, w, *Gk, a, b)
        ref = ck.centered2_ab2_update_plain(grid, u, v, w, *Gp, a, b)
        torch.cuda.synchronize()
        check("centered2_ab2_update", shape_name, got, ref, STENCIL_RTOL)

        # kernel 2: tendency alone
        got = ck.centered2_momentum_tendency(grid, u, v, w)
        ref = ck.centered2_momentum_tendency_plain(grid, u, v, w)
        torch.cuda.synchronize()
        check("centered2_momentum_tendency", shape_name, got, ref,
              STENCIL_RTOL)

        # kernel 3: pressure correction
        got = ck.pressure_correction(grid, p, u, v, w, 1e-4)
        ref = ck.pressure_correction_plain(grid, p, u, v, w, 1e-4)
        torch.cuda.synchronize()
        check("pressure_correction", shape_name, got, ref, STENCIL_RTOL)

        # kernel 4: Poisson middle stage on an x-transformed interior field
        solver = ot.MatmulPoissonSolver(grid)
        x = torch.randn(grid.N, generator=gen, device=dev, dtype=f32)
        x = solver._apply(x - x.mean(), 0, transpose=False)
        margs = (x, solver.T1, solver.T2, solver.lam0.to(f32), solver.lam1,
                 solver.lam2)
        got = (cp.fused_middle_solve(*margs),)
        ref = (cp.fused_middle_solve_plain(*margs),)
        torch.cuda.synchronize()
        check("fused_middle_solve", shape_name, got, ref, GEMM_RTOL)

        if shape_name != "main":
            continue
        reps = 20
        timings = {
            "centered2_ab2_update": (
                lambda: ck.centered2_ab2_update_plain(grid, u, v, w, *Gp,
                                                      a, b),
                lambda: ck.centered2_ab2_update(grid, u, v, w, *Gk, a, b)),
            "centered2_momentum_tendency": (
                lambda: ck.centered2_momentum_tendency_plain(grid, u, v, w),
                lambda: ck.centered2_momentum_tendency(grid, u, v, w)),
            "pressure_correction": (
                lambda: ck.pressure_correction_plain(grid, p, u, v, w, 1e-4),
                lambda: ck.pressure_correction(grid, p, u, v, w, 1e-4)),
            "fused_middle_solve": (
                lambda: cp.fused_middle_solve_plain(*margs),
                lambda: cp.fused_middle_solve(*margs)),
        }
        field = u.numel() * u.element_size()
        # the output points: the interior x-rows
        points = N[0] * N[1] * N[2]
        Ny, Nz = N[1], N[2]
        bounds = {
            "centered2_ab2_update": bound(
                12 * field, points * (C2_TENDENCY_OPS + 3 * AB2_OPS)),
            "centered2_momentum_tendency": bound(
                6 * field, points * C2_TENDENCY_OPS),
            "pressure_correction": bound(7 * field, points * PRESSURE_OPS),
            # the work of the kernel's route, three TF32 products for each
            # product, on the tensor cores
            "fused_middle_solve": bound(
                2 * x.numel() * x.element_size(),
                TF32X3_PASSES * 4 * N[0] * Ny * Nz * (Ny + Nz),
                PEAK_TF32_FLOPS),
        }
        for name, (plain, kernel) in timings.items():
            plain_ms, ms = paired_times(torch, plain, kernel, reps)
            bound_ms, bound_by = bounds[name]
            report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
            log(f"[3] {name} at {tuple(u.shape)}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
        # kernel 4's yardsticks: the same products in float32 FFMA, and the
        # torch.matmul chain with the 1/λ table made on every call (its
        # plain version) or made once, as the unfused MatmulPoissonSolver
        # holds it; the faster chain is the library call's time
        ffma_ms, _ = bound(2 * x.numel() * x.element_size(),
                           4 * N[0] * Ny * Nz * (Ny + Nz))
        inv_lam = cp._inv_lambda(*margs[3:], f32)

        def chain():
            Ey, Ez = margs[1], margs[2]
            z = torch.matmul(torch.matmul(Ey, x), Ez.T) * inv_lam
            return torch.matmul(Ey.T, torch.matmul(z, Ez))

        require(float((chain() - ref[0]).abs().max())
                <= GEMM_RTOL * scale(ref), "the table chain computes kernel "
                "4's function")
        table_ms, ms2 = paired_times(
            torch, chain, lambda: cp.fused_middle_solve(*margs), reps)
        rep = report["fused_middle_solve"]
        rep["library_ms"] = min(rep["plain_ms"], table_ms)
        log(f"[3] fused_middle_solve at {tuple(x.shape)} on {card}: kernel "
            f"{rep['ms']:.4f} and {ms2:.4f} ms (two turns); torch.matmul "
            f"chain {rep['plain_ms']:.4f} ms (1/λ table made each call), "
            f"{table_ms:.4f} ms (table made once); bound "
            f"{rep['bound_ms']:.4f} ms as 3xTF32 on the tensor cores "
            f"({TF32X3_PASSES} x {4 * N[0] * Ny * Nz * (Ny + Nz) / 1e9:.2f} "
            f"GFLOP at {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s), {ffma_ms:.4f} ms "
            f"as float32 FFMA at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s; share of "
            f"the 3xTF32 bound {rep['bound_ms'] / rep['ms']:.3f}")
        del u, v, w, p, Gm, Gk, Gp, got, ref, x, margs, timings, chain, \
            inv_lam
        torch.cuda.empty_cache()

    def zero_row_fields(grid, dtype=f32):
        """Halo-filled random u, v, w with u exactly zero on every third
        z-column and v on every other x-plane: faces whose taps and
        advecting velocity are exact zeros."""
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W)):
            a = torch.randn(grid.shape, generator=gen, device=dev,
                            dtype=dtype)
            if n == 0:
                a[:, :, ::3] = 0.0
            if n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, grid, loc=loc))
        return fs

    # kernel 2 on fields with exact zero rows at the main shape (checked
    # and timed) and in float64 at the ragged shape (checked)
    for shape_name, (N, halo), dtype in (
            ("main, zero rows", shapes["main"], f32),
            ("ragged, zero rows, float64", shapes["ragged"], torch.float64)):
        grid = grid_of(N, halo, dtype)
        fs = zero_row_fields(grid, dtype)
        got = ck.centered2_momentum_tendency(grid, *fs)
        ref = ck.centered2_momentum_tendency_plain(grid, *fs)
        torch.cuda.synchronize()
        check("centered2_momentum_tendency", shape_name, got, ref,
              STENCIL_RTOL if dtype == f32 else F64_RTOL)
        if dtype == f32:
            plain_ms, ms = paired_times(
                torch, lambda: ck.centered2_momentum_tendency_plain(grid,
                                                                   *fs),
                lambda: ck.centered2_momentum_tendency(grid, *fs), 20)
            log(f"[3] centered2_momentum_tendency at {tuple(grid.shape)}, "
                f"zero rows, on {card}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms (random fields: kernel "
                f"{report['centered2_momentum_tendency']['ms']:.4f} ms)")
        del fs, got, ref
    torch.cuda.empty_cache()

    #: the WENO-5 kernels against the plain versions: the WENO-Z weights
    #: are nonlinear and the plain versions divide by volumes where the
    #: kernels multiply by 1/spacing, so they agree to rounding of the
    #: largest value, not bit for bit. Two runs on an H100 read 8.95e-7 of
    #: it at the main shape and 2.5e-7 at the ragged one, each time; the
    #: JAX package holds its own kernels to 3e-5 (tests/test_pallas_weno.py)
    WENO_RTOL = 1e-5
    weno_shapes = {"main": ((256, 256, 256), (3, 0, 0)),
                   "ragged": ((30, 20, 40), (3, 3, 3))}
    f_smoke = 1e-4
    for shape_name, (N, halo) in weno_shapes.items():
        grid = grid_of(N, halo)
        u, v, w, c, d = filled_fields(grid, 5)
        tr = {"c": c, "d": d}
        Gm = [0.1 * torch.randn(grid.shape, generator=gen, device=dev,
                                dtype=f32) for _ in range(5)]
        a, b = 1.6e-4, -0.6e-4
        Gk = [g.clone() for g in Gm]
        Gp = [g.clone() for g in Gm]

        def ab2(fn, G):
            return fn(grid, u, v, w, *G[:3], a, b)

        def science(fn, G):
            out = fn(grid, u, v, w, tr, *G[:3], {"c": G[3], "d": G[4]}, a,
                     b, f=f_smoke, buoyancy_tracer="d")
            return [*out[:3], *out[3].values(), *out[4:7], *out[7].values()]

        checks = {
            "weno5_ab2_update": (
                lambda: ab2(cw.weno5_ab2_update, Gk),
                lambda: ab2(cw.weno5_ab2_update_plain, Gp)),
            "weno5_momentum_tendency": (
                lambda: cw.weno5_momentum_tendency(grid, u, v, w),
                lambda: cw.weno5_momentum_tendency_plain(grid, u, v, w)),
            "weno5_science_ab2_update": (
                lambda: science(cw.weno5_science_ab2_update, Gk),
                lambda: science(cw.weno5_science_ab2_update_plain, Gp)),
            "weno5_tracer_tendencies": (
                lambda: list(cw.weno5_tracer_tendencies(
                    grid, u, v, w, tr).values()),
                lambda: list(cw.weno5_tracer_tendencies_plain(
                    grid, u, v, w, tr).values())),
        }
        for name, (kernel, plain) in checks.items():
            # the AB2 kernels write G over G_prev: each side starts from
            # its own copy of the same G_prev
            for gk, gp, g0 in zip(Gk, Gp, Gm):
                gk.copy_(g0)
                gp.copy_(g0)
            got = kernel()
            ref = plain()
            torch.cuda.synchronize()
            check(name, shape_name, got, ref, WENO_RTOL)
        # kernel 6 also on fields with exact zero rows (u zero on every
        # third z-column, v on every other x-plane: faces whose taps and
        # advecting velocity are exact zeros), as phase 10 holds kernel 7
        uz, vz = u.clone(), v.clone()
        uz[:, :, ::3] = 0.0
        vz[::2] = 0.0
        uz = ot.fill_halo_regions(uz, grid, loc=ot.LOC_U)
        vz = ot.fill_halo_regions(vz, grid, loc=ot.LOC_V)
        for gk, gp, g0 in zip(Gk, Gp, Gm):
            gk.copy_(g0)
            gp.copy_(g0)
        got = cw.weno5_ab2_update(grid, uz, vz, w, *Gk[:3], a, b)
        ref = cw.weno5_ab2_update_plain(grid, uz, vz, w, *Gp[:3], a, b)
        torch.cuda.synchronize()
        check("weno5_ab2_update", f"{shape_name}, zero rows", got, ref,
              WENO_RTOL)
        del uz, vz
        if shape_name != "main":
            continue
        field = u.numel() * u.element_size()
        points = N[0] * N[1] * N[2]
        T = len(tr)
        require(WENO_MOMENTUM_OPS == generic_point_ops(ot.WENO(5)),
                "kernels 7 and 14 are bounded by the same count of work")
        bounds = {
            "weno5_ab2_update": bound(
                12 * field, points * (WENO_MOMENTUM_OPS + 3 * AB2_OPS)),
            "weno5_momentum_tendency": bound(
                6 * field, points * WENO_MOMENTUM_OPS),
            "weno5_science_ab2_update": bound(
                4 * (3 + T) * field,
                points * (WENO_MOMENTUM_OPS + SCIENCE_OPS
                          + T * WENO_TRACER_OPS + (3 + T) * AB2_OPS)),
            "weno5_tracer_tendencies": bound(
                (3 + 2 * T) * field, points * T * WENO_TRACER_OPS),
        }
        reps = 10
        for name, (kernel, plain) in checks.items():
            plain_ms, ms = paired_times(torch, plain, kernel, reps)
            bound_ms, bound_by = bounds[name]
            report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
            log(f"[3] {name} at {tuple(u.shape)}, {T} tracers: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
        del u, v, w, c, d, tr, Gm, Gk, Gp, got, ref, checks
        torch.cuda.empty_cache()

    # kernels 8 and 9 with one and with MAX_TRACERS tracers at the ragged
    # shape: a tracer block with one tracer, and four tracer blocks (8 with
    # f and the last tracer as buoyancy)
    N, halo = weno_shapes["ragged"]
    grid = grid_of(N, halo)
    for T in (1, cw.MAX_TRACERS):
        u, v, w = filled_fields(grid, 3)
        cs = [ot.fill_halo_regions(
            torch.randn(grid.shape, generator=gen, device=dev, dtype=f32),
            grid, loc=ot.LOC_C) for _ in range(T)]
        names = [f"c{t}" for t in range(T)]
        tr = dict(zip(names, cs))
        Gm = [0.1 * torch.randn(grid.shape, generator=gen, device=dev,
                                dtype=f32) for _ in range(3 + T)]
        a, b = 1.6e-4, -0.6e-4

        def science_t(fn):
            out = fn(grid, u, v, w, tr, *(g.clone() for g in Gm[:3]),
                     {n: g.clone() for n, g in zip(names, Gm[3:])}, a, b,
                     f=f_smoke, buoyancy_tracer=names[-1])
            return [*out[:3], *out[3].values(), *out[4:7], *out[7].values()]

        got = science_t(cw.weno5_science_ab2_update)
        ref = science_t(cw.weno5_science_ab2_update_plain)
        torch.cuda.synchronize()
        check("weno5_science_ab2_update", f"ragged, T = {T}", got, ref,
              WENO_RTOL)
        got = list(cw.weno5_tracer_tendencies(grid, u, v, w, tr).values())
        ref = list(cw.weno5_tracer_tendencies_plain(grid, u, v, w,
                                                    tr).values())
        torch.cuda.synchronize()
        check("weno5_tracer_tendencies", f"ragged, T = {T}", got, ref,
              WENO_RTOL)
    del u, v, w, cs, tr, Gm, got, ref
    torch.cuda.empty_cache()

    # kernel 5, the Centered-2 science step: the updated fields and the
    # tendencies, each group to 8 float32 ulps of its largest value (the
    # same stencils as kernels 1-2, plus products and sums of the same
    # size); in float64 to F64_RTOL
    science_shapes = {"main": ((256, 256, 256), (1, 0, 0), f32),
                      "ragged": ((30, 20, 40), (1, 1, 1), f32),
                      "ragged float64": ((30, 20, 40), (1, 1, 1),
                                         torch.float64)}
    for shape_name, (N, halo, dtype) in science_shapes.items():
        grid = grid_of(N, halo, dtype)
        u, v, w, b_, c_ = (q.to(dtype) for q in filled_fields(grid, 5))
        tr = {"b": b_, "c": c_}
        Gm = [0.1 * torch.randn(grid.shape, generator=gen, device=dev,
                                dtype=dtype) for _ in range(5)]
        Gk = [g.clone() for g in Gm]
        Gp = [g.clone() for g in Gm]
        a, b = 1.6e-4, -0.6e-4

        def science5(fn, G):
            out = fn(grid, u, v, w, tr, *G[:3], {"b": G[3], "c": G[4]}, a,
                     b, f=f_smoke, buoyancy_tracer="b")
            return ([*out[:3], *out[3].values()],
                    [*out[4:7], *out[7].values()])

        got = science5(ck.centered2_science_ab2_update, Gk)
        ref = science5(ck.centered2_science_ab2_update_plain, Gp)
        torch.cuda.synchronize()
        rtol = 8 * torch.finfo(dtype).eps if dtype == f32 else F64_RTOL
        check_groups("centered2_science_ab2_update", shape_name, [
            (" fields", got[0], ref[0], scale(ref[0]), rtol),
            (" tendencies", got[1], ref[1], scale(ref[1]), rtol)])
        if shape_name != "main":
            continue
        field = u.numel() * u.element_size()
        points = N[0] * N[1] * N[2]
        T = len(tr)
        bound_ms, bound_by = bound(
            4 * (3 + T) * field,
            points * (C2_TENDENCY_OPS + SCIENCE_OPS + T * C2_TRACER_OPS
                      + (3 + T) * AB2_OPS))
        plain_ms, ms = paired_times(
            torch, lambda: science5(ck.centered2_science_ab2_update_plain,
                                    Gp),
            lambda: science5(ck.centered2_science_ab2_update, Gk), 20)
        report["centered2_science_ab2_update"].update(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        log(f"[3] centered2_science_ab2_update at {tuple(u.shape)}, {T} "
            f"tracers: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    del u, v, w, b_, c_, tr, Gm, Gk, Gp, got, ref
    torch.cuda.empty_cache()

    # kernel 10, the shallow-water stage, on random fields near the
    # benchmark's (h ~ 1000, uh and vh ~ 100): the updated fields to 8
    # float32 ulps of their largest value; the tendencies, each a small
    # residual of terms ~1e4 times larger, to 32 float32 ulps of the largest
    # single term (sw_term_scale); in float64 both to F64_RTOL. The float64
    # bound is wider in ulps: the plain versions divide by spacings taken
    # from coordinate differences, which carry a relative rounding of up to
    # an ulp of the coordinate over the spacing (~1e-14 here; in float32
    # the spacings are rounded to float32 and this stays within an ulp)
    sw_shapes = {"main": ((8192, 8192), f32), "ragged": ((48, 200), f32),
                 "ragged float64": ((48, 200), torch.float64)}
    for shape_name, (N, dtype) in sw_shapes.items():
        grid = sw_grid(N, dtype)
        sgen = torch.Generator(device=dev).manual_seed(1)

        def rnd(sd, offset=0.0):
            return offset + sd * torch.randn(grid.shape, generator=sgen,
                                             device=dev, dtype=dtype)
        q = [rnd(100.0), rnd(100.0), rnd(1.0, 1000.0)]
        for fld, loc in zip(q, (ot.LOC_U, ot.LOC_V, ot.LOC_C)):
            ot.fill_halo_regions(fld, grid, loc=loc)
        Gm = [rnd(1e-2) for _ in range(3)]
        Gk = [g.clone() for g in Gm]
        Gp = [g.clone() for g in Gm]
        a, b = 0.4, -0.2
        got = csw.sw_rk3_stage(grid, *q, *Gk, a, b, 9.81)
        ref = csw.sw_rk3_stage_plain(grid, *q, *Gp, a, b, 9.81)
        torch.cuda.synchronize()
        eps = torch.finfo(dtype).eps
        r_fields, r_terms = ((8 * eps, 32 * eps) if dtype == f32
                             else (F64_RTOL, F64_RTOL))
        ii = grid.interior_slices
        gi = [[t[ii] for t in group] for group in (got[:3], got[3:],
                                                   ref[:3], ref[3:])]
        check_groups("sw_rk3_stage", shape_name, [
            (" fields", gi[0], gi[2], scale(gi[2]), r_fields),
            (" tendencies", gi[1], gi[3], sw_term_scale(grid, *q),
             r_terms)])
        del gi
        if shape_name != "main":
            continue
        field = q[0].numel() * q[0].element_size()
        points = N[0] * N[1]
        bound_ms, bound_by = bound(12 * field, points * SW_STAGE_OPS)
        plain_ms, ms = paired_times(
            torch, lambda: csw.sw_rk3_stage_plain(grid, *q, *Gp, a, b, 9.81),
            lambda: csw.sw_rk3_stage(grid, *q, *Gk, a, b, 9.81), 10)
        report["sw_rk3_stage"].update(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        log(f"[3] sw_rk3_stage at {tuple(q[0].shape)}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del q, Gm, Gk, Gp, got, ref
    torch.cuda.empty_cache()

    # kernel 11 (WENO tracers) and the vector-invariant kernel (rows 12 and
    # 13) on random fields, u and v exactly zero on some rows (velocities of
    # both signs and exact zeros), at hydro_vi's shape, ragged ones and
    # small float64 ones: every instantiated (vorticity, rest) order pair
    # with both vorticity stencils and every tracer order whose reach the
    # layout's halo holds (the halo (6, 6, 6) layouts hold them all; the
    # main shape takes the pairs and orders its halo (6, 6, 4) holds).
    # WENO_RTOL as for the WENO-5 kernels: nonlinear WENO-Z weights, the
    # plain versions divide by volumes and areas where the kernels take the
    # same values from y-profiles, FMA contraction
    # The lat-lon layouts ("latlon ...", a LatitudeLongitudeGrid of
    # (longitude, latitude) in place of the topology: phase 14's 1°
    # near-global ocean, ragged ones reaching both poles) take the same
    # kernels with metric profiles that vary with latitude; every layout
    # also takes the mixed orders of VI_MIXED (the kernel's instantiation
    # of runtime orders)
    PBB = (ot.Periodic, ot.Bounded, ot.Bounded)
    NEAR_GLOBAL, POLES = ((0.0, 360.0), (-80.0, 80.0)), ((0.0, 360.0),
                                                          (-90.0, 90.0))
    hydro_shapes = {
        "main": ((360, 160, 60), (6, 6, 4), PBB, f32),
        "latlon main": ((360, 160, 60), (6, 6, 4), NEAR_GLOBAL, f32),
        "ragged": ((23, 17, 9), (6, 6, 4),
                   (ot.Bounded, ot.Bounded, ot.Bounded), f32),
        "ragged halo-free": ((16, 12, 32), (5, 0, 0),
                             (ot.Bounded, ot.Periodic, ot.Periodic), f32),
        "ragged wide halo": ((23, 17, 9), (6, 6, 6),
                             (ot.Bounded, ot.Bounded, ot.Bounded), f32),
        "latlon ragged wide halo": ((23, 17, 9), (6, 6, 6), POLES, f32),
        "ragged float64": ((23, 17, 9), (6, 6, 4), PBB, torch.float64),
        "ragged wide halo float64": ((23, 17, 9), (6, 6, 6), PBB,
                                     torch.float64),
        "latlon ragged wide halo float64": ((23, 17, 9), (6, 6, 6), POLES,
                                            torch.float64),
        "latlon sector float64": ((24, 16, 8), (6, 6, 6),
                                  ((-30.0, 30.0), (15.0, 55.0)),
                                  torch.float64)}
    vi_velocity = ot.WENOVectorInvariant()
    vi_schemes = [ot.WENOVectorInvariant(vorticity_order=kv, order=kr,
                                         vorticity_stencil=stencil)
                  for kv, kr in cvi.ORDER_PAIRS
                  for stencil in ("velocity", "default")]
    vi_schemes += [mixed_vi(ot, orders, stencil) for orders in VI_MIXED
                   for stencil in ("velocity", "default")]
    for shape_name, (N, halo, topo, dtype) in hydro_shapes.items():
        if shape_name.startswith("latlon"):
            (lon, lat) = topo
            hg = ot.LatitudeLongitudeGrid(
                size=N, longitude=lon, latitude=lat, z=(-4000.0, 0.0),
                halo=halo, dtype=dtype, device=dev)
        else:
            hg = ot.RectilinearGrid(size=N, extent=(4e7, 2e7, 4e3),
                                    topology=topo, halo=halo, dtype=dtype,
                                    device=dev)
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C,
                                 ot.LOC_C)):
            a = torch.randn(hg.shape, generator=gen, device=dev, dtype=dtype)
            if n == 0:
                a[:, :, ::3] = 0.0
            if n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, hg, loc=loc))
        u, v, w, T, S = fs
        tr = {"T": T, "S": S}
        rtol = WENO_RTOL if dtype == f32 else F64_RTOL
        n_tr = n_vi = 0
        for order in ctr.ORDERS:
            sch = ot.WENO(order)
            if not ctr.tracer_fusion_available(hg, sch):
                continue
            got = list(ctr.weno_tracer_tendencies(hg, sch, u, v, w,
                                                  tr).values())
            ref = list(ctr.weno_tracer_tendencies_plain(hg, sch, u, v, w,
                                                        tr).values())
            torch.cuda.synchronize()
            check("weno_tracer_tendencies",
                  f"WENO({order}) {shape_name}", got, ref, rtol)
            n_tr += 1
        for vi in vi_schemes:
            if not cvi.vi_available(hg, vi):
                continue
            got = cvi.vi_momentum_tendency(hg, vi, u, v, w)
            ref = cvi.vi_momentum_tendency_plain(hg, vi, u, v, w)
            torch.cuda.synchronize()
            check("vi_momentum_tendency",
                  f"{vi_orders(vi)} {vi.vorticity_stencil} {shape_name}",
                  got, ref, rtol)
            n_vi += 1
        if "wide halo" in shape_name:
            require(n_tr == len(ctr.ORDERS) and n_vi == len(vi_schemes),
                    f"{shape_name}: every tracer order and VI pair checked")
        log(f"[3] {shape_name}: {n_tr} tracer orders and {n_vi} "
            "vector-invariant schemes checked")
        require(n_tr > 0 and n_vi > 0,
                f"{shape_name}: the kernels take the layout")
        if shape_name == "latlon main":
            # rows 11 and 12/13 on the sphere, timed beside their plain
            # versions and the bounds of the main shape (the same work)
            for name, (plain, kernel) in {
                    "weno_tracer_tendencies": (
                        lambda: ctr.weno_tracer_tendencies_plain(
                            hg, ot.WENO(7), u, v, w, tr),
                        lambda: ctr.weno_tracer_tendencies(
                            hg, ot.WENO(7), u, v, w, tr)),
                    "vi_momentum_tendency": (
                        lambda: cvi.vi_momentum_tendency_plain(
                            hg, vi_velocity, u, v, w),
                        lambda: cvi.vi_momentum_tendency(
                            hg, vi_velocity, u, v, w))}.items():
                plain_ms, ms = paired_times(torch, plain, kernel, 10)
                b_ms, b_by = bounds[name]
                log(f"[3] {name} at the lat-lon layout {tuple(u.shape)}: "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
        if shape_name != "main":
            continue
        field = u.numel() * u.element_size()
        points = math.prod(N)
        bounds = {
            "weno_tracer_tendencies": bound(
                (3 + 2 * len(tr)) * field,
                points * len(tr) * TRACER7_POINT_OPS),
            "vi_momentum_tendency": bound(5 * field, points * VI_POINT_OPS)}
        for order in ctr.ORDERS:
            b_ms, b_by = bound((3 + 2 * len(tr)) * field,
                               points * len(tr) * tracer_point_ops(order))
            log(f"[3] weno_tracer_tendencies bound at {tuple(u.shape)}, "
                f"WENO({order}), two tracers: {b_ms:.4f} ms ({b_by})")
        for kv, kr in cvi.ORDER_PAIRS:
            for velocity in (True, False):
                b_ms, b_by = bound(5 * field, points * vi_point_ops(
                    kv, kr, velocity=velocity))
                log(f"[3] vi_momentum_tendency bound at {tuple(u.shape)}, "
                    f"({kv}, {kr}) "
                    f"{'velocity' if velocity else 'default'}: "
                    f"{b_ms:.4f} ms ({b_by})")
        timings = {
            "weno_tracer_tendencies": (
                lambda: ctr.weno_tracer_tendencies_plain(
                    hg, ot.WENO(7), u, v, w, tr),
                lambda: ctr.weno_tracer_tendencies(hg, ot.WENO(7), u, v, w,
                                                   tr)),
            "vi_momentum_tendency": (
                lambda: cvi.vi_momentum_tendency_plain(hg, vi_velocity, u,
                                                       v, w),
                lambda: cvi.vi_momentum_tendency(hg, vi_velocity, u, v, w))}
        for name, (plain, kernel) in timings.items():
            plain_ms, ms = paired_times(torch, plain, kernel, 10)
            bound_ms, bound_by = bounds[name]
            report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
            log(f"[3] {name} at {tuple(u.shape)}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
        vi7 = ot.WENOVectorInvariant(order=7)
        ms7 = time_ms(torch, lambda: cvi.vi_momentum_tendency(hg, vi7, u, v,
                                                              w), 10)
        b7 = bound(5 * field, points * vi_point_ops(7, 7))
        log(f"[3] vi_momentum_tendency, WENOVectorInvariant(order=7), at "
            f"{tuple(u.shape)}: kernel {ms7:.4f} ms, bound {b7[0]:.4f} ms "
            f"({b7[1]})")
        # the instantiation of runtime orders against the (9, 5) pair, in
        # turns (pair, mixed, mixed, pair), each beside its bound
        b95 = bound(5 * field, points * vi_point_ops(9, 5))
        for orders in VI_MIXED[:2]:
            vim = mixed_vi(ot, orders)
            pair_ms, mixed_ms = paired_times(
                torch, lambda: cvi.vi_momentum_tendency(hg, vi_velocity, u,
                                                        v, w),
                lambda: cvi.vi_momentum_tendency(hg, vim, u, v, w), 10)
            bm = bound(5 * field, points * vi_point_ops(*orders))
            log(f"[3] vi_momentum_tendency at {tuple(u.shape)}, orders "
                f"{orders} (runtime orders): kernel {mixed_ms:.4f} ms, bound "
                f"{bm[0]:.4f} ms ({bm[1]}); the (9, 5) pair in turn with it "
                f"{pair_ms:.4f} ms, bound {b95[0]:.4f} ms ({b95[1]})")
        del timings
    del hg, fs, u, v, w, T, S, tr, got, ref
    torch.cuda.empty_cache()

    # kernel 14 (generic momentum advection) against its plain version at
    # small ragged shapes, for every scheme family on every axis, in
    # float32 (WENO_RTOL: the WENO-Z weights are nonlinear in the rounding
    # of the indicators, and the linear schemes are held to the same bound)
    # and float64 (F64_RTOL), with halo-free periodic and haloed y and z
    generic_schemes = (
        [ot.Centered(k) for k in range(2, 13, 2)]
        + [ot.UpwindBiased(k) for k in range(1, 12, 2)]
        + [ot.WENO(k) for k in range(3, 12, 2)]
        + [ot.FluxFormAdvection(ot.WENO(5), ot.Centered(2),
                                ot.UpwindBiased(3)),
           ot.FluxFormAdvection(ot.UpwindBiased(11), ot.WENO(9),
                                ot.Centered(12))])
    generic_shapes = {
        "ragged": ((13, 17, 24), (6, 0, 0),
                   (ot.Bounded, ot.Periodic, ot.Periodic), f32),
        "ragged haloed": ((9, 11, 14), (6, 6, 6),
                          (ot.Periodic, ot.Bounded, ot.Bounded), f32),
        "ragged float64": ((13, 17, 24), (6, 0, 0),
                           (ot.Bounded, ot.Periodic, ot.Periodic),
                           torch.float64),
        "ragged haloed float64": ((9, 11, 14), (6, 6, 6),
                                  (ot.Periodic, ot.Bounded, ot.Bounded),
                                  torch.float64)}
    for shape_name, (N, halo, topo, dtype) in generic_shapes.items():
        gg = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 0.5),
                                topology=topo, halo=halo, dtype=dtype,
                                device=dev)
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W)):
            a = torch.randn(gg.shape, generator=gen, device=dev, dtype=dtype)
            if n == 0:
                a[:, :, ::3] = 0.0
            if n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, gg, loc=loc))
        rtol = WENO_RTOL if dtype == f32 else F64_RTOL
        for sch in generic_schemes:
            got = cg.fused_momentum_tendency(gg, sch, *fs)
            ref = cg.fused_momentum_tendency_plain(gg, sch, *fs)
            torch.cuda.synchronize()
            check("fused_momentum_tendency", f"{sch!r} {shape_name}", got,
                  ref, rtol)
    del gg, fs, got, ref
    torch.cuda.empty_cache()

    # ---- phase 4: the main path ----------------------------------------
    wrappers = {"centered2_ab2_update": ck.centered2_ab2_update,
                "centered2_momentum_tendency":
                    ck.centered2_momentum_tendency,
                "pressure_correction": ck.pressure_correction,
                "fused_middle_solve": cp.fused_middle_solve,
                "weno5_ab2_update": cw.weno5_ab2_update,
                "weno5_momentum_tendency": cw.weno5_momentum_tendency,
                "weno5_science_ab2_update": cw.weno5_science_ab2_update,
                "weno5_tracer_tendencies": cw.weno5_tracer_tendencies,
                "centered2_science_ab2_update":
                    ck.centered2_science_ab2_update,
                "sw_rk3_stage": csw.sw_rk3_stage,
                "weno_tracer_tendencies": ctr.weno_tracer_tendencies,
                "vi_momentum_tendency": cvi.vi_momentum_tendency,
                "fused_momentum_tendency": cg.fused_momentum_tendency}
    launches = {}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    N = 256
    dt = 1e-4
    grid = grid_of((N, N, N), (1, 0, 0))

    def run(model, state, steps):
        state = model.fill_state_halos(state)
        for _ in range(steps):
            state = model.step(state, dt, assume_filled=True)
        return state

    def interior_max(grid, state):
        return max(float(grid.interior(q).abs().max())
                   for q in (state.u, state.v, state.w))

    def max_div(grid, state):
        div = divergence_ccc(grid, state.u, state.v, state.w)
        return float(grid.interior(div).abs().max())

    def finite(state):
        return all(bool(torch.isfinite(q).all())
                   for q in (state.u, state.v, state.w, state.pressure,
                             *state.tracers.values()))

    warm, steps = 5, 100
    step_ms = {}
    finals = {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        zero_counts()
        model = ot.NonhydrostaticModel(
            grid=grid, timestepper="QuasiAdamsBashforth2",
            fused_kernels=fused)
        require(bool(model.fused_ab2) == (path == "kernel"),
                f"{path} path selects fused_ab2={model.fused_ab2}")
        state = run(model, initial_state(model), warm)
        torch.cuda.synchronize()
        holder = [state]
        step_ms[path] = time_ms(
            torch, lambda: holder.__setitem__(
                0, model.step(holder[0], dt, assume_filled=True)), steps)
        finals[path] = holder[0]
        if path == "kernel":
            launches["centered2_ab2_update"] = ck.centered2_ab2_update.launches
        else:
            require(all(fn.launches == 0 for fn in wrappers.values()),
                    "the plain path launches no kernel")
        log(f"[4] {path} path: {step_ms[path]:.3f} ms/step at {N}^3 float32 "
            f"({warm} warm-up + {steps} timed steps)")
    ab2_launches = launches["centered2_ab2_update"]
    require(ab2_launches == warm + steps,
            f"centered2_ab2_update launched {ab2_launches} times in "
            f"{warm + steps} kernel-path steps")
    sk, sp = finals["kernel"], finals["plain"]
    require(finite(sk) and finite(sp), "fields are finite")
    umax = interior_max(grid, sk)
    dx = 1.0 / N
    div_k = max_div(grid, sk)
    require(div_k <= 1e-5 * umax / dx,
            f"max|div| {div_k:.3e} <= 1e-5 max|u|/dx = {1e-5 * umax / dx:.3e}")
    diff = max(float(grid.interior(a - b).abs().max())
               for a, b in ((sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w)))
    #: the kernel and the plain path round the tendency and the update
    #: differently (order, FMA) every step, and the difference accumulates
    #: over 105 steps
    PATH_RTOL = 3e-5
    log(f"[4] centered2_ab2_update launches = {ab2_launches} = steps; "
        f"max|u| {umax:.4e}; max|div| {div_k:.3e} (bound "
        f"{1e-5 * umax / dx:.3e}); kernel vs plain path max|diff| "
        f"{diff:.3e} = {diff / umax:.3e} max|u| (tolerance "
        f"{PATH_RTOL} max|u| = {PATH_RTOL * umax:.3e})")
    require(diff <= PATH_RTOL * umax,
            f"kernel vs plain path {diff:.3e} <= {PATH_RTOL} max|u|")
    del finals, holder, state, sk, sp
    torch.cuda.empty_cache()

    # a small float64 run: the kernel path on the card against the plain
    # path on the CPU, which the CPU tests hold against the JAX package
    f64 = {}
    for device, fused in (("cuda", True), ("cpu", False)):
        g16 = ot.RectilinearGrid(size=(16, 16, 16), extent=(1.0, 1.0, 1.0),
                                 topology=(ot.Bounded, ot.Periodic,
                                           ot.Periodic),
                                 halo=(1, 0, 0), dtype=torch.float64,
                                 device=device)
        m16 = ot.NonhydrostaticModel(grid=g16, fused_kernels=fused,
                                     timestepper="QuasiAdamsBashforth2")
        s16 = m16.initial_state(
            u=lambda x, y, z: torch.sin(2 * math.pi * x)
            * torch.cos(2 * math.pi * y),
            v=lambda x, y, z: torch.cos(2 * math.pi * z) + 0 * x)
        for _ in range(5):
            s16 = m16.step(s16, 1e-3)
        f64[device] = (g16, s16)
    g16, s16 = f64["cuda"]
    diff64 = max(float((g16.interior(getattr(s16, q)).cpu()
                        - f64["cpu"][0].interior(getattr(f64["cpu"][1], q)))
                       .abs().max()) for q in ("u", "v", "w"))
    require(diff64 <= 1e-12, f"float64 16^3 card vs CPU {diff64:.3e}")
    log(f"[4] float64 16^3, 5 AB2 steps: kernel path on the card vs plain "
        f"path on the CPU max|diff| {diff64:.3e} (tolerance 1e-12)")

    # ---- phase 5: RK3 --------------------------------------------------
    rk3 = ot.NonhydrostaticModel(grid=grid)
    require(rk3.timestepper == "RungeKutta3" and rk3.fused_kernels,
            "default model is RK3 with fused kernels")
    zero_counts()
    s = run(rk3, initial_state(rk3), 3)
    torch.cuda.synchronize()
    n_tend = launches["centered2_momentum_tendency"] = \
        ck.centered2_momentum_tendency.launches
    require(n_tend == 9, f"tendency kernel launched {n_tend} times in 3 "
            "RK3 steps")
    require(finite(s), "RK3 fields are finite")
    div_r = max_div(grid, s)
    umax_r = interior_max(grid, s)
    require(div_r <= 1e-5 * umax_r / dx, f"RK3 max|div| {div_r:.3e}")
    log(f"[5] RK3, 3 steps at {N}^3: centered2_momentum_tendency launches "
        f"{n_tend}; max|div| {div_r:.3e}")
    del rk3, s
    torch.cuda.empty_cache()

    # ---- phase 6: fused correction and the fused matmul solver ----------
    few = 10
    ref_model = ot.NonhydrostaticModel(
        grid=grid, timestepper="QuasiAdamsBashforth2")
    s_ref = run(ref_model, initial_state(ref_model), few)
    opt = ot.NonhydrostaticModel(grid=grid,
                                 timestepper="QuasiAdamsBashforth2")
    opt.fused_correction = True
    opt.pressure_solver = ot.MatmulPoissonSolver(grid, fused=True)
    zero_counts()
    s_opt = run(opt, initial_state(opt), few)
    torch.cuda.synchronize()
    for name in ("pressure_correction", "fused_middle_solve"):
        launches[name] = wrappers[name].launches
        # one projection in initial_state, one per step
        require(launches[name] == few + 1,
                f"{name} launched {launches[name]} times in the opt-in run")
    require(finite(s_opt), "opt-in path fields are finite")
    diff6 = max(float(grid.interior(a - b).abs().max())
                for a, b in ((s_opt.u, s_ref.u), (s_opt.v, s_ref.v),
                             (s_opt.w, s_ref.w)))
    umax6 = interior_max(grid, s_ref)
    #: two float32 Poisson solvers (cuFFT vs eigenbasis GEMMs) apart
    OPT_RTOL = 1e-4
    div6 = max_div(grid, s_opt)
    log(f"[6] fused correction + fused matmul solver, {few} AB2 steps: "
        f"max|diff| vs default path {diff6:.3e} (tolerance "
        f"{OPT_RTOL * umax6:.3e}); max|div| {div6:.3e}; launches "
        f"pressure_correction {launches['pressure_correction']}, "
        f"fused_middle_solve {launches['fused_middle_solve']}")
    require(diff6 <= OPT_RTOL * umax6,
            f"opt-in path vs default path {diff6:.3e}")
    require(div6 <= 1e-5 * umax6 / dx, f"opt-in max|div| {div6:.3e}")

    rhs = torch.randn(grid.N, generator=gen, device=dev, dtype=f32)
    rhs = rhs - rhs.mean()
    solvers = {"fft": ot.FFTPoissonSolver(grid),
               "matmul": ot.MatmulPoissonSolver(grid),
               "matmul_fused": opt.pressure_solver}
    solve_ms = {}
    for name, solver in solvers.items():
        solver.solve(rhs)
        torch.cuda.synchronize()
        solve_ms[name] = time_ms(torch, lambda: solver.solve(rhs), 10)
    # the default solver against the fused matmul solver, in turns
    fft_ms, fused_ms = paired_times(
        torch, lambda: solvers["fft"].solve(rhs),
        lambda: solvers["matmul_fused"].solve(rhs), 10)
    log(f"[6] Poisson solve at {N}^3 float32 on {card}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in solve_ms.items())
        + f"; in turns (fft, fused, fused, fft): FFTPoissonSolver "
        f"{fft_ms:.4f} ms, MatmulPoissonSolver(fused=True) {fused_ms:.4f} "
        "ms")
    log(f"[6] step times on {card}: kernel path {step_ms['kernel']:.3f} "
        f"ms/step, plain path {step_ms['plain']:.3f} ms/step")

    del ref_model, s_ref, opt, s_opt, solvers, rhs
    torch.cuda.empty_cache()

    # ---- phase 7: the WENO-5 and science paths ----------------------------
    def model_kwargs(config):
        if config == "weno_science":
            return dict(advection=ot.WENO(5), coriolis=ot.FPlane(f=1e-4),
                        buoyancy=ot.BuoyancyTracer(),
                        tracers=("b", "c")), (3, 0, 0)
        if config == "weno7":
            return dict(advection=ot.WENO(7), tracers=("T", "S")), (4, 0, 0)
        return config_kwargs(config)

    def weno_model(config, fused, timestepper="QuasiAdamsBashforth2",
                   grid=None):
        kwargs, halo = model_kwargs(config)
        grid = grid or grid_of((N, N, N), halo)
        return ot.NonhydrostaticModel(grid=grid, timestepper=timestepper,
                                      fused_kernels=fused, **kwargs)

    def rel_diff(grid, sk, sp):
        """max|kernel − plain| over the interiors, relative to the largest
        plain value, for the velocities and for the tracers."""
        def rel(pairs):
            diff = max(float(grid.interior(a - b.to(a.device)).abs().max())
                       for a, b in pairs)
            return diff / max(float(grid.interior(b).abs().max())
                              for _, b in pairs)
        vel = rel([(sk.u, sp.u), (sk.v, sp.v), (sk.w, sp.w)])
        trc = (rel([(sk.tracers[n], sp.tracers[n]) for n in sk.tracers])
               if sk.tracers else 0.0)
        return vel, trc

    #: the kernel and plain paths round the fluxes and the update
    #: differently every step, and the nonlinear WENO-Z weights carry the
    #: difference on; relative to the largest value of each group of
    #: fields. Two runs on an H100 read 8.724e-06 (velocities) and
    #: 8.906e-06 (tracers) after 105 `weno` steps (5 + 100, the depth the
    #: phase then ran), each time; the
    #: Centered-2 `science` path is held to the same bound (its default
    #: counterpart reads 8.361e-6 after 105 steps)
    WENO_PATH_RTOL = 3e-5
    weno_runs = {
        # name: (configuration, timestepper, warm-up, steps, kernels)
        "weno": ("weno", "QuasiAdamsBashforth2", warm, 30,
                 {"weno5_science_ab2_update": 1}),
        "science": ("science", "QuasiAdamsBashforth2", warm, 30,
                    {"centered2_science_ab2_update": 1}),
        "weno_mom": ("weno_mom", "QuasiAdamsBashforth2", 2, 20,
                     {"weno5_ab2_update": 1}),
        "weno_science": ("weno_science", "QuasiAdamsBashforth2", 2, 10,
                         {"weno5_science_ab2_update": 1}),
        "weno_rk3": ("weno", "RungeKutta3", 2, 10,
                     {"weno5_momentum_tendency": 3,
                      "weno5_tracer_tendencies": 3}),
        # WENO(7) tracers take the any-order tracer kernel (its main path
        # is phase 9's hydro_vi run); the momentum runs plain
        "weno7": ("weno7", "QuasiAdamsBashforth2", 1, 3,
                  {"weno_tracer_tendencies": 1}),
    }
    weno_ms = {}
    for run_name, (config, ts, n_warm, n_steps, per_step) in \
            weno_runs.items():
        finals = {}
        for path, fused in (("kernel", "auto"), ("plain", False)):
            model = weno_model(config, fused, ts)
            zero_counts()
            state = run(model, initial_state(model), n_warm)
            torch.cuda.synchronize()
            holder = [state]
            ms = time_ms(torch, lambda: holder.__setitem__(
                0, model.step(holder[0], dt, assume_filled=True)), n_steps)
            weno_ms[run_name, path] = ms
            finals[path] = (model, holder[0])
            total = n_warm + n_steps
            if path == "kernel":
                counts = {k: wrappers[k].launches for k in per_step}
                for name, per in per_step.items():
                    n = counts[name]
                    require(n == per * total,
                            f"{run_name}: {name} launched {n} times in "
                            f"{total} steps")
                    if run_name not in ("weno_science", "weno7"):
                        launches[name] = n
                others = [k for k in wrappers if k not in per_step
                          and wrappers[k].launches]
                require(not others, f"{run_name}: unexpected launches of "
                        f"{others}")
            else:
                require(all(fn.launches == 0 for fn in wrappers.values()),
                        f"{run_name}: the plain path launches no kernel")
            log(f"[7] {run_name} {path} path: {ms:.3f} ms/step at {N}^3 "
                f"float32 ({n_warm} warm-up + {n_steps} timed steps, {ts})")
        (mk, sk), (_, sp) = finals["kernel"], finals["plain"]
        g7 = mk.grid
        require(finite(sk) and finite(sp), f"{run_name}: fields are finite")
        umax7 = interior_max(g7, sk)
        div7 = max_div(g7, sk)
        require(div7 <= 1e-5 * umax7 / dx,
                f"{run_name}: max|div| {div7:.3e} <= 1e-5 max|u|/dx")
        vel, trc = rel_diff(g7, sk, sp)
        log(f"[7] {run_name}: kernel-path launches {counts} in "
            f"{n_warm + n_steps} steps; max|u| {umax7:.4e}; max|div| "
            f"{div7:.3e} (bound {1e-5 * umax7 / dx:.3e}); kernel vs plain "
            f"path: velocities {vel:.3e}, tracers {trc:.3e} of the largest "
            f"value (tolerance {WENO_PATH_RTOL})")
        require(vel <= WENO_PATH_RTOL and trc <= WENO_PATH_RTOL,
                f"{run_name}: kernel vs plain path {vel:.3e}, {trc:.3e}")
        del finals, holder, state, sk, sp, mk
        torch.cuda.empty_cache()

    # small float64 science runs: the kernel path on the card against the
    # plain path on the CPU
    for config, gate in (("weno_science", "fused_ab2_weno_science"),
                         ("science", "fused_ab2_science")):
        f64 = {}
        for device, fused in (("cuda", True), ("cpu", False)):
            g16 = ot.RectilinearGrid(
                size=(16, 16, 16), extent=(1.0, 1.0, 1.0),
                topology=(ot.Bounded, ot.Periodic, ot.Periodic),
                halo=model_kwargs(config)[1], dtype=torch.float64,
                device=device)
            m16 = weno_model(config, fused, grid=g16)
            s16 = m16.initial_state(
                u=lambda x, y, z: torch.sin(2 * math.pi * x)
                * torch.cos(2 * math.pi * y),
                v=lambda x, y, z: torch.cos(2 * math.pi * z) + 0 * x,
                b=lambda x, y, z: 0.1 * torch.sin(2 * math.pi * z) + 0 * x,
                c=lambda x, y, z: torch.cos(2 * math.pi * y) + 0 * x)
            for _ in range(5):
                s16 = m16.step(s16, 1e-3)
            f64[device] = (m16, s16)
        require(getattr(f64["cuda"][0], gate),
                f"the float64 card run takes {gate}")
        vel64, trc64 = rel_diff(f64["cuda"][0].grid, f64["cuda"][1],
                                f64["cpu"][1])
        require(vel64 <= 1e-12 and trc64 <= 1e-12,
                f"float64 16^3 {config} card vs CPU {vel64:.3e}, "
                f"{trc64:.3e}")
        log(f"[7] float64 16^3 {config}, 5 AB2 steps: kernel path on the "
            f"card vs plain path on the CPU: velocities {vel64:.3e}, "
            f"tracers {trc64:.3e} of the largest value (tolerance 1e-12)")
    log(f"[7] step times on {card}: " + ", ".join(
        f"{name} {path} {ms:.3f} ms/step"
        for (name, path), ms in weno_ms.items()))

    del f64, m16, s16
    torch.cuda.empty_cache()

    # ---- phase 8: the shallow-water model ---------------------------------
    # bench.py's Δt = 1 s is above RK3's stability limit for the grid-scale
    # gravity waves (ω·Δt = 2.3 at 8192², against √3): rounding noise grows
    # by ~1.7 a step and the fields overflow after ~30 steps on either
    # path. So each path is compared after SW_CMP steps, where the growth
    # is ~13, and timed over the next SW_TIMED, inside that horizon.
    #: sw8192 after SW_CMP steps, kernel path against plain path, relative
    #: to the largest value of each group. Both paths round h ~ 1e3 to
    #: float32 (an ulp is 6e-5 there), and the g·h·∂h term turns one ulp of
    #: h into ~0.05 of the x-transport tendency, so the transports drift
    #: apart by rounding noise; h itself stays within a few ulps of the
    #: largest value. Bounds set before the first run on the card
    SW_PATH_RTOL = {"transports": 1e-2, "h": 1e-4}
    SW_CMP, SW_TIMED = 5, 20
    sw_ms, sw_cmp = {}, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = sw_model(8192, fused)
        require(model.fused_rk3 == (path == "kernel"),
                f"sw8192 {path} path selects fused_rk3={model.fused_rk3}")
        zero_counts()
        state = model.fill_state_halos(sw_initial_state(model))
        for _ in range(SW_CMP):
            state = model.step(state, 1.0, assume_filled=True)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(q).all())
                    for q in (state.uh, state.vh, state.h)),
                f"sw8192 {path} path: finite fields")
        sw_cmp[path] = [model.grid.interior(q).clone()
                        for q in (state.uh, state.vh, state.h)]
        holder = [state]
        sw_ms[path] = time_ms(torch, lambda: holder.__setitem__(
            0, model.step(holder[0], 1.0, assume_filled=True)), SW_TIMED)
        total = SW_CMP + SW_TIMED
        if path == "kernel":
            n = launches["sw_rk3_stage"] = csw.sw_rk3_stage.launches
            require(n == 3 * total, f"sw_rk3_stage launched {n} times in "
                    f"{total} steps")
            others = [k for k in wrappers if k != "sw_rk3_stage"
                      and wrappers[k].launches]
            require(not others, f"sw8192: unexpected launches of {others}")
        else:
            require(all(fn.launches == 0 for fn in wrappers.values()),
                    "sw8192: the plain path launches no kernel")
        log(f"[8] sw8192 {path} path: {sw_ms[path]:.3f} ms/step at 8192^2 "
            f"float32 (steps {SW_CMP + 1} to {total} of RK3, timed)")
        del model, state, holder
    (uk, vk, hk), (up, vp, hp) = sw_cmp["kernel"], sw_cmp["plain"]
    sw_rel = {
        "transports": max(float((uk - up).abs().max()),
                          float((vk - vp).abs().max()))
        / max(float(up.abs().max()), float(vp.abs().max())),
        "h": float((hk - hp).abs().max()) / float(hp.abs().max())}
    log(f"[8] sw8192: sw_rk3_stage launches {launches['sw_rk3_stage']} in "
        f"{total} steps; kernel vs plain path after {SW_CMP} steps: "
        + ", ".join(f"{k} {v:.3e} of the largest value (tolerance "
                    f"{SW_PATH_RTOL[k]:g})" for k, v in sw_rel.items()))
    require(all(sw_rel[k] <= SW_PATH_RTOL[k] for k in sw_rel),
            f"sw8192 kernel vs plain path {sw_rel}")
    del sw_cmp, uk, vk, hk, up, vp, hp
    torch.cuda.empty_cache()

    # a small float64 run: the kernel path on the card against the plain
    # path on the CPU; the transports to 1e-12 of the largest transport and
    # h to 1e-12 of its largest value (vh starts at zero, so its own largest
    # value is no scale), the tendencies to 1e-9 absolute, the JAX
    # package's bound for its own stage kernel (one ulp of h ~ 1e3 moves the
    # g·h·∂h term by ~1e-12 of the largest term)
    f64 = {}
    for device in ("cuda", "cpu"):
        m = sw_model(96, "auto", torch.float64, device)
        require(m.fused_rk3 == (device == "cuda"), "float64 sw routes")
        st = sw_initial_state(m)
        for _ in range(4):
            st = m.step(st, 20.0)
        f64[device] = (m.grid, st)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    transports = max(float(gp.interior(q).abs().max())
                     for q in (sp.uh, sp.vh))
    scales = {"uh": transports, "vh": transports,
              "h": float(gp.interior(sp.h).abs().max())}
    sw64 = {"fields": 0.0, "tendencies": 0.0}
    for name in ("uh", "vh", "h", "Guh", "Gvh", "Gh"):
        a = gk.interior(getattr(sk, name)).cpu()
        b = gp.interior(getattr(sp, name))
        if name.startswith("G"):
            sw64["tendencies"] = max(sw64["tendencies"],
                                     float((a - b).abs().max()))
        else:
            sw64["fields"] = max(sw64["fields"], float(
                (a - b).abs().max()) / scales[name])
    require(sw64["fields"] <= 1e-12 and sw64["tendencies"] <= 1e-9,
            f"float64 96^2 shallow water card vs CPU {sw64}")
    log(f"[8] float64 96^2 shallow water, 4 RK3 steps: kernel path on the "
        f"card vs plain path on the CPU: fields {sw64['fields']:.3e} of "
        f"the largest value of their group (tolerance 1e-12), tendencies "
        f"{sw64['tendencies']:.3e} (tolerance 1e-9)")

    # a few kernel-path steps at 16384², where the noise grows ~15 a step
    m = sw_model(16384)
    st = m.fill_state_halos(sw_initial_state(m))
    st = m.step(st, 1.0, assume_filled=True)
    torch.cuda.synchronize()
    holder = [st]
    sw_ms["kernel 16384"] = time_ms(torch, lambda: holder.__setitem__(
        0, m.step(holder[0], 1.0, assume_filled=True)), 3)
    require(all(bool(torch.isfinite(q).all())
                for q in (holder[0].uh, holder[0].vh, holder[0].h)),
            "sw16384 finite fields")
    log(f"[8] sw16384 kernel path: {sw_ms['kernel 16384']:.3f} ms/step "
        "(1 warm-up + 3 timed RK3 steps)")
    log(f"[8] step times on {card}: " + ", ".join(
        f"{k} {v:.3f} ms/step" for k, v in sw_ms.items()))
    del m, st, holder
    torch.cuda.empty_cache()

    # ---- phase 9: the hydrostatic model (hydro_vi) -----------------------
    #: hydro_vi after 2 + 20 steps, kernel path against plain path,
    #: relative to the largest value of each group: both paths share the
    #: free surface and the fills and their tendencies differ by float32
    #: rounding, which this stable, smooth flow carries on without growth
    #: (PERF.md states the bounds with the expected ~1e-6)
    HYDRO_PATH_RTOL = {"velocities": 1e-4, "eta": 1e-4, "tracers": 1e-5}
    HYDRO_WARM, HYDRO_TIMED = 2, 20
    hydro_ms, hydro_enqueue, hydro_cmp = {}, {}, {}
    hydro_kernels = ("weno_tracer_tendencies", "vi_momentum_tendency")
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = hydro_model(fused)
        require(model.fused_kernels == model.fused_tracer
                == (path == "kernel"),
                f"hydro_vi {path} path selects fused_kernels="
                f"{model.fused_kernels}, fused_tracer={model.fused_tracer}")
        state = model.update_state(hydro_initial_state(model))
        torch.cuda.synchronize()
        zero_counts()
        for _ in range(HYDRO_WARM):
            state = model.step(state, HYDRO_DT, assume_filled=True)
        torch.cuda.synchronize()
        # CUDA events around the timed steps; the host clock stops when
        # the last step is enqueued
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(HYDRO_TIMED):
            state = model.step(state, HYDRO_DT, assume_filled=True)
        t1 = time.perf_counter()
        e1.record()
        e1.synchronize()
        hydro_ms[path] = e0.elapsed_time(e1) / HYDRO_TIMED
        hydro_enqueue[path] = (t1 - t0) * 1e3 / HYDRO_TIMED
        st = state
        total = HYDRO_WARM + HYDRO_TIMED
        if path == "kernel":
            for name in hydro_kernels:
                n = launches[name] = wrappers[name].launches
                require(n == total, f"hydro_vi: {name} launched {n} times "
                        f"in {total} steps")
            others = [k for k in wrappers if k not in hydro_kernels
                      and wrappers[k].launches]
            require(not others, f"hydro_vi: unexpected launches of {others}")
        else:
            require(all(fn.launches == 0 for fn in wrappers.values()),
                    "hydro_vi: the plain path launches no kernel")
        g9 = model.grid
        require(all(bool(torch.isfinite(q).all())
                    for q in (st.u, st.v, st.w, st.eta,
                              *st.tracers.values())),
                f"hydro_vi {path} path: finite fields")
        xy = g9.interior_slices[:2]
        hydro_cmp[path] = {
            "velocities": [g9.interior(st.u).clone(),
                           g9.interior(st.v).clone()],
            "eta": [st.eta[xy].clone()],
            "tracers": [g9.interior(st.tracers[n]).clone()
                        for n in ("T", "S")]}
        log(f"[9] hydro_vi {path} path: {hydro_ms[path]:.3f} ms/step "
            f"(steps {HYDRO_WARM + 1} to {total} of AB2, CUDA events); host "
            f"enqueue {hydro_enqueue[path]:.3f} ms/step; max|u| "
            f"{float(g9.interior(st.u).abs().max()):.4e}, max|eta| "
            f"{float(st.eta[xy].abs().max()):.4e}")
        # the device's idle share: torch.profiler's kernel time over a few
        # more steps (after the counts and the compared fields are read),
        # against their wall time under the profiler and against the
        # unprofiled step
        from torch.profiler import ProfilerActivity, profile
        n_prof = PROFILE_STEPS
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e0.record()
            for _ in range(n_prof):
                state = model.step(state, HYDRO_DT, assume_filled=True)
            e1.record()
            e1.synchronize()
        busy = _kernel_time_us(prof)[0] / 1e3 / n_prof
        wall = e0.elapsed_time(e1) / n_prof
        require(busy > 0, f"hydro_vi {path} path: the profiler saw device "
                "time")
        log(f"[9] hydro_vi {path} path under torch.profiler, {n_prof} "
            f"steps: device-busy {busy:.3f} ms/step in a wall of "
            f"{wall:.3f} ms/step, idle share {1 - busy / wall:.3f}; against "
            f"the unprofiled {hydro_ms[path]:.3f} ms/step, idle share "
            f"{1 - busy / hydro_ms[path]:.3f}")
        del model, state, st, prof
        torch.cuda.empty_cache()
    hydro_rel = {}
    for group, ks in hydro_cmp["kernel"].items():
        ps = hydro_cmp["plain"][group]
        hydro_rel[group] = max(float((a - b).abs().max())
                               for a, b in zip(ks, ps)) / max(
            float(b.abs().max()) for b in ps)
    log(f"[9] hydro_vi: launches {[launches[k] for k in hydro_kernels]} in "
        f"{HYDRO_WARM + HYDRO_TIMED} kernel-path steps; kernel vs plain path "
        "after them: " + ", ".join(
            f"{k} {v:.3e} of the largest value (tolerance "
            f"{HYDRO_PATH_RTOL[k]:g})" for k, v in hydro_rel.items()))
    require(all(hydro_rel[k] <= HYDRO_PATH_RTOL[k] for k in hydro_rel),
            f"hydro_vi kernel vs plain path {hydro_rel}")
    del hydro_cmp
    torch.cuda.empty_cache()

    # hydro_vi with WENOVectorInvariant(order=7): all four schemes WENO(7),
    # which the vector-invariant kernel takes since its order-generic
    # tiles; 1 + 3 steps on both paths, one launch of each kernel a step
    # and no other, held to the bounds of the 52-step run
    o7_steps, o7 = 1 + 3, {}
    for path, fused in (("kernel", "auto"), ("plain", False)):
        model = hydro_model(fused, momentum_advection=ot.WENOVectorInvariant(
            order=7))
        require(model.fused_kernels == model.fused_tracer
                == (path == "kernel"),
                f"hydro_vi order=7 {path} path selects fused_kernels="
                f"{model.fused_kernels}, fused_tracer={model.fused_tracer}")
        state = model.update_state(hydro_initial_state(model))
        torch.cuda.synchronize()
        zero_counts()
        state = model.step(state, HYDRO_DT, assume_filled=True)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(o7_steps - 1):
            state = model.step(state, HYDRO_DT, assume_filled=True)
        e1.record()
        e1.synchronize()
        counts = {k: fn.launches for k, fn in wrappers.items()
                  if fn.launches}
        want = ({k: o7_steps for k in hydro_kernels} if path == "kernel"
                else {})
        require(counts == want, f"hydro_vi order=7 {path} path launches "
                f"{counts}, expected {want}")
        g9 = model.grid
        require(all(bool(torch.isfinite(q).all())
                    for q in (state.u, state.v, state.w, state.eta,
                              *state.tracers.values())),
                f"hydro_vi order=7 {path} path: finite fields")
        xy = g9.interior_slices[:2]
        o7[path] = (e0.elapsed_time(e1) / (o7_steps - 1), {
            "velocities": [g9.interior(state.u).clone(),
                           g9.interior(state.v).clone()],
            "eta": [state.eta[xy].clone()],
            "tracers": [g9.interior(state.tracers[n]).clone()
                        for n in ("T", "S")]})
        del model, state
        torch.cuda.empty_cache()
    o7_rel = {}
    for group, ks in o7["kernel"][1].items():
        ps = o7["plain"][1][group]
        o7_rel[group] = max(float((a - b).abs().max())
                            for a, b in zip(ks, ps)) / max(
            float(b.abs().max()) for b in ps)
    require(all(o7_rel[k] <= HYDRO_PATH_RTOL[k] for k in o7_rel),
            f"hydro_vi order=7 kernel vs plain path {o7_rel}")
    log(f"[9] hydro_vi with WENOVectorInvariant(order=7), {o7_steps} steps: "
        f"kernel path {o7['kernel'][0]:.3f} ms/step, plain path "
        f"{o7['plain'][0]:.3f} ms/step (steps 2 to {o7_steps}, CUDA "
        f"events); one VI and one tracer launch a step; kernel vs plain "
        "path: " + ", ".join(f"{k} {v:.3e}" for k, v in o7_rel.items())
        + " of the largest value")
    del o7
    torch.cuda.empty_cache()

    # a small float64 run: the kernel path on the card against the plain
    # path on the CPU, which the CPU tests hold against the JAX package;
    # from a state without rounding-level zeros of the velocities, where
    # the Bernoulli term's upwind select is discontinuous (bench.py's state
    # has them and amplifies the devices' rounding differences to ~1e-10)
    f64 = {}
    for device in ("cuda", "cpu"):
        m = hydro_model("auto", torch.float64, device, size=(48, 16, 6))
        require(m.fused_kernels == m.fused_tracer == (device == "cuda"),
                "float64 hydro_vi routes")
        st = hydro_generic_state(m)
        for _ in range(5):
            st = m.step(st, HYDRO_DT)
        f64[device] = (m.grid, st)
    (gk, sk), (gp, sp) = f64["cuda"], f64["cpu"]
    xy = gp.interior_slices[:2]
    groups = {"velocities": [(gk.interior(sk.u).cpu(), gp.interior(sp.u)),
                             (gk.interior(sk.v).cpu(), gp.interior(sp.v))],
              "w": [(gk.interior(sk.w).cpu(), gp.interior(sp.w))],
              "eta": [(sk.eta[xy].cpu(), sp.eta[xy])],
              "tracers": [(gk.interior(sk.tracers[n]).cpu(),
                           gp.interior(sp.tracers[n])) for n in ("T", "S")]}
    hydro64 = {k: max(float((a - b).abs().max()) for a, b in pairs)
               / max(float(b.abs().max()) for _, b in pairs)
               for k, pairs in groups.items()}
    require(all(v <= 1e-12 for v in hydro64.values()),
            f"float64 (48, 16, 6) hydro_vi card vs CPU {hydro64}")
    log("[9] float64 (48, 16, 6) hydro_vi, 5 AB2 steps: kernel path on the "
        "card vs plain path on the CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in hydro64.items())
        + " of the largest value (tolerance 1e-12)")
    log(f"[9] step times on {card}: hydro_vi kernel path "
        f"{hydro_ms['kernel']:.3f} ms/step, plain path "
        f"{hydro_ms['plain']:.3f} ms/step")
    del f64, m, st
    torch.cuda.empty_cache()

    # ---- phase 10: kernel 14 at full width ------------------------------
    # bench.py's weno_mom grid (256³, extent 1, (Bounded, Periodic,
    # Periodic), float32) with the x halo each scheme needs, on random
    # filled fields with exact zero rows; the entry point a user calls, once
    # per scheme, is kernel 14's main path
    full_schemes = {
        "WENO(5)": ot.WENO(5), "Centered(4)": ot.Centered(4),
        "UpwindBiased(5)": ot.UpwindBiased(5), "WENO(9)": ot.WENO(9),
        "FluxForm(WENO(5), Centered(2), UpwindBiased(3))":
            ot.FluxFormAdvection(ot.WENO(5), ot.Centered(2),
                                 ot.UpwindBiased(3))}
    generic_ms = {}
    for label, sch in full_schemes.items():
        H = sch.required_halo
        g10 = grid_of((N, N, N), (H, 0, 0))
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W)):
            a = torch.randn(g10.shape, generator=gen, device=dev, dtype=f32)
            if n == 0:
                a[:, :, ::3] = 0.0
            if n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, g10, loc=loc))
        torch.cuda.synchronize()
        zero_counts()
        got = cg.fused_momentum_tendency(g10, sch, *fs)
        torch.cuda.synchronize()
        n14 = cg.fused_momentum_tendency.launches
        others = [k for k in wrappers if k != "fused_momentum_tendency"
                  and wrappers[k].launches]
        require(n14 == 1 and not others, f"phase 10 {label}: kernel 14 "
                f"launched {n14} times, others {others}")
        launches["fused_momentum_tendency"] = (
            launches.get("fused_momentum_tendency", 0) + n14)
        ref = cg.fused_momentum_tendency_plain(g10, sch, *fs)
        torch.cuda.synchronize()
        check("fused_momentum_tendency", f"{label} at {tuple(g10.shape)}",
              got, ref, WENO_RTOL)
        if label == "WENO(5)":
            # kernel 7 computes the same function on the interior x-rows
            k7 = cw.weno5_momentum_tendency(g10, *fs)
            torch.cuda.synchronize()
            S = slice(H, g10.shape[0] - H)
            err7 = max(float((a[S] - b[S]).abs().max())
                       for a, b in zip(got, k7))
            tol7 = WENO_RTOL * scale(ref)
            log(f"[10] WENO(5): kernel 14 vs kernel 7 max|diff| {err7:.3e}"
                f" (tolerance {tol7:.3e})")
            require(err7 <= tol7, f"kernel 14 vs kernel 7 {err7:.3e}")
            # and kernel 7 against its own plain version on these fields
            # with exact zero rows, every row (x-halo rows zero in both)
            p7 = cw.weno5_momentum_tendency_plain(g10, *fs)
            torch.cuda.synchronize()
            err7p = max_err(k7, p7)
            tol7p = WENO_RTOL * scale(p7)
            log(f"[10] WENO(5), zero rows: kernel 7 vs its plain version "
                f"max|diff| {err7p:.3e} (tolerance {tol7p:.3e})")
            require(err7p <= tol7p, f"kernel 7 vs plain on zero rows "
                    f"{err7p:.3e}")
            del k7, p7
        del got, ref
        torch.cuda.empty_cache()
        reps = 5
        field = fs[0].numel() * fs[0].element_size()
        bound_ms, bound_by = bound(6 * field,
                                   N ** 3 * generic_point_ops(sch))
        plain_ms, ms = paired_times(
            torch, lambda: cg.fused_momentum_tendency_plain(g10, sch, *fs),
            lambda: cg.fused_momentum_tendency(g10, sch, *fs), reps)
        line = (f"[10] fused_momentum_tendency {label} at "
                f"{tuple(g10.shape)} float32 on {card}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}, {generic_point_ops(sch)} operations a point)")
        if label == "WENO(5)":
            # kernel 7 computes the same function: the two timed in turn
            # (7, 14, 14, 7) on these fields and on fields without the
            # exact zero rows (phase 3's kernel 7 timing takes such fields)
            for data in ("with zero rows", "without zero rows"):
                if data == "without zero rows":
                    fs = filled_fields(g10, 3)
                k7_ms, k14_ms = paired_times(
                    torch, lambda: cw.weno5_momentum_tendency(g10, *fs),
                    lambda: cg.fused_momentum_tendency(g10, sch, *fs), reps)
                line += (f"; {data}: kernel 7 (same function) {k7_ms:.4f} "
                         f"ms, kernel 14 {k14_ms:.4f} ms in turn")
            report["fused_momentum_tendency"].update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
        generic_ms[label] = ms
        log(line)
        del fs
        torch.cuda.empty_cache()
    log(f"[10] kernel 14 launches in its main path (one call per scheme): "
        f"{launches['fused_momentum_tendency']}")

    # ---- phase 11: Simulation at full width -----------------------------
    # bitwise: 100 constant-Δt steps of the 256³ default model (kernel 1)
    # through Simulation(stop_iteration=100) against the bare loop of
    # phase 4 from the same state: one window of 100 steps (the default
    # NaN checker actuates every 100), and a refill of filled halos is
    # idempotent
    SIM_STEPS = 100
    model = ot.NonhydrostaticModel(grid=grid,
                                   timestepper="QuasiAdamsBashforth2")
    s0 = initial_state(model)
    copy0 = {k: getattr(s0, k).clone() for k in ("u", "v", "w", "pressure",
                                                 "Gu", "Gv", "Gw")}

    def fresh():
        return dataclasses.replace(
            s0, **{k: t.clone() for k, t in copy0.items()})

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    bare = run(model, fresh(), SIM_STEPS)
    e1.record()
    e1.synchronize()
    bare_ms = e0.elapsed_time(e1) / SIM_STEPS
    sim = ot.Simulation(model, state=fresh(), dt=dt,
                        stop_iteration=SIM_STEPS)
    zero_counts()
    e0.record()
    t0 = time.perf_counter()
    sim.run()
    e1.record()
    e1.synchronize()
    sim_wall_ms = (time.perf_counter() - t0) * 1e3 / SIM_STEPS
    sim_ms = e0.elapsed_time(e1) / SIM_STEPS
    n1 = ck.centered2_ab2_update.launches
    require(n1 == SIM_STEPS, f"Simulation: kernel 1 launched {n1} times "
            f"in {SIM_STEPS} steps")
    require(sim.state.clock.iteration == SIM_STEPS
            and sim.stop_reason == "stop_iteration reached",
            f"Simulation stopped at {sim.state.clock.iteration}: "
            f"{sim.stop_reason}")
    same = all(torch.equal(getattr(sim.state, k), getattr(bare, k))
               for k in ("u", "v", "w", "pressure", "Gu", "Gv", "Gw"))
    log(f"[11] Simulation, {SIM_STEPS} AB2 steps at {N}^3 (default, kernel "
        f"1 launched {n1} times): bitwise equal to the bare loop: {same}")
    require(same, "Simulation equals the bare loop bit for bit")
    # a second pair, for the timing: the bare loop then Simulation.run
    # again, alternated with the first
    e0.record()
    bare = run(model, fresh(), SIM_STEPS)
    e1.record()
    e1.synchronize()
    bare_ms2 = e0.elapsed_time(e1) / SIM_STEPS
    sim = ot.Simulation(model, state=fresh(), dt=dt,
                        stop_iteration=SIM_STEPS)
    e0.record()
    sim.run()
    e1.record()
    e1.synchronize()
    sim_ms2 = e0.elapsed_time(e1) / SIM_STEPS
    log(f"[11] on {card}: Simulation.run {sim_ms:.4f} and {sim_ms2:.4f} "
        f"ms/step (host clock {sim_wall_ms:.4f}), bare loop {bare_ms:.4f} "
        f"and {bare_ms2:.4f} ms/step ({SIM_STEPS} steps each, CUDA "
        f"events, one fill each)")
    del bare, sim
    torch.cuda.empty_cache()

    # the wizard: TimeStepWizard(cfl=0.5) every 10 iterations, a progress
    # callback every 10 iterations, a recorder every 0.002 of model time,
    # and a stop_time that the alignment reaches with a shortened last Δt.
    # The clock is float32, as in the JAX package; the recorder fires at
    # 0, 0.002, 0.004 and 0.006, where the clock is within its margin of
    # them (``utils.schedules.time_margin``)
    progress, timed = [], []

    def recorder(into):
        return lambda s: into.append((s.state.clock.iteration,
                                      float(s.state.clock.time), s.dt))

    sim = ot.Simulation(model, state=fresh(), dt=dt, stop_time=0.006)
    sim.callbacks["wizard"] = ot.Callback(ot.TimeStepWizard(cfl=0.5),
                                          ot.IterationInterval(10))
    sim.callbacks["progress"] = ot.Callback(recorder(progress),
                                            ot.IterationInterval(10))
    sim.callbacks["timed"] = ot.Callback(recorder(timed),
                                         ot.TimeInterval(0.002))
    zero_counts()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wiz_s = time.perf_counter() - t0
    st = sim.state
    nwiz = st.clock.iteration
    require(finite(st), "wizard run: finite fields")
    umax11 = interior_max(grid, st)
    div11 = max_div(grid, st)
    last_dt = float(st.clock.last_dt)
    require(div11 <= 1e-5 * umax11 / dx,
            f"wizard run: max|div| {div11:.3e} <= 1e-5 max|u|/dx")
    require(abs(float(st.clock.time) - 0.006) <= 1e-6 and last_dt < sim.dt,
            f"wizard run ends at t = {float(st.clock.time)} with the last "
            f"Δt {last_dt} < {sim.dt}")
    require(ck.centered2_ab2_update.launches == nwiz,
            "wizard run: kernel 1 once a step")
    require([round(t / 0.002) for _, t, _ in timed] == [0, 1, 2, 3],
            f"wizard run: TimeInterval(0.002) fired at {timed}")
    log(f"[11] wizard run: {nwiz} steps to t = {float(st.clock.time):.6g} "
        f"in {wiz_s:.3f} s on {card}; Δt {dt:g} -> {sim.dt:.6g}, last Δt {last_dt:.6g}"
        f" (cut by the alignment); progress {progress}; TimeInterval(0.002) "
        f"fired at {timed}; max|u| "
        f"{umax11:.4e}, max|div| {div11:.3e} (bound {1e-5 * umax11 / dx:.3e})")
    del sim, st, model, s0, copy0
    torch.cuda.empty_cache()

    # a 256³ UpwindBiased(5) model through Simulation: no kernel applies,
    # so it runs the plain path on the card
    g11 = grid_of((N, N, N), (3, 0, 0))
    model = ot.NonhydrostaticModel(grid=g11, advection=ot.UpwindBiased(5),
                                   timestepper="QuasiAdamsBashforth2")
    require(model.fused_kernels is False, "UpwindBiased(5) takes no kernel")
    sim = ot.Simulation(model, state=initial_state(model), dt=dt,
                        stop_iteration=20)
    zero_counts()
    torch.cuda.synchronize()
    e0.record()
    sim.run()
    e1.record()
    e1.synchronize()
    ub_ms = e0.elapsed_time(e1) / 20
    require(all(fn.launches == 0 for fn in wrappers.values()),
            "UpwindBiased(5) run launches no kernel")
    st = sim.state
    require(finite(st), "UpwindBiased(5) run: finite fields")
    umax_ub = interior_max(g11, st)
    div_ub = max_div(g11, st)
    require(div_ub <= 1e-5 * umax_ub / dx,
            f"UpwindBiased(5) run: max|div| {div_ub:.3e}")
    log(f"[11] UpwindBiased(5) at {N}^3, 20 AB2 steps through Simulation on "
        f"the plain path: {ub_ms:.3f} ms/step on {card}; max|u| "
        f"{umax_ub:.4e}, max|div| {div_ub:.3e}")
    del sim, st, model
    torch.cuda.empty_cache()

    # ---- phase 12: the wind-mixing LES (kernels 7 and 9) ------------------
    les = les_phase(torch, ot, wrappers, card)

    # ---- phase 13: hydro_vi with closures (kernels 11 and 12/13) ---------
    hydro_closure = hydro_closure_phase(torch, ot, wrappers, card,
                                        HYDRO_PATH_RTOL)
    log(f"[13] step times on {card}: les kernel path {les['kernel']['ms']:.3f}"
        f" ms/step, plain path {les['plain']['ms']:.3f} ms/step; "
        f"hydro_vi_closure kernel path {hydro_closure['kernel']['ms']:.3f} "
        f"ms/step, plain path {hydro_closure['plain']['ms']:.3f} ms/step")

    # ---- phase 14: hydro_vi on the sphere (kernels 11 and 12/13) ---------
    latlon = hydro_latlon_phase(torch, ot, wrappers, card, HYDRO_PATH_RTOL)
    log(f"[14] step times on {card}: hydro_vi_latlon kernel path "
        f"{latlon['kernel']['ms']:.3f} ms/step, plain path "
        f"{latlon['plain']['ms']:.3f} ms/step")

    # ---- phase 15: the cubed sphere's shallow water (Williamson 2) -------
    cs_w2 = cs_w2_phase(torch, wrappers, card)

    # ---- phase 16: the cubed sphere's global ocean (bench.py cs_global) --
    cs_global = cs_global_phase(torch, wrappers, card)
    log(f"[16] step times on {card}: cs_w2 C192 {cs_w2['ms']:.3f} ms/step; "
        + "; ".join(f"cs_global {k} {v['ms']:.3f} ms/step"
                    for k, v in cs_global.items()))

    # ---- phase 17: output (writers, averages, checkpoints, ensembles) ---
    output_phase(torch, ot, wrappers, card, dev, {
        "sim_ms": sim_ms, "bare_ms": bare_ms,
        "hydro_ms": hydro_ms["kernel"]})

    # ---- phases 18 to 20: immersed boundaries and stretched grids --------
    seamount = seamount_phase(torch, ot, wrappers, card)
    bathy = bathy_phase(torch, ot, wrappers, card)
    stretched = les_stretched_phase(torch, ot, wrappers, card)
    log(f"[20] step times on {card}: seamount {seamount['ms']:.3f} ms/step "
        f"(CG iterations {seamount['iterations']}), hydro_vi_bathy "
        f"{bathy['ms']:.3f} ms/step, les_stretched {stretched['ms']:.3f} "
        f"ms/step against phase 12's les plain path {les['plain']['ms']:.3f} "
        f"ms/step; none launched a port kernel")

    # ---- phases 21 and 22: forcings, particles, the ocean closures -------
    langmuir = langmuir_phase(torch, ot, wrappers, card)
    catke = catke_phase(torch, ot, wrappers, card, HYDRO_PATH_RTOL)
    log(f"[22] step times on {card}: langmuir kernel path "
        f"{langmuir['kernel']['ms']:.3f} ms/step (plain "
        f"{langmuir['plain']['ms']:.3f}, host syncs a step "
        f"{langmuir['kernel']['syncs']}); weno with a sponge kernel path "
        f"{langmuir['sponge']['kernel']:.3f} (plain "
        f"{langmuir['sponge']['plain']:.3f}); weno with background fields "
        f"{langmuir['background']['kernel']:.3f}; hydro_catke kernel path "
        f"{catke['kernel']['ms']:.3f} ms/step (plain "
        f"{catke['plain']['ms']:.3f}, host syncs a step "
        f"{catke['kernel']['syncs']})")

    # ---- phases 23 to 26: the implicit free surface, split RK3 with the
    # bound-preserving limiters, z-star ---------------------------------
    implicit = implicit_phase(torch, ot, wrappers, card, HYDRO_PATH_RTOL)
    split_rk3 = split_rk3_phase(torch, ot, wrappers, card, HYDRO_PATH_RTOL)
    zstar = zstar_phase(torch, ot, wrappers, card)
    cs_implicit = cs_implicit_phase(torch, wrappers, card)
    log(f"[26] step times on {card}: hydro_implicit kernel path "
        f"{implicit['kernel']['ms']:.3f} ms/step (plain "
        f"{implicit['plain']['ms']:.3f}; 'matrix' "
        f"{implicit['matrix']['ms']:.3f}, 'cg' {implicit['cg']['ms']:.3f}); "
        "hydro_split_rk3 kernel path "
        f"{split_rk3[('24a', 'kernel')]['ms']:.3f} ms/step (plain "
        f"{split_rk3[('24a', 'plain')]['ms']:.3f}; BoundPreserving kernel "
        f"path {split_rk3[('24b', 'kernel')]['ms']:.3f}); hydro_zstar "
        f"{zstar['ms']:.3f} ms/step; cs_global_implicit C48x16 "
        f"{cs_implicit['26a']['ms']:.3f} ms/step, with ZStar "
        f"{cs_implicit['26b']['ms']:.3f} ms/step")

    # ---- phase 27: the distributed layer (kernels 2, 7, 9, 11, 12/13 on
    # every rank's block) ----------------------------------------------------
    dist_phase(torch, wrappers, card, launches)

    # ---- phase 28: sharded_step_fn at full width (kernels 2, 7, 9, 10,
    # 11, 12/13 on every rank's block) --------------------------------------
    gspmd_phase(torch, card, launches)

    # ---- phase 29: the tripolar fold across ranks (no kernel) and blocks
    # narrower than their halo (kernels 7 and 9 on blocks of 3 and 2) ------
    gspmd_phase(torch, card, launches, FOLD_PARTS, "29")

    # ---- phase 30: ensembles through the kernels (every row under vmap)
    # and the batched conjugate gradient -----------------------------------
    ensemble_phase(torch, ot, wrappers, card, dev, launches, HYDRO_PATH_RTOL)

    sources = {"centered2_ab2_update": ("oceananigans_torch/csrc/centered2.cu",
                                        "oceananigans_tpu/ops/pallas_kernels.py:628"),
               "centered2_momentum_tendency": (
                   "oceananigans_torch/csrc/centered2.cu",
                   "oceananigans_tpu/ops/pallas_kernels.py:371"),
               "pressure_correction": (
                   "oceananigans_torch/csrc/pressure_correction.cu",
                   "oceananigans_tpu/ops/pallas_kernels.py:297"),
               "fused_middle_solve": (
                   "oceananigans_torch/csrc/poisson_middle.cu",
                   "oceananigans_tpu/ops/pallas_poisson.py:101"),
               "weno5_ab2_update": (
                   "oceananigans_torch/csrc/weno5_science_tile.cu",
                   "oceananigans_tpu/ops/pallas_weno.py:603"),
               "weno5_momentum_tendency": (
                   "oceananigans_torch/csrc/weno5_tile.cu",
                   "oceananigans_tpu/ops/pallas_weno.py:664"),
               "weno5_science_ab2_update": (
                   "oceananigans_torch/csrc/weno5_science_tile.cu",
                   "oceananigans_tpu/ops/pallas_weno.py:528"),
               "weno5_tracer_tendencies": (
                   "oceananigans_torch/csrc/weno5_science_tile.cu",
                   "oceananigans_tpu/ops/pallas_weno.py:783"),
               "centered2_science_ab2_update": (
                   "oceananigans_torch/csrc/centered2.cu",
                   "oceananigans_tpu/ops/pallas_kernels.py:574"),
               "sw_rk3_stage": ("oceananigans_torch/csrc/shallow_water.cu",
                                "oceananigans_tpu/ops/pallas_sw.py:207"),
               "weno_tracer_tendencies": (
                   "oceananigans_torch/csrc/vi_tile.h",
                   "oceananigans_tpu/ops/pallas_tracer.py:269"),
               "vi_momentum_tendency": (
                   "oceananigans_torch/csrc/vi_tile.h",
                   "oceananigans_tpu/ops/pallas_vi.py:634"),
               # the same CUDA kernel replaces both layouts' TPU kernels
               "vi_momentum_tendency_zyx": (
                   "oceananigans_torch/csrc/vi_tile.h",
                   "oceananigans_tpu/ops/pallas_vi.py:538"),
               "fused_momentum_tendency": (
                   "oceananigans_torch/csrc/generic_tile.h",
                   "oceananigans_tpu/ops/pallas_generic.py:111")}
    same = {"vi_momentum_tendency_zyx": "vi_momentum_tendency"}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[same.get(name, name)],
                **{k: report[same.get(name, name)][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name, (src, rep) in sources.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
