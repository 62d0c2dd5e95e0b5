#!/usr/bin/env python3
"""Time the Centered-2 tendency kernel (``centered2_momentum_tendency``),
the Poisson middle-stage kernel (``fused_middle_solve``), the WENO-5
momentum tendency, momentum AB2, science step and tracer tendency
kernels (``weno5_momentum_tendency``, ``weno5_ab2_update``,
``weno5_science_ab2_update``, ``weno5_tracer_tendencies``), the
shallow-water stage kernel (``sw_rk3_stage``), the WENO tracer kernel
(``weno_tracer_tendencies``) and the WENO vector-invariant kernel
(``vi_momentum_tendency``) and the generic momentum kernel
(``fused_momentum_tendency``) of one checkout of ``oceananigans_torch``
on one GPU, and print one JSON line.

    python3 tools/kernel_times.py [--root DIR] [--reps N]

``--root`` is the directory that holds the ``oceananigans_torch`` package
to time (default: this checkout); its kernels are built there, under
``DIR/build``, at first use. Two checkouts are compared by running this
script in turns in one session on one card (a, b, b, a): the inputs are
made from fixed seeds, so every run times the same work.

At 256³ in float32, as ``chip_smoke.py`` phases 3 and 10 call them:

- on a grid with halo (1, 0, 0), on random halo-filled u, v, w and on the
  same fields with u exactly zero on every third z-column and v on every
  other x-plane: ``centered2_momentum_tendency``, with a SHA-256 of its
  outputs; and on the random fields, with tracers b and c and random
  G_prev, ``centered2_ab2_update`` (the default AB2 step) and
  ``centered2_science_ab2_update`` (f-plane f = 1e-4, b the buoyancy
  tracer), each with a SHA-256 of all its outputs (two checkouts whose
  kernels compute the same bits print the same digests);

- ``fused_middle_solve`` on an x-transformed random right-hand side of a
  (Bounded, Periodic, Periodic) grid, its plain version (the
  ``torch.matmul`` chain that makes the 1/λ table on every call) and the
  same chain with the table made once;
- ``weno5_momentum_tendency`` on a grid with halo (3, 0, 0), on random
  halo-filled u, v, w, and on the same fields with u exactly zero on every
  third z-column and v on every other x-plane, with a SHA-256 of its
  outputs (two checkouts whose kernels compute the same bits print the
  same digest);
- on the same grid and both kinds of fields, with two tracers c and b:
  ``weno5_ab2_update`` as the ``weno_mom`` step calls it (beside the
  science step with no tracers, f = 0 and no buoyancy, the same function
  through the science kernel's instantiation with physics),
  ``weno5_science_ab2_update`` as the WENO science step calls it (f-plane
  f = 1e-4, b the buoyancy tracer) and ``weno5_tracer_tendencies``;
- ``sw_rk3_stage`` at 8192² (``bench.py``'s ``sw8192`` grid: halo
  (8, 0, 0), (Periodic, Periodic, Flat)) on random fields near the
  benchmark's (h ~ 1000, uh and vh ~ 100), with a SHA-256 of its outputs;
- at ``hydro_vi``'s 360 × 160 × 60 (halo (6, 6, 4), (Periodic, Bounded,
  Bounded), extent (4e7, 2e7, 4e3)), on random halo-filled u, v, w, T, S
  and on the same fields with u exactly zero on every third z-column and
  v on every other x-plane: ``weno_tracer_tendencies`` with WENO(7) for T
  and S as the model calls it, and ``vi_momentum_tendency`` with
  ``WENOVectorInvariant()`` (WENO-9 ζ with VelocityStencil, WENO-5 rest)
  and, where the checkout's kernel takes it, ``WENOVectorInvariant(order=
  7)``; and, where the checkout has the x-marching tiles of
  ``csrc/vi_tile.h``, their launch plans at that shape and the dynamic
  shared memory of a block for every instantiated order;
- ``fused_momentum_tendency`` on grids with the x halo of each scheme's
  reach, on random and zero-row fields, for WENO(5), Centered(4),
  UpwindBiased(5), WENO(9) and FluxFormAdvection(WENO(5), Centered(2),
  UpwindBiased(3)), as phase 10 of ``chip_smoke.py`` calls it.

Each kernel's largest difference from its plain version, relative to the
largest plain value, is printed beside its time; the times are CUDA-event
means over back-to-back calls, and for kernel 2, whose calls are short
enough for the host's launch time to matter, also its device time under
``torch.profiler`` (``device_ms``). The line also carries the
card's name and power limit, the counts of a few SASS instructions in the
kernels (``cuobjdump -sass``; the kernel names of earlier checkouts
included) and, when this run built the kernels, nvcc's registers, shared
memory and spills of them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def time_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up
    call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Mean device time of the CUDA kernels one call of ``fn`` launches,
    in ms, from ``torch.profiler`` over ``reps`` calls after one warm-up
    call: the kernels' own time, without the host's time to launch them
    (which CUDA events over back-to-back calls include where it is the
    longer)."""
    from torch.profiler import ProfilerActivity, profile

    from oceananigans_torch.profile_step import _kernel_time_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _kernel_time_us(prof)[0] / 1e3 / reps


def ptxas_report(log, kernels):
    """``{mangled name: [ptxas lines]}`` of the entry functions whose names
    contain one of ``kernels``: their registers, shared memory and spills
    from nvcc's ``-Xptxas -v`` report."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if any(k in name for k in kernels) else None
            if cur:
                out[cur] = []
        elif cur and ("spill" in line or "Used" in line):
            out[cur].append(line.strip())
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    import oceananigans_torch as ot
    from oceananigans_torch.ops import _build
    from oceananigans_torch.ops import cuda_poisson as cp
    from oceananigans_torch.ops import cuda_sw as csw
    from oceananigans_torch.ops import cuda_weno as cw
    if Path(ot.__file__).resolve().parent.parent != root:
        raise SystemExit(f"kernel_times.py: imported {ot.__file__}, not "
                         f"the package under {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.load()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root), "card": card, "reps": args.reps}

    def grid_of(halo):
        return ot.RectilinearGrid(
            size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
            dtype=f32, device=dev)

    def fields_of(grid, data, n=5):
        """u, v, w and n - 3 tracers, random and halo-filled; with "zero
        rows", u exactly zero on every third z-column, v on every other
        x-plane."""
        fs = []
        locs = (ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C, ot.LOC_C)
        for n_, loc in enumerate(locs[:n]):
            a = torch.randn(grid.shape, generator=gen, device=dev, dtype=f32)
            if data == "zero rows" and n_ == 0:
                a[:, :, ::3] = 0.0
            if data == "zero rows" and n_ == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, grid, loc=loc))
        return fs

    def sha256(tensors):
        digest = hashlib.sha256()
        for t in tensors:
            digest.update(t.cpu().numpy().tobytes())
        return digest.hexdigest()

    def rel_err(got, ref):
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max())
                   for g, r in zip(got, ref)) / scale

    # kernels 1, 2 and 5
    from oceananigans_torch.ops import cuda_kernels as ck
    grid = grid_of((1, 0, 0))
    out["centered2_momentum_tendency"] = {}
    for data in ("random", "zero rows"):
        u, v, w = fields_of(grid, data, 3)
        got = ck.centered2_momentum_tendency(grid, u, v, w)
        ref = ck.centered2_momentum_tendency_plain(grid, u, v, w)
        torch.cuda.synchronize()
        call = lambda: ck.centered2_momentum_tendency(grid, u, v, w)
        out["centered2_momentum_tendency"][data] = {
            "rel_err": rel_err(got, ref), "sha256": sha256(got),
            "kernel_ms": time_ms(torch, call, args.reps),
            "device_ms": device_ms(torch, call, args.reps)}
        del got, ref
    u, v, w, b, c = fields_of(grid, "random")
    G_prev = [0.1 * torch.randn(grid.shape, generator=gen, device=dev,
                                dtype=f32) for _ in range(5)]
    got = ck.centered2_ab2_update(grid, u, v, w,
                                  *(g.clone() for g in G_prev[:3]), 1.6e-4,
                                  -0.6e-4)
    torch.cuda.synchronize()
    Gk = [g.clone() for g in G_prev]
    out["centered2_ab2_update"] = {
        "sha256": sha256(got),
        "kernel_ms": time_ms(torch, lambda: ck.centered2_ab2_update(
            grid, u, v, w, *Gk[:3], 1.6e-4, -0.6e-4), args.reps)}

    def c2_science(G):
        res = ck.centered2_science_ab2_update(
            grid, u, v, w, {"b": b, "c": c}, *G[:3], {"b": G[3], "c": G[4]},
            1.6e-4, -0.6e-4, f=1e-4, buoyancy_tracer="b")
        return [*res[:3], *res[3].values(), *res[4:7], *res[7].values()]

    got = c2_science([g.clone() for g in G_prev])
    torch.cuda.synchronize()
    out["centered2_science_ab2_update"] = {
        "sha256": sha256(got),
        "kernel_ms": time_ms(torch, lambda: c2_science(Gk), args.reps)}
    del u, v, w, b, c, G_prev, Gk, got
    torch.cuda.empty_cache()

    # kernel 4
    solver = ot.MatmulPoissonSolver(grid)
    x = torch.randn(grid.N, generator=gen, device=dev, dtype=f32)
    x = solver._apply(x - x.mean(), 0, transpose=False)
    margs = (x, solver.T1, solver.T2, solver.lam0.to(f32), solver.lam1,
             solver.lam2)
    inv_lam = cp._inv_lambda(*margs[3:], f32)

    def chain():
        Ey, Ez = margs[1], margs[2]
        z = torch.matmul(torch.matmul(Ey, x), Ez.T) * inv_lam
        return torch.matmul(Ey.T, torch.matmul(z, Ez))

    ref = cp.fused_middle_solve_plain(*margs)
    got = cp.fused_middle_solve(*margs)
    torch.cuda.synchronize()
    out["fused_middle_solve"] = {
        "rel_err": float((got - ref).abs().max() / ref.abs().max()),
        "kernel_ms": time_ms(torch, lambda: cp.fused_middle_solve(*margs),
                             args.reps),
        "plain_ms": time_ms(torch, lambda: cp.fused_middle_solve_plain(
            *margs), args.reps),
        "table_chain_ms": time_ms(torch, chain, args.reps)}
    del solver, x, margs, inv_lam, ref, got
    torch.cuda.empty_cache()

    # kernels 6, 7, 8 and 9: u, v, w, tracers c and b, and G_prev of all
    # five
    grid = grid_of((3, 0, 0))
    fields = {}
    for data in ("random", "zero rows"):
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C,
                                 ot.LOC_C)):
            a = torch.randn(grid.shape, generator=gen, device=dev, dtype=f32)
            if data == "zero rows" and n == 0:
                a[:, :, ::3] = 0.0
            if data == "zero rows" and n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, grid, loc=loc))
        fields[data] = fs
    G_prev = [0.1 * torch.randn(grid.shape, generator=gen, device=dev,
                                dtype=f32) for _ in range(5)]

    def science(fn, u, v, w, c, b, G):
        res = fn(grid, u, v, w, {"c": c, "b": b}, *G[:3],
                 {"c": G[3], "b": G[4]}, 1.6e-4, -0.6e-4, f=1e-4,
                 buoyancy_tracer="b")
        return [*res[:3], *res[3].values(), *res[4:7], *res[7].values()]

    def tracers(fn, u, v, w, c, b):
        return list(fn(grid, u, v, w, {"c": c, "b": b}).values())

    def ab2(fn, u, v, w, G):
        return list(fn(grid, u, v, w, *G[:3], 1.6e-4, -0.6e-4))

    for name in ("weno5_momentum_tendency", "weno5_ab2_update",
                 "weno5_science_ab2_update", "weno5_tracer_tendencies"):
        out[name] = {}
    for data, fs in fields.items():
        rec = out["weno5_momentum_tendency"][data] = {}
        got = cw.weno5_momentum_tendency(grid, *fs[:3])
        ref = cw.weno5_momentum_tendency_plain(grid, *fs[:3])
        torch.cuda.synchronize()
        rec["rel_err"] = rel_err(got, ref)
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        rec["sha256"] = digest.hexdigest()
        rec["kernel_ms"] = time_ms(
            torch, lambda: cw.weno5_momentum_tendency(grid, *fs[:3]),
            args.reps)
        # the AB2 steps write G over G_prev: each side from its copy
        got = ab2(cw.weno5_ab2_update, *fs[:3],
                  [g.clone() for g in G_prev])
        ref = ab2(cw.weno5_ab2_update_plain, *fs[:3],
                  [g.clone() for g in G_prev])
        torch.cuda.synchronize()
        Gk = [g.clone() for g in G_prev]
        out["weno5_ab2_update"][data] = {
            "rel_err": rel_err(got, ref),
            "kernel_ms": time_ms(torch, lambda: ab2(
                cw.weno5_ab2_update, *fs[:3], Gk), args.reps),
            "science_t0_ms": time_ms(torch, lambda: (
                cw.weno5_science_ab2_update(grid, *fs[:3], {}, *Gk[:3], {},
                                            1.6e-4, -0.6e-4)), args.reps)}
        got = science(cw.weno5_science_ab2_update, *fs,
                      [g.clone() for g in G_prev])
        ref = science(cw.weno5_science_ab2_update_plain, *fs,
                      [g.clone() for g in G_prev])
        torch.cuda.synchronize()
        Gk = [g.clone() for g in G_prev]
        out["weno5_science_ab2_update"][data] = {
            "rel_err": rel_err(got, ref),
            "kernel_ms": time_ms(torch, lambda: science(
                cw.weno5_science_ab2_update, *fs, Gk), args.reps)}
        got = tracers(cw.weno5_tracer_tendencies, *fs)
        ref = tracers(cw.weno5_tracer_tendencies_plain, *fs)
        torch.cuda.synchronize()
        out["weno5_tracer_tendencies"][data] = {
            "rel_err": rel_err(got, ref),
            "kernel_ms": time_ms(torch, lambda: tracers(
                cw.weno5_tracer_tendencies, *fs), args.reps)}
        del got, ref, Gk
        torch.cuda.empty_cache()
    del grid, fields, G_prev
    torch.cuda.empty_cache()

    # kernel 10 at 8192²
    grid = ot.RectilinearGrid(
        size=(8192, 8192), x=(0.0, 1e6), y=(0.0, 1e6),
        topology=(ot.Periodic, ot.Periodic, ot.Flat), halo=(8, 0, 0),
        dtype=f32, device=dev)

    def rnd(sd, offset=0.0):
        return offset + sd * torch.randn(grid.shape, generator=gen,
                                         device=dev, dtype=f32)
    q = [rnd(100.0), rnd(100.0), rnd(1.0, 1000.0)]
    for fld, loc in zip(q, (ot.LOC_U, ot.LOC_V, ot.LOC_C)):
        ot.fill_halo_regions(fld, grid, loc=loc)
    G_prev = [rnd(1e-2) for _ in range(3)]
    got = csw.sw_rk3_stage(grid, *q, *(g.clone() for g in G_prev), 0.4,
                           -0.2, 9.81)
    ref = csw.sw_rk3_stage_plain(grid, *q, *(g.clone() for g in G_prev),
                                 0.4, -0.2, 9.81)
    torch.cuda.synchronize()
    ii = grid.interior_slices
    digest = hashlib.sha256()
    for g in got:
        digest.update(g.cpu().numpy().tobytes())
    Gk = [g.clone() for g in G_prev]
    out["sw_rk3_stage"] = {
        "rel_err_fields": rel_err([g[ii] for g in got[:3]],
                                  [r[ii] for r in ref[:3]]),
        "rel_err_tendencies": rel_err([g[ii] for g in got[3:]],
                                      [r[ii] for r in ref[3:]]),
        "sha256": digest.hexdigest(),
        "kernel_ms": time_ms(torch, lambda: csw.sw_rk3_stage(
            grid, *q, *Gk, 0.4, -0.2, 9.81), args.reps)}
    del got, ref, q, G_prev, Gk
    torch.cuda.empty_cache()

    # kernels 11 and 12/13 at hydro_vi's shape
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    grid = ot.RectilinearGrid(
        size=(360, 160, 60), extent=(4e7, 2e7, 4e3),
        topology=(ot.Periodic, ot.Bounded, ot.Bounded), halo=(6, 6, 4),
        dtype=f32, device=dev)
    schemes = {"default": ot.WENOVectorInvariant(),
               "order7": ot.WENOVectorInvariant(order=7)}
    out["weno_tracer_tendencies"] = {}
    out["vi_momentum_tendency"] = {}
    for data in ("random", "zero rows"):
        fs = []
        for n, loc in enumerate((ot.LOC_U, ot.LOC_V, ot.LOC_W, ot.LOC_C,
                                 ot.LOC_C)):
            a = torch.randn(grid.shape, generator=gen, device=dev, dtype=f32)
            if data == "zero rows" and n == 0:
                a[:, :, ::3] = 0.0
            if data == "zero rows" and n == 1:
                a[::2] = 0.0
            fs.append(ot.fill_halo_regions(a, grid, loc=loc))
        u, v, w, T, S = fs
        tr = {"T": T, "S": S}
        got = list(ctr.weno_tracer_tendencies(grid, ot.WENO(7), u, v, w,
                                              tr).values())
        ref = list(ctr.weno_tracer_tendencies_plain(grid, ot.WENO(7), u, v,
                                                    w, tr).values())
        torch.cuda.synchronize()
        out["weno_tracer_tendencies"][data] = {
            "rel_err": rel_err(got, ref),
            "kernel_ms": time_ms(torch, lambda: ctr.weno_tracer_tendencies(
                grid, ot.WENO(7), u, v, w, tr), args.reps)}
        for label, vi in schemes.items():
            if not cvi.vi_available(grid, vi):
                continue
            got = cvi.vi_momentum_tendency(grid, vi, u, v, w)
            ref = cvi.vi_momentum_tendency_plain(grid, vi, u, v, w)
            torch.cuda.synchronize()
            out["vi_momentum_tendency"][f"{label} {data}"] = {
                "rel_err": rel_err(got, ref),
                "kernel_ms": time_ms(
                    torch, lambda: cvi.vi_momentum_tendency(grid, vi, u, v, w),
                    args.reps)}
        del fs, u, v, w, T, S, tr, got, ref
        torch.cuda.empty_cache()
    # the march tiles' plans at hydro_vi's shape and their blocks' dynamic
    # shared memory, where the checkout has them
    lib = _build.load()
    if hasattr(lib, "ot_march_smem_bytes"):
        import ctypes
        fn = lib.ot_march_smem_bytes
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        shape = tuple(grid.shape)
        smem = out["march_smem_bytes"] = {}
        for itemsize in (4, 8):
            vp = ctr.march_plan(shape, 2, sms, itemsize)
            tp = ctr.march_plan(shape, 1, sms, itemsize, ctr.TRACER_EXTRA)
            smem[f"plans {itemsize}"] = {"vi": vp, "tracer": tp}
            for kv, kr in cvi.ORDER_PAIRS:
                smem[f"vi ({kv}, {kr}) velocity, itemsize {itemsize}"] = fn(
                    1, kv, kr, 1, vp[0], vp[1], itemsize)
            for k in ctr.ORDERS:
                smem[f"tracer {k}, itemsize {itemsize}"] = fn(
                    0, k, 0, 0, tp[0], tp[1], itemsize)

    # kernel 14 at 256³, each scheme with the x halo of its reach
    from oceananigans_torch.ops import cuda_generic as cg
    schemes14 = {
        "WENO(5)": ot.WENO(5), "Centered(4)": ot.Centered(4),
        "UpwindBiased(5)": ot.UpwindBiased(5), "WENO(9)": ot.WENO(9),
        "FluxForm(WENO(5), Centered(2), UpwindBiased(3))":
            ot.FluxFormAdvection(ot.WENO(5), ot.Centered(2),
                                 ot.UpwindBiased(3))}
    out["fused_momentum_tendency"] = {}
    for label, sch in schemes14.items():
        g14 = grid_of((sch.required_halo, 0, 0))
        for data in ("random", "zero rows"):
            u, v, w = fields_of(g14, data, 3)
            got = cg.fused_momentum_tendency(g14, sch, u, v, w)
            ref = cg.fused_momentum_tendency_plain(g14, sch, u, v, w)
            torch.cuda.synchronize()
            out["fused_momentum_tendency"][f"{label} {data}"] = {
                "rel_err": rel_err(got, ref),
                "kernel_ms": time_ms(
                    torch, lambda: cg.fused_momentum_tendency(g14, sch, u, v,
                                                              w),
                    max(2, args.reps // 4))}
            del u, v, w, got, ref
            torch.cuda.empty_cache()
    # the new tiles' launch plans at the main shapes and their blocks'
    # dynamic shared memory, where the checkout has them
    if hasattr(lib, "ot_generic_smem_bytes"):
        import ctypes
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        c2b = lib.ot_c2_tile_smem_bytes
        c2b.argtypes = [ctypes.c_int] * 3
        c2b.restype = ctypes.c_longlong
        gb = lib.ot_generic_smem_bytes
        gb.argtypes = [ctypes.c_int] * 4
        gb.restype = ctypes.c_longlong
        tiles = out["tile_plans"] = {}
        for itemsize in (4, 8):
            plan = ck.tendency_plan((258, 256, 256), sms, itemsize)
            tiles[f"c2_tile itemsize {itemsize}"] = {
                "plan": plan, "smem_bytes": c2b(plan[0], plan[1], itemsize)}
            for label, sch in schemes14.items():
                axis = cg.axis_schemes(sch)
                B = cg.reach(axis)
                plan = cg.momentum_plan((256 + 2 * B, 256, 256), B, axis,
                                        sms, itemsize)
                tiles[f"generic_march {label} itemsize {itemsize}"] = {
                    "plan": plan,
                    "smem_bytes": gb(B, plan[0], plan[1], itemsize)}

    kernels = ("c2_tile", "c2_tendency_kernel", "generic_march",
               "17momentum_tendencyI", "poisson_middle", "weno5_tile",
               "weno5_tendency",
               "weno5_science_tile", "weno5_tracer_tile", "weno5_step",
               "weno5_tracers", "sw_strip", "sw_stage", "vi_march",
               "weno_tracer_march", "vi_tendency", "weno_tracers")
    out["nvcc"] = ptxas_report(_build.build_log, kernels)
    # the instructions each kernel compiled to (chip_smoke.py's counter)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import sass_counts
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path()[1])],
                          capture_output=True, text=True, check=True).stdout
    out["sass"] = sass_counts(sass, kernels, ("HGMMA", "HMMA", "FFMA", "FCHK",
                                              "MUFU.RCP", "LDGSTS", "LDG.E",
                                              "STG.E", "LDS", "BAR.SYNC"))
    # all instructions (the lines that end in ";") of each float32
    # instantiation of the science kernel: with physics (kernel 8) and
    # without (kernel 6)
    out["sass_instructions"] = {
        k: v[";"] for k, v in sass_counts(
            sass, ("weno5_science_tileIfLb1", "weno5_science_tileIfLb0"),
            (";",)).items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
