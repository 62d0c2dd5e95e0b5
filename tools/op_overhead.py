#!/usr/bin/env python3
"""Time the host's cost of a kernel call and the step of the host-paced
models of one checkout of ``oceananigans_torch`` on one GPU, and print one
JSON line.

    python3 tools/op_overhead.py [--root DIR] [--reps N]

``--root`` is the directory that holds the ``oceananigans_torch`` package
to time (default: this checkout); its kernels are built there, under
``DIR/build``, at first use. Two checkouts (a kernel wrapper that calls
``ctypes`` directly, and one that calls its custom operator) are compared
by running this script in turns on one card in one job (a, b, b, a).

- ``calls``: the host's microseconds a call, over ``--reps`` calls after a
  warm-up, of four wrappers at small shapes where the card finishes each
  kernel before the host enqueues the next: ``centered2_momentum_tendency``
  and ``centered2_ab2_update`` (which writes G⁻ in place) on a 16³ grid
  with halo (1, 0, 0), ``weno_tracer_tendencies`` (WENO(7), T and S) and
  ``vi_momentum_tendency`` (``WENOVectorInvariant()``) on a (24, 12, 6)
  grid with halo (6, 6, 4); and the card's microseconds a call of the
  same loop (CUDA events), which the host paces at these shapes;
- ``steps``: ms a step (CUDA events, 2 warm-up and 10 timed steps) of
  ``hydro_vi`` (360 × 160 × 60, kernels 11 and 12/13 once a step),
  ``hydro_implicit`` ("fft", and "cg" at JAX's defaults), ``cs_w2`` at
  C192 (no kernel) and the 256³ ``default`` model (kernel 1).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def host_us(torch, fn, reps):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    e1.record()
    e1.synchronize()
    return (t1 - t0) * 1e6 / reps, e0.elapsed_time(e1) * 1e3 / reps


def step_ms(torch, model, state, dt, warm=2, steps=10):
    for _ in range(warm):
        state = model.step(state, dt)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        state = model.step(state, dt)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / steps


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--reps", type=int, default=2000)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import oceananigans_torch as ot
    if Path(ot.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {ot.__file__}, not the package under "
                         f"{root}")
    from oceananigans_torch.ops import _build
    from oceananigans_torch.ops import cuda_kernels as ck
    from oceananigans_torch.ops import cuda_tracer as ctr
    from oceananigans_torch.ops import cuda_vi as cvi
    from oceananigans_torch.profile_step import (
        HYDRO_DT, cs_w2_model, hydro_implicit_model, hydro_initial_state,
        hydro_model, initial_state,
    )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fields(grid, n):
        return [torch.randn(grid.shape, generator=gen, device=dev)
                for _ in range(n)]

    out = {"root": str(root), "card": card, "reps": args.reps,
           "torch": torch.__version__, "calls": {}, "steps": {}}
    g = ot.RectilinearGrid(size=(16, 16, 16), extent=(1.0, 1.0, 1.0),
                           topology=(ot.Bounded, ot.Periodic, ot.Periodic),
                           halo=(1, 0, 0), dtype=torch.float32, device=dev)
    u, v, w, *G = fields(g, 6)
    out["calls"]["centered2_momentum_tendency"] = host_us(
        torch, lambda: ck.centered2_momentum_tendency(g, u, v, w), args.reps)
    out["calls"]["centered2_ab2_update"] = host_us(
        torch, lambda: ck.centered2_ab2_update(g, u, v, w, *G, 1e-4, -5e-5),
        args.reps)
    h = ot.RectilinearGrid(size=(24, 12, 6), extent=(4e7, 2e7, 4e3),
                           topology=(ot.Periodic, ot.Bounded, ot.Bounded),
                           halo=(6, 6, 4), dtype=torch.float32, device=dev)
    u, v, w, T, S = fields(h, 5)
    tm = ctr.tracer_metric_profiles(h)
    vm = cvi.vi_metric_profiles(h)
    weno7, vi = ot.WENO(7), ot.WENOVectorInvariant()
    out["calls"]["weno_tracer_tendencies"] = host_us(
        torch, lambda: ctr.weno_tracer_tendencies(
            h, weno7, u, v, w, {"T": T, "S": S}, tm), args.reps)
    out["calls"]["vi_momentum_tendency"] = host_us(
        torch, lambda: cvi.vi_momentum_tendency(h, vi, u, v, w, vm),
        args.reps)
    del u, v, w, G, T, S

    model = hydro_model("auto")
    out["steps"]["hydro_vi"] = step_ms(
        torch, model, model.update_state(hydro_initial_state(model)),
        HYDRO_DT)
    for method in ("fft", "cg"):
        model = hydro_implicit_model("auto", solver_method=method)
        out["steps"][f"hydro_implicit {method}"] = step_ms(
            torch, model, model.update_state(hydro_initial_state(model)),
            HYDRO_DT)
    del model
    model, state = cs_w2_model(192)
    out["steps"]["cs_w2 C192"] = step_ms(torch, model, state, 40.0)
    del model, state
    torch.cuda.empty_cache()
    grid = ot.RectilinearGrid(size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
                              topology=(ot.Bounded, ot.Periodic, ot.Periodic),
                              halo=(1, 0, 0), dtype=torch.float32, device=dev)
    model = ot.NonhydrostaticModel(grid=grid,
                                   timestepper="QuasiAdamsBashforth2")
    out["steps"]["default 256^3"] = step_ms(torch, model,
                                            initial_state(model), 1e-4)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
