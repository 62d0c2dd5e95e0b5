#!/usr/bin/env python3
"""Where ``chip_smoke.py`` phase 29a's sharded tripolar step parts from
its serial one on the card, and how fast: phase 14's tripolar ocean
(``chip_smoke.gspmd_config``'s ``tripolar`` part, 360 × 170 × 60) over
``Partition(4, 1)``, four gloo ranks on ``cuda:0``.

    python3 tools/fold_rounding.py

Prints one JSON line a run (at phase 14's Δt of 60 s float32 1 step and
float64 1 and 12 steps, at phase 29's ``FOLD_DT`` float64 12 steps, each
from the part's initial state): for each field the cells in which the
sharded and the serial step differ, the largest difference relative to
the field's largest value and where it lies (interior indices); whether
the serial run repeats bit for bit; its max|u| a step; the split-explicit
substeps' largest Courant number (``chip_smoke.barotropic_courant``);
and, for float32, the same comparison of the serial step on the card and
on the CPU.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZE, PARTITION = (360, 170, 60), (4, 1)


def _clone(state):
    from oceananigans_torch.parallel.distributed import _map_tensors
    return _map_tensors(state, lambda t: t.clone())


def _compare(grid, a, b):
    """Per field of the interiors: cells that differ, the largest
    difference relative to the field's largest value, and where."""
    import torch
    out = {}
    for name, x in a.fields().items():
        y = b.fields()[name].to(x.device)
        if x.ndim != 3 or x.shape[2] == 1:
            xi, yi = x[grid.interior_slices[:2]], y[grid.interior_slices[:2]]
        else:
            xi, yi = grid.interior(x), grid.interior(y)
        d = (xi.double() - yi.double()).abs()
        at = torch.unravel_index(torch.argmax(d), d.shape)
        out[name] = {"cells": int((d > 0).sum()), "of": d.numel(),
                     "rel": float(d.max()) / max(float(yi.abs().max()),
                                                 1e-300),
                     "at": [int(i) for i in at]}
    return out


def rank(dist, dtype, steps, cpu, dt):
    """The sharded and the serial run of ``steps`` steps on this rank (the
    serial runs and the comparisons on rank 0)."""
    import torch

    import chip_smoke
    import oceananigans_torch as ot
    from oceananigans_torch.parallel import (
        Distributed, Partition, sharded_step_fn,
    )
    from oceananigans_torch.parallel.distributed import _map_tensors
    d = Distributed(Partition(*PARTITION), device=dist.device)
    spec = dict(kind="tripolar", size=SIZE, dtype=dtype)
    model, init, _, _ = chip_smoke.gspmd_config(spec, d.device)
    step = sharded_step_fn(model, d, dt)
    s0 = init(model) if d.rank == 0 else None
    sharded = s0
    for _ in range(steps):
        sharded = step(sharded)
    if d.rank:
        return None
    g = model.grid
    serial, again, umax = _clone(s0), _clone(s0), []
    for _ in range(steps):
        serial = model.step(serial, dt)
        again = model.step(again, dt)
        umax.append(float(g.interior(serial.u).abs().max()))
    out = {"umax": umax, "courant": chip_smoke.barotropic_courant(model, dt),
           "serial_repeats": all(torch.equal(p, q) for p, q in zip(
               again.fields().values(), serial.fields().values())),
           "sharded_vs_serial": _compare(g, sharded, serial)}
    if cpu:
        ot.config.device = "cpu"
        torch.set_num_threads(8)
        mc = chip_smoke.gspmd_config(spec, "cpu")[0]
        sc = _map_tensors(s0, lambda t: t.cpu())
        for _ in range(steps):
            sc = mc.step(sc, dt)
        out["card_vs_cpu_serial"] = _compare(g, serial, sc)
    return out


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fold_rounding.py: no CUDA device is available")
    from oceananigans_torch.parallel import launch
    import chip_smoke
    for dtype, steps, cpu, dt in (("float32", 1, True, 60.0),
                                  ("float64", 1, False, 60.0),
                                  ("float64", 12, False, 60.0),
                                  ("float64", 12, False, chip_smoke.FOLD_DT)):
        with tempfile.TemporaryDirectory() as tmp:
            rep = launch(4, rank, (dtype, steps, cpu, dt),
                         rendezvous_dir=tmp, backend="gloo",
                         device="cuda:0")[0]
        print(json.dumps({"dtype": dtype, "steps": steps, "dt": dt,
                          "size": SIZE, "partition": PARTITION, **rep}),
              flush=True)


if __name__ == "__main__":
    main()
