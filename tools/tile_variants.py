#!/usr/bin/env python3
"""Time variants of the Centered-2 tendency tile (kernel 2,
``csrc/centered2.cu``) and of the generic momentum tile (kernel 14,
``csrc/generic_tile.h``) on one GPU, and print one JSON line.

    python3 tools/tile_variants.py [--reps N]

Each variant is a copy of ``oceananigans_torch/csrc`` with a few edits,
compiled alone with ``nvcc`` into ``build/tile_variants/<name>/`` (all
variants at once) and called by its C entry point at the main path's
shapes (256³ float32, the plan the wrapper computes), so that the parts of
the march can be timed apart:

- kernel 2: as it is (``base``); one and two planes more in flight
  (``ahead2``, ``ahead3``); the march without its loads of planes after
  the first two (``noload``: the ring keeps stale planes), without its
  stores of G (``nostore``: the fluxes are still computed), and without
  either (``neither``: the barriers, index work and arithmetic alone);
- kernel 14 at WENO(5), Centered(4) and UpwindBiased(5): as it is, and
  with two and five planes in flight (``ahead2``, ``ahead5``).

Each time is the CUDA-event mean over ``--reps`` back-to-back calls after
one warm-up call, three times. The variants without loads or stores give
wrong values by design; their largest difference from the plain version
is printed all the same. The line also carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SRC = ROOT / "oceananigans_torch" / "csrc"
OUT = ROOT / "build" / "tile_variants"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared"]

C2_AHEAD = "constexpr int kAhead = 1;   // planes loaded ahead"
C2_SLOTS = ("constexpr int kSlots = 4;", "constexpr int kSlots = 8;")
C2_LOADS = ("    const int p = i + 2 + kAhead;\n    if (p <= b) {",
            "    const int p = i + 2 + kAhead;\n    if (p <= b && seg_len < 0) {")
C2_OWN = ("    if (i + 2 <= b) store_own(i + 2, qu[0], qv[0], qw[0]);",
          "    if (i + 2 <= b && seg_len < 0) store_own(i + 2, qu[0], qv[0], "
          "qw[0]);")
C2_STORES = ("      gu[p] = Gu;\n      gv[p] = Gv;\n      gw[p] = Gw;",
             "      if (Gu == T(12345.678)) gu[p] = Gu + Gv + Gw;")
GEN_AHEAD = "constexpr int kAhead = 3;           // planes in flight"

C2_VARIANTS = {
    "base": [],
    "ahead2": [(C2_AHEAD, C2_AHEAD.replace("= 1", "= 2")), C2_SLOTS],
    "ahead3": [(C2_AHEAD, C2_AHEAD.replace("= 1", "= 3")), C2_SLOTS],
    "noload": [C2_LOADS, C2_OWN],
    "nostore": [C2_STORES],
    "neither": [C2_LOADS, C2_OWN, C2_STORES],
}
GEN_VARIANTS = {
    "base": [],
    "ahead2": [(GEN_AHEAD, GEN_AHEAD.replace("= 3", "= 2"))],
    "ahead5": [(GEN_AHEAD, GEN_AHEAD.replace("= 3", "= 5"))],
}
GEN_SOURCES = ["generic_momentum.cu", "generic_tile_centered.cu",
               "generic_tile_upwind.cu", "generic_tile_weno3.cu",
               "generic_tile_weno5.cu", "generic_tile_weno7.cu",
               "generic_tile_weno9.cu", "generic_tile_weno11.cu"]


def start_build(nvcc, name, target, edits, files):
    """Copy the sources, apply ``edits`` (old, new) to the file ``target``,
    each exactly once, and start nvcc; returns (library path, process)."""
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(SRC, d)
    text = (d / target).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"tile_variants.py: edit for {name} matches "
                             f"{text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    (d / target).write_text(text)
    so = d / "lib.so"
    cmd = [nvcc, *FLAGS, "-o", str(so), *(str(d / f) for f in files)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tile_variants.py: no CUDA device is available")
    import oceananigans_torch as ot
    from oceananigans_torch.ops import _build
    from oceananigans_torch.ops import cuda_generic as cg
    from oceananigans_torch.ops import cuda_kernels as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {("c2", n): start_build(nvcc, f"c2_{n}", "centered2.cu", e,
                                     ["centered2.cu"])
              for n, e in C2_VARIANTS.items()}
    builds.update({("generic", n): start_build(
        nvcc, f"generic_{n}", "generic_tile.h", e, GEN_SOURCES)
        for n, e in GEN_VARIANTS.items()})
    libs = {}
    for key, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"tile_variants.py: nvcc failed for {key}:\n"
                             f"{log[-3000:]}")
        libs[key] = ctypes.CDLL(str(so))

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def grid_of(halo):
        return ot.RectilinearGrid(
            size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
            topology=(ot.Bounded, ot.Periodic, ot.Periodic), halo=halo,
            dtype=f32, device=dev)

    def fields(grid):
        return [ot.fill_halo_regions(
            torch.randn(grid.shape, generator=gen, device=dev, dtype=f32),
            grid, loc=loc) for loc in (ot.LOC_U, ot.LOC_V, ot.LOC_W)]

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / args.reps)
        return out

    def rel_err(got, ref):
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max())
                   for g, r in zip(got, ref)) / scale

    out = {"card": card, "reps": args.reps}
    grid = grid_of((1, 0, 0))
    u, v, w = fields(grid)
    ref = ck.centered2_momentum_tendency_plain(grid, u, v, w)
    G = [torch.empty_like(u) for _ in range(3)]
    plan = ck.tendency_plan(u.shape, sms, 4)
    c2_args = (u.data_ptr(), v.data_ptr(), w.data_ptr(),
               *(g.data_ptr() for g in G), *u.shape,
               *ck._inv_spacings(grid), *plan, stream)
    rec = out["centered2_momentum_tendency"] = {"plan": plan}
    for n in C2_VARIANTS:
        fn = libs[("c2", n)].ot_c2_tendency_f32
        fn.argtypes = _build.SIGNATURES["ot_c2_tendency"]
        fn.restype = ctypes.c_int
        if fn(*c2_args) != 0:
            raise SystemExit(f"tile_variants.py: c2 {n} failed to launch")
        torch.cuda.synchronize()
        rec[n] = {"ms": time_ms(lambda: fn(*c2_args)),
                  "rel_err": rel_err(G, ref)}
    del u, v, w, ref, G
    torch.cuda.empty_cache()

    rec = out["fused_momentum_tendency"] = {}
    for label, sch in (("WENO(5)", ot.WENO(5)), ("Centered(4)", ot.Centered(4)),
                       ("UpwindBiased(5)", ot.UpwindBiased(5))):
        H = sch.required_halo
        grid = grid_of((H, 0, 0))
        u, v, w = fields(grid)
        ref = cg.fused_momentum_tendency_plain(grid, sch, u, v, w)
        G = [torch.empty_like(u) for _ in range(3)]
        schemes = cg.axis_schemes(sch)
        m = cg.RegularMetricProxy(grid)
        plan = cg.momentum_plan(u.shape, H, schemes, sms, 4)
        gen_args = (u.data_ptr(), v.data_ptr(), w.data_ptr(),
                    *(g.data_ptr() for g in G), *u.shape, H,
                    *(cg.scheme_code(s) for s in schemes), m.Ax(), m.Ay(),
                    m.Az(), m.V(),
                    *(float(getattr(s, "epsilon", 0.0)) for s in schemes),
                    *plan, stream)
        rec[label] = {"plan": plan}
        for n in GEN_VARIANTS:
            fn = libs[("generic", n)].ot_generic_momentum_f32
            fn.argtypes = _build.SIGNATURES["ot_generic_momentum"]
            fn.restype = ctypes.c_int
            if fn(*gen_args) != 0:
                raise SystemExit(f"tile_variants.py: generic {n} failed to "
                                 "launch")
            torch.cuda.synchronize()
            rec[label][n] = {"ms": time_ms(lambda: fn(*gen_args)),
                             "rel_err": rel_err(G, ref)}
        del u, v, w, ref, G
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
