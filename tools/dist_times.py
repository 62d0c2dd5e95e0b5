#!/usr/bin/env python3
"""Time the four-rank parts of ``chip_smoke.py`` phase 27 (27a ``weno``
256³ and Centered(2) 64³ under ``Partition(4, 1)``, 27b ``hydro_vi``
under ``Partition(2, 2)``) of one checkout on one GPU: that checkout's own
rank programs on its own ``oceananigans_torch`` package, four gloo ranks
on ``cuda:0``, printing one JSON line a part with rank 0's serial ms/step,
every rank's sharded ms/step, the sharded-against-serial differences and
the collectives a step.

    python3 tools/dist_times.py [--root DIR]

The ranks share one card, so the sharded times are no scaling figure. A
change is compared with its parent in one session on one card by running
this script in turns (parent, change, change, parent), with the parent
unpacked by ``git archive`` under ``build/parent`` (git ignores
``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

SPECS = [dict(kind="weno", size=(256, 256, 256), dtype="float32",
              partition=(4, 1), serial=True),
         dict(kind="centered", size=(64, 64, 64), dtype="float32",
              partition=(4, 1), serial=True),
         dict(kind="hydro", size=(360, 160, 60), dtype="float32",
              partition=(2, 2), serial=True)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    root = Path(parser.parse_args().root).resolve()
    os.chdir(root)
    # the ranks import chip_smoke by name, from the parent's sys.path
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dist_times.py: no CUDA device is available")
    import chip_smoke
    import oceananigans_torch as ot
    from oceananigans_torch.parallel import launch
    if Path(ot.__file__).resolve().parent.parent != root:
        raise SystemExit(f"dist_times.py: imported {ot.__file__}, not the "
                         f"package under {root}")
    with tempfile.TemporaryDirectory() as tmp:
        reps = launch(4, chip_smoke.dist_parts_rank, (SPECS,),
                      rendezvous_dir=tmp, backend="gloo", device="cuda:0")
    for k, spec in enumerate(SPECS):
        print(json.dumps({"root": str(root), "kind": spec["kind"],
                          "size": spec["size"],
                          "serial_ms": reps[0][k]["serial_ms"],
                          "sharded_ms": [r[k]["ms"] for r in reps],
                          "rel": reps[0][k]["rel"],
                          "collectives": reps[0][k]["collectives_a_step"]}),
              flush=True)


if __name__ == "__main__":
    main()
