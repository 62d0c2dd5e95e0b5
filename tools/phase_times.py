#!/usr/bin/env python3
"""Run the cubed-sphere phases of ``chip_smoke.py`` (15, ``cs_w2``; 16,
``cs_global``) of one checkout on one GPU: that checkout's own phase
functions on its own ``oceananigans_torch`` package, printing what they
print and then one JSON line of their ms/step.

    python3 tools/phase_times.py [--root DIR]

No kernel of the package lies on these paths, and the host's launches set
their pace, so their ms/step moves with the host the card is attached to.
A change is compared with its parent in one session on one card by running
this script in turns (parent, change, change, parent), with the parent
unpacked by ``git archive`` under ``build/parent`` (git ignores
``build/``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase_times.py: no CUDA device is available")
    import oceananigans_torch as ot
    from oceananigans_torch import ops
    if Path(ot.__file__).resolve().parent.parent != root:
        raise SystemExit(f"phase_times.py: imported {ot.__file__}, not the "
                         f"package under {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # every kernel wrapper of the checkout (each counts its launches)
    wrappers = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"oceananigans_torch.ops.{info.name}")
        wrappers.update({k: v for k, v in vars(mod).items()
                         if callable(v) and hasattr(v, "launches")})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": str(root), "card": card}
    out["15"] = smoke.cs_w2_phase(torch, wrappers, card)["ms"]
    out["16"] = {k: v["ms"] for k, v in
                 smoke.cs_global_phase(torch, wrappers, card).items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
