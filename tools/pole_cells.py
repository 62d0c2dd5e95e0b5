#!/usr/bin/env python3
"""The cells beside the north poles of ``chip_smoke.py`` phase 29a's
tripolar ocean (``chip_smoke.gspmd_config``'s ``tripolar`` part), on the
CPU in float64.

    python3 tools/pole_cells.py

Prints one JSON line for the full-width grid (360 × 170, the metrics
only): its smallest centre spacings and where they lie (interior
indices), the median spacings, the floor ``grids/orthogonal.py: _guard``
would impose (1e-3 of the median), and the split-explicit substeps'
largest Courant number (``chip_smoke.barotropic_courant``) at phase 14's
Δt of 60 s and at phase 29's ``FOLD_DT``. Then one line for each run of 6
steps of the same ocean at (120, 57, 6) from three states (the phase's
generic one, rest with uniform T and S, rest with phase 14's T and S) at
both Δt: max|u| after each step and where the last lies.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    import oceananigans_torch as ot
    ot.config.device = "cpu"
    dts = (60.0, chip_smoke.FOLD_DT)

    spec = dict(kind="tripolar", size=(360, 170, 4), dtype="float64")
    model = chip_smoke.gspmd_config(spec, "cpu")[0]
    g = model.grid
    xy = g.interior_slices[:2]
    out = {"size": g.N[:2]}
    for name in ("dxCC", "dyCC", "dxFC", "dyCF"):
        d = getattr(g, name)[xy][..., 0]
        at = torch.unravel_index(torch.argmin(d), d.shape)
        out[name] = {"min": float(d.min()), "at": [int(i) for i in at],
                     "median": float(d.median()),
                     "guard_floor": 1e-3 * float(d[d > 0].median())}
    out["courant"] = {str(dt): chip_smoke.barotropic_courant(model, dt)
                      for dt in dts}
    print(json.dumps(out), flush=True)

    spec = dict(kind="tripolar", size=(120, 57, 6), dtype="float64")
    model, init, _, _ = chip_smoke.gspmd_config(spec, "cpu")
    g = model.grid
    states = {
        "generic": init(model),
        "rest, uniform T and S": model.update_state(
            model.initial_state(T=20.0, S=35.0)),
        "rest, phase 14's T and S": model.update_state(model.initial_state(
            T=lambda lam, phi, z: 20.0 + 8e-4 * z - 0.05 * torch.abs(phi),
            S=lambda lam, phi, z: 35.0 + 1e-3 * phi))}
    for label, s0 in states.items():
        for dt in dts:
            s, umax = s0, []
            for _ in range(6):
                s = model.step(s, dt)
                u = g.interior(s.u).abs()
                umax.append(float(u.max()))
            at = torch.unravel_index(torch.argmax(u), u.shape)
            print(json.dumps({"size": g.N, "state": label, "dt": dt,
                              "umax": umax, "at": [int(i) for i in at]}),
                  flush=True)


if __name__ == "__main__":
    main()
