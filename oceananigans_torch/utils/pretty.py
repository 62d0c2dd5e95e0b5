"""Human-readable formatting (reference ``src/Utils/pretty_time.jl`` etc.); a
copy of ``oceananigans_tpu/utils/pretty.py``."""

from __future__ import annotations


def prettytime(t: float) -> str:
    t = float(t)
    if t < 1e-6:
        return f"{t * 1e9:.3g} ns"
    if t < 1e-3:
        return f"{t * 1e6:.3g} us"
    if t < 1.0:
        return f"{t * 1e3:.3g} ms"
    if t < 60:
        return f"{t:.3g} s"
    if t < 3600:
        return f"{t / 60:.3g} min"
    if t < 86_400:
        return f"{t / 3600:.3g} hr"
    return f"{t / 86_400:.3g} days"


def prettysummary(x) -> str:
    try:
        return f"{float(x):.6g}"
    except (TypeError, ValueError):
        return repr(x)
