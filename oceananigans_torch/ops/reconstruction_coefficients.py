"""Exact reconstruction coefficients for WENO orders beyond the hand-coded
ones.

Counterpart of ``oceananigans_tpu/ops/reconstruction_coefficients.py``, kept
as the port's own copy (it holds no tensor code). The coefficients are
generated exactly with ``Fraction`` arithmetic and numpy at construction
time and cached: the sub-stencil reconstructions, the ideal weights, and the
Jiang–Shu smoothness indicators as quadratic forms (for k >= 4 they are full
quadratic forms, not sums of squares):

    β_r = Σ_{l=1}^{k-1} ∫_cell (Δ^{l-1/2} d^l p_r/dx^l)² dx

Index convention as in ``ops/operators.py``: face ``i`` sits between cells
``i-1`` and ``i``; a left-biased sub-stencil ``r`` uses cells
``i-1-r .. i-1-r+k-1``; the smoothness integral runs over the upwind cell
``i-1`` (x in [-1, 0] with the face at 0, Δ = 1). The centered and
upwind-biased face stencils (:func:`face_reconstruction_coefficients`) are
generated the same way. The stretched-grid tables
(:func:`stretched_reconstruction_tables`, :func:`weno_stretched_tables`)
solve the same exactness conditions per face on a nonuniform axis, in
float64 numpy on the host.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np


def _shu_c(r: int, k: int):
    """c_{rj}: v_{i+1/2} = Σ_j c_{rj} v̄_{i-r+j}, as exact Fractions."""
    out = []
    for j in range(k):
        s = Fraction(0)
        for m in range(j + 1, k + 1):
            num = Fraction(0)
            for l in range(k + 1):
                if l == m:
                    continue
                prod = Fraction(1)
                for q in range(k + 1):
                    if q in (m, l):
                        continue
                    prod *= (r - q + 1)
                num += prod
            den = Fraction(1)
            for l in range(k + 1):
                if l == m:
                    continue
                den *= (m - l)
            s += Fraction(num, den)
        out.append(s)
    return out


@lru_cache(None)
def face_reconstruction_coefficients(order: int, bias: str):
    """{offset: coefficient} for the value at face i from cell values.

    ``bias``: "centered" (even order, cells i-B..i+B-1) or "left" (odd
    order, cells i-B..i+B-2). Offsets are relative to the face (cell i-1
    is offset -1).
    """
    if bias == "centered":
        if order % 2:
            raise ValueError("centered orders are even")
        B = order // 2
        c = _shu_c(B - 1, order)
        return {j - B: float(ci) for j, ci in enumerate(c)}
    if bias == "left":
        if order % 2 == 0:
            raise ValueError("upwind orders are odd")
        B = (order + 1) // 2
        c = _shu_c(B - 1, order)
        return {j - B: float(ci) for j, ci in enumerate(c)}
    raise ValueError(bias)


@lru_cache(None)
def weno_substencils(order: int):
    """Tuple of {offset: coefficient}; sub-stencil r uses cells
    i-1-r .. i-1-r+k-1 (left-biased at face i)."""
    k = (order + 1) // 2
    return tuple({j - 1 - r: float(ci) for j, ci in enumerate(_shu_c(r, k))}
                 for r in range(k))


@lru_cache(None)
def weno_ideal_weights(order: int):
    """The weights that combine the sub-stencils into the (2k-1)-order
    reconstruction, solved from the big stencil's coefficients."""
    k = (order + 1) // 2
    big = _shu_c(k - 1, 2 * k - 1)       # face i from cells i-k..i+k-2
    A = np.zeros((2 * k - 1, k))
    b = np.array([float(x) for x in big])
    for r in range(k):
        for j, ci in enumerate(_shu_c(r, k)):
            A[(j - 1 - r) + k, r] += float(ci)
    d, *_ = np.linalg.lstsq(A, b, rcond=None)
    d = np.maximum(d, 0.0)
    return tuple(float(x) for x in (d / d.sum()))


def _basis_polynomials(offsets):
    """Degree k-1 polynomial coefficient rows P_m whose cell averages over
    the stencil cells (cell n spans [n, n+1]) are the unit vectors."""
    k = len(offsets)
    A = np.zeros((k, k))
    for m, n in enumerate(offsets):
        for q in range(k):
            A[m, q] = ((n + 1) ** (q + 1) - n ** (q + 1)) / (q + 1)
    return np.linalg.inv(A).T


@lru_cache(None)
def weno_beta_forms(order: int):
    """Quadratic forms M_r (k, k) with β_r = sᵀ M_r s over the sub-stencil
    values ordered by ascending offset."""
    k = (order + 1) // 2
    forms = []
    for r in range(k):
        P = _basis_polynomials(tuple((-1 - r) + j for j in range(k)))
        M = np.zeros((k, k))
        for l in range(1, k):
            D = np.zeros((k, k - l))
            for m in range(k):
                d = np.polynomial.polynomial.polyder(P[m], l)
                D[m, :len(d)] = d
            # ∫_{-1}^{0} x^(a+b) dx for the derivative's monomials
            deg = k - l
            S = np.zeros((deg, deg))
            for a in range(deg):
                for bq in range(deg):
                    p = a + bq
                    S[a, bq] = (0.0 ** (p + 1) - (-1.0) ** (p + 1)) / (p + 1)
            M += D @ S @ D.T
        forms.append(M)
    return tuple(forms)


def validate_k3():
    """The generated forms of WENO(5) reproduce the classic Jiang-Shu
    indicator of its centred sub-stencil (offsets −2, −1, 0): 13/12 (s₀ −
    2s₁ + s₂)² + 1/4 (s₀ − s₂)². Returns True, or raises
    ``AssertionError``."""
    _, M1, _ = weno_beta_forms(5)
    ref = (13 / 12) * np.outer([1, -2, 1], [1, -2, 1]) \
        + 0.25 * np.outer([1, 0, -1], [1, 0, -1])
    if not np.allclose(M1, ref):
        raise AssertionError((M1, ref))
    return True


# ---------------------------------------------------------------------------
# Stretched-grid (nonuniform) reconstruction tables
# ---------------------------------------------------------------------------

def stretched_reconstruction_tables(edges, offsets):
    """Per-face reconstruction coefficients on a nonuniform axis.

    ``edges``: (n+1,) source-cell edge coordinates (cell ``i`` spans
    ``[edges[i], edges[i+1]]``). ``offsets``: the cell offsets of the
    stencil relative to the target face (cell i-1 is offset -1, as in
    :func:`face_reconstruction_coefficients`).

    Returns ``{offset: (n,) float array}`` such that the face value
    ``Σ_k c_k[i] a[i+k]`` is exact for every polynomial of degree
    < len(offsets) in the finite-volume (cell-average) sense. Faces whose
    stencil leaves the array take the nearest valid row (they lie in halo
    slots that no stencil reads when the halos are wide enough)."""
    edges = np.asarray(edges, float).reshape(-1)
    n = len(edges) - 1
    offs = sorted(offsets)
    p = len(offs)
    idx = np.arange(n)

    def edge_at(k):
        return edges[np.clip(idx + k, 0, n)]

    xf = edges[:n]
    # the local spacing scales the moments, for conditioning
    h = np.maximum(edge_at(1) - edge_at(0), 1e-300)
    A = np.zeros((n, p, p))
    for col, off in enumerate(offs):
        eL = (edge_at(off) - xf) / h
        eR = (edge_at(off + 1) - xf) / h
        width = np.where(np.abs(eR - eL) > 1e-300, eR - eL, 1.0)
        for l in range(p):
            A[:, l, col] = (eR ** (l + 1) - eL ** (l + 1)) \
                / ((l + 1) * width)
    valid = (idx + offs[0] >= 0) & (idx + offs[-1] + 1 <= n)
    if not valid.any():
        raise ValueError("grid too small for the stencil")
    rhs = np.zeros((p, 1))
    rhs[0, 0] = 1.0
    w = np.zeros((n, p))
    w[valid] = np.linalg.solve(A[valid], rhs[None, :, :])[:, :, 0]
    vi = np.where(valid)[0]
    nearest = vi[np.clip(np.searchsorted(vi, idx), 0, len(vi) - 1)]
    w[~valid] = w[nearest[~valid]]
    return {off: w[:, k].copy() for k, off in enumerate(offs)}


def weno_stretched_tables(edges, order, side="left"):
    """Nonuniform WENO tables: per-face sub-stencil coefficients and
    per-face ideal weights γ_r (the combination of the sub-stencils that
    reproduces the full-order reconstruction, solved face by face). The
    smoothness indicators keep the uniform forms.

    Returns ``(sub_tables, gamma)``: ``sub_tables[r]`` is an ``{offset:
    (n,) array}`` dict for sub-stencil r (left-biased at face i, cells
    i-1-r .. i-1-r+k-1; mirrored for ``side="right"``) and ``gamma`` a
    (k, n) array."""
    k = (order + 1) // 2
    full_offs = sorted(face_reconstruction_coefficients(order, "left"))
    if side == "right":
        full_offs = sorted(-1 - o for o in full_offs)
    full = stretched_reconstruction_tables(edges, full_offs)
    sub_tables = []
    for r in range(k):
        offs_r = [(-1 - r) + j for j in range(k)]
        if side == "right":
            offs_r = sorted(-1 - o for o in offs_r)
        sub_tables.append(stretched_reconstruction_tables(edges, offs_r))
    n = len(np.asarray(edges).reshape(-1)) - 1
    gamma = np.zeros((k, n))
    # per face: Σ_r γ_r C_r = C_full (k unknowns, 2k − 1 consistent
    # equations)
    for i in range(n):
        M = np.zeros((len(full_offs), k))
        b = np.array([full[o][i] for o in full_offs])
        for r in range(k):
            for row, o in enumerate(full_offs):
                M[row, r] = sub_tables[r][o][i] if o in sub_tables[r] \
                    else 0.0
        g, *_ = np.linalg.lstsq(M, b, rcond=None)
        gamma[:, i] = g
    return sub_tables, gamma


__all__ = ["face_reconstruction_coefficients",
           "stretched_reconstruction_tables", "weno_beta_forms",
           "validate_k3", "weno_ideal_weights", "weno_stretched_tables",
           "weno_substencils"]
