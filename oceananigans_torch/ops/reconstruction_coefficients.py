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
generated the same way. The JAX module's stretched-grid tables are not
copied: stretched grids are not ported.
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


__all__ = ["face_reconstruction_coefficients", "weno_beta_forms",
           "weno_ideal_weights", "weno_substencils"]
