"""Roots of the Lucas polynomials, and the inverse-eigenvalue cloud built
from them, by a fixed point that needs no eigensolver.

The n x n companion matrix with a first row of ones and ones below the
diagonal has the characteristic polynomial p(z) = z^n - z^(n-1) - ... - 1,
and (z - 1) p(z) = z^(n+1) - 2 z^n + 1. Its roots are
  * the Pisot root in (1, 2), the fixed point of z = 2 - z^(-n) from z = 2;
  * n - 1 roots in the unit disc, z^n = 1 / (2 - z). For k = 1 .. n-1 the map
    g_k(z) = w_k (2 - z)^(-1/n), w_k = exp(2 pi i k / n), principal branch,
    sends the closed unit disc into itself (|2 - z| >= 1 there) with
    |g_k'| <= 1/n, so it has exactly one fixed point, a root of p; k = 0 gives
    z = 1, the root that (z - 1) added. Distinct k give distinct roots.
So each root is the limit of a contraction, exact to rounding in the dtype it
is computed in.
"""

from __future__ import annotations

import numpy as np

#: iterations of each fixed point: the contraction factor is at most 1/2 for
#: the disc roots and 2 / phi^3 ~ 0.47 for the Pisot root of n = 2
ITERS = 80


def roots(n: int, dtype=np.complex128) -> np.ndarray:
    """The n roots of z^n - z^(n-1) - ... - 1 in `dtype` (complex128 or
    complex64): the Pisot root first, then k = 1 .. n-1."""
    real = np.float64 if dtype == np.complex128 else np.float32
    two = real(2.0)
    pisot = two
    for _ in range(ITERS):
        pisot = two - pisot ** real(-n)
    k = np.arange(1, n, dtype=real)
    w = np.exp(1j * (real(2.0 * np.pi) * k / real(n))).astype(dtype)
    z = w.copy()
    inv_n = real(1.0) / real(n)
    for _ in range(ITERS):
        z = (w * np.exp(-inv_n * np.log(two - z))).astype(dtype)
    return np.concatenate([np.asarray([pisot], dtype=dtype), z])


def inverse_cloud(ns, dtype=np.complex128) -> list:
    """Per n, the inverse eigenvalues 1/lambda of the n x n Lucas companion
    matrix (no eigenvalue lies near 0, so none is dropped)."""
    return [(1.0 / roots(int(n), dtype)).astype(dtype) for n in ns]


def set_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Hausdorff distance of two finite point sets in the complex plane."""
    d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def cloud_gap(program: np.ndarray, reference: list) -> float:
    """Largest Hausdorff distance, over n, between the program's
    concatenated cloud cut into the reference's per-n sizes and the
    reference's per-n set; infinite where the sizes differ."""
    program = np.asarray(program)
    if program.size != sum(len(r) for r in reference):
        return float("inf")
    gap, at = 0.0, 0
    for r in reference:
        gap = max(gap, set_gap(program[at : at + len(r)], r))
        at += len(r)
    return gap


def in_order(program: np.ndarray, reference: list):
    """The reference's roots in the program's order: each root of the
    program's concatenated cloud, cut into the reference's per-n sizes,
    replaced by the nearest reference root of its n. The program's cloud
    gives only the order. None where the sizes differ or two program roots
    of one n fall to one reference root."""
    program = np.asarray(program)
    if program.size != sum(len(r) for r in reference):
        return None
    out, at = [], 0
    for r in reference:
        idx = np.abs(program[at : at + len(r)][:, None] - r[None, :]).argmin(axis=1)
        if np.unique(idx).size != len(r):
            return None
        out.append(r[idx])
        at += len(r)
    return np.concatenate(out) if out else program[:0]
