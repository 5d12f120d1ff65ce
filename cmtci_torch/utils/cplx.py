"""Complex arithmetic as (re, im) tensor pairs.

The reference (``cmtci/utils/cplx.py``) carries complex values as pairs of
real arrays because the TPU has no complex128. The port keeps the pairs on
the parity-relevant code (the Aberth eigensolver) so that each expression
rounds exactly as the reference writes it; complex128 tensors would take
another op order inside torch's complex kernels.

All functions broadcast like the underlying torch ops. A "pair" is any tuple
``(re, im)`` of equal-shape tensors.
"""

from __future__ import annotations

import torch


def add(a, b):
    return a[0] + b[0], a[1] + b[1]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def mul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def scale(a, s):
    return a[0] * s, a[1] * s


def abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def div(a, b):
    ar, ai = a
    br, bi = b
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def reciprocal(a):
    ar, ai = a
    d = ar * ar + ai * ai
    return ar / d, -ai / d


def where(mask, a, b):
    return torch.where(mask, a[0], b[0]), torch.where(mask, a[1], b[1])


def full_like(a, fill):
    fill = complex(fill)
    return torch.full_like(a[0], fill.real), torch.full_like(a[1], fill.imag)
