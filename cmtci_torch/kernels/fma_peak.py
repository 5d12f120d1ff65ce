"""K7: the chained-FMA ceiling microkernel, with its plain twin and wrapper.

Port of the Pallas kernel nested in the reference's ``bench.py``
(``_bench_vpu_peak``, ``kern`` at :238-248): every element of the output is
x0 after k chained steps x <- x*a + b. The kernel is ``csrc/fma_peak.cu``
(one ``__fmaf_rn`` a step); its rate is the denominator of the ``*_mfu``
keys of ``cmtci_torch.bench``.

With the reference's constants the fused step and the twin's unfused one
(a rounded product, then a rounded sum) both map x0 to itself: a = 1 - 2^-23,
x0 = 1 + 2^-23, so x0*a = 1 - 2^-46 rounds to 1 (or stays exact inside the
fused step) and adding b = f32(1e-7), 0.84 of the spacing 2^-23 above 1,
rounds back to 1 + 2^-23. Every element is 0x3F800001 on both sides.

Given a CPU device the wrapper runs the twin; given a CUDA device it launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch
from cmtci_torch.utils.device import resolve_device

#: the reference's constants, as the f32 values the kernels see
A = float(np.float32(0.9999999))
B = float(np.float32(1e-7))
X0 = float(np.float32(1.0000001))
#: bit pattern of every output element with those constants (1 + 2^-23)
FIXED_POINT_BITS = 0x3F800001
#: the reference's work: 64 tiles of (256, 1024) elements, 8192 steps each
N_ELEMS = 64 * 256 * 1024
K_STEPS = 8192
#: floating-point operations of one step (one fused multiply-add)
FLOP_PER_STEP = 2


def fma_chain_torch(n_elems: int, k: int, device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K7 kernel: an f32 (n_elems,) tensor of x0 after
    k steps x <- x*a + b, each step a rounded product and a rounded sum."""
    x = torch.full((int(n_elems),), X0, dtype=torch.float32, device=resolve_device(device))
    for _ in range(int(k)):
        x = x * A + B
    return x


def fma_chain(n_elems: int = N_ELEMS, k: int = K_STEPS, device="cuda") -> torch.Tensor:
    """K7 on `device` (CUDA: the kernel; CPU: its twin): the f32 (n_elems,)
    output of k chained FMA steps."""
    if n_elems < 0 or k < 0:
        raise ValueError(f"n_elems and k must be >= 0, got {n_elems} and {k}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fma_chain_torch(n_elems, k, device=dev)
    out = torch.empty((int(n_elems),), dtype=torch.float32, device=dev)
    if n_elems:
        launch("fma_peak", dev, out.data_ptr(), int(n_elems), int(k), X0, A, B, 0.0)
    return out
