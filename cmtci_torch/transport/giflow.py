"""GI flow: histogram mixture iteration X <- (1-alpha) X + alpha P with KL
tracking (S8). Port of ``cmtci/transport/giflow.py``:
  * fixed-T with kl0/klT — gi_assumption_tracker_v3.py:128-134
  * adaptive-to-threshold with min_steps — :137-148
  * the TCI flow's KL trajectory — tci_construct_mandelbrot_v002_fixed.py:
    90-95 (numpy on the host: T steps over one bins² grid)

device=None runs the numpy loop on the host; a torch device runs the same
loop in f64 tensors there (the tracker's choice for grids above 128 bins,
where the adaptive flow's per-step KL is O(bins²) logs).
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.transport.histogram import kl
from cmtci_torch.utils.device import resolve_device


def _kl_torch(p, x, eps: float):
    p = torch.clamp(p, min=eps)
    x = torch.clamp(x, min=eps)
    return torch.sum(p * (torch.log(p) - torch.log(x)))


def _as_f64(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)


def gi_flow_fixed_t(p, x0, alpha: float, t_steps: int, eps: float = 1e-12, device=None):
    """Returns (X_T numpy, T, kl0, klT) — gi_assumption_tracker_v3.py:128-134."""
    if device is None:
        p = np.asarray(p)
        x = np.asarray(x0)
        kl0 = kl(p, x, eps)
        for _ in range(int(t_steps)):
            x = (1.0 - alpha) * x + alpha * p
        return x, int(t_steps), float(kl0), float(kl(p, x, eps))
    dev = resolve_device(device)
    pt, x = _as_f64(p, dev), _as_f64(x0, dev)
    kl0 = _kl_torch(pt, x, eps)
    for _ in range(int(t_steps)):
        x = (1.0 - alpha) * x + alpha * pt
    klt = _kl_torch(pt, x, eps)
    return x.cpu().numpy(), int(t_steps), float(kl0), float(klt)


def gi_flow_to_threshold(p, x0, alpha: float, kl_threshold: float, max_steps: int,
                         min_steps: int = 1, eps: float = 1e-12, device=None):
    """Returns (X_T numpy, T, kl0, klT) — gi_assumption_tracker_v3.py:137-148."""
    # the reference's `for t in range(1, max_steps+1)` body always runs at
    # least one mixture step before the t >= min_steps check
    min_steps = max(1, int(min_steps))
    if device is None:
        p = np.asarray(p)
        x = np.asarray(x0)
        kl0 = kl(p, x, eps)
        t, klv = 0, kl0
        while t < int(max_steps) and (t < min_steps or klv > kl_threshold):
            x = (1.0 - alpha) * x + alpha * p
            t += 1
            klv = kl(p, x, eps)
        return x, int(t), float(kl0), float(klv)
    dev = resolve_device(device)
    pt, x = _as_f64(p, dev), _as_f64(x0, dev)
    kl0 = float(_kl_torch(pt, x, eps))
    t, klv = 0, kl0
    while t < int(max_steps) and (t < min_steps or klv > kl_threshold):
        x = (1.0 - alpha) * x + alpha * pt
        t += 1
        klv = float(_kl_torch(pt, x, eps))
    return x.cpu().numpy(), int(t), float(kl0), float(klv)


def tci_flow(p, x0, alpha: float, t_steps: int, eps: float = 1e-12):
    """KL trajectory variant (tci_construct_mandelbrot_v002_fixed.py:90-95),
    f64 on the host. Returns (kls array of length T+1, trajectory list of
    T+1 arrays, X_0 included)."""
    p = np.asarray(p, dtype=np.float64)
    x = np.asarray(x0, dtype=np.float64)
    kls = [kl(p, x, eps)]
    traj = [x]
    for _ in range(int(t_steps)):
        x = (1.0 - alpha) * x + alpha * p
        kls.append(kl(p, x, eps))
        traj.append(x)
    return np.asarray(kls), traj
