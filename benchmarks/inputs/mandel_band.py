"""Mandelbrot boundary-band points, drawn from a seed.

The rule (written into the configuration as ``mandel_band``): the escape
count k of each node of the res x res np.linspace grid of the domain (z0 = 0,
z <- z^2 + c, k the first step with |z|^2 > 4, f64; max_iter if none); the
band is the nodes with min_escape <= k < max_iter, the thin shell of escaping
points around the set; a draw takes `points` band nodes without replacement
(numpy's default_rng(seed).choice) and moves each by a uniform jitter in
[-1/2, 1/2) of a grid step in x and in y, from the same generator.
"""

from __future__ import annotations

import numpy as np
import torch


class Band:
    """The band of one configuration, computed once; draws are cheap."""

    def __init__(self, rule: dict, device):
        xmin, xmax, ymin, ymax = rule["domain"]
        res, max_iter = int(rule["res"]), int(rule["max_iter"])
        xs = torch.linspace(xmin, xmax, res, dtype=torch.float64, device=device)
        ys = torch.linspace(ymin, ymax, res, dtype=torch.float64, device=device)
        cr, ci = xs[None, :].expand(res, res), ys[:, None].expand(res, res)
        zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
        k = torch.full(cr.shape, max_iter, dtype=torch.int32, device=device)
        for n in range(max_iter):
            zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
            k = torch.where((k == max_iter) & (zr * zr + zi * zi > 4.0), n + 1, k)
        band = ((k >= int(rule["min_escape"])) & (k < max_iter)).reshape(-1)
        self.nodes = torch.nonzero(band).reshape(-1).cpu().numpy()
        self.res = res
        self.x0, self.y0 = xmin, ymin
        self.hx, self.hy = (xmax - xmin) / (res - 1), (ymax - ymin) / (res - 1)

    def draw(self, seed: int, points: int) -> np.ndarray:
        """`points` band points (complex128) for `seed`."""
        if points > self.nodes.size:
            raise ValueError(f"the band holds {self.nodes.size} nodes, {points} asked for")
        rng = np.random.default_rng(int(seed))
        idx = rng.choice(self.nodes, points, replace=False)
        jitter = rng.random((points, 2)) - 0.5
        x = self.x0 + (idx % self.res + jitter[:, 0]) * self.hx
        y = self.y0 + (idx // self.res + jitter[:, 1]) * self.hy
        return x + 1j * y
