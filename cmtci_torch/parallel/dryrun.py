"""The multi-rank dry run: the sharded tracker step and the sharded analysis
heads on an n-rank gloo group on the CPU (the counterpart of
``__graft_entry__.dryrun_multichip``).

``python -m cmtci_torch.parallel.dryrun N`` runs it from a shell.
"""

from __future__ import annotations

import sys

import numpy as np

DOMAIN = (-2.25, 1.25, -1.75, 1.75)


def dryrun_rank(n_devices: int, mesh=None) -> dict:
    """One rank's part: tracker_train_step at tiny shapes, then the sharded
    variogram, point variogram, shell counts, Green cloud and cloud
    potential, each checked with the reference's asserts. Returns the
    diagnostics (rank 0 prints them)."""
    import torch

    from cmtci_torch.parallel import sharded

    ns = list(range(4, 4 + 2 * n_devices * 4, 4))  # batch >= mesh size
    grid_n = 16 * n_devices
    n_samples = 8 * n_devices
    out = sharded.tracker_train_step(mesh, ns, DOMAIN, grid_n, n_samples, bins=16, key=0,
                                     max_iter=32, sigma_bins=1.0, alpha=0.1, t_steps=5,
                                     chunk=8)
    kl0, delta, tv, n_esc = (out["kl_initial"], out["delta_n"], out["tv_XT_PM"],
                             out["n_escaped"])
    assert kl0 >= 0.0 and 0.0 <= delta <= kl0 and 0.0 <= tv <= 1.0 and n_esc > n_samples, (
        kl0, delta, tv, n_esc)
    lines = [f"[dryrun_multichip] n={n_devices} kl0={kl0:.10f} delta={delta:.10f} "
             f"tv={tv:.10f} escaped_px={n_esc}"]

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, size=(64 * n_devices, 2))
    vals = rng.normal(size=len(pts))
    edges = np.linspace(0.0, 1.5, 9)
    sums, counts = sharded.sharded_binned_sq_diff(pts, vals, pts, vals, edges, mesh,
                                                  upper=True, chunk=16)
    n_pairs = len(pts) * (len(pts) - 1) // 2
    assert int(counts.sum()) <= n_pairs and (sums >= 0).all(), (counts, sums)
    lags, gamma, vcounts = sharded.sharded_point_variogram(pts, vals, nbins=8, mesh=mesh,
                                                           chunk=16)
    assert np.isfinite(gamma[vcounts > 0]).all() and len(lags) == 8
    _, shells, n_s, rho = sharded.sharded_shell_counts(pts, 1.0, 0.25, mesh, chunk=16)
    assert n_s == len(pts) and shells.sum() > 0 and rho > 0
    z = pts[:, 0] + 1j * pts[:, 1]
    g, it, _ = sharded.sharded_green_cloud(z, max_iter=64, mesh=mesh)
    assert (np.asarray(g) >= 0).all() and len(np.asarray(g)) == len(z)
    u = sharded.sharded_cloud_potential(DOMAIN, 16, 8 * n_devices, pts, mesh,
                                        dtype=torch.float64).cpu().numpy()
    assert u.shape == (8 * n_devices, 16) and np.isfinite(u).all()
    lines.append(f"[dryrun_multichip] analysis heads ok: pairs={int(counts.sum())} "
                 f"shells={int(shells.sum())} escaped={int((np.asarray(it) < 64).sum())} "
                 f"u_mean={float(u.mean()):.6f}")
    return {**out, "pairs": int(counts.sum()), "shells": int(shells.sum()),
            "u_mean": float(u.mean()), "lines": lines}


def dryrun_multichip(n_devices: int, workdir: str | None = None) -> dict:
    """Run dryrun_rank on an n-rank gloo group on the CPU (one intra-op
    thread a rank), print rank 0's lines, and return its diagnostics."""
    from cmtci_torch.parallel.launch import Call, run

    ranks = run(n_devices, [Call("cmtci_torch.parallel.dryrun:dryrun_rank", (n_devices,))],
                device="cpu", threads=1, workdir=workdir)
    out = ranks[0]["results"][0]
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
