"""A whole run of each cell on the CPU at a tiny size (the look for a card
skipped), first as it is and then with the timed path broken underneath in
each way the cell can break: ``correct`` has to come out false every time."""

import numpy as np
import pytest
import torch

from benchmarks.harness import cell
from benchmarks.tests import tiny
from cmtci_torch.kernels import companion, mandelbrot
from cmtci_torch.pipelines import tracker
from cmtci_torch.stats import pointstats
from cmtci_torch.transport import giflow
from cmtci_torch.transport import histogram as hg
from cmtci_torch.transport import sinkhorn


def run(name, trace=False, seed=2**31 + 3):
    wl, cfg = tiny.CELLS[name]()
    wl["check_jobs"] = 2
    return cell.run_cell(name, seed, 0.5, trace, tiny.CPU, workload=wl, config=cfg)


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {"job_rate", "setup_s"} <= set(res["metrics"])
    assert ("job_p95_s" in res["metrics"]) == (name == tiny.TRACKER)


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_traced_run_reports_the_layers(name):
    res = run(name, trace=True)
    assert res["correct"] is True, res["checks"]
    layers = {tiny.TRACKER: {"tracker.cloud_ms", "tracker.sample_ms", "tracker.match_ms",
                             "tracker.hist_ms", "tracker.giflow_ms"},
              tiny.PAIRSTATS: {"pairstats.stats_ms"}}[name]
    # no device on the CPU: no idle share and no kernel time for a roofline
    assert set(res["metrics"]) == layers
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def _unchanged_flow(p, x0, alpha, t_steps, eps=1e-12, device=None):
    kl0 = hg.kl(p, x0, eps)
    return np.asarray(x0), int(t_steps), kl0, kl0


def _half_histogram(real):
    return lambda cloud, *a, **k: real(np.asarray(cloud)[::2], *a, **k)


def _altered_flow(real):
    def flow(*a, **k):
        x, t, kl0, delta = real(*a, **k)
        return x, t, kl0, delta * (1 + 1e-1)
    return flow


#: rows at the edge of the matcher's last block of rows that a fault touches
EDGE = 4


def _dropped_edge(real):
    """The matcher loses the rows at its last block's edge, in both clouds."""
    def match(*a, **k):
        m, c = real(*a, **k)
        return m[:-EDGE], c[:-EDGE]
    return match


def _shifted_edge(real):
    """The blocked argmax gives the rows at its last block's edge the
    matches of the rows before them."""
    def rows(*a, **k):
        out = real(*a, **k).clone()
        out[-EDGE:] = out[-EDGE - 1 : -1].clone()
        return out
    return rows


def _moved_band(real):
    """The sampler's band points moved one pixel along the real axis."""
    def sample(domain, grid_n, *a, **k):
        return real(domain, grid_n, *a, **k) + (domain[1] - domain[0]) / (grid_n - 1)
    return sample


def _unchanged_counts(xy, r_edges, nbins, *a, **k):
    return torch.zeros(nbins, dtype=torch.int64, device=xy.device)


def _half_counts(real):
    return lambda points, *a, **k: real(np.asarray(points)[::2], *a, **k)


def _altered_cloud(real):
    def cloud(*a, **k):
        c = real(*a, **k).copy()
        c[len(c) // 2] += 1e-6
        return c
    return cloud


FAULTS = {
    tiny.TRACKER: {
        "flow step returns its state": (giflow, "gi_flow_fixed_t", lambda real: _unchanged_flow),
        "histogram of half the points": (hg, "mollified_histogram", _half_histogram),
        "delta altered where made": (giflow, "gi_flow_fixed_t", _altered_flow),
        "matcher drops the rows at a block edge": (tracker, "entropic_argmax_match",
                                                   _dropped_edge),
        "matcher shifts the rows at a block edge": (sinkhorn, "_argmax_kernel_rows",
                                                    _shifted_edge),
        "band points moved where sampled": (mandelbrot, "sample_boundary_quantile", _moved_band),
    },
    tiny.PAIRSTATS: {
        "pair counts left unchanged": (pointstats, "_pair_hist", lambda real: _unchanged_counts),
        "shells of half the points": (pointstats, "_shell_counts", _half_counts),
        "a root altered where made": (companion, "inverse_cloud", _altered_cloud),
    },
}


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n]])
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    module, attr, make = FAULTS[name][fault]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    res = run(name)
    assert res["correct"] is False, res["checks"]
