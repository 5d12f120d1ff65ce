"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same drivers, references and checks as on the card."""

from __future__ import annotations

import copy

import torch

from benchmarks.harness import files

TRACKER = "tracker_appendixA.dense4"
PAIRSTATS = "pairstats_lucas150k.scan"
CPU = torch.device("cpu")


def tracker_cell():
    """(workload, config): four stages of 2 to 4 clouds, grids 80 to 121."""
    wl = copy.deepcopy(files.workload(TRACKER))
    wl["traffic"]["tracker"] = {"bins_start": 16, "bins_max": 128, "construct_max_start": 60,
                                "mandelbrot_grid_start": 80, "mandelbrot_samples_start": 600,
                                "mandelbrot_samples_max": 3000}
    return wl, files.config(wl["config"])


def pairstats_cell():
    """(workload, config): n = 2..60 (1,829 points), M of 1,500 points from a
    300 x 300 band."""
    wl = copy.deepcopy(files.workload(PAIRSTATS))
    wl["traffic"]["pairstats"] = {"n_max": 60, "m_points": 1500}
    cfg = copy.deepcopy(files.config(wl["config"]))
    cfg["mandel_band"]["res"] = 300
    return wl, cfg


CELLS = {TRACKER: tracker_cell, PAIRSTATS: pairstats_cell}
