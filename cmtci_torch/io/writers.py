"""File-bus writers, schema-compatible with the reference outputs (subset of
``cmtci/io/writers.py`` used by the tracker, boundary and equipotential)."""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np


def ensure_dir(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


def write_xy_csv(path: str, xy, header: str = "x,y"):
    """Boundary CSV with 'x,y' header (mandelbrot_boundary_sample.py:74)."""
    ensure_dir(path)
    np.savetxt(path, np.asarray(xy), delimiter=",", header=header, comments="")
    return path


def write_meta_txt(path: str, params: dict):
    """key=value parameter dump (mandelbrot_boundary_sample.py:84-86)."""
    ensure_dir(path)
    with open(path, "w") as f:
        for k, v in params.items():
            f.write(f"{k}={v}\n")
    return path


def write_config_meta(path: str, cfg, extra: dict | None = None):
    """Uniform per-pipeline _meta.txt dump of a dataclass config (or dict)."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    if extra:
        d.update(extra)
    return write_meta_txt(path, d)


def write_dict_rows_csv(path: str, rows: list):
    """DictWriter CSV with union-of-keys columns (v40:387-398)."""
    ensure_dir(path)
    keys = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return path
