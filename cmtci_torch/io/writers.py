"""File-bus writers, schema-compatible with the reference outputs (subset of
``cmtci/io/writers.py`` used by the tracker, boundary, equipotential, TCI,
stage-1, Lucas-boundary, construct-boundary and curvature pipelines)."""

from __future__ import annotations

import csv
import dataclasses
import json
import os

import numpy as np

from cmtci_torch.utils.arrays import as_xy


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


def write_points_csv(path: str, pts):
    """Headerless point CSV (construct_stage1_clean.py:178-181 file bus)."""
    ensure_dir(path)
    np.savetxt(path, as_xy(pts), delimiter=",")
    return path


def write_matches_csv(path: str, matches):
    ensure_dir(path)
    np.savetxt(path, np.asarray(matches, dtype=int), delimiter=",", fmt="%d")
    return path


def write_curvature_csv(path: str, p, kappa, kappa_s, speed, aux):
    """10-column curvature CSV (boundary_curvature_localpoly.py:186-193)."""
    ensure_dir(path)
    header = "idx,x,y,curvature,kappa_signed,speed,xprime,yprime,x2,y2"
    idx = np.arange(len(p))
    out = np.c_[idx, p[:, 0], p[:, 1], kappa, kappa_s, speed,
                aux["xprime"], aux["yprime"], aux["x2"], aux["y2"]]
    np.savetxt(path, out, delimiter=",", header=header, comments="", fmt="%.10g")
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


def write_hist_csv(path: str, values, bins: int = 80, range_=None):
    """Histogram CSV (v40:401-410 schema)."""
    ensure_dir(path)
    values = np.asarray(values, dtype=float)
    values = values[np.isfinite(values)]
    hist, edges = np.histogram(values, bins=bins, range=range_, density=False)
    centers = 0.5 * (edges[:-1] + edges[1:])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["bin_left", "bin_right", "bin_center", "count"])
        for i in range(len(hist)):
            w.writerow([float(edges[i]), float(edges[i + 1]), float(centers[i]), int(hist[i])])
    return path


def to_jsonable(x):
    """numpy/complex containers -> JSON-safe (v18:977-995 semantics)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (float, np.floating)) and not np.isfinite(x):
        return str(float(x))  # before .item(): json.dump would emit a bare
        # NaN/Infinity token (invalid JSON) for a non-finite np scalar
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, (complex, np.complexfloating)):
        return {"re": float(np.real(x)), "im": float(np.imag(x))}
    if isinstance(x, np.ndarray):
        return to_jsonable(x.tolist())
    return x


def write_json(path: str, obj):
    ensure_dir(path)
    with open(path, "w") as f:
        json.dump(to_jsonable(obj), f, indent=2)
    return path
