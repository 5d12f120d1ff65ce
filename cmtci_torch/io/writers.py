"""File-bus writers, schema-compatible with the reference outputs (subset of
``cmtci/io/writers.py`` used by the tracker)."""

from __future__ import annotations

import dataclasses
import os


def ensure_dir(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
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
