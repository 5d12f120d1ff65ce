"""Per-stage artifact store keyed by config hash, and per-stage wall timing.

The cache and RNG-state layout are the reference's (``cmtci/utils/
artifacts.py``): a stage's products are stored as an .npz keyed by a stable
hash of its config dict, and the MT19937 state is stored under the same npz
keys, so a post-stage RNG state written by ``cmtci`` restores into the port
and the reverse.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch


def config_key(config: dict) -> str:
    """Stable short hash of a JSON-serializable config dict."""
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def array_digest(arr) -> str:
    """Short content hash of an array, for keying caches on array inputs
    (the reference's digest)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def rng_state_arrays(rng: "np.random.RandomState") -> dict:
    """MT19937 state of a RandomState as npz-storable arrays."""
    name, keys, pos, has_gauss, cached_gauss = rng.get_state()
    if name != "MT19937":
        raise ValueError(f"unsupported bit generator {name!r}")
    return {"rng_keys": keys, "rng_pos": np.int64(pos),
            "rng_has_gauss": np.int64(has_gauss), "rng_cached": np.float64(cached_gauss)}


def restore_rng_state(rng: "np.random.RandomState", blob: dict) -> None:
    rng.set_state(("MT19937", np.asarray(blob["rng_keys"], dtype=np.uint32),
                   int(blob["rng_pos"]), int(blob["rng_has_gauss"]),
                   float(blob["rng_cached"])))


def cached(stage: str, config: dict, fn, cache_dir: str = ".cmtci_cache",
           enabled: bool = True, write: bool = True):
    """Run fn() -> dict[str, array] with npz caching keyed by (stage, config).
    write=False reads a stored entry but stores none (the ranks of a mesh
    other than rank 0)."""
    if not enabled:
        return fn()
    key = config_key({"stage": stage, **config})
    path = os.path.join(cache_dir, f"{stage}_{key}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    out = fn()
    if not write:
        return out
    os.makedirs(cache_dir, exist_ok=True)
    # unique tmp per writer, then an atomic publish
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in out.items()})
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return out


def fetch(x) -> np.ndarray:
    """Host numpy copy of a tensor (numpy input passes through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StageTimer:
    """Per-stage wall times, and counters beside them. On a CUDA device each
    stage boundary synchronizes the device, so a stage's time includes the
    kernels it queued and no other stage's.

    Each stage runs inside a ``torch.profiler.record_function`` of its name,
    which does nothing unless a profiler records: under one (the caller's,
    or this timer's own with `trace_dir`) the stage is a ``user_annotation``
    span of the Chrome trace, nested in its caller's spans. ``count(name,
    n)`` adds n to ``counts[name]``, the program's counters, kept in memory
    like ``times``.

    With `trace_dir` each stage also runs under ``torch.profiler`` (host
    ops, and the card's kernels on a CUDA device) and writes one Chrome
    trace, ``<trace_dir>/<k>_<stage>.pt.trace.json`` (k counts the traces of
    this timer), the counterpart of the reference's ``jax.profiler.trace``.
    A stage inside a traced stage is timed but not traced again. Tracing
    records what runs; it changes no result."""

    def __init__(self, device=None, trace_dir: str | None = None):
        self.times: dict = {}
        self.counts: dict = {}
        self.device = torch.device(device) if device is not None else None
        self.trace_dir = trace_dir
        self.traces: list = []
        self._tracing = False

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        if not self.trace_dir or self._tracing:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def count(self, name: str, n) -> None:
        """Add n to counts[name]."""
        self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = self._profiler()
        if prof is not None:
            prof.__enter__()
            self._tracing = True
        try:
            with torch.profiler.record_function(name):
                self._sync()
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self._sync()
                    self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        finally:
            if prof is not None:
                self._tracing = False
                prof.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                safe = "".join(ch if ch.isalnum() or ch in "-_." else "_" for ch in name)
                path = os.path.join(self.trace_dir,
                                    f"{len(self.traces):03d}_{safe}.pt.trace.json")
                prof.export_chrome_trace(path)
                self.traces.append(path)
