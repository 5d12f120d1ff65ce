"""The device trace of a run with ``--trace 1``: ``torch.profiler`` over a
stretch of whole jobs, reduced to the card's busy time, its idle share, the
device operations that took most time and what the host did while the card
waited."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

#: the span the harness puts around every job; the stretch runs from the
#: first traced job's start to the last one's end
JOB_SPAN = "bench.job"
#: trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each list of the breakdown
TOP = 10


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def chrome_events(prof) -> list:
    """The profiler's Chrome trace events, by way of a file in TMPDIR that
    is removed once read."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_pct(busy_s: float, window_s: float):
    """100 x (1 - busy / window), or None where the card shows no work."""
    if window_s <= 0 or busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def _spans(events, cat):
    return [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == cat]


def _by_start(spans):
    spans = sorted(spans)
    return [s[0] for s in spans], spans


def _innermost(pool, t, reach: int = 256):
    """Name of the latest-starting span of `pool` (starts, spans) that holds
    time t: the innermost where the spans nest. Looks back `reach` spans."""
    starts, spans = pool
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - reach, -1), -1):
        if spans[k][1] >= t:
            return spans[k][2]
    return None


def covered(merged, starts, a: float, b: float) -> float:
    """Length of [a, b] that the sorted, merged intervals cover (`starts`
    their starts)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    for lo, hi in merged[i:]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


def span_kernel_s(events) -> dict:
    """Seconds of card time in kernels inside the host spans of each name
    (``record_function``, the job span left out): the union of the kernel
    intervals that lie within a span, summed over the spans of that name. A
    span that synchronises the device at both ends holds exactly the
    kernels launched inside it."""
    merged = union((a, b) for a, b, _ in _spans(events, "kernel"))
    starts = [lo for lo, _ in merged]
    out = defaultdict(float)
    for a, b, name in _spans(events, "user_annotation") if merged else ():
        if name != JOB_SPAN:
            out[name] += covered(merged, starts, a, b) * 1e-6
    return dict(out)


def summarize(events) -> dict:
    """busy_s, window_s, device_idle_pct and the breakdown of the stretch
    that the job spans in `events` (Chrome trace events, times in us) cover,
    and each span's kernel seconds (``span_kernel_s``).

    The idle gaps are grouped by what held the gap's middle on the host,
    ``<span>/<op>``: the innermost benchmark or program span
    (``record_function``, ``job`` where none) and the innermost torch
    operation (``host`` where none, as in numpy or Python): seconds of idle
    card a label."""
    jobs = [s for s in _spans(events, "user_annotation") if s[2] == JOB_SPAN]
    if not jobs:
        return {"busy_s": 0.0, "window_s": 0.0, "device_idle_pct": None,
                "device_ops": [], "idle_gaps": [], "span_kernel_s": {}}
    lo = min(s[0] for s in jobs)
    hi = max(s[1] for s in jobs)
    dev = [(max(a, lo), min(b, hi), n) for cat in DEVICE_CATS for a, b, n in _spans(events, cat)
           if b > lo and a < hi]
    merged = union((a, b) for a, b, _ in dev)
    busy = sum(b - a for a, b in merged)
    per_op = defaultdict(float)
    for a, b, n in dev:
        per_op[n] += b - a
    pools = [_by_start(s for s in _spans(events, "user_annotation") if s[2] != JOB_SPAN),
             _by_start(_spans(events, "cpu_op"))]
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = f"{_innermost(pools[0], mid) or 'job'}/{_innermost(pools[1], mid) or 'host'}"
        gaps[label] += b - a
    top = lambda d: [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    busy_s, window_s = busy * 1e-6, (hi - lo) * 1e-6
    return {"busy_s": busy_s, "window_s": window_s,
            "device_idle_pct": idle_pct(busy_s, window_s),
            "device_ops": top(per_op), "idle_gaps": top(gaps),
            "span_kernel_s": span_kernel_s(events)}
