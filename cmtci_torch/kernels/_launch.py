"""Launch the hand-written CUDA kernels through ctypes, and count it.

Every kernel wrapper of the package launches through ``launch``: it looks up
the C entry point ``<entry>_launch`` in the library built from
``csrc/<library>.cu`` (``_build.py``), calls it on PyTorch's current stream,
raises when the entry returns a non-zero ``cudaGetLastError()``, and adds one
to ``launches[entry]``. Nothing else adds to a count, so a caller that sets
the counts to 0 before a run and reads them after it sees which kernels the
run went through.
"""

from __future__ import annotations

import ctypes

import torch

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_D = ctypes.c_double
_GRID = [_P, _I, _I, _F, _F, _F, _F, _I]  # out, nx, ny, xmin, ymin, dx, dy, max_iter

#: argument types of each C entry point; the last is the stream
ARGTYPES = {
    "tci_de": [_P, _I, _F, _F, _F, _F, _I, _F, _P],
    "dwell": _GRID + [_P],
    "dwell_rows": _GRID[:3] + [_I] + _GRID[3:] + [_P],  # row0 after ny
    "dwell_periodic": _GRID + [_P],
    "cloud_green": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "de_std": _GRID + [_F, _P],
    "green_grid": _GRID + [_F, _P],
    "dwell_ms": [_P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P],
    "fma_peak": [_P, _L, _I, _F, _F, _F, _F, _P],
    # zr, zi, steps, task, deg, width, closed, coef, coef_stride, ctas, lanes,
    # max_iters, tol2, rep64, the closed form's c0..c3, nc, a, threads, smem
    "aberth": [_P] * 8 + [_I] * 4 + [_D, _I] + [_D] * 4 + [_I, _D, _I, _I, _P],
    # the orbit loops: inputs, outputs, n (orbit_green; the others ny, nx),
    # then each loop's counts and threshold, is_double
    "orbit_dwell": [_P, _P, _P, _L, _L, _I, _I, _P],
    "orbit_de_tci": [_P] * 7 + [_L, _L, _I, _D, _P, _I, _P],  # t, then second_passes
    "orbit_de_std": [_P] * 7 + [_L, _L, _I, _D, _I, _P],  # t
    # R, the band (t_lo, t_hi), then hypot_calls
    "orbit_de_stage1": [_P] * 7 + [_L, _L, _I, _D, _D, _D, _P, _I, _P],
    "orbit_green": [_P] * 10 + [_L, _I, _I, _D, _I, _I, _P],
    "orbit_potential": [_P] * 6 + [_L, _L, _I, _D, _I, _I, _P],  # r2, then skip_interior
    # cost, mk, mkT, f, g, plan, n, m, iters, eps, inv_eps, log_mu, log_nu,
    # ctas, resident, smem, pass_rows, pass_cols
    "sinkhorn": [_P] * 6 + [_I] * 3 + [_D] * 4 + [_I] * 5 + [_P],
    # xy, fparams, iparams, nclouds, nscales, words, ctas, bitmaps, counts, ticket
    "boxcount": [_P] * 3 + [_I, _I, _L, _I] + [_P] * 3 + [_P],
    # xy, n, lo, hi, tau, nbins, e0, inv, threads, cols, ctas, is_double, counts
    "shellcount": [_P, _I, _I, _I, _P, _I, _F, _F, _I, _I, _I, _I, _P, _P],
    # a, b, n, m, slabs, is_double, then partials, ticket, total
    "argmax_mean": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # a, b, n, m, slabs, is_double, mean, inv_eps, kpart, jpart, tickets, out
    "argmax_rows": [_P, _P, _I, _I, _I, _I, _P, _D, _P, _P, _P, _P, _P],
}

#: the csrc/<library>.cu that holds an entry point named otherwise
LIBRARY = {"dwell_rows": "dwell", "dwell_periodic": "dwell",
           "argmax_mean": "argmax_match", "argmax_rows": "argmax_match",
           **{name: "orbit" for name in ("orbit_dwell", "orbit_de_tci", "orbit_de_std",
                                         "orbit_de_stage1", "orbit_green", "orbit_potential")}}

#: kernel launches per entry point, counted where the wrapper launches; read
#: and reset by callers that need to show a run went through the kernels
launches = {name: 0 for name in ARGTYPES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch(entry: str, dev: torch.device, *args) -> None:
    """Launch `<entry>_launch` on dev's current stream and count it; raise on
    a non-zero cudaGetLastError()."""
    from cmtci_torch.kernels._build import library

    fn = getattr(library(LIBRARY.get(entry, entry)), f"{entry}_launch")
    fn.argtypes = ARGTYPES[entry]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    launches[entry] += 1
