"""cmtci-torch command-line driver (the ported subcommands of ``cmtci``).

Ported so far: tracker, boundary, equipotential, tci, variograms, bench, the
file bus (stage1, lucas-boundary, construct-boundary, curvature), the seven
bus analyses (spectral, multifractal, embeddings, symmetry, spatial-stats,
report, coupling), suite, which runs them in one process, and the two
conformal maps (uniformize-green, uniformize-fem). On a CUDA
session (``--device cuda``, the default) the dtype/backend knobs default to
the card's fast paths: tracker field_dtype=float32 and de_impl=cuda (K1),
boundary backend=cuda (K2), equipotential green_dtype=float32 (K3), tci
de_impl=cuda (K1), variograms vario_dtype=field_dtype=float32, symmetry
scan_dtype=float32, spatial-stats stat_dtype=float32, multifractal
box_backend=device and box_dtype=float32, embeddings eig_backend=device,
eig_dtype=float32 and knn_dtype=float32, coupling field and vario dtype
float32, suite --stage-paths accel (those same choices for every stage),
uniformize-green map_dtype=float32 (the f32 QR fit and f32 map evaluations
on the card) and uniformize-fem solver=device (the θ-iteration's dense f64
Cholesky solves on the card; --solver auto).
``--parity`` opts out to the host/f64 paths (for tci, the numpy DE),
``--device cpu`` to the f64 plain-torch paths, and an explicit per-flag value
always wins. ``bench`` forwards its arguments to ``cmtci_torch.bench``.
``--device cuda`` without a card raises; nothing falls back to the CPU, and
suite reruns no stage on another path after an exception: the exception
ends the run. ``--no-plots`` skips the figures (matplotlib is then not
needed). The file-bus subcommands run f64 on the device whatever the
session (the alpha shapes on the host), so they have no session defaults,
and their ``--parity`` changes nothing, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import sys

#: the seven bus analyses `suite` chains, in the reference's order
_SUITE_STAGES = ("spectral", "multifractal", "embeddings", "symmetry",
                 "spatial-stats", "report", "coupling")

#: per-subcommand (flag, CUDA-session default, host default) triples
_PLATFORM_FLAGS = {
    "tracker": (("field_dtype", "float32", "float64"),
                ("de_impl", "cuda", "torch")),
    "boundary": (("backend", "cuda", "torch"),),
    "equipotential": (("green_dtype", "float32", "float64"),),
    "tci": (("de_impl", "cuda", "torch"),),
    "variograms": (("vario_dtype", "float32", "float64"),
                   ("field_dtype", "float32", "float64")),
    "symmetry": (("scan_dtype", "float32", "float64"),),
    "spatial-stats": (("stat_dtype", "float32", "float64"),),
    "multifractal": (("box_backend", "device", "host"),
                     ("box_dtype", "float32", "float64")),
    "embeddings": (("eig_backend", "device", "scipy"),
                   ("eig_dtype", "float32", "float64"),
                   ("knn_dtype", "float32", "float64")),
    "coupling": (("coupling_field_dtype", "float32", "float64"),
                 ("coupling_vario_dtype", "float32", "float64")),
    "suite": (("stage_paths", "accel", "host"),),
    "uniformize-green": (("map_dtype", "float32", "float64"),),
    "uniformize-fem": (("solver", "device", "spsolve"),),
}

#: each stage's knobs under `suite --stage-paths accel`, in the strings the
#: standalone subcommands' flags take (spectral and report have none)
_ACCEL_STAGE_OPTS = {
    "multifractal": {"box_backend": "device", "box_dtype": "float32"},
    "embeddings": {"eig_backend": "device", "eig_dtype": "float32",
                   "knn_dtype": "float32"},
    "symmetry": {"scan_dtype": "float32"},
    "spatial-stats": {"stat_dtype": "float32"},
    "coupling": {"field_dtype": "float32", "vario_dtype": "float32"},
}

#: per-subcommand (flag, --parity default) pairs, where parity is not the
#: host default
_PARITY_FLAGS = {"tci": (("de_impl", "numpy"),)}


def _resolve_platform_defaults(args) -> None:
    """Fill every None dtype/backend flag with its session default."""
    parity = getattr(args, "parity", False)
    if parity:
        for name, value in _PARITY_FLAGS.get(args.cmd, ()):
            if getattr(args, name, None) is None:
                setattr(args, name, value)
    cuda_session = args.device.startswith("cuda") and not parity
    for name, accel, host in _PLATFORM_FLAGS.get(args.cmd, ()):
        if getattr(args, name, None) is None:
            setattr(args, name, accel if cuda_session else host)


def _add_common(p, parity_help: str, plots: bool = False):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default="outputs/run", help="output prefix/dir")
    p.add_argument("--parity", action="store_true", help=parity_help)
    if plots:
        p.add_argument("--no-plots", action="store_true",
                       help="skip the figures (no matplotlib needed)")


def _parser():
    ap = argparse.ArgumentParser(prog="cmtci-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tracker", help="GI assumption tracker (Appendix A)")
    p.add_argument("--sigma-bins", type=float, default=1.0)
    p.add_argument("--t-fixed", type=int, default=-1)
    p.add_argument("--bins-start", type=int, default=64)
    p.add_argument("--bins-max", type=int, default=1024)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--domain", type=str, default="-2.2:1.2:-1.6:1.6")
    p.add_argument("--field-dtype", choices=["float64", "float32"], default=None,
                   help="DE field and matcher dtype (CUDA-session default float32)")
    p.add_argument("--de-impl", choices=["torch", "cuda"], default=None,
                   help="cuda = the hand-written K1 kernel (CUDA-session default); "
                        "torch = the plain-torch DE field")
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (resume; keyed by config hash)")
    _add_common(p, "bitwise oracle-parity mode")

    p = sub.add_parser("boundary", help="Mandelbrot dwell grid + isocontour boundary")
    p.add_argument("--xlim", nargs=2, type=float, default=[-2.1, 0.9])
    p.add_argument("--ylim", nargs=2, type=float, default=[-1.5, 1.5])
    p.add_argument("--res", type=int, default=2000)
    p.add_argument("--max-iter", type=int, default=500)
    p.add_argument("--level", type=float, default=0.96)
    p.add_argument("--backend", choices=["cuda", "torch"], default=None,
                   help="cuda = the hand-written f32 K2 dwell kernel (CUDA-session "
                        "default); torch = the f64 dwell grid")
    _add_common(p, "the f64 dwell grid whatever the device", plots=True)

    p = sub.add_parser("equipotential", help="Green-function statistics + family comparison")
    p.add_argument("--n-min", type=int, default=2)
    p.add_argument("--n-max", type=int, default=200)
    p.add_argument("--max-iter", type=int, default=20000)
    p.add_argument("--skip-per-n", action="store_true")
    p.add_argument("--green-dtype", choices=["float64", "float32"], default=None,
                   help="float32 = the hand-written K3 cloud Green kernel "
                        "(CUDA-session default); float64 = the compacted torch loop")
    p.add_argument("--curve-npy", default=None,
                   help="stored boundary curve (.npy) to analyze too: its Green "
                        "potential is summarized, law-compared, and saved as g_curve.npy")
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (resume; keyed by config hash)")
    _add_common(p, "the f64 potential whatever the device", plots=True)

    p = sub.add_parser("tci", help="TCI flow pipeline (v002_fixed main)")
    p.add_argument("--grid", type=int, default=600,
                   help="DE grid resolution (BASELINE configs[4]: 2400 = 4x)")
    p.add_argument("--samples", type=int, default=25000)
    p.add_argument("--t-steps", type=int, default=60)
    p.add_argument("--de-impl", choices=["torch", "numpy", "cuda"], default=None,
                   help="cuda = the hand-written K1 kernel with the band and subsample on "
                        "the device (CUDA-session default); torch = the f64 DE field; "
                        "numpy = the host numpy DE (--parity)")
    _add_common(p, "the host numpy DE (bitwise the reference's numpy path)", plots=True)

    p = sub.add_parser("variograms", help="potentials + semivariograms + cross")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--detrend", action="store_true")
    p.add_argument("--fit-model", action="store_true")
    p.add_argument("--vario-dtype", choices=["float64", "float32"], default=None,
                   help="dtype of the all-pairs binning (CUDA-session default float32)")
    p.add_argument("--field-dtype", choices=["float64", "float32"], default=None,
                   help="dtype of the DE proxy and the potentials (CUDA-session default "
                        "float32; borderline DE-threshold points flip)")
    _add_common(p, "the f64 fields and binning whatever the device")

    p = sub.add_parser("lucas-boundary", help="Lucas cloud -> alpha-shape boundary npy")
    p.add_argument("--n-min", type=int, default=2)
    p.add_argument("--n-max", type=int, default=100)
    p.add_argument("--alpha", type=float, default=4.5)
    p.add_argument("--n-boundary", type=int, default=2000)
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (resume; keyed by config hash)")
    _add_common(p, "accepted as the reference accepts it; changes nothing")

    p = sub.add_parser("construct-boundary", help="alpha-shape boundary of a point CSV")
    p.add_argument("--input-csv", required=True)
    p.add_argument("--alpha", type=float, default=65.0)
    p.add_argument("--target-n", type=int, default=1500)
    _add_common(p, "accepted as the reference accepts it; changes nothing")

    p = sub.add_parser("curvature", help="local-polynomial curvature of a boundary CSV")
    p.add_argument("--input-csv", required=True)
    p.add_argument("--neighbors", type=int, default=7)
    p.add_argument("--closed", type=lambda s: s.lower() in ("1", "true", "yes"), default=True)
    _add_common(p, "accepted as the reference accepts it; changes nothing", plots=True)

    p = sub.add_parser("stage1", help="stage-1 cleaning pipeline (file bus)")
    p.add_argument("--max-n", type=int, default=40)
    p.add_argument("--boundary-samples", type=int, default=600)
    _add_common(p, "accepted as the reference accepts it; changes nothing", plots=True)

    dtypes = ["float64", "float32"]
    for name in _SUITE_STAGES:
        p = sub.add_parser(name, help=f"{name} analysis over the stage-1 file bus")
        p.add_argument("--busdir", default="out_clean", help="stage-1 file-bus directory")
        if name == "symmetry":
            p.add_argument("--scan-dtype", choices=dtypes, default=None,
                           help="dtype of the op table's and the 361-angle best-axis "
                                "nearest-distance scans (CUDA-session default float32)")
        if name == "spatial-stats":
            p.add_argument("--stat-dtype", choices=dtypes, default=None,
                           help="dtype of the shell-count and Hausdorff pair scans "
                                "(CUDA-session default float32; exact int64 counts)")
        if name == "multifractal":
            p.add_argument("--box-backend", choices=["host", "device"], default=None,
                           help="device = the count grid and partition sums on the device "
                                "(CUDA-session default); host = the numpy grouping")
            p.add_argument("--box-dtype", choices=dtypes, default=None,
                           help="dtype of the device count grid (CUDA-session default "
                                "float32)")
        if name == "embeddings":
            p.add_argument("--eig-backend", choices=["scipy", "device"], default=None,
                           help="device = the dense Lanczos on the device (CUDA-session "
                                "default); scipy = the eigsh oracle")
            p.add_argument("--eig-dtype", choices=dtypes, default=None,
                           help="dtype of the device Lanczos (CUDA-session default float32)")
            p.add_argument("--knn-dtype", choices=dtypes, default=None,
                           help="float32 = the kNN search with hi/lo coordinates "
                                "(CUDA-session default)")
        if name == "coupling":
            p.add_argument("--field-dtype", dest="coupling_field_dtype", choices=dtypes,
                           default=None,
                           help="float32 = both potential grids and the diagnostics in f32 "
                                "(CUDA-session default; the trajectory is unchanged)")
            p.add_argument("--vario-dtype", dest="coupling_vario_dtype", choices=dtypes,
                           default=None,
                           help="float32 = the point variogram in f32 on the device "
                                "(CUDA-session default; an f32 trajectory realization)")
        _add_common(p, "the host/f64 paths whatever the device", plots=True)

    p = sub.add_parser("suite", help="all bus analyses in one process (per-stage "
                                     "files and times)")
    p.add_argument("--busdir", default="out_clean", help="stage-1 file-bus directory")
    p.add_argument("--stages", default="all",
                   help="comma list from {" + ",".join(_SUITE_STAGES) + "} "
                        "(default: all seven, in catalog order)")
    p.add_argument("--stage-paths", choices=["host", "accel"], default=None,
                   help="accel = every stage's f32/device path (the reference's "
                        "`suite --device accel`; CUDA-session default); host = the "
                        "f64 defaults of each subcommand")
    _add_common(p, "the host/f64 stage paths whatever the device", plots=True)

    p = sub.add_parser("uniformize-fem", help="v18 FEM quasiconformal pipeline")
    p.add_argument("--levels", type=int, default=4, choices=[1, 2, 3, 4],
                   help="number of refinement levels (the reference v18 runs all 4, L0-L3)")
    p.add_argument("--solver", choices=["auto", "spsolve", "cg", "device"], default="auto",
                   help="FEM linear solver: device = the θ-iteration's dense f64 Cholesky "
                        "solves on the card; cg = torch CG on --device; spsolve = SuperLU on "
                        "the host; auto = device on a CUDA session, spsolve under --parity "
                        "or --device cpu")
    _add_common(p, "the host SuperLU solver whatever the device", plots=True)

    p = sub.add_parser("uniformize-green", help="v40 boundary-integral Riemann map")
    p.add_argument("--lucas-npy", default=None,
                   help="lucas_points.npy (else generated by the port's lucas-boundary)")
    p.add_argument("--n-bdy", type=int, default=2000)
    p.add_argument("--interior-n", type=int, default=20000)
    p.add_argument("--map-dtype", choices=["float64", "float32"], default=None,
                   help="float32 = the f32 QR fit and f32 map evaluations on the card "
                        "(CUDA-session default); float64 = the host lstsq fit and f64 "
                        "evaluations")
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (the fit; keyed by config hash)")
    _add_common(p, "the host lstsq fit and f64 evaluations whatever the device")

    sub.add_parser("bench", add_help=False,
                   help="the benchmark (python -m cmtci_torch.bench; same arguments)")
    return ap


def _bus_stage_opts_from_args(st, args) -> dict:
    """The standalone subcommand's flags as a stage-opts dict."""
    if st == "multifractal":
        return {"box_backend": args.box_backend, "box_dtype": args.box_dtype}
    if st == "embeddings":
        return {"eig_backend": args.eig_backend, "eig_dtype": args.eig_dtype,
                "knn_dtype": args.knn_dtype}
    if st == "symmetry":
        return {"scan_dtype": args.scan_dtype}
    if st == "spatial-stats":
        return {"stat_dtype": args.stat_dtype}
    if st == "coupling":
        return {"field_dtype": args.coupling_field_dtype,
                "vario_dtype": args.coupling_vario_dtype}
    return {}


def _run_bus_stage(st, c, m, ca, matches, out_prefix, opts, plots=True,
                   device="cuda", layers=None) -> dict:
    """One bus analysis stage: the one dispatch the standalone subcommands
    and `suite` share (the same pipeline call and files, so a suite stage
    writes what its subcommand writes). `opts` holds the stage's knobs as
    the CLI's strings; `layers`, a StageTimer, takes the spans of a stage
    that times its layers (coupling); returns the values the CLI prints."""
    import torch

    from cmtci_torch.pipelines import analysis
    from cmtci_torch.utils.device import resolve_device

    dev = resolve_device(device)

    def dtype(key):
        return torch.float32 if opts.get(key) == "float32" else torch.float64

    if st == "spectral":
        from cmtci_torch.pipelines.spectral import SpectralConfig, run_spectral

        o = run_spectral(c, m, SpectralConfig(), out_prefix, plots=plots, device=dev)
        return {"power_slopes_bootstrap": o["power_slopes_bootstrap"]}
    if st == "multifractal":
        analysis.run_multifractal(c, m, out_prefix=out_prefix,
                                  box_backend=opts.get("box_backend", "host"),
                                  box_dtype=dtype("box_dtype"), plots=plots, device=dev)
        return {}
    if st == "embeddings":
        o = analysis.run_embeddings(c, m, out_prefix=out_prefix,
                                    eig_backend=opts.get("eig_backend", "scipy"),
                                    eig_dtype=dtype("eig_dtype"), knn_dtype=dtype("knn_dtype"),
                                    plots=plots, device=dev)
        return {"spectral_distance": o["spectral_distance"]}
    if st == "symmetry":
        o = analysis.run_symmetry(ca, m, matches, out_prefix=out_prefix,
                                  scan_dtype=dtype("scan_dtype"), device=dev)
        return {"rows": o["rows"]}
    if st == "spatial-stats":
        o = analysis.run_spatial_stats(ca, m, out_prefix=out_prefix,
                                       stat_dtype=dtype("stat_dtype"), plots=plots, device=dev)
        return {"hausdorff": o["hausdorff"]}
    if st == "report":
        return {"report_row": analysis.run_report(c, m, ca, matches, out_prefix, plots=plots,
                                                  device=dev)}
    if st == "coupling":
        from cmtci_torch.pipelines.coupling import CouplingConfig, run_coupling

        rows, _ = run_coupling(
            c, m, matches,
            CouplingConfig(field_dtype=opts.get("field_dtype", "float64"),
                           vario_dtype=opts.get("vario_dtype", "float64")),
            out_prefix, plots=plots, device=dev, timer=layers)
        return {"coupling_rows": rows}
    raise ValueError(f"unknown bus stage {st!r}")


def _load_bus(busdir):
    """(C, M, C_aligned, matches) of a stage-1 bus; matches is None when
    matches_indices.csv is missing or unreadable (coupling then raises)."""
    from cmtci_torch.io.loaders import load_matches, load_points

    c = load_points(f"{busdir}/construct_points.csv")
    m = load_points(f"{busdir}/mandel_boundary_sample.csv")
    ca = load_points(f"{busdir}/construct_aligned.csv")
    try:
        matches = load_matches(f"{busdir}/matches_indices.csv", len(ca))
    except (OSError, ValueError):
        matches = None
    return c, m, ca, matches


def _run_suite(args, layers=None) -> int:
    """The bus analyses in one process, each stage timed (a device
    synchronize at both ends), with one JSON summary line. Each stage runs
    the pipeline call of its subcommand and writes `{out}/{stage}_*`. An
    exception in a stage ends the run: no stage is rerun on another path.
    `layers` (a StageTimer) takes the coupling stage's layer spans."""
    import time

    from cmtci_torch.io.writers import to_jsonable
    from cmtci_torch.utils.artifacts import StageTimer
    from cmtci_torch.utils.device import resolve_device

    t0 = time.time()
    stages = (_SUITE_STAGES if args.stages == "all"
              else tuple(s.strip() for s in args.stages.split(",") if s.strip()))
    unknown = [s for s in stages if s not in _SUITE_STAGES]
    if unknown:
        raise SystemExit(f"suite: unknown stage(s) {unknown}; choose from "
                         f"{list(_SUITE_STAGES)}")
    dev = resolve_device(args.device)
    accel = args.stage_paths == "accel"
    c, m, ca, matches = _load_bus(args.busdir)
    timer = StageTimer(dev)
    summary: dict = {}
    for st in stages:
        with timer.stage(st):
            o = _run_bus_stage(st, c, m, ca, matches, f"{args.out}/{st}",
                               _ACCEL_STAGE_OPTS.get(st, {}) if accel else {},
                               plots=not args.no_plots, device=dev, layers=layers)
        if st == "spectral" and o["power_slopes_bootstrap"]:
            summary["power_slope_construct"] = o["power_slopes_bootstrap"][0]["slope"]
        elif st == "embeddings":
            summary["spectral_distance"] = o["spectral_distance"]
        elif st == "symmetry":
            summary["best_axis_deg"] = o["rows"][-1]["angle_deg"]
        elif st == "spatial-stats":
            summary["hausdorff"] = o["hausdorff"]
        elif st == "report":
            summary.setdefault("hausdorff", o["report_row"]["hausdorff"])
        elif st == "coupling":
            summary["coupling_d_mean"] = o["coupling_rows"][-1]["d_mean"]
    print(json.dumps(to_jsonable(
        {"stages": {k: round(v, 3) for k, v in timer.times.items()},
         "wall_s": round(time.time() - t0, 3), **summary})))
    return 0


def main(argv=None, layers=None):
    """The CLI. `layers`, a StageTimer, takes the layer spans of `suite`'s and
    `coupling`'s coupling stage, for a caller in the same process."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        from cmtci_torch import bench

        raise SystemExit(bench.main(argv[1:]))
    args = _parser().parse_args(argv)
    if getattr(args, "solver", None) == "auto":
        args.solver = None  # resolved below with the session's defaults
    _resolve_platform_defaults(args)
    if args.cmd == "tracker":
        from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker, write_outputs

        domain = tuple(float(x) for x in args.domain.split(":"))
        if len(domain) != 4:
            raise SystemExit(
                f"--domain expects xmin:xmax:ymin:ymax (4 fields), got {args.domain!r}")
        cfg = TrackerConfig(seed=args.seed, domain=domain, alpha=args.alpha,
                            bins_start=args.bins_start, bins_max=args.bins_max,
                            sigma_bins=args.sigma_bins, t_fixed=args.t_fixed,
                            parity=args.parity, field_dtype=args.field_dtype,
                            de_impl=args.de_impl)
        rows, meta = run_tracker(cfg, cache_dir=args.cache_dir, device=args.device)
        csv_path, _ = write_outputs(rows, meta, args.out)
        print(f"tracker: {len(rows)} stages -> {csv_path}")
    elif args.cmd == "boundary":
        from cmtci_torch.pipelines.boundary import BoundaryConfig, run_boundary

        cfg = BoundaryConfig(tuple(args.xlim), tuple(args.ylim), args.res,
                             args.max_iter, args.level, backend=args.backend)
        path, _ = run_boundary(cfg, args.out, plots=not args.no_plots, device=args.device)
        print(f"boundary: {len(path)} vertices -> {args.out}_boundary.csv")
    elif args.cmd == "equipotential":
        from cmtci_torch.pipelines.equipotential import (EquipotentialConfig,
                                                         run_equipotential)

        cfg = EquipotentialConfig(n_min=args.n_min, n_max=args.n_max,
                                  max_iter=args.max_iter,
                                  potential_dtype=args.green_dtype,
                                  curve_npy=args.curve_npy)
        out = run_equipotential(cfg, args.out, with_per_n=not args.skip_per_n,
                                cache_dir=args.cache_dir, plots=not args.no_plots,
                                device=args.device)
        print(json.dumps(out["summary"]))
    elif args.cmd == "tci":
        from cmtci_torch.pipelines.analysis import TCIConfig, run_tci

        cfg = TCIConfig(mandelbrot_grid=args.grid, mandelbrot_samples=args.samples,
                        t_steps=args.t_steps, de_impl=args.de_impl)
        out, _, _ = run_tci(cfg, f"{args.out}_tci_results.json", plots=not args.no_plots,
                            device=args.device)
        print(json.dumps(out))
    elif args.cmd == "variograms":
        from cmtci_torch.pipelines.variograms import VariogramConfig, run_variograms

        cfg = VariogramConfig(grid_nx=args.grid, grid_ny=args.grid, detrend=args.detrend,
                              fit_model=args.fit_model, vario_dtype=args.vario_dtype,
                              field_dtype=args.field_dtype)
        out = run_variograms(cfg, f"{args.out}_variograms.csv", device=args.device)
        print(f"variograms: {out['n_construct']} C pts, {out['n_boundary']} M pts")
    elif args.cmd == "lucas-boundary":
        from cmtci_torch.pipelines.lucas_boundary import (LucasBoundaryConfig,
                                                          export_lucas_boundary)

        cfg = LucasBoundaryConfig(args.n_min, args.n_max, args.alpha, args.n_boundary)
        xy = export_lucas_boundary(cfg, f"{args.out}_lucas_points.npy",
                                   cache_dir=args.cache_dir, device=args.device)
        print(f"lucas boundary: {xy.shape} -> {args.out}_lucas_points.npy")
    elif args.cmd == "construct-boundary":
        from cmtci_torch.io.loaders import load_points
        from cmtci_torch.pipelines.lucas_boundary import (ConstructBoundaryConfig,
                                                          construct_boundary)
        from cmtci_torch.utils.device import resolve_device

        resolve_device(args.device)  # the alpha shape runs on the host; a
        # --device cuda without a card still raises, as on every subcommand
        pts = load_points(args.input_csv)
        b, closed = construct_boundary(pts, ConstructBoundaryConfig(args.alpha, args.target_n),
                                       args.out)
        print(f"construct boundary: {len(b)} pts closed={closed}")
    elif args.cmd == "curvature":
        from cmtci_torch.io.loaders import load_points
        from cmtci_torch.pipelines.curvature import CurvatureConfig, run_curvature

        pts = load_points(args.input_csv)
        _, _, _, _, summary = run_curvature(pts, CurvatureConfig(args.neighbors, args.closed),
                                            args.out, plots=not args.no_plots,
                                            device=args.device)
        print(json.dumps(summary))
    elif args.cmd == "stage1":
        from cmtci_torch.pipelines.stage1 import Stage1Config, run_stage1

        out = run_stage1(Stage1Config(max_n=args.max_n, boundary_samples=args.boundary_samples),
                         args.out, plots=not args.no_plots, device=args.device)
        print(f"stage1: C={out['C'].shape} M={out['M'].shape} -> {args.out}/")
    elif args.cmd in _SUITE_STAGES:
        from cmtci_torch.utils.device import resolve_device

        resolve_device(args.device)  # no card: raise before reading the bus
        c, m, ca, matches = _load_bus(args.busdir)
        out = _run_bus_stage(args.cmd, c, m, ca, matches, args.out,
                             _bus_stage_opts_from_args(args.cmd, args),
                             plots=not args.no_plots, device=args.device, layers=layers)
        if args.cmd == "spectral":
            print(json.dumps(out["power_slopes_bootstrap"]))
        elif args.cmd == "multifractal":
            print("multifractal done")
        elif args.cmd == "embeddings":
            print(f"spectral distance: {out['spectral_distance']}")
        elif args.cmd == "symmetry":
            print(json.dumps(out["rows"][-1]))
        elif args.cmd == "spatial-stats":
            print(f"hausdorff={out['hausdorff']:.4f}")
        elif args.cmd == "report":
            print(json.dumps(out["report_row"]))
        elif args.cmd == "coupling":
            print(json.dumps(out["coupling_rows"][-1]))
    elif args.cmd == "suite":
        return _run_suite(args, layers)
    elif args.cmd == "uniformize-fem":
        from cmtci_torch.pipelines.uniformize_fem import (REFINEMENT_LEVELS,
                                                          FEMUniformizeConfig,
                                                          run_fem_uniformization)

        results = run_fem_uniformization(FEMUniformizeConfig(solver=args.solver), args.out,
                                         REFINEMENT_LEVELS[: args.levels],
                                         plots=not args.no_plots, device=args.device)
        print(json.dumps({"levels": len(results),
                          "K_median_L0": results[0]["all"]["K_median"]}))
    elif args.cmd == "uniformize-green":
        import numpy as np

        from cmtci_torch.pipelines.uniformize_green import (GreenUniformizeConfig,
                                                            run_green_uniformization)
        from cmtci_torch.utils.artifacts import StageTimer
        from cmtci_torch.utils.device import resolve_device

        dev = resolve_device(args.device)
        if args.lucas_npy:
            pts = np.load(args.lucas_npy)
        else:
            from cmtci_torch.pipelines.lucas_boundary import (LucasBoundaryConfig,
                                                              export_lucas_boundary)

            pts = export_lucas_boundary(LucasBoundaryConfig(), device=dev)
        cfg = GreenUniformizeConfig(n_bdy=args.n_bdy, interior_n=args.interior_n,
                                    map_dtype=args.map_dtype)
        out = run_green_uniformization(pts, cfg, args.out, verbose=True,
                                       cache_dir=args.cache_dir, timer=StageTimer(dev),
                                       device=dev)
        print(json.dumps({k: v for k, v in out["diagnostics"].items()
                          if k.startswith(("bdy_mod", "inverse_err"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
