"""cmtci-torch command-line driver (the ported subcommands of ``cmtci``).

Ported so far: tracker, boundary, equipotential. On a CUDA session
(``--device cuda``, the default) the dtype/backend knobs default to the
card's hand-written kernels: tracker field_dtype=float32 and de_impl=cuda
(K1), boundary backend=cuda (K2), equipotential green_dtype=float32 (K3).
``--parity`` opts out to the host/f64 paths, ``--device cpu`` to the f64
plain-torch paths, and an explicit per-flag value always wins.
``--device cuda`` without a card raises; nothing falls back to the CPU.
``--no-plots`` skips the figures (matplotlib is then not needed).
"""

from __future__ import annotations

import argparse
import json

#: per-subcommand (flag, CUDA-session default, host default) triples
_PLATFORM_FLAGS = {
    "tracker": (("field_dtype", "float32", "float64"),
                ("de_impl", "cuda", "torch")),
    "boundary": (("backend", "cuda", "torch"),),
    "equipotential": (("green_dtype", "float32", "float64"),),
}


def _resolve_platform_defaults(args) -> None:
    """Fill every None dtype/backend flag with its session default."""
    cuda_session = args.device.startswith("cuda") and not getattr(args, "parity", False)
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
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
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


if __name__ == "__main__":
    main()
