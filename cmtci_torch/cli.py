"""cmtci-torch command-line driver (the ported subcommands of ``cmtci``).

Ported so far: tracker. On a CUDA session (``--device cuda``, the default)
the dtype/backend knobs default to the card's paths — field_dtype=float32
and de_impl=cuda (the hand-written K1 kernel). ``--parity`` opts out to the
all-numpy oracle path, ``--device cpu`` to the f64 plain-torch path, and an
explicit per-flag value always wins. ``--device cuda`` without a card
raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse

#: per-subcommand (flag, CUDA-session default, host default) triples
_PLATFORM_FLAGS = {
    "tracker": (("field_dtype", "float32", "float64"),
                ("de_impl", "cuda", "torch")),
}


def _resolve_platform_defaults(args) -> None:
    """Fill every None dtype/backend flag with its session default."""
    cuda_session = args.device.startswith("cuda") and not getattr(args, "parity", False)
    for name, accel, host in _PLATFORM_FLAGS.get(args.cmd, ()):
        if getattr(args, name, None) is None:
            setattr(args, name, accel if cuda_session else host)


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
    p.add_argument("--parity", action="store_true", help="bitwise oracle-parity mode")
    p.add_argument("--field-dtype", choices=["float64", "float32"], default=None,
                   help="DE field and matcher dtype (CUDA-session default float32)")
    p.add_argument("--de-impl", choices=["torch", "cuda"], default=None,
                   help="cuda = the hand-written K1 kernel (CUDA-session default); "
                        "torch = the plain-torch DE field")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default="outputs/run", help="output prefix")
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (resume; keyed by config hash)")
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


if __name__ == "__main__":
    main()
