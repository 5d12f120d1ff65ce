#!/usr/bin/env python3
"""Run one cell of cmtci_torch's benchmark once and print one JSON line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (it exits 2 without them and never falls back to the CPU).
The run builds or loads the port's kernels (``build/`` in the checkout), runs
one warm-up job of the cell's shapes (``setup_s``), then jobs back to back
for --seconds, and checks jobs drawn from the seed against the plain
reference. With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, the device trace's busy and window seconds
and a breakdown. The numbers compared, each beside its limit, are the last
lines of standard error and the line's last key, ``checks``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()  # setup_s counts from here: torch's import is set-up too

ROOT = Path(__file__).resolve().parents[1]
# kernel caches live in the checkout, at fixed paths, so that only a
# checkout's first run builds; the port's own nvcc cache is build/cmtci_torch
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks.harness import cell, files, guard  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        workload = files.workload(args.workload)
    except (ValueError, FileNotFoundError) as e:
        print(f"no such cell: {e}", file=sys.stderr)
        return 2
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), workload=workload, started=STARTED)
    found = guard.forbidden_modules()
    if found:
        print(f"modules of the JAX side were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in cell.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
