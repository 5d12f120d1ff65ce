#!/usr/bin/env python3
"""Readings that the limits of a cell are set from: on each seed, the
program's job and the control (the plain reference one precision step below
the configuration's, put in the program's place), each judged by the
harness's own check against the cell's limits. One process, one job a seed
(job 0 of the seed), so that set-up is paid once.

    python3 benchmarks/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed and side: {"seed", "side", "correct", "checks"}.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks.harness import cell, files, loop  # noqa: E402


def readings(name: str, seeds, device: torch.device, workload=None, config=None):
    """Yield {"seed", "side", "correct", "checks"} for each seed, the
    program's side first: each side's output as a job record of the seed,
    judged by ``cell.check``. `workload` and `config` default to the files
    (tests pass small ones)."""
    workload = files.workload(name) if workload is None else workload
    config = files.config(workload["config"]) if config is None else config
    job = files.driver(workload["driver"]).Job(config, workload, device)
    for seed in seeds:
        job_seed = loop.job_seed(seed, 0)
        inp = job.inputs(job_seed)
        sides = (("program", job.run(inp)[0]),
                 ("control", job.as_output(job.reference(inp, "lower"), inp)))
        for side, out in sides:
            checks = cell.check(job, [loop.JobRecord(0, job_seed, 0.0, {}, out)], seed, workload)
            yield {"seed": seed, "side": side, "correct": cell.judged(checks), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for line in readings(args.workload, args.seeds, torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
