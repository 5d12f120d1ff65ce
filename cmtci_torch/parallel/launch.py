"""The rank launcher: run a list of calls on N ranks of one process group.

``cmtci-torch <cmd> --devices N`` and the multi-device tests both go
through ``run``. It spawns N processes with ``torch.multiprocessing``
(spawn start method, so no rank inherits the parent's state), joins them
in a group over a ``file://`` rendezvous in a fresh directory, and has
every rank execute the same calls in the same order. A call names its
function as "module:qualname", so a rank imports only that module (never a
test module) and the function is found the same way on every rank. Each
rank writes its results, with every tensor turned into a numpy array, to a
pickle the parent reads back. When one rank raises, the others are stopped
and ``run`` raises with the rank's traceback.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import sys
import tempfile
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Call:
    """fn(*args, **kwargs) on every rank; with mesh=True the rank's Mesh is
    passed as the keyword `mesh`."""

    fn: str
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    mesh: bool = True


def check_devices(n: int, device: str = "cuda") -> None:
    """Refuse an N-rank group on `device` ("cuda" or "cpu") that this
    machine cannot give one card a rank; a CPU group is always possible."""
    import torch

    if str(device).startswith("cuda"):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise SystemExit(
                f"--devices {n} needs {n} devices but only {have} are available on "
                "'cuda'. A CPU group of N ranks runs with --device cpu.")


def _resolve(name: str):
    mod, _, qual = name.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x] if isinstance(x, list) else tuple(map(_to_host, x))
    return x


def _foreign_modules() -> list:
    """Modules a rank must never hold: jax and the JAX package."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "cmtci"
                  or m.startswith("cmtci."))


def _worker(rank: int, n: int, workdir: str, devices, backend: str, calls, threads):
    import torch
    import torch.distributed as dist

    from cmtci_torch.parallel import distributed
    from cmtci_torch.parallel.sharded import device_mesh

    if threads:
        torch.set_num_threads(int(threads))
    distributed.set_rank_device(devices[rank])
    dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous",
                            world_size=n, rank=rank, timeout=distributed.TIMEOUT)
    try:
        mesh = device_mesh(n)
        results = []
        for c in calls:
            fn = _resolve(c.fn)
            kw = dict(c.kwargs, mesh=mesh) if c.mesh else dict(c.kwargs)
            results.append(_to_host(fn(*c.args, **kw)))
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump({"rank": rank, "results": results,
                         "foreign_modules": _foreign_modules()}, f)
    finally:
        dist.destroy_process_group()


def run(n: int, calls, device: str = "cuda", devices=None, threads: int | None = None,
        workdir: str | None = None) -> list:
    """Run `calls` (a list of Call) on an n-rank group and return one dict
    per rank, in rank order: {"rank", "results" (one entry per call, tensors
    as numpy arrays), "foreign_modules" (jax or cmtci modules the rank
    held: none)}.

    `device` "cuda" (the default) puts rank r on cuda:r (NCCL) and refuses
    more ranks than cards; "cpu" puts every rank on the CPU (gloo).
    `devices` (one torch.device per rank) overrides that, e.g. several ranks
    on one card, which NCCL refuses, so that group is gloo. `threads` pins
    each rank's intra-op threads (default: the cores shared out). The
    rendezvous file and the results live in `workdir` (default: a new
    temporary directory, removed afterwards).
    """
    import torch
    import torch.multiprocessing as mp

    from cmtci_torch.parallel.distributed import backend_for, rank_device

    if devices is None:
        check_devices(n, device)
        devices = [rank_device(device, r) for r in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"run: {len(devices)} devices for {n} ranks")
    backend = backend_for(devices)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="cmtci_torch_ranks_") if own else str(workdir)
    os.makedirs(workdir, exist_ok=True)
    try:
        mp.start_processes(_worker, args=(n, workdir, devices, backend, list(calls), threads),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
