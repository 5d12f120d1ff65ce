"""Multi-process / multi-node initialization (port of
``cmtci/parallel/distributed.py``).

The reference calls ``jax.distributed.initialize`` once per process and then
builds meshes over every host's devices. The port's counterpart joins a
``torch.distributed`` process group: one process per device, each on
``cuda:<local rank>`` (NCCL) or on the CPU (gloo). Call ``initialize()``
once per process, before any sharded call, then build the mesh with
``parallel.sharded.device_mesh()``. Under ``torchrun`` the group's address,
size and rank come from the environment (``env://``); across nodes, run
``torchrun --nnodes ... --rdzv-endpoint ...`` on each node, or pass the
address, the world size and the rank here.
"""

from __future__ import annotations

import datetime
import os

#: the device this process's rank computes on, set when it joins a group
#: (``initialize``, ``launch``) and read by ``sharded.device_mesh``
_LOCAL = {"device": None}

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(device_type: str = "cuda", local_rank: int = 0):
    """torch.device of a rank: cuda:<local_rank> for "cuda", else the CPU."""
    import torch

    if str(device_type).startswith("cuda"):
        return torch.device("cuda", int(local_rank))
    return torch.device("cpu")


def backend_for(devices) -> str:
    """nccl when every rank has a card of its own, else gloo (the CPU, or
    several ranks sharing one card: NCCL refuses two ranks on one GPU)."""
    devs = list(devices)
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def set_rank_device(dev) -> None:
    import torch

    _LOCAL["device"] = torch.device(dev)
    if _LOCAL["device"].type == "cuda":
        torch.cuda.set_device(_LOCAL["device"])


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               require: bool = False, device_type: str | None = None) -> bool:
    """Join a torch.distributed group; returns True if this process is in one.

    With no arguments the group is read from the environment (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as ``torchrun`` sets them).
    On a plain single-process run that fails: the failure is swallowed and
    False is returned, unless `require=True` or an argument was passed
    explicitly (then it raises), as in the reference. `coordinator_address`
    is "host:port" of rank 0. `device_type` ("cuda", the default, or "cpu")
    picks the rank's device, cuda:<LOCAL_RANK>, and the backend (nccl on
    cards, gloo on the CPU). Once a group is found, "cuda" without a card
    raises whatever `require` says: a CPU group comes only from
    device_type="cpu".
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    from cmtci_torch.utils.device import resolve_device

    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if (explicit or "WORLD_SIZE" in os.environ) and str(device_type or "cuda") != "cpu":
        resolve_device("cuda")  # no card: raise, never fall back to a CPU group
    device_type = "cuda" if device_type is None else device_type
    try:
        if explicit:
            if None in (coordinator_address, num_processes, process_id):
                raise ValueError("initialize: pass coordinator_address, num_processes "
                                 "and process_id together")
            init = f"tcp://{coordinator_address}"
            world, rank = int(num_processes), int(process_id)
        else:
            if "WORLD_SIZE" not in os.environ:
                raise RuntimeError("no process group in the environment (WORLD_SIZE unset)")
            init = "env://"
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank if explicit else 0))
        dev = rank_device(device_type, local)
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{dev.index} but only "
                               f"{torch.cuda.device_count()} cards are visible")
        set_rank_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init, world_size=world, rank=rank,
                                timeout=TIMEOUT)
        return True
    except Exception:
        if require or explicit:
            raise
        return False  # single-process run


def process_info() -> dict:
    """Current process/device topology summary: this process's rank and the
    group's size, the cards this host shows, and the devices of the group
    (one per rank)."""
    import torch
    import torch.distributed as dist

    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if dist.is_available() and dist.is_initialized():
        return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
                "local_devices": local, "global_devices": dist.get_world_size(),
                "backend": dist.get_backend()}
    return {"process_index": 0, "process_count": 1, "local_devices": local,
            "global_devices": local, "backend": None}
