"""Device resolution for the port.

The reference pins f64 analysis math to the host CPU because the TPU
emulates f64 (``cmtci/utils/device.py``). Hopper has native f64, so the port
runs the whole stage on the one device the caller names, and a request for
"cuda" on a machine without a card raises instead of moving the work to the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """torch.device for `name` ("cuda", "cuda:N", "cpu" or a torch.device).

    Raises RuntimeError when a CUDA device is asked for and none is present.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain-torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (expected cuda or cpu)")
    return dev
