"""The benchmark of the PyTorch and CUDA port, cmtci_torch.

``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line. What belongs to one
configuration, cell, job or metric lives in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``, ``jobs/<driver>.py`` and
``metrics/<metric>.py``. ``reference/`` holds the plain references that decide
``correct``; they import nothing of the port.
"""
