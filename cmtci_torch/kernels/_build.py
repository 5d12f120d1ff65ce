"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled at first use into a shared library with
a plain C entry point, under ``build/cmtci_torch/<name>-<hash>/`` at the root
of the checkout, keyed by a hash of the source and the flags, then loaded
with ctypes. A source with no PyTorch headers compiles in seconds (the
``torch.utils.cpp_extension`` route takes minutes per build). Nothing is
compiled or loaded at import time: this module is imported on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cmtci_torch"

#: sm_90a (Hopper); -fmad=false keeps each product and sum rounded in the op
#: order the source writes, so a kernel can be held bitwise to its twin;
#: IEEE division and square root; never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}
#: seconds each library took to build in this process (0.0 when it was
#: already on disk)
BUILD_SECONDS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return found


def library(name: str) -> ctypes.CDLL:
    """ctypes handle of csrc/<name>.cu, built on first use. Raises on a
    failed build (the compiler's output is in the exception)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{digest}"
    so = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """Text of the newest build log of csrc/<name>.cu (ptxas register and
    spill report included), or '' when it was not built here."""
    logs = sorted(BUILD_DIR.glob(f"{name}-*/build.log"), key=os.path.getmtime)
    return logs[-1].read_text() if logs else ""
