"""cmtci_torch imports neither jax nor cmtci (cmtci/__init__.py turns on
x64 for the whole process), and imports matplotlib only to draw a figure
(the machine with the card has none)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import cmtci_torch.pipelines.tracker
import cmtci_torch.pipelines.boundary
import cmtci_torch.pipelines.equipotential
import cmtci_torch.io.plots
import cmtci_torch.kernels.mandelbrot_cuda
import cmtci_torch.kernels._build
import cmtci_torch.cli
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "cmtci" or m.startswith("cmtci.")
             or m == "matplotlib" or m.startswith("matplotlib."))
print("BAD", bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_cmtci():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_port_sources_name_no_jax():
    pkg = os.path.join(REPO, "cmtci_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f), encoding="utf-8").read()
                for line in src.splitlines():
                    s = line.strip()
                    assert not s.startswith(("import jax", "from jax", "import cmtci.",
                                             "from cmtci.", "from cmtci import")), (f, s)
