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
import cmtci_torch.pipelines.analysis
import cmtci_torch.pipelines.variograms
import cmtci_torch.pipelines.stage1
import cmtci_torch.pipelines.lucas_boundary
import cmtci_torch.pipelines.curvature
import cmtci_torch.pipelines.spectral
import cmtci_torch.pipelines.coupling
import cmtci_torch.pipelines.uniformize_green
import cmtci_torch.pipelines.uniformize_fem
import cmtci_torch.maps.riemann
import cmtci_torch.maps.fem
import cmtci_torch.maps.fem_device
import cmtci_torch.maps.qc
import cmtci_torch.geometry.cardioid
import cmtci_torch.geometry.mesh
import cmtci_torch.geometry.interp
import cmtci_torch.stats.multifractal
import cmtci_torch.stats.symmetry
import cmtci_torch.stats.fields
import cmtci_torch.transport.histogram
import cmtci_torch.geometry.polygon
import cmtci_torch.geometry.alpha_shape
import cmtci_torch.geometry.resample
import cmtci_torch.io.loaders
import cmtci_torch.transport.sinkhorn
import cmtci_torch.transport.procrustes
import cmtci_torch.bench
import cmtci_torch.kernels.fma_peak
import cmtci_torch.kernels.potential
import cmtci_torch.kernels._launch
import cmtci_torch.kernels.argmax_match
import cmtci_torch.kernels.companion
import cmtci_torch.kernels.mandelbrot
import cmtci_torch.stats.variogram
import cmtci_torch.stats.embeddings
import cmtci_torch.stats.pointstats
import cmtci_torch.stats.curvature
import cmtci_torch.stats.spectral
import cmtci_torch.io.plots
import cmtci_torch.kernels.mandelbrot_cuda
import cmtci_torch.kernels._build
import cmtci_torch.cli
import cmtci_torch.parallel.sharded
import cmtci_torch.parallel.distributed
import cmtci_torch.parallel.launch
import cmtci_torch.parallel.dryrun
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


_SMOKE_PROBE = """
import sys
import chip_smoke
import cmtci_torch.kernels.mandelbrot as mb
chip_smoke.orbit_constants()
mb.hypot_band(1e6, True)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "cmtci" or m.startswith("cmtci."))
print("BAD", bad)
assert not bad, bad
"""


def test_chip_smoke_imports_no_jax_and_no_cmtci():
    """chip_smoke.py, which drives the port on the card, imports neither jax
    nor cmtci, nor does the stage1 band it hands orbit_de_stage1."""
    proc = subprocess.run([sys.executable, "-c", _SMOKE_PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
