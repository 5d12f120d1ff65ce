"""The import guard: a run loads no module of the JAX side, compared by
whole top-level names, and the plain references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks.harness import guard

BENCH = Path(__file__).resolve().parents[1]


def test_names_are_compared_whole():
    assert guard.forbidden_modules(["cmtci_torch", "cmtci_torch.kernels", "jaxtyping",
                                    "cmtcix", "numpy"]) == []
    assert guard.forbidden_modules(["cmtci.pipelines", "jax", "jaxlib.xla", "flax.linen",
                                    "cmtci_torch"]) == ["cmtci", "flax", "jax", "jaxlib"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_either_package(path):
    assert not _imports(path) & {"cmtci_torch", "cmtci", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_the_jax_side(path):
    assert not _imports(path) & set(guard.FORBIDDEN)


def test_a_run_loads_no_jax_module():
    """A tiny pair-statistics job and its check in a fresh interpreter, then
    the guard on that interpreter's sys.modules."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "torch.set_num_threads(1)\n"
        "from benchmarks.harness import cell, guard\n"
        "from benchmarks.tests import tiny\n"
        "wl, cfg = tiny.pairstats_cell()\n"
        "res = cell.run_cell(tiny.PAIRSTATS, 5, 0.1, False, tiny.CPU, workload=wl, config=cfg)\n"
        "assert res['correct'], res['checks']\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
