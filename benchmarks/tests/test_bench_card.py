"""The control at each cell's own size on the card: on three seeds the
program's job is judged correct and the control (the reference one
precision step below the configuration's) not, by the harness's check. Runs on a machine
with a CUDA card: ``python -m pytest benchmarks -m card``."""

import pytest
import torch

from benchmarks import control
from benchmarks.harness import files

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in files.spec()["workloads"]])
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for x in control.readings(cell, SEEDS, torch.device("cuda", 0)):
        assert x["correct"] == (x["side"] == "program"), x
