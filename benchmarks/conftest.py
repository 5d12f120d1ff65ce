"""pytest settings of the benchmark's own tests (``python -m pytest benchmarks``):
the ``card`` marker for tests that need a CUDA card (such a test decides
inside itself whether a card is there and skips with a reason where none
is), and one intra-op thread a test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
