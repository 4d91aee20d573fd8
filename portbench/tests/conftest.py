"""Tests of the benchmark itself: ``python -m pytest portbench/tests`` from
the repository root (on the CPU; tests marked ``card`` skip there and run
on a machine with a CUDA card)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    """The card, decided inside the test: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
