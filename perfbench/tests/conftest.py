"""Fixtures of the benchmark's CPU tests."""

import pytest

from pbtestlib import write_tiny_checkout


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: requires an NVIDIA GPU and nvcc")


@pytest.fixture
def card():
    """Skips a test without a card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture
def tiny(tmp_path):
    """A checkout of tiny cells in a temporary directory."""
    return write_tiny_checkout(tmp_path)
