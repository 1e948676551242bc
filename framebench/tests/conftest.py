"""Tests of the benchmark.  Card tests carry the `cuda` marker and skip
inside the `card` fixture where no GPU is present."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the check's readings on "
        "the card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A miniature checkout (tests/tiny.py)."""
    from framebench.tests import tiny
    return tiny.make(str(tmp_path_factory.mktemp("fb")))
