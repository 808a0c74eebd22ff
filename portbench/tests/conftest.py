"""Tests of the benchmark.  Tests marked ``card`` need a CUDA device and
skip without one; the decision is made inside the ``card`` fixture."""

import pytest

from portbench.tests import tiny


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The benchmark with every cell cut to ``tiny``'s sizes, in bf16."""
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_root_f32(tmp_path_factory):
    """The same in f32."""
    return tiny.make_root(tmp_path_factory.mktemp("tiny_f32"), tiny.CFG_F32)
