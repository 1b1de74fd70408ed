"""The benchmark tests' marker and card fixture (helpers: bench_util)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from bench_util import small_root  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips where "
        "torch sees none")


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture()
def root(tmp_path):
    return small_root(tmp_path / "bench")
