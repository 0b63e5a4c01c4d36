"""Tests of the benchmark (``python3 -m pytest benchmark/tests``).  They run
on the CPU at tiny sizes; the card's tests are marked ``cuda`` and skip
where there is no card, decided in the ``cuda_device`` fixture."""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the chip")
    return torch.device("cuda", 0)
