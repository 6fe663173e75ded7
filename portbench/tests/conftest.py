"""The benchmark's CPU tests: `python -m pytest portbench/tests`. Tests
marked `gpu` need a CUDA card and skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from portbench import harness
    return harness.load_json(harness.ROOT, "BENCHMARK.json")
