"""Set-up of the benchmark's CPU tests: the benchmark's folder and the
port on the path, the ``cuda`` marker, and one intra-op thread a test."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run small models in real time, and
    the test runner's workers share the machine's cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
