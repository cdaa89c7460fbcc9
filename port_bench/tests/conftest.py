"""Tests of the benchmark harness (port_bench/). They run on the CPU at
small sizes; a test that needs a CUDA card carries the `cuda` marker and
skips, deciding so inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")
