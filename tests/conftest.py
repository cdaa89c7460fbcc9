"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

jax may already be imported by pytest plugin autoloading before this file
runs (so env vars alone are too late); jax.config.update still works as
long as no backend has been initialized yet. Real-TPU benchmarking happens
in bench.py (which does NOT use this conftest).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compile cache for the CPU test backend — OPT-IN via
# AWSM_JAX_CPU_CACHE=<dir>: cached reloads are bit-identical and turn
# minute-long interpret-mode compiles into seconds, but two full-suite
# runs with the cache enabled segfaulted inside XLA CPU
# backend_compile_and_load on a big FRESH compile ~40 min in (r3; the
# cache-less run only ever ran slow). Use it for chunked per-file dev
# runs, where a crash is isolated and restarts are cheap; leave the
# driver's single-process `pytest tests/` uncached.
if os.environ.get("AWSM_JAX_CPU_CACHE"):
    try:
        jax.config.update("jax_compilation_cache_dir",
                          os.environ["AWSM_JAX_CPU_CACHE"])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (heavy interpret-mode equality tests)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy interpret-mode equality test; deselected by default, "
        "run with --runslow (CI / round verification)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "on a host without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow; use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
