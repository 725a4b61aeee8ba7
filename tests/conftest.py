import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration tests (dry-run subprocess, trained "
        "system parity, full-engine A/B); the tier-1 fast subset is "
        '`-m "not slow"` — see scripts/check.sh')
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips on a machine without one")
