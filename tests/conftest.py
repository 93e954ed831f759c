"""Shared pytest fixtures.

NOTE: XLA_FLAGS / device count is NOT set here — smoke tests and
benches see the default 1 device.  Multi-device distributed tests run
in subprocesses (tests/test_distributed.py) with their own XLA_FLAGS.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


def run_subprocess_devices(code: str, n_devices: int = 16,
                           timeout: int = 600) -> str:
    """Run python ``code`` in a subprocess with n host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout
