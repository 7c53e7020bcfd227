"""Test-session device setup.

The sharding suites (``test_sharding.py``, ``test_distributed.py``) need
several devices; on the CPU-only CI runner those are faked with XLA's
host-platform device-count flag.  The flag must land in ``XLA_FLAGS``
BEFORE jax initializes its backends, so it is appended here — conftest
imports before any test module touches jax — and guarded so an explicit
user/CI setting wins.
"""
import os

_FLAG = "--xla_force_host_platform_device_count"

if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_FLAG}=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels have no CPU "
        "mode); skipped where there is none")
