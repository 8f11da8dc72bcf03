"""Test configuration.

Tests run on CPU with 8 virtual devices so sharding/collective paths are
exercised without several GPUs (the reference's analog: verifying the HLS
kernel on a 10x10 sub-map before the real fabric, dissertation p.46 §15.3.4).
Must run before the first ``import jax`` anywhere in the test session.

Tests marked ``gpu`` need a GPU and skip without one; on a GPU machine run
them alone, one process on the card:

    LIDAR_SLAM_GPU_TESTS=1 python -m pytest tests/ -m gpu -p no:xdist
"""

import os

if os.environ.get("LIDAR_SLAM_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute integration runs. Quick tier (<5 min, oracle "
        "parity + kernels + collectives): pytest tests/ -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips without one (LIDAR_SLAM_GPU_TESTS=1 "
        "python -m pytest tests/ -m gpu -p no:xdist)")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided at run time, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; JAX sees " + jax.default_backend())


@pytest.fixture(scope="session")
def small_dataset():
    """A short synthetic dataset shared across tests (80 scans)."""
    from lidar_slam_tpu.io import dataset

    ranges, gt, _ = dataset.ensure_dataset(n_scans=80, seed=3)
    return np.asarray(ranges), np.asarray(gt)
