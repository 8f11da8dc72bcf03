"""Watchdog supervision: a hang is injected and recovery observed.

The contract under test (utils/watchdog): a worker that wedges mid-run is
killed when its heartbeat goes stale, restarted, and resumes from its
checkpoint — the run completes with at most one chunk of work repeated.
"""

import os
import time

import numpy as np

from lidar_slam_tpu.utils import watchdog


def _flaky_worker(run_dir: str, n_steps: int, hang_at: int) -> None:
    """Counts to n_steps with per-step checkpoints; on the FIRST attempt it
    wedges (sleeps forever, heartbeat silent) at step ``hang_at``."""
    hb = watchdog.Heartbeat(run_dir)
    progress = os.path.join(run_dir, "progress.txt")
    start = 0
    first_attempt = True
    if os.path.exists(progress):
        start = int(open(progress).read())
        first_attempt = False
    hb.beat(start)
    for t in range(start, n_steps):
        if first_attempt and t == hang_at:
            time.sleep(3600)  # the injected wedge: no beat, never returns
        with open(progress + ".tmp", "w") as f:
            f.write(str(t + 1))
        os.replace(progress + ".tmp", progress)
        hb.beat(t + 1)


def test_recovers_from_injected_hang(tmp_path):
    run_dir = str(tmp_path / "run")
    t0 = time.time()
    report = watchdog.run_supervised(
        _flaky_worker, (20, 7), run_dir,
        stall_timeout_s=1.5, max_restarts=1, poll_s=0.1)
    assert report.completed, report
    assert report.attempts == 2          # one restart
    assert report.stalls == 1            # killed by the stale heartbeat
    assert int(open(os.path.join(run_dir, "progress.txt")).read()) == 20
    assert time.time() - t0 < 30         # the 3600 s sleep was cut short


def test_gives_up_after_max_restarts(tmp_path):
    run_dir = str(tmp_path / "always_hangs")
    # hang_at=0 and the progress file never advances -> every attempt wedges
    report = watchdog.run_supervised(
        _always_hang, (), run_dir,
        stall_timeout_s=1.0, max_restarts=1, poll_s=0.1)
    assert not report.completed
    assert report.attempts == 2
    assert report.stalls == 2


def _always_hang(run_dir: str) -> None:
    watchdog.Heartbeat(run_dir).beat(0)
    time.sleep(3600)


def test_supervised_pf_matches_unsupervised(tmp_path):
    """Happy path: the supervised PF run produces the same trajectory as the
    plain host loop (checkpoint plumbing must not perturb the filter)."""
    import dataclasses

    from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu.io import simulate
    from lidar_slam_tpu.models import fastslam

    ranges, _ = simulate.generate_dataset(n_scans=12, seed=0)
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=32))
    path, report = watchdog.run_pf_supervised(
        ranges, cfg, str(tmp_path / "pf"), stall_timeout_s=300.0,
        ckpt_every=5)
    assert report.completed and report.attempts == 1
    want, _ = fastslam.run_pf(ranges, cfg, seed=0)
    np.testing.assert_allclose(path, np.asarray(want), atol=1e-6)


def test_supervisor_stays_off_the_device(tmp_path):
    """The supervising process never initialises a JAX backend while its
    worker runs: on a GPU the first process to touch the card reserves most
    of its memory, and the worker would then fail for want of it."""
    import subprocess
    import sys

    script = f"""
import dataclasses
from jax._src import xla_bridge
from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu.io import simulate
from lidar_slam_tpu.utils import watchdog
ranges, _ = simulate.generate_dataset(n_scans=8, seed=0)
cfg = dataclasses.replace(DEFAULT_CONFIG,
                          particles=ParticleConfig(n_particles=16))
path, report = watchdog.run_pf_supervised(
    ranges, cfg, {str(tmp_path / "run")!r}, stall_timeout_s=300.0)
assert report.completed, report
assert path.shape == (8, 3)
print("PARENT_BACKEND", xla_bridge.backends_are_initialized())
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PARENT_BACKEND False" in out.stdout
