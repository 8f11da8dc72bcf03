"""PF frontend + pose-graph closure feedback (models/pf_graph_slam.py)."""

import dataclasses

import numpy as np
import pytest

from lidar_slam_tpu.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu.models.pf_graph_slam import _np_correct_cloud, run_pf_graph
from lidar_slam_tpu.utils.metrics import ate


def test_correct_cloud_identity_and_shift():
    rng = np.random.default_rng(0)
    poses = rng.normal(0, 1, (32, 3)).astype(np.float32)
    a = np.asarray([0.3, -0.2, 0.4], np.float32)
    # re-anchoring to the same anchor is the identity
    np.testing.assert_allclose(_np_correct_cloud(poses, a, a), poses,
                               atol=1e-5)
    # anchor moved by a pure translation: every pose translates identically
    b = a + np.asarray([1.0, -2.0, 0.0], np.float32)
    got = _np_correct_cloud(poses, a, b)
    np.testing.assert_allclose(got[:, :2], poses[:, :2] + [1.0, -2.0],
                               atol=1e-5)
    np.testing.assert_allclose(got[:, 2], poses[:, 2], atol=1e-6)
    # relative offsets between particles are preserved under any rigid move
    c = np.asarray([-0.5, 0.8, 1.1], np.float32)
    got2 = _np_correct_cloud(poses, a, c)
    d_before = np.hypot(*(poses[:1, :2] - poses[:, :2]).T)
    d_after = np.hypot(*(got2[:1, :2] - got2[:, :2]).T)
    np.testing.assert_allclose(d_after, d_before, atol=1e-4)


@pytest.mark.slow
def test_pf_graph_closes_loop_and_tracks():
    """Loop tour: closures must fire and feedback must not break tracking."""
    from lidar_slam_tpu.io import simulate

    n = 300
    ranges, gt = simulate.generate_dataset(n_scans=n, seed=0,
                                           waypoints=simulate.LOOP_WAYPOINTS)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=256))
    from lidar_slam_tpu.models.graph_slam import LoopClosureConfig

    lc = LoopClosureConfig(weak_closures=True, closure_batch=2,
                           chunk_size=64)
    path, opt, gs = run_pf_graph(ranges, cfg, lc)
    assert len(gs.closures) >= 1, "no closures on a loop trajectory"
    err = float(ate(np.asarray(path), gt[: len(path)]))
    assert err < 0.15, f"PF-graph lost track: ATE {err:.3f}"
    # graph-smoothed output must be at least as good as the online path
    sm = gs.smoothed_path(np.asarray(path))
    err_s = float(ate(sm, gt[: len(path)]))
    assert err_s < err + 0.03, (err_s, err)
