"""Graph-SLAM integration: loop-closure detection + optimization on a loop."""

import numpy as np
import pytest

from lidar_slam_tpu.config import DEFAULT_CONFIG
from lidar_slam_tpu.io import simulate
from lidar_slam_tpu.models import posegraph
from lidar_slam_tpu.models.graph_slam import GraphSlam, LoopClosureConfig
from lidar_slam_tpu.utils.metrics import ate



pytestmark = pytest.mark.slow  # multi-minute integration runs; quick tier: -m "not slow"

# XLA:CPU compiles the vmapped closure match slowly at wide batches
CPU_LC = LoopClosureConfig(closure_batch=2, chunk_size=64)

def test_graph_slam_closes_loops_on_loop_trajectory():
    ranges, gt = simulate.generate_dataset(
        n_scans=300, seed=1, waypoints=simulate.LOOP_WAYPOINTS)
    gs = GraphSlam(DEFAULT_CONFIG, CPU_LC)
    path, opt_kf = gs.run(ranges)

    assert int(gs.kf.count) >= 10
    assert len(gs.closures) >= 1, "no loop closures found on a loop trajectory"
    # closure edges must respect the keyframe gap
    for i, k in gs.closures:
        assert k - i >= gs.lc.min_gap
    # the optimized graph must be consistent (small residual error)
    err = float(posegraph.graph_error(gs.graph))
    n_edges = int(gs.graph.n_edges)
    assert err / max(n_edges, 1) < 1.0, (err, n_edges)
    # frontend still tracks
    assert ate(path, gt) < 0.1


def test_graph_closures_do_not_hurt_building_corridors():
    """Corridor-world regression (round 4): aliased corridor closures used
    to pass the fraction-based ambiguity gate (a 29-cell valley is only
    0.16% of the volume) and drag a 0.04 m frontend to 0.6-9 m. With the
    cell-count + odometry-consistency gates, accepted closures must leave
    the trajectory at frontend quality."""
    from lidar_slam_tpu.config import BUILDING_WIDE_CONFIG
    from lidar_slam_tpu.io import dataset, simulate
    from lidar_slam_tpu.models import scan_matcher

    n = 800
    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    ranges, gt = ranges[:n], gt[:n]
    gs = GraphSlam(BUILDING_WIDE_CONFIG, CPU_LC)
    path, _ = gs.run(ranges)
    fpath, _ = scan_matcher.run_scan(ranges, BUILDING_WIDE_CONFIG)
    g_err = float(ate(np.asarray(path), gt))
    f_err = float(ate(np.asarray(fpath), gt))
    assert len(gs.closures) >= 5, "gates must still accept true closures"
    assert g_err < max(f_err + 0.02, 0.1), (g_err, f_err)


def test_graph_slam_feedback_keeps_tracking():
    """Optimized poses folded back into the live frontend (map rebuild +
    pose re-anchoring) must not destabilize tracking."""
    ranges, gt = simulate.generate_dataset(
        n_scans=300, seed=1, waypoints=simulate.LOOP_WAYPOINTS)
    gs = GraphSlam(DEFAULT_CONFIG, CPU_LC)
    path, _ = gs.run(ranges, feedback=True)
    assert len(gs.closures) >= 1
    assert ate(path, gt) < 0.1
