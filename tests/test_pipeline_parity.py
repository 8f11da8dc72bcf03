"""End-to-end parity: JAX fidelity pipeline vs the native C++ oracle.

This is the framework's equivalent of the reference's only real verification
harness — running the software and accelerated implementations on identical
inputs and comparing outputs (dissertation p.45 §15.3.3). Our bar is stricter:
bit-exact trajectories, not visual map fidelity.
"""

import numpy as np
import pytest

from lidar_slam_tpu import native
from lidar_slam_tpu.config import DEFAULT_CONFIG
from lidar_slam_tpu.models import scan_matcher
from lidar_slam_tpu.utils.metrics import ate, max_abs_err


@pytest.fixture(scope="module")
def oracle_path(small_dataset):
    ranges, _ = small_dataset
    path, omap = native.run_oracle(ranges)
    return ranges, path, omap


def test_host_loop_matches_oracle(oracle_path):
    ranges, cpath, cmap = oracle_path
    jpath, state = scan_matcher.run_host_loop(ranges, DEFAULT_CONFIG)
    assert max_abs_err(jpath, cpath) == 0.0
    assert int(state.pmap.size) == len(cmap)
    # map contents identical up to FMA-contraction ulps (g++ vs XLA emit
    # fused multiply-adds in different places in the transform)
    jmap = np.asarray(state.pmap.xy[: int(state.pmap.size)])
    np.testing.assert_allclose(jmap, cmap, atol=2e-6)


def test_lax_scan_driver_matches_oracle(oracle_path):
    ranges, cpath, _ = oracle_path
    jpath, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG)
    assert max_abs_err(np.asarray(jpath), cpath) == 0.0


def test_oracle_tracks_ground_truth(small_dataset):
    """Sanity: the oracle itself must track the simulator's ground truth."""
    ranges, gt = small_dataset
    path, _ = native.run_oracle(ranges)
    assert ate(path, gt) < 0.08   # fine-matcher quantization is 2.5 cm


def test_naive_edt_oracle_agrees(small_dataset):
    """The O(N^4)-style clamped EDT and the separable one must agree end to end."""
    ranges, _ = small_dataset
    p_fast, _ = native.run_oracle(ranges[:30])
    p_naive, _ = native.run_oracle(ranges[:30], use_naive_edt=True)
    assert max_abs_err(p_fast, p_naive) == 0.0


@pytest.mark.slow
def test_museum_1000_bit_exact():
    """Full-dataset parity pin: x, y AND theta bit-identical over 1000 scans.

    Round 1 could only claim xy (theta forked at a cosf-ulp argmin tie,
    PARITY.md). The determinism work (core/trig32.py shared sin/cos, the
    2^-10 score lattice in ops/edt.quantize_metric, reciprocal-multiply
    rasterization in core/gridmap._rasterize) makes the full pose exact."""
    from lidar_slam_tpu.io import dataset

    ranges, _, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    cpath, _ = native.run_oracle(ranges)
    jpath, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG)
    assert np.array_equal(np.asarray(jpath), cpath)


@pytest.mark.slow
def test_building_3800_bit_exact():
    """The museum-scale hard workload (60x45 m, 3800 scans, 60 m sightlines):
    full-pose bit-exact parity on the enlarged BUILDING_CONFIG grids."""
    from lidar_slam_tpu.config import BUILDING_CONFIG
    from lidar_slam_tpu.io import dataset, simulate

    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    cpath, _ = native.run_oracle_cfg(ranges, BUILDING_CONFIG)
    jpath, _ = scan_matcher.run_scan(ranges, BUILDING_CONFIG)
    assert np.array_equal(np.asarray(jpath), cpath)
    # the single-hypothesis matcher drifts in the 60 m corridor (no loop
    # closure; same on both sides) — pin the regime so quality regressions
    # and accidental improvements both surface
    assert 3.0 < ate(cpath, gt) < 8.0


def test_building_prefix_bit_exact():
    """Quick-tier building parity (200 scans incl. several keyframe rebuilds)."""
    from lidar_slam_tpu.config import BUILDING_CONFIG
    from lidar_slam_tpu.io import dataset, simulate

    ranges, _, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    cpath, _ = native.run_oracle_cfg(ranges[:200], BUILDING_CONFIG)
    jpath, _ = scan_matcher.run_scan(ranges[:200], BUILDING_CONFIG)
    assert np.array_equal(np.asarray(jpath), cpath)


@pytest.mark.slow
def test_building_3800_wide_window_solves_tour():
    """The solved building workload: the +-2 correlative window with the
    center-bias penalty keeps the frontend locked through the corridor turns
    that break the reference's fixed +-1 window (5.3 m ATE above). Swept
    result: ATE 0.092 m, with identical trajectories across backends."""
    from lidar_slam_tpu.config import BUILDING_WIDE_CONFIG
    from lidar_slam_tpu.io import dataset, simulate

    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    jpath, _ = scan_matcher.run_scan(ranges, BUILDING_WIDE_CONFIG)
    assert ate(np.asarray(jpath), gt) < 0.5


def test_building_wide_window_prefix():
    """Quick tier: by scan 1000 (first hard corridor turns) the +-1 parity
    window has already lost ~0.5 m that the wide window tracks through."""
    from lidar_slam_tpu.config import BUILDING_CONFIG, BUILDING_WIDE_CONFIG
    from lidar_slam_tpu.io import dataset, simulate

    n = 1000
    ranges, gt, _ = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, world="building")
    wide, _ = scan_matcher.run_scan(ranges[:n], BUILDING_WIDE_CONFIG)
    narrow, _ = scan_matcher.run_scan(ranges[:n], BUILDING_CONFIG)
    e_wide = ate(np.asarray(wide), gt[:n])
    e_narrow = ate(np.asarray(narrow), gt[:n])
    assert e_wide < 0.2
    assert e_narrow > 2.0 * e_wide
