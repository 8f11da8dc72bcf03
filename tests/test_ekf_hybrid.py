"""Hybrid grid+landmark EKF-FastSLAM (models/ekf_hybrid.py).

The round-4 finding this model closes: the pure landmark filter is
corridor-blind between corner sightings (museum-1000 ATE 0.785 m)
while its grid-PF sibling runs 0.065 m on the same tour.
The hybrid fuses the correlation-volume grid likelihood into the particle
weights; measured full-tour ATE 0.081 m (CPU, P=1024, 2026-08-21)."""

import numpy as np
import pytest

from lidar_slam_tpu.models import ekf_slam
from lidar_slam_tpu.models.ekf_hybrid import run_ekf_hybrid
from lidar_slam_tpu.utils.metrics import ate


def test_hybrid_tracks_short_tour(small_dataset):
    """Quick tier: 80-scan museum prefix at P=128 stays locked."""
    ranges, gt = small_dataset
    cfg = ekf_slam.long_tour_config(128)
    path, final = run_ekf_hybrid(ranges, cfg)
    err = float(ate(np.asarray(path), gt))
    assert err < 0.15, f"hybrid lost track: ATE {err:.3f}"
    # the grid map machinery must actually be engaged (mini-updates ran)
    assert int(np.asarray(final.pmap.size)) > 100
    assert bool(np.asarray(final.fine.occ).any())


@pytest.mark.slow
def test_hybrid_beats_landmark_only_through_room_transition():
    """The corridor/room-transition regime (VERDICT r4 next-round #1): from
    scan ~300 the museum tour crosses a landmark-poor stretch where the
    pure landmark filter starts its steady drift. The hybrid's grid term
    must keep the filter bounded there; the landmark-only filter is the
    control (it may pass 400 scans, but the hybrid must be at least as
    good AND absolutely tight)."""
    from lidar_slam_tpu.io import dataset

    ranges, gt, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    ranges, gt = ranges[:500], gt[:500]
    cfg = ekf_slam.long_tour_config(512)

    path_h, _ = run_ekf_hybrid(ranges, cfg)
    err_h = float(ate(np.asarray(path_h), gt))
    assert err_h < 0.12, f"hybrid ATE {err_h:.3f} through the transition"

    path_l, _ = ekf_slam.run_ekf_slam_scan(
        ranges, cfg, seed=0, max_range=ekf_slam.LONG_TOUR_MAX_RANGE)
    err_l = float(ate(np.asarray(path_l), gt))
    assert err_h < err_l + 0.02, (
        f"hybrid ({err_h:.3f}) must not lose to landmark-only ({err_l:.3f})")
