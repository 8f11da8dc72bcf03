"""The graph backend's dispatch shape comes from LoopClosureConfig alone.

``closure_batch`` sets the vmapped width of the keyframe-raster, closure
match and refinement programs; ``chunk_size`` sets the frontend's scan
length per on-device chunk. Neither depends on the backend.
"""

import numpy as np

from lidar_slam_tpu.config import DEFAULT_CONFIG
from lidar_slam_tpu.models import graph_slam
from lidar_slam_tpu.models.graph_slam import GraphSlam, LoopClosureConfig


def test_config_fields_reach_the_compiled_programs(small_dataset,
                                                   monkeypatch):
    ranges, _ = small_dataset
    ranges = ranges[:34]                   # 33 steps -> chunks of 16, 16, 1
    widths = []
    real = graph_slam._raster_edt_batch

    def spy(x, y, valid, size, pixel):
        widths.append(x.shape[0])
        return real(x, y, valid, size, pixel)

    monkeypatch.setattr(graph_slam, "_raster_edt_batch", spy)
    lc = LoopClosureConfig(closure_batch=3, chunk_size=16)
    gs = GraphSlam(DEFAULT_CONFIG, lc)
    path, _ = gs.run(ranges)
    assert path.shape == (34, 3) and np.isfinite(path).all()
    assert widths and set(widths) == {3}
    assert gs.timer.counts["frontend_chunk"] == 3


def test_defaults_are_backend_independent():
    from lidar_slam_tpu.models.pf_graph_slam import PFGraphSlam

    lc = LoopClosureConfig()
    assert (lc.closure_batch, lc.chunk_size) == (8, 256)
    # the PF-graph cadence is an accuracy optimum, not a dispatch choice
    pf = PFGraphSlam(DEFAULT_CONFIG)
    assert pf.lc.chunk_size == 128 and pf.lc.weak_closures
