"""Particle-filter frontend + pose-graph closure feedback.

The grid PF (``models/fastslam.py``) shares one occupancy map rebuilt from
the estimated pose; a single mis-registered keyframe poisons the map for
every particle, and a filter without loop closure cannot undo it (observed:
one lower-corridor mis-registration on building-3800 costs 0.7 m ATE while
the single-hypothesis wide frontend runs the same tour at 0.09 m — inverting
the point of carrying 1024 hypotheses).

This model closes that loop: the PF runs as the frontend inside the
``GraphSlam`` orchestrator (keyframes, gated loop-closure matching, damped-GN
pose-graph optimization — ``models/graph_slam.py``), and every accepted
closure feeds back into the particle cloud: all particle poses are rigidly
re-anchored by the optimized correction, the shared point map is rebuilt
from the keyframe scans at their optimized poses, and the likelihood raster
is recomputed — so the map corruption is *undone* rather than carried.

The feedback transform is the same anchor rewrite the single-hypothesis
backend uses (pose' = opt_k (+) (old_k (-) pose)), applied to the whole
(P, 3) cloud in one vectorized host pass; relative weights are preserved
(a rigid re-anchoring moves every hypothesis identically).

Accuracy envelope on building-3800 (ATE 0.31 m at the committed config) —
diagnosed, round 5, with per-scan error vectors and closure topology:

- The residual is NOT one bad keyframe: optimized-keyframe error grows
  smoothly 0.1 -> 0.68 m over the t=1100-2300 stretch and decays back by
  t=3700. That stretch is a no-revisit excursion — the tour only re-joins
  previously-seen geometry at t~3491, so no loop closure CAN anchor its
  middle; its accuracy is bounded by frontend drift, which for the cloud
  estimate is proposal noise integrating along each corridor's flat
  likelihood axis (sigma_xy=0.01 over ~1200 scans walks 0.3-0.5 m; the
  error vector tracks the travel direction).
- Every attempt to cut that drift broke the t~2000 corner (a 71-degree,
  1.1 deg/scan turn) worse than the drift it saved, all measured at
  seed 0 / chunk 128: exact-snap polish of the estimate (wt=wr=2:
  0.50 m — heading error injected at the turn; wr=1: 0.86 m), an embedded
  wide-matcher tracker with cloud rescue (1.40 m), halved static sigmas
  (1.93 m, corner cut), turn-rate-inflated sigmas (theta-only: 5.1 m —
  inflation overflows the +-1.5 deg volume window and breaks weighting;
  xy+theta: 0.67 m), straightaway-attenuated sigmas (all-axis: 2.32 m,
  xy-only: 0.59 m — the velocity-based turn signal lags corner entry and
  the filter under-rotates, locking in 2-8 deg of heading error). The
  committed config is the measured optimum of this family; pushing below
  it needs a frontend whose corner tracking does not ride on cloud
  diversity (per-particle maps, or an odometry sensor prior).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.config import SlamConfig
from lidar_slam_tpu.core import gridmap, se2
from lidar_slam_tpu.models import fastslam
from lidar_slam_tpu.models.graph_slam import (GraphSlam, LoopClosureConfig,
                                              _np_transform_ref)
from lidar_slam_tpu.ops import edt as edt_ops


class _PFFrontend:
    """Adapter giving ``fastslam`` the module surface GraphSlam expects."""

    def __init__(self, seed: int = 0):
        self._seed = seed

    def init_state(self, ranges0, cfg: SlamConfig):
        return fastslam.init_particles(ranges0, cfg, self._seed)

    @staticmethod
    def slam_step(state, ranges, cfg, angles):
        return fastslam.pf_step(state, ranges, cfg, angles)


def _np_correct_cloud(poses: np.ndarray, old_last: np.ndarray,
                      new_last: np.ndarray) -> np.ndarray:
    """Re-anchor (P, 3) reference-convention poses from old_last to new_last:
    pose' = new_last (+) (old_last (-) pose), vectorized host numpy."""
    ct, st = np.cos(old_last[2], dtype=np.float32), np.sin(old_last[2],
                                                           dtype=np.float32)
    dx = poses[:, 0] - old_last[0]
    dy = poses[:, 1] - old_last[1]
    zx = ct * dx - st * dy
    zy = st * dx + ct * dy
    zt = poses[:, 2] - old_last[2]
    ct2, st2 = np.cos(new_last[2], dtype=np.float32), np.sin(
        new_last[2], dtype=np.float32)
    return np.stack([new_last[0] + ct2 * zx + st2 * zy,
                     new_last[1] - st2 * zx + ct2 * zy,
                     new_last[2] + zt], axis=1).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reraster(pmap, kf_x, kf_y, kf_valid, kf_pose, cfg: SlamConfig):
    """Fine raster + clamped EDT of the rebuilt map around a keyframe pose
    (one dispatch — the cloud must not score against the stale field for
    even one step after a feedback rewrite)."""
    wx, wy = se2.transform_ref(kf_x, kf_y, kf_pose)
    local = gridmap.extract_local_map(pmap, wx, wy, kf_valid,
                                      cfg.grid.border_size)
    _, fine = gridmap.rasterize_dual(local, cfg.grid)
    fm = edt_ops.edt_clamped(fine.occ, int(cfg.grid.max_dist_px))
    return fine, fm


class PFGraphSlam(GraphSlam):
    """GraphSlam with the 1024-hypothesis grid PF as frontend.

    Weak (recovery-tier) closures are ON by default here: the PF's shared
    map can mis-register whole stretches, and the sharp-but-high-score
    weak anchors are what lets the graph pull a bent cluster back
    (building-3800: 0.94 -> 0.45 m ATE measured; the same tier is OFF for
    tracking frontends, where it only adds noise — graph_slam.py).

    The default chunk is 128 scans (vs the tracking frontends' 256):
    halving the chunk doubles the closure/feedback cadence, so a
    mis-registration gets corrected sooner — measured on building-3800: ATE
    0.31 at chunk 128 vs 0.45 at 256 (chunk 64 measured 0.76 — the
    mis-registration magnitude itself is chaotic in chunk size, so this is a
    measured optimum, not a monotone knob)."""

    def __init__(self, cfg: SlamConfig,
                 lc: LoopClosureConfig | None = None,
                 max_keyframes: int = 512, seed: int = 0):
        if lc is None:
            lc = LoopClosureConfig(weak_closures=True, chunk_size=128)
        super().__init__(cfg, lc, max_keyframes)
        self.frontend = _PFFrontend(seed)

    def _rebuild_frontend(self, state: fastslam.ParticleState):
        # one packed fetch of everything the rewrite needs
        p = state.poses.shape[0]
        fb = np.asarray(jnp.concatenate(
            [state.poses, state.prev_poses,
             jnp.tile(state.pmap.keyframe_pose, (1, 1))], axis=0))
        poses, prev_poses = fb[:p], fb[p:2 * p]
        old_last = fb[2 * p]
        new_last = np.asarray(self.kf_poses[-1], np.float32)

        poses_c = _np_correct_cloud(poses, old_last, new_last)
        prev_c = _np_correct_cloud(prev_poses, old_last, new_last)

        # rebuild the shared point map from keyframe scans at optimized poses
        k = self._kf_count
        kposes = np.stack(self.kf_poses)
        wx, wy = _np_transform_ref(self._kf_x[:k], self._kf_y[:k], kposes)
        v = self._kf_valid[:k]
        allpts = np.stack([wx[v], wy[v]], axis=1)
        cap = state.pmap.xy.shape[0]
        if len(allpts) > cap:
            allpts = allpts[:: int(np.ceil(len(allpts) / cap))][:cap]
        xy = np.zeros((cap, 2), np.float32)
        xy[: len(allpts)] = allpts

        pmap = state.pmap._replace(
            xy=jnp.asarray(xy), size=jnp.int32(len(allpts)),
            keyframe_pose=jnp.asarray(new_last))
        fine, fm = _reraster(pmap, jnp.asarray(self._kf_x[k - 1]),
                             jnp.asarray(self._kf_y[k - 1]),
                             jnp.asarray(self._kf_valid[k - 1]),
                             jnp.asarray(new_last), self.cfg)
        return state._replace(
            poses=jnp.asarray(poses_c), prev_poses=jnp.asarray(prev_c),
            pmap=pmap, fine=fine, fine_metric=fm,
            mini_updated=jnp.bool_(True))


def run_pf_graph(ranges_all: np.ndarray, cfg: SlamConfig,
                 lc: LoopClosureConfig | None = None,
                 max_keyframes: int = 512, seed: int = 0):
    """PF-frontend graph SLAM over a whole dataset.

    Returns (path (T, 3), optimized keyframe poses, the PFGraphSlam
    instance — ``.closures`` carries the accepted loop closures)."""
    gs = PFGraphSlam(cfg, lc, max_keyframes, seed)
    path, opt = gs.run(ranges_all)
    return path, opt, gs
