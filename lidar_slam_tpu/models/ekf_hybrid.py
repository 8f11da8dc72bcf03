"""Hybrid grid + landmark EKF-FastSLAM — the corridor-proof config-2 model.

The pure landmark filter (``models/ekf_slam.py``) weights particles on <= 64
corner landmarks; through corridor stretches with no corners the filter is
corridor-blind and drifts (museum-1000 ATE ~0.78 m vs 0.065 m for the grid
PF on the same data). The grid PF (``models/fastslam.py``) has the opposite
blind spot: no persistent per-particle features, so its accuracy rests
entirely on the shared raster.

This model fuses both observation models into one weight:

    log w_p += sum_det loglik_landmark(p, det)  -  avg_edt_dist(p) / temp

The grid term reuses the correlation volume the PF already builds per scan
(``ops/correlative.build_cascade``): one volume build per scan (cost
independent of P), then every particle's grid likelihood is 8 small-table
lookups. The landmark term is the existing (P, L)-batched 2x2 EKF bank.
The shared occupancy map follows the reference's keyframe mini-update rule
(``main.c:928-961``) exactly as the grid PF does.

Shape: everything in the step is (P,)-leading batched arithmetic; the
whole run is one ``lax.scan`` over scans with detections and scan odometry
precomputed in batched pre-passes.

Measured (CPU, 2026-08-21): museum-1000 full tour ATE 0.081 m at P=1024
(landmark-only: 0.785 m) — the grid term carries the filter
through the landmark-poor room transition from scan ~300.

Known regime limit: in the synthetic office CORRIDOR world (long straight
walls, door gaps) the hybrid measures ~2.6-3.1 m where the plain grid PF
holds 0.2 m — door-gap occlusion edges are detected as "corners" whose
world position moves with the robot, and the landmark term then anchors
particles to a feature that drifts with them (the classic veil-point
failure; noise/odometry-source sweeps don't move the number). Use the
grid PF (or graph closures, CORRIDOR_WAYPOINTS' design purpose) for
corridor-dominated environments; the hybrid's home turf is corner-bearing
interiors with landmark-poor stretches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.config import SlamConfig
from lidar_slam_tpu.core import gridmap, se2, sensor
from lidar_slam_tpu.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu.models import scan_matcher
from lidar_slam_tpu.models.ekf_slam import (EkfSlamConfig, EkfSlamState,
                                            ekf_slam_step_ml, init_ekf_slam)
from lidar_slam_tpu.ops import correlative
from lidar_slam_tpu.ops import edt as edt_ops
from lidar_slam_tpu.ops import matching


class HybridState(NamedTuple):
    ekf: EkfSlamState          # particle poses + landmark banks
    pmap: PointMap             # shared world-frame point map
    fine: OccGrid              # fine raster of the local map
    fine_metric: jnp.ndarray   # (Sf, Sf) clamped-EDT likelihood field
    step: jnp.ndarray          # () i32
    mini_updated: jnp.ndarray  # () bool


def init_hybrid(ranges0: jnp.ndarray, ekf_cfg: EkfSlamConfig,
                cfg: SlamConfig, seed: int = 0) -> HybridState:
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    scan = sensor.read_scan(jnp.asarray(ranges0), angles, cfg.lidar)
    pose = jnp.zeros(3, jnp.float32)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose,
                                  cfg.map.map_capacity)
    g = cfg.grid
    return HybridState(
        ekf=init_ekf_slam(ekf_cfg, seed),
        pmap=pmap,
        fine=scan_matcher._empty_grid(g.fine_size, g.fine_pixel),
        fine_metric=jnp.zeros((g.fine_size, g.fine_size), jnp.float32),
        step=jnp.int32(1), mini_updated=jnp.bool_(True))


def hybrid_step(state: HybridState, ranges: jnp.ndarray, obs: jnp.ndarray,
                obs_valid: jnp.ndarray, odo: jnp.ndarray,
                ekf_cfg: EkfSlamConfig, cfg: SlamConfig,
                angles: jnp.ndarray) -> tuple[HybridState, jnp.ndarray]:
    """One hybrid step. Returns (state, estimated pose).

    obs (M, 2) range/bearing corner detections for this scan; odo (3,) the
    scan-odometry delta (reference convention)."""
    pc, g, m, mc = cfg.particles, cfg.grid, cfg.map, cfg.matcher
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- correlation volume(s) around the odometry-predicted mean pose.
    # Weighted mean, matching the pose estimate convention below.
    w0 = jax.nn.softmax(state.ekf.logw)
    mean_pose = jnp.sum(w0[:, None] * state.ekf.poses, axis=0)
    c, s = jnp.cos(mean_pose[2]), jnp.sin(mean_pose[2])
    base = jnp.stack([mean_pose[0] + c * odo[0] + s * odo[1],
                      mean_pose[1] - s * odo[0] + c * odo[1],
                      mean_pose[2] + odo[2]])
    vols = correlative.build_cascade(
        state.fine_metric, state.fine, scan.x, scan.y, scan.valid, base,
        n_theta=pc.vol_theta_bins, theta_step=mc.fine_r, half=pc.vol_half,
        levels=pc.cascade_levels)

    def grid_loglik(poses):
        d, _ = correlative.lookup_cascade(vols, poses)
        return -d / pc.score_temperature

    ekf2, _ = ekf_slam_step_ml(state.ekf, obs, obs_valid, ekf_cfg, odo=odo,
                               aux_loglik_fn=grid_loglik)

    # --- pose estimate: weighted mean + interpolated hill-climb refinement
    # on the volume (the PF's estimator, fastslam.pf_step).
    w_norm = jax.nn.softmax(ekf2.logw)
    est_pose = jnp.sum(w_norm[:, None] * ekf2.poses, axis=0)
    steps = jnp.asarray([mc.fine_t, mc.fine_t, mc.fine_r], jnp.float32)
    offs = jnp.stack(jnp.meshgrid(*([jnp.asarray([-1.0, 0.0, 1.0])] * 3),
                                  indexing="ij"), axis=-1).reshape(27, 3)

    def refine(est, _):
        cands = est[None, :] + offs * steps[None, :]
        d, _ = correlative.lookup_cascade(vols, cands)
        return cands[jnp.argmin(d)], None

    est_pose, _ = jax.lax.scan(refine, est_pose, None, length=3)

    # --- keyframe mini-update of the shared map (reference rule)
    dp = jnp.abs(est_pose - state.pmap.keyframe_pose)
    moved = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
             | (dp[2] > m.mini_update_dr) | (state.step == 1))

    def refresh(_):
        wx, wy = se2.transform_ref(scan.x, scan.y, est_pose)
        sc, hits, inb1 = matching.score_candidates(
            state.fine_metric, state.fine, scan.x, scan.y, scan.valid,
            est_pose[None])
        novel = (hits[0] > m.new_point_threshold) & inb1[0]
        novel = jnp.where(state.step == 1, scan.valid, novel)
        pmap = gridmap.append_points(state.pmap, wx, wy, novel, est_pose)
        local = gridmap.extract_local_map(pmap, wx, wy, scan.valid,
                                          g.border_size)
        _, fine = gridmap.rasterize_dual(local, g)
        fm = edt_ops.edt_clamped(fine.occ, int(g.max_dist_px))
        return pmap, fine, fm, jnp.bool_(True)

    def keep(_):
        return state.pmap, state.fine, state.fine_metric, jnp.bool_(False)

    pmap, fine, fine_metric, mini_updated = jax.lax.cond(
        moved, refresh, keep, None)

    return HybridState(ekf=ekf2, pmap=pmap, fine=fine,
                       fine_metric=fine_metric, step=state.step + 1,
                       mini_updated=mini_updated), est_pose


@functools.partial(jax.jit, static_argnames=("ekf_cfg", "cfg", "seed"))
def _run_hybrid_jit(ranges_all, obs_all, valid_all, odo_all,
                    ekf_cfg: EkfSlamConfig, cfg: SlamConfig, seed: int):
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    state = init_hybrid(ranges_all[0], ekf_cfg, cfg, seed)

    def body(st, inp):
        r, z, v, o = inp
        return hybrid_step(st, r, z, v, o, ekf_cfg, cfg, angles)

    final, path = jax.lax.scan(
        body, state, (ranges_all[1:], obs_all, valid_all, odo_all))
    return jnp.concatenate([jnp.zeros((1, 3), jnp.float32), path]), final


def run_ekf_hybrid(ranges_all: np.ndarray, ekf_cfg: EkfSlamConfig,
                   cfg: SlamConfig | None = None, seed: int = 0,
                   max_range: float = 12.0, **extract_kw):
    """Whole-sequence hybrid run: raw (T, 1079) ranges -> (path, final state).

    Detections and scan odometry are computed in batched pre-passes (all
    T-1 pair matches in parallel), then the sequential filter runs as one
    on-device ``lax.scan``."""
    from lidar_slam_tpu.config import DEFAULT_CONFIG
    from lidar_slam_tpu.core.sensor import beam_angles
    from lidar_slam_tpu.ops import landmarks as lm_ops
    from lidar_slam_tpu.ops.scan_odometry import pairwise_odometry

    cfg = cfg or DEFAULT_CONFIG
    angles = jnp.asarray(beam_angles(cfg.lidar))
    ranges_j = jnp.asarray(ranges_all, jnp.float32)
    fn = lambda r: lm_ops.extract_corners(
        r, angles, range_min=cfg.lidar.range_min,
        usable_range=cfg.lidar.usable_range, max_range=max_range,
        **extract_kw)
    det = jax.jit(jax.vmap(fn))(ranges_j)
    odo_all = pairwise_odometry(ranges_j, angles, cfg.lidar)
    return _run_hybrid_jit(ranges_j, det.rb[1:], det.valid[1:], odo_all,
                           ekf_cfg, cfg, seed)
