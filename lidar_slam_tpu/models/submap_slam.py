"""Submap SLAM driver: the scan-to-map pipeline over a tiled submap atlas.

Same per-scan structure as ``models/scan_matcher.py`` (the accelerator re-design of
``Subsystem_1/main.c:825-990``) but the global point map is a
``core.submap.SubmapAtlas`` instead of the reference's single 20k-point
buffer: the matcher's local map is gathered from the K nearest submaps, novel
points are inserted into the *active* submap in its anchor frame, and a new
submap is spawned when the robot leaves the active anchor's neighborhood or
the submap fills. Loop-closure corrections re-anchor submaps rigidly
(``apply_anchor_correction``) — no point rewrites.

The step stays one fixed-shape pure function: it jits, scans, and shards
exactly like the flat-map pipeline. Spawning is a ``lax.cond``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.config import SlamConfig
from lidar_slam_tpu.core import gridmap, se2, sensor, submap
from lidar_slam_tpu.core.gridmap import OccGrid
from lidar_slam_tpu.core.submap import SubmapAtlas
from lidar_slam_tpu.ops import edt as edt_ops
from lidar_slam_tpu.ops import matching


class SubmapSlamState(NamedTuple):
    pose: jnp.ndarray
    prev_pose: jnp.ndarray
    step: jnp.ndarray
    mini_updated: jnp.ndarray
    keyframe_pose: jnp.ndarray   # last map-update pose (mini-update rule)
    atlas: SubmapAtlas
    coarse: OccGrid
    fine: OccGrid
    coarse_metric: jnp.ndarray
    fine_metric: jnp.ndarray
    scan_wx: jnp.ndarray
    scan_wy: jnp.ndarray


def _empty_grid(size: int, pixel: float) -> OccGrid:
    return OccGrid(occ=jnp.zeros((size, size), jnp.bool_),
                   n_rows=jnp.int32(0), n_cols=jnp.int32(0),
                   origin=jnp.zeros(2, jnp.float32), pixel=pixel)


def init_state(ranges0: jnp.ndarray, cfg: SlamConfig,
               pose0=(0.0, 0.0, 0.0)) -> SubmapSlamState:
    """Atlas := one submap anchored at pose0 holding scan 0."""
    sm = cfg.submaps
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    scan = sensor.read_scan(jnp.asarray(ranges0), angles, cfg.lidar)
    pose = jnp.asarray(pose0, jnp.float32)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    atlas = submap.empty_atlas(sm.n_submaps, sm.submap_capacity)
    atlas = submap.start_submap(atlas, pose)
    atlas = submap.insert_world_points(atlas, wx, wy, scan.valid)
    g = cfg.grid
    return SubmapSlamState(
        pose=pose, prev_pose=pose + 0.0, step=jnp.int32(1),
        mini_updated=jnp.bool_(True), keyframe_pose=pose + 0.0,
        atlas=atlas,
        coarse=_empty_grid(g.coarse_size, g.coarse_pixel),
        fine=_empty_grid(g.fine_size, g.fine_pixel),
        coarse_metric=jnp.zeros((g.coarse_size, g.coarse_size), jnp.float32),
        fine_metric=jnp.zeros((g.fine_size, g.fine_size), jnp.float32),
        scan_wx=wx, scan_wy=wy,
    )


def slam_step(state: SubmapSlamState, ranges: jnp.ndarray, cfg: SlamConfig,
              angles: jnp.ndarray) -> tuple[SubmapSlamState, jnp.ndarray]:
    """One scan; same structure as scan_matcher.slam_step, atlas-backed."""
    g, m, mc, sm = cfg.grid, cfg.map, cfg.matcher, cfg.submaps
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    def refresh(_):
        wx, wy = se2.transform_ref(scan.x, scan.y, state.pose)
        local = submap.extract_local_from_atlas(
            state.atlas, state.pose, wx, wy, scan.valid,
            g.border_size, sm.k_nearest)
        coarse, fine = gridmap.rasterize_dual(local, g)
        cm = edt_ops.edt_clamped(coarse.occ, int(g.max_dist_px))
        fm = edt_ops.edt_clamped(fine.occ, int(g.max_dist_px))
        return coarse, fine, cm, fm, wx, wy

    def keep(_):
        return (state.coarse, state.fine, state.coarse_metric,
                state.fine_metric, state.scan_wx, state.scan_wy)

    coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy = jax.lax.cond(
        state.mini_updated, refresh, keep, None)

    guess = jnp.where(state.step > 1,
                      state.pose + (state.pose - state.prev_pose),
                      state.pose)

    def match_coarse(_):
        return matching.fast_match(coarse_metric, coarse, scan.x, scan.y,
                                   scan.valid, guess, mc.coarse_t, mc.coarse_r)

    def match_fine(_):
        return matching.fast_match(fine_metric, fine, scan.x, scan.y,
                                   scan.valid, guess, mc.coarse_t, mc.coarse_r)

    m1 = jax.lax.cond(state.mini_updated, match_coarse, match_fine, None)
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1.pose, mc.fine_t, mc.fine_r)
    new_pose = m2.pose

    dp = jnp.abs(new_pose - state.keyframe_pose)
    moved = (dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt) | \
            (dp[2] > m.mini_update_dr)

    def do_update(_):
        wx, wy = jax.lax.cond(
            state.mini_updated,
            lambda __: (scan_wx, scan_wy),
            lambda __: se2.transform_ref(scan.x, scan.y, new_pose),
            None)
        n = wx.shape[0]
        j = jnp.arange(n)
        select = (j < m2.best_count) & (m2.last_hits > m.new_point_threshold)

        # spawn-then-insert: if the robot left the active anchor's
        # neighborhood or the submap is (nearly) full, novel points open a
        # fresh submap anchored at the current pose
        atlas = state.atlas
        anchor = atlas.anchors[atlas.active]
        far = jnp.hypot(new_pose[0] - anchor[0], new_pose[1] - anchor[1]) \
            > sm.spawn_dist
        full = atlas.sizes[atlas.active] \
            >= jnp.int32(sm.spawn_fill_frac * sm.submap_capacity)
        atlas = jax.lax.cond(far | full,
                             lambda a: submap.start_submap(a, new_pose),
                             lambda a: a, atlas)
        atlas = submap.insert_world_points(atlas, wx, wy, select)
        return atlas, wx, wy, jnp.bool_(True), new_pose

    def no_update(_):
        return state.atlas, scan_wx, scan_wy, jnp.bool_(False), \
            state.keyframe_pose

    atlas, out_wx, out_wy, mini_updated, kf_pose = jax.lax.cond(
        moved, do_update, no_update, None)

    new_state = SubmapSlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=mini_updated, keyframe_pose=kf_pose, atlas=atlas,
        coarse=coarse, fine=fine,
        coarse_metric=coarse_metric, fine_metric=fine_metric,
        scan_wx=out_wx, scan_wy=out_wy,
    )
    return new_state, new_pose


def make_step_fn(cfg: SlamConfig):
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, ranges):
        return slam_step(state, ranges, cfg, angles)

    return step


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig):
    step = make_step_fn(cfg)
    state = init_state(jnp.asarray(ranges_all[0]), cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges_all.shape[0]):
        state, pose = step(state, jnp.asarray(ranges_all[t]))
        poses.append(np.asarray(pose))
    return np.stack(poses), state


@functools.partial(jax.jit, static_argnames=("cfg",))
def _run_scan_jit(ranges_all: jnp.ndarray, cfg: SlamConfig):
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    state = init_state(ranges_all[0], cfg)

    def body(st, ranges):
        return slam_step(st, ranges, cfg, angles)

    final, path = jax.lax.scan(body, state, ranges_all[1:])
    path = jnp.concatenate([state.pose[None], path], axis=0)
    return path, final


def run_scan(ranges_all: np.ndarray, cfg: SlamConfig):
    """Whole-dataset on-device driver (one lax.scan dispatch)."""
    return _run_scan_jit(jnp.asarray(ranges_all, jnp.float32), cfg)
