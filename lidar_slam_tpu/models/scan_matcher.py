"""The single-hypothesis scan-to-map SLAM pipeline (fidelity mode).

This is the accelerator re-design of the reference's whole program
(``Subsystem_1/main.c:825-990``): per scan — gate/convert, keyframe-gated
local-map raster + EDT, constant-velocity prediction, two-stage correlative
matching (coarse grid then fine refine), mini-update rule appending novel
points to the map.

Design: the entire step is one fixed-shape pure function ``slam_step`` on a
``SlamState`` pytree. It can be driven two ways:

- ``run_host_loop``: python loop around the jitted step (debugging, streaming
  scans from a live source — the "edge offload" capability of the reference's
  ESP32 variant maps to this host->device feed);
- ``run_scan``: the whole dataset as one ``lax.scan`` on device — zero host
  round trips, the EDT/raster executed under ``lax.cond`` only on keyframe
  steps, exactly like the reference's ``miniUpdated`` gate (main.c:865-872).

Reference quirks reproduced (required for trajectory parity, SURVEY §7.3):
- the scan's world-frame transform is *cached* across steps and is stale at
  map-update time when the step began with ``miniUpdated`` set (the C globals
  ``scan.tx/ty`` are written at main.c:867 with the pre-match pose and reused
  at main.c:944-945);
- the map update indexes the valid-compacted scan by the position of points
  in the *last candidate's* in-bounds compaction (main.c:941-948);
- the first matcher stage runs on the coarse grid only on keyframe steps,
  otherwise on the fine grid (main.c:901-915), and the refine stage always
  runs on the fine grid.
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
from lidar_slam_tpu.ops import edt as edt_ops
from lidar_slam_tpu.ops import matching


class SlamState(NamedTuple):
    pose: jnp.ndarray            # (3,) current pose (path[t-1])
    prev_pose: jnp.ndarray       # (3,) path[t-2] for the constant-velocity prior
    step: jnp.ndarray            # () i32 — scan index of the *next* scan
    mini_updated: jnp.ndarray    # () bool
    pmap: PointMap
    coarse: OccGrid
    fine: OccGrid
    coarse_metric: jnp.ndarray   # (Sc, Sc) f32 EDT likelihood field
    fine_metric: jnp.ndarray     # (Sf, Sf) f32
    scan_wx: jnp.ndarray         # (N,) cached world-frame scan (stale by design)
    scan_wy: jnp.ndarray


def _empty_grid(size: int, pixel: float) -> OccGrid:
    return OccGrid(occ=jnp.zeros((size, size), jnp.bool_),
                   n_rows=jnp.int32(0), n_cols=jnp.int32(0),
                   origin=jnp.zeros(2, jnp.float32), pixel=pixel)


def init_state(ranges0: jnp.ndarray, cfg: SlamConfig,
               pose0=(0.0, 0.0, 0.0)) -> SlamState:
    """Initialise from scan 0 (main.c:842-857): map := scan 0, miniUpdated=1."""
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    scan = sensor.read_scan(jnp.asarray(ranges0), angles, cfg.lidar)
    pose = jnp.asarray(pose0, jnp.float32)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose, cfg.map.map_capacity)
    g = cfg.grid
    return SlamState(
        # distinct buffers (donation rejects the same buffer passed twice)
        pose=pose, prev_pose=pose + 0.0, step=jnp.int32(1),
        mini_updated=jnp.bool_(True), pmap=pmap,
        coarse=_empty_grid(g.coarse_size, g.coarse_pixel),
        fine=_empty_grid(g.fine_size, g.fine_pixel),
        coarse_metric=jnp.zeros((g.coarse_size, g.coarse_size), jnp.float32),
        fine_metric=jnp.zeros((g.fine_size, g.fine_size), jnp.float32),
        scan_wx=wx, scan_wy=wy,
    )


def slam_step(state: SlamState, ranges: jnp.ndarray, cfg: SlamConfig,
              angles: jnp.ndarray) -> tuple[SlamState, jnp.ndarray]:
    """Process one scan; returns (new_state, pose). Pure & fixed-shape."""
    g, m, mc = cfg.grid, cfg.map, cfg.matcher
    scan = sensor.read_scan(ranges, angles, cfg.lidar)

    # --- keyframe-gated map refresh (main.c:865-872) ---
    def refresh(_):
        wx, wy = se2.transform_ref(scan.x, scan.y, state.pose)
        local = gridmap.extract_local_map(state.pmap, wx, wy, scan.valid,
                                          g.border_size)
        coarse, fine = gridmap.rasterize_dual(local, g)
        cm = edt_ops.edt_clamped(coarse.occ, int(g.max_dist_px))
        fm = edt_ops.edt_clamped(fine.occ, int(g.max_dist_px))
        return coarse, fine, cm, fm, wx, wy

    def keep(_):
        return (state.coarse, state.fine, state.coarse_metric,
                state.fine_metric, state.scan_wx, state.scan_wy)

    coarse, fine, coarse_metric, fine_metric, scan_wx, scan_wy = jax.lax.cond(
        state.mini_updated, refresh, keep, None)

    # --- constant-velocity prediction (main.c:875-898) ---
    guess = jnp.where(state.step > 1,
                      state.pose + (state.pose - state.prev_pose),
                      state.pose)

    # --- two-stage correlative matching (main.c:901-918); the search window
    # defaults to the reference's +-1 step, wider windows (matcher.window_t/
    # window_r) turn the same batched scorer into a full correlative search
    wt, wr = int(mc.window_t), int(mc.window_r)
    pen = float(mc.window_penalty_px)

    def match_coarse(_):
        return matching.fast_match(coarse_metric, coarse, scan.x, scan.y,
                                   scan.valid, guess, mc.coarse_t, mc.coarse_r,
                                   wt, wr, pen)

    def match_fine(_):
        return matching.fast_match(fine_metric, fine, scan.x, scan.y,
                                   scan.valid, guess, mc.coarse_t, mc.coarse_r,
                                   wt, wr, pen)

    m1 = jax.lax.cond(state.mini_updated, match_coarse, match_fine, None)
    m2 = matching.fast_match(fine_metric, fine, scan.x, scan.y, scan.valid,
                             m1.pose, mc.fine_t, mc.fine_r, wt, wr, pen)
    new_pose = m2.pose

    # --- mini-update rule (main.c:928-961) ---
    dp = jnp.abs(new_pose - state.pmap.keyframe_pose)
    moved = (dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt) | \
            (dp[2] > m.mini_update_dr)

    def do_update(_):
        # If this step did NOT refresh, the C code re-transforms the scan with
        # the *new* pose (main.c:935-937); otherwise the cached transform from
        # the pre-match pose is (mis)used as-is.
        wx, wy = jax.lax.cond(
            state.mini_updated,
            lambda __: (scan_wx, scan_wy),
            lambda __: se2.transform_ref(scan.x, scan.y, new_pose),
            None)
        n = wx.shape[0]
        j = jnp.arange(n)
        select = (j < m2.best_count) & (m2.last_hits > m.new_point_threshold)
        pmap = gridmap.append_points(state.pmap, wx, wy, select, new_pose)
        return pmap, wx, wy, jnp.bool_(True)

    def no_update(_):
        return state.pmap, scan_wx, scan_wy, jnp.bool_(False)

    pmap, out_wx, out_wy, mini_updated = jax.lax.cond(moved, do_update,
                                                      no_update, None)

    new_state = SlamState(
        pose=new_pose, prev_pose=state.pose, step=state.step + 1,
        mini_updated=mini_updated, pmap=pmap,
        coarse=coarse, fine=fine,
        coarse_metric=coarse_metric, fine_metric=fine_metric,
        scan_wx=out_wx, scan_wy=out_wy,
    )
    return new_state, new_pose


def make_step_fn(cfg: SlamConfig):
    """A jitted (state, ranges) -> (state, pose) step with donated state."""
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, ranges):
        return slam_step(state, ranges, cfg, angles)

    return step


def run_host_loop(ranges_all: np.ndarray, cfg: SlamConfig) -> tuple[np.ndarray, SlamState]:
    """Python-loop driver (debug / streaming). Returns path (T, 3)."""
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
    """Whole-dataset on-device driver: one ``lax.scan``, one dispatch."""
    return _run_scan_jit(jnp.asarray(ranges_all, jnp.float32), cfg)
