"""Grid-based Rao-Blackwellized particle filter (FastSLAM-style).

The reference is a single-hypothesis matcher (SURVEY §0: no particle filter in
its code); the particle layer is the north-star extension from BASELINE.json
("1k particles, vmapped per-particle updates + batched importance weighting").

Design decisions:
- Particles are a leading batch axis, nothing else. Propagation, (optional)
  per-particle gradient refinement, and importance weighting are pure
  broadcasted tensor ops — trilinear lookups into one correlation volume of
  the EDT likelihood field (ops/correlative.py), no per-particle control
  flow.
- The occupancy/likelihood grid is *shared* (rebuilt from the best particle on
  keyframe steps, same mini-update rule as the reference, main.c:928-961);
  per-particle landmark EKF maps live in ``models/ekf_slam.py``.
- Systematic resampling is branchless: indices are always computed, and an
  ESS test selects between resampled and identity index vectors — jit- and
  shard_map-friendly (the distributed version swaps the local cumsum for a
  psum/all_gather; see ``parallel/resampling.py``).
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
from lidar_slam_tpu.ops import correlative
from lidar_slam_tpu.ops import edt as edt_ops
from lidar_slam_tpu.ops import matching


class ParticleState(NamedTuple):
    poses: jnp.ndarray       # (P, 3)
    prev_poses: jnp.ndarray  # (P, 3) — per-particle constant-velocity memory
    logw: jnp.ndarray        # (P,) log importance weights (normalized-ish)
    step: jnp.ndarray        # () i32
    mini_updated: jnp.ndarray  # () bool
    pmap: PointMap
    fine: OccGrid
    fine_metric: jnp.ndarray   # (Sf, Sf) f32
    rng: jnp.ndarray           # PRNG key carried in-state (on-device loop)
    clamp_frac: jnp.ndarray    # () f32 — fraction of particles that escaped
                               # the fine scoring window this step (diagnostic)


def init_particles(ranges0: jnp.ndarray, cfg: SlamConfig, seed: int = 0,
                   pose0=(0.0, 0.0, 0.0)) -> ParticleState:
    p = cfg.particles.n_particles
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    scan = sensor.read_scan(jnp.asarray(ranges0), angles, cfg.lidar)
    pose = jnp.asarray(pose0, jnp.float32)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose, cfg.map.map_capacity)
    g = cfg.grid
    return ParticleState(
        poses=jnp.tile(pose, (p, 1)),
        prev_poses=jnp.tile(pose, (p, 1)) + 0.0,
        logw=jnp.zeros(p, jnp.float32),
        step=jnp.int32(1), mini_updated=jnp.bool_(True), pmap=pmap,
        fine=scan_matcher._empty_grid(g.fine_size, g.fine_pixel),
        fine_metric=jnp.zeros((g.fine_size, g.fine_size), jnp.float32),
        rng=jax.random.PRNGKey(seed),
        clamp_frac=jnp.float32(0.0),
    )


def systematic_resample(key: jnp.ndarray, logw: jnp.ndarray) -> jnp.ndarray:
    """Systematic (low-variance) resampling. Returns ancestor indices (P,).

    The inverse-CDF lookup is a compare-count (idx_i = #{j : c_j < u_i},
    identical to ``searchsorted(c, u, side='left')``) — a (P, P) compare +
    row-sum: one fused elementwise pass instead of ~log2(P) dependent
    gather rounds of a binary search."""
    p = logw.shape[0]
    w = jax.nn.softmax(logw)
    c = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / p)
    u = u0 + jnp.arange(p, dtype=jnp.float32) / p
    idx = jnp.sum((c[None, :] < u[:, None]).astype(jnp.int32), axis=1)
    return jnp.clip(idx, 0, p - 1)


def effective_sample_size(logw: jnp.ndarray) -> jnp.ndarray:
    w = jax.nn.softmax(logw)
    return 1.0 / jnp.sum(w * w)


def pf_step(state: ParticleState, ranges: jnp.ndarray, cfg: SlamConfig,
            angles: jnp.ndarray, edt_fn=None) -> tuple[ParticleState, jnp.ndarray]:
    """One particle-filter step. Returns (state, best_pose).

    ``edt_fn(occ, max_dist)`` overrides the EDT implementation — the sharded
    pipeline passes the map-axis halo-exchange transform here
    (parallel/sharded_edt.py) so the likelihood field computes across the
    mesh's 'map' dimension."""
    if edt_fn is None:
        edt_fn = edt_ops.edt_clamped
    pc, g, m, mc = cfg.particles, cfg.grid, cfg.map, cfg.matcher
    p = pc.n_particles
    scan = sensor.read_scan(ranges, angles, cfg.lidar)
    key, k_noise, k_resample = jax.random.split(state.rng, 3)

    # --- propagate: per-particle constant velocity + Gaussian proposal noise
    vel = state.poses - state.prev_poses
    noise = jax.random.normal(k_noise, (p, 3)) * jnp.asarray(
        [pc.sigma_xy, pc.sigma_xy, pc.sigma_theta], jnp.float32)
    prop = state.poses + vel + noise

    # --- correlation volume(s) around the predicted mean pose: all particle
    # scoring collapses to trilinear lookups (cost independent of P). With
    # cascade_levels > 1, coarser volumes (2x, 4x pixels; same bin counts)
    # catch particles that escape the fine window — the multi-resolution
    # correlative trick — instead of silently clamping them to its edge.
    base = jnp.mean(prop, axis=0)
    vols = correlative.build_cascade(
        state.fine_metric, state.fine, scan.x, scan.y, scan.valid, base,
        n_theta=pc.vol_theta_bins, theta_step=mc.fine_r, half=pc.vol_half,
        levels=pc.cascade_levels)
    vol = vols[0]
    # --- gradient-guided proposal refinement (cf. FastSLAM 2.0 / the
    # gradient-guided PF literature): the trilinear volume is differentiable,
    # so each particle descends the interpolated distance field a few capped
    # steps before weighting. Vmapped value-and-grad = a handful of
    # small-table lookups per particle.
    if pc.grad_refine_steps > 0:
        caps = jnp.asarray([pc.grad_step_xy, pc.grad_step_xy,
                            pc.grad_step_theta], jnp.float32)

        def dist_of(pose):
            return correlative.lookup_avg_distance(vol, pose[None])[0]

        grad_fn = jax.vmap(jax.grad(dist_of))

        def descend(poses_c, _):
            g = grad_fn(poses_c)                               # (P, 3)
            delta = jnp.clip(-0.01 * g, -caps, caps)
            return poses_c + delta, None

        prop, _ = jax.lax.scan(descend, prop, None,
                               length=pc.grad_refine_steps)

    avg_dist, fine_escape = correlative.lookup_cascade(vols, prop)  # (P,)
    clamp_frac = jnp.mean(fine_escape.astype(jnp.float32))
    new_poses = prop

    # --- importance weighting: average EDT distance under the pose -> logw
    logw = state.logw - avg_dist / pc.score_temperature

    # --- resample (branchless ESS gate)
    ess = effective_sample_size(logw)
    idx_resampled = systematic_resample(k_resample, logw)
    do_resample = ess < pc.resample_threshold * p
    idx = jnp.where(do_resample, idx_resampled, jnp.arange(p, dtype=jnp.int32))
    resampled_poses = new_poses[idx]
    prev_for_vel = jnp.where(do_resample, state.poses[idx], state.poses)
    logw = jnp.where(do_resample, jnp.zeros_like(logw), logw)
    logw = logw - jnp.max(logw)  # keep numerics bounded

    # --- pose estimate: weighted mean + interpolated hill-climb refinement
    # (the reference's two-stage FastMatch, main.c:901-918, re-expressed as
    # three fixed argmin iterations over the continuous volume).
    w_norm = jax.nn.softmax(logw)
    est_pose = jnp.sum(w_norm[:, None] * resampled_poses, axis=0)
    steps = jnp.asarray([mc.fine_t, mc.fine_t, mc.fine_r], jnp.float32)
    offs = jnp.stack(jnp.meshgrid(*([jnp.asarray([-1.0, 0.0, 1.0])] * 3),
                                  indexing="ij"), axis=-1).reshape(27, 3)

    def refine(est, _):
        cands = est[None, :] + offs * steps[None, :]
        d, _ = correlative.lookup_cascade(vols, cands)
        return cands[jnp.argmin(d)], None

    est_pose, _ = jax.lax.scan(refine, est_pose, None, length=3)
    dp = jnp.abs(est_pose - state.pmap.keyframe_pose)
    moved = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
             | (dp[2] > m.mini_update_dr) | (state.step == 1))

    def refresh(_):
        wx, wy = se2.transform_ref(scan.x, scan.y, est_pose)
        # novel-surface test against the current field (reference: bestHits
        # > 1.5 px, main.c:943): append points that land far from surfaces.
        sc, hits, inb1 = matching.score_candidates(
            state.fine_metric, state.fine, scan.x, scan.y, scan.valid,
            est_pose[None])
        novel = (hits[0] > m.new_point_threshold) & inb1[0]
        # on the very first update the field is empty: seed from all valid
        novel = jnp.where(state.step == 1, scan.valid, novel)
        pmap = gridmap.append_points(state.pmap, wx, wy, novel, est_pose)
        local = gridmap.extract_local_map(pmap, wx, wy, scan.valid, g.border_size)
        _, fine = gridmap.rasterize_dual(local, g)
        fm = edt_fn(fine.occ, int(g.max_dist_px))
        return pmap, fine, fm, jnp.bool_(True)

    def keep(_):
        return state.pmap, state.fine, state.fine_metric, jnp.bool_(False)

    pmap, fine, fine_metric, mini_updated = jax.lax.cond(moved, refresh, keep, None)

    new_state = ParticleState(
        poses=resampled_poses, prev_poses=prev_for_vel, logw=logw,
        step=state.step + 1, mini_updated=mini_updated, pmap=pmap,
        fine=fine, fine_metric=fine_metric, rng=key, clamp_frac=clamp_frac,
    )
    return new_state, est_pose


def make_pf_step(cfg: SlamConfig):
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, ranges):
        return pf_step(state, ranges, cfg, angles)

    return step


@functools.partial(jax.jit, static_argnames=("cfg", "seed"))
def _run_pf_jit(ranges_all: jnp.ndarray, cfg: SlamConfig, seed: int):
    angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
    state = init_particles(ranges_all[0], cfg, seed)

    def body(st, ranges):
        return pf_step(st, ranges, cfg, angles)

    final, path = jax.lax.scan(body, state, ranges_all[1:])
    path = jnp.concatenate([jnp.zeros((1, 3), jnp.float32), path], axis=0)
    return path, final


def run_pf(ranges_all: np.ndarray, cfg: SlamConfig, seed: int = 0):
    """Whole-dataset particle-filter run as one on-device lax.scan."""
    return _run_pf_jit(jnp.asarray(ranges_all, jnp.float32), cfg, seed)
