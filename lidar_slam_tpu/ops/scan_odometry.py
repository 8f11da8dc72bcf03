"""Batched scan-to-scan odometry: every consecutive pair matched in parallel.

The scan-driven EKF-FastSLAM (models/ekf_slam.py) has no odometry input —
the reference's dataset is ranges-only (Subsystem_1/main.c:64 reads nothing
but ranges) — and a constant-velocity proposal alone caps accuracy at the
random-walk level: through the museum tour's landmark-poor stretches (60+
consecutive scans with only 1-2 corner detections in view) the filter is
under-constrained and a 1e-5-level input perturbation forks the trajectory
by meters.

This module supplies the missing motion prior in batch form: relative
poses between consecutive scans are INDEPENDENT given the raw log, so all
T-1 pair matches run as one batched pre-pass before the sequential filter —
a vmapped raster + separable EDT + iterative 27-candidate descent per pair,
chunked with ``lax.map`` to bound memory. No sequential dependence, no
host loop; the filter's ``lax.scan`` then consumes the (T-1, 3) deltas.

The per-pair matcher is the reference's own FastMatch descent
(ops/matching.fast_match, main.c:443-487's candidate walk) run scan-vs-scan
instead of scan-vs-map: scan t-1 is rastered around the sensor, clamp-EDT'd,
and scan t is matched into it starting from identity with halving steps.
The returned delta is the relative pose in the reference's transposed-
rotation convention — it composes with ``ekf_slam._compose_ref`` exactly
(W_t = W_{t-1} o delta).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.core import sensor
from lidar_slam_tpu.core.gridmap import OccGrid, roundf_like
from lidar_slam_tpu.ops import edt as edt_ops
from lidar_slam_tpu.ops import matching


def _raster_centered(x: jnp.ndarray, y: jnp.ndarray, valid: jnp.ndarray,
                     pixel: float, size: int) -> OccGrid:
    """Raster sensor-frame points into a fixed grid centered on the sensor."""
    ipixel = jnp.float32(np.float32(1.0) / np.float32(pixel))
    origin = jnp.full((2,), np.float32(-0.5 * size * pixel), jnp.float32)
    col = roundf_like((x - origin[0]) * ipixel).astype(jnp.int32)
    row = roundf_like((y - origin[1]) * ipixel).astype(jnp.int32)
    # invalid AND out-of-extent points route to the drop slot: a negative
    # index would WRAP to the opposite edge (jnp .at[] semantics) and write
    # phantom occupancy, so in-bounds is part of the routing condition
    keep = valid & (row >= 0) & (row < size) & (col >= 0) & (col < size)
    row = jnp.where(keep, row, size)        # routed out -> mode="drop"
    col = jnp.where(keep, col, size)
    occ = jnp.zeros((size, size), jnp.bool_).at[row, col].set(True, mode="drop")
    return OccGrid(occ=occ, n_rows=jnp.int32(size), n_cols=jnp.int32(size),
                   origin=origin, pixel=pixel)


def _match_pair(r_prev: jnp.ndarray, r_cur: jnp.ndarray, guess: jnp.ndarray,
                angles: jnp.ndarray, lidar_cfg, max_range: float,
                pixel: float, size: int, iters: int, step_t0: float,
                step_r0: float) -> jnp.ndarray:
    s0 = sensor.read_scan(r_prev, angles, lidar_cfg)
    s1 = sensor.read_scan(r_cur, angles, lidar_cfg)
    mr2 = jnp.float32(max_range * max_range)
    v0 = s0.valid & (s0.x * s0.x + s0.y * s0.y <= mr2)
    v1 = s1.valid & (s1.x * s1.x + s1.y * s1.y <= mr2)
    grid = _raster_centered(s0.x, s0.y, v0, pixel, size)
    metric = edt_ops.edt_clamped(grid.occ)   # separable jnp form: vmaps clean
    pose = guess
    st, sr = step_t0, step_r0
    # halving descent: cumulative reach +-2*step0 per axis around the guess
    # covers the per-scan motion envelope (museum: |dxy| <= 0.035 m,
    # |dth| <= 0.045 rad from identity)
    for _ in range(iters):
        pose = matching.fast_match(metric, grid, s1.x, s1.y, v1, pose,
                                   st, sr).pose
        st, sr = st * 0.5, sr * 0.5
    return pose


@functools.partial(
    jax.jit, static_argnames=("lidar_cfg", "max_range", "pixel", "size",
                              "iters", "step_t0", "step_r0", "chunk"))
def pairwise_odometry(ranges_all: jnp.ndarray, angles: jnp.ndarray,
                      lidar_cfg, *, max_range: float = 10.0,
                      pixel: float = 0.05, size: int = 448, iters: int = 7,
                      step_t0: float = 0.03, step_r0: float = 0.03,
                      chunk: int = 50) -> jnp.ndarray:
    """Relative poses for all consecutive pairs of ``ranges_all`` (T, N).

    Returns (T-1, 3): row t-1 is the delta from scan t-1 to scan t in the
    reference convention. Chunked ``lax.map`` over a vmapped matcher keeps
    peak memory at chunk * size^2 floats regardless of T.

    Noise character (measured, museum straights): along a featureless
    corridor the per-pair score is a flat valley in the travel direction,
    so that component jitters by ~+-0.025 m — but INDEPENDENTLY per pair
    (each descent starts from identity). A velocity-seeded second pass was
    tried and REJECTED: seeding pair t from pair t-1's estimate correlates
    consecutive errors, and a correlated walk integrates ~2x worse than
    white jitter (dead-reckoning ATE 0.76 -> 1.44 m on museum-400).
    Consumers should model the noise instead: the EKF's proposal noise for
    this odometry must be ~the corridor jitter, not the rotation-axis
    accuracy (see ekf_slam.long_tour_config)."""
    if max_range >= 0.5 * size * pixel:
        raise ValueError(
            f"max_range={max_range} m reaches beyond the centered raster's "
            f"half-extent {0.5 * size * pixel:.2f} m (size={size}, "
            f"pixel={pixel}); widen the grid or lower max_range")
    t = ranges_all.shape[0]
    n_pairs = t - 1
    n_chunks = -(-n_pairs // chunk)
    pad = n_chunks * chunk - n_pairs
    shp = ranges_all.shape[1:]
    prev = jnp.concatenate([ranges_all[:-1],
                            jnp.ones((pad,) + shp, ranges_all.dtype)])
    cur = jnp.concatenate([ranges_all[1:],
                           jnp.ones((pad,) + shp, ranges_all.dtype)])
    prev = prev.reshape((n_chunks, chunk) + shp)
    cur = cur.reshape((n_chunks, chunk) + shp)

    def run_pass(guesses, it, st, sr):
        fn = functools.partial(_match_pair, angles=angles,
                               lidar_cfg=lidar_cfg, max_range=max_range,
                               pixel=pixel, size=size, iters=it,
                               step_t0=st, step_r0=sr)
        out = jax.lax.map(
            lambda pcg: jax.vmap(fn)(pcg[0], pcg[1], pcg[2]),
            (prev, cur, guesses.reshape(n_chunks, chunk, 3)))
        return out.reshape(n_chunks * chunk, 3)

    zeros = jnp.zeros((n_chunks * chunk, 3), jnp.float32)
    deltas = run_pass(zeros, iters, step_t0, step_r0)
    return deltas[:n_pairs]


def reach_clip_fraction(deltas: np.ndarray, step_t0: float = 0.03,
                        step_r0: float = 0.03) -> float:
    """Fraction of pair deltas that landed on the descent's reach boundary.

    The halving descent's cumulative reach is ~+-2*step0 per axis; a delta at
    >= 95% of that bound almost certainly means the true per-scan motion
    exceeded the envelope and was silently clipped (a biased motion prior).
    Host-side diagnostic — callers should warn when this is non-negligible."""
    deltas = np.asarray(deltas)
    if deltas.size == 0:
        return 0.0
    near_t = np.abs(deltas[:, :2]).max(axis=1) >= 1.9 * step_t0
    near_r = np.abs(deltas[:, 2]) >= 1.9 * step_r0
    return float(np.mean(near_t | near_r))
