"""Correlative scan matching over the EDT likelihood field.

Capability parity with ``FastMatch``/``FastMatch2`` (main.c:381-809): score a
set of candidate poses by projecting the (pixel-scaled) scan into the grid and
summing the EDT values under the points; the *minimum*-score pose wins.

Reference behaviors reproduced exactly (they shape the trajectory, SURVEY §3.2):
- rotation uses the transposed convention (S_x = px*ct + py*st,
  S_y = -px*st + py*ct; main.c:462-463);
- cells snap via roundf (round half away from zero) then +1 (main.c:483,501);
- out-of-bounds points (Sx<=1 | Sy<=1 | Sx>=nCols | Sy>=nRows) are silently
  dropped from the score (main.c:512);
- the candidate set is fixed at entry (theta/tx/ty = pose +- step, computed
  once, main.c:424-426) and the hill-climb loop therefore reduces to a single
  argmin over the 27 candidates, first-minimum-wins under strict ``<``
  (main.c:549) in loop order theta-major, then tx, then ty;
- ``bestHits``: the compacted in-bounds EDT values of the *last evaluated*
  candidate (the buffer is overwritten during scoring of every candidate,
  main.c:515), while ``bestHits_size`` is the in-bounds count of the best
  candidate — the mismatch the reference's map update depends on.

Design: all candidates are scored in one batched gather
(``vmap``-free — pure broadcasting), so the same code scales from the
reference's 27 candidates to full correlative windows and to thousands of
particles via an extra leading axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lidar_slam_tpu.core.gridmap import OccGrid, roundf_like


class MatchResult(NamedTuple):
    pose: jnp.ndarray        # (3,) best candidate pose
    score: jnp.ndarray       # () best score
    best_count: jnp.ndarray  # () i32 — in-bounds count of the best candidate
    last_hits: jnp.ndarray   # (N,) EDT values of the LAST candidate (compacted, padded 0)
    last_inb: jnp.ndarray    # (N,) bool — in-bounds&valid mask of the last candidate


def candidate_grid_ref(pose: jnp.ndarray, step_t: float, step_r: float,
                       window_t: int = 1, window_r: int = 1) -> jnp.ndarray:
    """The candidate set, in the reference's loop order.

    Order: theta-major, then tx, then ty (main.c:443-487). With the default
    +-1 windows each axis takes (v - step, v, v + step) — exactly the
    reference's fixed 27-candidate set; wider windows generalize the same
    grid to a full correlative search ((2*window_r+1) x (2*window_t+1)^2
    candidates), which the batched scorer handles with no code change.
    """
    offs_t = jnp.arange(-window_t, window_t + 1, dtype=jnp.float32)
    offs_r = jnp.arange(-window_r, window_r + 1, dtype=jnp.float32)
    nr, nt = offs_r.shape[0], offs_t.shape[0]
    thetas = pose[2] + offs_r * step_r
    txs = pose[0] + offs_t * step_t
    tys = pose[1] + offs_t * step_t
    th = jnp.repeat(thetas, nt * nt)
    tx = jnp.tile(jnp.repeat(txs, nt), nr)
    ty = jnp.tile(tys, nr * nt)
    return jnp.stack([tx, ty, th], axis=-1)  # (nr*nt*nt, 3)


def project_scan(scan_x: jnp.ndarray, scan_y: jnp.ndarray,
                 poses: jnp.ndarray, grid: OccGrid):
    """Project the sensor-frame scan into grid cells for each candidate pose.

    Returns integer cell coords (C, N) in the reference's 1-based convention
    (Sx, Sy) plus the float intermediate, reproducing main.c:417-503.
    """
    from lidar_slam_tpu.core.trig32 import sincos32

    ipixel = jnp.float32(1.0 / grid.pixel)
    px = scan_x * ipixel  # (N,)
    py = scan_y * ipixel
    st, ct = sincos32(poses[:, 2:3])  # (C,1) — oracle-identical trig
    sx = px[None, :] * ct + py[None, :] * st       # (C, N)
    sy = -px[None, :] * st + py[None, :] * ct
    offx = (poses[:, 0:1] - grid.origin[0]) * ipixel
    offy = (poses[:, 1:2] - grid.origin[1]) * ipixel
    cell_x = roundf_like(sx + offx).astype(jnp.int32) + 1
    cell_y = roundf_like(sy + offy).astype(jnp.int32) + 1
    return cell_x, cell_y


def score_candidates(metric: jnp.ndarray, grid: OccGrid,
                     scan_x: jnp.ndarray, scan_y: jnp.ndarray,
                     valid: jnp.ndarray, poses: jnp.ndarray):
    """Score every candidate pose. Returns (scores (C,), hits (C,N), inb (C,N)).

    hits are the gathered EDT values (0 where out of bounds / invalid).
    """
    cell_x, cell_y = project_scan(scan_x, scan_y, poses, grid)
    inb = ((cell_x > 1) & (cell_y > 1)
           & (cell_x < grid.n_cols) & (cell_y < grid.n_rows)
           & valid[None, :])
    iy = jnp.clip(cell_y - 1, 0, metric.shape[0] - 1)
    ix = jnp.clip(cell_x - 1, 0, metric.shape[1] - 1)
    vals = metric[iy, ix]                      # (C, N) gather
    hits = jnp.where(inb, vals, 0.0)
    scores = jnp.sum(hits, axis=1)
    return scores, hits, inb


def fast_match(metric: jnp.ndarray, grid: OccGrid,
               scan_x: jnp.ndarray, scan_y: jnp.ndarray, valid: jnp.ndarray,
               pose: jnp.ndarray, step_t: float, step_r: float,
               window_t: int = 1, window_r: int = 1,
               window_penalty_px: float = 1.0) -> MatchResult:
    """One FastMatch call: argmin over the candidate window (27 at default).

    jnp.argmin returns the first minimum, matching the strict-< first-wins
    update order of the C loop.

    With windows wider than the reference's +-1, distant candidates pay a
    center-bias penalty of ``window_penalty_px`` (summed EDT px) per step of
    L1 offset beyond the inner 3x3x3. Two reasons: (a) corridor aliasing —
    translation along a featureless corridor scores almost flat, and an
    unpenalized far candidate that wins by a fraction of a pixel yanks the
    pose by multiple steps; (b) determinism — near-tie argmin flips between
    *distant* poses amplify one-ulp backend differences into meters of
    trajectory divergence (observed across backends on building-3800). A genuinely
    better far candidate (e.g. during a fast turn, where +-2 theta wins by
    hundreds of px) clears the penalty trivially. window=1 is untouched —
    bit-exact reference parity.
    """
    poses = candidate_grid_ref(pose, step_t, step_r, window_t, window_r)
    scores, hits, inb = score_candidates(metric, grid, scan_x, scan_y, valid, poses)
    if window_t > 1 or window_r > 1:
        ot = jnp.abs(jnp.arange(-window_t, window_t + 1, dtype=jnp.float32))
        orr = jnp.abs(jnp.arange(-window_r, window_r + 1, dtype=jnp.float32))
        excess = (jnp.maximum(orr - 1.0, 0.0)[:, None, None]
                  + jnp.maximum(ot - 1.0, 0.0)[None, :, None]
                  + jnp.maximum(ot - 1.0, 0.0)[None, None, :]).reshape(-1)
        scores = scores + jnp.float32(window_penalty_px) * excess
    best = jnp.argmin(scores)
    counts = jnp.sum(inb, axis=1).astype(jnp.int32)
    # Compact the last candidate's hits the way the C buffer ends up
    # (values packed in beam order of its in-bounds points).
    last_hits_raw = hits[-1]
    last_inb = inb[-1]
    n = last_hits_raw.shape[0]
    pos = jnp.where(last_inb, jnp.cumsum(last_inb) - 1, n)
    last_hits = jnp.zeros(n, jnp.float32).at[pos].set(last_hits_raw, mode="drop")
    return MatchResult(pose=poses[best], score=scores[best],
                       best_count=counts[best], last_hits=last_hits,
                       last_inb=last_inb)
