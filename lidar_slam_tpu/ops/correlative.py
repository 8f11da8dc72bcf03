"""Correlation-volume scan scoring.

Problem: weighting P particles (x 27 candidates) against the EDT likelihood
field directly is a (P*27*N)-point gather whose cost grows with the particle
count.

Design: all particles cluster around the predicted pose, so every lookup hits
the field within a few pixels of a shared base projection. We therefore:

1. project the scan once per theta-bin around the base pose (T bins, step =
   the fine matcher resolution);
2. gather, for every beam, the (W, W) window of the field centered at its
   base cell, and sum the windows over beams into a score volume
   C[t, dy, dx] (plus an in-bounds count volume) — C is exactly "score of
   the scan shifted by (dy, dx) cells at theta-bin t";
3. score any continuous candidate pose by *trilinear interpolation* into C.
   Interpolation commutes with the per-beam sum, so this equals per-beam
   bilinear field sampling — smoother than the reference's roundf cell
   snapping (main.c:483-501) and with a usable gradient, at O(T*N*W^2)
   cost independent of particle count.

The field values sit on the 2^-10 lattice (``edt.quantize_metric``), so the
f32 per-beam sums are exact in any summation order: the volume is identical
on every backend.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_tpu.core.gridmap import OccGrid, roundf_like

HIGHEST = jax.lax.Precision.HIGHEST


class ScoreVolume(NamedTuple):
    scores: jnp.ndarray     # (T, W, W) f32 — sum of field values per offset
    counts: jnp.ndarray     # (T, W, W) f32 — in-bounds beam count per offset
    base_pose: jnp.ndarray  # (3,) pose the volume is centered on
    theta_step: float       # static
    ipixel: jnp.ndarray     # () f32 (traced — grid.pixel is a state leaf)
    half: int               # static — W = 2*half + 1


def base_cells(grid: OccGrid, scan_x: jnp.ndarray, scan_y: jnp.ndarray,
               base_pose: jnp.ndarray, n_theta: int, theta_step: float
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """0-based (T, N) column/row cells of every beam at every theta bin."""
    t_half = n_theta // 2
    ipixel = jnp.float32(1.0 / grid.pixel)
    thetas = base_pose[2] + (jnp.arange(n_theta, dtype=jnp.float32) - t_half) * theta_step
    ct = jnp.cos(thetas)[:, None]            # (T, 1)
    st = jnp.sin(thetas)[:, None]
    px = scan_x * ipixel                     # (N,)
    py = scan_y * ipixel
    # reference-convention rotation (main.c:462-463)
    rx = px[None, :] * ct + py[None, :] * st          # (T, N)
    ry = -px[None, :] * st + py[None, :] * ct
    offx = (base_pose[0] - grid.origin[0]) * ipixel
    offy = (base_pose[1] - grid.origin[1]) * ipixel
    # base cells, 0-based into the fixed array (ref 1-based minus 1)
    cx0 = roundf_like(rx + offx).astype(jnp.int32)
    cy0 = roundf_like(ry + offy).astype(jnp.int32)
    return cx0, cy0


def _window_masks(grid: OccGrid, cx0, cy0, valid, half: int):
    """(T, N, W) row/col in-bounds masks (reference bounds test, main.c:512:
    0-based cell in [1, n-2]); invalid beams zero their row mask."""
    offs = jnp.arange(2 * half + 1) - half
    row_idx = cy0[..., None] + offs
    col_idx = cx0[..., None] + offs
    row_ok = ((row_idx >= 1) & (row_idx < grid.n_rows - 1)
              & valid[None, :, None])
    col_ok = (col_idx >= 1) & (col_idx < grid.n_cols - 1)
    return row_idx, col_idx, row_ok, col_ok


def build_score_volume(metric: jnp.ndarray, grid: OccGrid,
                       scan_x: jnp.ndarray, scan_y: jnp.ndarray,
                       valid: jnp.ndarray, base_pose: jnp.ndarray,
                       n_theta: int = 9, theta_step: float = 0.004363,
                       half: int = 8) -> ScoreVolume:
    """Build the (n_theta, W, W) correlation volume around ``base_pose``."""
    s = metric.shape[0]
    cx0, cy0 = base_cells(grid, scan_x, scan_y, base_pose, n_theta,
                          theta_step)
    row_idx, col_idx, row_ok, col_ok = _window_masks(grid, cx0, cy0, valid,
                                                     half)
    # per-beam (W, W) window of the field, masked and summed over beams
    patches = metric[jnp.clip(row_idx, 0, s - 1)[..., :, None],
                     jnp.clip(col_idx, 0, s - 1)[..., None, :]]  # (T,N,W,W)
    inb = row_ok[..., :, None] & col_ok[..., None, :]
    scores = jnp.sum(jnp.where(inb, patches, 0.0), axis=1)
    # counts separate into row and column conditions:
    # counts[t, dy, dx] = sum_n row_ok[t, n, dy] * col_ok[t, n, dx]
    counts = jnp.einsum("tnr,tnc->trc", row_ok.astype(jnp.float32),
                        col_ok.astype(jnp.float32), precision=HIGHEST)
    return ScoreVolume(scores=scores, counts=counts,
                       base_pose=base_pose, theta_step=float(theta_step),
                       ipixel=jnp.float32(1.0 / grid.pixel), half=half)


def downsample_metric(metric: jnp.ndarray, grid: OccGrid, factor: int
                      ) -> tuple[jnp.ndarray, OccGrid]:
    """Min-pool the EDT field by ``factor`` for coarse cascade levels.

    Distances are rescaled into coarse-pixel units (divide by factor); min
    over the block is the conservative pooling for a distance field (never
    overestimates how far a pose is from surfaces). The origin shifts by
    (factor-1)/2 fine pixels so coarse cell centers sit at block centers.
    """
    s = metric.shape[0]
    assert s % factor == 0, (s, factor)
    m2 = metric.reshape(s // factor, factor, s // factor, factor)
    m2 = jnp.min(jnp.min(m2, axis=3), axis=1) / factor
    ceil = lambda v: (v + factor - 1) // factor
    grid2 = OccGrid(
        occ=grid.occ[::factor, ::factor],  # unused by scoring; keep shapes sane
        n_rows=ceil(grid.n_rows), n_cols=ceil(grid.n_cols),
        origin=grid.origin + 0.5 * (factor - 1) * grid.pixel,
        pixel=grid.pixel * factor)
    return m2, grid2


def build_cascade(metric: jnp.ndarray, grid: OccGrid,
                  scan_x: jnp.ndarray, scan_y: jnp.ndarray,
                  valid: jnp.ndarray, base_pose: jnp.ndarray,
                  n_theta: int, theta_step: float, half: int,
                  levels: int) -> list[ScoreVolume]:
    """Score volumes at pixel scales 1x, 2x, 4x, ... around ``base_pose``.

    Level l covers +-(half * 2^l) fine pixels and +-(n_theta//2 * 2^l) theta
    steps — the classic multi-resolution correlative trick (Olson 2009): the
    coarse levels catch particles (or a kidnapped cloud) that escaped the
    fine window, at a fraction of the fine level's cost (the field shrinks
    4x per level).
    """
    vols = [build_score_volume(metric, grid, scan_x, scan_y, valid, base_pose,
                               n_theta=n_theta, theta_step=theta_step,
                               half=half)]
    for lvl in range(1, levels):
        f = 2 ** lvl
        m2, g2 = downsample_metric(metric, grid, f)
        vols.append(build_score_volume(
            m2, g2, scan_x, scan_y, valid, base_pose,
            n_theta=n_theta, theta_step=theta_step * f, half=half))
    return vols


def _window_inside(vol: ScoreVolume, poses: jnp.ndarray) -> jnp.ndarray:
    """True where a pose lies inside the volume's interpolation window."""
    t = vol.scores.shape[0]
    half = vol.half
    fdx = (poses[..., 0] - vol.base_pose[0]) * vol.ipixel + half
    fdy = (poses[..., 1] - vol.base_pose[1]) * vol.ipixel + half
    fdt = (poses[..., 2] - vol.base_pose[2]) / vol.theta_step + t // 2
    w = 2 * half
    return ((fdx >= 0) & (fdx <= w) & (fdy >= 0) & (fdy <= w)
            & (fdt >= 0) & (fdt <= t - 1))


def lookup_cascade(vols: list[ScoreVolume], poses: jnp.ndarray
                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Average distance (fine-pixel units) via the finest containing level.

    Returns (dist (...,), fine_escape (...) bool). Poses outside every level
    clamp to the coarsest volume's edge (the pre-cascade behavior, now only
    reachable beyond +-half * 2^(L-1) fine pixels). Distances from level l
    are multiplied by 2^l so scores are comparable across levels.
    """
    dist = None
    chosen = None
    fine_escape = None
    for lvl, vol in enumerate(vols):
        d = lookup_avg_distance(vol, poses) * (2.0 ** lvl)
        inside = _window_inside(vol, poses)
        if dist is None:
            dist, chosen, fine_escape = d, inside, ~inside
        else:
            # not-yet-chosen poses provisionally take this level's value
            # (clamped if outside); the coarsest level's clamp is the floor.
            dist = jnp.where(chosen, dist, d)
            chosen = chosen | inside
    return dist, fine_escape


def lookup_avg_distance(vol: ScoreVolume, poses: jnp.ndarray) -> jnp.ndarray:
    """Average field distance for candidate poses (..., 3) via trilinear
    interpolation into the volume. Out-of-window poses clamp to the edge.

    The 8 corner lookups are one weighted one-hot contraction against the
    flattened (score, count) table; at HIGHEST precision it is exact in f32
    (every dot row has <= 8 nonzero products), preserving the
    ratio-of-interpolants semantics.
    """
    t, w, _ = vol.scores.shape
    half = vol.half
    t_half = t // 2

    fdx = (poses[..., 0] - vol.base_pose[0]) * vol.ipixel + half
    fdy = (poses[..., 1] - vol.base_pose[1]) * vol.ipixel + half
    fdt = (poses[..., 2] - vol.base_pose[2]) / vol.theta_step + t_half

    t0 = jnp.floor(fdt).astype(jnp.int32)
    y0 = jnp.floor(fdy).astype(jnp.int32)
    x0 = jnp.floor(fdx).astype(jnp.int32)
    at_ = fdt - t0
    ay = fdy - y0
    ax = fdx - x0

    tww = t * w * w
    table = jnp.stack([vol.scores.reshape(tww), vol.counts.reshape(tww)],
                      axis=1)                                   # (TWW, 2)
    lane = jnp.arange(tww)
    acc = jnp.zeros(poses.shape[:-1] + (tww,), jnp.float32)
    for dt_ in (0, 1):
        for dy_ in (0, 1):
            for dx_ in (0, 1):
                wgt = ((at_ if dt_ else 1 - at_)
                       * (ay if dy_ else 1 - ay)
                       * (ax if dx_ else 1 - ax))
                ti = jnp.clip(t0 + dt_, 0, t - 1)
                yi = jnp.clip(y0 + dy_, 0, w - 1)
                xi = jnp.clip(x0 + dx_, 0, w - 1)
                idx = (ti * w + yi) * w + xi
                acc = acc + jnp.where(idx[..., None] == lane,
                                      wgt[..., None], 0.0)
    out = jax.lax.dot_general(
        acc.reshape(-1, tww), table, (((1,), (0,)), ((), ())),
        precision=HIGHEST)                                      # (B, 2)
    out = out.reshape(poses.shape[:-1] + (2,))
    return out[..., 0] / jnp.maximum(out[..., 1], 1.0)
