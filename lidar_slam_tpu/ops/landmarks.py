"""Scan-driven landmark extraction: pillar/corner detection on gated beams.

The EKF-FastSLAM model family (models/ekf_slam.py) needs point landmarks.
Round 1 fed it simulator-generated range/bearing pairs with *known
association*; this op closes the gap by extracting landmark observations from
the raw lidar scan itself, so `run --mode ekf` consumes the same ranges CSV as
every other mode (the reference's dataset format, Subsystem_1/main.c:22-30).

Detector: free-standing pillars/posts appear as short runs of beams whose
range drops well below both adjacent background segments. Design —
no data-dependent loops:

1. segment the beam array at range discontinuities (|dr| > gap) and validity
   changes: ``seg_id = cumsum(breaks)`` gives every beam a segment id;
2. per-segment stats (count, centroid, mean range) via ``segment_sum`` with a
   static segment capacity (= n_beams);
3. a segment is a pillar candidate iff it is short (arc width below
   ``max_width``), near (below ``max_range``), and both neighboring segments
   lie at least ``gap`` *behind* it (gated-out/invalid neighbors count as
   far background);
4. the first ``max_out`` accepted segments (beam order — deterministic) are
   compacted into fixed (M, 2) range/bearing slots + a validity mask.

Returns observations in the sensor frame; bearings follow the reference
convention used throughout (a beam at sensor angle a points at world angle
a - theta, main.c:115-116).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LandmarkDetections(NamedTuple):
    rb: jnp.ndarray      # (M, 2) f32 — (range, bearing), zero-padded
    valid: jnp.ndarray   # (M,) bool
    count: jnp.ndarray   # () i32


def extract_landmarks(ranges: jnp.ndarray, angles: jnp.ndarray,
                      range_min: float = 0.023, usable_range: float = 24.0,
                      gap: float = 0.6, max_width: float = 1.0,
                      min_beams: int = 3, max_range: float = 12.0,
                      max_out: int = 16) -> LandmarkDetections:
    """Detect pillar-like clusters in one scan. Fixed shapes, jit/vmap safe."""
    n = ranges.shape[0]
    r = ranges.astype(jnp.float32)
    ok = (r >= range_min) & (r <= usable_range)
    # heal isolated dropouts (the simulator's 1% random dropout, and real
    # lidars' specular misses): an invalid beam whose two neighbors are valid
    # and mutually consistent is interpolated — otherwise every dropout pair
    # cuts a wall into a short "foreground" sliver that mimics a pillar.
    prev_ok = jnp.concatenate([jnp.zeros(1, bool), ok[:-1]])
    next_ok = jnp.concatenate([ok[1:], jnp.zeros(1, bool)])
    prev_rv = jnp.concatenate([r[:1], r[:-1]])
    next_rv = jnp.concatenate([r[1:], r[-1:]])
    healable = (~ok) & prev_ok & next_ok & (jnp.abs(prev_rv - next_rv) < gap)
    r = jnp.where(healable, 0.5 * (prev_rv + next_rv), r)
    ok = ok | healable
    # invalid beams read as "far background" for the neighbor test
    far = jnp.float32(1e6)
    r_eff = jnp.where(ok, r, far)

    # --- segmentation at discontinuities ------------------------------------
    dr = jnp.abs(r_eff[1:] - r_eff[:-1])
    brk = jnp.concatenate([jnp.ones(1, bool), dr > gap])
    seg = jnp.cumsum(brk.astype(jnp.int32)) - 1          # (N,) in [0, n)

    ones = jnp.ones(n, jnp.float32)
    cnt = jax.ops.segment_sum(ones, seg, num_segments=n)             # (S,)
    sum_r = jax.ops.segment_sum(r_eff, seg, num_segments=n)
    mean_r = sum_r / jnp.maximum(cnt, 1.0)
    sx = r * jnp.cos(angles)
    sy = r * jnp.sin(angles)
    cx = jax.ops.segment_sum(sx, seg, num_segments=n) / jnp.maximum(cnt, 1.0)
    cy = jax.ops.segment_sum(sy, seg, num_segments=n) / jnp.maximum(cnt, 1.0)

    n_seg = seg[-1] + 1
    sid = jnp.arange(n)
    live = sid < n_seg
    # neighbor background ranges (out-of-range neighbors = far)
    prev_r = jnp.where(sid >= 1, mean_r[jnp.maximum(sid - 1, 0)], far)
    next_r = jnp.where(sid + 1 < n_seg, mean_r[jnp.minimum(sid + 1, n - 1)], far)

    width = cnt * jnp.float32(0.004363) * mean_r   # arc-length approximation
    is_pillar = (live
                 & (mean_r < max_range)
                 & (cnt >= min_beams)
                 & (width <= max_width)
                 & (prev_r > mean_r + gap)
                 & (next_r > mean_r + gap))

    # --- compact the first max_out accepted segments -------------------------
    rank = jnp.where(is_pillar, jnp.cumsum(is_pillar.astype(jnp.int32)) - 1, n)
    det_r = jnp.hypot(cx, cy)
    det_b = jnp.arctan2(cy, cx)
    rb = jnp.zeros((max_out, 2), jnp.float32)
    rb = rb.at[rank, 0].set(det_r, mode="drop")
    rb = rb.at[rank, 1].set(det_b, mode="drop")
    count = jnp.minimum(jnp.sum(is_pillar), max_out).astype(jnp.int32)
    valid = jnp.arange(max_out) < count
    return LandmarkDetections(rb=rb, valid=valid, count=count)


def extract_corners(ranges: jnp.ndarray, angles: jnp.ndarray,
                    range_min: float = 0.023, usable_range: float = 24.0,
                    k: int = 12, gap: float = 0.3,
                    min_angle: float = 0.5, max_resid: float = 0.0012,
                    max_range: float = 12.0, max_out: int = 16
                    ) -> LandmarkDetections:
    """Detect wall-intersection corners — the high-precision landmark class.

    Unlike a pillar's visible-arc centroid (which wanders by ~its radius as
    the viewpoint moves), a corner is an exact world point. Per beam i, fit
    lines to the k beams on each side (closed-form PCA via sliding cumsums —
    no loops over beams), and flag a corner when (a) both sides are straight
    (small minor eigenvalue), (b) their directions differ by > ``min_angle``
    rad, and (c) the window is continuous (no range jumps > ``gap``).
    Non-maximum suppression over +-k beams keeps one detection per corner.
    """
    n = ranges.shape[0]
    r = ranges.astype(jnp.float32)
    ok = (r >= range_min) & (r <= usable_range)
    x = r * jnp.cos(angles)
    y = r * jnp.sin(angles)

    # continuity: a window is usable only if every |dr| within it is small
    dr = jnp.abs(r[1:] - r[:-1])
    brk = jnp.concatenate([jnp.ones(1, bool), (dr > gap)]) | ~ok
    brk_ps = jnp.cumsum(brk.astype(jnp.int32))

    def win_sums(v):
        ps = jnp.concatenate([jnp.zeros(1, v.dtype), jnp.cumsum(v)])
        # left window [i-k, i-1], right window [i+1, i+k] (clamped)
        i = jnp.arange(n)
        lo_l = jnp.maximum(i - k, 0)
        left = ps[i] - ps[lo_l]
        hi_r = jnp.minimum(i + 1 + k, n)
        right = ps[hi_r] - ps[i + 1]
        return left, right

    def side_stats(xl, yl, xxl, yyl, xyl, cnt):
        c = jnp.maximum(cnt, 1.0)
        mx, my = xl / c, yl / c
        cxx = xxl / c - mx * mx
        cyy = yyl / c - my * my
        cxy = xyl / c - mx * my
        ang = 0.5 * jnp.arctan2(2.0 * cxy, cxx - cyy)   # major axis direction
        tr = cxx + cyy
        det = cxx * cyy - cxy * cxy
        disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
        minor = tr / 2.0 - disc                          # smaller eigenvalue
        return ang, minor

    ones = ok.astype(jnp.float32)
    cl, cr = win_sums(ones)
    xl, xr = win_sums(x * ones)
    yl, yr = win_sums(y * ones)
    xxl, xxr = win_sums(x * x * ones)
    yyl, yyr = win_sums(y * y * ones)
    xyl, xyr = win_sums(x * y * ones)
    ang_l, min_l = side_stats(xl, yl, xxl, yyl, xyl, cl)
    ang_r, min_r = side_stats(xr, yr, xxr, yyr, xyr, cr)

    # window continuity: no break strictly inside (i-k, i+k]
    i = jnp.arange(n)
    lo = jnp.maximum(i - k, 0)
    hi = jnp.minimum(i + k, n - 1)
    contiguous = (brk_ps[hi] - brk_ps[lo]) == 0
    full = (cl >= k) & (cr >= k)                        # not at array edges

    dang = jnp.abs(jnp.arctan2(jnp.sin(2.0 * (ang_l - ang_r)),
                               jnp.cos(2.0 * (ang_l - ang_r)))) / 2.0
    is_corner = (ok & contiguous & full & (r < max_range)
                 & (dang > min_angle)
                 & (min_l < max_resid) & (min_r < max_resid))
    score = jnp.where(is_corner, dang, -1.0)

    # non-max suppression over +-k beams
    best = score
    for s in range(1, k + 1):
        best = jnp.maximum(best, jnp.roll(score, s))
        best = jnp.maximum(best, jnp.roll(score, -s))
    keep = is_corner & (score >= best)
    # break exact ties (plateaus) by keeping only the first beam of a run
    prev_keep = jnp.concatenate([jnp.zeros(1, bool), keep[:-1]])
    keep = keep & ~prev_keep

    # corner position = intersection of the two fitted lines (exact world
    # point; the junction *beam* is biased by up to one beam spacing along
    # the wall, which shows up as ~5-10 cm viewpoint-dependent error)
    mxl, myl = xl / jnp.maximum(cl, 1.0), yl / jnp.maximum(cl, 1.0)
    mxr, myr = xr / jnp.maximum(cr, 1.0), yr / jnp.maximum(cr, 1.0)
    dlx, dly = jnp.cos(ang_l), jnp.sin(ang_l)
    drx, dry = jnp.cos(ang_r), jnp.sin(ang_r)
    denom = dlx * dry - dly * drx            # != 0 where dang > min_angle
    tt = ((mxr - mxl) * dry - (myr - myl) * drx) / jnp.where(
        jnp.abs(denom) < 1e-6, 1.0, denom)
    cx_int = mxl + tt * dlx
    cy_int = myl + tt * dly
    usable = jnp.abs(denom) >= 1e-6
    px_c = jnp.where(keep & usable, cx_int, x)
    py_c = jnp.where(keep & usable, cy_int, y)

    rank = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, n)
    det_r = jnp.hypot(px_c, py_c)
    det_b = jnp.arctan2(py_c, px_c)
    rb = jnp.zeros((max_out, 2), jnp.float32)
    rb = rb.at[rank, 0].set(det_r, mode="drop")
    rb = rb.at[rank, 1].set(det_b, mode="drop")
    count = jnp.minimum(jnp.sum(keep), max_out).astype(jnp.int32)
    valid = jnp.arange(max_out) < count
    return LandmarkDetections(rb=rb, valid=valid, count=count)


def extract_all(ranges: jnp.ndarray, angles: jnp.ndarray,
                max_out: int = 16, pillar_kw: dict | None = None,
                corner_kw: dict | None = None) -> LandmarkDetections:
    """Corners first (precise), then pillars, compacted into M slots."""
    corners = extract_corners(ranges, angles, max_out=max_out,
                              **(corner_kw or {}))
    pillars = extract_landmarks(ranges, angles, max_out=max_out,
                                **(pillar_kw or {}))
    rb = jnp.concatenate([corners.rb, pillars.rb])          # (2M, 2)
    val = jnp.concatenate([corners.valid, pillars.valid])
    pos = jnp.where(val, jnp.cumsum(val) - 1, 2 * max_out)
    out = jnp.zeros((max_out, 2), jnp.float32)
    out = out.at[pos, 0].set(rb[:, 0], mode="drop")
    out = out.at[pos, 1].set(rb[:, 1], mode="drop")
    count = jnp.minimum(corners.count + pillars.count, max_out).astype(jnp.int32)
    return LandmarkDetections(rb=out, valid=jnp.arange(max_out) < count,
                              count=count)


def extract_landmarks_batch(ranges_all: jnp.ndarray, angles: jnp.ndarray,
                            corners: bool = True, **kw) -> LandmarkDetections:
    """Whole-dataset extraction: (T, N) -> (T, M, 2) in one vmapped jit."""
    if corners:
        max_out = kw.pop("max_out", 16)
        shared = {k_: v for k_, v in kw.items()
                  if k_ in ("range_min", "usable_range", "max_range")}
        fn = lambda r: extract_all(r, angles, max_out=max_out, pillar_kw=kw,
                                   corner_kw=shared)
    else:
        fn = lambda r: extract_landmarks(r, angles, **kw)
    return jax.jit(jax.vmap(fn))(ranges_all)
