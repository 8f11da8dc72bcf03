"""Point map, local-map extraction, and dual-resolution occupancy rasters.

Capability parity with the reference:
- global point map, append-only, capacity 20000 (``main.c:123-145``)
- AABB local-map crop with 1 m border (``ExtractLocalMap``, main.c:155-198)
- dual-resolution occupancy grids: bounds = local-map AABB with a 3-pixel
  margin, ``Sgrid = roundf(extent/pixel)+1`` cells, one-hot scatter of every
  local-map point (``OccupationalGrid``, main.c:271-363)

Design: everything is fixed-shape. The point map is a capacity-CAP
buffer plus a size scalar; the local map is a *mask* over that buffer (no
compaction — scatter order is irrelevant for a one-hot raster); the grids are
fixed (200,200)/(400,400) arrays with a dynamic valid region (rows, cols).
Out-of-region cells are kept unoccupied so the EDT computed on the full fixed
array agrees with the reference's EDT on the dynamic region (the matcher never
reads outside the valid region: bounds test at main.c:512).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lidar_slam_tpu.config import GridConfig


def roundf_like(x: jnp.ndarray) -> jnp.ndarray:
    """C ``roundf``: round half away from zero (jnp.round is half-to-even).

    The reference's cell snapping (main.c:304, 337-341, 483, 501) uses roundf;
    matching it exactly keeps cell indices — and hence the trajectory —
    bit-comparable to the C oracle.
    """
    return jnp.trunc(x + jnp.sign(x) * 0.5)


class PointMap(NamedTuple):
    """Append-only world-frame point cloud + last keyframe pose."""

    xy: jnp.ndarray        # (CAP, 2) f32
    size: jnp.ndarray      # () i32
    keyframe_pose: jnp.ndarray  # (3,) f32 — map.pose in the reference


def init_point_map(wx: jnp.ndarray, wy: jnp.ndarray, valid: jnp.ndarray,
                   pose: jnp.ndarray, capacity: int) -> PointMap:
    """Map := scan 0 (reference ``Initialise``, main.c:136-145)."""
    n = wx.shape[0]
    xy = jnp.zeros((capacity, 2), jnp.float32)
    idx = jnp.where(valid, jnp.arange(n), capacity)
    xy = xy.at[idx, 0].set(wx, mode="drop")
    xy = xy.at[idx, 1].set(wy, mode="drop")
    return PointMap(xy=xy, size=jnp.sum(valid).astype(jnp.int32),
                    keyframe_pose=pose.astype(jnp.float32) + 0.0)


def append_points(pmap: PointMap, px: jnp.ndarray, py: jnp.ndarray,
                  select: jnp.ndarray, new_pose: jnp.ndarray) -> PointMap:
    """Append selected points at the end of the buffer (main.c:941-956).

    ``select`` is a boolean mask over the candidate arrays; points are packed
    in order after the current ``size``. Writes beyond capacity are dropped
    (the reference would overflow; we saturate).
    """
    cap = pmap.xy.shape[0]
    pos = jnp.where(select, pmap.size + jnp.cumsum(select) - 1, cap)
    xy = pmap.xy.at[pos, 0].set(px, mode="drop")
    xy = xy.at[pos, 1].set(py, mode="drop")
    new_size = jnp.minimum(pmap.size + jnp.sum(select), cap).astype(jnp.int32)
    return PointMap(xy=xy, size=new_size, keyframe_pose=new_pose.astype(jnp.float32))


class LocalMap(NamedTuple):
    """Mask view of the point map restricted to the scan AABB + border."""

    xy: jnp.ndarray    # (CAP, 2) — the full map buffer (aliased)
    mask: jnp.ndarray  # (CAP,) bool


def extract_local_map(pmap: PointMap, scan_wx: jnp.ndarray, scan_wy: jnp.ndarray,
                      scan_valid: jnp.ndarray, border: float) -> LocalMap:
    """AABB crop (main.c:155-198). Strict inequalities as in the reference."""
    big = jnp.float32(1e30)
    sx = jnp.where(scan_valid, scan_wx, big)
    sy = jnp.where(scan_valid, scan_wy, big)
    min_x = jnp.min(sx) - border
    min_y = jnp.min(sy) - border
    sx = jnp.where(scan_valid, scan_wx, -big)
    sy = jnp.where(scan_valid, scan_wy, -big)
    max_x = jnp.max(sx) + border
    max_y = jnp.max(sy) + border

    cap = pmap.xy.shape[0]
    in_range = jnp.arange(cap) < pmap.size
    mx, my = pmap.xy[:, 0], pmap.xy[:, 1]
    inside = (mx > min_x) & (mx < max_x) & (my > min_y) & (my < max_y)
    return LocalMap(xy=pmap.xy, mask=in_range & inside)


class OccGrid(NamedTuple):
    """One occupancy raster with dynamic valid region inside a fixed array."""

    occ: jnp.ndarray       # (S, S) bool
    n_rows: jnp.ndarray    # () i32 — Sgrid[1] in the reference
    n_cols: jnp.ndarray    # () i32 — Sgrid[0]
    origin: jnp.ndarray    # (2,) f32 — top_left_corner (min_x, min_y), margin applied
    pixel: float           # static


def _rasterize(local: LocalMap, pixel: float, size: int,
               min_xy: jnp.ndarray, max_xy: jnp.ndarray,
               margin_pixels: int) -> OccGrid:
    import numpy as np

    # Multiply by the correctly-rounded f32 reciprocal instead of dividing:
    # XLA:CPU lowers f32 division to a reciprocal+Newton sequence that is off
    # by 1 ulp from IEEE at rare quotients (observed: 31.449999/0.1 ->
    # 314.5 vs divss's 314.49997), which snaps a point into the neighboring
    # cell and forks the trajectory vs the C++ oracle. f32 multiplication is
    # correctly rounded everywhere, and the oracle computes the same
    # `1.0f / pixel` with divss — bit-identical by construction.
    ipixel = jnp.float32(np.float32(1.0) / np.float32(pixel))
    min_xy = min_xy - margin_pixels * pixel
    max_xy = max_xy + margin_pixels * pixel
    sgrid = (roundf_like((max_xy - min_xy) * ipixel) + 1).astype(jnp.int32)  # (2,) = (x_cells, y_cells)

    col = roundf_like((local.xy[:, 0] - min_xy[0]) * ipixel).astype(jnp.int32)
    row = roundf_like((local.xy[:, 1] - min_xy[1]) * ipixel).astype(jnp.int32)
    cap = local.xy.shape[0]
    row = jnp.where(local.mask, row, size)  # dropped by mode="drop"
    col = jnp.where(local.mask, col, size)
    occ = jnp.zeros((size, size), jnp.bool_)
    occ = occ.at[row, col].set(True, mode="drop")
    return OccGrid(occ=occ, n_rows=sgrid[1], n_cols=sgrid[0],
                   origin=min_xy.astype(jnp.float32), pixel=pixel)


def rasterize_dual(local: LocalMap, cfg: GridConfig) -> tuple[OccGrid, OccGrid]:
    """Scatter the local map into both grids (main.c:271-363).

    Bounds are computed once from the local map (before margins), then each
    resolution applies its own 3-pixel margin, exactly as the reference.
    """
    big = jnp.float32(1e30)
    mx = jnp.where(local.mask, local.xy[:, 0], big)
    my = jnp.where(local.mask, local.xy[:, 1], big)
    min_xy = jnp.stack([jnp.min(mx), jnp.min(my)])
    mx = jnp.where(local.mask, local.xy[:, 0], -big)
    my = jnp.where(local.mask, local.xy[:, 1], -big)
    max_xy = jnp.stack([jnp.max(mx), jnp.max(my)])

    coarse = _rasterize(local, cfg.coarse_pixel, cfg.coarse_size,
                        min_xy, max_xy, cfg.margin_pixels)
    fine = _rasterize(local, cfg.fine_pixel, cfg.fine_size,
                      min_xy, max_xy, cfg.margin_pixels)
    return coarse, fine
