"""Submap atlas: tiled long-term mapping with rigid loop-closure correction.

The reference's global map is one append-only 20k-point buffer
(``Subsystem_1/main.c:123-145``) — it saturates after a few hundred meters of
trajectory and a loop closure cannot move already-inserted points. This module
replaces it with an *atlas* of fixed-capacity submaps (the Cartographer-style
design, in fixed shapes):

- each submap stores its points in its **anchor frame**; the anchor's world
  pose is a separate (3,) leaf. A pose-graph correction therefore moves a
  whole submap rigidly by rewriting one anchor — zero point updates;
- everything is fixed-shape: (M, Ns, 2) point pool, (M,) sizes, (M, 3)
  anchors — the whole structure jits and rides inside ``lax.scan``;
- the matcher's local map is assembled from the K nearest submaps by anchor
  distance (``top_k`` + gather + batched SE(2) transform), bounding the
  per-step cost regardless of how large the explored area grows;
- unbounded environments page cold submaps to host memory
  (``utils/paging.PagedAtlas``) — the device footprint stays M*Ns points.

Frame convention: anchors are reference-convention poses (rotation by -theta,
``se2.transform_ref``), matching the fidelity pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_tpu.core import se2
from lidar_slam_tpu.core.gridmap import LocalMap


class SubmapAtlas(NamedTuple):
    pts: jnp.ndarray        # (M, Ns, 2) f32 — points in each submap's anchor frame
    sizes: jnp.ndarray      # (M,) i32
    anchors: jnp.ndarray    # (M, 3) f32 — world pose of each anchor (ref conv)
    n_submaps: jnp.ndarray  # () i32 — allocated slots
    active: jnp.ndarray     # () i32 — slot receiving new points


def empty_atlas(n_submaps: int, capacity: int) -> SubmapAtlas:
    return SubmapAtlas(
        pts=jnp.zeros((n_submaps, capacity, 2), jnp.float32),
        sizes=jnp.zeros(n_submaps, jnp.int32),
        anchors=jnp.zeros((n_submaps, 3), jnp.float32),
        n_submaps=jnp.int32(0),
        active=jnp.int32(0),
    )


def world_to_anchor(wx: jnp.ndarray, wy: jnp.ndarray, anchor: jnp.ndarray):
    """Inverse of ``se2.transform_ref``: world -> anchor frame.

    transform_ref maps p -> R(-theta) p + t, so the inverse is R(theta)(w-t).
    """
    dx = wx - anchor[..., 0:1]
    dy = wy - anchor[..., 1:2]
    ct = jnp.cos(anchor[..., 2:3])
    st = jnp.sin(anchor[..., 2:3])
    return ct * dx - st * dy, st * dx + ct * dy


def start_submap(atlas: SubmapAtlas, anchor: jnp.ndarray) -> SubmapAtlas:
    """Open a new submap anchored at ``anchor`` and make it active.

    Saturates silently when the pool is full (paging evicts cold slots
    before that happens in the unbounded driver).
    """
    m = atlas.pts.shape[0]
    slot = atlas.n_submaps  # mode="drop" discards writes when slot == m
    return SubmapAtlas(
        pts=atlas.pts.at[slot].set(0.0, mode="drop"),
        sizes=atlas.sizes.at[slot].set(0, mode="drop"),
        anchors=atlas.anchors.at[slot].set(anchor, mode="drop"),
        n_submaps=jnp.minimum(atlas.n_submaps + 1, m),
        active=jnp.minimum(slot, m - 1),
    )


def insert_world_points(atlas: SubmapAtlas, wx: jnp.ndarray, wy: jnp.ndarray,
                        select: jnp.ndarray) -> SubmapAtlas:
    """Append selected world-frame points to the active submap.

    Points are re-expressed in the active anchor's frame; packing and
    saturation follow ``gridmap.append_points``.
    """
    k = atlas.active
    anchor = atlas.anchors[k]
    ax, ay = world_to_anchor(wx, wy, anchor[None])
    ax, ay = ax[0], ay[0]
    cap = atlas.pts.shape[1]
    size = atlas.sizes[k]
    pos = jnp.where(select, size + jnp.cumsum(select) - 1, cap)
    pts_k = atlas.pts[k]
    pts_k = pts_k.at[pos, 0].set(ax, mode="drop")
    pts_k = pts_k.at[pos, 1].set(ay, mode="drop")
    new_size = jnp.minimum(size + jnp.sum(select), cap).astype(jnp.int32)
    return atlas._replace(pts=atlas.pts.at[k].set(pts_k),
                          sizes=atlas.sizes.at[k].set(new_size))


def submap_world_points(atlas: SubmapAtlas):
    """All submap points in world frame: ((M, Ns), (M, Ns)) + (M, Ns) mask."""
    # transform_ref broadcasts (M, 3) poses against (M, Ns) points via its
    # trailing-singleton slicing (pose[..., 0:1] -> (M, 1))
    wx, wy = se2.transform_ref(atlas.pts[..., 0], atlas.pts[..., 1],
                               atlas.anchors)
    m, ns = atlas.pts.shape[:2]
    mask = (jnp.arange(ns)[None, :] < atlas.sizes[:, None]) & \
           (jnp.arange(m)[:, None] < atlas.n_submaps)
    return wx, wy, mask


def nearest_submaps(atlas: SubmapAtlas, pose: jnp.ndarray, k_nearest: int):
    """Indices of the K nearest allocated submaps by anchor xy distance.

    The active submap always wins (distance forced to -1), so the matcher
    never loses the surface it is currently building.
    """
    m = atlas.pts.shape[0]
    d2 = jnp.sum((atlas.anchors[:, :2] - pose[:2]) ** 2, axis=1)
    d2 = jnp.where(jnp.arange(m) < atlas.n_submaps, d2, jnp.inf)
    d2 = d2.at[atlas.active].set(-1.0)
    _, idx = jax.lax.top_k(-d2, k_nearest)
    return idx


def extract_local_from_atlas(atlas: SubmapAtlas, pose: jnp.ndarray,
                             scan_wx: jnp.ndarray, scan_wy: jnp.ndarray,
                             scan_valid: jnp.ndarray, border: float,
                             k_nearest: int) -> LocalMap:
    """Local map for the matcher: K nearest submaps, AABB-cropped.

    Mirrors ``gridmap.extract_local_map`` semantics (scan AABB + border,
    strict inequalities) over the gathered submap points. Returns a
    fixed-shape ``LocalMap`` with capacity K * Ns.
    """
    idx = nearest_submaps(atlas, pose, k_nearest)          # (K,)
    pts = atlas.pts[idx]                                   # (K, Ns, 2)
    anchors = atlas.anchors[idx]                           # (K, 3)
    wx, wy = se2.transform_ref(pts[..., 0], pts[..., 1], anchors)
    ns = pts.shape[1]
    valid = (jnp.arange(ns)[None, :] < atlas.sizes[idx][:, None]) & \
            (idx[:, None] < atlas.n_submaps)

    big = jnp.float32(1e30)
    sx = jnp.where(scan_valid, scan_wx, big)
    sy = jnp.where(scan_valid, scan_wy, big)
    min_x = jnp.min(sx) - border
    min_y = jnp.min(sy) - border
    sx = jnp.where(scan_valid, scan_wx, -big)
    sy = jnp.where(scan_valid, scan_wy, -big)
    max_x = jnp.max(sx) + border
    max_y = jnp.max(sy) + border

    fx = wx.reshape(-1)
    fy = wy.reshape(-1)
    inside = (fx > min_x) & (fx < max_x) & (fy > min_y) & (fy < max_y)
    return LocalMap(xy=jnp.stack([fx, fy], axis=1),
                    mask=valid.reshape(-1) & inside)


def apply_anchor_correction(atlas: SubmapAtlas,
                            new_anchors: jnp.ndarray) -> SubmapAtlas:
    """Rigidly move submaps to pose-graph-optimized anchors (loop closure).

    ``new_anchors`` is (M, 3) in the reference convention; slots beyond
    ``n_submaps`` are ignored by construction (their masks are off).
    """
    return atlas._replace(anchors=new_anchors.astype(jnp.float32))


def total_points(atlas: SubmapAtlas) -> jnp.ndarray:
    m = atlas.pts.shape[0]
    return jnp.sum(jnp.where(jnp.arange(m) < atlas.n_submaps, atlas.sizes, 0))
