"""Host paging for the submap atlas: unbounded maps on a bounded device pool.

The device-resident ``SubmapAtlas`` holds M submaps; an unbounded environment
produces arbitrarily many. This module archives cold submaps (anchor far from
the robot) to host memory and reloads them when the trajectory returns — the
device footprint stays M * Ns points forever. Paging runs on the host between
jitted steps (it is keyframe-rate work on ~1 MB arrays; the hot per-scan path
never touches it), the same host/device split the reference's "edge offload"
variant used for its cheap front-end (``Submodule_2/esp32_edge.c``,
SURVEY §2.2 N5).

Archive entries keep their points in the anchor frame, so a pose-graph
correction while a submap is paged out only rewrites its (3,) anchor.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.core.submap import SubmapAtlas


@dataclasses.dataclass
class ArchivedSubmap:
    pts: np.ndarray      # (size, 2) anchor-frame points (trimmed)
    anchor: np.ndarray   # (3,)


class PagedAtlas:
    """Host-side manager pairing a device ``SubmapAtlas`` with an archive.

    Call ``manage(atlas, pose)`` at keyframe rate: it reloads archived
    submaps whose anchors are within ``near_dist`` of the pose and, when the
    device pool is full, evicts the furthest non-active residents. Returns
    the (possibly rewritten) atlas.
    """

    def __init__(self, near_dist: float = 8.0, keep_free: int = 2):
        self.archive: list[ArchivedSubmap] = []
        self.near_dist = near_dist
        self.keep_free = keep_free
        self.pages_out = 0
        self.pages_in = 0

    # -- internals on host copies ---------------------------------------------
    @staticmethod
    def _to_host(atlas: SubmapAtlas):
        # np.asarray views of jax arrays are read-only; the eviction
        # compaction below mutates in place, so copy
        return (np.array(atlas.pts), np.array(atlas.sizes),
                np.array(atlas.anchors), int(atlas.n_submaps),
                int(atlas.active))

    def _evict(self, pts, sizes, anchors, n, active, pose_xy, want_free):
        """Archive the furthest residents until ``want_free`` slots are free.

        Compacts by moving the tail slot into the evicted slot (order inside
        the pool is irrelevant — the matcher selects by anchor distance)."""
        m = pts.shape[0]
        while n > m - want_free:
            d = np.hypot(anchors[:n, 0] - pose_xy[0],
                         anchors[:n, 1] - pose_xy[1])
            d[active] = -1.0  # never evict the submap being built
            victim = int(np.argmax(d))
            if d[victim] <= self.near_dist:
                break  # everything resident is hot; stop evicting
            self.archive.append(ArchivedSubmap(
                pts=pts[victim, : sizes[victim]].copy(),
                anchor=anchors[victim].copy()))
            self.pages_out += 1
            last = n - 1
            if victim != last:
                pts[victim] = pts[last]
                sizes[victim] = sizes[last]
                anchors[victim] = anchors[last]
                if active == last:
                    active = victim
            pts[last] = 0.0
            sizes[last] = 0
            n = last
        return n, active

    def manage(self, atlas: SubmapAtlas, pose) -> SubmapAtlas:
        pose = np.asarray(pose)
        pts, sizes, anchors, n, active = self._to_host(atlas)
        m, cap = pts.shape[0], pts.shape[1]

        # page-in: archived submaps whose anchors came back into range
        near = [i for i, a in enumerate(self.archive)
                if np.hypot(a.anchor[0] - pose[0], a.anchor[1] - pose[1])
                <= self.near_dist]
        changed = False
        for i in sorted(near, reverse=True):
            if n >= m:
                n, active = self._evict(pts, sizes, anchors, n, active,
                                        pose[:2], 1)
                changed = True
                if n >= m:
                    break  # pool saturated with hot submaps
            a = self.archive.pop(i)
            k = min(len(a.pts), cap)
            pts[n] = 0.0
            pts[n, :k] = a.pts[:k]
            sizes[n] = k
            anchors[n] = a.anchor
            n += 1
            self.pages_in += 1
            changed = True

        # page-out: keep headroom so in-jit spawns never hit a full pool
        if n > m - self.keep_free:
            n2, active2 = self._evict(pts, sizes, anchors, n, active,
                                      pose[:2], self.keep_free)
            changed |= (n2 != n) or (active2 != active)
            n, active = n2, active2

        if not changed:
            return atlas
        return SubmapAtlas(pts=jnp.asarray(pts), sizes=jnp.asarray(sizes),
                           anchors=jnp.asarray(anchors),
                           n_submaps=jnp.int32(n), active=jnp.int32(active))

    # -- output ----------------------------------------------------------------
    def world_points(self, atlas: SubmapAtlas) -> np.ndarray:
        """All map points (resident + archived) in world frame, (P, 2)."""
        from lidar_slam_tpu.core import submap as sm

        wx, wy, mask = sm.submap_world_points(atlas)
        wx, wy, mask = np.asarray(wx), np.asarray(wy), np.asarray(mask)
        parts = [np.stack([wx[mask], wy[mask]], axis=1)]
        for a in self.archive:
            ct, st = np.cos(a.anchor[2]), np.sin(a.anchor[2])
            # reference-convention transform (rotation by -theta)
            x = ct * a.pts[:, 0] + st * a.pts[:, 1] + a.anchor[0]
            y = -st * a.pts[:, 0] + ct * a.pts[:, 1] + a.anchor[1]
            parts.append(np.stack([x, y], axis=1))
        return np.concatenate(parts) if parts else np.zeros((0, 2), np.float32)


def run_host_loop_paged(ranges_all: np.ndarray, cfg, paged: PagedAtlas,
                        manage_every: int = 16):
    """Host-loop driver with paging: unbounded maps on a fixed device pool."""
    from lidar_slam_tpu.models import submap_slam

    step = submap_slam.make_step_fn(cfg)
    state = submap_slam.init_state(jnp.asarray(ranges_all[0]), cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, ranges_all.shape[0]):
        state, pose = step(state, jnp.asarray(ranges_all[t]))
        poses.append(np.asarray(pose))
        if t % manage_every == 0:
            new_atlas = paged.manage(state.atlas, poses[-1])
            if new_atlas is not state.atlas:
                state = state._replace(atlas=new_atlas)
    return np.stack(poses), state
