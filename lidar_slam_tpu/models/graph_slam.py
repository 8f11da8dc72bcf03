"""Graph-SLAM driver: scan-matcher frontend + loop closure + pose graph.

The full-capability model (BASELINE.json config 5): the fidelity frontend
tracks pose scan-to-map; every keyframe becomes a graph node with an odometry
edge; revisited places are detected by keyframe-to-keyframe correlative
matching over a wide search window; accepted closures trigger a damped
Gauss-Newton solve and a map rebuild from the optimized keyframe poses.

Structure: a host loop around three jitted pieces (frontend step, loop-closure
match, graph optimize). Loop closures are rare events with data-dependent
graph sizes — host-side control flow is the right tool here, while every
numeric inner loop stays on device. (The frontend alone remains available as
one fused lax.scan for pure odometry benchmarking.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.config import SlamConfig
from lidar_slam_tpu.core import gridmap, se2, sensor
from lidar_slam_tpu.core.gridmap import OccGrid, roundf_like
from lidar_slam_tpu.models import posegraph, scan_matcher
from lidar_slam_tpu.ops import correlative
from lidar_slam_tpu.ops import edt as edt_ops


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    raster_size: int = 256        # keyframe raster: 256 cells @ 0.2 m = +-25.6 m
    raster_pixel: float = 0.2
    n_theta: int = 21             # +-10 bins
    theta_step: float = 0.008727  # 0.5 deg
    window_half: int = 14         # +-2.8 m search window
    accept_avg_dist: float = 1.1  # px — acceptance threshold
    min_inlier_frac: float = 0.75  # fraction of beams in bounds
    # peak-sharpness gate: reject a match when more than this many CELLS of
    # the search volume score within ``ambiguity_margin`` px of the best
    # cell. Corridor aliasing leaves a near-flat valley along the corridor
    # axis (a LINE of near-optimal cells, ~2*window_half+1 of them); a true
    # unique alignment has a sharp, isolated minimum (<= a trilinear plateau
    # of a few cells). Round 3 gated on the near-optimal FRACTION (1%), but
    # a 29-cell corridor valley is only 0.16% of the 21x29x29 volume — the
    # dominant building-3800 failure (aliased closures at ATE 9-10 m) passed
    # that gate by an order of magnitude.
    max_ambiguous_cells: float = 8.0
    ambiguity_margin: float = 0.25  # px above the best average distance
    # odometry-consistency gate: a closure implies a correction
    # |z_match - z_est| of the relative pose between its keyframes; real
    # frontend drift grows with distance traveled, so corrections beyond
    # abs + rel * (path length between the keyframes) are wrong by
    # construction (a low-drift frontend cannot be meters off over a short
    # gap — exactly the signature of an aliased corridor match).
    consistency_abs: float = 0.15   # m (and rad for the heading axis)
    consistency_rel: float = 0.03   # per meter of inter-keyframe path
    min_gap: int = 10             # keyframe index gap before closing
    max_dist: float = 4.0         # m — candidate search radius
    max_candidates: int = 2       # old keyframes tried per new keyframe
    #                               (3 candidates + weak weight 8 measured
    #                               WORSE on the building mis-registration
    #                               tour: 0.85 vs 0.45 m — more weak anchors
    #                               also means more weakly-wrong anchors)
    # weak-closure second tier (see _try_loop_closures_batch): rail- and
    # consistency-clean full-overlap matches whose absolute score fails the
    # strict gates enter at ~1/10 weight; <= 2 per keyframe. OFF by
    # default: a low-drift tracking frontend gains nothing from noisy
    # anchors (enabling them regressed the wide-frontend building graph
    # 0.069 -> 1.48 m, measured) — they are a RECOVERY mechanism for
    # multi-modal frontends whose map can mis-register (PFGraphSlam
    # enables them by default: 0.94 -> 0.45 m on the same tour).
    weak_closures: bool = False
    weak_avg_dist: float = 3.5    # px — weak-tier score ceiling
    refine_iters: int = 8
    # fine-raster refinement of ACCEPTED closures: the coarse 0.2 m closure
    # raster bounds the measurement z's precision to ~a decimeter, which is
    # worse than a tracking frontend's drift — accepted closures then pull
    # the graph AWAY from a good trajectory (building-3800: graph 0.15-0.21
    # m vs 0.04 m frontend-only). One extra batched dispatch re-matches each
    # accepted pair against a 0.05 m raster of the old keyframe (the
    # scan-odometry descent, halving steps from the coarse estimate).
    fine_refine: bool = True
    fine_pixel: float = 0.05
    fine_size: int = 448          # 448 * 0.05 = 22.4 m extent
    fine_range: float = 10.0      # points gated to the raster's safe reach
    fine_step_t0: float = 0.08    # descent reach +-0.16 m around the coarse
    fine_step_r0: float = 0.008   # estimate; resolution 2.5 mm / 0.25 mrad
    fine_iters: int = 6
    # Dispatch shape of the backend. Closure matches, keyframe rasters and
    # fine refinements run in fixed-width vmapped batches of
    # ``closure_batch`` (one compiled program per width), and the frontend
    # runs ``chunk_size`` scans per on-device lax.scan between host
    # bookkeeping rounds (the closure/optimize cadence). XLA:CPU's compile
    # time for the vmapped correlation volume grows steeply with the batch
    # width, so CPU test runs pass closure_batch=2, chunk_size=64.
    closure_batch: int = 8
    chunk_size: int = 256


class KeyframeStore(NamedTuple):
    x: jnp.ndarray      # (K, N) gated sensor-frame points
    y: jnp.ndarray
    valid: jnp.ndarray  # (K, N)
    count: jnp.ndarray  # () i32


@functools.partial(jax.jit, static_argnames=("size",))
def _raster_edt(x, y, valid, size: int, pixel: float):
    """Rasterize one keyframe scan in its own frame + clamped EDT."""
    half = size // 2
    col = roundf_like(x / pixel).astype(jnp.int32) + half
    row = roundf_like(y / pixel).astype(jnp.int32) + half
    col = jnp.where(valid, col, size)
    row = jnp.where(valid, row, size)
    occ = jnp.zeros((size, size), jnp.bool_).at[row, col].set(True, mode="drop")
    return edt_ops.edt_clamped(occ, 10)


@functools.partial(jax.jit, static_argnames=("size",))
def _raster_edt_batch(x, y, valid, size: int, pixel: float):
    """Vmapped ``_raster_edt`` — one dispatch rasterizes a whole bucket of
    keyframes (each EDT field is computed ONCE per keyframe and cached on
    host; round 2 recomputed it inside every closure attempt)."""
    return jax.vmap(lambda a, b, c: _raster_edt(a, b, c, size, pixel))(
        x, y, valid)


@functools.partial(jax.jit, static_argnames=("lc_size", "lc_pixel", "n_theta",
                                             "theta_step", "half", "iters"))
def _match_keyframes(metric, cur_x, cur_y, cur_valid,
                     guess_rel, lc_size: int, lc_pixel: float, n_theta: int,
                     theta_step: float, half: int, iters: int,
                     ambiguity_margin: float = 0.25):
    """Match current scan against an old keyframe's cached EDT raster.

    Returns (rel_pose (3,), avg_dist (), inlier_frac (), ambiguity ()) —
    ambiguity is the fraction of search-volume cells scoring within
    ``ambiguity_margin`` px of the best cell (flat valley = aliased match).
    ``guess_rel`` and the result use the reference convention in the old
    keyframe's frame."""
    halfm = lc_size // 2 * lc_pixel
    grid = OccGrid(occ=jnp.zeros((lc_size, lc_size), jnp.bool_),
                   n_rows=jnp.int32(lc_size), n_cols=jnp.int32(lc_size),
                   origin=jnp.asarray([-halfm, -halfm], jnp.float32),
                   pixel=lc_pixel)
    vol = correlative.build_score_volume(
        metric, grid, cur_x, cur_y, cur_valid, guess_rel,
        n_theta=n_theta, theta_step=theta_step, half=half)

    steps0 = jnp.asarray([lc_pixel, lc_pixel, theta_step], jnp.float32)
    offs = jnp.stack(jnp.meshgrid(*([jnp.asarray([-1.0, 0.0, 1.0])] * 3),
                                  indexing="ij"), axis=-1).reshape(27, 3)

    def refine(carry, i):
        est, _ = carry
        # coarse-to-fine: halve the step every other iteration
        scale = 2.0 ** (-(i // 2).astype(jnp.float32))
        cands = est[None, :] + offs * (steps0 * scale)[None, :]
        d = correlative.lookup_avg_distance(vol, cands)
        k = jnp.argmin(d)
        return (cands[k], d[k]), None

    (rel, avg_d), _ = jax.lax.scan(refine, (guess_rel, jnp.float32(1e9)),
                                   jnp.arange(iters))
    # inlier fraction: beams of the current scan landing inside the window
    n_valid = jnp.maximum(jnp.sum(cur_valid), 1)
    counts = correlative.lookup_avg_distance(
        vol._replace(scores=vol.counts, counts=jnp.ones_like(vol.counts)),
        rel[None])[0]
    # peak sharpness over the whole (T, W, W) volume: cells with too few
    # in-bounds beams score INF so they never count as near-optimal
    cell_avg = jnp.where(vol.counts > 0.5 * n_valid.astype(jnp.float32),
                         vol.scores / jnp.maximum(vol.counts, 1.0), jnp.inf)
    best_cell = jnp.min(cell_avg)
    ambiguity = jnp.mean(
        (cell_avg <= best_cell + jnp.float32(ambiguity_margin))
        .astype(jnp.float32))
    return rel, avg_d, counts / n_valid.astype(jnp.float32), ambiguity



def _match_keyframes_batch(old_metric, cur_x, cur_y, cur_valid,
                           guesses, lc: "LoopClosureConfig"):
    """Vmapped keyframe matching: all closure candidates of a whole chunk in
    ONE dispatch (old keyframe EDT raster AND current scan both batched)."""
    fn = functools.partial(
        _match_keyframes, lc_size=lc.raster_size, lc_pixel=lc.raster_pixel,
        n_theta=lc.n_theta, theta_step=lc.theta_step, half=lc.window_half,
        iters=lc.refine_iters, ambiguity_margin=lc.ambiguity_margin)
    rel, avg, inl, amb = jax.vmap(fn)(old_metric, cur_x, cur_y, cur_valid,
                                      guesses)
    # packed (B, 6): the caller fetches ONE array
    return jnp.concatenate([rel, avg[:, None], inl[:, None], amb[:, None]],
                           axis=1)


@functools.partial(jax.jit, static_argnames=("pixel", "size", "iters",
                                             "step_t0", "step_r0",
                                             "max_range"))
def _refine_rel_batch(x0, y0, v0, x1, y1, v1, guesses, *, pixel: float,
                      size: int, iters: int, step_t0: float, step_r0: float,
                      max_range: float):
    """Fine-raster re-match of accepted closures (one vmapped dispatch).

    Each old keyframe scan is rastered in its own frame at ``pixel`` and
    clamp-EDT'd; the new keyframe's scan descends from the coarse estimate
    with halving steps (the ops/scan_odometry pair-matcher applied
    keyframe-to-keyframe). Points beyond ``max_range`` are gated so the
    centered raster's reach is never exceeded."""
    from lidar_slam_tpu.ops import matching
    from lidar_slam_tpu.ops.scan_odometry import _raster_centered

    mr2 = jnp.float32(max_range * max_range)

    def one(ax, ay, av, bx, by, bv, g):
        grid = _raster_centered(ax, ay, av & (ax * ax + ay * ay <= mr2),
                                pixel, size)
        metric = edt_ops.edt_clamped(grid.occ)
        pose = g
        st, sr = step_t0, step_r0
        for _ in range(iters):
            pose = matching.fast_match(
                metric, grid, bx, by, bv & (bx * bx + by * by <= mr2),
                pose, st, sr).pose
            st, sr = st * 0.5, sr * 0.5
        return pose

    return jax.vmap(one)(x0, y0, v0, x1, y1, v1, guesses)


# -- host-side SE(2) helpers (numpy; bookkeeping must not dispatch) -----------
def _np_ref_to_std(p):
    return np.asarray([p[0], p[1], -p[2]], np.float32)


def _np_between_std(p1, p2):
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ct, st = np.cos(p1[2]), np.sin(p1[2])
    dth = p2[2] - p1[2]
    dth = dth - 2.0 * np.pi * np.floor((dth + np.pi) / (2.0 * np.pi))
    return np.asarray([ct * dx + st * dy, -st * dx + ct * dy, dth], np.float32)


def _np_between_ref(a, b):
    dx, dy = b[0] - a[0], b[1] - a[1]
    ct, st = np.cos(a[2]), np.sin(a[2])
    return np.asarray([ct * dx - st * dy, st * dx + ct * dy, b[2] - a[2]],
                      np.float32)


def _np_compose_ref(a, z):
    ct, st = np.cos(a[2]), np.sin(a[2])
    return np.asarray([a[0] + ct * z[0] + st * z[1],
                       a[1] - st * z[0] + ct * z[1],
                       a[2] + z[2]], np.float32)


def _np_transform_ref(x, y, poses):
    """Vectorized reference-convention transform, host numpy.

    x, y: (..., N); poses: (..., 3) broadcastable. Feedback-path map rebuilds
    run on host, where the keyframe store lives (float roundoff vs the jnp
    path is irrelevant there — the rebuilt map is our own extension, not a
    parity surface)."""
    t = poses[..., 2:3]
    ct, st = np.cos(t, dtype=np.float32), np.sin(t, dtype=np.float32)
    wx = ct * x + st * y + poses[..., 0:1]
    wy = -st * x + ct * y + poses[..., 1:2]
    return wx.astype(np.float32), wy.astype(np.float32)


class GraphSlam:
    """Host-side orchestrator. See module docstring.

    All per-keyframe bookkeeping (keyframe store, graph nodes/edges) lives in
    host numpy. The device sees exactly: one lax.scan per chunk (which also
    emits the gated scans), one batched closure-match per closure bucket, and
    one pose-graph optimize per chunk with accepted closures.
    """

    frontend = scan_matcher  # module providing init_state / slam_step

    def __init__(self, cfg: SlamConfig, lc: LoopClosureConfig = LoopClosureConfig(),
                 max_keyframes: int = 512):
        from lidar_slam_tpu.utils.profiling import StageTimer

        self.cfg = cfg
        self.lc = lc
        self.max_keyframes = max_keyframes
        self.angles = jnp.asarray(sensor.beam_angles(cfg.lidar))
        n = cfg.lidar.n_beams
        self._kf_x = np.zeros((max_keyframes, n), np.float32)
        self._kf_y = np.zeros((max_keyframes, n), np.float32)
        self._kf_valid = np.zeros((max_keyframes, n), bool)
        # per-keyframe EDT raster cache (host): computed once per keyframe in
        # bucketed dispatches, reused by every closure attempt against it
        self._kf_metric = np.zeros((max_keyframes, lc.raster_size,
                                    lc.raster_size), np.float32)
        self._kf_count = 0
        self._saturation_warned = False
        # edge lists (host): (i, j, z_std (3,), w (3,))
        self._edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.kf_poses: list[np.ndarray] = []   # ref-convention, host mirror
        self.kf_raw: list[np.ndarray] = []     # pose AT ADD TIME (frozen —
        #                                 _optimize rewrites kf_poses, not
        #                                 these; anchors for smoothed_path)
        self.kf_epoch: list[int] = []   # frame epoch at add time (feedback
        #                                 rewrites the frontend frame; raw
        #                                 poses are only comparable to path
        #                                 entries of the same epoch)
        self.path_epoch: list[int] = [0]
        self._epoch = 0
        self.closures: list[tuple[int, int]] = []
        self.weak_closures: list[tuple[int, int]] = []
        self.kf_times: list[int] = []   # scan index of each keyframe
        self._edge_speeds: list[float] = []  # per-scan speeds of accepted
        #                                 odometry edges (jump-gate baseline)
        self.jump_edges: list[tuple[int, int, int]] = []  # flagged jumps
        self._jump_kf: set[int] = set()  # keyframes right after a jump —
        #                                 widened closure search (see
        #                                 _closure_candidates)
        self.closure_rejects: dict = {}  # gate -> count (observability)
        self.attempt_log: list = []  # (k, i_old, avg_d, inlier, ambig_cells,
        #                               off_xy) per match attempt
        self._kf_cum: list[float] = []  # path length up to each keyframe (m),
        #                                 frozen at add time (drift budget of
        #                                 the consistency gate)
        self.timer = StageTimer()      # per-phase wall breakdown of run()

    # -- views ------------------------------------------------------------------
    @property
    def kf(self) -> KeyframeStore:
        return KeyframeStore(x=self._kf_x, y=self._kf_y, valid=self._kf_valid,
                             count=np.int32(self._kf_count))

    @property
    def graph(self) -> posegraph.PoseGraph:
        """Materialize the pose graph from the host mirrors (fixed shapes)."""
        g = posegraph.empty_graph(self.max_keyframes, self.max_keyframes * 4)
        k = self._kf_count
        poses = np.zeros((self.max_keyframes, 3), np.float32)
        if k:
            poses[:k] = np.stack([_np_ref_to_std(p) for p in self.kf_poses])
        e = min(len(self._edges), self.max_keyframes * 4)
        if e < len(self._edges) and not getattr(self, "_edge_warned", False):
            import warnings

            warnings.warn(
                f"pose-graph edge store saturated at {e}; "
                f"{len(self._edges) - e} edges dropped from optimization",
                stacklevel=2)
            self._edge_warned = True
        ei = np.zeros(self.max_keyframes * 4, np.int32)
        ej = np.zeros(self.max_keyframes * 4, np.int32)
        ez = np.zeros((self.max_keyframes * 4, 3), np.float32)
        ew = np.ones((self.max_keyframes * 4, 3), np.float32)
        for idx, (i, j, z, w) in enumerate(self._edges[:e]):
            ei[idx], ej[idx], ez[idx], ew[idx] = i, j, z, w
        return posegraph.PoseGraph(
            poses=jnp.asarray(poses),
            node_active=jnp.asarray(np.arange(self.max_keyframes) < k),
            n_nodes=jnp.int32(k),
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            edge_z=jnp.asarray(ez), edge_w=jnp.asarray(ew),
            edge_active=jnp.asarray(np.arange(self.max_keyframes * 4) < e),
            n_edges=jnp.int32(e))

    # -- keyframe bookkeeping (pure host) ----------------------------------------
    def _add_keyframe(self, scan_x, scan_y, scan_valid, pose_ref: np.ndarray,
                      scan_t: int = 0, quality: float = 0.0):
        k = self._kf_count
        if k >= self.max_keyframes:
            if not self._saturation_warned:
                import warnings

                warnings.warn(
                    f"GraphSlam keyframe store saturated at "
                    f"{self.max_keyframes}; further keyframes (and their "
                    f"closure opportunities) are dropped — raise "
                    f"max_keyframes for longer tours", stacklevel=2)
                self._saturation_warned = True
            return k - 1  # saturate (mirrors the fixed-capacity stores)
        self._kf_x[k] = np.asarray(scan_x)
        self._kf_y[k] = np.asarray(scan_y)
        self._kf_valid[k] = np.asarray(scan_valid)
        self._kf_count = k + 1
        pose_ref = np.asarray(pose_ref, np.float32)
        if k > 0:
            z = _np_between_std(_np_ref_to_std(self.kf_poses[-1]),
                                _np_ref_to_std(pose_ref))
            w = np.asarray([100.0, 100.0, 400.0], np.float32)
            # frontend-health weighting: clamp_frac > 0 means part of the
            # particle cloud escaped the scoring window this step — the
            # estimate is suspect, so its odometry edge softens (measured
            # on the building mis-registration: clamp_frac 0.02-0.15 over
            # the ~15-scan walk where the 2 m error entered). At cf=0.05
            # the edge halves; at 0.15 it carries ~1/10 weight.
            if quality > 0.0:
                w = w / np.float32(1.0 + (quality / 0.05) ** 2)
            # Kinematic jump gate: a keyframe-to-keyframe translation far
            # beyond the physical envelope (>4x the running-median per-scan
            # speed AND >0.5 m absolute) is a frontend RE-REGISTRATION
            # event (mis-registration entering, or the map snapping the
            # estimate back), not motion — recording it as a stiff
            # odometry edge bakes the discrepancy into a perfectly
            # self-consistent graph that no closure can bend (observed:
            # building-3800 PF stretch at ~2 m that optimize left
            # untouched because every residual was zero). The repair:
            # clamp the edge's translation to the kinematic bound and
            # weight it softly, so a final optimize translates the whole
            # mis-registered cluster back once its far end is constrained.
            step = float(np.hypot(z[0], z[1]))
            gap = max(scan_t - (self.kf_times[-1] if self.kf_times else 0), 1)
            speed = step / gap
            hist = self._edge_speeds[-100:]
            if (len(hist) >= 10 and step > 0.5
                    and speed > 4.0 * float(np.median(hist))):
                bound = 4.0 * float(np.median(hist)) * gap
                z = z.copy()
                z[:2] *= bound / step
                w = np.asarray([4.0, 4.0, 16.0], np.float32)
                self.jump_edges.append((k - 1, k, scan_t))
                self._jump_kf.add(k)
            else:
                self._edge_speeds.append(speed)
            self._edges.append((k - 1, k, z, w))
            self._kf_cum.append(self._kf_cum[-1] + float(
                np.hypot(*(pose_ref[:2] - self.kf_poses[-1][:2]))))
        else:
            self._kf_cum.append(0.0)
        self.kf_poses.append(pose_ref)
        self.kf_raw.append(pose_ref.copy())
        self.kf_epoch.append(self._epoch)
        self.kf_times.append(scan_t)
        return k

    def _compute_kf_metrics(self, kf_indices: list[int]) -> None:
        """Fill the host EDT-raster cache for newly added keyframes.

        Fixed-width buckets (pad by repeating the first index) keep one
        compiled program for every chunk; each bucket is one dispatch."""
        if not kf_indices:
            return
        lc = self.lc
        bucket = lc.closure_batch
        n_batches = (len(kf_indices) + bucket - 1) // bucket
        padded = kf_indices + [kf_indices[0]] * (n_batches * bucket
                                                 - len(kf_indices))
        for s in range(n_batches):
            o = padded[s * bucket: (s + 1) * bucket]
            m = _raster_edt_batch(
                jnp.asarray(self._kf_x[o]), jnp.asarray(self._kf_y[o]),
                jnp.asarray(self._kf_valid[o]), lc.raster_size,
                lc.raster_pixel)
            self._kf_metric[o] = np.asarray(m)

    def _closure_candidates(self, k: int) -> list[int]:
        """Old keyframes worth matching against keyframe ``k`` (pure host).

        Keyframes within a few frames after a detected re-registration jump
        get a widened search (3x radius, more candidates): the frontend
        just snapped back onto the map, so anchoring it to OLD keyframes is
        exactly what turns the soft jump edge into a correctable cluster —
        the regular 4 m radius misses revisits seen from across a hall."""
        lc = self.lc
        if k < lc.min_gap:
            return []
        wide = any(0 <= k - j <= 6 for j in self._jump_kf)
        max_dist = lc.max_dist * (3.0 if wide else 1.0)
        n_cand = (2 * lc.max_candidates) if wide else lc.max_candidates
        cur = self.kf_poses[k]
        old = [(i, float(np.hypot(*(p[:2] - cur[:2]))))
               for i, p in enumerate(self.kf_poses[: k - lc.min_gap + 1])]
        old = [c for c in old if c[1] < max_dist]
        old.sort(key=lambda c: c[1])
        return [i for i, _ in old[: n_cand]]

    def _try_loop_closures_batch(self, new_kf: list[int]) -> bool:
        """Match every (new keyframe, old candidate) pair of the chunk in ONE
        vmapped dispatch; accept/reject on host. Returns True if any closure
        was accepted. ``new_kf`` holds keyframe indices; the current scans
        come from the keyframe store (they ARE keyframe scans)."""
        lc = self.lc
        rows: list[tuple[int, int]] = []   # (k, i_old)
        for k in new_kf:
            for i_old in self._closure_candidates(k):
                rows.append((k, i_old))
        if not rows:
            return False
        # ONE fixed batch shape: every distinct vmap width would recompile
        # the correlation-volume program, and XLA:CPU's compile time for it
        # is pathological (minutes) — a single bucket size means a single
        # compile for the whole run. Chunks with more candidate pairs than
        # the bucket loop over same-shaped dispatches.
        b = len(rows)
        bucket = lc.closure_batch
        n_batches = (b + bucket - 1) // bucket
        padded = rows + [rows[0]] * (n_batches * bucket - b)
        ks = [k for k, _ in padded]
        olds = [i for _, i in padded]
        guesses = np.stack([_np_between_ref(self.kf_poses[i], self.kf_poses[k])
                            for k, i in padded])
        packs = []
        for s in range(n_batches):
            sl = slice(s * bucket, (s + 1) * bucket)
            o = olds[sl]
            kk = ks[sl]
            packs.append(np.asarray(_match_keyframes_batch(
                jnp.asarray(self._kf_metric[o]),
                jnp.asarray(self._kf_x[kk]), jnp.asarray(self._kf_y[kk]),
                jnp.asarray(self._kf_valid[kk]), jnp.asarray(guesses[sl]),
                lc)))
        packed = np.concatenate(packs)
        rels, avg_ds, inliers, ambigs = (packed[:, :3], packed[:, 3],
                                         packed[:, 4], packed[:, 5])

        n_cells = lc.n_theta * (2 * lc.window_half + 1) ** 2

        def reject(reason: str) -> None:
            self.closure_rejects[reason] = (
                self.closure_rejects.get(reason, 0) + 1)

        accepted: list[tuple[int, int, int]] = []   # (row, i_old, k)
        weak: list[tuple[int, int, int]] = []
        weak_per_kf: dict = {}
        for row in range(b):                   # skip padded rows
            i, k = olds[row], ks[row]
            off = rels[row] - guesses[row]
            self.attempt_log.append(
                (k, i, float(avg_ds[row]), float(inliers[row]),
                 float(ambigs[row] * n_cells),
                 float(np.hypot(off[0], off[1]))))
            # rail rejection: a "match" at the edge of the search window
            # means the true alignment is outside it (drift exceeded the
            # window) — railed solutions pass score tests with garbage.
            max_xy = 0.85 * lc.window_half * lc.raster_pixel
            max_th = 0.85 * (lc.n_theta // 2) * lc.theta_step
            if (abs(off[0]) > max_xy or abs(off[1]) > max_xy
                    or abs(off[2]) > max_th):
                reject("rail")
                continue
            # odometry-consistency gate: the implied correction must fit
            # inside the drift budget accumulated between the two keyframes
            budget = (lc.consistency_abs + lc.consistency_rel
                      * abs(self._kf_cum[k] - self._kf_cum[i]))
            if (abs(off[0]) > budget or abs(off[1]) > budget
                    or abs(off[2]) > budget):
                reject("consistency")
                continue
            strict = (avg_ds[row] <= lc.accept_avg_dist
                      and inliers[row] >= lc.min_inlier_frac
                      and ambigs[row] * n_cells <= lc.max_ambiguous_cells)
            if strict:
                accepted.append((row, i, k))
                continue
            # WEAK tier: SHARP (ambiguity-clean), full-overlap, rail- and
            # consistency-clean matches whose absolute score fails the
            # strict avg_dist gate. Hall-scale revisits legitimately score
            # avg_d 2-3.5 px (viewpoint shift moves occlusion boundaries;
            # measured: all 250 genuine tail->old revisit attempts on
            # building-3800 had inlier 1.0 but avg_d median 2.9 vs the 1.1
            # gate). Each weak closure keeps the sharpness gate (a HIGH but
            # UNIQUE minimum — dropping it admitted 628 aliased/noisy edges
            # whose 0.2 m-raster z bias dragged the whole run to 3 m ATE,
            # measured), goes through the same fine-raster refinement as
            # strong closures, and enters at ~1/10 weight: a healthy graph
            # barely feels them, but dozens of mutually-consistent weak
            # edges anchor a mis-registered cluster the strict gate would
            # leave floating. Weak-only chunks do NOT trigger the
            # optimize+feedback path (their influence lands at the next
            # strong-closure solve or the final one).
            if (lc.weak_closures and inliers[row] >= 0.9
                    and avg_ds[row] <= lc.weak_avg_dist
                    and ambigs[row] * n_cells <= lc.max_ambiguous_cells
                    and weak_per_kf.get(k, 0) < 2):
                weak.append((row, i, k))
                weak_per_kf[k] = weak_per_kf.get(k, 0) + 1
            else:
                reject("avg_dist" if avg_ds[row] > lc.accept_avg_dist
                       else ("inlier_frac"
                             if inliers[row] < lc.min_inlier_frac
                             else "ambiguity"))
        if not accepted and not weak:
            return False

        # fine-raster refinement of the accepted pairs — strong AND weak —
        # (one bucketed dispatch each): drops z noise from the coarse
        # raster's decimeter scale to the descent's millimeter resolution
        z_rel = {row: rels[row] for row, _, _ in accepted + weak}
        if lc.fine_refine:
            pairs = [(row, i, k) for row, i, k in accepted + weak]
            n_b2 = (len(pairs) + bucket - 1) // bucket
            padded2 = pairs + [pairs[0]] * (n_b2 * bucket - len(pairs))
            for s in range(n_b2):
                sl = padded2[s * bucket: (s + 1) * bucket]
                o2 = [i for _, i, _ in sl]
                k2 = [k for _, _, k in sl]
                g2 = np.stack([rels[row] for row, _, _ in sl])
                fine = np.asarray(_refine_rel_batch(
                    jnp.asarray(self._kf_x[o2]), jnp.asarray(self._kf_y[o2]),
                    jnp.asarray(self._kf_valid[o2]),
                    jnp.asarray(self._kf_x[k2]), jnp.asarray(self._kf_y[k2]),
                    jnp.asarray(self._kf_valid[k2]), jnp.asarray(g2),
                    pixel=lc.fine_pixel, size=lc.fine_size,
                    iters=lc.fine_iters, step_t0=lc.fine_step_t0,
                    step_r0=lc.fine_step_r0, max_range=lc.fine_range))
                for j, (row, _, _) in enumerate(sl[:len(pairs) - s * bucket]):
                    z_rel[row] = fine[j]

        for row, i, k in accepted:
            rel = z_rel[row]
            # convert measurement to the standard convention (theta negated)
            z_std = np.asarray([rel[0], rel[1], -rel[2]], np.float32)
            self._edges.append((i, k, z_std,
                                np.asarray([50.0, 50.0, 200.0], np.float32)))
            self.closures.append((i, k))
        for row, i, k in weak:
            rel = z_rel[row]
            z_std = np.asarray([rel[0], rel[1], -rel[2]], np.float32)
            self._edges.append((i, k, z_std,
                                np.asarray([5.0, 5.0, 20.0], np.float32)))
            self.weak_closures.append((i, k))
        return bool(accepted)

    def _optimize(self) -> float:
        """One damped-GN solve over the materialized graph; NaN-revert.

        Returns the max keyframe position move (m) the solve produced —
        callers gate the (expensive) frontend feedback on it; -1.0 on
        NaN-revert."""
        candidate = posegraph.optimize(self.graph, iters=10)
        opt = np.asarray(candidate.poses[: self._kf_count])
        if not np.isfinite(opt).all():
            # keep the unoptimized poses; the offending edge stays but robust
            # reweighting bounds its influence
            return -1.0
        old = np.stack([_np_ref_to_std(p) for p in self.kf_poses])
        delta = float(np.max(np.hypot(opt[:, 0] - old[:, 0],
                                      opt[:, 1] - old[:, 1]))) if len(old) else 0.0
        self.kf_poses = [_np_ref_to_std(p) for p in opt]  # std->ref (involution)
        return delta

    # -- frontend feedback ----------------------------------------------------
    def _post_chunk(self, state) -> None:
        """Hook for frontend-specific per-chunk bookkeeping (no-op here)."""

    def _rebuild_frontend(self, state):
        """Fold optimized keyframe poses back into the live frontend state.

        The frontend pose is re-expressed relative to the last keyframe
        (pose' = opt_k (+) (old_k (-) pose), anchored on the frontend's own
        record of its last keyframe pose), and the point map is rebuilt from
        the stored keyframe scans at their optimized poses (subsampled to
        capacity). All array math runs in host numpy with ONE packed fetch of
        the three frontend poses — the earlier device version round-tripped
        the whole (K, 1079) world-frame cloud per feedback. mini_updated is
        forced so the next step re-rasters the corrected map."""
        fb = np.asarray(jnp.stack([state.pmap.keyframe_pose, state.pose,
                                   state.prev_pose]))           # one fetch
        old_last, cur_pose, prev_pose = fb[0], fb[1], fb[2]
        new_last = self.kf_poses[-1]

        def correct(pose):
            z = _np_between_ref(old_last, np.asarray(pose))
            return _np_compose_ref(new_last, z)

        k = self._kf_count
        poses = np.stack(self.kf_poses)                         # (K, 3)
        wx, wy = _np_transform_ref(self._kf_x[:k], self._kf_y[:k], poses)
        v = self._kf_valid[:k]
        allpts = np.stack([wx[v], wy[v]], axis=1)
        cap = state.pmap.xy.shape[0]
        if len(allpts) > cap:
            allpts = allpts[:: int(np.ceil(len(allpts) / cap))][:cap]
        xy = np.zeros((cap, 2), np.float32)
        xy[: len(allpts)] = allpts

        new_pose = jnp.asarray(correct(cur_pose))
        return state._replace(
            pose=new_pose,
            prev_pose=jnp.asarray(correct(prev_pose)),
            mini_updated=jnp.bool_(True),
            pmap=state.pmap._replace(
                xy=jnp.asarray(xy),
                size=jnp.int32(len(allpts)),
                keyframe_pose=new_pose + 0.0),
        )

    # -- main loop ------------------------------------------------------------
    def run(self, ranges_all: np.ndarray, optimize_every_closure: bool = True,
            feedback: bool = True):
        """Returns (path (T,3) ref convention, optimized keyframe poses).

        The frontend runs in on-device ``lax.scan`` chunks of
        ``lc.chunk_size`` scans that also emit the gated scans; keyframe
        bookkeeping runs in host numpy, loop closures are matched in
        fixed-width batched dispatches, and the graph is optimized at most
        once per chunk."""
        chunk_size = self.lc.chunk_size
        cfg = self.cfg
        state = self.frontend.init_state(jnp.asarray(ranges_all[0]), cfg)
        scan0 = sensor.read_scan(jnp.asarray(ranges_all[0]), self.angles, cfg.lidar)
        self._add_keyframe(np.asarray(scan0.x), np.asarray(scan0.y),
                           np.asarray(scan0.valid), np.zeros(3, np.float32))
        self._compute_kf_metrics([0])  # keyframe 0 is a closure target too
        path = [np.zeros(3, np.float32)]
        slam_step = self.frontend.slam_step
        lidar_cfg = cfg.lidar
        bucket = self.lc.closure_batch

        @functools.partial(jax.jit, donate_argnums=(0,))
        def run_chunk(st, chunk_ranges):
            def body(s, r):
                s2, pose = slam_step(s, r, cfg, self.angles)
                scan = sensor.read_scan(r, self.angles, lidar_cfg)  # CSE'd
                # frontend health, when the frontend exposes one (the PF's
                # clamp_frac = fraction of particles escaping the scoring
                # window): keyframes recorded in unhealthy moments get soft
                # odometry edges so the graph can bend exactly there
                q = getattr(s2, "clamp_frac", None)
                q = jnp.float32(0.0) if q is None else jnp.float32(q)
                return s2, (pose, s2.mini_updated, q,
                            scan.x, scan.y, scan.valid)

            st2, (poses, flags, quals, sx, sy, sv) = jax.lax.scan(
                body, st, chunk_ranges)
            # poses+flags+quality packed: the host needs them every chunk,
            # the scans only for the few keyframe rows — one small fetch
            packed = jnp.concatenate(
                [poses, flags[:, None].astype(jnp.float32),
                 quals[:, None]], axis=1)
            return st2, packed, sx, sy, sv

        @jax.jit
        def gather_rows(sx, sy, sv, idx):
            return jnp.stack([jnp.take(sx, idx, axis=0),
                              jnp.take(sy, idx, axis=0),
                              jnp.take(sv, idx, axis=0).astype(jnp.float32)],
                             axis=1)                        # (B, 3, N)

        t = 1
        while t < len(ranges_all):
            n_real = min(chunk_size, len(ranges_all) - t)
            chunk_np = ranges_all[t: t + n_real]
            if n_real < chunk_size:
                # pad the trailing chunk to the fixed shape (repeating the
                # last scan) so run_chunk never recompiles; padded steps'
                # outputs are dropped and only perturb the final state by a
                # few in-place re-matches of the same scan
                chunk_np = np.concatenate(
                    [chunk_np, np.repeat(chunk_np[-1:], chunk_size - n_real,
                                         axis=0)], axis=0)
            chunk = jnp.asarray(chunk_np)
            with self.timer.stage("frontend_chunk"):
                state, packed, sx_c, sy_c, sv_c = run_chunk(state, chunk)
                packed = np.asarray(packed)                 # one fetch
            poses_c = packed[:, :3]
            flags_c = packed[:, 3] > 0.5
            quals_c = packed[:, 4]
            kf_rows = [i for i in range(n_real) if flags_c[i]]
            # fetch only the keyframe rows' gated scans, in fixed-width
            # buckets (one compiled gather program, one fetch per bucket)
            blk = {}
            with self.timer.stage("kf_fetch"):
                for s in range(0, len(kf_rows), bucket):
                    rows = kf_rows[s: s + bucket]
                    idx = rows + [rows[0]] * (bucket - len(rows))
                    got = np.asarray(gather_rows(sx_c, sy_c, sv_c,
                                                 jnp.asarray(idx)))
                    for j, r in enumerate(rows):
                        blk[r] = got[j]
            # pass 1: register this chunk's keyframes (closure candidates
            # only ever look backward, so batching the adds is neutral)
            new_kf = []
            for i in range(n_real):
                path.append(poses_c[i])
                self.path_epoch.append(self._epoch)
                if not flags_c[i]:
                    continue
                k = self._add_keyframe(blk[i][0], blk[i][1],
                                       blk[i][2] > 0.5, poses_c[i],
                                       scan_t=t + i,
                                       quality=float(quals_c[i]))
                new_kf.append(k)
            with self.timer.stage("kf_raster_edt"):
                self._compute_kf_metrics(sorted(set(new_kf)))
            # frontend-specific bookkeeping (e.g. submap-anchor association)
            # before any optimization rewrites kf_poses
            self._post_chunk(state)
            # pass 2: all the chunk's loop-closure candidates in one
            # dispatch, then at most one optimize for the chunk
            with self.timer.stage("closure_match"):
                any_closed = self._try_loop_closures_batch(new_kf)
            if any_closed and optimize_every_closure:
                with self.timer.stage("optimize"):
                    delta = self._optimize()
                if delta > 0.01 and feedback:
                    # feedback only when the solve actually moved a keyframe
                    # (> 1 cm) — steady-state closures that confirm the
                    # current geometry don't pay a map rebuild
                    with self.timer.stage("feedback"):
                        state = self._rebuild_frontend(state)
                    self._epoch += 1
            t += n_real

        # final solve: closures (and soft jump edges) accepted near the end
        # may never have triggered an optimize, and the jump-gate repair
        # only takes effect once BOTH sides of a mis-registered cluster are
        # constrained — one more damped-GN pass is a single dispatch
        if self.closures or self.weak_closures or self.jump_edges:
            with self.timer.stage("optimize"):
                self._optimize()

        opt_poses = list(self.kf_poses)
        self.final_state = state  # for map export by callers/subclasses
        self._last_path = np.stack(path)
        return self._last_path, np.stack(opt_poses)

    def smoothed_path(self, path: np.ndarray | None = None) -> np.ndarray:
        """Post-hoc graph-smoothed trajectory — the standard output of a
        pose-graph SLAM system (the online path keeps whatever drift each
        scan had when it was estimated; the smoothed path re-expresses
        every pose relative to its nearest keyframe of the same frame
        epoch and composes it onto that keyframe's OPTIMIZED pose, so
        closure corrections propagate to the whole tour, past included).

        Frame epochs: every feedback rewrite changes the frontend's frame;
        raw keyframe anchors are only comparable to path entries recorded
        in the same epoch (``kf_epoch`` / ``path_epoch``)."""
        if path is None:
            path = self._last_path
        path = np.asarray(path)
        out = path.copy()
        if not self.kf_poses:
            return out
        kf_t = np.asarray(self.kf_times)
        kf_ep = np.asarray(self.kf_epoch)
        for t in range(len(path)):
            ep = self.path_epoch[t] if t < len(self.path_epoch) else kf_ep[-1]
            same = np.nonzero(kf_ep == ep)[0]
            if len(same) == 0:       # epoch without keyframes (rare):
                same = np.arange(len(kf_t))   # nearest overall, approximate
            i = int(same[np.argmin(np.abs(kf_t[same] - t))])
            z = _np_between_ref(self.kf_raw[i], path[t])
            out[t] = _np_compose_ref(self.kf_poses[i], z)
        return out
