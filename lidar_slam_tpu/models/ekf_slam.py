"""FastSLAM with per-particle landmark EKFs — fully vmapped/batched.

BASELINE.json config 2 ("1k particles, vmapped per-particle landmark EKF +
batched importance weighting"). The grid-based filter (``fastslam.py``) shares
one occupancy map; this model family is the Rao-Blackwellized *landmark*
formulation: each particle carries an independent bank of 2-D landmark EKFs
(mean + covariance), updated in closed form.

Design: there is no per-landmark loop anywhere. Every step does
the EKF update for ALL (particle, landmark) pairs as (P, L)-batched 2x2
linear algebra (closed-form inverses, no solves), then selects between
{update, initialize, keep} with masks. For P=10k, L=64 that is ~10 MFLOP of
elementwise arithmetic per step.

Conventions: poses use the reference convention (w = A(theta) p + t,
A = [[c, s], [-s, c]]); a landmark at world offset (dx, dy) is observed at
range |d| and sensor-frame bearing atan2(dy, dx) + theta.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lidar_slam_tpu.core import se2

# f32 contractions run at full precision on every backend (no TF32)
HIGHEST = jax.lax.Precision.HIGHEST


class EkfSlamConfig(NamedTuple):
    n_particles: int = 1024
    max_landmarks: int = 16
    r_noise: float = 0.05       # measurement std (range, m)
    b_noise: float = 0.015      # measurement std (bearing, rad)
    odo_xy_noise: float = 0.006  # proposal noise around odometry
    odo_th_noise: float = 0.002
    resample_threshold: float = 0.5
    # unknown (per-particle max-likelihood) association — the scan-driven path
    new_lm_logp0: float = -7.0   # log pseudo-likelihood of a new landmark:
    #                              a detection whose best per-particle match
    #                              scores below this initializes a new slot
    use_scan_odometry: bool = False  # motion prior from the batched
    #                              scan-to-scan matcher pre-pass
    #                              (ops/scan_odometry.pairwise_odometry)
    #                              instead of per-particle constant velocity.
    #                              The dataset is ranges-only, so this is the
    #                              only odometry available; it bounds drift
    #                              through landmark-poor stretches where the
    #                              filter is otherwise under-constrained.
    r_noise_per_m: float = 0.0   # range-proportional measurement std growth:
    #                              a corner intersection is fitted from ~k
    #                              beams whose spacing grows linearly with
    #                              range, so its position error does too.
    #                              Constant noise makes far detections
    #                              overconfident AND gates true far
    #                              re-observations out as "new" landmarks,
    #                              flooding the bank with shifted duplicates.


def long_tour_config(n_particles: int = 1024) -> EkfSlamConfig:
    """The tuned scan-driven config — the ONE place it lives (CLI ``run
    --mode ekf`` and ``bench.py`` both use it; round 2 duplicated the numbers
    in both and they drifted).

    Range-scaled measurement noise + wide proposal + late resampling keep the
    sparse-landmark filter bounded (~1 m over the full 1000-scan museum tour
    incl. a landmark-poor room transition; the landmark-rich envelope is
    pinned < 0.1 m at 400 scans in tests)."""
    return EkfSlamConfig(
        n_particles=n_particles, max_landmarks=64, r_noise=0.02,
        r_noise_per_m=0.015, b_noise=0.008, odo_xy_noise=0.02,
        odo_th_noise=0.02, new_lm_logp0=-11.0, resample_threshold=0.25,
        use_scan_odometry=True)
    # odo_xy_noise 0.02 ~= the scan-odometry corridor jitter (swept 0.012 /
    # 0.02 / 0.03 on museum-1000: 0.98 / 0.67-0.71 / 0.99 m ATE) — the
    # proposal must match the odometry's real error, not its rotation-axis
    # accuracy (ops/scan_odometry docstring).


LONG_TOUR_MAX_RANGE = 12.0  # detection gating range pairing with the config


class EkfSlamState(NamedTuple):
    poses: jnp.ndarray      # (P, 3)
    prev_poses: jnp.ndarray  # (P, 3) — constant-velocity memory (scan mode)
    logw: jnp.ndarray       # (P,)
    lm_mean: jnp.ndarray    # (P, L, 2)
    lm_cov: jnp.ndarray     # (P, L, 2, 2)
    lm_seen: jnp.ndarray    # (P, L) bool — per-particle under ML association
    rng: jnp.ndarray


def init_ekf_slam(cfg: EkfSlamConfig, seed: int = 0) -> EkfSlamState:
    p, l = cfg.n_particles, cfg.max_landmarks
    return EkfSlamState(
        poses=jnp.zeros((p, 3), jnp.float32),
        prev_poses=jnp.zeros((p, 3), jnp.float32),
        logw=jnp.zeros(p, jnp.float32),
        lm_mean=jnp.zeros((p, l, 2), jnp.float32),
        lm_cov=jnp.tile(jnp.eye(2, dtype=jnp.float32) * 1e4, (p, l, 1, 1)),
        lm_seen=jnp.zeros((p, l), jnp.bool_),
        rng=jax.random.PRNGKey(seed),
    )


def _compose_ref(pose: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """compose in the reference convention: result applies delta in pose's frame."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x = pose[..., 0] + c * delta[..., 0] + s * delta[..., 1]
    y = pose[..., 1] - s * delta[..., 0] + c * delta[..., 1]
    return jnp.stack([x, y, pose[..., 2] + delta[..., 2]], axis=-1)


def _inv2(m: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form 2x2 inverse + determinant (batched)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = jnp.stack([jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2)
    return inv / det[..., None, None], det


def _mm2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 2x2 @ 2x2 as elementwise math (broadcasts like ``@``).

    Deliberately NOT a dot_general: a default-precision f32 dot may round
    its inputs (to TF32 or bf16, by backend), and the EKF-bank recursion
    (covariances feed the next step's gains for 1000 steps) amplifies that
    rounding into trajectory-level error. Elementwise keeps full f32 at the
    same FLOPs."""
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    b00, b01 = b[..., 0, 0], b[..., 0, 1]
    b10, b11 = b[..., 1, 0], b[..., 1, 1]
    return jnp.stack([
        jnp.stack([a00 * b00 + a01 * b10, a00 * b01 + a01 * b11], -1),
        jnp.stack([a10 * b00 + a11 * b10, a10 * b01 + a11 * b11], -1)], -2)


def _mv2(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched 2x2 @ 2-vector, elementwise (see _mm2)."""
    return jnp.stack([m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1],
                      m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]], -1)


def ekf_slam_step(state: EkfSlamState, odo: jnp.ndarray, obs: jnp.ndarray,
                  vis: jnp.ndarray, cfg: EkfSlamConfig
                  ) -> tuple[EkfSlamState, jnp.ndarray]:
    """One step: propagate + per-(particle, landmark) EKF update + resample.

    odo: (3,) relative motion; obs: (L, 2) (range, bearing); vis: (L,) bool.
    Returns (state, estimated pose)."""
    p, l = cfg.n_particles, cfg.max_landmarks
    key, k_noise, k_resample = jax.random.split(state.rng, 3)

    # --- propagate through odometry with per-particle noise
    noise = jax.random.normal(k_noise, (p, 3)) * jnp.asarray(
        [cfg.odo_xy_noise, cfg.odo_xy_noise, cfg.odo_th_noise], jnp.float32)
    poses = _compose_ref(state.poses, odo[None, :] + noise)     # (P, 3)

    # --- batched EKF: all (P, L) pairs at once
    px, py, pth = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]   # (P, 1)
    dx = state.lm_mean[..., 0] - px                              # (P, L)
    dy = state.lm_mean[..., 1] - py
    r2 = jnp.maximum(dx * dx + dy * dy, 1e-6)
    r = jnp.sqrt(r2)
    zr = obs[None, :, 0]                                         # (1, L)
    zb = obs[None, :, 1]
    r_noise2 = jnp.float32(cfg.r_noise ** 2)
    b_noise2 = jnp.float32(cfg.b_noise ** 2)

    # innovation (range, bearing); bearing = atan2(dy,dx) + theta (ref conv)
    nu_r = zr - r
    nu_b = se2.wrap_angle(zb - (jnp.arctan2(dy, dx) + pth))
    nu = jnp.stack([nu_r, nu_b], axis=-1)                        # (P, L, 2)

    # H = d(h)/d(landmark): rows (range, bearing)
    h = jnp.stack([
        jnp.stack([dx / r, dy / r], -1),
        jnp.stack([-dy / r2, dx / r2], -1),
    ], axis=-2)                                                  # (P, L, 2, 2)

    pcov = state.lm_cov
    hp = _mm2(h, pcov)                                           # (P, L, 2, 2)
    s_mat = _mm2(hp, jnp.swapaxes(h, -1, -2))
    s_mat = s_mat + jnp.asarray([[r_noise2, 0.0], [0.0, b_noise2]])
    s_inv, s_det = _inv2(s_mat)
    k_gain = _mm2(jnp.swapaxes(hp, -1, -2), s_inv)               # P H^T S^-1
    upd_mean = state.lm_mean + _mv2(k_gain, nu)
    upd_cov = pcov - _mm2(k_gain, hp)
    loglik = -0.5 * (jnp.sum(nu * _mv2(s_inv, nu), -1)
                     + jnp.log(jnp.maximum(s_det, 1e-12))
                     + 2.0 * jnp.log(2.0 * jnp.pi))              # (P, L)

    # --- initialization branch for first sightings
    ang = zb - pth                                               # world angle
    init_mean = jnp.stack([px + zr * jnp.cos(ang),
                           py + zr * jnp.sin(ang)], axis=-1)     # (P, L, 2)
    j_cos, j_sin = jnp.cos(ang), jnp.sin(ang)
    jac = jnp.stack([
        jnp.stack([j_cos, -zr * j_sin], -1),
        jnp.stack([j_sin, zr * j_cos], -1),
    ], axis=-2)                                                  # (P, L, 2, 2)
    meas_cov = jnp.asarray([[cfg.r_noise ** 2, 0.0],
                            [0.0, cfg.b_noise ** 2]], jnp.float32)
    init_cov = _mm2(_mm2(jac, meas_cov), jnp.swapaxes(jac, -1, -2))

    # --- select per (landmark) branch: update / init / keep
    seen = state.lm_seen                                         # (P, L)
    visb = vis[None, :]
    do_upd = (visb & seen)[..., None]
    do_init = (visb & ~seen)[..., None]
    new_mean = jnp.where(do_upd, upd_mean,
                         jnp.where(do_init, init_mean, state.lm_mean))
    new_cov = jnp.where(do_upd[..., None], upd_cov,
                        jnp.where(do_init[..., None], init_cov, state.lm_cov))
    logw = state.logw + jnp.sum(jnp.where(visb & seen, loglik, 0.0), axis=1)
    logw = logw - jnp.max(logw)

    # --- resample (branchless ESS gate; ancestors carry their landmark banks)
    w = jax.nn.softmax(logw)
    ess = 1.0 / jnp.sum(w * w)
    c = jnp.cumsum(w)
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    u = u0 + jnp.arange(p, dtype=jnp.float32) / p
    idx_rs = jnp.clip(jnp.searchsorted(c, u), 0, p - 1)
    do_rs = ess < cfg.resample_threshold * p
    idx = jnp.where(do_rs, idx_rs, jnp.arange(p))
    prev = jnp.where(do_rs, state.poses[idx], state.poses)
    poses = poses[idx]
    new_mean = new_mean[idx]
    new_cov = new_cov[idx]
    new_seen = (state.lm_seen | visb)[idx]
    logw = jnp.where(do_rs, jnp.zeros_like(logw), logw)

    est = jnp.sum(jax.nn.softmax(logw)[:, None] * poses, axis=0)
    new_state = EkfSlamState(poses=poses, prev_poses=prev, logw=logw,
                             lm_mean=new_mean, lm_cov=new_cov,
                             lm_seen=new_seen, rng=key)
    return new_state, est


def _landmark_likelihoods(state: EkfSlamState, poses: jnp.ndarray,
                          zr: jnp.ndarray, zb: jnp.ndarray,
                          cfg: EkfSlamConfig):
    """Batched 2x2 EKF math for ONE observation against all (P, L) pairs.

    Returns (loglik (P, L), upd_mean (P, L, 2), upd_cov (P, L, 2, 2),
    init_mean (P, L->(P,) broadcastable, 2), init_cov)."""
    px, py, pth = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]   # (P, 1)
    dx = state.lm_mean[..., 0] - px                              # (P, L)
    dy = state.lm_mean[..., 1] - py
    r2 = jnp.maximum(dx * dx + dy * dy, 1e-6)
    r = jnp.sqrt(r2)
    r_sig = jnp.float32(cfg.r_noise) + jnp.float32(cfg.r_noise_per_m) * zr
    r_noise2 = r_sig * r_sig
    b_noise2 = jnp.float32(cfg.b_noise ** 2)

    nu_r = zr - r                                                # (P, L)
    nu_b = se2.wrap_angle(zb - (jnp.arctan2(dy, dx) + pth))
    nu = jnp.stack([nu_r, nu_b], axis=-1)                        # (P, L, 2)
    h = jnp.stack([
        jnp.stack([dx / r, dy / r], -1),
        jnp.stack([-dy / r2, dx / r2], -1),
    ], axis=-2)                                                  # (P, L, 2, 2)
    pcov = state.lm_cov
    hp = _mm2(h, pcov)
    s_mat = _mm2(hp, jnp.swapaxes(h, -1, -2))
    s_mat = s_mat + jnp.asarray([[r_noise2, 0.0], [0.0, b_noise2]])
    s_inv, s_det = _inv2(s_mat)
    k_gain = _mm2(jnp.swapaxes(hp, -1, -2), s_inv)
    upd_mean = state.lm_mean + _mv2(k_gain, nu)
    upd_cov = pcov - _mm2(k_gain, hp)
    loglik = -0.5 * (jnp.sum(nu * _mv2(s_inv, nu), -1)
                     + jnp.log(jnp.maximum(s_det, 1e-12))
                     + 2.0 * jnp.log(2.0 * jnp.pi))              # (P, L)

    ang = zb - pth[..., 0]                                       # (P,)
    init_mean = jnp.stack([poses[:, 0] + zr * jnp.cos(ang),
                           poses[:, 1] + zr * jnp.sin(ang)], axis=-1)  # (P, 2)
    j_cos, j_sin = jnp.cos(ang), jnp.sin(ang)
    jac = jnp.stack([
        jnp.stack([j_cos, -zr * j_sin], -1),
        jnp.stack([j_sin, zr * j_cos], -1),
    ], axis=-2)                                                  # (P, 2, 2)
    meas_cov = jnp.stack([
        jnp.stack([r_noise2, jnp.float32(0.0)]),
        jnp.stack([jnp.float32(0.0), b_noise2]),
    ])                                                           # (2, 2)
    init_cov = _mm2(_mm2(jac, meas_cov), jnp.swapaxes(jac, -1, -2))  # (P,2,2)
    return loglik, upd_mean, upd_cov, init_mean, init_cov


def ekf_slam_step_ml(state: EkfSlamState, obs: jnp.ndarray, obs_valid: jnp.ndarray,
                     cfg: EkfSlamConfig,
                     odo: jnp.ndarray | None = None,
                     aux_loglik_fn=None) -> tuple[EkfSlamState, jnp.ndarray]:
    """FastSLAM 1.0 step with per-particle MAXIMUM-LIKELIHOOD association.

    ``aux_loglik_fn(poses (P, 3)) -> (P,)`` optionally adds an extra
    per-particle observation log-likelihood (evaluated on the refined
    proposal poses, before resampling). The hybrid grid+landmark model
    (``models/ekf_hybrid.py``) passes the correlation-volume grid term here
    so corridor stretches with no corner landmarks stay constrained.

    The scan-driven path (BASELINE config 2 made real): obs (M, 2) are
    range/bearing detections from ``ops/landmarks.extract_landmarks`` —
    unordered, with misses and spurious hits. Particles propagate by scan-
    to-scan odometry (``odo`` (3,), reference-convention delta from
    ops/scan_odometry — required when cfg.use_scan_odometry) or by their own
    constant velocity; each detection is processed sequentially
    (``lax.scan`` over M <= 16), choosing per particle the landmark slot with
    the highest likelihood, or initializing a fresh slot when the best score
    falls below ``cfg.new_lm_logp0`` (the classic new-feature pseudo-
    likelihood gate). All per-detection math stays (P, L)-batched 2x2 algebra.
    """
    p, l = cfg.n_particles, cfg.max_landmarks
    # 4-way split (one spare): the measured long_tour tuning was done on
    # this stream; collapsing to 3 would shift every draw
    key, k_noise, _k_spare, k_resample = jax.random.split(state.rng, 4)

    # --- propagate + proposal noise
    noise = jax.random.normal(k_noise, (p, 3)) * jnp.asarray(
        [cfg.odo_xy_noise, cfg.odo_xy_noise, cfg.odo_th_noise], jnp.float32)
    if cfg.use_scan_odometry:
        if odo is None:
            raise ValueError(
                "cfg.use_scan_odometry=True requires an `odo` (3,) delta "
                "(see ops/scan_odometry.pairwise_odometry)")
        # delta applied in each particle's own frame (reference convention).
        # Isotropic proposal noise sized to the scan-odometry corridor
        # jitter (~0.02 m) measured best; an anisotropic variant (extra
        # noise along the delta direction only) was tried and measured
        # WORSE on museum-1000 (0.87-1.0 m vs 0.67 m) — the error direction
        # during turns is not the travel direction, and starving cross-track
        # diversity costs more than the along-track focus buys.
        poses = _compose_ref(state.poses, odo[None, :] + noise)
    else:
        vel = state.poses - state.prev_poses
        poses = state.poses + vel + noise

    log_p0 = jnp.float32(cfg.new_lm_logp0)
    det_rows = jnp.concatenate(
        [obs, obs_valid.astype(jnp.float32)[:, None]], axis=1)   # (M, 3)

    # --- FastSLAM-2.0-style proposal refinement: per-particle damped
    # Gauss-Newton on the pose against its ML-associated landmarks (means
    # held fixed). Without external odometry the constant-velocity proposal
    # alone caps accuracy at the random-walk level; one batched 3x3 solve per
    # particle pulls each particle onto its own observation manifold before
    # weighting. All detections are associated and accumulated in ONE
    # (M, P, L)-batched pass (the landmark means are frozen during GN, so
    # per-detection sequencing is a no-op) — the round-2 ``lax.scan`` over
    # M <= 16 detections x 2 passes serialized 32 tiny (P, L) iterations and
    # capped the whole model at 30 scans/s.
    b_w = jnp.float32(1.0 / cfg.b_noise ** 2)
    zr_m = det_rows[:, 0][:, None, None]       # (M, 1, 1)
    zb_m = det_rows[:, 1][:, None, None]
    dval_m = det_rows[:, 2] > 0.5              # (M,)
    r_sig_m = jnp.float32(cfg.r_noise) + jnp.float32(cfg.r_noise_per_m) * zr_m
    r_w_m = 1.0 / (r_sig_m * r_sig_m)          # (M, 1, 1)

    def gn_step(poses_in):
        px, py, pth = poses_in[:, 0:1], poses_in[:, 1:2], poses_in[:, 2:3]
        dx = state.lm_mean[..., 0] - px        # (P, L)
        dy = state.lm_mean[..., 1] - py
        r2 = jnp.maximum(dx * dx + dy * dy, 1e-6)
        r = jnp.sqrt(r2)
        bearing = jnp.arctan2(dy, dx) + pth    # (P, L)
        nu_r = zr_m - r[None]                  # (M, P, L)
        nu_b = se2.wrap_angle(zb_m - bearing[None])
        ll = -0.5 * (nu_r * nu_r * r_w_m + nu_b * nu_b * b_w)
        ll = jnp.where(state.lm_seen[None], ll, -jnp.inf)
        j = jnp.argmax(ll, axis=2)             # (M, P)
        ll_b = jnp.max(ll, axis=2)
        take = (dval_m[:, None] & (ll_b > 2.0 * log_p0)
                & jnp.any(state.lm_seen, axis=1)[None])          # (M, P)
        pidx = jnp.arange(p)[None, :]
        dxj, dyj = dx[pidx, j], dy[pidx, j]    # (M, P)
        rj, r2j = r[pidx, j], r2[pidx, j]
        nrj = jnp.take_along_axis(nu_r, j[..., None], 2)[..., 0]
        nbj = jnp.take_along_axis(nu_b, j[..., None], 2)[..., 0]
        # rows: d(range)/d(pose), d(bearing)/d(pose); ref conv b = atan2+th
        h_r = jnp.stack([-dxj / rj, -dyj / rj, jnp.zeros_like(rj)], -1)
        h_b = jnp.stack([dyj / r2j, -dxj / r2j, jnp.ones_like(rj)], -1)
        w_r = take.astype(jnp.float32) * r_w_m[:, :, 0]          # (M, P)
        w_b = take.astype(jnp.float32) * b_w
        # Broadcast-multiply-sum, NOT einsum/dot: f32 here is load-bearing.
        # A default-precision dot may round its inputs to bf16 or TF32, and
        # that rounding of the ~1e4-scale weights biases the mm-scale GN
        # delta; the bias compounds over a 1000-step tour into total
        # divergence (measured: ATE 1.2 m f32 -> 16-60 m bf16). Elementwise
        # ops keep full f32 at identical FLOP count (M*P*9 ~ 3e5).
        hth = (jnp.sum(w_r[..., None, None] * h_r[..., :, None]
                       * h_r[..., None, :], axis=0)
               + jnp.sum(w_b[..., None, None] * h_b[..., :, None]
                         * h_b[..., None, :], axis=0))           # (P, 3, 3)
        htn = (jnp.sum((w_r * nrj)[..., None] * h_r, axis=0)
               + jnp.sum((w_b * nbj)[..., None] * h_b, axis=0))  # (P, 3)
        # damped solve (H^T W H + lambda I) delta = H^T W nu via the explicit
        # symmetric-3x3 adjugate — elementwise f32, no LU/dot lowering.
        damp = jnp.asarray([100.0, 100.0, 400.0], jnp.float32)  # prior stiffness
        a = hth + jnp.diag(damp)[None]
        a00, a01, a02 = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
        a11, a12, a22 = a[:, 1, 1], a[:, 1, 2], a[:, 2, 2]
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)  # damp => det >> 0
        b0, b1, b2 = htn[:, 0], htn[:, 1], htn[:, 2]
        delta = jnp.stack([
            (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
            (c01 * b0 + c11 * b1 + c12 * b2) * inv_det,
            (c02 * b0 + c12 * b1 + c22 * b2) * inv_det], axis=-1)  # (P, 3)
        cap = jnp.asarray([0.05, 0.05, 0.02], jnp.float32)
        return poses_in + jnp.clip(delta, -cap, cap)

    for _ in range(2):
        poses = gn_step(poses)

    def process_det(carry, det):
        lm_mean, lm_cov, seen, logw_add = carry
        zr, zb, dval = det[0], det[1], det[2] > 0.5
        st = state._replace(lm_mean=lm_mean, lm_cov=lm_cov)
        loglik, upd_mean, upd_cov, init_mean, init_cov = \
            _landmark_likelihoods(st, poses, zr, zb, cfg)
        loglik = jnp.where(seen, loglik, -jnp.inf)               # (P, L)
        best = jnp.argmax(loglik, axis=1)                        # (P,)
        best_ll = jnp.max(loglik, axis=1)
        first_free = jnp.argmin(seen, axis=1)                    # first False
        full = jnp.all(seen, axis=1)
        # Bank full: evict the most-uncertain slot (largest covariance trace)
        # instead of dropping the detection. Spurious spawns carry a large
        # init covariance (especially at range) and never converge, so junk
        # evicts junk while established landmarks are untouchable — without
        # this the bank saturates with shifted duplicates and the gate then
        # forces every true re-observation to be dropped (observed: steady
        # drift from scan ~300 on museum-1000 once all slots filled).
        cov_tr = lm_cov[..., 0, 0] + lm_cov[..., 1, 1]           # (P, L)
        evict = jnp.argmax(cov_tr, axis=1)                       # (P,)
        spawn_slot = jnp.where(full, evict, first_free)
        make_new = best_ll < log_p0                              # (P,)
        slot = jnp.where(make_new, spawn_slot, best)             # (P,)
        sel = slot[:, None] == jnp.arange(l)[None, :]            # (P, L)
        act = dval & jnp.ones_like(make_new)                     # (P,)
        upd_sel = (sel & ~make_new[:, None] & act[:, None])[..., None]
        new_sel = (sel & make_new[:, None] & act[:, None])[..., None]
        lm_mean = jnp.where(upd_sel, upd_mean,
                            jnp.where(new_sel, init_mean[:, None, :], lm_mean))
        lm_cov = jnp.where(upd_sel[..., None], upd_cov,
                           jnp.where(new_sel[..., None],
                                     init_cov[:, None, :, :], lm_cov))
        seen = seen | (sel & act[:, None])
        contrib = jnp.where(make_new, log_p0, best_ll)
        logw_add = logw_add + jnp.where(dval, contrib, 0.0)
        return (lm_mean, lm_cov, seen, logw_add), None

    (lm_mean, lm_cov, seen, logw_add), _ = jax.lax.scan(
        process_det, (state.lm_mean, state.lm_cov, state.lm_seen,
                      jnp.zeros(p, jnp.float32)), det_rows)
    if aux_loglik_fn is not None:
        logw_add = logw_add + aux_loglik_fn(poses)
    logw = state.logw + logw_add
    logw = logw - jnp.max(logw)

    # --- resample (branchless ESS gate)
    w = jax.nn.softmax(logw)
    ess = 1.0 / jnp.sum(w * w)
    c = jnp.cumsum(w)
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    u = u0 + jnp.arange(p, dtype=jnp.float32) / p
    idx_rs = jnp.clip(jnp.searchsorted(c, u), 0, p - 1)
    do_rs = ess < cfg.resample_threshold * p
    idx = jnp.where(do_rs, idx_rs, jnp.arange(p))
    prev = jnp.where(do_rs, state.poses[idx], state.poses)
    new_state = EkfSlamState(
        poses=poses[idx], prev_poses=prev,
        logw=jnp.where(do_rs, jnp.zeros_like(logw), logw),
        lm_mean=lm_mean[idx], lm_cov=lm_cov[idx], lm_seen=seen[idx], rng=key)
    est = jnp.sum(jax.nn.softmax(new_state.logw)[:, None] * new_state.poses,
                  axis=0)
    return new_state, est


@functools.partial(jax.jit, static_argnames=("cfg",))
def _run_ml_jit(obs_all, valid_all, odo_all, cfg: EkfSlamConfig, seed):
    state = init_ekf_slam(cfg, seed)

    def body(st, inp):
        z, v, o = inp
        return ekf_slam_step_ml(st, z, v, cfg, odo=o)

    # NOTE: all linear algebra inside the step is explicit elementwise math
    # (_mm2/_mv2/adjugate solve) — no dot_general anywhere, so no backend
    # precision default can round it.
    final, path = jax.lax.scan(body, state, (obs_all, valid_all, odo_all))
    return jnp.concatenate([jnp.zeros((1, 3), jnp.float32), path]), final


def run_ekf_slam_scan(ranges_all: np.ndarray, cfg: EkfSlamConfig,
                      lidar_cfg=None, seed: int = 0, max_range: float = 18.0,
                      include_pillars: bool = False, **extract_kw):
    """Scan-driven EKF-FastSLAM: raw ranges -> landmark detections -> ML-
    association particle filter. Consumes the same (T, 1079) CSV/array as
    every other mode (reference format, main.c:22-30).

    Observations default to wall-intersection corners only
    (ops/landmarks.extract_corners): a corner is an exact world point, while
    a pillar's visible-arc centroid wanders by ~its radius with viewpoint —
    mixing pillars in raises museum-400 ATE from ~0.08 m to ~0.15 m. Set
    ``include_pillars=True`` for corner-poor environments.
    """
    import jax as _jax

    from lidar_slam_tpu.config import LidarConfig
    from lidar_slam_tpu.core.sensor import beam_angles
    from lidar_slam_tpu.ops import landmarks as lm_ops

    lidar_cfg = lidar_cfg or LidarConfig()
    angles = jnp.asarray(beam_angles(lidar_cfg))
    common = dict(range_min=lidar_cfg.range_min,
                  usable_range=lidar_cfg.usable_range, max_range=max_range)
    if include_pillars:
        det = lm_ops.extract_landmarks_batch(
            jnp.asarray(ranges_all, jnp.float32), angles, corners=True,
            **common, **extract_kw)
    else:
        fn = lambda r: lm_ops.extract_corners(r, angles, **common, **extract_kw)
        det = _jax.jit(_jax.vmap(fn))(jnp.asarray(ranges_all, jnp.float32))
    # obs[t] pairs with the pose after step t-1 -> feed detections of scans
    # 1..T-1 (scan 0 seeds nothing; pose0 is the origin by convention)
    if cfg.use_scan_odometry:
        from lidar_slam_tpu.ops.scan_odometry import pairwise_odometry

        # batched pre-pass: all T-1 pair matches in parallel before the
        # sequential filter; odo row t-1 pairs with obs row t-1 = scan t
        odo_all = pairwise_odometry(
            jnp.asarray(ranges_all, jnp.float32), angles, lidar_cfg)
        from lidar_slam_tpu.ops.scan_odometry import reach_clip_fraction

        # 10%: corridor-ambiguity noise lands ~5% of a healthy museum run's
        # deltas sporadically on the boundary; genuine fast-motion datasets
        # saturate most of them
        frac = reach_clip_fraction(np.asarray(odo_all))
        if frac > 0.10:
            import warnings

            warnings.warn(
                f"scan odometry: {frac:.1%} of pair deltas sit on the descent "
                "reach boundary (~+-0.06 m/rad) — per-scan motion likely "
                "exceeds the envelope and the motion prior is clipped; widen "
                "pairwise_odometry step_t0/step_r0", RuntimeWarning,
                stacklevel=2)
    else:
        odo_all = jnp.zeros((det.rb.shape[0] - 1, 3), jnp.float32)
    return _run_ml_jit(det.rb[1:], det.valid[1:], odo_all, cfg, seed)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _run_jit(odom, obs, vis, cfg: EkfSlamConfig, seed):
    state = init_ekf_slam(cfg, 0)

    def body(st, inp):
        o, z, v = inp
        return ekf_slam_step(st, o, z, v, cfg)

    final, path = jax.lax.scan(body, state, (odom, obs, vis))
    return jnp.concatenate([jnp.zeros((1, 3), jnp.float32), path]), final


def run_ekf_slam(odom: np.ndarray, obs: np.ndarray, vis: np.ndarray,
                 cfg: EkfSlamConfig, seed: int = 0):
    """Whole-sequence on-device run. obs/vis include t=0 (skipped for odom
    alignment: obs[t] pairs with the pose after odom[t-1])."""
    return _run_jit(jnp.asarray(odom, jnp.float32),
                    jnp.asarray(obs[1:], jnp.float32),
                    jnp.asarray(vis[1:]), cfg, seed)


def landmark_estimates(state: EkfSlamState) -> np.ndarray:
    """Weight-averaged landmark means (L, 2)."""
    w = jax.nn.softmax(state.logw)
    return np.asarray(jnp.einsum("p,plk->lk", w, state.lm_mean,
                                 precision=HIGHEST))
